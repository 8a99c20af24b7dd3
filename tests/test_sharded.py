"""Multi-device tests on the spoofed 8-device CPU mesh (conftest.py).

The key distributed test (SURVEY.md section 4): tiled multi-chip output
must equal the single-chip pipeline — same keys, same schedule, only the
partitioning differs (to f32 fusion-level tolerance).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P
from jax import shard_map

from eppm.config import EPPMConfig, PatchMatchConfig, PyramidConfig, RefineConfig
from eppm.parallel import (
    check_tileable,
    compute_flow_sharded,
    halo_exchange_2d,
    make_mesh,
)
from eppm.pipeline import compute_flow


def _cfg(depth=2):
    return EPPMConfig(
        pyramid=PyramidConfig(max_depth=depth),
        patchmatch=PatchMatchConfig(num_iters=3, prop_steps=(4, 2, 1)),
        refine=RefineConfig(wmf_coarse_iters=3),
    )


def _textured(rng, h, w):
    small = rng.random((h // 4 + 2, w // 4 + 2, 3)).astype(np.float32)
    img = np.asarray(
        jax.image.resize(jnp.asarray(small), (h + 8, w + 8, 3), "cubic")
    )[:h, :w]
    return np.clip(img, 0, 1)


def test_devices_available():
    assert len(jax.devices()) == 8, "conftest must spoof 8 CPU devices"


def test_halo_exchange_matches_pad():
    """Tiled halo exchange == slicing a globally padded array."""
    mesh = make_mesh(batch=1, y=2, x=2)
    rng = np.random.default_rng(0)
    full = rng.random((16, 24)).astype(np.float32)
    halo = 3

    def fn(tile):
        return halo_exchange_2d(tile[0, :, :, 0], halo)[None, :, :, None]

    tiled = shard_map(
        fn,
        mesh=mesh,
        in_specs=P("batch", "y", "x", None),
        out_specs=P("batch", "y", "x", None),
        check_vma=False,
    )(jnp.asarray(full)[None, :, :, None])
    # can't reassemble haloed tiles globally; instead check each tile
    tiles = np.asarray(tiled)[0, :, :, 0]
    padded = np.pad(full, halo, mode="edge")
    th, tw = 8, 12
    # shard (iy, ix) occupies rows iy*(th+2h):(iy+1)*(th+2h) in the output
    for iy in range(2):
        for ix in range(2):
            got = tiles[
                iy * (th + 2 * halo) : (iy + 1) * (th + 2 * halo),
                ix * (tw + 2 * halo) : (ix + 1) * (tw + 2 * halo),
            ]
            want = padded[
                iy * th : iy * th + th + 2 * halo,
                ix * tw : ix * tw + tw + 2 * halo,
            ]
            np.testing.assert_array_equal(got, want)


def test_halo_exchange_constant_boundary():
    mesh = make_mesh(batch=1, y=2, x=1)
    full = jnp.arange(8.0 * 4).reshape(8, 4)

    def fn(tile):
        return halo_exchange_2d(tile[0, :, :, 0], 2, boundary=-1.0)[
            None, :, :, None
        ]

    tiled = shard_map(
        fn,
        mesh=mesh,
        in_specs=P("batch", "y", "x", None),
        out_specs=P("batch", "y", "x", None),
        check_vma=False,
    )(full[None, :, :, None])
    t = np.asarray(tiled)[0, :, :, 0]
    top_tile = t[:8]  # 4 rows + 2 halo each side (x halo is columns 0:2, 6:8)
    assert (top_tile[:2] == -1.0).all()            # global top boundary
    assert (top_tile[:, :2] == -1.0).all()         # global left boundary
    # bottom halo rows come from the next y-shard (rows 4:6 of the image)
    np.testing.assert_array_equal(top_tile[6:8, 2:6], np.asarray(full)[4:6])


@pytest.mark.parametrize("ny,nx", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_median_halo_matches_padded_median(ny, nx):
    """The flow ring a sharded refine pass warps with: halo exchange,
    3x3 median, then the positions beyond the frame clamped.  Every tile
    must equal the single-chip field, median3 of the whole flow
    edge-padded — a median of edge copies beyond the border is not."""
    from eppm.ops.dense import median3_flow
    from eppm.parallel.sharded import _clamp_to_frame

    h, w, halo = 16, 24, 5
    mesh = make_mesh(batch=1, y=ny, x=nx)
    full = np.random.default_rng(3).integers(-6, 7, (h, w, 2)).astype(
        np.float32
    )
    th, tw = h // ny, w // nx

    def fn(tile):
        y0 = jax.lax.axis_index("y") * th
        x0 = jax.lax.axis_index("x") * tw
        fh = halo_exchange_2d(tile[0], halo + 1)
        fh = _clamp_to_frame(
            median3_flow(fh), y0 - halo - 1, x0 - halo - 1, h, w
        )
        return fh[None, 1:-1, 1:-1]

    tiled = np.asarray(shard_map(
        fn, mesh=mesh, in_specs=P("batch", "y", "x", None),
        out_specs=P("batch", "y", "x", None), check_vma=False,
    )(jnp.asarray(full)[None]))[0]
    want = np.pad(np.asarray(median3_flow(jnp.asarray(full))),
                  ((halo, halo), (halo, halo), (0, 0)), mode="edge")
    eh, ew = th + 2 * halo, tw + 2 * halo
    for iy in range(ny):
        for ix in range(nx):
            np.testing.assert_array_equal(
                tiled[iy * eh:(iy + 1) * eh, ix * ew:(ix + 1) * ew],
                want[iy * th:iy * th + eh, ix * tw:ix * tw + ew],
            )


def test_check_tileable():
    cfg = _cfg(depth=3)
    check_tileable(64, 96, cfg, 2, 2)
    with pytest.raises(ValueError):
        check_tileable(60, 96, cfg, 2, 2)  # 60 -> 30 -> 15 not divisible


@pytest.mark.slow
def test_sharded_matches_single_chip(rng):
    """Tiled (1,2,2) vs single chip, same key: quality-equal + per-program
    deterministic.

    The contract is NOT cross-program bitwise equality: the monolithic and
    shard_map programs are different XLA compilations whose reductions
    associate differently, and the engine is an argmin cascade — a float
    near-tie between two integer candidates can legitimately resolve
    either way (global-match scores are quantized to kill the worst of
    it; residual-cost sums still carry ~1e-6 reassociation noise).  Both
    outputs minimize the same objective; the gates are (a) decision-level
    agreement on the overwhelming majority of pixels, (b) near-zero flow
    EPE between the two, (c) bitwise determinism of the sharded program
    across reruns.
    """
    cfg = _cfg(depth=2)
    h, w = 64, 96
    img2 = _textured(rng, h, w)
    img1 = np.roll(img2, (-3, -2), axis=(1, 0))
    key = jax.random.PRNGKey(cfg.seed)
    single = np.asarray(
        compute_flow(jnp.asarray(img1), jnp.asarray(img2), key, cfg)
    )
    mesh = make_mesh(batch=1, y=2, x=2)
    run = lambda: np.asarray(
        compute_flow_sharded(
            jnp.asarray(img1)[None], jnp.asarray(img2)[None], mesh, cfg,
            keys=key[None],
        )
    )[0]
    tiled = run()
    d = np.abs(tiled - single).max(axis=-1)
    agree = (d < 1e-3).mean()
    assert agree > 0.98, f"only {agree:.2%} of pixels agree"
    assert float(np.mean(d)) < 0.05, f"mean |delta| {np.mean(d):.3f}"
    # same program, same inputs -> bitwise deterministic
    np.testing.assert_array_equal(run(), tiled)


@pytest.mark.slow
def test_sharded_mesh_shape_invariance(rng):
    """The result must not depend on how the frame is tiled: (1,2),
    (2,1) and (2,2) meshes must produce identical flow.  A halo-exchange
    bug on one axis shows up as a mesh-shape-dependent difference even
    when each shape individually stays within the single-chip gate."""
    cfg = _cfg(depth=2)
    h, w = 64, 96
    img2 = _textured(rng, h, w)
    img1 = np.roll(img2, (-3, -2), axis=(1, 0))
    key = jax.random.PRNGKey(cfg.seed)
    outs = {}
    for (ny, nx) in [(1, 2), (2, 1), (2, 2)]:
        mesh = make_mesh(batch=1, y=ny, x=nx)
        outs[(ny, nx)] = np.asarray(
            compute_flow_sharded(
                jnp.asarray(img1)[None], jnp.asarray(img2)[None], mesh,
                cfg, keys=key[None],
            )
        )[0]
    np.testing.assert_array_equal(outs[(1, 2)], outs[(2, 1)])
    np.testing.assert_array_equal(outs[(1, 2)], outs[(2, 2)])


def test_sharded_pad_to_tileable(rng):
    """Non-divisible (KITTI-like) shapes run via pad-and-crop and match
    the single-chip result on identically padded-then-cropped frames."""
    from eppm.parallel.sharded import pad_to_tileable

    cfg = _cfg(depth=2)
    h, w = 62, 94  # not divisible by mesh*2^(depth-1)
    img2 = _textured(rng, h, w)
    img1 = np.roll(img2, (-3, -2), axis=(1, 0))
    key = jax.random.PRNGKey(cfg.seed)
    mesh = make_mesh(batch=1, y=2, x=2)
    with pytest.raises(ValueError):
        check_tileable(h, w, cfg, 2, 2)
    tiled = np.asarray(
        compute_flow_sharded(
            jnp.asarray(img1)[None], jnp.asarray(img2)[None], mesh, cfg,
            keys=key[None],
        )
    )[0]
    assert tiled.shape == (h, w, 2)
    ph, pw = pad_to_tileable(h, w, cfg, 2, 2)
    check_tileable(ph, pw, cfg, 2, 2)
    p1 = np.pad(img1, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    p2 = np.pad(img2, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    single = np.asarray(
        compute_flow(jnp.asarray(p1), jnp.asarray(p2), key, cfg)
    )[:h, :w]
    d = np.abs(tiled - single).max(axis=-1)
    agree = (d < 1e-3).mean()
    assert agree > 0.98, f"only {agree:.2%} agree"
    assert float(np.mean(d)) < 0.05, f"mean |delta| {np.mean(d):.3f}"
    # strict mode still refuses
    with pytest.raises(ValueError):
        compute_flow_sharded(
            jnp.asarray(img1)[None], jnp.asarray(img2)[None], mesh, cfg,
            keys=key[None], pad_to_fit=False,
        )


@pytest.mark.slow
def test_sharded_refine_disagreements_are_ties(rng):
    """Tie-proof for the cross-program gates: the only stage where the
    partitioning can change a *decision* (not just reassociate float
    noise below the 1e-3 gate) is the fine-level residual argmin.  Run it
    from one shared input flow as (a) the monolithic full-frame program
    and (b) the sharded tile program with halo G (exactly as
    parallel/sharded.py runs it), then score BOTH programs' chosen
    offsets with a single oracle evaluation (ops/dense.residual_costs,
    quantized to the 2^-17 grid): every pixel where the decisions differ
    must be an exact quantized-cost tie.  This turns the statistical
    98%-agreement gates into a proof that disagreements are ties — the
    downstream smoothing is decision-free dense math, so output-level
    differences can only originate here (or in the replicated coarse
    stage, which is decision-identical by construction: same program,
    same inputs on every device).
    """
    from eppm.config import DEFAULT_CONFIG
    from eppm.ops.census import census_transform
    from eppm.ops.cost import pack_frame
    from eppm.ops.dense import (
        center_out_offsets,
        dense_refine_flow,
        residual_costs,
        warp_pack,
    )
    from eppm.parallel.halo import halo_exchange_2d
    from eppm.parallel.sharded import _slice_tile_haloed

    cfg = DEFAULT_CONFIG
    h, w = 64, 96
    img2 = _textured(rng, h, w)
    img1 = np.roll(img2, (-3, -2), axis=(1, 0))
    p1 = pack_frame(jnp.asarray(img1), census_transform(jnp.asarray(img1)))
    p2 = pack_frame(jnp.asarray(img2), census_transform(jnp.asarray(img2)))
    # a smooth but non-constant input flow (what the upsample hands over)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [2.0 + 0.02 * xs + 0.5 * np.sin(ys / 9.0),
         3.0 - 0.015 * ys + 0.5 * np.cos(xs / 11.0)], axis=-1
    )
    flow = jnp.asarray(base)

    refine = lambda f, pk1, origin: dense_refine_flow(
        f, pk1, p2, cfg.cost, cfg.dense_search_radius,
        cfg.dense_pass1_planes, cfg.cost_tap_chunk, origin=origin,
        cand_shape=cfg.dense_cand_shape,
    )
    single = np.asarray(jax.jit(lambda f: refine(f, p1, (0, 0)))(flow))

    reach = max(cfg.dense_search_radius, cfg.cost.patch_radius)
    G = -(-reach // 8) * 8
    mesh = make_mesh(batch=1, y=2, x=2)

    def tile_fn(f, pk1):
        iy = jax.lax.axis_index("y")
        ix = jax.lax.axis_index("x")
        th, tw = h // 2, w // 2
        y0, x0 = iy * th, ix * tw
        fh = halo_exchange_2d(f[0], G, boundary="edge")
        p1h = _slice_tile_haloed(pk1[0], y0, x0, th, tw, G)
        ext = refine(fh, p1h, (y0 - G, x0 - G))
        return ext[None, G:-G, G:-G]

    tiled = np.asarray(
        shard_map(
            tile_fn,
            mesh=mesh,
            in_specs=(P(None, "y", "x", None), P(None, None, None, None)),
            out_specs=P(None, "y", "x", None),
            check_vma=False,
        )(flow[None], p1[None])
    )[0]

    # oracle: one program scores every candidate for both outputs
    unknown = base > 1e9
    g = np.trunc(np.where(unknown, 0.0, base)).astype(np.int32)
    warped = warp_pack(p2, jnp.asarray(g[..., 0]), jnp.asarray(g[..., 1]),
                       gather_dtype=cfg.warp_dtype)
    cands = center_out_offsets(cfg.dense_search_radius, cfg.dense_cand_shape)
    costs = np.asarray(
        jax.jit(
            lambda: residual_costs(
                p1, warped, cands, cfg.cost, cfg.dense_pass1_planes,
                cfg.cost_tap_chunk,
            )
        )()
    )
    k_of = {off: k for k, off in enumerate(cands)}

    def chosen_cost(out):
        dx = out[..., 0].astype(np.int32) - g[..., 0]
        dy = out[..., 1].astype(np.int32) - g[..., 1]
        k = np.vectorize(lambda a, b: k_of[(a, b)])(dy, dx)
        return np.take_along_axis(costs, k[None], axis=0)[0]

    disagree = np.abs(tiled - single).max(axis=-1) > 0
    if disagree.any():
        ca = chosen_cost(single)
        cb = chosen_cost(tiled)
        bad = disagree & (ca != cb)
        assert not bad.any(), (
            f"{bad.sum()} disagreeing pixels are NOT cost ties "
            f"(max |dc|={np.abs(ca - cb)[disagree].max():.3e})"
        )


@pytest.mark.slow
def test_sharded_batch_parallel(rng):
    """Batch sharding: each pair's flow matches its single-chip result at
    the decision level (see test_sharded_matches_single_chip for why
    cross-program bitwise equality is not the contract)."""
    cfg = _cfg(depth=2)
    h, w = 32, 32
    pairs = []
    for i in range(4):
        img2 = _textured(rng, h, w)
        img1 = np.roll(img2, -(i % 3 + 1), axis=1)
        pairs.append((img1, img2))
    imgs1 = jnp.asarray(np.stack([p[0] for p in pairs]))
    imgs2 = jnp.asarray(np.stack([p[1] for p in pairs]))
    mesh = make_mesh(batch=4, y=1, x=2)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(cfg.seed), jnp.arange(4)
    )
    batched = np.asarray(
        compute_flow_sharded(imgs1, imgs2, mesh, cfg, keys=keys)
    )
    for i in range(4):
        single = np.asarray(
            compute_flow(imgs1[i], imgs2[i], keys[i], cfg)
        )
        d = np.abs(batched[i] - single).max(axis=-1)
        agree = (d < 1e-3).mean()
        assert agree > 0.9, f"pair {i}: only {agree:.2%} agree"
        assert float(np.mean(d)) < 0.3, f"pair {i}: mean {np.mean(d):.3f}"


@pytest.mark.slow
def test_full_3axis_mesh(rng):
    """(batch=2, y=2, x=2) = all 8 devices at once."""
    cfg = _cfg(depth=2)
    h, w = 32, 32
    img2 = _textured(rng, h, w)
    img1 = np.roll(img2, -2, axis=1)
    imgs1 = jnp.asarray(np.stack([img1, img1]))
    imgs2 = jnp.asarray(np.stack([img2, img2]))
    mesh = make_mesh(batch=2, y=2, x=2)
    out = np.asarray(compute_flow_sharded(imgs1, imgs2, mesh, cfg))
    assert out.shape == (2, h, w, 2)
    assert np.isfinite(out).all()
    b = 8
    assert abs(np.median(out[0, b:-b, b:-b, 0]) - 2.0) <= 1.0


@pytest.mark.slow
def test_sharded_plus_cand_shape(rng):
    """dense_cand_shape="plus" through the sharded path: mesh-shape
    invariant and agreeing with the single-chip program (same gates as
    the default-config test — the knob only changes the candidate list
    both programs share)."""
    import dataclasses

    cfg = dataclasses.replace(_cfg(depth=2), dense_cand_shape="plus")
    h, w = 64, 96
    img2 = _textured(rng, h, w)
    img1 = np.roll(img2, (-3, -2), axis=(1, 0))
    key = jax.random.PRNGKey(cfg.seed)
    single = np.asarray(
        compute_flow(jnp.asarray(img1), jnp.asarray(img2), key, cfg)
    )
    outs = {}
    for (ny, nx) in [(1, 2), (2, 2)]:
        mesh = make_mesh(batch=1, y=ny, x=nx)
        outs[(ny, nx)] = np.asarray(
            compute_flow_sharded(
                jnp.asarray(img1)[None], jnp.asarray(img2)[None], mesh,
                cfg, keys=key[None],
            )
        )[0]
    np.testing.assert_array_equal(outs[(1, 2)], outs[(2, 2)])
    d = np.abs(outs[(1, 2)] - single).max(axis=-1)
    assert (d < 1e-3).mean() > 0.98


@pytest.mark.slow
def test_sharded_default_config_moderate_shape(rng):
    """96x160 at the FULL default config (EPPMConfig()), both engines,
    through the (1,2,2) mesh — the round-3 dryrun only exercised trimmed
    configs at tiny shapes.  Gates per the documented cross-program
    contract (test_sharded_matches_single_chip): decision-level agreement
    with the single-chip program, near-zero mean delta, and BITWISE
    mesh-shape invariance between (1,2) and (2,2) tilings of the same
    sharded program family."""
    import dataclasses

    h, w = 96, 160
    img2 = _textured(rng, h, w)
    img1 = np.roll(img2, (-4, -3), axis=(1, 0))
    for engine in ("dense", "patchmatch"):
        cfg = dataclasses.replace(EPPMConfig(), match_engine=engine)
        key = jax.random.PRNGKey(cfg.seed)
        single = np.asarray(
            compute_flow(jnp.asarray(img1), jnp.asarray(img2), key, cfg)
        )
        outs = {}
        for (ny, nx) in [(1, 2), (2, 2)]:
            mesh = make_mesh(batch=1, y=ny, x=nx)
            outs[(ny, nx)] = np.asarray(
                compute_flow_sharded(
                    jnp.asarray(img1)[None], jnp.asarray(img2)[None],
                    mesh, cfg, keys=key[None],
                )
            )[0]
        np.testing.assert_array_equal(outs[(1, 2)], outs[(2, 2)])
        d = np.abs(outs[(2, 2)] - single).max(axis=-1)
        agree = (d < 1e-3).mean()
        assert agree > 0.98, f"{engine}: only {agree:.2%} of pixels agree"
        assert float(np.mean(d)) < 0.05, f"{engine}: mean {np.mean(d):.3f}"


@pytest.mark.slow
def test_sharded_temporal_streaming_chain(rng):
    """Temporal streaming through the mesh: 3 frames -> 2 pairs, the
    second pair warm-started from the first pair's SHARDED flow (the
    real streaming dataflow, flow never leaving the mesh layout).  The
    chained sharded result must agree with the single-chip chain at the
    cross-program gate and be bitwise deterministic across reruns."""
    import dataclasses

    from eppm.pipeline import compute_flow as cf

    h, w = 64, 96
    f0 = _textured(rng, h, w)
    f1 = np.roll(f0, (3, 1), axis=(1, 0))
    f2 = np.roll(f0, (6, 2), axis=(1, 0))
    cfg = _cfg(depth=2)
    key = jax.random.PRNGKey(cfg.seed)
    mesh = make_mesh(batch=1, y=2, x=2)

    def sharded_chain():
        fl01 = compute_flow_sharded(
            jnp.asarray(f0)[None], jnp.asarray(f1)[None], mesh, cfg,
            keys=key[None],
        )
        fl12 = compute_flow_sharded(
            jnp.asarray(f1)[None], jnp.asarray(f2)[None], mesh, cfg,
            keys=key[None], init_flows=fl01,
        )
        return np.asarray(fl01)[0], np.asarray(fl12)[0]

    s01 = cf(jnp.asarray(f0), jnp.asarray(f1), key, cfg)
    s12 = np.asarray(
        cf(jnp.asarray(f1), jnp.asarray(f2), key, cfg, init_flow=s01)
    )
    t01, t12 = sharded_chain()
    d = np.abs(t12 - s12).max(axis=-1)
    agree = (d < 1e-3).mean()
    assert agree > 0.95, f"chained: only {agree:.2%} of pixels agree"
    assert float(np.mean(d)) < 0.1, f"chained mean {np.mean(d):.3f}"
    # bitwise determinism of the chained sharded programs
    r01, r12 = sharded_chain()
    np.testing.assert_array_equal(r01, t01)
    np.testing.assert_array_equal(r12, t12)
