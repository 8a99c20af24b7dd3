"""End-to-end pipeline tests on synthetic pairs with known ground truth.

The reference repo bundles no GT .flo (SURVEY.md section 4), so accuracy
gates use synthetic warps where EPPM must recover the flow: uniform
translation and a smooth affine-ish field.  Sizes/iterations are trimmed
for CPU CI; the full-size runs on the card are in chip_smoke.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from eppm.config import (
    EPPMConfig,
    PatchMatchConfig,
    PyramidConfig,
    RefineConfig,
)
from eppm.metrics import flow_error
from eppm.pipeline import EPPMFlow, compute_flow, compute_flow_jit


def _test_cfg(depth=2):
    return EPPMConfig(
        pyramid=PyramidConfig(max_depth=depth),
        patchmatch=PatchMatchConfig(num_iters=4, prop_steps=(4, 2, 1)),
        refine=RefineConfig(wmf_coarse_iters=5),
    )


def _textured(rng, h, w):
    """Smooth random texture (pure noise defeats bilinear warping)."""
    small = rng.random((h // 4 + 2, w // 4 + 2, 3)).astype(np.float32)
    img = np.asarray(
        jax.image.resize(jnp.asarray(small), (h + 8, w + 8, 3), "cubic")
    )[:h, :w]
    return np.clip(img, 0, 1)


def _warp(img, flow):
    """img1(x) = img2(x + flow): build frame 1 by sampling frame 2."""
    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    fx = np.clip(xs + flow[..., 0], 0, w - 1)
    fy = np.clip(ys + flow[..., 1], 0, h - 1)
    x0 = np.floor(fx).astype(int)
    y0 = np.floor(fy).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    return (
        img[y0, x0] * (1 - ax) * (1 - ay)
        + img[y0, x1] * ax * (1 - ay)
        + img[y1, x0] * (1 - ax) * ay
        + img[y1, x1] * ax * ay
    ).astype(np.float32)


@pytest.mark.slow
def test_uniform_shift_epe(rng):
    h, w, sx, sy = 64, 80, 5, 3
    img2 = _textured(rng, h, w)
    gt = np.zeros((h, w, 2), np.float32)
    gt[..., 0], gt[..., 1] = sx, sy
    img1 = _warp(img2, gt)
    flow = np.asarray(
        compute_flow(jnp.asarray(img1), jnp.asarray(img2), cfg=_test_cfg())
    )
    b = 10
    epe, _ = flow_error(flow[b:-b, b:-b], gt[b:-b, b:-b])
    assert epe < 1.0, f"uniform-shift EPE {epe:.3f}"


def test_smooth_flow_epe(rng):
    h, w = 64, 80
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    gt = np.zeros((h, w, 2), np.float32)
    gt[..., 0] = 3.0 + 2.0 * xs / w          # 3..5 px horizontally
    gt[..., 1] = 2.0 * ys / h                # 0..2 px vertically
    img2 = _textured(rng, h, w)
    img1 = _warp(img2, gt)
    flow = np.asarray(
        compute_flow(jnp.asarray(img1), jnp.asarray(img2), cfg=_test_cfg())
    )
    b = 10
    epe, _ = flow_error(flow[b:-b, b:-b], gt[b:-b, b:-b])
    assert epe < 1.5, f"smooth-flow EPE {epe:.3f}"


@pytest.mark.slow
def test_pipeline_deterministic(rng):
    h, w = 48, 64
    img2 = _textured(rng, h, w)
    img1 = np.roll(img2, -3, axis=1)
    cfg = _test_cfg()
    f1 = np.asarray(compute_flow_jit(jnp.asarray(img1), jnp.asarray(img2), cfg=cfg))
    f2 = np.asarray(compute_flow_jit(jnp.asarray(img1), jnp.asarray(img2), cfg=cfg))
    np.testing.assert_array_equal(f1, f2)


@pytest.mark.slow
def test_pipeline_uint8_input(rng):
    h, w = 48, 64
    img2 = (_textured(rng, h, w) * 255).astype(np.uint8)
    img1 = np.roll(img2, -3, axis=1)
    flow = np.asarray(
        compute_flow(jnp.asarray(img1), jnp.asarray(img2), cfg=_test_cfg())
    )
    assert flow.shape == (h, w, 2)
    assert np.isfinite(flow).all()
    b = 10
    assert abs(np.median(flow[b:-b, b:-b, 0]) - 3.0) <= 1.0


@pytest.mark.slow
def test_object_api(rng):
    h, w = 48, 64
    img2 = (_textured(rng, h, w) * 255).astype(np.uint8)
    img1 = np.roll(img2, -2, axis=1)
    engine = EPPMFlow(_test_cfg())
    engine.init(h, w)
    with pytest.raises(RuntimeError):
        engine.compute_flow()
    with pytest.raises(ValueError):
        engine.set_data(img1[: h // 2], img2)
    flow = np.asarray(engine.set_data(img1, img2).compute_flow())
    assert flow.shape == (h, w, 2)
    assert np.isfinite(flow).all()


@pytest.mark.slow
def test_fine_level_wmf_option(rng):
    """The 'intended' fine-level WMF path also produces sane flow."""
    h, w = 48, 64
    img2 = _textured(rng, h, w)
    img1 = np.roll(img2, -3, axis=1)
    flow = np.asarray(
        compute_flow(
            jnp.asarray(img1), jnp.asarray(img2), cfg=_test_cfg(),
            fine_level_wmf=True,
        )
    )
    assert np.isfinite(flow).all()
    b = 10
    assert abs(np.median(flow[b:-b, b:-b, 0]) - 3.0) <= 1.0


@pytest.mark.slow
def test_staged_pipeline_matches_one_program(rng, monkeypatch):
    """The >1M-pixel staged execution path, forced on a small image, must
    agree with the monolithic program at the decision level (see
    tests/test_sharded.py for why not bitwise)."""
    import eppm.pipeline as P

    cfg = _test_cfg()
    h, w = 64, 80
    img2 = _textured(rng, h, w)
    img1 = np.roll(img2, (-3, -2), axis=(1, 0))
    key = jax.random.PRNGKey(cfg.seed)
    one = np.asarray(
        P.compute_flow_jit(jnp.asarray(img1), jnp.asarray(img2), key, cfg)
    )
    monkeypatch.setattr(P, "STAGED_PIPELINE_THRESHOLD", 0)
    staged = np.asarray(
        P.compute_flow_jit(jnp.asarray(img1), jnp.asarray(img2), key, cfg)
    )
    d = np.abs(staged - one).max(axis=-1)
    assert (d < 1e-3).mean() > 0.9
    assert float(np.mean(d)) < 0.2


def test_staged_refine_disagreements_are_ties(rng):
    """Tie-proof companion of test_staged_pipeline_matches_one_program:
    the staged path compiles each refine pass as its own XLA program while
    the monolithic path fuses it with the surrounding stages, so the two
    can reassociate the cost reductions differently.  The quantization
    grid (2^-17, ops/dense.py residual_costs) is supposed to make the
    *decisions* agree or tie.  Prove it at the decision stage: run one
    refine pass from a shared input flow (a) standalone-jitted (staged
    context) and (b) fused inside a bigger jit between upsample and
    smoothing (monolithic context), then score both outputs' chosen
    offsets with one oracle evaluation — disagreements must be exact
    quantized-cost ties.  (The pipeline outputs themselves stay under the
    statistical gate: smoothing diffuses tie differences spatially.)"""
    from eppm.config import DEFAULT_CONFIG
    from eppm.ops.census import census_transform
    from eppm.ops.cost import pack_frame
    from eppm.ops.dense import (
        center_out_offsets,
        dense_refine_flow,
        residual_costs,
        warp_pack,
    )
    from eppm.ops.refine import flow_smoothing
    from eppm.ops.resize import bilinear_resize

    cfg = DEFAULT_CONFIG
    h, w = 64, 96
    img2 = _textured(rng, h, w)
    img1 = np.roll(img2, (-3, -2), axis=(1, 0))
    p1 = pack_frame(jnp.asarray(img1), census_transform(jnp.asarray(img1)))
    p2 = pack_frame(jnp.asarray(img2), census_transform(jnp.asarray(img2)))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [2.0 + 0.02 * xs + 0.5 * np.sin(ys / 9.0),
         3.0 - 0.015 * ys + 0.5 * np.cos(xs / 11.0)], axis=-1
    )
    coarse = jnp.asarray(base[::2, ::2] * 0.5)

    up = lambda f: bilinear_resize(f, h, w, 2.0) * 2.0
    refine = lambda f: dense_refine_flow(
        f, p1, p2, cfg.cost, cfg.dense_search_radius,
        cfg.dense_pass1_planes, cfg.cost_tap_chunk,
        cand_shape=cfg.dense_cand_shape,
    )
    flow_in = jax.jit(up)(coarse)
    standalone = np.asarray(jax.jit(refine)(flow_in))

    # monolithic context: upsample + refine + smoothing in ONE program;
    # the refine output rides out alongside so decisions are observable
    def fused(c):
        f = up(c)
        r = refine(f)
        return r, flow_smoothing(r, jnp.asarray(img1), cfg.refine)

    fused_refine = np.asarray(jax.jit(fused)(coarse)[0])

    fin = np.asarray(flow_in)
    g = np.trunc(fin).astype(np.int32)
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

    disagree = np.abs(fused_refine - standalone).max(axis=-1) > 0
    if disagree.any():
        ca = chosen_cost(standalone)
        cb = chosen_cost(fused_refine)
        bad = disagree & (ca != cb)
        assert not bad.any(), (
            f"{bad.sum()} disagreeing pixels are NOT cost ties"
        )


@pytest.mark.parametrize(
    "variant",
    ["patchmatch", "gather", "fine_wmf", "subpixel"],
)
@pytest.mark.slow
def test_staged_pipeline_all_variants(rng, monkeypatch, variant):
    """Every non-default option must run through the staged path (the
    route of every input above STAGED_PIPELINE_THRESHOLD, so it must
    cover all variants)."""
    import dataclasses

    import eppm.pipeline as P

    cfg = _test_cfg()
    fine_wmf = False
    if variant == "patchmatch":
        cfg = dataclasses.replace(cfg, match_engine="patchmatch")
    elif variant == "gather":
        cfg = dataclasses.replace(cfg, refine_impl="gather")
    elif variant == "subpixel":
        cfg = dataclasses.replace(cfg, subpixel_refine=True)
    elif variant == "fine_wmf":
        fine_wmf = True
    h, w = 48, 64
    img2 = _textured(rng, h, w)
    img1 = np.roll(img2, (-3, -2), axis=(1, 0))
    key = jax.random.PRNGKey(cfg.seed)
    one = np.asarray(
        P.compute_flow_jit(
            jnp.asarray(img1), jnp.asarray(img2), key, cfg, fine_wmf
        )
    )
    monkeypatch.setattr(P, "STAGED_PIPELINE_THRESHOLD", 0)
    staged = np.asarray(
        P.compute_flow_jit(
            jnp.asarray(img1), jnp.asarray(img2), key, cfg, fine_wmf
        )
    )
    d = np.abs(staged - one).max(axis=-1)
    assert np.isfinite(staged).all()
    assert (d < 1e-3).mean() > 0.9, f"{variant}: {(d < 1e-3).mean():.2%}"
    assert float(np.mean(d)) < 0.25, f"{variant}: mean {np.mean(d):.3f}"
