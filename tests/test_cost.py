"""Patch-cost evaluator vs a literal NumPy oracle of
``_d_compute_patch_dist`` (bao_pmflow_kernel.cu:255-301)."""

import numpy as np
import jax.numpy as jnp

from eppm.config import CostConfig
from eppm.ops.census import census_transform
from eppm.ops.cost import (
    pack_frame,
    patch_cost,
    patch_cost_candidates,
    patch_cost_planefitting,
    plane_offsets,
)


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


def oracle_patch_cost(img1, img2, cen1, cen2, tx, ty, cfg):
    h, w = img1.shape[:2]
    lam_ad2 = cfg.lambda_ad**2
    lam_cen2 = (cfg.lambda_census * cfg.census_max_diff) ** 2
    sig_s2 = cfg.sigma_spatial**2
    sig_r2 = cfg.sigma_range**2
    out = np.zeros((h, w))
    for y in range(h):
        for x in range(w):
            x2, y2 = int(tx[y, x]), int(ty[y, x])
            c1 = img1[y, x]
            c2 = img2[_clamp(y2, 0, h - 1), _clamp(x2, 0, w - 1)]
            cost_sum, weight_sum = 0.0, 0.0
            r = cfg.patch_radius
            for i in range(-r, r + 1, cfg.patch_stride):
                for j in range(-r, r + 1, cfg.patch_stride):
                    p1 = img1[_clamp(y + i, 0, h - 1), _clamp(x + j, 0, w - 1)]
                    p2 = img2[_clamp(y2 + i, 0, h - 1), _clamp(x2 + j, 0, w - 1)]
                    s1 = cen1[_clamp(y + i, 0, h - 1), _clamp(x + j, 0, w - 1)]
                    s2 = cen2[_clamp(y2 + i, 0, h - 1), _clamp(x2 + j, 0, w - 1)]
                    ham = bin(int(s1) ^ int(s2)).count("1")
                    ad = np.max(np.abs(p1 - p2))
                    c = 1 - np.exp(-(ad * ad) / lam_ad2)
                    c += 1 - np.exp(-(ham * ham) / lam_cen2)
                    dr1 = np.max(np.abs(c1 - p1))
                    dr2 = np.max(np.abs(c2 - p2))
                    wgt = np.exp(-(dr1**2 + dr2**2) / sig_r2)
                    wgt *= np.exp(-(j * j) / sig_s2) * np.exp(-(i * i) / sig_s2)
                    cost_sum += wgt * c
                    weight_sum += wgt
            out[y, x] = cost_sum / weight_sum
    return out


def _mk(rng, h, w):
    img1 = rng.random((h, w, 3)).astype(np.float32)
    img2 = rng.random((h, w, 3)).astype(np.float32)
    cen1 = np.asarray(census_transform(jnp.asarray(img1)))
    cen2 = np.asarray(census_transform(jnp.asarray(img2)))
    return img1, img2, cen1, cen2


def test_patch_cost_matches_oracle_small(rng):
    cfg = CostConfig(patch_radius=3, patch_stride=2, sigma_spatial=1.5)
    h, w = 8, 9
    img1, img2, cen1, cen2 = _mk(rng, h, w)
    tx = rng.integers(0, w, (h, w)).astype(np.int32)
    ty = rng.integers(0, h, (h, w)).astype(np.int32)
    p1 = pack_frame(jnp.asarray(img1), jnp.asarray(cen1))
    p2 = pack_frame(jnp.asarray(img2), jnp.asarray(cen2))
    got = np.asarray(patch_cost(p1, p2, jnp.asarray(tx), jnp.asarray(ty), cfg, tap_chunk=5))
    want = oracle_patch_cost(img1, img2, cen1, cen2, tx, ty, cfg)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_patch_cost_default_radius(rng):
    """Full R=9 stride-2 grid (100 taps) against the oracle on a small image."""
    cfg = CostConfig()
    h, w = 6, 7
    img1, img2, cen1, cen2 = _mk(rng, h, w)
    tx = rng.integers(0, w + 1, (h, w)).astype(np.int32)  # incl. out-of-range
    ty = rng.integers(0, h + 1, (h, w)).astype(np.int32)
    p1 = pack_frame(jnp.asarray(img1), jnp.asarray(cen1))
    p2 = pack_frame(jnp.asarray(img2), jnp.asarray(cen2))
    got = np.asarray(patch_cost(p1, p2, jnp.asarray(tx), jnp.asarray(ty), cfg))
    want = oracle_patch_cost(img1, img2, cen1, cen2, tx, ty, cfg)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_identical_patch_costs_zero(rng):
    cfg = CostConfig(patch_radius=3, sigma_spatial=1.5)
    h, w = 8, 8
    img = rng.random((h, w, 3)).astype(np.float32)
    cen = census_transform(jnp.asarray(img))
    p = pack_frame(jnp.asarray(img), cen)
    ys, xs = np.mgrid[0:h, 0:w]
    cost = np.asarray(
        patch_cost(p, p, jnp.asarray(xs, jnp.int32), jnp.asarray(ys, jnp.int32), cfg)
    )
    assert np.abs(cost).max() < 1e-5


def test_true_shift_beats_random(rng):
    """Cost at the true displacement must undercut random displacements."""
    cfg = CostConfig(patch_radius=3, sigma_spatial=1.5)
    h, w, s = 12, 16, 3
    img2 = rng.random((h, w, 3)).astype(np.float32)
    img1 = np.roll(img2, -s, axis=1)  # img1(x) = img2(x+s)
    cen1 = census_transform(jnp.asarray(img1))
    cen2 = census_transform(jnp.asarray(img2))
    p1 = pack_frame(jnp.asarray(img1), cen1)
    p2 = pack_frame(jnp.asarray(img2), cen2)
    ys, xs = np.mgrid[0:h, 0:w]
    true_cost = np.asarray(
        patch_cost(p1, p2, jnp.asarray(xs + s, jnp.int32), jnp.asarray(ys, jnp.int32), cfg)
    )
    rand_cost = np.asarray(
        patch_cost(p1, p2, jnp.asarray((xs + 7) % w, jnp.int32), jnp.asarray(ys, jnp.int32), cfg)
    )
    interior = (slice(2, h - 2), slice(2, w - s - 2))
    assert true_cost[interior].mean() < 0.3 * rand_cost[interior].mean()


def test_candidates_match_single(rng):
    cfg = CostConfig(patch_radius=3, sigma_spatial=1.5)
    h, w = 7, 9
    img1, img2, cen1, cen2 = _mk(rng, h, w)
    p1 = pack_frame(jnp.asarray(img1), jnp.asarray(cen1))
    p2 = pack_frame(jnp.asarray(img2), jnp.asarray(cen2))
    txs = jnp.asarray(rng.integers(0, w, (3, h, w)), jnp.int32)
    tys = jnp.asarray(rng.integers(0, h, (3, h, w)), jnp.int32)
    batched = np.asarray(patch_cost_candidates(p1, p2, txs, tys, cfg))
    seq = np.asarray(patch_cost_candidates(p1, p2, txs, tys, cfg, sequential=True))
    np.testing.assert_allclose(batched, seq, rtol=1e-6)
    for k in range(3):
        single = np.asarray(patch_cost(p1, p2, txs[k], tys[k], cfg))
        np.testing.assert_allclose(batched[k], single, rtol=1e-6)


def test_plane_offsets_tables():
    cfg = CostConfig()
    tables = plane_offsets(cfg)
    assert len(tables) == 4
    assert tables[0] == cfg.tap_offsets  # fronto-parallel
    # hypothesis tables share tap count and differ from fronto-parallel
    for t in tables[1:]:
        assert len(t) == len(cfg.tap_offsets)
        assert t != tables[0]


def test_planefitting_upper_bounded_by_fronto(rng):
    """min over 4 hypotheses can only improve on the fronto-parallel cost."""
    cfg = CostConfig(patch_radius=3, sigma_spatial=1.5)
    h, w = 8, 9
    img1, img2, cen1, cen2 = _mk(rng, h, w)
    p1 = pack_frame(jnp.asarray(img1), jnp.asarray(cen1))
    p2 = pack_frame(jnp.asarray(img2), jnp.asarray(cen2))
    tx = jnp.asarray(rng.integers(0, w, (h, w)), jnp.int32)
    ty = jnp.asarray(rng.integers(0, h, (h, w)), jnp.int32)
    fronto = np.asarray(patch_cost(p1, p2, tx, ty, cfg))
    plane = np.asarray(patch_cost_planefitting(p1, p2, tx, ty, cfg))
    assert (plane <= fronto + 1e-6).all()


def test_center_out_offsets_plus_shape():
    """The "plus" candidate set is the L1 ball, center-first, a subset of
    the square set in the same center-out order (tie-keeping semantics of
    dense_refine_flow depend on that order)."""
    from eppm.ops.dense import center_out_offsets

    plus = center_out_offsets(1, "plus")
    assert plus[0] == (0, 0)
    assert set(plus) == {(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)}
    square = center_out_offsets(1)
    assert [c for c in square if abs(c[0]) + abs(c[1]) <= 1] == plus
    assert len(center_out_offsets(2, "plus")) == 13
    import pytest
    with pytest.raises(ValueError):
        center_out_offsets(1, "diamondX")


def test_dense_refine_plus_recovers_translation(rng):
    """dense_refine_flow with the plus candidate set still converges to an
    exact integer translation (diagonal component resolved across passes)."""
    from eppm.config import CostConfig
    from eppm.ops.dense import dense_refine_flow, median3_flow

    h, w = 48, 64
    # Smooth (spatially correlated) texture: the plus set hill-climbs a
    # diagonal via two axis steps, which needs a cost gradient at
    # half-aligned offsets — i.i.d. noise has none, real images do.
    import jax

    coarse = rng.random((h // 4 + 1, w // 4 + 1, 3)).astype(np.float32)
    rgb = np.asarray(jax.image.resize(jnp.asarray(coarse), (h, w, 3),
                                      "bilinear"), np.float32)
    pack2 = np.concatenate([rgb, np.zeros((h, w, 1), np.float32)], axis=-1)
    dy, dx = 1, 1  # diagonal: not reachable in one plus-pass
    pack1 = np.roll(pack2, (dy, dx), axis=(0, 1))
    p1 = jnp.asarray(pack1)
    p2 = jnp.asarray(pack2)
    cfg = CostConfig()
    flow = jnp.zeros((h, w, 2), jnp.float32)
    for _ in range(3):
        flow = dense_refine_flow(
            median3_flow(flow), p1, p2, cfg, 1, False, 25,
            cand_shape="plus",
        )
    f = np.asarray(flow)[8:-8, 8:-8]
    # Raw refine passes, no median/smoothing cleanup as in the pipeline:
    # ~90% exact recovery measured; locally-flat patches legitimately
    # stall (no cost gradient at half-aligned offsets).
    assert (np.abs(f[..., 0] - (-dx)) < 1e-6).mean() > 0.85
    assert (np.abs(f[..., 1] - (-dy)) < 1e-6).mean() > 0.85
    # A pure-axis step is inside the plus set: one pass, exact everywhere.
    pack1x = np.roll(pack2, 1, axis=1)
    fx = dense_refine_flow(
        jnp.zeros((h, w, 2), jnp.float32), jnp.asarray(pack1x), p2,
        cfg, 1, False, 25, cand_shape="plus",
    )
    fxi = np.asarray(fx)[8:-8, 8:-8]
    assert (np.abs(fxi[..., 0] + 1) < 1e-6).mean() > 0.99
    assert (np.abs(fxi[..., 1]) < 1e-6).mean() > 0.99
