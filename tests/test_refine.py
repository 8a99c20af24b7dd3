"""Refinement-stage tests against literal NumPy oracles of the reference
CUDA kernels (bao_pmflow_refine_kernel.cu)."""

import numpy as np
import jax.numpy as jnp

from eppm.config import (
    FLT_MAX,
    INVALID_LOCATION,
    UNKNOWN_FLOW,
    CostConfig,
    RefineConfig,
)
from eppm.ops.refine import (
    fill_holes,
    flow_smoothing,
    flow_to_nnf,
    lr_check,
    nnf_to_flow,
    outlier_removal,
    weighted_median_filter,
)


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


# ---------- left-right check ----------

def oracle_lr_one(tx, ty, cost, tx2, ty2, thresh=0):
    h, w = tx.shape
    otx, oty, oc = tx.copy(), ty.copy(), cost.copy()
    for y in range(h):
        for x in range(w):
            X, Y = tx[y, x], ty[y, x]
            if X < 0 or X >= w or Y < 0 or Y >= h:
                otx[y, x] = oty[y, x] = INVALID_LOCATION
                oc[y, x] = FLT_MAX
            elif abs(tx2[Y, X] - x) > thresh or abs(ty2[Y, X] - y) > thresh:
                otx[y, x] = oty[y, x] = INVALID_LOCATION
                oc[y, x] = FLT_MAX
    return otx, oty, oc


def test_lr_check_matches_oracle(rng):
    h, w = 9, 11
    tx1 = rng.integers(-2, w + 2, (h, w)).astype(np.int32)
    ty1 = rng.integers(-2, h + 2, (h, w)).astype(np.int32)
    tx2 = rng.integers(0, w, (h, w)).astype(np.int32)
    ty2 = rng.integers(0, h, (h, w)).astype(np.int32)
    c1 = rng.random((h, w)).astype(np.float32)
    c2 = rng.random((h, w)).astype(np.float32)
    # make some pixels mutually consistent
    for y in range(0, h, 2):
        for x in range(0, w, 2):
            X, Y = (x + 1) % w, y
            tx1[y, x], ty1[y, x] = X, Y
            tx2[Y, X], ty2[Y, X] = x, y
    got = lr_check(*(jnp.asarray(a) for a in (tx1, ty1, c1, tx2, ty2, c2)))
    w1 = oracle_lr_one(tx1, ty1, c1, tx2, ty2)
    w2 = oracle_lr_one(tx2, ty2, c2, w1[0], w1[1])  # pass 2 sees pass 1
    for g, want in zip(got, w1 + w2):
        np.testing.assert_array_equal(np.asarray(g), want)


def test_lr_check_keeps_consistent_pixels():
    h = w = 4
    ys, xs = np.mgrid[0:h, 0:w]
    tx1 = ((xs + 1) % w).astype(np.int32)  # shift right with wrap
    ty1 = ys.astype(np.int32)
    # backward field maps back exactly
    tx2 = ((xs - 1) % w).astype(np.int32)
    ty2 = ys.astype(np.int32)
    c = np.zeros((h, w), np.float32)
    r = lr_check(*(jnp.asarray(a) for a in (tx1, ty1, c, tx2, ty2, c)))
    np.testing.assert_array_equal(np.asarray(r[0]), tx1)
    assert (np.asarray(r[2]) < FLT_MAX).all()


# ---------- outlier removal ----------

def oracle_outlier(tx, ty, cost, cfg):
    h, w = tx.shape
    r, sim, thresh = cfg.stat_radius, cfg.stat_sim_thresh, cfg.stat_count_thresh
    otx, oty, oc = tx.copy(), ty.copy(), cost.copy()
    for y in range(h):
        for x in range(w):
            if tx[y, x] < 0 and ty[y, x] < 0:
                continue
            cu, cv = tx[y, x] - x, ty[y, x] - y
            count = 0
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    cy, cx = y + dy, x + dx
                    if cx < 0 or cy < 0 or cx >= w or cy >= h:
                        continue
                    nu, nv = tx[cy, cx] - cx, ty[cy, cx] - cy
                    if abs(nu - cu) <= sim and abs(nv - cv) <= sim:
                        count += 1
            if count < thresh:
                otx[y, x] = oty[y, x] = INVALID_LOCATION
                oc[y, x] = FLT_MAX
    return otx, oty, oc


def test_outlier_removal_matches_oracle(rng):
    # stat_proportional=False: bit-faithful reference semantics
    cfg = RefineConfig(stat_radius=2, stat_proportional=False)
    h, w = 12, 14
    ys, xs = np.mgrid[0:h, 0:w]
    # mostly-constant field with a few outliers
    tx = (xs + 3).astype(np.int32)
    ty = (ys + 1).astype(np.int32)
    for _ in range(6):
        y, x = rng.integers(0, h), rng.integers(0, w)
        tx[y, x] = rng.integers(0, w)
        ty[y, x] = rng.integers(0, h)
    cost = rng.random((h, w)).astype(np.float32)
    got = outlier_removal(
        jnp.asarray(tx), jnp.asarray(ty), jnp.asarray(cost), cfg
    )
    want = oracle_outlier(tx, ty, cost, cfg)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), wv)


def oracle_outlier_proportional(tx, ty, cost, cfg):
    """Proportional variant: survive when similar >= max(valid//2, 4)."""
    h, w = tx.shape
    r, sim = cfg.stat_radius, cfg.stat_sim_thresh
    otx, oty, oc = tx.copy(), ty.copy(), cost.copy()
    for y in range(h):
        for x in range(w):
            if tx[y, x] < 0 and ty[y, x] < 0:
                continue
            cu, cv = tx[y, x] - x, ty[y, x] - y
            count = 0
            nvalid = 0
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    cy, cx = y + dy, x + dx
                    if cx < 0 or cy < 0 or cx >= w or cy >= h:
                        continue
                    if not (tx[cy, cx] < 0 and ty[cy, cx] < 0):
                        nvalid += 1
                    nu, nv = tx[cy, cx] - cx, ty[cy, cx] - cy
                    if abs(nu - cu) <= sim and abs(nv - cv) <= sim:
                        count += 1
            if count < max(nvalid // 2, 4):
                otx[y, x] = oty[y, x] = INVALID_LOCATION
                oc[y, x] = FLT_MAX
    return otx, oty, oc


def test_outlier_removal_proportional_matches_oracle(rng):
    cfg = RefineConfig(stat_radius=2, stat_proportional=True)
    h, w = 12, 14
    ys, xs = np.mgrid[0:h, 0:w]
    tx = (xs + 3).astype(np.int32)
    ty = (ys + 1).astype(np.int32)
    # sprinkle outliers and a large invalidated region (the scattered-
    # survivor scenario the proportional threshold exists for)
    for _ in range(6):
        y, x = rng.integers(0, h), rng.integers(0, w)
        tx[y, x] = rng.integers(0, w)
        ty[y, x] = rng.integers(0, h)
    mask = rng.random((h, w)) < 0.7
    tx = np.where(mask, INVALID_LOCATION, tx).astype(np.int32)
    ty = np.where(mask, INVALID_LOCATION, ty).astype(np.int32)
    cost = rng.random((h, w)).astype(np.float32)
    got = outlier_removal(
        jnp.asarray(tx), jnp.asarray(ty), jnp.asarray(cost), cfg
    )
    want = oracle_outlier_proportional(tx, ty, cost, cfg)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), wv)
    # sanity: scattered consistent survivors are NOT wiped (the fixed
    # threshold would cull them all)
    surv = (np.asarray(got[0]) != INVALID_LOCATION) & ~mask
    assert surv.sum() > 0


# ---------- weighted median filter ----------

def oracle_wmf(tx, ty, img, cfg, only_occlusion):
    h, w = tx.shape
    r = cfg.wmf_radius
    sig_r2, sig_s2 = cfg.wmf_sigma_range**2, cfg.wmf_sigma_spatial**2
    otx, oty = tx.copy(), ty.copy()
    for y in range(h):
        for x in range(w):
            if only_occlusion and tx[y, x] >= 0 and ty[y, x] >= 0:
                continue
            best = None
            min_cost = np.inf
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    cy, cx = y + dy, x + dx
                    if cx < 0 or cy < 0 or cx >= w or cy >= h:
                        continue
                    if tx[cy, cx] < 0 or ty[cy, cx] < 0:
                        continue
                    cu, cv = tx[cy, cx] - cx, ty[cy, cx] - cy
                    cost_sum, weight_sum = np.float32(0), np.float32(0)
                    for sy in range(-r, r + 1):
                        for sx in range(-r, r + 1):
                            py, px = y + sy, x + sx
                            if px < 0 or py < 0 or px >= w or py >= h:
                                continue
                            if tx[py, px] < 0 or ty[py, px] < 0:
                                continue
                            su, sv = tx[py, px] - px, ty[py, px] - py
                            dr = np.max(np.abs(img[py, px] - img[y, x]))
                            # f32 exp like CUDA __expf: tiny weights
                            # underflow to zero, not 1e-300
                            wgt = np.float32(
                                np.exp(np.float32(-dr * dr / sig_r2))
                            ) * np.float32(
                                np.exp(-(sx * sx) / sig_s2)
                            ) * np.float32(np.exp(-(sy * sy) / sig_s2))
                            cost_sum += wgt * np.float32(
                                max(abs(cu - su), abs(cv - sv))
                            )
                            weight_sum += wgt
                    if weight_sum > 0 and cost_sum < min_cost:
                        min_cost = cost_sum
                        best = (cu + x, cv + y)
            if best is not None and best[0] >= 0 and best[1] >= 0:
                otx[y, x], oty[y, x] = best
    return otx, oty


def _field_with_holes(rng, h, w):
    ys, xs = np.mgrid[0:h, 0:w]
    tx = (xs + 2).astype(np.int32)
    ty = ys.astype(np.int32)
    for _ in range(8):
        y, x = rng.integers(0, h), rng.integers(0, w)
        tx[y, x] = ty[y, x] = INVALID_LOCATION
    img = rng.random((h, w, 3)).astype(np.float32)
    return tx, ty, img


def test_wmf_matches_oracle_occlusion_mode(rng):
    cfg = RefineConfig(wmf_radius=2, wmf_sigma_spatial=2.0, wmf_sigma_range=0.5)
    tx, ty, img = _field_with_holes(rng, 10, 12)
    got = weighted_median_filter(
        jnp.asarray(tx), jnp.asarray(ty), jnp.asarray(img), cfg,
        num_iter=1, only_occlusion=True,
    )
    want = oracle_wmf(tx, ty, img, cfg, True)
    np.testing.assert_array_equal(np.asarray(got[0]), want[0])
    np.testing.assert_array_equal(np.asarray(got[1]), want[1])


def test_wmf_matches_oracle_full(rng):
    cfg = RefineConfig(wmf_radius=1, wmf_sigma_spatial=1.0, wmf_sigma_range=0.5)
    tx, ty, img = _field_with_holes(rng, 8, 9)
    got = weighted_median_filter(
        jnp.asarray(tx), jnp.asarray(ty), jnp.asarray(img), cfg,
        num_iter=1, only_occlusion=False,
    )
    want = oracle_wmf(tx, ty, img, cfg, False)
    np.testing.assert_array_equal(np.asarray(got[0]), want[0])
    np.testing.assert_array_equal(np.asarray(got[1]), want[1])


def test_wmf_polish_mode_invariants(rng):
    """Frozen-valid polish mode (ops/refine.py::wmf_polish_occlusions
    composition): valid pixels pass through untouched, holes become
    valid wherever the fill found a valid target, one iteration is the
    fixed point (candidates/supports are frozen), and holes whose window
    holds an originally-valid pixel take a polished value while
    unreachable holes keep the fill exactly."""
    from eppm.ops.refine import fill_holes

    cfg = RefineConfig(wmf_radius=2, wmf_sigma_spatial=2.0,
                       wmf_sigma_range=0.5)
    h, w = 20, 26
    ys, xs = np.mgrid[0:h, 0:w]
    tx = np.clip(xs + rng.integers(-2, 3, (h, w)), 0, w - 1).astype(np.int32)
    ty = np.clip(ys + rng.integers(-2, 3, (h, w)), 0, h - 1).astype(np.int32)
    # a band of holes wider than the window diameter + scattered holes
    hole = (xs >= 8) & (xs <= 17)
    hole |= rng.random((h, w)) < 0.1
    tx = np.where(hole, INVALID_LOCATION, tx)
    ty = np.where(hole, INVALID_LOCATION, ty)
    jt, jy, ji = jnp.asarray(tx), jnp.asarray(ty), jnp.asarray(
        rng.random((h, w, 3)).astype(np.float32)
    )
    ftx, fty = fill_holes(jt, jy, ji)
    o1 = weighted_median_filter(jt, jy, ji, cfg, num_iter=1,
                                polish_init=(ftx, fty))
    o3 = weighted_median_filter(jt, jy, ji, cfg, num_iter=3,
                                polish_init=(ftx, fty))
    otx, oty = np.asarray(o1[0]), np.asarray(o1[1])
    valid0 = (tx >= 0) & (ty >= 0)
    np.testing.assert_array_equal(otx[valid0], tx[valid0])
    np.testing.assert_array_equal(oty[valid0], ty[valid0])
    np.testing.assert_array_equal(np.asarray(o3[0]), otx)
    np.testing.assert_array_equal(np.asarray(o3[1]), oty)
    fv = (np.asarray(ftx) >= 0) & (np.asarray(fty) >= 0)
    assert ((otx >= 0) & (oty >= 0))[~valid0 & fv].all()
    # band centers beyond the window's reach from any valid pixel keep
    # the fill; holes within reach of valid data get re-medianed
    r = cfg.wmf_radius
    pv = np.pad(valid0, r)
    reach = np.zeros_like(valid0)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            reach |= pv[r + dy:r + dy + h, r + dx:r + dx + w]
    far = ~valid0 & ~reach
    assert far.any()
    np.testing.assert_array_equal(otx[far], np.asarray(ftx)[far])
    np.testing.assert_array_equal(oty[far], np.asarray(fty)[far])


def test_polish_unreachable_fill_bounded(rng):
    """A hole whose entire row AND column are invalid defeats the
    4-direction scanline fill; the polish path must bound such holes to
    zero offset rather than let the INVALID sentinel smear through the
    median stages into plausible-looking garbage flows (the round-4
    QUALITY blowup: 240x320 translation cases at 130-600 EPE)."""
    import dataclasses

    from eppm.ops.refine import coarse_occlusion_reconstruct

    cfg = RefineConfig(wmf_radius=2, wmf_sigma_spatial=2.0,
                       wmf_sigma_range=0.5)
    h, w = 24, 30
    ys, xs = np.mgrid[0:h, 0:w]
    tx = xs.astype(np.int32) + 2
    ty = ys.astype(np.int32)
    # a cross of invalid rows/columns: its intersection is unreachable
    hole = (ys < 6) | (xs < 8)
    tx = np.where(hole, INVALID_LOCATION, tx)
    ty = np.where(hole, INVALID_LOCATION, ty)
    ji = jnp.asarray(rng.random((h, w, 3)).astype(np.float32))
    out = coarse_occlusion_reconstruct(
        jnp.asarray(tx), jnp.asarray(ty), ji,
        dataclasses.replace(cfg, wmf_fill_first=True),
    )
    otx, oty = np.asarray(out[0]), np.asarray(out[1])
    # every output target is a bounded image-scale coordinate: no raw
    # or median-smeared sentinels (e.g. -10000, -3000) anywhere
    assert otx.min() > -2 * max(h, w) and oty.min() > -2 * max(h, w)
    assert otx.max() < 2 * max(h, w) and oty.max() < 2 * max(h, w)


def test_coarse_occlusion_reconstruct_paths(rng):
    """Both orders of the shared coarse occlusion chain run and return
    fully-usable fields; the fill-first path equals fill + 1-iter
    frozen-valid polish composed by hand."""
    import dataclasses

    from eppm.ops.refine import (
        coarse_occlusion_reconstruct, wmf_polish_occlusions,
    )

    cfg = RefineConfig(wmf_radius=2, wmf_sigma_spatial=2.0,
                       wmf_sigma_range=0.5)
    h, w = 16, 22
    ys, xs = np.mgrid[0:h, 0:w]
    tx = np.clip(xs - 1, 0, w - 1).astype(np.int32)
    ty = np.clip(ys + 1, 0, h - 1).astype(np.int32)
    hole = rng.random((h, w)) < 0.25
    tx = np.where(hole, INVALID_LOCATION, tx)
    ty = np.where(hole, INVALID_LOCATION, ty)
    jt, jy = jnp.asarray(tx), jnp.asarray(ty)
    ji = jnp.asarray(rng.random((h, w, 3)).astype(np.float32))
    # with the extra reconstruction stages disabled, fill-first reduces
    # to the bare fill + 1-iter frozen-valid polish composed by hand
    bare = dataclasses.replace(
        cfg, wmf_fill_first=True, fill_patch_radius=0,
        fill_median_rounds=0,
    )
    a = coarse_occlusion_reconstruct(jt, jy, ji, bare)
    b = wmf_polish_occlusions(jt, jy, ji, cfg, num_iter=1)
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
    # the full default fill-first chain (patch-SAD fill + median
    # correction) runs and returns fully-usable fields
    full = coarse_occlusion_reconstruct(
        jt, jy, ji, dataclasses.replace(cfg, wmf_fill_first=True)
    )
    legacy = coarse_occlusion_reconstruct(jt, jy, ji, cfg)
    for f in (a, full, legacy):
        assert np.asarray(f[0]).shape == (h, w)
    valid0 = (tx >= 0) & (ty >= 0)
    np.testing.assert_array_equal(np.asarray(full[0])[valid0], tx[valid0])
    np.testing.assert_array_equal(np.asarray(full[1])[valid0], ty[valid0])


# ---------- hole filling ----------

def oracle_fill(tx, ty, img):
    h, w = tx.shape
    otx, oty = tx.copy(), ty.copy()
    for y in range(h):
        for x in range(w):
            if tx[y, x] >= 0 and ty[y, x] >= 0:
                continue
            cands = []  # (pixdiff, u, v) in direction order
            for rng_, fixed_axis in (
                (range(x - 1, -1, -1), "x"),
                (range(x + 1, w), "x"),
                (range(y - 1, -1, -1), "y"),
                (range(y + 1, h), "y"),
            ):
                found = None
                for c in rng_:
                    cy, cx = (y, c) if fixed_axis == "x" else (c, x)
                    if tx[cy, cx] >= 0 and ty[cy, cx] >= 0:
                        found = (cy, cx)
                        break
                if found:
                    cy, cx = found
                    diff = np.max(np.abs(img[cy, cx] - img[y, x]))
                    cands.append((diff, tx[cy, cx] - cx, ty[cy, cx] - cy))
            if cands:
                best = min(cands, key=lambda t: t[0])
                otx[y, x] = best[1] + x
                oty[y, x] = best[2] + y
    return otx, oty


def test_fill_holes_matches_oracle(rng):
    h, w = 10, 13
    tx, ty, img = _field_with_holes(rng, h, w)
    # a full occluded column and row segment
    tx[:, 5] = ty[:, 5] = INVALID_LOCATION
    tx[3, :7] = ty[3, :7] = INVALID_LOCATION
    got = fill_holes(jnp.asarray(tx), jnp.asarray(ty), jnp.asarray(img))
    want = oracle_fill(tx, ty, img)
    np.testing.assert_array_equal(np.asarray(got[0]), want[0])
    np.testing.assert_array_equal(np.asarray(got[1]), want[1])


def test_fill_holes_noop_when_all_valid(rng):
    h, w = 6, 7
    ys, xs = np.mgrid[0:h, 0:w]
    tx = ((xs + 1) % w).astype(np.int32)
    ty = ys.astype(np.int32)
    img = rng.random((h, w, 3)).astype(np.float32)
    got = fill_holes(jnp.asarray(tx), jnp.asarray(ty), jnp.asarray(img))
    np.testing.assert_array_equal(np.asarray(got[0]), tx)
    np.testing.assert_array_equal(np.asarray(got[1]), ty)


# ---------- NNF <-> flow ----------

def test_nnf_flow_roundtrip(rng):
    h, w = 7, 9
    ys, xs = np.mgrid[0:h, 0:w]
    tx = rng.integers(0, w, (h, w)).astype(np.int32)
    ty = rng.integers(0, h, (h, w)).astype(np.int32)
    tx[2, 3] = ty[2, 3] = INVALID_LOCATION
    flow = np.asarray(nnf_to_flow(jnp.asarray(tx), jnp.asarray(ty)))
    assert flow[2, 3, 0] == UNKNOWN_FLOW
    np.testing.assert_array_equal(flow[0, 0], [tx[0, 0], ty[0, 0]])
    btx, bty = flow_to_nnf(jnp.asarray(flow))
    np.testing.assert_array_equal(np.asarray(btx), tx)
    np.testing.assert_array_equal(np.asarray(bty), ty)


# ---------- flow smoothing ----------

def oracle_blf(flow, img, cfg):
    h, w = flow.shape[:2]
    r = cfg.blf_radius
    sig_r2, sig_s2 = cfg.blf_sigma_range**2, cfg.blf_sigma_spatial**2
    out = flow.copy()
    for y in range(h):
        for x in range(w):
            acc = np.zeros(2)
            wsum = 0.0
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    cy, cx = y + dy, x + dx
                    if cx < 0 or cy < 0 or cx >= w or cy >= h:
                        continue
                    f = flow[cy, cx]
                    if f[0] > 1e9 or f[1] > 1e9:
                        continue
                    dr = np.max(np.abs(img[cy, cx] - img[y, x]))
                    # f32 exp like CUDA __expf (tiny weights flush to 0)
                    wgt = np.exp(np.float32(-dr * dr / sig_r2)) * np.float32(
                        np.exp(-(dx * dx) / sig_s2)
                    ) * np.float32(np.exp(-(dy * dy) / sig_s2))
                    acc += wgt * f
                    wsum += wgt
            if wsum != 0:
                out[y, x] = acc / wsum
    return out


def test_flow_smoothing_matches_oracle(rng):
    # sigma_range 0.5 keeps range weights in normal f32 range: XLA and CUDA
    # __expf flush subnormals to zero while NumPy keeps them, so the
    # default 0.02 makes oracle comparison flaky at strong color edges
    cfg = RefineConfig(blf_sigma_spatial=1.5, blf_sigma_range=0.5)
    h, w = 9, 10
    flow = rng.normal(size=(h, w, 2)).astype(np.float32)
    flow[4, 4] = UNKNOWN_FLOW
    img = rng.random((h, w, 3)).astype(np.float32)
    got = np.asarray(flow_smoothing(jnp.asarray(flow), jnp.asarray(img), cfg))
    want = oracle_blf(flow, img, cfg)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_flow_smoothing_preserves_constant_flow(rng):
    cfg = RefineConfig(blf_sigma_spatial=2.0)
    flow = np.full((8, 8, 2), 3.0, np.float32)
    img = rng.random((8, 8, 3)).astype(np.float32)
    got = np.asarray(flow_smoothing(jnp.asarray(flow), jnp.asarray(img), cfg))
    np.testing.assert_allclose(got, flow, rtol=1e-5)


def test_fill_photometric_arbitration_recovers_visible(rng):
    """Photometric fill arbitration (round 5): a mis-invalidated but
    VISIBLE pixel whose directional color fill would pick the wrong
    side is recovered by the true patch cost against frame 2, while
    with the feature off the color fill keeps its pick
    (config.RefineConfig.fill_photometric_thresh)."""
    import dataclasses

    from eppm.ops.census import census_transform
    from eppm.ops.cost import pack_frame
    from eppm.ops.refine import coarse_occlusion_reconstruct
    from eppm.config import CostConfig

    h, w = 32, 40
    # frame 1: textured left half, differently textured right half
    img1 = rng.random((h, w, 3)).astype(np.float32)
    # frame 2 = frame 1 shifted right by 3 (global flow u=+3)
    img2 = np.roll(img1, 3, axis=1)
    ys, xs = np.mgrid[0:h, 0:w]
    tx = (xs + 3).astype(np.int32)
    ty = ys.astype(np.int32)
    # invalidate an interior block although it is visible in both frames
    hole = (ys >= 12) & (ys < 20) & (xs >= 16) & (xs < 24)
    # bias the hole's surroundings: make the RIGHT-side neighbors carry a
    # wrong flow (u = -5) so a wrong color pick is observable
    wrong = (~hole) & (xs >= 24) & (xs < 30) & (ys >= 12) & (ys < 20)
    tx = np.where(wrong, xs - 5, tx)
    txh = np.where(hole, -30000, tx)
    tyh = np.where(hole, -30000, ty)

    j1 = jnp.asarray(img1)
    j2 = jnp.asarray(img2)
    p1 = pack_frame(j1, census_transform(j1))
    p2 = pack_frame(j2, census_transform(j2))
    ccfg = CostConfig()
    rcfg = RefineConfig(wmf_radius=2, wmf_sigma_spatial=2.0,
                        wmf_sigma_range=0.5, wmf_fill_first=True,
                        fill_median_rounds=0,
                        fill_photometric_thresh=0.9)
    out = coarse_occlusion_reconstruct(
        jnp.asarray(txh), jnp.asarray(tyh), j1, rcfg,
        packs=(p1, p2), cost_cfg=ccfg,
        orig=(jnp.asarray(tx), jnp.asarray(ty)),
    )
    otx = np.asarray(out[0])
    # arbitrated: the hole's recovered offsets are the true u=+3 for the
    # clear majority of hole pixels (photometric cost identifies them)
    rec_u = (otx - xs)[hole]
    assert (rec_u == 3).mean() > 0.75, rec_u

    off = dataclasses.replace(rcfg, fill_photometric_thresh=0.0)
    out2 = coarse_occlusion_reconstruct(
        jnp.asarray(txh), jnp.asarray(tyh), j1, off,
        packs=(p1, p2), cost_cfg=ccfg,
        orig=(jnp.asarray(tx), jnp.asarray(ty)),
    )
    # feature off: same call signature still works (packs ignored)
    assert np.asarray(out2[0]).shape == (h, w)


def test_flow_smoothing_ragged_matches_brute_force(rng):
    """flow_smoothing at the default 441-tap window (radius 10) on a
    ragged 37x83 field against a NumPy brute force that loops over the
    window offsets: out-of-image and unknown-flow taps are skipped,
    empty windows keep their value."""
    cfg = RefineConfig(blf_sigma_range=0.5)  # normal-range f32 weights
    h, w = 37, 83
    r = cfg.blf_radius
    assert (2 * r + 1) ** 2 == 441
    flow = rng.normal(0, 5, (h, w, 2)).astype(np.float32)
    flow[rng.random((h, w)) < 0.1] = UNKNOWN_FLOW
    img = rng.random((h, w, 3)).astype(np.float32)
    got = np.asarray(flow_smoothing(jnp.asarray(flow), jnp.asarray(img), cfg))

    known = (flow[..., 0] <= 1e9) & (flow[..., 1] <= 1e9)
    pf = np.pad(np.where(known[..., None], flow, 0.0), ((r, r), (r, r), (0, 0)))
    pk = np.pad(known, r)
    pimg = np.pad(img, ((r, r), (r, r), (0, 0)))
    acc = np.zeros((h, w, 2), np.float64)
    wsum = np.zeros((h, w), np.float64)
    sig_r2, sig_s2 = cfg.blf_sigma_range ** 2, cfg.blf_sigma_spatial ** 2
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            sl = (slice(r + dy, r + dy + h), slice(r + dx, r + dx + w))
            dr = np.abs(pimg[sl] - img).max(axis=-1)
            wgt = (
                np.exp(-(dr * dr) / sig_r2)
                * np.exp(-(dy * dy) / sig_s2) * np.exp(-(dx * dx) / sig_s2)
                * pk[sl]
            )
            acc += wgt[..., None] * pf[sl]
            wsum += wgt
    want = np.where(
        (wsum > 0)[..., None], acc / np.maximum(wsum, 1e-300)[..., None], flow
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_occlusion_reconstruction_lives_in_refine():
    """The occlusion chain is plain JAX in ops/refine.py."""
    from eppm.ops import refine

    for name in ("coarse_occlusion_reconstruct", "wmf_polish_occlusions",
                 "_photometric_arbitrate"):
        assert getattr(refine, name).__module__ == "eppm.ops.refine"
    assert {"coarse_occlusion_reconstruct", "wmf_polish_occlusions"} <= set(
        refine.__all__
    )
