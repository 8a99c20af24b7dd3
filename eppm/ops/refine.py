"""Flow refinement chain: left-right check, outlier removal, weighted
median filtering, hole filling, NNF<->flow conversion, joint-bilateral flow
smoothing, coarse-to-fine refinement, and the non-default extras (cutoff,
still-region suppression).

Spec source: bao_pmflow_refine_kernel.cu.  Every stage is a pure function
of (target fields, cost, image); value-dependent control flow from the CUDA
kernels (``continue``/early return) becomes masking.  The stages are
stencils expressed as chunked ``lax.scan`` over window offsets so the HLO
stays compact and peak memory is bounded at ``chunk * H * W`` floats.

Conventions (identical to the reference):
  - NNF = absolute int32 target coordinates (tx, ty); INVALID_LOCATION marks
    culled pixels, FLT_MAX their cost (refine_kernel.cu:46,62-63).
  - A pixel is "occluded"/invalid when tx < 0 or ty < 0
    (refine_kernel.cu:213,304).
  - flow = target - position; unknown flow = 1e10 (:644-653).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import (
    FLT_MAX,
    INVALID_LOCATION,
    UNKNOWN_FLOW,
    UNKNOWN_FLOW_THRESH,
    CostConfig,
    RefineConfig,
)
from ._util import grid as _grid_util
from .cost import patch_cost_planefitting, patch_cost_ad_l2

__all__ = [
    "lr_check",
    "outlier_removal",
    "weighted_median_filter",
    "fill_holes",
    "nnf_to_flow",
    "flow_to_nnf",
    "flow_smoothing",
    "blf_refine_flow",
    "flow_cutoff",
    "median_filter",
    "guide_image_smoothing",
    "eliminate_still_region",
    "wmf_polish_occlusions",
    "coarse_occlusion_reconstruct",
]


_grid = _grid_util


def _window_offsets(radius: int, chunk: int):
    """(n_chunks, chunk, 2) int offsets + (n_chunks, chunk) validity pad."""
    offs = [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)]
    n = len(offs)
    n_pad = (-n) % chunk
    offs += [(0, 0)] * n_pad
    valid = [1.0] * n + [0.0] * n_pad
    return (
        np.asarray(offs, np.int32).reshape(-1, chunk, 2),
        np.asarray(valid, np.float32).reshape(-1, chunk),
    )


def _lr_check_one(tx, ty, cost, tx2, ty2, thresh: int):
    """One direction of d_left_right_check (refine_kernel.cu:53-76)."""
    h, w = tx.shape
    ys, xs = _grid(h, w)
    oob = (tx < 0) | (tx >= w) | (ty < 0) | (ty >= h)
    txc = jnp.clip(tx, 0, w - 1)
    tyc = jnp.clip(ty, 0, h - 1)
    idx = tyc * w + txc
    back_x = jnp.take(tx2.reshape(-1), idx)
    back_y = jnp.take(ty2.reshape(-1), idx)
    incons = (jnp.abs(back_x - xs) > thresh) | (jnp.abs(back_y - ys) > thresh)
    bad = oob | incons
    inv = jnp.int32(INVALID_LOCATION)
    return (
        jnp.where(bad, inv, tx),
        jnp.where(bad, inv, ty),
        jnp.where(bad, FLT_MAX, cost),
    )


@jax.named_scope("lr_check")
def lr_check(tx1, ty1, cost1, tx2, ty2, cost2, thresh: int = 0):
    """Bidirectional left-right consistency check.

    Matches the reference launch order (refine_kernel.cu:89-90): direction 1
    is checked against the original field 2, then direction 2 against the
    *already-culled* field 1 (the CUDA kernels run back-to-back on one
    stream, so pass 2 sees pass 1's invalidations).
    """
    ntx1, nty1, nc1 = _lr_check_one(tx1, ty1, cost1, tx2, ty2, thresh)
    ntx2, nty2, nc2 = _lr_check_one(tx2, ty2, cost2, ntx1, nty1, thresh)
    return ntx1, nty1, nc1, ntx2, nty2, nc2


@jax.named_scope("outlier")
def outlier_removal(
    tx, ty, cost, cfg: RefineConfig = RefineConfig(), chunk: int = 13
):
    """Invalidate isolated displacements (refine_kernel.cu:149-193).

    A non-occluded pixel survives when at least (2R+1)^2/2 in-image window
    neighbors carry a displacement within +-STAT_SIM_THRESH in both
    components.  Out-of-image neighbors are skipped (``continue``), so
    border pixels see smaller windows against the same fixed threshold —
    faithfully reproduced (corner pixels are always culled, as in CUDA).
    """
    h, w = tx.shape
    r = cfg.stat_radius
    ys, xs = _grid(h, w)
    ox = (tx - xs).astype(jnp.float32)
    oy = (ty - ys).astype(jnp.float32)
    # sentinel pad: out-of-image neighbors never match
    big = jnp.float32(1e9)
    pox = jnp.pad(ox, r, constant_values=1e9)
    poy = jnp.pad(oy, r, constant_values=1e9)
    # validity of each neighbor (in-image and not lr-invalidated);
    # only accumulated on the proportional path
    vfield = ((tx >= 0) | (ty >= 0)).astype(jnp.float32)
    pval = jnp.pad(vfield, r, constant_values=0.0)

    offs, valid = _window_offsets(r, chunk)

    def tap(off, val):
        dy, dx = off[0], off[1]
        nox = jax.lax.dynamic_slice(pox, (r + dy, r + dx), (h, w))
        noy = jax.lax.dynamic_slice(poy, (r + dy, r + dx), (h, w))
        sim = (jnp.abs(nox - ox) <= cfg.stat_sim_thresh) & (
            jnp.abs(noy - oy) <= cfg.stat_sim_thresh
        )
        nv = jax.lax.dynamic_slice(pval, (r + dy, r + dx), (h, w))
        return sim.astype(jnp.float32) * val, nv * val

    def step(carry, data):
        acc, accv = carry
        off, val = data
        s, v = jax.vmap(tap)(off, val)
        return (acc + s.sum(0), accv + v.sum(0)), None

    (count, vcount), _ = jax.lax.scan(
        step,
        (jnp.zeros((h, w), jnp.float32), jnp.zeros((h, w), jnp.float32)),
        (jnp.asarray(offs), jnp.asarray(valid)),
    )
    occluded = (tx < 0) & (ty < 0)  # skipped pixels (refine_kernel.cu:156)
    # half the valid window population (== the reference threshold in
    # fully-valid windows), floored at 4 so isolated pixels still die
    prop_thresh = jnp.maximum(jnp.floor(vcount / 2.0), 4.0)
    if cfg.stat_proportional:
        cull = (~occluded) & (count < prop_thresh)
    else:
        cull = (~occluded) & (count < cfg.stat_count_thresh)
        if cfg.stat_collapse_guard > 0:
            # per-frame guard: if fixed culling wipes almost every
            # survivor, fall back to the proportional threshold
            n_valid = jnp.maximum(jnp.sum(vfield), 1.0)
            kept = jnp.sum(vfield * (~cull).astype(jnp.float32))
            collapse = kept / n_valid < cfg.stat_collapse_guard
            cull_prop = (~occluded) & (count < prop_thresh)
            cull = jnp.where(collapse, cull_prop, cull)
    inv = jnp.int32(INVALID_LOCATION)
    return (
        jnp.where(cull, inv, tx),
        jnp.where(cull, inv, ty),
        jnp.where(cull, FLT_MAX, cost),
    )


@jax.named_scope("wmf")
def weighted_median_filter(
    tx,
    ty,
    img,
    cfg: RefineConfig = RefineConfig(),
    num_iter: int = 1,
    only_occlusion: bool = False,
    support_chunk: int = 27,
    polish_init=None,
    dilation: int = 1,
):
    """Weighted-median displacement filter (refine_kernel.cu:206-286).

    For each pixel, every valid displacement in the (2R+1)^2 window is a
    candidate; the winner minimizes the bilateral-weighted L-inf deviation
    from the (valid) window displacements.  The reference notes (:215-216)
    this min-cost form replaces a histogram WMF for memory reasons; we keep
    the same math.  CUDA iterates the kernel in place with racy reads; here
    each iteration is a clean Jacobi pass (read old field, write new).

    ``polish_init`` (tx_fill, ty_fill): frozen-valid polish mode — see
    ``wmf_polish_occlusions``.
    Holes start from the fill, each iteration re-medians them from
    ORIGINALLY-valid window data only, output is fully valid.
    """
    h, w = tx.shape
    r = cfg.wmf_radius
    sig_r2 = cfg.wmf_sigma_range**2
    sig_s2 = cfg.wmf_sigma_spatial**2
    ys, xs = _grid(h, w)

    # spatial LUT folded into per-tap constants.  ``dilation`` scales
    # the offsets (jump-flood style: radius 4 at dilation 4 reaches 16 px
    # with the same 81 samples) but NOT the spatial term — sigma
    # effectively scales with it.
    all_offs = [
        (dy * dilation, dx * dilation)
        for dy in range(-r, r + 1) for dx in range(-r, r + 1)
    ]
    gws = np.asarray(
        [
            math.exp(-(dy * dy) / sig_s2) * math.exp(-(dx * dx) / sig_s2)
            for dy in range(-r, r + 1) for dx in range(-r, r + 1)
        ],
        np.float32,
    )
    offs_arr = np.asarray(all_offs, np.int32)
    n = len(all_offs)
    n_pad = (-n) % support_chunk
    s_offs = np.concatenate([offs_arr, np.zeros((n_pad, 2), np.int32)])
    s_gw = np.concatenate([gws, np.zeros(n_pad, np.float32)])
    s_offs = s_offs.reshape(-1, support_chunk, 2)
    s_gw = s_gw.reshape(-1, support_chunk)

    center = img  # (H, W, 3)

    valid0 = ((tx >= 0) & (ty >= 0)).astype(jnp.float32)
    if polish_init is not None:
        ftx, fty = polish_init
        tx = jnp.where(valid0 > 0, tx, ftx)
        ty = jnp.where(valid0 > 0, ty, fty)

    def one_pass(tx, ty):
        ox = (tx - xs).astype(jnp.float32)
        oy = (ty - ys).astype(jnp.float32)
        if polish_init is not None:
            valid = valid0
        else:
            valid = ((tx >= 0) & (ty >= 0)).astype(jnp.float32)
        # pad: out-of-image supports/candidates invalid (pad covers the
        # dilated window's true reach)
        reach = r * dilation
        pox = jnp.pad(ox, reach)
        poy = jnp.pad(oy, reach)
        pvalid = jnp.pad(valid, reach)  # zero outside
        pimg = jnp.pad(img, ((reach, reach), (reach, reach), (0, 0)),
                       mode="edge")

        def support_weight(dy, dx, gw):
            sv = jax.lax.dynamic_slice(pvalid, (reach + dy, reach + dx),
                                       (h, w))
            spix = jax.lax.dynamic_slice(
                pimg, (reach + dy, reach + dx, 0), (h, w, 3)
            )
            d = jnp.abs(spix - center)
            dr = jnp.maximum(jnp.maximum(d[..., 0], d[..., 1]), d[..., 2])
            return sv * gw * jnp.exp(-(dr * dr) / sig_r2)

        def support_vals(dy, dx):
            sox = jax.lax.dynamic_slice(pox, (reach + dy, reach + dx),
                                        (h, w))
            soy = jax.lax.dynamic_slice(poy, (reach + dy, reach + dx),
                                        (h, w))
            return sox, soy

        def cand_step(carry, coff):
            best_cost, best_ox, best_oy = carry
            cdy, cdx = coff[0], coff[1]
            cvalid = jax.lax.dynamic_slice(
                pvalid, (reach + cdy, reach + cdx), (h, w)
            )
            cox, coy = support_vals(cdy, cdx)

            def sup_step(acc, sdata):
                cost_acc, w_acc = acc
                soff, sgw = sdata
                # invalid supports contribute nothing (their validity is a
                # factor of the weight); padded taps have gw==0
                ws = jax.vmap(
                    lambda o, g: support_weight(o[0], o[1], g)
                )(soff, sgw)
                sox, soy = jax.vmap(lambda o: support_vals(o[0], o[1]))(soff)
                dev = jnp.maximum(jnp.abs(cox - sox), jnp.abs(coy - soy))
                return (cost_acc + (ws * dev).sum(0), w_acc + ws.sum(0)), None

            (cost_sum, weight_sum), _ = jax.lax.scan(
                sup_step,
                (jnp.zeros((h, w), jnp.float32), jnp.zeros((h, w), jnp.float32)),
                (jnp.asarray(s_offs), jnp.asarray(s_gw)),
            )
            cost_sum = jnp.where(cvalid > 0, cost_sum, FLT_MAX)
            better = (weight_sum > 0) & (cost_sum < best_cost)
            return (
                jnp.where(better, cost_sum, best_cost),
                jnp.where(better, cox, best_ox),
                jnp.where(better, coy, best_oy),
            ), None

        init = (jnp.full((h, w), FLT_MAX, jnp.float32), ox, oy)
        (best_cost, best_ox, best_oy), _ = jax.lax.scan(
            cand_step, init, jnp.asarray(offs_arr)
        )
        # negative reconstructed targets are not written (the reference's
        # write guard, refine_kernel.cu:286) — the original value stays
        found = (
            (best_cost < FLT_MAX)
            & (best_ox + xs.astype(jnp.float32) >= 0)
            & (best_oy + ys.astype(jnp.float32) >= 0)
        )
        new_tx = jnp.where(
            found, best_ox.astype(jnp.int32) + xs, tx
        )
        new_ty = jnp.where(found, best_oy.astype(jnp.int32) + ys, ty)
        if polish_init is not None:
            # polish mode: only holes (w.r.t. the frozen original
            # validity) are replaced; unreachable holes keep their fill
            occ = valid0 == 0
            new_tx = jnp.where(occ, new_tx, tx)
            new_ty = jnp.where(occ, new_ty, ty)
        elif only_occlusion:
            occ = (tx < 0) | (ty < 0)  # refine_kernel.cu:213
            new_tx = jnp.where(occ, new_tx, tx)
            new_ty = jnp.where(occ, new_ty, ty)
        return new_tx, new_ty

    def body(_, state):
        return one_pass(*state)

    tx, ty = jax.lax.fori_loop(0, num_iter, body, (tx, ty))
    return tx, ty


def fill_holes(tx, ty, img, patch_radius: int = 0,
               linear_baseline: int = 0, linear_slope_tol: float = 0.3,
               linear_max_slope: float = 1.0,
               return_candidates: bool = False):
    """Fill remaining occlusions from the color-nearest of the first valid
    displacement in each of the 4 scan directions (refine_kernel.cu:297-371).

    ``patch_radius`` > 0 replaces the reference's single-pixel color
    test with a (2r+1)^2 patch SAD between the hole's neighborhood and
    the candidate source pixel's neighborhood.  Rationale: the
    single-pixel max-channel difference is one noisy sample — on content
    whose textures homogenize at the coarse level (same means, different
    realizations) it picks the wrong side of an occlusion band ~20% of
    the time; a patch distance averages (2r+1)^2 samples, comparing
    texture rather than one pixel's color.  A measured negative result
    for the alternative cue (backward-LR-validity of the candidate's
    target, 'occlusion consistency') is recorded in the round-4 notes:
    it systematically prefers the WRONG side when the occluded band's
    true flow points into the occluder (band EPE 4.6 -> 6.5).

    ``linear_baseline`` > 0 upgrades the adopted value from constant to
    FIRST-ORDER along the scan direction: the per-component slope is
    estimated from two extra valid samples at ``b`` and ``2b`` pixels
    behind the nearest valid pixel, accepted only where the two
    single-baseline estimates agree within ``linear_slope_tol`` px/px
    (noise gate: a constant-flow region estimates slope ~0 twice and
    extrapolates like the reference; an edge or noisy run disagrees and
    falls back to constant), clamped to ±``linear_max_slope``.  This
    recovers smoothly-VARYING fields (zoom/rotation border wedges) that
    a constant fill flattens — the round-4 accepted trade.

    The reference's unbounded per-thread scans become cumulative max/min
    index propagations (O(H+W) scan depth -> lax.cummax), a data-parallel
    reformulation with identical results.  Delta vs reference: when NO
    direction holds a valid pixel, the CUDA code writes INVALID+pos
    (:368-370); we keep INVALID (strictly better-defined, only reachable
    when the whole image is occluded).
    """
    h, w = tx.shape
    ys, xs = _grid(h, w)
    valid = (tx >= 0) & (ty >= 0)
    ox = (tx - xs).astype(jnp.float32)
    oy = (ty - ys).astype(jnp.float32)

    def nearest(axis: int, reverse: bool):
        """Index (along ``axis``) of the nearest valid pixel strictly
        before (reverse=False) / after (reverse=True) each position; -1
        when none exists.  cummax of 'own index if valid else -1' yields
        the nearest valid at-or-before; an exclusive one-step shift makes
        it strictly-before.  The 'after' direction runs the same scan in a
        flipped frame (indices rebuilt post-flip so cummax still finds the
        *nearest*, i.e. smallest original index >= x)."""
        size = w if axis == 1 else h
        coords = xs if axis == 1 else ys
        v = valid
        if reverse:
            v = jnp.flip(v, axis=axis)
        idx = jnp.where(v, coords, -1)
        acc = jax.lax.cummax(idx, axis=axis)
        # exclusive shift: drop self, prepend "none"
        pad = [(0, 0), (0, 0)]
        pad[axis] = (1, 0)
        acc = jnp.pad(acc, pad, constant_values=-1)
        acc = jax.lax.slice_in_dim(acc, 0, size, axis=axis)
        if reverse:
            acc = jnp.flip(acc, axis=axis)
            acc = jnp.where(acc >= 0, size - 1 - acc, -1)
        return acc

    pr = patch_radius
    if pr > 0:
        pimg = jnp.pad(img, ((pr, pr), (pr, pr), (0, 0)), mode="edge")

    dirs = []
    for axis, reverse in ((1, False), (1, True), (0, False), (0, True)):
        nidx = nearest(axis, reverse)
        found = nidx >= 0
        size = w if axis == 1 else h
        coords = xs if axis == 1 else ys
        nidxc = jnp.clip(nidx, 0, size - 1)
        gox = jnp.take_along_axis(ox, nidxc, axis=axis)
        goy = jnp.take_along_axis(oy, nidxc, axis=axis)
        if linear_baseline > 0:
            # First-order extrapolation along the scan direction.  Two
            # deeper samples (b, 2b behind the nearest valid) give two
            # independent slope estimates; accept only where they agree.
            b = linear_baseline
            step = b if reverse else -b
            i1 = nidx + step
            i2 = nidx + 2 * step
            ok = found & (i1 >= 0) & (i1 < size) & (i2 >= 0) & (i2 < size)
            i1c = jnp.clip(i1, 0, size - 1)
            i2c = jnp.clip(i2, 0, size - 1)
            ok = (
                ok
                & jnp.take_along_axis(valid, i1c, axis=axis)
                & jnp.take_along_axis(valid, i2c, axis=axis)
            )
            inv_b = 1.0 / float(b)
            # Extrapolation reach is deliberately UNCAPPED: capping at
            # 2b was measured WORSE (zoom_rot 0.535 -> 0.658 — its LR
            # holes run 30+ coarse px deep and the far half benefits
            # most) while barely helping the constant-field leak it
            # aimed at (large_disp_120 0.183 -> 0.177, vs 0.154 with
            # the fill off; the leak is baseline noise, not reach).
            dist = jnp.abs(coords - nidxc).astype(jnp.float32)

            def slope(field, g0):
                # The NNF is integer-quantized, so per-b differences are
                # a staircase (resolution 1/b): the slope itself comes
                # from the LONG 2b baseline (half the quantization
                # noise); the two half-segment estimates only gate it.
                # A masked-presmoothed slope source measured WORSE than
                # raw at the same baseline (zoom_rot 0.553 vs 0.535,
                # layered 2.182 vs 2.169 — blurs across motion edges),
                # so raw offsets stay.
                v1 = jnp.take_along_axis(field, i1c, axis=axis)
                v2 = jnp.take_along_axis(field, i2c, axis=axis)
                s1 = (g0 - v1) * inv_b
                s2 = (v1 - v2) * inv_b
                agree = ok & (jnp.abs(s1 - s2) <= linear_slope_tol)
                s = jnp.clip(
                    (g0 - v2) * (0.5 * inv_b),
                    -linear_max_slope, linear_max_slope,
                )
                return jnp.where(agree, s, 0.0)

            gox = gox + slope(ox, gox) * dist
            goy = goy + slope(oy, goy) * dist
        if pr == 0:
            gpix = jnp.take_along_axis(img, nidxc[..., None], axis=axis)
            d = jnp.abs(gpix - img)
            pixdiff = jnp.maximum(
                jnp.maximum(d[..., 0], d[..., 1]), d[..., 2]
            )
        else:
            # patch SAD: compare the hole's neighborhood against the
            # source pixel's neighborhood, offset by offset (both read
            # from the same o-shifted image, so each term is one
            # take_along_axis gather)
            acc = jnp.zeros((h, w), jnp.float32)
            for dy in range(-pr, pr + 1):
                for dx in range(-pr, pr + 1):
                    S = jax.lax.dynamic_slice(
                        pimg, (pr + dy, pr + dx, 0), (h, w, 3)
                    )
                    g = jnp.take_along_axis(
                        S, nidxc[..., None], axis=axis
                    )
                    d = jnp.abs(g - S)
                    acc = acc + jnp.maximum(
                        jnp.maximum(d[..., 0], d[..., 1]), d[..., 2]
                    )
            pixdiff = acc / float((2 * pr + 1) ** 2)
        pixdiff = jnp.where(found, pixdiff, FLT_MAX)
        dirs.append((pixdiff, gox, goy, found))

    best_diff = jnp.full((h, w), FLT_MAX, jnp.float32)
    best_ox, best_oy = ox, oy
    any_found = jnp.zeros((h, w), bool)
    for pixdiff, gox, goy, found in dirs:  # order: left, right, up, down
        better = found & (pixdiff < best_diff)
        best_diff = jnp.where(better, pixdiff, best_diff)
        best_ox = jnp.where(better, gox, best_ox)
        best_oy = jnp.where(better, goy, best_oy)
        any_found = any_found | found

    occ = ~valid
    fill = occ & any_found
    new_tx = jnp.where(fill, best_ox.astype(jnp.int32) + xs, tx)
    new_ty = jnp.where(fill, best_oy.astype(jnp.int32) + ys, ty)
    if return_candidates:
        # (found, gox, goy) per scan direction, offsets already
        # linear-extrapolated — consumers (_photometric_arbitrate)
        # re-score these against frame 2
        return new_tx, new_ty, [
            (found, gox, goy) for (_, gox, goy, found) in dirs
        ]
    return new_tx, new_ty


def nnf_to_flow(tx, ty):
    """Absolute targets -> float offsets (refine_kernel.cu:636-655)."""
    h, w = tx.shape
    ys, xs = _grid(h, w)
    invalid = (tx <= INVALID_LOCATION) | (ty <= INVALID_LOCATION)
    u = jnp.where(invalid, UNKNOWN_FLOW, (tx - xs).astype(jnp.float32))
    v = jnp.where(invalid, UNKNOWN_FLOW, (ty - ys).astype(jnp.float32))
    return jnp.stack([u, v], axis=-1)


def flow_to_nnf(flow):
    """Float offsets -> absolute targets (refine_kernel.cu:657-676).

    C float->short conversion truncates toward zero.
    """
    h, w = flow.shape[:2]
    ys, xs = _grid(h, w)
    u, v = flow[..., 0], flow[..., 1]
    unknown = (u > UNKNOWN_FLOW_THRESH) | (v > UNKNOWN_FLOW_THRESH)
    tx = jnp.trunc(u).astype(jnp.int32) + xs
    ty = jnp.trunc(v).astype(jnp.int32) + ys
    inv = jnp.int32(INVALID_LOCATION)
    return jnp.where(unknown, inv, tx), jnp.where(unknown, inv, ty)


@jax.named_scope("smooth")
def flow_smoothing(
    flow, img, cfg: RefineConfig = RefineConfig(), chunk: int = 21
):
    """Joint-bilateral flow smoothing (refine_kernel.cu:764-826): guided by
    the image, radius 2*sigma_s, skipping unknown-flow taps; pixels whose
    window holds no known flow keep their value."""
    h, w = flow.shape[:2]
    r = cfg.blf_radius
    sig_r2 = cfg.blf_sigma_range**2
    sig_s2 = cfg.blf_sigma_spatial**2

    pflow = jnp.pad(
        flow, ((r, r), (r, r), (0, 0)), constant_values=UNKNOWN_FLOW
    )
    pimg = jnp.pad(img, ((r, r), (r, r), (0, 0)), mode="edge")

    offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    gws = [
        math.exp(-(dy * dy) / sig_s2) * math.exp(-(dx * dx) / sig_s2)
        for dy, dx in offs
    ]
    n = len(offs)
    n_pad = (-n) % chunk
    offs += [(0, 0)] * n_pad
    gws += [0.0] * n_pad
    offs_a = np.asarray(offs, np.int32).reshape(-1, chunk, 2)
    gws_a = np.asarray(gws, np.float32).reshape(-1, chunk)

    def tap(off, gw):
        dy, dx = off[0], off[1]
        f = jax.lax.dynamic_slice(pflow, (r + dy, r + dx, 0), (h, w, 2))
        p = jax.lax.dynamic_slice(pimg, (r + dy, r + dx, 0), (h, w, 3))
        known = (f[..., 0] <= UNKNOWN_FLOW_THRESH) & (
            f[..., 1] <= UNKNOWN_FLOW_THRESH
        )
        d = jnp.abs(p - img)
        dr = jnp.maximum(jnp.maximum(d[..., 0], d[..., 1]), d[..., 2])
        wgt = jnp.exp(-(dr * dr) / sig_r2) * gw * known.astype(jnp.float32)
        fz = jnp.where(known[..., None], f, 0.0)
        return wgt[..., None] * fz, wgt

    def step(carry, data):
        acc_f, acc_w = carry
        off, gw = data
        fs, ws = jax.vmap(tap)(off, gw)
        return (acc_f + fs.sum(0), acc_w + ws.sum(0)), None

    (fsum, wsum), _ = jax.lax.scan(
        step,
        (jnp.zeros((h, w, 2), jnp.float32), jnp.zeros((h, w), jnp.float32)),
        (jnp.asarray(offs_a), jnp.asarray(gws_a)),
    )
    out = fsum / jnp.maximum(wsum, 1e-30)[..., None]
    return jnp.where((wsum > 0)[..., None], out, flow)


def blf_refine_flow(
    flow,
    pack1,
    pack2,
    cost_cfg: CostConfig = CostConfig(),
    tap_chunk: int = 25,
    sequential: bool = True,
    origin=(0, 0),
    pack1_halo: int = 0,
):
    """3x3 plane-fitting cost re-search around the current flow target
    (d_bilateral_refine_flow_planefitting, bao_pmflow_kernel.cu:2005-2041).

    Candidate grid: center = trunc(flow) + pos, +-1 per axis; out-of-image
    candidates are skipped; unknown flow resets to 0 and is skipped.

    Multi-chip tiling: ``flow`` may be a shard tile whose top-left pixel
    sits at global position ``origin`` (traced (y0, x0)); ``pack1`` is then
    the matching tile with ``pack1_halo`` exchanged rows/cols per side, and
    ``pack2`` the full replicated frame.
    """
    h, w = flow.shape[:2]
    h2, w2 = pack2.shape[0], pack2.shape[1]
    y0, x0 = origin
    ys, xs = _grid(h, w)
    ys = ys + y0  # global pixel coordinates
    xs = xs + x0
    u, v = flow[..., 0], flow[..., 1]
    unknown = (u > UNKNOWN_FLOW_THRESH) | (v > UNKNOWN_FLOW_THRESH)
    cx = jnp.trunc(jnp.where(unknown, 0.0, u)).astype(jnp.int32) + xs
    cy = jnp.trunc(jnp.where(unknown, 0.0, v)).astype(jnp.int32) + ys

    cand_tx, cand_ty, cand_inb = [], [], []
    for m in (-1, 0, 1):
        for n in (-1, 0, 1):
            tx = cx + m
            ty = cy + n
            inb = (tx >= 0) & (tx < w2) & (ty >= 0) & (ty < h2)
            cand_tx.append(jnp.clip(tx, 0, w2 - 1))
            cand_ty.append(jnp.clip(ty, 0, h2 - 1))
            cand_inb.append(inb)
    txs = jnp.stack(cand_tx)
    tys = jnp.stack(cand_ty)
    inbs = jnp.stack(cand_inb)

    fn = lambda t: patch_cost_planefitting(
        pack1, pack2, t[0], t[1], cost_cfg, tap_chunk, pack1_halo
    )
    if sequential:
        costs = jax.lax.map(fn, (txs, tys))
    else:
        costs = jax.vmap(lambda a, b: patch_cost_planefitting(
            pack1, pack2, a, b, cost_cfg, tap_chunk, pack1_halo))(txs, tys)
    costs = jnp.where(inbs, costs, FLT_MAX)

    # initial best: the center candidate at sentinel cost 999999
    # (bao_pmflow_kernel.cu:2020-2023)
    best_cost = jnp.full((h, w), 999999.0, jnp.float32)
    best_tx, best_ty = cx, cy
    for k in range(9):
        better = costs[k] < best_cost
        best_cost = jnp.where(better, costs[k], best_cost)
        best_tx = jnp.where(better, txs[k], best_tx)
        best_ty = jnp.where(better, tys[k], best_ty)

    out_u = (best_tx - xs).astype(jnp.float32)
    out_v = (best_ty - ys).astype(jnp.float32)
    out = jnp.stack([out_u, out_v], axis=-1)
    return jnp.where(unknown[..., None], 0.0, out)


def median_filter(img, radius: int = 2):
    """Channel-wise (2r+1)^2 median with edge-clamped taps
    (d_median_filtering, refine_kernel.cu:921-974; the CUDA kernel bubble-
    sorts in registers — here XLA sorts a (taps, H, W) stack)."""
    h, w = img.shape[0], img.shape[1]
    pad = ((radius, radius), (radius, radius)) + ((0, 0),) * (img.ndim - 2)
    p = jnp.pad(img, pad, mode="edge")
    taps = [
        jax.lax.dynamic_slice(
            p, (radius + dy, radius + dx) + (0,) * (img.ndim - 2),
            (h, w) + img.shape[2:],
        )
        for dy in range(-radius, radius + 1)
        for dx in range(-radius, radius + 1)
    ]
    stack = jnp.stack(taps)
    return jnp.sort(stack, axis=0)[len(taps) // 2]


def guide_image_smoothing(
    img, cfg: RefineConfig = RefineConfig(), median_radius: int = 2,
    chunk: int = 21,
):
    """Guide-image pre-smoothing (baoCudaImageSmoothing,
    refine_kernel.cu:915-1054; not in the reference default path): 5x5
    channel-wise median followed by a bilateral filter.

    Fidelity note: the reference binds the *original* image as both the
    weight guide and the averaged values, so its median output is
    overwritten and discarded (.cu:1031-1050) — an apparent oversight.
    We run the bilateral on the median result, which is the evidently
    intended composition.
    """
    med = median_filter(img, median_radius)
    h, w = img.shape[0], img.shape[1]
    r = cfg.blf_radius
    sig_r2 = cfg.blf_sigma_range**2
    sig_s2 = cfg.blf_sigma_spatial**2
    pimg = jnp.pad(med, ((r, r), (r, r), (0, 0)), mode="edge")
    # border taps are skipped (continue), not clamped: weight by validity
    valid = jnp.pad(jnp.ones((h, w), jnp.float32), r)

    offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    gws = [
        math.exp(-(dy * dy) / sig_s2) * math.exp(-(dx * dx) / sig_s2)
        for dy, dx in offs
    ]
    n_pad = (-len(offs)) % chunk
    offs += [(0, 0)] * n_pad
    gws += [0.0] * n_pad
    offs_a = np.asarray(offs, np.int32).reshape(-1, chunk, 2)
    gws_a = np.asarray(gws, np.float32).reshape(-1, chunk)

    def tap(off, gw):
        dy, dx = off[0], off[1]
        p = jax.lax.dynamic_slice(pimg, (r + dy, r + dx, 0), (h, w, 3))
        v = jax.lax.dynamic_slice(valid, (r + dy, r + dx), (h, w))
        d = jnp.abs(p - med)
        dr = jnp.maximum(jnp.maximum(d[..., 0], d[..., 1]), d[..., 2])
        wgt = jnp.exp(-(dr * dr) / sig_r2) * gw * v
        return wgt[..., None] * p, wgt

    def step(carry, data):
        acc_p, acc_w = carry
        off, gw = data
        ps, ws = jax.vmap(tap)(off, gw)
        return (acc_p + ps.sum(0), acc_w + ws.sum(0)), None

    (psum, wsum), _ = jax.lax.scan(
        step,
        (jnp.zeros((h, w, 3), jnp.float32), jnp.zeros((h, w), jnp.float32)),
        (jnp.asarray(offs_a), jnp.asarray(gws_a)),
    )
    return psum / jnp.maximum(wsum, 1e-30)[..., None]


def flow_cutoff(flow, max_val: float):
    """Clamp to +-max_val (refine_kernel.cu:891-912; disabled by default)."""
    return jnp.clip(flow, -max_val, max_val)


def eliminate_still_region(
    flow, img1, img2, cost_cfg: CostConfig = CostConfig(),
    min_cost: float = 0.1,
):
    """Zero flow where the identity displacement already matches well
    (baoEliminateStillRegionFlow, bao_pmflow_kernel.cu:2072-2095; disabled
    in the default path)."""
    h, w = flow.shape[:2]
    ys, xs = _grid(h, w)
    cost = patch_cost_ad_l2(img1, img2, xs, ys, cost_cfg)
    return jnp.where((cost <= min_cost)[..., None], 0.0, flow)


def _photometric_arbitrate(
    tx, ty, ftx, fty, cands, packs, cost_cfg, thresh: float, orig,
):
    """Re-decide each hole's fill by TRUE patch cost where the scene is
    visible in frame 2.

    The strict LR check + outlier removal invalidate over half the
    foreground on layered content (tools/layered_diag.py) although those
    pixels are visible in both frames; for them the frame-2 appearance
    picks the right candidate where the scanline fill's frame-1 color
    test is a coin flip.  Truly occluded pixels have NO good candidate
    (all costs above ``thresh`` — their content does not exist in
    frame 2) and keep the color/majority fill, where photometric voting
    systematically prefers the WRONG layer (round-4 negative result,
    ops/refine.py::fill_holes docstring).

    Candidates: the 4 directional fill sources (slope-extrapolated) plus
    the pixel's own pre-LR match (``orig`` — exactly right wherever the
    invalidation was quantization noise rather than occlusion).  Costs
    come from the exact gather path (ops/cost.py::patch_cost_stack) on
    the coarse-level packs — a K<=5-field rescore of a ~110x256 level,
    negligible next to the matcher's own exact stage.
    """
    from .cost import make_patch_stack, patch_cost_stack

    p1, p2 = packs
    h, w = tx.shape
    h2, w2 = p2.shape[0], p2.shape[1]
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)

    fields = []
    for found, gox, goy in cands:
        ctx = xs + jnp.round(gox).astype(jnp.int32)
        cty = ys + jnp.round(goy).astype(jnp.int32)
        fields.append((found, ctx, cty))
    if orig is not None:
        # Corroboration gate (zero extra cost evals): the pre-LR match
        # is admitted only where SOME directional fill source roughly
        # agrees with it (L-inf <= 2 px).  A mis-invalidated visible
        # pixel sits among same-surface valid neighbors whose flow
        # matches its own, so the gate passes; an out-of-frame border
        # band's pre-LR matches are lone garbage no neighbor seconds
        # (measured: admitting them un-gated costs large_disp_120
        # 0.183 -> 1.183 — they score under the cost threshold on
        # featureless border content).
        otx, oty = orig
        agree = jnp.zeros((h, w), bool)
        for found, ctx, cty in fields:
            d = jnp.maximum(jnp.abs(ctx - otx), jnp.abs(cty - oty))
            agree = agree | (found & (d <= 2))
        fields.append((agree, otx, oty))

    txs = jnp.stack([f[1] for f in fields])
    tys = jnp.stack([f[2] for f in fields])
    offs = cost_cfg.tap_offsets
    stack2 = make_patch_stack(p2, offs)
    costs = patch_cost_stack(p1, stack2, txs, tys, cost_cfg, offs)
    for k, (found, ctx, cty) in enumerate(fields):
        inb = (ctx >= 0) & (ctx < w2) & (cty >= 0) & (cty < h2)
        costs = costs.at[k].set(
            jnp.where(found & inb, costs[k], FLT_MAX)
        )
    kbest = jnp.argmin(costs, axis=0)
    cmin = jnp.min(costs, axis=0)
    btx = jnp.take_along_axis(txs, kbest[None], axis=0)[0]
    bty = jnp.take_along_axis(tys, kbest[None], axis=0)[0]

    hole = (tx < 0) | (ty < 0)
    use = hole & (cmin < jnp.float32(thresh))
    return (
        jnp.where(use, btx, ftx),
        jnp.where(use, bty, fty),
    )


def wmf_polish_occlusions(
    tx, ty, img, cfg: RefineConfig = RefineConfig(), num_iter: int = 1,
    dilations: Tuple[int, ...] = (1,),
    fill_patch_radius: int = 0,
    accept_thresh: float = 0.0,
    fill_linear_baseline: int = 0,
    fill_linear_slope_tol: float = 0.3,
    packs=None,
    cost_cfg=None,
    fill_cost_thresh: float = 0.0,
    orig=None,
):
    """Occlusion reconstruction as fill-then-polish (the data-parallel
    answer to the reference's 20 sequential in-place occlusion-WMF
    sweeps, bao_flow_patchmatch_multiscale_cuda.cpp:239).

    The reference's in-place scan diffuses values across an arbitrarily
    wide occluded band in few passes because each thread reads its
    neighbors' already-updated values.  A clean Jacobi port needs
    ~band_width/radius iterations, and its inward reconstruction
    compounds errors (diag on the layered stress case: 6.7 px mean error
    in an ~20 px coarse band after 5 Jacobi iterations).  Here the holes
    are instead initialized by ``fill_holes`` (the reference's own
    4-direction color-nearest rule, refine_kernel.cu:297-371 — exact
    for band-shaped occlusions whose two sides differ in texture), then
    ``num_iter`` frozen-valid WMF iterations re-median each hole from
    originally-valid window data: edge holes get the full bilateral
    median, unreachable band centers keep the color-chosen fill, and
    nothing compounds.  Cheaper AND more accurate than the Jacobi
    schedule it replaces.

    ``dilations`` chains one polish pass per entry, coarse-to-fine
    (e.g. (4, 1)): the dilated pass re-medians wide-band holes from
    original data up to radius*dilation away (81 color-weighted samples
    beat the scanline fill's single-pixel color pick), then the
    dilation-1 pass re-medians near-edge holes at full precision — holes
    it cannot reach keep the previous pass's value (each pass's output
    is the next pass's ``polish_init``).

    ``accept_thresh`` > 0 gates every dilated (>1) pass: a hole adopts
    the dilated median only when it agrees with its current (fill)
    hypothesis within the threshold per component.  This resolves the
    measured content conflict: on single-layer bands (image borders at
    large translations) the dilated median denoises the scanline fill's
    single-source jitter and agrees within ±1, while on two-layer
    occlusions whose coarse colors homogenize the wide median mixes
    layers — a large jump vs the one-sided fill — and is rejected.
    """
    arbitrate = (
        packs is not None and cost_cfg is not None and fill_cost_thresh > 0
    )
    if arbitrate:
        ftx, fty, cands = fill_holes(
            tx, ty, img, patch_radius=fill_patch_radius,
            linear_baseline=fill_linear_baseline,
            linear_slope_tol=fill_linear_slope_tol,
            return_candidates=True,
        )
        ftx, fty = _photometric_arbitrate(
            tx, ty, ftx, fty, cands, packs, cost_cfg,
            fill_cost_thresh, orig,
        )
    else:
        ftx, fty = fill_holes(
            tx, ty, img, patch_radius=fill_patch_radius,
            linear_baseline=fill_linear_baseline,
            linear_slope_tol=fill_linear_slope_tol,
        )
    # A diagonal translation invalidates a full-height column band AND a
    # full-width row band; at their intersection all 4 scan directions
    # fail and the fill keeps the INVALID sentinel.  A second fill pass
    # over the first pass's output reaches such corners (their rows/
    # columns now hold pass-1 values).  Without this, sentinel VALUES
    # smear through the median stages into plausible-looking garbage
    # flows (the round-4 QUALITY blowup).
    h, w = ftx.shape
    sent = jnp.int32(INVALID_LOCATION // 2)
    # single-pixel color test here: pass 2 only serves the rare corner
    # holes, and the patch-SAD gathers are the fill's dominant cost
    ftx2, fty2 = fill_holes(ftx, fty, img)
    ftx = jnp.where(ftx > sent, ftx, ftx2)
    fty = jnp.where(fty > sent, fty, fty2)
    # last resort (whole image occluded): zero offset, the reference's
    # own unreachable-hole rule (INVALID+pos, refine_kernel.cu:368-370)
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    ftx = jnp.where(ftx > sent, ftx, xs)
    fty = jnp.where(fty > sent, fty, ys)
    hole = (tx < 0) | (ty < 0)
    cur = (ftx, fty)
    for d in dilations:
        nxt = weighted_median_filter(
            tx, ty, img, cfg, num_iter, only_occlusion=True,
            polish_init=cur, dilation=d,
        )
        if d > 1 and accept_thresh > 0:
            # float comparison: int32-truncating the threshold would turn
            # e.g. a configured 0.5 into an exact-equality gate (0).
            t = jnp.float32(accept_thresh)
            agree = (jnp.abs(nxt[0] - cur[0]).astype(jnp.float32) <= t) & (
                jnp.abs(nxt[1] - cur[1]).astype(jnp.float32) <= t
            )
            keep = hole & ~agree
            nxt = (
                jnp.where(keep, cur[0], nxt[0]),
                jnp.where(keep, cur[1], nxt[1]),
            )
        cur = nxt
    return cur


@jax.named_scope("occlusion")
def coarse_occlusion_reconstruct(tx, ty, img, rcfg: RefineConfig,
                                 packs=None, cost_cfg=None, orig=None):
    """The coarse level's occlusion chain, shared by the single-chip and
    sharded pipelines: reconstruct LR-invalidated pixels, then the
    optional full-image WMF pass.

    ``rcfg.wmf_fill_first`` selects fill-then-polish
    (``wmf_polish_occlusions``) over the faithful WMF-then-fill Jacobi
    order (reference schedule, compute_flow .cpp:236-243).
    ``wmf_coarse_iters`` drives only the Jacobi path: the fill-first
    polish runs exactly ONE frozen-valid iteration per dilation pass by
    construction — one iteration is that pass's fixed point (see the
    comment below), so an iteration knob would be a no-op there.
    """
    if rcfg.wmf_fill_first:
        hole = (tx < 0) | (ty < 0)
        # one iteration per pass IS the fixed point: polish candidates/
        # supports are the frozen originally-valid data, so iteration 2
        # re-derives identical medians (verified iter5 == iter2 == iter1).
        tx, ty = wmf_polish_occlusions(
            tx, ty, img, rcfg, num_iter=1,
            dilations=rcfg.wmf_polish_dilations,
            fill_patch_radius=rcfg.fill_patch_radius,
            accept_thresh=rcfg.wmf_polish_accept_thresh,
            fill_linear_baseline=rcfg.fill_linear_baseline,
            fill_linear_slope_tol=rcfg.fill_linear_slope_tol,
            packs=packs, cost_cfg=cost_cfg,
            fill_cost_thresh=rcfg.fill_photometric_thresh,
            orig=orig,
        )
        if rcfg.fill_median_rounds > 0:
            # majority correction over the reconstructed holes: wrong
            # scanline-fill picks are streak-correlated (~20% of band
            # pixels on layered content); iterated 3x3 component medians
            # over ALL values, applied to holes only, let the correct
            # majority overwrite wrong streaks.
            from .dense import median3

            ys2 = jax.lax.broadcasted_iota(jnp.int32, tx.shape, 0)
            xs2 = jax.lax.broadcasted_iota(jnp.int32, tx.shape, 1)
            ox = (tx - xs2).astype(jnp.float32)
            oy = (ty - ys2).astype(jnp.float32)
            for _ in range(rcfg.fill_median_rounds):
                ox = jnp.where(hole, median3(ox), ox)
                oy = jnp.where(hole, median3(oy), oy)
            tx = jnp.where(hole, ox.astype(jnp.int32) + xs2, tx)
            ty = jnp.where(hole, oy.astype(jnp.int32) + ys2, ty)
    else:
        tx, ty = weighted_median_filter(
            tx, ty, img, rcfg, num_iter=rcfg.wmf_coarse_iters,
            only_occlusion=True,
        )
        tx, ty = fill_holes(tx, ty, img)
    if rcfg.wmf_coarse_full_iters > 0:
        tx, ty = weighted_median_filter(
            tx, ty, img, rcfg, num_iter=rcfg.wmf_coarse_full_iters,
            only_occlusion=False,
        )
    return tx, ty
