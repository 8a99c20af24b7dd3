"""Dense warp-and-residual flow refinement — the fine-level hot path.

The reference refines each fine pyramid level by re-searching a 3x3 grid of
integer targets around the upsampled flow with the plane-fitting bilateral
AD+census patch cost (``baoCudaBLFCostFilterRefine``,
bao_pmflow_kernel.cu:1968-2069).  Evaluating that cost at per-pixel targets
requires a data-dependent gather of frame 2 for every tap of every
candidate.

Reformulation
-------------
Split the per-pixel target into  t(p) = p + g(p) + c  where g = trunc(flow)
is the (smooth) integer base flow and c the small search offset:

  1. **Warp once**: J(p) = pack2(p + g(p)) — one 4-channel gather per level
     (and the only data-dependent memory access left).
  2. **Dense residual search**: the cost of candidate c at p needs frame-2
     taps  I2(t(p) + c + d).  On the warped frame this is approximated by
     J(p + c + d) — exact wherever g is locally constant over the patch
     reach (|c|+|d| <= 11 px), which bilateral smoothing makes true away
     from motion boundaries; at boundaries the bilateral range weights
     already discount the offending taps.  Every tap is now a *static*
     shift: the whole search is branch-free stencil work with zero
     gathers, evaluated for all candidates x plane hypotheses in one fused
     pass (ops/pallas_cost.py on CUDA, ``residual_costs`` here elsewhere).

This is the classical warp+residual structure of coarse-to-fine matching.
Accuracy is gated by the same EPE tests as the gather-exact path
(ops/refine.py keeps ``blf_refine_flow`` as the bit-faithful reference
implementation).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import FLT_MAX, UNKNOWN_FLOW_THRESH, CostConfig
from ._util import grid as _grid_util, shift2d as _shift2d
from .cost import plane_offsets

__all__ = [
    "warp_pack",
    "residual_costs",
    "dense_refine_flow",
    "median3",
    "median3_flow",
    "center_out_offsets",
]


def center_out_offsets(radius: int, shape: str = "square") -> List[Tuple[int, int]]:
    """(dy, dx) residual candidates ordered center-out: (0,0) first, then
    by Chebyshev ring and squared distance.

    ``shape="square"`` is the full (2r+1)^2 grid (the reference re-search,
    bao_pmflow_kernel.cu:2005-2041 searches the full 3x3); ``shape="plus"``
    keeps only |dy|+|dx| <= radius (the L1 ball — 5 candidates at r=1),
    trading diagonal single-pass moves for ~1.8x less cost arithmetic;
    iterative-warping passes recover diagonals as two axis steps.

    Why this ordering matters here and not in the reference: argmin ties
    keep the *first* candidate, and our costs are quantized to a 2^-17
    grid so cross-compilation argmin decisions agree (ops/dense.py
    residual_costs) — which makes exact ties common in low-texture
    regions.  Raster order (reference kernel bao_pmflow_kernel.cu:
    1990-1999, raw float costs where exact ties are rare) would drift
    tied pixels toward (-r, -r) every sweep; center-out keeps the
    smallest update instead."""
    cands = [
        (m, n)
        for m in range(-radius, radius + 1)
        for n in range(-radius, radius + 1)
    ]
    if shape == "plus":
        cands = [c for c in cands if abs(c[0]) + abs(c[1]) <= radius]
    elif shape != "square":
        raise ValueError(f"unknown candidate shape {shape!r}")
    cands.sort(key=lambda c: (max(abs(c[0]), abs(c[1])),
                              c[0] * c[0] + c[1] * c[1], c))
    return cands


_grid = _grid_util


def median3(x: jnp.ndarray) -> jnp.ndarray:
    """3x3 median of a 2D field via a fixed 19-comparator sorting network
    over the static shifts (pure min/max; edge-replicated borders)."""
    vals = [_shift2d(x, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    for i, j in [
        (0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8), (0, 1), (3, 4),
        (6, 7), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
        (4, 2), (6, 4), (4, 2),
    ]:
        lo = jnp.minimum(vals[i], vals[j])
        hi = jnp.maximum(vals[i], vals[j])
        vals[i], vals[j] = lo, hi
    return vals[4]


def median3_flow(flow: jnp.ndarray) -> jnp.ndarray:
    """Per-component 3x3 median of an (H, W, 2) flow field."""
    return jnp.stack(
        [median3(flow[..., 0]), median3(flow[..., 1])], axis=-1
    )


def warp_pack(
    pack2: jnp.ndarray,
    gx: jnp.ndarray,
    gy: jnp.ndarray,
    origin: Tuple = (0, 0),
    gather_dtype=None,
) -> jnp.ndarray:
    """J(p) = pack2 at (y + gy(p), x + gx(p)), edge-clamped.

    One flat gather of all 4 channels; this is the single data-dependent
    memory access of the dense refinement path.  ``origin`` gives the
    global position of (gx, gy)'s top-left pixel when warping a shard
    tile against the full replicated frame 2.

    ``gather_dtype`` (e.g. bfloat16) narrows the gathered rows, returning
    float32 values rounded through that dtype (census integers 0..255 stay exact; RGB keeps an
    8-bit mantissa).  All consumers of one warp see the same rounded
    values, so kernel/oracle and cross-program consistency hold.
    """
    h2, w2 = pack2.shape[0], pack2.shape[1]
    h, w = gx.shape
    ys, xs = _grid(h, w)
    # Position clamps first: a halo pixel beyond the global image border
    # reproduces the edge-padded warp of the single-chip path
    # (warped2(clamp(q)) = pack2(clip(clamp(q) + g(clamp(q))))).
    py = jnp.clip(ys + origin[0], 0, h2 - 1)
    px = jnp.clip(xs + origin[1], 0, w2 - 1)
    cy = jnp.clip(py + gy, 0, h2 - 1)
    cx = jnp.clip(px + gx, 0, w2 - 1)
    if gather_dtype is not None:
        pack2 = pack2.astype(gather_dtype)
    flat = pack2.reshape(h2 * w2, pack2.shape[2])
    out = jnp.take(flat, cy * w2 + cx, axis=0)
    if gather_dtype is not None:
        out = out.astype(jnp.float32)
    return out


def _build_tables(
    cfg: CostConfig, use_planes: bool
) -> List[Tuple[Tuple[int, int], ...]]:
    if use_planes:
        return plane_offsets(cfg)
    return [tuple(cfg.tap_offsets)]


@jax.named_scope("residual_cost")
def residual_costs(
    pack1: jnp.ndarray,
    warped2: jnp.ndarray,
    cand_offsets: Sequence[Tuple[int, int]],
    cfg: CostConfig,
    use_planes: bool = True,
    tap_chunk: int = 25,
) -> jnp.ndarray:
    """Bilateral AD+census cost of each residual candidate, densely.

    Candidate ``c``'s cost at pixel p uses frame-1 taps pack1(p+d) and
    warped-frame-2 taps warped2(p+c+d2), d2 from each plane-hypothesis tap
    table; returns the per-candidate min over hypotheses, shape
    (len(cand_offsets), H, W).  All taps are static shifts.
    """
    h, w = pack1.shape[0], pack1.shape[1]
    tables = _build_tables(cfg, use_planes)
    R = cfg.patch_radius
    cmax = max(max(abs(cy), abs(cx)) for (cy, cx) in cand_offsets)
    # max |tap| across tables (plane warps can exceed R slightly)
    tmax = max(
        max(abs(i), abs(j)) for tbl in tables for (i, j) in tbl
    )
    pad1 = jnp.pad(pack1, ((R, R), (R, R), (0, 0)), mode="edge")
    P2 = cmax + tmax
    pad2 = jnp.pad(warped2, ((P2, P2), (P2, P2), (0, 0)), mode="edge")

    lam_ad2 = cfg.lambda_ad * cfg.lambda_ad
    lam_cen2 = (cfg.lambda_census * cfg.census_max_diff) ** 2
    inv_sig_r2 = 1.0 / (cfg.sigma_range * cfg.sigma_range)
    sig_s2 = cfg.sigma_spatial * cfg.sigma_spatial

    center1 = pack1[..., :3]

    def one_cand_table(cy: jnp.ndarray, cx: jnp.ndarray, table) -> jnp.ndarray:
        """Cost field for one candidate offset (traced scalars) and one
        static tap table; scan over tap chunks bounds peak memory."""
        center2 = jax.lax.dynamic_slice(
            pad2, (P2 + cy, P2 + cx, 0), (h, w, 4)
        )[..., :3]

        # static per-tap data
        taps = []
        for (i1, j1), (i2, j2) in zip(cfg.tap_offsets, table):
            gw = math.exp(-(i1 * i1) / sig_s2) * math.exp(-(j1 * j1) / sig_s2)
            taps.append((i1, j1, i2, j2, gw))
        n_pad = (-len(taps)) % tap_chunk
        taps += [(0, 0, 0, 0, 0.0)] * n_pad
        tap_idx = np.asarray([t[:4] for t in taps], np.int32).reshape(
            -1, tap_chunk, 4
        )
        tap_gw = np.asarray([t[4] for t in taps], np.float32).reshape(
            -1, tap_chunk
        )

        def one_tap(tap, gw):
            dy1, dx1, dy2, dx2 = tap[0], tap[1], tap[2], tap[3]
            p1 = jax.lax.dynamic_slice(
                pad1, (R + dy1, R + dx1, 0), (h, w, 4)
            )
            p2 = jax.lax.dynamic_slice(
                pad2, (P2 + cy + dy2, P2 + cx + dx2, 0), (h, w, 4)
            )
            d = jnp.abs(p1[..., :3] - p2[..., :3])
            ad = jnp.maximum(jnp.maximum(d[..., 0], d[..., 1]), d[..., 2])
            c_ad = 1.0 - jnp.exp(-(ad * ad) / lam_ad2)
            x = p1[..., 3].astype(jnp.int32) ^ p2[..., 3].astype(jnp.int32)
            x = x - ((x >> 1) & 0x55)
            x = (x & 0x33) + ((x >> 2) & 0x33)
            ham = ((x + (x >> 4)) & 0x0F).astype(jnp.float32)
            # census Gaussian LUT (bao_pmflow_kernel.cu:681-686) in closed
            # form — the hardware exp is vectorized, a table read is not
            c_cen = 1.0 - jnp.exp(-(ham * ham) / lam_cen2)
            d1 = jnp.abs(center1 - p1[..., :3])
            dr1 = jnp.maximum(jnp.maximum(d1[..., 0], d1[..., 1]), d1[..., 2])
            d2c = jnp.abs(center2 - p2[..., :3])
            dr2 = jnp.maximum(
                jnp.maximum(d2c[..., 0], d2c[..., 1]), d2c[..., 2]
            )
            wgt = jnp.exp(-(dr1 * dr1 + dr2 * dr2) * inv_sig_r2) * gw
            return wgt * (c_ad + c_cen), wgt

        def chunk_step(carry, data):
            acc_c, acc_w = carry
            tap, gw = data
            cs, ws = jax.vmap(one_tap)(tap, gw)
            return (acc_c + cs.sum(0), acc_w + ws.sum(0)), None

        init = (
            jnp.zeros((h, w), jnp.float32),
            jnp.zeros((h, w), jnp.float32),
        )
        (cost_sum, weight_sum), _ = jax.lax.scan(
            chunk_step, init, (jnp.asarray(tap_idx), jnp.asarray(tap_gw))
        )
        # Quantize (2^-17 grid) so argmin ties resolve identically across
        # XLA compilations (monolithic vs sharded programs reassociate
        # reductions differently); same grid as ops/pallas_cost.py.
        cost = cost_sum / jnp.maximum(weight_sum, 1e-30)
        return jnp.round(cost * 131072.0) * (1.0 / 131072.0)

    cands = jnp.asarray(list(cand_offsets), jnp.int32)  # (K, 2) as (dy, dx)

    def per_cand(c):
        cost = None
        for table in tables:
            ct = one_cand_table(c[0], c[1], table)
            cost = ct if cost is None else jnp.minimum(cost, ct)
        return cost

    return jax.lax.map(per_cand, cands)


@jax.named_scope("refine")
def dense_refine_flow(
    flow: jnp.ndarray,
    pack1: jnp.ndarray,
    pack2: jnp.ndarray,
    cfg: CostConfig,
    search_radius: int = 1,
    use_planes: bool = True,
    tap_chunk: int = 25,
    warped2: Optional[jnp.ndarray] = None,
    origin: Tuple = (0, 0),
    cand_shape: str = "square",
    subpixel_fit: bool = False,
    gather_dtype=None,
    subpixel_min_curv: float = 0.0,
) -> jnp.ndarray:
    """Drop-in dense replacement for ``blf_refine_flow`` (ops/refine.py).

    Searches the (2*search_radius+1)^2 grid of integer targets around
    trunc(flow) + pos with the plane-fitting bilateral cost, evaluated on
    the once-warped frame 2.  Unknown flow resets to target 0; candidates
    whose (exact) target falls outside frame 2 are skipped; ties keep the
    first-best in reference scan order — all matching the reference kernel
    (bao_pmflow_kernel.cu:2005-2041).

    ``subpixel_fit`` adds a near-free subpixel estimate: where the center
    candidate wins, a 1-D parabola through the three axis costs per
    direction (already computed for the integer search) places the
    minimum of the local cost surface on a continuous grid.  This is the
    cheap counterpart of the reference's unused 5x5 half-pixel quadratic
    stage (bao_pmflow_refine_kernel.cu:393-633): zero extra cost
    evaluations, fractional only where the surface is locally convex.

    ``subpixel_min_curv`` is the confidence gate on that fit: the axis
    curvature (lo - 2*cc + hi, in normalized cost units) must exceed it
    or the axis keeps the integer argmin.  Rationale: on true integer
    motion the spurious fractional offset is noise/curvature — a
    curvature floor suppresses exactly the weak-minimum pixels where
    texture noise dominates, while clearly-convex minima (where the
    parabola is trustworthy) keep their fractional estimate.  0 restores
    the ungated fit.

    ``warped2`` lets callers supply a pre-warped pack; ``origin`` is the
    global position of the tile's top-left pixel (sharded fine levels run
    this on tile+halo domains against the full replicated frame 2).
    """
    h, w = flow.shape[:2]
    h2, w2 = pack2.shape[0], pack2.shape[1]
    ys, xs = _grid(h, w)
    ys = ys + origin[0]
    xs = xs + origin[1]
    u, v = flow[..., 0], flow[..., 1]
    unknown = (u > UNKNOWN_FLOW_THRESH) | (v > UNKNOWN_FLOW_THRESH)
    gx = jnp.trunc(jnp.where(unknown, 0.0, u)).astype(jnp.int32)
    gy = jnp.trunc(jnp.where(unknown, 0.0, v)).astype(jnp.int32)

    if warped2 is None:
        warped2 = warp_pack(pack2, gx, gy, origin, gather_dtype)

    cand_offsets = center_out_offsets(search_radius, cand_shape)
    from .pallas_cost import residual_costs_auto

    costs = residual_costs_auto(
        pack1, warped2, cand_offsets, cfg, use_planes, tap_chunk
    )

    # mask candidates whose true target is out of frame 2
    best_cost = jnp.full((h, w), 999999.0, jnp.float32)
    best_dy = jnp.zeros((h, w), jnp.int32)
    best_dx = jnp.zeros((h, w), jnp.int32)
    for k, (m, n) in enumerate(cand_offsets):
        ty = ys + gy + m
        tx = xs + gx + n
        inb = (tx >= 0) & (tx < w2) & (ty >= 0) & (ty < h2)
        ck = jnp.where(inb, costs[k], FLT_MAX)
        better = ck < best_cost
        best_cost = jnp.where(better, ck, best_cost)
        best_dy = jnp.where(better, m, best_dy)
        best_dx = jnp.where(better, n, best_dx)

    out_u = (gx + best_dx).astype(jnp.float32)
    out_v = (gy + best_dy).astype(jnp.float32)

    if subpixel_fit:
        # Parabola through the axis-neighbor costs (center-out ordering
        # puts (0,0) first; both square and plus shapes carry all four
        # axis candidates at radius >= 1).  Applied only where (0,0) won
        # and every sample is a real in-frame cost.
        k_of = {off: k for k, off in enumerate(cand_offsets)}
        masked = []
        for off in [(0, 0), (0, -1), (0, 1), (-1, 0), (1, 0)]:
            m, n = off
            ty = ys + gy + m
            tx = xs + gx + n
            inb = (tx >= 0) & (tx < w2) & (ty >= 0) & (ty < h2)
            masked.append(jnp.where(inb, costs[k_of[off]], FLT_MAX))
        cc, cl, cr, cu, cd = masked
        valid = (
            (best_dy == 0) & (best_dx == 0)
            & (cl < FLT_MAX) & (cr < FLT_MAX)
            & (cu < FLT_MAX) & (cd < FLT_MAX)
        )

        curv_floor = max(float(subpixel_min_curv), 1e-8)

        def fit(lo, hi):
            den = lo - 2.0 * cc + hi
            d = 0.5 * (lo - hi) / jnp.maximum(den, 1e-8)
            return jnp.where(den > curv_floor, jnp.clip(d, -0.5, 0.5), 0.0)

        out_u = out_u + jnp.where(valid, fit(cl, cr), 0.0)
        out_v = out_v + jnp.where(valid, fit(cu, cd), 0.0)

    out = jnp.stack([out_u, out_v], axis=-1)
    return jnp.where(unknown[..., None], 0.0, out)
