"""Dense coarse-level matcher — a data-parallel replacement for PatchMatch.

The reference finds the coarse-level NNF by PatchMatch (random init +
sequential propagation + random search, bao_pmflow_kernel.cu:1760-1826):
~220 patch-cost evaluations per pixel at per-pixel *gathered* frame-2
positions, each thread walking its own sequential search.  Here the
search is restructured into dense, statically addressed work (two
complementary engines, fused):

1. **Global descriptor argmax (matmul).**  Every pixel scores *every*
   target with a patch descriptor dot product: ``S = D1 @ D2^T``
   blockwise with a running argmax.  Descriptors are static-shift tap
   stacks (RGB + census bits), so SSD/Hamming patch distance reduces to
   ``argmax(a.b - |b|^2/2)`` — one big bf16 matmul.  This recovers
   arbitrarily large displacements of small objects, the capability
   PatchMatch's global random init provided (and classic coarse-to-fine
   loses).
2. **Dense local descent.**  A mini-pyramid below the coarse level;
   at each step the flow is upsampled, frame 2 warped once, and a
   (2r+1)^2 residual grid evaluated densely with the *true* bilateral
   AD+census cost (ops/dense.py) — the same cost PatchMatch optimizes,
   restructured from per-pixel sequential search into data-parallel
   sweeps.

The two candidate fields are rescored with the true cost and merged by
per-pixel argmin, then polished with a final residual sweep.  Interface
matches ``ops.patchmatch.patchmatch``: returns absolute int32 target
fields + their cost, feeding the unchanged refinement chain (LR check,
outlier removal, WMF, hole fill).

PatchMatch itself remains available (``EPPMConfig.match_engine =
"patchmatch"``) as the bit-faithful reference engine.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import CostConfig, MatchConfig
from .census import census_transform
from .cost import pack_frame
from ._util import grid as _grid_util, shift2d as _shift2d_util
from .dense import center_out_offsets, median3, residual_costs, warp_pack
from .pallas_cost import residual_costs_auto, residual_costs_multiwarp_auto
from .resize import bilinear_resize, gaussian_filter

__all__ = [
    "patch_descriptors",
    "global_match",
    "global_match_bidi",
    "descend_level",
    "match_coarse",
    "match_coarse_bidi",
]


_grid = _grid_util
_shift2d = _shift2d_util


def patch_descriptors(
    pack: jnp.ndarray, cfg: MatchConfig, stride: int = 1
) -> jnp.ndarray:
    """Per-pixel patch descriptor for matmul matching, (H, W, D) bfloat16.

    ``stride`` subsamples the output grid (in float32, before the
    bfloat16 cast).

    Taps on a stride-``desc_tap_stride`` grid of radius ``desc_radius``;
    per tap: 3 RGB channels + 8 census sign bits scaled by
    ``desc_census_scale`` (so descriptor SSD ~ RGB SSD + census Hamming,
    the dot-product form of the reference's AD+census cost family).
    Spatial Gaussian tap weighting is folded in as a per-tap scale.
    """
    import math

    r, s = cfg.desc_radius, cfg.desc_tap_stride
    sig2 = cfg.desc_sigma_spatial**2
    feats = []
    census = pack[..., 3].astype(jnp.int32)
    bit_planes = [
        ((census >> b) & 1).astype(jnp.float32) - 0.5 for b in range(8)
    ]
    bits = jnp.stack(bit_planes, axis=-1) * (2.0 * cfg.desc_census_scale)
    rgb = pack[..., :3]
    for dy in range(-r, r + 1, s):
        for dx in range(-r, r + 1, s):
            gw = math.exp(-(dy * dy + dx * dx) / sig2)
            feats.append(_shift2d(rgb, dy, dx) * gw)
            feats.append(_shift2d(bits, dy, dx) * gw)
    out = jnp.concatenate(feats, axis=-1)
    if stride > 1:
        out = out[::stride, ::stride]
    return out.astype(jnp.bfloat16)


@jax.named_scope("global_match")
def global_match(
    desc1: jnp.ndarray, desc2: jnp.ndarray, block: int = 2048
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-pixel SSD-argmin target over *all* of frame 2, via blockwise
    score matmul: argmin |a-b|^2 == argmax (a.b - |b|^2/2), a running
    argmax over (N1, block) score panels in a ``lax.scan``.

    Returns (ty, tx) int32 absolute target fields for frame 1 pixels.
    """
    h, w = desc1.shape[0], desc1.shape[1]
    h2, w2 = desc2.shape[0], desc2.shape[1]
    d = desc1.shape[2]
    n1, n2 = h * w, h2 * w2
    d1 = desc1.reshape(n1, d)
    d2 = desc2.reshape(n2, d)
    half_norm2 = 0.5 * jnp.sum(
        d2.astype(jnp.float32) * d2.astype(jnp.float32), axis=1
    )

    n_blocks = -(-n2 // block)
    pad2 = n_blocks * block - n2
    d2p = jnp.pad(d2, ((0, pad2), (0, 0)))
    hn2p = jnp.pad(half_norm2, (0, pad2), constant_values=jnp.inf)
    d2b = d2p.reshape(n_blocks, block, d)
    hn2b = hn2p.reshape(n_blocks, block)

    def step(carry, inp):
        best_s, best_i = carry
        j, d2_blk, hn_blk = inp
        scores = (
            jax.lax.dot_general(
                d1, d2_blk,
                (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            - hn_blk[None, :]
        )
        # Quantize so near-ties resolve identically regardless of how a
        # given XLA compilation reassociates the dot reduction (the
        # sharded and monolithic pipelines must take the same argmax).
        scores = jnp.round(scores * 4096.0)
        s = jnp.max(scores, axis=1)
        i = jnp.argmax(scores, axis=1).astype(jnp.int32) + j * block
        better = s > best_s
        return (
            jnp.where(better, s, best_s),
            jnp.where(better, i, best_i),
        ), None

    init = (
        jnp.full((n1,), -jnp.inf, jnp.float32),
        jnp.zeros((n1,), jnp.int32),
    )
    (best_s, best_i), _ = jax.lax.scan(
        step, init,
        (jnp.arange(n_blocks, dtype=jnp.int32), d2b, hn2b),
    )
    ty = (best_i // w2).reshape(h, w)
    tx = (best_i % w2).reshape(h, w)
    return ty, tx


@jax.named_scope("global_match")
def global_match_bidi(
    desc1: jnp.ndarray, desc2: jnp.ndarray, block: int = 2048
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Both directions of ``global_match`` from ONE score sweep.

    The raw descriptor dot ``R = D1 @ D2^T`` serves both argmaxes:
    fwd scores are ``R - |d2|^2/2`` reduced over frame-2 (running max
    across panels), bwd scores are ``R - |d1|^2/2`` reduced over frame-1
    (each panel yields its columns' full answer immediately).  Halves the
    dominant matmul + score traffic of bidirectional matching vs two
    ``global_match`` calls; per-direction results are identical (same
    quantization, same first-max tie order).

    Returns (t1y, t1x, t2y, t2x) int32 absolute target fields.
    """
    h, w = desc1.shape[0], desc1.shape[1]
    h2, w2 = desc2.shape[0], desc2.shape[1]
    d = desc1.shape[2]
    n1, n2 = h * w, h2 * w2
    d1 = desc1.reshape(n1, d)
    d2 = desc2.reshape(n2, d)
    half_norm1 = 0.5 * jnp.sum(
        d1.astype(jnp.float32) * d1.astype(jnp.float32), axis=1
    )
    half_norm2 = 0.5 * jnp.sum(
        d2.astype(jnp.float32) * d2.astype(jnp.float32), axis=1
    )

    n_blocks = -(-n2 // block)
    pad2 = n_blocks * block - n2
    d2p = jnp.pad(d2, ((0, pad2), (0, 0)))
    hn2p = jnp.pad(half_norm2, (0, pad2), constant_values=jnp.inf)
    d2b = d2p.reshape(n_blocks, block, d)
    hn2b = hn2p.reshape(n_blocks, block)

    def step(carry, inp):
        best_s, best_i = carry
        j, d2_blk, hn_blk = inp
        raw = jax.lax.dot_general(
            d1, d2_blk,
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        # fwd: quantized exactly like global_match
        scores = jnp.round((raw - hn_blk[None, :]) * 4096.0)
        s = jnp.max(scores, axis=1)
        i = jnp.argmax(scores, axis=1).astype(jnp.int32) + j * block
        better = s > best_s
        carry = (
            jnp.where(better, s, best_s),
            jnp.where(better, i, best_i),
        )
        # bwd: this panel's columns are complete (reduce over all of n1)
        bscores = jnp.round((raw - half_norm1[:, None]) * 4096.0)
        bi = jnp.argmin(
            jnp.where(
                bscores == jnp.max(bscores, axis=0)[None, :],
                jnp.arange(n1, dtype=jnp.int32)[:, None],
                jnp.int32(2**30),
            ),
            axis=0,
        )
        return carry, bi

    init = (
        jnp.full((n1,), -jnp.inf, jnp.float32),
        jnp.zeros((n1,), jnp.int32),
    )
    (best_s, best_i), bwd_i = jax.lax.scan(
        step, init,
        (jnp.arange(n_blocks, dtype=jnp.int32), d2b, hn2b),
    )
    t1y = (best_i // w2).reshape(h, w)
    t1x = (best_i % w2).reshape(h, w)
    bwd_flat = bwd_i.reshape(n_blocks * block)[:n2]
    t2y = (bwd_flat // w).reshape(h2, w2)
    t2x = (bwd_flat % w).reshape(h2, w2)
    return t1y, t1x, t2y, t2x


def _flow_to_targets(flow, h2, w2):
    h, w = flow.shape[0], flow.shape[1]
    ys, xs = _grid(h, w)
    gx = jnp.trunc(flow[..., 0]).astype(jnp.int32)
    gy = jnp.trunc(flow[..., 1]).astype(jnp.int32)
    return gy, gx, ys, xs


def rescore(
    pack1: jnp.ndarray,
    pack2: jnp.ndarray,
    gy: jnp.ndarray,
    gx: jnp.ndarray,
    cost_cfg: CostConfig,
    tap_chunk: int = 25,
) -> jnp.ndarray:
    """True bilateral AD+census cost of the integer offset field (gy, gx):
    one warp + a single dense evaluation."""
    warped = warp_pack(pack2, gx, gy)
    return residual_costs_auto(
        pack1, warped, [(0, 0)], cost_cfg, False, tap_chunk
    )[0]


def rescore_multi(
    pack1: jnp.ndarray,
    pack2: jnp.ndarray,
    gys: jnp.ndarray,
    gxs: jnp.ndarray,
    cost_cfg: CostConfig,
    tap_chunk: int = 25,
) -> jnp.ndarray:
    """True cost of K integer offset fields (K, H, W) -> (K, H, W); the K
    warps share one batched gather."""
    k, h, w = gys.shape
    h2, w2 = pack2.shape[0], pack2.shape[1]
    ys, xs = _grid(h, w)
    cy = jnp.clip(ys[None] + gys, 0, h2 - 1)
    cx = jnp.clip(xs[None] + gxs, 0, w2 - 1)
    flat = pack2.reshape(h2 * w2, pack2.shape[2])
    warped = jnp.take(flat, (cy * w2 + cx).reshape(-1), axis=0).reshape(
        k, h, w, pack2.shape[2]
    )
    return residual_costs_multiwarp_auto(pack1, warped, cost_cfg, tap_chunk)


def propagate_dense(
    pack1: jnp.ndarray,
    pack2: jnp.ndarray,
    flow: jnp.ndarray,
    cost: jnp.ndarray,
    steps: Sequence[int],
    cost_cfg: CostConfig,
    tap_chunk: int = 25,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dense jump-flood propagation: each round tries the 4 axial
    neighbors' offsets at the given step distance plus the 3x3 flow median,
    rescored with the true cost and kept on strict improvement.  This is
    PatchMatch propagation (bao_pmflow_kernel.cu:979-1181) restructured
    from per-thread sequential sweeps into whole-field candidate rounds."""
    h, w = flow.shape[0], flow.shape[1]
    h2, w2 = pack2.shape[0], pack2.shape[1]
    ys, xs = _grid(h, w)
    gx = jnp.trunc(flow[..., 0]).astype(jnp.int32)
    gy = jnp.trunc(flow[..., 1]).astype(jnp.int32)
    for step in steps:
        cand_gx = [
            _shift2d(gx, dy, dx)
            for dy, dx in ((0, -step), (0, step), (-step, 0), (step, 0))
        ]
        cand_gy = [
            _shift2d(gy, dy, dx)
            for dy, dx in ((0, -step), (0, step), (-step, 0), (step, 0))
        ]
        cand_gx.append(median3(gx))
        cand_gy.append(median3(gy))
        gxs = jnp.stack(cand_gx)
        gys = jnp.stack(cand_gy)
        costs = rescore_multi(pack1, pack2, gys, gxs, cost_cfg, tap_chunk)
        # out-of-image targets never win
        inb = (
            (xs[None] + gxs >= 0) & (xs[None] + gxs < w2)
            & (ys[None] + gys >= 0) & (ys[None] + gys < h2)
        )
        from ..config import FLT_MAX

        costs = jnp.where(inb, costs, FLT_MAX)
        for i in range(gxs.shape[0]):
            better = costs[i] < cost
            gx = jnp.where(better, gxs[i], gx)
            gy = jnp.where(better, gys[i], gy)
            cost = jnp.where(better, costs[i], cost)
    return (
        jnp.stack([gx.astype(jnp.float32), gy.astype(jnp.float32)], -1),
        cost,
    )


def descend_level(
    pack1: jnp.ndarray,
    pack2: jnp.ndarray,
    flow: jnp.ndarray,
    radius: int,
    cost_cfg: CostConfig,
    tap_chunk: int = 25,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One dense warp + (2r+1)^2 residual argmin sweep; returns the updated
    integer flow and its cost (fronto-parallel cost, as PatchMatch uses)."""
    h, w = pack1.shape[0], pack1.shape[1]
    h2, w2 = pack2.shape[0], pack2.shape[1]
    gy, gx, ys, xs = _flow_to_targets(flow, h2, w2)
    warped = warp_pack(pack2, gx, gy)
    # center-out: quantized-cost ties keep the current match
    # (see ops/dense.py center_out_offsets)
    cands = center_out_offsets(radius)
    costs = residual_costs_auto(pack1, warped, cands, cost_cfg, False, tap_chunk)
    from ..config import FLT_MAX

    best_cost = jnp.full((h, w), FLT_MAX, jnp.float32)
    best_dy = jnp.zeros((h, w), jnp.int32)
    best_dx = jnp.zeros((h, w), jnp.int32)
    for k, (m, n) in enumerate(cands):
        ty = ys + gy + m
        tx = xs + gx + n
        inb = (tx >= 0) & (tx < w2) & (ty >= 0) & (ty < h2)
        ck = jnp.where(inb, costs[k], FLT_MAX)
        better = ck < best_cost
        best_cost = jnp.where(better, ck, best_cost)
        best_dy = jnp.where(better, m, best_dy)
        best_dx = jnp.where(better, n, best_dx)
    new_flow = jnp.stack(
        [
            (gx + best_dx).astype(jnp.float32),
            (gy + best_dy).astype(jnp.float32),
        ],
        axis=-1,
    )
    return new_flow, best_cost


def _mini_pyramid(
    img: jnp.ndarray, levels: int, ratio: float = 0.5,
    pack0: Optional[jnp.ndarray] = None,
) -> List[jnp.ndarray]:
    """Gaussian mini-pyramid below the coarse level: packs per level,
    level 0 = input resolution (``pack0`` reuses the caller's
    already-computed level-0 pack).

    Note: levels are built as a *cascade* (each filters its parent with
    base sigma = 1/ratio - 1 before resampling), unlike the main pyramid
    (ops/resize.py gaussian_pyramid), which follows the reference's
    filter-level-0-with-sigma*i schedule.  The mini-pyramid is our own
    matcher scaffolding with no reference counterpart; the cascade is the
    cheaper recursion and its blur only seeds coarse init flows."""
    h, w = img.shape[0], img.shape[1]
    if pack0 is None:
        pack0 = pack_frame(img, census_transform(img))
    packs = [pack0]
    base_sigma = 1.0 / ratio - 1.0
    cur = img
    for i in range(1, levels + 1):
        oh, ow = int(h * ratio**i), int(w * ratio**i)
        smoothed = gaussian_filter(cur, base_sigma, int(base_sigma * 3))
        cur = bilinear_resize(smoothed, oh, ow, ratio)
        packs.append(pack_frame(cur, census_transform(cur)))
    return packs


def _mini_levels(h: int, w: int, match_cfg: MatchConfig) -> int:
    """Mini-pyramid depth floor: a level must stay large relative to the
    patch (19x19 default) or residual argmins degenerate into
    border-clamp noise; keep min(h, w) >= ~24 px."""
    levels = 0
    while (
        levels < match_cfg.descent_levels
        and min(h, w) // 2 ** (levels + 1) >= match_cfg.min_level_dim
    ):
        levels += 1
    return levels


def _make_mini_cost(cost_cfg: CostConfig, match_cfg: MatchConfig) -> CostConfig:
    """Mini-level sweeps use a proportionally smaller patch: the full-size
    patch spans most of a mini level and loses discrimination."""
    import dataclasses

    return dataclasses.replace(
        cost_cfg,
        patch_radius=match_cfg.mini_patch_radius,
        patch_stride=1,
        sigma_spatial=0.5 * match_cfg.mini_patch_radius,
    )


def _descend_chain(
    packs_a, packs_b, tiny_targets, match_cfg, cost_cfg, mini_cost,
    tap_chunk,
):
    """Tiny-level global targets -> descend the mini-pyramid with dense
    residual sweeps -> (flow, cost) at the coarse level."""
    tiny_a, tiny_b = packs_a[-1], packs_b[-1]
    t_y, t_x = tiny_targets
    ys, xs = _grid(tiny_a.shape[0], tiny_a.shape[1])
    flow = jnp.stack(
        [(t_x - xs).astype(jnp.float32), (t_y - ys).astype(jnp.float32)],
        axis=-1,
    )
    flow, cost = descend_level(
        tiny_a, tiny_b, flow, match_cfg.descent_radius, mini_cost, tap_chunk
    )
    for lvl in range(len(packs_a) - 2, -1, -1):
        oh, ow = packs_a[lvl].shape[0], packs_a[lvl].shape[1]
        flow = bilinear_resize(flow, oh, ow, 2.0) * 2.0
        cc = cost_cfg if lvl == 0 else mini_cost
        flow, cost = descend_level(
            packs_a[lvl], packs_b[lvl], flow, match_cfg.descent_radius,
            cc, tap_chunk,
        )
    return flow, cost


def _merge_proposal(pack_a, pack_b, flow, cost, pgy, pgx, cost_cfg,
                    tap_chunk):
    """Merge an integer offset-field proposal by true-cost argmin
    (out-of-image never wins) — can only lower the field's true cost."""
    from ..config import FLT_MAX

    h, w = flow.shape[0], flow.shape[1]
    prop_cost = rescore(pack_a, pack_b, pgy, pgx, cost_cfg, tap_chunk)
    ysc, xsc = _grid(h, w)
    inb = (
        (xsc + pgx >= 0) & (xsc + pgx < pack_b.shape[1])
        & (ysc + pgy >= 0) & (ysc + pgy < pack_b.shape[0])
    )
    prop_cost = jnp.where(inb, prop_cost, FLT_MAX)
    better = prop_cost < cost
    flow = jnp.where(
        better[..., None],
        jnp.stack(
            [pgx.astype(jnp.float32), pgy.astype(jnp.float32)], axis=-1
        ),
        flow,
    )
    return flow, jnp.where(better, prop_cost, cost)


def _coarse_targets_from_global(p_y, p_x, s, h, w):
    """Global-argmax targets (possibly on a stride-s grid) -> full-
    resolution integer offset fields."""
    if s > 1:
        ys_s, xs_s = _grid(p_y.shape[0], p_y.shape[1])
        fy = (p_y - ys_s) * s
        fx = (p_x - xs_s) * s
        # nearest-upsample the proposal flow back to full resolution
        pgy = jnp.repeat(jnp.repeat(fy, s, 0), s, 1)[:h, :w]
        pgx = jnp.repeat(jnp.repeat(fx, s, 0), s, 1)[:h, :w]
        return pgy, pgx
    ysc, xsc = _grid(h, w)
    return p_y - ysc, p_x - xsc


@jax.named_scope("match")
def match_coarse(
    img1: jnp.ndarray,
    img2: jnp.ndarray,
    cost_cfg: CostConfig,
    match_cfg: MatchConfig,
    tap_chunk: int = 25,
    pack1: Optional[jnp.ndarray] = None,
    pack2: Optional[jnp.ndarray] = None,
    init_flow: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Coarse-level dense matching, frame 1 -> frame 2.

    Returns (tx, ty, cost): absolute int32 target fields + float32 cost,
    the same contract as ``ops.patchmatch.patchmatch``.

    ``init_flow`` (H, W, 2), when given, is a temporal warm start (e.g.
    the previous pair's flow resized to this level): always merged as a
    true-cost proposal; with ``match_cfg.warm_skip_global`` it replaces
    the global descriptor stages entirely (see MatchConfig).
    """
    h, w = img1.shape[0], img1.shape[1]
    skip_global = init_flow is not None and match_cfg.warm_skip_global
    levels = _mini_levels(h, w, match_cfg)
    packs1 = _mini_pyramid(img1, levels, pack0=pack1)
    packs2 = _mini_pyramid(img2, levels, pack0=pack2)
    pack1, pack2 = packs1[0], packs2[0]
    mini_cost = _make_mini_cost(cost_cfg, match_cfg)

    if skip_global:
        # Temporal warm start: begin from the previous pair's flow and
        # locally re-optimize (one dense residual sweep seeds the cost
        # field; propagation + exact polish below do the rest).
        flow, cost = descend_level(
            pack1, pack2, init_flow, match_cfg.descent_radius, cost_cfg,
            tap_chunk,
        )
    elif levels > 0:
        # --- tiny level: global descriptor matching ---
        tiny1, tiny2 = packs1[-1], packs2[-1]
        d1 = patch_descriptors(tiny1, match_cfg)
        d2 = patch_descriptors(tiny2, match_cfg)
        tiny_t = global_match(d1, d2, match_cfg.global_block)
        flow, cost = _descend_chain(
            packs1, packs2, tiny_t, match_cfg, cost_cfg, mini_cost,
            tap_chunk,
        )
    else:
        flow = jnp.zeros((h, w, 2), jnp.float32)
        gy, gx, _, _ = _flow_to_targets(flow, h, w)
        cost = rescore(pack1, pack2, gy, gx, cost_cfg, tap_chunk)

    if init_flow is not None and not skip_global:
        igx = jnp.trunc(init_flow[..., 0]).astype(jnp.int32)
        igy = jnp.trunc(init_flow[..., 1]).astype(jnp.int32)
        flow, cost = _merge_proposal(
            pack1, pack2, flow, cost, igy, igx, cost_cfg, tap_chunk
        )

    # --- global proposals at coarse resolution (large-displacement
    # recall, the role of PatchMatch's global random init) ---
    if match_cfg.global_at_coarse and not skip_global:
        # The argmax cost scales with N1*N2; above the threshold the
        # proposal grid subsamples by 2 on both frames (a proposal within
        # 1 px of the optimum is recovered by the final polish sweep,
        # radius >= 2).
        s = 2 if (h * w > match_cfg.global_stride_threshold) else 1
        dc1 = patch_descriptors(pack1, match_cfg, stride=s)
        dc2 = patch_descriptors(pack2, match_cfg, stride=s)
        p_y, p_x = global_match(dc1, dc2, match_cfg.global_block)
        pgy, pgx = _coarse_targets_from_global(p_y, p_x, s, h, w)
        flow, cost = _merge_proposal(
            pack1, pack2, flow, cost, pgy, pgx, cost_cfg, tap_chunk
        )

    return _polish_direction(
        pack1, pack2, flow, cost, match_cfg, cost_cfg, tap_chunk
    )


@jax.named_scope("match")
def match_coarse_bidi(
    img1: jnp.ndarray,
    img2: jnp.ndarray,
    cost_cfg: CostConfig,
    match_cfg: MatchConfig,
    tap_chunk: int = 25,
    pack1: Optional[jnp.ndarray] = None,
    pack2: Optional[jnp.ndarray] = None,
    init_flow: Optional[jnp.ndarray] = None,
):
    """Bidirectional coarse matching in one program: returns
    ((tx1, ty1, c1), (tx2, ty2, c2)), per-direction results identical to
    two ``match_coarse`` calls.

    The left-right check needs both directions every frame
    (bao_flow_patchmatch_multiscale_cuda.cpp:223-233); computing them
    together shares what two single-direction calls duplicate — the two
    mini-pyramids, the descriptor builds, and (the dominant term) the
    global N^2 descriptor score sweep, which one ``global_match_bidi``
    pass reduces over both axes at once.  ``init_flow`` seeds the
    forward direction; the backward direction uses its negation (the
    standard temporal-coherence approximation).
    """
    h, w = img1.shape[0], img1.shape[1]
    h2, w2 = img2.shape[0], img2.shape[1]
    skip_global = init_flow is not None and match_cfg.warm_skip_global
    levels = min(
        _mini_levels(h, w, match_cfg), _mini_levels(h2, w2, match_cfg)
    )
    packs1 = _mini_pyramid(img1, levels, pack0=pack1)
    packs2 = _mini_pyramid(img2, levels, pack0=pack2)
    pack1, pack2 = packs1[0], packs2[0]
    mini_cost = _make_mini_cost(cost_cfg, match_cfg)

    if skip_global:
        flow_f, cost_f = descend_level(
            pack1, pack2, init_flow, match_cfg.descent_radius, cost_cfg,
            tap_chunk,
        )
        flow_b, cost_b = descend_level(
            pack2, pack1, -init_flow, match_cfg.descent_radius, cost_cfg,
            tap_chunk,
        )
    elif levels > 0:
        tiny1, tiny2 = packs1[-1], packs2[-1]
        d1 = patch_descriptors(tiny1, match_cfg)
        d2 = patch_descriptors(tiny2, match_cfg)
        t1y, t1x, t2y, t2x = global_match_bidi(d1, d2, match_cfg.global_block)
        flow_f, cost_f = _descend_chain(
            packs1, packs2, (t1y, t1x), match_cfg, cost_cfg, mini_cost,
            tap_chunk,
        )
        flow_b, cost_b = _descend_chain(
            packs2, packs1, (t2y, t2x), match_cfg, cost_cfg, mini_cost,
            tap_chunk,
        )
    else:
        flow_f = jnp.zeros((h, w, 2), jnp.float32)
        flow_b = jnp.zeros((h2, w2, 2), jnp.float32)
        cost_f = rescore(
            pack1, pack2, jnp.zeros((h, w), jnp.int32),
            jnp.zeros((h, w), jnp.int32), cost_cfg, tap_chunk,
        )
        cost_b = rescore(
            pack2, pack1, jnp.zeros((h2, w2), jnp.int32),
            jnp.zeros((h2, w2), jnp.int32), cost_cfg, tap_chunk,
        )

    if init_flow is not None and not skip_global:
        igx = jnp.trunc(init_flow[..., 0]).astype(jnp.int32)
        igy = jnp.trunc(init_flow[..., 1]).astype(jnp.int32)
        flow_f, cost_f = _merge_proposal(
            pack1, pack2, flow_f, cost_f, igy, igx, cost_cfg, tap_chunk
        )
        bgx = jnp.trunc(-init_flow[..., 0]).astype(jnp.int32)
        bgy = jnp.trunc(-init_flow[..., 1]).astype(jnp.int32)
        flow_b, cost_b = _merge_proposal(
            pack2, pack1, flow_b, cost_b, bgy, bgx, cost_cfg, tap_chunk
        )

    if match_cfg.global_at_coarse and not skip_global:
        s = 2 if (
            max(h * w, h2 * w2) > match_cfg.global_stride_threshold
        ) else 1
        dc1 = patch_descriptors(pack1, match_cfg, stride=s)
        dc2 = patch_descriptors(pack2, match_cfg, stride=s)
        p1y, p1x, p2y, p2x = global_match_bidi(
            dc1, dc2, match_cfg.global_block
        )
        pgy, pgx = _coarse_targets_from_global(p1y, p1x, s, h, w)
        flow_f, cost_f = _merge_proposal(
            pack1, pack2, flow_f, cost_f, pgy, pgx, cost_cfg, tap_chunk
        )
        pgy, pgx = _coarse_targets_from_global(p2y, p2x, s, h2, w2)
        flow_b, cost_b = _merge_proposal(
            pack2, pack1, flow_b, cost_b, pgy, pgx, cost_cfg, tap_chunk
        )

    fwd = _polish_direction(
        pack1, pack2, flow_f, cost_f, match_cfg, cost_cfg, tap_chunk
    )
    bwd = _polish_direction(
        pack2, pack1, flow_b, cost_b, match_cfg, cost_cfg, tap_chunk
    )
    return fwd, bwd


def _polish_direction(
    pack1, pack2, flow, cost, match_cfg, cost_cfg, tap_chunk
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Shared tail of the coarse matcher: dense jump-flood propagation,
    the final polish sweep, and the exact-cost stage."""
    import dataclasses

    h, w = flow.shape[0], flow.shape[1]

    # --- dense jump-flood propagation (spatial coherence) ---
    if match_cfg.prop_steps:
        flow, cost = propagate_dense(
            pack1, pack2, flow, cost, match_cfg.prop_steps, cost_cfg,
            tap_chunk,
        )

    # --- final polish sweep at the coarse level ---
    if match_cfg.final_radius > 0:
        flow, cost = descend_level(
            pack1, pack2, flow, match_cfg.final_radius, cost_cfg, tap_chunk
        )

    ysc, xsc = _grid(h, w)
    tx = jnp.trunc(flow[..., 0]).astype(jnp.int32) + xsc
    ty = jnp.trunc(flow[..., 1]).astype(jnp.int32) + ysc

    # --- exact-cost polish (symmetric gathered cost; see MatchConfig) ---
    if match_cfg.exact_polish_radius > 0:
        from ..config import FLT_MAX
        from .cost import make_patch_stack, patch_cost_stack

        h2, w2 = pack2.shape[0], pack2.shape[1]
        exact_cfg = dataclasses.replace(
            cost_cfg, patch_stride=match_cfg.exact_tap_stride
        )
        offs2 = exact_cfg.tap_offsets
        # Pre-shifted tap stack, built once per direction: every exact
        # evaluation is then ONE wide row gather instead of T narrow
        # ones.  bf16 storage halves
        # the gathered bytes, exactly like the old gather_dtype=bf16
        # (scores are only compared, symmetrically in both directions).
        stack2 = make_patch_stack(pack2, offs2, dtype=jnp.bfloat16)

        def exact_multi(cgxs, cgys, mask_oob=True):
            """Exact quantized cost of K offset fields (K, H, W); out-of-
            image targets masked to FLT_MAX (quantization grid 2^-17 as
            everywhere, so cross-compilation argmins agree)."""
            ctxs = xsc[None] + cgxs
            ctys = ysc[None] + cgys
            ck = patch_cost_stack(
                pack1, stack2, ctxs, ctys, exact_cfg, offs2
            )
            ck = jnp.round(ck * 131072.0) * (1.0 / 131072.0)
            if mask_oob:
                inb = (
                    (ctxs >= 0) & (ctxs < w2) & (ctys >= 0) & (ctys < h2)
                )
                ck = jnp.where(inb, ck, FLT_MAX)
            return ck

        gx, gy = tx - xsc, ty - ysc
        # incumbent, exactly scored (unmasked, like the reference's own
        # clamped-texture reads at out-of-image targets)
        cost = exact_multi(gx[None], gy[None], mask_oob=False)[0]

        def best_of(cgxs, cgys, cur, strict=True):
            """Exact-score K candidate fields, take the per-pixel first
            minimum (candidate order = tie order), accept vs incumbent."""
            gx0, gy0, cost0 = cur
            ck = exact_multi(cgxs, cgys)
            i1 = jnp.argmin(ck, axis=0)
            cbest = jnp.take_along_axis(ck, i1[None], axis=0)[0]
            cgx = jnp.take_along_axis(cgxs, i1[None], axis=0)[0]
            cgy = jnp.take_along_axis(cgys, i1[None], axis=0)[0]
            win = (cbest < cost0) if strict else (cbest <= cost0)
            return (
                jnp.where(win, cgx, gx0),
                jnp.where(win, cgy, gy0),
                jnp.where(win, cbest, cost0),
            )

        # Polish: the whole ring around the incumbent is exact-scored in
        # one batched stack gather (the stack makes exact-everything
        # cheaper than an approximate preselect), in center-out tie
        # order.
        ring = [
            (m, n) for (m, n) in
            center_out_offsets(match_cfg.exact_polish_radius)
            if (m, n) != (0, 0)
        ]
        offs = jnp.asarray(ring, jnp.int32)  # (K, 2) as (dy, dx)
        cgys = gy[None] + offs[:, 0, None, None]
        cgxs = gx[None] + offs[:, 1, None, None]
        gx, gy, cost = best_of(cgxs, cgys, (gx, gy, cost))

        # Exact-cost propagation (coherence): per step, all 4 neighbor
        # offsets exact-scored in one batch; strict improvement keeps
        # the incumbent on ties.
        for step in match_cfg.exact_prop_steps:
            shifts = ((0, -step), (0, step), (-step, 0), (step, 0))
            cgys = jnp.stack([_shift2d(gy, dy, dx) for dy, dx in shifts])
            cgxs = jnp.stack([_shift2d(gx, dy, dx) for dy, dx in shifts])
            gx, gy, cost = best_of(cgxs, cgys, (gx, gy, cost))

        # Consensus relaxation (tie clustering): equality adopts, pulling
        # isolated tie-breaks toward the regional majority.
        for _ in range(match_cfg.exact_median_rounds):
            gx, gy, cost = best_of(
                median3(gx)[None], median3(gy)[None], (gx, gy, cost),
                strict=False,
            )
        tx, ty = xsc + gx, ysc + gy
    return tx, ty, cost
