"""Bilateral AD + census patch-matching cost — the hot op of EPPM.

Spec source: ``_d_compute_patch_dist`` (bao_pmflow_kernel.cu:255-301) and its
plane-fitting variant (:334-513).  For a pixel p1=(x1,y1) in frame 1 and a
candidate target p2=(x2,y2) in frame 2, the cost aggregates over a
(2R+1)x(2R+1) patch sampled with stride 2 ("pixel skipping",
bao_pmflow_kernel.cu:269-272 — 100 taps for R=9; note the tap grid
{-9,-7,...,7,9} does NOT include the center):

  per tap d=(i,j):
    ad     = max_c |I1(p1+d) - I2(p2+d)|          (max over R,G,B in [0,1])
    c_ad   = 1 - exp(-ad^2 / lambda_ad^2)
    ham    = popcount(census1(p1+d) XOR census2(p2+d))
    c_cen  = 1 - exp(-ham^2 / (lambda_census*8)^2)   (LUT at :681-686, folded)
    dr1    = max_c |I1(p1) - I1(p1+d)|
    dr2    = max_c |I2(p2) - I2(p2+d)|
    w      = exp(-(dr1^2+dr2^2)/sigma_r^2) * G(|i|) * G(|j|)
    G(k)   = exp(-k^2 / sigma_s^2)                   (LUT at :671-679, folded)
  cost = sum(w * (c_ad + c_cen)) / sum(w)

All reads clamp at image borders (CUDA texture clamp addressing).

Design
------
Frames are packed as (H, W, 4) float32 [r, g, b, census] so each tap costs a
single gather of the frame-2 pack at (ty+i, tx+j) plus a static shifted view
of the frame-1 pack.  The tap loop is a ``lax.scan`` over chunks of taps,
with the taps inside a chunk vmapped — bounding peak memory at
``chunk * H * W * 4`` floats.  The census
Hamming distance uses branch-free popcount bit tricks instead of the
reference's sequential Kernighan loop (:280-282); the spatial/census Gauss
LUTs are folded into closed-form math.

The plane-fitting variant's four affine hypotheses evaluate frame-2 taps at
point-sampled (floored) warped coordinates (:358-367); since query coords
are integral, flooring commutes and each hypothesis reduces to a *static*
integer tap-offset table — the same kernel with a different offset list.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import CostConfig
from ._util import popcount8 as _popcount8_util

__all__ = [
    "pack_frame",
    "patch_cost",
    "patch_cost_candidates",
    "plane_offsets",
    "patch_cost_planefitting",
    "patch_cost_ad_l2",
]

# Plane-fitting affine hypothesis coefficients (u_x, u_y, v_x, v_y)
# (bao_pmflow_kernel.cu:319-332).
PLANE_COEFS = (
    (0.177, -0.011, -0.003, 0.301),   # COEF_FL_*
    (0.125, -0.357, 0.009, 0.308),    # COEF_LEFT_*
    (0.205, 0.370, 0.011, 0.296),     # COEF_RIGHT_*
)


def pack_frame(img: jnp.ndarray, census: jnp.ndarray) -> jnp.ndarray:
    """Pack (H, W, 3) float image + (H, W) int census -> (H, W, 4) f32."""
    return jnp.concatenate(
        [img.astype(jnp.float32), census.astype(jnp.float32)[..., None]], axis=-1
    )


_popcount8 = _popcount8_util


def _maxabs3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    d = jnp.abs(a - b)
    return jnp.maximum(jnp.maximum(d[..., 0], d[..., 1]), d[..., 2])


def _tap_tables(
    cfg: CostConfig, offsets1, offsets2, chunk: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Build (n_chunks, chunk, 5) int tap table and (n_chunks, chunk) f32
    spatial weights.  Columns: dy1, dx1, dy2, dx2.  Padding taps get zero
    spatial weight so they contribute nothing."""
    sig_s2 = cfg.sigma_spatial * cfg.sigma_spatial
    taps = []
    gws = []
    for (i1, j1), (i2, j2) in zip(offsets1, offsets2):
        taps.append((i1, j1, i2, j2))
        gws.append(
            math.exp(-(j1 * j1) / sig_s2) * math.exp(-(i1 * i1) / sig_s2)
        )
    n = len(taps)
    n_pad = (-n) % chunk
    taps += [(0, 0, 0, 0)] * n_pad
    gws += [0.0] * n_pad
    tap_arr = np.asarray(taps, dtype=np.int32).reshape(-1, chunk, 4)
    gw_arr = np.asarray(gws, dtype=np.float32).reshape(-1, chunk)
    return tap_arr, gw_arr, n


def _patch_cost_offsets(
    pack1: jnp.ndarray,
    pack2: jnp.ndarray,
    tx: jnp.ndarray,
    ty: jnp.ndarray,
    cfg: CostConfig,
    offsets2: Sequence[Tuple[int, int]],
    tap_chunk: int,
    pack1_halo: int = 0,
    gather_dtype=None,
) -> jnp.ndarray:
    """Weighted patch cost with per-tap frame-2 offsets ``offsets2``
    (frame-1 offsets are always the regular stride-2 grid).

    Multi-chip tiling: ``pack1`` may be a query *tile* carrying
    ``pack1_halo`` extra rows/cols per side (exchanged from neighbor
    shards); ``tx``/``ty`` give absolute coordinates into the full
    (replicated) ``pack2``, whose dims may differ from the tile's.
    """
    H, W = tx.shape
    H2, W2 = pack2.shape[0], pack2.shape[1]
    R = cfg.patch_radius
    tap_arr, gw_arr, _ = _tap_tables(cfg, cfg.tap_offsets, offsets2, tap_chunk)

    pad_extra = max(R - pack1_halo, 0)
    base = pack1_halo + pad_extra
    if pad_extra > 0:
        pad1 = jnp.pad(
            pack1, ((pad_extra, pad_extra), (pad_extra, pad_extra), (0, 0)),
            mode="edge",
        )
    else:
        pad1 = pack1
    # Optional narrow gather dtype: the gathers dominate this op's cost
    # (random device-memory access); bf16 halves the bytes moved.  The census
    # channel (integers 0..255) is exact in bf16; RGB in [0,1] keeps an
    # 8-bit mantissa.  Used by the match-engine's internal exact stage
    # (its scores are only compared, symmetrically in both directions);
    # the default keeps the full-precision reference oracle.
    if gather_dtype is not None:
        pack2_flat = pack2.astype(gather_dtype).reshape(-1, 4)
    else:
        pack2_flat = pack2.reshape(-1, 4)

    lam_ad2 = cfg.lambda_ad * cfg.lambda_ad
    lam_cen2 = (cfg.lambda_census * cfg.census_max_diff) ** 2
    inv_sig_r2 = 1.0 / (cfg.sigma_range * cfg.sigma_range)

    txc = jnp.clip(tx, 0, W2 - 1)
    tyc = jnp.clip(ty, 0, H2 - 1)
    center1 = jax.lax.dynamic_slice(pad1, (base, base, 0), (H, W, 4))[..., :3]
    center2 = jnp.take(pack2_flat, tyc * W2 + txc, axis=0).astype(
        jnp.float32
    )[..., :3]

    def one_tap(tap, gw):
        dy1, dx1, dy2, dx2 = tap[0], tap[1], tap[2], tap[3]
        p1 = jax.lax.dynamic_slice(pad1, (base + dy1, base + dx1, 0), (H, W, 4))
        cy = jnp.clip(ty + dy2, 0, H2 - 1)
        cx = jnp.clip(tx + dx2, 0, W2 - 1)
        p2 = jnp.take(pack2_flat, cy * W2 + cx, axis=0).astype(jnp.float32)
        ad = _maxabs3(p1[..., :3], p2[..., :3])
        c_ad = 1.0 - jnp.exp(-(ad * ad) / lam_ad2)
        ham = _popcount8(
            p1[..., 3].astype(jnp.int32) ^ p2[..., 3].astype(jnp.int32)
        ).astype(jnp.float32)
        c_cen = 1.0 - jnp.exp(-(ham * ham) / lam_cen2)
        dr1 = _maxabs3(center1, p1[..., :3])
        dr2 = _maxabs3(center2, p2[..., :3])
        w = jnp.exp(-(dr1 * dr1 + dr2 * dr2) * inv_sig_r2) * gw
        return w * (c_ad + c_cen), w

    def chunk_step(carry, chunk_data):
        acc_c, acc_w = carry
        taps, gws = chunk_data
        cs, ws = jax.vmap(one_tap)(taps, gws)
        return (acc_c + cs.sum(0), acc_w + ws.sum(0)), None

    init = (jnp.zeros((H, W), jnp.float32), jnp.zeros((H, W), jnp.float32))
    (cost_sum, weight_sum), _ = jax.lax.scan(
        chunk_step, init, (jnp.asarray(tap_arr), jnp.asarray(gw_arr))
    )
    # The reference divides unguarded (:300); with sigma_r=0.1 the range
    # weight can underflow to zero for ALL taps on extreme patches, giving
    # NaN.  We clamp to keep costs finite (NaN candidates are never accepted
    # in the reference either, so behavior matches).
    return cost_sum / jnp.maximum(weight_sum, 1e-30)


def patch_cost(
    pack1: jnp.ndarray,
    pack2: jnp.ndarray,
    tx: jnp.ndarray,
    ty: jnp.ndarray,
    cfg: CostConfig = CostConfig(),
    tap_chunk: int = 25,
    pack1_halo: int = 0,
    gather_dtype=None,
) -> jnp.ndarray:
    """Fronto-parallel bilateral AD+census cost (bao_pmflow_kernel.cu:255-301).

    pack1/pack2: (H, W, 4) packed frames; tx/ty: (H, W) int32 absolute
    target coordinates (out-of-range targets read clamped pixels, exactly
    like CUDA texture clamp addressing).  Returns (H, W) float32.
    ``gather_dtype`` narrows the frame-2 gathers (see _patch_cost_offsets).
    """
    return _patch_cost_offsets(
        pack1, pack2, tx, ty, cfg, cfg.tap_offsets, tap_chunk, pack1_halo,
        gather_dtype,
    )


def make_patch_stack(
    pack2: jnp.ndarray,
    offsets2: Sequence[Tuple[int, int]],
    dtype=None,
) -> jnp.ndarray:
    """Pre-shifted tap stack for gather-efficient exact patch costs.

    Returns (H2, W2, T*4): channel group t holds
    ``pack2[clip(y + dy_t), clip(x + dx_t)]`` (edge-clamped static
    shifts).  With the stack built once, the exact patch cost of ANY
    target field needs a single row gather of T*4-wide rows instead of T
    separate 4-wide gathers — fewer, wider rows per evaluation, and the
    stack amortizes
    across every evaluation sharing the tap table (the match engine's
    exact stage scores ~14 candidate fields per direction).

    Border note: for in-image targets the taps are identical to
    ``patch_cost``; an out-of-image target t reads taps
    ``clip(clip(t)+d)`` instead of ``clip(t+d)`` — exact-stage consumers
    mask out-of-image targets to FLT_MAX anyway.

    Layout: T tap groups followed by one (0, 0) *center* group (the
    range-weight reference pixel; tap grids like the exact stage's
    stride-4 {-9,-5,-1,3,7} don't contain the center themselves).
    """
    from ._util import shift2d

    stack = jnp.concatenate(
        [shift2d(pack2, dy, dx) for (dy, dx) in offsets2] + [pack2],
        axis=-1,
    )
    if dtype is not None:
        stack = stack.astype(dtype)
    return stack


def patch_cost_stack(
    pack1: jnp.ndarray,
    stack2: jnp.ndarray,
    txs: jnp.ndarray,
    tys: jnp.ndarray,
    cfg: CostConfig,
    offsets2: Sequence[Tuple[int, int]],
) -> jnp.ndarray:
    """Exact bilateral AD+census cost of K target fields against a
    pre-shifted tap stack (``make_patch_stack(pack2, offsets2)``).

    txs/tys: (K, H, W) int32 absolute targets -> (K, H, W) float32 costs.
    Semantically equal to ``patch_cost`` per field for in-image targets
    (see make_patch_stack for the border caveat); the tap table
    ``offsets2`` must be the one the stack was built with, and frame-1
    offsets mirror cfg.tap_offsets as in ``_patch_cost_offsets``.
    """
    K, H, W = txs.shape
    H2, W2 = stack2.shape[0], stack2.shape[1]
    T = len(offsets2)
    R = cfg.patch_radius
    sig_s2 = cfg.sigma_spatial * cfg.sigma_spatial
    lam_ad2 = cfg.lambda_ad * cfg.lambda_ad
    lam_cen2 = (cfg.lambda_census * cfg.census_max_diff) ** 2
    inv_sig_r2 = 1.0 / (cfg.sigma_range * cfg.sigma_range)

    pad1 = jnp.pad(pack1, ((R, R), (R, R), (0, 0)), mode="edge")
    flat = stack2.reshape(H2 * W2, 4 * (T + 1))
    idx = (
        jnp.clip(tys, 0, H2 - 1) * W2 + jnp.clip(txs, 0, W2 - 1)
    ).reshape(-1)
    # ONE gather: (K*H*W, 4(T+1)) -> (K, H, W, T+1, 4) float32 tap values
    taps2 = (
        jnp.take(flat, idx, axis=0)
        .reshape(K, H, W, T + 1, 4)
        .astype(jnp.float32)
    )
    # frame-2 range-weight center = the target pixel itself (the stack's
    # final group, see make_patch_stack)
    center2 = taps2[..., T, :3]

    center1 = pack1[..., :3]

    cost_sum = jnp.zeros((K, H, W), jnp.float32)
    weight_sum = jnp.zeros((K, H, W), jnp.float32)
    for t, ((i1, j1), (i2, j2)) in enumerate(
        zip(cfg.tap_offsets, offsets2)
    ):
        gw = math.exp(-(j1 * j1) / sig_s2) * math.exp(-(i1 * i1) / sig_s2)
        p1 = jax.lax.dynamic_slice(
            pad1, (R + i1, R + j1, 0), (H, W, 4)
        )
        p2 = taps2[..., t, :]
        ad = _maxabs3(p1[None, ..., :3], p2[..., :3])
        c_ad = 1.0 - jnp.exp(-(ad * ad) / lam_ad2)
        ham = _popcount8(
            p1[None, ..., 3].astype(jnp.int32)
            ^ p2[..., 3].astype(jnp.int32)
        ).astype(jnp.float32)
        c_cen = 1.0 - jnp.exp(-(ham * ham) / lam_cen2)
        dr1 = _maxabs3(center1, p1[..., :3])[None]
        dr2 = _maxabs3(center2, p2[..., :3])
        w = jnp.exp(-(dr1 * dr1 + dr2 * dr2) * inv_sig_r2) * gw
        cost_sum = cost_sum + w * (c_ad + c_cen)
        weight_sum = weight_sum + w
    return cost_sum / jnp.maximum(weight_sum, 1e-30)


def patch_cost_candidates(
    pack1: jnp.ndarray,
    pack2: jnp.ndarray,
    txs: jnp.ndarray,
    tys: jnp.ndarray,
    cfg: CostConfig = CostConfig(),
    tap_chunk: int = 25,
    sequential: bool = False,
) -> jnp.ndarray:
    """Cost for K candidate fields: txs/tys (K, H, W) -> (K, H, W).

    ``sequential=True`` evaluates candidates through ``lax.map`` to bound
    peak memory at full resolution; otherwise candidates are vmapped.
    """
    fn = lambda t: patch_cost(pack1, pack2, t[0], t[1], cfg, tap_chunk)
    if sequential:
        return jax.lax.map(fn, (txs, tys))
    return jax.vmap(lambda a, b: patch_cost(pack1, pack2, a, b, cfg, tap_chunk))(
        txs, tys
    )


def plane_offsets(cfg: CostConfig) -> List[Tuple[Tuple[int, int], ...]]:
    """Static frame-2 tap-offset tables for the 4 plane hypotheses.

    Hypothesis 0 is fronto-parallel (offsets equal the frame-1 grid); 1-3
    warp tap (i, j) to (i + j*v_x + i*v_y, j + j*u_x + i*u_y), floored —
    point-sampled float texture reads at integral query coords
    (bao_pmflow_kernel.cu:402-407 with default point filterMode).
    """
    tables = [tuple(cfg.tap_offsets)]
    for ux, uy, vx, vy in PLANE_COEFS:
        table = tuple(
            (
                int(math.floor(i + j * vx + i * vy)),
                int(math.floor(j + j * ux + i * uy)),
            )
            for (i, j) in cfg.tap_offsets
        )
        tables.append(table)
    return tables


def patch_cost_planefitting(
    pack1: jnp.ndarray,
    pack2: jnp.ndarray,
    tx: jnp.ndarray,
    ty: jnp.ndarray,
    cfg: CostConfig = CostConfig(),
    tap_chunk: int = 25,
    pack1_halo: int = 0,
) -> jnp.ndarray:
    """Min over the 4 affine-warp hypotheses (bao_pmflow_kernel.cu:334-513)."""
    cost = None
    for offsets2 in plane_offsets(cfg):
        c = _patch_cost_offsets(
            pack1, pack2, tx, ty, cfg, offsets2, tap_chunk, pack1_halo
        )
        cost = c if cost is None else jnp.minimum(cost, c)
    return cost


def patch_cost_scaled(
    pack1: jnp.ndarray,
    pack2: jnp.ndarray,
    tx: jnp.ndarray,
    ty: jnp.ndarray,
    scale: jnp.ndarray,
    cfg: CostConfig = CostConfig(),
    tap_chunk: int = 25,
) -> jnp.ndarray:
    """Scaled-patch bilateral AD cost (_d_compute_patch_dist_scaled,
    bao_pmflow_kernel.cu:588-634): frame-2 taps sample at
    floor(t + d * scale) with a per-pixel patch scale; the census term is
    disabled in the reference variant (commented out, :610-615) and is
    omitted here too.
    """
    H, W = tx.shape
    H2, W2 = pack2.shape[0], pack2.shape[1]
    R = cfg.patch_radius
    sig_s2 = cfg.sigma_spatial * cfg.sigma_spatial
    lam_ad2 = cfg.lambda_ad * cfg.lambda_ad
    inv_sig_r2 = 1.0 / (cfg.sigma_range * cfg.sigma_range)

    pad1 = jnp.pad(pack1, ((R, R), (R, R), (0, 0)), mode="edge")
    pack2_flat = pack2.reshape(-1, 4)
    txc = jnp.clip(tx, 0, W2 - 1)
    tyc = jnp.clip(ty, 0, H2 - 1)
    center1 = pack1[..., :3]
    center2 = jnp.take(pack2_flat, tyc * W2 + txc, axis=0)[..., :3]

    taps = []
    gws = []
    for (i, j) in cfg.tap_offsets:
        taps.append((i, j))
        gws.append(
            math.exp(-(j * j) / sig_s2) * math.exp(-(i * i) / sig_s2)
        )
    n_pad = (-len(taps)) % tap_chunk
    taps += [(0, 0)] * n_pad
    gws += [0.0] * n_pad
    tap_arr = np.asarray(taps, np.int32).reshape(-1, tap_chunk, 2)
    gw_arr = np.asarray(gws, np.float32).reshape(-1, tap_chunk)

    def one_tap(tap, gw):
        i, j = tap[0], tap[1]
        p1 = jax.lax.dynamic_slice(pad1, (R + i, R + j, 0), (H, W, 4))
        # floor(t + d*s) == t + floor(d*s) for integer t
        oy = jnp.floor(i.astype(jnp.float32) * scale).astype(jnp.int32)
        ox = jnp.floor(j.astype(jnp.float32) * scale).astype(jnp.int32)
        cy = jnp.clip(ty + oy, 0, H2 - 1)
        cx = jnp.clip(tx + ox, 0, W2 - 1)
        p2 = jnp.take(pack2_flat, cy * W2 + cx, axis=0)
        ad = _maxabs3(p1[..., :3], p2[..., :3])
        c_ad = 1.0 - jnp.exp(-(ad * ad) / lam_ad2)
        dr1 = _maxabs3(center1, p1[..., :3])
        dr2 = _maxabs3(center2, p2[..., :3])
        w = jnp.exp(-(dr1 * dr1 + dr2 * dr2) * inv_sig_r2) * gw
        return w * c_ad, w

    def chunk_step(carry, data):
        acc_c, acc_w = carry
        tap, gw = data
        cs, ws = jax.vmap(one_tap)(tap, gw)
        return (acc_c + cs.sum(0), acc_w + ws.sum(0)), None

    init = (jnp.zeros((H, W), jnp.float32), jnp.zeros((H, W), jnp.float32))
    (cost_sum, weight_sum), _ = jax.lax.scan(
        chunk_step, init, (jnp.asarray(tap_arr), jnp.asarray(gw_arr))
    )
    return cost_sum / jnp.maximum(weight_sum, 1e-30)


def patch_cost_ad_l2(
    img1: jnp.ndarray,
    img2: jnp.ndarray,
    tx: jnp.ndarray,
    ty: jnp.ndarray,
    cfg: CostConfig = CostConfig(),
) -> jnp.ndarray:
    """Unweighted robust-AD cost (bao_pmflow_kernel.cu:555-586); used by the
    still-region suppressor (:2072-2095)."""
    H, W = img1.shape[0], img1.shape[1]
    R = cfg.patch_radius
    lam_ad2 = cfg.lambda_ad * cfg.lambda_ad
    pad1 = jnp.pad(img1, ((R, R), (R, R), (0, 0)), mode="edge")
    img2_flat = img2.reshape(-1, 3)
    acc = jnp.zeros((H, W), jnp.float32)
    n = 0
    for (i, j) in cfg.tap_offsets:
        p1 = jax.lax.dynamic_slice(pad1, (R + i, R + j, 0), (H, W, 3))
        cy = jnp.clip(ty + i, 0, H - 1)
        cx = jnp.clip(tx + j, 0, W - 1)
        p2 = jnp.take(img2_flat, cy * W + cx, axis=0)
        ad = _maxabs3(p1, p2)
        acc = acc + (1.0 - jnp.exp(-(ad * ad) / lam_ad2))
        n += 1
    return acc / float(n)
