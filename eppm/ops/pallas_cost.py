"""Pallas kernel (Triton route) for the dense residual patch cost — the
hot op of every pyramid level.

Computes, for K candidates and a set of plane-hypothesis tap tables, the
bilateral AD+census patch cost between ``pack1`` and pre-warped frame-2
packs (see ops/dense.py ``residual_costs`` for the math and the
reference citations: _d_compute_patch_dist, bao_pmflow_kernel.cu:255-301;
plane hypotheses :334-513).  ``residual_costs`` is the plain reference
and the form every non-CUDA backend runs.

Why a kernel: the XLA form is a ``lax.map`` over candidates times tap
tables, each a scan over 25-tap chunks, so it re-reads both packs and
recomputes the frame-1 half of the bilateral weight once per candidate
and table, and every chunk materializes (25, H, W, 4) tap slices in
device memory.  Here one program owns a (BY, BX) pixel tile and a group
of candidates: per tap it loads the frame-1 tap once and evaluates every
candidate of the group from registers and L1, so device-memory traffic
is the two packs plus the output.

Layout: channel-planar (4, H, W) packs, edge-padded by the tap reach on
the host so every load is in bounds (no masks), and padded up to whole
tiles at the bottom/right (cropped after).  The grid is (tile rows, tile
cols, table x candidate group); nothing carries between programs.

Numerics: the per-tap weight is the oracle's exact expression
``exp(-(dr1^2 + dr2^2) / sig_r^2) * gw``; sums run in another order than
XLA's chunked reduction, and the GPU ``exp`` differs in the last bits,
so a cost can land one 2^-17 quantization step away from the oracle's
(tests and chip_smoke.py hold the kernel to 1e-4 and to >= 99.9%
argmin agreement).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..config import CostConfig
from ._util import round_up as _round_up
from .cost import plane_offsets

__all__ = [
    "residual_costs_triton",
    "residual_costs_multiwarp_triton",
    "residual_costs_auto",
    "residual_costs_multiwarp_auto",
]

# Tile and candidate-group defaults (chosen on the card; PERF.md).
BLOCK = (8, 32)
GROUP = 9
NUM_WARPS = 4

_QUANT = 131072.0  # 2^17: the oracle's tie-stability grid


def _round_half_even(x):
    """jnp.round (half to even) from floor, which the Triton route lowers."""
    r = jnp.floor(x + 0.5)
    odd = (r - 2.0 * jnp.floor(r * 0.5)) != 0.0
    return jnp.where(((r - x) == 0.5) & odd, r - 1.0, r)


def _maxabs3(a, b):
    return jnp.maximum(
        jnp.maximum(jnp.abs(a[0] - b[0]), jnp.abs(a[1] - b[1])),
        jnp.abs(a[2] - b[2]),
    )


def _cost_kernel(
    taps_ref,   # (n_taps, 2 + 2T) int32: dy1, dx1, then (dy2, dx2) per table
    gws_ref,    # (n_taps,) float32 spatial weights
    cands_ref,  # (G*KG, 3) int32: warp index, cy, cx
    p1_ref,     # (4, H1p, W1p) frame-1 pack, padded by R1
    w2_ref,     # (4*Kw, H2p, W2p) warped frame-2 packs, padded by P2
    out_ref,    # (T, G*KG, Hr, Wr)
    *,
    n_taps: int, n_groups: int, KG: int, BY: int, BX: int, R1: int, P2: int,
    inv_lam_ad2: float, inv_lam_cen2: float, inv_sig_r2: float,
):
    y0 = pl.program_id(0) * BY
    x0 = pl.program_id(1) * BX
    q = pl.program_id(2)
    tb = q // n_groups
    g = q % n_groups

    def tile1(c, dy, dx):
        return p1_ref[c, pl.ds(y0 + R1 + dy, BY), pl.ds(x0 + R1 + dx, BX)]

    def tile2(c, dy, dx):
        return w2_ref[c, pl.ds(y0 + P2 + dy, BY), pl.ds(x0 + P2 + dx, BX)]

    center1 = [tile1(c, 0, 0) for c in range(3)]
    cands = []
    for kk in range(KG):
        k = g * KG + kk
        base = 4 * cands_ref[k, 0]
        cy = cands_ref[k, 1]
        cx = cands_ref[k, 2]
        center2 = [tile2(base + c, cy, cx) for c in range(3)]
        cands.append((base, cy, cx, center2))

    def tap_body(t, accs):
        dy1 = taps_ref[t, 0]
        dx1 = taps_ref[t, 1]
        dy2 = taps_ref[t, 2 + 2 * tb]
        dx2 = taps_ref[t, 3 + 2 * tb]
        gw = gws_ref[t]
        a = [tile1(c, dy1, dx1) for c in range(4)]
        dr1 = _maxabs3(center1, a)
        dr1_2 = dr1 * dr1
        s1 = a[3].astype(jnp.int32)
        out = []
        for kk, (base, cy, cx, center2) in enumerate(cands):
            b = [tile2(base + c, cy + dy2, cx + dx2) for c in range(4)]
            ad = _maxabs3(a, b)
            c_ad = 1.0 - jnp.exp(-(ad * ad) * inv_lam_ad2)
            ham = jax.lax.population_count(
                s1 ^ b[3].astype(jnp.int32)
            ).astype(jnp.float32)
            c_cen = 1.0 - jnp.exp(-(ham * ham) * inv_lam_cen2)
            dr2 = _maxabs3(center2, b)
            wgt = jnp.exp(-(dr1_2 + dr2 * dr2) * inv_sig_r2) * gw
            acc_c, acc_w = accs[kk]
            out.append((acc_c + wgt * (c_ad + c_cen), acc_w + wgt))
        return tuple(out)

    zero = jnp.zeros((BY, BX), jnp.float32)
    accs = jax.lax.fori_loop(
        0, n_taps, tap_body, tuple((zero, zero) for _ in range(KG))
    )
    for kk, (acc_c, acc_w) in enumerate(accs):
        cost = acc_c / jnp.maximum(acc_w, 1e-30)
        out_ref[tb, g * KG + kk, pl.ds(y0, BY), pl.ds(x0, BX)] = (
            _round_half_even(cost * _QUANT) * (1.0 / _QUANT)
        )


def _costs(
    pack1: jnp.ndarray,
    warped: jnp.ndarray,
    cands: Sequence[Tuple[int, int, int]],
    tables: Sequence[Tuple[Tuple[int, int], ...]],
    cfg: CostConfig,
    block: Tuple[int, int] = BLOCK,
    group: int = GROUP,
    num_warps: int = NUM_WARPS,
    interpret: bool = False,
) -> jnp.ndarray:
    """Quantized cost of each (warp index, cy, cx) candidate under each
    tap table: pack1 (H, W, 4), warped (Kw, H, W, 4) -> (T, K, H, W)."""
    h, w = pack1.shape[0], pack1.shape[1]
    kw = warped.shape[0]
    BY, BX = block
    K, T = len(cands), len(tables)
    KG = min(group, K)
    n_groups = -(-K // KG)
    # pad the candidate list to whole groups (extra outputs are dropped)
    cands = list(cands) + [cands[-1]] * (n_groups * KG - K)

    taps1 = tuple(cfg.tap_offsets)
    sig_s2 = cfg.sigma_spatial * cfg.sigma_spatial
    taps_arr = np.zeros((len(taps1), 2 + 2 * T), np.int32)
    gws = np.zeros((len(taps1),), np.float32)
    for t, (dy1, dx1) in enumerate(taps1):
        taps_arr[t, :2] = (dy1, dx1)
        gws[t] = math.exp(-(dy1 * dy1) / sig_s2) * math.exp(
            -(dx1 * dx1) / sig_s2
        )
        for tb, table in enumerate(tables):
            taps_arr[t, 2 + 2 * tb : 4 + 2 * tb] = table[t]

    R1 = max(max(abs(i), abs(j)) for (i, j) in taps1)
    cmax = max(max(abs(cy), abs(cx)) for (_, cy, cx) in cands)
    tmax = max(max(abs(i), abs(j)) for tbl in tables for (i, j) in tbl)
    P2 = cmax + tmax
    hr, wr = _round_up(h, BY), _round_up(w, BX)
    p1 = jnp.pad(
        jnp.moveaxis(pack1, -1, 0),
        ((0, 0), (R1, R1 + hr - h), (R1, R1 + wr - w)), mode="edge",
    )
    w2 = jnp.pad(
        jnp.moveaxis(warped, -1, 1).reshape(4 * kw, h, w),
        ((0, 0), (P2, P2 + hr - h), (P2, P2 + wr - w)), mode="edge",
    )

    kern = functools.partial(
        _cost_kernel,
        n_taps=len(taps1), n_groups=n_groups, KG=KG, BY=BY, BX=BX,
        R1=R1, P2=P2,
        inv_lam_ad2=1.0 / cfg.lambda_ad**2,
        inv_lam_cen2=1.0 / (cfg.lambda_census * cfg.census_max_diff) ** 2,
        inv_sig_r2=1.0 / cfg.sigma_range**2,
    )
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct(
            (T, n_groups * KG, hr, wr), jnp.float32
        ),
        grid=(hr // BY, wr // BX, T * n_groups),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=1
        ),
        interpret=interpret,
        name="residual_cost",
    )(
        jnp.asarray(taps_arr), jnp.asarray(gws),
        jnp.asarray(np.asarray(cands, np.int32)), p1, w2,
    )
    return out[:, :K, :h, :w]


def residual_costs_triton(
    pack1: jnp.ndarray,
    warped2: jnp.ndarray,
    cand_offsets: Sequence[Tuple[int, int]],
    cfg: CostConfig,
    use_planes: bool = True,
    **kw,
) -> jnp.ndarray:
    """Kernel form of ``ops.dense.residual_costs``: (K, H, W), the
    per-candidate min over plane hypotheses."""
    tables = plane_offsets(cfg) if use_planes else [tuple(cfg.tap_offsets)]
    cands = [(0, cy, cx) for (cy, cx) in cand_offsets]
    return _costs(pack1, warped2[None], cands, tables, cfg, **kw).min(0)


def residual_costs_multiwarp_triton(
    pack1: jnp.ndarray, warped_stack: jnp.ndarray, cfg: CostConfig, **kw
) -> jnp.ndarray:
    """Fronto-parallel cost of K different warped frames at offset 0:
    warped_stack (K, H, W, 4) -> (K, H, W), one launch (the dense
    matcher's propagation rescoring, ops/match.py ``rescore_multi``)."""
    cands = [(k, 0, 0) for k in range(warped_stack.shape[0])]
    return _costs(
        pack1, warped_stack, cands, [tuple(cfg.tap_offsets)], cfg, **kw
    )[0]


@jax.named_scope("residual_cost")
def residual_costs_auto(
    pack1: jnp.ndarray,
    warped2: jnp.ndarray,
    cand_offsets: Sequence[Tuple[int, int]],
    cfg: CostConfig,
    use_planes: bool = True,
    tap_chunk: int = 25,
) -> jnp.ndarray:
    """The kernel when lowering for CUDA, the XLA reference elsewhere
    (chosen at lowering by ``lax.platform_dependent``)."""
    from .dense import residual_costs

    return jax.lax.platform_dependent(
        pack1, warped2,
        cuda=lambda a, b: residual_costs_triton(
            a, b, cand_offsets, cfg, use_planes
        ),
        default=lambda a, b: residual_costs(
            a, b, cand_offsets, cfg, use_planes, tap_chunk
        ),
    )


@jax.named_scope("residual_cost")
def residual_costs_multiwarp_auto(
    pack1: jnp.ndarray,
    warped_stack: jnp.ndarray,
    cfg: CostConfig,
    tap_chunk: int = 25,
) -> jnp.ndarray:
    """Dispatch of ``residual_costs_multiwarp_triton`` (XLA reference: one
    fronto-parallel ``residual_costs`` per warp)."""
    from .dense import residual_costs

    def xla_form(a, stack):
        return jax.lax.map(
            lambda wp: residual_costs(a, wp, [(0, 0)], cfg, False, tap_chunk)[0],
            stack,
        )

    return jax.lax.platform_dependent(
        pack1, warped_stack,
        cuda=lambda a, s: residual_costs_multiwarp_triton(a, s, cfg),
        default=xla_form,
    )
