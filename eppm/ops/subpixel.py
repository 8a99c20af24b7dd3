"""Subpixel flow refinement via quadratic cost-surface fitting.

Spec: ``d_subpixel_refine`` (bao_pmflow_refine_kernel.cu:393-633).  For
each pixel with a valid integer NNF target t: evaluate the bilateral
AD+census patch cost at the 5x5 half-pixel grid t + (dx, dy)/2, fit the
quadratic surface  a x^2 + b y^2 + c xy + d x + e y + f  by least squares
and move the flow to its analytic minimum (accepted when the stationary
point is within +-3 grid units).  Patch taps are sampled at half-pixel
positions: images through the cubic-B-spline filter of the NVIDIA bicubic
sampler (3rdparty/nv-cuda-v5.0/bicubicTexture_kernel.cuh:40-105, with its
half-texel origin), census through a census transform of the 2x
bicubic-upsampled image (baoCudaCensusTransform_Bicubic,
bao_pmflow_census_kernel.cu:115-181).

The reference allocates buffers for this stage but never calls it in the
default path (bao_flow_patchmatch_multiscale_cuda.cpp:135-136, SURVEY.md
section 2.4); it ships here as an optional post-process
(``EPPMConfig.subpixel_refine``).

Shape: the reference's per-pixel 6x6 conjugate-gradient solve
(:473-536) disappears — the design matrix A is the same for every pixel,
so the least-squares solve is a constant 6x25 pseudo-inverse folded at
trace time, applied as one einsum over the cost grid.  Frame-2 sampling
uses the once-warped frame (see ops/dense.py) so every tap is a static
fractional shift: cubic B-spline filtering at a static phase is a
separable 4-tap stencil.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SubpixelConfig, UNKNOWN_FLOW_THRESH
from ._util import popcount8 as _popcount8, shift2d as _shift
from .census import census_transform
from .dense import warp_pack

__all__ = [
    "bspline_weights",
    "bicubic_shift",
    "bicubic_resize2x",
    "census_2x",
    "subpixel_refine",
]


def bspline_weights(a: float) -> Tuple[float, float, float, float]:
    """Cubic B-spline filter weights w0..w3 at fractional phase ``a``
    (bicubicTexture_kernel.cuh:28-51)."""
    w0 = (1.0 / 6.0) * (-(a**3) + 3 * a * a - 3 * a + 1)
    w1 = (1.0 / 6.0) * (3 * a**3 - 6 * a * a + 4)
    w2 = (1.0 / 6.0) * (-3 * a**3 + 3 * a * a + 3 * a + 1)
    w3 = (1.0 / 6.0) * (a**3)
    return w0, w1, w2, w3


def bicubic_shift(img: jnp.ndarray, offy: float, offx: float) -> jnp.ndarray:
    """Sample ``img`` at (y + offy, x + offx) for a static fractional
    offset, with the reference sampler's semantics: coordinates shift by
    the half-texel origin (x -= 0.5) before the 4x4 B-spline filter;
    borders clamp.  Separable: 4 taps per axis."""
    out = img

    def axis_pass(a: jnp.ndarray, off: float, axis: int) -> jnp.ndarray:
        x = off - 0.5
        px = math.floor(x)
        fx = x - px
        ws = bspline_weights(fx)
        acc = None
        for k, wk in enumerate(ws):
            if wk == 0.0:
                continue
            o = px - 1 + k
            shifted = _shift(a, o if axis == 0 else 0, o if axis == 1 else 0)
            term = shifted * wk
            acc = term if acc is None else acc + term
        return acc

    out = axis_pass(out, offy, 0)
    out = axis_pass(out, offx, 1)
    return out


def bicubic_resize2x(img: jnp.ndarray) -> jnp.ndarray:
    """2x bicubic upsampling, sampling the source at (y*0.5, x*0.5) like
    the census-2x path (bao_pmflow_census_kernel.cu:115-181 reads
    tex2DBicubic at half coordinates)."""
    h, w = img.shape[0], img.shape[1]
    phases = {}
    for py in (0, 1):
        for px in (0, 1):
            phases[(py, px)] = bicubic_shift(img, py * 0.5, px * 0.5)
    out_shape = (2 * h, 2 * w) + img.shape[2:]
    out = jnp.zeros(out_shape, img.dtype)
    for (py, px), v in phases.items():
        out = out.at[py::2, px::2].set(v)
    return out


def census_2x(img: jnp.ndarray) -> jnp.ndarray:
    """Census transform of the 2x bicubic-upsampled image -> (2H, 2W)."""
    return census_transform(bicubic_resize2x(img))


def subpixel_refine(
    flow: jnp.ndarray,
    img1: jnp.ndarray,
    img2: jnp.ndarray,
    cfg: SubpixelConfig = SubpixelConfig(),
    tap_chunk: int = 25,
) -> jnp.ndarray:
    """Quadratic-fit subpixel refinement of an integer flow field.

    flow: (H, W, 2) float; img1/img2: (H, W, 3) in [0, 1].  Returns the
    refined fractional flow; pixels whose fit is rejected (stationary
    point beyond +-3 half-pixels, degenerate quadratic, unknown flow, or
    out-of-image target) keep their input flow.
    """
    h, w = img1.shape[0], img1.shape[1]
    up = cfg.up_factor
    R = cfg.patch_radius
    nr = cfg.neighborhood_radius
    sig_s2 = cfg.sigma_spatial**2
    sig_r2 = cfg.sigma_range**2
    lam_ad2 = 0.1 * 0.1          # LAMBDA_AD (defs.h:51)
    lam_cen2 = (0.3 * 8) ** 2    # LAMBDA_CENSUS * CENSUS_MAX_DIFF

    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    u, v = flow[..., 0], flow[..., 1]
    unknown = (u > UNKNOWN_FLOW_THRESH) | (v > UNKNOWN_FLOW_THRESH)
    gx = jnp.trunc(jnp.where(unknown, 0.0, u)).astype(jnp.int32)
    gy = jnp.trunc(jnp.where(unknown, 0.0, v)).astype(jnp.int32)
    tx, ty = xs + gx, ys + gy
    valid = (
        ~unknown & (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
    )

    # warp once; all frame-2 taps become static fractional shifts of J
    pack2 = jnp.concatenate([img2, jnp.zeros(img2.shape[:2] + (1,))], -1)
    J = warp_pack(pack2, gx, gy)[..., :3]
    cen1_2x = census_2x(img1)
    cen2_2x = census_2x(J)

    center1 = img1
    center2 = J  # J(p) = img2 at integer target

    # Half-pixel sampling decomposes into FOUR phase images per frame
    # (fractional part of a half-integer offset is 0 or 0.5 per axis):
    # value(q + e) = PHASE[frac(e)](q + floor(e)).  Everything after this
    # is integer static shifts, scanned in chunks so the HLO stays
    # compact (the naive 25x100 unrolled bicubic form took tens of
    # minutes to compile).
    def phases(img):
        return jnp.stack([
            bicubic_shift(img, fy, fx)
            for fy in (0.0, 0.5) for fx in (0.0, 0.5)
        ])  # (4, H, W, 3); index = 2*frac_y + frac_x

    ph1 = phases(center1)
    ph2 = phases(center2)

    # static tap set: (i, j) in {-R..R step 2}^2, sampled at (i, j)/up
    taps = [
        (i, j)
        for i in range(-R, R + 1, 2)
        for j in range(-R, R + 1, 2)
    ]
    grid = [(dy, dx) for dy in range(-nr, nr + 1) for dx in range(-nr, nr + 1)]

    def decomp(num: int):
        """half-integer num/2 -> (floor, phase-bit)."""
        return num // 2, num % 2

    # per grid position: tap rows of integer shifts + phase plane ids
    CH = 25  # taps per fused chunk
    n_taps = len(taps)
    n_chunks = -(-n_taps // CH)
    tab_i = np.zeros((len(grid), n_chunks, CH, 10), np.int32)
    tab_w = np.zeros((len(grid), n_chunks, CH), np.float32)
    for g_idx, (cy, cx) in enumerate(grid):
        for t_idx, (i, j) in enumerate(taps):
            gw = math.exp(-(j * j) / sig_s2) * math.exp(-(i * i) / sig_s2)
            k1y, p1y = decomp(i)
            k1x, p1x = decomp(j)
            k2y, p2y = decomp(i + cy)
            k2x, p2x = decomp(j + cx)
            c, t = divmod(t_idx, CH)
            tab_i[g_idx, c, t] = (
                2 * p1y + p1x, k1y, k1x, 2 * p2y + p2x, k2y, k2x,
                i, j, i + cy, j + cx,
            )
            tab_w[g_idx, c, t] = gw

    # pad everything once; tap reads become dynamic slices
    PAD = R + nr + 2
    ph1p = jnp.pad(ph1, ((0, 0), (PAD, PAD), (PAD, PAD), (0, 0)), mode="edge")
    ph2p = jnp.pad(ph2, ((0, 0), (PAD, PAD), (PAD, PAD), (0, 0)), mode="edge")
    PAD2 = 2 * PAD
    c1p = jnp.pad(cen1_2x, PAD2, mode="edge")
    c2p = jnp.pad(cen2_2x, PAD2, mode="edge")

    def one_tap(row, gw):
        p1 = jax.lax.dynamic_slice(
            ph1p, (row[0], PAD + row[1], PAD + row[2], 0), (1, h, w, 3)
        )[0]
        p2 = jax.lax.dynamic_slice(
            ph2p, (row[3], PAD + row[4], PAD + row[5], 0), (1, h, w, 3)
        )[0]
        s1 = jax.lax.dynamic_slice(
            c1p, (PAD2 + row[6], PAD2 + row[7]), (2 * h, 2 * w)
        )[::2, ::2]
        s2 = jax.lax.dynamic_slice(
            c2p, (PAD2 + row[8], PAD2 + row[9]), (2 * h, 2 * w)
        )[::2, ::2]
        d = jnp.abs(p1 - p2)
        ad = jnp.maximum(jnp.maximum(d[..., 0], d[..., 1]), d[..., 2])
        c_ad = 1.0 - jnp.exp(-(ad * ad) / lam_ad2)
        ham = _popcount8(s1 ^ s2).astype(jnp.float32)
        c_cen = 1.0 - jnp.exp(-(ham * ham) / lam_cen2)
        d1 = jnp.abs(center1 - p1)
        dr1 = jnp.maximum(jnp.maximum(d1[..., 0], d1[..., 1]), d1[..., 2])
        d2 = jnp.abs(center2 - p2)
        dr2 = jnp.maximum(jnp.maximum(d2[..., 0], d2[..., 1]), d2[..., 2])
        wgt = jnp.exp(-(dr1 * dr1 + dr2 * dr2) / sig_r2) * gw
        return wgt * (c_ad + c_cen), wgt

    def one_position(tables):
        rows_pos, gws_pos = tables  # (n_chunks, CH, 10), (n_chunks, CH)

        def chunk_step(carry, data):
            acc_c, acc_w = carry
            cs, ws = jax.vmap(one_tap)(*data)
            return (acc_c + cs.sum(0), acc_w + ws.sum(0)), None

        init = (
            jnp.zeros((h, w), jnp.float32),
            jnp.zeros((h, w), jnp.float32),
        )
        (acc_c, acc_w), _ = jax.lax.scan(
            chunk_step, init, (rows_pos, gws_pos)
        )
        return acc_c / jnp.maximum(acc_w, 1e-30)

    B = jax.lax.map(
        one_position, (jnp.asarray(tab_i), jnp.asarray(tab_w))
    )  # (25, H, W)

    # out-of-image positions read cost 2.0 (refine_kernel.cu:560-566)
    masked = []
    for g_idx, (dy, dx) in enumerate(grid):
        nx = tx.astype(jnp.float32) + dx / up
        ny = ty.astype(jnp.float32) + dy / up
        inb = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
        masked.append(jnp.where(inb, B[g_idx], 2.0))
    B = jnp.stack(masked)  # (25, H, W)

    # constant least-squares operator: X = pinv(A) @ B
    A = np.asarray(
        [[dx * dx, dy * dy, dx * dy, dx, dy, 1.0] for (dy, dx) in grid],
        np.float64,
    )
    P = jnp.asarray(np.linalg.pinv(A), jnp.float32)  # (6, 25)
    X = jnp.einsum("kn,nhw->khw", P, B)
    a, b, c, d, e = X[0], X[1], X[2], X[3], X[4]
    denorm = c * c - 4 * a * b
    safe = jnp.where(denorm == 0, 1.0, denorm)
    subx = (2 * d * b - c * e) / safe
    suby = (2 * a * e - c * d) / safe
    accept = (
        valid
        & (denorm != 0)
        & (jnp.abs(subx) <= 3)
        & (jnp.abs(suby) <= 3)
    )
    new_u = (gx.astype(jnp.float32) * up + subx) / up
    new_v = (gy.astype(jnp.float32) * up + suby) / up
    out = jnp.stack(
        [jnp.where(accept, new_u, u), jnp.where(accept, new_v, v)], -1
    )
    return out
