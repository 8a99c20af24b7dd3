"""Image resampling: Gaussian filter, bilinear resize, Gaussian pyramid.

Spec sources in /root/reference/basic/bao_basic_cuda.cuh:
  - Gaussian filter (:397-481): brute-force (2r+1)^2 window with
    edge-clamped taps and weights exp(-(dx^2+dy^2)/(2*sigma^2)); because taps
    clamp (replicate) at borders, the normalizer is the constant full-window
    weight sum.  The kernel is separable, so we implement it as two 1-D
    passes over an edge-padded array — numerically identical.
  - Bilinear resize (:484-615): source coordinate fx = (x+1)/ratio - 1 with
    C-style truncation toward zero for the integer part and dx clamped to
    [0, 1]; taps clamp to the image.  Output-position-dependent indices and
    weights are static, so the resize compiles to 4 constant-index takes.
  - Gaussian pyramid (:619-664): level i is built by filtering level 0 (or
    level i-n) with sigma = baseSigma*i (baseSigma = 1/ratio - 1,
    n = log(0.25)/log(ratio)) at radius 3*sigma, then bilinear-resizing with
    ratio**i.

All functions operate on float arrays of shape (H, W) or (H, W, C).
"""

from __future__ import annotations

import math
from functools import partial
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "gaussian_filter",
    "bilinear_resize",
    "gaussian_pyramid",
    "pyramid_dims",
]


def _pad_edge(img: jnp.ndarray, r: int, axis: int) -> jnp.ndarray:
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r, r)
    return jnp.pad(img, pad, mode="edge")


def gaussian_filter(img: jnp.ndarray, sigma: float, radius: int) -> jnp.ndarray:
    """Gaussian blur with edge-replicated taps (bao_basic_cuda.cuh:397-417)."""
    if radius <= 0:
        return img
    k = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-(k * k) / (2.0 * sigma * sigma))
    w = (w / w.sum()).astype(np.float32)
    for axis in (0, 1):
        padded = _pad_edge(img, radius, axis)
        acc = None
        for i, wi in enumerate(w):
            sl = [slice(None)] * img.ndim
            sl[axis] = slice(i, i + img.shape[axis])
            term = padded[tuple(sl)] * wi
            acc = term if acc is None else acc + term
        img = acc
    return img


def _resize_axis_indices(
    out_size: int, in_size: int, ratio: float, shift: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static (i0, i1, frac) for one axis, reference semantics.

    fx = (x+1)/ratio - 1; xx = trunc(fx); dx = clip(fx-xx, 0, 1); taps at
    clamp(xx), clamp(xx+1) (bao_basic_cuda.cuh:489-509).

    ``shift`` offsets the tap indices (for shard tiles carrying ``shift``
    halo rows/cols: local index = global mapping + shift; the clamp then
    binds at the halo edge, which carries the globally-clamped values).
    """
    x = np.arange(out_size, dtype=np.float64)
    fx = (x + 1.0) / ratio - 1.0
    # The C code truncates toward zero; we floor.  They differ only for
    # fx in (-1, 0) — reachable solely at output pixel 0 when upsampling —
    # where both variants clamp every tap to input pixel 0 and the weights
    # sum to 1, so outputs are identical.  floor (unlike trunc) commutes
    # with the integer ``shift``, which tiled resizing relies on.
    xx = np.floor(fx)
    dx = np.clip(fx - xx, 0.0, 1.0)
    i0 = np.clip(xx.astype(np.int64) + shift, 0, in_size - 1)
    i1 = np.clip(xx.astype(np.int64) + 1 + shift, 0, in_size - 1)
    return i0, i1, dx.astype(np.float32)


def bilinear_resize(
    img: jnp.ndarray, out_h: int, out_w: int, ratio: float, shift: int = 0
) -> jnp.ndarray:
    """Bilinear resize with the reference's coordinate mapping.

    ``ratio`` is out/in scale as the reference passes it (e.g. 0.5**i for
    pyramid downsampling, 2.0 for flow upsampling).  ``shift`` supports
    haloed shard tiles (see _resize_axis_indices).
    """
    h, w = img.shape[0], img.shape[1]
    y0, y1, fy = _resize_axis_indices(out_h, h, ratio, shift)
    x0, x1, fx = _resize_axis_indices(out_w, w, ratio, shift)
    fy = jnp.asarray(fy).reshape((-1, 1) + (1,) * (img.ndim - 2))
    fx = jnp.asarray(fx).reshape((1, -1) + (1,) * (img.ndim - 2))
    r0 = jnp.take(img, y0, axis=0)
    r1 = jnp.take(img, y1, axis=0)
    row = lambda r: (
        jnp.take(r, x0, axis=1) * (1.0 - fx) + jnp.take(r, x1, axis=1) * fx
    )
    return row(r0) * (1.0 - fy) + row(r1) * fy


def pyramid_dims(
    h: int, w: int, max_depth: int, ratio: float = 0.5
) -> List[Tuple[int, int]]:
    """Per-level dims, truncated (bao_basic.h:196-211)."""
    depth = max(max_depth, 1)
    return [(int(h * ratio**i), int(w * ratio**i)) for i in range(depth)]


def gaussian_pyramid(
    img: jnp.ndarray, dims: Sequence[Tuple[int, int]], ratio: float = 0.5
) -> List[jnp.ndarray]:
    """Gaussian pyramid with the reference sigma schedule
    (bao_cuda_construct_gauss_pyramid, bao_basic_cuda.cuh:619-641).

    dims[0] must equal img's spatial dims.  For the default ratio 0.5:
    baseSigma = 1, n = 2; level i <= 2 filters level 0 with sigma=i,
    radius=3i and resizes by 0.5**i.
    """
    levels = [img]
    base_sigma = 1.0 / ratio - 1.0
    n = int(math.log(0.25) / math.log(ratio))
    n_sigma = base_sigma * n
    h0, w0 = img.shape[0], img.shape[1]
    for i in range(1, len(dims)):
        oh, ow = dims[i]
        if i <= n:
            sigma = base_sigma * i
            smoothed = gaussian_filter(img, sigma, int(sigma * 3))
            levels.append(bilinear_resize(smoothed, oh, ow, ratio**i))
        else:
            src = levels[i - n]
            smoothed = gaussian_filter(src, n_sigma, int(n_sigma * 3))
            eff_ratio = (ratio**i) * w0 / src.shape[1]
            levels.append(bilinear_resize(smoothed, oh, ow, eff_ratio))
    return levels
