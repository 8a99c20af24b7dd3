"""Seeded frame pairs with known motion, in NumPy.

Benchmarks, smoke runs and tools need inputs at deployment sizes without
shipping image files.  Everything here is plain NumPy so a pair is
bitwise identical whichever device later consumes it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["textured_frame", "warp", "shift_pair", "smooth_flow_pair"]


def _upsample(small: np.ndarray, h: int, w: int) -> np.ndarray:
    """Separable linear interpolation of (hs, ws, C) onto (h, w, C)."""
    hs, ws = small.shape[0], small.shape[1]
    ys = np.linspace(0.0, hs - 1.0, h)
    xs = np.linspace(0.0, ws - 1.0, w)
    y0 = np.minimum(ys.astype(int), hs - 2)
    x0 = np.minimum(xs.astype(int), ws - 2)
    ay = (ys - y0)[:, None, None]
    ax = (xs - x0)[None, :, None]
    rows = small[y0] * (1 - ay) + small[y0 + 1] * ay
    return rows[:, x0] * (1 - ax) + rows[:, x0 + 1] * ax


def textured_frame(h: int, w: int, seed: int = 0) -> np.ndarray:
    """(h, w, 3) float32 in [0, 1]: two octaves of smooth random texture
    (pure noise defeats bilinear warping; a flat image has no motion)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float64)
    for scale, amp in ((16, 0.6), (4, 0.3)):
        small = rng.random((h // scale + 2, w // scale + 2, 3))
        img += amp * _upsample(small, h, w)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def warp(img: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """img1(x) = img(x + flow(x)), bilinear with clamped borders."""
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


def shift_pair(
    h: int, w: int, dx: float = 5.0, dy: float = 3.0, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(img1, img2, gt): frame 2 textured, frame 1 its uniform shift, so
    the flow frame 1 -> frame 2 is (dx, dy) everywhere."""
    img2 = textured_frame(h, w, seed)
    gt = np.zeros((h, w, 2), np.float32)
    gt[..., 0], gt[..., 1] = dx, dy
    return warp(img2, gt), img2, gt


def smooth_flow_pair(
    h: int, w: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(img1, img2, gt) under a smooth non-uniform field: 3..5 px
    horizontally, 0..2 px vertically (the shape of the CPU tests' gate,
    tests/test_pipeline.py ``test_smooth_flow_epe``)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    gt = np.stack([3.0 + 2.0 * xs / w, 2.0 * ys / h], axis=-1)
    img2 = textured_frame(h, w, seed)
    return warp(img2, gt), img2, gt.astype(np.float32)
