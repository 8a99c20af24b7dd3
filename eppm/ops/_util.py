"""Shared op helpers (single home for stencil/shift/dispatch primitives
previously duplicated across the ops modules)."""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "shift2d", "grid", "popcount8", "round_up",
]


def shift2d(a: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Edge-clamped static shift: out[y, x] = a[clamp(y+dy), clamp(x+dx)]
    (CUDA texture clamp semantics); trailing dims pass through."""
    h, w = a.shape[0], a.shape[1]
    ady, adx = abs(dy), abs(dx)
    pad = ((ady, ady), (adx, adx)) + ((0, 0),) * (a.ndim - 2)
    padded = jnp.pad(a, pad, mode="edge")
    return padded[ady + dy : ady + dy + h, adx + dx : adx + dx + w]


def grid(h: int, w: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(ys, xs) int32 coordinate fields."""
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    return ys, xs


def popcount8(x: jnp.ndarray) -> jnp.ndarray:
    """Branch-free popcount for 8-bit values stored in int32 (replaces the
    reference's sequential Kernighan loop, bao_pmflow_kernel.cu:280-282)."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m

