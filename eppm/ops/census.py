"""3x3 census transform.

Spec source: ``d_census_transform3x3`` (bao_pmflow_census_kernel.cu:39-112).
Each pixel gets an 8-bit signature: bit k is set when the k-th neighbor's
luminance (0.3R + 0.6G + 0.1B) is strictly greater than the center's.
Neighbor order (dx, dy), matching the reference texture reads:

  bit0 (-1,-1)  bit1 (0,-1)  bit2 (+1,-1)
  bit3 (-1, 0)               bit4 (+1, 0)
  bit5 (-1,+1)  bit6 (0,+1)  bit7 (+1,+1)

Borders clamp (CUDA texture clamp addressing).  A pure stencil — plain
jnp shifts; XLA fuses this into surrounding elementwise work.
"""

from __future__ import annotations

import jax.numpy as jnp

from .color import luminance

# (dx, dy) per bit, reference order (census_kernel.cu:53-60).
NEIGHBOR_OFFSETS = (
    (-1, -1), (0, -1), (1, -1),
    (-1, 0), (1, 0),
    (-1, 1), (0, 1), (1, 1),
)

__all__ = ["census_transform", "NEIGHBOR_OFFSETS"]


def census_transform(img: jnp.ndarray) -> jnp.ndarray:
    """Census signature of an (H, W, 3) image -> (H, W) int32 in [0, 255]."""
    lum = luminance(img)
    h, w = lum.shape
    padded = jnp.pad(lum, 1, mode="edge")
    center = lum
    out = jnp.zeros((h, w), dtype=jnp.int32)
    for bit, (dx, dy) in enumerate(NEIGHBOR_OFFSETS):
        neigh = padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        out = out | ((neigh > center).astype(jnp.int32) << bit)
    return out
