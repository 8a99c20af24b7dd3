"""Halo exchange between spatial shards via ``jax.lax.ppermute``.

The reference is single-GPU (SURVEY.md section 2.7); spatial tiling across a
device mesh is a new axis of parallelism.  Every stencil stage
(flow smoothing, patch-cost taps, tile upsampling, warp+residual refine)
needs a ring of neighbor rows/cols around its tile; this module exchanges
those rings with ``ppermute`` inside ``shard_map``.  At the mesh
boundary the halo is filled by edge replication, reproducing the global
clamp-to-edge addressing of the single-chip pipeline (CUDA texture clamp
semantics).

Halos wider than the shard itself (small pyramid levels on large meshes)
are supported: the exchange runs at neighbor distances 1..K and stitches
the received tiles before slicing the requested ring.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["halo_exchange_1d", "halo_exchange_2d"]


def _take1(x: jnp.ndarray, start: int, size: int, dim: int) -> jnp.ndarray:
    return jax.lax.slice_in_dim(x, start, start + size, axis=dim)


def halo_exchange_1d(
    tile: jnp.ndarray,
    halo: int,
    axis_name: str,
    dim: int,
    boundary="edge",
) -> jnp.ndarray:
    """Pad ``tile`` with ``halo`` rows/cols along ``dim``, filled from
    neighboring shards on mesh axis ``axis_name`` (multi-hop when
    ``halo`` exceeds the shard extent).  Must run inside shard_map.

    ``boundary`` controls the fill at the global border: "edge"
    replicates the global edge row/col (CUDA texture clamp semantics,
    right for image data) while a float fills a constant (pass
    UNKNOWN_FLOW for flow fields, whose out-of-image taps the reference
    *skips* rather than clamps, refine_kernel.cu:781-783).
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    size = tile.shape[dim]
    K = -(-halo // size)  # hops needed

    if K == 1 and halo < size:
        # Common case: exchange only the halo STRIPS, not whole tiles —
        # traffic proportional to the tile boundary (halo*edge), not its
        # area.  This is what makes multi-chip scaling efficiency
        # boundary-limited (tools/comm_model.py accounts for it).
        perm_fwd = [(i, i + 1) for i in range(n - 1)]
        perm_bwd = [(i + 1, i) for i in range(n - 1)]
        lo_strip = _take1(tile, size - halo, halo, dim)  # to next shard
        hi_strip = _take1(tile, 0, halo, dim)            # to prev shard
        prev_part = (
            jax.lax.ppermute(lo_strip, axis_name, perm_fwd)
            if perm_fwd else jnp.zeros_like(lo_strip)
        )
        next_part = (
            jax.lax.ppermute(hi_strip, axis_name, perm_bwd)
            if perm_bwd else jnp.zeros_like(hi_strip)
        )
        ext = jnp.concatenate([prev_part, tile, next_part], axis=dim)
    else:
        parts = []
        for k in range(K, 0, -1):  # farthest prev first
            perm = [(i, i + k) for i in range(n - k)]
            parts.append(
                jax.lax.ppermute(tile, axis_name, perm) if perm
                else jnp.zeros_like(tile)
            )
        parts.append(tile)
        for k in range(1, K + 1):
            perm = [(i + k, i) for i in range(n - k)]
            parts.append(
                jax.lax.ppermute(tile, axis_name, perm) if perm
                else jnp.zeros_like(tile)
            )
        ext = jnp.concatenate(parts, axis=dim)
        ext = _take1(ext, K * size - halo, size + 2 * halo, dim)

    # fill positions beyond the global array (zeros from missing links)
    shape = [1] * tile.ndim
    shape[dim] = size + 2 * halo
    pos = jax.lax.broadcasted_iota(jnp.int32, tuple(shape), dim)
    gidx = idx * size + pos - halo
    below = gidx < 0
    above = gidx >= n * size
    if boundary == "edge":
        # Global edge rows sit at ext positions (0 - idx*size + halo) and
        # ((n*size - 1) - idx*size + halo); when a shard has no
        # out-of-range positions on a side, the (clamped) slice is unused.
        lo_fill = jax.lax.dynamic_slice_in_dim(
            ext, halo - idx * size, 1, axis=dim
        )
        hi_fill = jax.lax.dynamic_slice_in_dim(
            ext, (n - idx) * size - 1 + halo, 1, axis=dim
        )
        ext = jnp.where(below, lo_fill, ext)
        ext = jnp.where(above, hi_fill, ext)
    else:
        ext = jnp.where(below | above, jnp.asarray(boundary, ext.dtype), ext)
    return ext


def halo_exchange_2d(
    tile: jnp.ndarray,
    halo: int,
    y_axis: str = "y",
    x_axis: str = "x",
    boundary="edge",
) -> jnp.ndarray:
    """Exchange a ``halo``-wide ring in both spatial dims (dims 0 and 1).

    Exchanging y first and then x over the already-extended rows makes the
    corner halos correct (the x-neighbors' y-halos ride along)."""
    tile = halo_exchange_1d(tile, halo, y_axis, dim=0, boundary=boundary)
    return halo_exchange_1d(tile, halo, x_axis, dim=1, boundary=boundary)
