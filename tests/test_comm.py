"""Communication-volume accounting tests (spoofed 8-device CPU mesh).

Validates the analytic halo model (tools/comm_model.py) against the
exchanges the sharded pipeline actually performs (recorded at trace
time), and asserts the weak-scaling property the BASELINE >=80%
scaling-efficiency target rests on: per-device halo traffic scales with
the tile BOUNDARY, not its area.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools")
)
import comm_model  # noqa: E402

from eppm.config import EPPMConfig, PatchMatchConfig, PyramidConfig, RefineConfig  # noqa: E402
from eppm.parallel import make_mesh  # noqa: E402


def _cfg(depth=3):
    return EPPMConfig(
        pyramid=PyramidConfig(max_depth=depth),
        patchmatch=PatchMatchConfig(num_iters=2, prop_steps=(2, 1)),
        refine=RefineConfig(wmf_coarse_iters=2),
    )


def _traced_exchanges(h, w, cfg, ny, nx):
    """Record every (halo, tile_shape) halo_exchange_2d call made while
    tracing the sharded pipeline (eval_shape: no compile, no execute)."""
    import eppm.parallel.sharded as S

    recorded = []
    real = S.halo_exchange_2d

    def spy(tile, halo, *a, **kw):
        recorded.append((halo, tuple(tile.shape)))
        return real(tile, halo, *a, **kw)

    mesh = make_mesh(batch=1, y=ny, x=nx)
    imgs = jax.ShapeDtypeStruct((1, h, w, 3), jnp.float32)
    keys = jax.ShapeDtypeStruct((1, 2), jnp.uint32)
    old = S.halo_exchange_2d
    S.halo_exchange_2d = spy
    try:
        jax.eval_shape(
            lambda a, b, k: S._compute_flow_sharded_jit(a, b, k, cfg, mesh),
            imgs, imgs, keys,
        )
    finally:
        S.halo_exchange_2d = old
    return recorded


def test_model_matches_traced_exchanges():
    """Total per-device halo bytes in the analytic model == bytes implied
    by the exchanges the code actually requests."""
    cfg = _cfg(depth=3)
    h, w = 64, 96
    ny, nx = 2, 2
    recorded = _traced_exchanges(h, w, cfg, ny, nx)
    traced_bytes = sum(
        comm_model.ring_bytes(shape[0], shape[1], halo,
                              shape[2] if len(shape) > 2 else 1)
        for halo, shape in recorded
    )
    model = comm_model.halo_traffic(h, w, cfg, ny, nx)
    model_bytes = sum(b for _, b in model)
    assert traced_bytes == model_bytes, (
        f"model {model_bytes} != traced {traced_bytes}\n"
        f"model: {model}\ntraced: {recorded}"
    )


def test_weak_scaling_boundary_not_area():
    """Fixed tile size, growing mesh: per-device halo bytes stay constant
    (boundary-proportional) while per-device pixels stay constant — the
    weak-scaling regime.  Also: doubling the tile area must NOT double
    per-device comm (it grows ~sqrt: boundary, not area)."""
    cfg = _cfg(depth=2)
    th, tw = 32, 32

    def per_device_bytes(ny, nx):
        items = comm_model.halo_traffic(th * ny, tw * nx, cfg, ny, nx)
        return sum(b for _, b in items)

    b11 = per_device_bytes(1, 2)
    b22 = per_device_bytes(2, 2)
    b24 = per_device_bytes(2, 4)
    assert b11 == b22 == b24, (b11, b22, b24)

    # area x4 (tile side x2) -> comm roughly x2, definitely < x3
    big = comm_model.halo_traffic(2 * th * 2, 2 * tw * 2, cfg, 2, 2)
    b_big = sum(b for _, b in big)
    assert b_big < 3 * b22, (b_big, b22)
    assert b_big > 1.5 * b22, (b_big, b22)


def test_efficiency_meets_baseline_target():
    """The >=80% BASELINE scaling-efficiency target holds with wide
    margin in the analytic model for every BASELINE config shape."""
    from eppm.config import DEFAULT_CONFIG

    for h, w, ny, nx in [
        (480, 640, 2, 2),
        (376, 1244, 2, 2),
        (1080, 1920, 2, 4),
        (2160, 3840, 4, 4),
    ]:
        *_, eff = comm_model.efficiency(
            h, w, DEFAULT_CONFIG, ny, nx, 3e12, 45e9
        )
        assert eff > 0.95, f"{h}x{w} mesh {ny}x{nx}: eff {eff:.1%}"
