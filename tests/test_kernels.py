"""The residual-cost kernel (ops/pallas_cost.py) and its dispatch.

On the CPU the kernel runs in Pallas interpret mode against the plain
reference (ops/dense.py ``residual_costs``); the dispatchers are checked
to lower to the reference on the CPU and to the compiled Triton kernel
(never interpret mode) when lowering for CUDA.  ``gpu`` tests repeat the
comparison on the card and skip elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eppm.config import CostConfig
from eppm.ops.dense import center_out_offsets, residual_costs
from eppm.ops.pallas_cost import (
    residual_costs_auto,
    residual_costs_multiwarp_auto,
    residual_costs_multiwarp_triton,
    residual_costs_triton,
)

QUANT = 2.0 ** -17  # one step of the shared tie-stability grid


def _pack(rng, h, w):
    p = rng.random((h, w, 4)).astype(np.float32)
    p[..., 3] = rng.integers(0, 256, (h, w))
    return jnp.asarray(p)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    d = np.abs(got - ref)
    # sums run in another order than XLA's chunked reduction: a cost may
    # land one quantization step away, on a small share of pixels
    assert d.max() <= QUANT + 1e-9
    assert (d > 0).mean() < 0.01
    assert (got.argmin(0) == ref.argmin(0)).mean() > 0.99


@pytest.mark.parametrize(
    "case, h, w",
    [
        ("planes_k9_t4", 24, 40),
        ("fronto_k25", 24, 40),
        ("ragged_k9", 21, 45),  # not a multiple of the (8, 32) tile
    ],
)
def test_kernel_interpret_matches_reference(rng, case, h, w):
    cfg = CostConfig()
    p1, w2 = _pack(rng, h, w), _pack(rng, h, w)
    cands = center_out_offsets(2 if case == "fronto_k25" else 1)
    planes = case.startswith("planes")
    ref = residual_costs(p1, w2, cands, cfg, planes)
    got = residual_costs_triton(p1, w2, cands, cfg, planes, interpret=True)
    _close(got, ref)


def test_kernel_interpret_multiwarp_matches_reference(rng):
    cfg = CostConfig()
    h, w = 24, 40
    p1 = _pack(rng, h, w)
    stack = jnp.stack([_pack(rng, h, w) for _ in range(5)])
    ref = jax.lax.map(
        lambda wp: residual_costs(p1, wp, [(0, 0)], cfg, False)[0], stack
    )
    got = residual_costs_multiwarp_triton(p1, stack, cfg, interpret=True)
    _close(got, ref)


def _dispatch(which):
    cfg = CostConfig()
    if which == "single":
        cands = center_out_offsets(1)
        f = lambda a, b: residual_costs_auto(a, b, cands, cfg, False)
        ref = lambda a, b: residual_costs(a, b, cands, cfg, False)
        shapes = ((24, 40, 4), (24, 40, 4))
    else:
        f = lambda a, s: residual_costs_multiwarp_auto(a, s, cfg)
        ref = lambda a, s: jax.lax.map(
            lambda wp: residual_costs(a, wp, [(0, 0)], cfg, False)[0], s
        )
        shapes = ((24, 40, 4), (5, 24, 40, 4))
    return f, ref, shapes


@pytest.mark.parametrize("which", ["single", "multiwarp"])
def test_dispatch_lowers_to_reference_on_cpu(rng, which):
    """On the CPU backend the dispatcher is the XLA reference: no Pallas
    call (interpret mode or compiled) in the program, identical output."""
    f, ref, shapes = _dispatch(which)
    args = [
        jnp.asarray(rng.random(s).astype(np.float32) * 255.0) for s in shapes
    ]
    text = jax.jit(f).lower(*args).as_text()
    assert "triton" not in text.lower() and "pallas" not in text.lower()
    np.testing.assert_array_equal(
        np.asarray(jax.jit(f)(*args)), np.asarray(jax.jit(ref)(*args))
    )


@pytest.mark.parametrize("which", ["single", "multiwarp"])
def test_dispatch_lowers_to_triton_kernel_for_cuda(which):
    """Lowered for CUDA the dispatcher is one compiled Triton kernel
    call (a custom call carrying the kernel), not interpret mode."""
    f, _, shapes = _dispatch(which)
    specs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    text = jax.jit(f).trace(*specs).lower(
        lowering_platforms=("cuda",)
    ).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert "residual_cost" in text


@pytest.mark.gpu
def test_kernel_on_card_matches_reference(gpu_device, rng):
    cfg = CostConfig()
    h, w = 120, 160
    p1 = jax.device_put(_pack(rng, h, w), gpu_device)
    w2 = jax.device_put(_pack(rng, h, w), gpu_device)
    cands = center_out_offsets(1)
    got = jax.jit(lambda a, b: residual_costs_triton(a, b, cands, cfg, False))(
        p1, w2
    )
    ref = jax.jit(lambda a, b: residual_costs(a, b, cands, cfg, False))(p1, w2)
    d = np.abs(np.asarray(got) - np.asarray(ref))
    assert d.max() <= 1e-4
    assert (np.asarray(got).argmin(0) == np.asarray(ref).argmin(0)).mean() >= 0.999
