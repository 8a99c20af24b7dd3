"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device hardware is not available in CI; sharding code is exercised
via XLA host-platform device spoofing, per the JAX distributed-testing
recipe.  Must run before jax is imported anywhere.  Tests that need a
CUDA device carry the ``gpu`` marker and skip here (see the ``gpu_device``
fixture).
"""

import os

# The persistent compile cache is a steady-state serving optimization; under
# pytest it adds a cache *write* (zstd compress inside the JAX internals) for
# every freshly compiled program, and a full-suite run on this host has
# segfaulted inside that write path (compilation_cache.put_executable_and_time,
# reproduced twice at round 2, rc=139).  Tests compile hundreds of tiny
# programs that are never reused across runs anyway — disable the cache.
os.environ.setdefault("EPPM_NO_COMPILE_CACHE", "1")

# CPU unless the caller chose platforms (the on-card tests run with
# JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test when there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a CUDA device (run on the card: python chip_smoke.py)")
