"""EPPM: a dense optical-flow engine in JAX.

A from-scratch JAX/Pallas reimplementation of the capabilities of
linchaobao/EPPM — "Fast Edge-Preserving PatchMatch for Large Displacement
Optical Flow" (Bao, Yang, Jin; CVPR 2014): the whole pipeline is one
jitted pure function, the sequential CUDA propagation sweeps become
Jacobi jump-flood rounds, the hot patch cost is a Pallas kernel on CUDA
(ops/pallas_cost.py), and multi-device scaling uses ``shard_map`` over a
device mesh with ``ppermute`` halo exchange.
"""

import os as _os

# <checkout>/.jax_cache: fixed, so a cache written by one process is found
# by the next (the path is part of what JAX keys the cache on).
COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)


def _enable_compile_cache() -> None:
    """Persistent compilation cache: ``JAX_COMPILATION_CACHE_DIR`` when it
    is set (JAX reads it itself; nothing else is set here), otherwise
    ``COMPILE_CACHE_DIR``.  Opt out with EPPM_NO_COMPILE_CACHE=1."""
    if _os.environ.get("EPPM_NO_COMPILE_CACHE"):
        return
    import jax

    if jax.config.jax_compilation_cache_dir:
        return
    _os.makedirs(COMPILE_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compile_cache()

from .config import (
    DEFAULT_CONFIG,
    EPPMConfig,
    CostConfig,
    MatchConfig,
    PatchMatchConfig,
    PyramidConfig,
    RefineConfig,
    UNKNOWN_FLOW,
    UNKNOWN_FLOW_THRESH,
    INVALID_LOCATION,
)

__version__ = "0.1.0"
