"""Timing & profiling utilities — the reference's timer classes.

The reference ships three timers (SURVEY.md §5): ``bao_timer_gpu``
(cudaEvent elapsed, basic/bao_basic_cuda.cpp:37-75), ``bao_timer_gpu_cpu``
(device-sync + wall clock, :78-122) and ``bao_timer_cpu``
(bao_basic.cpp:38-80), threaded through main.cpp and dozens of per-kernel
probes.  Here:

* ``Timer`` — plain wall-clock timer (bao_timer_cpu).
* ``DeviceTimer`` — device-synchronized wall timer (bao_timer_gpu_cpu):
  ``stop(x)`` blocks on ``x`` before reading the clock.
* ``time_stage`` — min-of-N steady-state timing of a jitted callable,
  synchronized with ``block_until_ready``.
* ``profile_trace`` — context manager around ``jax.profiler.trace`` for
  XLA-level traces (the per-kernel visibility the reference got from its
  commented-out cudaEvent probes).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

__all__ = ["Timer", "DeviceTimer", "time_stage", "profile_trace"]


class Timer:
    """Wall-clock timer (bao_timer_cpu parity): start/stop/time_display."""

    def __init__(self) -> None:
        self._t0: Optional[float] = None

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("Timer.stop() before start()")
        return time.perf_counter() - self._t0

    def time_display(self, label: str = "") -> float:
        dt = self.stop()
        print(f"[{label}] {dt * 1000:.2f} ms")
        return dt


class DeviceTimer(Timer):
    """Device-synchronized wall timer (bao_timer_gpu_cpu parity)."""

    def stop(self, result=None) -> float:
        if result is not None:
            import jax

            jax.block_until_ready(result)
        return super().stop()


def time_stage(
    fn: Callable, *args, n: int = 5, label: str = "", verbose: bool = True
) -> float:
    """Steady-state min-of-n timing of ``fn(*args)``; returns seconds."""
    import jax

    jfn = jax.jit(fn)
    jax.block_until_ready(jfn(*args))  # compile + warm
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(jfn(*args))
        best = min(best, time.perf_counter() - t0)
    if verbose and label:
        print(f"[{label}] {best * 1000:.2f} ms")
    return best


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """XLA profiler trace around a code block (view with TensorBoard or
    xprof); the per-kernel visibility layer."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
