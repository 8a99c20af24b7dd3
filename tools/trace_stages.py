"""Reduce a JAX profiler trace to device time per pipeline stage.

Stages are the ``jax.named_scope`` names the package puts on its
functions (``STAGES``).  Each device kernel event is attributed through
its ``tf_op`` stat when the trace carries one; kernels launched from a
CUDA graph carry none, so they are matched by name to the HLO
instruction that emitted them (``loop_add_fusion_12`` is
``%loop_add_fusion.12``) and attributed through that instruction's
``op_name`` metadata in the compiled module text.  Pallas kernels are
named after their stage (``residual_cost``).
A stage's time is inclusive: a WMF kernel inside the occlusion stage
inside the matcher counts for ``wmf``, ``occlusion`` and ``match``.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional

STAGES = (
    "prepare", "match", "global_match", "residual_cost", "lr_check",
    "outlier", "occlusion", "wmf", "refine", "smooth",
)

_INSTR = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?metadata=\{[^}]*op_name="([^"]+)"'
)


def _kernel_name(hlo_name: str) -> str:
    return re.sub(r"[.\-]", "_", hlo_name)


def hlo_op_names(hlo_text: str) -> Dict[str, str]:
    """Kernel-style instruction name -> op_name metadata, from the
    compiled module text."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            out[_kernel_name(m.group(1))] = m.group(2)
    return out


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def stage_times(
    trace_dir: str, hlo_text: Optional[str] = None, runs: int = 1
) -> dict:
    """Per-stage inclusive device ms (per run), device busy ms and the
    idle share of the traced window."""
    from jax.profiler import ProfileData

    paths = glob.glob(
        os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb")
    )
    data = ProfileData.from_file(sorted(paths)[-1])
    names = hlo_op_names(hlo_text) if hlo_text else {}
    stage_ns = {s: 0 for s in STAGES}
    intervals, unattributed, kernels = [], 0, {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = [l for l in plane.lines if "Stream" in l.name] or list(
            plane.lines
        )
        for line in lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = str(stats.get("tf_op", ""))
                if "/" not in op:
                    op = names.get(_kernel_name(ev.name), "")
                op = "/".join([op] + [s for s in STAGES
                                      if ev.name.startswith(s)])
                dur = int(ev.duration_ns)
                start = int(ev.start_ns)
                intervals.append((start, start + dur))
                kernels[ev.name] = kernels.get(ev.name, 0) + dur
                scopes = set(str(op).split("/"))
                hit = False
                for s in STAGES:
                    if s in scopes:
                        stage_ns[s] += dur
                        hit = True
                if not hit:
                    unattributed += dur
    busy = _union_ns(intervals)
    window = (
        max(e for _, e in intervals) - min(s for s, _ in intervals)
        if intervals else 0
    )
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    return {
        "stage_ms_per_run": {
            s: ns / 1e6 / runs for s, ns in stage_ns.items()
        },
        "unattributed_ms_per_run": unattributed / 1e6 / runs,
        "device_busy_ms_per_run": busy / 1e6 / runs,
        "window_ms": window / 1e6,
        "idle_share": 1.0 - busy / window if window else None,
        "top_kernels_ms_per_run": [(k, v / 1e6 / runs) for k, v in top],
    }
