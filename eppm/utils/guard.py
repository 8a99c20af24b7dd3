"""Output validation for production flow serving.

The reference has no failure-handling layer at all (``helper_cuda.h``
aborts the process on any CUDA error; ``main.cpp`` assumes every kernel
succeeded).  `flow_sanity` / `check_flow` (`FlowGuardError`) are cheap
checks that a produced flow field is structurally sound (finite, bounded
magnitude, not sentinel-saturated) and, when frames are available, that
it actually explains the motion (photometric warp error vs the zero-flow
baseline).  Device errors are not caught here: they surface to the
caller.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config import UNKNOWN_FLOW_THRESH

__all__ = [
    "FlowGuardError",
    "FlowSanity",
    "flow_sanity",
    "check_flow",
]


class FlowGuardError(RuntimeError):
    """A produced flow field failed validation."""

    def __init__(self, msg: str, report: "FlowSanity"):
        super().__init__(f"{msg}: {report}")
        self.report = report


@dataclass(frozen=True)
class FlowSanity:
    """Structural health report for one flow field."""

    finite_frac: float      # fraction of finite values
    unknown_frac: float     # fraction of UNKNOWN_FLOW-sentinel pixels
    max_mag: float          # max |flow| over finite, known pixels
    warp_ratio: Optional[float]  # warp_error / zero-flow warp_error

    def __str__(self) -> str:
        wr = "n/a" if self.warp_ratio is None else f"{self.warp_ratio:.3f}"
        return (
            f"finite={self.finite_frac:.4f} unknown={self.unknown_frac:.4f} "
            f"max|f|={self.max_mag:.1f} warp_ratio={wr}"
        )


def flow_sanity(
    flow: np.ndarray,
    img1: Optional[np.ndarray] = None,
    img2: Optional[np.ndarray] = None,
) -> FlowSanity:
    """Compute the health report for ``flow`` (host-side, (H, W, 2)).

    When both frames are given, also computes the photometric
    warp-error ratio vs the zero-flow baseline (< 1 means the flow
    explains at least some motion; bench gates at < 0.5-0.6).
    """
    f = np.asarray(flow)
    finite = np.isfinite(f)
    finite_frac = float(finite.mean()) if f.size else 1.0
    known = (
        finite.all(axis=-1)
        & (np.abs(np.where(finite, f, 0.0)) <= UNKNOWN_FLOW_THRESH).all(
            axis=-1
        )
    )
    unknown_frac = 1.0 - (float(known.mean()) if known.size else 1.0)
    if known.any():
        mags = np.linalg.norm(np.where(finite, f, 0.0), axis=-1)
        max_mag = float(mags[known].max())
    else:
        max_mag = float("inf")

    warp_ratio = None
    if img1 is not None and img2 is not None:
        from ..metrics import warp_error

        a1 = np.asarray(img1, np.float64)
        a2 = np.asarray(img2, np.float64)
        if a1.max() > 1.5:  # uint8-range frames
            a1, a2 = a1 / 255.0, a2 / 255.0
        fz = np.where(finite & (np.abs(f) <= UNKNOWN_FLOW_THRESH), f, 0.0)
        we = warp_error(a1, a2, fz.astype(np.float32))
        we0 = warp_error(a1, a2, np.zeros_like(fz, np.float32))
        warp_ratio = float(we / max(we0, 1e-12))
    return FlowSanity(finite_frac, unknown_frac, max_mag, warp_ratio)


def check_flow(
    flow: np.ndarray,
    img1: Optional[np.ndarray] = None,
    img2: Optional[np.ndarray] = None,
    *,
    max_unknown_frac: float = 0.5,
    max_mag: Optional[float] = None,
    max_warp_ratio: Optional[float] = None,
) -> FlowSanity:
    """Validate ``flow``; raise :class:`FlowGuardError` on failure.

    Defaults are deliberately loose (a hole-filled field should have ~0
    unknowns; 50% means the pipeline failed structurally).  Pass
    ``max_warp_ratio`` (with both frames) for a quality gate — e.g.
    0.6 per the bench gate.
    """
    rep = flow_sanity(flow, img1, img2)
    if rep.finite_frac < 1.0:
        raise FlowGuardError("non-finite flow values", rep)
    if rep.unknown_frac > max_unknown_frac:
        raise FlowGuardError(
            f"unknown-flow fraction > {max_unknown_frac}", rep
        )
    if max_mag is not None and rep.max_mag > max_mag:
        raise FlowGuardError(f"flow magnitude > {max_mag}", rep)
    if (
        max_warp_ratio is not None
        and rep.warp_ratio is not None
        and rep.warp_ratio > max_warp_ratio
    ):
        raise FlowGuardError(f"warp ratio > {max_warp_ratio}", rep)
    return rep
