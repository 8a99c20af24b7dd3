"""Output validation (eppm.utils.guard).

The reference aborts the process on any device error (helper_cuda.h) and
never checks what its kernels produced; this layer validates flow fields
before a serving deployment hands them on.
"""

import numpy as np
import pytest

from eppm.config import UNKNOWN_FLOW
from eppm.utils import (
    FlowGuardError,
    check_flow,
    flow_sanity,
)


def test_flow_sanity_clean_field():
    flow = np.full((16, 16, 2), 2.5, np.float32)
    rep = flow_sanity(flow)
    assert rep.finite_frac == 1.0
    assert rep.unknown_frac == 0.0
    assert abs(rep.max_mag - np.hypot(2.5, 2.5)) < 1e-6
    assert rep.warp_ratio is None


def test_flow_sanity_counts_sentinels_and_nonfinite():
    flow = np.zeros((10, 10, 2), np.float32)
    flow[0, :, 0] = UNKNOWN_FLOW          # 10 sentinel pixels
    flow[1, 0, 1] = np.nan                # 1 non-finite pixel
    rep = flow_sanity(flow)
    assert rep.finite_frac < 1.0
    assert 0.10 <= rep.unknown_frac <= 0.12  # 11/100 unknown-or-bad

    with pytest.raises(FlowGuardError):
        check_flow(flow)


def test_check_flow_warp_ratio_gate():
    rng = np.random.default_rng(0)
    img = rng.random((20, 20, 3)).astype(np.float32)
    # shifted[y, x] = img[y, x-3]; warp_error(img1=shifted, img2=img, f)
    # compares shifted(x) to img(x+u)  ->  the explaining flow is u = -3
    shifted = np.roll(img, 3, axis=1)
    good = np.zeros((20, 20, 2), np.float32)
    good[..., 0] = -3.0
    rep = check_flow(good, shifted, img, max_warp_ratio=0.6)
    assert rep.warp_ratio < 0.6

    bad = -good                            # opposite of the motion
    with pytest.raises(FlowGuardError):
        check_flow(bad, shifted, img, max_warp_ratio=0.6)


def test_check_flow_magnitude_gate():
    flow = np.full((8, 8, 2), 100.0, np.float32)
    with pytest.raises(FlowGuardError):
        check_flow(flow, max_mag=50.0)
    check_flow(flow, max_mag=200.0)
