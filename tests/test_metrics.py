import numpy as np

from eppm.config import UNKNOWN_FLOW
from eppm.metrics import bad_pixel_rate, flow_error, warp_error


def test_epe_exact():
    gt = np.ones((4, 4, 2), np.float32)
    flow = gt.copy()
    flow[..., 0] += 3.0  # EPE 3 everywhere
    epe, aae = flow_error(flow, gt)
    assert abs(epe - 3.0) < 1e-6
    assert aae > 0


def test_epe_skips_zero_and_unknown_gt():
    gt = np.zeros((2, 2, 2), np.float32)
    gt[0, 0] = (1.0, 0.0)           # the only valid pixel
    gt[0, 1] = (UNKNOWN_FLOW, UNKNOWN_FLOW)
    flow = np.zeros_like(gt)
    flow[0, 0] = (1.0, 0.0)         # exact
    flow[1, 1] = (50.0, 50.0)       # error on an invalid pixel: ignored
    epe, aae = flow_error(flow, gt)
    assert epe == 0.0 and aae < 1e-3  # arccos rounding near 1.0


def test_epe_border():
    gt = np.ones((6, 6, 2), np.float32)
    flow = gt.copy()
    flow[0, :, 0] += 100.0  # huge error only on a border row
    epe, _ = flow_error(flow, gt, border=1)
    assert epe == 0.0


def test_bad_pixel_rate():
    gt = np.ones((4, 4, 2), np.float32)
    flow = gt.copy()
    flow[0, 0, 0] += 10.0
    assert abs(bad_pixel_rate(flow, gt, 3.0) - 1 / 16) < 1e-9


def test_warp_error_zero_for_identical():
    rng = np.random.default_rng(0)
    img = rng.random((8, 8, 3))
    flow = np.zeros((8, 8, 2))
    assert warp_error(img, img, flow) < 1e-12


def test_warp_error_recovers_shift():
    rng = np.random.default_rng(0)
    img2 = rng.random((16, 16, 3))
    img1 = np.roll(img2, shift=-2, axis=1)  # img1(x) = img2(x+2)
    flow = np.zeros((16, 16, 2))
    flow[..., 0] = 2.0
    # interior pixels warp exactly
    assert warp_error(img1[:, :12], img2[:, :12], flow[:, :12]) < 0.1
