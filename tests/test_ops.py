"""Unit tests for image ops against independent NumPy oracles that follow
the reference CUDA semantics loop-for-loop."""

import numpy as np
import jax.numpy as jnp

from eppm.ops.census import census_transform
from eppm.ops.color import flow_to_color, make_color_wheel
from eppm.ops.resize import (
    bilinear_resize,
    gaussian_filter,
    gaussian_pyramid,
    pyramid_dims,
)


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


def oracle_gauss(img, sigma, radius):
    """bao_basic_cuda.cuh:397-417: brute-force window, clamped taps."""
    h, w = img.shape[:2]
    out = np.zeros_like(img, dtype=np.float64)
    s2 = sigma * sigma * 2
    for y in range(h):
        for x in range(w):
            val, tot = 0.0, 0.0
            for dy in range(-radius, radius + 1):
                for dx in range(-radius, radius + 1):
                    cy = _clamp(y + dy, 0, h - 1)
                    cx = _clamp(x + dx, 0, w - 1)
                    wgt = np.exp(-(dy * dy + dx * dx) / s2)
                    val += img[cy, cx] * wgt
                    tot += wgt
            out[y, x] = val / tot
    return out


def oracle_resize(img, oh, ow, ratio):
    """bao_basic_cuda.cuh:484-511: trunc-toward-zero + clamped taps."""
    h, w = img.shape[:2]
    out = np.zeros((oh, ow) + img.shape[2:], dtype=np.float64)
    for y in range(oh):
        for x in range(ow):
            fx = (x + 1.0) / ratio - 1.0
            fy = (y + 1.0) / ratio - 1.0
            xx = int(fx)  # C cast: trunc toward zero
            yy = int(fy)
            dx = _clamp(fx - xx, 0.0, 1.0)
            dy = _clamp(fy - yy, 0.0, 1.0)
            res = 0.0
            for m in (0, 1):
                for n in (0, 1):
                    u = _clamp(xx + m, 0, w - 1)
                    v = _clamp(yy + n, 0, h - 1)
                    s = abs(1 - m - dx) * abs(1 - n - dy)
                    res = res + img[v, u] * s
            out[y, x] = res
    return out


def oracle_census(img):
    """bao_pmflow_census_kernel.cu:39-90."""
    h, w = img.shape[:2]
    lum = 0.3 * img[..., 0] + 0.6 * img[..., 1] + 0.1 * img[..., 2]
    offsets = [(-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0), (-1, 1), (0, 1), (1, 1)]
    out = np.zeros((h, w), np.int32)
    for y in range(h):
        for x in range(w):
            sig = 0
            for bit, (dx, dy) in enumerate(offsets):
                ny = _clamp(y + dy, 0, h - 1)
                nx = _clamp(x + dx, 0, w - 1)
                if lum[ny, nx] > lum[y, x]:
                    sig |= 1 << bit
            out[y, x] = sig
    return out


def test_gaussian_filter_matches_oracle(rng):
    img = rng.random((9, 11)).astype(np.float32)
    got = np.asarray(gaussian_filter(jnp.asarray(img), 1.0, 3))
    want = oracle_gauss(img, 1.0, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gaussian_filter_multichannel(rng):
    img = rng.random((7, 8, 3)).astype(np.float32)
    got = np.asarray(gaussian_filter(jnp.asarray(img), 0.5, 2))
    want = oracle_gauss(img, 0.5, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bilinear_resize_down_matches_oracle(rng):
    img = rng.random((12, 16)).astype(np.float32)
    got = np.asarray(bilinear_resize(jnp.asarray(img), 6, 8, 0.5))
    want = oracle_resize(img, 6, 8, 0.5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bilinear_resize_up_matches_oracle(rng):
    img = rng.random((6, 8, 2)).astype(np.float32)
    got = np.asarray(bilinear_resize(jnp.asarray(img), 12, 16, 2.0))
    want = oracle_resize(img, 12, 16, 2.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bilinear_resize_quarter(rng):
    img = rng.random((16, 20)).astype(np.float32)
    got = np.asarray(bilinear_resize(jnp.asarray(img), 4, 5, 0.25))
    want = oracle_resize(img, 4, 5, 0.25)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pyramid_dims_truncate():
    # bao_pyr_init_dim truncates: 480*0.25 = 120, 333*0.5 = 166 (int cast)
    assert pyramid_dims(480, 640, 3) == [(480, 640), (240, 320), (120, 160)]
    assert pyramid_dims(333, 445, 2) == [(333, 445), (166, 222)]


def test_gaussian_pyramid_shapes(rng):
    img = rng.random((32, 40, 3)).astype(np.float32)
    dims = pyramid_dims(32, 40, 3)
    pyr = gaussian_pyramid(jnp.asarray(img), dims)
    assert [p.shape[:2] for p in pyr] == [(32, 40), (16, 20), (8, 10)]
    # level 0 is untouched; deeper levels are smoothed (lower variance)
    np.testing.assert_array_equal(np.asarray(pyr[0]), img)
    assert np.asarray(pyr[2]).std() < img.std()


def test_census_matches_oracle(rng):
    img = rng.random((10, 12, 3)).astype(np.float32)
    got = np.asarray(census_transform(jnp.asarray(img)))
    want = oracle_census(img)
    np.testing.assert_array_equal(got, want)


def test_census_flat_image_is_zero():
    img = jnp.full((6, 6, 3), 0.5, jnp.float32)
    assert int(np.abs(np.asarray(census_transform(img))).max()) == 0


def test_color_wheel():
    wheel = make_color_wheel()
    assert wheel.shape == (55, 3)
    assert wheel.min() >= 0 and wheel.max() <= 1
    np.testing.assert_allclose(wheel[0], [1, 0, 0])  # pure red start


def test_flow_to_color_shapes():
    flow = jnp.zeros((4, 6, 2), jnp.float32)
    rgb = np.asarray(flow_to_color(flow))
    assert rgb.shape == (4, 6, 3) and rgb.dtype == np.uint8
    # zero flow -> white-ish center of the wheel
    assert rgb.min() > 200
