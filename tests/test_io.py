import numpy as np
import pytest

from eppm.io import read_flo, read_ppm, write_flo, write_ppm

def test_ppm_roundtrip(tmp_path, rng):
    img = rng.integers(0, 256, size=(13, 17, 3), dtype=np.uint8)
    p = str(tmp_path / "x.ppm")
    write_ppm(p, img)
    out = read_ppm(p)
    np.testing.assert_array_equal(out, img)


def test_pgm_roundtrip(tmp_path, rng):
    img = rng.integers(0, 256, size=(5, 9), dtype=np.uint8)
    p = str(tmp_path / "x.pgm")
    write_ppm(p, img)
    np.testing.assert_array_equal(read_ppm(p), img)


def test_ppm_comment_header(tmp_path):
    p = str(tmp_path / "c.ppm")
    with open(p, "wb") as f:
        f.write(b"P6\n# a comment\n2 2\n255\n" + bytes(range(12)))
    img = read_ppm(p)
    assert img.shape == (2, 2, 3)
    assert img[0, 0, 0] == 0 and img[1, 1, 2] == 11


def test_read_grove_pair(tmp_path):
    """A generated frame at the Grove pair's shape (main.cpp:38-39
    hardcodes 640x480) survives the PPM codec as textured uint8."""
    from eppm.synthetic import textured_frame

    src = (textured_frame(480, 640, seed=3) * 255).round().astype(np.uint8)
    p = str(tmp_path / "frame10.ppm")
    write_ppm(p, src)
    img = read_ppm(p)
    assert img.shape == (480, 640, 3)
    assert img.dtype == np.uint8
    assert img.std() > 10  # textured, not constant
    np.testing.assert_array_equal(img, src)


def test_flo_roundtrip(tmp_path, rng):
    flow = rng.normal(size=(7, 11, 2)).astype(np.float32)
    p = str(tmp_path / "f.flo")
    write_flo(p, flow)
    out = read_flo(p)
    np.testing.assert_array_equal(out, flow)


def test_flo_bad_tag(tmp_path):
    p = str(tmp_path / "bad.flo")
    with open(p, "wb") as f:
        f.write(np.float32(1.0).tobytes() + np.array([2, 2], "<i4").tobytes())
        f.write(np.zeros(8, "<f4").tobytes())
    with pytest.raises(ValueError):
        read_flo(p)
