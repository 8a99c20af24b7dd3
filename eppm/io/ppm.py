"""Netpbm (PPM/PGM) image I/O.

Spec source: the reference PPM loader ``bao_loadimage_ppm``
(basic/bao_basic.cpp:137-218) reads binary P6 with a max-value line and
interleaved RGB bytes.  This implementation additionally supports P5
(grayscale binary) and the ASCII variants P2/P3, and 16-bit maxval.

Pure NumPy; used by tests and the CLI.  A native C++ fast path lives in
``eppm/_native`` (see eppm/io/native.py) and is used when built.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_ppm", "write_ppm"]


def _read_tokens(data: bytes, count: int, pos: int):
    """Read whitespace-separated header tokens, skipping '#' comments."""
    tokens = []
    n = len(data)
    while len(tokens) < count:
        # skip whitespace
        while pos < n and data[pos : pos + 1].isspace():
            pos += 1
        if pos < n and data[pos : pos + 1] == b"#":
            while pos < n and data[pos : pos + 1] != b"\n":
                pos += 1
            continue
        start = pos
        while pos < n and not data[pos : pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError("truncated PNM header")
        tokens.append(data[start:pos])
    return tokens, pos


def read_ppm(path: str) -> np.ndarray:
    """Read a PNM file -> uint8/uint16 array of shape (H, W, 3) or (H, W)."""
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:2]
    if magic not in (b"P2", b"P3", b"P5", b"P6"):
        raise ValueError(f"unsupported PNM magic {magic!r} in {path}")
    tokens, pos = _read_tokens(data, 3, 2)
    w, h, maxval = (int(t) for t in tokens)
    if maxval <= 0 or maxval > 65535:
        raise ValueError(f"bad maxval {maxval} in {path}")
    channels = 3 if magic in (b"P3", b"P6") else 1
    dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
    if magic in (b"P5", b"P6"):
        pos += 1  # single whitespace byte after maxval (bao_basic.cpp:171)
        count = w * h * channels
        arr = np.frombuffer(data, dtype=dtype, count=count, offset=pos)
    else:
        arr = np.array(data[pos:].split(), dtype=np.int64).astype(dtype)
        if arr.size != w * h * channels:
            raise ValueError(f"bad ASCII pixel count in {path}")
    arr = arr.astype(np.uint8 if maxval < 256 else np.uint16)
    if channels == 3:
        return arr.reshape(h, w, 3)
    return arr.reshape(h, w)


def write_ppm(path: str, img: np.ndarray) -> None:
    """Write a uint8 array of shape (H, W, 3) as P6 or (H, W) as P5."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("write_ppm expects uint8")
    if img.ndim == 3 and img.shape[2] == 3:
        magic, (h, w) = b"P6", img.shape[:2]
    elif img.ndim == 2:
        magic, (h, w) = b"P5", img.shape
    else:
        raise ValueError(f"bad image shape {img.shape}")
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())
