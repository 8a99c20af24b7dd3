#!/usr/bin/env python
"""Video-streaming throughput: cold vs temporal warm start.

Generates a synthetic N-frame video (a seeded textured frame,
eppm/synthetic.py, rolled by a constant per-frame motion), streams it through the CLI pipeline twice (cold, --temporal), and prints
one JSON line per mode plus a quality check of the warm output against
the known motion.

The headline bench (bench.py) stays cold on purpose: it repeats one pair,
which a warm start would trivially (and unrealistically) accelerate.
This script is the honest warm-start measurement: every pair is a new
frame, the warm start only helps as much as real temporal coherence does.

Usage:  python tools/stream_bench.py [--frames 32] [--size 480x640]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DY, DX = 2, 3  # px/frame, constant


def make_frames(fdir: str, n: int, h: int, w: int) -> None:
    from eppm.io import write_ppm
    from eppm.synthetic import textured_frame

    base = (textured_frame(h, w) * 255.0).round().astype(np.uint8)
    for i in range(n):
        write_ppm(
            os.path.join(fdir, f"f{i:04d}.ppm"),
            np.roll(base, (DY * i, DX * i), axis=(0, 1)),
        )


def run_mode(fdir: str, odir: str, temporal: bool) -> float:
    """Stream the directory through the CLI; return fps from its JSON."""
    import contextlib
    import io as _io

    from eppm.cli import main

    argv = ["--frames-dir", fdir, "--out-dir", odir]
    if temporal:
        argv.append("--temporal")
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"cli failed rc={rc}: {buf.getvalue()[-400:]}")
    line = [l for l in buf.getvalue().splitlines() if l.startswith("{")][-1]
    return json.loads(line)["fps"]


def main_() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--size", default="480x640")
    args = p.parse_args()
    h, w = map(int, args.size.split("x"))

    tmp = tempfile.mkdtemp(prefix="streambench_")
    fdir = os.path.join(tmp, "frames")
    os.makedirs(fdir)
    try:
        make_frames(fdir, args.frames, h, w)
        results = {}
        for mode, temporal in [("cold", False), ("temporal", True)]:
            odir = os.path.join(tmp, f"flo_{mode}")
            fps = run_mode(fdir, odir, temporal)
            results[mode] = fps
            print(json.dumps({
                "metric": f"stream_{h}x{w}_{mode}_fps",
                "value": round(fps, 4), "unit": "frames/sec",
            }), flush=True)

        # quality: warm output must still carry the known constant motion
        from eppm.io import read_flo
        from eppm.metrics import flow_error

        fl = read_flo(os.path.join(tmp, "flo_temporal",
                                   f"f{args.frames // 2:04d}.flo"))
        gt = np.zeros(fl.shape, np.float32)
        gt[..., 0], gt[..., 1] = float(DX), float(DY)
        b = 16
        epe, _ = flow_error(fl[b:-b, b:-b], gt[b:-b, b:-b])
        print(json.dumps({
            "metric": f"stream_{h}x{w}_temporal_epe",
            "value": round(float(epe), 4), "unit": "px",
            "speedup_vs_cold": round(results["temporal"] / results["cold"], 3),
        }), flush=True)
        return 0 if epe < 1.0 else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main_())
