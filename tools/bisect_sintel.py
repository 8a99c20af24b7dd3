#!/usr/bin/env python
"""Knob bisect for the round-3 sintel_stress drifts (zoom_rot 0.47->0.69,
large_disp_80 0.12->0.17, judge-measured).  Runs the dense engine on the
sintel_stress group with each round-3 default restored to its round-2
value, one at a time, and prints per-sequence EPE deltas.

Usage: python tools/bisect_sintel.py [--group sintel_stress] [--only NAME]
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = [
    ("baseline", []),
    ("pass1_planes", ["dense_pass1_planes=True"]),
    ("pass2_fullgrid", ["dense_pass2_tap_stride=0",
                        "dense_pass2_patch_radius=0"]),
    ("wmf20", ["refine.wmf_coarse_iters=20"]),
    ("exact_stride3", ["match.exact_tap_stride=3"]),
    ("exact_sched_r2", ["match.exact_prop_steps=(2,1)",
                        "match.exact_median_rounds=2"]),
]


def run(group, extra, border=12):
    gt = "flow10.png" if group.startswith("kitti") else "flow10.flo"
    cmd = [
        sys.executable, "-m", "eppm.cli",
        "--eval-dir", os.path.join(ROOT, "evalset", group),
        "--pattern", f"frame10.ppm,frame11.ppm,{gt}",
        "--border", str(border), "--json",
    ]
    for s in extra:
        cmd += ["--set", s]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         check=True)
    dt = time.perf_counter() - t0
    return json.loads(out.stdout.strip().splitlines()[-1]), dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--group", default="sintel_stress")
    ap.add_argument("--only", default=None,
                    help="run a single variant by name")
    args = ap.parse_args()
    results = {}
    for name, extra in VARIANTS:
        if args.only and name != args.only:
            continue
        summary, dt = run(args.group, extra)
        seqs = {k: v["epe"] for k, v in summary["sequences"].items()}
        results[name] = seqs
        print(f"{name:16s} ({dt:5.0f}s): "
              + "  ".join(f"{k}={v:.3f}" for k, v in sorted(seqs.items())),
              flush=True)
    if "baseline" in results and len(results) > 1:
        base = results["baseline"]
        print("\ndeltas vs baseline (negative = variant better):")
        for name, seqs in results.items():
            if name == "baseline":
                continue
            print(f"{name:16s}: " + "  ".join(
                f"{k}={seqs[k]-base[k]:+.3f}" for k in sorted(seqs)))


if __name__ == "__main__":
    main()
