#!/usr/bin/env python
"""Targeted per-case EPE evaluation (subset of the dossier, any device).

For fast development loops on specific eval sequences:
  python tools/quick_eval.py evalset/sintel_stress/zoom_rot \
      evalset/sintel_stress/layered --set refine.fill_linear_baseline=4

Prints one line per case and a mean.  The full dossier remains
tools/eval_report.py; this is its single-case counterpart built on the
same metric (eppm/metrics.py; spec basic/bao_flow_tools.cpp:64-141).
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("cases", nargs="+")
    p.add_argument("--set", dest="overrides", action="append", default=[])
    p.add_argument("--border", type=int, default=12)
    args = p.parse_args()

    import jax

    from eppm.cli import apply_overrides
    from eppm.config import DEFAULT_CONFIG
    from eppm.io import read_flo, read_ppm
    from eppm.io.kitti import read_kitti_flow
    from eppm.metrics import flow_error
    from eppm.pipeline import compute_flow_jit

    cfg = apply_overrides(DEFAULT_CONFIG, args.overrides)
    epes = []
    for case in args.cases:
        img1 = read_ppm(os.path.join(case, "frame10.ppm"))
        img2 = read_ppm(os.path.join(case, "frame11.ppm"))
        fpng = os.path.join(case, "flow10.png")
        gt = (
            read_kitti_flow(fpng)[0]
            if os.path.exists(fpng)
            else read_flo(os.path.join(case, "flow10.flo"))
        )
        flow = np.asarray(
            compute_flow_jit(img1, img2, jax.random.PRNGKey(0), cfg)
        )
        epe, aae = flow_error(flow, gt, border=args.border)
        epes.append(epe)
        print(f"{os.path.basename(case):24s} EPE {epe:.3f}  AAE {aae:.2f}",
              flush=True)
    print(f"{'mean':24s} EPE {np.mean(epes):.3f}")


if __name__ == "__main__":
    main()
