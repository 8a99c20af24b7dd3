#!/usr/bin/env python
"""Multi-resolution timing table on the card.

Sibling of bench.py: steady-state single-pair time at the BASELINE
config shapes — Grove 640x480, KITTI 1242x375, 1080p, 4K — on seeded
generated pairs (eppm/synthetic.py).  Per shape: ``device_ms`` (median
of n runs ending in ``block_until_ready``) and ``e2e_ms`` (median of n
runs that also copy the flow to the host).

Usage: python tools/bench_table.py [--out table.json] [--set K=V ...]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = {
    "grove_640x480": (480, 640),
    "kitti_1242x375": (375, 1242),
    "hd_1080p": (1080, 1920),
    "uhd_4k": (2160, 3840),
}


def time_shape(h, w, cfg, n=3):
    import jax
    import jax.numpy as jnp

    from eppm.pipeline import compute_flow_jit
    from eppm.synthetic import shift_pair

    img1, img2, _ = shift_pair(h, w)
    i1, i2 = jnp.asarray(img1), jnp.asarray(img2)
    t0 = time.perf_counter()
    jax.block_until_ready(compute_flow_jit(i1, i2, None, cfg))
    first = time.perf_counter() - t0
    dev, e2e = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(compute_flow_jit(i1, i2, None, cfg))
        dev.append(time.perf_counter() - t0)
    for _ in range(n):
        t0 = time.perf_counter()
        np.asarray(compute_flow_jit(i1, i2, None, cfg))
        e2e.append(time.perf_counter() - t0)
    return {
        "shape": [h, w],
        "first_call_s": first,
        "device_ms": float(np.median(dev)) * 1e3,
        "e2e_ms": float(np.median(e2e)) * 1e3,
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", help="also write the table here as JSON")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   dest="sets", help="config overrides (incl. preset=NAME)")
    args = p.parse_args()
    import jax

    from eppm.cli import apply_overrides
    from eppm.config import DEFAULT_CONFIG

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_table.py needs a CUDA device, found "
                         f"{dev.platform}")
    cfg = apply_overrides(DEFAULT_CONFIG, args.sets)
    table = {
        "device_kind": dev.device_kind,
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0],
        "overrides": list(args.sets),
    }
    for name, (h, w) in SHAPES.items():
        table[name] = time_shape(h, w, cfg)
        print(name, json.dumps(table[name]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(table, f, indent=2)
    print(json.dumps(table))


if __name__ == "__main__":
    main()
