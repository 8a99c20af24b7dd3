#!/usr/bin/env python
"""Headline benchmark: full EPPM pipeline on the card.

Seeded, generated pairs with known motion (eppm/synthetic.py) at the
Middlebury/Grove shape 640x480 — the reference binary's own workload
(main.cpp:36-79) — and at 1080p, BASELINE's north-star size.

Prints ONE JSON line:
  {"metric": "grove_640x480_fps", "value": N, "unit": "frames/sec",
   "hd1080p_device_ms": N, "epe_640x480": N, "device_kind": "...",
   "card": "<name>, <power limit>"}

640x480 fps: 8 pairs submitted back to back, timed until every flow is
on the host.  1080p: median of 3 single-pair runs ending in
``block_until_ready``.  Fails (non-zero exit, no number) without a CUDA
device or when the 640x480 EPE gate (< 1.0 px, 16 px border) fails.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import jax
    import jax.numpy as jnp

    from eppm.metrics import flow_error
    from eppm.pipeline import compute_flow_jit
    from eppm.synthetic import shift_pair

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a CUDA device; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    img1, img2, gt = shift_pair(480, 640)
    i1, i2 = jnp.asarray(img1), jnp.asarray(img2)
    flow = np.asarray(compute_flow_jit(i1, i2))  # compile + warm
    b = 16
    epe = float(flow_error(flow[b:-b, b:-b], gt[b:-b, b:-b])[0])
    if not (np.isfinite(flow).all() and epe < 1.0):
        print(f"quality gate failed: 640x480 EPE {epe:.3f}", file=sys.stderr)
        return 1

    n = 8
    t0 = time.perf_counter()
    flows = [compute_flow_jit(i1, i2) for _ in range(n)]
    for f in flows:
        np.asarray(f)
    fps = n / (time.perf_counter() - t0)

    h1, h2, _ = shift_pair(1080, 1920)
    h1, h2 = jnp.asarray(h1), jnp.asarray(h2)
    jax.block_until_ready(compute_flow_jit(h1, h2))  # compile + warm
    dev_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(compute_flow_jit(h1, h2))
        dev_s.append(time.perf_counter() - t0)

    print(json.dumps({
        "metric": "grove_640x480_fps",
        "value": fps,
        "unit": "frames/sec",
        "hd1080p_device_ms": float(np.median(dev_s)) * 1e3,
        "epe_640x480": epe,
        "device_kind": dev.device_kind,
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
