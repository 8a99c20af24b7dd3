#!/usr/bin/env python
"""Staged vs one-program pipeline at large sizes, on the card.

Above ``STAGED_PIPELINE_THRESHOLD`` pixels ``compute_flow_jit`` runs ~20
jitted stages per pair instead of one program.  This times both routes
at each shape in turns (staged, one program, one program, staged), each
the median of n runs ending in ``block_until_ready``, plus the first
call (compile) of each route — the measurement that decides whether the
threshold stays (ROADMAP A5).

Usage: python tools/measure_staging.py [1080x1920 ...]
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def time_route(route, img1, img2, n=5):
    import jax

    import eppm.pipeline as P

    saved = P.STAGED_PIPELINE_THRESHOLD
    if route == "one_program":
        P.STAGED_PIPELINE_THRESHOLD = 1 << 62
    jax.clear_caches()
    try:
        t0 = time.perf_counter()
        jax.block_until_ready(P.compute_flow_jit(img1, img2))
        first = time.perf_counter() - t0
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            jax.block_until_ready(P.compute_flow_jit(img1, img2))
            ts.append(time.perf_counter() - t0)
    finally:
        P.STAGED_PIPELINE_THRESHOLD = saved
    return first, float(np.median(ts))


def main():
    import jax
    import jax.numpy as jnp

    from eppm.synthetic import shift_pair

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("measure_staging.py needs a CUDA device")
    for shape in sys.argv[1:] or ["1080x1920", "2160x3840"]:
        h, w = (int(v) for v in shape.split("x"))
        img1, img2, _ = shift_pair(h, w)
        i1, i2 = jnp.asarray(img1), jnp.asarray(img2)
        row = {"shape": shape}
        for route in ("staged", "one_program", "one_program", "staged"):
            first, med = time_route(route, i1, i2)
            row.setdefault(route + "_ms", []).append(med * 1e3)
            row.setdefault(route + "_first_s", []).append(first)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
