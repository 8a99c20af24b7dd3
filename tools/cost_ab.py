#!/usr/bin/env python
"""Residual-cost kernel vs its XLA form on the card.

Phase ``kernels``: every call shape of the patch-cost stage at real
widths (L0 refine passes at 480x640 and 1080x1920, the coarse descent,
the multiwarp propagation rescoring, the plane-hypothesis form): max abs
difference and per-pixel argmin agreement against ops/dense.py
``residual_costs`` on the same card, then both timed in turns (XLA,
kernel, kernel, XLA), plus a sweep of tile/group/warp settings.

Phase ``e2e``: ``compute_flow_jit`` at 480x640 (one program) and
1080x1920 (staged) with the kernel and with the XLA form, in turns.

Phase ``trace``: a profiler trace of the 480x640 pipeline, reduced to
device time per named stage (``jax.named_scope`` names in the package).

Phase ``compile``: setup time of the 256x320 one-program pipeline under
the process's ``XLA_FLAGS`` (lowering and XLA compilation apart), with
its device time and EPE; run it in processes with different flags to
compare compiler settings.

Usage (on the card):  python tools/cost_ab.py [kernels] [e2e] [trace] [compile]
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "chiprun_out")


def card():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def median_time(fn, *args, n=7):
    import jax

    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@contextlib.contextmanager
def xla_costs():
    """Route every residual-cost call to the XLA form (in-memory jit
    caches cleared on entry and exit so each form is traced anew)."""
    import jax

    import eppm.ops.match as M
    import eppm.ops.pallas_cost as PC
    from eppm.ops.dense import residual_costs

    def one(p1, w2, cands, cfg, use_planes=True, tap_chunk=25):
        return residual_costs(p1, w2, cands, cfg, use_planes, tap_chunk)

    def multi(p1, stack, cfg, tap_chunk=25):
        return jax.lax.map(
            lambda wp: residual_costs(p1, wp, [(0, 0)], cfg, False,
                                      tap_chunk)[0], stack)

    saved = {
        (PC, "residual_costs_auto"): PC.residual_costs_auto,
        (PC, "residual_costs_multiwarp_auto"): PC.residual_costs_multiwarp_auto,
        (M, "residual_costs_auto"): M.residual_costs_auto,
        (M, "residual_costs_multiwarp_auto"): M.residual_costs_multiwarp_auto,
    }
    for (mod, name) in saved:
        setattr(mod, name, multi if "multiwarp" in name else one)
    jax.clear_caches()
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
        jax.clear_caches()


def packs(h, w, seed=0):
    import jax.numpy as jnp

    from eppm.ops.census import census_transform
    from eppm.ops.cost import pack_frame
    from eppm.ops.dense import warp_pack
    from eppm.synthetic import shift_pair

    img1, img2, _ = shift_pair(h, w, seed=seed)
    i1, i2 = jnp.asarray(img1), jnp.asarray(img2)
    p1 = pack_frame(i1, census_transform(i1))
    p2 = pack_frame(i2, census_transform(i2))
    g = jnp.full((h, w), 5, jnp.int32), jnp.full((h, w), 3, jnp.int32)
    return p1, p2, warp_pack(p2, g[0], g[1])


def phase_kernels(lines):
    import jax
    import jax.numpy as jnp

    from eppm.config import DEFAULT_CONFIG as cfg
    from eppm.ops.dense import center_out_offsets, residual_costs
    from eppm.ops.match import _make_mini_cost
    from eppm.ops.pallas_cost import _costs, residual_costs_triton

    coarse = {s: cfg.pyramid.level_dims(*s)[-1]
              for s in ((480, 640), (1080, 1920))}
    sq1 = center_out_offsets(cfg.dense_search_radius)
    desc = center_out_offsets(cfg.match.descent_radius)
    cases = [
        ("L0 pass1 480x640", (480, 640), sq1, cfg.cost, False),
        ("L0 pass2 480x640", (480, 640), sq1, cfg.pass2_cost, False),
        ("L0 pass1 1080x1920", (1080, 1920), sq1, cfg.cost, False),
        ("L0 pass2 1080x1920", (1080, 1920), sq1, cfg.pass2_cost, False),
        ("planes K=9 T=4 480x640", (480, 640), sq1, cfg.cost, True),
    ]
    for s, (ch, cw) in coarse.items():
        cases.append((f"descent K={len(desc)} {ch}x{cw}", (ch, cw), desc,
                      cfg.cost, False))
    mini = _make_mini_cost(cfg.cost, cfg.match)
    cases.append((f"mini descent K={len(desc)} 60x80", (60, 80), desc, mini,
                  False))
    pk = {}
    for name, (h, w), cands, ccfg, planes in cases:
        if (h, w) not in pk:
            pk[(h, w)] = packs(h, w)
        p1, _, w2 = pk[(h, w)]
        fk = jax.jit(lambda a, b, c=cands, k=ccfg, pl_=planes:
                     residual_costs_triton(a, b, c, k, pl_))
        fx = jax.jit(lambda a, b, c=cands, k=ccfg, pl_=planes:
                     residual_costs(a, b, c, k, pl_))
        t0 = time.perf_counter()
        got = np.asarray(fk(p1, w2))
        tc = time.perf_counter() - t0
        ref = np.asarray(fx(p1, w2))
        d = float(np.abs(got - ref).max())
        agree = float((got.argmin(0) == ref.argmin(0)).mean())
        tx1 = median_time(fx, p1, w2)
        tk1 = median_time(fk, p1, w2)
        tk2 = median_time(fk, p1, w2)
        tx2 = median_time(fx, p1, w2)
        lines.append({
            "case": name, "K": len(cands), "maxdiff": d,
            "maxdiff_limit": 1e-4, "argmin_agree": agree,
            "argmin_limit": 0.999, "kernel_compile_s": tc,
            "xla_ms": [tx1 * 1e3, tx2 * 1e3],
            "kernel_ms": [tk1 * 1e3, tk2 * 1e3],
        })
        print(json.dumps(lines[-1]), flush=True)

    # multiwarp (propagation rescoring): K=5 distinct warps, fronto
    from eppm.ops.pallas_cost import residual_costs_multiwarp_triton

    for (h, w) in coarse.values():
        p1, p2, _ = pk[(h, w)]
        stack = jnp.stack([packs(h, w, seed=s)[2] for s in range(5)])
        fk = jax.jit(lambda a, s: residual_costs_multiwarp_triton(a, s, cfg.cost))
        fx = jax.jit(lambda a, s: jax.lax.map(
            lambda wp: residual_costs(a, wp, [(0, 0)], cfg.cost, False)[0], s))
        got, ref = np.asarray(fk(p1, stack)), np.asarray(fx(p1, stack))
        tx1 = median_time(fx, p1, stack)
        tk1 = median_time(fk, p1, stack)
        tk2 = median_time(fk, p1, stack)
        tx2 = median_time(fx, p1, stack)
        lines.append({
            "case": f"multiwarp K=5 {h}x{w}",
            "maxdiff": float(np.abs(got - ref).max()), "maxdiff_limit": 1e-4,
            "argmin_agree": float((got.argmin(0) == ref.argmin(0)).mean()),
            "xla_ms": [tx1 * 1e3, tx2 * 1e3],
            "kernel_ms": [tk1 * 1e3, tk2 * 1e3],
        })
        print(json.dumps(lines[-1]), flush=True)

    # tile / group / warps sweep at the 1080p L0 pass-1 shape
    p1, _, w2 = pk[(1080, 1920)]
    tables = [tuple(cfg.cost.tap_offsets)]
    cands = [(0, cy, cx) for (cy, cx) in sq1]
    for block, group, warps in [((8, 32), 9, 4), ((16, 32), 9, 4),
                                ((8, 64), 9, 4), ((4, 64), 9, 4),
                                ((8, 32), 3, 4), ((16, 64), 9, 8),
                                ((8, 32), 9, 2)]:
        f = jax.jit(lambda a, b, bl=block, g=group, nw=warps: _costs(
            a, b[None], cands, tables, cfg.cost, block=bl, group=g,
            num_warps=nw))
        try:
            jax.block_until_ready(f(p1, w2))
            t = median_time(f, p1, w2) * 1e3
        except Exception as e:  # a setting the compiler refuses
            t = f"failed: {type(e).__name__}: {str(e)[:200]}"
        lines.append({"sweep": [list(block), group, warps], "ms": t})
        print(json.dumps(lines[-1]), flush=True)


def run_pipeline(img1, img2, n=5):
    import jax

    from eppm.pipeline import compute_flow_jit

    t0 = time.perf_counter()
    jax.block_until_ready(compute_flow_jit(img1, img2))
    first = time.perf_counter() - t0
    flow = compute_flow_jit(img1, img2)
    return first, median_time(compute_flow_jit, img1, img2, n=n), flow


def phase_e2e(lines):
    import jax.numpy as jnp

    from eppm.metrics import flow_error
    from eppm.synthetic import shift_pair

    for (h, w) in ((480, 640), (1080, 1920)):
        img1, img2, gt = shift_pair(h, w)
        i1, i2 = jnp.asarray(img1), jnp.asarray(img2)
        row = {"e2e": f"{h}x{w}"}
        for tag in ("xla", "kernel", "kernel", "xla"):
            ctx = xla_costs() if tag == "xla" else contextlib.nullcontext()
            with ctx:
                first, med, flow = run_pipeline(i1, i2)
            f = np.asarray(flow)
            epe = flow_error(f[16:-16, 16:-16], gt[16:-16, 16:-16])[0]
            row.setdefault(tag + "_ms", []).append(med * 1e3)
            row.setdefault(tag + "_first_s", []).append(first)
            row.setdefault(tag + "_epe", []).append(float(epe))
        lines.append(row)
        print(json.dumps(row), flush=True)


def phase_trace(lines):
    import jax
    import jax.numpy as jnp

    from eppm.pipeline import compute_flow_jit
    from eppm.synthetic import shift_pair

    import eppm.pipeline as P
    from eppm.config import DEFAULT_CONFIG

    img1, img2, _ = shift_pair(480, 640)
    i1, i2 = jnp.asarray(img1), jnp.asarray(img2)
    hlo = P._compute_flow_one_program.lower(
        i1, i2, None, DEFAULT_CONFIG, False, None
    ).compile().as_text()
    jax.block_until_ready(compute_flow_jit(i1, i2))
    tdir = os.path.join(OUT, "trace_480x640")
    with jax.profiler.trace(tdir):
        for _ in range(3):
            jax.block_until_ready(compute_flow_jit(i1, i2))
    from tools.trace_stages import stage_times

    res = stage_times(tdir, hlo, runs=3)
    lines.append({"trace_480x640": res})
    print(json.dumps(lines[-1]), flush=True)


def phase_compile(lines, h=256, w=320):
    """Setup time of the one-program pipeline under this process's
    ``XLA_FLAGS``, with the persistent cache off: tracing + lowering and
    XLA compilation timed apart, then the steady device time and EPE."""
    import jax
    import jax.numpy as jnp

    from eppm.config import DEFAULT_CONFIG
    from eppm.metrics import flow_error
    from eppm.pipeline import compute_flow
    from eppm.synthetic import shift_pair

    jax.config.update("jax_enable_compilation_cache", False)
    img1, img2, gt = shift_pair(h, w, seed=7)
    i1, i2 = jnp.asarray(img1), jnp.asarray(img2)
    f = jax.jit(lambda a, b: compute_flow(a, b, None, DEFAULT_CONFIG))
    t0 = time.perf_counter()
    low = f.lower(i1, i2)
    t1 = time.perf_counter()
    comp = low.compile()
    t2 = time.perf_counter()
    flow = np.asarray(comp(i1, i2))
    row = {
        "compile": f"{h}x{w}", "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "lower_s": t1 - t0, "compile_s": t2 - t1,
        "median_ms": median_time(comp, i1, i2, n=5) * 1e3,
        "epe": float(flow_error(flow[16:-16, 16:-16],
                                gt[16:-16, 16:-16])[0]),
    }
    lines.append(row)
    print(json.dumps(row), flush=True)


def main():
    import jax

    os.makedirs(OUT, exist_ok=True)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a CUDA device, found {dev.platform}")
    lines = [{"card": card(), "device_kind": dev.device_kind}]
    print(json.dumps(lines[0]), flush=True)
    phases = sys.argv[1:] or ["kernels", "e2e", "trace"]
    failed = []
    for ph in phases:
        try:
            {"kernels": phase_kernels, "e2e": phase_e2e,
             "trace": phase_trace, "compile": phase_compile}[ph](lines)
        except Exception:  # report and go on to the next phase
            import traceback

            traceback.print_exc()
            failed.append(ph)
    with open(os.path.join(OUT, "cost_ab.json"), "w") as f:
        json.dump(lines, f, indent=1)
    if failed:
        raise SystemExit(f"phases failed: {failed}")


if __name__ == "__main__":
    main()
