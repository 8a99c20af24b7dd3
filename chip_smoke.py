#!/usr/bin/env python
"""On-card smoke test: the EPPM pipeline on one CUDA device, checked.

Phases, one process, each check on its own line; any failed check or
exception ends the run with a non-zero exit code:

1. device   — JAX's first device must be a GPU; prints its kind, the
              device count, the JAX version and the card's name and
              power limit (nvidia-smi).
2. kernels  — the residual-cost kernel (ops/pallas_cost.py, Pallas on
              the Triton route) against ops/dense.py ``residual_costs``
              on the same card at the 480x640 and 1080x1920 L0 shapes,
              the coarse descent and the multiwarp rescoring: max abs
              difference <= 1e-4 and per-pixel argmin agreement >= 99.9%.
3. pipeline — ``compute_flow_jit`` at 480x640 (one program) and
              1080x1920 (staged) on seeded pairs with known motion:
              setup (compile) time of every program (compiled in
              parallel threads while phase 2 runs), ``memory_analysis()``
              of the 480x640 program, median of 5 steady device times
              (run one at a time, after all compiles), EPE gates
              (uniform shift < 1.0 px, smooth flow < 1.5 px, 16 px
              border); ``EPPMFlow``; a byte-exact .flo round trip; the
              CLI streaming loop over 6 generated frames, cold and
              ``--temporal``; peak device memory.
4. gpu_cpu  — one 240x320 pair on the GPU and on the CPU device of the
              same process: |EPE_gpu - EPE_cpu| <= 0.05 px, and two GPU
              runs bitwise identical.

``--four`` runs only the four-card checks: ``compute_flow_sharded`` on a
(batch=4, y=1, x=1) mesh over four 1080p pairs and a (1, 2, 2) tiled
3840x2160 pair, each against single-device ``compute_flow_jit``.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage:  python chip_smoke.py [--four]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from eppm.config import DEFAULT_CONFIG  # noqa: E402
from eppm.metrics import flow_error  # noqa: E402
from eppm.synthetic import shift_pair, smooth_flow_pair, textured_frame  # noqa: E402

BORDER = 16
COST_MAXDIFF = 1e-4
ARGMIN_AGREE = 0.999
GPU_CPU_GAP = 0.05
SHARD_AGREE = 0.98      # tests/test_sharded.py decision-level contract
SHARD_MEAN_DELTA = 0.05


def say(msg):
    print(msg, flush=True)


def gate(ok, what):
    say(("PASS " if ok else "FAIL ") + what)
    if not ok:
        raise SystemExit(1)


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return [l.strip() for l in out.strip().splitlines()]


def u8(img):
    return (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def epe(flow, gt):
    b = BORDER
    f = np.asarray(flow)
    return float(flow_error(f[b:-b, b:-b], gt[b:-b, b:-b])[0])


def steady_ms(fn, *args, n=5):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def phase_device():
    devs = jax.devices()
    d = devs[0]
    gate(d.platform == "gpu", f"device: JAX platform {d.platform!r} is gpu")
    cards = card_lines()
    say(f"device_kind {d.device_kind!r}, {len(devs)} device(s), "
        f"jax {jax.__version__}")
    for c in cards:
        say(c)
    return d, cards[0]


def _packs(h, w, seed=0):
    from eppm.ops.census import census_transform
    from eppm.ops.cost import pack_frame
    from eppm.ops.dense import warp_pack

    img1, img2, gt = shift_pair(h, w, seed=seed)
    i1, i2 = jnp.asarray(img1), jnp.asarray(img2)
    p1 = pack_frame(i1, census_transform(i1))
    p2 = pack_frame(i2, census_transform(i2))
    gx = jnp.full((h, w), int(gt[0, 0, 0]), jnp.int32)
    gy = jnp.full((h, w), int(gt[0, 0, 1]), jnp.int32)
    return p1, p2, warp_pack(p2, gx, gy)


def _compare(name, got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    d = float(np.abs(got - ref).max())
    agree = float((got.argmin(0) == ref.argmin(0)).mean())
    gate(d <= COST_MAXDIFF and agree >= ARGMIN_AGREE,
         f"kernel {name}: max|diff| {d:.3g} (limit {COST_MAXDIFF:g}), "
         f"argmin agreement {agree:.5f} (limit {ARGMIN_AGREE})")


def phase_kernels(shapes=((480, 640), (1080, 1920))):
    from eppm.ops.dense import center_out_offsets, residual_costs
    from eppm.ops.match import _make_mini_cost
    from eppm.ops.pallas_cost import (
        residual_costs_multiwarp_triton,
        residual_costs_triton,
    )

    cfg = DEFAULT_CONFIG
    sq = center_out_offsets(cfg.dense_search_radius, cfg.dense_cand_shape)
    desc = center_out_offsets(cfg.match.descent_radius)
    mini = _make_mini_cost(cfg.cost, cfg.match)

    def both(p1, w2, cands, ccfg, planes=False):
        k = jax.jit(lambda a, b: residual_costs_triton(a, b, cands, ccfg,
                                                       planes))(p1, w2)
        r = jax.jit(lambda a, b: residual_costs(a, b, cands, ccfg,
                                                planes))(p1, w2)
        return k, r

    for (h, w) in shapes:
        p1, _, w2 = _packs(h, w)
        _compare(f"L0 pass 1 K={len(sq)} {h}x{w}",
                 *both(p1, w2, sq, cfg.cost))
        _compare(f"L0 pass 2 K={len(sq)} {h}x{w}",
                 *both(p1, w2, sq, cfg.pass2_cost))
        ch, cw = cfg.pyramid.level_dims(h, w)[-1]
        c1, c2, cw2 = _packs(ch, cw, seed=1)
        _compare(f"coarse descent K={len(desc)} {ch}x{cw}",
                 *both(c1, cw2, desc, cfg.cost))
        _compare(f"mini-level descent K={len(desc)} {ch // 2}x{cw // 2}",
                 *both(c1[::2, ::2], cw2[::2, ::2], desc, mini))
        stack = jnp.stack([_packs(ch, cw, seed=s)[2] for s in range(5)])
        mk = jax.jit(lambda a, s: residual_costs_multiwarp_triton(
            a, s, cfg.cost))(c1, stack)
        mr = jax.jit(lambda a, s: jax.lax.map(
            lambda wp: residual_costs(a, wp, [(0, 0)], cfg.cost, False)[0],
            s))(c1, stack)
        _compare(f"multiwarp K=5 {ch}x{cw}", mk, mr)
    p1, _, w2 = _packs(*shapes[0])
    _compare(f"plane hypotheses K={len(sq)}x4 {shapes[0][0]}x{shapes[0][1]}",
             *both(p1, w2, sq, cfg.cost, True))


def _timed(fn):
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    return time.perf_counter() - t0


class Pairs:
    """The seeded uint8 pairs every phase shares (uint8 like decoded
    frames, so the CLI reuses the programs compiled for them)."""

    def __init__(self, small, large, gpucpu):
        self.small, self.large, self.gpucpu = small, large, gpucpu
        self.shift = {}
        for hw in (small, large):
            img1, img2, gt = shift_pair(*hw, dx=5.0, dy=3.0, seed=11)
            self.shift[hw] = (jnp.asarray(u8(img1)), jnp.asarray(u8(img2)),
                              gt)
        img1, img2, self.gc_gt = shift_pair(*gpucpu, dx=4.0, dy=-2.0,
                                            seed=31)
        self.gc = (u8(img1), u8(img2))


def compile_all(dev, pairs):
    """Compile (and first-run) every program the later phases use, in
    parallel threads; prints each one's setup time.  Returns the
    ``memory_analysis()`` of the small one-program pipeline."""
    from concurrent.futures import ThreadPoolExecutor

    import eppm.pipeline as P

    cfg = DEFAULT_CONFIG
    small, large = pairs.small, pairs.large
    i1, i2, _ = pairs.shift[small]
    h1, h2, _ = pairs.shift[large]
    a, b = pairs.gc
    cpu = jax.devices("cpu")[0]
    zero = jax.device_put(jnp.zeros(small + (2,), jnp.float32), dev)
    analysis = {}

    def one_program():
        compiled = P._compute_flow_one_program.lower(
            i1, i2, None, cfg, False, None
        ).compile()
        analysis["small"] = compiled.memory_analysis()
        return P.compute_flow_jit(i1, i2)

    def on_cpu():
        with jax.default_device(cpu):
            return P.compute_flow_jit(jax.device_put(a, cpu),
                                      jax.device_put(b, cpu))

    jobs = {
        f"{small[0]}x{small[1]} one program": one_program,
        f"{small[0]}x{small[1]} one program, warm start":
            lambda: P.compute_flow_jit(i1, i2, init_flow=zero),
        f"{large[0]}x{large[1]} staged": lambda: P.compute_flow_jit(h1, h2),
        f"{pairs.gpucpu[0]}x{pairs.gpucpu[1]} gpu":
            lambda: P.compute_flow_jit(jnp.asarray(a), jnp.asarray(b)),
        f"{pairs.gpucpu[0]}x{pairs.gpucpu[1]} cpu": on_cpu,
    }
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {name: ex.submit(_timed, fn) for name, fn in jobs.items()}
        for name, fut in futs.items():
            say(f"setup {name}: {fut.result():.1f} s (compile + first run, "
                f"{len(jobs)} compiling in parallel)")
    return analysis["small"]


def _pipeline_shape(hw, pairs, card):
    from eppm.pipeline import compute_flow_jit

    h, w = hw
    i1, i2, gt = pairs.shift[hw]
    flow = compute_flow_jit(i1, i2)
    ms = steady_ms(compute_flow_jit, i1, i2)
    say(f"{h}x{w} compute_flow_jit median of 5: {ms:.2f} ms device "
        f"[{card}]")
    e = epe(flow, gt)
    gate(np.isfinite(np.asarray(flow)).all() and e < 1.0,
         f"{h}x{w} uniform-shift EPE {e:.4f} (limit 1.0)")
    s1, s2, sgt = smooth_flow_pair(h, w, seed=12)
    sflow = compute_flow_jit(jnp.asarray(u8(s1)), jnp.asarray(u8(s2)))
    e = epe(sflow, sgt)
    gate(e < 1.5, f"{h}x{w} smooth-flow EPE {e:.4f} (limit 1.5)")
    return flow


def phase_pipeline(dev, card, pairs, n_frames=6):
    from eppm.cli import main as cli_main
    from eppm.io import read_flo, write_flo, write_ppm
    from eppm.pipeline import EPPMFlow

    small = pairs.small
    flow = _pipeline_shape(small, pairs, card)
    _pipeline_shape(pairs.large, pairs, card)

    i1, i2, _ = pairs.shift[small]
    eng = EPPMFlow(DEFAULT_CONFIG).init(*small).set_data(i1, i2)
    ef = np.asarray(eng.compute_flow())
    gate(np.array_equal(ef, np.asarray(flow)),
         "EPPMFlow init/set_data/compute_flow equals compute_flow_jit")

    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a.flo"), os.path.join(tmp, "b.flo")
        write_flo(a, np.asarray(flow))
        back = read_flo(a)
        write_flo(b, back)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            same = fa.read() == fb.read()
        gate(same and np.array_equal(back, np.asarray(flow)),
             ".flo round trip byte-exact")

        dy, dx = 2, 3
        fdir = os.path.join(tmp, "frames")
        os.makedirs(fdir)
        base = u8(textured_frame(*small, seed=21))
        for i in range(n_frames):
            write_ppm(os.path.join(fdir, f"f{i:02d}.ppm"),
                      np.roll(base, (dy * i, dx * i), axis=(0, 1)))
        gt = np.zeros(small + (2,), np.float32)
        gt[..., 0], gt[..., 1] = dx, dy
        for extra in ([], ["--temporal"]):
            odir = os.path.join(tmp, "flo" + "".join(extra))
            rc = cli_main(["--frames-dir", fdir, "--out-dir", odir] + extra)
            flos = sorted(os.listdir(odir))
            worst = max(epe(read_flo(os.path.join(odir, f)), gt)
                        for f in flos)
            gate(rc == 0 and len(flos) == n_frames - 1 and worst < 1.0,
                 f"CLI stream {' '.join(extra) or 'cold'}: rc {rc}, "
                 f"{len(flos)} flows, worst EPE {worst:.4f} (limit 1.0)")
    peak = dev.memory_stats()["peak_bytes_in_use"]
    say(f"peak_bytes_in_use {peak} ({peak / 2**30:.2f} GiB) [{card}]")


def phase_gpu_cpu(pairs):
    from eppm.pipeline import compute_flow_jit

    h, w = pairs.gpucpu
    a, b = pairs.gc
    gt = pairs.gc_gt
    g1 = np.asarray(compute_flow_jit(jnp.asarray(a), jnp.asarray(b)))
    g2 = np.asarray(compute_flow_jit(jnp.asarray(a), jnp.asarray(b)))
    gate(np.array_equal(g1, g2), f"{h}x{w} two GPU runs bitwise identical")
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        c = np.asarray(compute_flow_jit(jax.device_put(a, cpu),
                                        jax.device_put(b, cpu)))
    e_g, e_c = epe(g1, gt), epe(c, gt)
    say(f"{h}x{w} EPE gpu-vs-cpu {epe(g1, c):.4f}; vs ground truth: "
        f"gpu {e_g:.4f}, cpu {e_c:.4f}")
    gate(abs(e_g - e_c) <= GPU_CPU_GAP,
         f"|EPE_gpu - EPE_cpu| {abs(e_g - e_c):.4f} (limit {GPU_CPU_GAP})")


def _agree(name, got, ref, gt):
    """The decision-level contract; returns whether it holds."""
    d = np.abs(np.asarray(got) - np.asarray(ref)).max(axis=-1)
    agree, mean = float((d < 1e-3).mean()), float(d.mean())
    ok = agree > SHARD_AGREE and mean < SHARD_MEAN_DELTA
    say(f"{'PASS' if ok else 'FAIL'} {name}: {agree:.4%} of pixels agree "
        f"(limit {SHARD_AGREE}), mean |delta| {mean:.4f} (limit "
        f"{SHARD_MEAN_DELTA}); EPE vs ground truth sharded "
        f"{epe(got, gt):.4f}, single-device {epe(ref, gt):.4f}")
    return ok


def _shards(name, out):
    for s in out.addressable_shards:
        say(f"{name} shard {s.index} on {s.device}")
    return len({s.device for s in out.addressable_shards}) == 4


def phase_four(card, hd=(1080, 1920), uhd=(2160, 3840)):
    """Batch mesh and tiled 4K against single-device results; every
    comparison is reported before the run fails on any of them."""
    from concurrent.futures import ThreadPoolExecutor

    from eppm.parallel import compute_flow_sharded, make_mesh
    from eppm.parallel.sharded import pad_to_tileable
    from eppm.pipeline import compute_flow_jit

    devs = jax.devices()
    gate(len(devs) >= 4, f"{len(devs)} devices (need 4)")
    motions = [(5.0, 3.0), (-4.0, 2.0), (7.0, -1.0), (2.0, 6.0)]
    pairs = [shift_pair(*hd, dx=dx, dy=dy, seed=40 + i)
             for i, (dx, dy) in enumerate(motions)]
    singles = [(jax.device_put(u8(p[0]), devs[0]),
                jax.device_put(u8(p[1]), devs[0])) for p in pairs]
    a4 = jnp.asarray(np.stack([u8(p[0]) for p in pairs]))
    b4 = jnp.asarray(np.stack([u8(p[1]) for p in pairs]))
    mesh_b = make_mesh(batch=4, y=1, x=1)
    # 2160 rows do not tile 2x2 through 5 halving levels: the sharded
    # path edge-pads to pad_to_tileable dims and crops, so the reference
    # runs on identically padded frames (tests/test_sharded.py contract)
    h, w = uhd
    img1, img2, gt4k = shift_pair(h, w, dx=6.0, dy=4.0, seed=50)
    a1, b1 = jnp.asarray(u8(img1))[None], jnp.asarray(u8(img2))[None]
    ph, pw = pad_to_tileable(h, w, DEFAULT_CONFIG, 2, 2)
    pad = ((0, ph - h), (0, pw - w), (0, 0))
    ap = jax.device_put(np.pad(u8(img1), pad, mode="edge"), devs[0])
    bp = jax.device_put(np.pad(u8(img2), pad, mode="edge"), devs[0])
    mesh_t = make_mesh(batch=1, y=2, x=2)
    t0 = time.perf_counter()
    names = (f"batch mesh (4,1,1) {hd[0]}x{hd[1]}",
             f"single device {hd[0]}x{hd[1]}",
             f"tiled mesh (1,2,2) {h}x{w}", f"single device {ph}x{pw}")
    jobs = (lambda: compute_flow_sharded(a4, b4, mesh_b),
            lambda: compute_flow_jit(*singles[0]),
            lambda: compute_flow_sharded(a1, b1, mesh_t),
            lambda: compute_flow_jit(ap, bp))

    def setup(fut, name):
        say(f"setup {name}: {fut.result():.1f} s (compile + first run, "
            f"{len(jobs)} compiling in parallel; "
            f"{time.perf_counter() - t0:.1f} s into the phase)")

    ok = []
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = [ex.submit(_timed, fn) for fn in jobs]
        # the batch checks go first, while the 4K programs still compile
        setup(futs[0], names[0])
        setup(futs[1], names[1])
        out = compute_flow_sharded(a4, b4, mesh_b)
        ok.append(_shards("batch mesh", out))
        for i, (p, (dx, dy), s) in enumerate(zip(pairs, motions, singles)):
            ok.append(_agree(f"batch pair {i} (motion {dx:+.0f},{dy:+.0f})",
                             np.asarray(out[i]), compute_flow_jit(*s), p[2]))
        setup(futs[2], names[2])
        setup(futs[3], names[3])
    out = compute_flow_sharded(a1, b1, mesh_t)
    ok.append(_shards("tiled 4K", out))
    ok.append(_agree(f"tiled {h}x{w} (padded to {ph}x{pw})",
                     np.asarray(out[0]),
                     np.asarray(compute_flow_jit(ap, bp))[:h, :w], gt4k))
    say(f"batch mesh (4,1,1) {hd[0]}x{hd[1]}: "
        f"{steady_ms(compute_flow_sharded, a4, b4, mesh_b, n=3):.2f} ms "
        f"for 4 pairs, median of 3 [{card}]")
    say(f"single device {hd[0]}x{hd[1]}: "
        f"{steady_ms(compute_flow_jit, *singles[0], n=3):.2f} ms per pair, "
        f"median of 3 [{card}]")
    say(f"tiled mesh (1,2,2) {h}x{w}: "
        f"{steady_ms(compute_flow_sharded, a1, b1, mesh_t, n=3):.2f} ms, "
        f"median of 3 [{card}]")
    say(f"single device {ph}x{pw}: "
        f"{steady_ms(compute_flow_jit, ap, bp, n=3):.2f} ms, "
        f"median of 3 [{card}]")
    gate(all(ok), f"four-card checks: {sum(ok)} of {len(ok)} hold")
    return 4


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card mesh checks")
    args = p.parse_args()
    dev, card = phase_device()
    if args.four:
        count = phase_four(card)
    else:
        t0 = time.perf_counter()
        pairs = Pairs((480, 640), (1080, 1920), (240, 320))
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as ex:
            # the pipeline programs compile while the kernel checks run
            fut = ex.submit(compile_all, dev, pairs)
            phase_kernels()
            say(f"[kernels phase done at {time.perf_counter() - t0:.1f} s]")
            analysis = fut.result()
        say(f"480x640 memory_analysis: {analysis}")
        say(f"[setup done at {time.perf_counter() - t0:.1f} s]")
        phase_pipeline(dev, card, pairs)
        say(f"[pipeline phase done at {time.perf_counter() - t0:.1f} s]")
        phase_gpu_cpu(pairs)
        say(f"[gpu_cpu phase done at {time.perf_counter() - t0:.1f} s]")
        count = 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}), flush=True)


if __name__ == "__main__":
    main()
