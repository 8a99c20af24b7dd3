"""Command-line driver for the EPPM optical-flow engine.

The reference driver (main.cpp:36-79) hardcodes two PPM filenames and a
640x480 resolution with zero flags; every parameter is a compile-time
#define (defs.h:31-91).  This CLI exposes the same pipeline with a real
flag surface: any resolution, any EPPMConfig field overridable, .flo /
color-PPM outputs, optional ground-truth evaluation (EPE/AAE/bad-pixel,
the bao_calc_flow_error math, basic/bao_flow_tools.cpp:64-141), batch
mode over frame sequences, and multi-device meshes.

Usage:
  python -m eppm.cli frame10.ppm frame11.ppm -o flow.flo --viz flow.ppm
  python -m eppm.cli frame10.ppm frame11.ppm --gt gt.flo
  python -m eppm.cli --eval-dir middlebury/ --pattern "frame10.ppm,frame11.ppm,flow10.flo"
  python -m eppm.cli a.ppm b.ppm --set refine.wmf_coarse_iters=10 --set match_engine=patchmatch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, List, Optional, Tuple

import numpy as np

from .config import DEFAULT_CONFIG, EPPMConfig

__all__ = ["main", "apply_overrides", "load_image"]


# Named presets: a preset expands to ordinary --set overrides BEFORE any
# user override in the same command (so --set preset=fast --set k=v lets
# v win).  "fast" is the measured speed/quality trade for real-time-
# leaning deployments; its fps + EPE deltas vs the default are published
# in PERF.md ("fast-1080p preset").
PRESETS = {
    "fast": [
        # plus-shaped candidate set: ~1.8x less refine arithmetic,
        # +0.010 mean EPE on the synthetic sweep (config.py).
        "dense_cand_shape=plus",
        # sparser pass-1 grid on the stabilized warp: radius 8 stride 4
        # (the measured-safe centered 25-tap grid already default for
        # pass 2) halves the dominant L0 pass-1 kernel.
        "cost.patch_stride=4",
        "cost.patch_radius=8",
        # lighter final smoothing: radius 6 instead of 10.
        "refine.blf_sigma_spatial=3.0",
    ],
}


def apply_overrides(cfg: EPPMConfig, overrides: List[str]) -> EPPMConfig:
    """Apply "dotted.path=value" overrides to the (frozen) config tree.

    ``preset=NAME`` expands to the named override list (PRESETS) in
    place, so later explicit overrides win over the preset's choices.
    """
    preset_part: List[str] = []
    user_part: List[str] = []
    for ov in overrides:
        if ov.startswith("preset="):
            name = ov.split("=", 1)[1]
            if name not in PRESETS:
                raise SystemExit(
                    f"unknown preset {name!r} (have: {sorted(PRESETS)})"
                )
            preset_part.extend(PRESETS[name])
        else:
            user_part.append(ov)
    # presets always expand BEFORE user overrides, regardless of where
    # they appear on the command line — an explicit --set must never be
    # silently clobbered by a later preset=.
    overrides = preset_part + user_part
    for ov in overrides:
        if "=" not in ov:
            raise SystemExit(f"--set expects key=value, got {ov!r}")
        path, raw = ov.split("=", 1)
        keys = path.split(".")
        # parse value: try python literal, fall back to string
        try:
            import ast

            value: Any = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw

        def rebuild(node, ks):
            # Validate against actual dataclass fields: hasattr() would
            # accept properties/methods (e.g. lr_thresh) and then fail
            # inside dataclasses.replace with an opaque TypeError.
            field_names = {f.name for f in dataclasses.fields(node)}
            if ks[0] not in field_names:
                raise SystemExit(f"unknown config field {path!r}")
            if len(ks) == 1:
                return dataclasses.replace(node, **{ks[0]: value})
            child = getattr(node, ks[0])
            return dataclasses.replace(
                node, **{ks[0]: rebuild(child, ks[1:])}
            )

        cfg = rebuild(cfg, keys)
    return cfg


def load_image(path: str) -> np.ndarray:
    """Load a PPM/PGM/PNG (self-contained codecs) or anything PIL reads."""
    from .io import read_image

    try:
        return read_image(path)
    except ValueError as e:
        raise SystemExit(str(e))


def _compute(img1, img2, cfg, mesh_shape=None):
    import jax.numpy as jnp

    from .pipeline import compute_flow_jit

    if mesh_shape:
        from .parallel import compute_flow_sharded, make_mesh

        b, y, x = mesh_shape
        mesh = make_mesh(batch=b, y=y, x=x)
        out = compute_flow_sharded(
            jnp.asarray(img1)[None], jnp.asarray(img2)[None], mesh, cfg
        )
        return np.asarray(out[0])
    return np.asarray(
        compute_flow_jit(jnp.asarray(img1), jnp.asarray(img2), None, cfg)
    )


def _evaluate(flow, gt_path, border):
    from .metrics import bad_pixel_rate, flow_error

    if gt_path.lower().endswith(".png"):
        # KITTI 16-bit PNG ground truth; invalid pixels become the
        # unknown-flow sentinel so the reference metric skips them
        from .config import UNKNOWN_FLOW
        from .io.kitti import read_kitti_flow

        gt, valid = read_kitti_flow(gt_path)
        gt = np.where(valid[..., None], gt, np.float32(UNKNOWN_FLOW))
    else:
        from .io.flo import read_flo

        gt = read_flo(gt_path)
    epe, aae = flow_error(flow, gt, border=border)
    if border > 0:  # all three metrics over the same cropped pixel set
        flow = flow[border:-border, border:-border]
        gt = gt[border:-border, border:-border]
    bad = bad_pixel_rate(flow, gt, thresh=3.0)
    return {"epe": epe, "aae_deg": aae, "bad3": bad}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="eppm", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("frame1", nargs="?", help="first frame (PPM/PGM/PNG or PIL-readable)")
    p.add_argument("frame2", nargs="?", help="second frame")
    p.add_argument("-o", "--out", help="write flow as .flo")
    p.add_argument("--viz", help="write color-coded flow as .ppm or .png")
    p.add_argument("--gt", help="ground-truth .flo for EPE/AAE evaluation")
    p.add_argument("--border", type=int, default=0,
                   help="border pixels to skip in evaluation")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="config override, e.g. refine.wmf_coarse_iters=10")
    p.add_argument("--mesh", metavar="B,Y,X",
                   help="device mesh (batch,y,x) for multi-chip execution")
    p.add_argument("--frames-dir", metavar="DIR",
                   help="stream mode: compute flow for every consecutive "
                        "frame pair in DIR (sorted); threaded batch decode "
                        "+ pipelined device dispatch")
    p.add_argument("--out-dir", metavar="DIR",
                   help="directory for streamed .flo outputs")
    p.add_argument("--temporal", action="store_true",
                   help="streaming: warm-start each pair's coarse match "
                        "from the previous pair's flow (MatchConfig "
                        "temporal warm start)")
    p.add_argument("--eval-dir", metavar="DIR",
                   help="evaluate every sequence directory under DIR")
    p.add_argument("--pattern", default="frame10.ppm,frame11.ppm,flow10.flo",
                   metavar="F1,F2,GT",
                   help="filenames inside each sequence dir for --eval-dir")
    p.add_argument("--time", action="store_true",
                   help="report steady-state wall time (2nd run)")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    args = p.parse_args(argv)

    cfg = apply_overrides(DEFAULT_CONFIG, args.set)
    mesh_shape = None
    if args.mesh:
        mesh_shape = tuple(int(v) for v in args.mesh.split(","))
        if len(mesh_shape) != 3:
            raise SystemExit("--mesh expects B,Y,X")

    if args.frames_dir:
        import jax.numpy as jnp

        from .io import IMAGE_EXTS, read_image_batch, write_flo
        from .pipeline import compute_flow_jit

        names = sorted(
            f for f in os.listdir(args.frames_dir)
            if f.lower().endswith(IMAGE_EXTS)
        )
        if len(names) < 2:
            raise SystemExit(
                f"{args.frames_dir}: need >= 2 frames ({'/'.join(IMAGE_EXTS)})"
            )
        paths = [os.path.join(args.frames_dir, f) for f in names]
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)

        # bounded memory: decode frames in chunks, keep a small window of
        # in-flight device computations; a drain thread fetches finished
        # flows so device->host readback overlaps the next pair's upload +
        # compute.
        import queue as _queue
        import threading

        CHUNK = 32
        WINDOW = 4
        n_pairs = len(paths) - 1

        fetch_q: "_queue.Queue" = _queue.Queue(maxsize=WINDOW)
        drain_err = []

        def _drain_worker():
            while True:
                item = fetch_q.get()
                if item is None:
                    return
                name, fl = item
                try:
                    out = np.asarray(fl)
                    if args.out_dir:
                        write_flo(
                            os.path.join(
                                args.out_dir,
                                os.path.splitext(name)[0] + ".flo",
                            ),
                            out,
                        )
                except Exception as e:  # surfaced after the loop
                    drain_err.append(e)

        drainer = threading.Thread(target=_drain_worker, daemon=True)
        drainer.start()

        prev = None
        prev_flow = None  # --temporal: previous pair's device-resident flow
        # warm-up compile on the first pair
        first = read_image_batch(paths[:2])
        warm = compute_flow_jit(
            jnp.asarray(first[0]), jnp.asarray(first[1]), None, cfg
        )
        if args.temporal:  # also compile the warm-started program
            warm = compute_flow_jit(
                jnp.asarray(first[0]), jnp.asarray(first[1]), None, cfg,
                init_flow=warm,
            )
        np.asarray(warm)
        t0 = time.perf_counter()
        for start in range(0, len(paths), CHUNK):
            frames = read_image_batch(paths[start : start + CHUNK])
            for k in range(frames.shape[0]):
                cur = jnp.asarray(frames[k])
                if prev is not None:
                    idx = start + k - 1
                    fl = compute_flow_jit(
                        prev, cur, None, cfg,
                        init_flow=prev_flow if args.temporal else None,
                    )
                    if args.temporal:
                        prev_flow = fl
                    fetch_q.put((names[idx], fl))
                prev = cur
        fetch_q.put(None)
        drainer.join()
        if drain_err:
            raise drain_err[0]
        dt = time.perf_counter() - t0
        print(json.dumps({
            "frames": len(names),
            "pairs": n_pairs,
            "fps": round(n_pairs / dt, 3),
            "out_dir": args.out_dir,
        }))
        return 0

    if args.eval_dir:
        f1n, f2n, gtn = args.pattern.split(",")
        results = {}
        for name in sorted(os.listdir(args.eval_dir)):
            d = os.path.join(args.eval_dir, name)
            f1 = os.path.join(d, f1n)
            f2 = os.path.join(d, f2n)
            gt = os.path.join(d, gtn)
            if not (os.path.isfile(f1) and os.path.isfile(f2)):
                continue
            flow = _compute(load_image(f1), load_image(f2), cfg, mesh_shape)
            if os.path.isfile(gt):
                results[name] = _evaluate(flow, gt, args.border)
            else:
                results[name] = {"epe": None}
        epes = [r["epe"] for r in results.values() if r.get("epe") is not None]
        summary = {
            "sequences": results,
            "mean_epe": float(np.mean(epes)) if epes else None,
        }
        print(json.dumps(summary, indent=None if args.json else 2))
        return 0

    if not (args.frame1 and args.frame2):
        p.error("frame1 and frame2 required (or --eval-dir)")

    img1 = load_image(args.frame1)
    img2 = load_image(args.frame2)
    t0 = time.perf_counter()
    flow = _compute(img1, img2, cfg, mesh_shape)
    t_first = time.perf_counter() - t0
    report = {"shape": list(flow.shape[:2]), "time_s": round(t_first, 4)}
    if args.time:
        t0 = time.perf_counter()
        flow = _compute(img1, img2, cfg, mesh_shape)
        report["steady_time_s"] = round(time.perf_counter() - t0, 4)
        report["fps"] = round(1.0 / max(report["steady_time_s"], 1e-9), 3)

    if args.out:
        from .io.flo import write_flo

        write_flo(args.out, flow)
        report["flo"] = args.out
    if args.viz:
        import jax.numpy as jnp

        from .ops.color import flow_to_color

        rgb = np.asarray(flow_to_color(jnp.asarray(flow)))
        if args.viz.lower().endswith(".png"):
            from .io.png import write_png

            write_png(args.viz, rgb)
        else:
            from .io import write_ppm

            write_ppm(args.viz, rgb)
        report["viz"] = args.viz
    if args.gt:
        report.update(_evaluate(flow, args.gt, args.border))

    if args.json:
        print(json.dumps(report))
    else:
        for k, v in report.items():
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
