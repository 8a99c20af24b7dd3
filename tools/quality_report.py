#!/usr/bin/env python
"""Quality report: dense engine vs PatchMatch engine vs ground truth.

The reference repo bundles no GT .flo and no runnable-here GPU binary
(SURVEY.md §4, §6), so accuracy is gated on synthetic warps with known
ground truth (translations incl. large displacement, affine fields,
rotations) plus the bundled Grove pair's photometric warp error.

Writes QUALITY.md at the repo root and prints the table.
"""

import io
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

import dataclasses

from eppm.config import DEFAULT_CONFIG
from eppm.io import read_ppm
from eppm.metrics import bad_pixel_rate, flow_error, warp_error
from eppm.pipeline import compute_flow_jit


def _textured(rng, h, w):
    small = rng.random((h // 4 + 2, w // 4 + 2, 3)).astype(np.float32)
    img = np.asarray(
        jax.image.resize(jnp.asarray(small), (h + 8, w + 8, 3), "cubic")
    )[:h, :w]
    return np.clip(img, 0, 1)


def _warp(img, flow):
    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    fx = np.clip(xs + flow[..., 0], 0, w - 1)
    fy = np.clip(ys + flow[..., 1], 0, h - 1)
    x0 = np.floor(fx).astype(int)
    y0 = np.floor(fy).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    return (
        img[y0, x0] * (1 - ax) * (1 - ay)
        + img[y0, x1] * ax * (1 - ay)
        + img[y1, x0] * (1 - ax) * ay
        + img[y1, x1] * ax * ay
    ).astype(np.float32)


def cases(rng, h=240, w=320):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for name, (u, v) in [
        ("translation 5px", (5.0, 3.0)),
        ("translation 25px", (25.0, -14.0)),
        ("large displacement 60px", (60.0, 20.0)),
    ]:
        gt = np.zeros((h, w, 2), np.float32)
        gt[..., 0], gt[..., 1] = u, v
        out.append((name, gt))
    gt = np.stack(
        [4 + 6 * xs / w - 3 * ys / h, -2 + 4 * ys / h], -1
    ).astype(np.float32)
    out.append(("affine field", gt))
    cy, cx = h / 2, w / 2
    th = 0.02
    gt = np.stack(
        [(xs - cx) * (np.cos(th) - 1) - (ys - cy) * np.sin(th),
         (xs - cx) * np.sin(th) + (ys - cy) * (np.cos(th) - 1)], -1
    ).astype(np.float32)
    out.append(("small rotation", gt))
    return out


def main():
    import argparse

    from eppm.cli import apply_overrides

    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--set", action="append", default=[], metavar="K=V", dest="sets",
        help="config overrides for an A/B run; when given, results are "
        "printed but QUALITY.md is NOT rewritten (the committed dossier "
        "stays a DEFAULT_CONFIG artifact)",
    )
    args = ap.parse_args()
    rng = np.random.default_rng(1234)
    cfg_dense = apply_overrides(DEFAULT_CONFIG, args.sets)
    cfg_pm = dataclasses.replace(cfg_dense, match_engine="patchmatch")
    rows = []
    for name, gt in cases(rng):
        h, w = gt.shape[:2]
        img2 = _textured(rng, h, w)
        img1 = _warp(img2, gt)
        res = {}
        for ename, cfg in (("dense", cfg_dense), ("patchmatch", cfg_pm)):
            f = np.asarray(compute_flow_jit(
                jnp.asarray(img1), jnp.asarray(img2),
                jax.random.PRNGKey(0), cfg,
            ))
            b = 12
            epe, aae = flow_error(f[b:-b, b:-b], gt[b:-b, b:-b])
            bad = bad_pixel_rate(f[b:-b, b:-b], gt[b:-b, b:-b], 3.0)
            res[ename] = (epe, aae, bad)
        rows.append((name, res))
        print(name, {k: tuple(round(x, 3) for x in v) for k, v in res.items()},
              flush=True)

    img1 = jnp.asarray(read_ppm("/root/reference/frame10.ppm"))
    img2 = jnp.asarray(read_ppm("/root/reference/frame11.ppm"))
    a1 = np.asarray(img1, np.float64) / 255.0
    a2 = np.asarray(img2, np.float64) / 255.0
    grove = {}
    for ename, cfg in (("dense", cfg_dense), ("patchmatch", cfg_pm)):
        f = np.asarray(compute_flow_jit(img1, img2, jax.random.PRNGKey(0), cfg))
        grove[ename] = warp_error(a1, a2, f)
    grove["zero-flow"] = warp_error(a1, a2, np.zeros((480, 640, 2)))
    print("grove warp error:", {k: round(v, 4) for k, v in grove.items()})

    buf = io.StringIO()
    buf.write(
        "# QUALITY — dense engine vs PatchMatch engine\n\n"
        "Synthetic ground-truth warps (240x320, interior-cropped EPE/AAE/"
        "bad3) and the bundled Grove pair (photometric warp error; the\n"
        "reference ships no GT .flo and no binary runnable here — "
        "SURVEY.md §4).  Default parameters, seed 1234, single device "
        f"({jax.default_backend()}; EPE is platform-independent).\n\n"
        "| case | dense EPE | dense AAE° | dense bad3 | PM EPE | PM AAE° | PM bad3 |\n"
        "|---|---|---|---|---|---|---|\n"
    )
    for name, res in rows:
        d, p = res["dense"], res["patchmatch"]
        buf.write(
            f"| {name} | {d[0]:.3f} | {d[1]:.2f} | {d[2]:.3f} "
            f"| {p[0]:.3f} | {p[1]:.2f} | {p[2]:.3f} |\n"
        )
    buf.write(
        f"\nGrove warp error: dense {grove['dense']:.4f}, "
        f"patchmatch {grove['patchmatch']:.4f}, "
        f"zero-flow {grove['zero-flow']:.4f}.\n\n"
        "The dense engine is the default (dense, statically addressed "
        "coarse matching, incl. its exact-cost final stage); the "
        "PatchMatch engine preserves the reference's search structure.  "
        "Generated by tools/quality_report.py.\n"
    )
    if args.sets:
        print("overrides active (" + ", ".join(args.sets)
              + "): QUALITY.md not rewritten")
        return
    with open("QUALITY.md", "w") as f:
        f.write(buf.getvalue())
    print("wrote QUALITY.md")


if __name__ == "__main__":
    main()
