#!/usr/bin/env python
"""Per-region, per-stage error breakdown for the `layered` eval case.

The layered case (evalset/sintel_stress/layered, 436x1024) is a true
two-layer scene: background moving (u=9, v=3) with three independently
textured foreground boxes moving (u=-70, v=20), genuinely occluding
background.  Round-3 verdict: 3.05 EPE, ~10x every other case, cause
undiagnosed.  This tool answers WHERE the error lives (foreground /
background / occluded band / boundary band) and WHEN it appears
(coarse match -> lr -> outlier -> wmf -> holes -> per fine level).

Usage: python tools/layered_diag.py [--case evalset/sintel_stress/layered]
                                    [--set k=v ...]
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax
import jax.numpy as jnp

from eppm.config import DEFAULT_CONFIG
from eppm import pipeline as P
from eppm.io import read_flo, read_ppm
from eppm.cli import apply_overrides
from eppm.ops.refine import (
    coarse_occlusion_reconstruct, fill_holes, flow_to_nnf, lr_check,
    nnf_to_flow, outlier_removal,
)
from eppm.ops.resize import bilinear_resize
from eppm.config import UNKNOWN_FLOW_THRESH


def regions(gt):
    """Masks from the GT field: fg boxes (u<-30), bg, occluded band
    (bg pixels whose GT target lands inside a frame-2 fg box), boundary
    band (within 8 px of a fg box edge, either side)."""
    fg = gt[..., 0] < -30.0
    h, w = fg.shape
    # frame-2 fg region: fg boxes shifted by their motion (dx=-70, dy=20)
    fg2 = np.zeros_like(fg)
    dy, dx = 20, -70
    ys, xs = np.nonzero(fg)
    y2, x2 = ys + dy, xs + dx
    ok = (y2 >= 0) & (y2 < h) & (x2 >= 0) & (x2 < w)
    fg2[y2[ok], x2[ok]] = True
    # occluded: bg pixel p whose bg-motion target p+(3,9) is inside fg2
    tgt_y = np.clip(np.arange(h)[:, None] + 3, 0, h - 1)
    tgt_x = np.clip(np.arange(w)[None, :] + 9, 0, w - 1)
    occ = fg2[tgt_y, tgt_x] & ~fg
    # boundary band: within 8px of the fg/bg edge
    from scipy import ndimage  # available? fall back to manual dilate
    try:
        dil = ndimage.binary_dilation(fg, iterations=8)
        ero = ndimage.binary_erosion(fg, iterations=8)
        band = dil & ~ero
    except Exception:
        band = np.zeros_like(fg)
    return {"fg": fg, "bg": ~fg & ~occ, "occ": occ, "band": band}


def epe_by_region(flow, gt, masks, border=12, label=""):
    flow = np.asarray(flow, np.float32)
    err = np.linalg.norm(flow - gt, axis=-1)
    known = np.abs(flow).max(-1) < UNKNOWN_FLOW_THRESH
    h, w = err.shape
    interior = np.zeros((h, w), bool)
    interior[border:h - border, border:w - border] = True
    out = {}
    for name, m in masks.items():
        mm = m & interior
        mk = mm & known
        n = mm.sum()
        out[name] = (
            float(err[mk].mean()) if mk.sum() else float("nan"),
            float(1.0 - mk.sum() / max(n, 1)),
        )
    mk = interior & known
    out["all"] = (float(err[mk].mean()),
                  float(1.0 - mk.sum() / interior.sum()))
    row = " | ".join(
        f"{k}:{v[0]:7.3f}({v[1]*100:4.1f}%inv)" for k, v in out.items()
    )
    print(f"{label:<28s} {row}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="evalset/sintel_stress/layered")
    ap.add_argument("--set", action="append", default=[], metavar="K=V")
    ap.add_argument("--border", type=int, default=12)
    args = ap.parse_args()

    cfg = apply_overrides(DEFAULT_CONFIG, args.set)
    case = os.path.join(ROOT, args.case)
    img1 = np.asarray(read_ppm(os.path.join(case, "frame10.ppm")))
    img2 = np.asarray(read_ppm(os.path.join(case, "frame11.ppm")))
    gt = read_flo(os.path.join(case, "flow10.flo"))
    masks = regions(gt)
    for k, m in masks.items():
        print(f"region {k}: {m.sum()} px")

    j1, j2 = jnp.asarray(img1), jnp.asarray(img2)
    levels1, packs1 = P._prep_stage(j1, cfg)
    levels2, packs2 = P._prep_stage(j2, cfg)
    top = len(packs1) - 1
    key = jax.random.PRNGKey(cfg.seed)

    # coarse GT + masks
    h, w = img1.shape[:2]
    ch, cw = packs1[top].shape[0], packs1[top].shape[1]
    r = ch / h
    cgt = np.asarray(bilinear_resize(jnp.asarray(gt), ch, cw, r)) * r
    cmasks = {
        k: np.asarray(
            bilinear_resize(
                jnp.asarray(m[..., None].astype(np.float32)), ch, cw, r
            )
        )[..., 0] > 0.5
        for k, m in masks.items()
    }
    cb = max(2, int(args.border * r))

    m1, m2 = P._match_stage_bidi(
        levels1[top], levels2[top], packs1[top], packs2[top], key, cfg
    )
    tx1, ty1, c1 = m1
    tx2, ty2, c2 = m2
    print(f"\n== coarse level {ch}x{cw} (border {cb}) ==")
    epe_by_region(np.asarray(nnf_to_flow(tx1, ty1)), cgt, cmasks, cb,
                  "match fwd")
    tx1, ty1, c1, tx2, ty2, c2 = lr_check(
        tx1, ty1, c1, tx2, ty2, c2, cfg.lr_thresh
    )
    epe_by_region(np.asarray(nnf_to_flow(tx1, ty1)), cgt, cmasks, cb,
                  "after lr_check")
    tx1, ty1, c1 = outlier_removal(tx1, ty1, c1, cfg.refine)
    epe_by_region(np.asarray(nnf_to_flow(tx1, ty1)), cgt, cmasks, cb,
                  "after outlier_removal")
    tx1, ty1 = coarse_occlusion_reconstruct(
        tx1, ty1, levels1[top], cfg.refine
    )
    epe_by_region(np.asarray(nnf_to_flow(tx1, ty1)), cgt, cmasks, cb,
                  "after occl reconstruct")
    flow = nnf_to_flow(tx1, ty1)

    for lvl in range(top - 1, -1, -1):
        oh, ow = packs1[lvl].shape[0], packs1[lvl].shape[1]
        rl = oh / h
        lgt = np.asarray(bilinear_resize(jnp.asarray(gt), oh, ow, rl)) * rl
        lmasks = {
            k: np.asarray(
                bilinear_resize(
                    jnp.asarray(m[..., None].astype(np.float32)), oh, ow, rl
                )
            )[..., 0] > 0.5
            for k, m in masks.items()
        }
        lb = max(2, int(args.border * rl))
        print(f"\n== level {lvl} {oh}x{ow} (border {lb}) ==")
        n = cfg.dense_refine_passes
        fit = cfg.dense_subpixel_fit and lvl == 0
        flow = P._refine_pass_stage(
            flow, packs1[lvl], packs2[lvl], cfg, oh, ow, False,
            fit and n == 1,
        )
        epe_by_region(np.asarray(flow), lgt, lmasks, lb, "refine pass 1")
        for i in range(n - 1):
            flow = P._refine_pass_stage(
                flow, packs1[lvl], packs2[lvl], cfg, oh, ow, True,
                fit and i == n - 2,
            )
            epe_by_region(np.asarray(flow), lgt, lmasks, lb,
                          f"refine pass {i+2}")
        flow = P._smooth_stage(flow, levels1[lvl], cfg)
        epe_by_region(np.asarray(flow), lgt, lmasks, lb, "blf smooth")

    flow = P._smooth_stage(flow, levels1[0], cfg)
    print("\n== final ==")
    epe_by_region(np.asarray(flow), gt, masks, args.border, "final")


if __name__ == "__main__":
    main()
