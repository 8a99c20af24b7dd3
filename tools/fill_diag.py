#!/usr/bin/env python
"""Coarse-level occlusion-fill diagnostic on any eval case.

Answers, at the COARSE level where reconstruction happens: how many
pixels are holes, what is their offset error after each reconstruction
variant, and what fraction of holes receive a nonzero linear-fill slope.
Much faster than full-pipeline sweeps (one coarse match, many fill
variants).

Usage: python tools/fill_diag.py evalset/sintel_stress/zoom_rot \
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

from eppm.cli import apply_overrides
from eppm.config import DEFAULT_CONFIG
from eppm.io import read_flo, read_ppm
from eppm.ops.match import match_coarse_bidi
from eppm.ops.refine import coarse_occlusion_reconstruct
from eppm.ops.refine import fill_holes, lr_check, outlier_removal
from eppm.pipeline import prepare_pyramids
import dataclasses


def main():
    p = argparse.ArgumentParser()
    p.add_argument("case")
    p.add_argument("--set", dest="overrides", action="append", default=[])
    args = p.parse_args()
    cfg = apply_overrides(DEFAULT_CONFIG, args.overrides)

    img1 = jnp.asarray(read_ppm(os.path.join(args.case, "frame10.ppm")))
    img2 = jnp.asarray(read_ppm(os.path.join(args.case, "frame11.ppm")))
    gt = read_flo(os.path.join(args.case, "flow10.flo"))

    prep = jax.jit(lambda a: prepare_pyramids(a, cfg), static_argnums=())
    levels1, packs1 = prep(img1)
    levels2, packs2 = prep(img2)
    top = len(packs1) - 1
    (tx1, ty1, c1), (tx2, ty2, c2) = jax.jit(
        lambda a, b, q1, q2: match_coarse_bidi(
            a, b, cfg.cost, cfg.match, cfg.cost_tap_chunk, q1, q2
        )
    )(levels1[top], levels2[top], packs1[top], packs2[top])
    tx1, ty1, c1, tx2, ty2, c2 = lr_check(
        tx1, ty1, c1, tx2, ty2, c2, cfg.lr_thresh
    )
    tx1, ty1, c1 = jax.jit(
        lambda a, b, c: outlier_removal(a, b, c, cfg.refine)
    )(tx1, ty1, c1)

    ch, cw = tx1.shape
    h, w = gt.shape[:2]
    ry, rx = ch / h, cw / w
    # GT offsets at coarse scale (nearest sample, scaled values)
    ys = (np.arange(ch) / ry).astype(int).clip(0, h - 1)
    xs = (np.arange(cw) / rx).astype(int).clip(0, w - 1)
    gtc = gt[np.ix_(ys, xs)] * np.array([rx, ry])
    cys, cxs = np.mgrid[0:ch, 0:cw]

    tx1n, ty1n = np.asarray(tx1), np.asarray(ty1)
    hole = (tx1n < 0) | (ty1n < 0)
    print(f"coarse {ch}x{cw}; holes {hole.mean()*100:.1f}% "
          f"({hole.sum()} px)")

    def err(tx, ty, mask):
        du = np.asarray(tx) - cxs - gtc[..., 0]
        dv = np.asarray(ty) - cys - gtc[..., 1]
        e = np.hypot(du, dv)[mask]
        return e.mean() if e.size else float("nan")

    valid = ~hole
    print(f"valid-px EPE {err(tx1n, ty1n, valid):.3f}")

    variants = [
        ("const fill only", dict(linear_baseline=0)),
        ("linear b=4 tol .35", dict(linear_baseline=4)),
        ("linear b=4 tol 10", dict(linear_baseline=4,
                                   linear_slope_tol=10.0)),
        ("linear b=6 tol .35", dict(linear_baseline=6)),
        ("linear b=8 tol 10", dict(linear_baseline=8,
                                   linear_slope_tol=10.0)),
    ]
    f = None
    for name, kw in variants:
        pr = cfg.refine.fill_patch_radius
        ftx, fty = jax.jit(
            lambda a, b, c, kw=kw: fill_holes(a, b, c, patch_radius=pr,
                                              **kw)
        )(tx1, ty1, levels1[top])
        print(f"fill [{name:20s}] hole EPE {err(ftx, fty, hole):.3f}")

    for b in (0, 4, 8):
        rcfg = dataclasses.replace(cfg.refine, fill_linear_baseline=b)
        ftx, fty = jax.jit(
            lambda a, b_, c, r=rcfg: coarse_occlusion_reconstruct(
                a, b_, c, r
            )
        )(tx1, ty1, levels1[top])
        print(f"full reconstruct b={b}: hole EPE {err(ftx, fty, hole):.3f}"
              f"  all EPE {err(ftx, fty, np.ones_like(hole, bool)):.3f}")


if __name__ == "__main__":
    main()
