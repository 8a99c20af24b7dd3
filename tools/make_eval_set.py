#!/usr/bin/env python
"""Generate the deterministic evaluation datasets for EVAL.md.

The reference repo bundles a single Middlebury pair with no ground truth
and no benchmark table (SURVEY.md §4, §6), so dataset-level accuracy is
gated on synthetic sequences with exact ground truth, in the three
BASELINE dataset shapes:

  middlebury_synth/  8 sequences, 480x640  (Middlebury class: small-to-
                     large translations, affine, rotation, zoom, shear,
                     piecewise-discontinuous motion)
  sintel_stress/     4 sequences, 436x1024 (Sintel dims; large
                     displacement 60-120 px, layered discontinuities)
  kitti_fixtures/    4 sequences, 375x1242 (KITTI-2015 dims; wide frame,
                     horizontal-dominant motion; ground truth stored in
                     the KITTI 16-bit PNG flow format through
                     eppm/io/kitti.py)

Each sequence directory holds frame10.ppm, frame11.ppm and ground truth
(flow10.flo, or flow10.png for KITTI).  frame10 = warp(frame11, gt), the
standard inverse-warp construction: the flow maps frame10 pixel p to
frame11 position p + gt(p).  Evaluation metric spec:
/root/reference/basic/bao_flow_tools.cpp:64-141 (eppm/metrics.py).

Deterministic: fixed seed, pure NumPy.  Usage:
  python tools/make_eval_set.py [--root evalset]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from eppm.io import write_ppm
from eppm.io.flo import write_flo
from eppm.io.kitti import write_kitti_flow


def textured(rng, h, w):
    """Multi-octave RGB texture: coarse structure + mid + fine detail."""
    img = np.zeros((h, w, 3), np.float64)
    for scale, amp in ((16, 0.6), (4, 0.3), (1, 0.1)):
        small = rng.random((h // scale + 2, w // scale + 2, 3))
        ys = np.linspace(0, small.shape[0] - 1.001, h)
        xs = np.linspace(0, small.shape[1] - 1.001, w)
        y0 = np.floor(ys).astype(int)[:, None]
        x0 = np.floor(xs).astype(int)[None, :]
        ay = (ys[:, None] - y0)[..., None]
        ax = (xs[None, :] - x0)[..., None]
        img += amp * (
            small[y0, x0] * (1 - ay) * (1 - ax)
            + small[y0, x0 + 1] * (1 - ay) * ax
            + small[y0 + 1, x0] * ay * (1 - ax)
            + small[y0 + 1, x0 + 1] * ay * ax
        )
    return np.clip(img, 0, 1).astype(np.float32)


def warp(img, flow):
    """Bilinear inverse warp: out(p) = img(p + flow(p)), edge-clamped."""
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


def const_flow(h, w, u, v):
    gt = np.empty((h, w, 2), np.float32)
    gt[..., 0], gt[..., 1] = u, v
    return gt


def affine_flow(h, w, u0, v0, ux, uy, vx, vy):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack(
        [u0 + ux * xs / w + uy * ys / h, v0 + vx * xs / w + vy * ys / h], -1
    ).astype(np.float32)


def rotation_flow(h, w, deg, zoom=1.0):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = h / 2.0, w / 2.0
    th = np.deg2rad(deg)
    c, s = zoom * np.cos(th), zoom * np.sin(th)
    return np.stack(
        [(xs - cx) * (c - 1) - (ys - cy) * s, (xs - cx) * s + (ys - cy) * (c - 1)],
        -1,
    ).astype(np.float32)


def piecewise_flow(h, w, flows, rng):
    """Voronoi-style piecewise-constant field: motion discontinuities."""
    k = len(flows)
    cy = rng.uniform(0, h, k)
    cx = rng.uniform(0, w, k)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    d = (ys[None] - cy[:, None, None]) ** 2 + (xs[None] - cx[:, None, None]) ** 2
    lbl = np.argmin(d, 0)
    gt = np.zeros((h, w, 2), np.float32)
    for i, (u, v) in enumerate(flows):
        gt[lbl == i] = (u, v)
    return gt


def layered_flow(h, w, bg, fg, rng, n_boxes=3):
    """Background motion with foreground boxes moving differently."""
    gt = const_flow(h, w, *bg)
    for _ in range(n_boxes):
        bh = int(rng.uniform(0.15, 0.35) * h)
        bw = int(rng.uniform(0.1, 0.25) * w)
        y0 = rng.integers(0, h - bh)
        x0 = rng.integers(0, w - bw)
        gt[y0 : y0 + bh, x0 : x0 + bw] = fg
    return gt


def layered_scene(rng, h, w, bg_uv, fg_uv, n_boxes=3):
    """TRUE two-layer scene: independently-textured foreground boxes
    (integer motion) over a warped background, with real occlusion.

    Replaces the old single-texture construction (``warp`` with a
    discontinuous ``layered_flow`` field), which DUPLICATES texture:
    the frame-2 content a foreground box shows also remains visible at
    its background position, giving every foreground pixel two
    legitimate matches.  That ambiguity — not occlusion handling — is
    what the old layered cases actually measured (diagnosed 2026-08-19:
    forward matches split between the two copies, the strict LR check
    fragmented, and outlier removal culled the foreground wholesale).
    Independent per-box textures keep the match unique; the boxes'
    frame-2 positions genuinely occlude background.
    """
    bg2 = textured(rng, h, w)
    bg_flow = const_flow(h, w, *bg_uv)
    img2 = bg2.copy()
    img1 = warp(bg2, bg_flow)
    gt = bg_flow.copy()
    dx, dy = int(fg_uv[0]), int(fg_uv[1])
    for _ in range(n_boxes):
        bh = int(rng.uniform(0.15, 0.35) * h)
        bw = int(rng.uniform(0.1, 0.25) * w)
        patch = textured(rng, bh, bw)
        y0 = int(rng.integers(max(0, -dy), h - bh - max(0, dy)))
        x0 = int(rng.integers(max(0, -dx), w - bw - max(0, dx)))
        img1[y0 : y0 + bh, x0 : x0 + bw] = patch
        img2[y0 + dy : y0 + dy + bh, x0 + dx : x0 + dx + bw] = patch
        gt[y0 : y0 + bh, x0 : x0 + bw] = (dx, dy)
    return img1.astype(np.float32), img2.astype(np.float32), gt


def load_grove():
    """The bundled real Middlebury pair (the reference's own smoke input,
    main.cpp:56-57) — the only real-image data in this offline
    environment; EVAL.md documents the absence of network access."""
    from eppm.io import read_ppm

    f10 = read_ppm("/root/reference/frame10.ppm").astype(np.float32) / 255.0
    f11 = read_ppm("/root/reference/frame11.ppm").astype(np.float32) / 255.0
    return f10, f11


def layered_composite(bg2, fg_patch, y0, x0, dy, dx, bg_flow):
    """Two-layer scene with REAL occlusion semantics and exact GT.

    frame2 = bg2 with ``fg_patch`` pasted at (y0+dy, x0+dx);
    frame1 = warp(bg2, bg_flow) with ``fg_patch`` pasted at (y0, x0).
    GT(p) = (dx, dy) on the frame-1 foreground rectangle, else bg_flow.
    Background pixels covered by the foreground's frame-2 position are
    genuinely occluded (their GT is the background motion but no
    correspondence exists) — unlike single-layer ``warp`` synthesis,
    which stretches texture instead of occluding it.
    """
    h, w = bg2.shape[:2]
    ph, pw = fg_patch.shape[:2]
    img2 = bg2.copy()
    img2[y0 + dy : y0 + dy + ph, x0 + dx : x0 + dx + pw] = fg_patch
    img1 = warp(bg2, bg_flow)
    img1[y0 : y0 + ph, x0 : x0 + pw] = fg_patch
    gt = bg_flow.copy()
    gt[y0 : y0 + ph, x0 : x0 + pw] = (dx, dy)
    return img1.astype(np.float32), img2.astype(np.float32), gt


def save_pair(root, name, img1, img2, gt, kitti=False):
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    write_ppm(os.path.join(d, "frame10.ppm"),
              (img1 * 255 + 0.5).astype(np.uint8))
    write_ppm(os.path.join(d, "frame11.ppm"),
              (img2 * 255 + 0.5).astype(np.uint8))
    if kitti:
        write_kitti_flow(os.path.join(d, "flow10.png"), gt)
    else:
        write_flo(os.path.join(d, "flow10.flo"), gt)
    print(f"  {name}: {gt.shape[0]}x{gt.shape[1]}  "
          f"|gt| max {np.abs(gt).max():.1f}")


def save_seq(root, name, gt, rng, kitti=False):
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    h, w = gt.shape[:2]
    img2 = textured(rng, h, w)
    img1 = warp(img2, gt)
    write_ppm(os.path.join(d, "frame10.ppm"),
              (img1 * 255 + 0.5).astype(np.uint8))
    write_ppm(os.path.join(d, "frame11.ppm"),
              (img2 * 255 + 0.5).astype(np.uint8))
    if kitti:
        write_kitti_flow(os.path.join(d, "flow10.png"), gt)
    else:
        write_flo(os.path.join(d, "flow10.flo"), gt)
    print(f"  {name}: {h}x{w}  |gt| max {np.abs(gt).max():.1f}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="evalset")
    args = p.parse_args()
    rng = np.random.default_rng(20260817)

    mb = os.path.join(args.root, "middlebury_synth")
    h, w = 480, 640
    print("middlebury_synth (480x640):")
    save_seq(mb, "trans_small", const_flow(h, w, 3.2, 1.7), rng)
    save_seq(mb, "trans_mid", const_flow(h, w, 12.4, -7.8), rng)
    save_seq(mb, "trans_large", const_flow(h, w, 42.0, 13.0), rng)
    save_seq(mb, "affine", affine_flow(h, w, 4, -2, 6, -3, 0, 4), rng)
    save_seq(mb, "rotation", rotation_flow(h, w, 1.2), rng)
    save_seq(mb, "zoom", rotation_flow(h, w, 0.0, zoom=1.04), rng)
    save_seq(mb, "shear", affine_flow(h, w, 1, 1, 0, 9, 7, 0), rng)
    save_seq(
        mb, "piecewise",
        piecewise_flow(h, w, [(6, 2), (-9, 4), (2, -11), (15, 8)], rng), rng,
    )

    st = os.path.join(args.root, "sintel_stress")
    h, w = 436, 1024
    print("sintel_stress (436x1024):")
    save_seq(st, "large_disp_80", const_flow(h, w, 80.0, 24.0), rng)
    save_seq(st, "large_disp_120", const_flow(h, w, -120.0, 15.0), rng)
    img1, img2, gt = layered_scene(rng, h, w, (9.0, 3.0), (-70.0, 20.0))
    save_pair(st, "layered", img1, img2, gt)
    save_seq(
        st, "zoom_rot",
        rotation_flow(h, w, 2.5, zoom=1.06), rng,
    )

    kt = os.path.join(args.root, "kitti_fixtures")
    h, w = 375, 1242
    print("kitti_fixtures (375x1242, PNG16 ground truth):")
    save_seq(kt, "forward_35", affine_flow(h, w, 35, 2, -10, 3, 0, 1),
             rng, kitti=True)
    save_seq(kt, "forward_60", affine_flow(h, w, 60, 1, -22, 4, 0, 2),
             rng, kitti=True)
    save_seq(kt, "yaw", affine_flow(h, w, -28, 3, 14, -2, 1, 1),
             rng, kitti=True)
    img1, img2, gt = layered_scene(rng, h, w, (18.0, 1.0), (-45.0, 3.0))
    save_pair(kt, "layered_traffic", img1, img2, gt, kitti=True)
    rt = os.path.join(args.root, "real_texture")
    print("real_texture (480x640, frames built from the REAL Grove pair):")
    f10, f11 = load_grove()
    h, w = f11.shape[:2]
    # GT'd warps of the real frame: natural image statistics + exact GT
    save_pair(rt, "grove_trans", warp(f11, const_flow(h, w, 7.0, -4.0)),
              f11, const_flow(h, w, 7.0, -4.0))
    save_pair(rt, "grove_trans_large",
              warp(f11, const_flow(h, w, 44.0, 12.0)), f11,
              const_flow(h, w, 44.0, 12.0))
    aff = affine_flow(h, w, 4, -2, 6, -3, 0, 4)
    save_pair(rt, "grove_affine", warp(f11, aff), f11, aff)
    rot = rotation_flow(h, w, 1.2, zoom=1.03)
    save_pair(rt, "grove_rot_zoom", warp(f11, rot), f11, rot)
    # Layered occlusion from REAL crops: a Grove foliage patch moves over
    # the Grove background — true two-layer occlusion, not texture
    # stretch.  The crops are FLIPPED before pasting: a raw crop of
    # frame 10 still exists (nearly unchanged) in frame 11's background,
    # so an unflipped foreground has two legitimate matches in frame 2 —
    # a duplicated-texture ambiguity the flow is not supposed to resolve
    # (diagnosed 2026-08-19: the coarse matcher found both copies, the
    # strict LR check fragmented on the ambiguity, and outlier removal
    # culled the foreground wholesale).  Flipping keeps real image
    # statistics while making the foreground content unique.
    fg = np.flipud(np.fliplr(f10[60:180, 80:260])).copy()
    img1, img2, gt = layered_composite(
        f11, fg, 150, 240, 12, -34, const_flow(h, w, 5.0, 2.0)
    )
    save_pair(rt, "grove_layered", img1, img2, gt)
    fg2 = np.flipud(np.fliplr(f10[250:330, 380:520])).copy()
    img1, img2, gt = layered_composite(
        f11, fg2, 90, 70, -8, 26,
        affine_flow(h, w, 3, 1, 4, -2, 0, 2),
    )
    save_pair(rt, "grove_layered_affine", img1, img2, gt)

    print("done ->", args.root)


if __name__ == "__main__":
    main()
