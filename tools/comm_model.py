#!/usr/bin/env python
"""Analytic communication accounting for the sharded pipeline.

Models the scaling question (BASELINE north star: >=80% scaling
efficiency across devices) from the program's own traffic:
per fine level, every halo exchange the sharded pipeline
(eppm/parallel/sharded.py) performs is enumerated with its ring
width, and the bytes each device moves over the interconnect are
computed from the
strip sizes ppermute actually sends (halo_exchange_1d exchanges halo
strips, not whole tiles, so traffic scales with the tile BOUNDARY while
compute scales with its AREA).

Model (per device, per frame pair, fine levels only — the coarse level
is replicated and exchanges nothing):

  upsample      1-px flow ring                       (sharded.py)
  refine pass k (G+1)-px flow ring, G = roundup(max(r+tmax, R), 8)
  smoothing     blf_radius flow ring

A ring of width k on an (th, tw) tile with C channels moves
  y:  2 * k * tw * C * 4 bytes
  x:  2 * k * (th + 2k) * C * 4 bytes   (x runs on the y-extended tile)
with the boundary shards sending one-sided.  Compute volume is estimated
from the dense-refine tap count (the dominant term:
(2r+1)^2 candidates x plane tables x 100 taps x ~16 f32 ops per tap).

Scaling efficiency model: eff = t_comp / (t_comp + t_comm) assuming no
overlap (pessimistic), with per-device compute throughput and link
bandwidth as parameters.  Defaults are the published H100 SXM figures
(NVIDIA H100 data sheet, 700 W): 67 TFLOP/s float32 outside the tensor
cores, and NVLink 900 GB/s per card, 450 GB/s each way.  They are
published peaks, not measurements of this program.

Usage:  python tools/comm_model.py            # table for the BASELINE configs
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from eppm.config import DEFAULT_CONFIG, EPPMConfig


def ring_bytes(th, tw, k, ch, dtype_bytes=4):
    """Bytes one device sends for a k-wide 2D ring exchange."""
    y = 2 * k * tw * ch * dtype_bytes
    x = 2 * k * (th + 2 * k) * ch * dtype_bytes
    return y + x


def refine_halo(cfg: EPPMConfig) -> int:
    """G+1: the flow-ring width of one dense refine pass (sharded.py)."""
    from eppm.ops.cost import plane_offsets

    tmax = max(
        max(abs(i), abs(j))
        for tbl in plane_offsets(cfg.cost)
        for (i, j) in tbl
    )
    reach = max(cfg.dense_search_radius + tmax, cfg.cost.patch_radius)
    return -(-reach // 8) * 8 + 1


def halo_traffic(h, w, cfg: EPPMConfig, ny, nx):
    """Per-device halo bytes per frame pair, itemized per stage."""
    dims = cfg.pyramid.level_dims(h, w)
    top = len(dims) - 1
    g1 = refine_halo(cfg)
    rb = cfg.refine.blf_radius
    items = []
    for lvl in range(top - 1, -1, -1):
        lh, lw = dims[lvl]
        th, tw = lh // ny, lw // nx
        if lvl != top - 1:
            # the first upsample slices from the REPLICATED coarse flow —
            # no exchange (sharded.py _pair_flow_tiled)
            ph, pw = dims[lvl + 1]
            items.append(
                (f"L{lvl} upsample", ring_bytes(ph // ny, pw // nx, 1, 2))
            )
        for p in range(cfg.dense_refine_passes):
            items.append(
                (f"L{lvl} refine pass{p + 1}", ring_bytes(th, tw, g1, 2))
            )
        items.append((f"L{lvl} smoothing", ring_bytes(th, tw, rb, 2)))
    # final extra L0 smoothing (reference .cpp:289; sharded.py returns
    # smooth_tile(flow_tile, 0, ...) after the loop)
    th, tw = dims[0][0] // ny, dims[0][1] // nx
    items.append(("L0 final smoothing", ring_bytes(th, tw, rb, 2)))
    return items


def compute_flops(h, w, cfg: EPPMConfig, ny, nx):
    """Rough per-device FLOP count of the sharded fine levels (dense
    refine dominates; smoothing adds its window)."""
    dims = cfg.pyramid.level_dims(h, w)
    top = len(dims) - 1
    n_taps = len(cfg.cost.tap_offsets)
    r = cfg.dense_search_radius
    cands = (2 * r + 1) ** 2
    flops = 0.0
    for lvl in range(top - 1, -1, -1):
        lh, lw = dims[lvl]
        px = (lh // ny) * (lw // nx)
        # pass 1 evaluates 4 plane tables, later passes fronto-only
        tables = 4 + (cfg.dense_refine_passes - 1) * 1
        flops += px * cands * tables * n_taps * 16.0
        d = 2 * cfg.refine.blf_radius + 1
        flops += px * d * d * 12.0  # joint-bilateral smoothing
    return flops


def efficiency(h, w, cfg, ny, nx, flops_per_s, link_bytes_per_s):
    items = halo_traffic(h, w, cfg, ny, nx)
    comm = sum(b for _, b in items)
    comp = compute_flops(h, w, cfg, ny, nx)
    t_comm = comm / link_bytes_per_s
    t_comp = comp / flops_per_s
    return comp, comm, t_comp, t_comm, t_comp / (t_comp + t_comm)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--flops", type=float, default=67e12,
                   help="per-device FLOP/s (default: H100 SXM float32)")
    p.add_argument("--link", type=float, default=450e9,
                   help="link bytes/s each way (default: H100 NVLink)")
    p.add_argument("--detail", action="store_true")
    args = p.parse_args()
    cfg = DEFAULT_CONFIG

    configs = [
        ("Grove 640x480", 480, 640, 1, 2),
        ("Grove 640x480", 480, 640, 2, 2),
        ("KITTI 1242x375 (padded 376x1244)", 376, 1244, 2, 2),
        ("1080p", 1080, 1920, 2, 2),
        ("1080p", 1080, 1920, 2, 4),
        ("4K", 2160, 3840, 2, 4),
        ("4K", 2160, 3840, 4, 4),
    ]
    print(f"{'config':36s} {'mesh':7s} {'comm/dev':>10s} {'comp/dev':>12s} "
          f"{'t_comm':>8s} {'t_comp':>8s} {'eff':>6s}")
    for name, h, w, ny, nx in configs:
        comp, comm, t_comp, t_comm, eff = efficiency(
            h, w, cfg, ny, nx, args.flops, args.link
        )
        print(f"{name:36s} {ny}x{nx:<5d} {comm / 1e6:9.2f}M "
              f"{comp / 1e9:10.2f}G {t_comm * 1e3:7.3f}ms "
              f"{t_comp * 1e3:7.2f}ms {eff:6.1%}")
        if args.detail:
            for stage, b in halo_traffic(h, w, cfg, ny, nx):
                print(f"    {stage:24s} {b / 1e3:10.1f} KB")


if __name__ == "__main__":
    main()
