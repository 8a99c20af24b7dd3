"""Multi-chip EPPM: batched frame pairs + spatial frame tiles over a
device mesh.

The reference is a single-process single-GPU program (SURVEY.md section
2.7); this module adds a distributed axis, following
the scaling-book recipe: pick a mesh, shard with ``shard_map``, move data
with explicit collectives.

Design
------
Mesh axes ``("batch", "y", "x")``:

  * ``batch`` — data parallelism over frame pairs (embarrassingly
    parallel; zero communication).
  * ``y``/``x`` — spatial tiling of each frame within a pair.

Per pair, the work splits sharply by level:

  * **Coarsest level** (e.g. 480x270 for 4K input) is tiny — PatchMatch +
    the refinement chain run *replicated* on every device of the (y, x)
    submesh.  Replicated compute on small data beats paying latency-bound
    collectives per PatchMatch sweep; all devices hold identical coarse
    flow afterwards (same seed, same data -> bitwise identical).
  * **Fine levels** carry ~95% of the FLOPs (3x3 plane-fitting re-search +
    radius-10 joint-bilateral smoothing at full resolution).  These shard
    over (y, x): each device refines its tile, exchanging halos of the
    *flow state* with ``jax.lax.ppermute`` between stages (halo 1 before
    tile upsampling, blf-radius before smoothing).  Image pyramids stay
    replicated across (y, x) — frame-2 gathers at PatchMatch targets are
    unbounded, and never moving image data is the bandwidth-optimal
    choice; flow rings are the only steady-state traffic.

Alignment requirement: every pyramid level's dims must be divisible by
(ny, nx) and halve exactly between levels — ``check_tileable`` validates.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import DEFAULT_CONFIG, EPPMConfig, UNKNOWN_FLOW
from ..ops.dense import dense_refine_flow, median3_flow, warp_pack
from ..ops.match import match_coarse_bidi
from ..ops.patchmatch import patchmatch
from ..ops.refine import (
    blf_refine_flow,
    coarse_occlusion_reconstruct,
    flow_smoothing,
    lr_check,
    nnf_to_flow,
    outlier_removal,
)
from ..ops.resize import bilinear_resize
from ..pipeline import _coarse_init, prepare_pyramids
from .halo import halo_exchange_2d

__all__ = [
    "make_mesh", "check_tileable", "pad_to_tileable", "compute_flow_sharded",
]


def make_mesh(
    batch: int = 1, y: int = 1, x: int = 1, devices=None
) -> Mesh:
    """Build a ("batch", "y", "x") mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    n = batch * y * x
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(batch, y, x)
    return Mesh(dev, ("batch", "y", "x"))


def check_tileable(h: int, w: int, cfg: EPPMConfig, ny: int, nx: int) -> None:
    dims = cfg.pyramid.level_dims(h, w)
    for i, (lh, lw) in enumerate(dims):
        if lh % ny or lw % nx:
            raise ValueError(
                f"level {i} dims {lh}x{lw} not divisible by mesh ({ny},{nx})"
            )
        if i + 1 < len(dims):
            nh, nw = dims[i + 1]
            if lh != 2 * nh or lw != 2 * nw:
                raise ValueError(
                    f"levels must halve exactly for aligned tiles; got "
                    f"{lh}x{lw} -> {nh}x{nw} (pad inputs to a multiple of "
                    f"{2 ** (len(dims) - 1)})"
                )


def pad_to_tileable(
    h: int, w: int, cfg: EPPMConfig, ny: int, nx: int
) -> Tuple[int, int]:
    """Smallest (H, W) >= (h, w) that ``check_tileable`` accepts.

    With the truncating level solver (PyramidConfig.level_dims), a
    dimension that is a multiple of ``2^(depth-1) * n`` halves exactly at
    every level and every level stays divisible by the mesh axis, so the
    padded shape satisfies both tileability conditions.  Covers the
    arbitrary-resolution BASELINE configs (KITTI 1242x375 etc.) that no
    power-of-two constraint fits.  Iterates because padding can itself
    raise the auto-deepened effective depth (PyramidConfig.depth).
    """
    ph, pw = h, w
    for _ in range(4):  # depth(h, w) is monotone in (h, w); converges fast
        d = cfg.pyramid.depth(ph, pw)
        qy = ny * 2 ** (d - 1)
        qx = nx * 2 ** (d - 1)
        nph, npw = (-(-h // qy)) * qy, (-(-w // qx)) * qx
        if (nph, npw) == (ph, pw) and cfg.pyramid.depth(nph, npw) == d:
            break
        ph, pw = nph, npw
    return ph, pw


def _slice_tile_haloed(full, y0, x0, th, tw, halo, mode="edge"):
    """Tile + halo from a replicated full array, globally clamped edges."""
    if full.ndim == 2:
        full = full[..., None]
        squeeze = True
    else:
        squeeze = False
    if halo:
        if mode == "edge":
            padded = jnp.pad(
                full, ((halo, halo), (halo, halo), (0, 0)), mode="edge"
            )
        else:
            padded = jnp.pad(
                full, ((halo, halo), (halo, halo), (0, 0)),
                constant_values=mode,
            )
    else:
        padded = full
    out = jax.lax.dynamic_slice(
        padded, (y0, x0, 0), (th + 2 * halo, tw + 2 * halo, full.shape[2])
    )
    return out[..., 0] if squeeze else out


def _clamp_to_frame(ext, oy, ox, h, w):
    """Replace the positions of ``ext`` (top-left at global (oy, ox))
    that lie beyond the global (h, w) frame with the value at the
    clamped in-frame position — the edge padding a single-chip stage
    applies to its output."""
    ry = jnp.clip(jnp.arange(ext.shape[0]) + oy, 0, h - 1) - oy
    rx = jnp.clip(jnp.arange(ext.shape[1]) + ox, 0, w - 1) - ox
    return jnp.take(jnp.take(ext, ry, axis=0), rx, axis=1)


def _pair_flow_tiled(
    img1, img2, key, cfg: EPPMConfig, ny: int, nx: int, init_flow=None
):
    """Per-pair flow, running inside shard_map on the (y, x) submesh.

    img1/img2 are full frames (replicated over y/x).  Returns this
    device's (tile_h, tile_w, 2) shard of the full-resolution flow.

    ``init_flow`` is the temporal warm start (full-res, replicated like
    the frames) — the coarse level is replicated, so it feeds
    ``match_coarse`` exactly as on a single chip (forward as-is,
    backward negated).  The PatchMatch engine ignores it.
    """
    k_fwd, k_bwd = jax.random.split(key)
    levels1, packs1 = prepare_pyramids(img1, cfg)
    levels2, packs2 = prepare_pyramids(img2, cfg)
    top = len(packs1) - 1

    # ---- coarsest level: replicated (identical on all (y,x) devices) ----
    if cfg.match_engine == "dense":
        ci = None
        if init_flow is not None:
            ch, cw = packs1[top].shape[0], packs1[top].shape[1]
            ci = _coarse_init(init_flow, ch, cw, cfg)
        (tx1, ty1, c1), (tx2, ty2, c2) = match_coarse_bidi(
            levels1[top], levels2[top], cfg.cost, cfg.match,
            cfg.cost_tap_chunk, packs1[top], packs2[top],
            init_flow=ci,
        )
    else:
        tx1, ty1, c1 = patchmatch(
            packs1[top], packs2[top], k_fwd, cfg.patchmatch, cfg.cost,
            cfg.cost_tap_chunk,
        )
        tx2, ty2, c2 = patchmatch(
            packs2[top], packs1[top], k_bwd, cfg.patchmatch, cfg.cost,
            cfg.cost_tap_chunk,
        )
    otx, oty = tx1, ty1  # pre-LR matches: arbitration candidates
    tx1, ty1, c1, tx2, ty2, c2 = lr_check(
        tx1, ty1, c1, tx2, ty2, c2, cfg.lr_thresh
    )
    tx1, ty1, c1 = outlier_removal(tx1, ty1, c1, cfg.refine)
    tx1, ty1 = coarse_occlusion_reconstruct(
        tx1, ty1, levels1[top], cfg.refine,
        packs=(packs1[top], packs2[top]), cost_cfg=cfg.cost,
        orig=(otx, oty),
    )
    flow_full = nnf_to_flow(tx1, ty1)  # replicated coarse flow

    # ---- fine levels: sharded over (y, x) with ppermute halo exchange ----
    iy = jax.lax.axis_index("y")
    ix = jax.lax.axis_index("x")
    R = cfg.cost.patch_radius
    rb = cfg.refine.blf_radius
    ratio_up = 1.0 / cfg.pyramid.ratio
    flow_tile = None

    def smooth_tile(flow_tile, lvl, y0, x0, th, tw):
        flow_h = halo_exchange_2d(flow_tile, rb, boundary=UNKNOWN_FLOW)
        img_h = _slice_tile_haloed(levels1[lvl], y0, x0, th, tw, rb)
        sm = flow_smoothing(flow_h, img_h, cfg.refine)
        return sm[rb:-rb, rb:-rb]

    for lvl in range(top - 1, -1, -1):
        H, W = packs1[lvl].shape[0], packs1[lvl].shape[1]
        th, tw = H // ny, W // nx
        y0 = iy * th
        x0 = ix * tw
        # Upsample halo uses edge fill: the reference's resize *clamps*
        # taps at the global border (unlike smoothing, which skips them),
        # and coarse flow has no unknowns left after hole filling.
        if flow_tile is None:
            # previous flow is replicated: slice tile+1 halo directly
            ph, pw = packs1[lvl + 1].shape[0], packs1[lvl + 1].shape[1]
            pth, ptw = ph // ny, pw // nx
            prev_h = _slice_tile_haloed(
                flow_full, iy * pth, ix * ptw, pth, ptw, 1
            )
        else:
            prev_h = halo_exchange_2d(flow_tile, 1, boundary="edge")
        flow_tile = (
            bilinear_resize(prev_h, th, tw, ratio_up, shift=1) * ratio_up
        )
        if cfg.refine_impl == "dense":
            # Warp + residual search on a tile extended by halo G so the
            # cropped interior is bitwise-equal to the single-chip result:
            # taps on the warped frame reach cmax + tmax px (candidate
            # radius + max plane-warped tap offset) and the warp reads the
            # full replicated frame 2 at global (clamped) coordinates.
            # Each pass re-exchanges the flow halo (iterative warping
            # needs fresh neighbor state).
            from ..ops.cost import plane_offsets

            tmax = max(
                max(abs(i), abs(j))
                for tbl in plane_offsets(cfg.cost)
                for (i, j) in tbl
            )
            reach = max(cfg.dense_search_radius + tmax, cfg.cost.patch_radius)
            G = -(-reach // 8) * 8

            def refine_tile(ft, med: bool, sub: bool = False):
                fh = halo_exchange_2d(ft, G + 1, boundary="edge")
                if med:
                    # beyond the frame border the single-chip warp reads
                    # the median at the clamped position, not a median
                    # of edge copies
                    fh = _clamp_to_frame(
                        median3_flow(fh), y0 - G - 1, x0 - G - 1, H, W
                    )
                fh = fh[1:-1, 1:-1]
                p1h = _slice_tile_haloed(packs1[lvl], y0, x0, th, tw, G)
                ext = dense_refine_flow(
                    fh, p1h, packs2[lvl],
                    cfg.pass2_cost if med else cfg.cost,
                    cfg.dense_search_radius,
                    cfg.dense_pass2_planes if med else cfg.dense_pass1_planes,
                    cfg.cost_tap_chunk, origin=(y0 - G, x0 - G),
                    cand_shape=(
                        cfg.pass2_cand_shape if med else cfg.dense_cand_shape
                    ),
                    subpixel_fit=sub,
                    gather_dtype=cfg.warp_dtype,
                    subpixel_min_curv=cfg.dense_subpixel_min_curv,
                )
                return ext[G:-G, G:-G]

            # Subpixel parabola only on the last pass of level 0 (see
            # pipeline.compute_flow)
            n = cfg.dense_refine_passes
            fit = cfg.dense_subpixel_fit and lvl == 0
            flow_tile = refine_tile(flow_tile, med=False, sub=fit and n == 1)
            for i in range(n - 1):
                flow_tile = refine_tile(
                    flow_tile, med=True, sub=fit and i == n - 2
                )
        else:
            pack1_tile = _slice_tile_haloed(packs1[lvl], y0, x0, th, tw, R)
            flow_tile = blf_refine_flow(
                flow_tile, pack1_tile, packs2[lvl], cfg.cost,
                cfg.cost_tap_chunk, origin=(y0, x0), pack1_halo=R,
            )
        flow_tile = smooth_tile(flow_tile, lvl, y0, x0, th, tw)

    if top == 0:
        # single-level pyramid: shard the final smoothing only
        th, tw = flow_full.shape[0] // ny, flow_full.shape[1] // nx
        y0, x0 = iy * th, ix * tw
        flow_tile = jax.lax.dynamic_slice(flow_full, (y0, x0, 0), (th, tw, 2))
        return smooth_tile(flow_tile, 0, y0, x0, th, tw)

    th, tw = packs1[0].shape[0] // ny, packs1[0].shape[1] // nx
    return smooth_tile(flow_tile, 0, iy * th, ix * tw, th, tw)


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def _compute_flow_sharded_jit(imgs1, imgs2, keys, cfg, mesh):
    ny = mesh.shape["y"]
    nx = mesh.shape["x"]

    def shard_fn(imgs1, imgs2, keys):
        # local batch of pairs; frames replicated over (y, x)
        def one(img1, img2, key):
            return _pair_flow_tiled(img1, img2, key, cfg, ny, nx)

        return jax.vmap(one)(imgs1, imgs2, keys)

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P("batch", None, None, None),
            P("batch", None, None, None),
            P("batch", None),
        ),
        out_specs=P("batch", "y", "x", None),
        check_vma=False,
    )
    return fn(imgs1, imgs2, keys)


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def _compute_flow_sharded_init_jit(imgs1, imgs2, keys, init_flows, cfg, mesh):
    """Warm-started variant: init_flows (B, H, W, 2), replicated over
    (y, x) like the frames themselves."""
    ny = mesh.shape["y"]
    nx = mesh.shape["x"]

    def shard_fn(imgs1, imgs2, keys, init_flows):
        def one(img1, img2, key, init_flow):
            return _pair_flow_tiled(img1, img2, key, cfg, ny, nx, init_flow)

        return jax.vmap(one)(imgs1, imgs2, keys, init_flows)

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P("batch", None, None, None),
            P("batch", None, None, None),
            P("batch", None),
            P("batch", None, None, None),
        ),
        out_specs=P("batch", "y", "x", None),
        check_vma=False,
    )
    return fn(imgs1, imgs2, keys, init_flows)


def compute_flow_sharded(
    imgs1: jnp.ndarray,
    imgs2: jnp.ndarray,
    mesh: Mesh,
    cfg: EPPMConfig = DEFAULT_CONFIG,
    keys: Optional[jnp.ndarray] = None,
    pad_to_fit: bool = True,
    init_flows: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Dense flow for a batch of pairs, sharded over ``mesh``.

    imgs1/imgs2: (B, H, W, 3); B divisible by mesh 'batch'.  Returns
    (B, H, W, 2) flow laid out with sharding P('batch', 'y', 'x').

    ``init_flows`` (B, H, W, 2): optional temporal warm start per pair
    (the previous pair's flow when streaming video) — same semantics as
    ``compute_flow_jit(init_flow=...)``; see MatchConfig.

    Arbitrary resolutions: when (H, W) is not tileable over the mesh
    (``check_tileable``), the frames are edge-padded bottom/right to
    ``pad_to_tileable`` dims, computed, and the flow cropped back.
    Pixels within a patch radius of the bottom/right border then see
    replicated-edge texture instead of the clamp-at-border reads of an
    unpadded run — the same class of boundary approximation the
    reference's texture clamping already makes.  ``pad_to_fit=False``
    restores the strict behavior (raise on non-tileable shapes).
    """
    B, h, w = imgs1.shape[0], imgs1.shape[1], imgs1.shape[2]
    nb = mesh.shape["batch"]
    ny, nx = mesh.shape["y"], mesh.shape["x"]
    if B % nb:
        raise ValueError(f"batch {B} not divisible by mesh batch {nb}")
    try:
        check_tileable(h, w, cfg, ny, nx)
    except ValueError:
        if not pad_to_fit:
            raise
        ph, pw = pad_to_tileable(h, w, cfg, ny, nx)
        pad = ((0, 0), (0, ph - h), (0, pw - w), (0, 0))
        imgs1 = jnp.pad(imgs1, pad, mode="edge")
        imgs2 = jnp.pad(imgs2, pad, mode="edge")
        if init_flows is not None:
            init_flows = jnp.pad(init_flows, pad, mode="edge")
    if keys is None:
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.PRNGKey(cfg.seed), jnp.arange(B)
        )
    if init_flows is not None:
        out = _compute_flow_sharded_init_jit(
            imgs1, imgs2, keys, init_flows, cfg, mesh
        )
    else:
        out = _compute_flow_sharded_jit(imgs1, imgs2, keys, cfg, mesh)
    return out[:, :h, :w]
