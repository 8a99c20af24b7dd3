"""The full EPPM optical-flow pipeline as one jitted pure function.

Spec source: ``bao_flow_patchmatch_multiscale_cuda::compute_flow``
(bao_flow_patchmatch_multiscale_cuda.cpp:217-315) and ``_prepare_data``
(:212-215).  Default-path stage order, faithfully reproduced:

  prepare (refine_kernel.cu:1059-1071):
    Gaussian pre-smooth (sigma .5, r 2) -> Gaussian pyramid (3 levels,
    ratio .5) -> census transform per level
  coarsest level (.cpp:223-258):
    PatchMatch fwd + bwd -> left-right check (both dirs) -> outlier
    removal -> weighted median filter (20 iters, occlusions only) ->
    hole fill -> NNF-to-flow
  each finer level (.cpp:275-282):
    bilinear upsample x2 + scale x2 -> 3x3 plane-fitting cost re-search
    (baoCudaBLF_C2F, refine_kernel.cu:1076-1087) -> joint-bilateral flow
    smoothing
  level 0 (.cpp:289): one extra joint-bilateral smoothing

Fidelity note: the reference also calls the WMF on
``m_disp_vec1_pyramid[nlayer]`` inside the fine-level loop (.cpp:281), but
at fine levels that buffer holds uninitialized device memory (only the
coarsest level is ever written, .cpp:223) and its output is never read —
the call is dead.  We omit it by default and offer ``fine_level_wmf=True``
to run what the author apparently intended (flow -> NNF -> one full-image
WMF pass -> flow).

Unlike the reference — which crosses host<->device three times and runs ~40
kernel launches — the whole pipeline here is a single XLA program: one
``jit``, zero intermediate host transfers (SURVEY.md section 3.3).
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from .config import DEFAULT_CONFIG, EPPMConfig
from .ops.census import census_transform
from .ops.cost import pack_frame
from .ops.dense import dense_refine_flow, median3_flow
from .ops.match import match_coarse_bidi
from .ops.patchmatch import patchmatch
from .ops.refine import (
    blf_refine_flow,
    coarse_occlusion_reconstruct,
    flow_smoothing,
    flow_to_nnf,
    lr_check,
    nnf_to_flow,
    outlier_removal,
    weighted_median_filter,
)
from .ops.resize import bilinear_resize, gaussian_filter, gaussian_pyramid

__all__ = ["prepare_pyramids", "compute_flow", "compute_flow_jit", "EPPMFlow"]


def _normalize(img: jnp.ndarray) -> jnp.ndarray:
    """uint8 [0,255] or float [0,1] -> float32 [0,1] (the reference reads
    uchar4 textures in normalized-float mode, bao_pmflow_kernel.cu:36-37)."""
    if img.dtype == jnp.uint8:
        return img.astype(jnp.float32) / 255.0
    return img.astype(jnp.float32)


@jax.named_scope("prepare")
def prepare_pyramids(
    img: jnp.ndarray, cfg: EPPMConfig
) -> Tuple[List[jnp.ndarray], List[jnp.ndarray]]:
    """Pre-smooth, build the Gaussian pyramid, census-transform each level,
    and pack (rgb, census) frames (baoCudaPatchMatchMultiscalePrepare,
    refine_kernel.cu:1059-1071).  Returns (image levels, packed levels)."""
    img = _normalize(img)
    h, w = img.shape[0], img.shape[1]
    dims = cfg.pyramid.level_dims(h, w)
    smoothed = gaussian_filter(
        img, cfg.pyramid.presmooth_sigma, cfg.pyramid.presmooth_radius
    )
    levels = gaussian_pyramid(smoothed, dims, cfg.pyramid.ratio)
    packs = [pack_frame(lv, census_transform(lv)) for lv in levels]
    return levels, packs


def _coarse_init(init_flow, ch, cw, cfg):
    """Resize a full-resolution temporal init flow to the coarse level
    (values scale with the resolution ratio)."""
    h = init_flow.shape[0]
    r = ch / h
    return bilinear_resize(init_flow, ch, cw, r) * r


def compute_flow(
    img1: jnp.ndarray,
    img2: jnp.ndarray,
    key: Optional[jax.Array] = None,
    cfg: EPPMConfig = DEFAULT_CONFIG,
    fine_level_wmf: bool = False,
    init_flow: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Dense flow frame1 -> frame2 for an (H, W, 3) pair; returns (H, W, 2).

    ``key`` defaults to PRNGKey(cfg.seed), mirroring the reference's fixed
    cuRAND seed 1234 (bao_pmflow_kernel.cu:68) — results are deterministic.

    ``init_flow`` (H, W, 2) is an optional temporal warm start — the
    previous pair's flow when streaming video — used by the dense coarse
    matcher (forward as-is, backward negated; see MatchConfig).  The
    PatchMatch engine ignores it (its random-init search structure is the
    reference's, kept bit-faithful).
    """
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    k_fwd, k_bwd = jax.random.split(key)

    levels1, packs1 = prepare_pyramids(img1, cfg)
    levels2, packs2 = prepare_pyramids(img2, cfg)
    top = len(packs1) - 1

    # --- coarsest level: bidirectional matching (+ refinement) ---
    if cfg.match_engine == "dense":
        ci = None
        if init_flow is not None:
            ch, cw = packs1[top].shape[0], packs1[top].shape[1]
            ci = _coarse_init(init_flow, ch, cw, cfg)
        # Both directions in one bidirectional matcher: the mini-
        # pyramids, descriptor builds, and the global N^2 score sweep
        # are shared (ops/match.py match_coarse_bidi).
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
    flow = nnf_to_flow(tx1, ty1)

    # --- coarse-to-fine (.cpp:275-289) ---
    ratio_up = 1.0 / cfg.pyramid.ratio
    for lvl in range(top - 1, -1, -1):
        oh, ow = packs1[lvl].shape[0], packs1[lvl].shape[1]
        flow = bilinear_resize(flow, oh, ow, ratio_up) * ratio_up
        if cfg.refine_impl == "dense":
            # Subpixel parabola only on the very last refine pass (level
            # 0): fractional offsets fed back into earlier iterative-
            # warping passes destabilize them (measured: mean EPE 0.520
            # per-pass vs 0.348 off) — it is a terminal polish.
            n = cfg.dense_refine_passes
            fit = cfg.dense_subpixel_fit and lvl == 0
            flow = dense_refine_flow(
                flow, packs1[lvl], packs2[lvl], cfg.cost,
                cfg.dense_search_radius, cfg.dense_pass1_planes,
                cfg.cost_tap_chunk, cand_shape=cfg.dense_cand_shape,
                subpixel_fit=fit and n == 1,
                gather_dtype=cfg.warp_dtype,
                subpixel_min_curv=cfg.dense_subpixel_min_curv,
            )
            for i in range(n - 1):
                flow = dense_refine_flow(
                    median3_flow(flow), packs1[lvl], packs2[lvl],
                    cfg.pass2_cost,
                    cfg.dense_search_radius, cfg.dense_pass2_planes,
                    cfg.cost_tap_chunk, cand_shape=cfg.pass2_cand_shape,
                    subpixel_fit=fit and i == n - 2,
                    gather_dtype=cfg.warp_dtype,
                    subpixel_min_curv=cfg.dense_subpixel_min_curv,
                )
        else:
            flow = blf_refine_flow(
                flow, packs1[lvl], packs2[lvl], cfg.cost, cfg.cost_tap_chunk
            )
        flow = flow_smoothing(flow, levels1[lvl], cfg.refine)
        if fine_level_wmf:
            ftx, fty = flow_to_nnf(flow)
            ftx, fty = weighted_median_filter(
                ftx, fty, levels1[lvl], cfg.refine, num_iter=1,
                only_occlusion=False,
            )
            flow = nnf_to_flow(ftx, fty)

    if cfg.subpixel_refine:
        from .ops.subpixel import subpixel_refine

        flow = subpixel_refine(
            flow, levels1[0], levels2[0], cfg.subpixel, cfg.cost_tap_chunk
        )
    flow = flow_smoothing(flow, levels1[0], cfg.refine)
    return flow


# whole-pipeline jit; cfg/fine_level_wmf are compile-time
_compute_flow_one_program = jax.jit(
    compute_flow, static_argnames=("cfg", "fine_level_wmf")
)


@partial(jax.jit, static_argnames=("cfg",))
def _prep_stage(img, cfg):
    levels, packs = prepare_pyramids(img, cfg)
    return tuple(levels), tuple(packs)


@partial(jax.jit, static_argnames=("cfg",))
def _match_stage_bidi(lvl1, lvl2, pk1, pk2, key, cfg, init_flow=None):
    """Both match directions in one staged program.  The dense engine
    shares pyramids/descriptors/global sweep (match_coarse_bidi); the
    PatchMatch engine runs its two independent searches."""
    if cfg.match_engine == "dense":
        return match_coarse_bidi(
            lvl1, lvl2, cfg.cost, cfg.match, cfg.cost_tap_chunk, pk1, pk2,
            init_flow=init_flow,
        )
    k_fwd, k_bwd = jax.random.split(key)
    m1 = patchmatch(
        pk1, pk2, k_fwd, cfg.patchmatch, cfg.cost, cfg.cost_tap_chunk
    )
    m2 = patchmatch(
        pk2, pk1, k_bwd, cfg.patchmatch, cfg.cost, cfg.cost_tap_chunk
    )
    return m1, m2


@partial(jax.jit, static_argnames=("cfg",))
def _coarse_refine_stage(m1, m2, img_top, cfg, pack_top1=None,
                         pack_top2=None):
    tx1, ty1, c1 = m1
    tx2, ty2, c2 = m2
    otx, oty = tx1, ty1  # pre-LR matches: arbitration candidates
    tx1, ty1, c1, tx2, ty2, c2 = lr_check(
        tx1, ty1, c1, tx2, ty2, c2, cfg.lr_thresh
    )
    tx1, ty1, c1 = outlier_removal(tx1, ty1, c1, cfg.refine)
    packs = (
        (pack_top1, pack_top2) if pack_top1 is not None else None
    )
    tx1, ty1 = coarse_occlusion_reconstruct(
        tx1, ty1, img_top, cfg.refine,
        packs=packs, cost_cfg=cfg.cost, orig=(otx, oty),
    )
    return nnf_to_flow(tx1, ty1)


@partial(jax.jit, static_argnames=("cfg", "oh", "ow", "med", "sub"))
def _refine_pass_stage(flow, pack1, pack2, cfg, oh, ow, med, sub=False):
    if oh != flow.shape[0]:
        flow = bilinear_resize(
            flow, oh, ow, 1.0 / cfg.pyramid.ratio
        ) * (1.0 / cfg.pyramid.ratio)
    if cfg.refine_impl != "dense":
        return blf_refine_flow(
            flow, pack1, pack2, cfg.cost, cfg.cost_tap_chunk
        )
    if med:
        flow = median3_flow(flow)
    return dense_refine_flow(
        flow, pack1, pack2, cfg.pass2_cost if med else cfg.cost,
        cfg.dense_search_radius,
        cfg.dense_pass2_planes if med else cfg.dense_pass1_planes,
        cfg.cost_tap_chunk,
        cand_shape=cfg.pass2_cand_shape if med else cfg.dense_cand_shape,
        subpixel_fit=sub,
        gather_dtype=cfg.warp_dtype,
        subpixel_min_curv=cfg.dense_subpixel_min_curv,
    )


@partial(jax.jit, static_argnames=("cfg",))
def _smooth_stage(flow, img, cfg):
    return flow_smoothing(flow, img, cfg.refine)


@partial(jax.jit, static_argnames=("cfg",))
def _fine_wmf_stage(flow, img, cfg):
    ftx, fty = flow_to_nnf(flow)
    ftx, fty = weighted_median_filter(
        ftx, fty, img, cfg.refine, num_iter=1, only_occlusion=False
    )
    return nnf_to_flow(ftx, fty)


@partial(jax.jit, static_argnames=("cfg",))
def _subpixel_stage(flow, lvl1, lvl2, cfg):
    from .ops.subpixel import subpixel_refine

    return subpixel_refine(
        flow, lvl1, lvl2, cfg.subpixel, cfg.cost_tap_chunk
    )


# Above this many pixels the pipeline executes as staged programs (~20
# jitted stages per pair; arrays stay on the device between them, so
# staging costs host dispatch only).  Kept pending a staged-vs-one-program
# head-to-head on the card (tools/measure_staging.py; ROADMAP A5).
STAGED_PIPELINE_THRESHOLD = 1_000_000


@partial(jax.jit, static_argnames=("ch", "cw", "cfg"))
def _coarse_init_stage(init_flow, ch, cw, cfg):
    return _coarse_init(init_flow, ch, cw, cfg)


def compute_flow_jit(img1, img2, key=None, cfg=DEFAULT_CONFIG,
                     fine_level_wmf: bool = False, init_flow=None):
    """Jitted pipeline entry point.

    Single XLA program for typical sizes; staged programs above
    STAGED_PIPELINE_THRESHOLD pixels (see note there).  The staged path
    covers every configuration — both match engines, both refine
    implementations, fine-level WMF and subpixel refinement.
    """
    h = img1.shape[0]
    w = img1.shape[1]
    if h * w <= STAGED_PIPELINE_THRESHOLD:
        return _compute_flow_one_program(
            img1, img2, key, cfg, fine_level_wmf, init_flow
        )
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    levels1, packs1 = _prep_stage(img1, cfg)
    levels2, packs2 = _prep_stage(img2, cfg)
    top = len(packs1) - 1
    ci = None
    if init_flow is not None and cfg.match_engine == "dense":
        ch, cw = packs1[top].shape[0], packs1[top].shape[1]
        ci = _coarse_init_stage(init_flow, ch, cw, cfg)
    m1, m2 = _match_stage_bidi(
        levels1[top], levels2[top], packs1[top], packs2[top], key, cfg,
        init_flow=ci,
    )
    flow = _coarse_refine_stage(
        m1, m2, levels1[top], cfg, packs1[top], packs2[top]
    )
    for lvl in range(top - 1, -1, -1):
        oh, ow = packs1[lvl].shape[0], packs1[lvl].shape[1]
        n = cfg.dense_refine_passes
        fit = cfg.dense_subpixel_fit and lvl == 0
        flow = _refine_pass_stage(
            flow, packs1[lvl], packs2[lvl], cfg, oh, ow, False,
            fit and n == 1,
        )
        if cfg.refine_impl == "dense":
            for i in range(n - 1):
                flow = _refine_pass_stage(
                    flow, packs1[lvl], packs2[lvl], cfg, oh, ow, True,
                    fit and i == n - 2,
                )
        flow = _smooth_stage(flow, levels1[lvl], cfg)
        if fine_level_wmf:
            flow = _fine_wmf_stage(flow, levels1[lvl], cfg)
    if cfg.subpixel_refine:
        flow = _subpixel_stage(flow, levels1[0], levels2[0], cfg)
    return _smooth_stage(flow, levels1[0], cfg)


class EPPMFlow:
    """Object API mirroring the reference orchestrator
    (bao_flow_patchmatch_multiscale_cuda.h:33-44): ``init(h, w)``,
    ``set_data(img1, img2)``, ``compute_flow()``.

    Thin stateful wrapper over the pure pipeline; useful for streaming
    frame pairs at a fixed resolution (the jit cache keys on shape).
    """

    def __init__(self, cfg: EPPMConfig = DEFAULT_CONFIG):
        self.cfg = cfg
        self._shape: Optional[Tuple[int, int]] = None
        self._img1 = None
        self._img2 = None

    def init(self, h: int, w: int) -> "EPPMFlow":
        self._shape = (h, w)
        return self

    def set_data(self, img1, img2) -> "EPPMFlow":
        img1 = jnp.asarray(img1)
        img2 = jnp.asarray(img2)
        if self._shape is None:
            self._shape = (img1.shape[0], img1.shape[1])
        if img1.shape[:2] != self._shape or img2.shape[:2] != self._shape:
            raise ValueError(
                f"frame shape {img1.shape[:2]}/{img2.shape[:2]} != "
                f"init shape {self._shape}"
            )
        self._img1, self._img2 = img1, img2
        return self

    def compute_flow(
        self,
        key: Optional[jax.Array] = None,
        fine_level_wmf: bool = False,
        init_flow: Optional[jnp.ndarray] = None,
    ) -> jnp.ndarray:
        if self._img1 is None:
            raise RuntimeError("set_data() must be called before compute_flow()")
        return compute_flow_jit(
            self._img1, self._img2, key, self.cfg, fine_level_wmf, init_flow
        )
