"""PatchMatch nearest-neighbor-field search, data-parallel.

Spec source: ``baoCudaPatchMatch`` (bao_pmflow_kernel.cu:1760-1826):
random NNF init (:73-109) -> initial cost field (:636-645) -> NUM_ITER x
{propagation; random search (:1519-1586)}.

Redesign
--------
The reference's propagation is 4 sequential scanline sweeps over 10-pixel
segments (:979-1181), one thread per segment — a shape that maps terribly
onto SIMD vector units.  We restructure it as Jacobi jump-flood rounds: in
each round every pixel simultaneously tries the offsets of its 4 axial
neighbors at distance s for a schedule of step sizes (default 8,4,2,1).
The reference itself ships a jump-flood propagation variant
(``baoJumpPropagate``, :800-857), so the substitution is algorithmically
sanctioned; the acceptance bar is final EPE, not per-iteration equivalence.

Randomness: ``jax.random`` (threefry) with a fixed seed mirrors the
reference's deterministic seed-1234 cuRAND streams (:68).  The NNF is kept
as absolute int32 target coordinates, exactly like the reference's short2
fields, so invalid-marking and the left-right check carry over unchanged.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import CostConfig, PatchMatchConfig
from ._util import shift2d as _shift2d_util
from .cost import (
    patch_cost,
    patch_cost_candidates,
    patch_cost_planefitting,
    patch_cost_scaled,
)

__all__ = [
    "random_init",
    "random_init_scaled",
    "propagate_round",
    "line_propagate",
    "random_search",
    "patchmatch",
    "patchmatch_scaled",
    "patchmatch_planefitting",
]


def random_init(
    key: jax.Array, h: int, w: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Uniform random absolute targets: x in [0, w], y in [0, h] inclusive
    (d_gen_rand_field draws rand%(w+1), bao_pmflow_kernel.cu:97-98; the
    one-past-the-end target reads clamped pixels and is culled by the
    left-right check)."""
    kx, ky = jax.random.split(key)
    tx = jax.random.randint(kx, (h, w), 0, w + 1, dtype=jnp.int32)
    ty = jax.random.randint(ky, (h, w), 0, h + 1, dtype=jnp.int32)
    return tx, ty


_shift2d = _shift2d_util


def _select_best(state, txs, tys, costs):
    """Fold candidate fields (K, H, W) into (tx, ty, cost) keeping argmin.

    Strict '<' comparison matches the reference acceptance test
    (bao_pmflow_kernel.cu:1067, :1574): ties keep the incumbent.
    """
    tx, ty, cost = state
    for k in range(txs.shape[0]):
        better = costs[k] < cost
        tx = jnp.where(better, txs[k], tx)
        ty = jnp.where(better, tys[k], ty)
        cost = jnp.where(better, costs[k], cost)
    return tx, ty, cost


def propagate_round(
    pack1: jnp.ndarray,
    pack2: jnp.ndarray,
    tx: jnp.ndarray,
    ty: jnp.ndarray,
    cost: jnp.ndarray,
    step: int,
    cost_cfg: CostConfig,
    tap_chunk: int = 25,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One Jacobi jump-flood round at step distance ``step``.

    Each pixel tries the *offsets* of its 4 axial neighbors at distance
    ``step`` (the segmented sweep at bao_pmflow_kernel.cu:1060-1076 carries
    the previous pixel's offset via ``prev_disp.x+1``; at distance s that is
    the neighbor's target shifted by s, clamped to the image like :1065).
    """
    h, w = tx.shape
    cand_tx = []
    cand_ty = []
    for dy, dx in ((0, -step), (0, step), (-step, 0), (step, 0)):
        # neighbor at (y+dy, x+dx); carrying its offset to (y, x) means
        # target - (dy, dx)
        ntx = _shift2d(tx, dy, dx) - dx
        nty = _shift2d(ty, dy, dx) - dy
        cand_tx.append(jnp.clip(ntx, 0, w - 1))
        cand_ty.append(jnp.clip(nty, 0, h - 1))
    txs = jnp.stack(cand_tx)
    tys = jnp.stack(cand_ty)
    costs = patch_cost_candidates(pack1, pack2, txs, tys, cost_cfg, tap_chunk)
    return _select_best((tx, ty, cost), txs, tys, costs)


def random_search(
    key: jax.Array,
    pack1: jnp.ndarray,
    pack2: jnp.ndarray,
    tx: jnp.ndarray,
    ty: jnp.ndarray,
    cost: jnp.ndarray,
    pm_cfg: PatchMatchConfig,
    cost_cfg: CostConfig,
    tap_chunk: int = 25,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Shrinking-window random search (bao_pmflow_kernel.cu:1519-1586).

    All guesses are drawn around the *incumbent* target (the reference
    pre-generates every guess before the evaluation loop, so guesses do not
    chain off each other): guess k is uniform in
    [max(t-mag_k, 0), min(t+mag_k+1, dim+1)) per axis, mag halving from
    SEARCH_RANGE down to SEARCH_RADIUS_MIN (:1560-1564).
    """
    h, w = tx.shape
    mags = pm_cfg.search_mags()
    keys = jax.random.split(key, 2 * len(mags))
    cand_tx = []
    cand_ty = []
    for k, mag in enumerate(mags):
        xmin = jnp.maximum(tx - mag, 0)
        xmax = jnp.minimum(tx + mag + 1, w + 1)
        ymin = jnp.maximum(ty - mag, 0)
        ymax = jnp.minimum(ty + mag + 1, h + 1)
        gx = jax.random.randint(keys[2 * k], (h, w), xmin, xmax, dtype=jnp.int32)
        gy = jax.random.randint(
            keys[2 * k + 1], (h, w), ymin, ymax, dtype=jnp.int32
        )
        cand_tx.append(gx)
        cand_ty.append(gy)
    txs = jnp.stack(cand_tx)
    tys = jnp.stack(cand_ty)
    costs = patch_cost_candidates(pack1, pack2, txs, tys, cost_cfg, tap_chunk)
    return _select_best((tx, ty, cost), txs, tys, costs)


@partial(
    jax.jit, static_argnames=("pm_cfg", "cost_cfg", "tap_chunk")
)
def patchmatch(
    pack1: jnp.ndarray,
    pack2: jnp.ndarray,
    key: jax.Array,
    pm_cfg: PatchMatchConfig = PatchMatchConfig(),
    cost_cfg: CostConfig = CostConfig(),
    tap_chunk: int = 25,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Full PatchMatch (bao_pmflow_kernel.cu:1760-1826).

    Returns (tx, ty, cost): absolute int32 target fields + float32 cost.
    """
    h, w = pack1.shape[0], pack1.shape[1]
    init_key, loop_key = jax.random.split(key)
    tx, ty = random_init(init_key, h, w)
    cost = patch_cost(pack1, pack2, tx, ty, cost_cfg, tap_chunk)

    def one_iter(i, state):
        tx, ty, cost = state
        for step in pm_cfg.prop_steps:
            tx, ty, cost = propagate_round(
                pack1, pack2, tx, ty, cost, step, cost_cfg, tap_chunk
            )
        iter_key = jax.random.fold_in(loop_key, i)
        tx, ty, cost = random_search(
            iter_key, pack1, pack2, tx, ty, cost, pm_cfg, cost_cfg, tap_chunk
        )
        return tx, ty, cost

    tx, ty, cost = jax.lax.fori_loop(
        0, pm_cfg.num_iters, one_iter, (tx, ty, cost)
    )
    return tx, ty, cost


def line_propagate(
    pack1: jnp.ndarray,
    pack2: jnp.ndarray,
    tx: jnp.ndarray,
    ty: jnp.ndarray,
    cost: jnp.ndarray,
    cost_cfg: CostConfig,
    tap_chunk: int = 25,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Full sequential scanline propagation (d_row_propagate /
    d_column_propagate and reverses, bao_pmflow_kernel.cu:862-974): four
    sweeps — row-forward, column-forward, row-reverse, column-reverse —
    each carrying the previous pixel's offset one step.

    Faithful to the reference's (unused) full-scanline variant: the sweep
    is a ``lax.scan`` whose steps evaluate one row/column at a time —
    inherently latency-bound, provided for engine parity and as an
    accuracy reference; the production propagation is the jump-flood
    schedule (propagate_round) / dense rounds (ops.match.propagate_dense).
    """
    h, w = tx.shape
    R = cost_cfg.patch_radius
    pad1 = jnp.pad(pack1, ((R, R), (R, R), (0, 0)), mode="edge")

    def col_cost(x, cand_tx, cand_ty):
        """Candidate cost for one image column x (cand_* shape (h,))."""
        tile = jax.lax.dynamic_slice(
            pad1, (0, x, 0), (h + 2 * R, 1 + 2 * R, 4)
        )
        return patch_cost(
            tile, pack2, cand_tx[:, None], cand_ty[:, None], cost_cfg,
            tap_chunk, pack1_halo=R,
        )[:, 0]

    def row_cost(y, cand_tx, cand_ty):
        tile = jax.lax.dynamic_slice(
            pad1, (y, 0, 0), (1 + 2 * R, w + 2 * R, 4)
        )
        return patch_cost(
            tile, pack2, cand_tx[None, :], cand_ty[None, :], cost_cfg,
            tap_chunk, pack1_halo=R,
        )[0]

    def sweep(state, axis: int, reverse: bool):
        """Sequential sweep along ``axis`` carrying the previous line's
        (updated) offsets, shifted one pixel like the CUDA kernels
        (prev_disp.x + 1, :884)."""
        tx, ty, cost = state
        step = -1 if reverse else 1
        n = w if axis == 1 else h
        idxs = jnp.arange(n) if not reverse else jnp.arange(n)[::-1]

        def body(carry, i):
            prev_tx, prev_ty = carry
            # gather the current line
            if axis == 1:
                cur_tx = jax.lax.dynamic_slice(tx, (0, i), (h, 1))[:, 0]
                cur_ty = jax.lax.dynamic_slice(ty, (0, i), (h, 1))[:, 0]
                cur_cost = jax.lax.dynamic_slice(cost, (0, i), (h, 1))[:, 0]
                cand_tx = jnp.clip(prev_tx + step, 0, w - 1)
                cand_ty = prev_ty
                c = col_cost(i, cand_tx, cand_ty)
            else:
                cur_tx = jax.lax.dynamic_slice(tx, (i, 0), (1, w))[0]
                cur_ty = jax.lax.dynamic_slice(ty, (i, 0), (1, w))[0]
                cur_cost = jax.lax.dynamic_slice(cost, (i, 0), (1, w))[0]
                cand_tx = prev_tx
                cand_ty = jnp.clip(prev_ty + step, 0, h - 1)
                c = row_cost(i, cand_tx, cand_ty)
            # the first line of a sweep has no predecessor (the CUDA
            # kernels start at index 1, :880)
            better = (c < cur_cost) & (i != idxs[0])
            new_tx = jnp.where(better, cand_tx, cur_tx)
            new_ty = jnp.where(better, cand_ty, cur_ty)
            new_cost = jnp.where(better, c, cur_cost)
            return (new_tx, new_ty), (new_tx, new_ty, new_cost, i)

        if axis == 1:
            init = (tx[:, idxs[0]], ty[:, idxs[0]])
        else:
            init = (tx[idxs[0]], ty[idxs[0]])
        _, (otx, oty, ocost, oi) = jax.lax.scan(body, init, idxs)
        # scatter the swept lines back in original order
        order = jnp.argsort(oi)
        otx, oty, ocost = otx[order], oty[order], ocost[order]
        if axis == 1:
            return otx.T, oty.T, ocost.T
        return otx, oty, ocost

    state = (tx, ty, cost)
    state = sweep(state, axis=1, reverse=False)   # row forward
    state = sweep(state, axis=0, reverse=False)   # column forward
    state = sweep(state, axis=1, reverse=True)    # row reverse
    state = sweep(state, axis=0, reverse=True)    # column reverse
    return state


def random_init_scaled(
    key: jax.Array, h: int, w: int,
    scale_range: int = 9, scale_min: int = 4,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Random NNF plus per-pixel patch scale (d_gen_rand_field_scaled,
    bao_pmflow_kernel.cu:112-151): scale = (10 + (r % range) - min)/10,
    i.e. 0.6..1.4 for the defaults (the reference comment says 0.9~1.3;
    the code says otherwise — we follow the code)."""
    kx, ky, ks = jax.random.split(key, 3)
    tx = jax.random.randint(kx, (h, w), 0, w + 1, dtype=jnp.int32)
    ty = jax.random.randint(ky, (h, w), 0, h + 1, dtype=jnp.int32)
    r = jax.random.randint(ks, (h, w), 0, scale_range, dtype=jnp.int32)
    scale = (10.0 + (r - scale_min).astype(jnp.float32)) / 10.0
    return tx, ty, scale


@partial(jax.jit, static_argnames=("pm_cfg", "cost_cfg", "tap_chunk"))
def patchmatch_scaled(
    pack1: jnp.ndarray,
    pack2: jnp.ndarray,
    key: jax.Array,
    pm_cfg: PatchMatchConfig = PatchMatchConfig(),
    cost_cfg: CostConfig = CostConfig(),
    tap_chunk: int = 25,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Scale-adaptive PatchMatch (baoCudaPatchMatch_Scaled,
    bao_pmflow_kernel.cu:1828-1896): the NNF carries a per-pixel patch
    scale; propagation passes the neighbor's scale along with its offset,
    random search draws a fresh scale per guess.  Returns
    (tx, ty, scale, cost)."""
    h, w = pack1.shape[0], pack1.shape[1]
    init_key, loop_key = jax.random.split(key)
    tx, ty, scale = random_init_scaled(init_key, h, w)
    cost = patch_cost_scaled(pack1, pack2, tx, ty, scale, cost_cfg, tap_chunk)

    def select(state, txs, tys, scs, costs):
        tx, ty, sc, cost = state
        for k in range(txs.shape[0]):
            better = costs[k] < cost
            tx = jnp.where(better, txs[k], tx)
            ty = jnp.where(better, tys[k], ty)
            sc = jnp.where(better, scs[k], sc)
            cost = jnp.where(better, costs[k], cost)
        return tx, ty, sc, cost

    def one_iter(i, state):
        tx, ty, sc, cost = state
        # jump-flood propagation carrying scale
        for step in pm_cfg.prop_steps:
            cand = []
            for dy, dx in ((0, -step), (0, step), (-step, 0), (step, 0)):
                ntx = jnp.clip(_shift2d(tx, dy, dx) - dx, 0, w - 1)
                nty = jnp.clip(_shift2d(ty, dy, dx) - dy, 0, h - 1)
                nsc = _shift2d(sc, dy, dx)
                cand.append((ntx, nty, nsc))
            txs = jnp.stack([c[0] for c in cand])
            tys = jnp.stack([c[1] for c in cand])
            scs = jnp.stack([c[2] for c in cand])
            costs = jax.vmap(
                lambda a, b, s: patch_cost_scaled(
                    pack1, pack2, a, b, s, cost_cfg, tap_chunk
                )
            )(txs, tys, scs)
            tx, ty, sc, cost = select((tx, ty, sc, cost), txs, tys, scs, costs)
        # random search with fresh scales
        iter_key = jax.random.fold_in(loop_key, i)
        mags = pm_cfg.search_mags()
        keys = jax.random.split(iter_key, 3 * len(mags))
        cand = []
        for k, mag in enumerate(mags):
            xmin = jnp.maximum(tx - mag, 0)
            xmax = jnp.minimum(tx + mag + 1, w + 1)
            ymin = jnp.maximum(ty - mag, 0)
            ymax = jnp.minimum(ty + mag + 1, h + 1)
            gx = jax.random.randint(keys[3 * k], (h, w), xmin, xmax,
                                    dtype=jnp.int32)
            gy = jax.random.randint(keys[3 * k + 1], (h, w), ymin, ymax,
                                    dtype=jnp.int32)
            r = jax.random.randint(keys[3 * k + 2], (h, w), 0, 9,
                                   dtype=jnp.int32)
            gs = (10.0 + (r - 4).astype(jnp.float32)) / 10.0
            cand.append((gx, gy, gs))
        txs = jnp.stack([c[0] for c in cand])
        tys = jnp.stack([c[1] for c in cand])
        scs = jnp.stack([c[2] for c in cand])
        costs = jax.vmap(
            lambda a, b, s: patch_cost_scaled(
                pack1, pack2, a, b, s, cost_cfg, tap_chunk
            )
        )(txs, tys, scs)
        return select((tx, ty, sc, cost), txs, tys, scs, costs)

    tx, ty, scale, cost = jax.lax.fori_loop(
        0, pm_cfg.num_iters, one_iter, (tx, ty, scale, cost)
    )
    return tx, ty, scale, cost


@partial(jax.jit, static_argnames=("pm_cfg", "cost_cfg", "tap_chunk"))
def patchmatch_planefitting(
    pack1: jnp.ndarray,
    pack2: jnp.ndarray,
    key: jax.Array,
    pm_cfg: PatchMatchConfig = PatchMatchConfig(),
    cost_cfg: CostConfig = CostConfig(),
    tap_chunk: int = 25,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """PatchMatch over the plane-fitting cost (min over 4 affine-warp
    hypotheses; baoCudaPatchMatch_PlaneFitting,
    bao_pmflow_kernel.cu:1899-1963)."""
    h, w = pack1.shape[0], pack1.shape[1]
    init_key, loop_key = jax.random.split(key)
    tx, ty = random_init(init_key, h, w)
    pc = lambda a, b: patch_cost_planefitting(
        pack1, pack2, a, b, cost_cfg, tap_chunk
    )
    cost = pc(tx, ty)

    def one_iter(i, state):
        tx, ty, cost = state
        for step in pm_cfg.prop_steps:
            cand_tx, cand_ty = [], []
            for dy, dx in ((0, -step), (0, step), (-step, 0), (step, 0)):
                cand_tx.append(jnp.clip(_shift2d(tx, dy, dx) - dx, 0, w - 1))
                cand_ty.append(jnp.clip(_shift2d(ty, dy, dx) - dy, 0, h - 1))
            txs, tys = jnp.stack(cand_tx), jnp.stack(cand_ty)
            costs = jax.lax.map(lambda t: pc(t[0], t[1]), (txs, tys))
            tx, ty, cost = _select_best((tx, ty, cost), txs, tys, costs)
        iter_key = jax.random.fold_in(loop_key, i)
        mags = pm_cfg.search_mags()
        keys = jax.random.split(iter_key, 2 * len(mags))
        cand_tx, cand_ty = [], []
        for k, mag in enumerate(mags):
            xmin = jnp.maximum(tx - mag, 0)
            xmax = jnp.minimum(tx + mag + 1, w + 1)
            ymin = jnp.maximum(ty - mag, 0)
            ymax = jnp.minimum(ty + mag + 1, h + 1)
            cand_tx.append(jax.random.randint(
                keys[2 * k], (h, w), xmin, xmax, dtype=jnp.int32))
            cand_ty.append(jax.random.randint(
                keys[2 * k + 1], (h, w), ymin, ymax, dtype=jnp.int32))
        txs, tys = jnp.stack(cand_tx), jnp.stack(cand_ty)
        costs = jax.lax.map(lambda t: pc(t[0], t[1]), (txs, tys))
        return _select_best((tx, ty, cost), txs, tys, costs)

    tx, ty, cost = jax.lax.fori_loop(
        0, pm_cfg.num_iters, one_iter, (tx, ty, cost)
    )
    return tx, ty, cost
