"""Temporal warm start (video streaming) tests.

The reference has no streaming mode (main.cpp processes one hardcoded
pair); the warm start is a framework extension: the previous pair's flow
seeds the dense coarse matcher (MatchConfig.warm_skip_global) or is
merged as a true-cost proposal.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from eppm.config import EPPMConfig, MatchConfig, PyramidConfig, RefineConfig
from eppm.metrics import flow_error
from eppm.pipeline import EPPMFlow, compute_flow_jit


def _textured(rng, h, w):
    small = rng.random((h // 4 + 2, w // 4 + 2, 3)).astype(np.float32)
    img = np.asarray(
        jax.image.resize(jnp.asarray(small), (h + 8, w + 8, 3), "cubic")
    )[:h, :w]
    return np.clip(img, 0, 1)


def _roll_seq(base, n, dy, dx):
    """n frames, constant (dx, dy) px/frame motion: frame k is base
    rolled k steps down/right, so f_k(p) == f_{k+1}(p + (dx, dy)) and the
    flow k -> k+1 is (dx, dy) everywhere (mod the wrap seam)."""
    return [np.roll(base, (k * dy, k * dx), axis=(0, 1)) for k in range(n)]


def _cfg(**match_kw):
    return EPPMConfig(
        pyramid=PyramidConfig(max_depth=2),
        refine=RefineConfig(wmf_coarse_iters=5),
        match=dataclasses.replace(MatchConfig(), **match_kw),
    )


@pytest.mark.slow
def test_warm_skip_global_matches_cold(rng):
    """Pair 2 warm-started from pair 1's flow recovers the same constant
    motion the cold run does."""
    base = _textured(rng, 96, 128)
    f = _roll_seq(base, 3, 3, 5)
    gt = np.zeros((96, 128, 2), np.float32)
    gt[..., 0], gt[..., 1] = 5.0, 3.0
    cfg = _cfg(warm_skip_global=True)
    flow01 = compute_flow_jit(jnp.asarray(f[0]), jnp.asarray(f[1]), cfg=cfg)
    warm = compute_flow_jit(
        jnp.asarray(f[1]), jnp.asarray(f[2]), cfg=cfg, init_flow=flow01
    )
    cold = compute_flow_jit(jnp.asarray(f[1]), jnp.asarray(f[2]), cfg=cfg)
    b = 12
    epe_w, _ = flow_error(np.asarray(warm)[b:-b, b:-b], gt[b:-b, b:-b])
    epe_c, _ = flow_error(np.asarray(cold)[b:-b, b:-b], gt[b:-b, b:-b])
    assert np.isfinite(np.asarray(warm)).all()
    assert epe_c < 0.8
    assert epe_w < epe_c + 0.1


@pytest.mark.slow
def test_warm_proposal_merge_never_hurts(rng):
    """With warm_skip_global=False the init is merged by true-cost argmin
    alongside the full global stages — accuracy stays at the cold level."""
    base = _textured(rng, 96, 128)
    f = _roll_seq(base, 3, 2, 4)
    gt = np.zeros((96, 128, 2), np.float32)
    gt[..., 0], gt[..., 1] = 4.0, 2.0
    cfg = _cfg(warm_skip_global=False)
    flow01 = compute_flow_jit(jnp.asarray(f[0]), jnp.asarray(f[1]), cfg=cfg)
    warm = compute_flow_jit(
        jnp.asarray(f[1]), jnp.asarray(f[2]), cfg=cfg, init_flow=flow01
    )
    cold = compute_flow_jit(jnp.asarray(f[1]), jnp.asarray(f[2]), cfg=cfg)
    b = 12
    epe_w, _ = flow_error(np.asarray(warm)[b:-b, b:-b], gt[b:-b, b:-b])
    epe_c, _ = flow_error(np.asarray(cold)[b:-b, b:-b], gt[b:-b, b:-b])
    assert epe_w < epe_c + 0.1


def test_warm_large_displacement_from_gt_init(rng):
    """Skip-global mode relies on the init for large-displacement recall:
    given the true motion as init, a 24-px displacement is recovered even
    though the global matcher never runs."""
    base = _textured(rng, 96, 128)
    f = _roll_seq(base, 2, 0, 24)
    gt = np.zeros((96, 128, 2), np.float32)
    gt[..., 0] = 24.0
    cfg = _cfg(warm_skip_global=True)
    warm = compute_flow_jit(
        jnp.asarray(f[0]), jnp.asarray(f[1]), cfg=cfg,
        init_flow=jnp.asarray(gt),
    )
    b = 12
    epe, _ = flow_error(np.asarray(warm)[b:-b, b:-b], gt[b:-b, b:-b])
    assert epe < 0.8


@pytest.mark.slow
def test_eppmflow_init_flow_api(rng):
    base = _textured(rng, 64, 96)
    f = _roll_seq(base, 3, 1, 2)
    eng = EPPMFlow(_cfg())
    eng.set_data(f[0], f[1])
    fl = eng.compute_flow()
    eng.set_data(f[1], f[2])
    fl2 = eng.compute_flow(init_flow=fl)
    assert fl2.shape == (64, 96, 2)
    assert np.isfinite(np.asarray(fl2)).all()


@pytest.mark.slow
def test_sharded_temporal_warm_start(rng):
    """Warm start through the (1,2,2) mesh: the coarse level is
    replicated, so the sharded warm result must agree with the
    single-chip warm result at the usual cross-program gate."""
    from eppm.parallel import compute_flow_sharded, make_mesh
    from eppm.pipeline import compute_flow

    base = _textured(rng, 64, 96)
    img1, img2 = base, np.roll(base, (2, 4), axis=(0, 1))
    gt = np.zeros((64, 96, 2), np.float32)
    gt[..., 0], gt[..., 1] = 4.0, 2.0
    cfg = _cfg(warm_skip_global=True)
    key = jax.random.PRNGKey(cfg.seed)
    single = np.asarray(
        compute_flow(
            jnp.asarray(img1), jnp.asarray(img2), key, cfg,
            init_flow=jnp.asarray(gt),
        )
    )
    mesh = make_mesh(batch=1, y=2, x=2)
    tiled = np.asarray(
        compute_flow_sharded(
            jnp.asarray(img1)[None], jnp.asarray(img2)[None], mesh, cfg,
            keys=key[None], init_flows=jnp.asarray(gt)[None],
        )
    )[0]
    d = np.abs(tiled - single).max(axis=-1)
    agree = (d < 1e-3).mean()
    assert agree > 0.98, f"only {agree:.2%} of pixels agree"
    assert float(np.mean(d)) < 0.05
    b = 12
    epe, _ = flow_error(tiled[b:-b, b:-b], gt[b:-b, b:-b])
    assert epe < 0.8


@pytest.mark.slow
def test_cli_temporal_stream(rng, tmp_path):
    """--frames-dir --temporal end-to-end: writes one .flo per pair with
    the expected motion."""
    from eppm.cli import main
    from eppm.io import read_flo, write_ppm

    base = (_textured(rng, 64, 96) * 255).astype(np.uint8)
    frames = _roll_seq(base, 4, 1, 3)
    fdir = tmp_path / "frames"
    odir = tmp_path / "flo"
    os.makedirs(fdir)
    for i, fr in enumerate(frames):
        write_ppm(str(fdir / f"f{i:03d}.ppm"), fr)
    rc = main([
        "--frames-dir", str(fdir), "--out-dir", str(odir), "--temporal",
        "--set", "pyramid.max_depth=2", "--set", "refine.wmf_coarse_iters=5",
    ])
    assert rc == 0
    outs = sorted(os.listdir(odir))
    assert outs == ["f000.flo", "f001.flo", "f002.flo"]
    fl = read_flo(str(odir / "f001.flo"))
    b = 12
    gt = np.zeros(fl.shape, np.float32)
    gt[..., 0], gt[..., 1] = 3.0, 1.0
    epe, _ = flow_error(fl[b:-b, b:-b], gt[b:-b, b:-b])
    assert epe < 1.0
