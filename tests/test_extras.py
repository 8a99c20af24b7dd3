"""Tests for the auxiliary components: native I/O, CLI, subpixel
refinement, scaled/plane-fitting PatchMatch, warp-by-flow, color
conversions, guide smoothing, median filter."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from eppm.config import CostConfig, PatchMatchConfig, SubpixelConfig
from eppm.ops.color import rgb2luv, rgb2yuv, yuv2rgb
from eppm.ops.refine import guide_image_smoothing, median_filter
from eppm.ops.subpixel import (
    bicubic_resize2x,
    bicubic_shift,
    bspline_weights,
    subpixel_refine,
)
from eppm.ops.warp import warp_image_by_flow


def _textured(rng, h, w):
    small = rng.random((h // 4 + 2, w // 4 + 2, 3)).astype(np.float32)
    img = np.asarray(
        jax.image.resize(jnp.asarray(small), (h + 8, w + 8, 3), "cubic")
    )[:h, :w]
    return np.clip(img, 0, 1)


# ---- native I/O ---------------------------------------------------------

def test_native_io_roundtrip(tmp_path):
    from eppm.io import native

    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (33, 47, 3), np.uint8)
    p = str(tmp_path / "x.ppm")
    native.write_ppm_native(p, img)
    back = native.read_ppm_native(p)
    np.testing.assert_array_equal(back, img)
    # python <-> native cross-compat
    from eppm.io.ppm import read_ppm as read_py

    np.testing.assert_array_equal(read_py(p), img)
    flow = rng.normal(size=(15, 21, 2)).astype(np.float32)
    fp = str(tmp_path / "x.flo")
    native.write_flo_native(fp, flow)
    np.testing.assert_array_equal(native.read_flo_native(fp), flow)


def test_native_batch(tmp_path):
    from eppm.io import native, read_ppm_batch, write_ppm

    rng = np.random.default_rng(1)
    paths = []
    frames = []
    for i in range(5):
        img = rng.integers(0, 256, (16, 20, 3), np.uint8)
        p = str(tmp_path / f"f{i}.ppm")
        write_ppm(p, img)
        paths.append(p)
        frames.append(img)
    out = read_ppm_batch(paths, nthreads=2)
    np.testing.assert_array_equal(out, np.stack(frames))


# ---- CLI ----------------------------------------------------------------

def test_cli_overrides():
    from eppm.cli import apply_overrides
    from eppm.config import DEFAULT_CONFIG

    cfg = apply_overrides(
        DEFAULT_CONFIG,
        ["refine.wmf_coarse_iters=7", "match_engine=patchmatch",
         "pyramid.ratio=0.5"],
    )
    assert cfg.refine.wmf_coarse_iters == 7
    assert cfg.match_engine == "patchmatch"
    with pytest.raises(SystemExit):
        apply_overrides(DEFAULT_CONFIG, ["no.such.field=1"])


# ---- color conversions --------------------------------------------------

def test_yuv_roundtrip():
    rng = np.random.default_rng(2)
    img = rng.integers(16, 240, (8, 9, 3)).astype(np.float32)
    yuv = np.asarray(rgb2yuv(jnp.asarray(img)))
    back = np.asarray(yuv2rgb(jnp.asarray(yuv)))
    # the reference's coefficients are not an exact inverse pair; loose gate
    assert np.abs(back - img).mean() < 4.0


def test_luv_range():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (8, 9, 3)).astype(np.float32)
    luv = np.asarray(rgb2luv(jnp.asarray(img)))
    assert np.isfinite(luv).all()
    assert (luv <= 255.0).all()


# ---- warp by flow -------------------------------------------------------

def test_warp_identity_and_shift():
    rng = np.random.default_rng(4)
    img = jnp.asarray(rng.random((12, 16, 3)).astype(np.float32))
    zero = jnp.zeros((12, 16, 2))
    np.testing.assert_allclose(
        np.asarray(warp_image_by_flow(img, zero)), np.asarray(img), atol=1e-6
    )
    # integer shift: warped(p) = img(p + (2, 1))
    fl = jnp.zeros((12, 16, 2)).at[..., 0].set(2.0).at[..., 1].set(1.0)
    out = np.asarray(warp_image_by_flow(img, fl))
    ref = np.asarray(img)
    np.testing.assert_allclose(
        out[:-1, :-2], ref[1:, 2:], atol=1e-6
    )


# ---- median / guide smoothing ------------------------------------------

def test_median_filter_matches_numpy():
    rng = np.random.default_rng(5)
    img = rng.random((10, 12, 3)).astype(np.float32)
    out = np.asarray(median_filter(jnp.asarray(img), 2))
    pad = np.pad(img, ((2, 2), (2, 2), (0, 0)), mode="edge")
    ref = np.empty_like(img)
    for y in range(10):
        for x in range(12):
            win = pad[y : y + 5, x : x + 5].reshape(25, 3)
            ref[y, x] = np.median(win, axis=0)
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_guide_smoothing_finite():
    rng = np.random.default_rng(6)
    img = jnp.asarray(_textured(rng, 24, 28))
    out = np.asarray(guide_image_smoothing(img))
    assert out.shape == (24, 28, 3)
    assert np.isfinite(out).all()
    # edge-preserving smoothing keeps values in range
    assert out.min() >= -1e-4 and out.max() <= 1.0 + 1e-4


# ---- bicubic sampling / subpixel ---------------------------------------

def test_bspline_weights_partition_of_unity():
    for a in (0.0, 0.25, 0.5, 0.9):
        assert abs(sum(bspline_weights(a)) - 1.0) < 1e-12


def test_bicubic_shift_constant():
    img = jnp.full((9, 11), 0.7)
    out = np.asarray(bicubic_shift(img, 0.5, -1.5))
    np.testing.assert_allclose(out, 0.7, atol=1e-6)


def test_bicubic_resize2x_shape():
    rng = np.random.default_rng(7)
    img = jnp.asarray(rng.random((6, 7, 3)).astype(np.float32))
    out = bicubic_resize2x(img)
    assert out.shape == (12, 14, 3)


def test_subpixel_refine_improves_fractional_shift(rng):
    """GT flow (1.5, 0): integer search stops at 1 or 2; the quadratic fit
    should move toward the half-pixel optimum."""
    h, w = 40, 48
    img2 = _textured(rng, h, w)
    # frame1 samples frame2 at x + 1.5 (build by bilinear)
    x = np.arange(w)
    fx = np.clip(x + 1.5, 0, w - 1)
    x0 = np.floor(fx).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    a = (fx - x0)[None, :, None]
    img1 = (img2[:, x0] * (1 - a) + img2[:, x1] * a).astype(np.float32)
    flow_int = np.zeros((h, w, 2), np.float32)
    flow_int[..., 0] = 1.0  # trunc of 1.5
    out = np.asarray(
        subpixel_refine(
            jnp.asarray(flow_int), jnp.asarray(img1), jnp.asarray(img2),
            SubpixelConfig(),
        )
    )
    b = 8
    err_in = np.abs(flow_int[b:-b, b:-b, 0] - 1.5).mean()
    err_out = np.abs(out[b:-b, b:-b, 0] - 1.5).mean()
    assert err_out < err_in, f"{err_out:.3f} !< {err_in:.3f}"


# ---- scaled / plane-fitting PatchMatch ---------------------------------

def test_patchmatch_variants_run(rng):
    from eppm.ops.cost import pack_frame
    from eppm.ops.census import census_transform
    from eppm.ops.patchmatch import (
        patchmatch_planefitting,
        patchmatch_scaled,
    )

    h, w = 24, 28
    img2 = _textured(rng, h, w)
    img1 = np.roll(img2, -2, axis=1)
    p1 = pack_frame(jnp.asarray(img1), census_transform(jnp.asarray(img1)))
    p2 = pack_frame(jnp.asarray(img2), census_transform(jnp.asarray(img2)))
    pm = PatchMatchConfig(num_iters=2, prop_steps=(2, 1))
    key = jax.random.PRNGKey(0)
    tx, ty, sc, c = patchmatch_scaled(p1, p2, key, pm, CostConfig())
    assert sc.shape == (h, w) and np.isfinite(np.asarray(c)).all()
    assert float(np.asarray(sc).min()) >= 0.6 - 1e-6
    assert float(np.asarray(sc).max()) <= 1.4 + 1e-6
    xs = np.arange(w)[None, :]
    med = np.median(np.asarray(tx)[:, 8:-8] - xs[:, 8:-8])
    assert abs(med - 2.0) <= 1.5
    tx2, ty2, c2 = patchmatch_planefitting(p1, p2, key, pm, CostConfig())
    assert np.isfinite(np.asarray(c2)).all()


def test_line_propagate_reduces_cost(rng):
    from eppm.ops.cost import pack_frame, patch_cost
    from eppm.ops.census import census_transform
    from eppm.ops.patchmatch import line_propagate, random_init

    h, w = 20, 24
    img2 = _textured(rng, h, w)
    img1 = np.roll(img2, -2, axis=1).astype(np.float32)
    p1 = pack_frame(jnp.asarray(img1), census_transform(jnp.asarray(img1)))
    p2 = pack_frame(jnp.asarray(img2), census_transform(jnp.asarray(img2)))
    cc = CostConfig(patch_radius=3)
    tx, ty = random_init(jax.random.PRNGKey(0), h, w)
    cost0 = patch_cost(p1, p2, tx, ty, cc)
    tx2, ty2, cost2 = line_propagate(p1, p2, tx, ty, cost0, cc)
    assert float(np.asarray(cost2).mean()) < float(np.asarray(cost0).mean())
    # stored costs must match a recomputation at the accepted targets
    c_re = patch_cost(p1, p2, tx2, ty2, cc)
    np.testing.assert_allclose(
        np.asarray(cost2), np.asarray(c_re), atol=1e-5
    )


def test_timing_utils():
    from eppm.utils import DeviceTimer, Timer, time_stage

    t = Timer().start()
    assert t.stop() >= 0.0
    x = jnp.ones((8, 8))
    dt = DeviceTimer().start()
    assert dt.stop(x * 2.0) >= 0.0
    sec = time_stage(lambda a: a * 3.0, x, n=1, verbose=False)
    assert sec > 0.0


def test_bad_pixel_error_map():
    from eppm.metrics import bad_pixel_rate

    gt = np.zeros((4, 5, 2), np.float32)
    gt[..., 0] = 1.0
    flow = np.zeros((4, 5, 2), np.float32)
    flow[0, 0, 0] = 10.0
    rate, emap = bad_pixel_rate(flow, gt, thresh=3.0, return_error_map=True)
    assert emap.shape == (4, 5)
    assert emap[0, 0] == 9.0
    assert 0.0 < rate < 1.0


@pytest.mark.slow
def test_cli_stream_mode(tmp_path, rng):
    """Streaming video mode: N frames -> N-1 .flo files."""
    from eppm.cli import main as cli_main
    from eppm.io import write_ppm
    from eppm.io.flo import read_flo

    frames_dir = tmp_path / "frames"
    out_dir = tmp_path / "flows"
    frames_dir.mkdir()
    img = (np.clip(_textured(rng, 48, 64), 0, 1) * 255).astype(np.uint8)
    for i in range(3):
        write_ppm(str(frames_dir / f"f{i}.ppm"), np.roll(img, -2 * i, 1))
    rc = cli_main([
        "--frames-dir", str(frames_dir), "--out-dir", str(out_dir),
        "--set", "pyramid.max_depth=2",
        "--set", "refine.wmf_coarse_iters=2",
    ])
    assert rc == 0
    flows = sorted(out_dir.iterdir())
    assert len(flows) == 2
    f = read_flo(str(flows[0]))
    assert f.shape == (48, 64, 2) and np.isfinite(f).all()
    # float32 readback: the streamed flow is the pipeline's own output
    import dataclasses

    from eppm.config import DEFAULT_CONFIG
    from eppm.io import read_image
    from eppm.pipeline import compute_flow_jit

    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        pyramid=dataclasses.replace(DEFAULT_CONFIG.pyramid, max_depth=2),
        refine=dataclasses.replace(DEFAULT_CONFIG.refine, wmf_coarse_iters=2),
    )
    frames = sorted(frames_dir.iterdir())
    want = np.asarray(compute_flow_jit(
        jnp.asarray(read_image(str(frames[0]))),
        jnp.asarray(read_image(str(frames[1]))), None, cfg,
    ))
    np.testing.assert_array_equal(f, want)


def test_kitti_flow_roundtrip(tmp_path):
    from eppm.io.kitti import read_kitti_flow, write_kitti_flow

    rng = np.random.default_rng(8)
    flow = rng.normal(0, 30, (17, 23, 2)).astype(np.float32)
    valid = rng.random((17, 23)) > 0.2
    p = str(tmp_path / "flow.png")
    write_kitti_flow(p, flow, valid)
    back, v2 = read_kitti_flow(p)
    np.testing.assert_array_equal(v2, valid)
    # 1/64 px quantization
    np.testing.assert_allclose(back[valid], flow[valid], atol=1 / 64 + 1e-6)
    assert (back[~valid] == 0).all()


def _write_filtered_png16(path, img):
    """Encode (H, W, 3) uint16 cycling through all 5 PNG row filters —
    what libpng-encoded KITTI ground truth actually uses."""
    import struct
    import zlib

    from eppm.io.png import _SIG, _chunk

    h, w = img.shape[:2]
    bpp = 6
    rows = np.ascontiguousarray(img.astype(">u2")).view(np.uint8)
    rows = rows.reshape(h, w * bpp)
    raw = bytearray()
    prev = np.zeros(w * bpp, np.int32)
    for y in range(h):
        ft = y % 5
        line = rows[y].astype(np.int32)
        enc = np.empty(w * bpp, np.int32)
        for i in range(w * bpp):
            a = line[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if ft == 0:
                pred = 0
            elif ft == 1:
                pred = a
            elif ft == 2:
                pred = b
            elif ft == 3:
                pred = (a + b) >> 1
            else:
                pp = a + b - c
                pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            enc[i] = (line[i] - pred) & 0xFF
        raw.append(ft)
        raw.extend(enc.astype(np.uint8).tobytes())
        prev = line
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(bytes(raw))))
        f.write(_chunk(b"IEND", b""))


def test_kitti_png_all_filters(tmp_path, monkeypatch):
    """Sub/Up/Average/Paeth scanline filters decode exactly, through both
    the native C unfilter and the pure-NumPy fallback."""
    from eppm.io import native as native_mod
    from eppm.io.kitti import read_png16

    rng = np.random.default_rng(3)
    img = rng.integers(0, 65536, (11, 17, 3), dtype=np.uint16)
    p = str(tmp_path / "filt.png")
    _write_filtered_png16(p, img)
    np.testing.assert_array_equal(read_png16(p), img)
    monkeypatch.setattr(native_mod, "png_unfilter_native", lambda *a: None)
    np.testing.assert_array_equal(read_png16(p), img)


def test_kitti_png_missing_ihdr(tmp_path):
    import zlib

    from eppm.io.kitti import read_png16
    from eppm.io.png import _SIG, _chunk

    p = str(tmp_path / "noihdr.png")
    with open(p, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IDAT", zlib.compress(b"\x00" * 7)))
        f.write(_chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="IHDR"):
        read_png16(p)


def test_cli_override_rejects_non_field():
    """Properties (lr_thresh) are not config fields; the override must
    fail with a clean message, not an opaque dataclasses TypeError."""
    from eppm.cli import apply_overrides
    from eppm.config import DEFAULT_CONFIG

    with pytest.raises(SystemExit, match="unknown config field"):
        apply_overrides(DEFAULT_CONFIG, ["lr_thresh=3"])


@pytest.mark.slow
def test_dense_subpixel_fit_knob(rng):
    """dense_subpixel_fit produces a finite, fractional flow on a
    fractional-motion pair and leaves the default path untouched when
    off (it is opt-in; see PERF.md 'Subpixel variants')."""
    import dataclasses

    from eppm.config import EPPMConfig, PyramidConfig, RefineConfig
    from eppm.pipeline import compute_flow_jit

    small = rng.random((26, 34, 3)).astype(np.float32)
    img2 = np.asarray(
        jax.image.resize(jnp.asarray(small), (104, 136, 3), "cubic")
    ).clip(0, 1)
    # fractional shift by resampling: flow ~ (1.5, 0)
    xs = np.clip(np.arange(136) + 1.5, 0, 135)
    x0 = np.floor(xs).astype(int)
    x1 = np.minimum(x0 + 1, 135)
    a = (xs - x0)[None, :, None]
    img1 = (1 - a) * img2[:, x0] + a * img2[:, x1]
    cfg = EPPMConfig(
        pyramid=PyramidConfig(max_depth=2),
        refine=RefineConfig(wmf_coarse_iters=3),
    )
    base = np.asarray(
        compute_flow_jit(jnp.asarray(img1), jnp.asarray(img2), cfg=cfg)
    )
    cfg_fit = dataclasses.replace(cfg, dense_subpixel_fit=True)
    fit = np.asarray(
        compute_flow_jit(jnp.asarray(img1), jnp.asarray(img2), cfg=cfg_fit)
    )
    assert np.isfinite(fit).all()
    # the fit must actually move some pixels off the base field
    assert np.abs(fit - base).max() > 0
    b = 12
    err_base = np.abs(base[b:-b, b:-b, 0] - 1.5).mean()
    err_fit = np.abs(fit[b:-b, b:-b, 0] - 1.5).mean()
    # on pure fractional translation the parabola should not be worse
    assert err_fit < err_base + 0.05


def test_png_codec_variants(tmp_path, monkeypatch):
    """8/16-bit gray/RGB/RGBA round-trips through the generic PNG codec
    (io/png.py), via both the native unfilter and the NumPy fallback."""
    from eppm.io import native as native_mod
    from eppm.io.png import read_png, write_png

    rng2 = np.random.default_rng(11)
    cases = [
        rng2.integers(0, 256, (9, 13), dtype=np.uint8),          # gray8
        rng2.integers(0, 256, (9, 13, 3), dtype=np.uint8),       # rgb8
        rng2.integers(0, 256, (9, 13, 4), dtype=np.uint8),       # rgba8
        rng2.integers(0, 65536, (9, 13), dtype=np.uint16),       # gray16
        rng2.integers(0, 65536, (9, 13, 3), dtype=np.uint16),    # rgb16
    ]
    for i, img in enumerate(cases):
        p = str(tmp_path / f"c{i}.png")
        write_png(p, img)
        np.testing.assert_array_equal(read_png(p), img)
    monkeypatch.setattr(native_mod, "png_unfilter_native", lambda *a: None)
    for i, img in enumerate(cases):
        np.testing.assert_array_equal(
            read_png(str(tmp_path / f"c{i}.png")), img
        )


def test_read_image_normalizes(tmp_path):
    """read_image returns (H, W, 3) uint8 for gray, RGBA and 16-bit PNGs
    (Sintel-style frame ingestion, BASELINE Sintel config)."""
    from eppm.io import read_image
    from eppm.io.png import write_png

    rng2 = np.random.default_rng(12)
    gray = rng2.integers(0, 256, (7, 8), dtype=np.uint8)
    write_png(str(tmp_path / "g.png"), gray)
    out = read_image(str(tmp_path / "g.png"))
    assert out.shape == (7, 8, 3) and (out[..., 0] == gray).all()

    rgba = rng2.integers(0, 256, (7, 8, 4), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), rgba)
    out = read_image(str(tmp_path / "a.png"))
    np.testing.assert_array_equal(out, rgba[..., :3])

    deep = rng2.integers(0, 65536, (7, 8, 3), dtype=np.uint16)
    write_png(str(tmp_path / "d.png"), deep)
    out = read_image(str(tmp_path / "d.png"))
    np.testing.assert_array_equal(out, (deep // 257).astype(np.uint8))


def test_cli_stream_mode_png(tmp_path, rng):
    """Streaming consumes PNG frame sequences (Sintel-style) end-to-end."""
    from eppm.cli import main as cli_main
    from eppm.io.flo import read_flo
    from eppm.io.png import write_png

    frames_dir = tmp_path / "frames"
    out_dir = tmp_path / "flows"
    frames_dir.mkdir()
    img = (np.clip(_textured(rng, 48, 64), 0, 1) * 255).astype(np.uint8)
    for i in range(3):
        write_png(str(frames_dir / f"f{i}.png"), np.roll(img, -2 * i, 1))
    rc = cli_main([
        "--frames-dir", str(frames_dir), "--out-dir", str(out_dir),
        "--set", "pyramid.max_depth=2",
        "--set", "refine.wmf_coarse_iters=2",
    ])
    assert rc == 0
    flows = sorted(out_dir.iterdir())
    assert len(flows) == 2
    f = read_flo(str(flows[0]))
    assert f.shape == (48, 64, 2) and np.isfinite(f).all()
    b = 8
    # known motion: -2 px horizontal per frame
    assert abs(np.median(f[b:-b, b:-b, 0]) - (-2.0)) < 0.75


def test_cli_preset_expansion():
    """--set preset=fast expands to its override list; later explicit
    overrides win; unknown presets are rejected."""
    from eppm.cli import PRESETS, apply_overrides
    from eppm.config import DEFAULT_CONFIG

    cfg = apply_overrides(DEFAULT_CONFIG, ["preset=fast"])
    assert cfg.dense_cand_shape == "plus"
    assert cfg.cost.patch_stride == 4
    assert cfg.refine.blf_sigma_spatial == 3.0
    # explicit override after the preset wins
    cfg2 = apply_overrides(
        DEFAULT_CONFIG, ["preset=fast", "refine.blf_sigma_spatial=5.0"]
    )
    assert cfg2.refine.blf_sigma_spatial == 5.0
    import pytest as _pytest

    with _pytest.raises(SystemExit):
        apply_overrides(DEFAULT_CONFIG, ["preset=nope"])
    # every preset override must parse against the real config tree
    for name, ovs in PRESETS.items():
        apply_overrides(DEFAULT_CONFIG, [f"preset={name}"])


def test_preset_before_any_user_override():
    """A preset appearing AFTER an explicit --set must not clobber it
    (presets are hoisted to the front of the override list)."""
    from eppm.cli import apply_overrides
    from eppm.config import DEFAULT_CONFIG

    cfg = apply_overrides(
        DEFAULT_CONFIG, ["refine.blf_sigma_spatial=5.0", "preset=fast"]
    )
    assert cfg.refine.blf_sigma_spatial == 5.0


def test_eval_dossier_fingerprint_current():
    """Mechanical dossier gate: EVAL.json must carry the fingerprint of
    the CURRENT DEFAULT_CONFIG.  If this fails, a config default changed
    without regenerating the eval dossier — rerun
    `python tools/eval_report.py` in the same commit (EVAL.md's GATE)."""
    import json
    import os

    from eppm.config import config_fingerprint

    path = os.path.join(os.path.dirname(__file__), "..", "EVAL.json")
    if not os.path.exists(path):
        import pytest

        pytest.skip("no EVAL.json in tree")
    with open(path) as f:
        stamp = json.load(f).get("config_fingerprint")
    if stamp is None:
        import pytest

        pytest.skip(
            "pre-gate dossier format (no fingerprint); the gate arms on "
            "the first regeneration"
        )
    assert stamp == config_fingerprint(), (
        "config defaults changed since EVAL.json was generated — "
        "regenerate the dossier (python tools/eval_report.py) in this "
        "commit"
    )
