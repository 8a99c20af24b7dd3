"""PatchMatch convergence tests on synthetic pairs with known flow."""

import numpy as np
import jax
import jax.numpy as jnp

from eppm.config import CostConfig, PatchMatchConfig
from eppm.ops.census import census_transform
from eppm.ops.cost import pack_frame
from eppm.ops.patchmatch import patchmatch, random_init


def _packed_pair(rng, h, w, shift_x, shift_y):
    """img1(x, y) = img2(x+sx, y+sy): true target = pos + shift."""
    img2 = rng.random((h, w, 3)).astype(np.float32)
    img1 = np.roll(img2, (-shift_y, -shift_x), axis=(0, 1))
    p1 = pack_frame(jnp.asarray(img1), census_transform(jnp.asarray(img1)))
    p2 = pack_frame(jnp.asarray(img2), census_transform(jnp.asarray(img2)))
    return p1, p2


def test_random_init_bounds():
    tx, ty = random_init(jax.random.PRNGKey(0), 20, 30)
    tx, ty = np.asarray(tx), np.asarray(ty)
    assert tx.min() >= 0 and tx.max() <= 30  # inclusive upper bound (w)
    assert ty.min() >= 0 and ty.max() <= 20
    assert tx.std() > 1  # actually random


def test_patchmatch_recovers_uniform_shift(rng):
    h, w, sx, sy = 48, 64, 5, 3
    p1, p2 = _packed_pair(rng, h, w, sx, sy)
    pm_cfg = PatchMatchConfig(num_iters=6, prop_steps=(4, 2, 1))
    cost_cfg = CostConfig(patch_radius=3, sigma_spatial=1.5)
    tx, ty, cost = patchmatch(p1, p2, jax.random.PRNGKey(1234), pm_cfg, cost_cfg)
    ys, xs = np.mgrid[0:h, 0:w]
    u = np.asarray(tx) - xs
    v = np.asarray(ty) - ys
    # interior (away from the roll seam and patch border)
    m = (slice(8, h - 8), slice(8, w - sx - 8))
    frac_exact = ((u[m] == sx) & (v[m] == sy)).mean()
    assert frac_exact > 0.95, f"only {frac_exact:.2%} exact"


def test_patchmatch_deterministic(rng):
    h, w = 24, 32
    p1, p2 = _packed_pair(rng, h, w, 2, 1)
    pm_cfg = PatchMatchConfig(num_iters=2, prop_steps=(2, 1))
    cost_cfg = CostConfig(patch_radius=3, sigma_spatial=1.5)
    r1 = patchmatch(p1, p2, jax.random.PRNGKey(7), pm_cfg, cost_cfg)
    r2 = patchmatch(p1, p2, jax.random.PRNGKey(7), pm_cfg, cost_cfg)
    for a, b in zip(r1, r2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_patchmatch_cost_decreases(rng):
    """More iterations can never worsen the cost field (monotone argmin)."""
    h, w = 24, 32
    p1, p2 = _packed_pair(rng, h, w, 2, 1)
    cost_cfg = CostConfig(patch_radius=3, sigma_spatial=1.5)
    key = jax.random.PRNGKey(3)
    _, _, c1 = patchmatch(
        p1, p2, key, PatchMatchConfig(num_iters=1, prop_steps=(1,)), cost_cfg
    )
    _, _, c4 = patchmatch(
        p1, p2, key, PatchMatchConfig(num_iters=4, prop_steps=(1,)), cost_cfg
    )
    assert float(np.asarray(c4).mean()) <= float(np.asarray(c1).mean()) + 1e-6


def test_match_coarse_bidi_equals_two_calls(rng):
    """match_coarse_bidi shares pyramids/descriptors/global sweep across
    directions but must return per-direction results identical to two
    match_coarse calls (same quantized scores, same tie order)."""
    from eppm.config import MatchConfig
    from eppm.ops.match import match_coarse, match_coarse_bidi

    h, w = 40, 48
    img2 = rng.random((h, w, 3)).astype(np.float32)
    img1 = np.roll(img2, (-2, -1), axis=(1, 0))
    i1, i2 = jnp.asarray(img1), jnp.asarray(img2)
    cost_cfg = CostConfig(patch_radius=4, sigma_spatial=2.0)
    mcfg = MatchConfig(descent_levels=1, min_level_dim=16,
                       prop_steps=(2, 1), final_radius=1)
    fwd = match_coarse(i1, i2, cost_cfg, mcfg)
    bwd = match_coarse(i2, i1, cost_cfg, mcfg)
    bf, bb = match_coarse_bidi(i1, i2, cost_cfg, mcfg)
    for a, b in zip(fwd + bwd, bf + bb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_match_coarse_bidi_warm_start(rng):
    """Warm-start (init_flow) bidi equals two warm single-direction calls
    (forward seeded as-is, backward negated)."""
    from eppm.config import MatchConfig
    from eppm.ops.match import match_coarse, match_coarse_bidi

    h, w = 40, 48
    img2 = rng.random((h, w, 3)).astype(np.float32)
    img1 = np.roll(img2, (-2, -1), axis=(1, 0))
    i1, i2 = jnp.asarray(img1), jnp.asarray(img2)
    init = jnp.zeros((h, w, 2), jnp.float32) + jnp.asarray([1.0, 2.0])
    cost_cfg = CostConfig(patch_radius=4, sigma_spatial=2.0)
    for skip in (True, False):
        mcfg = MatchConfig(descent_levels=1, min_level_dim=16,
                           prop_steps=(2, 1), final_radius=1,
                           warm_skip_global=skip)
        fwd = match_coarse(i1, i2, cost_cfg, mcfg, init_flow=init)
        bwd = match_coarse(i2, i1, cost_cfg, mcfg, init_flow=-init)
        bf, bb = match_coarse_bidi(i1, i2, cost_cfg, mcfg, init_flow=init)
        for a, b in zip(fwd + bwd, bf + bb):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
