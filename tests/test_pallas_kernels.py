"""Megakernel equivalence tests (Pallas interpreter on the CPU mesh).

The Triton-route megakernel (kernels/megatrace.py) must reproduce the XLA
wavefront: same estimator, same (pixel, sample, bounce) RNG streams, so
images agree to float tolerance (the kernel's A&S erf differs from
lax.erf by <= 1.5e-7 absolute), except where a marginal scatter decision
flips and the path diverges chaotically — hence mean/median bars at
larger N.  Also: the wrapper's table layout, padding and shape checks, and
the engine choice by platform."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gvr.scene.scene import parse_gmm
from gvr.scene.generators import random_gaussian_scene
from gvr.cameras import PinholeCamera
from gvr.config import RenderConfig, Solver
from gvr.ops.transmittance import tau_coeffs, tau_total
from gvr.integrators.multiscatter import wavefront_pixels

CAM = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)


def _random_rays(n, key):
    k1, k2 = jax.random.split(key)
    o = jax.random.uniform(k1, (n, 3), minval=-1.5, maxval=1.5) \
        + jnp.array([0.0, 1.0, 1.5])
    d = jax.random.normal(k2, (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _mega_vs_xla(sc, cfg, n_px):
    ids = jnp.arange(n_px, dtype=jnp.int32)
    img_mega = np.asarray(wavefront_pixels(sc, CAM, cfg, ids))
    img_xla = np.asarray(wavefront_pixels(
        sc, CAM, cfg.replace(pallas="off"), ids))
    assert np.isfinite(img_mega).all()
    return img_mega, img_xla


def test_small_kernel_matches_xla(rng):
    """One bounce per path (max_bounces=1): free-flight solve, albedo, NEE
    and escape of the kernel against the XLA step, per pixel."""
    sc = parse_gmm(random_gaussian_scene(120, seed=1,
                                         diameter=(0.1, 0.4),
                                         density=(0.5, 2.0)))
    cfg = RenderConfig(width=16, height=16, spp=4, max_bounces=1,
                       pallas="interpret")
    img_mega, img_xla = _mega_vs_xla(sc, cfg, 256)
    assert img_xla.mean() > 0.0
    # the kernel's A&S erf is within 1.5e-7 of lax.erf; the optical depth
    # scales that by the prefactor, so bright pixels agree to ~1e-3 rel
    np.testing.assert_allclose(img_mega, img_xla, rtol=1e-3, atol=1e-4)


def test_megakernel_matches_step_wavefront(rng):
    """The persistent megakernel (whole sample/bounce loop in one Pallas
    program) must reproduce the XLA wavefront: same estimator, same RNG
    streams, so images agree to float tolerance."""
    sc = parse_gmm(random_gaussian_scene(24, seed=7,
                                         diameter=(0.2, 0.6),
                                         density=(0.5, 2.0)))
    # spp=9 -> n_strat=3: exercises the in-kernel stratified-jitter math
    # (integer stratum + /n_strat offset), the one piece of ray-gen the
    # kernel re-derives instead of sharing with the XLA path
    cfg = RenderConfig(width=16, height=16, spp=9, max_bounces=6,
                       pallas="interpret")
    img_mega, img_xla = _mega_vs_xla(sc, cfg, 256)
    np.testing.assert_allclose(img_mega, img_xla, atol=1e-4)


def test_megakernel_midrange_matches_big_and_xla(rng):
    """Midrange N (1000 Gaussians, 125 table tiles): sums over tiles
    differ in association order from XLA's reductions, so marginal
    scatter decisions can flip and diverge chaotically on a few pixels —
    mean/median bars, not max-abs."""
    n = 1000
    sc = parse_gmm(random_gaussian_scene(n, seed=11,
                                         diameter=(0.05, 0.25),
                                         density=(0.5, 2.0)))
    sc = sc.with_medium(sc.medium.morton_sorted())
    cfg = RenderConfig(width=16, height=16, spp=4, max_bounces=4,
                       pallas="interpret")
    img_mega, img_xla = _mega_vs_xla(sc, cfg, 256)
    dm = np.abs(img_mega - img_xla)
    assert np.median(dm) < 1e-4, np.median(dm)
    assert abs(img_mega.mean() - img_xla.mean()) < 5e-3 * max(
        img_xla.mean(), 1e-6), (img_mega.mean(), img_xla.mean())


def test_block_override_is_estimator_invariant(rng):
    """The wrapper's block and tile are pure launch geometry: RNG is keyed
    by (pixel, sample, bounce), never lane index, and the tile only
    regroups the per-ray Gaussian sums, so the images agree to f32
    rounding."""
    from gvr.kernels import megatrace as mt
    from gvr.integrators.multiscatter import static_lights_of, strat_n
    sc = parse_gmm(random_gaussian_scene(24, seed=7,
                                         diameter=(0.2, 0.6),
                                         density=(0.5, 2.0)))
    lp, li, env = static_lights_of(sc)
    cfg_t = (16, 16, 2, strat_n(2), 0, 12, 5, 0.9, 16, 0.5, 4)
    ids = jnp.arange(256, dtype=jnp.int32)
    cv = mt.camera_vector(CAM)

    def run(block, tile):
        return np.asarray(mt.mega_call(
            cv, mt.pack_table(sc.medium, tile), ids, cfg_t, lp, li, env,
            pinhole=True, interpret=True, block=block, tile=tile))

    ref = run(128, 8)
    np.testing.assert_allclose(run(64, 8)[:3], ref[:3], atol=1e-6)
    np.testing.assert_allclose(run(128, 4)[:3], ref[:3], atol=1e-5)


def test_megakernel_matches_xla_deep_bounces(rng):
    """Deep-path variant: early RR (min_scatter=1) and the two-stage RR
    tail (rr_tail_after=3) both active within max_bounces=10 — exercises
    the in-kernel RR/tail-cap arithmetic the short test never reaches."""
    sc = parse_gmm(random_gaussian_scene(16, seed=9,
                                         diameter=(0.3, 0.8),
                                         density=(1.0, 3.0)))
    cfg = RenderConfig(width=8, height=8, spp=4, max_bounces=10,
                       min_scatter=1, rr_tail_after=3, rr_cap_tail=0.4,
                       pallas="interpret")
    img_mega, img_xla = _mega_vs_xla(sc, cfg, 64)
    np.testing.assert_allclose(img_mega, img_xla, atol=1e-4)


def test_orthographic_megakernel_matches_xla(rng):
    """The kernel's orthographic ray generation (static camera kind)."""
    from gvr.cameras import OrthographicCamera
    sc = parse_gmm(random_gaussian_scene(24, seed=3,
                                         diameter=(0.2, 0.6)))
    cam = OrthographicCamera.create([0, 1, 6], [0, 1, 0])
    cfg = RenderConfig(width=8, height=8, spp=4, max_bounces=4,
                       pallas="interpret")
    ids = jnp.arange(64, dtype=jnp.int32)
    a = np.asarray(wavefront_pixels(sc, cam, cfg, ids))
    b = np.asarray(wavefront_pixels(sc, cam, cfg.replace(pallas="off"),
                                    ids))
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_pack_table_layout_and_padding():
    """[16, Np] feature-major table: Np rounds N up to the tile, real
    columns carry the mixture's features, padding columns are an identity
    quadratic with zero density and valid = 0."""
    from gvr.kernels.megatrace import pack_table, N_FEAT
    g = parse_gmm(random_gaussian_scene(13, seed=2)).medium
    tab = np.asarray(pack_table(g, 8))
    assert tab.shape == (N_FEAT, 16)
    np.testing.assert_allclose(tab[12:15, :13].T, np.asarray(g.mean))
    np.testing.assert_allclose(tab[10, :13], np.asarray(g.albedo))
    assert (tab[11, :13] == 1).all() and (tab[11, 13:] == 0).all()
    assert (tab[9, 13:] == 0).all()
    assert (tab[0:3, 13:] == 1).all() and (tab[3:9, 13:] == 0).all()
    assert pack_table(g, 16).shape == (N_FEAT, 16)
    assert pack_table(g, 1).shape == (N_FEAT, 13)


def test_mega_call_rejects_bad_shapes():
    from gvr.kernels import megatrace as mt
    g = parse_gmm(random_gaussian_scene(10, seed=2)).medium
    cfg_t = (8, 8, 1, 1, 0, 4, 5, 0.9, 16, 0.5, 2)
    cv = mt.camera_vector(CAM)
    call = lambda tab, ids, **kw: mt.mega_call(
        cv, tab, ids, cfg_t, (), (), (0.5, 0.5, 0.5), pinhole=True,
        interpret=True, **kw)
    with pytest.raises(ValueError, match="multiple of block"):
        call(mt.pack_table(g, 8), jnp.arange(100, dtype=jnp.int32))
    with pytest.raises(ValueError, match="powers of two"):
        call(mt.pack_table(g, 8), jnp.arange(96, dtype=jnp.int32),
             block=96)
    with pytest.raises(ValueError, match="pack_table"):
        call(mt.pack_table(g, 8), jnp.arange(128, dtype=jnp.int32),
             tile=32)


def test_wavefront_pads_ragged_chunks(rng):
    """A pixel chunk that is not a multiple of the kernel block is padded
    with repeats of its last id and trimmed: the first pixels render the
    same as in a whole-block chunk."""
    sc = parse_gmm(random_gaussian_scene(12, seed=4, diameter=(0.2, 0.6)))
    cfg = RenderConfig(width=16, height=16, spp=1, max_bounces=3,
                       pallas="interpret")
    full = np.asarray(wavefront_pixels(
        sc, CAM, cfg, jnp.arange(256, dtype=jnp.int32)))
    part = np.asarray(wavefront_pixels(
        sc, CAM, cfg, jnp.arange(100, dtype=jnp.int32)))
    assert part.shape == (100, 3)
    np.testing.assert_allclose(part, full[:100], atol=1e-6)


def test_kernel_choice_by_platform():
    """'auto' takes the kernel only on a GPU backend (plain XLA on this
    CPU mesh); 'interpret' always; 'off' never; configurations the kernel
    does not implement stay on XLA."""
    from gvr.integrators.multiscatter import kernel_enabled
    assert jax.default_backend() == "cpu"
    assert not kernel_enabled(RenderConfig())
    assert kernel_enabled(RenderConfig(pallas="interpret"))
    assert not kernel_enabled(RenderConfig(pallas="off"))
    for kw in ({"solver": Solver.BISECTION}, {"solver_finisher": True},
               {"candidate_k": 8}):
        assert not kernel_enabled(RenderConfig(pallas="interpret", **kw))


def test_pallas_on_without_gpu_raises():
    from gvr.integrators.multiscatter import (kernel_enabled,
                                                  render_multiscatter)
    with pytest.raises(ValueError, match="GPU"):
        kernel_enabled(RenderConfig(pallas="on"))
    sc = parse_gmm(random_gaussian_scene(4, seed=1))
    with pytest.raises(ValueError, match="GPU"):
        render_multiscatter(sc, CAM, RenderConfig(width=8, height=8, spp=1,
                                                  pallas="on"))


def test_morton_sort_is_order_invariant(rng):
    sc = parse_gmm(random_gaussian_scene(200, seed=3))
    g = sc.medium
    gs = g.morton_sorted()
    o, d = _random_rays(64, jax.random.key(2))
    a = tau_total(tau_coeffs(g, o, d))
    b = tau_total(tau_coeffs(gs, o, d))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-5)


def test_tile_order_is_permutation():
    from gvr.integrators.multiscatter import tile_order
    for w, h in ((32, 32), (48, 24), (17, 9)):
        order = tile_order(w, h)
        assert sorted(order.tolist()) == list(range(w * h))
    # 16x8 tiles: the first 128 ids form one tile
    order = tile_order(64, 64)
    first = order[:128]
    xs, ys = first % 64, first // 64
    assert xs.max() - xs.min() == 15
    assert ys.max() - ys.min() == 7
