"""Free-flight solver tests: every solver must invert tau_total(t) = target
(reference distance_solvers.h semantics, minus the ones that are by design
approximate)."""

import numpy as np
import jax.numpy as jnp
import pytest

from gvr.config import Solver
from gvr.ops.transmittance import tau_coeffs, tau_up_to, far_bound
from gvr.ops.solvers import sample_free_flight, NO_SCATTER
from gvr.scene.gaussians import GaussianMixture

from oracle import OracleMixture
from test_gaussian_math import make_pair, random_rays


@pytest.mark.parametrize("solver", [Solver.NEWTON, Solver.BISECTION,
                                    Solver.ANALYTIC_NEWTON,
                                    Solver.ANALYTIC_BISECTION])
def test_solver_inverts_tau(rng, solver):
    om, gm = make_pair(rng, n=6)
    o, d = random_rays(rng, 128)
    rg = tau_coeffs(gm, jnp.asarray(o), jnp.asarray(d))
    tau_max = np.asarray(tau_up_to(rg, far_bound(rg)))
    # pick targets below the max so scatter must happen where tau_max > 0
    target = jnp.asarray(0.5 * tau_max + 1e-9, jnp.float32)
    t, scattered = sample_free_flight(rg, target, solver, iters=40)
    t = np.asarray(t)
    scat = np.asarray(scattered)
    assert scat.sum() > 16
    tau_at = np.asarray(tau_up_to(rg, jnp.asarray(np.where(scat, t, 0.0))))
    good = scat & (tau_max > 1e-4)
    np.testing.assert_allclose(tau_at[good], np.asarray(target)[good],
                               rtol=2e-3, atol=2e-4)


def test_no_scatter_when_target_exceeds_tau(rng):
    om, gm = make_pair(rng, n=4)
    o, d = random_rays(rng, 64)
    rg = tau_coeffs(gm, jnp.asarray(o), jnp.asarray(d))
    tau_max = np.asarray(tau_up_to(rg, far_bound(rg)))
    target = jnp.asarray(tau_max * 1.5 + 1.0, jnp.float32)
    t, scattered = sample_free_flight(rg, target, Solver.NEWTON, iters=24)
    assert not np.asarray(scattered).any()
    assert np.all(np.asarray(t) == NO_SCATTER)


def test_analytic_matches_newton_single_gaussian(rng):
    om, gm = make_pair(rng, n=1)
    o, d = random_rays(rng, 64)
    rg = tau_coeffs(gm, jnp.asarray(o), jnp.asarray(d))
    tau_max = np.asarray(tau_up_to(rg, far_bound(rg)))
    target = jnp.asarray(0.7 * tau_max + 1e-9, jnp.float32)
    t_n, s_n = sample_free_flight(rg, target, Solver.NEWTON, iters=40)
    t_a, s_a = sample_free_flight(rg, target, Solver.ANALYTIC_NEWTON,
                                  iters=40)
    good = np.asarray(s_n) & (tau_max > 1e-4)
    np.testing.assert_allclose(np.asarray(t_a)[good], np.asarray(t_n)[good],
                               rtol=1e-3, atol=1e-3)


def test_uniform_solver_within_critical_segment(rng):
    """UNIFORM must return a t inside the bracketing event segment
    (distance_solvers.h:132-137)."""
    om, gm = make_pair(rng, n=4)
    o, d = random_rays(rng, 64)
    rg = tau_coeffs(gm, jnp.asarray(o), jnp.asarray(d))
    tau_max = np.asarray(tau_up_to(rg, far_bound(rg)))
    target = jnp.asarray(0.5 * tau_max + 1e-9, jnp.float32)
    u = jnp.asarray(rng.uniform(size=64), jnp.float32)
    t, scattered = sample_free_flight(rg, target, Solver.UNIFORM, iters=1,
                                      u_uniform=u)
    t_n, _ = sample_free_flight(rg, target, Solver.NEWTON, iters=40)
    good = np.asarray(scattered) & (tau_max > 1e-3)
    # the exact root and the uniform sample share the same segment; with
    # many candidates just check plausibility bounds
    t_lo = np.asarray(jnp.min(jnp.where(rg.hit, rg.t0, jnp.inf), axis=-1))
    t_hi = np.asarray(far_bound(rg))
    assert np.all(np.asarray(t)[good] >= t_lo[good] - 1e-5)
    assert np.all(np.asarray(t)[good] <= t_hi[good] + 1e-5)


def test_default_iters_leave_no_biased_root_tail(scene_files):
    """Regression for the round-4 solver_iters=8 episode: the p99 tau
    residual looked converged while a tail of rays carried grossly wrong
    free-flight roots (bias, not variance).  Pin the TAIL at the
    production default on the headline fixture: measured frac(rel>1%) /
    max_rel here is 0.15% / 5.4 at 8 iters, 0.06% / 0.42 at 10, 0 / 0.004
    at 12 — the bounds below pass from 12 iterations on."""
    from gvr.config import RenderConfig
    from gvr.scene.scene import load_gmm
    path = scene_files["250_random.txt"]
    gmm = load_gmm(path).medium
    rng = np.random.default_rng(11)
    lo = np.asarray(gmm.mean).min(0) - 0.5
    hi = np.asarray(gmm.mean).max(0) + 0.5
    o = rng.uniform(lo, hi, (8192, 3)).astype(np.float32)
    d = rng.normal(size=(8192, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rg = tau_coeffs(gmm, jnp.asarray(o), jnp.asarray(d))
    tau_max = np.asarray(tau_up_to(rg, far_bound(rg)))
    u = rng.uniform(size=8192).astype(np.float32)
    target = jnp.asarray(u * tau_max * 0.999, jnp.float32)

    iters = RenderConfig().solver_iters
    t, scattered = sample_free_flight(rg, target, Solver.NEWTON, iters)
    scat = np.asarray(scattered) & (tau_max > 1e-3)
    tgt = np.asarray(target)[scat]
    res = np.abs(np.asarray(tau_up_to(rg, jnp.asarray(t)))[scat] - tgt)
    rel = res / np.maximum(tgt, 1e-6)
    frac_bad = float((rel > 0.01).mean())
    assert frac_bad <= 1e-4, f"biased-root tail: {frac_bad:.5f} of rays >1%"
    assert float(rel.max()) < 0.05, f"worst relative residual {rel.max():.3f}"


def test_analytic_finisher_is_exact_where_it_fires(rng):
    """The per-segment erfinv finisher (distance_solvers.h:176-186) must
    replace the Newton iterate with a root whose tau residual is at float
    precision wherever it fires — i.e. ANALYTIC_NEWTON at very few
    iterations + finisher must beat the same budget without it on scenes
    where most roots have exactly one active Gaussian."""
    from gvr.scene.scene import parse_gmm
    from gvr.scene.generators import random_gaussian_scene

    # well-separated small supports -> mostly single-active roots
    gm = parse_gmm(random_gaussian_scene(
        40, seed=9, diameter=(0.08, 0.18), density=(2.0, 6.0))).medium
    o, d = random_rays(rng, 512)
    rg = tau_coeffs(gm, jnp.asarray(o), jnp.asarray(d))
    tau_max = np.asarray(tau_up_to(rg, far_bound(rg)))
    u = rng.uniform(size=512).astype(np.float32)
    target = jnp.asarray(u * tau_max * 0.999, jnp.float32)

    t_ref, sc_ref = sample_free_flight(rg, target, Solver.NEWTON, 40)
    t_fin, _ = sample_free_flight(rg, target, Solver.ANALYTIC_NEWTON, 4,
                                  finisher=True)
    t_off, _ = sample_free_flight(rg, target, Solver.ANALYTIC_NEWTON, 4,
                                  finisher=False)
    m = np.asarray(sc_ref) & (tau_max > 1e-3)
    assert m.sum() > 100
    d_fin = np.abs(np.asarray(t_fin) - np.asarray(t_ref))[m]
    d_off = np.abs(np.asarray(t_off) - np.asarray(t_ref))[m]
    # the finisher must land most roots at the converged reference even
    # with a 4-iteration budget...
    assert np.median(d_fin) < 1e-5, np.median(d_fin)
    # ... and be a strict improvement over the same budget without it
    assert np.percentile(d_fin, 90) < np.percentile(d_off, 90)


def test_kernel_finisher_matches_xla_finisher(rng):
    """The grid engine's in-cell solve (integrators/gridscatter, always-on
    analytic finisher) and the dense XLA solver with cfg.solver_finisher
    reach the same roots at the same small iteration budget: both run the
    shared ops/solvers Newton + finisher, on the critical cell's entries
    and on every Gaussian respectively."""
    from gvr.scene.scene import parse_gmm
    from gvr.scene.generators import random_gaussian_scene
    from gvr.accel.grid import build_grid
    from gvr.integrators.gridscatter import grid_free_flight

    sc = parse_gmm(random_gaussian_scene(
        40, seed=9, diameter=(0.08, 0.18), density=(2.0, 6.0)))
    gm = sc.medium
    o, d = random_rays(rng, 512)
    o = jnp.asarray(o, jnp.float32)
    d = jnp.asarray(d, jnp.float32)
    u = jnp.asarray(rng.uniform(size=512), jnp.float32)

    rg = tau_coeffs(gm, o, d)
    target = -jnp.log(jnp.maximum(1.0 - u, 1e-12))
    t_x, sc_x = sample_free_flight(rg, target, Solver.NEWTON, 6,
                                   finisher=True)
    t_g, sc_g, *_ = grid_free_flight(build_grid(gm), o, d, u, 6)
    m = np.asarray(sc_x) & np.asarray(sc_g)
    assert m.sum() > 100
    dt = np.abs(np.asarray(t_g) - np.asarray(t_x))[m]
    assert np.median(dt) < 1e-5, np.median(dt)
