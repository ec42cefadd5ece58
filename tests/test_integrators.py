"""Integrator correctness tests at small resolution.

Strategy (SURVEY §4): closed-form checks where the physics admits one
(pure-absorption scenes: L = T_total * env exactly), plus cross-integrator
statistical consistency for the MC estimators.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from gvr.scene.scene import parse_gmm, parse_smm, Scene
from gvr.scene.gaussians import GaussianMixture
from gvr.cameras import PinholeCamera, OrthographicCamera
from gvr.config import RenderConfig, Solver
from gvr.integrators.test_hit import render_hit_mask
from gvr.integrators.raymarch import (render_raymarch_gaussians,
                                          render_raymarch_spheres)
from gvr.integrators.multiscatter import render_multiscatter
from gvr.integrators.freeflight import render_single_scatter
from gvr.ops.transmittance import transmittance_up_to
from gvr.cameras import pixel_center_uv

ABSORB_SCENE = "g 0 1 0  0.08 0.01 0  0.06 0 0.1  2.0 0.0\n"   # albedo 0
SCATTER_SCENE = ("l 0 4 0  30 30 30\n"
                 "g 0 1 0  0.08 0.01 0  0.06 0 0.1  1.5 0.8\n")
CAM = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
W = H = 24


def closed_form_absorption(scene, cam, w, h):
    """Pure absorption + env only: L = T(infinity) * env per pixel."""
    uv = pixel_center_uv(w, h).reshape(-1, 2)
    o, d = cam.sample_ray(uv)
    tr = transmittance_up_to(scene.medium, o, d, jnp.float32(1e8))
    img = np.asarray(tr)[:, None] * np.asarray(scene.env_color)
    return img.reshape(h, w, 3)


def test_hit_mask():
    sc = parse_gmm(ABSORB_SCENE)
    img = render_hit_mask(sc, CAM, RenderConfig(width=W, height=H))
    # center hits (magenta), corner misses (env)
    np.testing.assert_allclose(img[H // 2, W // 2], [1, 0, 1], atol=1e-6)
    np.testing.assert_allclose(img[0, 0], [0.53, 0.81, 0.92], atol=1e-6)
    assert 0.0 < (img[..., 1] < 0.5).mean() < 1.0


def test_raymarch_pure_absorption_closed_form():
    """With albedo=0 and no lights, the marcher must reproduce
    T_total * env (analytic transmittance end to end)."""
    sc = parse_gmm(ABSORB_SCENE)
    cfg = RenderConfig(width=W, height=H, env_samples=1, step_size=0.01)
    img = render_raymarch_gaussians(sc, CAM, cfg)
    want = closed_form_absorption(sc, CAM, W, H)
    np.testing.assert_allclose(img, want, atol=5e-3)


def test_multiscatter_pure_absorption_statistics():
    """Albedo=0 kills paths at the first scatter, so
    E[L] = P(escape) * env = T_total * env."""
    sc = parse_gmm(ABSORB_SCENE)
    cfg = RenderConfig(width=W, height=H, spp=144, solver=Solver.NEWTON)
    img = render_multiscatter(sc, CAM, cfg)
    want = closed_form_absorption(sc, CAM, W, H)
    err = np.abs(img - want).mean()
    assert err < 0.02, err


def test_single_scatter_matches_multiscatter_thin():
    """In a thin medium, multi-scatter ~ single-scatter + small correction;
    both MC estimators must agree closely on a low-albedo scene."""
    sc = parse_gmm("l 0 4 0  30 30 30\n"
                   "g 0 1 0  0.08 0.01 0  0.06 0 0.1  0.4 0.3\n")
    cfg = RenderConfig(width=W, height=H, spp=256)
    ss = render_single_scatter(sc, CAM, cfg)
    ms = render_multiscatter(sc, CAM, cfg.replace(seed=7))
    assert np.abs(ss - ms).mean() < 0.01


@pytest.mark.parametrize("solver", [Solver.NEWTON, Solver.BISECTION,
                                    Solver.ANALYTIC_NEWTON,
                                    Solver.ANALYTIC_BISECTION])
def test_solver_choice_does_not_change_image(solver):
    """Exact solvers must agree on the rendered image given identical seeds
    (the ablation of distance_solvers.h, minus UNIFORM which is biased)."""
    sc = parse_gmm(SCATTER_SCENE)
    cfg = RenderConfig(width=16, height=16, spp=32, solver=solver)
    img = render_multiscatter(sc, CAM, cfg)
    cfg_ref = cfg.replace(solver=Solver.NEWTON, solver_iters=40)
    ref = render_multiscatter(sc, CAM, cfg_ref)
    # last-ulp root differences can flip a path's later RNG trajectory
    # (chaotic divergence) — require statistical agreement, not bitwise
    diff = np.abs(img - ref)
    assert diff.mean() < 1e-3, diff.mean()
    assert (diff < 2e-3).mean() > 0.98


def test_multiscatter_deterministic_same_seed():
    sc = parse_gmm(SCATTER_SCENE)
    cfg = RenderConfig(width=16, height=16, spp=8)
    a = render_multiscatter(sc, CAM, cfg)
    b = render_multiscatter(sc, CAM, cfg)
    np.testing.assert_array_equal(a, b)


def test_multiscatter_chunk_invariance():
    """Radiance must not depend on how rays are batched into chunks."""
    sc = parse_gmm(SCATTER_SCENE)
    cfg = RenderConfig(width=16, height=16, spp=8)
    a = render_multiscatter(sc, CAM, cfg.replace(ray_chunk=64))
    b = render_multiscatter(sc, CAM, cfg.replace(ray_chunk=1 << 16))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_raymarch_spheres_pure_absorption():
    sc = parse_smm("s 0 1 0  1.0  0.8 0.0\n")
    cam = OrthographicCamera.create([0, 1, 6], [0, 1, 0])
    cfg = RenderConfig(width=W, height=H, env_samples=1, step_size=0.01)
    img = render_raymarch_spheres(sc, cam, cfg)
    # closed form: chord length through the sphere
    uv = pixel_center_uv(W, H).reshape(-1, 2)
    o, d = cam.sample_ray(uv)
    t0, t1, hit = sc.medium.intersect(o, d)
    chord = np.where(np.asarray(hit)[:, 0],
                     np.asarray(t1 - t0)[:, 0], 0.0)
    want = (np.exp(-0.8 * chord)[:, None]
            * np.asarray(sc.env_color)).reshape(H, W, 3)
    np.testing.assert_allclose(img, want, atol=2e-2)
