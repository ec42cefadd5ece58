"""PureRayMarching (marched transmittance) + whitening intersection tests."""

import math

import numpy as np
import jax.numpy as jnp

from gvr.scene.scene import parse_gmm, parse_smm
from gvr.cameras import PinholeCamera, OrthographicCamera
from gvr.config import RenderConfig
from gvr.integrators.raymarch import (
    render_pure_raymarch, render_raymarch_gaussians, march_transmittance)
from gvr.ops.transmittance import transmittance_up_to
from gvr.ops.quadratics import (intersect_gaussians,
                                    intersect_gaussians_whitening)

from test_gaussian_math import make_pair, random_rays

CAM = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)


def test_whitening_matches_direct(rng):
    om, gm = make_pair(rng, n=8)
    o, d = random_rays(rng, 48)
    t0a, t1a, ha = intersect_gaussians(gm, jnp.asarray(o), jnp.asarray(d))
    t0b, t1b, hb = intersect_gaussians_whitening(gm, jnp.asarray(o),
                                                 jnp.asarray(d))
    ha, hb = np.asarray(ha), np.asarray(hb)
    both = ha & hb
    # grazing rays may disagree on hit classification; interiors must agree
    assert (ha == hb).mean() > 0.98
    np.testing.assert_allclose(np.asarray(t0a)[both], np.asarray(t0b)[both],
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(np.asarray(t1a)[both], np.asarray(t1b)[both],
                               rtol=5e-3, atol=5e-3)


def test_marched_transmittance_converges_to_analytic(rng):
    """march_transmittance -> closed form as step -> 0
    (PureRayMarching's estimator vs the analytic one)."""
    om, gm = make_pair(rng, n=3)
    o = jnp.asarray(rng.uniform(-0.5, 0.5, (16, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(16, 3)), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    tmax = jnp.full((16,), 4.0)
    exact = np.asarray(transmittance_up_to(gm, o, d, tmax))
    approx = np.asarray(march_transmittance(gm, o, d, tmax, 0.002, 2001))
    np.testing.assert_allclose(approx, exact, atol=0.02)


def test_pure_raymarch_matches_analytic_marcher():
    """On a pure-absorption scene both marchers reduce to T * env, so they
    must agree tightly despite different transmittance estimators."""
    sc = parse_gmm("g 0 1 0  0.08 0.01 0  0.06 0 0.1  1.0 0.0\n")
    cfg = RenderConfig(width=16, height=16, env_samples=1, step_size=0.02)
    a = render_pure_raymarch(sc, CAM, cfg)
    b = render_raymarch_gaussians(sc, CAM, cfg)
    np.testing.assert_allclose(a, b, atol=0.03)


def test_pure_raymarch_spheres():
    sc = parse_smm("l 0 4 0  10 10 10\ns 0 1 0  0.8  0.1 0.5\n")
    cam = OrthographicCamera.create([0, 1, 6], [0, 1, 0])
    cfg = RenderConfig(width=12, height=12, env_samples=1, step_size=0.05)
    img = render_pure_raymarch(sc, cam, cfg)
    assert np.isfinite(img).all()
    assert img.min() >= 0.0
    # center pixel darker than the env-only corners (absorbing sphere)
    assert img[6, 6].sum() != img[0, 0].sum()
