"""Unit tests for the Gaussian primitive math against the float64 oracle.

Mirrors the closed forms of reference gaussian.h:111-231 (evaluation,
intersection, optical depth) and the parameter codec gmm.h:583-674.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gvr.scene.gaussians import GaussianMixture
from gvr.ops.quadratics import ray_quadratics, intersect_gaussians
from gvr.ops.transmittance import (
    tau_coeffs, tau_up_to, transmittance_up_to, sigma_t_at, far_bound)

from oracle import OracleMixture


def make_pair(rng, n=8):
    om = OracleMixture.random(rng, n)
    gm = GaussianMixture.from_covariances(
        np.array([g.mean for g in om.g]),
        np.array([g.cov for g in om.g]),
        np.array([g.density for g in om.g]),
        np.array([g.albedo for g in om.g]))
    return om, gm


def random_rays(rng, m):
    o = rng.uniform(-4, 4, (m, 3))
    # aim at points inside the Gaussian box so most rays hit the medium
    target = rng.uniform(-0.8, 0.8, (m, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_evaluate_matches_oracle(rng):
    om, gm = make_pair(rng)
    xs = rng.uniform(-1.5, 1.5, (32, 3)).astype(np.float32)
    got = np.asarray(gm.mu_t(jnp.asarray(xs)))
    want = np.array([[g.mu_t(x) for g in om.g] for x in xs])
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-6)


def test_quadratics_match_oracle(rng):
    om, gm = make_pair(rng)
    o, d = random_rays(rng, 16)
    a, b, c = ray_quadratics(gm, jnp.asarray(o), jnp.asarray(d))
    for i in range(o.shape[0]):
        for j, g in enumerate(om.g):
            aa, bb, cc = g.quad(o[i], d[i])
            rel = max(abs(aa), abs(bb), abs(cc), 1.0)
            assert abs(float(a[i, j]) - aa) < 2e-4 * rel
            assert abs(float(b[i, j]) - bb) < 2e-4 * rel
            assert abs(float(c[i, j]) - cc) < 2e-4 * rel


def test_intersection_matches_oracle(rng):
    om, gm = make_pair(rng, n=12)
    o, d = random_rays(rng, 64)
    t0, t1, hit = intersect_gaussians(gm, jnp.asarray(o), jnp.asarray(d))
    t0 = np.maximum(np.asarray(t0), 0.0)
    agree = 0
    for i in range(o.shape[0]):
        for j, g in enumerate(om.g):
            want = g.intersect(o[i], d[i])
            if want is None:
                # tolerate tangent-ray disagreements (grazing hits)
                if bool(hit[i, j]):
                    a, b, c = g.quad(o[i], d[i])
                    disc = b * b - 4 * a * (c - 9.0)
                    assert abs(disc) < 1e-2 * max(abs(b * b), 1.0)
                continue
            assert bool(hit[i, j])
            np.testing.assert_allclose(t0[i, j], want[0], rtol=2e-3,
                                       atol=2e-3)
            np.testing.assert_allclose(np.asarray(t1)[i, j], want[1],
                                       rtol=2e-3, atol=2e-3)
            agree += 1
    assert agree > 10  # sanity: fixture actually exercises hits


def test_tau_matches_oracle_closed_form(rng):
    om, gm = make_pair(rng)
    o, d = random_rays(rng, 32)
    rg = tau_coeffs(gm, jnp.asarray(o), jnp.asarray(d))
    for t in [0.5, 2.0, 10.0]:
        got = np.asarray(tau_up_to(rg, jnp.float32(t)))
        want = np.array([om.tau_up_to(o[i], d[i], t) for i in range(len(o))])
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)


def test_tau_matches_quadrature(rng):
    """Closed-form erf optical depth == brute-force integral of extinction."""
    om, gm = make_pair(rng, n=3)
    o = np.array([[0.0, 0.0, 3.0]], np.float32)
    d = np.array([[0.0, 0.0, -1.0]], np.float32)
    rg = tau_coeffs(gm, jnp.asarray(o), jnp.asarray(d))
    got = float(tau_up_to(rg, jnp.float32(6.0))[0])
    want = om.tau_quadrature(o[0], d[0], 6.0)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-5)


def test_sigma_t_is_tau_derivative(rng):
    om, gm = make_pair(rng)
    o, d = random_rays(rng, 8)
    rg = tau_coeffs(gm, jnp.asarray(o), jnp.asarray(d))
    eps = 1e-3
    for t in [1.0, 3.0]:
        num = (np.asarray(tau_up_to(rg, jnp.float32(t + eps)))
               - np.asarray(tau_up_to(rg, jnp.float32(t - eps)))) / (2 * eps)
        ana = np.asarray(sigma_t_at(rg, jnp.float32(t)))
        np.testing.assert_allclose(ana, num, rtol=5e-2, atol=5e-3)


def test_transmittance_bounds(rng):
    om, gm = make_pair(rng)
    o, d = random_rays(rng, 64)
    tr = np.asarray(transmittance_up_to(gm, jnp.asarray(o), jnp.asarray(d),
                                        jnp.float32(100.0)))
    assert np.all(tr >= 0.0) and np.all(tr <= 1.0 + 1e-6)


def test_aabb_contains_ellipsoid(rng):
    om, gm = make_pair(rng, n=5)
    bmin, bmax = gm.aabbs()
    bmin, bmax = np.asarray(bmin), np.asarray(bmax)
    # sample ellipsoid surface points, all must be inside the AABB
    for j, g in enumerate(om.g):
        evals, evecs = np.linalg.eigh(g.cov)
        for _ in range(64):
            u = rng.normal(size=3)
            u /= np.linalg.norm(u)
            p = g.mean + evecs @ (3.0 * np.sqrt(evals) * u)
            assert np.all(p >= bmin[j] - 1e-4)
            assert np.all(p <= bmax[j] + 1e-4)


def test_param_codec_roundtrip(rng):
    om, gm = make_pair(rng, n=10)
    params = gm.pack_parameters()
    assert params.shape == (10 * 11,)
    gm2 = GaussianMixture.from_parameters(params)
    np.testing.assert_allclose(np.asarray(gm2.mean), np.asarray(gm.mean),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(gm2.cov), np.asarray(gm.cov),
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gm2.density),
                               np.asarray(gm.density), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(gm2.albedo),
                               np.asarray(gm.albedo), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gm2.inv_cov),
                               np.asarray(gm.inv_cov), rtol=5e-3, atol=1e-2)


def test_rodrigues_roundtrip(rng):
    from gvr.scene.gaussians import (rodrigues_to_rotation,
                                         rotation_to_rodrigues)
    rod = rng.uniform(-2.5, 2.5, (40, 3)).astype(np.float32)
    r = rodrigues_to_rotation(jnp.asarray(rod))
    rod2 = rotation_to_rodrigues(r)
    r2 = rodrigues_to_rotation(rod2)
    # rotation matrices must round-trip (rod vector itself may alias by 2pi)
    np.testing.assert_allclose(np.asarray(r2), np.asarray(r), atol=2e-5)
