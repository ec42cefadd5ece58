"""Stochastic finite-difference gradients — validation mode only.

Two estimators mirroring the reference (inverse_integrator.h:140-193):

* ``sfd_gradient`` — global-loss SFD: Rademacher sign vectors s, forward
  differences over params +/- s*eps, grad ~= mean_s [(L(p+s eps)-L(p))*s/eps].
* ``sfd_gradient_localized`` — the reference's full estimator
  (inverse_integrator.h:118-188): per-pixel L1 losses (:20-29), per-Gaussian
  loss deltas restricted to the **union of base + perturbed pixel
  footprints** (:165-179), footprints from ``inverse/attribution.py``
  (the RECORD_PIXEL_GAUSSIANS machinery, integrator.h:526-545).

This framework's real optimizer is autodiff (fit.py); these exist to
cross-check gradient signs and magnitudes (BASELINE config #4).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from gvr.scene.gaussians import (default_param_eps,
                                     PARAMS_PER_GAUSSIAN)


def sfd_gradient(loss_of_params: Callable, params: jnp.ndarray,
                 num_samples: int = 4, rng=None,
                 eps: np.ndarray = None) -> np.ndarray:
    """Estimate d loss / d params by stochastic forward differences."""
    rng = rng or np.random.default_rng(0)
    params = np.asarray(params)
    if eps is None:
        eps = default_param_eps(params.size // PARAMS_PER_GAUSSIAN)
    loss_of_params = jax.jit(loss_of_params)
    base = float(loss_of_params(jnp.asarray(params)))
    grad = np.zeros_like(params, np.float64)
    for _ in range(num_samples):
        s = rng.choice(np.array([-1.0, 1.0], np.float32), params.shape)
        plus = float(loss_of_params(jnp.asarray(params + s * eps)))
        grad += (plus - base) * s / eps
    return (grad / num_samples).astype(np.float32)


def footprint_fn(scene_template, camera, cfg, k: int = 16,
                 paths: bool = False, spp: int | None = None) -> Callable:
    """Build ``footprint_of_params``: params -> [H*W, k] int32 Gaussian
    indices per pixel (-1 padded), via the attribution machinery.

    ``paths=False``: primary-ray top-k (inverse/attribution.pixel_gaussians).
    ``paths=True``: the reference's full multi-bounce recording
    (integrator.h:616-644) — the union of contributing Gaussians at every
    scatter event over ``spp`` sample paths
    (attribution.pixel_gaussians_paths); a Gaussian reached only through a
    secondary bounce enters the localized-SFD footprint, matching
    inverse_integrator.h:125-131."""
    from gvr.scene.gaussians import GaussianMixture
    from gvr.inverse.attribution import (pixel_gaussians,
                                             pixel_gaussians_paths)

    def fp(params):
        gmm = GaussianMixture.from_parameters(jnp.asarray(params))
        sc = scene_template.with_medium(gmm)
        if paths:
            idx, cnt = pixel_gaussians_paths(sc, camera, cfg, k, spp)
        else:
            idx, cnt = pixel_gaussians(sc, camera, cfg, k)
        # a truncated footprint silently drops those gaussians' loss
        # contributions from the localized-SFD cross-check — refuse loudly
        over = int(np.max(cnt)) if cnt.size else 0
        if over > min(k, gmm.n):
            raise ValueError(
                f"footprint_fn: a pixel's footprint reaches {over} "
                f"gaussians (> k={k}); localized SFD would silently drop "
                f"their contributions — call footprint_fn with k>={over}")
        return idx

    return fp


def sfd_gradient_localized(image_of_params: Callable,
                           footprint_of_params: Callable,
                           params: jnp.ndarray, target: np.ndarray,
                           num_samples: int = 4, rng=None,
                           eps: np.ndarray = None) -> np.ndarray:
    """Union-footprint SFD — the reference's full gradient estimator
    (inverse_integrator.h:118-188).

    Per stochastic sample s: render params + s*eps, compute per-pixel L1
    losses for base and perturbed images (:20-29), and for every Gaussian g
    accumulate F_diff[g] = sum over the union of g's base+perturbed pixel
    footprints of (loss_plus - loss_base) (:165-179); the gradient of each
    of g's 11 params is F_diff[g] * s / eps (:182-188).

    ``image_of_params(p) -> [P,3]``; ``footprint_of_params(p) -> [P,k]``
    int32 indices (-1 padded; see ``footprint_fn``); ``target`` [P,3].
    """
    rng = rng or np.random.default_rng(0)
    params = np.asarray(params)
    n_gauss = params.size // PARAMS_PER_GAUSSIAN
    if eps is None:
        eps = default_param_eps(n_gauss)
    target = np.asarray(target).reshape(-1, 3)
    image_of_params = jax.jit(image_of_params)

    def pixel_losses(img):
        # L1 per pixel: |d|.sum over channels (inverse_integrator.h:27)
        return np.abs(np.asarray(img).reshape(-1, 3) - target).sum(-1)

    def membership(fp):
        fp = np.asarray(fp)
        m = np.zeros((fp.shape[0], n_gauss), bool)
        px, slot = np.nonzero(fp >= 0)
        m[px, fp[px, slot]] = True
        return m

    base_loss = pixel_losses(image_of_params(jnp.asarray(params)))
    mem_base = membership(footprint_of_params(params))

    grad = np.zeros_like(params, np.float64)
    for _ in range(num_samples):
        s = rng.choice(np.array([-1.0, 1.0], np.float32), params.shape)
        p_plus = params + s * eps
        plus_loss = pixel_losses(image_of_params(jnp.asarray(p_plus)))
        mem = mem_base | membership(footprint_of_params(p_plus))
        f_diff = mem.T.astype(np.float64) @ (plus_loss - base_loss)   # [N]
        grad += np.repeat(f_diff, PARAMS_PER_GAUSSIAN) * s / eps
    return (grad / num_samples).astype(np.float32)
