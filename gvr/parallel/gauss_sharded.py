"""Tensor-parallel rendering: shard the Gaussian mixture over a mesh axis.

The default multi-chip strategy (parallel/sharding.py) replicates the scene
and shards rays — right whenever the parameters fit one chip (20k Gaussians
= 220 KB).  What does NOT fit at scale is the dense path's per-(ray,
gaussian) working set: a 64k-ray chunk against N Gaussians carries
O(64k x N) f32 intermediates (RayGaussians is 11 of them), which is what
actually caps the ray-chunk size as scenes grow.  Sharding the *Gaussian*
axis divides that working set (and the per-pair FLOPs) across chips while
rays stay replicated or shard on a second mesh axis — classic 2-D
tensor x data parallelism.

Mechanism: every Gaussian-axis reduction in ops/{transmittance,solvers}.py
runs through the g*() helpers (transmittance.gaussian_axis); inside this
module's shard_map they complete local reductions with psum/pmax/pmin over
the ``gauss`` mesh axis.  Per-ray control flow (the bracketed Newton loop,
RR, phase sampling) is replicated across the gauss axis and stays in
lockstep because every device sees identical post-collective scalars; the
per-bounce collective payload is a few scalars per ray (tau, sigma_t per
solver iteration + the NEE tau), which XLA hands to NCCL on GPUs.

Reference parity note: the reference has no scene-parallel mode at all
(OpenMP shares one scene in RAM, integrator.h:148,302,547); this is a
capability beyond it.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from gvr.config import RenderConfig
from gvr.ops.gaxis import gaussian_axis
from gvr.scene.gaussians import GaussianMixture
from gvr.scene.scene import Scene

RAY_AXIS = "rays"
GAUSS_AXIS = "gauss"


def make_mesh_2d(n_ray_shards: int, n_gauss_shards: int,
                 devices=None) -> Mesh:
    """(rays x gauss) mesh over the first n_ray*n_gauss devices."""
    devices = list(devices if devices is not None else jax.devices())
    need = n_ray_shards * n_gauss_shards
    assert len(devices) >= need, (len(devices), need)
    return Mesh(np.array(devices[:need]).reshape(n_ray_shards,
                                                 n_gauss_shards),
                (RAY_AXIS, GAUSS_AXIS))


def pad_mixture(gmm: GaussianMixture, multiple: int) -> GaussianMixture:
    """Pad N up to a multiple with inert Gaussians: zero density AND a
    center so remote (1e9 with unit covariance) that the support test
    ``(R_CUT^2 - m2)/a > 0`` fails for every finite ray — padded rows hit
    nothing, so brackets/far bounds/NEE are untouched, not just zero-tau."""
    n = gmm.n
    rem = (-n) % multiple
    if rem == 0:
        return gmm
    pad = GaussianMixture.from_covariances(
        mean=jnp.full((rem, 3), 1e9, jnp.float32),
        cov=jnp.tile(jnp.eye(3, dtype=jnp.float32), (rem, 1, 1)),
        density=jnp.zeros((rem,), jnp.float32),
        albedo=jnp.zeros((rem,), jnp.float32))
    cat = lambda a, b: jnp.concatenate([a, b], axis=0)
    return jax.tree_util.tree_map(cat, gmm, pad)


def render_rays_tp(scene: Scene, origin, direction, rng_ids,
                   cfg: RenderConfig, mesh: Mesh, sample=0):
    """Multi-scatter radiance with rays sharded over mesh axis ``rays`` and
    the Gaussian mixture sharded over mesh axis ``gauss``.

    Estimator-identical to ``multiscatter_radiance`` up to f32 reduction
    order (the psum tree vs one flat jnp.sum); RNG streams are keyed by
    rng_ids so the result is layout-independent like the dp path.
    Candidate compaction is forced off — top_k over a sharded axis has no
    cheap collective — which is the correct trade: compaction exists to
    shrink the [rays, N] working set, and that is what the gauss axis
    itself does.
    """
    from gvr.integrators.multiscatter import multiscatter_radiance

    cfg = dataclasses.replace(cfg, candidate_k=0)

    n_gauss_shards = mesh.shape[GAUSS_AXIS]
    n_ray_shards = mesh.shape[RAY_AXIS]
    medium = pad_mixture(scene.medium, n_gauss_shards)

    n_rays = origin.shape[0]
    assert n_rays % n_ray_shards == 0, (
        f"ray count {n_rays} must divide the '{RAY_AXIS}' axis "
        f"({n_ray_shards}); pad rays upstream")

    def local(medium, lights_p, lights_i, env_color, o, d, ids):
        sc = Scene(medium, lights_p, lights_i, env_color)
        with gaussian_axis(GAUSS_AXIS):
            return multiscatter_radiance(sc, o, d, ids, cfg, sample=sample)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(GAUSS_AXIS), P(), P(), P(),
                  P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )
    return fn(medium, scene.lights_p, scene.lights_i, scene.env_color,
              origin, direction, rng_ids)


def render_multiscatter_tp(scene: Scene, camera, cfg: RenderConfig,
                           mesh: Mesh):
    """Image-level tensor-parallel multi-scatter render: pixels shard over
    the ``rays`` mesh axis, the mixture over ``gauss``; the spp loop runs
    inside the shard_map (stratified camera jitter + per-sample RNG streams
    identical to the single-device estimator — keyed by (pixel, sample,
    bounce), never by shard).  Returns [H*W, 3] in pixel-id order.

    The dp production path (integrators.render_multiscatter) stays the
    default on one-chip-sized scenes; this wrapper is the working-set
    escape hatch (see docs/SCALING.md).
    """
    from gvr.integrators.multiscatter import (
        mc_camera_rays, multiscatter_radiance)

    cfg = dataclasses.replace(cfg, candidate_k=0)
    w, h, spp = cfg.width, cfg.height, cfg.spp
    n_ray_shards = mesh.shape[RAY_AXIS]
    medium = pad_mixture(scene.medium, mesh.shape[GAUSS_AXIS])

    n = w * h
    n_pad = ((n + n_ray_shards - 1) // n_ray_shards) * n_ray_shards
    ids = jnp.arange(n_pad, dtype=jnp.int32) % n

    def local(medium, lights_p, lights_i, env_color, camera, ids):
        sc = Scene(medium, lights_p, lights_i, env_color)
        with gaussian_axis(GAUSS_AXIS):
            def body(si, acc):
                o, d, rng_ids = mc_camera_rays(sc, camera, cfg, ids, si)
                return acc + multiscatter_radiance(sc, o, d, rng_ids, cfg,
                                                   sample=si)
            acc = jax.lax.fori_loop(
                0, spp, body, jnp.zeros((ids.shape[0], 3), jnp.float32))
        return acc / spp

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(GAUSS_AXIS), P(), P(), P(), P(), P(RAY_AXIS)),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )
    img = fn(medium, scene.lights_p, scene.lights_i, scene.env_color,
             camera, ids)
    return img[:n]


def fit_value_and_grad_tp(mesh: Mesh, n_bounces: int = 4,
                          loss: str = "l2_dual", rr_after: int = 0):
    """value_and_grad of the inverse-rendering loss with the *parameters
    themselves* sharded: each chip owns params[N/tp, 11] of the mixture
    (and would own the matching slice of Adam state), rays/targets shard
    over the ``rays`` axis — model x data parallel fitting, for mixtures
    whose [rays, N] fit working set outgrows one chip.

    Returns ``f(params, lights_p, lights_i, env_color, o, d, rng_ids,
    target, seed) -> (loss, grads)`` with params/grads sharded over
    ``gauss`` and o/d/rng_ids/target over ``rays``; loss is replicated.
    N and the ray count must divide their mesh axes (pad upstream —
    a zero-density padded row's gradient is well-defined and discarded).

    The backward pass is the implicit-function-theorem VJP
    (ops/solvers.solve_conditional_free_flight) run under the gauss axis:
    its tau/sigma collectives transpose to per-shard cotangents, so no
    gradient collective over ``gauss`` is needed — only the ``rays``-axis
    pmean that dp fitting (parallel/sharding.py) already uses.
    """
    from gvr.inverse.fit import fit_loss

    def local(params, lights_p, lights_i, env_color, o, d, ids, tgt, seed):
        template = Scene(None, lights_p, lights_i, env_color)
        with gaussian_axis(GAUSS_AXIS):
            val, grads = jax.value_and_grad(fit_loss)(
                params, template, o, d, ids, tgt, n_bounces=n_bounces,
                loss=loss, seed=seed, rr_after=rr_after)
        val = jax.lax.pmean(val, RAY_AXIS)
        grads = jax.lax.pmean(grads, RAY_AXIS)
        return val, grads

    # jit is required, not just fast: fit_loss's remat'd spp scan
    # (inverse/fit._mc_mean) cannot be evaluated eagerly under shard_map
    # (closed_call has no eager shard_map rule), and this is the hot
    # training-step anyway.
    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(GAUSS_AXIS), P(), P(), P(),
                  P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS), P()),
        out_specs=(P(), P(GAUSS_AXIS)),
        check_vma=False,
    ))
