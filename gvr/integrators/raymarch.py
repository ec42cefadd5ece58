"""Deterministic single-scatter ray marchers with analytic transmittance.

References:
  * ``RayMarchingGaussians`` (test_integrators.h:143-297): fixed-step march,
    per-step analytic (erf) segment transmittance, NEE to every point light
    with analytic shadow transmittance, Monte Carlo environment sampling.
  * ``RayMarchingSpheres`` (test_integrators.h:11-136): same structure with
    piecewise-constant transmittance.
  * ``PureRayMarching`` (integrator.h:100-267): medium-agnostic variant that
    *marches* shadow/env transmittance; provided as ``march_transmittance``
    mode mostly for cross-validation (it converges to the analytic one as
    step -> 0).

Batched formulation: the event-driven active set of the reference is the mask
``(t0 <= t) & (t < t1)`` per (ray, gaussian); shadow/env transmittance is the
closed-form clipped-interval reduction (ops/transmittance.py).  The march is
a ``fori_loop`` with a static step count bound derived from the farthest
medium exit over the whole image, with per-ray masking — no data-dependent
shapes.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from gvr.config import RenderConfig
from gvr.scene.scene import Scene
from gvr.ops.transmittance import (
    tau_coeffs, transmittance_over_segment, transmittance_up_to,
    far_bound, any_hit)
from gvr.ops.sampling import path_uniforms
from gvr.integrators.common import render_chunked, ids_to_pixels, pick_chunk

INV_4PI = 1.0 / (4.0 * math.pi)
FOUR_PI = 4.0 * math.pi


def _scene_t_end(scene, camera, cfg) -> float:
    """Static bound on the march length from host-side geometry: the
    farthest medium AABB corner from the camera ray origins (camera plane
    extends +-sqrt(2) around position).  Camera-stable up to the ceil, so
    turntable frames reuse one compilation."""
    if hasattr(scene.medium, "aabbs"):
        bmin, bmax = scene.medium.aabbs()
        bmin = np.asarray(bmin).min(axis=0)
        bmax = np.asarray(bmax).max(axis=0)
    else:
        c = np.asarray(scene.medium.center)
        r = np.asarray(scene.medium.radius)[:, None]
        bmin = (c - r).min(axis=0)
        bmax = (c + r).max(axis=0)
    pos = np.asarray(camera.position)
    corners = np.array([[bmin[i] if (k >> i) & 1 else bmax[i]
                         for i in range(3)] for k in range(8)])
    far = float(np.max(np.linalg.norm(corners - pos, axis=-1)))
    return far + 2.0   # image-plane offset headroom


@functools.lru_cache(maxsize=32)
def _raymarch_gaussians_fn(cfg: RenderConfig, n_steps: int):
    """Cached jitted per-chunk marcher; scene and camera are traced args."""
    w, h = cfg.width, cfg.height
    step = cfg.step_size

    def radiance(sc: Scene, camera, ids):
        gmm = sc.medium
        x, y = ids_to_pixels(ids, w)
        u = (x.astype(jnp.float32) + 0.5) / w
        v = (y.astype(jnp.float32) + 0.5) / h
        o, d = camera.sample_ray(jnp.stack([u, v], axis=-1))   # [B,3]
        rg = tau_coeffs(gmm, o, d)
        hit_any = any_hit(rg)
        t_end = far_bound(rg)                                  # [B]

        def body(k, carry):
            big_t, radiance_acc = carry
            t = k * step
            live = (t < t_end) & hit_any
            pos = o + t * d                                    # [B,3]
            active = rg.hit & (rg.t0 <= t) & (t < rg.t1)       # [B,N]
            sigma_a, sigma_s = gmm.sigma_albedo(pos, active)

            # --- point lights: analytic shadow transmittance ---
            li = jnp.zeros_like(pos)
            for l in range(sc.lights_p.shape[0]):
                lp = sc.lights_p[l]
                wi = lp - pos
                dist = jnp.linalg.norm(wi, axis=-1)
                wi = wi / dist[..., None]
                tr = transmittance_up_to(gmm, pos, wi, dist)
                li = li + tr[:, None] * sc.lights_i[l] / (dist * dist)[:, None]

            # --- environment: MC directions, analytic transmittance ---
            # counter-hash uniforms keyed by (pixel, step, env sample) —
            # the vmapped fold_in pattern used previously is ~10000x
            # slower on this backend (see CLAUDE.md)
            def env_one(e, acc):
                xi = path_uniforms(ids, k, e, 2, cfg.seed)
                wdir = _dir_from_xi(xi)
                tr = transmittance_up_to(gmm, pos, wdir, jnp.float32(1e8))
                return acc + tr[:, None] * sc.env_color

            le = jax.lax.fori_loop(0, cfg.env_samples, env_one,
                                   jnp.zeros_like(pos))
            le = le / max(cfg.env_samples, 1) * FOUR_PI  # 0 -> lights only

            contrib = (big_t * sigma_s)[:, None] * (li + le) * (step * INV_4PI)
            radiance_acc = radiance_acc + jnp.where(live[:, None], contrib, 0.0)

            # analytic per-step transmittance over the active set
            # (gmm.h:145-157 via test_integrators.h:281-287)
            big_t = jnp.where(
                live,
                big_t * transmittance_over_segment(rg, t, t + step, active),
                big_t)
            return big_t, radiance_acc

        big_t, rad = jax.lax.fori_loop(
            0, n_steps, body,
            (jnp.ones(ids.shape[0]), jnp.zeros((ids.shape[0], 3))))
        rad = rad + big_t[:, None] * sc.env_color
        return jnp.where(hit_any[:, None], rad, sc.env_color[None, :])

    return jax.jit(radiance)


def _quant_steps(raw: float) -> int:
    """ceil(raw)+1 rounded up to a multiple of 128 (see call sites)."""
    n = max(1, int(math.ceil(raw)) + 1)
    return ((n + 127) // 128) * 128


def render_raymarch_gaussians(scene: Scene, camera,
                              cfg: RenderConfig) -> np.ndarray:
    """Analytic-transmittance Gaussian ray marcher
    (= RayMarchingGaussians, test_integrators.h:143)."""
    w, h = cfg.width, cfg.height
    t_end_max = _scene_t_end(scene, camera, cfg)
    # quantize the trip count up to a multiple of 128: the march masks
    # per-ray by t_end, so extra steps are harmless — but a raw count
    # varies with every orbit angle and caused one full recompile PER
    # TURNTABLE FRAME (lru key is (cfg, n_steps))
    n_steps = _quant_steps(t_end_max / cfg.step_size)
    fn = _raymarch_gaussians_fn(cfg, n_steps)
    # env sampling multiplies the [B,N] working set
    chunk = pick_chunk(cfg, scene.medium.n * 4)
    img = render_chunked(scene, fn, w * h, chunk, camera=camera)
    return img.reshape(h, w, 3)


def _dir_from_xi(xi):
    """Uniform sphere direction from two uniforms, reference
    parameterization (integrator.h:32-44)."""
    theta = 2.0 * jnp.pi * xi[..., 0]
    cos_phi = 1.0 - 2.0 * xi[..., 1]
    sin_phi = jnp.sqrt(jnp.maximum(1.0 - cos_phi * cos_phi, 0.0))
    return jnp.stack([sin_phi * jnp.cos(theta),
                      sin_phi * jnp.sin(theta),
                      cos_phi], axis=-1)


def _medium_intervals(medium, o, d):
    """(t0 [clamped>=0], t1, hit) for any medium type (GMM / SMM / voxels)."""
    from gvr.scene.gaussians import GaussianMixture
    if isinstance(medium, GaussianMixture):
        from gvr.ops.quadratics import intersect_gaussians
        t0, t1, hit = intersect_gaussians(medium, o, d)
    else:
        t0, t1, hit = medium.intersect(o, d)
    return jnp.maximum(t0, 0.0), t1, hit


def _medium_sigma(medium, pos, active):
    # position-dependent media (GMM, VoxelGrid) expose sigma_albedo(pos,
    # active); homogeneous-per-primitive media (SMM) only need the mask
    if hasattr(medium, "sigma_albedo"):
        return medium.sigma_albedo(pos, active)
    return medium.sigma_at(active)


def march_transmittance(medium, o, d, tmax, step: float, n_steps: int):
    """Marched (left-Riemann) transmittance: T = prod exp(-sigma_t(t_k) dt)
    (reference ``PureRayMarching::march_transmittance``,
    integrator.h:105-135).  n_steps is the static bound; per-ray masking
    stops at tmax."""
    t0, t1, hit = _medium_intervals(medium, o, d)

    def body(k, T):
        t = k * step
        live = t < tmax
        active = hit & (t0 <= t) & (t < t1)
        pos = o + t * d
        sa, ss = _medium_sigma(medium, pos, active)
        return jnp.where(live, T * jnp.exp(-(sa + ss) * step), T)

    return jax.lax.fori_loop(0, n_steps, body, jnp.ones(o.shape[:-1]))


def render_pure_raymarch(scene: Scene, camera,
                         cfg: RenderConfig) -> np.ndarray:
    """Medium-agnostic single-scatter marcher with *marched* shadow/env
    transmittance (= PureRayMarching, integrator.h:100-267) — the slowest,
    assumption-free baseline (the reference's 'CPU-parity config #1').
    O(primary_steps x (lights + env_samples) x shadow_steps) per pixel:
    use small resolutions / step sizes accordingly.
    """
    w, h = cfg.width, cfg.height
    step = cfg.step_size
    t_end_max = _scene_t_end_any(scene, camera, cfg)
    n_steps = max(1, int(math.ceil(t_end_max / step)) + 1)
    # static bound for shadow/env marches: a shadow ray starts anywhere in
    # the medium and can traverse the FULL AABB diagonal — the camera
    # bound n_steps can be shorter (e.g. camera near a face), which would
    # truncate the transmittance march mid-medium and brighten shadows
    shadow_steps = max(n_steps,
                       int(math.ceil(_medium_diag(scene.medium) / step))) + 8

    def radiance(sc: Scene, ids):
        medium = sc.medium
        x, y = ids_to_pixels(ids, w)
        u = (x.astype(jnp.float32) + 0.5) / w
        v = (y.astype(jnp.float32) + 0.5) / h
        o, d = camera.sample_ray(jnp.stack([u, v], axis=-1))
        t0, t1, hitm = _medium_intervals(medium, o, d)
        hit_any = jnp.any(hitm, axis=-1)
        t_end = jnp.max(jnp.where(hitm, t1, 0.0), axis=-1)

        def body(k, carry):
            big_t, rad = carry
            t = k * step
            live = (t < t_end) & hit_any
            pos = o + t * d
            active = hitm & (t0 <= t) & (t < t1)
            sa, ss = _medium_sigma(medium, pos, active)

            li = jnp.zeros_like(pos)
            for l in range(sc.lights_p.shape[0]):
                lp = sc.lights_p[l]
                wi = lp - pos
                dist = jnp.linalg.norm(wi, axis=-1)
                wi = wi / dist[..., None]
                tr = march_transmittance(medium, pos, wi, dist, step,
                                         shadow_steps)
                li = li + tr[:, None] * sc.lights_i[l] / (dist * dist)[:, None]

            def env_one(e, acc):
                xi = path_uniforms(ids, k, e, 2, cfg.seed)
                wdir = _dir_from_xi(xi)
                # march env transmittance to the env ray's own medium exit
                et0, et1, ehit = _medium_intervals(medium, pos, wdir)
                e_end = jnp.max(jnp.where(ehit, et1, 0.0), axis=-1)
                tr = march_transmittance(medium, pos, wdir, e_end, step,
                                         shadow_steps)
                return acc + tr[:, None] * sc.env_color

            le = jax.lax.fori_loop(0, cfg.env_samples, env_one,
                                   jnp.zeros_like(pos))
            le = le / max(cfg.env_samples, 1) * FOUR_PI

            contrib = (big_t * ss)[:, None] * (li + le) * (step * INV_4PI)
            rad = rad + jnp.where(live[:, None], contrib, 0.0)
            big_t = jnp.where(live, big_t * jnp.exp(-(sa + ss) * step), big_t)
            return big_t, rad

        big_t, rad = jax.lax.fori_loop(
            0, n_steps, body,
            (jnp.ones(ids.shape[0]), jnp.zeros((ids.shape[0], 3))))
        rad = rad + big_t[:, None] * sc.env_color
        return jnp.where(hit_any[:, None], rad, sc.env_color[None, :])

    img = render_chunked(scene, radiance, w * h,
                         pick_chunk(cfg, scene.medium.n * 8))
    return img.reshape(h, w, 3)


def _medium_diag(medium) -> float:
    """Full AABB diagonal of the medium — the longest chord any
    shadow/env ray can traverse."""
    if hasattr(medium, "aabbs"):
        bmin, bmax = medium.aabbs()
        lo = np.asarray(bmin).min(0)
        hi = np.asarray(bmax).max(0)
    else:
        c = np.asarray(medium.center)
        r = np.asarray(medium.radius)[:, None]
        lo = (c - r).min(0)
        hi = (c + r).max(0)
    return float(np.linalg.norm(hi - lo))


def _scene_t_end_any(scene, camera, cfg) -> float:
    """Static march bound for either medium type."""
    w, h = cfg.width, cfg.height

    def chunk_max(sc, ids):
        x, y = ids_to_pixels(ids, w)
        u = (x.astype(jnp.float32) + 0.5) / w
        v = (y.astype(jnp.float32) + 0.5) / h
        o, d = camera.sample_ray(jnp.stack([u, v], axis=-1))
        t0, t1, hitm = _medium_intervals(sc.medium, o, d)
        t_end = jnp.max(jnp.where(hitm, t1, 0.0), axis=-1)
        return jnp.broadcast_to(t_end[:, None], (ids.shape[0], 3))

    vals = render_chunked(scene, chunk_max, w * h,
                          pick_chunk(cfg, scene.medium.n))
    return float(vals[:, 0].max())


@functools.lru_cache(maxsize=32)
def _raymarch_spheres_fn(cfg: RenderConfig, n_steps: int):
    w, h = cfg.width, cfg.height
    step = cfg.step_size

    def radiance(sc: Scene, camera, ids):
        smm = sc.medium
        x, y = ids_to_pixels(ids, w)
        u = (x.astype(jnp.float32) + 0.5) / w
        v = (y.astype(jnp.float32) + 0.5) / h
        o, d = camera.sample_ray(jnp.stack([u, v], axis=-1))
        t0, t1, hitm = smm.intersect(o, d)
        t0c = jnp.maximum(t0, 0.0)
        hit_any = jnp.any(hitm, axis=-1)
        t_end = jnp.max(jnp.where(hitm, t1, 0.0), axis=-1)

        def body(k, carry):
            big_t, rad = carry
            t = k * step
            live = (t < t_end) & hit_any
            pos = o + t * d
            active = hitm & (t0c <= t) & (t < t1)
            sigma_a, sigma_s = smm.sigma_at(active)
            sigma_t = sigma_a + sigma_s

            li = jnp.zeros_like(pos)
            for l in range(sc.lights_p.shape[0]):
                lp = sc.lights_p[l]
                wi = lp - pos
                dist = jnp.linalg.norm(wi, axis=-1)
                wi = wi / dist[..., None]
                tr = smm.transmittance_up_to(pos, wi, dist)
                li = li + tr[:, None] * sc.lights_i[l] / (dist * dist)[:, None]

            def env_one(e, acc):
                xi = path_uniforms(ids, k, e, 2, cfg.seed)
                wdir = _dir_from_xi(xi)
                tr = smm.transmittance_up_to(pos, wdir, jnp.float32(1e8))
                return acc + tr[:, None] * sc.env_color

            le = jax.lax.fori_loop(0, cfg.env_samples, env_one,
                                   jnp.zeros_like(pos))
            le = le / max(cfg.env_samples, 1) * FOUR_PI  # 0 -> lights only

            contrib = (big_t * sigma_s)[:, None] * (li + le) * (step * INV_4PI)
            rad = rad + jnp.where(live[:, None], contrib, 0.0)
            big_t = jnp.where(live, big_t * jnp.exp(-sigma_t * step), big_t)
            return big_t, rad

        big_t, rad = jax.lax.fori_loop(
            0, n_steps, body,
            (jnp.ones(ids.shape[0]), jnp.zeros((ids.shape[0], 3))))
        rad = rad + big_t[:, None] * sc.env_color
        return jnp.where(hit_any[:, None], rad, sc.env_color[None, :])

    return jax.jit(radiance)


def render_raymarch_spheres(scene: Scene, camera,
                            cfg: RenderConfig) -> np.ndarray:
    """Sphere ray marcher with piecewise-constant analytic transmittance
    (= RayMarchingSpheres, test_integrators.h:11-136)."""
    w, h = cfg.width, cfg.height
    n_steps = _quant_steps(
        _scene_t_end(scene, camera, cfg) / cfg.step_size)
    fn = _raymarch_spheres_fn(cfg, n_steps)
    img = render_chunked(scene, fn, w * h,
                         pick_chunk(cfg, scene.medium.n * 4), camera=camera)
    return img.reshape(h, w, 3)
