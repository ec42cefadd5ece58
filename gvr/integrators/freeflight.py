"""Single-scatter free-flight Monte Carlo integrator.

Reference ``FreeFlightGaussians`` (integrator.h:273-409): stratified pixel
samples, one free-flight distance per path, NEE to one of (lights + env),
no recursion.  Exactly the first bounce of the multi-scatter tracer, so it
shares all machinery.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gvr.config import RenderConfig, Solver
from gvr.scene.scene import Scene
from gvr.ops.transmittance import (tau_coeffs, compact_candidates,
                                       albedo_at_from_rg)
from gvr.ops.solvers import sample_free_flight
from gvr.integrators.common import pick_chunk
from gvr.integrators.multiscatter import _nee, mc_camera_rays
from gvr.integrators.raymarch import INV_4PI


def single_scatter_radiance(scene: Scene, origin, direction, rng_ids,
                            cfg: RenderConfig, sample=0):
    gmm = scene.medium

    from gvr.ops.sampling import path_uniforms
    xi = path_uniforms(rng_ids, sample, 0, 9, cfg.seed)
    rg = tau_coeffs(gmm, origin, direction)
    k_cand = cfg.candidate_k
    if 0 < k_cand < gmm.n:
        rg, alb_k, _ = compact_candidates(rg, gmm.albedo, k_cand)
    else:
        alb_k = gmm.albedo
    target_tau = -jnp.log(jnp.maximum(1.0 - xi[:, 0], 1e-12))
    u_sol = xi[:, 8] if cfg.solver == Solver.UNIFORM else None
    t_sc, scattered = sample_free_flight(
        rg, target_tau, cfg.solver, cfg.solver_iters, u_sol,
        finisher=cfg.solver_finisher)

    pos = origin + t_sc[:, None] * direction
    albedo = albedo_at_from_rg(rg, alb_k, t_sc)

    li, w_ne = _nee(scene, gmm, pos, xi[:, 1], xi[:, 2], xi[:, 3:5])
    scatter_l = (albedo * INV_4PI * w_ne)[:, None] * li
    return jnp.where(scattered[:, None], scatter_l,
                     jnp.broadcast_to(scene.env_color, pos.shape))


def render_single_scatter(scene: Scene, camera,
                          cfg: RenderConfig) -> np.ndarray:
    w, h = cfg.width, cfg.height

    def radiance(sc: Scene, ids, si):
        o, d, rng_ids = mc_camera_rays(sc, camera, cfg, ids, si)
        return single_scatter_radiance(sc, o, d, rng_ids, cfg, sample=si)

    fn = jax.jit(radiance)
    chunk = pick_chunk(cfg, scene.medium.n)
    acc = np.zeros((w * h, 3), np.float32)
    for si in range(cfg.spp):
        # one spp-slice of the padded chunk walk (integrators/common.
        # render_chunked covers the single-pass case; this loop also
        # carries the per-sample index si)
        for start in range(0, w * h, chunk):
            ids = np.arange(start, start + chunk, dtype=np.int32)
            ids = np.minimum(ids, w * h - 1)
            vals = np.asarray(fn(scene, jnp.asarray(ids), jnp.int32(si)))
            stop = min(start + chunk, w * h)
            acc[start:stop] += vals[: stop - start]
    return (acc / cfg.spp).reshape(h, w, 3)
