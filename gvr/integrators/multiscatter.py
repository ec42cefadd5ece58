"""Multi-scatter Monte Carlo volumetric path tracer — the flagship.

Reference ``MultiScatterGaussians`` (integrator.h:417-720): per path —
free-flight sampling by regular tracking, NEE to one of (lights + env) per
bounce, isotropic phase, throughput *= albedo, Russian roulette after
``min_scatter`` bounces capped at 0.9.

Wavefront formulation: one ``lax.while_loop`` steps a whole ray batch
through bounces with a live mask; every per-bounce op is dense
[rays, gaussians] work.  The per-bounce event gather + sort + active
set walk of the reference collapses into the clipped-interval free-flight
solve (ops/solvers.py).  NEE needs exactly one extra transmittance
evaluation per bounce: the light/env choice picks the direction *first*,
then a single closed-form transmittance is evaluated (the reference computes
the same quantity through a BVH walk, gmm.h:517-578).

RNG: counter-hash uniforms keyed by (pixel id, sample, bounce)
(ops/sampling.path_uniforms) — 9 per bounce (target tau, NEE choice, light
index, env direction x2, RR, scatter direction x2, uniform-solver sample).
Chunk-layout invariant and shard reproducible, like the reference's
derive_path_seed + PCG32 (rng.h).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from gvr.config import RenderConfig, Solver
from gvr.scene.scene import Scene
from gvr.ops.transmittance import (
    tau_coeffs, tau_total, transmittance_up_to, compact_candidates,
    albedo_at_from_rg)
from gvr.ops.solvers import (
    sample_free_flight, solve_conditional_free_flight)
from gvr.ops.sampling import path_uniforms
from gvr.integrators.common import ids_to_pixels, pick_chunk
from gvr.integrators.raymarch import _dir_from_xi, INV_4PI, FOUR_PI


def _nee(sc: Scene, gmm, pos, xi_choice, xi_light, xi_env2):
    """Next-event estimation: sample one of (num_lights point lights + env)
    with probability 1/(L+1) each (integrator.h:657-683).

    Returns (Li [B,3], weight (L+1)); Li already includes transmittance and
    the 4*pi factor for the env branch (integrator.h:677)."""
    num_lights = sc.lights_p.shape[0]
    b = pos.shape[0]

    wi_env = _dir_from_xi(xi_env2)

    if num_lights == 0:
        tr = transmittance_up_to(gmm, pos, wi_env, jnp.float32(1e8))
        li = tr[:, None] * sc.env_color * FOUR_PI
        return li, 1.0

    is_env = xi_choice < 1.0 / (num_lights + 1)
    lidx = jnp.clip((xi_light * num_lights).astype(jnp.int32),
                    0, num_lights - 1)
    lp = sc.lights_p[lidx]                                  # [B,3]
    linten = sc.lights_i[lidx]
    to_l = lp - pos
    dist = jnp.linalg.norm(to_l, axis=-1)
    wi_l = to_l / jnp.maximum(dist, 1e-12)[:, None]

    wi = jnp.where(is_env[:, None], wi_env, wi_l)
    tmax = jnp.where(is_env, jnp.float32(1e8), dist)
    tr = transmittance_up_to(gmm, pos, wi, tmax)

    li_light = tr[:, None] * linten / jnp.maximum(dist * dist, 1e-12)[:, None]
    li_env = tr[:, None] * sc.env_color * FOUR_PI
    li = jnp.where(is_env[:, None], li_env, li_light)
    return li, float(num_lights + 1)


def multiscatter_radiance(scene: Scene, origin, direction, rng_ids,
                          cfg: RenderConfig, sample=0):
    """Trace a batch of rays to completion.  origin/direction [B,3],
    rng_ids [B] int32 per-path stream ids (pixel ids for camera rays).
    Returns radiance [B,3]."""
    gmm = scene.medium
    b = origin.shape[0]

    def uniforms(_ids, bounce, n=9):
        return path_uniforms(_ids, sample, bounce, n, cfg.seed)

    def cond(state):
        o, d, thr, rad, alive, bounce = state
        return jnp.any(alive) & (bounce < cfg.max_bounces)

    k_cand = cfg.candidate_k
    use_compact = 0 < k_cand < gmm.n

    def body(state):
        o, d, thr, rad, alive, bounce = state
        rg = tau_coeffs(gmm, o, d)
        if use_compact:
            # BVH-pruning replacement: run the fixed-iteration solver on the
            # candidate_k nearest-entering hits instead of all N Gaussians
            rg, alb_k, _ = compact_candidates(rg, gmm.albedo, k_cand)
        else:
            alb_k = gmm.albedo
        xi = uniforms(rng_ids, bounce)                       # [B,9]

        # free-flight distance by regular tracking (integrator.h:599-614)
        target_tau = -jnp.log(jnp.maximum(1.0 - xi[:, 0], 1e-12))
        u_sol = xi[:, 8] if cfg.solver == Solver.UNIFORM else None
        t_sc, scattered = sample_free_flight(
            rg, target_tau, cfg.solver, cfg.solver_iters, u_sol,
            finisher=cfg.solver_finisher)

        # escaped rays collect the environment (integrator.h:594-597,647-650)
        escaped = alive & ~scattered
        rad = rad + jnp.where(escaped[:, None], thr * scene.env_color, 0.0)
        alive_n = alive & scattered

        pos = o + t_sc[:, None] * d
        albedo = albedo_at_from_rg(rg, alb_k, t_sc)          # [B]

        # NEE (one light or env per bounce)
        li, w_ne = _nee(scene, gmm, pos, xi[:, 1], xi[:, 2], xi[:, 3:5])
        contrib = thr * (albedo * INV_4PI * w_ne)[:, None] * li
        rad = rad + jnp.where(alive_n[:, None], contrib, 0.0)

        # throughput update + Russian roulette (integrator.h:688-695)
        thr_n = thr * albedo[:, None]
        do_rr = bounce >= cfg.min_scatter
        cap = jnp.where(bounce >= cfg.rr_tail_after, cfg.rr_cap_tail,
                        cfg.rr_cap)
        rr = jnp.minimum(jnp.max(thr_n, axis=-1), cap)
        killed = do_rr & (xi[:, 5] > rr)
        thr_n = jnp.where((do_rr & ~killed)[:, None],
                          thr_n / jnp.maximum(rr, 1e-12)[:, None], thr_n)
        alive_n = alive_n & ~killed

        # isotropic phase resample (integrator.h:698-699)
        new_d = _dir_from_xi(xi[:, 6:8])

        o = jnp.where(alive_n[:, None], pos, o)
        d = jnp.where(alive_n[:, None], new_d, d)
        thr = jnp.where(alive_n[:, None], thr_n, thr)
        return o, d, thr, rad, alive_n, bounce + 1

    state = (origin, direction,
             jnp.ones((b, 3)), jnp.zeros((b, 3)),
             jnp.ones((b,), bool), jnp.int32(0))
    *_, rad, alive, _ = jax.lax.while_loop(cond, body, state)
    return rad


def multiscatter_radiance_diff(scene: Scene, origin, direction, rng_ids,
                               cfg: RenderConfig, n_bounces: int = 4,
                               sample=0, seed: int = 0,
                               candidate_k: int = 0,
                               rr_after: int = 0, rr_cap: float = 0.9,
                               return_overflow: bool = False):
    """Differentiable multi-scatter estimator for inverse rendering.

    Differences from the forward flagship (both documented, both unbiased):

    * fixed-trip ``lax.scan`` over ``n_bounces`` (reverse-mode AD cannot
      differentiate ``while_loop``);
    * *analytic escape*: instead of sampling the escape event, every bounce
      adds ``thr * exp(-tau_total) * env`` in closed form and conditions the
      free-flight sample on scattering (target = -log(1 - u*(1-T_esc))).
      Lower variance and smooth in the Gaussian parameters.
    * the sampled scatter distance is differentiable via the implicit
      function theorem (``solve_conditional_free_flight``), the
      reparameterized replacement for the reference's stochastic finite
      differences (inverse_integrator.h).
    * ``candidate_k > 0``: the free-flight solve and albedo run on the
      k nearest-entering hit Gaussians per ray (``compact_candidates``,
      differentiable gathers) — [B,k] instead of [B,N] solver work, the
      scaling lever for fitting hundreds+ of Gaussians.
    * ``rr_after > 0``: Russian roulette from that bounce on (reference
      integrator.h:691-695), with a stop-gradient survival probability so
      the reweighting stays an unbiased gradient estimator.  With RR the
      truncation bias of the fixed-trip scan decays geometrically in
      ``n_bounces`` instead of being O(residual throughput).
    """
    gmm = scene.medium
    b = origin.shape[0]
    use_compact = 0 < candidate_k < gmm.n

    def uniforms(bounce, n=9):
        return path_uniforms(rng_ids, sample, bounce, n, seed)

    def body(state, bounce):
        o, d, thr, rad, alive, n_over, n_live = state
        rg = tau_coeffs(gmm, o, d)
        if use_compact:
            rg, alb_k, overflow = compact_candidates(rg, gmm.albedo,
                                                     candidate_k)
            # bias honesty (the forward path got this in round 2): count
            # live lanes whose hit set exceeded k — their dropped
            # candidates silently bias gradients at dense scenes — plus
            # the live-lane denominator (dead lanes would dilute the rate)
            n_over = n_over + jnp.sum((overflow & alive).astype(jnp.int32))
            n_live = n_live + jnp.sum(alive.astype(jnp.int32))
        xi = uniforms(bounce)

        tau_tot = tau_total(rg)
        t_esc = jnp.exp(-tau_tot)
        rad = rad + jnp.where(alive[:, None], thr * t_esc[:, None]
                              * scene.env_color, 0.0)
        p_scat = 1.0 - t_esc
        alive_n = alive & (jax.lax.stop_gradient(p_scat) > 1e-6)
        thr = thr * p_scat[:, None]

        # reparameterized conditional sample: tau(t) = -log(1 - u * p_scat);
        # p_scat stays differentiable — t depends on theta both through tau
        # and through the conditioning mass (the implicit-diff VJP of the
        # solver routes the target's cotangent correctly)
        target = -jnp.log1p(-xi[:, 0] * p_scat * 0.999999)
        t_sc = solve_conditional_free_flight(rg, target)
        # sanitize dead lanes so masked NaNs can't leak into reverse-mode
        t_sc = jnp.where(alive_n, t_sc, 0.0)
        pos = o + t_sc[:, None] * d
        if use_compact:
            albedo = albedo_at_from_rg(rg, alb_k, t_sc)
        else:
            tsg = jax.lax.stop_gradient(t_sc)[:, None]
            active = rg.hit & (rg.t0 <= tsg) & (tsg <= rg.t1)
            albedo = gmm.albedo_at(pos, active)

        li, w_ne = _nee(scene, gmm, pos, xi[:, 1], xi[:, 2], xi[:, 3:5])
        contrib = thr * (albedo * INV_4PI * w_ne)[:, None] * li
        rad = rad + jnp.where(alive_n[:, None], contrib, 0.0)

        thr = thr * albedo[:, None]

        if rr_after > 0:
            do_rr = bounce >= rr_after
            surv = jax.lax.stop_gradient(
                jnp.minimum(jnp.max(thr, axis=-1), rr_cap))
            killed = do_rr & (xi[:, 5] > surv)
            thr = jnp.where((do_rr & ~killed)[:, None],
                            thr / jnp.maximum(surv, 1e-12)[:, None], thr)
            alive_n = alive_n & ~killed

        new_d = _dir_from_xi(xi[:, 6:8])
        o = jnp.where(alive_n[:, None], pos, o)
        d = jnp.where(alive_n[:, None], new_d, d)
        return (o, d, thr, rad, alive_n, n_over, n_live), None

    state = (origin, direction, jnp.ones((b, 3)), jnp.zeros((b, 3)),
             jnp.ones((b,), bool), jnp.int32(0), jnp.int32(0))
    (o, d, thr, rad, alive, n_over, n_live), _ = jax.lax.scan(
        body, state, jnp.arange(n_bounces))
    if return_overflow:
        return rad, (n_over, n_live)
    return rad


def strat_n(spp: int) -> int:
    """Stratification grid side: int(sqrt(spp)) when spp is a perfect
    square, else 1 (plain jitter).  The reference assumes perfect-square
    spp (integrator.h:311 "ASSUMING num_samples is power of 2"); for other
    spp its si // n cells walk outside the pixel footprint — here
    non-square spp degrades gracefully to unstratified sampling."""
    n = max(int(spp ** 0.5), 1)
    return n if n * n == spp else 1


def strat_uv(x, y, sample_idx, n_strat, w, h, xi0, xi1):
    """Stratified sub-pixel sample position (integrator.h:562-566): cell
    (s % n, (s // n) % n) plus RNG jitter, normalized to [0,1).  THE
    single XLA-side copy of this arithmetic — the megakernel re-derives
    it in-register (kernels/megatrace) and is held to it by the spp=9
    megakernel-vs-XLA equivalence test."""
    sx = (sample_idx % n_strat).astype(jnp.float32)
    sy = ((sample_idx // n_strat) % n_strat).astype(jnp.float32)
    u = (x.astype(jnp.float32) + (sx + xi0) / n_strat) / w
    v = (y.astype(jnp.float32) + (sy + xi1) / n_strat) / h
    return u, v


def mc_camera_rays(scene: Scene, camera, cfg: RenderConfig, ids, sample_idx):
    """Stratified primary rays for MC integrators (integrator.h:557-570):
    n = int(sqrt(spp)); cell (si % n, si // n); hash-RNG jitter (the
    0x7FFF0000 bounce tag reserves the jitter stream)."""
    w, h = cfg.width, cfg.height
    x, y = ids_to_pixels(ids, w)
    xi = path_uniforms(ids, sample_idx, 0x7FFF0000, 2, cfg.seed)
    u, v = strat_uv(x, y, sample_idx, strat_n(cfg.spp), w, h,
                    xi[:, 0], xi[:, 1])
    o, d = camera.sample_ray(jnp.stack([u, v], axis=-1))
    return o, d, ids


def static_lights_of(scene: Scene):
    """Scene lights and env colour as hashable Python tuples: the
    megakernel bakes them in as compile-time constants (tiny and static
    per render).  Only valid outside jit."""
    return (tuple(tuple(float(v) for v in r)
                  for r in np.asarray(scene.lights_p)),
            tuple(tuple(float(v) for v in r)
                  for r in np.asarray(scene.lights_i)),
            tuple(float(v) for v in np.asarray(scene.env_color)))


def _wavefront_mega(scene: Scene, camera, cfg: RenderConfig, ids,
                    static_lights):
    """Dense engine through the persistent megakernel
    (kernels/megatrace.py): the whole sample/bounce loop of
    ``wavefront_pixels`` runs inside one Pallas program per ray block.
    Estimator- and RNG-stream-identical to the XLA wavefront below."""
    from gvr.kernels.megatrace import (mega_call, pack_table,
                                           camera_vector, BLOCK)
    from gvr.cameras import PinholeCamera

    b0 = ids.shape[0]
    pad = (-b0) % BLOCK
    if pad:
        ids = jnp.concatenate([ids, jnp.broadcast_to(ids[-1:], (pad,))])
    lights_p, lights_i, env = static_lights
    cfg_t = (cfg.width, cfg.height, cfg.spp, strat_n(cfg.spp), cfg.seed,
             cfg.solver_iters, cfg.min_scatter, cfg.rr_cap,
             cfg.rr_tail_after, cfg.rr_cap_tail, cfg.max_bounces)
    out = mega_call(camera_vector(camera), pack_table(scene.medium), ids,
                    cfg_t, lights_p, lights_i, env,
                    pinhole=isinstance(camera, PinholeCamera),
                    interpret=cfg.pallas == "interpret")
    return out[0:3].T[:b0] / cfg.spp


def kernel_enabled(cfg: RenderConfig) -> bool:
    """Whether the dense engine runs the megakernel.

    ``pallas``: 'auto' takes the kernel on a GPU backend and plain XLA
    elsewhere; 'on' insists on the GPU kernel and raises without a GPU;
    'interpret' runs the kernel in the Pallas interpreter (CPU tests);
    'off' is plain XLA.  The kernel implements the (analytic-)Newton solver
    without the erfinv finisher or candidate compaction; those
    configurations run on XLA."""
    if cfg.pallas == "off":
        return False
    supported = (cfg.solver in (Solver.NEWTON, Solver.ANALYTIC_NEWTON)
                 and not cfg.solver_finisher and cfg.candidate_k == 0)
    if cfg.pallas == "on":
        if jax.default_backend() != "gpu":
            raise ValueError(
                f"pallas='on' needs a GPU backend, found "
                f"{jax.default_backend()!r}; use 'auto', 'interpret' or "
                f"'off'")
        if not supported:
            raise ValueError(
                "pallas='on': the megakernel implements the Newton solver "
                "without finisher or candidate_k; this config runs on XLA "
                "(pallas='auto' or 'off')")
        return True
    if not supported:
        return False
    return cfg.pallas == "interpret" or jax.default_backend() == "gpu"


def wavefront_pixels(scene: Scene, camera, cfg: RenderConfig, ids,
                     static_lights=None):
    """All-spp radiance for a chunk of pixels with *path regeneration*:
    one persistent lane per pixel; when a path terminates (escape or RR),
    the lane immediately starts the pixel's next stratified sample.

    The reference's per-path loop wastes nothing because it is scalar; a
    naive SIMD while_loop pays the longest path's bounce count for every
    lane (RR's 0.9 cap gives a long tail), leaving <1% utilization at the
    tail.  Regeneration keeps lane utilization near 100% and amortizes the
    tail across all spp (persistent-threads wavefront path tracing).  Estimator and RNG streams are identical to
    ``multiscatter_radiance`` per (pixel, sample).
    """
    gmm = scene.medium
    b = ids.shape[0]
    w, h = cfg.width, cfg.height
    x = ids % w
    y = ids // w
    n_strat = strat_n(cfg.spp)
    k_cand = cfg.candidate_k
    use_compact = 0 < k_cand < gmm.n

    if kernel_enabled(cfg):
        if static_lights is None:
            static_lights = static_lights_of(scene)
        return _wavefront_mega(scene, camera, cfg, ids, static_lights)

    # counter-based hash RNG keyed by (pixel, sample, bounce) — see
    # ops/sampling.path_uniforms.  0x7FFF0000 tags the sub-pixel jitter
    # draw so it never collides with a bounce index.
    def make_ray(sample_idx):
        xi = path_uniforms(ids, sample_idx, 0x7FFF0000, 2, cfg.seed)
        u, v = strat_uv(x, y, sample_idx, n_strat, w, h,
                        xi[:, 0], xi[:, 1])
        o, d = camera.sample_ray(jnp.stack([u, v], axis=-1))
        return o, d

    def cond(state):
        o, d, thr, acc, alive, sample, bounce, it = state
        return jnp.any(alive | (sample < cfg.spp)) & (
            it < cfg.spp * cfg.max_bounces + cfg.max_bounces)

    def body(state):
        o, d, thr, acc, alive, sample, bounce, it = state

        # --- regenerate dead lanes that still have samples to trace ---
        regen = ~alive & (sample < cfg.spp)
        o_n, d_n = make_ray(jnp.where(regen, sample, 0))
        o = jnp.where(regen[:, None], o_n, o)
        d = jnp.where(regen[:, None], d_n, d)
        thr = jnp.where(regen[:, None], 1.0, thr)
        bounce = jnp.where(regen, 0, bounce)
        sample = jnp.where(regen, sample + 1, sample)
        alive = alive | regen

        # --- one bounce step (identical math to multiscatter_radiance) ---
        # current path's sample index is sample-1 (incremented at regen)
        xi = path_uniforms(ids, jnp.maximum(sample, 1) - 1, bounce, 9,
                           cfg.seed)
        rg = tau_coeffs(gmm, o, d)
        if use_compact:
            rg, alb_k, _ = compact_candidates(rg, gmm.albedo, k_cand)
        else:
            alb_k = gmm.albedo
        target_tau = -jnp.log(jnp.maximum(1.0 - xi[:, 0], 1e-12))
        u_sol = xi[:, 8] if cfg.solver == Solver.UNIFORM else None
        t_sc, scattered = sample_free_flight(
            rg, target_tau, cfg.solver, cfg.solver_iters, u_sol,
            finisher=cfg.solver_finisher)
        pos = o + t_sc[:, None] * d
        albedo = albedo_at_from_rg(rg, alb_k, t_sc)

        escaped = alive & ~scattered
        acc = acc + jnp.where(escaped[:, None], thr * scene.env_color, 0.0)
        alive_n = alive & scattered

        li, w_ne = _nee(scene, gmm, pos, xi[:, 1], xi[:, 2], xi[:, 3:5])
        contrib = thr * (albedo * INV_4PI * w_ne)[:, None] * li
        acc = acc + jnp.where(alive_n[:, None], contrib, 0.0)

        thr_n = thr * albedo[:, None]
        do_rr = bounce >= cfg.min_scatter
        cap = jnp.where(bounce >= cfg.rr_tail_after, cfg.rr_cap_tail,
                        cfg.rr_cap)
        rr = jnp.minimum(jnp.max(thr_n, axis=-1), cap)
        killed = do_rr & (xi[:, 5] > rr)
        thr_n = jnp.where((do_rr & ~killed)[:, None],
                          thr_n / jnp.maximum(rr, 1e-12)[:, None], thr_n)
        alive_n = alive_n & ~killed & (bounce + 1 < cfg.max_bounces)

        new_d = _dir_from_xi(xi[:, 6:8])
        o = jnp.where(alive_n[:, None], pos, o)
        d = jnp.where(alive_n[:, None], new_d, d)
        thr = jnp.where(alive_n[:, None], thr_n, thr)
        return (o, d, thr, acc, alive_n, sample, bounce + 1, it + 1)

    zeros3 = jnp.zeros((b, 3))
    state = (zeros3, jnp.ones((b, 3)), jnp.ones((b, 3)), zeros3,
             jnp.zeros(b, bool), jnp.zeros(b, jnp.int32),
             jnp.zeros(b, jnp.int32), jnp.int32(0))
    *_, acc, _, _, _, _ = jax.lax.while_loop(cond, body, state)
    return acc / cfg.spp


def _mesh_shards() -> int:
    """Number of devices the production render shards each pixel chunk
    over: every visible device (the reference's OpenMP pixel loop,
    integrator.h:547, mapped to cards).  Chunks are padded up to a
    multiple of the device count by the caller."""
    return len(jax.devices())


@functools.lru_cache(maxsize=32)
def _wavefront_fn(cfg: RenderConfig, static_lights, n_shards: int = 1):
    """Cached jitted wavefront chunk fn; scene and camera are traced, so
    turntable frames and fit iterations reuse one compilation."""
    fn = lambda sc, cam, ids: wavefront_pixels(
        sc, cam, cfg, ids, static_lights)
    if n_shards > 1:
        from gvr.parallel.sharding import make_mesh, shard_last_arg
        fn = shard_last_arg(fn, make_mesh(jax.devices()[:n_shards]), 3)
    return jax.jit(fn)


# engine='auto' takes the grid when the dense engine's pair evaluations per
# ray, N * (solver_iters + 3), exceed GRID_PAIR_COST times the grid's
# (accel/grid.pass_work): a grid pair evaluation costs about four dense
# megakernel ones.  Fitted to the dense/grid crossovers measured on one
# H100 at 512^2 spp 16 (PERF.md): tiny supports cross near N = 100 (work
# ratio 4.4), fat supports (diameter 0.1-0.4) stay dense at N = 1000 (1.4).
GRID_PAIR_COST = 4.0


def _grid_pays(cfg: RenderConfig, gmm):
    """The GridIndex when engine='auto' should take the grid, else None.
    Scenes too small for any grid to pay skip the (host) grid build."""
    from gvr.accel.grid import pass_work
    dense = gmm.n * (cfg.solver_iters + 3)
    if dense < GRID_PAIR_COST * pass_work(2, 1, cfg.grid_solver_iters):
        return None
    from gvr.integrators.gridscatter import grid_for
    grid = grid_for(gmm)
    work = pass_work(grid.side[0], grid.s_cap, cfg.grid_solver_iters)
    return grid if dense >= GRID_PAIR_COST * work else None


def engine_for(cfg: RenderConfig, gmm):
    """Resolve ('grid', GridIndex) or ('dense', None)."""
    if cfg.engine == "grid" and cfg.solver not in (Solver.NEWTON,
                                                   Solver.ANALYTIC_NEWTON):
        # the grid engine replaces the free-flight solver with its in-cell
        # Newton — refuse configs that would silently change semantics
        raise ValueError(
            f"engine='grid' implements the (analytic-)Newton solver "
            f"only; solver={cfg.solver.name} requires engine='dense' "
            f"or 'auto'")
    if cfg.engine == "grid":
        from gvr.integrators.gridscatter import grid_for
        return "grid", grid_for(gmm)
    grid = _grid_pays(cfg, gmm) if cfg.engine == "auto" else None
    return ("grid", grid) if grid is not None else ("dense", None)


@functools.lru_cache(maxsize=32)
def _wavefront_grid_fn(cfg: RenderConfig, n_shards: int = 1):
    from gvr.integrators.gridscatter import (
        wavefront_pixels_grid, wavefront_pixels_grid_pooled)
    wf = wavefront_pixels_grid_pooled if cfg.pool_regen \
        else wavefront_pixels_grid
    fn = lambda sc, grid, cam, ids: wf(sc, grid, cam, cfg, ids)
    if n_shards > 1:
        from gvr.parallel.sharding import make_mesh, shard_last_arg
        fn = shard_last_arg(fn, make_mesh(jax.devices()[:n_shards]), 4)
    return jax.jit(fn)


def tile_order(w: int, h: int, tw: int = 16, th: int = 8) -> np.ndarray:
    """Pixel ids permuted into tw x th screen tiles, so consecutive
    128-ray kernel blocks are spatially coherent (their paths end at
    similar depths, so a block's loop idles fewer lanes)."""
    ys, xs = np.mgrid[0:h, 0:w]
    key = ((ys // th).astype(np.int64) * ((w + tw - 1) // tw)
           + (xs // tw)) * (tw * th) \
        + (ys % th) * tw + (xs % tw)
    return np.argsort(key.reshape(-1), kind="stable").astype(np.int32)


def render_multiscatter(scene: Scene, camera, cfg: RenderConfig,
                        progress=False, stats=None,
                        trace_dir: str | None = None,
                        n_shards: int | None = None) -> np.ndarray:
    """Full MC render: all spp per pixel in one wavefront dispatch per
    pixel chunk (path regeneration keeps lanes busy across samples).
    Pixels are traced in tile order for ray-block spatial coherence.

    stats: optional utils.profiling.RenderStats — collects per-chunk spans
    (engine, shards, Mrays/s).  trace_dir: optional jax.profiler trace
    output directory (per-kernel timeline).  n_shards: devices to shard
    each chunk over (default: every visible device)."""
    from gvr.utils.profiling import device_trace, mrays_per_sec
    import time as _time

    w, h = cfg.width, cfg.height
    order = tile_order(w, h)

    engine, grid = engine_for(cfg, scene.medium)
    use_kernel = engine == "dense" and kernel_enabled(cfg)
    if engine == "grid":
        from gvr.integrators.gridscatter import grid_chunk
        chunk = grid_chunk(cfg, grid)
    elif use_kernel:
        chunk = cfg.ray_chunk      # no [rays, N] intermediates
    else:
        chunk = pick_chunk(cfg, scene.medium.n)
    chunk = min(chunk, ((w * h + 255) // 256) * 256)
    n_shards = n_shards or _mesh_shards()
    # pad the chunk so it divides evenly over the mesh (preferring whole
    # 256-ray kernel blocks per shard when the chunk is big enough)
    q = 256 * n_shards if chunk >= 256 * n_shards else n_shards
    chunk = ((chunk + q - 1) // q) * q
    if engine == "grid":
        fn_g = _wavefront_grid_fn(cfg, n_shards)
        fn = lambda sc, cam, ids: fn_g(sc, grid, cam, ids)
    else:
        static_lights = static_lights_of(scene) if use_kernel else None
        fn = _wavefront_fn(cfg, static_lights, n_shards)
    acc = np.zeros((w * h, 3), np.float32)
    if use_kernel:
        engine = "mega"
    t_render = _time.time()
    # Async chunk pipeline: JAX dispatch is asynchronous, so enqueueing
    # every chunk before fetching any lets the device run back-to-back
    # while H2D id uploads, D2H result fetches and host glue all overlap
    # compute.  A blocking np.asarray per chunk drains the device queue
    # once per chunk.  Estimator-identical: same chunks, same order, only the
    # fetch points move.  The per-chunk-timing paths (stats/progress)
    # stay synchronous — overlapped spans would be meaningless.
    pipelined = stats is None and not progress
    with device_trace(trace_dir):
        pending = []
        for start in range(0, w * h, chunk):
            stop = min(start + chunk, w * h)
            ids = order[start:stop]
            if len(ids) < chunk:
                ids = np.concatenate([ids, np.full(chunk - len(ids),
                                                   ids[-1], np.int32)])
            t0 = _time.time()
            vals = fn(scene, camera, jnp.asarray(ids))
            if pipelined:
                pending.append((start, stop, vals))
                continue
            vals = np.asarray(vals)
            if stats is not None:
                dt = _time.time() - t0
                stats.add("chunk", dt, pixels=int(stop - start),
                          paths=int((stop - start) * cfg.spp),
                          engine=engine, shards=n_shards)
            acc[order[start:stop]] = vals[: stop - start]
            if progress:
                print(f"  pixels {stop}/{w * h}")
        for start, stop, vals in pending:
            acc[order[start:stop]] = np.asarray(vals)[: stop - start]
    if stats is not None:
        dt = _time.time() - t_render
        stats.add("render_multiscatter", dt, engine=engine,
                  shards=n_shards, n=scene.medium.n,
                  paths=w * h * cfg.spp,
                  mpaths_per_s=round(mrays_per_sec(w * h * cfg.spp, dt), 3))
    return acc.reshape(h, w, 3)
