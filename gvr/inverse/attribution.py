"""Per-pixel Gaussian attribution.

Counterpart of the reference's RECORD_PIXEL_GAUSSIANS machinery
(integrator.h:415,526-545,616-644 + inverse_integrator.h:125-131): which
Gaussians contribute to which pixel.  The reference collects dynamic
per-pixel index lists during rendering to restrict its finite-difference
loss sums; autodiff made that unnecessary here, but the capability remains
useful (debugging, localized refinement, sparse updates), so it is exposed
as fixed-K tensors:

* ``pixel_gaussians``: top-k Gaussians intersected by each pixel's primary
  ray, nearest entry first (+ the count, so overflow is detectable);
* ``pixel_gaussians_paths``: the reference's FULL recording — the union of
  contributing Gaussians at **every scatter event along every sample
  path** (integrator.h:616-644): on scatter, every Gaussian whose interval
  entry precedes the scatter point; on escape, every forward hit.  Replays
  the renderer's exact path streams (same counter-hash RNG keyed by
  (pixel, sample, bounce)), so the footprint is the set of Gaussians the
  estimator actually touched;
* ``gaussian_pixel_counts``: the inverse histogram — for how many pixels
  each Gaussian is a candidate (the reference's ``gaussian_pixels`` lists,
  as counts).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from gvr.config import RenderConfig
from gvr.scene.scene import Scene
from gvr.ops.quadratics import intersect_gaussians
from gvr.integrators.common import ids_to_pixels, pick_chunk


def _primary_rays(camera, w, h, ids):
    x, y = ids_to_pixels(ids, w)
    u = (x.astype(jnp.float32) + 0.5) / w
    v = (y.astype(jnp.float32) + 0.5) / h
    return camera.sample_ray(jnp.stack([u, v], axis=-1))


@functools.lru_cache(maxsize=32)
def _pixel_gaussians_fn(w: int, h: int, k: int):
    """Cached jitted chunk fn; scene and camera are traced pytrees, so the
    SFD fit loop's repeated footprint calls reuse one compilation."""

    @jax.jit
    def chunk(sc, camera, ids):
        o, d = _primary_rays(camera, w, h, ids)
        t0, t1, hit = intersect_gaussians(sc.medium, o, d)
        key = jnp.where(hit, -jnp.maximum(t0, 0.0), -jnp.inf)
        _, idx = jax.lax.top_k(key, k)
        valid = jnp.take_along_axis(hit, idx, axis=-1)
        idx = jnp.where(valid, idx, -1)
        count = jnp.sum(hit.astype(jnp.int32), axis=-1)
        return idx, count

    return chunk


def pixel_gaussians(scene: Scene, camera, cfg: RenderConfig, k: int = 16):
    """[H*W, k] int32 Gaussian indices per pixel (-1 padded, sorted by entry
    distance) and [H*W] hit counts."""
    w, h = cfg.width, cfg.height
    gmm = scene.medium
    k = min(k, gmm.n)
    fn = _pixel_gaussians_fn(w, h, k)

    n = w * h
    ch = pick_chunk(cfg, gmm.n)
    out_idx = np.empty((n, k), np.int32)
    out_cnt = np.empty((n,), np.int32)
    for start in range(0, n, ch):
        ids = np.arange(start, start + ch, dtype=np.int32)
        ids = np.minimum(ids, n - 1)
        idx, cnt = fn(scene, camera, jnp.asarray(ids))
        stop = min(start + ch, n)
        out_idx[start:stop] = np.asarray(idx)[: stop - start]
        out_cnt[start:stop] = np.asarray(cnt)[: stop - start]
    return out_idx, out_cnt


@functools.lru_cache(maxsize=32)
def _path_membership_fn(cfg: RenderConfig):
    """Cached jitted chunk fn: one sample path per pixel lane, returns the
    [B, N] bool union of per-bounce contributing sets.  The path stream
    (camera jitter, free-flight target, RR, phase resample) is keyed
    identically to ``multiscatter_radiance`` — the recorded footprint is
    the renderer's own."""
    from gvr.config import Solver
    from gvr.ops.transmittance import (tau_coeffs, albedo_at_from_rg,
                                           compact_candidates)
    from gvr.ops.solvers import sample_free_flight
    from gvr.ops.sampling import path_uniforms
    from gvr.integrators.multiscatter import mc_camera_rays
    from gvr.integrators.raymarch import _dir_from_xi

    @jax.jit
    def chunk(sc, camera, ids, sample_idx):
        gmm = sc.medium
        # mirror the renderer's candidate compaction exactly: with
        # candidate_k active the renderer solves free flight on the
        # compacted set, so the replayed paths must too — otherwise
        # t_scatter diverges from bounce 0 and the footprint records a
        # different path family than the one the estimator integrated
        use_compact = 0 < cfg.candidate_k < gmm.n
        o, d, rng_ids = mc_camera_rays(sc, camera, cfg, ids, sample_idx)
        b = o.shape[0]

        def cond(state):
            o, d, thr, alive, bounce, mem = state
            return jnp.any(alive) & (bounce < cfg.max_bounces)

        def body(state):
            o, d, thr, alive, bounce, mem = state
            rg = tau_coeffs(gmm, o, d)
            if use_compact:
                rg_s, alb_k, _ = compact_candidates(rg, gmm.albedo,
                                                    cfg.candidate_k)
            else:
                rg_s, alb_k = rg, gmm.albedo
            xi = path_uniforms(rng_ids, sample_idx, bounce, 9, cfg.seed)
            target_tau = -jnp.log(jnp.maximum(1.0 - xi[:, 0], 1e-12))
            u_sol = xi[:, 8] if cfg.solver == Solver.UNIFORM else None
            t_sc, scattered = sample_free_flight(
                rg_s, target_tau, cfg.solver, cfg.solver_iters, u_sol,
                finisher=cfg.solver_finisher)

            # record (integrator.h:616-644): on scatter, every Gaussian
            # whose interval entry precedes the scatter point (all sorted
            # events with t <= t_scatter + tol are enter events of exactly
            # these); on escape, every forward intersection.  Membership
            # is read off the FULL rg — the reference's event walk records
            # every pre-scatter event, uncapped — while the path geometry
            # above follows the renderer's (possibly compacted) solve.
            touched = jnp.where(scattered[:, None],
                                rg.hit & (rg.t0 <= t_sc[:, None] + 1e-6),
                                rg.hit)
            mem = mem | (touched & alive[:, None])

            alive_n = alive & scattered
            pos = o + t_sc[:, None] * d
            albedo = albedo_at_from_rg(rg_s, alb_k, t_sc)

            thr_n = thr * albedo[:, None]
            do_rr = bounce >= cfg.min_scatter
            cap = jnp.where(bounce >= cfg.rr_tail_after, cfg.rr_cap_tail,
                            cfg.rr_cap)
            rr = jnp.minimum(jnp.max(thr_n, axis=-1), cap)
            killed = do_rr & (xi[:, 5] > rr)
            thr_n = jnp.where((do_rr & ~killed)[:, None],
                              thr_n / jnp.maximum(rr, 1e-12)[:, None],
                              thr_n)
            alive_n = alive_n & ~killed

            new_d = _dir_from_xi(xi[:, 6:8])
            o = jnp.where(alive_n[:, None], pos, o)
            d = jnp.where(alive_n[:, None], new_d, d)
            thr = jnp.where(alive_n[:, None], thr_n, thr)
            return o, d, thr, alive_n, bounce + 1, mem

        state = (o, d, jnp.ones((b, 3)), jnp.ones((b,), bool),
                 jnp.int32(0), jnp.zeros((b, gmm.n), bool))
        *_, mem = jax.lax.while_loop(cond, body, state)
        return mem

    return chunk


def pixel_gaussians_paths(scene: Scene, camera, cfg: RenderConfig,
                          k: int = 16, spp: int | None = None):
    """Multi-bounce per-pixel attribution (integrator.h:616-644 +
    inverse_integrator.h:125-131): [H*W, k] int32 Gaussian indices per
    pixel (-1 padded, ascending index) and [H*W] exact union counts, from
    the union over ``spp`` sample paths (default ``cfg.spp``) of every
    scatter event's contributing set.  A Gaussian reached only via a
    secondary bounce appears here but not in ``pixel_gaussians``."""
    w, h = cfg.width, cfg.height
    gmm = scene.medium
    k = min(k, gmm.n)
    spp = cfg.spp if spp is None else spp
    fn = _path_membership_fn(cfg)

    n = w * h
    ch = pick_chunk(cfg, gmm.n)
    counts = np.empty(n, np.int32)
    out_idx = np.full((n, k), -1, np.int32)
    # per-chunk membership only: a persistent [H*W, N] bool was ~5.2 GB at
    # 512^2 x 20k gaussians — exactly the big-scene inverse runs this
    # multi-bounce footprint exists for.  Counts and first-k indices are
    # extracted per chunk and the [chunk, N] working set is dropped.
    for start in range(0, n, ch):
        ids = np.minimum(np.arange(start, start + ch, dtype=np.int32),
                         n - 1)
        stop = min(start + ch, n)
        acc = np.zeros((ch, gmm.n), bool)
        for s in range(spp):
            acc |= np.asarray(fn(scene, camera, jnp.asarray(ids),
                                 jnp.int32(s)))
        acc = acc[: stop - start]
        counts[start:stop] = acc.sum(axis=1).astype(np.int32)
        px, g = np.nonzero(acc)                   # row-major: g ascending
        row_first = np.searchsorted(px, np.arange(stop - start))
        pos = np.arange(len(px)) - row_first[px]
        sel = pos < k
        out_idx[start + px[sel], pos[sel]] = g[sel]
    return out_idx, counts


@functools.lru_cache(maxsize=32)
def _hit_counts_fn(w: int, h: int):
    @jax.jit
    def chunk(sc, camera, ids):
        o, d = _primary_rays(camera, w, h, ids)
        _, _, hit = intersect_gaussians(sc.medium, o, d)
        return jnp.sum(hit.astype(jnp.int32), axis=0)      # [N]

    return chunk


def gaussian_pixel_counts(scene: Scene, camera,
                          cfg: RenderConfig) -> np.ndarray:
    """[N] number of pixels whose primary ray intersects each Gaussian —
    the inverted attribution map (inverse_integrator.h:125-131).  EXACT:
    sums the full [chunk, N] hit mask per chunk (no top-k truncation —
    a dense scene's rays can overlap far more than 16 Gaussians)."""
    w, h = cfg.width, cfg.height
    fn = _hit_counts_fn(w, h)
    n = w * h
    ch = pick_chunk(cfg, scene.medium.n)
    counts = np.zeros(scene.medium.n, np.int64)
    for start in range(0, n, ch):
        ids = np.minimum(np.arange(start, start + ch, dtype=np.int32),
                         n - 1)
        counts += np.asarray(
            fn(scene, camera, jnp.asarray(ids))).astype(np.int64)
    pad = ch * ((n + ch - 1) // ch) - n
    if pad:
        # the last chunk repeated pixel n-1 `pad` extra times
        single = np.asarray(fn(
            scene, camera,
            jnp.full((ch,), n - 1, jnp.int32))).astype(np.int64)
        counts -= (pad * single) // ch
    return counts
