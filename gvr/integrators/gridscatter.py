"""Grid regular-tracking wavefront: the big-N multi-scatter engine.

Same estimator and RNG streams as ``integrators/multiscatter.py`` (one
persistent lane per pixel, path regeneration, NEE each bounce, RR) but every
transmittance/free-flight evaluation goes through the uniform grid
(``accel/grid.py``) instead of dense [rays, N] math:

  per bounce:
    1. DDA the extension rays into t-ordered cell crossings; per (ray,
       crossing) item, the closed-form optical depth of the crossing
       cell's Gaussians over the crossing's interval (a loop over the
       cell's table slices, one gathered slice per step); per-ray
       cumulative tau -> escape and the critical crossing (reference
       ``integrator.h:445-455``).
    2. In-cell solve on the critical crossing (reference
       ``distance_solvers.h``): the critical cell's entries are gathered
       per ray and the XLA Newton + Illinois solver and analytic finisher
       run on them, producing scatter distance + mixture albedo.
    3. NEE shadow rays ride the next iteration's tau pass; Li assembly in
       XLA (reference ``integrator.h:657-683``).

Per-ray cost is proportional to the Gaussians in the cells the ray crosses
(the reference's BVH property, ``gmm.h:452-578``), all plain jnp/lax.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gvr.config import RenderConfig
from gvr.scene.scene import Scene
from gvr.scene.gaussians import R_CUT
from gvr.accel.grid import GridIndex, build_grid, dda_crossings, H
from gvr.integrators.common import _ELEM_BUDGET
from gvr.ops.sampling import path_uniforms
from gvr.ops.solvers import (NO_SCATTER, _bracket, _safeguarded_newton,
                                 _analytic_finisher)
from gvr.ops.transmittance import RayGaussians, albedo_at_from_rg
from gvr.integrators.raymarch import _dir_from_xi, INV_4PI, FOUR_PI


def _entry_gaussians(rows, o, d, t_lo, t_hi, live):
    """RayGaussians of gathered table entries against rays, with each
    support interval clipped to [t_lo, t_hi] (the crossing).

    rows [..., 16] entry features (accel/grid._feature_rows layout);
    o, d [..., 3] and t_lo, t_hi, live [...] broadcast against rows[..., 0].
    Same cancellation-free closest-approach form as
    ops/transmittance._interval_pref."""
    f = lambda k: rows[..., k]
    ic0, ic1, ic2, ic3, ic4, ic5 = (f(k) for k in range(6))
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]

    def bil(ux, uy, uz, vx, vy, vz):
        return (ux * vx * ic0 + uy * vy * ic1 + uz * vz * ic2
                + (ux * vy + uy * vx) * ic3
                + (ux * vz + uz * vx) * ic4
                + (uy * vz + uz * vy) * ic5)

    a = bil(dx, dy, dz, dx, dy, dz)
    b = 2.0 * (bil(ox, oy, oz, dx, dy, dz)
               - (dx * f(6) + dy * f(7) + dz * f(8)))
    a_s = jnp.maximum(a, 1e-30)
    t_star = -b / (2.0 * a_s)
    vx = ox - f(13) + t_star * dx
    vy = oy - f(14) + t_star * dy
    vz = oz - f(15) + t_star * dz
    m2 = jnp.maximum(bil(vx, vy, vz, vx, vy, vz), 0.0)
    gap = (R_CUT * R_CUT - m2) / a_s
    half = jnp.sqrt(jnp.where(gap > 0.0, gap, 0.0))
    t0 = jnp.maximum(jnp.maximum(t_star - half, 0.0), t_lo)
    t1 = jnp.minimum(t_star + half, t_hi)
    hit = live & (gap > 0.0) & (t1 > t0) & (f(12) > 0.0)
    peak = f(10) * jnp.exp(-0.5 * m2)
    pref = peak * jnp.sqrt(jnp.pi / (2.0 * a_s))
    fscale = 1.0 / (2.0 * jnp.sqrt(2.0 * a_s))
    erf_lo = jax.lax.erf((b + 2.0 * a * t0) * fscale)
    erf_hi = jax.lax.erf((b + 2.0 * a * t1) * fscale)
    tau_i = jnp.where(hit, pref * (erf_hi - erf_lo), 0.0)
    return RayGaussians(a, b, peak, pref, fscale, t0, t1, hit, erf_lo,
                        erf_hi, tau_i)


def grid_tau_crossings(grid: GridIndex, o, d, tmax=None):
    """Per-crossing optical depth, t-ordered.  Returns (tau [B,C],
    cells [B,C], t_in [B,C], t_out [B,C]); invalid/empty slots have tau 0.

    One ``fori_loop`` over slices: step j gathers slice j of every item's
    cell ([B, C, H, 16]) and adds its entries' optical depth over the
    item's crossing interval; items whose cell has fewer slices are masked.
    The trip count is the deepest cell among the batch's items."""
    cells, t_in, t_out = dda_crossings(grid, o, d, tmax)
    safe = jnp.maximum(cells, 0)
    first = grid.cell_sfirst[safe]
    span = jnp.where(cells >= 0, grid.cell_sspan[safe], 0)     # [B, C]
    o4, d4 = o[:, None, None, :], d[:, None, None, :]
    tin4, tout4 = t_in[..., None], t_out[..., None]

    def body(j, tau):
        live = (j < span)[..., None]
        rows = grid.table[jnp.where(j < span, first + j, 0)]
        rg = _entry_gaussians(rows, o4, d4, tin4, tout4, live)
        return tau + jnp.sum(rg.tau_i, axis=-1)

    tau = jax.lax.fori_loop(0, jnp.max(span), body, jnp.zeros_like(t_in))
    return tau, cells, t_in, t_out


def grid_transmittance(grid: GridIndex, o, d, tmax=None):
    """exp(-total tau up to tmax) — the NEE shadow/env transmittance
    (reference ``gmm.h:517-578``)."""
    tau, *_ = grid_tau_crossings(grid, o, d, tmax)
    return jnp.exp(-jnp.sum(tau, axis=-1))


def grid_free_flight(grid: GridIndex, o, d, u_tau, solver_iters=12):
    """Free-flight sampling by grid regular tracking.

    Returns (t_sc [B], scattered [B], albedo [B], tau_tot [B])."""
    tau, cells, t_in, t_out = grid_tau_crossings(grid, o, d, None)
    return grid_solve_from_crossings(grid, o, d, tau, cells, t_in, t_out,
                                     u_tau, solver_iters)


def _take(x, idx):
    return jnp.take_along_axis(x, idx[:, None], axis=-1)[:, 0]


def grid_solve_from_crossings(grid: GridIndex, o, d, tau, cells, t_in,
                              t_out, u_tau, solver_iters=12):
    """Critical-crossing search + in-cell Newton solve, given per-crossing
    taus (separated from the tau pass so the wavefront can batch extension
    and NEE rays into one tau pass)."""
    cum = jnp.cumsum(tau, axis=-1)
    tau_tot = cum[:, -1]
    target = -jnp.log(jnp.maximum(1.0 - u_tau, 1e-12))
    scattered = tau_tot > target
    # floor the clamped target at a tiny positive tau: u_tau == 0 gives
    # target 0, whose critical slot would be crossing 0 — possibly an
    # EMPTY cell, leaving nothing to solve (t_sc = 0, albedo = 0, path
    # killed) where the dense engine scatters at the medium entry with a
    # real albedo.  The floor lands crit on the first occupied crossing
    # and moves the root by O(1e-12) optical depth.
    tgt = jnp.maximum(jnp.minimum(target, tau_tot * 0.999999), 1e-12)

    # first crossing where the running tau passes the target
    crit = jnp.sum((cum < tgt[:, None]).astype(jnp.int32), axis=-1)
    crit = jnp.clip(crit, 0, grid.c_max - 1)
    residual = jnp.maximum(tgt - (_take(cum, crit) - _take(tau, crit)), 0.0)
    cell_c = jnp.where(scattered, _take(cells, crit), -1)
    safe = jnp.maximum(cell_c, 0)
    span = jnp.where(cell_c >= 0, grid.cell_sspan[safe], 0)

    # the critical cell's entries, [B, s_cap * H]
    j = jnp.arange(grid.s_cap)
    live = j[None, :] < span[:, None]
    sl = jnp.where(live, grid.cell_sfirst[safe][:, None] + j[None, :], 0)
    rows = grid.table[sl].reshape(o.shape[0], grid.s_cap * H, 16)
    live = jnp.repeat(live, H, axis=1)
    rg = _entry_gaussians(rows, o[:, None, :], d[:, None, :],
                          _take(t_in, crit)[:, None],
                          _take(t_out, crit)[:, None], live)

    t_lo, t_hi, tau_cell = _bracket(rg)
    tgt_c = jnp.minimum(residual, tau_cell * 0.999999)
    t_sc = _safeguarded_newton(rg, tgt_c, t_lo, t_hi, solver_iters)
    t_sc = jnp.clip(_analytic_finisher(rg, tgt_c, t_sc), t_lo, t_hi)
    albedo = albedo_at_from_rg(rg, rows[..., 11], t_sc)
    t_sc = jnp.where(scattered, t_sc, NO_SCATTER)
    albedo = jnp.where(scattered, albedo, 0.0)
    return t_sc, scattered, albedo, tau_tot


def grid_chunk(cfg: RenderConfig, grid: GridIndex) -> int:
    """Rays per chunk: the tau pass holds [2 rays, C, H] pair terms per
    step and the solve [rays, s_cap * H]; keep both within the dense
    engine's element budget."""
    per_ray = max(2 * grid.c_max * H, grid.s_cap * H)
    chunk = min(cfg.ray_chunk, 1 << 15, max(256, _ELEM_BUDGET // per_ray))
    return max(256, (chunk // 256) * 256)


def _nee_select(scene: Scene, pos, xi_choice, xi_light, xi_env2):
    """NEE light/env selection (integrator.h:657-683) *without* the
    transmittance: returns (wi [B,3], tmax [B], base [B,3], w_ne) such
    that Li = transmittance(pos, wi, tmax) * base."""
    num_lights = scene.lights_p.shape[0]
    wi_env = _dir_from_xi(xi_env2)
    env_base = jnp.broadcast_to(scene.env_color * FOUR_PI,
                                (pos.shape[0], 3))

    if num_lights == 0:
        return wi_env, jnp.full(pos.shape[0], 1e8, jnp.float32), \
            env_base, 1.0

    is_env = xi_choice < 1.0 / (num_lights + 1)
    lidx = jnp.clip((xi_light * num_lights).astype(jnp.int32),
                    0, num_lights - 1)
    lp = scene.lights_p[lidx]
    linten = scene.lights_i[lidx]
    to_l = lp - pos
    dist = jnp.linalg.norm(to_l, axis=-1)
    wi_l = to_l / jnp.maximum(dist, 1e-12)[:, None]

    wi = jnp.where(is_env[:, None], wi_env, wi_l)
    tmax = jnp.where(is_env, jnp.float32(1e8), dist)
    base_l = linten / jnp.maximum(dist * dist, 1e-12)[:, None]
    base = jnp.where(is_env[:, None], env_base, base_l)
    return wi, tmax, base, float(num_lights + 1)


def _nee_grid(scene: Scene, grid: GridIndex, pos, xi_choice, xi_light,
              xi_env2):
    """NEE with grid transmittance; same selection logic as
    ``multiscatter._nee`` (integrator.h:657-683)."""
    wi, tmax, base, w_ne = _nee_select(scene, pos, xi_choice, xi_light,
                                       xi_env2)
    tr = grid_transmittance(grid, pos, wi, tmax)
    return tr[:, None] * base, w_ne


def wavefront_pixels_grid(scene: Scene, grid: GridIndex, camera,
                          cfg: RenderConfig, ids):
    """Grid-engine counterpart of ``multiscatter.wavefront_pixels``: same
    path regeneration, RNG streams, NEE and RR — estimator-identical.

    Per iteration there is ONE merged tau pass: the current bounce's
    extension rays and the *previous* bounce's NEE shadow rays ride the
    same DDA + slice loop (shadow Li lands in the accumulator one
    iteration late; a final flush iteration drains the pipeline), so the
    loop's trip count is paid once per iteration."""
    from gvr.integrators.multiscatter import strat_n, strat_uv

    b = ids.shape[0]
    w, h = cfg.width, cfg.height
    x = ids % w
    y = ids // w
    n_strat = strat_n(cfg.spp)

    def make_ray(sample_idx):
        xi = path_uniforms(ids, sample_idx, 0x7FFF0000, 2, cfg.seed)
        u, v = strat_uv(x, y, sample_idx, n_strat, w, h,
                        xi[:, 0], xi[:, 1])
        return camera.sample_ray(jnp.stack([u, v], axis=-1))

    def cond(state):
        (o, d, thr, acc, alive, sample, bounce, it,
         p_pos, p_wi, p_tmax, p_val) = state
        return (jnp.any(alive | (sample < cfg.spp))
                | jnp.any(p_val > 0.0)) & (
            it < cfg.spp * cfg.max_bounces + cfg.max_bounces + 1)

    def body(state):
        (o, d, thr, acc, alive, sample, bounce, it,
         p_pos, p_wi, p_tmax, p_val) = state

        regen = ~alive & (sample < cfg.spp)
        o_n, d_n = make_ray(jnp.where(regen, sample, 0))
        o = jnp.where(regen[:, None], o_n, o)
        d = jnp.where(regen[:, None], d_n, d)
        thr = jnp.where(regen[:, None], 1.0, thr)
        bounce = jnp.where(regen, 0, bounce)
        sample = jnp.where(regen, sample + 1, sample)
        alive = alive | regen

        xi = path_uniforms(ids, jnp.maximum(sample, 1) - 1, bounce, 9,
                           cfg.seed)

        # --- ONE tau pass: [ext rays ; pending NEE rays] ---
        # dead lanes get a zero-length traversal: their stale rays would
        # otherwise keep generating live work items every iteration
        o2 = jnp.concatenate([o, p_pos], axis=0)
        d2 = jnp.concatenate([d, p_wi], axis=0)
        tmax2 = jnp.concatenate([jnp.where(alive, 1e8, 0.0), p_tmax])
        tau2, cells2, tin2, tout2 = grid_tau_crossings(grid, o2, d2, tmax2)

        # pending NEE completion (bounce k-1's shadow rays)
        tr = jnp.exp(-jnp.sum(tau2[b:], axis=-1))
        acc = acc + tr[:, None] * p_val

        # extension: critical-crossing solve
        t_sc, scattered, albedo, _ = grid_solve_from_crossings(
            grid, o, d, tau2[:b], cells2[:b], tin2[:b], tout2[:b],
            xi[:, 0], cfg.grid_solver_iters)

        escaped = alive & ~scattered
        acc = acc + jnp.where(escaped[:, None], thr * scene.env_color, 0.0)
        alive_n = alive & scattered

        pos = o + jnp.maximum(t_sc, 0.0)[:, None] * d
        wi, tmax_n, base, w_ne = _nee_select(scene, pos, xi[:, 1],
                                             xi[:, 2], xi[:, 3:5])
        weight = thr * (albedo * INV_4PI * w_ne)[:, None] * base
        p_val_n = jnp.where(alive_n[:, None], weight, 0.0)
        # dead pending rays: zero-length traversal (tmax 0) costs nothing
        p_tmax_n = jnp.where(alive_n, tmax_n, 0.0)

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
        return (o, d, thr, acc, alive_n, sample, bounce + 1, it + 1,
                pos, wi, p_tmax_n, p_val_n)

    zeros3 = jnp.zeros((b, 3))
    state = (zeros3, jnp.ones((b, 3)), jnp.ones((b, 3)), zeros3,
             jnp.zeros(b, bool), jnp.zeros(b, jnp.int32),
             jnp.zeros(b, jnp.int32), jnp.int32(0),
             zeros3, jnp.ones((b, 3)), jnp.zeros(b), zeros3)
    *_, acc, _, _, _, _, _, _, _, _ = jax.lax.while_loop(cond, body, state)
    return acc / cfg.spp


def wavefront_pixels_grid_pooled(scene: Scene, grid: GridIndex, camera,
                                 cfg: RenderConfig, ids):
    """Grid wavefront with POOLED regeneration: a dead lane claims the
    chunk's next untraced (pixel, sample) from a shared pool instead of
    idling once its own pixel's samples are exhausted.

    Why: the per-lane scheme (``wavefront_pixels_grid``) runs the chunk's
    while_loop until its SLOWEST pixel finishes all spp samples, so every
    iteration's DDA/sweep cost is also spent on lanes whose pixel is done.
    Pooling bounds the loop at ~ceil(total_work / lanes) + one path tail.

    Estimator-identical per (pixel, sample): RNG streams are keyed by
    (pixel, sample, bounce) (ops/sampling.path_uniforms), so WHICH lane
    traces a sample never changes its radiance.  Each sample scatters
    into its own slot of a [b*spp] accumulator and pixels sum their spp
    slots in fixed sample order, so per-pixel output is bit-deterministic
    and chunk-layout-invariant (only f32 add GROUPING differs from the
    per-lane engine: per-sample subtotals instead of one running per-lane
    sum — ulp-level).

    Pool order is pixel-major (slot g ↦ pixel ids[g // spp], sample
    g % spp): a pixel's samples are claimed consecutively.
    """
    from gvr.integrators.multiscatter import strat_n, strat_uv

    b = ids.shape[0]
    w, h = cfg.width, cfg.height
    spp = cfg.spp
    pool_n = b * spp
    n_strat = strat_n(cfg.spp)

    def make_ray(px, sample_idx):
        xi = path_uniforms(px, sample_idx, 0x7FFF0000, 2, cfg.seed)
        u, v = strat_uv(px % w, px // w, sample_idx, n_strat, w, h,
                        xi[:, 0], xi[:, 1])
        return camera.sample_ray(jnp.stack([u, v], axis=-1))

    def cond(state):
        (o, d, thr, slots, alive, px, smp, g, next_g, bounce, it,
         p_pos, p_wi, p_tmax, p_val, p_g) = state
        return (jnp.any(alive) | (next_g < pool_n)
                | jnp.any(p_val > 0.0)) & (
            it < cfg.spp * cfg.max_bounces + cfg.max_bounces + 1)

    def body(state):
        (o, d, thr, slots, alive, px, smp, g, next_g, bounce, it,
         p_pos, p_wi, p_tmax, p_val, p_g) = state

        # --- pooled regeneration: dead lanes claim consecutive slots ---
        dead = ~alive
        di = dead.astype(jnp.int32)
        rank = jnp.cumsum(di) - di              # exclusive rank among dead
        g_new = next_g + rank
        regen = dead & (g_new < pool_n)
        pix_idx = jnp.clip(g_new // spp, 0, b - 1)
        px_new = jnp.take(ids, pix_idx)
        smp_new = g_new % spp
        g = jnp.where(regen, g_new, g)
        px = jnp.where(regen, px_new, px)
        smp = jnp.where(regen, smp_new, smp)
        next_g = jnp.minimum(next_g + jnp.sum(di), pool_n)

        o_n, d_n = make_ray(px, jnp.where(regen, smp, 0))
        o = jnp.where(regen[:, None], o_n, o)
        d = jnp.where(regen[:, None], d_n, d)
        thr = jnp.where(regen[:, None], 1.0, thr)
        bounce = jnp.where(regen, 0, bounce)
        alive = alive | regen

        xi = path_uniforms(px, smp, bounce, 9, cfg.seed)

        # --- ONE tau pass: [ext rays ; pending NEE rays] ---
        o2 = jnp.concatenate([o, p_pos], axis=0)
        d2 = jnp.concatenate([d, p_wi], axis=0)
        tmax2 = jnp.concatenate([jnp.where(alive, 1e8, 0.0), p_tmax])
        tau2, cells2, tin2, tout2 = grid_tau_crossings(grid, o2, d2, tmax2)

        # pending NEE completion (bounce k-1's shadow rays) -> its slot
        tr = jnp.exp(-jnp.sum(tau2[b:], axis=-1))
        slots = slots.at[p_g].add(tr[:, None] * p_val)

        # extension: critical-crossing solve
        t_sc, scattered, albedo, _ = grid_solve_from_crossings(
            grid, o, d, tau2[:b], cells2[:b], tin2[:b], tout2[:b],
            xi[:, 0], cfg.grid_solver_iters)

        escaped = alive & ~scattered
        g_esc = jnp.where(escaped, g, pool_n)
        slots = slots.at[g_esc].add(thr * scene.env_color)
        alive_n = alive & scattered

        pos = o + jnp.maximum(t_sc, 0.0)[:, None] * d
        wi, tmax_n, base, w_ne = _nee_select(scene, pos, xi[:, 1],
                                             xi[:, 2], xi[:, 3:5])
        weight = thr * (albedo * INV_4PI * w_ne)[:, None] * base
        p_val_n = jnp.where(alive_n[:, None], weight, 0.0)
        p_tmax_n = jnp.where(alive_n, tmax_n, 0.0)
        p_g_n = jnp.where(alive_n, g, pool_n)

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
        return (o, d, thr, slots, alive_n, px, smp, g, next_g,
                bounce + 1, it + 1, pos, wi, p_tmax_n, p_val_n, p_g_n)

    zeros3 = jnp.zeros((b, 3))
    state = (zeros3, jnp.ones((b, 3)), jnp.ones((b, 3)),
             jnp.zeros((pool_n + 1, 3)),            # slot pool + dummy row
             jnp.zeros(b, bool), ids, jnp.zeros(b, jnp.int32),
             jnp.zeros(b, jnp.int32), jnp.int32(0),
             jnp.zeros(b, jnp.int32), jnp.int32(0),
             zeros3, jnp.ones((b, 3)), jnp.zeros(b), zeros3,
             jnp.full(b, pool_n, jnp.int32))
    st = jax.lax.while_loop(cond, body, state)
    slots = st[3]
    return slots[:pool_n].reshape(b, spp, 3).sum(axis=1) / cfg.spp


# scene-content -> GridIndex cache (host side; rebuilt when gaussians change)
_GRID_CACHE: dict = {}


def grid_for(gmm) -> GridIndex:
    # content digest of the arrays that determine the grid — a float-sum
    # key collides for sum-preserving edits (e.g. swapping two coordinates)
    # and would silently reuse the wrong grid
    import hashlib
    hsh = hashlib.blake2b(digest_size=16)
    for arr in (gmm.mean, gmm.density, gmm.albedo, gmm.eigvals,
                gmm.eigvecs):
        hsh.update(np.ascontiguousarray(np.asarray(arr)).tobytes())
    key = (gmm.n, hsh.hexdigest())
    g = _GRID_CACHE.get(key)
    if g is None:
        g = build_grid(gmm)
        _GRID_CACHE.clear()        # keep at most one (tables can be large)
        _GRID_CACHE[key] = g
    return g
