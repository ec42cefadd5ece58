"""Persistent path-tracing megakernel (Pallas, Triton route).

One program traces a block of pixels through ALL of their samples and
bounces: regeneration of dead lanes (stratified camera ray, counter-hash
RNG in ``uint32``), free-flight sampling by bracketed Newton + Illinois on
the clipped-interval optical depth, mixture albedo, next-event estimation
and Russian roulette (reference ``integrator.h:422-498,557-699``).  Only
the pixel ids stream in and the per-pixel radiance sums stream out.

Why a kernel: the XLA wavefront materialises ~8 ``[rays, N]`` arrays per
bounce and re-reads them on every Newton trip, so it is bound by device
memory.  Here a ray's state stays in registers and the Gaussian table
(64 B per Gaussian, resident in L1/L2) streams in ``tile``-row tiles; every
pass recomputes the pair terms per tile, which costs arithmetic instead of
memory traffic.

Layout: rays are 1-D ``[blk]`` vectors (one lane each); a tile of Gaussian
features is a ``[tile, 1]`` column, so pair terms are ``[tile, blk]`` and
reduce over axis 0.  ``tile=1`` degenerates to one Gaussian per step with
broadcast scalar loads.

Estimator- and RNG-stream-identical to ``integrators/multiscatter
.wavefront_pixels`` with the Newton solver (same (pixel, sample, bounce)
streams, same regeneration/RR/NEE order).  The kernel implements the
Newton solver without the analytic finisher; other solvers run on XLA.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from gvr.ops.solvers import illinois_update
from gvr.scene.gaussians import R_CUT

SQRT_HALF = 0.7071067811865476
SQRT_HALF_PI = math.sqrt(0.5 * math.pi)
FOUR_PI = 4.0 * math.pi
INV_4PI = 1.0 / FOUR_PI
BIG = 1e30

# feature rows of the packed table
N_FEAT = 16
_IC, _Q, _DENS, _ALB, _VALID, _MEAN = 0, 6, 9, 10, 11, 12

# launch geometry, chosen by measurement on the card (see PERF.md)
BLOCK = 128
TILE = 4
NUM_WARPS = 4

# counter-hash constants (ops/sampling.path_uniforms)
_M1, _M2, _M3 = 0x9E3779B9, 0x21F0AAAD, 0x735A2D97
JITTER_TAG = 0x7FFF0000


def _mix32_py(x: int) -> int:
    """Python-int mirror of ``_mix32`` (static seeds)."""
    mask = 0xFFFFFFFF
    x = (x + _M1) & mask
    x = ((x ^ (x >> 16)) * _M2) & mask
    x = ((x ^ (x >> 15)) * _M3) & mask
    return x ^ (x >> 15)


def _mix32(x):
    x = x + jnp.uint32(_M1)
    x = (x ^ (x >> 16)) * jnp.uint32(_M2)
    x = (x ^ (x >> 15)) * jnp.uint32(_M3)
    return x ^ (x >> 15)


def _uniforms(pid, s, b, n, seed):
    """The ``path_uniforms`` hash chain on uint32 vectors: n [blk] f32
    uniforms in [0, 1), bit-exact with the XLA version."""
    sd = seed & 0xFFFFFFFF
    h1 = _mix32(pid * jnp.uint32(0x85EBCA6B)
                ^ (s * jnp.uint32(0xC2B2AE35))
                ^ jnp.uint32(_mix32_py(sd)))
    h2 = _mix32((pid ^ jnp.uint32(0xDEADBEEF)) * jnp.uint32(0x9E3779B1)
                + s * jnp.uint32(0x6C078965) + jnp.uint32(sd))
    b1 = _mix32(h1 ^ (b * jnp.uint32(0x27D4EB2F)))
    b2 = _mix32(h2 + b * jnp.uint32(0x41C64E6D))
    cols = [_mix32((b1 ^ jnp.uint32((0x165667B1 * (i + 1)) & 0xFFFFFFFF))
                   + b2) for i in range(n)]
    return [(c >> 9).astype(jnp.int32).astype(jnp.float32)
            * jnp.float32(2.0 ** -23) for c in cols]


def _erf_from_exp(x, expx2):
    """erf by Abramowitz-Stegun 7.1.26 (|abs err| <= 1.5e-7) with the
    exp(-x^2) factor supplied by the caller: in the Newton loop the same
    exponential is the Gaussian's extinction profile, so one ``exp``
    serves both.  (The Triton route has no ``erf`` lowering.)"""
    ax = jnp.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    y = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    r = 1.0 - y * expx2
    return jnp.where(x < 0.0, -r, r)


def pack_table(gmm, tile: int = TILE):
    """[16, Np] feature-major table, Np = N rounded up to ``tile``.  Pure
    jnp, so it traces under jit.  Padding columns are an identity
    quadratic with zero density and valid = 0."""
    n = gmm.n
    np_ = ((n + tile - 1) // tile) * tile
    rows = jnp.concatenate([
        gmm.icpack(),                                    # 0-5
        gmm.qvec(),                                      # 6-8
        (gmm.density * gmm.norm)[:, None],               # 9
        gmm.albedo[:, None],                             # 10
        jnp.ones((n, 1), jnp.float32),                   # 11 valid
        gmm.mean,                                        # 12-14
        jnp.zeros((n, 1), jnp.float32),                  # 15 unused
    ], axis=1).astype(jnp.float32)
    pad = jnp.zeros((np_ - n, N_FEAT), jnp.float32).at[:, 0:3].set(1.0)
    return jnp.concatenate([rows, pad], axis=0).T


def camera_vector(camera) -> jnp.ndarray:
    """[16] f32 camera row: position, right, up, view_dir, focal (0 for
    orthographic), 3 zeros.  Traced, so turntables do not recompile; the
    camera KIND is the static ``pinhole`` argument of ``mega_call``."""
    from gvr.cameras import PinholeCamera
    if isinstance(camera, PinholeCamera):
        focal = 1.0 / jnp.tan(0.5 * camera.fov)
    else:
        focal = jnp.float32(0.0)
    return jnp.concatenate([
        jnp.asarray(camera.position, jnp.float32).reshape(3),
        jnp.asarray(camera.right, jnp.float32).reshape(3),
        jnp.asarray(camera.up, jnp.float32).reshape(3),
        jnp.asarray(camera.view_dir, jnp.float32).reshape(3),
        jnp.asarray(focal, jnp.float32).reshape(1),
        jnp.zeros(3, jnp.float32)])


def _pair(c, o, d, tmax):
    """Clipped-interval terms of one Gaussian tile against the block's
    rays: ([tile, blk] each) sa, zoff, peak, pref, t0, hi, ok where the
    ray's support interval is [t0, hi] (hi clipped to ``tmax``)."""
    ox, oy, oz = o
    dx, dy, dz = d
    ic0, ic1, ic2, ic3, ic4, ic5 = c[_IC:_IC + 6]

    def bil(ux, uy, uz, vx, vy, vz):
        return (ux * vx * ic0 + uy * vy * ic1 + uz * vz * ic2
                + (ux * vy + uy * vx) * ic3
                + (ux * vz + uz * vx) * ic4
                + (uy * vz + uz * vy) * ic5)

    a = bil(dx, dy, dz, dx, dy, dz)
    b = 2.0 * (bil(ox, oy, oz, dx, dy, dz)
               - (dx * c[_Q] + dy * c[_Q + 1] + dz * c[_Q + 2]))
    a_s = jnp.maximum(a, 1e-30)
    inv_a = 1.0 / a_s
    # closest approach and its squared Mahalanobis distance (stable
    # positive form, ops/transmittance.min_mahalanobis_sq)
    t_star = -0.5 * b * inv_a
    vx = ox - c[_MEAN] + t_star * dx
    vy = oy - c[_MEAN + 1] + t_star * dy
    vz = oz - c[_MEAN + 2] + t_star * dz
    m2 = jnp.maximum(vx * vx * ic0 + vy * vy * ic1 + vz * vz * ic2
                     + 2.0 * (vx * vy * ic3 + vx * vz * ic4 + vy * vz * ic5),
                     0.0)
    gap = (R_CUT * R_CUT - m2) * inv_a
    half = jnp.sqrt(jnp.maximum(gap, 0.0))
    t1 = t_star + half
    t0 = jnp.maximum(t_star - half, 0.0)
    hi = jnp.minimum(t1, tmax)
    ok = (gap > 0.0) & (t1 >= 0.0) & (c[_VALID] > 0.0) & (hi > t0)
    sa = jnp.sqrt(a_s)
    inv_sa = sa * inv_a
    zoff = 0.5 * b * inv_sa
    peak = c[_DENS] * jnp.exp(-0.5 * m2)
    pref = jnp.where(ok, peak * (SQRT_HALF_PI * inv_sa), 0.0)
    return sa, zoff, peak, pref, t0, hi, ok


def _erf_at(sa, zoff, t):
    z = sa * t + zoff
    return _erf_from_exp(z * SQRT_HALF, jnp.exp(-0.5 * z * z))


def _make_kernel(cfg_t, lights_p, lights_i, env, pinhole: bool,
                 n_tiles: int, tile: int):
    (w, h, spp, n_strat, seed, solver_iters, min_scatter, rr_cap,
     rr_tail_after, rr_cap_tail, max_bounces) = cfg_t
    n_lights = len(lights_p)
    w_ne = float(n_lights + 1) if n_lights else 1.0
    max_it = spp * max_bounces + max_bounces

    def kernel(cam_ref, tab_ref, ids_ref, pix_ref, out_ref):
        pid = ids_ref[...].astype(jnp.uint32)                  # [blk]
        xpix = pix_ref[0, :]
        ypix = pix_ref[1, :]
        cam = [cam_ref[k] for k in range(13)]
        zero = jnp.zeros_like(xpix)

        def cols(k):
            sl = pl.ds(k * tile, tile)
            return [tab_ref[f, sl][:, None] for f in range(15)]

        def tile_loop(fn, init):
            return jax.lax.fori_loop(
                0, n_tiles, lambda k, acc: fn(cols(k), acc), init)

        def row(v):
            return v[None, :]

        def tau_pass(o, d, tmax, bracket):
            """Optical depth over [0, tmax]; with ``bracket`` also the
            first entry / last exit over all supports."""
            o2, d2, tm2 = [row(v) for v in o], [row(v) for v in d], \
                row(tmax)

            def fn(c, acc):
                sa, zoff, _, pref, t0, hi, ok = _pair(c, o2, d2, tm2)
                seg = pref * (_erf_at(sa, zoff, hi) - _erf_at(sa, zoff, t0))
                tau = acc[0] + jnp.sum(jnp.where(ok, seg, 0.0), axis=0)
                if not bracket:
                    return (tau,)
                return (tau,
                        jnp.minimum(acc[1], jnp.min(
                            jnp.where(ok, t0, BIG), axis=0)),
                        jnp.maximum(acc[2], jnp.max(
                            jnp.where(ok, hi, 0.0), axis=0)))

            init = (zero, zero + BIG, zero) if bracket else (zero,)
            return tile_loop(fn, init)

        def tau_sig_at(o2, d2, t):
            """tau(t) and sigma_t(t) along the extension rays."""
            t2 = row(t)

            def fn(c, acc):
                sa, zoff, peak, pref, t0, t1, ok = _pair(c, o2, d2, BIG)
                tc = jnp.minimum(t2, t1)
                z = sa * tc + zoff
                ez = jnp.exp(-0.5 * z * z)       # erf factor == extinction
                ferf = _erf_from_exp(z * SQRT_HALF, ez)
                seg = pref * (ferf - _erf_at(sa, zoff, t0))
                seg = jnp.where(ok & (t2 > t0), seg, 0.0)
                rho = jnp.where(ok & (t2 >= t0) & (t2 <= t1), peak * ez, 0.0)
                return (acc[0] + jnp.sum(seg, axis=0),
                        acc[1] + jnp.sum(rho, axis=0))

            return tile_loop(fn, (zero, zero))

        def albedo_at(o2, d2, t):
            t2 = row(t)

            def fn(c, acc):
                sa, zoff, peak, _, t0, t1, ok = _pair(c, o2, d2, BIG)
                z = sa * t2 + zoff
                rho = jnp.where(ok & (t2 >= t0) & (t2 <= t1),
                                peak * jnp.exp(-0.5 * z * z), 0.0)
                return (acc[0] + jnp.sum(rho, axis=0),
                        acc[1] + jnp.sum(rho * c[_ALB], axis=0))

            s, sa_ = tile_loop(fn, (zero, zero))
            safe = jnp.where(s > 1e-25, s, 1.0)
            return jnp.clip(jnp.where(s > 1e-25, sa_ / safe, 0.0), 0.0, 1.0)

        def make_ray(s):
            """Stratified camera ray for int32 sample indices (mirrors
            multiscatter.mc_camera_rays + cameras.sample_ray)."""
            xi = _uniforms(pid, s.astype(jnp.uint32), jnp.uint32(JITTER_TAG),
                           2, seed)
            sx = (s % n_strat).astype(jnp.float32)
            sy = ((s // n_strat) % n_strat).astype(jnp.float32)
            u01 = (xpix + (sx + xi[0]) / float(n_strat)) / float(w)
            v01 = (ypix + (sy + xi[1]) / float(n_strat)) / float(h)
            (cpx, cpy, cpz, crx, cry, crz, cux, cuy, cuz,
             cvx, cvy, cvz, focal) = cam
            if pinhole:
                u = 1.0 - u01 * 2.0                    # x-flip (camera.h:47)
                v = v01 * 2.0 - 1.0
            else:
                u = u01 * 2.0 - 1.0
                v = 1.0 - v01 * 2.0                    # y-flip (camera.h:67)
            ox = cpx + u * crx + v * cux
            oy = cpy + u * cry + v * cuy
            oz = cpz + u * crz + v * cuz
            if not pinhole:
                return (ox, oy, oz), (zero + cvx, zero + cvy, zero + cvz)
            ddx = cpx + focal * cvx - ox
            ddy = cpy + focal * cvy - oy
            ddz = cpz + focal * cvz - oz
            inv = 1.0 / jnp.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
            return (ox, oy, oz), (ddx * inv, ddy * inv, ddz * inv)

        def sel(m, a, b):
            return tuple(jnp.where(m, x, y) for x, y in zip(a, b))

        def cond(st):
            alive, sample, it = st[4], st[5], st[7]
            live = (alive > 0) | (sample < spp)
            return (jnp.max(live.astype(jnp.int32)) > 0) & (it < max_it)

        def body(st):
            o, d, thr, acc, alive_i, sample, bounce, it = st
            alive = alive_i > 0

            # --- regenerate dead lanes that still have samples ---
            regen = ~alive & (sample < spp)
            o_n, d_n = make_ray(jnp.where(regen, sample, 0))
            o = sel(regen, o_n, o)
            d = sel(regen, d_n, d)
            thr = sel(regen, (zero + 1.0,) * 3, thr)
            bounce = jnp.where(regen, 0, bounce)
            sample = jnp.where(regen, sample + 1, sample)
            alive = alive | regen

            xi = _uniforms(pid, (jnp.maximum(sample, 1) - 1).astype(
                jnp.uint32), bounce.astype(jnp.uint32), 9, seed)

            # --- free flight: bracketed Newton + Illinois ---
            o2, d2 = [row(v) for v in o], [row(v) for v in d]
            tau_tot, t_lo, t_hi = tau_pass(o, d, zero + BIG, True)
            t_lo = jnp.minimum(t_lo, t_hi)
            target = -jnp.log(jnp.maximum(1.0 - xi[0], 1e-12))
            scattered = tau_tot > target
            tgt = jnp.minimum(target, tau_tot * 0.999999)

            def newton(_, ns):
                lo, hi, flo, fhi, t = ns
                tau, sig = tau_sig_at(o2, d2, t)
                return illinois_update(lo, hi, flo, fhi, t, tau - tgt, sig)

            *_, t_sc = jax.lax.fori_loop(
                0, solver_iters, newton,
                (t_lo, t_hi, -tgt, jnp.maximum(tau_tot - tgt, 1e-12),
                 0.5 * (t_lo + t_hi)))
            t_sc = jnp.clip(t_sc, t_lo, t_hi)
            albedo = albedo_at(o2, d2, t_sc)

            # --- escape ---
            escaped = alive & ~scattered
            acc = tuple(a + jnp.where(escaped, tc * e, 0.0)
                        for a, tc, e in zip(acc, thr, env))
            alive_n = alive & scattered

            # --- NEE: env or one light (integrator.h:657-683) ---
            pos = tuple(oc + t_sc * dc for oc, dc in zip(o, d))
            theta = (2.0 * math.pi) * xi[3]
            cphi = 1.0 - 2.0 * xi[4]
            sphi = jnp.sqrt(jnp.maximum(1.0 - cphi * cphi, 0.0))
            w_env = (sphi * jnp.cos(theta), sphi * jnp.sin(theta), cphi)
            env_li = tuple(zero + e * FOUR_PI for e in env)
            if n_lights == 0:
                wi, tmax, li_base = w_env, zero + 1e8, env_li
            else:
                is_env = xi[1] < 1.0 / (n_lights + 1)
                lidx = jnp.clip((xi[2] * n_lights).astype(jnp.int32),
                                0, n_lights - 1)
                lp = (zero,) * 3
                lr = (zero,) * 3
                for l in range(n_lights):
                    m = lidx == l
                    lp = tuple(jnp.where(m, lights_p[l][k], lp[k])
                               for k in range(3))
                    lr = tuple(jnp.where(m, lights_i[l][k], lr[k])
                               for k in range(3))
                to = tuple(a - b for a, b in zip(lp, pos))
                dist = jnp.sqrt(jnp.maximum(
                    to[0] * to[0] + to[1] * to[1] + to[2] * to[2], 1e-24))
                inv_d = 1.0 / dist
                wi = sel(is_env, w_env, tuple(v * inv_d for v in to))
                tmax = jnp.where(is_env, 1e8, dist)
                li_base = sel(is_env, env_li,
                              tuple(v * (inv_d * inv_d) for v in lr))
            (tau_nee,) = tau_pass(pos, wi, tmax, False)
            tr = jnp.exp(-tau_nee)
            wgt = albedo * (INV_4PI * w_ne) * tr
            acc = tuple(a + jnp.where(alive_n, tc * wgt * lb, 0.0)
                        for a, tc, lb in zip(acc, thr, li_base))

            # --- throughput + Russian roulette (integrator.h:688-695) ---
            thr_n = tuple(tc * albedo for tc in thr)
            do_rr = bounce >= min_scatter
            cap = jnp.where(bounce >= rr_tail_after, rr_cap_tail, rr_cap)
            rr = jnp.minimum(jnp.maximum(jnp.maximum(thr_n[0], thr_n[1]),
                                         thr_n[2]), cap)
            killed = do_rr & (xi[5] > rr)
            inv_rr = 1.0 / jnp.maximum(rr, 1e-12)
            thr_n = sel(do_rr & ~killed, tuple(tc * inv_rr for tc in thr_n),
                        thr_n)
            alive_n = alive_n & ~killed & (bounce + 1 < max_bounces)

            # --- isotropic phase (integrator.h:698-699) ---
            theta = (2.0 * math.pi) * xi[6]
            cphi = 1.0 - 2.0 * xi[7]
            sphi = jnp.sqrt(jnp.maximum(1.0 - cphi * cphi, 0.0))
            new_d = (sphi * jnp.cos(theta), sphi * jnp.sin(theta), cphi)
            o = sel(alive_n, pos, o)
            d = sel(alive_n, new_d, d)
            thr = sel(alive_n, thr_n, thr)
            return (o, d, thr, acc, alive_n.astype(jnp.int32), sample,
                    bounce + 1, it + 1)

        izero = jnp.zeros_like(ids_ref[...])
        st = ((zero,) * 3, (zero,) * 2 + (zero + 1.0,), (zero + 1.0,) * 3,
              (zero,) * 3, izero, izero, izero, jnp.int32(0))
        _, _, _, acc, _, _, _, it = jax.lax.while_loop(cond, body, st)
        for k in range(3):
            out_ref[k, :] = acc[k]
        out_ref[3, :] = zero + it.astype(jnp.float32)    # loop trips

    return kernel


@functools.partial(jax.jit, static_argnames=(
    "cfg_t", "lights_p", "lights_i", "env_color", "pinhole", "interpret",
    "block", "tile", "num_warps"))
def mega_call(cam_vec, table, ids, cfg_t, lights_p, lights_i, env_color,
              pinhole: bool, interpret: bool = False, block: int = BLOCK,
              tile: int = TILE, num_warps: int = NUM_WARPS):
    """Radiance sums for pixel ids [B] (B a multiple of ``block``).

    table: [16, Np] from ``pack_table(gmm, tile)``; cfg_t: (w, h, spp,
    n_strat, seed, solver_iters, min_scatter, rr_cap, rr_tail_after,
    rr_cap_tail, max_bounces).  Returns [4, B]: rows 0-2 the radiance
    summed over spp, row 3 the block's loop trip count."""
    b = ids.shape[0]
    if b % block or block & (block - 1) or tile & (tile - 1):
        raise ValueError(f"mega_call: B={b} must be a multiple of block="
                         f"{block}; block and tile={tile} powers of two")
    if table.shape[0] != N_FEAT or table.shape[1] % tile:
        raise ValueError(f"mega_call: table {table.shape} is not a "
                         f"pack_table(gmm, tile={tile}) layout")
    w = cfg_t[0]
    pix = jnp.stack([(ids % w).astype(jnp.float32),
                     (ids // w).astype(jnp.float32)])
    kernel = _make_kernel(cfg_t, lights_p, lights_i, env_color, pinhole,
                          table.shape[1] // tile, tile)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((4, b), jnp.float32),
        grid=(b // block,),
        in_specs=[
            pl.BlockSpec((N_FEAT,), lambda i: (0,)),
            pl.BlockSpec(table.shape, lambda i: (0, 0)),
            pl.BlockSpec((block,), lambda i: (i,)),
            pl.BlockSpec((2, block), lambda i: (0, i)),
        ],
        out_specs=pl.BlockSpec((4, block), lambda i: (0, i)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=1),
        interpret=interpret,
        name="megatrace",
    )(cam_vec, table, ids, pix)
