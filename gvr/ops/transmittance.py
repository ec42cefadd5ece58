"""Closed-form Gaussian optical depth and transmittance.

Reference math (``gaussian.h:208-231``): along a ray, the optical depth of a
single Gaussian over [u, v] is

    tau(u, v) = pref * exp(-0.5 (C - B^2/(4A))) * (erf(F(v)) - erf(F(u)))
    pref      = density * norm * sqrt(pi / (2A))
    F(t)      = (B + 2 A t) / (2 sqrt(2 A))

Replacement for the reference's event-list walks: total optical
depth of the whole mixture up to distance t is the *clipped-interval
map-reduce*

    tau_total(t) = sum_g  tau_g( max(t0_g, 0), min(t1_g, t) )   over hits

which is exactly what the sorted-event traversals compute
(``gmm.h:207-226, 517-578`` and ``integrator.h:422-498``) — monotone in t,
no sort required.  Everything here is dense [R, N] elementwise work, fed by
the matmuls in ``quadratics.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gvr.scene.gaussians import GaussianMixture, R_CUT
from gvr.ops.quadratics import (ray_quadratics, ray_quadratics_ab,
                                    intersect_from_quadratics)

# Tensor-parallel Gaussian-axis reductions (see ops/gaxis.py); re-exported
# here because this module is where the reduction sites live.
from gvr.ops.gaxis import gaussian_axis, gsum, gmax, gmin, gany  # noqa: F401,E402


class RayGaussians(NamedTuple):
    """Per-(ray, gaussian) precomputed quantities, shapes [..., N].

    peak = density*norm*exp(-0.5(C - B^2/4A)): the extinction at the ray's
    closest approach; pref = peak * sqrt(pi/(2A)); ferf_scale = 1/(2 sqrt(2A));
    interval [t0, t1] (t0 clamped to 0), hit mask.

    erf_lo/erf_hi are erf(F(.)) at the clipped interval ends and
    tau_i = pref*(erf_hi - erf_lo) the gaussian's full optical depth —
    precomputed once so each solver iteration needs a single erf and the
    escape test (tau_total) needs none.
    """

    a: jnp.ndarray
    b: jnp.ndarray
    peak: jnp.ndarray
    pref: jnp.ndarray
    fscale: jnp.ndarray
    t0: jnp.ndarray
    t1: jnp.ndarray
    hit: jnp.ndarray
    erf_lo: jnp.ndarray
    erf_hi: jnp.ndarray
    tau_i: jnp.ndarray


def min_mahalanobis_sq(gmm: GaussianMixture, origin, direction, a, b):
    """Squared Mahalanobis distance at the ray's closest approach,
    evaluated *directly* at x* = o + t* d with t* = -b/(2a).

    The reference computes this as C - B^2/(4A) (gaussian.h:230) — a
    difference of ~1e6-magnitude terms whose fp32 cancellation costs up to
    ~0.1 absolute (10% in exp).  The direct positive quadratic form has no
    cancellation, improving on the reference's own conditioning."""
    from gvr.ops.quadratics import sym6, _mm
    t_star = -b / (2.0 * jnp.maximum(a, 1e-30))          # [...,N]
    v = (origin[..., None, :] - gmm.mean
         + t_star[..., None] * direction[..., None, :])  # [...,N,3]
    ic = gmm.icpack()                                    # [N,6]
    feats = sym6(v, v)                                   # [...,N,6]
    return jnp.maximum(jnp.sum(feats * ic, axis=-1), 0.0), t_star


def _interval_pref(gmm: GaussianMixture, origin, direction):
    """Clipped support interval + erf prefactors per (ray, gaussian) pair
    — the single derivation behind tau_coeffs and the lean NEE path
    (transmittance_up_to below).  Cancellation-free closest-approach form:
    t0/t1 = t* -/+ sqrt((R^2 - m2)/a), exponent -m2/2."""
    a, b = ray_quadratics_ab(gmm, origin, direction)
    a_safe = jnp.maximum(a, 1e-30)
    m2, t_star = min_mahalanobis_sq(gmm, origin, direction, a, b)
    gap = (R_CUT * R_CUT - m2) / a_safe
    half = jnp.sqrt(jnp.where(gap > 0.0, gap, 0.0))
    t1 = t_star + half
    t0 = jnp.maximum(t_star - half, 0.0)
    hit = (gap > 0.0) & (t1 >= 0.0)
    peak = gmm.density * gmm.norm * jnp.exp(-0.5 * m2)
    pref = peak * jnp.sqrt(jnp.pi / (2.0 * a_safe))
    fscale = 1.0 / (2.0 * jnp.sqrt(2.0 * a_safe))
    return a, b, t0, t1, hit, peak, pref, fscale


def tau_coeffs(gmm: GaussianMixture, origin, direction) -> RayGaussians:
    """Precompute everything needed for tau/transmittance along rays."""
    a, b, t0, t1, hit, peak, pref, fscale = _interval_pref(
        gmm, origin, direction)
    erf_lo = jax.lax.erf((b + 2.0 * a * t0) * fscale)
    erf_hi = jax.lax.erf((b + 2.0 * a * t1) * fscale)
    tau_i = jnp.where(hit, pref * (erf_hi - erf_lo), 0.0)
    return RayGaussians(a, b, peak, pref, fscale, t0, t1, hit,
                        erf_lo, erf_hi, tau_i)


def _ferf(rg: RayGaussians, t):
    """erf(F(t)) with F(t) = (B + 2At) * fscale."""
    return jax.lax.erf((rg.b + 2.0 * rg.a * t) * rg.fscale)


def tau_interval(rg: RayGaussians, u, v):
    """Per-gaussian optical depth over raw interval [u, v] (no clipping),
    the direct transcription of ``Gaussian::optical_depth``."""
    return rg.pref * (_ferf(rg, v) - _ferf(rg, u))


def tau_up_to(rg: RayGaussians, t):
    """Total mixture optical depth from 0 to t (t may be [...] or scalar):
    sum over hit Gaussians of tau over [t0, min(t1, t)].  Uses the
    precomputed interval-end erfs: one erf per (ray, gaussian)."""
    t = jnp.asarray(t)
    tt = t[..., None] if t.ndim < rg.t1.ndim else t
    seg = jnp.where(tt >= rg.t1, rg.tau_i,
                    rg.pref * (_ferf(rg, tt) - rg.erf_lo))
    return gsum(jnp.where(rg.hit & (tt > rg.t0), seg, 0.0))


def tau_total(rg: RayGaussians):
    """Optical depth through the whole medium: erf-free reduction of the
    precomputed per-gaussian totals."""
    return gsum(jnp.where(rg.hit, rg.tau_i, 0.0))


def sigma_t_at(rg: RayGaussians, t):
    """d tau_total / dt at t: sum of extinctions of Gaussians whose interval
    contains t, in the stable completed-square form
    peak * exp(-(sqrt(A) t + B/(2 sqrt(A)))^2 / 2)."""
    rho, inside = extinction_at(rg, t)
    return gsum(jnp.where(inside, rho, 0.0))


def transmittance_up_to(gmm: GaussianMixture, origin, direction, tmax):
    """T(tmax) = exp(-tau_total(tmax)) for rays [...,3].

    Replaces ``transmittance_up_to_naive/BVH`` (gmm.h:207-226, 517-578).
    One-shot lean path (two erfs per pair) for NEE shadow/env rays."""
    a, b, lo, t1, hit, _, pref, fscale = _interval_pref(
        gmm, origin, direction)
    tmax = jnp.asarray(tmax, jnp.float32)
    tt = tmax[..., None] if tmax.ndim < t1.ndim else tmax
    hi = jnp.minimum(t1, tt)
    f = lambda t: jax.lax.erf((b + 2.0 * a * t) * fscale)
    seg = pref * (f(hi) - f(lo))
    tau = gsum(jnp.where(hit & (hi > lo), seg, 0.0))
    return jnp.exp(-tau)


def transmittance_over_segment(rg: RayGaussians, u, v, active_mask):
    """T over [u,v] restricted to an explicit active mask [...,N]
    (gmm.h:145-157) — used by the analytic ray marcher."""
    seg = tau_interval(rg, u[..., None], v[..., None])
    tau = gsum(jnp.where(active_mask, seg, 0.0))
    return jnp.exp(-tau)


def compact_candidates(rg: RayGaussians, albedo, k: int):
    """Gather the k nearest-entering hit Gaussians per ray.

    This is the batched replacement for BVH candidate pruning
    (gmm.h:457-515): the fixed-iteration free-flight solver then runs on
    [rays, k] instead of [rays, N].  Exact whenever every ray hits <= k
    Gaussians (overflow flag reports violations); candidates are ranked by
    entry distance so dropped ones are the farthest along the ray.

    Returns (rg_k, albedo_k [.,k], overflow [.]).
    """
    from gvr.ops import gaxis
    assert gaxis.active() is None, (
        "candidate compaction (top_k over the Gaussian axis) is not "
        "tensor-parallel; render with candidate_k=0 under gaussian_axis "
        "(parallel/gauss_sharded.py forces this)")
    key = jnp.where(rg.hit, -rg.t0, -jnp.inf)
    _, idx = jax.lax.top_k(key, k)                  # k smallest t0 among hits
    take = lambda x: jnp.take_along_axis(x, idx, axis=-1)
    rg_k = RayGaussians(*(take(f) for f in rg))
    albedo_k = jnp.take(albedo, idx, axis=0)
    overflow = jnp.sum(rg.hit.astype(jnp.int32), axis=-1) > k
    return rg_k, albedo_k, overflow


def extinction_at(rg: RayGaussians, t):
    """Per-gaussian extinction along the ray at parameter t:
    rho_i(t) = peak_i * exp(-(sqrt(a) t + b/(2 sqrt(a)))^2 / 2), plus the
    inside-interval mask.  Shared by sigma_t_at and the candidate albedo."""
    t = jnp.asarray(t)
    tt = t[..., None] if t.ndim < rg.t1.ndim else t
    sa = jnp.sqrt(jnp.maximum(rg.a, 1e-30))
    z = sa * tt + rg.b / (2.0 * sa)
    rho = rg.peak * jnp.exp(-0.5 * z * z)
    inside = rg.hit & (tt >= rg.t0) & (tt <= rg.t1)
    return rho, inside


def albedo_at_from_rg(rg: RayGaussians, albedo, t):
    """Mixture albedo at the scatter point from (compacted) ray-gaussian
    state — avoids re-evaluating the full mixture (gmm.h:128-143
    semantics)."""
    rho, inside = extinction_at(rg, t)
    w = jnp.where(inside, rho, 0.0)
    s = gsum(w)
    sa = gsum(w * albedo)
    s_safe = jnp.where(s > 1e-25, s, 1.0)
    return jnp.clip(jnp.where(s > 1e-25, sa / s_safe, 0.0), 0.0, 1.0)


def far_bound(rg: RayGaussians):
    """Farthest exit distance over hit Gaussians (0 if none): the upper end
    of the medium along this ray, i.e. the reference's ``events.back().t``."""
    return gmax(jnp.where(rg.hit, rg.t1, 0.0))


def any_hit(rg: RayGaussians):
    return gany(rg.hit)
