"""Per-(ray, Gaussian) quadratic coefficients as matmuls.

The reference computes, per ray per Gaussian, the quadratic
``A t^2 + B t + C`` of the Mahalanobis distance along the ray with Eigen
mat-vecs (``gaussian.h:126-164, 208-231``):

    A = d^T S^-1 d
    B = 2 (o - m)^T S^-1 d
    C = (o - m)^T S^-1 (o - m)

Batched formulation: every bilinear form u^T S^-1 v against a *symmetric*
S^-1 is a dot product between a 6-feature vector of u,v products and the
packed 6 unique entries of S^-1.  So for a batch of R rays against N
Gaussians, (A, B, C) are three [R,6]x[6,N] / [R,3]x[3,N] matmuls — no
per-ray loops, no gathers:

    A       = sym6(d,d) . icpack
    B       = 2 * (sym6(o,d) . icpack - d . q)        q  = S^-1 m
    C       = sym6(o,o) . icpack - 2 * o . q + c0     c0 = m^T S^-1 m

Intersection with the R_CUT-sigma ellipsoid solves
``A t^2 + B t + (C - R_CUT^2) = 0`` exactly as ``intersect_direct``
(gaussian.h:126-164); the whitening variant (gaussian.h:167-205) yields the
same interval and is intentionally not replicated.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gvr.scene.gaussians import GaussianMixture, R_CUT

# The quadratic coefficients span ~1e6 dynamic range (squared Mahalanobis
# distances of far origins against tiny Gaussians); reduced-precision
# matmul passes (bf16, or TF32 on a GPU) destroy them (spurious hits, +inf
# peaks).  Full fp32 passes are mandatory here.
_PREC = jax.lax.Precision.HIGHEST


def _mm(feats, table):
    """[..., F] x [N, F] -> [..., N] at full fp32 precision."""
    return jnp.einsum("...f,nf->...n", feats, table, precision=_PREC)


def sym6(u, v):
    """Symmetric bilinear features [...,6] such that
    u^T S v = sym6(u,v) . (S00,S11,S22,S01,S02,S12) for symmetric S."""
    return jnp.stack([
        u[..., 0] * v[..., 0],
        u[..., 1] * v[..., 1],
        u[..., 2] * v[..., 2],
        u[..., 0] * v[..., 1] + u[..., 1] * v[..., 0],
        u[..., 0] * v[..., 2] + u[..., 2] * v[..., 0],
        u[..., 1] * v[..., 2] + u[..., 2] * v[..., 1],
    ], axis=-1)


def ray_quadratics_ab(gmm: GaussianMixture, origin, direction):
    """(A, B) for rays [...,3] against all N Gaussians -> each [...,N].

    The hot paths never need C: the interval and exponent come from the
    cancellation-free closest-approach form (transmittance.py), which only
    uses A and B — skipping C saves a third of the coefficient matmuls."""
    ic = gmm.icpack()                       # [N,6]
    q = gmm.qvec()                          # [N,3]

    dd = sym6(direction, direction)         # [...,6]
    od = sym6(origin, direction)

    a = _mm(dd, ic)
    d_q = _mm(direction, q)
    b = 2.0 * (_mm(od, ic) - d_q)
    return a, b


def ray_quadratics(gmm: GaussianMixture, origin, direction):
    """(A, B, C) for rays [...,3] against all N Gaussians -> each [...,N].

    C here is the *full* Mahalanobis constant (no -R_CUT^2), as used by the
    direct transcription of the optical-depth closed form
    (gaussian.h:208-231)."""
    a, b = ray_quadratics_ab(gmm, origin, direction)
    oo = sym6(origin, origin)
    o_q = _mm(origin, gmm.qvec())
    c = _mm(oo, gmm.icpack()) - 2.0 * o_q + gmm.c0()
    return a, b, c


def intersect_from_quadratics(a, b, c):
    """Solve the R_CUT-sigma ellipsoid quadratic given (A, B, C-full).

    Returns (t0, t1, hit) with t0 <= t1 and hit iff the ray crosses the
    ellipsoid with t1 >= 0 (gaussian.h:141-163).  t0 is NOT clamped to 0;
    clip at the point of use (the reference clamps on return)."""
    cc = c - R_CUT * R_CUT
    disc = b * b - 4.0 * a * cc
    hit = (disc >= 0.0) & (a > 0.0)
    # where-guarded sqrt: d/dx sqrt(x) at the clamp would be inf, and
    # masked-out lanes would still poison reverse-mode with 0 * inf = NaN
    sq = jnp.sqrt(jnp.where(disc > 0.0, disc, 1.0))
    sq = jnp.where(disc > 0.0, sq, 0.0)
    inv2a = 0.5 / jnp.maximum(a, 1e-30)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    hit = hit & (t1 >= 0.0)
    return t0, t1, hit


def intersect_gaussians(gmm: GaussianMixture, origin, direction):
    """Intervals of every Gaussian along rays: (t0, t1, hit) each [...,N]."""
    a, b, c = ray_quadratics(gmm, origin, direction)
    return intersect_from_quadratics(a, b, c)


def intersect_gaussians_whitening(gmm: GaussianMixture, origin, direction):
    """Whitening-transform intersection variant (gaussian.h:167-205):
    transform the ray by W = diag(1/sqrt(eigval)) R^T / R_CUT, intersect the
    unit sphere.  Produces the same intervals as the direct quadratic (the
    reference keeps both; the direct form is faster — PDF slide 44) and is
    kept for cross-validation."""
    ev = jnp.maximum(gmm.eigvals, 1e-12)                    # [N,3]
    w = (1.0 / jnp.sqrt(ev))[:, :, None] * jnp.swapaxes(gmm.eigvecs, 1, 2) \
        / R_CUT                                             # [N,3,3]
    o_local = origin[..., None, :] - gmm.mean               # [...,N,3]
    hp = jax.lax.Precision.HIGHEST         # no TF32 in ray geometry
    ow = jnp.einsum("nij,...nj->...ni", w, o_local, precision=hp)
    dw = jnp.einsum("nij,...j->...ni", w, direction, precision=hp)
    a = jnp.einsum("...ni,...ni->...n", dw, dw, precision=hp)
    b = 2.0 * jnp.einsum("...ni,...ni->...n", ow, dw, precision=hp)
    c = jnp.einsum("...ni,...ni->...n", ow, ow, precision=hp) - 1.0
    disc = b * b - 4.0 * a * c
    hit = disc >= 0.0
    sq = jnp.sqrt(jnp.where(disc > 0.0, disc, 0.0))
    inv2a = 0.5 / jnp.maximum(a, 1e-30)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    hit = hit & (t1 >= 0.0)
    return t0, t1, hit
