"""Gaussian mixture medium as structure-of-arrays JAX pytree.

Reference: the ``Gaussian`` primitive (``include/gaussian.h:28-320``) and
``GaussianMixtureModel`` (``include/gmm.h:35-629``).  The reference stores an
``std::vector<Gaussian>`` of Eigen objects with per-object precomputation
(inverse covariance, normalization, eigendecomposition, whitening transform);
here everything is a batched tensor, precomputed once with
``jnp.linalg.eigh`` and laid out for matmul-friendly per-(ray, gaussian)
quadratic evaluation (see ``gvr/ops/quadratics.py``).

Anisotropic 3D Gaussian density:  g(x) = norm * exp(-0.5 (x-mu)^T S^-1 (x-mu))
with norm = (2*pi)^{-3/2} det(S)^{-1/2}; extinction mu_t(x) = density * g(x).
Support is truncated at R_CUT = 3 standard deviations (``gaussian.h:36``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Support truncation radius in units of standard deviation (gaussian.h:36).
R_CUT = 3.0

# Number of optimizable parameters per Gaussian in the codec (gmm.h:583-628):
# mean(3) + Rodrigues axis-angle(3) + log-scale-diag(3) + log-density(1)
# + logit-albedo(1).
PARAMS_PER_GAUSSIAN = 11


@jax.tree_util.register_pytree_node_class
class GaussianMixture:
    """SoA Gaussian mixture.  All arrays share leading dim N.

    Stored fields (the pytree leaves):
      mean      [N,3]   centers
      cov       [N,3,3] covariance (symmetric)
      density   [N]     extinction scale
      albedo    [N]     single-scattering albedo
      emission  [N,3]   parsed + stored but never shaded, matching the
                        reference (no integrator reads emission; see
                        SURVEY dead-items: gaussian.h:34, scene.h:97-105)
      inv_cov   [N,3,3] precomputed inverse covariance
      norm      [N]     (2 pi)^{-3/2} det^{-1/2}
      eigvals   [N,3]   ascending eigenvalues of cov
      eigvecs   [N,3,3] columns are eigenvectors (rotation R with det +1)

    Derived on demand (recomputed per call; XLA hoists them out of
    jitted loops — not pytree leaves):
      icpack    [N,6]   (ic00, ic11, ic22, ic01, ic02, ic12)
      q         [N,3]   inv_cov @ mean
      c0        [N]     mean^T inv_cov mean
      aabb_min/max [N,3] world AABBs at R_CUT sigma (gaussian.h:302-319)
    """

    def __init__(self, mean, cov, density, albedo, emission,
                 inv_cov, norm, eigvals, eigvecs):
        self.mean = mean
        self.cov = cov
        self.density = density
        self.albedo = albedo
        self.emission = emission
        self.inv_cov = inv_cov
        self.norm = norm
        self.eigvals = eigvals
        self.eigvecs = eigvecs

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        leaves = (self.mean, self.cov, self.density, self.albedo,
                  self.emission, self.inv_cov, self.norm, self.eigvals,
                  self.eigvecs)
        return leaves, None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)

    # -- constructors ---------------------------------------------------------
    @staticmethod
    def from_covariances(mean, cov, density, albedo, emission=None):
        """Build from means [N,3] + full covariances [N,3,3].

        Mirrors ``Gaussian::precompute_from_covariance`` (gaussian.h:52-72)
        but batched: one ``eigh`` over the whole set.
        """
        mean = jnp.asarray(mean, jnp.float32).reshape(-1, 3)
        cov = jnp.asarray(cov, jnp.float32).reshape(-1, 3, 3)
        n = mean.shape[0]
        density = jnp.asarray(density, jnp.float32).reshape(n)
        albedo = jnp.asarray(albedo, jnp.float32).reshape(n)
        if emission is None:
            emission = jnp.zeros((n, 3), jnp.float32)
        emission = jnp.asarray(emission, jnp.float32).reshape(n, 3)

        eigvals, eigvecs = jnp.linalg.eigh(cov)
        # Make eigvecs a proper rotation (det +1) so the rotation->axis-angle
        # codec is well defined; covariance R S^2 R^T is invariant to the flip.
        det = jnp.linalg.det(eigvecs)
        flip = jnp.where(det < 0.0, -1.0, 1.0)[:, None]
        eigvecs = eigvecs.at[:, :, 0].multiply(flip)

        ev = jnp.maximum(eigvals, 1e-12)
        # inv_cov = R diag(1/ev) R^T  (more robust than jnp.linalg.inv and
        # exactly consistent with the eigendecomposition)
        inv_cov = jnp.einsum("nij,nj,nkj->nik", eigvecs, 1.0 / ev,
                             eigvecs, precision=jax.lax.Precision.HIGHEST)
        det_cov = jnp.prod(ev, axis=-1)
        norm = (2.0 * jnp.pi) ** (-1.5) * det_cov ** (-0.5)
        return GaussianMixture(mean, cov, density, albedo, emission,
                               inv_cov, norm, eigvals, eigvecs)

    @staticmethod
    def from_rotation_scale(mean, rotation, scale_diag, density, albedo,
                            emission=None):
        """Build from rotation matrices [N,3,3] + scale diagonals [N,3].

        Mirrors the R*S*S^T*R^T constructor (gaussian.h:95-109), but computes
        inverse/determinant/eigendecomposition analytically — no ``eigh`` —
        keeping this path cheap and differentiable for the inverse optimizer.
        """
        mean = jnp.asarray(mean, jnp.float32).reshape(-1, 3)
        rotation = jnp.asarray(rotation, jnp.float32).reshape(-1, 3, 3)
        scale_diag = jnp.asarray(scale_diag, jnp.float32).reshape(-1, 3)
        n = mean.shape[0]
        density = jnp.asarray(density, jnp.float32).reshape(n)
        albedo = jnp.asarray(albedo, jnp.float32).reshape(n)
        if emission is None:
            emission = jnp.zeros((n, 3), jnp.float32)
        emission = jnp.asarray(emission, jnp.float32).reshape(n, 3)

        s2 = jnp.maximum(scale_diag * scale_diag, 1e-24)
        cov = jnp.einsum("nij,nj,nkj->nik", rotation, s2, rotation, precision=jax.lax.Precision.HIGHEST)
        inv_cov = jnp.einsum("nij,nj,nkj->nik", rotation, 1.0 / s2,
                             rotation, precision=jax.lax.Precision.HIGHEST)
        # log-space determinant: prod(s2) underflows fp32 (flushed
        # subnormals) for collapsing fit scales ~1e-9/axis, which made
        # norm = 0**-0.5 = inf and NaN'd gradients; exp(-0.5 sum log) is
        # exact, differentiable, and cannot underflow before norm itself
        norm = ((2.0 * jnp.pi) ** (-1.5)
                * jnp.exp(-0.5 * jnp.sum(jnp.log(s2), axis=-1)))
        return GaussianMixture(mean, cov, density, albedo, emission,
                               inv_cov, norm, s2, rotation)

    # -- basic info -----------------------------------------------------------
    @property
    def n(self) -> int:
        return self.mean.shape[0]

    # -- packed features for the quadratics (ops/quadratics.py) ---------------
    def icpack(self):
        """[N,6] packed symmetric inverse covariance:
        (ic00, ic11, ic22, ic01, ic02, ic12)."""
        ic = self.inv_cov
        return jnp.stack(
            [ic[:, 0, 0], ic[:, 1, 1], ic[:, 2, 2],
             ic[:, 0, 1], ic[:, 0, 2], ic[:, 1, 2]], axis=-1)

    def qvec(self):
        """[N,3] inv_cov @ mean."""
        return jnp.einsum("nij,nj->ni", self.inv_cov, self.mean, precision=jax.lax.Precision.HIGHEST)

    def c0(self):
        """[N] mean^T inv_cov mean."""
        return jnp.einsum("ni,ni->n", self.qvec(), self.mean, precision=jax.lax.Precision.HIGHEST)

    # -- pointwise evaluation --------------------------------------------------
    def evaluate(self, x):
        """Densities of every Gaussian at points x [...,3] -> [...,N].

        Reference ``Gaussian::evaluate`` (gaussian.h:111-115)."""
        d = x[..., None, :] - self.mean          # [...,N,3]
        expo = -0.5 * jnp.einsum("...ni,nij,...nj->...n", d, self.inv_cov, d,
                                 precision=jax.lax.Precision.HIGHEST)
        return self.norm * jnp.exp(expo)

    def mu_t(self, x):
        """Extinction of every Gaussian at x: density * evaluate
        (gaussian.h:117)."""
        return self.density * self.evaluate(x)

    def sigma_albedo(self, x, active_mask):
        """Mixture (sigma_a, sigma_s) at x for a boolean active mask [...,N].

        Reference ``GaussianMixtureModel::evaluate_sigma`` (gmm.h:98-126):
        density-weighted albedo blend a = sum(mu_t*a)/sum(mu_t),
        sigma_s = a*sum(mu_t), sigma_a = (1-a)*sum(mu_t).
        """
        from gvr.ops.gaxis import gsum
        mt = self.mu_t(x) * active_mask
        s = gsum(mt)
        sa = gsum(mt * self.albedo)
        # grad-safe division: zero lanes must not produce 1e30-scale grads
        s_safe = jnp.where(s > 1e-25, s, 1.0)
        amix = jnp.where(s > 1e-25, sa / s_safe, 0.0)
        sigma_s = amix * s
        sigma_a = (1.0 - amix) * s
        return sigma_a, sigma_s

    def albedo_at(self, x, active_mask):
        """Mixture single-scattering albedo at x (gmm.h:128-143),
        clamped to [0,1]."""
        from gvr.ops.gaxis import gsum
        mt = self.mu_t(x) * active_mask
        s = gsum(mt)
        sa = gsum(mt * self.albedo)
        s_safe = jnp.where(s > 1e-25, s, 1.0)
        return jnp.clip(jnp.where(s > 1e-25, sa / s_safe, 0.0), 0.0, 1.0)

    # -- spatial ordering -------------------------------------------------------
    def morton_sorted(self) -> "GaussianMixture":
        """Reorder Gaussians along a Morton (Z-order) curve of their means.

        The mixture is order-invariant; spatial locality keeps nearby
        Gaussians adjacent in the table.  This is the analog of the
        reference's BVH build (gmm.h:231-260): a one-time spatial sort
        instead of a pointer hierarchy."""
        order = morton_order(np.asarray(self.mean))
        take = lambda x: jnp.asarray(np.asarray(x)[order])
        return GaussianMixture(*(take(f) for f in self.tree_flatten()[0]))

    # -- AABBs (gaussian.h:302-319) --------------------------------------------
    def aabbs(self):
        """World AABBs at R_CUT sigma.  Returns (bmin [N,3], bmax [N,3])."""
        extents = R_CUT * jnp.sqrt(jnp.maximum(self.eigvals, 0.0))  # [N,3]
        h = jnp.einsum("nij,nj->ni", jnp.abs(self.eigvecs), extents, precision=jax.lax.Precision.HIGHEST)
        return self.mean - h, self.mean + h

    # -- parameter codec (gmm.h:583-706) ----------------------------------------
    def pack_parameters(self):
        """Flat [N*11] parameter vector, the reference's reparameterization
        (gmm.h:583-628): unconstrained Adam keeps scale/density positive via
        log and albedo in [0,1] via logit."""
        rod = rotation_to_rodrigues(self.eigvecs)                      # [N,3]
        sdiag = jnp.sqrt(jnp.maximum(self.eigvals, 1e-24))
        log_s = jnp.log(jnp.maximum(sdiag, 1e-12))
        log_d = jnp.log(jnp.maximum(self.density, 1e-12))[:, None]
        alb = jnp.clip(self.albedo, 0.0, 1.0)
        logit_a = inv_sigmoid(alb)[:, None]
        packed = jnp.concatenate([self.mean, rod, log_s, log_d, logit_a],
                                 axis=-1)                              # [N,11]
        return packed.reshape(-1)

    @staticmethod
    def from_parameters(params, emission=None):
        """Inverse of ``pack_parameters`` (gmm.h:634-674), fully
        differentiable (no eigh — covariance rebuilt from R, S)."""
        p = params.reshape(-1, PARAMS_PER_GAUSSIAN)
        mean = p[:, 0:3]
        rot = rodrigues_to_rotation(p[:, 3:6])
        sdiag = jnp.exp(p[:, 6:9])
        density = jnp.exp(p[:, 9])
        albedo = jax.nn.sigmoid(p[:, 10])
        return GaussianMixture.from_rotation_scale(
            mean, rot, sdiag, density, albedo, emission)


# -----------------------------------------------------------------------------
# Rotation <-> Rodrigues axis-angle helpers (gmm.h:597-607, 644-651)
# -----------------------------------------------------------------------------

def rotation_to_rodrigues(r):
    """Batched rotation matrix [N,3,3] -> axis*angle vector [N,3].

    Goes through a quaternion (Shepperd's method: pick the largest of the
    four squared components, so every branch divides by a quantity >= 1/2)
    — uniformly well-conditioned over the whole rotation group, unlike the
    classic axis = w/(2 sin theta) form which loses ~3 digits just below
    the near-pi switchover (the round-3 red test).  Safe at angle -> 0
    (factor Taylor branch) and exactly at pi (q_w = 0, atan2 fine).
    Non-finite inputs map to zero, matching the reference guard
    (gmm.h:602-604)."""
    r00, r11, r22 = r[:, 0, 0], r[:, 1, 1], r[:, 2, 2]
    # 4*q_i^2 for i in (w, x, y, z)
    qw2 = 1.0 + r00 + r11 + r22
    qx2 = 1.0 + r00 - r11 - r22
    qy2 = 1.0 - r00 + r11 - r22
    qz2 = 1.0 - r00 - r11 + r22
    # antisymmetric / symmetric off-diagonal sums
    a = r[:, 2, 1] - r[:, 1, 2]
    b = r[:, 0, 2] - r[:, 2, 0]
    c = r[:, 1, 0] - r[:, 0, 1]
    d = r[:, 0, 1] + r[:, 1, 0]
    e = r[:, 0, 2] + r[:, 2, 0]
    f = r[:, 1, 2] + r[:, 2, 1]
    # each row i is the quaternion scaled by 4*q_i — normalization removes
    # the scale, so only the (well-conditioned) ratios matter
    cand = jnp.stack([
        jnp.stack([qw2, a, b, c], axis=-1),
        jnp.stack([a, qx2, d, e], axis=-1),
        jnp.stack([b, d, qy2, f], axis=-1),
        jnp.stack([c, e, f, qz2], axis=-1),
    ], axis=1)                                               # [N,4,4]
    mags = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)          # [N,4]
    idx = jnp.argmax(mags, axis=-1)
    q = jnp.take_along_axis(cand, idx[:, None, None], axis=1)[:, 0]
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    q = q * jnp.where(q[:, :1] < 0.0, -1.0, 1.0)             # w >= 0
    s = jnp.linalg.norm(q[:, 1:], axis=-1)                   # sin(angle/2)
    angle = 2.0 * jnp.arctan2(s, q[:, 0])
    # rod = axis*angle = q_vec * angle/sin(angle/2); Taylor at 0: factor -> 2
    factor = jnp.where(s < 1e-6, 2.0, angle / jnp.maximum(s, 1e-12))
    rod = q[:, 1:] * factor[:, None]
    return jnp.where(jnp.isfinite(rod), rod, 0.0)


def rodrigues_to_rotation(rod):
    """Batched axis*angle [N,3] -> rotation matrix [N,3,3] (gmm.h:644-651).

    Sinc form on the *unnormalized* skew matrix:
        R = I + sin(t)/t * K + (1-cos t)/t^2 * K^2,   K = skew(rod)
    with Taylor branches for the two ratios — smooth (and with finite
    gradients) at rod = 0, unlike axis-normalization (whose norm() gradient
    is NaN at zero; axis-aligned Gaussians pack to exactly rod = 0)."""
    t2 = jnp.sum(rod * rod, axis=-1)
    t = jnp.sqrt(jnp.maximum(t2, 1e-24))
    small = t2 < 1e-8
    sin_ratio = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(t) / t)
    cos_ratio = jnp.where(small, 0.5 - t2 / 24.0,
                          (1.0 - jnp.cos(t)) / jnp.maximum(t2, 1e-24))
    x, y, z = rod[:, 0], rod[:, 1], rod[:, 2]
    zero = jnp.zeros_like(x)
    k = jnp.stack([
        jnp.stack([zero, -z, y], axis=-1),
        jnp.stack([z, zero, -x], axis=-1),
        jnp.stack([-y, x, zero], axis=-1),
    ], axis=-2)                                            # [N,3,3]
    eye = jnp.eye(3, dtype=rod.dtype)[None]
    return (eye + sin_ratio[:, None, None] * k
            + cos_ratio[:, None, None]
            * jnp.matmul(k, k, precision=jax.lax.Precision.HIGHEST))


def morton_order(points: np.ndarray) -> np.ndarray:
    """Permutation sorting 3D points along a 30-bit Z-order curve."""
    p = np.asarray(points, np.float64)
    lo = p.min(axis=0)
    hi = p.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    q = np.clip(((p - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def inv_sigmoid(y):
    """Numerically-guarded logit (gmm.h:28-32)."""
    eps = 1e-7
    yy = jnp.clip(y, eps, 1.0 - eps)
    return jnp.log(yy / (1.0 - yy))


def default_param_eps(n_gaussians: int) -> np.ndarray:
    """Per-parameter finite-difference epsilons (gmm.h:677-706), used by the
    SFD validation mode."""
    eps = np.empty(n_gaussians * PARAMS_PER_GAUSSIAN, np.float32)
    per = np.array([0.02, 0.02, 0.02,          # mean
                    0.10, 0.10, 0.10,          # rotation
                    0.05, 0.05, 0.05,          # log-scale
                    0.25,                      # log-density
                    0.5], np.float32)          # logit-albedo
    eps.reshape(-1, PARAMS_PER_GAUSSIAN)[:] = per
    return eps
