"""Homogeneous-sphere mixture medium (SoA pytree).

Reference: ``Sphere`` + ``SphereMixtureModel`` (``include/smm.h``).
Spheres have constant sigma_a/sigma_s inside the radius, so transmittance is
piecewise exponential in the overlap length — again a clipped-interval
map-reduce, no event sort needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
class SphereMixture:
    """center [N,3], radius [N], sigma_a [N], sigma_s [N]."""

    def __init__(self, center, radius, sigma_a, sigma_s):
        self.center = center
        self.radius = radius
        self.sigma_a = sigma_a
        self.sigma_s = sigma_s

    def tree_flatten(self):
        return (self.center, self.radius, self.sigma_a, self.sigma_s), None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)

    @staticmethod
    def create(center, radius, sigma_a, sigma_s):
        center = jnp.asarray(center, jnp.float32).reshape(-1, 3)
        n = center.shape[0]
        return SphereMixture(
            center,
            jnp.asarray(radius, jnp.float32).reshape(n),
            jnp.asarray(sigma_a, jnp.float32).reshape(n),
            jnp.asarray(sigma_s, jnp.float32).reshape(n))

    @property
    def n(self) -> int:
        return self.center.shape[0]

    def intersect(self, origin, direction):
        """Ray-sphere intersection for all spheres.

        origin/direction [...,3] -> (t_enter, t_exit, hit) each [...,N].
        Matches ``Sphere::intersect`` (smm.h:29-39): hit iff the closest
        approach is inside the radius and t_exit >= 0.  t values are NOT
        clamped here (the reference clamps at event insertion; we clip at the
        point of use instead).
        """
        l = self.center - origin[..., None, :]                  # [...,N,3]
        hp = jax.lax.Precision.HIGHEST     # no TF32 in ray geometry
        tca = jnp.einsum("...ni,...i->...n", l, direction, precision=hp)
        d2 = jnp.einsum("...ni,...ni->...n", l, l, precision=hp) - tca * tca
        r2 = self.radius * self.radius
        thc = jnp.sqrt(jnp.maximum(r2 - d2, 0.0))
        t_enter = tca - thc
        t_exit = tca + thc
        hit = (d2 <= r2) & (t_exit >= 0.0)
        return t_enter, t_exit, hit

    def transmittance_up_to(self, origin, direction, tmax):
        """T = exp(-sum_i sigma_t_i * overlap([t0,t1] clip [0,tmax])).

        Replaces the event-walk ``transmittance_from_events``
        (smm.h:79-103) with a closed-form clipped-interval reduction."""
        t0, t1, hit = self.intersect(origin, direction)
        a = jnp.maximum(t0, 0.0)
        b = jnp.minimum(t1, tmax[..., None] if jnp.ndim(tmax) else tmax)
        seg = jnp.maximum(b - a, 0.0) * hit
        tau = jnp.sum((self.sigma_a + self.sigma_s) * seg, axis=-1)
        return jnp.exp(-tau)

    def sigma_at(self, active_mask):
        """(sigma_a, sigma_s) for a boolean active mask [...,N]
        (smm.h:66-76): homogeneous sums over active spheres."""
        sa = jnp.sum(self.sigma_a * active_mask, axis=-1)
        ss = jnp.sum(self.sigma_s * active_mask, axis=-1)
        return sa, ss
