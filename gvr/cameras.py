"""Cameras as pure functions uv -> (origin, direction), batched over pixels.

Reference: ``include/camera.h``.  The frame construction and the (quirky but
parity-critical) uv flips are preserved exactly:

* frame: right = view_dir x world_up (world_up = (0,1,0)), up = right x view_dir
  (camera.h:15-22)
* pinhole: image plane AT ``position``; pinhole point in front at
  position + view_dir / tan(fov/2); u is x-flipped: u = 1 - 2 uv.x
  (camera.h:45-53)
* orthographic: parallel rays along view_dir; v is y-flipped:
  v = 1 - 2 uv.y (camera.h:64-73)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

WORLD_UP = np.array([0.0, 1.0, 0.0], np.float32)


def _normalize(v):
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def make_frame(position, view_dir):
    position = jnp.asarray(position, jnp.float32)
    view_dir = _normalize(jnp.asarray(view_dir, jnp.float32))
    r = jnp.cross(view_dir, jnp.asarray(WORLD_UP))
    # looking straight up/down makes cross(view, up) vanish — the
    # reference NaNs here too (camera.h:13-16); fall back to the z axis
    # so a vertical turntable frame renders instead of going all-NaN
    degenerate = jnp.linalg.norm(r, axis=-1, keepdims=True) < 1e-6
    r = jnp.where(degenerate,
                  jnp.cross(view_dir, jnp.asarray([0.0, 0.0, 1.0])), r)
    right = _normalize(r)
    up = _normalize(jnp.cross(right, view_dir))
    return position, view_dir, right, up


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PinholeCamera:
    position: jnp.ndarray
    view_dir: jnp.ndarray
    right: jnp.ndarray
    up: jnp.ndarray
    fov: jnp.ndarray

    def tree_flatten(self):
        return (self.position, self.view_dir, self.right, self.up,
                self.fov), None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)

    @staticmethod
    def create(position, lookat_or_dir, fov, lookat=True) -> "PinholeCamera":
        position = jnp.asarray(position, jnp.float32)
        target = jnp.asarray(lookat_or_dir, jnp.float32)
        view = target - position if lookat else target
        p, v, r, u = make_frame(position, view)
        return PinholeCamera(p, v, r, u, jnp.float32(fov))

    def sample_ray(self, uv):
        """uv [...,2] in [0,1] -> (origin [...,3], dir [...,3]).

        camera.h:45-53: the ray starts on the image plane at ``position`` and
        points at the pinhole in front of the plane."""
        u = 1.0 - uv[..., 0] * 2.0          # x-flip (camera.h:47)
        v = uv[..., 1] * 2.0 - 1.0
        focal = 1.0 / jnp.tan(0.5 * self.fov)
        pinhole = self.position + focal * self.view_dir
        origin = (self.position
                  + u[..., None] * self.right
                  + v[..., None] * self.up)
        direction = _normalize(pinhole - origin)
        return origin, direction


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class OrthographicCamera:
    position: jnp.ndarray
    view_dir: jnp.ndarray
    right: jnp.ndarray
    up: jnp.ndarray

    def tree_flatten(self):
        return (self.position, self.view_dir, self.right, self.up), None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)

    @staticmethod
    def create(position, lookat_or_dir, lookat=True) -> "OrthographicCamera":
        position = jnp.asarray(position, jnp.float32)
        target = jnp.asarray(lookat_or_dir, jnp.float32)
        view = target - position if lookat else target
        p, v, r, u = make_frame(position, view)
        return OrthographicCamera(p, v, r, u)

    def sample_ray(self, uv):
        """camera.h:64-73: parallel rays; v is y-flipped.

        The broadcast constant direction is wrapped in an
        optimization_barrier, which keeps XLA from constant-folding a
        whole-batch constant direction through the renderer."""
        u = uv[..., 0] * 2.0 - 1.0
        v = 1.0 - uv[..., 1] * 2.0          # y-flip (camera.h:67)
        origin = (self.position
                  + u[..., None] * self.right
                  + v[..., None] * self.up)
        direction = jax.lax.optimization_barrier(
            jnp.broadcast_to(self.view_dir, origin.shape))
        return origin, direction


def pixel_center_uv(width: int, height: int):
    """uv grid at pixel centers ((x+0.5)/W, (y+0.5)/H) as [H,W,2], matching
    the deterministic integrators' sampling (integrator.h:77-78 etc.)."""
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    ys = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    u, v = jnp.meshgrid(xs, ys, indexing="xy")
    return jnp.stack([u, v], axis=-1)
