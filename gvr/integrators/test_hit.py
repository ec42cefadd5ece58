"""Hit-mask visualization integrator — the first smoke test.

Reference ``TestIntegrator`` (integrator.h:65-94): magenta where the primary
ray intersects any primitive, environment color elsewhere.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from gvr.config import RenderConfig
from gvr.scene.scene import Scene
from gvr.scene.gaussians import GaussianMixture
from gvr.ops.quadratics import intersect_gaussians
from gvr.integrators.common import render_chunked, ids_to_pixels, pick_chunk

MAGENTA = jnp.array([1.0, 0.0, 1.0], jnp.float32)


def render_hit_mask(scene: Scene, camera, cfg: RenderConfig) -> np.ndarray:
    w, h = cfg.width, cfg.height

    def radiance(sc: Scene, ids):
        x, y = ids_to_pixels(ids, w)
        u = (x.astype(jnp.float32) + 0.5) / w
        v = (y.astype(jnp.float32) + 0.5) / h
        o, d = camera.sample_ray(jnp.stack([u, v], axis=-1))
        if isinstance(sc.medium, GaussianMixture):
            _, _, hit = intersect_gaussians(sc.medium, o, d)
        else:
            _, _, hit = sc.medium.intersect(o, d)
        any_hit = jnp.any(hit, axis=-1)
        return jnp.where(any_hit[:, None], MAGENTA, sc.env_color)

    img = render_chunked(scene, radiance, w * h,
                         pick_chunk(cfg, scene.medium.n))
    return img.reshape(h, w, 3)
