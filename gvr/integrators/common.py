"""Shared rendering driver: chunked evaluation of per-ray radiance.

The reference parallelizes with one OpenMP ``collapse(2)`` loop over pixels
(integrator.h:148,302,547).  Here the pixel grid is flattened into ray
batches; each batch is one jitted XLA program where every op is dense over
[rays, gaussians].  Chunk size adapts to the Gaussian count so intermediate
[R, N] tensors stay within a fixed element budget.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from gvr.config import RenderConfig
from gvr.scene.scene import Scene

# budget for the [rays, gaussians] intermediates of one chunk
_ELEM_BUDGET = 1 << 25


def pick_chunk(cfg: RenderConfig, n_primitives: int) -> int:
    # floor at 256 rays, NOT higher: a bigger floor would let
    # the [chunk, N] working set outgrow the element budget at huge N
    # (e.g. 300k gaussians -> 1024-ray floor = 11 live ~1.2 GB arrays)
    chunk = min(cfg.ray_chunk, max(256, _ELEM_BUDGET // max(n_primitives, 1)))
    # keep it lane-friendly
    return max(256, (chunk // 256) * 256)


def render_chunked(scene: Scene, radiance_fn: Callable, num_rays: int,
                   chunk: int, camera=None) -> np.ndarray:
    """Evaluate radiance_fn(scene[, camera], ray_ids [B]) -> [B,3] over all
    rays in fixed-size chunks (last chunk padded).  Returns
    [num_rays, 3] float32.

    When ``camera`` is given it is passed as a *traced* pytree argument so
    per-frame camera changes (turntables) don't retrigger compilation."""
    # don't re-wrap already-jitted callables (would defeat their caches)
    fn = radiance_fn if hasattr(radiance_fn, "lower") else \
        jax.jit(radiance_fn)
    out = np.empty((num_rays, 3), np.float32)
    for start in range(0, num_rays, chunk):
        ids = np.arange(start, start + chunk, dtype=np.int32)
        ids = np.minimum(ids, num_rays - 1)          # pad with repeats
        if camera is None:
            vals = np.asarray(fn(scene, jnp.asarray(ids)))
        else:
            vals = np.asarray(fn(scene, camera, jnp.asarray(ids)))
        stop = min(start + chunk, num_rays)
        out[start:stop] = vals[: stop - start]
    return out


def ids_to_pixels(ids, width: int):
    """Flat ray/pixel id -> (x, y) integer coords."""
    x = ids % width
    y = ids // width
    return x, y
