"""SPMD pixel-tile sharding over a device mesh.

The reference's only parallelism is shared-memory OpenMP over pixels
(``#pragma omp parallel for collapse(2)``, integrator.h:148,302,547).  The
equivalent here (SURVEY §2 "Parallelism strategies"): shard the flat ray
batch across devices with ``shard_map`` over a 1-D ``Mesh``; Gaussian
parameters are replicated (20k Gaussians x 11 params = 220 KB — replication
is free); forward rendering needs *no* collectives, inverse fitting needs a
single ``psum`` over parameter gradients.  Per-path RNG keys are derived
from pixel coordinates, so radiance is bitwise independent of the shard
layout.

When the per-(ray, gaussian) working set (not the parameters) is what
outgrows a chip, the complementary axis lives in ``gauss_sharded.py``:
tensor-parallel rendering over a 2-D (rays x gauss) mesh.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

RAY_AXIS = "rays"


def make_mesh(devices: Optional[Sequence] = None,
              axis: str = RAY_AXIS) -> Mesh:
    """1-D mesh over all (or given) devices; forward rendering is data
    parallel over rays, so one axis is the whole story (ICI handles any
    physical topology)."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), (axis,))


def shard_rays(n: int, n_devices: int) -> int:
    """Round a ray count up to a multiple of the device count."""
    return ((n + n_devices - 1) // n_devices) * n_devices


def sharded_render_fn(radiance_fn: Callable, mesh: Mesh) -> Callable:
    """Wrap ``radiance_fn(scene, rays...) -> [B,3]`` so the ray batch is
    split across the mesh.  Scene (medium, lights, env) is replicated; rays
    and output are sharded on the leading axis.  No collectives needed."""

    def wrapped(scene, *ray_args):
        fn = shard_map(
            lambda sc, *ra: radiance_fn(sc, *ra),
            mesh=mesh,
            in_specs=(P(),) + tuple(P(RAY_AXIS) for _ in ray_args),
            out_specs=P(RAY_AXIS),
            check_vma=False,
        )
        return fn(scene, *ray_args)

    return wrapped


def shard_last_arg(fn: Callable, mesh: Mesh, n_args: int) -> Callable:
    """Wrap ``fn(*replicated_args, ids) -> [B,3]`` so the trailing ray-id
    batch (and the output) are sharded over the mesh; everything else
    (scene, grid index, camera) is replicated.  This is the production
    multi-chip forward path: radiance is bitwise shard-invariant because
    RNG streams are keyed by pixel id (ops/sampling.path_uniforms)."""
    return shard_map(
        fn, mesh=mesh,
        in_specs=tuple(P() for _ in range(n_args - 1)) + (P(RAY_AXIS),),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )


def sharded_value_and_grad(loss_fn: Callable, mesh: Mesh) -> Callable:
    """value_and_grad of ``loss_fn(params, scene_template, rays..., targets)``
    with rays/targets sharded over the mesh and the gradient psum-reduced —
    the single collective the framework requires (SURVEY §5)."""

    def local(params, template, *sharded_args):
        loss, grads = jax.value_and_grad(loss_fn)(params, template,
                                                  *sharded_args)
        loss = jax.lax.pmean(loss, RAY_AXIS)
        grads = jax.lax.pmean(grads, RAY_AXIS)
        return loss, grads

    def wrapped(params, template, *sharded_args):
        fn = shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P()) + tuple(P(RAY_AXIS) for _ in sharded_args),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return fn(params, template, *sharded_args)

    return wrapped
