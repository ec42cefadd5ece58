"""Multi-chip SPMD tests on the virtual 8-device CPU mesh (SURVEY §7 stage
7): sharded rendering must be bitwise-identical to single-device, and the
sharded gradient (the framework's one collective) must match unsharded."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gvr.scene.scene import parse_gmm
from gvr.cameras import PinholeCamera
from gvr.config import RenderConfig
from gvr.integrators.multiscatter import multiscatter_radiance
from gvr.inverse.fit import fit_loss, _pixel_rays
from gvr.parallel.sharding import (make_mesh, sharded_render_fn,
                                       sharded_value_and_grad)

SCENE = ("l 0 4 0  8 8 8\n"
         "g 0.1 1.0 0.2  0.08 0.01 0  0.07 0 0.09  1.5 0.7\n")
CAM = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(jax.devices()[:8])


def test_sharded_render_matches_single_device(mesh):
    scene = parse_gmm(SCENE)
    cfg = RenderConfig(width=16, height=16, spp=1)
    w = h = 16
    ids = jnp.arange(w * h, dtype=jnp.int32)
    o, d, rng_ids = _pixel_rays(CAM, w, h, ids)

    def radiance(sc, o, d, rng_ids):
        return multiscatter_radiance(sc, o, d, rng_ids, cfg)

    single = np.asarray(jax.jit(radiance)(scene, o, d, rng_ids))
    sharded = np.asarray(
        jax.jit(sharded_render_fn(radiance, mesh))(scene, o, d, rng_ids))
    np.testing.assert_allclose(sharded, single, atol=2e-6)


def test_production_render_is_shard_invariant(mesh):
    """render_multiscatter auto-shards over all visible devices; the image
    must match the single-device wavefront bitwise-ish (same RNG streams,
    keyed by pixel id)."""
    from gvr.integrators.multiscatter import (
        render_multiscatter, _wavefront_fn, _mesh_shards, tile_order)

    scene = parse_gmm(SCENE)
    cfg = RenderConfig(width=16, height=16, spp=2, pallas="off")
    assert _mesh_shards() == 8        # the production path really shards
    img = np.asarray(render_multiscatter(scene, CAM, cfg))

    ids = jnp.asarray(tile_order(16, 16))
    single = np.asarray(_wavefront_fn(cfg, None, 1)(scene, CAM, ids))
    ref = np.zeros_like(single)
    ref[np.asarray(ids)] = single
    np.testing.assert_allclose(img.reshape(-1, 3), ref, atol=2e-6)


def test_awkward_ray_chunk_still_shards(mesh):
    """A ray_chunk that does not divide by the device count must be padded
    up (and still shard over all devices), not silently rendered on one
    (round-2 weak #7)."""
    from gvr.integrators.multiscatter import render_multiscatter

    scene = parse_gmm(SCENE)
    base = RenderConfig(width=16, height=16, spp=2, pallas="off")
    # 300 is not a multiple of 256*8; the render pads it internally
    odd = RenderConfig(width=16, height=16, spp=2, pallas="off",
                       ray_chunk=300)
    np.testing.assert_allclose(
        np.asarray(render_multiscatter(scene, CAM, odd)),
        np.asarray(render_multiscatter(scene, CAM, base)), atol=2e-6)


def test_grid_engine_is_shard_invariant(mesh):
    """The grid wavefront (shard_map + the jnp slice-gather passes) must
    match the single-shard grid render (advisor round-2 finding)."""
    from gvr.scene.generators import random_gaussian_scene
    from gvr.integrators.multiscatter import (
        render_multiscatter, _wavefront_grid_fn, engine_for, tile_order)

    scene = parse_gmm(random_gaussian_scene(24, seed=11,
                                            diameter=(0.1, 0.6)))
    cfg = RenderConfig(width=8, height=8, spp=1, engine="grid")
    engine, grid = engine_for(cfg, scene.medium)
    assert engine == "grid"
    img = np.asarray(render_multiscatter(scene, CAM, cfg))

    ids = jnp.asarray(tile_order(8, 8))
    single = np.asarray(
        _wavefront_grid_fn(cfg, 1)(scene, grid, CAM, ids))
    ref = np.zeros_like(single)
    ref[np.asarray(ids)] = single
    np.testing.assert_allclose(img.reshape(-1, 3), ref, atol=2e-6)


def test_mega_wavefront_is_shard_invariant(mesh):
    """The persistent megakernel (pallas interpret) under the production
    shard_map path must match the single-shard megakernel render — the
    multi-card production path runs this kernel inside shard_map."""
    from gvr.integrators.multiscatter import (
        render_multiscatter, _wavefront_fn, tile_order, static_lights_of)

    scene = parse_gmm(SCENE)
    cfg = RenderConfig(width=16, height=16, spp=2, pallas="interpret")
    img = np.asarray(render_multiscatter(scene, CAM, cfg))

    lights = static_lights_of(scene)
    ids = jnp.asarray(tile_order(16, 16))
    single = np.asarray(_wavefront_fn(cfg, lights, 1)(scene, CAM, ids))
    ref = np.zeros_like(single)
    ref[np.asarray(ids)] = single
    np.testing.assert_allclose(img.reshape(-1, 3), ref, atol=2e-6)


def test_grid_engine_rejects_pallas_off():
    """The grid engine is plain jnp/lax, so it no longer depends on the
    kernel switch: pallas='off' selects it like any other setting.  It
    still refuses solvers it does not implement."""
    from gvr.integrators.multiscatter import engine_for
    from gvr.config import Solver

    scene = parse_gmm(SCENE)
    engine, grid = engine_for(RenderConfig(engine="grid", pallas="off"),
                              scene.medium)
    assert engine == "grid" and grid is not None
    with pytest.raises(ValueError, match="solver"):
        engine_for(RenderConfig(engine="grid", solver=Solver.BISECTION),
                   scene.medium)


def test_sharded_grads_match_unsharded(mesh):
    scene = parse_gmm(SCENE)
    params = scene.medium.pack_parameters()
    w = h = 16
    ids = jnp.arange(w * h, dtype=jnp.int32)
    o, d, rng_ids = _pixel_rays(CAM, w, h, ids)
    target = jnp.full((w * h, 3), 0.3, jnp.float32)

    def loss_fn(p, template, o, d, rng_ids, tgt):
        return fit_loss(p, template, o, d, rng_ids, tgt, n_bounces=2)

    loss_u, grads_u = jax.value_and_grad(loss_fn)(
        params, scene, o, d, rng_ids, target)
    vg = sharded_value_and_grad(loss_fn, mesh)
    loss_s, grads_s = jax.jit(vg)(params, scene, o, d, rng_ids, target)

    # mean-of-shard-means == global mean for equal shard sizes
    np.testing.assert_allclose(float(loss_s), float(loss_u), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(grads_s), np.asarray(grads_u),
                               rtol=1e-3, atol=1e-5)
