"""Voxel-grid medium: the reference's VOXELS VolumeType, made real.

The reference declares VolumeType::VOXELS and load_VDB but implements
neither (scene.h:21-22, 122, 144-145).  gvr renders dense voxel grids
through the medium-agnostic PureRayMarching path (integrator.h:100-267),
so these tests pin (1) the trilinear sampler, (2) closed-form
transmittance on a constant grid, (3) the .npz loader round-trip, and
(4) cross-representation agreement: a GaussianMixture baked to a grid
must render the same image through the SAME marcher.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest

from gvr.cameras import PinholeCamera
from gvr.config import RenderConfig
from gvr.integrators.raymarch import (
    march_transmittance, render_pure_raymarch)
from gvr.scene.scene import load_gmm, load_scene
from gvr.scene.voxels import VoxelGrid, load_voxels



def test_trilinear_exact_at_cell_centers():
    g = np.arange(4 * 5 * 6, dtype=np.float32).reshape(4, 5, 6)
    vg = VoxelGrid.create([0, 0, 0], [1, 1, 1], g, 0.5)
    pts, vals = [], []
    for i in range(4):
        for j in range(5):
            for k in range(6):
                pts.append(((i + 0.5) / 4, (j + 0.5) / 5, (k + 0.5) / 6))
                vals.append(g[i, j, k])
    s = vg._trilinear(vg.sigma_t, jnp.asarray(pts, jnp.float32))
    np.testing.assert_allclose(np.asarray(s), vals, atol=1e-5)


def test_trilinear_midpoint_is_mean():
    g = np.zeros((4, 4, 4), np.float32)
    g[1, 2, 2], g[2, 2, 2] = 3.0, 5.0
    vg = VoxelGrid.create([0, 0, 0], [1, 1, 1], g, 0.5)
    # midpoint between the (1,2,2) and (2,2,2) cell centers along x
    p = jnp.asarray([[0.5, 0.625, 0.625]], jnp.float32)
    s = float(vg._trilinear(vg.sigma_t, p)[0])
    assert abs(s - 4.0) < 1e-5


def test_constant_grid_transmittance_closed_form():
    vg = VoxelGrid.create([-1, -1, -1], [1, 1, 1],
                          np.full((8, 8, 8), 0.7, np.float32), 0.8)
    o = jnp.asarray([[0.0, 0.0, -5.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    T = float(march_transmittance(vg, o, d, jnp.asarray([100.0]),
                                  0.002, 6000)[0])
    assert abs(T - math.exp(-0.7 * 2.0)) < 2e-3


def test_aabb_intersect_interval():
    vg = VoxelGrid.create([-1, 0, -1], [1, 2, 1],
                          np.ones((4, 4, 4), np.float32), 0.5)
    o = jnp.asarray([[0.0, 1.0, 6.0], [5.0, 5.0, 6.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    t0, t1, hit = vg.intersect(o, d)
    assert bool(hit[0, 0]) and not bool(hit[1, 0])
    np.testing.assert_allclose(float(t0[0, 0]), 5.0, atol=1e-5)
    np.testing.assert_allclose(float(t1[0, 0]), 7.0, atol=1e-5)


def test_npz_loader_roundtrip(tmp_path):
    sig = np.random.default_rng(0).uniform(0, 1, (6, 6, 6)).astype(np.float32)
    path = os.path.join(tmp_path, "vox.npz")
    np.savez(path, sigma_t=sig, albedo=np.float32(0.7),
             lo=np.asarray([-1, -1, -1], np.float32),
             hi=np.asarray([1, 1, 1], np.float32),
             lights=np.asarray([[0, 4, 0, 35, 35, 35]], np.float32))
    sc = load_voxels(path)
    assert sc.num_lights == 1
    np.testing.assert_allclose(np.asarray(sc.medium.sigma_t), sig)
    # load_scene auto-detects .npz
    sc2 = load_scene(path)
    assert isinstance(sc2.medium, VoxelGrid)


def test_baked_gmm_renders_like_gmm(scene_files):
    """Cross-representation validation: bake 2g_altered to a voxel grid and
    render both through the SAME medium-agnostic marcher.  As the bake
    resolution rises the images converge; at 64^3 the remaining gap is
    interpolation bias only."""
    sc = load_gmm(scene_files["2g_altered.txt"])
    vg = VoxelGrid.from_gaussians(sc.medium, res=64)
    scv = sc.with_medium(vg)
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
    cfg = RenderConfig(width=16, height=16, step_size=0.06, env_samples=2)
    img_g = render_pure_raymarch(sc, cam, cfg)
    img_v = render_pure_raymarch(scv, cam, cfg)
    assert np.isfinite(img_v).all()
    d = np.abs(img_g - img_v)
    assert d.mean() < 0.01, (d.mean(), d.max())
    assert d.max() < 0.05, (d.mean(), d.max())


@pytest.mark.parametrize("res", [24, 48])
def test_bake_convergence(res, scene_files):
    """Baking error falls with resolution (sigma_t field midline probe)."""
    sc = load_gmm(scene_files["2g_altered.txt"])
    vg = VoxelGrid.from_gaussians(sc.medium, res=res)
    pts = jnp.stack([jnp.zeros(64), jnp.linspace(0.2, 1.8, 64),
                     jnp.zeros(64)], axis=-1)
    active = jnp.ones((64, 1), bool)
    sa_v, ss_v = vg.sigma_albedo(pts, active)
    full = jnp.ones((64, sc.medium.n), bool)
    sa_g, ss_g = sc.medium.sigma_albedo(pts, full)
    err = float(jnp.abs((sa_v + ss_v) - (sa_g + ss_g)).max())
    scale = float(jnp.abs(sa_g + ss_g).max())
    assert err < (0.25 if res == 24 else 0.08) * scale, (res, err, scale)
