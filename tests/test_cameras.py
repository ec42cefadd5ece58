"""Camera parity tests against a hand-rolled oracle of camera.h math,
including the reference's uv flips (camera.h:47,66-67)."""

import math

import numpy as np
import jax.numpy as jnp

from gvr.cameras import PinholeCamera, OrthographicCamera, pixel_center_uv


def oracle_frame(pos, lookat):
    pos = np.asarray(pos, np.float64)
    view = np.asarray(lookat, np.float64) - pos
    view /= np.linalg.norm(view)
    right = np.cross(view, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, view)
    up /= np.linalg.norm(up)
    return pos, view, right, up


def test_pinhole_matches_reference_math(rng):
    pos, lookat, fov = [0.3, 1.2, 6.0], [0.0, 1.0, 0.0], 0.25 * math.pi
    cam = PinholeCamera.create(pos, lookat, fov)
    p, view, right, up = oracle_frame(pos, lookat)
    focal = 1.0 / math.tan(0.5 * fov)
    pin = p + focal * view
    for _ in range(32):
        uv = rng.uniform(0, 1, 2)
        o, d = cam.sample_ray(jnp.asarray(uv, jnp.float32))
        u = 1.0 - 2.0 * uv[0]          # x-flip (camera.h:47)
        v = 2.0 * uv[1] - 1.0
        oo = p + u * right + v * up
        dd = pin - oo
        dd /= np.linalg.norm(dd)
        np.testing.assert_allclose(np.asarray(o), oo, atol=1e-5)
        np.testing.assert_allclose(np.asarray(d), dd, atol=1e-5)


def test_orthographic_matches_reference_math(rng):
    pos, lookat = [2.0, 1.0, 5.0], [0.0, 1.0, 0.0]
    cam = OrthographicCamera.create(pos, lookat)
    p, view, right, up = oracle_frame(pos, lookat)
    for _ in range(32):
        uv = rng.uniform(0, 1, 2)
        o, d = cam.sample_ray(jnp.asarray(uv, jnp.float32))
        u = 2.0 * uv[0] - 1.0
        v = 1.0 - 2.0 * uv[1]          # y-flip (camera.h:67)
        oo = p + u * right + v * up
        np.testing.assert_allclose(np.asarray(o), oo, atol=1e-5)
        np.testing.assert_allclose(np.asarray(d), view, atol=1e-5)


def test_pixel_center_uv():
    uv = pixel_center_uv(4, 2)
    assert uv.shape == (2, 4, 2)
    np.testing.assert_allclose(np.asarray(uv[0, 0]), [0.125, 0.25])
    np.testing.assert_allclose(np.asarray(uv[1, 3]), [0.875, 0.75])


def test_batched_equals_scalar(rng):
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
    uvs = rng.uniform(0, 1, (16, 2)).astype(np.float32)
    ob, db = cam.sample_ray(jnp.asarray(uvs))
    for i in range(16):
        o, d = cam.sample_ray(jnp.asarray(uvs[i]))
        np.testing.assert_allclose(np.asarray(ob[i]), np.asarray(o),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(db[i]), np.asarray(d),
                                   atol=1e-6)
