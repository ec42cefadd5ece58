"""Mitsuba XML loader test against the reference cross-validation scene."""

import numpy as np
import pytest

from gvr.io.mitsuba import load_mitsuba
from gvr.cameras import OrthographicCamera

XML = "tests/env_one_sphere_test_ortho.xml"


def test_load_reference_xml(ref_paths):
    scene, camera, w, h = load_mitsuba(f"{ref_paths['root']}/{XML}")
    assert (w, h) == (512, 512)
    assert isinstance(camera, OrthographicCamera)
    np.testing.assert_allclose(np.asarray(camera.position), [0, 1, 6])
    np.testing.assert_allclose(np.asarray(scene.env_color),
                               [0.53, 0.81, 0.92])
    assert scene.num_lights == 1
    np.testing.assert_allclose(np.asarray(scene.lights_p[0]), [0, 4, 0])
    np.testing.assert_allclose(np.asarray(scene.lights_i[0]), [35, 35, 35])
    smm = scene.medium
    assert smm.n == 1
    np.testing.assert_allclose(np.asarray(smm.center[0]), [0, 1, 0])
    np.testing.assert_allclose(float(smm.radius[0]), 1.0)
    # sigma_t=0.8, albedo=0.875 -> sigma_s=0.7, sigma_a=0.1 — exactly the
    # text fixture scenes/spheres/1_spheres.txt (SURVEY §4.3)
    np.testing.assert_allclose(float(smm.sigma_s[0]), 0.7, atol=1e-6)
    np.testing.assert_allclose(float(smm.sigma_a[0]), 0.1, atol=1e-6)


def test_xml_matches_text_fixture(ref_paths):
    """The XML scene and scenes/spheres/1_spheres.txt describe the same
    physical setup."""
    from gvr.scene.scene import load_smm
    scene_xml, *_ = load_mitsuba(f"{ref_paths['root']}/{XML}")
    scene_txt = load_smm(f"{ref_paths['spheres']}/1_spheres.txt")
    np.testing.assert_allclose(np.asarray(scene_xml.medium.center),
                               np.asarray(scene_txt.medium.center))
    np.testing.assert_allclose(np.asarray(scene_xml.medium.sigma_s),
                               np.asarray(scene_txt.medium.sigma_s),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(scene_xml.lights_i),
                               np.asarray(scene_txt.lights_i))
