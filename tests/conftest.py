"""Pytest config: tests run on a virtual 8-device CPU mesh.

Set ``GVR_TEST_GPU=1`` to run on the GPU instead (``chip_smoke.py`` does so
for the tests marked ``gpu``; they skip without a card).  Scenes are
generated from fixed seeds; the reference renderer's golden PPMs and XML
are read from the checkout named by ``GVR_REFERENCE`` and their tests skip
without it.
"""

import os

if os.environ.get("GVR_TEST_GPU") != "1":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("GVR_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from gvr.scene.generators import random_gaussian_scene  # noqa: E402

# the reference driver's thick 2-Gaussian scene (2g_altered.txt)
TWO_GAUSSIANS = ("l 0 4 0 1 1 1\n"
                 "g 0 0.7 0.3 0.03778 0 0 0.0811 0 0.0336 4.5 1.0\n"
                 "g 0 1.3 -0.3 0.1511 0 0 0.03778 0 0.0336 1.5 0.0\n")
# one Gaussian in front of the default camera, one light (1_gaussian.txt)
ONE_GAUSSIAN = ("l 0 4 0 35 35 35\n"
                "g 0 1 0 0.09 0 0 0.09 0 0.09 3.0 0.8\n")


@pytest.fixture(scope="session")
def scene_files(tmp_path_factory):
    """Scene files generated from fixed seeds, by reference file name."""
    d = tmp_path_factory.mktemp("scenes")
    texts = {"1_gaussian.txt": ONE_GAUSSIAN,
             "2g_altered.txt": TWO_GAUSSIANS,
             "250_random.txt": random_gaussian_scene(250, seed=250)}
    paths = {}
    for name, text in texts.items():
        paths[name] = str(d / name)
        with open(paths[name], "w") as f:
            f.write(text)
    return paths


@pytest.fixture(scope="session")
def ref_paths():
    """Paths into a checkout of the reference renderer (its scenes and
    golden renders); skips the test when ``GVR_REFERENCE`` names none."""
    ref = os.environ.get("GVR_REFERENCE", "")
    if not (ref and os.path.isdir(os.path.join(ref, "tests", "renders"))):
        pytest.skip("reference checkout unavailable (set GVR_REFERENCE)")
    return {"root": ref,
            "gaussians": os.path.join(ref, "scenes", "gaussians"),
            "spheres": os.path.join(ref, "scenes", "spheres"),
            "renders": os.path.join(ref, "tests", "renders")}


@pytest.fixture
def gpu():
    """The first GPU device; skips the test without one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (found {dev.platform})")
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
