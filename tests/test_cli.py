"""CLI smoke tests (the reference's driver surface, tests/main.cpp)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from gvr.io.ppm import read_ppm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu",
       "PYTHONPATH": os.pathsep.join(
           [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
               os.pathsep) if p])}


@pytest.fixture
def scene(scene_files):
    return scene_files["1_gaussian.txt"]


def _run(args, timeout=300):
    return subprocess.run([sys.executable, "-m", "gvr.cli", *args],
                          capture_output=True, text=True, timeout=timeout,
                          env=ENV, cwd=ROOT)


def test_cli_render_multiscatter(tmp_path, scene):
    out = str(tmp_path / "o.ppm")
    r = _run(["render", scene, "-o", out, "--width", "32", "--height", "32",
              "--spp", "4"])
    assert r.returncode == 0, r.stderr[-800:]
    img = read_ppm(out)
    assert img.shape == (32, 32, 3)
    assert "Render time" in r.stdout


def test_cli_render_hitmask(tmp_path, scene):
    out = str(tmp_path / "h.ppm")
    r = _run(["render", scene, "-o", out, "--width", "16", "--height", "16",
              "--integrator", "hitmask", "--spp", "1"])
    assert r.returncode == 0, r.stderr[-800:]
    img = read_ppm(out)
    # center magenta, corner env
    np.testing.assert_allclose(img[8, 8], [1.0, 0.0, 1.0], atol=0.01)


def test_cli_animate(tmp_path, scene):
    out = str(tmp_path / "a.gif")
    r = _run(["animate", scene, "-o", out, "--width", "24", "--height", "24",
              "--frames", "2", "--env-samples", "1"], timeout=400)
    assert r.returncode == 0, r.stderr[-800:]
    raw = open(out, "rb").read()
    assert raw.startswith(b"GIF89a") and raw.endswith(b"\x3b")


def test_cli_fit(tmp_path, scene):
    """The USE_INVERSE_OPT driver surface (tests/main.cpp:54-75): render a
    tiny target with the CLI, then fit against it end-to-end — arg wiring,
    FitConfig, snapshots, checkpoint, and the final render must all land."""
    tgt = str(tmp_path / "t.ppm")
    r = _run(["render", scene, "-o", tgt, "--width", "16", "--height", "16",
              "--spp", "4"])
    assert r.returncode == 0, r.stderr[-800:]
    out = str(tmp_path / "fit")
    r = _run(["fit", scene, "--target", tgt, "-o", out, "--iters", "2",
              "--spp", "2", "--batch-pixels", "64", "--bounces", "2",
              "--final-spp", "2", "--save-every", "1", "--snapshots"],
             timeout=580)
    assert r.returncode == 0, r.stderr[-800:]
    img = read_ppm(f"{out}/final.ppm")
    assert img.shape == (16, 16, 3)
    assert os.path.exists(f"{out}/iter_0001.ppm")     # snapshot hook ran
    assert any(f.endswith(".npz") for f in os.listdir(out)), \
        "fit checkpoint missing"
    assert "Inverse optimization time" in r.stdout


def test_cli_render_voxel_npz(tmp_path):
    """A .npz voxel scene through the CLI routes to the medium-agnostic
    marcher (ADVICE r4: it used to die with an opaque AttributeError in
    the GMM-only multiscatter path)."""
    npz = str(tmp_path / "vox.npz")
    sig = np.zeros((8, 8, 8), np.float32)
    sig[2:6, 2:6, 2:6] = 0.8
    np.savez(npz, sigma_t=sig, albedo=np.float32(0.7),
             lo=np.array([-1, 0, -1], np.float32),
             hi=np.array([1, 2, 1], np.float32),
             lights=np.array([[0, 4, 0, 35, 35, 35]], np.float32))
    out = str(tmp_path / "v.ppm")
    # default integrator (multiscatter) must refuse with a clear message
    r = _run(["render", npz, "-o", out, "--width", "16", "--height", "16",
              "--spp", "1"])
    assert r.returncode != 0
    assert "pureraymarch" in (r.stderr + r.stdout)
    # explicit pureraymarch renders
    r = _run(["render", npz, "-o", out, "--width", "16", "--height", "16",
              "--integrator", "pureraymarch", "--spp", "1",
              "--env-samples", "2", "--step-size", "0.05"])
    assert r.returncode == 0, r.stderr[-800:]
    img = read_ppm(out)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()


def test_cli_bad_scene():
    r = _run(["render", "/nonexistent.txt", "-o", "/tmp/x.ppm"])
    assert r.returncode != 0
