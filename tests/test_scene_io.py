"""Scene parser + PPM/GIF IO tests (reference scene.h:38-120, image.h)."""

import glob
import io
import os

import numpy as np
import pytest

from gvr.scene.scene import load_scene, load_gmm, load_smm, parse_gmm
from gvr.io.ppm import read_ppm, write_ppm, decode_ppm, quantize
from gvr.io.gif import write_gif


EXPECTED_COUNTS = {
    "1_gaussian.txt": (1, 1), "2_gaussian.txt": (2, 1),
    "2g_altered.txt": (2, 1), "50_random.txt": (50, 3),
    "250_random.txt": (250, 3), "1000_random.txt": (1000, 3),
    "20k_bias.txt": (20000, 3), "many_gaussians.txt": (7, 3),
}


def test_parse_all_reference_gaussian_scenes(ref_paths):
    for path in sorted(glob.glob(f"{ref_paths['gaussians']}/*.txt")):
        sc = load_scene(path)
        name = os.path.basename(path)
        assert sc.medium.n > 0
        if name in EXPECTED_COUNTS:
            n, l = EXPECTED_COUNTS[name]
            assert sc.medium.n == n, name
            assert sc.num_lights == l, name


def test_parse_all_reference_sphere_scenes(ref_paths):
    for path in sorted(glob.glob(f"{ref_paths['spheres']}/*.txt")):
        sc = load_scene(path)
        assert sc.medium.n > 0
        assert sc.num_lights > 0


def test_parse_gmm_values():
    text = ("l 0 4 0 1 2 3\n"
            "g 0.5 0.7 0.3 0.04 0.0 0.0 0.08 0.0 0.03 4.5 1.0\n"
            "g 1 2 3 0.1 0 0 0.1 0 0.1 1.5 0.25 0.5 0.6 0.7\n")
    sc = parse_gmm(text)
    assert sc.medium.n == 2
    np.testing.assert_allclose(np.asarray(sc.lights_i[0]), [1, 2, 3])
    np.testing.assert_allclose(np.asarray(sc.medium.mean[0]),
                               [0.5, 0.7, 0.3])
    np.testing.assert_allclose(np.asarray(sc.medium.density), [4.5, 1.5])
    # optional emission parsed on second gaussian only
    np.testing.assert_allclose(np.asarray(sc.medium.emission[1]),
                               [0.5, 0.6, 0.7])
    np.testing.assert_allclose(np.asarray(sc.medium.emission[0]), [0, 0, 0])
    # default env color (scene.h:29)
    np.testing.assert_allclose(np.asarray(sc.env_color), [0.53, 0.81, 0.92])


def test_parse_skips_comments_and_garbage():
    text = ("# a comment line\n"
            "banana 1 2 3\n"
            "g 0 0 0 0.1 0 0 0.1 0 0.1 1.0 0.5\n")
    sc = parse_gmm(text)
    assert sc.medium.n == 1


def test_parse_keeps_rows_with_trailing_junk(tmp_path):
    """A row with trailing non-float tokens keeps its float prefix — the
    reference stream-extracts exactly the floats it needs (scene.h:89-115)
    and the native sscanf parser does the same; the Python parser must not
    diverge by dropping the whole line (advisor round-3 finding)."""
    text = ("g 0 0 0 0.1 0 0 0.1 0 0.1 1.0 0.5 # the core\n"
            "g 0 1 0 0.1 0 0 0.1 0 0.1 2.0 0.25\n")
    sc = parse_gmm(text)
    assert sc.medium.n == 2
    # and the native parser (if built) agrees on the same file
    from gvr.native.loader import lib
    nat = lib()
    if nat is not None:
        p = tmp_path / "junk.txt"
        p.write_text(text)
        g, s, l = nat.parse_scene(str(p))
        assert g.shape[0] == 2


def test_ppm_roundtrip_bytes(tmp_path):
    img = np.random.default_rng(0).uniform(-0.2, 1.3, (17, 23, 3)).astype(
        np.float32)
    p = str(tmp_path / "x.ppm")
    write_ppm(p, img)
    back = read_ppm(p)
    # the codec truncates like the reference (image.h:65-67)
    want = quantize(img).astype(np.float32) / 255.0
    np.testing.assert_allclose(back, want, atol=1e-7)


def test_ppm_reads_reference_goldens(ref_paths):
    g = read_ppm(f"{ref_paths['renders']}/baseline_1.ppm")
    assert g.shape == (512, 512, 3)
    assert 0.0 <= g.min() and g.max() <= 1.0


def test_ppm_write_matches_reference_header(tmp_path):
    img = np.zeros((4, 6, 3), np.float32)
    p = str(tmp_path / "h.ppm")
    write_ppm(p, img)
    raw = open(p, "rb").read()
    assert raw.startswith(b"P6\n6 4\n255\n")
    assert len(raw) == len(b"P6\n6 4\n255\n") + 4 * 6 * 3


def test_gif_writer(tmp_path):
    rng = np.random.default_rng(1)
    frames = [rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
              for _ in range(3)]
    p = str(tmp_path / "a.gif")
    write_gif(p, frames, delay_cs=4)
    raw = open(p, "rb").read()
    assert raw.startswith(b"GIF89a")
    assert raw.endswith(b"\x3b")
    # logical screen descriptor dims
    assert int.from_bytes(raw[6:8], "little") == 32
    assert int.from_bytes(raw[8:10], "little") == 24
    # three image separators
    assert raw.count(b"\x2c\x00\x00\x00\x00") >= 3
