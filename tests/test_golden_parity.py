"""Golden-render parity tests against the reference's checked-in PPMs
(SURVEY §4.2) at reduced resolution for CI speed.

Full-resolution (512x512) parity for every usable golden is measured by
``scripts/parity_report.py`` and recorded in ``PARITY.md`` — this file keeps
the same comparisons continuously verified at CI scale.

Scene <-> golden pairing (verified by matching means and probes):
  * baseline_N / *_rand_baseline  <- RayMarchingGaussians (deterministic)
  * *_ss / *_freeflight           <- FreeFlightGaussians (single scatter MC)
  * *_ms / 250_rand_*_big         <- MultiScatterGaussians (the _big suffix
                                     is the solver ablation set)
  * the 2_gaussian family (baseline_2, 2_gaussian_ref, 2g_freeflight) does
    NOT match the checked-in 2_gaussian.txt (verified with a float64 oracle
    and a light-intensity sweep: the mismatch is structural, not light
    scaling) — excluded here and documented in PARITY.md.

MC comparisons quantize our float render through the reference's truncating
PPM clamp first (io/ppm.quantize): the goldens are 8-bit, and truncation
biases means by -0.5/255 ~= -0.002, which would otherwise read as estimator
bias.  Mean deltas are the robust MC metric (chaotic path divergence makes
max-abs meaningless, see CLAUDE.md); PSNR floors catch structural breakage.
"""

import math

import numpy as np

from gvr.scene.scene import load_gmm
from gvr.cameras import PinholeCamera
from gvr.config import RenderConfig, Solver
from gvr.integrators.raymarch import (render_raymarch_gaussians,
                                          render_raymarch_spheres)
from gvr.integrators.freeflight import render_single_scatter
from gvr.integrators.multiscatter import render_multiscatter
from gvr.io.mitsuba import load_mitsuba
from gvr.io.ppm import read_ppm, quantize
from gvr.utils.image import psnr

RES = 128  # goldens are 512; compare against box-downsampled


def downsample(img, res):
    f = img.shape[0] // res
    return img.reshape(res, f, res, f, 3).mean((1, 3))


def gold(ref_paths, name, res=RES):
    return downsample(read_ppm(f"{ref_paths['renders']}/{name}.ppm"), res)


def ppm_quantized(img):
    """Our render through the reference's truncating 8-bit clamp."""
    return quantize(np.asarray(img)).astype(np.float32) / 255.0


CAM = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)


# ---------------------------------------------------------------------------
# deterministic marchers: direct PSNR
# ---------------------------------------------------------------------------

def test_gaussian_marcher_vs_baseline_1(ref_paths):
    sc = load_gmm(f"{ref_paths['gaussians']}/1_gaussian.txt")
    cfg = RenderConfig(width=RES, height=RES, env_samples=4)
    img = render_raymarch_gaussians(sc, CAM, cfg)
    p = psnr(np.clip(img, 0, 1), gold(ref_paths, "baseline_1"))
    assert p > 40.0, p


def test_gaussian_marcher_vs_baseline_7(ref_paths):
    # 64^2: the marcher is O(steps * N * env) and CPU CI time matters;
    # 512^2 parity for this and 50/250_rand_baseline lives in PARITY.md
    res = 64
    sc = load_gmm(f"{ref_paths['gaussians']}/many_gaussians.txt")
    cfg = RenderConfig(width=res, height=res, env_samples=4)
    img = render_raymarch_gaussians(sc, CAM, cfg)
    p = psnr(np.clip(img, 0, 1), gold(ref_paths, "baseline_7", res))
    assert p > 38.0, p


def test_sphere_marcher_vs_env_test_orthographic(ref_paths):
    scene, camera, w, h = load_mitsuba(
        f"{ref_paths['root']}/tests/env_one_sphere_test_ortho.xml")
    cfg = RenderConfig(width=RES, height=RES, env_samples=4)
    img = render_raymarch_spheres(scene, camera, cfg)
    p = psnr(np.clip(img, 0, 1),
             gold(ref_paths, "env_test_orthographic"))
    assert p > 35.0, p


# ---------------------------------------------------------------------------
# MC integrators: quantized mean-delta + PSNR floor
# ---------------------------------------------------------------------------

def test_single_scatter_vs_7g_freeflight(ref_paths):
    sc = load_gmm(f"{ref_paths['gaussians']}/many_gaussians.txt")
    cfg = RenderConfig(width=RES, height=RES, spp=36, pallas="off")
    img = ppm_quantized(render_single_scatter(sc, CAM, cfg))
    g = gold(ref_paths, "7g_freeflight")
    assert abs(img.mean() - g.mean()) < 0.008, (img.mean(), g.mean())
    assert psnr(img, g) > 25.0


def test_single_scatter_vs_50_rand_ss(ref_paths):
    sc = load_gmm(f"{ref_paths['gaussians']}/50_random.txt")
    cfg = RenderConfig(width=RES, height=RES, spp=32, pallas="off")
    img = ppm_quantized(render_single_scatter(sc, CAM, cfg))
    g = gold(ref_paths, "50_rand_ss")
    assert abs(img.mean() - g.mean()) < 0.008, (img.mean(), g.mean())
    assert psnr(img, g) > 23.0


def test_multiscatter_vs_50_rand_ms(ref_paths):
    sc = load_gmm(f"{ref_paths['gaussians']}/50_random.txt")
    cfg = RenderConfig(width=RES, height=RES, spp=16, pallas="off")
    img = ppm_quantized(render_multiscatter(sc, CAM, cfg))
    g = gold(ref_paths, "50_rand_ms")
    assert abs(img.mean() - g.mean()) < 0.010, (img.mean(), g.mean())
    assert psnr(img, g) > 20.0  # spp16-noise-limited floor


def test_solver_ablation_vs_250_big_goldens(ref_paths):
    """The reference's distance-solver ablation (SURVEY §4.2):
    newton/bisection agree with their goldens; the uniform solver's known
    over-brightness bias (golden: +0.013 over newton) is reproduced."""
    res = 64
    sc = load_gmm(f"{ref_paths['gaussians']}/250_random.txt")
    means = {}
    for name, solver in [("newton", Solver.NEWTON),
                         ("bisection", Solver.BISECTION),
                         ("uniform", Solver.UNIFORM)]:
        cfg = RenderConfig(width=res, height=res, spp=9, pallas="off",
                           solver=solver, candidate_k=32)
        img = ppm_quantized(render_multiscatter(sc, CAM, cfg))
        g = gold(ref_paths, f"250_rand_{name}_big", res)
        means[name] = img.mean()
        assert abs(img.mean() - g.mean()) < 0.012, \
            (name, img.mean(), g.mean())
    bias = means["uniform"] - means["newton"]
    assert 0.004 < bias < 0.03, means


def test_single_scatter_vs_250_rand_ss(ref_paths):
    res = 64
    sc = load_gmm(f"{ref_paths['gaussians']}/250_random.txt")
    cfg = RenderConfig(width=res, height=res, spp=16, pallas="off",
                       candidate_k=32)
    img = ppm_quantized(render_single_scatter(sc, CAM, cfg))
    g = gold(ref_paths, "250_rand_ss", res)
    assert abs(img.mean() - g.mean()) < 0.010, (img.mean(), g.mean())
    assert psnr(img, g) > 19.0
