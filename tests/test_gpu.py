"""Tests that need an NVIDIA GPU (marker ``gpu``): the megakernel as the
card compiles it, against the plain XLA engine.  They skip elsewhere; run
them on the card with ``python chip_smoke.py``."""

import math

import jax
import numpy as np
import pytest

from gvr.cameras import PinholeCamera
from gvr.config import RenderConfig
from gvr.scene.scene import parse_gmm
from gvr.scene.generators import random_gaussian_scene
from gvr.integrators.multiscatter import render_multiscatter, kernel_enabled

pytestmark = pytest.mark.gpu

CAM = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)


def test_auto_selects_megakernel_on_card(gpu):
    assert kernel_enabled(RenderConfig())
    assert kernel_enabled(RenderConfig(pallas="on"))
    assert not kernel_enabled(RenderConfig(pallas="off"))


def test_megakernel_matches_xla_on_card(gpu):
    """Compiled Triton kernel vs the XLA wavefront at full f32 precision:
    same estimator and RNG streams, so images agree in the mean and the
    median pixel (per-pixel values diverge chaotically where a marginal
    scatter decision flips)."""
    sc = parse_gmm(random_gaussian_scene(300, seed=5, diameter=(0.1, 0.4)))
    cfg = RenderConfig(width=64, height=64, spp=9)
    img = render_multiscatter(sc, CAM, cfg.replace(pallas="on",
                                                   engine="dense"))
    with jax.default_matmul_precision("highest"):
        ref = render_multiscatter(sc, CAM, cfg.replace(pallas="off",
                                                       engine="dense"))
    assert np.isfinite(img).all()
    d = np.abs(img - ref)
    assert abs(img.mean() - ref.mean()) <= 1e-3 * ref.mean()
    assert np.median(d) <= 1e-4
    assert (d > 1e-2).mean() <= 0.01
