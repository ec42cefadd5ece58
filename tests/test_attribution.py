"""Per-pixel Gaussian attribution tests (RECORD_PIXEL_GAUSSIANS
counterpart)."""

import math

import numpy as np

from gvr.scene.scene import parse_gmm
from gvr.cameras import PinholeCamera
from gvr.config import RenderConfig
from gvr.inverse.attribution import pixel_gaussians, gaussian_pixel_counts

CAM = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)

# two spatially separated gaussians: left (x=-0.6) and right (x=+0.6)
SCENE = ("g -0.6 1 0  0.02 0 0  0.02 0 0.02  2.0 0.5\n"
         "g  0.6 1 0  0.02 0 0  0.02 0 0.02  2.0 0.5\n")


def test_pixel_attribution_separates_gaussians():
    sc = parse_gmm(SCENE)
    cfg = RenderConfig(width=32, height=32)
    idx, cnt = pixel_gaussians(sc, CAM, cfg, k=4)
    idx = idx.reshape(32, 32, -1)   # k clamps to N=2
    cnt = cnt.reshape(32, 32)
    # empirically (matches the reference camera): world -x -> image left
    left_half = idx[:, :16]      # image left = gaussian 0 (x = -0.6)
    right_half = idx[:, 16:]
    assert (left_half == 1).sum() == 0
    assert (right_half == 0).sum() == 0
    assert (left_half == 0).sum() > 0
    assert (right_half == 1).sum() > 0
    assert cnt.max() >= 1
    # counts: both gaussians should cover a similar number of pixels
    counts = gaussian_pixel_counts(sc, CAM, cfg)
    assert counts.shape == (2,)
    assert counts.min() > 0
    assert abs(int(counts[0]) - int(counts[1])) < 0.2 * counts.max()


def test_multibounce_attribution_reaches_hidden_gaussian():
    """A Gaussian placed BEHIND the camera is unreachable by primary rays
    but reachable by scattered (secondary-bounce) rays; the multi-bounce
    path recording (integrator.h:616-644) must include it, the primary-ray
    footprint must not."""
    from gvr.inverse.attribution import pixel_gaussians_paths

    # 0: dense gaussian in front of the camera (almost every path scatters)
    # 1: fat gaussian behind the camera (z=9 > camera z=6; rays go -z)
    sc = parse_gmm("g 0 1 0  0.09 0 0  0.09 0 0.09  20.0 0.9\n"
                   "g 0 1 9  1.0 0 0   1.0 0 1.0    1.0 0.5\n")
    cfg = RenderConfig(width=8, height=8, spp=16)

    idx_primary, _ = pixel_gaussians(sc, CAM, cfg, k=2)
    assert (idx_primary == 1).sum() == 0, "primary rays cannot reach g1"

    idx_paths, cnt = pixel_gaussians_paths(sc, CAM, cfg, k=2, spp=16)
    assert (idx_paths == 0).sum() > 0
    assert (idx_paths == 1).sum() > 0, \
        "secondary-bounce gaussian missing from the path footprint"
    assert cnt.max() <= 2
