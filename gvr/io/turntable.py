"""Turntable animation (reference MAKE_GIF mode, tests/main.cpp:77-115).

120 frames orbiting the lookat point at radius 6, height 1, orthographic
camera, analytic-transmittance ray marcher, 30 fps GIF.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

from gvr.config import RenderConfig
from gvr.scene.scene import Scene
from gvr.cameras import OrthographicCamera
from gvr.integrators.raymarch import (render_raymarch_gaussians,
                                           render_raymarch_spheres)
from gvr.integrators.multiscatter import render_multiscatter
from gvr.scene.gaussians import GaussianMixture
from gvr.io.gif import write_gif


def render_turntable(scene: Scene, out_path: str,
                     cfg: RenderConfig = RenderConfig(),
                     lookat=(0.0, 1.0, 0.0), radius: float = 6.0,
                     height: float = 1.0, num_frames: int = 120,
                     fps: float = 30.0, integrator: str = "raymarch",
                     progress: Optional[Callable] = print) -> None:
    lookat = np.asarray(lookat, np.float32)
    frames = []
    for frame in range(num_frames):
        angle = 2.0 * math.pi * frame / num_frames
        pos = lookat + np.array([radius * math.sin(angle), height,
                                 radius * math.cos(angle)], np.float32)
        cam = OrthographicCamera.create(pos, lookat)
        if integrator == "raymarch":
            # medium dispatch like cli.cmd_render — sphere scenes would
            # crash in the gaussian marcher (missing inv_cov/norm fields)
            is_gmm = isinstance(scene.medium, GaussianMixture)
            img = (render_raymarch_gaussians if is_gmm
                   else render_raymarch_spheres)(scene, cam, cfg)
        elif integrator == "multiscatter":
            img = render_multiscatter(scene, cam, cfg)
        else:
            raise ValueError(f"unknown turntable integrator "
                             f"{integrator!r} (use 'raymarch' or "
                             f"'multiscatter')")
        frames.append(img)
        if progress:
            progress(f"Frame {frame + 1} / {num_frames} complete.")
    write_gif(out_path, frames, delay_cs=max(1, round(100.0 / fps)))
