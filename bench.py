"""Benchmark: Mrays/s of the flagship multi-scatter path tracer.

Renders a generated 250-Gaussian scene (the reference's make_random.py
distribution, fixed seed) at 1024^2 spp 64 through ``render_multiscatter``
and prints ONE JSON line: {"metric", "value", "unit", "device"}.

Ray accounting: every traced ray segment counts — primary/bounce extension
rays plus one NEE shadow ray per scatter event (both cost a full
transmittance evaluation), from ``utils/profiling.path_statistics``.

    BENCH_N=250 BENCH_SIZE=1024 BENCH_SPP=64 python bench.py
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np

N = int(os.environ.get("BENCH_N", "250"))
SIZE = int(os.environ.get("BENCH_SIZE", "1024"))
SPP = int(os.environ.get("BENCH_SPP", "64"))


def main():
    from gvr.utils.compile_cache import enable
    enable()

    import jax
    from gvr.scene.scene import parse_gmm
    from gvr.scene.generators import random_gaussian_scene
    from gvr.cameras import PinholeCamera
    from gvr.config import RenderConfig
    from gvr.integrators.multiscatter import render_multiscatter
    from gvr.utils.profiling import path_statistics

    dev = jax.devices()[0]
    scene = parse_gmm(random_gaussian_scene(N, seed=0))
    camera = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=SPP)

    rays_per_path = path_statistics(scene, camera, cfg)["rays_per_path"]
    # warm up with the IDENTICAL config: cfg is a static jit argument, so a
    # cheaper warm config would compile a different program
    render_multiscatter(scene, camera, cfg)
    t0 = time.perf_counter()
    img = render_multiscatter(scene, camera, cfg)
    dt = time.perf_counter() - t0
    assert np.isfinite(img).all()

    mrays = SIZE * SIZE * SPP * rays_per_path / dt / 1e6
    print(json.dumps({
        "metric": f"Mrays/s multiscatter random_{N} @{SIZE}x{SIZE} "
                  f"spp{SPP} ({rays_per_path:.3f} rays/path)",
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
