"""A/B timings of the render engines on the card, end to end.

    python scripts/ab_engines.py sweep [--n 250] [--size 512] [--spp 16]
    python scripts/ab_engines.py kernel [--ns 50,250,1000]
    python scripts/ab_engines.py crossover [--ns 1000,2500,5000,10000]

``sweep`` times the megakernel's launch geometry (block, tile, warps) on
one generated scene.  ``kernel`` times the megakernel against the plain
XLA wavefront (pallas='off') through ``render_multiscatter`` at 1024^2
spp 64 (512^2 spp 16 from N = 1000 on).  ``crossover`` times the dense
engine against the grid engine at 512^2 spp 16.  Each timed render runs
once to compile and then ``--reps`` times.  Every line is JSON and names
the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("sweep", "kernel", "crossover"))
    ap.add_argument("--n", type=int, default=250)
    ap.add_argument("--ns", default="")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--diameter", default="",
                    help="lo,hi Gaussian diameters (default: the "
                         "generator's make_random.py range)")
    args = ap.parse_args()
    smi = card()

    import jax
    import numpy as np
    from gvr.utils import compile_cache
    compile_cache.enable()
    from gvr.cameras import PinholeCamera
    from gvr.config import RenderConfig
    from gvr.scene.scene import parse_gmm
    from gvr.scene.generators import random_gaussian_scene
    from gvr.integrators.multiscatter import render_multiscatter

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: {dev.platform}")
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)

    def emit(**kw):
        print(json.dumps(dict(kw, device=dev.device_kind, card=smi)),
              flush=True)

    def timed(fn):
        fn()                                   # compile + warm
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    if args.mode == "sweep":
        import jax.numpy as jnp
        from gvr.kernels import megatrace as mt
        from gvr.integrators.multiscatter import (static_lights_of,
                                                      strat_n, tile_order)
        sc = parse_gmm(random_gaussian_scene(args.n, seed=0))
        w = h = args.size
        cfg = RenderConfig(width=w, height=h, spp=args.spp)
        lp, li, env = static_lights_of(sc)
        cfg_t = (w, h, cfg.spp, strat_n(cfg.spp), cfg.seed,
                 cfg.solver_iters, cfg.min_scatter, cfg.rr_cap,
                 cfg.rr_tail_after, cfg.rr_cap_tail, cfg.max_bounces)
        ids = jnp.asarray(tile_order(w, h))
        cv = mt.camera_vector(cam)
        for block, tile, warps in ((128, 8, 4), (128, 8, 8), (256, 8, 8),
                                   (128, 4, 4), (64, 8, 2), (256, 4, 8)):
            tab = mt.pack_table(sc.medium, tile)

            def run():
                return np.asarray(mt.mega_call(
                    cv, tab, ids, cfg_t, lp, li, env, pinhole=True,
                    block=block, tile=tile, num_warps=warps))
            try:
                s = timed(run)
            except Exception as e:            # report and go on
                emit(mode="sweep", block=block, tile=tile, warps=warps,
                     error=repr(e)[:300])
                continue
            emit(mode="sweep", n=args.n, size=w, spp=args.spp, block=block,
                 tile=tile, warps=warps, seconds=s,
                 mpaths_per_s=w * h * args.spp / s / 1e6)
        return

    ns = [int(v) for v in args.ns.split(",")] if args.ns else (
        [50, 250, 1000] if args.mode == "kernel" else
        [1000, 2500, 5000, 10000])
    for n in ns:
        # the reference's fixture generator (make_random.py defaults)
        kw = {"diameter": tuple(float(v) for v in args.diameter.split(
            ","))} if args.diameter else {}
        sc = parse_gmm(random_gaussian_scene(n, seed=0, **kw))
        size, spp = (1024, 64) if (args.mode == "kernel" and n < 1000) \
            else (512, 16)
        base = RenderConfig(width=size, height=size, spp=spp)
        arms = (("mega", base.replace(pallas="on", engine="dense")),
                ("xla", base.replace(pallas="off", engine="dense"))) \
            if args.mode == "kernel" else (
            ("dense", base.replace(engine="dense")),
            ("grid", base.replace(engine="grid")))
        for name, cfg in arms:
            s = timed(lambda: render_multiscatter(sc, cam, cfg))
            emit(mode=args.mode, n=n, size=size, spp=spp, arm=name,
                 diameter=args.diameter or "default", seconds=s,
                 mpaths_per_s=size * size * spp / s / 1e6)


if __name__ == "__main__":
    main()
