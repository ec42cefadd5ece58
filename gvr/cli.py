"""Command-line driver: render / animate / fit.

The runtime equivalent of the reference's compile-time-configured
``tests/main.cpp`` (mode #defines at main.cpp:11-12, scene/camera/integrator
edits at :25-42).  Defaults mirror the reference driver: 512x512, camera at
(0,1,6) looking at (0,1,0), FOV pi/4, 256 spp, MultiScatter.

    python -m gvr.cli render scenes/gaussians/2g_altered.txt -o out.ppm
    python -m gvr.cli animate scene.txt -o anim.gif
    python -m gvr.cli fit scene.txt --target ref.ppm -o fit_out/
"""

from __future__ import annotations

import argparse
import math
import time


def _add_common(p):
    p.add_argument("scene", help="scene text file (GMM or SMM format)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--camera", choices=["pinhole", "orthographic"],
                   default="pinhole")
    p.add_argument("--pos", type=float, nargs=3, default=[0.0, 1.0, 6.0])
    p.add_argument("--lookat", type=float, nargs=3, default=[0.0, 1.0, 0.0])
    p.add_argument("--fov", type=float, default=45.0, help="degrees")
    p.add_argument("--seed", type=int, default=0)


def make_camera(args):
    from gvr.cameras import PinholeCamera, OrthographicCamera
    if args.camera == "pinhole":
        return PinholeCamera.create(args.pos, args.lookat,
                                    math.radians(args.fov))
    return OrthographicCamera.create(args.pos, args.lookat)


def cmd_render(args):
    from gvr.scene.scene import load_scene
    from gvr.scene.gaussians import GaussianMixture
    from gvr.config import RenderConfig, Solver
    from gvr.integrators import (
        render_multiscatter, render_single_scatter, render_raymarch_gaussians,
        render_raymarch_spheres, render_hit_mask)
    from gvr.io.ppm import write_ppm

    scene = load_scene(args.scene)
    camera = make_camera(args)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       step_size=args.step_size, env_samples=args.env_samples,
                       solver=Solver(args.solver), seed=args.seed,
                       pallas=args.pallas)
    is_gmm = isinstance(scene.medium, GaussianMixture)
    # voxel media (.npz) have no analytic transmittance: only the
    # medium-agnostic pure ray-marcher can render them — route there
    # instead of surfacing an AttributeError from a GMM-only path
    from gvr.scene.voxels import VoxelGrid
    if isinstance(scene.medium, VoxelGrid):
        if args.integrator not in ("raymarch", "pureraymarch"):
            raise SystemExit(
                "voxel media render with the medium-agnostic marcher only; "
                "use --integrator pureraymarch (or raymarch)")
        args.integrator = "pureraymarch"

    cfg = cfg.replace(engine=args.engine)
    stats = None
    if args.stats or args.trace:
        from gvr.utils.profiling import RenderStats
        stats = RenderStats()

    t0 = time.time()
    if args.integrator == "multiscatter":
        img = render_multiscatter(scene, camera, cfg, progress=args.verbose,
                                  stats=stats, trace_dir=args.trace)
    elif args.integrator == "singlescatter":
        img = render_single_scatter(scene, camera, cfg)
    elif args.integrator == "raymarch":
        img = (render_raymarch_gaussians if is_gmm
               else render_raymarch_spheres)(scene, camera, cfg)
    elif args.integrator == "pureraymarch":
        from gvr.integrators import render_pure_raymarch
        img = render_pure_raymarch(scene, camera, cfg)
    elif args.integrator == "hitmask":
        img = render_hit_mask(scene, camera, cfg)
    else:
        raise SystemExit(f"unknown integrator {args.integrator}")
    print(f"Render time: {time.time() - t0:.3f} seconds")
    if stats is not None and not stats.spans:
        print("[render] note: --stats/--trace are only instrumented for "
              "--integrator multiscatter")
    if stats is not None and stats.spans:
        print(stats.report())
    write_ppm(args.output, img)
    print(f"wrote {args.output}")


def cmd_animate(args):
    from gvr.scene.scene import load_scene
    from gvr.config import RenderConfig
    from gvr.io.turntable import render_turntable

    if (args.camera, tuple(args.pos), args.fov) != \
            ("pinhole", (0.0, 1.0, 6.0), 45.0):
        print("[animate] note: --camera/--pos/--fov are ignored; the "
              "turntable uses the reference orbit camera "
              "(orthographic, tests/main.cpp:95-103)")

    scene = load_scene(args.scene)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       step_size=args.step_size, env_samples=args.env_samples,
                       seed=args.seed)
    t0 = time.time()
    render_turntable(scene, args.output, cfg, lookat=tuple(args.lookat),
                     radius=args.radius, num_frames=args.frames,
                     fps=args.fps, integrator=args.integrator)
    print(f"GIF saved ({time.time() - t0:.1f}s): {args.output}")


def cmd_fit(args):
    from gvr.scene.scene import load_scene
    from gvr.config import FitConfig
    from gvr.inverse.fit import fit_gaussians
    from gvr.io.ppm import read_ppm, write_ppm
    from gvr.integrators import render_multiscatter
    from gvr.config import RenderConfig

    scene = load_scene(args.scene)
    camera = make_camera(args)
    target = read_ppm(args.target)
    cfg = FitConfig(max_iters=args.iters, lr=args.lr,
                    save_every=args.save_every, out_dir=args.output,
                    seed=args.seed)
    if (args.width, args.height) != (512, 512):
        print("[fit] note: --width/--height are ignored; the fit "
              f"resolution comes from the target image "
              f"({target.shape[1]}x{target.shape[0]})")

    def snapshot(it, sc):
        rc = RenderConfig(width=target.shape[1], height=target.shape[0],
                          spp=args.spp)
        img = render_multiscatter(sc, camera, rc)
        write_ppm(f"{args.output}/iter_{it:04d}.ppm", img)

    t0 = time.time()
    fitted = fit_gaussians(scene, camera, target, cfg,
                           batch_pixels=args.batch_pixels,
                           n_bounces=args.bounces,
                           save_snapshot=snapshot if args.snapshots else None)
    print(f"Inverse optimization time: {time.time() - t0:.1f} seconds")
    # final high-spp render (inverse_integrator.h:230-233)
    rc = RenderConfig(width=target.shape[1], height=target.shape[0],
                      spp=args.final_spp)
    img = render_multiscatter(fitted, camera, rc)
    write_ppm(f"{args.output}/final.ppm", img)
    print(f"wrote {args.output}/final.ppm")


def main(argv=None):
    from gvr.utils.compile_cache import enable as _cc
    _cc()

    ap = argparse.ArgumentParser(prog="gvr",
                                 description="Gaussian volume renderer")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="forward render to PPM")
    _add_common(pr)
    pr.add_argument("-o", "--output", default="output.ppm")
    pr.add_argument("--integrator", default="multiscatter",
                    choices=["multiscatter", "singlescatter", "raymarch",
                             "pureraymarch", "hitmask"])
    pr.add_argument("--spp", type=int, default=256)
    pr.add_argument("--step-size", dest="step_size", type=float, default=0.01)
    pr.add_argument("--env-samples", dest="env_samples", type=int, default=20)
    pr.add_argument("--solver", default="analytic_newton",
                    choices=["newton", "bisection", "analytic_newton",
                             "analytic_bisection", "uniform"])
    pr.add_argument("--pallas", default="auto",
                    choices=["auto", "on", "off", "interpret"])
    pr.add_argument("--engine", default="auto",
                    choices=["auto", "dense", "grid"],
                    help="multiscatter engine (grid = uniform-grid "
                         "regular tracking for big Gaussian sets)")
    pr.add_argument("--stats", action="store_true",
                    help="print per-chunk span report after rendering")
    pr.add_argument("--trace", default=None, metavar="DIR",
                    help="write a jax.profiler trace to DIR")
    pr.add_argument("-v", "--verbose", action="store_true")
    pr.set_defaults(fn=cmd_render)

    pa = sub.add_parser("animate", help="turntable GIF")
    _add_common(pa)
    pa.add_argument("-o", "--output", default="animation.gif")
    pa.add_argument("--integrator", default="raymarch",
                    choices=["raymarch", "multiscatter"])
    pa.add_argument("--frames", type=int, default=120)
    pa.add_argument("--fps", type=float, default=30.0)
    pa.add_argument("--radius", type=float, default=6.0)
    pa.add_argument("--spp", type=int, default=16)
    pa.add_argument("--step-size", dest="step_size", type=float, default=0.01)
    pa.add_argument("--env-samples", dest="env_samples", type=int, default=20)
    pa.set_defaults(fn=cmd_animate)

    pf = sub.add_parser("fit", help="fit Gaussians to a target image")
    _add_common(pf)
    pf.add_argument("--target", required=True, help="target PPM image")
    pf.add_argument("-o", "--output", default="./fit_output")
    pf.add_argument("--iters", type=int, default=1000)
    pf.add_argument("--lr", type=float, default=1e-2)
    pf.add_argument("--save-every", dest="save_every", type=int, default=25)
    pf.add_argument("--batch-pixels", dest="batch_pixels", type=int,
                    default=4096)
    pf.add_argument("--bounces", type=int, default=4)
    pf.add_argument("--spp", type=int, default=16)
    pf.add_argument("--final-spp", dest="final_spp", type=int, default=1024)
    pf.add_argument("--snapshots", action="store_true")
    pf.set_defaults(fn=cmd_fit)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
