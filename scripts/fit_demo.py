"""End-to-end inverse-rendering demo (BASELINE config #5).

Renders a high-spp target of a scene (default: a generated scene of
``--n`` Gaussians), perturbs the Gaussian parameters, fits them back with
the autodiff optimizer, reports PSNR before/after, and writes a turntable
GIF of the fitted scene.

    python scripts/fit_demo.py [--scene FILE | --n 50] [--iters 300]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import dataclasses
import json
import math
import time

import numpy as np


def main():
    from gvr.utils.compile_cache import enable as _cc
    _cc()

    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="",
                    help="scene file (default: generated, see --n)")
    ap.add_argument("--n", type=int, default=50,
                    help="Gaussians of the generated scene")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--eval-spp", dest="eval_spp", type=int, default=0,
                    help="spp for the target/initial/final comparison "
                         "renders (default 4x --spp; the reference "
                         "renders its final at 16384 spp)")
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--perturb", type=float, default=0.15)
    ap.add_argument("--bounces", type=int, default=8,
                    help="differentiable-estimator bounce count; thick "
                         "scenes need enough bounces that the estimator "
                         "is unbiased vs the full-transport target")
    ap.add_argument("--rr-after", dest="rr_after", type=int, default=4)
    ap.add_argument("--candidate-k", dest="candidate_k", type=int,
                    default=0,
                    help="compact the differentiable solver to the k "
                         "nearest-entering Gaussians per ray (the big-N "
                         "scaling lever; overflow fraction is logged)")
    ap.add_argument("--batch", type=int, default=4096,
                    help="pixels per optimizer step")
    ap.add_argument("--out", default="chiprun_out/fit_demo")
    ap.add_argument("--gif", action="store_true")
    ap.add_argument("--interrupt-at", dest="interrupt_at", type=int,
                    default=0,
                    help="simulate a mid-run failure: stop the fit at this "
                         "iteration, then resume from the written ckpt.npz "
                         "to --iters — exercises checkpoint/resume on the "
                         "real workload, not just the unit test")
    args = ap.parse_args()

    import jax.numpy as jnp
    from gvr.scene.scene import load_gmm
    from gvr.scene.gaussians import GaussianMixture
    from gvr.cameras import PinholeCamera
    from gvr.config import RenderConfig, FitConfig
    from gvr.integrators.multiscatter import render_multiscatter
    from gvr.inverse.fit import fit_gaussians
    from gvr.io.ppm import write_ppm
    from gvr.utils.image import psnr

    os.makedirs(args.out, exist_ok=True)
    if args.scene:
        scene_true = load_gmm(args.scene)
    else:
        from gvr.scene.scene import parse_gmm
        from gvr.scene.generators import random_gaussian_scene
        scene_true = parse_gmm(random_gaussian_scene(
            args.n, seed=0, diameter=(0.1, 0.4)))
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
    rc = RenderConfig(width=args.size, height=args.size,
                      spp=args.eval_spp or 4 * args.spp)

    print("rendering target...")
    target = render_multiscatter(scene_true, cam, rc)
    write_ppm(f"{args.out}/target.ppm", target)

    rng = np.random.default_rng(0)
    p = np.asarray(scene_true.medium.pack_parameters()).copy()
    p += rng.normal(0, args.perturb, p.shape).astype(np.float32)
    scene_init = scene_true.with_medium(
        GaussianMixture.from_parameters(jnp.asarray(p)))

    init_img = render_multiscatter(scene_init, cam, rc)
    write_ppm(f"{args.out}/initial.ppm", init_img)
    psnr0 = psnr(np.clip(init_img, 0, 1), np.clip(target, 0, 1))
    print(f"initial PSNR vs target: {psnr0:.2f} dB")

    cfg = FitConfig(max_iters=args.iters, lr=args.lr, save_every=25,
                    checkpoint_every=50, out_dir=args.out)

    # PSNR trajectory (VERDICT r4 #7): evaluate the in-flight scene
    # against the target every save_every iterations at a modest spp and
    # append one JSONL row per eval — the committed loss curve.
    traj_path = f"{args.out}/fit_log.jsonl"
    traj = open(traj_path, "w")
    rc_traj = RenderConfig(width=args.size, height=args.size, spp=32)
    t0 = time.time()

    def log(msg):
        print(msg, flush=True)
        traj.write(json.dumps({"log": msg,
                               "elapsed": round(time.time() - t0, 2)})
                   + "\n")
        traj.flush()

    def snapshot(it, scene_now):
        img = np.asarray(render_multiscatter(scene_now, cam, rc_traj))
        p = float(psnr(np.clip(img, 0, 1), np.clip(np.asarray(target), 0, 1)))
        traj.write(json.dumps({"iter": it, "psnr_vs_target": round(p, 3),
                               "elapsed": round(time.time() - t0, 2)})
                   + "\n")
        traj.flush()
        print(f"[traj] iter {it} PSNR {p:.2f} dB", flush=True)

    kw = dict(batch_pixels=args.batch, n_bounces=args.bounces,
              spp=args.spp, rr_after=args.rr_after,
              candidate_k=args.candidate_k, log=log,
              save_snapshot=snapshot)
    if args.interrupt_at:
        cfg1 = dataclasses.replace(cfg, max_iters=args.interrupt_at)
        fit_gaussians(scene_init, cam, target, cfg1, **kw)
        print(f"--- simulated interruption at iter {args.interrupt_at}; "
              f"resuming from {args.out}/ckpt.npz ---", flush=True)
        fitted = fit_gaussians(scene_init, cam, target, cfg,
                               resume=f"{args.out}/ckpt.npz", **kw)
    else:
        fitted = fit_gaussians(scene_init, cam, target, cfg, **kw)
    fit_time = time.time() - t0
    print(f"fit time: {fit_time:.1f}s "
          f"({1000 * fit_time / max(args.iters, 1):.0f} ms/iter "
          f"incl trajectory evals)")

    final_img = render_multiscatter(fitted, cam, rc)
    write_ppm(f"{args.out}/final.ppm", final_img)
    psnr1 = psnr(np.clip(final_img, 0, 1), np.clip(target, 0, 1))
    print(f"final PSNR vs target: {psnr1:.2f} dB (was {psnr0:.2f})")

    if args.gif:
        from gvr.io.turntable import render_turntable
        render_turntable(
            fitted, f"{args.out}/turntable.gif",
            RenderConfig(width=args.size, height=args.size, env_samples=8),
            num_frames=24)
        print(f"wrote {args.out}/turntable.gif")


if __name__ == "__main__":
    main()
