"""End-to-end check of the render and fit paths on one NVIDIA GPU.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the sharded phase only

Phases (one line each on stdout; the last line is one JSON object):

1. device: the card's name and power limit (``nvidia-smi``, read before
   this process imports JAX) and ``jax.devices()[0]``; anything but a GPU
   backend is refused.
2. compile: the megakernel's render chunk at the headline widths, with
   ``compiled.memory_analysis()``.
3. render / fit: the 250-Gaussian 1024^2 spp 64 headline, the reference
   driver's thick 2-Gaussian scene at 512^2 spp 256, a 10k-Gaussian
   tiny-support scene at 512^2 spp 16 through engine='auto' (the grid
   engine), and Adam steps of ``fit_gaussians`` on a 50-Gaussian scene.
   Seconds are wall time of a warm call ending in a host fetch; Mrays/s
   counts extension rays plus one NEE shadow ray per scatter
   (``utils/profiling.path_statistics``).
4. check: each engine on the card against the plain XLA dense reference
   (pallas='off') under highest matmul precision: relative error of the
   image mean, median per-pixel |diff|, share of pixels with |diff| > 1e-2.
5. gpu-tests: the tests marked ``gpu``, in a child process that holds the
   card before this process touches JAX.

``--four-cards`` renders the 250-Gaussian frame on four cards and on one
card in one process — through the megakernel, bitwise equal (the RNG is
keyed by pixel, sample and bounce), and through the engine 'auto' picks
(the grid), within the agreement bounds — and compares one data-parallel
fit step's gradients.

Every scene is generated from a seed.  Any failed phase exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# image agreement bounds (per-pixel values diverge chaotically where one
# scatter decision flips, so the bounds are on means and medians)
MEAN_REL = 1e-3
MEDIAN_ABS = 1e-4
FRAC_OVER = 0.01


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def read_card() -> str:
    """``name, power.limit`` of the first card, from a child process
    that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi lists no GPU")
    return out[0]


def run_gpu_tests() -> None:
    """The ``gpu``-marked tests, in a child that exits before the parent
    first touches JAX (one JAX process reserves most of the card)."""
    env = dict(os.environ, GVR_TEST_GPU="1")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", os.path.join(ROOT, "tests")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    tail = r.stdout.strip().splitlines()[-1:] or ["(no output)"]
    log("gpu-tests", rc=r.returncode, summary=repr(tail[0]))
    if r.returncode != 0:
        sys.stdout.write(r.stdout[-4000:] + r.stderr[-2000:])
        raise SystemExit(1)


def agreement(img, ref):
    import numpy as np
    d = np.abs(np.asarray(img, np.float64) - np.asarray(ref, np.float64))
    mean_rel = abs(float(img.mean()) - float(ref.mean())) / max(
        abs(float(ref.mean())), 1e-12)
    med = float(np.median(d))
    frac = float((d > 1e-2).mean())
    ok = (bool(np.isfinite(img).all()) and mean_rel <= MEAN_REL
          and med <= MEDIAN_ABS and frac <= FRAC_OVER)
    return ok, mean_rel, med, frac


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="render and fit-step comparison on four cards "
                         "against one card, and no other phase")
    args = ap.parse_args()

    card = read_card()
    if not args.four_cards:
        run_gpu_tests()

    import jax
    dev = jax.devices()[0]
    log("device", platform=dev.platform, kind=repr(dev.device_kind),
        count=len(jax.devices()))
    if dev.platform != "gpu":
        log("device", error="no GPU backend")
        return 1
    print(card, flush=True)

    sys.path.insert(0, ROOT)
    from gvr.utils import compile_cache
    log("device", compile_cache=compile_cache.enable())

    if args.four_cards:
        if len(jax.devices()) < 4:
            log("four-cards", error=f"{len(jax.devices())} devices")
            return 1
        ok = four_cards(card)
    else:
        ok = one_card(card)
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": 4 if args.four_cards else len(jax.devices())}}))
    return 0


def _scenes():
    from gvr.scene.scene import parse_gmm
    from gvr.scene.generators import random_gaussian_scene
    from gvr.cameras import PinholeCamera
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], 0.25 * math.pi)
    s250 = parse_gmm(random_gaussian_scene(250, seed=0))
    # the reference driver's default: a thick 2-Gaussian scene
    s2 = parse_gmm(
        "l 0 4 0 1 1 1\n"
        "g 0 0.7 0.3 0.03778 0 0 0.0811 0 0.0336 4.5 1.0\n"
        "g 0 1.3 -0.3 0.1511 0 0 0.03778 0 0.0336 1.5 0.0\n")
    s10k = parse_gmm(random_gaussian_scene(10_000, seed=0))
    return cam, s250, s2, s10k


def one_card(card: str) -> bool:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gvr.config import RenderConfig, Solver
    from gvr.integrators.multiscatter import (
        render_multiscatter, engine_for, kernel_enabled, static_lights_of,
        _wavefront_fn)
    from gvr.utils.profiling import path_statistics

    cam, s250, s2, s10k = _scenes()
    ok = True

    # --- compile: the megakernel render chunk at its real widths ---
    head = RenderConfig(width=1024, height=1024, spp=64)
    if not kernel_enabled(head):
        log("compile", error="megakernel not selected on this backend")
        return False
    ids = jnp.arange(head.ray_chunk, dtype=jnp.int32)
    fn = _wavefront_fn(head, static_lights_of(s250), 1)
    t0 = time.perf_counter()
    compiled = fn.lower(s250, cam, ids).compile()
    log("compile", chunk="mega-250g-1024x1024-spp64",
        rays=head.ray_chunk, seconds=round(time.perf_counter() - t0, 3))
    print(compiled.memory_analysis(), flush=True)

    # --- render and fit phases ---
    def render_phase(name, scene, cfg):
        engine = engine_for(cfg, scene.medium)[0]
        if engine == "dense" and kernel_enabled(cfg):
            engine = "mega"
        t0 = time.perf_counter()
        img = render_multiscatter(scene, cam, cfg)     # compile + warm
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        img = render_multiscatter(scene, cam, cfg)
        sec = time.perf_counter() - t0
        rpp = path_statistics(scene, cam, cfg)["rays_per_path"]
        paths = cfg.width * cfg.height * cfg.spp
        good = bool(np.isfinite(img).all()) and img.shape == (
            cfg.height, cfg.width, 3)
        log("render", name=name, engine=engine, n=scene.medium.n,
            size=f"{cfg.width}x{cfg.height}", spp=cfg.spp,
            first_call_s=round(t_first, 3), seconds=round(sec, 4),
            rays_per_path=round(rpp, 4),
            mrays_per_s=round(paths * rpp / sec / 1e6, 3),
            mean=float(img.mean()), finite=good, card=repr(card))
        return good

    ok &= render_phase("headline-250g", s250, head)
    ok &= render_phase("reference-2g", s2, RenderConfig(
        width=512, height=512, spp=256))
    ok &= render_phase("grid-10k", s10k, RenderConfig(
        width=512, height=512, spp=16))

    ok &= _fit_phase(cam, card)

    # --- correctness: each engine against the XLA dense reference ---
    def check(name, scene, cfg_run, cfg_ref):
        img = render_multiscatter(scene, cam, cfg_run)
        with jax.default_matmul_precision("highest"):
            ref = render_multiscatter(scene, cam, cfg_ref)
        good, mean_rel, med, frac = agreement(img, ref)
        log("check", name=name, mean_rel=f"{mean_rel:.3e}",
            median_abs=f"{med:.3e}", frac_over=f"{frac:.3e}",
            bounds=f"{MEAN_REL}/{MEDIAN_ABS}/{FRAC_OVER}", ok=good)
        return good

    small = RenderConfig(width=256, height=256, spp=16, engine="dense")
    ok &= check("mega-vs-xla-250g", s250, small,
                small.replace(pallas="off"))
    grid_cfg = RenderConfig(width=128, height=128, spp=4)
    if engine_for(grid_cfg, s10k.medium)[0] != "grid":
        log("check", error="engine='auto' did not pick the grid at 10k")
        return False
    # the dense solve's default 12 Newton trips are not converged on
    # thousands of tiny Gaussians (image-mean bias ~1%), so the reference
    # for the grid engine is the dense XLA engine at a converged 48
    ok &= check("grid-vs-dense-10k", s10k, grid_cfg,
                grid_cfg.replace(engine="dense", pallas="off",
                                 solver=Solver.NEWTON, solver_iters=48))
    return bool(ok)


def _fit_phase(cam, card: str) -> bool:
    import numpy as np
    from gvr.config import RenderConfig, FitConfig
    from gvr.scene.scene import parse_gmm
    from gvr.scene.generators import random_gaussian_scene
    from gvr.scene.gaussians import GaussianMixture
    from gvr.integrators.multiscatter import render_multiscatter
    from gvr.inverse.fit import fit_gaussians

    true = parse_gmm(random_gaussian_scene(50, seed=0,
                                           diameter=(0.1, 0.4)))
    target = render_multiscatter(true, cam, RenderConfig(
        width=256, height=256, spp=64))
    p = np.asarray(true.medium.pack_parameters())
    rng = np.random.default_rng(1)
    init = true.with_medium(GaussianMixture.from_parameters(
        p + 0.05 * rng.standard_normal(p.shape).astype(np.float32)))
    stamps = []

    def record(msg):
        stamps.append(time.perf_counter())

    steps, batch, n_bounces, spp = 6, 4096, 4, 2
    cfg = FitConfig(max_iters=steps, save_every=1, checkpoint_every=0,
                    spp=spp, out_dir=os.path.join(OUT, "fit"))
    t0 = time.perf_counter()
    out = fit_gaussians(init, cam, target, cfg, batch_pixels=batch,
                        n_bounces=n_bounces, log=record)
    per_step = (stamps[-1] - stamps[0]) / (len(stamps) - 1)
    # fixed-trip differentiable estimator: an extension and an NEE ray per
    # bounce, two MC buffers of spp samples per pixel
    rays = batch * 2 * spp * 2 * n_bounces
    good = bool(np.isfinite(np.asarray(
        out.medium.pack_parameters())).all()) and len(stamps) == steps
    log("fit", n=50, target="256x256", batch=batch, steps=steps,
        first_step_s=round(stamps[0] - t0, 3),
        seconds_per_step=round(per_step, 4),
        mrays_per_s=round(rays / per_step / 1e6, 3), finite=good,
        card=repr(card))
    return good


def four_cards(card: str) -> bool:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gvr.config import RenderConfig
    from gvr.integrators.multiscatter import render_multiscatter, engine_for
    from gvr.inverse.fit import fit_loss, _pixel_rays
    from gvr.parallel.sharding import make_mesh, sharded_value_and_grad
    from gvr.scene.scene import parse_gmm
    from gvr.scene.generators import random_gaussian_scene

    cam, s250, _, _ = _scenes()
    cfg = RenderConfig(width=1024, height=1024, spp=64)
    ok = True
    # the megakernel traces each ray in its own lane, so any sharding of
    # the pixels gives bitwise the same image; the grid engine's XLA
    # reductions may regroup with the per-card batch shape, so it is held
    # to the image agreement bounds instead
    for engine in ("dense", "auto"):
        c = cfg.replace(engine=engine)
        secs, imgs = {}, {}
        for n in (4, 1):
            render_multiscatter(s250, cam, c, n_shards=n)
            t0 = time.perf_counter()
            imgs[n] = render_multiscatter(s250, cam, c, n_shards=n)
            secs[n] = time.perf_counter() - t0
        same = bool(np.array_equal(imgs[4], imgs[1]))
        agree, mean_rel, med, frac = agreement(imgs[4], imgs[1])
        good = same if engine == "dense" else agree
        log("four-cards", part="render-250g-1024x1024-spp64",
            engine=engine_for(c, s250.medium)[0] + (
                "-mega" if engine == "dense" else ""),
            seconds_4=round(secs[4], 4), seconds_1=round(secs[1], 4),
            bitwise_equal=same,
            max_abs=float(np.abs(imgs[4] - imgs[1]).max()),
            mean_rel=f"{mean_rel:.3e}", median_abs=f"{med:.3e}",
            frac_over=f"{frac:.3e}", ok=good, card=repr(card))
        ok &= good

    scene = parse_gmm(random_gaussian_scene(50, seed=0,
                                            diameter=(0.1, 0.4)))
    params = scene.medium.pack_parameters()
    ids = jnp.asarray(np.random.default_rng(0).integers(
        0, 256 * 256, 4096, dtype=np.int32))
    o, d, rng_ids = _pixel_rays(cam, 256, 256, ids)
    tgt = jnp.full((4096, 3), 0.2, jnp.float32)

    def loss_fn(p, template, o, d, rng_ids, tgt):
        return fit_loss(p, template, o, d, rng_ids, tgt, n_bounces=4,
                        spp=2)

    grads = {}
    for n in (4, 1):
        vg = jax.jit(sharded_value_and_grad(
            loss_fn, make_mesh(jax.devices()[:n])))
        loss, g = vg(params, scene, o, d, rng_ids, tgt)
        grads[n] = (float(loss), np.asarray(g))
    g4, g1 = grads[4][1], grads[1][1]
    rel = float(np.abs(g4 - g1).max() / max(np.abs(g1).max(), 1e-30))
    close = bool(np.allclose(g4, g1, rtol=1e-3, atol=1e-5))
    log("four-cards", part="fit-step-grads-50g", loss_4=grads[4][0],
        loss_1=grads[1][0], max_rel_diff=f"{rel:.3e}", allclose=close,
        card=repr(card))
    return ok and close


if __name__ == "__main__":
    sys.exit(main())
