"""Inverse rendering: fit Gaussian parameters to a target image by autodiff.

Reference: ``StochasticFiniteDiffInverseIntegrator``
(inverse_integrator.h:59-246) — per iteration it runs (1 + 4) full MC renders
with per-pixel Gaussian attribution and estimates gradients by Rademacher
finite differences, then Adam (optimizer.h) on the 11-param/Gaussian codec
(gmm.h:583-674), rebuilding every Gaussian + the BVH per application.

Replacement: the estimator itself is differentiable
(``multiscatter_radiance_diff``: analytic escape + implicit-diff free-flight
sampling), so one render's worth of work yields exact pathwise gradients via
``jax.grad``; Adam is ``optax.adam`` on the identical reparameterization.
Each iteration samples a random minibatch of pixels instead of full frames.
Gradients are ``pmean``-reduced across the device mesh — the framework's one
collective.  Checkpoints (params + opt state + iteration) go to .npz —
capability the reference lacks entirely (SURVEY §5 checkpoint/resume).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec

from gvr.config import FitConfig
from gvr.scene.scene import Scene
from gvr.scene.gaussians import GaussianMixture
from gvr.integrators.multiscatter import multiscatter_radiance_diff
from gvr.parallel.sharding import (
    make_mesh, sharded_value_and_grad, shard_rays)


@dataclasses.dataclass
class FitState:
    params: jnp.ndarray
    opt_state: object
    iteration: int


def _mc_mean(render, sample_ids):
    """Memory-bounded MC mean over the sample axis.

    A plain ``vmap(render)(samples)`` materializes every per-sample
    ``[bounces, rays, N]`` residual for the backward pass at once —
    [8,16,4096,50] f32 temps at spp=16 on the N=50 fit.  A ``lax.scan`` with ``jax.checkpoint`` on the per-sample
    render keeps one sample's residuals live and recomputes the rest in
    the backward sweep: memory is O(1) in spp, FLOPs ~2x forward.
    """
    out = jax.eval_shape(render, sample_ids[0])

    def body(acc, si):
        return acc + jax.checkpoint(render)(si), None

    tot, _ = jax.lax.scan(body, jnp.zeros(out.shape, out.dtype), sample_ids)
    return tot / sample_ids.shape[0]


def fit_loss(params, scene_template: Scene, origin, direction, rng_ids,
             target, n_bounces: int = 4, spp: int = 1, loss: str = "l2_dual",
             seed=0, candidate_k: int = 0, rr_after: int = 0):
    """Loss between the differentiable estimate and target radiance for a
    ray batch.  ``seed`` may be traced (e.g. the iteration index) to refresh
    the MC streams every optimizer step.

    * 'l2_dual' (default): dual-buffer L2 — two independent MC estimates
      x1, x2; gradient of mean((x1-t) sg(x2-t)) is an *unbiased* estimate of
      grad (E[x]-t)^2.  Naive L1/L2 of a noisy estimator is biased toward
      variance reduction (the optimizer learns to dim densities to quiet the
      render rather than match it) — this is the standard fix.
    * 'l1' matches the reference's pixel loss (inverse_integrator.h:20-29);
      'l2' plain — both fine for high-spp/low-noise settings and used by
      the gradient-check tests.
    """
    gmm = GaussianMixture.from_parameters(params)
    scene = scene_template.with_medium(gmm)

    def render(si):
        return multiscatter_radiance_diff(scene, origin, direction, rng_ids,
                                          None, n_bounces=n_bounces,
                                          sample=si, seed=seed,
                                          candidate_k=candidate_k,
                                          rr_after=rr_after)

    if loss == "l2_dual":
        x1 = _mc_mean(render, jnp.arange(spp) * 2)
        x2 = _mc_mean(render, jnp.arange(spp) * 2 + 1)
        e1 = x1 - target
        e2 = x2 - target
        return 0.5 * jnp.mean(e1 * jax.lax.stop_gradient(e2)
                              + jax.lax.stop_gradient(e1) * e2)

    rad = _mc_mean(render, jnp.arange(spp))
    err = rad - target
    if loss == "l2":
        return jnp.mean(err * err)
    if loss != "l1":
        raise ValueError(f"loss must be 'l2_dual', 'l2' or 'l1', "
                         f"got {loss!r}")
    return jnp.mean(jnp.abs(err))


def _pixel_rays(camera, width, height, ids):
    x = ids % width
    y = ids // width
    u = (x.astype(jnp.float32) + 0.5) / width
    v = (y.astype(jnp.float32) + 0.5) / height
    o, d = camera.sample_ray(jnp.stack([u, v], axis=-1))
    return o, d, ids


def fit_gaussians(scene_init: Scene, camera, target_img: np.ndarray,
                  cfg: FitConfig = FitConfig(),
                  batch_pixels: int = 4096,
                  n_bounces: int = 4,
                  spp: Optional[int] = None,
                  mesh=None,
                  log: Callable = print,
                  save_snapshot: Optional[Callable] = None,
                  candidate_k: int = 0,
                  rr_after: int = 0,
                  resume: Optional[str] = None) -> Scene:
    """Run the Adam fit.  Returns the optimized scene.

    target_img: [H,W,3] float.  save_snapshot(iteration, scene) optional.
    spp defaults to cfg.spp (MC gradient samples per pixel per buffer).
    candidate_k > 0 compacts the differentiable solver to the k
    nearest-entering Gaussians per ray (the big-scene scaling lever);
    rr_after > 0 enables Russian roulette from that bounce on.
    resume: path to a ckpt.npz written by this function — restores
    params/opt state and continues from the saved iteration (the
    per-iteration RNG streams are derived from (cfg.seed, it), so the
    resumed run draws the same batches the uninterrupted run would).
    """
    h, w = target_img.shape[:2]
    spp = cfg.spp if spp is None else spp
    params = scene_init.medium.pack_parameters()
    optimizer = optax.adam(cfg.lr)
    opt_state = optimizer.init(params)
    start_iter = 0
    if resume is not None and os.path.exists(resume):
        st = load_checkpoint(resume, optimizer, params)
        params, opt_state = st.params, st.opt_state
        start_iter = st.iteration + 1  # checkpoints hold POST-update state
        log(f"[fit] resumed {resume} at iteration {start_iter}")
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    batch_pixels = shard_rays(batch_pixels, n_dev)
    # the step returns replicated params/state on the mesh; start there too,
    # or the second step's differently-placed inputs recompile the step
    params, opt_state = jax.device_put(
        (params, opt_state), NamedSharding(mesh, PartitionSpec()))
    target_flat = jnp.asarray(target_img.reshape(-1, 3), jnp.float32)

    def loss_fn(p, template, o, d, rng_ids, tgt, seed):
        return fit_loss(p, template, o, d, rng_ids, tgt,
                        n_bounces=n_bounces, spp=spp, seed=seed,
                        candidate_k=candidate_k, rr_after=rr_after)

    vg = sharded_value_and_grad(loss_fn, mesh)

    @jax.jit
    def step(p, opt_state, template, o, d, rng_ids, tgt, seed):
        loss, grads = vg(p, template, o, d, rng_ids, tgt, seed)
        updates, opt_state = optimizer.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    if candidate_k > 0:
        # bias-honesty probe: fraction of live (ray, bounce) lanes whose
        # hit set exceeded candidate_k (dropped candidates bias gradients;
        # mirrors the forward path's round-2 overflow honesty)
        @jax.jit
        def overflow_probe(p, template, o, d, rng_ids, seed):
            gmm = GaussianMixture.from_parameters(p)
            _, counts = multiscatter_radiance_diff(
                template.with_medium(gmm), o, d, rng_ids, None,
                n_bounces=n_bounces, seed=seed, candidate_k=candidate_k,
                rr_after=rr_after, return_overflow=True)
            return counts

    t0 = time.time()
    os.makedirs(cfg.out_dir, exist_ok=True)

    for it in range(start_iter, cfg.max_iters):
        # per-iteration derived stream (not one sequential generator):
        # reproducible under resume without replaying prior draws
        ids = jnp.asarray(np.random.default_rng(
            (cfg.seed << 20) + it).integers(0, w * h, batch_pixels,
                                            dtype=np.int32))
        o, d, rng_ids = _pixel_rays(camera, w, h, ids)
        tgt = target_flat[ids]
        # per-iteration seed as a (shardable) per-ray array
        # (cfg.seed, it)-derived like the minibatch ids (identical to the
        # historical `it` stream at the default seed 0)
        seed_arr = jnp.full(batch_pixels, (cfg.seed << 20) + it, jnp.uint32)

        over = ""
        if candidate_k > 0 and it % cfg.save_every == 0:
            # probe with THIS step's params + streams (pre-update), so the
            # number is the overflow of the gradients actually applied,
            # over live lanes only
            n_over, n_live = (int(v) for v in overflow_probe(
                params, scene_init, o, d, rng_ids, seed_arr))
            frac = n_over / max(n_live, 1)
            over = f" cand-overflow {frac:.2%} ({n_live} live lanes)"
            if frac > 0.01:
                log(f"[fit] WARNING: {frac:.2%} of live lanes dropped "
                    f"candidates (candidate_k={candidate_k} too small "
                    f"— gradients are biased)")

        params, opt_state, loss = step(params, opt_state, scene_init,
                                       o, d, rng_ids, tgt, seed_arr)

        if it % cfg.save_every == 0:
            log(f"[fit] iter {it} loss {float(loss):.5f} "
                f"elapsed {time.time() - t0:.1f}s{over}")
            if save_snapshot is not None:
                save_snapshot(it, scene_init.with_medium(
                    GaussianMixture.from_parameters(params)))
        if cfg.checkpoint_every and it % cfg.checkpoint_every == 0:
            save_checkpoint(os.path.join(cfg.out_dir, "ckpt.npz"),
                            FitState(params, opt_state, it))

    return scene_init.with_medium(GaussianMixture.from_parameters(params))


# -----------------------------------------------------------------------------
# Checkpoint / resume — absent from the reference (SURVEY §5), trivial here.
# -----------------------------------------------------------------------------

def save_checkpoint(path: str, state: FitState) -> None:
    flat, _ = jax.tree_util.tree_flatten(state.opt_state)
    np.savez(path, params=np.asarray(state.params),
             iteration=state.iteration,
             **{f"opt_{i}": np.asarray(x) for i, x in enumerate(flat)})


def load_checkpoint(path: str, optimizer, params_like) -> FitState:
    data = np.load(path)
    params = jnp.asarray(data["params"])
    opt_template = optimizer.init(params_like)
    flat, treedef = jax.tree_util.tree_flatten(opt_template)
    flat = [jnp.asarray(data[f"opt_{i}"]) for i in range(len(flat))]
    opt_state = jax.tree_util.tree_unflatten(treedef, flat)
    return FitState(params, opt_state, int(data["iteration"]))
