"""Render observability: timing spans, throughput, and profiler hooks.

The reference's only instrumentation is wall-clock prints
(tests/main.cpp:44-49, gmm.h:80-89, inverse_integrator.h:222-226).  Here:
structured spans with Mrays/s (the north-star metric), path statistics from
a counting trace, and optional ``jax.profiler`` trace capture for per-kernel
timelines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class Span:
    name: str
    seconds: float
    extra: Dict


class RenderStats:
    """Collects named spans; prints/export a compact report."""

    def __init__(self):
        self.spans: List[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, **extra):
        t0 = time.time()
        yield
        self.spans.append(Span(name, time.time() - t0, extra))

    def add(self, name: str, seconds: float, **extra):
        self.spans.append(Span(name, seconds, extra))

    def report(self) -> str:
        lines = []
        for s in self.spans:
            kv = " ".join(f"{k}={v}" for k, v in s.extra.items())
            lines.append(f"[gvr] {s.name}: {s.seconds:.3f}s {kv}".rstrip())
        return "\n".join(lines)

    def json(self) -> str:
        return json.dumps([dataclasses.asdict(s) for s in self.spans])


def mrays_per_sec(n_rays: int, seconds: float) -> float:
    return n_rays / max(seconds, 1e-9) / 1e6


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """jax.profiler trace of the body into ``log_dir`` (no-op when it is
    None).  Profiler errors and errors of the body propagate."""
    if not log_dir:
        yield
        return
    import jax
    with jax.profiler.trace(log_dir):
        yield


def path_statistics(scene, camera, cfg, sample_pixels: int = 16384):
    """Trace a subsample counting bounces and rays per path — the bounce
    histogram the reference never had.  Returns dict with rays/path and
    mean bounces (used by bench.py's honest ray accounting)."""
    import jax
    import jax.numpy as jnp
    from gvr.ops.transmittance import tau_coeffs, albedo_at_from_rg
    from gvr.ops.solvers import sample_free_flight
    from gvr.ops.sampling import path_uniforms
    from gvr.config import Solver
    from gvr.integrators.raymarch import _dir_from_xi

    # the counting trace is dense [n, N]; cap n so its ~11 live [n, N]
    # f32 arrays stay near 1.5 GB at big N
    n_gauss = scene.medium.n
    budget = max(256, (3 << 25) // max(n_gauss, 1))
    n = min(sample_pixels, budget, cfg.width * cfg.height)

    @jax.jit
    def count(sc, ids):
        x = ids % cfg.width
        y = ids // cfg.width
        u = (x.astype(jnp.float32) + 0.5) / cfg.width
        v = (y.astype(jnp.float32) + 0.5) / cfg.height
        o, d = camera.sample_ray(jnp.stack([u, v], axis=-1))

        def cond(st):
            alive, bounce = st[4], st[5]
            return jnp.any(alive) & (bounce < cfg.max_bounces)

        # Mirrors wavefront_pixels' survival exactly: throughput decays by
        # the mixture albedo at each scatter and Russian roulette survives
        # with min(max(throughput), cap) where cap drops to rr_cap_tail
        # after rr_tail_after bounces.  (A constant-0.9 model overestimated
        # rays/path on absorbing scenes.)
        def body(st):
            o, d, thr, ids_, alive, bounce, rays, bounces = st
            rg = tau_coeffs(sc.medium, o, d)
            xi = path_uniforms(ids_, 0, bounce, 9, cfg.seed)
            target = -jnp.log(jnp.maximum(1.0 - xi[:, 0], 1e-12))
            # xi[:, 8] mirrors the wavefront's UNIFORM-solver draw
            # (multiscatter.py) — without it the UNIFORM ablation asserts
            t_sc, scattered = sample_free_flight(
                rg, target, cfg.solver, cfg.solver_iters,
                xi[:, 8] if cfg.solver == Solver.UNIFORM else None,
                finisher=cfg.solver_finisher)
            rays = rays + jnp.sum(alive) + jnp.sum(alive & scattered)
            bounces = bounces + jnp.sum(alive & scattered)
            alive = alive & scattered
            t_pos = jnp.maximum(t_sc, 0.0)
            albedo = albedo_at_from_rg(rg, sc.medium.albedo, t_pos)
            thr_n = thr * albedo[:, None]
            do_rr = bounce >= cfg.min_scatter
            cap = jnp.where(bounce >= cfg.rr_tail_after, cfg.rr_cap_tail,
                            cfg.rr_cap)
            rr = jnp.minimum(jnp.max(thr_n, axis=-1), cap)
            killed = do_rr & (xi[:, 5] > rr)
            thr_n = jnp.where((do_rr & ~killed)[:, None],
                              thr_n / jnp.maximum(rr, 1e-12)[:, None], thr_n)
            alive = alive & ~killed
            thr = jnp.where(alive[:, None], thr_n, thr)
            pos = o + t_pos[:, None] * d
            nd = _dir_from_xi(xi[:, 6:8])
            return (pos, nd, thr, ids_, alive, bounce + 1, rays, bounces)

        st = (o, d, jnp.ones((ids.shape[0], 3)), ids,
              jnp.ones(ids.shape[0], bool), jnp.int32(0),
              jnp.int32(0), jnp.int32(0))
        *_, rays, bounces = jax.lax.while_loop(cond, body, st)
        return rays, bounces

    import numpy as np
    ids = jnp.asarray(np.linspace(0, cfg.width * cfg.height - 1, n,
                                  dtype=np.int32))
    rays, bounces = count(scene, ids)
    return {
        "rays_per_path": float(rays) / n,
        "mean_scatter_events": float(bounces) / n,
    }
