"""Runtime configuration for renders and fits.

The reference selects behavior with compile-time ``#define``s
(``distance_solvers.h:142-147``, ``gmm.h:161-163``, ``tests/main.cpp:11-12``);
here everything is a runtime dataclass whose fields become static jit
arguments, selecting traced code paths.
"""

from __future__ import annotations

import dataclasses
import enum


class Solver(enum.Enum):
    """Free-flight distance solver (reference ``distance_solvers.h``).

    All solvers run a *fixed* number of iterations — fixed trip counts keep
    batched lanes in lockstep, so the reference's early-exit tolerances
    become pure iteration-count choices.

    * ``NEWTON``: safeguarded Newton (bisection bracket + Newton step,
      branchless selects) on the *global* clipped optical-depth function
      tau(t).  This subsumes the reference's segment search + per-segment
      Newton (``integrator.h:422-498`` + ``distance_solvers.h:62-127``):
      tau(t) is the same monotone function, so the root is identical.
    * ``BISECTION``: fixed-iteration bisection on the same function
      (reference ``distance_solvers.h:25-57``).
    * ``ANALYTIC_NEWTON``: when exactly one Gaussian overlaps the bracketed
      segment, invert analytically via erfinv (reference
      ``gaussian.h:235-297``); otherwise safeguarded Newton.  The reference
      default ``ANALYTIC_PLUS_NEWTON`` (``distance_solvers.h:146``).
    * ``ANALYTIC_BISECTION``: the same analytic closed form with a plain
      bisection fallback (reference ``ANALYTIC_PLUS_BISECTION``,
      ``distance_solvers.h:166-174``) — ablation only.
    * ``UNIFORM``: uniform sample inside the critical segment (reference
      ``distance_solvers.h:132-137``) — ablation only.
    """

    NEWTON = "newton"
    BISECTION = "bisection"
    ANALYTIC_NEWTON = "analytic_newton"
    ANALYTIC_BISECTION = "analytic_bisection"
    UNIFORM = "uniform"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static knobs shared by the integrators.

    Defaults mirror the reference driver (``tests/main.cpp:17-42``,
    integrator ctor defaults ``integrator.h:138,278-281,501-505``).
    """

    width: int = 512
    height: int = 512
    spp: int = 256                 # samples per pixel (MC integrators)
    min_scatter: int = 5           # bounces before Russian roulette kicks in
    rr_cap: float = 0.9            # RR survival probability cap
    # second RR stage: deep paths survive with at most rr_cap_tail from
    # bounce rr_tail_after on.  Unbiased (RR reweights); shortens the
    # bounce tail that otherwise costs full-batch iterations in the
    # wavefront loop.  Set rr_cap_tail=rr_cap for exact reference behavior.
    rr_tail_after: int = 16
    rr_cap_tail: float = 0.5
    max_bounces: int = 64          # hard safety bound for the while_loop
    step_size: float = 0.01        # ray-march step (deterministic integrators)
    env_samples: int = 20          # env direction samples (ray marchers)
    solver: Solver = Solver.ANALYTIC_NEWTON
    # fixed solver trip count.  Newton+Illinois on random in-medium rays
    # of the 250-Gaussian scene with conditioned targets: the fraction of
    # rays with >1% relative tau residual is 0.15% at 8 iterations, 0.06%
    # at 10 and 0 at 12 (tests/test_solvers.py pins this).  A wrong root
    # is BIAS, not variance, so the default is the first clean count.  The
    # reference's 8-iteration Newton (distance_solvers.h:64) runs per
    # SEGMENT on an already-tight bracket; this global solve needs more.
    solver_iters: int = 12
    # per-segment analytic erfinv finisher for the dense XLA solver
    # (exact root when one Gaussian is active at the iterate;
    # distance_solvers.h:176-186).  Off by default: at 12 iterations the
    # Newton+Illinois root is already converged.  The megakernel does not
    # implement it, so finisher=True renders on XLA.  The grid engine's
    # in-cell solve keeps its own always-on finisher.
    solver_finisher: bool = False
    # grid-engine in-cell solve trip count: the bracket is one cell
    # crossing and the analytic erfinv finisher handles the (common)
    # single-active case exactly.  Image-mean bias against a converged
    # 48-iteration dense solve on the 10k tiny-support scene (64^2 spp 4,
    # CPU run): 1.4e-3 at 6 iterations, 3.3e-4 at 8, 2.0e-4 at 10.
    grid_solver_iters: int = 10
    # POOLED path regeneration for the grid wavefront: a dead lane claims
    # the chunk's next untraced (pixel, sample) instead of idling once its
    # own pixel's samples are done (gridscatter.wavefront_pixels_grid_pooled).
    # Estimator-identical per (pixel, sample) — RNG is keyed by
    # (pixel, sample, bounce) — but per-pixel f32 accumulation regroups
    # (per-sample slots summed in fixed order), so images differ from the
    # per-lane engine at the ulp level.  Applies to the grid engine only.
    pool_regen: bool = True
    ray_chunk: int = 1 << 16       # rays per jitted chunk (memory bound)
    seed: int = 0                  # base RNG seed
    # per-ray candidate compaction: the XLA free-flight solver runs on the
    # candidate_k nearest-entering hit Gaussians per ray. 0 = dense.
    candidate_k: int = 0
    # dense-engine kernel (kernels/megatrace.py, Pallas through Triton):
    # 'auto' uses it on a GPU backend and plain XLA elsewhere; 'on' insists
    # (raises without a GPU); 'off' is plain XLA; 'interpret' runs the
    # kernel in the Pallas interpreter (CPU testing).
    pallas: str = "auto"
    # engine: 'auto' picks the uniform-grid regular-tracking wavefront
    # (accel/grid.py) where its pair work per ray undercuts the dense
    # engine's (multiscatter.GRID_PAIR_COST), else the dense engine;
    # 'dense'/'grid' force.  The grid engine is the BVH replacement
    # (gmm.h:231-578).
    engine: str = "auto"

    def __post_init__(self):
        if self.pallas not in ("auto", "on", "off", "interpret"):
            raise ValueError(f"pallas must be 'auto'/'on'/'off'/"
                             f"'interpret', got {self.pallas!r}")
        if self.engine not in ("auto", "dense", "grid"):
            raise ValueError(f"engine must be 'auto'/'dense'/'grid', "
                             f"got {self.engine!r}")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Inverse-rendering configuration (reference ``SFDDConfig``,
    ``inverse_integrator.h:52-57``)."""

    max_iters: int = 1000
    save_every: int = 25
    lr: float = 1e-2
    # MC gradient samples per pixel per loss buffer (fit_gaussians).  The
    # reference re-renders whole frames at the integrator's spp per SFD
    # sample; pathwise autodiff gradients need far fewer samples.
    spp: int = 2
    # Rademacher perturbations per iteration for the SFD validation mode —
    # pass to inverse/sfd.sfd_gradient* (reference SFDDConfig default)
    num_stoch_samples: int = 4
    checkpoint_every: int = 100
    out_dir: str = "./fit_output"
    seed: int = 0                  # minibatch + MC stream base seed
