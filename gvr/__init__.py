"""gvr — volumetric path tracer for 3D Gaussian-mixture media.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
wantonsushi/3DG-vol-renderer (C++20/Eigen/OpenMP):
physically-based volumetric path tracing where 3D Gaussians are true
scattering media with closed-form (erf) transmittance and analytic /
fixed-iteration free-flight distance sampling.  It runs on NVIDIA GPUs
(the dense engine's megakernel is Pallas through Triton) and on the CPU.

Design stance (batched array programs, not a translation):

* Gaussians live as structure-of-arrays tensors in device memory
  (``scene/gaussians.py``); per-(ray, gaussian) quadratic coefficients are
  three matmuls (``ops/quadratics.py``) instead of Eigen per-ray loops
  (reference ``gaussian.h:126-164``).
* The reference's BVH + per-ray ``std::vector`` event lists + ``std::sort``
  (``gmm.h:231-578``) collapse into clipped-interval map-reduce: transmittance
  and free-flight inversion only ever need each Gaussian's entry/exit
  interval, clipped against the query range.  No sorting, no pointer chasing.
* Monte Carlo uses a counter-based hash RNG keyed by
  (pixel, sample, bounce) — deterministic across shards, replacing the
  thread-local PCG32 of ``rng.h``.
* Multi-device scaling is SPMD over pixel tiles via ``jax.sharding`` +
  ``shard_map`` (``parallel/``); inverse fitting all-reduces gradients with
  ``psum`` — the only collective the workload needs.
* Inverse rendering is JAX autodiff through the differentiable estimators
  plus the reference's 11-parameter reparameterization (``inverse/``),
  replacing stochastic finite differences (``inverse_integrator.h``), which
  is kept only as a validation mode.
"""

from gvr.scene.gaussians import GaussianMixture
from gvr.scene.spheres import SphereMixture
from gvr.scene.scene import Scene, Light, load_scene, load_gmm, load_smm
from gvr.cameras import PinholeCamera, OrthographicCamera
from gvr.config import RenderConfig, Solver

__version__ = "0.1.0"

__all__ = [
    "GaussianMixture",
    "SphereMixture",
    "Scene",
    "Light",
    "load_scene",
    "load_gmm",
    "load_smm",
    "PinholeCamera",
    "OrthographicCamera",
    "RenderConfig",
    "Solver",
]
