from gvr.ops.quadratics import ray_quadratics, intersect_gaussians
from gvr.ops.transmittance import (
    tau_coeffs,
    tau_interval,
    tau_up_to,
    transmittance_up_to,
    sigma_t_at,
)
from gvr.ops.solvers import sample_free_flight
from gvr.ops.sampling import sample_uniform_direction, path_key

__all__ = [
    "ray_quadratics",
    "intersect_gaussians",
    "tau_coeffs",
    "tau_interval",
    "tau_up_to",
    "transmittance_up_to",
    "sigma_t_at",
    "sample_free_flight",
    "sample_uniform_direction",
    "path_key",
]
