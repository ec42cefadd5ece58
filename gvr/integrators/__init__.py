from gvr.integrators.common import render_chunked
from gvr.integrators.test_hit import render_hit_mask
from gvr.integrators.raymarch import (
    render_raymarch_gaussians,
    render_raymarch_spheres,
    render_pure_raymarch,
    march_transmittance,
)
from gvr.integrators.freeflight import render_single_scatter
from gvr.integrators.multiscatter import (
    render_multiscatter,
    multiscatter_radiance,
)

__all__ = [
    "render_chunked",
    "render_hit_mask",
    "render_raymarch_gaussians",
    "render_raymarch_spheres",
    "render_pure_raymarch",
    "march_transmittance",
    "render_single_scatter",
    "render_multiscatter",
    "multiscatter_radiance",
]
