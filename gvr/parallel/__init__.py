from gvr.parallel.sharding import (
    make_mesh,
    shard_rays,
    sharded_render_fn,
)
from gvr.parallel.gauss_sharded import (
    make_mesh_2d,
    render_rays_tp,
    render_multiscatter_tp,
    fit_value_and_grad_tp,
)

__all__ = [
    "make_mesh",
    "shard_rays",
    "sharded_render_fn",
    "make_mesh_2d",
    "render_rays_tp",
    "render_multiscatter_tp",
    "fit_value_and_grad_tp",
]
