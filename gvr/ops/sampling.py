"""Counter-based RNG and direction sampling.

Replaces the reference's thread-local PCG32 + splitmix64 path seeding
(``rng.h``) with JAX threefry keys derived deterministically from
(pixel x, pixel y, sample index) — the same determinism property (the
reference already derives per-path seeds from coordinates, rng.h:52-57)
without the bit pattern, reproducible across shards and chips.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _mix32(x):
    """splitmix32 finalizer: full-avalanche 32-bit mix."""
    x = x + jnp.uint32(0x9E3779B9)
    x = (x ^ (x >> 16)) * jnp.uint32(0x21F0AAAD)
    x = (x ^ (x >> 15)) * jnp.uint32(0x735A2D97)
    return x ^ (x >> 15)


def path_uniforms(pixel_id, sample, bounce, n: int, seed: int = 0):
    """[..., n] uniforms in [0,1) from a counter-based hash keyed by
    (pixel, sample, bounce, slot) — the same determinism contract as the
    reference's derive_path_seed + PCG32 (rng.h:20-57): independent of
    batching/chunk layout, reproducible across shards.

    Used in the render hot loop: vmapped threefry costs far more;
    splitmix32 rounds give MC-grade avalanche at a handful of integer ops
    per draw.

    The path state is 64 bits (two independently-mixed 32-bit lanes, the
    analog of the reference's splitmix64 path seeding, rng.h:52-57): with a
    single 32-bit state, birthday collisions would give ~5e5 of the ~6.7e7
    (pixel, sample) pairs at 512^2 x 256 spp fully identical uniform
    streams.  Each output column mixes both lanes, so full-stream
    collisions need a simultaneous 64-bit collision (~2^-64)."""
    pid = pixel_id.astype(jnp.uint32)
    s = jnp.asarray(sample).astype(jnp.uint32)
    b = jnp.asarray(bounce).astype(jnp.uint32)
    if isinstance(seed, int):
        seed = seed & 0xFFFFFFFF
    sd = jnp.asarray(seed).astype(jnp.uint32)
    h1 = _mix32(pid * jnp.uint32(0x85EBCA6B)
                ^ (s * jnp.uint32(0xC2B2AE35))
                ^ _mix32(sd))
    h2 = _mix32((pid ^ jnp.uint32(0xDEADBEEF)) * jnp.uint32(0x9E3779B1)
                + s * jnp.uint32(0x6C078965) + sd)
    b1 = _mix32(h1 ^ (b * jnp.uint32(0x27D4EB2F)))
    b2 = _mix32(h2 + b * jnp.uint32(0x41C64E6D))
    cols = [_mix32((b1 ^ jnp.uint32(0x165667B1 * (i + 1))) + b2)
            for i in range(n)]
    u = jnp.stack(cols, axis=-1)
    # 23 high bits only: bit-exact with the megakernel's in-kernel copy
    # (kernels/megatrace.py)
    return (u >> 9).astype(jnp.float32) * jnp.float32(2.0 ** -23)


def path_key(base_key, x, y, sample):
    """Per-path key from pixel coords + sample index
    (counterpart of derive_path_seed, rng.h:52-57)."""
    k = jax.random.fold_in(base_key, x)
    k = jax.random.fold_in(k, y)
    return jax.random.fold_in(k, sample)


def sample_uniform_direction(key, shape=()):
    """Uniform direction on the unit sphere, matching the reference's
    parameterization (integrator.h:32-44): theta = 2 pi xi1 azimuth,
    phi = acos(1 - 2 xi2) polar, direction =
    (sin phi cos theta, sin phi sin theta, cos phi)."""
    xi = jax.random.uniform(key, shape + (2,))
    theta = 2.0 * jnp.pi * xi[..., 0]
    cos_phi = 1.0 - 2.0 * xi[..., 1]
    sin_phi = jnp.sqrt(jnp.maximum(1.0 - cos_phi * cos_phi, 0.0))
    return jnp.stack([sin_phi * jnp.cos(theta),
                      sin_phi * jnp.sin(theta),
                      cos_phi], axis=-1)


