"""Persistent XLA compilation cache.

Compiling the render programs takes seconds to minutes per (config, chunk)
shape; the persistent cache makes that a one-time cost per machine.
Drivers (CLI, bench, chip_smoke) call :func:`enable` at start-up.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, the cache goes there and this
module names no other path.  Otherwise it lives at the fixed
``<checkout>/.jax_cache`` (gitignored): the directory is part of the cache
key, so a path that moves never hits.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    return os.environ.get(ENV) or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    return that path."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return path
