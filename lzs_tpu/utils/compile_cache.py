"""JAX's persistent compilation cache: one place decides where it lives.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache goes to a fixed directory inside
the checkout (listed in .gitignore): the path is part of the cache key,
so a fixed one is what lets a later process find earlier compilations.
"""

from __future__ import annotations

import os
import pathlib

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable(config=None, environ=os.environ) -> str:
    """Turn the persistent cache on; returns the directory in use.

    ``config`` defaults to ``jax.config``; tests pass a recorder.
    """
    if environ.get(ENV):
        return environ[ENV]
    path = str(DEFAULT_DIR)
    if config is None:
        import jax

        config = jax.config
    config.update("jax_compilation_cache_dir", path)
    config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
