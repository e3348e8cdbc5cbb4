"""Where the persistent XLA compilation cache lives.

A solve compiles one large program per (field, blocking n, matrix shape);
on the GPU that takes seconds to minutes, so every entry point (the CLI,
chip_smoke.py, bench.py, the test suite) shares one on-disk cache.  The
directory is part of the cache key's reach: a path that changes from run
to run (a temporary name, a pid, a time) never hits, so it is fixed.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on and return its directory.

    Honours JAX_COMPILATION_CACHE_DIR when it is set (JAX reads it itself,
    so no other directory is configured); otherwise uses DEFAULT_DIR.
    """
    path = os.environ.get(ENV_VAR) or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
