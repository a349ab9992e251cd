"""Persistent XLA compilation cache for the entry points.

Compiling the kernels and the model step is a large part of a cold run.
Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
there and nothing is changed; otherwise the cache goes to the fixed
in-checkout ``.jax_cache/`` (gitignored), so reruns from one checkout hit.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache")
)


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return DEFAULT_DIR
