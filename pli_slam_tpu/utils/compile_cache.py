"""Persistent XLA compilation cache, placed the same way by every entry point.

`JAX_COMPILATION_CACHE_DIR`, when set, is read by JAX itself and left in
force. Otherwise the cache lives at one fixed directory inside the
checkout: the directory is part of each entry's key, so a path that
moved between runs (a per-process or per-time name) would never hit.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent cache; returns the directory in use."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return jax.config.jax_compilation_cache_dir
