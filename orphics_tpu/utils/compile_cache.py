"""Persistent XLA compilation cache location, shared by every entry point.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache
lives at ``<checkout>/.jax_cache`` (listed in ``.gitignore``). A fixed
path matters: the path is part of the cache key, so a directory that
moves never hits.
"""
from __future__ import annotations

import os

import jax

__all__ = ["enable"]


def enable(checkout_root: str) -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.abspath(checkout_root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    if "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS" not in os.environ:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
