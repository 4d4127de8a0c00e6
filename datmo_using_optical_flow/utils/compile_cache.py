"""Persistent XLA compilation cache for the benchmarks, the smoke test and
long-running CLIs.

The 1080p and reference-load programs take tens of seconds to compile; the
persistent cache makes re-runs of identical programs start in seconds.  The
directory is ``$JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads it
itself, and nothing here overrides it), otherwise the fixed ``<repo>/.jax_cache``.
Tests do not enable this (they exercise fresh compilation paths).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    # cache everything that took noticeable compile time
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
