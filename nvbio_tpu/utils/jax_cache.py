"""Persistent XLA compilation cache for the CLI tools and tests.

The mapper pipeline compiles several large programs (~minutes on a
cold start); caching them on disk makes every run after the first
start mapping immediately — the moral equivalent of the reference
shipping precompiled CUDA binaries.

Where the cache lives: if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and this module sets no other directory.  Otherwise the
cache is ``<checkout>/.scratch/jax_cache`` (``.scratch/`` is
gitignored): a fixed path, so a later run finds what an earlier one
cached.
"""

from __future__ import annotations

import os

#: the checkout's own cache directory (used when the environment names none)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".scratch", "jax_cache")


def cache_dir() -> str:
    """The directory compiled programs are cached in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache(min_compile_secs: float = 1.0) -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    d = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return d
