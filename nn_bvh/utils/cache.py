"""Persistent XLA compilation cache.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it and nothing is set here.
Otherwise the cache lives in the checkout's `.jax_cache` (a fixed path: the
path is part of the cache key)."""

import os


def cache_dir() -> str:
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_jax_cache():
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 10.0)
