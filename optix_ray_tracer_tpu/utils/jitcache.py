"""Persistent XLA compilation cache — the PTX/module-cache analog.

The reference caches compiled OptiX modules/pipelines so later runs skip
PTX JIT (OptiX module cache via the driver's disk cache).  Here that is
XLA's persistent compilation cache: the fused animation chunk costs tens of
seconds of compile per process, all of it identical across runs of the same
configuration.

Enabled by the CLI, bench, and viewer entry points (not on package import —
a library must not mutate global jax config for its host process).  Where
``JAX_COMPILATION_CACHE_DIR`` is set, jax itself reads it and this module
sets no directory; otherwise the cache lives at the fixed path
``<checkout>/.jax_cache`` (the path is part of the cache key, so it must
not move between runs).
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    Safe to call multiple times and before/after backend init (jax reads
    the config at compile time)."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_CACHE_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # the animation chunk compiles in tens of seconds; even sub-second
    # entries (per-file rebuilds, quantizers) are worth keeping
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
