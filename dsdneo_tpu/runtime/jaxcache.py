"""The persistent XLA compilation cache, set up in one place.

Every entry point (CLI batched paths, bench.py, chip_smoke.py, the
multi-device dryrun) calls :func:`enable_compile_cache` before its
first compile.  ``JAX_COMPILATION_CACHE_DIR``, when set, wins and no
other cache setting is touched.  Otherwise the cache lives at the fixed
``<checkout>/.jax_cache``; the path is part of the cache key, so a
directory that moves would never hit.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns
    the directory in use."""
    import jax
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        # JAX reads the variable at import; set it again in case the
        # caller exported it after importing jax
        jax.config.update("jax_compilation_cache_dir", env)
        return env
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return DEFAULT_DIR
