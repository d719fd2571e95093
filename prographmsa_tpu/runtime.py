"""Process-level device runtime knobs.

One stop for the JAX settings every entry point (CLI, bench, graft entry,
chip_smoke) wants: a **persistent XLA compilation cache**, so that a
process after the first starts warm.  Precision and backend policy live in
``engine_policy``.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
other directory is set here; otherwise the cache is ``<checkout>/.jax_cache``
(gitignored).
"""

from __future__ import annotations

import functools
import os


@functools.lru_cache(maxsize=1)
def enable_compile_cache() -> str:
    """Idempotently point JAX at the persistent compilation cache; returns
    the cache directory."""
    import jax

    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache:
        cache = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", cache)
    # cache even fast compiles: a cold process pays every one of them
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache
