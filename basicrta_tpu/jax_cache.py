"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (CLI, bench.py, chip_smoke.py, scripts):
when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here; otherwise the cache is the fixed ``<checkout>/.jax_cache``
(listed in ``.gitignore``). The path is part of each entry's key, so it
never depends on a temp name, a PID or the time.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE = os.path.join(CHECKOUT, ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE)
    return DEFAULT_CACHE
