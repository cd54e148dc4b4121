"""Where JAX keeps its persistent compilation cache for this checkout.

Entry points (``chip_smoke.py``, ``bench.py``, ``benchmarks/*``, the test
harness) call :func:`use_compile_cache` once at start-up.  Library modules
never set a cache.
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def use_compile_cache() -> str:
    """Return the cache directory in use, setting it if needed.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed.  Otherwise the cache goes to ``<checkout>/.jax_cache``
    (git-ignored), a fixed path, so that one run's compilations are found
    again by the next."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
