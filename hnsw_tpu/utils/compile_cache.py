"""Persistent XLA compile cache for the repository's entry points.

``chip_smoke.py``, ``bench.py``, ``benchmarks/sweep.py`` and
``examples/large_scale.py`` call :func:`enable_compile_cache` before
their first compile. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and this sets nothing. Otherwise the cache lives at
``<checkout>/.jax_cache``: a fixed path (the path is part of the cache's
key, so a directory that moved would never hit), listed in
``.gitignore``.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

#: ``<checkout>/.jax_cache`` — the package's parent directory.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
