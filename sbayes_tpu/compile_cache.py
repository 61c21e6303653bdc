"""Placement of JAX's persistent compilation cache.

Every entry point (the CLI, ``chip_smoke.py``, ``bench.py`` and the scripts
under ``benchmarks/``) calls :func:`place_compile_cache` before it compiles
anything, so repeated runs find their programs in one place. The path is
part of the cache key, so it is fixed rather than per-run.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def place_compile_cache() -> str:
    """Return the cache directory in use, setting it if nobody has.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads that
    directory and nothing is changed. Otherwise the cache goes to
    ``<checkout>/.jax_cache``."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
