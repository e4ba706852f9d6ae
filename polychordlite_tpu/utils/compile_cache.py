"""Persistent XLA compilation cache for the entry-point scripts.

``chip_smoke.py``, ``python -m polychordlite_tpu``, ``bench.py`` and
``benchmarks/run_matrix.py`` call :func:`enable_compile_cache` once at start;
importing the library never does.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and nothing is set
  here.
* Otherwise the cache lives at the fixed path ``<repo>/.jax_cache`` (listed
  in ``.gitignore``).  The path is part of the cache key, so it never
  depends on a temporary directory, a process id or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        return env_dir
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
