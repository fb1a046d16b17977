"""Persistent XLA compile cache, shared by every entry point.

A cold receiver compiles its acquisition, handoff and tracking programs
before the first block runs; the persistent cache makes that a one-time
cost per machine.  The cache key includes the directory, so the path is
fixed: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it (JAX
reads that variable itself, so no directory is set here), otherwise
``<repo>/.jax_cache`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(config=None, environ=None) -> str:
    """Turn on the persistent compile cache; return its directory.

    ``config`` defaults to ``jax.config`` and ``environ`` to
    ``os.environ`` (both replaceable so a test can observe the calls
    without touching the process-wide JAX configuration).  Every
    program is cached, however small or fast to compile: a receiver's
    cold start is many mid-sized programs."""
    if config is None:
        import jax

        config = jax.config
    environ = os.environ if environ is None else environ
    path = environ.get(ENV_VAR)
    if not path:
        path = str(REPO_CACHE_DIR)
        config.update("jax_compilation_cache_dir", path)
    config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
