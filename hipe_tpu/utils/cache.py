"""Persistent XLA compilation cache.

Compiled executables are reused across processes, so a second run skips
compilation. Enabled by the CLI, `bench.py` and `chip_smoke.py`; library
users call :func:`enable_compilation_cache` themselves if desired.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache in
that directory and this module sets no other path. Otherwise the cache goes
to the fixed in-checkout directory :data:`DEFAULT_DIR` (a fixed path, so
that one run's entries are found by the next).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """Where the compilation cache lives for this process."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir()
