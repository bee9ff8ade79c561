"""Where the persistent XLA compilation cache lives — one rule for every
entry point (bench.py, chip_smoke.py, the suite runner, the tests).

A cache hit needs the same directory from run to run, so the path is
fixed: never a temporary name, a process id or a time.

- If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it at import and this
  module sets nothing.
- Otherwise the cache goes to `.jax_cache/` at the root of the checkout
  (listed in `.gitignore`).
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache(min_compile_time_secs: float = 1.0) -> str:
    """Point JAX's persistent compilation cache at its fixed directory and
    return that directory."""
    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_time_secs)
    return DEFAULT_CACHE_DIR
