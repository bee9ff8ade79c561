"""The compile-cache rule shared by every entry point
(timeopt/utils/compile_cache.py)."""

import os

import jax

from timeopt.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_is_honoured_and_nothing_is_set(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, "/some/cache/dir")
    assert compile_cache.enable_compile_cache() == "/some/cache/dir"
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_and_inside_the_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    saved = (
        jax.config.jax_compilation_cache_dir,
        jax.config.jax_persistent_cache_min_compile_time_secs,
    )
    try:
        first = compile_cache.enable_compile_cache(min_compile_time_secs=0.5)
        assert first == compile_cache.enable_compile_cache(min_compile_time_secs=0.5)
        assert first == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == first
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
