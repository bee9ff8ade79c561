"""Test environment: CPU backend with 8 virtual devices (for mesh/sharding
tests on one host — SURVEY.md §4), fp64 enabled for numerical-parity
oracles, persistent compilation cache to keep repeat runs fast. The GPU
path is exercised by chip_smoke.py, not by this suite."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from timeopt.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_time_secs=0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    # a fresh generator per test: with a shared one, a test's draws would
    # depend on which tests ran before it in the same worker
    return np.random.default_rng(0)
