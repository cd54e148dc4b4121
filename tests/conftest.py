"""Test harness config: CPU backend with 8 virtual devices (a multi-device
mesh on the host CPU, per SURVEY.md §4), float64 enabled for math oracles.
Tests that need a GPU carry the ``gpu`` marker and skip here."""

import os

# The suite runs on the CPU backend, also on a machine with a GPU: tests
# simulate an 8-device mesh on host CPU, per the multi-device test strategy.
# Only an explicit JAX_PLATFORMS (e.g. ``cuda`` for the ``gpu`` tests, see
# the README) overrides it.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from pogs_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)
# Persistent compilation cache: the suite is compile-dominated; repeat runs
# reuse compiled executables.
use_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skip unless JAX's backend is a GPU (decided at run time, never at
    import).  The suite defaults to the CPU; on a machine with a card run
    ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist``."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU backend (JAX_PLATFORMS=cuda on the card)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """XLA-CPU segfault mitigation: with the full suite in one process,
    late sparse (BCOO) solves segfault inside compiled executables — an
    accumulated-state issue in the CPU runtime (crash site moves with suite
    composition; subsets always pass; memory is plentiful).  Dropping
    executable references between modules keeps the live-program count
    bounded.  The persistent compilation cache makes the recompiles cheap."""
    yield
    import pogs_tpu.solver.graph as _g
    import pogs_tpu.solver.cone as _c
    import pogs_tpu.parallel.batch as _b

    _g._SOLVE_CACHE.clear()
    _g._INIT_CACHE.clear()
    _c._CONE_SOLVE_CACHE.clear()
    _c._CONE_INIT_CACHE.clear()
    _b._BATCH_CACHE.clear()
    _b._CONE_BATCH_CACHE.clear()
    jax.clear_caches()
