"""Tests for the aux subsystems: checkpoint/resume, profiling, verbose output.

SURVEY.md §5.1 (tracing), §5.4 (checkpoint/resume), §5.5 (observability).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from pogs_tpu import (
    Function, FunctionVector, GraphFormSolver, SolverSettings, Status,
    PhaseTimer,
)


def _problem(m=40, n=20, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    f = FunctionVector(Function.SQUARE, m, b=b)
    g = FunctionVector(Function.ABS, n, c=0.3)
    return A, f, g


def test_checkpoint_roundtrip(tmp_path):
    A, f, g = _problem()
    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6)
    s1 = GraphFormSolver(A, settings=st)
    r1 = s1.solve(f, g)
    assert r1.status == Status.SUCCESS
    path = tmp_path / "ckpt.npz"
    s1.save_state(path)

    # A fresh solver resumed from the checkpoint converges immediately.
    s2 = GraphFormSolver(A, settings=st).load_state(path)
    r2 = s2.solve(f, g)
    assert r2.status == Status.SUCCESS
    assert int(r2.final_iter) <= max(3, int(r1.final_iter) // 5)
    assert float(r2.optval) == pytest.approx(float(r1.optval), rel=1e-5)


def test_checkpoint_rejects_wrong_matrix(tmp_path):
    A, f, g = _problem(seed=1)
    s1 = GraphFormSolver(A)
    s1.solve(f, g)
    path = tmp_path / "ckpt.npz"
    s1.save_state(path)

    B, _, _ = _problem(seed=2)
    with pytest.raises(ValueError, match="different matrix"):
        GraphFormSolver(B).load_state(path)
    # Same shape, strict off: allowed.
    GraphFormSolver(B).load_state(path, strict=False)


def test_checkpoint_requires_state(tmp_path):
    A, f, g = _problem()
    with pytest.raises(ValueError, match="no state"):
        GraphFormSolver(A).save_state(tmp_path / "x.npz")


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("init"):
        pass
    with t.phase("solve"):
        pass
    with t.phase("solve"):
        pass
    assert t.counts["solve"] == 2
    s = t.summary()
    assert "init" in s and "solve" in s and "share" in s


def test_verbose_banner_and_summary(capsys):
    A, f, g = _problem()
    st = SolverSettings(verbose=1)
    res = GraphFormSolver(A, settings=st).solve(f, g)
    out = capsys.readouterr().out
    assert "pogs_tpu" in out
    assert "status: SUCCESS" in out
    assert "optval" in out
    assert res.status == Status.SUCCESS


def test_device_time_runs():
    from pogs_tpu import device_time
    import jax

    f = jax.jit(lambda x: x * 2.0)
    x = jnp.ones((128,), jnp.float32)
    dt = device_time(f, x, reps=5, warmup=2,
                     vary=lambda i: (x * (1.0 + 1e-6 * i),))
    assert dt >= 0.0


def test_checkpoint_sparse_solver(tmp_path):
    sp = pytest.importorskip("scipy.sparse")
    A = sp.random(30, 15, density=0.4, random_state=5, format="csr")
    b = np.random.default_rng(0).standard_normal(30)
    f = FunctionVector(Function.SQUARE, 30, b=b)
    g = FunctionVector(Function.ABS, 15, c=0.1)
    s1 = GraphFormSolver(A)
    r1 = s1.solve(f, g)
    assert r1.status == Status.SUCCESS
    path = tmp_path / "sparse_ckpt.npz"
    s1.save_state(path)
    s2 = GraphFormSolver(A).load_state(path)
    r2 = s2.solve(f, g)
    assert r2.status == Status.SUCCESS
    assert int(r2.final_iter) <= int(r1.final_iter)


def test_profiler_trace_writes(tmp_path):
    import os
    import jax
    from pogs_tpu import trace

    with trace(str(tmp_path)):
        jax.block_until_ready(jnp.ones((64,)) * 2.0)
    assert any(files for _, _, files in os.walk(tmp_path))


def _cache_helper_in_child(env_extra):
    """Run use_compile_cache() in a fresh interpreter (the JAX config is
    process-global) and return (returned dir, JAX's configured dir)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu", PYTHONPATH=root)
    code = ("import jax; from pogs_tpu.utils.compile_cache import "
            "use_compile_cache as u; d = u(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    return out[-2], out[-1]


def test_compile_cache_defaults_to_checkout():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    used, configured = _cache_helper_in_child({})
    assert used == configured == os.path.join(root, ".jax_cache")


def test_compile_cache_honours_environment(tmp_path):
    want = str(tmp_path / "cache")
    used, configured = _cache_helper_in_child(
        {"JAX_COMPILATION_CACHE_DIR": want})
    assert used == configured == want
