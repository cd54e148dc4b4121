"""Batched λ-sweeps and multi-right-hand-side sweeps through the vmapped
XLA loop (parallel/batch.py), each lane checked against an independent
single solve of the same problem (solver/graph.py)."""

import numpy as np
import pytest
import jax.numpy as jnp

from pogs_tpu.types import Function, FunctionVector, SolverSettings, Status
from pogs_tpu.solver.graph import GraphFormSolver
from pogs_tpu.parallel.batch import batched_graph_solve, solve_lasso_path


def _lane_refs(A, f_b, g_c, settings):
    """Independent single solves, one per lane (cold starts)."""
    m, n = A.shape
    out = []
    for b_k, c_k in zip(f_b, g_c):
        f = FunctionVector(Function.SQUARE, m, b=b_k, dtype=jnp.float32)
        g = FunctionVector(Function.ABS, n, c=c_k, dtype=jnp.float32)
        out.append(GraphFormSolver(A, dtype=jnp.float32,
                                   settings=settings).solve(f, g))
    return out


def _assert_lanes_match(batch, refs, x_atol=2e-3, rtol=1e-3):
    assert np.asarray(batch["x"]).shape[0] == len(refs)
    np.testing.assert_array_equal(
        np.asarray(batch["status"]), [int(r.status) for r in refs])
    np.testing.assert_allclose(
        np.asarray(batch["optval"]), [float(r.optval) for r in refs],
        rtol=rtol, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(batch["x"]), np.stack([np.asarray(r.x) for r in refs]),
        atol=x_atol)


@pytest.mark.parametrize("m,n,K,hi,lo", [
    (100, 60, 10, 0.5, 0.1),    # tall λ-sweep
    (60, 40, 5, 0.9, 0.3),      # odd K
    (40, 90, 6, 0.6, 0.2),      # wide: the Woodbury projector branch
])
def test_lambda_sweep_matches_single_solves(m, n, K, hi, lo):
    rng = np.random.default_rng(m + n + K)
    A = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    lam_max = float(np.max(np.abs(A.T @ b)))
    lambdas = (np.geomspace(hi, lo, K) * lam_max).astype(np.float32)
    st = SolverSettings(abs_tol=1e-4, rel_tol=1e-3, gap_stop=False)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=jnp.float32)
    g = FunctionVector(Function.ABS, n, dtype=jnp.float32)
    batch = batched_graph_solve(A, f, g, lambdas, settings=st)
    _assert_lanes_match(batch, _lane_refs(A, [b] * K, lambdas, st))


def test_sweep_instant_convergence_reports_objective():
    """A lane converging at k=0 (λ ≥ λ_max, x* = 0) reports the objective
    of its converged iterate, not the carry initializer."""
    rng = np.random.default_rng(21)
    m, n, K = 60, 40, 8
    A = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    lam_max = float(np.max(np.abs(A.T @ b)))
    lambdas = np.array([10 * lam_max, 5 * lam_max]
                       + list(np.geomspace(0.5, 0.1, K - 2) * lam_max),
                       np.float32)
    st = SolverSettings(abs_tol=1e-4, rel_tol=1e-3, gap_stop=False)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=jnp.float32)
    g = FunctionVector(Function.ABS, n, dtype=jnp.float32)
    batch = batched_graph_solve(A, f, g, lambdas, settings=st)
    _assert_lanes_match(batch, _lane_refs(A, [b] * K, lambdas, st))
    # x* = 0 there, so the objective is 0.5 ||b||^2.
    assert float(np.asarray(batch["optval"])[0]) == pytest.approx(
        0.5 * float(b @ b), rel=1e-3)


@pytest.mark.parametrize("with_lambdas", [False, True])
def test_multi_rhs_sweep_matches_single_solves(with_lambdas):
    """Per-lane f.b (multi-right-hand-side), alone and with a per-lane λ."""
    rng = np.random.default_rng(3)
    m, n, K = 40, 20, 6
    A = rng.standard_normal((m, n)).astype(np.float32)
    B = rng.standard_normal((K, m)).astype(np.float32)
    lambdas = np.linspace(0.5, 0.1, K).astype(np.float32)
    st = SolverSettings(abs_tol=1e-5, rel_tol=1e-5)
    f = FunctionVector(Function.SQUARE, m, dtype=jnp.float32)
    g = FunctionVector(Function.ABS, n, c=0.3, dtype=jnp.float32)
    kw = {"f_b_batch": B}
    if with_lambdas:
        kw["g_c_batch"] = lambdas
    batch = batched_graph_solve(A, f, g, settings=st, **kw)
    c = lambdas if with_lambdas else [0.3] * K
    _assert_lanes_match(batch, _lane_refs(A, B, c, st), x_atol=1e-3)


def test_warm_path_matches_sequential_warm_solves():
    """solve_lasso_path(warm=True) — one lax.scan carrying (z, z̃, ρ) —
    against the same λ sequence solved by one GraphFormSolver, whose final
    iterate warm-starts the next solve."""
    rng = np.random.default_rng(7)
    m, n, K = 100, 60, 12
    A = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    lam_max = float(np.max(np.abs(A.T @ b)))
    lambdas = (np.geomspace(0.5, 0.05, K) * lam_max).astype(np.float32)
    st = SolverSettings(abs_tol=1e-5, rel_tol=1e-5)
    path = solve_lasso_path(A, b, lambdas, settings=st, warm=True)
    solver = GraphFormSolver(A, dtype=jnp.float32, settings=st)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=jnp.float32)
    seq = []
    for lam in lambdas:
        g = FunctionVector(Function.ABS, n, c=lam, dtype=jnp.float32)
        seq.append(solver.solve(f, g))
    assert all(r.status == Status.SUCCESS for r in seq)
    assert bool(np.all(np.asarray(path["status"]) == 0))
    np.testing.assert_allclose(np.asarray(path["optval"]),
                               [float(r.optval) for r in seq], rtol=1e-3)
    np.testing.assert_allclose(np.asarray(path["x"]),
                               np.stack([np.asarray(r.x) for r in seq]),
                               atol=1e-3)
    # Warm-started continuation needs fewer iterations than a cold solve.
    iters = np.asarray(path["iterations"])
    assert int(np.min(iters[1:])) <= int(iters[0])
