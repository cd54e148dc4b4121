"""Graph-form solver integration tests — analytic oracles + KKT checks.

Mirrors the reference's strategy (tests/test_solver.cpp): lasso/ridge with
closed-form answers, NNLS nonnegativity vs scipy, logistic gradient
optimality, warm-started λ-path behavior, and f32 tolerance attainment.
"""

import numpy as np
import pytest
import jax.numpy as jnp
from scipy.optimize import nnls as scipy_nnls

import pogs_tpu
from pogs_tpu import (
    Function,
    FunctionVector,
    GraphFormSolver,
    SolverSettings,
    Status,
    solve_lasso,
    solve_ridge,
    solve_elastic_net,
    solve_logistic,
    solve_huber,
    solve_svm,
    solve_nonneg_ls,
)


def _lasso_kkt_gap(A, b, lam, x):
    """max violation of the lasso optimality conditions."""
    g = A.T @ (A @ x - b)
    viol = np.where(
        np.abs(x) > 1e-6,
        np.abs(g + lam * np.sign(x)),
        np.maximum(np.abs(g) - lam, 0.0),
    )
    return float(np.max(viol))


def test_lasso_identity_soft_threshold(rng):
    # With A = I: minimize 0.5 (x - b)^2 + lam |x| -> soft threshold.
    n = 16
    b = rng.normal(size=n) * 2
    lam = 0.5
    res = solve_lasso(np.eye(n), b, lam, abs_tol=1e-7, rel_tol=1e-7)
    expect = np.sign(b) * np.maximum(np.abs(b) - lam, 0.0)
    np.testing.assert_allclose(res["x"], expect, atol=1e-4)
    assert res["status"] == Status.SUCCESS


def test_lasso_random_kkt(rng):
    m, n = 60, 30
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    lam = 0.2 * np.max(np.abs(A.T @ b))
    res = solve_lasso(A, b, lam, abs_tol=1e-7, rel_tol=1e-7)
    assert res["status"] == Status.SUCCESS
    assert _lasso_kkt_gap(A, b, lam, res["x"]) < 1e-3
    # Objective value agrees with the one recomputed from x.
    obj = 0.5 * np.sum((A @ res["x"] - b) ** 2) + lam * np.sum(np.abs(res["x"]))
    np.testing.assert_allclose(res["optval"], obj, rtol=1e-3)


def test_ridge_closed_form(rng):
    m, n = 50, 20
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    lam = 0.7
    res = solve_ridge(A, b, lam, abs_tol=1e-8, rel_tol=1e-8)
    expect = np.linalg.solve(A.T @ A + lam * np.eye(n), A.T @ b)
    np.testing.assert_allclose(res["x"], expect, atol=2e-4)


def test_wide_matrix_ridge(rng):
    m, n = 20, 50
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    lam = 0.5
    res = solve_ridge(A, b, lam, abs_tol=1e-8, rel_tol=1e-8)
    expect = np.linalg.solve(A.T @ A + lam * np.eye(n), A.T @ b)
    np.testing.assert_allclose(res["x"], expect, atol=2e-4)


def test_nonneg_ls(rng):
    m, n = 40, 15
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    res = solve_nonneg_ls(A, b, abs_tol=1e-8, rel_tol=1e-8)
    assert np.all(np.asarray(res["x"]) >= -1e-6)
    x_ref, _ = scipy_nnls(A, b)
    obj = 0.5 * np.sum((A @ res["x"] - b) ** 2)
    obj_ref = 0.5 * np.sum((A @ x_ref - b) ** 2)
    assert obj <= obj_ref * (1 + 1e-3) + 1e-6


def test_logistic_gradient_optimality(rng):
    m, n = 80, 10
    A = rng.normal(size=(m, n))
    w_true = rng.normal(size=n)
    b = np.sign(A @ w_true + 0.1 * rng.normal(size=m))
    lam = 0.1
    res = solve_logistic(A, b, lam, abs_tol=1e-7, rel_tol=1e-7)
    x = np.asarray(res["x"])
    # gradient of sum log(1+exp(-b a'x)) is A' (-b * sigmoid(-b (Ax)))
    z = -b * (A @ x)
    grad = A.T @ (-b * (1.0 / (1.0 + np.exp(-z))))
    viol = np.where(
        np.abs(x) > 1e-6,
        np.abs(grad + lam * np.sign(x)),
        np.maximum(np.abs(grad) - lam, 0.0),
    )
    assert np.max(viol) < 5e-3


def test_elastic_net_kkt(rng):
    m, n = 50, 25
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    l1, l2 = 0.3, 0.4
    res = solve_elastic_net(A, b, l1, l2, abs_tol=1e-8, rel_tol=1e-8)
    x = np.asarray(res["x"])
    g = A.T @ (A @ x - b) + l2 * x
    viol = np.where(
        np.abs(x) > 1e-6,
        np.abs(g + l1 * np.sign(x)),
        np.maximum(np.abs(g) - l1, 0.0),
    )
    assert np.max(viol) < 1e-3


def test_huber_solves(rng):
    m, n = 40, 15
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    res = solve_huber(A, b, delta=1.0, abs_tol=1e-6, rel_tol=1e-6)
    assert res["status"] == Status.SUCCESS
    # Huber gradient optimality: psi(r) = clip(r, -1, 1), A' psi(Ax-b) = 0.
    r = A @ np.asarray(res["x"]) - b
    grad = A.T @ np.clip(r, -1.0, 1.0)
    assert np.max(np.abs(grad)) < 5e-3


def test_svm_objective_reasonable(rng):
    m, n = 60, 10
    A = rng.normal(size=(m, n))
    b = np.sign(rng.normal(size=m))
    res = solve_svm(A, b, lambd=1.0, abs_tol=1e-6, rel_tol=1e-6)
    x = np.asarray(res["x"])
    obj = np.sum(np.maximum(0, 1 - b * (A @ x))) + 0.5 * np.sum(x**2)
    np.testing.assert_allclose(res["optval"], obj, rtol=1e-2)
    # x = 0 must not beat the solution.
    assert obj <= m + 1e-6


def test_warm_start_lambda_path(rng):
    """The λ-path pattern (examples/cpp/lasso_path.cpp): reusing the solver
    warm-starts each solve; later solves should take few iterations."""
    m, n = 60, 30
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    lam_max = np.max(np.abs(A.T @ b))
    solver = GraphFormSolver(A, dtype=jnp.float64)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=jnp.float64)
    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6)
    iters = []
    for frac in [0.5, 0.45, 0.4]:
        g = FunctionVector(Function.ABS, n, c=frac * lam_max, dtype=jnp.float64)
        res = solver.solve(f, g, settings=st)
        assert res.status == Status.SUCCESS
        iters.append(int(res.final_iter))
        assert _lasso_kkt_gap(A, b, frac * lam_max, np.asarray(res.x)) < 1e-2
    # Warm-started continuation solves should be cheaper than the first.
    assert iters[1] < iters[0]
    assert iters[2] < iters[0]


def test_float32_reaches_default_tolerance(rng):
    """f32 (the accelerator's working dtype) must attain the default 1e-4 tolerances."""
    m, n = 100, 60
    A = rng.normal(size=(m, n)).astype(np.float32)
    b = rng.normal(size=m).astype(np.float32)
    lam = 0.2 * float(np.max(np.abs(A.T @ b)))
    res = solve_lasso(A, b, lam, dtype=jnp.float32)
    assert res["status"] == Status.SUCCESS
    assert _lasso_kkt_gap(A.astype(np.float64), b.astype(np.float64), lam,
                          res["x"].astype(np.float64)) < 1e-1


def test_cgls_projector_path(rng):
    m, n = 60, 30
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    lam = 0.3 * np.max(np.abs(A.T @ b))
    solver = GraphFormSolver(A, projector="cgls", dtype=jnp.float64)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=jnp.float64)
    g = FunctionVector(Function.ABS, n, c=lam, dtype=jnp.float64)
    res = solver.solve(f, g, settings=SolverSettings(abs_tol=1e-6, rel_tol=1e-6))
    assert res.status == Status.SUCCESS
    assert _lasso_kkt_gap(A, b, lam, np.asarray(res.x)) < 1e-2


def test_max_iter_status(rng):
    m, n = 40, 20
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    res = solve_lasso(A, b, 0.1, abs_tol=1e-12, rel_tol=1e-12, max_iter=3)
    assert res["status"] == Status.MAX_ITER
    assert res["iterations"] == 2  # 0-based final_iter at break


def test_f32_tolerance_attainment_family():
    """All five README problem families reach SUCCESS at default tolerances
    in float32 (the accelerator's working iterate precision)."""
    import numpy as np
    import jax.numpy as jnp
    from pogs_tpu import (
        solve_lasso, solve_ridge, solve_elastic_net, solve_logistic,
        solve_svm, Status,
    )

    rng = np.random.default_rng(9)
    m, n = 120, 60
    A = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    labels = np.sign(rng.standard_normal(m)).astype(np.float32)
    lam = 0.2 * float(np.max(np.abs(A.T @ b)))

    runs = [
        solve_lasso(A, b, lam, dtype=jnp.float32),
        solve_ridge(A, b, 0.5, dtype=jnp.float32),
        solve_elastic_net(A, b, 0.5 * lam, 0.3, dtype=jnp.float32),
        solve_logistic(A, labels, 0.1, dtype=jnp.float32),
        solve_svm(A, labels, 1.0, dtype=jnp.float32),
    ]
    for out in runs:
        assert out["status"] == int(Status.SUCCESS)
        assert np.all(np.isfinite(out["x"]))


def test_f32_rho_clamp_is_load_bearing(monkeypatch):
    """Regression pin for the tightened f32 adaptive-rho bounds
    (admm.py K_RHO_MIN_F32/K_RHO_MAX_F32 = [1e-2, 1e2]).

    Under the reference's bounds [1e-4, 1e4] (pogs.cpp:94-96) an f32 NNLS
    solve stalls permanently: adaptive rho spirals toward 1e-4, zt = dual/rho
    grows, and the dual residual sits on the f32 cancellation floor above
    eps_dua.  This test reproduces that stall and asserts the shipped clamp
    fixes it, so restoring the reference bounds for f32 fails loudly.

    The two solves use different max_iter values on purpose: the jitted
    solve is cached per-settings, and the clamp constants are baked in at
    trace time.
    """
    import numpy as np
    import pogs_tpu.solver.admm as admm_mod
    from pogs_tpu import solve_nonneg_ls, Status

    rng = np.random.default_rng(0)
    A = rng.standard_normal((300, 150)).astype(np.float32)
    b = (A @ np.abs(rng.standard_normal(150))
         + 0.1 * rng.standard_normal(300)).astype(np.float32)

    monkeypatch.setattr(admm_mod, "K_RHO_MIN_F32", 1e-4)
    monkeypatch.setattr(admm_mod, "K_RHO_MAX_F32", 1e4)
    stalled = solve_nonneg_ls(A, b, max_iter=2501)
    assert stalled["status"] == int(Status.MAX_ITER), (
        "the f32 stall under the reference rho bounds no longer reproduces; "
        "if the loop changed, re-validate whether the tightened clamp is "
        "still needed (admm.py:52-58)")

    monkeypatch.setattr(admm_mod, "K_RHO_MIN_F32", 1e-2)
    monkeypatch.setattr(admm_mod, "K_RHO_MAX_F32", 1e2)
    fixed = solve_nonneg_ls(A, b, max_iter=2500)
    assert fixed["status"] == int(Status.SUCCESS)
    assert fixed["iterations"] < 1000
