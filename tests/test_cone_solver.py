"""Cone-form solver tests: LP/SOC via HSDE, standard-form LP via the
graph-form cone path, infeasibility/unboundedness certificates.

Mirrors tests/test_solver.cpp:14-41 (cone LP with known solution) and the
legacy tests/test_cone.cpp cases, with scipy.linprog as oracle.
"""

import numpy as np
import pytest
import jax.numpy as jnp
from scipy.optimize import linprog

from pogs_tpu.types import Cone, ConeConstraint, SolverSettings, Status
from pogs_tpu.solver.cone import ConeSolver


def _settings(**kw):
    base = dict(abs_tol=1e-6, rel_tol=1e-6, max_iter=20000)
    base.update(kw)
    return SolverSettings(**base)


def test_hsde_lp_known_solution():
    # min -x1 - 2 x2  s.t.  x1 + x2 <= 1, x >= 0  -> x* = (0, 1), val -2.
    A = np.array([[1.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    b = np.array([1.0, 0.0, 0.0])
    c = np.array([-1.0, -2.0])
    Ky = [ConeConstraint(Cone.NON_NEG, [0, 1, 2])]
    solver = ConeSolver(A, Ky=Ky, dtype=jnp.float64)
    res = solver.solve(b, c, settings=_settings())
    assert res.status == Status.SUCCESS
    np.testing.assert_allclose(np.asarray(res.x), [0.0, 1.0], atol=1e-4)
    np.testing.assert_allclose(float(res.optval), -2.0, atol=1e-4)


def test_hsde_lp_vs_scipy(rng):
    m, n = 30, 15
    A = rng.normal(size=(m, n))
    x0 = rng.random(n)
    b = A @ x0 + rng.random(m)  # strictly feasible
    c = rng.normal(size=n)
    # bounded: add box rows x <= 2, -x <= 2
    A_full = np.vstack([A, np.eye(n), -np.eye(n)])
    b_full = np.concatenate([b, 2 * np.ones(n), 2 * np.ones(n)])
    Ky = [ConeConstraint(Cone.NON_NEG, range(A_full.shape[0]))]
    solver = ConeSolver(A_full, Ky=Ky, dtype=jnp.float64)
    res = solver.solve(b_full, c, settings=_settings())
    assert res.status == Status.SUCCESS
    ref = linprog(c, A_ub=A_full, b_ub=b_full, bounds=(None, None), method="highs")
    assert ref.success
    np.testing.assert_allclose(float(res.optval), ref.fun, rtol=1e-3, atol=1e-4)
    # primal feasibility
    assert np.max(A_full @ np.asarray(res.x) - b_full) < 1e-4


def test_hsde_lp_with_equality(rng):
    # min c'x s.t. Ax = b (zero cone rows) + x >= -5 box (nonneg rows).
    m, n = 8, 12
    A = rng.normal(size=(m, n))
    x0 = rng.normal(size=n)
    b = A @ x0
    c = rng.normal(size=n)
    A_full = np.vstack([A, -np.eye(n)])
    b_full = np.concatenate([b, 5 * np.ones(n)])
    Ky = [ConeConstraint(Cone.ZERO, range(m)),
          ConeConstraint(Cone.NON_NEG, range(m, m + n))]
    solver = ConeSolver(A_full, Ky=Ky, dtype=jnp.float64)
    res = solver.solve(b_full, c, settings=_settings())
    assert res.status == Status.SUCCESS
    x = np.asarray(res.x)
    np.testing.assert_allclose(A @ x, b, atol=1e-4)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(-5, None), method="highs")
    assert ref.success
    np.testing.assert_allclose(float(res.optval), ref.fun, rtol=1e-3, atol=1e-4)


def test_hsde_soc_ball():
    # min c'x s.t. ||x|| <= 1  ->  x* = -c/||c||, val -||c||.
    n = 5
    c = np.array([1.0, -2.0, 0.5, 0.0, 1.5])
    # b - Ax = (1, x) in SOC: first row A=0,b=1; rows 1..n A=-I, b=0.
    A = np.vstack([np.zeros((1, n)), -np.eye(n)])
    b = np.concatenate([[1.0], np.zeros(n)])
    Ky = [ConeConstraint(Cone.SOC, range(n + 1))]
    solver = ConeSolver(A, Ky=Ky, dtype=jnp.float64)
    res = solver.solve(b, c, settings=_settings())
    assert res.status == Status.SUCCESS
    cn = np.linalg.norm(c)
    np.testing.assert_allclose(np.asarray(res.x), -c / cn, atol=1e-4)
    np.testing.assert_allclose(float(res.optval), -cn, atol=1e-4)


def test_graph_cone_path_standard_lp(rng):
    # Kx non-empty -> graph-form cone ADMM: min c'x s.t. Ax = b, x >= 0.
    m, n = 6, 10
    A = rng.normal(size=(m, n))
    x0 = rng.random(n) + 0.1
    b = A @ x0
    c = rng.random(n) + 0.5  # positive costs -> bounded
    Kx = [ConeConstraint(Cone.NON_NEG, range(n))]
    Ky = [ConeConstraint(Cone.ZERO, range(m))]
    solver = ConeSolver(A, Kx=Kx, Ky=Ky, dtype=jnp.float64)
    res = solver.solve(b, c, settings=_settings(abs_tol=1e-7, rel_tol=1e-7))
    assert res.status == Status.SUCCESS
    x = np.asarray(res.x)
    assert np.all(x >= -1e-5)
    np.testing.assert_allclose(A @ x, b, atol=1e-3)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    assert ref.success
    np.testing.assert_allclose(float(res.optval), ref.fun, rtol=1e-2, atol=1e-3)


def test_hsde_infeasible():
    # x >= 1 and x <= 0: infeasible.
    A = np.array([[-1.0], [1.0]])
    b = np.array([-1.0, 0.0])
    c = np.array([1.0])
    Ky = [ConeConstraint(Cone.NON_NEG, [0, 1])]
    solver = ConeSolver(A, Ky=Ky, dtype=jnp.float64)
    res = solver.solve(b, c, settings=_settings(max_iter=5000))
    assert res.status == Status.INFEASIBLE


def test_hsde_unbounded():
    # min -x s.t. x >= 0: unbounded below.
    A = np.array([[-1.0]])
    b = np.array([0.0])
    c = np.array([-1.0])
    Ky = [ConeConstraint(Cone.NON_NEG, [0])]
    solver = ConeSolver(A, Ky=Ky, dtype=jnp.float64)
    res = solver.solve(b, c, settings=_settings(max_iter=5000))
    assert res.status == Status.UNBOUNDED


@pytest.mark.parametrize("strategy", ["smw", "inverse", "cg"])
def test_hsde_strategies_agree(rng, strategy):
    m, n = 20, 10
    A = rng.normal(size=(m, n))
    b = A @ rng.random(n) + rng.random(m)
    c = rng.normal(size=n)
    A_full = np.vstack([A, np.eye(n), -np.eye(n)])
    b_full = np.concatenate([b, 3 * np.ones(n), 3 * np.ones(n)])
    Ky = [ConeConstraint(Cone.NON_NEG, range(A_full.shape[0]))]
    solver = ConeSolver(A_full, Ky=Ky, strategy=strategy, dtype=jnp.float64)
    res = solver.solve(b_full, c, settings=_settings())
    assert res.status == Status.SUCCESS
    ref = linprog(c, A_ub=A_full, b_ub=b_full, bounds=(None, None), method="highs")
    np.testing.assert_allclose(float(res.optval), ref.fun, rtol=1e-3, atol=1e-4)


def test_hsde_qp(rng):
    # min 0.5 x'Px + c'x s.t. x >= 0, with P PSD. Oracle: projected closed
    # form via active-set-free case (interior solution).
    n = 6
    M = rng.normal(size=(n, n))
    P = M @ M.T + np.eye(n)
    x_star = rng.random(n) + 0.5        # interior target
    c = -(P @ x_star)                    # unconstrained optimum at x_star > 0
    A = -np.eye(n)
    b = np.zeros(n)
    Ky = [ConeConstraint(Cone.NON_NEG, range(n))]
    solver = ConeSolver(A, Ky=Ky, strategy="inverse", dtype=jnp.float64)
    res = solver.solve(b, c, P=P, settings=_settings(max_iter=20000))
    assert res.status == Status.SUCCESS
    np.testing.assert_allclose(np.asarray(res.x), x_star, atol=1e-3)


def test_hsde_strategies_agree():
    """All three HSDE linear-solve strategies produce the same LP solution
    (SURVEY.md §2.1: SMW / direct normal-equations / Jacobi-PCG)."""
    import numpy as np
    from pogs_tpu.types import Cone, ConeConstraint, Status
    from pogs_tpu.api.cone import solve_cone

    A = np.array([[1.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    b = np.array([1.0, 0.0, 0.0])
    c = np.array([1.0, 2.0])
    Ky = [ConeConstraint(Cone.ZERO, [0]), ConeConstraint(Cone.NON_NEG, [1, 2])]

    vals = {}
    for strat in ("smw", "direct", "cg"):
        out = solve_cone(A, b, c, Ky=Ky, strategy=strat,
                         abs_tol=1e-7, rel_tol=1e-7, dtype="float64")
        assert out["status"] == int(Status.SUCCESS), strat
        vals[strat] = out["optval"]
    assert abs(vals["smw"] - 1.0) < 1e-4
    assert abs(vals["direct"] - vals["smw"]) < 1e-4
    assert abs(vals["cg"] - vals["smw"]) < 1e-4


def test_hsde_warm_start_receding_horizon():
    """warm_start=True reuses the previous embedding iterate: a perturbed-b
    re-solve converges in (far) fewer iterations (receding-horizon MPC
    pattern; no reference counterpart)."""
    import numpy as np
    from pogs_tpu.types import Cone, ConeConstraint, SolverSettings, Status
    from pogs_tpu.solver.cone import ConeSolver

    rng = np.random.default_rng(0)
    n = 10
    x0 = rng.standard_normal(n)
    c = rng.standard_normal(n)
    A = np.vstack([np.zeros((1, n)), -np.eye(n)])
    b = np.concatenate([[1.5], -x0])
    Ky = [ConeConstraint(Cone.SOC, range(n + 1))]
    st = SolverSettings(abs_tol=1e-7, rel_tol=1e-7)
    solver = ConeSolver(A, Ky=Ky, settings=st, dtype="float64")

    r_cold = solver.solve(b, c, warm_start=True)  # first call: still cold
    assert r_cold.status == Status.SUCCESS
    # Slightly shifted center: warm start should cut iterations sharply.
    b2 = b + 1e-3 * rng.standard_normal(n + 1)
    r_warm = solver.solve(b2, c, warm_start=True)
    assert r_warm.status == Status.SUCCESS
    assert int(r_warm.final_iter) <= int(r_cold.final_iter) // 2
    # Same problem solved cold for value comparison.
    r_cold2 = ConeSolver(A, Ky=Ky, settings=st, dtype="float64").solve(b2, c)
    assert float(r_warm.optval) == pytest.approx(float(r_cold2.optval),
                                                 rel=1e-5, abs=1e-6)


# ---------------------------------------------------------------------------
# qp_via="admm": graph-form cone ADMM with quadratic x-prox (the
# reference's PogsObjectiveCone x-step, ρ-shift via one-time eigh of the
# scaled P).  Kept as an option: measured weaker than the epigraph-SOC
# HSDE seed on ill-conditioned CVXQP instances (as is the native
# runtime's independent implementation of the same split), so "socp"
# stays the default.
# ---------------------------------------------------------------------------

def test_qp_via_admm_matches_socp(rng):
    from scipy.optimize import minimize

    from pogs_tpu.api.cone import solve_cone
    from pogs_tpu.types import Cone, ConeConstraint

    n = 15
    B = rng.normal(size=(n, n))
    P = B @ B.T + 0.5 * np.eye(n)
    c = rng.normal(size=n)
    A = np.vstack([np.ones((1, n)), np.eye(n), -np.eye(n)])
    b = np.concatenate([[1.0], np.full(n, 1.0), np.full(n, 1.0)])
    Ky = [ConeConstraint(Cone.ZERO, [0]),
          ConeConstraint(Cone.NON_NEG, range(1, 1 + 2 * n))]
    kw = dict(Kx=(), Ky=Ky, P=P, dtype=np.float64,
              abs_tol=1e-6, rel_tol=1e-6, max_iter=3000)
    r_admm = solve_cone(A, b, c, qp_via="admm", **kw)
    r_socp = solve_cone(A, b, c, qp_via="socp", **kw)
    ref = minimize(
        lambda x: 0.5 * x @ P @ x + c @ x, np.zeros(n),
        jac=lambda x: P @ x + c,
        constraints=[{"type": "eq", "fun": lambda x: x.sum() - 1.0,
                      "jac": lambda x: np.ones(n)}],
        bounds=[(-1.0, 1.0)] * n, method="SLSQP",
        options={"maxiter": 1000, "ftol": 1e-14})
    assert r_admm["status"] == 0
    assert r_socp["status"] == 0
    assert r_admm["optval"] == pytest.approx(float(ref.fun), rel=1e-6, abs=1e-6)
    assert r_socp["optval"] == pytest.approx(float(ref.fun), rel=1e-6, abs=1e-6)


def test_qp_via_validation():
    from pogs_tpu.solver.cone import ConeSolver

    with pytest.raises(ValueError, match="qp_via"):
        ConeSolver(np.eye(3), qp_via="bogus")


def test_qp_warm_start_cuts_iterations(rng):
    """The QP (epigraph-SOC) route must thread warm_start to the extended
    solver: a perturbed-b re-solve is the receding-horizon MPC pattern."""
    from pogs_tpu.solver.cone import ConeSolver
    from pogs_tpu.types import Cone, ConeConstraint, SolverSettings

    n = 30
    B = rng.normal(size=(n, n))
    P = B @ B.T + 0.5 * np.eye(n)
    c = rng.normal(size=n)
    A = np.vstack([np.ones((1, n)), np.eye(n), -np.eye(n)])
    b = np.concatenate([[1.0], np.full(n, 1.0), np.full(n, 1.0)])
    Ky = [ConeConstraint(Cone.ZERO, [0]),
          ConeConstraint(Cone.NON_NEG, range(1, 1 + 2 * n))]
    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=20000,
                        polish=False)
    s = ConeSolver(A, Ky=Ky, settings=st, dtype=np.float64)
    s.solve(b, c, P=P, settings=st)
    b2 = b.copy()
    b2[0] = 1.01
    cold = ConeSolver(A, Ky=Ky, settings=st, dtype=np.float64).solve(
        b2, c, P=P, settings=st)
    warm = s.solve(b2, c, P=P, settings=st, warm_start=True)
    assert int(warm.final_iter) < 0.6 * int(cold.final_iter)
    assert float(warm.optval) == pytest.approx(float(cold.optval),
                                               rel=1e-5, abs=1e-6)


def test_qp_certificates_flow_through_epigraph():
    """Infeasibility/unboundedness certificates of the extended SOCP map
    back to the original QP (the epigraph reformulation preserves both:
    its feasible set projects onto the QP's, and a QP descent ray is an
    epigraph descent ray).  Fixed seed: certificate firing time varies
    with the instance, and this one certifies well within the cap."""
    from pogs_tpu.api.cone import solve_cone
    from pogs_tpu.types import Cone, ConeConstraint, Status

    n = 8
    B = np.random.default_rng(0).normal(size=(n, n))
    P = B @ B.T + np.eye(n)
    A = np.vstack([np.ones((1, n)), np.ones((1, n)), np.eye(n), -np.eye(n)])
    b = np.concatenate([[1.0], [3.0], np.full(n, 1.0), np.full(n, 1.0)])
    Ky = [ConeConstraint(Cone.ZERO, [0, 1]),
          ConeConstraint(Cone.NON_NEG, range(2, 2 + 2 * n))]
    r = solve_cone(A, b, np.zeros(n), Kx=(), Ky=Ky, P=P, dtype=np.float64,
                   abs_tol=1e-6, rel_tol=1e-6, max_iter=20000)
    assert Status(r["status"]) == Status.INFEASIBLE

    P2 = np.zeros((n, n))
    P2[0, 0] = 1.0           # singular P: descent direction in null(P)
    c2 = np.zeros(n)
    c2[1] = 1.0              # min x2, x2 unbounded below
    r2 = solve_cone(np.eye(n)[:1], np.array([1.0]), c2, Kx=(),
                    Ky=[ConeConstraint(Cone.NON_NEG, [0])], P=P2,
                    dtype=np.float64, abs_tol=1e-6, rel_tol=1e-6,
                    max_iter=5000)
    assert Status(r2["status"]) == Status.UNBOUNDED


def test_qp_with_soc_constraint_vs_slsqp():
    """QP over a mixed SOC+box cone: non-polyhedral K_y means no PDAS
    polish, so this pins the raw HSDE-epigraph accuracy on the
    trust-region-style problem min ½xᵀPx + cᵀx s.t. ‖x−x₀‖ ≤ r, |x| ≤ 2."""
    from scipy.optimize import minimize

    from pogs_tpu.api.cone import solve_cone
    from pogs_tpu.types import Cone, ConeConstraint

    rng = np.random.default_rng(4)
    n = 10
    B = rng.normal(size=(n, n))
    P = B @ B.T + np.eye(n)
    c = rng.normal(size=n)
    x0 = rng.normal(size=n) * 0.3
    r_ball = 0.8
    A = np.vstack([np.zeros((1, n)), -np.eye(n), np.eye(n), -np.eye(n)])
    b = np.concatenate([[r_ball], -x0, np.full(n, 2.0), np.full(n, 2.0)])
    Ky = [ConeConstraint(Cone.SOC, range(n + 1)),
          ConeConstraint(Cone.NON_NEG, range(n + 1, n + 1 + 2 * n))]
    out = solve_cone(A, b, c, Kx=(), Ky=Ky, P=P, dtype=np.float64,
                     abs_tol=1e-7, rel_tol=1e-7, max_iter=40000)
    ref = minimize(
        lambda x: 0.5 * x @ P @ x + c @ x, x0, jac=lambda x: P @ x + c,
        constraints=[{"type": "ineq",
                      "fun": lambda x: r_ball**2 - (x - x0) @ (x - x0),
                      "jac": lambda x: -2 * (x - x0)}],
        bounds=[(-2.0, 2.0)] * n, method="SLSQP",
        options={"maxiter": 1000, "ftol": 1e-14})
    assert out["status"] == 0
    assert out["optval"] == pytest.approx(float(ref.fun), rel=1e-5, abs=1e-5)


def _slsqp_min(c, cons, x0):
    """Independent oracle for small smooth conic programs: SLSQP on
    min c'x subject to scalar inequality functions g(x) >= 0."""
    from scipy.optimize import minimize

    res = minimize(lambda x: c @ x, x0, jac=lambda x: c, method="SLSQP",
                   constraints=[{"type": "ineq", "fun": g} for g in cons],
                   options={"ftol": 1e-12, "maxiter": 500})
    assert res.success, res.message
    return res.x


def _hsde_instance(name):
    """(A, b, c, Ky, check) for one f32 HSDE instance; ``check(status, x)``
    compares with HiGHS, SLSQP or a closed form."""
    rng = np.random.default_rng(5)
    if name == "lp_equality":
        # min x1 + 2 x2 s.t. x1 + x2 = 1, x >= 0  ->  x* = (1, 0).
        A = np.array([[1.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
        b = np.array([1.0, 0.0, 0.0])
        c = np.array([1.0, 2.0])
        Ky = [ConeConstraint(Cone.ZERO, [0]),
              ConeConstraint(Cone.NON_NEG, [1, 2])]
        ref = linprog(c, A_eq=A[:1], b_eq=b[:1], bounds=(0, None),
                      method="highs")

        def check(status, x):
            assert status == Status.SUCCESS
            np.testing.assert_allclose(x, ref.x, atol=1e-3)
        return A, b, c, Ky, check
    if name == "soc_ball":
        # min c'x s.t. ||x - x0|| <= 1.5  ->  x* = x0 - 1.5 c/||c||.
        n = 9
        x0 = rng.standard_normal(n)
        c = rng.standard_normal(n)
        A = np.vstack([np.zeros((1, n)), -np.eye(n)])
        b = np.concatenate([[1.5], -x0])
        Ky = [ConeConstraint(Cone.SOC, range(n + 1))]

        def check(status, x):
            assert status == Status.SUCCESS
            np.testing.assert_allclose(
                x, x0 - 1.5 * c / np.linalg.norm(c), atol=2e-3)
        return A, b, c, Ky, check
    if name == "equality_wide":
        # m < n equality rows with c in the row space of A: the objective
        # is constant on the feasible set, c'x = w'b for c = A'w.
        A = rng.standard_normal((3, 8))
        b = A @ rng.standard_normal(8)
        w = rng.standard_normal(3)
        c = A.T @ w
        Ky = [ConeConstraint(Cone.ZERO, range(3))]

        def check(status, x):
            assert status == Status.SUCCESS
            np.testing.assert_allclose(A @ x, b, atol=1e-3)
            assert float(c @ x) == pytest.approx(float(w @ b), abs=2e-3)
        return A, b, c, Ky, check
    if name == "infeasible":
        # x >= 1 and x <= 0.
        A = np.array([[-1.0], [1.0]])
        b = np.array([-1.0, 0.0])
        c = np.array([1.0])
        Ky = [ConeConstraint(Cone.NON_NEG, [0, 1])]

        def check(status, x):
            assert status == Status.INFEASIBLE
        return A, b, c, Ky, check
    if name == "unbounded":
        # min -x s.t. x >= 0.
        A = np.array([[-1.0]])
        b = np.array([0.0])
        c = np.array([-1.0])
        Ky = [ConeConstraint(Cone.NON_NEG, [0])]

        def check(status, x):
            assert status == Status.UNBOUNDED
        return A, b, c, Ky, check
    if name == "soc_segments":
        # 8 second-order-cone segments b_k - F_k x in SOC: constant heads
        # (bounded feasible set) large enough that x = 0 is strictly
        # feasible.
        nseg, L, n = 8, 8, 30
        F = rng.standard_normal((nseg * L, n)) * 0.3
        F[::L] = 0.0
        c = rng.standard_normal(n)
        b = np.abs(rng.standard_normal(nseg * L)) + 0.5
        for k in range(nseg):
            b[k * L] = np.linalg.norm(b[k * L + 1:(k + 1) * L]) + 2.0
        Ky = [ConeConstraint(Cone.SOC, range(k * L, (k + 1) * L))
              for k in range(nseg)]

        def seg(k):  # s0 >= 0 and s0^2 - |s_rest|^2 >= 0: smooth
            def g(x):
                s = b[k * L:(k + 1) * L] - F[k * L:(k + 1) * L] @ x
                return np.array([s[0], s[0] ** 2 - s[1:] @ s[1:]])
            return g
        ref = _slsqp_min(c, [seg(k) for k in range(nseg)], np.zeros(n))

        def check(status, x):
            assert status == Status.SUCCESS
            assert float(c @ x) == pytest.approx(float(c @ ref), rel=1e-3,
                                                 abs=1e-3)
        return F, b, c, Ky, check
    if name == "exp_cone":
        # maximize r s.t. (r, 1, e) in K_exp  ->  r* = 1.
        A = np.array([[-1.0], [0.0], [0.0]])
        b = np.array([0.0, 1.0, float(np.e)])
        c = np.array([-1.0])
        Ky = [ConeConstraint(Cone.EXP_PRIMAL, [0, 1, 2])]

        def check(status, x):
            assert status == Status.SUCCESS
            assert float(x[0]) == pytest.approx(1.0, abs=5e-3)
        return A, b, c, Ky, check
    assert name == "mixed_exp_soc_nonneg"
    # ||x - x0|| <= 2 (SOC), x[0] <= 1 (exp-cone row (x0, 1, e)),
    # A_nn x <= b_nn (nonneg rows).
    n = 4
    x0 = rng.standard_normal(n)
    c = rng.standard_normal(n)
    A_exp = np.zeros((3, n))
    A_exp[0, 0] = -1.0
    A_nn = rng.standard_normal((2, n))
    b_nn = A_nn @ x0 + 2.0
    A = np.vstack([np.zeros((1, n)), -np.eye(n), A_exp, A_nn])
    b = np.concatenate([[2.0], -x0, [0.0, 1.0, float(np.e)], b_nn])
    Ky = [ConeConstraint(Cone.SOC, range(n + 1)),
          ConeConstraint(Cone.EXP_PRIMAL, [n + 1, n + 2, n + 3]),
          ConeConstraint(Cone.NON_NEG, [n + 4, n + 5])]
    ref = _slsqp_min(c, [lambda x: 4.0 - (x - x0) @ (x - x0),
                         lambda x: 1.0 - x[0],
                         lambda x: b_nn - A_nn @ x], x0)

    def check(status, x):
        assert status == Status.SUCCESS
        assert float(c @ x) == pytest.approx(float(c @ ref), rel=2e-3,
                                             abs=2e-3)
    return A, b, c, Ky, check


@pytest.mark.parametrize("name", [
    "lp_equality", "soc_ball", "equality_wide", "infeasible", "unbounded",
    "soc_segments", "exp_cone", "mixed_exp_soc_nonneg",
])
def test_hsde_instances_f32(name):
    """The XLA HSDE loop in float32 on small instances, each checked
    against HiGHS, SLSQP or a closed form."""
    from pogs_tpu.cones.sets import ConeSet
    from pogs_tpu.solver.hsde import hsde_solve

    A, b, c, Ky, check = _hsde_instance(name)
    out = hsde_solve(jnp.asarray(A, jnp.float32), jnp.asarray(b, jnp.float32),
                     jnp.asarray(c, jnp.float32), ConeSet(Ky, A.shape[0]),
                     strategy="smw", abs_tol=1e-6, rel_tol=1e-6,
                     max_iter=20000)
    w = np.asarray(out["w"], np.float64)
    n = A.shape[1]
    x = w[:n] / w[-1] if w[-1] > 1e-8 else w[:n]
    check(Status(int(out["status"])), x)
