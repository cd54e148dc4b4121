"""Sparse-matrix path: BCOO operators through the CGLS projector / CG HSDE.

Parity target: the reference's MatrixSparse × ProjectorCgls instantiations
(src/cpu/pogs.cpp:1979-2010) and sparse benchmarks (examples/cpp_sp/).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
from scipy.optimize import linprog

from pogs_tpu import (
    Function, FunctionVector, GraphFormSolver, SolverSettings, Status,
    solve_lasso,
)
from pogs_tpu.types import Cone, ConeConstraint
from pogs_tpu.solver.cone import ConeSolver
from pogs_tpu.linalg.matrix import as_matrix_op
from pogs_tpu.linalg.equil import equilibrate


def test_sparse_operator_contract(rng):
    S = sp.random(30, 20, density=0.3, random_state=1, format="csr")
    op = as_matrix_op(S, jnp.float64)
    assert op.is_sparse
    x = rng.normal(size=20)
    y = rng.normal(size=30)
    np.testing.assert_allclose(np.asarray(op.mv(jnp.asarray(x))), S @ x, atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.rmv(jnp.asarray(y))), S.T @ y, atol=1e-12)
    S2 = S.multiply(S)
    np.testing.assert_allclose(np.asarray(op.sq_mv(jnp.asarray(x))), S2 @ x, atol=1e-12)
    d = rng.random(30) + 0.5
    e = rng.random(20) + 0.5
    scaled = op.scale(jnp.asarray(d), jnp.asarray(e))
    ref = sp.diags(d) @ S @ sp.diags(e)
    np.testing.assert_allclose(np.asarray(scaled.mv(jnp.asarray(x))), ref @ x, atol=1e-12)
    np.testing.assert_allclose(float(op.frob2()), (S.data**2).sum(), atol=1e-12)


def test_sparse_equilibration_matches_dense(rng):
    Sd = rng.normal(size=(25, 15)) * (rng.random((25, 15)) < 0.4)
    S = sp.csr_matrix(Sd)
    eq_dense = equilibrate(jnp.asarray(Sd, jnp.float64))
    eq_sparse = equilibrate(as_matrix_op(S, jnp.float64))
    np.testing.assert_allclose(np.asarray(eq_sparse.d), np.asarray(eq_dense.d), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(eq_sparse.e), np.asarray(eq_dense.e), rtol=1e-10)
    x = rng.normal(size=15)
    np.testing.assert_allclose(
        np.asarray(eq_sparse.A.mv(jnp.asarray(x))),
        np.asarray(eq_dense.A) @ x, rtol=1e-8,
    )


def test_sparse_lasso(rng):
    m, n = 80, 40
    Sd = rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.3)
    S = sp.csr_matrix(Sd)
    b = rng.normal(size=m)
    lam = 0.2 * np.max(np.abs(Sd.T @ b))
    solver = GraphFormSolver(S, dtype=jnp.float64)
    assert solver.projector == "cgls"  # sparse forces the indirect projector
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=jnp.float64)
    g = FunctionVector(Function.ABS, n, c=lam, dtype=jnp.float64)
    res = solver.solve(f, g, settings=SolverSettings(abs_tol=1e-7, rel_tol=1e-7))
    assert res.status == Status.SUCCESS
    x = np.asarray(res.x)
    grad = Sd.T @ (Sd @ x - b)
    viol = np.where(np.abs(x) > 1e-6, np.abs(grad + lam * np.sign(x)),
                    np.maximum(np.abs(grad) - lam, 0.0))
    assert np.max(viol) < 1e-2

    # dense solve agrees
    dense = solve_lasso(Sd, b, lam, abs_tol=1e-7, rel_tol=1e-7)
    obj_s = 0.5 * np.sum((Sd @ x - b) ** 2) + lam * np.sum(np.abs(x))
    obj_d = 0.5 * np.sum((Sd @ dense["x"] - b) ** 2) + lam * np.sum(np.abs(dense["x"]))
    np.testing.assert_allclose(obj_s, obj_d, rtol=1e-4)


def test_sparse_cone_lp(rng):
    m0, n = 25, 12
    Sd = rng.normal(size=(m0, n)) * (rng.random((m0, n)) < 0.5)
    b0 = Sd @ rng.random(n) + rng.random(m0)
    c = rng.normal(size=n)
    A_full = sp.vstack([sp.csr_matrix(Sd), sp.eye(n), -sp.eye(n)]).tocsr()
    b = np.concatenate([b0, 2 * np.ones(n), 2 * np.ones(n)])
    Ky = [ConeConstraint(Cone.NON_NEG, range(A_full.shape[0]))]
    solver = ConeSolver(A_full, Ky=Ky, dtype=jnp.float64)
    assert solver.strategy == "cg" and solver.projector == "cgls"
    res = solver.solve(b, c, settings=SolverSettings(
        abs_tol=1e-6, rel_tol=1e-6, max_iter=20000))
    assert res.status == Status.SUCCESS
    ref = linprog(c, A_ub=A_full.toarray(), b_ub=b, bounds=(None, None), method="highs")
    np.testing.assert_allclose(float(res.optval), ref.fun, rtol=1e-3, atol=1e-4)


def test_builders_keep_sparse(rng):
    """solve_lasso with a scipy-sparse A must use the sparse/CGLS path
    (parity: python/pogs/graph.py accepts scipy sparse without densifying)."""
    from pogs_tpu import solve_lasso

    A = sp.random(60, 30, density=0.3, random_state=3, format="csr")
    b = rng.normal(size=60)
    lam = 0.2 * float(np.max(np.abs(A.T @ b)))
    out = solve_lasso(A, b, lam, abs_tol=1e-5, rel_tol=1e-5)
    assert out["status"] == 0
    dense_out = solve_lasso(np.asarray(A.todense()), b, lam,
                            abs_tol=1e-5, rel_tol=1e-5)
    assert out["optval"] == pytest.approx(dense_out["optval"], rel=1e-3)


def test_cone_solver_sparse_policy():
    """ConeSolver shares GraphFormSolver's policy: 'auto' keeps BCOO;
    'densify' forces dense (and the direct projector)."""
    import scipy.sparse as sp

    from pogs_tpu.solver.cone import ConeSolver
    from pogs_tpu.types import Cone, ConeConstraint

    A = sp.random(30, 20, density=0.2, random_state=0, format="csr")
    Ky = [ConeConstraint(Cone.NON_NEG, range(30))]
    s_dense = ConeSolver(A, Ky=Ky, sparse_policy="densify")
    assert not s_dense.A.is_sparse
    s_auto = ConeSolver(A, Ky=Ky)
    assert s_auto.A.is_sparse
    with pytest.raises(ValueError, match="sparse_policy"):
        ConeSolver(A, Ky=Ky, sparse_policy="bogus")
    with pytest.raises(ValueError, match="sparse_policy"):
        ConeSolver(A, Ky=Ky, sparse_policy="keep")


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("kind", ["scipy", "bcoo"])
def test_auto_sparse_policy_keeps_bcoo_on_every_backend(monkeypatch,
                                                        backend, kind):
    """'auto' never densifies, whatever the platform: both solvers keep a
    scipy or BCOO input as BCOO with the CGLS projector."""
    import jax
    import scipy.sparse as sp
    from jax.experimental import sparse as jsparse

    from pogs_tpu.solver.cone import ConeSolver
    from pogs_tpu.solver.graph import GraphFormSolver
    from pogs_tpu.types import Cone, ConeConstraint

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    A = sp.random(40, 25, density=0.5, random_state=1, format="csr")
    if kind == "bcoo":
        A = jsparse.BCOO.from_scipy_sparse(A)
    g = GraphFormSolver(A)
    assert g.A.is_sparse and g.projector == "cgls"
    c = ConeSolver(A, Ky=[ConeConstraint(Cone.NON_NEG, range(40))])
    assert c.A.is_sparse


def test_f32_cgls_noise_floor_regression(rng):
    """Round-4 regression: a warm-started f32 CGLS projection used to burn
    all 500 inner iterations at the f32 noise floor once the ADMM warm
    start got good — the conjugacy-free recurrence then random-walked and
    the outer solve diverged by 6 orders of magnitude (2000x1000 1%-dense
    lasso: MAX_ITER at obj 2.6e6 vs 168.6 converged).  The best-iterate +
    divergence/stall guards in cgls_solve must keep the f32 sparse route
    convergent and matching the direct projector's objective."""
    m, n = 2000, 1000
    A = sp.random(m, n, density=0.01, random_state=3, format="csr")
    A.data[:] = rng.normal(size=A.nnz)
    x_true = np.zeros(n)
    idx = rng.choice(n, n // 20, replace=False)
    x_true[idx] = rng.normal(size=idx.size)
    b = A @ x_true + 0.1 * rng.normal(size=m)
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    st = SolverSettings(abs_tol=1e-4, rel_tol=1e-4, max_iter=2500)
    f = FunctionVector(Function.SQUARE, m, b=np.asarray(b, np.float32),
                       dtype=jnp.float32)
    g = FunctionVector(Function.ABS, n, c=lam, dtype=jnp.float32)

    out = GraphFormSolver(A, dtype=jnp.float32).solve(f, g, settings=st)
    assert out.status == Status.SUCCESS
    assert out.final_iter < 1000

    def canon_obj(x):
        x = np.asarray(x, np.float64)
        r = A @ x - b
        return float(0.5 * r @ r + lam * np.abs(x).sum())

    dense_out = GraphFormSolver(A.toarray().astype(np.float32),
                                dtype=jnp.float32).solve(f, g, settings=st)
    assert canon_obj(out.x) == pytest.approx(canon_obj(dense_out.x), rel=1e-2)


def test_sparse_lp_tail_polish_reaches_tight_tolerance():
    """Round-5 regression: sparse (BCOO-kept) LPs used to be excluded
    from the IPM tail polish, so the DR tail crawled — 1e-6 was
    unreached at 3000 iterations on this instance.  With the polish
    densifying A for its Newton bursts only (256 MiB budget), the solve
    must certify 1e-6 in bounded iterations and match the dense twin."""
    import scipy.sparse as sp

    from pogs_tpu.solver.cone import ConeSolver
    from pogs_tpu.types import Cone, ConeConstraint, SolverSettings, Status

    rng = np.random.default_rng(2)
    Araw = sp.random(800, 300, density=0.02, random_state=8, format="csr")
    Araw.data[:] = rng.standard_normal(Araw.nnz)
    A = sp.vstack([Araw, sp.eye(300), -sp.eye(300)]).tocsr()
    m = A.shape[0]
    x0 = rng.standard_normal(300)
    b = A @ x0 + rng.random(m) + 0.1
    c = rng.standard_normal(300)
    Ky = [ConeConstraint(Cone.NON_NEG, range(m))]
    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=4000)
    r_sp = ConeSolver(A, Ky=Ky, settings=st, dtype=np.float64).solve(b, c, settings=st)
    assert r_sp.status == Status.SUCCESS
    assert int(r_sp.final_iter) <= 3000
    r_d = ConeSolver(A.toarray(), Ky=Ky, settings=st,
                     dtype=np.float64).solve(b, c, settings=st)
    assert r_d.status == Status.SUCCESS
    assert float(r_sp.optval) == pytest.approx(float(r_d.optval),
                                               rel=1e-5, abs=1e-5)
