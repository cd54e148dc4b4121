"""Vendored Maros–Mészáros QP subset (VERDICT round-1 item 5).

The reference's maros_benchmark.py depends on an external checkout
(`~/cvxbench`, reference python/benchmarks/maros_benchmark.py:22-40) that
is unavailable here (no network).  This module vendors a subset of the
collection instead: the small classics from the Hock–Schittkowski family
that Maros & Mészáros included (HS21, HS35, HS51, HS52, HS53, HS76,
TAME), with their published optimal values.

Each problem is stated in the standard convention

    minimize    ½ xᵀ Q x + cᵀ x  (+ c0)
    subject to  rows of (A, sense, rhs): '=' , '<=' or '>='
                lb ≤ x ≤ ub     (±inf allowed)

and `to_cone_form` lowers it to the solver's cone form
    min ½xᵀPx + cᵀx   s.t.   b − Āx ∈ {0}^eq × ℝ₊^ineq
(equalities become Zero-cone rows; all inequalities and finite variable
bounds become NonNeg rows — Kx must stay empty on the QP path).

Published optima: Hock & Schittkowski, "Test Examples for Nonlinear
Programming Codes" (1981), and the Maros–Mészáros QP collection notes.
Every value is additionally cross-checked against scipy SLSQP in
tests/test_real_data.py, so a transcription error cannot hide.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

INF = np.inf


def _problem(name, Q, c, c0, A, sense, rhs, lb, ub, optval):
    n = len(c)
    return {
        "name": name,
        "Q": np.asarray(Q, np.float64).reshape(n, n),
        "c": np.asarray(c, np.float64),
        "c0": float(c0),
        "A": np.asarray(A, np.float64).reshape(-1, n) if len(A) else
             np.zeros((0, n)),
        "sense": list(sense),
        "rhs": np.asarray(rhs, np.float64),
        "lb": np.asarray(lb, np.float64),
        "ub": np.asarray(ub, np.float64),
        "optval": float(optval),
    }


def problems():
    out = []

    # HS21: min 0.01 x1² + x2² − 100   s.t. 10x1 − x2 ≥ 10,
    #       2 ≤ x1 ≤ 50, −50 ≤ x2 ≤ 50.   x* = (2, 0), f* = −99.96.
    out.append(_problem(
        "HS21",
        Q=np.diag([0.02, 2.0]), c=[0.0, 0.0], c0=-100.0,
        A=[[10.0, -1.0]], sense=[">="], rhs=[10.0],
        lb=[2.0, -50.0], ub=[50.0, 50.0],
        optval=-99.96,
    ))

    # HS35 (Beale): min 9 − 8x1 − 6x2 − 4x3 + 2x1² + 2x2² + x3²
    #               + 2x1x2 + 2x1x3   s.t. x ≥ 0, x1 + x2 + 2x3 ≤ 3.
    #               f* = 1/9.
    out.append(_problem(
        "HS35",
        Q=[[4.0, 2.0, 2.0], [2.0, 4.0, 0.0], [2.0, 0.0, 2.0]],
        c=[-8.0, -6.0, -4.0], c0=9.0,
        A=[[1.0, 1.0, 2.0]], sense=["<="], rhs=[3.0],
        lb=[0.0, 0.0, 0.0], ub=[INF, INF, INF],
        optval=1.0 / 9.0,
    ))

    # HS52: min (4x1−x2)² + (x2+x3−2)² + (x4−1)² + (x5−1)²
    #       s.t. x1 + 3x2 = 0, x3 + x4 − 2x5 = 0, x2 − x5 = 0.
    #       f* = 1859/349.
    G = np.array([
        [4.0, -1.0, 0.0, 0.0, 0.0],
        [0.0, 1.0, 1.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 1.0, 0.0],
        [0.0, 0.0, 0.0, 0.0, 1.0],
    ])
    target = np.array([0.0, 2.0, 1.0, 1.0])
    out.append(_problem(
        "HS52",
        Q=2.0 * G.T @ G, c=-2.0 * G.T @ target, c0=float(target @ target),
        A=[[1.0, 3.0, 0.0, 0.0, 0.0],
           [0.0, 0.0, 1.0, 1.0, -2.0],
           [0.0, 1.0, 0.0, 0.0, -1.0]],
        sense=["=", "=", "="], rhs=[0.0, 0.0, 0.0],
        lb=[-INF] * 5, ub=[INF] * 5,
        optval=1859.0 / 349.0,
    ))

    # HS51: min (x1−x2)² + (x2+x3−2)² + (x4−1)² + (x5−1)²
    #       s.t. x1 + 3x2 = 4, x3 + x4 − 2x5 = 0, x2 − x5 = 0.   f* = 0.
    G1 = G.copy()
    G1[0] = [1.0, -1.0, 0.0, 0.0, 0.0]
    out.append(_problem(
        "HS51",
        Q=2.0 * G1.T @ G1, c=-2.0 * G1.T @ target, c0=float(target @ target),
        A=[[1.0, 3.0, 0.0, 0.0, 0.0],
           [0.0, 0.0, 1.0, 1.0, -2.0],
           [0.0, 1.0, 0.0, 0.0, -1.0]],
        sense=["=", "=", "="], rhs=[4.0, 0.0, 0.0],
        lb=[-INF] * 5, ub=[INF] * 5,
        optval=0.0,
    ))

    # HS53: the (x1−x2)² objective with HS52's equalities, plus
    #       −10 ≤ x ≤ 10.   f* = 176/43.
    out.append(_problem(
        "HS53",
        Q=2.0 * G1.T @ G1, c=-2.0 * G1.T @ target, c0=float(target @ target),
        A=[[1.0, 3.0, 0.0, 0.0, 0.0],
           [0.0, 0.0, 1.0, 1.0, -2.0],
           [0.0, 1.0, 0.0, 0.0, -1.0]],
        sense=["=", "=", "="], rhs=[0.0, 0.0, 0.0],
        lb=[-10.0] * 5, ub=[10.0] * 5,
        optval=176.0 / 43.0,
    ))

    # HS76: min x1² + 0.5x2² + x3² + 0.5x4² − x1x3 + x3x4
    #           − x1 − 3x2 + x3 − x4
    #       s.t. x1 + 2x2 + x3 + x4 ≤ 5, 3x1 + x2 + 2x3 − x4 ≤ 4,
    #            x2 + 4x3 ≥ 1.5, x ≥ 0.   f* = −4.681818...
    out.append(_problem(
        "HS76",
        Q=[[2.0, 0.0, -1.0, 0.0],
           [0.0, 1.0, 0.0, 0.0],
           [-1.0, 0.0, 2.0, 1.0],
           [0.0, 0.0, 1.0, 1.0]],
        c=[-1.0, -3.0, 1.0, -1.0], c0=0.0,
        A=[[1.0, 2.0, 1.0, 1.0],
           [3.0, 1.0, 2.0, -1.0],
           [0.0, 1.0, 4.0, 0.0]],
        sense=["<=", "<=", ">="], rhs=[5.0, 4.0, 1.5],
        lb=[0.0] * 4, ub=[INF] * 4,
        optval=-4.681818181,
    ))

    # TAME: min (x1 − x2)²  s.t. x1 + x2 = 1, x ≥ 0.   f* = 0.
    out.append(_problem(
        "TAME",
        Q=[[2.0, -2.0], [-2.0, 2.0]], c=[0.0, 0.0], c0=0.0,
        A=[[1.0, 1.0]], sense=["="], rhs=[1.0],
        lb=[0.0, 0.0], ub=[INF, INF],
        optval=0.0,
    ))

    return out


# ---------------------------------------------------------------------------
# Mid-size Maros–Mészáros-class problems (VERDICT round-2 item 5).
#
# The reference's maros_benchmark.py targets the real collection via an
# external checkout (reference python/benchmarks/maros_benchmark.py:22-40);
# offline we reproduce the published CUTE generator recipes instead.  The
# CVXQP family recipe below EXACTLY reproduces the collection's problems —
# confirmed by matching the published optimal values (CVXQP1_S 1.1590718e4,
# CVXQP2_S 8.1209405e3, CVXQP3_S 1.1943432e4) through an independent scipy
# SLSQP solve of the generated data.  cond(Q) ≈ 7e18 at n=100: these stress
# conditioning the way the real set does, unlike the HS toys above.
# ---------------------------------------------------------------------------


def cvxqp_matrices(n, m):
    """CUTE CVXQP recipe: Q = Σᵢ i·vᵢvᵢᵀ with vᵢ = e_i + e_{(2i−1) mod n}
    + e_{(3i−1) mod n}; constraint i: x_i + 2x_{(4i−1) mod n}
    + 3x_{(5i−1) mod n} = 6; bounds 0.1 ≤ x ≤ 10."""
    V = np.zeros((n, n))
    for i in range(1, n + 1):
        for j in (i - 1, (2 * i - 1) % n, (3 * i - 1) % n):
            V[i - 1, j] += 1.0
    w = np.arange(1, n + 1, dtype=np.float64)
    Q = V.T @ (w[:, None] * V)
    A = np.zeros((m, n))
    b = np.full(m, 6.0)
    for i in range(1, m + 1):
        A[i - 1, i - 1] += 1.0
        A[i - 1, (4 * i - 1) % n] += 2.0
        A[i - 1, (5 * i - 1) % n] += 3.0
    return Q, A, b


def cvxqp_problem(variant, n, optval, name=None, duplicate_rows=0):
    """CVXQP{1,2,3} with m = n/2, n/4, 3n/4 equalities.  `duplicate_rows`
    repeats the first rows again (linearly dependent constraints — the
    degeneracy stressor; the feasible set and optimum are unchanged)."""
    m = {1: n // 2, 2: n // 4, 3: 3 * n // 4}[variant]
    Q, A, b = cvxqp_matrices(n, m)
    if duplicate_rows:
        A = np.vstack([A, A[:duplicate_rows]])
        b = np.concatenate([b, b[:duplicate_rows]])
    return _problem(
        name or f"CVXQP{variant}_{'S' if n <= 100 else 'M'}",
        Q=Q, c=np.zeros(n), c0=0.0,
        A=A, sense=["="] * A.shape[0], rhs=b,
        lb=np.full(n, 0.1), ub=np.full(n, 10.0),
        optval=optval,
    )


def aug2d_style(nx=12, ny=12):
    """AUG*-structure grid QP: variables on the edges of an nx×ny grid,
    min ½‖x − t‖² subject to flow conservation at every interior node.
    The node-edge incidence system is rank-deficient by one on a balanced
    grid — constraint degeneracy with an EXACT oracle: the equality-only
    KKT system solved by lstsq gives the optimum in closed form."""
    edges = []
    def node(i, j):
        return i * ny + j
    for i in range(nx):
        for j in range(ny):
            if i + 1 < nx:
                edges.append((node(i, j), node(i + 1, j)))
            if j + 1 < ny:
                edges.append((node(i, j), node(i, j + 1)))
    n_nodes, n_edges = nx * ny, len(edges)
    A = np.zeros((n_nodes, n_edges))
    for k, (u, v) in enumerate(edges):
        A[u, k] = 1.0
        A[v, k] = -1.0
    rng = np.random.default_rng(0)
    inj = rng.normal(size=n_nodes)
    inj -= inj.mean()  # balanced ⇒ feasible despite rank deficiency
    t = rng.normal(size=n_edges)
    Q = np.eye(n_edges)
    c = -t
    # Exact optimum: minimize ½‖x−t‖² s.t. Ax = inj via KKT least squares.
    dim = n_edges + n_nodes
    K = np.zeros((dim, dim))
    K[:n_edges, :n_edges] = Q
    K[:n_edges, n_edges:] = A.T
    K[n_edges:, :n_edges] = A
    rhs = np.concatenate([t, inj])
    z = np.linalg.lstsq(K, rhs, rcond=None)[0]
    x_star = z[:n_edges]
    optval = float(0.5 * x_star @ x_star - t @ x_star + 0.5 * t @ t)
    return _problem(
        f"AUG2D_{nx}x{ny}",
        Q=Q, c=c, c0=float(0.5 * t @ t),
        A=A, sense=["="] * n_nodes, rhs=inj,
        lb=np.full(n_edges, -INF), ub=np.full(n_edges, INF),
        optval=optval,
    )


def dual_style(n=200, cond=1e6, seed=1):
    """DUAL*-structure problem: dense ill-conditioned covariance QP over
    the simplex, min ½xᵀQx + cᵀx s.t. Σx = 1, x ≥ 0, with spectrum
    log-spaced over `cond`.  Oracle: scipy SLSQP (solve_with_slsqp)."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.normal(size=(n, n)))
    spec = np.logspace(-np.log10(cond), 0.0, n)
    Q = (U * spec) @ U.T
    Q = (Q + Q.T) / 2
    c = rng.normal(size=n) * 0.01
    return _problem(
        f"DUAL_{n}",
        Q=Q, c=c, c0=0.0,
        A=np.ones((1, n)), sense=["="], rhs=[1.0],
        lb=np.zeros(n), ub=np.full(n, INF),
        optval=np.nan,  # computed live by the SLSQP oracle
    )


def midsize_problems(include_m_size=True):
    """The mid-size suite.  Published values for the S sizes are from the
    Maros–Mészáros tables (SLSQP-confirmed in tests/test_real_data.py);
    the M-size and AUG2D values are KKT-certified (stationarity/primal
    residuals ≤ 1e-10 asserted on every solve, which proves optimality of
    a convex QP independent of any solver)."""
    probs = [
        cvxqp_problem(1, 100, 1.1590718e4),
        cvxqp_problem(2, 100, 8.1209405e3),
        cvxqp_problem(3, 100, 1.1943432e4),
        cvxqp_problem(1, 100, 1.1590718e4, name="CVXQP1_S_DEGEN",
                      duplicate_rows=10),
        aug2d_style(12, 12),
        dual_style(200),
    ]
    if include_m_size:
        # KKT-certified at residuals ≤ 1e-14 (see benchmark history);
        # CVXQP1_M agrees with the published 1.0875116e6.
        probs.append(cvxqp_problem(1, 1000, 1.0875115673e6))
    return probs


def kkt_certificate(p, x):
    """Solver-independent optimality certificate for a convex QP: estimate
    duals from x alone by sign-constrained least squares on the active
    set, then report (stationarity, primal, complementarity) residuals.
    Small residuals PROVE near-optimality regardless of which solver
    produced x."""
    from scipy.optimize import lsq_linear

    P, c, A_bar, b_bar, n_eq = to_cone_form(p)
    x = np.asarray(x, np.float64)
    m = A_bar.shape[0]
    s = b_bar - A_bar @ x
    pri = float(max(np.max(np.abs(s[:n_eq]), initial=0.0),
                    np.max(-s[n_eq:], initial=0.0)))
    g = P @ x + c
    scale = 1.0 + max(float(np.max(np.abs(g), initial=0.0)),
                      float(np.max(np.abs(b_bar), initial=0.0)))
    # Dual estimate restricted to the ACTIVE rows (equalities + tight
    # inequalities): min ‖Px + c + Ā_actᵀλ_act‖ with λ ≥ 0 on inequality
    # rows, λ = 0 elsewhere.  Restricting enforces complementarity by
    # construction, so a small stationarity residual certifies optimality.
    act = np.zeros(m, bool)
    act[:n_eq] = True
    act[n_eq:] = s[n_eq:] <= 1e-7 * scale
    idx = np.flatnonzero(act)
    lam = np.zeros(m)
    if idx.size:
        # Exactly duplicated active rows (degenerate instances) make the
        # dual least-squares stall in lsq_linear; merge duplicates first —
        # duplicated constraints share dual mass, so assigning the merged
        # multiplier to one representative leaves A_actᵀλ unchanged.
        rows_act = np.ascontiguousarray(A_bar[idx])
        _, uniq_pos = np.unique(
            rows_act.view([("", rows_act.dtype)] * rows_act.shape[1]),
            return_index=True)
        idx = idx[np.sort(uniq_pos)]
        lo = np.where(idx < n_eq, -np.inf, 0.0)
        sol = lsq_linear(A_bar[idx].T, -g, bounds=(lo, np.inf),
                         max_iter=500, tol=1e-14)
        lam[idx] = sol.x
    stat = float(np.max(np.abs(g + A_bar.T @ lam), initial=0.0))
    comp = float(np.max(np.abs(lam[n_eq:] * s[n_eq:]), initial=0.0))
    return {"stat": stat / scale, "pri": pri / scale, "comp": comp / scale}


def to_cone_form(p):
    """Lower (Q,c,A,sense,rhs,lb,ub) to  min ½xᵀPx + cᵀx  s.t.
    b − Āx ∈ {0}^n_eq × ℝ₊^n_ineq  (Kx empty; QP path).

    Row order: equalities first, then '<=' rows as-is, '>=' rows negated,
    then finite upper bounds (x_j ≤ u) and finite lower bounds (−x_j ≤ −l).
    Returns (P, c, A_bar, b_bar, n_eq).
    """
    n = p["c"].shape[0]
    rows, rhs = [], []
    n_eq = 0
    for a, s, r in zip(p["A"], p["sense"], p["rhs"]):
        if s == "=":
            rows.insert(n_eq, a)
            rhs.insert(n_eq, r)
            n_eq += 1
    for a, s, r in zip(p["A"], p["sense"], p["rhs"]):
        if s == "<=":
            rows.append(a)
            rhs.append(r)
        elif s == ">=":
            rows.append(-a)
            rhs.append(-r)
    for j in range(n):
        if np.isfinite(p["ub"][j]):
            e = np.zeros(n)
            e[j] = 1.0
            rows.append(e)
            rhs.append(p["ub"][j])
        if np.isfinite(p["lb"][j]):
            e = np.zeros(n)
            e[j] = -1.0
            rows.append(e)
            rhs.append(-p["lb"][j])
    A_bar = np.vstack(rows) if rows else np.zeros((0, n))
    return p["Q"], p["c"], A_bar, np.asarray(rhs, np.float64), n_eq


def solve_with_pogs_tpu(p, abs_tol=1e-6, rel_tol=1e-6, max_iter=40000,
                        dtype=np.float64, solver=None, warm_start=False,
                        b_scale=1.0):
    """Solve one vendored problem with the JAX QP path; returns the dict
    from solve_cone plus the objective including the constant term.

    ``solver``/``warm_start`` enable the receding-horizon re-solve
    pattern (pass the ConeSolver back in with a perturbed right-hand
    side); ``b_scale`` perturbs the constraint rhs for that purpose."""
    from pogs_tpu.api.cone import solve_cone
    from pogs_tpu.types import Cone, ConeConstraint

    P, c, A_bar, b_bar, n_eq = to_cone_form(p)
    m = A_bar.shape[0]
    Ky = []
    if n_eq:
        Ky.append(ConeConstraint(Cone.ZERO, range(n_eq)))
    if m > n_eq:
        Ky.append(ConeConstraint(Cone.NON_NEG, range(n_eq, m)))
    res = solve_cone(A_bar, b_bar * b_scale, c, Kx=(), Ky=Ky, P=P,
                     dtype=dtype, abs_tol=abs_tol, rel_tol=rel_tol,
                     max_iter=max_iter, solver=solver,
                     warm_start=warm_start)
    res["objective"] = float(res["optval"]) + p["c0"]
    return res


def warm_resolve_stats(p, max_iter, abs_tol=1e-6, rel_tol=1e-6,
                       dtype=np.float64, perturb=1e-3):
    """Receding-horizon evidence: solve, then re-solve with a perturbed
    rhs through the SAME ConeSolver with warm_start=True (the MPC
    pattern).  Returns (cold_iters, warm_iters, warm_ms, rel_err) with
    rel_err measured against a cold solve of the perturbed problem."""
    import time as _time

    from pogs_tpu.solver.cone import ConeSolver
    from pogs_tpu.types import Cone, ConeConstraint, SolverSettings

    P, c, A_bar, b_bar, n_eq = to_cone_form(p)
    m = A_bar.shape[0]
    Ky = []
    if n_eq:
        Ky.append(ConeConstraint(Cone.ZERO, range(n_eq)))
    if m > n_eq:
        Ky.append(ConeConstraint(Cone.NON_NEG, range(n_eq, m)))
    st = SolverSettings(abs_tol=abs_tol, rel_tol=rel_tol, max_iter=max_iter)
    s = ConeSolver(A_bar, Ky=Ky, settings=st, dtype=dtype)
    r0 = s.solve(b_bar, c, P=P, settings=st)
    b2 = b_bar * (1.0 + perturb)
    t0 = _time.perf_counter()
    r_warm = s.solve(b2, c, P=P, settings=st, warm_start=True)
    warm_ms = (_time.perf_counter() - t0) * 1e3
    r_cold = ConeSolver(A_bar, Ky=Ky, settings=st, dtype=dtype).solve(
        b2, c, P=P, settings=st)
    denom = max(abs(float(r_cold.optval)), 1.0)
    rel_err = abs(float(r_warm.optval) - float(r_cold.optval)) / denom
    return (int(r0.final_iter), int(r_warm.final_iter), warm_ms, rel_err)


def solve_with_slsqp(p):
    """Independent oracle: scipy SLSQP on the same data."""
    from scipy.optimize import minimize

    n = p["c"].shape[0]
    Q, c = p["Q"], p["c"]

    def fun(x):
        return 0.5 * x @ Q @ x + c @ x + p["c0"]

    def jac(x):
        return Q @ x + c

    cons = []
    for a, s, r in zip(p["A"], p["sense"], p["rhs"]):
        a = np.asarray(a, np.float64)
        if s == "=":
            cons.append({"type": "eq", "fun": (lambda x, a=a, r=r: a @ x - r),
                         "jac": (lambda x, a=a: a)})
        elif s == "<=":
            cons.append({"type": "ineq", "fun": (lambda x, a=a, r=r: r - a @ x),
                         "jac": (lambda x, a=a: -a)})
        else:
            cons.append({"type": "ineq", "fun": (lambda x, a=a, r=r: a @ x - r),
                         "jac": (lambda x, a=a: a)})
    bounds = [(None if not np.isfinite(lo) else lo,
               None if not np.isfinite(hi) else hi)
              for lo, hi in zip(p["lb"], p["ub"])]
    x0 = np.clip(np.zeros(n), p["lb"], p["ub"])
    r = minimize(fun, x0, jac=jac, constraints=cons, bounds=bounds,
                 method="SLSQP", options={"maxiter": 500, "ftol": 1e-12})
    return float(r.fun)


# ---------------------------------------------------------------------------
# maros_full: the >=50-instance suite (VERDICT r4 item 5).
#
# The real QPS collection is not downloadable here (no network), so the
# suite is built from the collection's REPRODUCIBLE recipe families —
# CVXQP{1,2,3} (CUTE generator, exact reproduction confirmed against the
# published S/M optima), AUG2D-structure grid QPs (KKT-exact oracle),
# DUAL-structure ill-conditioned simplex QPs, the HS/TAME classics with
# published optima — across a ladder of sizes and degeneracy variants.
# The PASS CRITERION is solver-independent: the KKT certificate
# (kkt_certificate above: stationarity/primal/complementarity residuals
# from x alone) must be <= 1e-6, AND where a published/closed-form
# optimum exists the relative objective gap must be <= 1e-6.  This is
# stronger than matching a published table: a certificate at 1e-6 proves
# near-optimality of a convex QP regardless of any oracle.
# ---------------------------------------------------------------------------

# Published optima (Maros–Mészáros tables) for the exactly-reproduced
# CVXQP instances, cross-confirmed by scipy SLSQP at the S sizes
# (tests/test_real_data.py).
CVXQP_PUBLISHED = {
    ("CVXQP1", 100): 1.1590718e4,
    ("CVXQP2", 100): 8.1209405e3,
    ("CVXQP3", 100): 1.1943432e4,
    ("CVXQP1", 1000): 1.0875116e6,
}


def full_problems():
    """The maros_full instance list (>= 50)."""
    probs = []
    # HS/TAME classics (published optima).
    probs.extend(problems())
    # CVXQP ladder: 3 variants x 6 sizes (+ published optima where the
    # instance is literally the collection's).
    for variant in (1, 2, 3):
        for n in (40, 80, 100, 200, 400, 600, 1000):
            opt = CVXQP_PUBLISHED.get((f"CVXQP{variant}", n), np.nan)
            probs.append(cvxqp_problem(
                variant, n, opt,
                name=f"CVXQP{variant}_n{n}"))
    # Degeneracy stressors: duplicated (linearly dependent) rows.
    for variant in (1, 2, 3):
        for n in (100, 200):
            probs.append(cvxqp_problem(
                variant, n, np.nan,
                name=f"CVXQP{variant}_n{n}_DEGEN",
                duplicate_rows=max(2, n // 10)))
    # AUG2D-structure grid QPs (exact KKT oracle baked into optval).
    for g in ((8, 8), (10, 10), (12, 12), (14, 14), (16, 16), (20, 20),
              (24, 16)):
        probs.append(aug2d_style(*g))
    # DUAL-structure dense ill-conditioned simplex QPs; names carry the
    # condition-number exponent so the (n, cond) grid stays distinct.
    for n in (100, 200, 300, 400):
        for cond in (1e4, 1e6, 1e8):
            p = dual_style(n, cond=cond, seed=int(np.log10(cond)))
            p["name"] = f"DUAL_{n}_c1e{int(np.log10(cond))}"
            probs.append(p)
    return probs


def run_full(abs_tol=1e-6, rel_tol=1e-6, record=False):
    """Run the maros_full suite; print one JSON row per instance and a
    summary; with record=True upsert results.json:maros_full."""
    import time as _time

    rows = []
    for p in full_problems():
        n = int(p["c"].shape[0])
        max_iter = 2000 if n <= 300 else 400
        t0 = _time.perf_counter()
        try:
            r = solve_with_pogs_tpu(p, abs_tol=abs_tol, rel_tol=rel_tol,
                                    max_iter=max_iter)
            cold_ms = (_time.perf_counter() - t0) * 1e3
            t1 = _time.perf_counter()
            r = solve_with_pogs_tpu(p, abs_tol=abs_tol, rel_tol=rel_tol,
                                    max_iter=max_iter)
            warm_ms = (_time.perf_counter() - t1) * 1e3
            cert = kkt_certificate(p, r["x"])
            row = {
                "problem": p["name"], "n": n,
                "m_rows": int(p["A"].shape[0]),
                "objective": float(r["objective"]),
                "iterations": int(r["iterations"]),
                "status": int(r["status"]),
                "cold_ms": round(cold_ms, 2), "warm_ms": round(warm_ms, 2),
                "kkt_max": round(max(cert.values()), 12),
            }
            ok = row["status"] == 0 and row["kkt_max"] <= 1e-6
            if np.isfinite(p["optval"]):
                gap = abs(row["objective"] - p["optval"]) / max(
                    abs(p["optval"]), 1.0)
                row["published_optval"] = p["optval"]
                row["obj_rel_gap"] = round(gap, 12)
                ok = ok and gap <= 1e-6
            row["pass"] = bool(ok)
        except Exception as e:  # noqa: BLE001 - per-row degradation
            row = {"problem": p["name"], "n": n,
                   "error": f"{type(e).__name__}: {e}", "pass": False}
        rows.append(row)
        print(json.dumps(row))
    n_pass = sum(r["pass"] for r in rows)
    summary = {
        "instances": len(rows),
        "passed": n_pass,
        "pass_rate": round(n_pass / len(rows), 4),
        "criterion": "status SUCCESS and solver-independent KKT "
                     "certificate <= 1e-6 (stationarity, primal, "
                     "complementarity); where a published/closed-form "
                     "optimum exists, additionally relative objective "
                     "gap <= 1e-6",
        "provenance": "reproducible recipe families of the collection "
                      "(CVXQP/AUG2D/DUAL structures + HS classics); the "
                      "real QPS files are not downloadable in this "
                      "offline environment — CVXQP instances at the "
                      "collection's S/M sizes match its published optima",
    }
    print(json.dumps({"maros_full_summary": summary}))
    if record:
        from benchmarks.head_to_head import merge_results

        merge_results("maros_full", {"rows": rows, "summary": summary})
    return rows, summary


# ---------------------------------------------------------------------------
# QPS-file entry point: run the REAL Maros–Mészáros set (or any QPS/MPS
# files) through the same harness.  The reference's runner needs an
# external cvxbench checkout plus cvxpy to load the set
# (maros_benchmark.py:22-40); here the loader is built in
# (pogs_tpu/utils/qps.py) and the certificate is solver-independent.
# ---------------------------------------------------------------------------

def load_qps_problem(path, optval=float("nan")):
    """Load one QPS file into the harness problem schema.  ``optval`` is
    the published optimum when known (the KKT certificate provides a
    solver-independent check when it is not)."""
    from pogs_tpu.utils.qps import load_qps

    p = load_qps(path)
    p["optval"] = float(optval)
    return p


def run_qps(paths, abs_tol=1e-6, rel_tol=1e-6, max_iter=40000,
            optvals=None):
    """Solve each QPS file and report objective, timing, and the KKT
    certificate.  ``optvals`` maps problem NAME → published optimum for
    relative-gap reporting.  Returns a list of row dicts.

    Routing goes through the packaged :func:`pogs_tpu.solve_qp` /
    :func:`pogs_tpu.solve_lp` entries (LP = all-zero Hessian) so real
    files get the presolve (FX-bound fixed variables substituted out)
    and the staged early-exit polish."""
    import time as _time

    from pogs_tpu import solve_lp, solve_qp
    from pogs_tpu.utils.qps import qps_to_solve_qp_kwargs

    optvals = optvals or {}
    rows = []
    for path in paths:
        p = load_qps_problem(path)
        known = optvals.get(p["name"])

        def _solve(p=p):
            kw = qps_to_solve_qp_kwargs(p)
            P = kw.pop("P")
            common = dict(abs_tol=abs_tol, rel_tol=rel_tol,
                          max_iter=max_iter, dtype=np.float64)
            is_lp = (P.nnz == 0) if hasattr(P, "nnz") else not np.any(P)
            if is_lp:
                return solve_lp(kw.pop("q"), **kw, **common)
            return solve_qp(P, kw.pop("q"), **kw, **common)

        t0 = _time.perf_counter()
        try:
            res = _solve()
            cold_ms = (_time.perf_counter() - t0) * 1e3
            t1 = _time.perf_counter()
            res = _solve()
            warm_ms = (_time.perf_counter() - t1) * 1e3
            row = {
                "problem": p["name"], "n": int(p["c"].shape[0]),
                "m": int(p["A"].shape[0]),
                "objective": float(res["optval"]) + p["c0"],
                "status": int(res["status"]),
                "iterations": int(res["num_iters"]),
                "cold_ms": cold_ms, "warm_ms": warm_ms,
            }
            if "presolve" in res:
                row["presolve"] = res["presolve"]
            if np.all(np.isfinite(np.asarray(res["x"], np.float64))):
                row["kkt"] = kkt_certificate(p, res["x"])
            if known is not None:
                row["published_optval"] = known
                row["obj_rel_gap"] = abs(row["objective"] - known) / max(
                    abs(known), 1.0)
        except Exception as e:  # noqa: BLE001 - per-row degradation
            row = {"problem": p["name"], "error": f"{type(e).__name__}: {e}"}
        rows.append(row)
        print(json.dumps(row))
    return rows


def _main(argv):
    import argparse

    ap = argparse.ArgumentParser(
        description="Maros–Mészáros harness: vendored mid-size recipes "
                    "by default, or real QPS files via --qps")
    ap.add_argument("--qps", nargs="+", metavar="PATH",
                    help="QPS/MPS files or directories to solve")
    ap.add_argument("--full", action="store_true",
                    help="run the >=50-instance maros_full suite")
    ap.add_argument("--record", action="store_true",
                    help="with --full: upsert results.json:maros_full")
    ap.add_argument("--abs-tol", type=float, default=1e-6)
    ap.add_argument("--rel-tol", type=float, default=1e-6)
    ap.add_argument("--max-iter", type=int, default=40000)
    ap.add_argument("--cpu", action="store_true",
                    help="pin the JAX CPU backend")
    args = ap.parse_args(argv)
    import jax

    # Every harness path requests dtype=float64; without x64 JAX silently
    # truncates the returned x to f32 (solve_with_pogs_tpu's host-side IPM
    # computes x in f64, but `jnp.asarray(x64, f32)` then throws those
    # digits away — on the ill-conditioned CVXQP3 tail the truncation
    # alone moves the independent KKT certificate from ~1e-14 to ~1e-4).
    # Enabled here in the CLI entry, not at module import: tests import
    # this module and must not have their process-global JAX config
    # flipped underneath them.
    jax.config.update("jax_enable_x64", True)
    if args.cpu or os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from pogs_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    if args.full:
        run_full(abs_tol=args.abs_tol, rel_tol=args.rel_tol,
                 record=args.record)
    elif args.qps:
        paths = []
        for item in args.qps:
            if os.path.isdir(item):
                paths.extend(sorted(
                    os.path.join(item, f) for f in os.listdir(item)
                    if f.upper().endswith((".QPS", ".MPS", ".SIF"))))
            else:
                paths.append(item)
        run_qps(paths, abs_tol=args.abs_tol, rel_tol=args.rel_tol,
                max_iter=args.max_iter)
    else:
        for p in midsize_problems():
            res = solve_with_pogs_tpu(p, abs_tol=args.abs_tol,
                                      rel_tol=args.rel_tol,
                                      max_iter=args.max_iter)
            print(json.dumps({
                "problem": p["name"], "objective": float(res["objective"]),
                "published_optval": p["optval"],
                "status": int(res["status"]),
                "iterations": int(res["iterations"]),
                "kkt": kkt_certificate(p, res["x"]),
            }))


if __name__ == "__main__":
    # `python benchmarks/maros_meszaros.py` puts benchmarks/ (not the
    # repo root) on sys.path; make pogs_tpu importable either way.
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _main(sys.argv[1:])
