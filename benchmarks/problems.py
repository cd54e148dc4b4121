"""Benchmark problem generators.

Counterparts of python/benchmarks/problems/{lasso,logistic,lp,qp,socp,sdp,
portfolio}.py — same generation protocols (data distributions, sparsity,
regularization choice), returning raw arrays instead of CVXPY problems so
the suite runs without cvxpy.
"""

from __future__ import annotations

import numpy as np


def lasso(m=500, n=300, density=1.0, condition_number=1.0, seed=42):
    """A ~ N(0,1), 90%-sparse x_true, b = A x_true + 0.1 noise,
    λ = 0.1 ‖Aᵀb‖∞ (problems/lasso.py:28-57)."""
    rng = np.random.default_rng(seed)
    if density < 1.0:
        A = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
    else:
        A = rng.standard_normal((m, n))
    if condition_number > 1.0:
        scale = condition_number ** (-np.arange(n) / max(n - 1, 1))
        A = A * scale[None, :]
    x_true = rng.standard_normal(n)
    x_true[rng.random(n) < 0.9] = 0.0
    b = A @ x_true + 0.1 * rng.standard_normal(m)
    lam = 0.1 * np.max(np.abs(A.T @ b))
    return {"A": A, "b": b, "lambd": lam, "x_true": x_true}


def lasso_kkt(A, b, lam, x, zero_tol) -> float:
    """Lasso KKT violation in float64, relative to λ: |∇ + λ sign(x)| on the
    support, max(|∇| − λ, 0) off it (∇ = Aᵀ(Ax − b)).  ``A`` may be dense
    or scipy sparse."""
    A64 = A.astype(np.float64)
    x = np.asarray(x, np.float64)
    grad = A64.T @ (A64 @ x - np.asarray(b, np.float64))
    viol = np.where(np.abs(x) > zero_tol, np.abs(grad + lam * np.sign(x)),
                    np.maximum(np.abs(grad) - lam, 0.0))
    return float(np.max(viol) / lam)


def ridge(m=500, n=300, seed=42, lam=0.1):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    x_true = rng.standard_normal(n)
    b = A @ x_true + 0.1 * rng.standard_normal(m)
    return {"A": A, "b": b, "lambd": lam}


def elastic_net(m=500, n=300, seed=42):
    p = lasso(m, n, seed=seed)
    return {"A": p["A"], "b": p["b"], "lambda1": p["lambd"],
            "lambda2": 0.5 * p["lambd"]}


def logistic(m=500, n=300, seed=42, lam=None):
    """Labels from a ground-truth hyperplane with 10% flips
    (problems/logistic.py)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    w = rng.standard_normal(n)
    y = np.sign(A @ w + 0.5 * rng.standard_normal(m))
    if lam is None:
        lam = 0.01 * np.max(np.abs(A.T @ y))
    return {"A": A, "b": y, "lambd": lam}


def svm(m=500, n=300, seed=42, lam=1.0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    w = rng.standard_normal(n)
    y = np.sign(A @ w + 0.1 * rng.standard_normal(m))
    return {"A": A, "b": y, "lambd": lam}


def huber_reg(m=500, n=300, seed=42, outliers=0.05):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    x_true = rng.standard_normal(n)
    b = A @ x_true + 0.1 * rng.standard_normal(m)
    mask = rng.random(m) < outliers
    b[mask] += 10 * rng.standard_normal(mask.sum())
    return {"A": A, "b": b}


def lp_ineq(m=500, n=300, seed=42):
    """Feasible bounded inequality LP (problems/lp.py style):
    min c'x s.t. Ax <= b with strictly feasible interior."""
    rng = np.random.default_rng(seed)
    A = np.vstack([rng.standard_normal((m, n)), np.eye(n), -np.eye(n)])
    x0 = rng.standard_normal(n)
    b = A @ x0 + rng.random(A.shape[0]) + 0.1
    c = rng.standard_normal(n)
    return {"A": A, "b": b, "c": c, "dims": {"l": A.shape[0]}}


def lp_eq(m=100, n=300, seed=42):
    """Standard-form LP: min c'x s.t. Ax = b, x >= 0."""
    rng = np.random.default_rng(seed)
    A0 = rng.standard_normal((m, n))
    x0 = rng.random(n) + 0.1
    b0 = A0 @ x0
    c = rng.random(n) + 0.5
    A = np.vstack([A0, -np.eye(n)])
    b = np.concatenate([b0, np.zeros(n)])
    return {"A": A, "b": b, "c": c, "dims": {"f": m, "l": n}}


def qp_box(n=200, seed=42):
    """Box-constrained strictly convex QP (problems/qp.py style)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + np.eye(n)
    q = rng.standard_normal(n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    b = np.ones(2 * n)
    return {"P": P, "c": q, "A": A, "b": b, "dims": {"l": 2 * n}}


def socp_ball(n=200, n_balls=4, seed=42):
    """min c'x over an intersection of balls (problems/socp.py style)."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal(n)
    rows, bs, q = [], [], []
    for _ in range(n_balls):
        # Centers with norm ~0.3 so all unit balls share an interior region.
        center = 0.3 * rng.standard_normal(n) / np.sqrt(n)
        rows.append(np.vstack([np.zeros((1, n)), -np.eye(n)]))
        bs.append(np.concatenate([[1.0], -center]))
        q.append(n + 1)
    A = np.vstack(rows)
    b = np.concatenate(bs)
    return {"A": A, "b": b, "c": c, "dims": {"q": q}}


def sdp_min_eig(nmat=20, seed=42):
    """Smallest-eigenvalue SDP: min tr(CX), tr(X)=1, X PSD."""
    rng = np.random.default_rng(seed)
    Cr = rng.standard_normal((nmat, nmat))
    Csym = (Cr + Cr.T) / 2
    L = nmat * (nmat + 1) // 2
    cvec, tvec = [], []
    for col in range(nmat):
        for row in range(col, nmat):
            w = 1.0 if row == col else 2.0
            cvec.append(w * Csym[row, col])
            tvec.append(1.0 if row == col else 0.0)
    A = np.vstack([np.asarray(tvec)[None, :], -np.eye(L)])
    b = np.concatenate([[1.0], np.zeros(L)])
    return {"A": A, "b": b, "c": np.asarray(cvec), "dims": {"f": 1, "s": [nmat]},
            "lam_min": float(np.linalg.eigvalsh(Csym)[0])}


def portfolio(n_assets=300, n_factors=30, seed=42, gamma=1.0):
    """Markowitz portfolio QP (problems/portfolio.py style):
    min γ xᵀΣx − μᵀx  s.t.  Σx = 1, x ≥ 0, with factor-model Σ."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n_assets, n_factors)) / np.sqrt(n_factors)
    D = np.diag(0.1 * rng.random(n_assets))
    Sigma = F @ F.T + D
    mu = rng.random(n_assets)
    P = 2 * gamma * Sigma
    c = -mu
    A = np.vstack([np.ones((1, n_assets)), -np.ones((1, n_assets)),
                   -np.eye(n_assets)])
    b = np.concatenate([[1.0], [-1.0], np.zeros(n_assets)])
    return {"P": P, "c": c, "A": A, "b": b, "dims": {"l": A.shape[0]}}


def tv_denoising(n=500, seed=42, lam=1.0):
    """1-D total-variation denoising (signal benchmark,
    python/benchmarks/signal_processing_benchmark.py style):
        min 0.5||x - y||^2 + lam * ||D x||_1
    in graph form with A = [I; D] (D the first-difference operator),
    f = [Square(y); Abs*lam], g = Zero."""
    rng = np.random.default_rng(seed)
    # Piecewise-constant ground truth + noise.
    truth = np.repeat(rng.standard_normal(max(n // 50, 2)), 50)[:n]
    y = truth + 0.2 * rng.standard_normal(n)
    D = np.zeros((n - 1, n))
    idx = np.arange(n - 1)
    D[idx, idx] = -1.0
    D[idx, idx + 1] = 1.0
    A = np.vstack([np.eye(n), D])
    return {"A": A, "y": y, "lam": lam, "truth": truth}


def mpc_qp(horizon=30, nx=8, nu=3, seed=42):
    """Condensed linear MPC tracking QP (control benchmark,
    python/benchmarks/control_benchmark.py style):
        min 0.5 u' H u + f' u   s.t.  -u_max <= u_k <= u_max
    with H from a stable random (A_d, B_d) system over the horizon."""
    rng = np.random.default_rng(seed)
    Ad = rng.standard_normal((nx, nx))
    Ad *= 0.95 / max(np.abs(np.linalg.eigvals(Ad)))
    Bd = rng.standard_normal((nx, nu))
    x0 = rng.standard_normal(nx)
    Q = np.eye(nx)
    R = 0.1 * np.eye(nu)
    # Prediction matrices: x_k = Ad^k x0 + sum_j Ad^(k-1-j) Bd u_j.
    N = horizon
    Su = np.zeros((N * nx, N * nu))
    Sx = np.zeros((N * nx, nx))
    Apow = np.eye(nx)
    for k in range(N):
        Apow = Apow @ Ad
        Sx[k * nx:(k + 1) * nx] = Apow
        blk = Bd
        for j in range(k, -1, -1):
            Su[k * nx:(k + 1) * nx, j * nu:(j + 1) * nu] = blk
            blk = Ad @ blk
    Qbar = np.kron(np.eye(N), Q)
    Rbar = np.kron(np.eye(N), R)
    H = Su.T @ Qbar @ Su + Rbar
    f = Su.T @ Qbar @ Sx @ x0
    u_max = 1.0
    nN = N * nu
    A = np.vstack([np.eye(nN), -np.eye(nN)])
    b = np.full(2 * nN, u_max)
    return {"P": H, "c": f, "A": A, "b": b, "dims": {"l": 2 * nN}}
