"""Differentiable solves: implicit differentiation through the optimum.

A capability the CUDA/C++ reference cannot offer: ``pogs_tpu`` solves are
differentiable with respect to the data matrix ``A`` and every objective
parameter (a, b, c, d, e of both ``f`` and ``g``) — enabling gradient-based
hyper-parameter tuning (λ-selection on a validation loss), bilevel programs,
and solver-in-the-loop training (OptNet-style convex layers) entirely on
the accelerator, composing with ``jit``, ``grad``, and ``vmap``.

Method: implicit function theorem on a Douglas–Rachford fixed point, NOT
backprop through the (hundreds of) ADMM iterations.  The graph-form problem

    minimize  f(y) + g(x)   subject to  y = A x

is solved by ADMM on the splitting F(z) = g(x) + f(y) vs the graph
constraint (solver/admm.py, reference pogs.cpp:90-581).  ADMM with unit
step is Douglas–Rachford on F and the indicator of the graph
G_A = {(x, y) : y = A x}; its fixed-point map in the reflected variable u is

    T(u) = u + Pi(2 prox_F(u) - u) - prox_F(u),     z* = prox_F(u*)

where Pi is the (linear) orthogonal projection onto G_A.  The key
simplification exploited here: given the solver's returned primal/dual
solution (x*, y*, mu*, nu*) in the ORIGINAL problem space — satisfying
mu* in dg(x*), nu* in df(y*), A'nu* + mu* = 0 (the reference's result
contract, pogs.cpp:509-518) — the point

    u* = (x* + mu*, y* + nu*)        [rho = 1]

is an EXACT fixed point of T in the original space:
prox_F(u*) = z* holds because (mu*, nu*) in dF(z*) is precisely the prox
optimality condition at unit rho, and Pi(2 z* - u*) = z* reduces (via the
normal-equation form of Pi) to A'nu* + mu* = 0.  The backward pass
therefore never touches equilibration, over-relaxation, rho adaptation, or
any other solver internal: it differentiates the clean residual

    R(u, A, f_params, g_params) = Pi(2 prox_F(u) - u) - prox_F(u) = 0

at u*, solving one (m+n)-dimensional linear system per cotangent:

    dtheta = dS/dtheta - (dR/dtheta)' J^{-T} (dS/du)' w,   J = dR/du

with S(u, g_params) = prox_g(u_x) extracting x*.  prox_F is the library's
own elementwise prox (prox/vector.py) — differentiable almost everywhere,
and its generalized Jacobian is exactly what implicit differentiation of
nonsmooth programs calls for (e.g. the soft-threshold derivative vanishing
on the inactive set gives the correct zero gradients for lasso).

The forward pass is the production solver path (equilibration + adaptive
rho + the jitted while_loop) re-composed as one pure traceable function, so
the whole construction jits and vmaps.  Accuracy of the gradients is tied
to solve accuracy; the default settings here tighten tolerances to 1e-6.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from pogs_tpu.types import Function, FunctionVector, SolverSettings
from pogs_tpu.prox.vector import prox_eval, func_eval, scale_f, scale_g
from pogs_tpu.linalg.equil import equilibrate
from pogs_tpu.linalg.matrix import DenseMatrix
from pogs_tpu.linalg.norm import norm2_est
from pogs_tpu.projector.direct import DirectProjector
from pogs_tpu.solver.admm import admm_loop
from pogs_tpu.utils.precision import highest_precision

__all__ = [
    "make_diff_solver",
    "diff_lasso",
    "diff_ridge",
    "diff_elastic_net",
    "diff_logistic",
    "diff_nonneg_ls",
    "diff_qp",
]

_DIFF_CACHE: dict = {}

#: Dense-Jacobian threshold: below this m+n the (m+n)^2 system is formed
#: explicitly and solved directly; above it a matrix-free GMRES on the
#: transposed Jacobian is used instead.
_DENSE_MAX_DIM = 2048


def _fv(h: np.ndarray, params) -> FunctionVector:
    """FunctionVector around traced params (no host ops, no re-clamping)."""
    fv = FunctionVector.__new__(FunctionVector)
    fv.h = h
    fv.n = h.shape[0]
    fv.a, fv.b, fv.c, fv.d, fv.e = params
    return fv


def _coerce_params(params, length: int, dt):
    """Broadcast a 5-tuple of scalars/arrays to full-length jnp arrays."""
    out = []
    for p in params:
        arr = jnp.asarray(p, dt)
        if arr.ndim == 0:
            arr = jnp.full((length,), arr, dt)
        out.append(arr)
    return tuple(out)


def _pure_solve(h_f, h_g, settings: SolverSettings, A, f_params, g_params):
    """The production solve path as one pure traceable function.

    Mirrors GraphFormSolver.init + solve (solver/graph.py) minus host-side
    state: equilibrate, factor the min-dim Gram, run the jitted ADMM
    while_loop, unscale.  Dense A only.
    """
    m, n = A.shape
    dt = A.dtype

    def _clamp(params):
        a, b, c, d, e = (jnp.asarray(p, dt) for p in params)
        return (a, b, jnp.maximum(c, 0), d, jnp.maximum(e, 0))

    Aop = DenseMatrix(A)
    eq = equilibrate(Aop)
    norm_A = norm2_est(eq.A)
    projector = DirectProjector(method="inverse")
    factor = projector.init(eq.A, s=1.0)

    f_s = scale_f(_fv(h_f, _clamp(f_params)), eq.d)
    g_s = scale_g(_fv(h_g, _clamp(g_params)), eq.e)

    def prox_fn(x_in, y_in, rho):
        return prox_eval(g_s, x_in, rho), prox_eval(f_s, y_in, rho)

    def eval_fn(x12, y12):
        return func_eval(f_s, y12) + func_eval(g_s, x12)

    def project_fn(px, py, tol, x_warm):
        return projector.project(eq.A, factor, px, py, tol, x_warm)

    z0 = jnp.zeros((m + n,), dt)
    zt0 = jnp.zeros((m + n,), dt)
    out = admm_loop(
        eq.A, norm_A, eq.d, eq.e, prox_fn, eval_fn, project_fn, settings,
        z0, zt0, jnp.asarray(settings.rho, dt),
    )
    # Unscale to the original space (pogs.cpp:509-518).
    return {
        "x": out["x12"] * eq.e,
        "y": out["y12"] / eq.d,
        "mu": out["mu_scaled"] / eq.e,
        "nu": out["nu_scaled"] * eq.d,
        "optval": out["optval"],
        "status": out["status"],
        "iterations": out["final_iter"],
    }


def make_diff_solver(
    h_f,
    h_g,
    settings: Optional[SolverSettings] = None,
    linear_solver: str = "auto",
):
    """Build a differentiable graph-form solver for fixed objective types.

    Returns ``fn(A, f_params, g_params) -> (x, aux)`` where ``x`` is the
    primal solution (differentiable w.r.t. all three arguments via implicit
    differentiation) and ``aux`` is a non-differentiable dict with keys
    ``y, mu, nu, optval, status, iterations``.  ``f_params``/``g_params``
    are 5-tuples ``(a, b, c, d, e)`` of length-m / length-n arrays encoding
    f_i(y) = c h(a y - b) + d y + (e/2) y^2 (prox_lib.h:23-70); build them
    with traced values to obtain gradients (see :func:`diff_lasso`).

    ``linear_solver``: ``'dense'`` forms the (m+n)^2 fixed-point Jacobian
    explicitly (exact), ``'gmres'`` solves matrix-free,
    ``'auto'`` picks dense for m+n <= {dmax}.

    The returned function composes with ``jax.jit``, ``jax.grad`` and
    ``jax.vmap``.  Functions are cached per (h_f, h_g, settings, solver).
    """
    h_f = np.asarray(h_f, np.int32)
    h_g = np.asarray(h_g, np.int32)
    if settings is None:
        settings = SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=20000)
    if linear_solver not in ("auto", "dense", "gmres"):
        raise ValueError(f"unknown linear_solver {linear_solver!r}")
    m, n = h_f.shape[0], h_g.shape[0]
    key = (h_f.tobytes(), h_g.tobytes(), m, n, settings, linear_solver)
    cached = _DIFF_CACHE.get(key)
    if cached is not None:
        return cached

    dense = linear_solver == "dense" or (
        linear_solver == "auto" and (m + n) <= _DENSE_MAX_DIM
    )

    # ---- fixed-point residual in the ORIGINAL space (rho = 1) -------------
    def _residual(u, A, f_params, g_params):
        dt = A.dtype
        one = jnp.asarray(1.0, dt)
        ux, uy = u[:n], u[n:]
        px = prox_eval(_fv(h_g, g_params), ux, one)
        py = prox_eval(_fv(h_f, f_params), uy, one)
        rx = 2.0 * px - ux
        ry = 2.0 * py - uy
        # Graph projection Pi(rx, ry) via the min-dim Gram normal equations
        # (projector/direct.py) — differentiable through cho_solve.
        if m >= n:
            K = jnp.eye(n, dtype=dt) + A.T @ A
            cf = jax.scipy.linalg.cho_factor(K)
            x_pi = jax.scipy.linalg.cho_solve(cf, rx + A.T @ ry)
        else:
            K = jnp.eye(m, dtype=dt) + A @ A.T
            cf = jax.scipy.linalg.cho_factor(K)
            w = jax.scipy.linalg.cho_solve(cf, A @ rx - ry)
            x_pi = rx - A.T @ w
        y_pi = A @ x_pi
        return jnp.concatenate([x_pi - px, y_pi - py])

    def _extract(u, g_params, dt):
        return prox_eval(_fv(h_g, g_params), u[:n], jnp.asarray(1.0, dt))

    # ---- custom_vjp wiring ------------------------------------------------
    @jax.custom_vjp
    def solve(A, f_params, g_params):
        return _fwd(A, f_params, g_params)[0]

    # Precision is pinned inside _fwd/_bwd (not only around the call site):
    # custom_vjp traces the backward rule outside any caller-side context.
    @highest_precision
    def _fwd(A, f_params, g_params):
        out = _pure_solve(h_f, h_g, settings, A, f_params, g_params)
        x = out.pop("x")
        aux = {k: jax.lax.stop_gradient(v) for k, v in out.items()}
        res = (A, f_params, g_params, x, aux["y"], aux["mu"], aux["nu"])
        return (x, aux), res

    @highest_precision
    def _bwd(res, ct):
        ct_x, _ct_aux = ct  # aux is declared non-differentiable
        A, f_params, g_params, x, y, mu, nu = res
        dt = A.dtype
        # Exact DR fixed point from the primal/dual solution (see module
        # docstring): u* = (x* + mu*, y* + nu*) at rho = 1.
        u = jnp.concatenate([x + mu, y + nu])

        # g1 = (dS/du)' w  and the direct dS/dg_params term.
        _, vjp_S = jax.vjp(lambda u_, gp_: _extract(u_, gp_, dt), u, g_params)
        gS_u, gS_gp = vjp_S(ct_x)

        # lambda solves J' lambda = g1 with J = dR/du.
        def R_u(u_):
            return _residual(u_, A, f_params, g_params)

        if dense:
            J = jax.jacfwd(R_u)(u)
            lam = jnp.linalg.solve(J.T, gS_u)
        else:
            _, vjp_R = jax.vjp(R_u, u)
            lam, _ = jax.scipy.sparse.linalg.gmres(
                lambda v: vjp_R(v)[0], gS_u,
                tol=1e-10, atol=0.0, maxiter=20 * (m + n), solve_method="batched",
            )

        # dtheta = dS/dtheta - (dR/dtheta)' lambda.
        _, vjp_T = jax.vjp(
            lambda A_, fp_, gp_: _residual(u, A_, fp_, gp_),
            A, f_params, g_params,
        )
        dA, dfp, dgp = vjp_T(lam)
        neg = jax.tree_util.tree_map(jnp.negative, (dA, dfp, dgp))
        dA, dfp, dgp = neg
        dgp = jax.tree_util.tree_map(jnp.add, dgp, gS_gp)
        return dA, dfp, dgp

    solve.defvjp(_fwd, _bwd)

    fn = highest_precision(solve)
    if len(_DIFF_CACHE) > 32:  # bound long-process growth
        _DIFF_CACHE.clear()
    _DIFF_CACHE[key] = fn
    return fn


make_diff_solver.__doc__ = make_diff_solver.__doc__.format(dmax=_DENSE_MAX_DIM)


# ---------------------------------------------------------------------------
# Convenience wrappers mirroring the packaged API encodings (api/graph.py,
# reference python/pogs/graph.py:393-707) with traced parameters.
# ---------------------------------------------------------------------------

def _shape(A):
    m, n = A.shape
    return m, n


def diff_lasso(A, b, lam, settings=None, **kw):
    """Differentiable lasso: min (1/2)||Ax - b||^2 + lam ||x||_1.

    Differentiable w.r.t. A, b and lam.  Returns ``(x, aux)``.
    """
    m, n = _shape(A)
    dt = A.dtype
    fp = _coerce_params((1.0, b, 1.0, 0.0, 0.0), m, dt)
    gp = _coerce_params((1.0, 0.0, lam, 0.0, 0.0), n, dt)
    fn = make_diff_solver(
        np.full(m, Function.SQUARE, np.int32),
        np.full(n, Function.ABS, np.int32),
        settings=settings, **kw,
    )
    return fn(A, fp, gp)


def diff_ridge(A, b, lam, settings=None, **kw):
    """Differentiable ridge: min (1/2)||Ax - b||^2 + (lam/2)||x||^2."""
    m, n = _shape(A)
    dt = A.dtype
    fp = _coerce_params((1.0, b, 1.0, 0.0, 0.0), m, dt)
    gp = _coerce_params((1.0, 0.0, lam, 0.0, 0.0), n, dt)
    fn = make_diff_solver(
        np.full(m, Function.SQUARE, np.int32),
        np.full(n, Function.SQUARE, np.int32),
        settings=settings, **kw,
    )
    return fn(A, fp, gp)


def diff_elastic_net(A, b, lam1, lam2, settings=None, **kw):
    """Differentiable elastic net: (1/2)||Ax-b||^2 + lam1||x||_1 + (lam2/2)||x||^2."""
    m, n = _shape(A)
    dt = A.dtype
    fp = _coerce_params((1.0, b, 1.0, 0.0, 0.0), m, dt)
    gp = _coerce_params((1.0, 0.0, lam1, 0.0, lam2), n, dt)
    fn = make_diff_solver(
        np.full(m, Function.SQUARE, np.int32),
        np.full(n, Function.ABS, np.int32),
        settings=settings, **kw,
    )
    return fn(A, fp, gp)


def diff_logistic(A, b, lam=0.0, settings=None, **kw):
    """Differentiable l1-regularized logistic regression (labels b in {-1,+1}).

    minimize sum_i log(1 + exp(-b_i a_i'x)) + lam ||x||_1 — the a=-b
    encoding of api/graph.py::solve_logistic (reference graph.py:527-570).
    """
    m, n = _shape(A)
    dt = A.dtype
    b_arr = jnp.asarray(b, dt)
    fp = _coerce_params((-b_arr, 0.0, 1.0, 0.0, 0.0), m, dt)
    gp = _coerce_params((1.0, 0.0, lam, 0.0, 0.0), n, dt)
    fn = make_diff_solver(
        np.full(m, Function.LOGISTIC, np.int32),
        np.full(n, Function.ABS, np.int32),
        settings=settings, **kw,
    )
    return fn(A, fp, gp)


def diff_qp(P, q, G=None, h=None, A=None, b=None, settings=None, **kw):
    """Differentiable QP layer (OptNet-style), entirely on device:

        minimize   (1/2) x'Px + q'x
        subject to Gx <= h,  Ax = b

    differentiable w.r.t. every argument.  Returns ``(x, aux)``.

    Construction: P = L'L via Cholesky (P must be positive definite; add a
    small ridge for PSD inputs), then the QP is the GRAPH-FORM problem

        minimize  (1/2)||y_L||^2 + I(y_G <= h) + I(y_A = b) + q'x
        s.t.      [y_L; y_G; y_A] = [L; G; A] x

    i.e. stacked SQUARE / shifted-INDLE0 / shifted-INDEQ0 rows over the
    stacked matrix — no new machinery: the same Douglas-Rachford implicit
    differentiation as every other family (module docstring).  Gradients
    w.r.t. P flow through the (differentiable) Cholesky factor and the
    stacked-matrix rows.  The layer composes with jit/grad/vmap, so a
    batch of QPs is one ``jax.vmap(diff_qp, ...)`` — the convex-layer
    pattern of OptNet/cvxpylayers, natively on the accelerator.
    """
    P = jnp.asarray(P)
    dt = P.dtype
    n = P.shape[0]
    q = jnp.asarray(q, dt)
    L = jnp.linalg.cholesky((P + P.T) / 2)
    rows = [L.T]  # L'x rows give (1/2)||L'x||^2 = (1/2) x'Px... see below
    # Careful: cholesky returns lower L with P = L L'; the quadratic rows
    # need M with M x such that ||M x||^2 = x'Px, i.e. M = L'.
    h_blocks = [np.full(n, Function.SQUARE, np.int32)]
    b_shift = [jnp.zeros(n, dt)]
    if G is not None:
        G = jnp.asarray(G, dt)
        h_vec = jnp.asarray(h, dt)
        rows.append(G)
        h_blocks.append(np.full(G.shape[0], Function.INDLE0, np.int32))
        b_shift.append(h_vec)
    if A is not None:
        A = jnp.asarray(A, dt)
        b_vec = jnp.asarray(b, dt)
        rows.append(A)
        h_blocks.append(np.full(A.shape[0], Function.INDEQ0, np.int32))
        b_shift.append(b_vec)
    A_stack = jnp.concatenate(rows, axis=0)
    m = A_stack.shape[0]
    h_f = np.concatenate(h_blocks)
    fp = (
        jnp.ones(m, dt),
        jnp.concatenate(b_shift),
        jnp.ones(m, dt),
        jnp.zeros(m, dt),
        jnp.zeros(m, dt),
    )
    gp = (jnp.ones(n, dt), jnp.zeros(n, dt), jnp.ones(n, dt), q, jnp.zeros(n, dt))
    fn = make_diff_solver(
        h_f, np.full(n, Function.ZERO, np.int32), settings=settings, **kw,
    )
    return fn(A_stack, fp, gp)


def diff_nonneg_ls(A, b, settings=None, **kw):
    """Differentiable nonnegative least squares: min (1/2)||Ax-b||^2, x >= 0."""
    m, n = _shape(A)
    dt = A.dtype
    fp = _coerce_params((1.0, b, 1.0, 0.0, 0.0), m, dt)
    gp = _coerce_params((1.0, 0.0, 1.0, 0.0, 0.0), n, dt)
    fn = make_diff_solver(
        np.full(m, Function.SQUARE, np.int32),
        np.full(n, Function.INDGE0, np.int32),
        settings=settings, **kw,
    )
    return fn(A, fp, gp)
