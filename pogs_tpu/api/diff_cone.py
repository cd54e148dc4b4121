"""Differentiable cone-form solves: implicit gradients for LP/SOCP/SDP.

Extends the implicit-differentiation construction of ``api/diff.py`` to
the cone problem

    minimize    c'x     subject to   b − A x ∈ K

making the solution map differentiable w.r.t. ``A``, ``b`` and ``c`` —
the cvxpylayers capability class (conic convex layers inside a larger
differentiable program), natively on the accelerator, composing with ``jit``,
``grad`` and ``vmap``.  The reference has no autodiff surface at all.

Method (see api/diff.py's module docstring for the derivation): the cone
problem is the graph-form split  g(x) = c'x,  f(y) = I{b − y ∈ K}, whose
Douglas–Rachford fixed point in the ORIGINAL problem space at ρ = 1 is

    u* = (x* + c,  y* + ν*)

with ν* the returned cone dual (ν* ∈ K*, ν*'s* = 0, c + A'ν* = 0 — the
stationarity contract of solver/cone.py).  The proxes entering the
fixed-point residual are

    prox_g(v) = v − c                 (linear objective)
    prox_f(v) = b − Π_K(b − v)        (shifted cone projection)

and Π_K is ``ConeSet.project`` — pure jnp, so its (generalized) Jacobian
comes from autodiff: exact masks for Zero/NonNeg/NonPos rows, the
closed-form SOC projection differentiated as written, the eigh-clamp
SDP projection through JAX's eigh derivative, and the exponential-cone
projection through its custom implicit-JVP rule (the raw bisection's
unrolled autodiff tangent would be structurally zero at the root —
``cones/projections.py::_exp_primal_tangent`` differentiates the
projection's KKT system instead).  The backward pass solves one
(m+n)-dimensional linear system per cotangent, independent of iteration
count.

The forward pass is the production HSDE path (equilibration + the jitted
DR ``while_loop`` of ``solver/hsde.py``) wrapped in ``custom_vjp`` so
none of its internals are ever differentiated.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from pogs_tpu.types import ConeConstraint, SolverSettings
from pogs_tpu.cones.sets import ConeSet
from pogs_tpu.utils.precision import highest_precision

__all__ = ["make_diff_cone_solver", "diff_cone_solve"]

_DIFF_CONE_CACHE: dict = {}

#: Same dense-Jacobian threshold as api/diff.py.
from pogs_tpu.api.diff import _DENSE_MAX_DIM


def make_diff_cone_solver(
    Ky: Sequence[ConeConstraint],
    m: int,
    n: int,
    settings: Optional[SolverSettings] = None,
    strategy: str = "smw",
    linear_solver: str = "auto",
):
    """Build a differentiable cone solver for a fixed cone structure.

    Returns ``fn(A, b, c) -> (x, aux)``: ``x`` is the primal solution,
    differentiable w.r.t. all three arguments; ``aux`` is a
    non-differentiable dict with ``y, nu, s, optval, status, iterations``.
    Check ``aux["status"] == 0`` — gradients at a non-optimal iterate
    inherit its residual error, and certificates (infeasible/unbounded)
    have no gradient semantics.

    Supported cones on the ``y`` rows: Zero, NonNeg, NonPos, SOC, SDP
    (svec rows as in ``ConeSolver``), EXP_PRIMAL and EXP_DUAL (via the
    implicit-JVP projection rule of ``cones/projections.py``).
    """
    Ky = [c if isinstance(c, ConeConstraint) else ConeConstraint(*c)
          for c in Ky]
    if settings is None:
        settings = SolverSettings(abs_tol=1e-8, rel_tol=1e-8, max_iter=20000)
    if linear_solver not in ("auto", "dense", "gmres"):
        raise ValueError(f"unknown linear_solver {linear_solver!r}")

    key = (tuple((int(c.cone), c.indices) for c in Ky), m, n,
           settings, strategy, linear_solver)
    cached = _DIFF_CONE_CACHE.get(key)
    if cached is not None:
        return cached

    Kset = ConeSet(Ky, m)
    dense = linear_solver == "dense" or (
        linear_solver == "auto" and (m + n) <= _DENSE_MAX_DIM
    )

    # ---- DR fixed-point residual in the ORIGINAL space (rho = 1) ----------
    def _residual(u, A, b, c):
        dt = A.dtype
        ux, uy = u[:n], u[n:]
        px = ux - c
        py = b - Kset.project(b - uy)
        rx = 2.0 * px - ux
        ry = 2.0 * py - uy
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

    # ---- forward: the production HSDE path --------------------------------
    @highest_precision
    def _pure_solve(A, b, c):
        from pogs_tpu.linalg.equil import equilibrate
        from pogs_tpu.solver.hsde import hsde_solve

        dt = A.dtype
        eq = equilibrate(A, constrain_d=Kset.constrain_average)
        b_s = b * eq.d
        c_s = c * eq.e
        out = hsde_solve(
            eq.A, b_s, c_s, Kset, strategy=strategy,
            abs_tol=settings.abs_tol, rel_tol=settings.rel_tol,
            max_iter=settings.max_iter,
            use_anderson=settings.use_anderson,
            anderson_mem=settings.anderson_mem,
            anderson_start=settings.anderson_start,
            polish=settings.polish,
        )
        w = out["w"]
        tau = w[n + m]
        ok = tau > 1e-8
        tau_safe = jnp.where(ok, tau, 1.0)
        x_s = w[:n] / tau_safe
        y_dual_s = w[n:n + m] / tau_safe
        s_orig = (b_s - eq.A @ x_s) / eq.d
        x = jnp.where(ok, x_s * eq.e, jnp.zeros(n, dt))
        s = jnp.where(ok, s_orig, jnp.zeros(m, dt))
        nu = jnp.where(ok, y_dual_s * eq.d, jnp.zeros(m, dt))
        return {
            "x": x,
            "y": b - s,
            "nu": nu,
            "s": s,
            "optval": jnp.vdot(c, x),
            "status": out["status"],
            "iterations": out["final_iter"],
        }

    # ---- custom_vjp wiring -------------------------------------------------
    @jax.custom_vjp
    def solve(A, b, c):
        return _fwd(A, b, c)[0]

    @highest_precision
    def _fwd(A, b, c):
        out = _pure_solve(A, b, c)
        x = out.pop("x")
        aux = {k: jax.lax.stop_gradient(v) for k, v in out.items()}
        res = (A, b, c, x, aux["y"], aux["nu"])
        return (x, aux), res

    @highest_precision
    def _bwd(res, ct):
        ct_x, _ct_aux = ct
        A, b, c, x, y, nu = res
        # Exact DR fixed point from the solution (module docstring):
        # u* = (x* + c, y* + nu*) at rho = 1.
        u = jnp.concatenate([x + c, y + nu])

        # S(u, c) = u_x - c extracts x*; its u- and c-cotangents are
        # immediate: (dS/du)'w = [w; 0], (dS/dc)'w = -w.
        gS_u = jnp.concatenate([ct_x, jnp.zeros_like(y)])

        def R_u(u_):
            return _residual(u_, A, b, c)

        if dense:
            J = jax.jacfwd(R_u)(u)
            lam = jnp.linalg.solve(J.T, gS_u)
        else:
            _, vjp_R = jax.vjp(R_u, u)
            lam, _ = jax.scipy.sparse.linalg.gmres(
                lambda v: vjp_R(v)[0], gS_u,
                tol=1e-10, atol=0.0, maxiter=20 * (m + n),
                solve_method="batched",
            )

        _, vjp_T = jax.vjp(
            lambda A_, b_, c_: _residual(u, A_, b_, c_), A, b, c,
        )
        dA, db, dc = vjp_T(lam)
        return -dA, -db, -dc - ct_x

    solve.defvjp(_fwd, _bwd)
    fn = highest_precision(solve)
    if len(_DIFF_CONE_CACHE) > 32:  # bound long-process growth
        _DIFF_CONE_CACHE.clear()
    _DIFF_CONE_CACHE[key] = fn
    return fn


def diff_cone_solve(A, b, c, Ky, settings=None, **kw):
    """One-shot differentiable cone solve:  min c'x  s.t.  b − Ax ∈ K_y.

    Returns ``(x, aux)``; see :func:`make_diff_cone_solver`.  The solver
    function is cached per (cone structure, shape, settings), so repeated
    calls with new data are cheap and jit-cached.
    """
    A = jnp.asarray(A)
    m, n = A.shape
    fn = make_diff_cone_solver(Ky, m, n, settings=settings, **kw)
    return fn(A, jnp.asarray(b, A.dtype), jnp.asarray(c, A.dtype))
