"""Graph-form problem builders: lasso, ridge, elastic net, logistic, huber,
SVM, non-negative least squares.

Parity with python/pogs/graph.py:393-707 — same FunctionObj constructions,
same result-dict contract (x, y, l, optval, iterations, status), same
defaults (abs_tol 1e-4, rel_tol 1e-4, max_iter 2500, rho 1.0, adaptive_rho
on, gap_stop on — graph.py:236-247).  Builders are vectorized: they create
struct-of-arrays FunctionVector objects directly instead of per-element
FunctionObj lists.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pogs_tpu.types import Function, FunctionVector, SolverSettings
from pogs_tpu.solver.graph import GraphFormSolver


def _settings(abs_tol, rel_tol, max_iter, verbose, rho, adaptive_rho,
              gap_stop):
    return SolverSettings(
        abs_tol=abs_tol, rel_tol=rel_tol, rho=rho, max_iter=max_iter,
        verbose=verbose, adaptive_rho=adaptive_rho, gap_stop=gap_stop,
    )


# One-shot problems at or below this size route to the native host
# runtime under backend="auto": a cold device solve pays a jit compile
# (seconds) plus a host-to-device upload and a blocking result fetch,
# while the host runtime solves a 128x256 problem in well under a
# millisecond.  The crossover against a warm accelerator has not been
# measured; the bound sits well below the 500x300 lasso.
_NATIVE_AUTO_MAX_ELEMS = 32768


def _route_native(A, st, backend, solver, verbose):
    """backend="auto" decision: tiny dense one-shot problems run on the
    native host runtime (don't pay a device compile and upload for
    problems the host solves in sub-millisecond time)."""
    if backend == "native":
        return True
    if backend != "auto" or solver is not None or verbose:
        return False
    if st.use_anderson:
        return False
    if not isinstance(A, np.ndarray) or A.size > _NATIVE_AUTO_MAX_ELEMS:
        return False
    import jax

    # Only reroute when the ambient JAX backend is an accelerator: the
    # native runtime's win on tiny problems is avoiding the device upload
    # and compile.  On a CPU backend the JAX path is local (and is what
    # the test suite deliberately exercises).
    if jax.default_backend() == "cpu":
        return False
    from pogs_tpu import native

    return native.is_available()


def solve_graph_form(
    A,
    f: FunctionVector,
    g: FunctionVector,
    abs_tol: float = 1e-4,
    rel_tol: float = 1e-4,
    max_iter: int = 2500,
    verbose: int = 0,
    rho: float = 1.0,
    adaptive_rho: bool = True,
    gap_stop: bool = True,
    solver: Optional[GraphFormSolver] = None,
    dtype=None,
    backend: str = "auto",
    **solver_kw,
):
    """Solve min f(y) + g(x) s.t. y = Ax. Returns the reference result dict.

    ``f``/``g`` accept FunctionVector objects or plain lists of FunctionObj
    (the reference's calling convention).

    ``backend``: "auto" (default) solves tiny dense one-shot problems on
    the native host runtime and everything else through the jitted JAX
    path; "jax" / "native" force a path.  Reuse (passing ``solver``)
    always stays on the JAX path — device-resident state is the point of
    reuse."""
    if isinstance(f, (list, tuple)):
        f = FunctionVector.from_objs(f, dtype=dtype)
    if isinstance(g, (list, tuple)):
        g = FunctionVector.from_objs(g, dtype=dtype)
    st = _settings(abs_tol, rel_tol, max_iter, verbose, rho, adaptive_rho,
                   gap_stop)
    if backend not in ("auto", "jax", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    if _route_native(A, st, backend, solver, verbose):
        import time as _time

        from pogs_tpu.native import solve_graph_native

        t0 = _time.perf_counter()
        out = solve_graph_native(np.asarray(A, np.float64), f, g, settings=st)
        out["status"] = int(out["status"])
        out["solve_time"] = _time.perf_counter() - t0
        out["backend"] = "native"
        return out
    if solver is None:
        solver = GraphFormSolver(A, dtype=dtype, settings=st, **solver_kw)
    res = solver.solve(f, g, settings=st)
    out = res.as_dict()
    out["solve_time"] = res.solve_time
    return out


def _as_dense(A, dtype):
    """Pass scipy-sparse / BCOO through untouched (GraphFormSolver routes
    them to the CGLS projector, matching the reference's sparse path);
    everything else becomes a dense ndarray."""
    if hasattr(A, "tocoo") or hasattr(A, "indices"):
        return A, A.shape
    return np.asarray(A), np.asarray(A).shape


def solve_lasso(A, b, lambd, dtype=None, **kw):
    """minimize 0.5‖Ax − b‖² + λ‖x‖₁  (graph.py:393-433)."""
    A, (m, n) = _as_dense(A, dtype)
    b = np.asarray(b).ravel()
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=dtype)
    g = FunctionVector(Function.ABS, n, c=lambd, dtype=dtype)
    return solve_graph_form(A, f, g, dtype=dtype, **kw)


def solve_ridge(A, b, lambd, dtype=None, **kw):
    """minimize 0.5‖Ax − b‖² + (λ/2)‖x‖²  (graph.py:436-476)."""
    A, (m, n) = _as_dense(A, dtype)
    b = np.asarray(b).ravel()
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=dtype)
    g = FunctionVector(Function.SQUARE, n, c=lambd, dtype=dtype)
    return solve_graph_form(A, f, g, dtype=dtype, **kw)


def solve_elastic_net(A, b, lambda1, lambda2, dtype=None, **kw):
    """minimize 0.5‖Ax − b‖² + λ₁‖x‖₁ + (λ₂/2)‖x‖²  (graph.py:479-524).

    Note: the reference encodes e = λ₂/2, but its FunctionObj ``e`` term
    contributes (e/2)x², so it actually penalizes (λ₂/4)‖x‖² — a bug
    relative to its own docstring.  We encode e = λ₂ to match the
    documented objective.
    """
    A, (m, n) = _as_dense(A, dtype)
    b = np.asarray(b).ravel()
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=dtype)
    g = FunctionVector(Function.ABS, n, c=lambda1, e=lambda2, dtype=dtype)
    return solve_graph_form(A, f, g, dtype=dtype, **kw)


def solve_logistic(A, b, lambd=0.0, dtype=None, **kw):
    """minimize Σ log(1 + exp(−bᵢ aᵢᵀx)) + λ‖x‖₁  (graph.py:527-570)."""
    A, (m, n) = _as_dense(A, dtype)
    b = np.asarray(b).ravel()
    f = FunctionVector(Function.LOGISTIC, m, a=-b, dtype=dtype)
    if lambd > 0:
        g = FunctionVector(Function.ABS, n, c=lambd, dtype=dtype)
    else:
        g = FunctionVector(Function.ZERO, n, dtype=dtype)
    return solve_graph_form(A, f, g, dtype=dtype, **kw)


def solve_huber(A, b, delta=1.0, lambd=0.0, dtype=None, **kw):
    """minimize Σ huber_δ(aᵢᵀx − bᵢ) + λ‖x‖₁  (graph.py:573-622)."""
    A, (m, n) = _as_dense(A, dtype)
    b = np.asarray(b).ravel()
    f = FunctionVector(
        Function.HUBER, m, a=1.0 / delta, b=b / delta, c=delta * delta, dtype=dtype
    )
    if lambd > 0:
        g = FunctionVector(Function.ABS, n, c=lambd, dtype=dtype)
    else:
        g = FunctionVector(Function.ZERO, n, dtype=dtype)
    return solve_graph_form(A, f, g, dtype=dtype, **kw)


def solve_svm(A, b, lambd=1.0, dtype=None, **kw):
    """minimize Σ max(0, 1 − bᵢ aᵢᵀx) + (λ/2)‖x‖²  (graph.py:625-665)."""
    A, (m, n) = _as_dense(A, dtype)
    b = np.asarray(b).ravel()
    f = FunctionVector(Function.MAXPOS0, m, a=-b, b=-1.0, dtype=dtype)
    g = FunctionVector(Function.SQUARE, n, c=lambd, dtype=dtype)
    return solve_graph_form(A, f, g, dtype=dtype, **kw)


def solve_nonneg_ls(A, b, dtype=None, **kw):
    """minimize 0.5‖Ax − b‖² s.t. x ≥ 0  (graph.py:668-707)."""
    A, (m, n) = _as_dense(A, dtype)
    b = np.asarray(b).ravel()
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=dtype)
    g = FunctionVector(Function.INDGE0, n, dtype=dtype)
    return solve_graph_form(A, f, g, dtype=dtype, **kw)
