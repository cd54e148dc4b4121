"""Direct (factorization-based) graph projector.

Counterpart of ProjectorDirect (src/cpu/projector/projector_direct_dense.cpp):
form the Gram matrix of the smaller dimension once, factor (G + sI) once,
then each projection is a handful of matvecs.

    m ≥ n (tall):  x = (AᵀA + sI)⁻¹ (s·x0 + Aᵀy0),        y = A x
    m < n (wide):  w = (AAᵀ + sI)⁻¹ (A x0 − y0),
                   x = x0 − Aᵀ w,                          y = y0 + s·w

(The wide-case ``y`` identity y0 + s·w follows from Woodbury; the reference
hardcodes s = 1 there, projector_direct_dense.cpp:128-135 — we keep general
s.)

The per-iteration solve defaults to multiplication by the precomputed
*explicit inverse* (G + sI)⁻¹ — one matrix-vector product — instead of two
sequential triangular solves.  The equilibrated G has unit-scale spectrum
and the +sI
shift bounds the condition number, so the inverse multiply is numerically
safe for the solver's 1e-4..1e-6 tolerance regime.  ``method='cholesky'``
keeps the classic two-triangular-solve path for ill-conditioned inputs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_PRECISION = lax.Precision.HIGHEST


def _as_dense(A):
    """Operators materialize; arrays pass through."""
    return A.dense() if hasattr(A, "dense") else A


# Above this element count the Gram matrix is accumulated over row blocks.
# One product over a full 40000x10000 operand (plus its transposed layout
# copy) transiently costs several extra copies of A in device memory;
# blocking caps the transient at one block's worth.  Init-only cost, no
# loop impact.
_GRAM_BLOCK_ELEMS = 2 * 10**8
_GRAM_BLOCK_ROWS = 4096
# Explicit-inverse construction: above this Gram dimension the identity RHS
# is solved in column panels (see init) to bound triangular-solve temps.
_INV_BLOCK_MIN = 5120
_INV_BLOCK_COLS = 2048


def _gram(A, trans: bool):
    """AᵀA (trans) or AAᵀ, at highest precision; blocked when big."""
    m, n = A.shape
    if m * n < _GRAM_BLOCK_ELEMS:
        if trans:
            return jnp.matmul(A.T, A, precision=_PRECISION)
        return jnp.matmul(A, A.T, precision=_PRECISION)
    # Static (trace-time) block loop: G = sum_b A_bᵀ A_b.  ~m/4096 matmul
    # steps unrolled in the init program; XLA double-buffers G.
    k = n if trans else m
    big = m if trans else n
    G = jnp.zeros((k, k), A.dtype)
    for lo in range(0, big, _GRAM_BLOCK_ROWS):
        hi = min(lo + _GRAM_BLOCK_ROWS, big)
        if trans:
            Ab = lax.slice_in_dim(A, lo, hi, axis=0)
            G = G + jnp.matmul(Ab.T, Ab, precision=_PRECISION)
        else:
            Ab = lax.slice_in_dim(A, lo, hi, axis=1)
            G = G + jnp.matmul(Ab, Ab.T, precision=_PRECISION)
    return G


class DirectProjector:
    """Stateless-by-construction: ``init`` returns the factor pytree, and
    ``project`` is a pure function of it (so it can live inside jit/scan)."""

    def __init__(self, method: str = "inverse"):
        if method not in ("inverse", "cholesky"):
            raise ValueError(f"unknown direct method {method!r}")
        self.method = method

    def init(self, A, s=1.0):
        """Factor (G + sI). Returns the solve-operator pytree."""
        A = _as_dense(A)
        m, n = A.shape
        dt = A.dtype
        tall = m >= n
        G = _gram(A, trans=tall)
        K = G + jnp.asarray(s, dt) * jnp.eye(G.shape[0], dtype=dt)
        L = jnp.linalg.cholesky(K)
        if self.method == "inverse":
            # SPD inverse via the Cholesky factor (never LU): K⁻¹ = L⁻ᵀ L⁻¹.
            k = G.shape[0]
            if k <= _INV_BLOCK_MIN:
                eye = jnp.eye(k, dtype=dt)
                Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
                op = jnp.matmul(Linv.T, Linv, precision=_PRECISION)
            else:
                # XLA's blocked triangular_solve against a full k x k RHS
                # materializes O(k/128) dynamic-update-slice temps of ~k^2
                # bytes each — at k = 10000 tens of GB.  Solving K^-1
                # column-panel by column-panel caps the transient at one
                # panel; init-only cost, identical loop body.
                panels = []
                for lo in range(0, k, _INV_BLOCK_COLS):
                    hi = min(lo + _INV_BLOCK_COLS, k)
                    eye_b = jnp.eye(k, hi - lo, k=-lo, dtype=dt)
                    panels.append(jax.scipy.linalg.cho_solve((L, True), eye_b))
                op = jnp.concatenate(panels, axis=1)
                # cho_solve's two triangular solves run at default precision
                # and don't guarantee an exactly symmetric result, unlike the
                # small-k Linv.T @ Linv path; symmetrize so both paths agree
                # (and the operator is SPD to the bit) across the threshold.
                op = 0.5 * (op + op.T)
        else:
            op = L
        return {"op": op, "s": jnp.asarray(s, dt)}

    def _solve(self, factor, rhs):
        if self.method == "inverse":
            return jnp.matmul(factor["op"], rhs, precision=_PRECISION)
        return jax.scipy.linalg.cho_solve((factor["op"], True), rhs)

    def project(self, A, factor, x0, y0, tol=None, x_warm=None):
        """Project (x0, y0) onto {(x, y) : y = A x}. tol/x_warm unused here."""
        A = _as_dense(A)
        m, n = A.shape
        s = factor["s"]
        if m >= n:
            rhs = s * x0 + jnp.matmul(A.T, y0, precision=_PRECISION)
            x = self._solve(factor, rhs)
            y = jnp.matmul(A, x, precision=_PRECISION)
        else:
            rhs = jnp.matmul(A, x0, precision=_PRECISION) - y0
            w = self._solve(factor, rhs)
            x = x0 - jnp.matmul(A.T, w, precision=_PRECISION)
            y = y0 + s * w
        return x, y
