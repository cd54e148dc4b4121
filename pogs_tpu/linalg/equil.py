"""Fougner–Boyd matrix equilibration (modified Sinkhorn–Knopp).

Fully functional version of the reference pipeline
(src/cpu/include/equil_helper.h:140-164 + src/cpu/matrix/matrix_dense.cpp:116-200):

  1. B = A ∘ A (elementwise square — 2-norm equilibration).
  2. 50 Sinkhorn–Knopp sweeps on B with a regularizing constant, producing
     row/col scalings d, e; optional ``constrain_d`` / ``constrain_e`` hooks
     (used by the cone objective to tie scalings within non-separable cones).
  3. d ← √d, e ← √e; A ← diag(d) · A · diag(e).
  4. Normalize: ‖A‖_F / √min(m,n) = 1, folding √normA into both d and e.

The reference mutates A in place with a packed sign-bit trick to save
memory; here we simply form B = A∘A (device memory is ample for the dense
sizes this path serves) and let XLA fuse the squaring into the first
matvec.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

# Constants mirror equil_helper.h:19-23.
SINKHORN_CONST = 1e-4
EQUIL_ITERS = 50


@dataclasses.dataclass
class EquilResult:
    """Equilibrated matrix and scalings: A_eq = d[:,None] * A * e[None,:] / normA."""

    A: jax.Array
    d: jax.Array
    e: jax.Array


def sinkhorn_knopp(
    B,
    constrain_d: Optional[Callable] = None,
    constrain_e: Optional[Callable] = None,
    iters: int = EQUIL_ITERS,
):
    """Modified Sinkhorn–Knopp on a nonnegative matrix B (equil_helper.h:140-164).

    Alternates  e ← m / (Bᵀ d + reg_e)  and  d ← n / (B e + reg_d)  with
    regularizers reg = kSinkhornConst·(m+n)/m (resp. /n) to keep the
    iteration well-posed for matrices with zero rows/columns.
    B may be a dense array or an operator with mv/rmv.
    """
    if hasattr(B, "mv"):
        bm, brm = B.mv, B.rmv
        m, n = B.shape
        dt = B.dtype
    else:
        bm, brm = (lambda v: B @ v), (lambda v: B.T @ v)
        m, n = B.shape
        dt = B.dtype
    # Zero rows/columns (padding rows for equal mesh shards, slack-free
    # variables) must not distort the scaling of the REAL entries: with
    # the raw counts, k zero rows inflate every e_j by m/(m-k) and the
    # regularizer shifts with them — measured to collapse the HSDE DR
    # rate ~36x on a 10%-padded LP.  Run the updates on the EFFECTIVE
    # counts and pin zero rows/cols to scale 1 (also keeps a huge d_i
    # from amplifying b_i on a zero row with b_i != 0).
    row_mass = bm(jnp.ones((n,), dt))
    col_mass = brm(jnp.ones((m,), dt))
    row_live = row_mass > 0
    col_live = col_mass > 0
    m_eff = jnp.maximum(jnp.sum(row_live.astype(dt)), 1.0)
    n_eff = jnp.maximum(jnp.sum(col_live.astype(dt)), 1.0)
    reg_e = SINKHORN_CONST * (m_eff + n_eff) / m_eff
    reg_d = SINKHORN_CONST * (m_eff + n_eff) / n_eff
    cd = constrain_d if constrain_d is not None else lambda v: v
    ce = constrain_e if constrain_e is not None else lambda v: v

    def body(_, de):
        d, e = de
        # Zero rows/cols are pinned to the NEUTRAL accumulation (the one
        # that inverts to scale 1) BEFORE the cone hook, so cone-averaging
        # still re-imposes uniform scaling across any non-separable cone
        # that happens to contain a zero row (e.g. the radius row of an
        # SOC ball, which is all-zero in A).
        acc_e = brm(d) + reg_e
        acc_e = jnp.where(col_live, acc_e, m_eff)
        e = m_eff / ce(acc_e)
        acc_d = bm(e) + reg_d
        acc_d = jnp.where(row_live, acc_d, n_eff)
        d = n_eff / cd(acc_d)
        return (d, e)

    d0 = jnp.ones((m,), dt)
    e0 = jnp.ones((n,), dt)
    d, e = jax.lax.fori_loop(0, iters, body, (d0, e0))
    return d, e


class _SqOp:
    """View of an operator's elementwise square, for Sinkhorn."""

    def __init__(self, op):
        self.op = op
        self.shape = op.shape
        self.dtype = op.dtype

    def mv(self, v):
        return self.op.sq_mv(v)

    def rmv(self, v):
        return self.op.sq_rmv(v)


def equilibrate(
    A,
    constrain_d: Optional[Callable] = None,
    constrain_e: Optional[Callable] = None,
    iters: int = EQUIL_ITERS,
) -> EquilResult:
    """Full equilibration pipeline (matrix_dense.cpp:116-200). Pure function.

    A may be a dense jnp array or a matrix operator (DenseMatrix /
    SparseMatrix); the returned EquilResult.A matches the input kind.
    """
    is_op = hasattr(A, "mv")
    m, n = A.shape
    dt = A.dtype
    if is_op:
        d, e = sinkhorn_knopp(_SqOp(A), constrain_d, constrain_e, iters)
    else:
        d, e = sinkhorn_knopp(A * A, constrain_d, constrain_e, iters)
    d = jnp.sqrt(d)
    e = jnp.sqrt(e)
    # Frobenius normalization to unit "average singular value"
    # (matrix_dense.cpp:183-192 with kNormNormalize = kNormFro).
    if is_op:
        A_eq = A.scale(d, e)
        norm_a = jnp.sqrt(A_eq.frob2()) / jnp.sqrt(jnp.asarray(min(m, n), dt))
        norm_a = jnp.where(norm_a > 0, norm_a, jnp.ones_like(norm_a))  # A = 0
        A_eq = A_eq.scalar_mul(1.0 / norm_a)
    else:
        A_eq = A * d[:, None] * e[None, :]
        norm_a = jnp.linalg.norm(A_eq) / jnp.sqrt(jnp.asarray(min(m, n), dt))
        norm_a = jnp.where(norm_a > 0, norm_a, jnp.ones_like(norm_a))  # A = 0
        A_eq = A_eq / norm_a
    scale = jnp.sqrt(norm_a)
    return EquilResult(A=A_eq, d=d / scale, e=e / scale)
