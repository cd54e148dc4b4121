"""Matrix abstraction layer: dense and sparse operators with one contract.

Counterpart of the Matrix<T> interface (src/include/matrix/matrix.h:8-37)
with its Dense (matrix_dense.cpp) and Sparse (matrix_sparse.cpp)
implementations.  The contract the solvers consume:

    mv(x)      — A @ x            rmv(y)    — Aᵀ @ y
    sq_mv(v)   — (A∘A) @ v        sq_rmv(v) — (A∘A)ᵀ @ v     (equilibration)
    scale(d,e) — diag(d)·A·diag(e) as a new operator
    frob2()    — ‖A‖_F²           dense()   — materialize (dense only)

Both kinds are registered pytrees so they pass through jit/while_loop
carries untouched.  Sparse storage is BCOO (coordinate format): matvec
lowers to gathers + segment-sum, and XLA handles both A·x and Aᵀ·x from
one index array, where the reference keeps CSR and CSC side by side
(matrix_sparse.cpp:97-128).
"""

from __future__ import annotations


import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import sparse as jsparse

_PRECISION = lax.Precision.HIGHEST


@jax.tree_util.register_pytree_node_class
class DenseMatrix:
    def __init__(self, A):
        self.A = A if isinstance(A, jax.Array) or hasattr(A, "aval") else jnp.asarray(A)

    # pytree protocol -------------------------------------------------------
    def tree_flatten(self):
        return (self.A,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.A = children[0]
        return obj

    # operator contract -----------------------------------------------------
    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def is_sparse(self):
        return False

    def mv(self, x):
        return jnp.matmul(self.A, x, precision=_PRECISION)

    def rmv(self, y):
        return jnp.matmul(self.A.T, y, precision=_PRECISION)

    def sq_mv(self, v):
        return jnp.matmul(self.A * self.A, v, precision=_PRECISION)

    def sq_rmv(self, v):
        return jnp.matmul((self.A * self.A).T, v, precision=_PRECISION)

    def scale(self, d, e) -> "DenseMatrix":
        return DenseMatrix(self.A * d[:, None] * e[None, :])

    def scalar_mul(self, s) -> "DenseMatrix":
        return DenseMatrix(self.A * s)

    def frob2(self):
        return jnp.sum(self.A * self.A)

    def dense(self):
        return self.A


@jax.tree_util.register_pytree_node_class
class SparseMatrix:
    """BCOO-backed sparse operator (n_batch=0, n_dense=0)."""

    def __init__(self, M):
        if not isinstance(M, jsparse.BCOO):
            M = jsparse.BCOO.from_scipy_sparse(M)
        self.M = M

    # pytree protocol -------------------------------------------------------
    def tree_flatten(self):
        return (self.M,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.M = children[0]
        return obj

    # operator contract -----------------------------------------------------
    @property
    def shape(self):
        return self.M.shape

    @property
    def dtype(self):
        return self.M.dtype

    @property
    def is_sparse(self):
        return True

    def _sq(self):
        return jsparse.BCOO((self.M.data * self.M.data, self.M.indices),
                            shape=self.M.shape)

    def mv(self, x):
        return self.M @ x

    def rmv(self, y):
        return self.M.T @ y

    def sq_mv(self, v):
        return self._sq() @ v

    def sq_rmv(self, v):
        return self._sq().T @ v

    def scale(self, d, e) -> "SparseMatrix":
        rows = self.M.indices[:, 0]
        cols = self.M.indices[:, 1]
        data = self.M.data * d[rows] * e[cols]
        return SparseMatrix(jsparse.BCOO((data, self.M.indices), shape=self.M.shape))

    def scalar_mul(self, s) -> "SparseMatrix":
        return SparseMatrix(
            jsparse.BCOO((self.M.data * s, self.M.indices), shape=self.M.shape)
        )

    def frob2(self):
        return jnp.sum(self.M.data * self.M.data)

    def dense(self):
        raise TypeError("SparseMatrix cannot be materialized for the direct "
                        "projector; use projector='cgls'")


def as_matrix_op(A, dtype=None):
    """Wrap dense arrays / scipy sparse / BCOO into the operator contract."""
    if isinstance(A, (DenseMatrix, SparseMatrix)):
        return A
    if hasattr(A, "mv") and hasattr(A, "scale") and hasattr(A, "is_sparse"):
        return A  # already an operator (e.g. parallel.sparse.ShardedSparseMatrix)
    if isinstance(A, jsparse.BCOO):
        if dtype is not None and A.dtype != dtype:
            A = jsparse.BCOO((A.data.astype(dtype), A.indices), shape=A.shape)
        return SparseMatrix(A)
    if hasattr(A, "tocoo") and not isinstance(A, np.ndarray):  # scipy sparse
        B = jsparse.BCOO.from_scipy_sparse(A.tocoo())
        if dtype is not None and B.dtype != dtype:
            B = jsparse.BCOO((B.data.astype(dtype), B.indices), shape=B.shape)
        return SparseMatrix(B)
    return DenseMatrix(jnp.asarray(A, dtype))


def apply_sparse_policy(A, policy: str):
    """Solver-constructor ``sparse_policy``: ``"auto"`` keeps a sparse input
    (scipy sparse / BCOO) sparse; ``"densify"`` materializes it as a dense
    array.  The dense-versus-sparse crossover by density and size has not
    been measured, so ``"auto"`` never densifies."""
    if policy not in ("auto", "densify"):
        raise ValueError(f"unknown sparse_policy {policy!r}")
    is_sparse_input = hasattr(A, "tocoo") or (
        hasattr(A, "todense") and not isinstance(A, np.ndarray)
    )
    if policy == "densify" and is_sparse_input:
        return A.toarray() if hasattr(A, "toarray") else np.asarray(A.todense())
    return A
