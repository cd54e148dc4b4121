"""Lasso regularization path, two ways (examples/cpp/lasso_path.cpp):

1. Sequential warm-started solves on one GraphFormSolver (the reference's
   pattern: factorization reused, each solve warm-starts from the last).
2. The whole path vmapped into one batched program.
"""
import time
import numpy as np
import jax.numpy as jnp
from pogs_tpu import GraphFormSolver, FunctionVector, Function
from pogs_tpu.parallel.batch import solve_lasso_path
from common import banner


def main(m=400, n=200, n_lambda=20, seed=0):
    banner(f"Lasso path {m}x{n}, {n_lambda} lambdas")
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    b = (A @ (rng.standard_normal(n) * (rng.random(n) < 0.1))
         + 0.1 * rng.standard_normal(m)).astype(np.float32)
    lam_max = float(np.max(np.abs(A.T @ b)))
    lambdas = np.geomspace(lam_max * 0.9, lam_max * 0.01, n_lambda)

    # 1. sequential warm-started
    solver = GraphFormSolver(A)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=jnp.float32)
    t0 = time.perf_counter()
    iters = []
    for lam in lambdas:
        g = FunctionVector(Function.ABS, n, c=float(lam), dtype=jnp.float32)
        res = solver.solve(f, g)
        iters.append(int(res.final_iter))
    t_seq = time.perf_counter() - t0
    print(f"  sequential warm-started: {t_seq*1e3:.1f} ms total, iters={iters}")

    # 2. vmapped parallel path
    out = solve_lasso_path(A, b, lambdas.astype(np.float32))
    t0 = time.perf_counter()
    out = solve_lasso_path(A, b, (lambdas * (1 + 1e-5)).astype(np.float32))
    np.asarray(out["optval"])
    t_par = time.perf_counter() - t0
    print(f"  vmapped parallel path:   {t_par*1e3:.1f} ms total "
          f"(all {n_lambda} solves in one program)")


if __name__ == "__main__":
    main()
