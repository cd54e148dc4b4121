"""Batched λ-path: the one-program alternative to sequential warm starts.

The reference solves λ-paths one λ at a time with warm starts
(reference: examples/cpp/lasso_path.cpp:90-106; examples/lasso_path.py
here reproduces that).  The alternative here solves the whole path in ONE
device program — equilibrate + factor once, vmap the ADMM loop — so each
iteration is a single batched matrix product for every λ at once.
"""

import numpy as np

def make_lasso_problem(m, n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    x_true = rng.standard_normal(n) * (rng.random(n) < 0.1)
    b = A @ x_true + 0.1 * rng.standard_normal(m)
    lam_max = float(np.max(np.abs(A.T @ b)))
    return A, b, lam_max


def main(m=200, n=100, n_lambdas=32):
    from pogs_tpu.parallel.batch import solve_lasso_path

    A, b, lam_max = make_lasso_problem(m, n, seed=0)
    lambdas = np.logspace(0, -2, n_lambdas) * lam_max

    out = solve_lasso_path(A, b, lambdas.astype(np.float32))
    x = np.asarray(out["x"])          # (K, n)
    nnz = (np.abs(x) > 1e-5).sum(axis=1)
    ok = np.asarray(out["status"]) == 0

    print(f"batched lasso path: K={n_lambdas}, all converged: {bool(ok.all())}")
    for k in range(0, n_lambdas, max(1, n_lambdas // 8)):
        print(f"  lambda={lambdas[k]:9.4f}  nnz={nnz[k]:3d} "
              f" optval={float(out['optval'][k]):.4f} "
              f" iters={int(out['iterations'][k])}")
    assert bool(ok.all()), "some path solves did not converge"
    # Sparsity is monotone (weakly) decreasing in lambda.
    assert nnz[0] <= nnz[-1] + 2
    return out


if __name__ == "__main__":
    main()
