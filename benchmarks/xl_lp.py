"""XL LP tail-polish benchmark (VERDICT round-3 item 5).

A 20000x5000 inequality LP solved to 1e-6 through the HSDE path: without
a tail finisher the DR iteration's linear tail takes O(10^4-10^5)
iterations at this tolerance; the XL interior-point polish
(solver/hsde.py, K_POLISH_XL_*) certifies from an O(10^3)-iteration seed
— each polish step is one m*n^2 normal-matrix product, affordable at the
sparse XL cadence.

The reference has no counterpart: its docs admit 3-4 digits of accuracy
on exactly this problem class (DR tail stall).

Writes one row under the "xl_lp" key of benchmarks/results.json:
    {m, n, status, iterations, solve_time_s, optval, backend, dtype}

Usage:
    python benchmarks/xl_lp.py            # the 20000x5000 target row
    python benchmarks/xl_lp.py --small    # 4000x1000 smoke variant
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_xl_lp(m: int, n: int, seed: int = 0):
    """Feasible bounded inequality LP: min c'x s.t. Ax <= b with a
    strictly feasible interior; box rows keep it bounded.  Same recipe as
    problems.lp_ineq but sized for the XL tier without dense-eye stacking
    overhead."""
    rng = np.random.default_rng(seed)
    m_rand = m - 2 * n
    if m_rand <= 0:
        raise ValueError("need m > 2n for the box-row construction")
    A = np.empty((m, n))
    A[:m_rand] = rng.standard_normal((m_rand, n)) / np.sqrt(n)
    A[m_rand:m_rand + n] = np.eye(n)
    A[m_rand + n:] = -np.eye(n)
    x0 = rng.standard_normal(n)
    b = A @ x0 + rng.random(m) + 0.1
    c = rng.standard_normal(n)
    return {"A": A, "b": b, "c": c, "dims": {"l": m}}


def run(m: int, n: int, abs_tol: float, rel_tol: float, max_iter: int):
    import jax

    jax.config.update("jax_enable_x64", True)

    from pogs_tpu.api.cone import solve_cone_problem

    p = make_xl_lp(m, n)
    t0 = time.perf_counter()
    out = solve_cone_problem(
        p["c"], p["A"], p["b"], dims=p["dims"],
        abs_tol=abs_tol, rel_tol=rel_tol, max_iter=max_iter,
        dtype=np.float64,
    )
    wall = time.perf_counter() - t0
    row = {
        "m": m, "n": n,
        "status": out["status_name"],
        "iterations": int(out["num_iters"]),
        "solve_time_s": round(wall, 2),
        "optval": float(out["optval"]),
        "abs_tol": abs_tol, "rel_tol": rel_tol,
        "backend": jax.devices()[0].platform,
        "dtype": "float64",
    }
    print(row)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="17000x800 smoke variant (m > 16384 so it still "
                         "exercises the XL polish tier)")
    ap.add_argument("--max-iter", type=int, default=20000)
    ap.add_argument("--cpu", action="store_true",
                    help="pin the JAX CPU backend")
    args = ap.parse_args()
    if args.cpu or os.environ.get("JAX_PLATFORMS") == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    from pogs_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    m, n = (17000, 800) if args.small else (20000, 5000)
    row = run(m, n, 1e-6, 1e-6, args.max_iter)
    from benchmarks.head_to_head import merge_results

    merge_results("xl_lp", [row])
    print("merged into results.json under 'xl_lp'")


if __name__ == "__main__":
    main()
