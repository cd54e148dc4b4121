"""Anderson acceleration on/off artifact (VERDICT round-3 item 9).

The reference ships Anderson acceleration but never wires it into a
solve and its docs admit no measured benefit
(reference docs/examples/anderson.md:106-117).  pogs_tpu wires it for
real (`SolverSettings(use_anderson=True)`, safeguarded, ρ-rescale
invalidation) — this artifact measures what it actually buys, per
problem family, so the docs can say "measured ≤N× here" instead of
advertising it.

For each family the SAME problem is solved with Anderson off and on
(m=5 memory, default start) at identical tolerances; rows record
iterations and warm wall time.  Rows land under the "anderson" key of
benchmarks/results.json.

Usage: python benchmarks/anderson_bench.py [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _time_solve(fn, reps=3):
    """Median warm wall time + result of the last call."""
    out = fn()  # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def run_family(name, solve, reps=3):
    rows = []
    for use_aa in (False, True):
        wall, out = _time_solve(lambda: solve(use_aa), reps)
        iters = int(out.get("iterations", out.get("num_iters", -1))
                    if isinstance(out, dict) else out.final_iter)
        status = int(out["status"] if isinstance(out, dict)
                     else out.status)
        rows.append({
            "problem": name, "anderson": use_aa, "iterations": iters,
            "warm_ms": round(wall * 1e3, 2), "status": status,
        })
        print(rows[-1])
    off, on = rows
    if off["iterations"] > 0:
        on["iter_ratio_vs_off"] = round(
            off["iterations"] / max(on["iterations"], 1), 3)
        on["time_ratio_vs_off"] = round(
            off["warm_ms"] / max(on["warm_ms"], 1e-9), 3)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="pin the JAX CPU backend")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_enable_x64", True)  # the LP family runs f64
    if args.cpu or os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from pogs_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()

    import jax.numpy as jnp

    from benchmarks import problems
    from pogs_tpu import Function, FunctionVector, GraphFormSolver
    from pogs_tpu.solver.cone import ConeSolver
    from pogs_tpu.types import Cone, ConeConstraint, SolverSettings

    rng = np.random.default_rng(0)
    rows = []

    def graph_settings(aa):
        return SolverSettings(use_anderson=aa, anderson_mem=5)

    # Graph-form families (ADMM loop AA).
    p = problems.lasso(500, 300, seed=1)
    lam = 0.2 * float(np.max(np.abs(p["A"].T @ p["b"])))
    A1 = p["A"].astype(np.float32)
    f1 = FunctionVector(Function.SQUARE, 500,
                        b=p["b"].astype(np.float32), dtype=jnp.float32)
    g1 = FunctionVector(Function.ABS, 300, c=lam, dtype=jnp.float32)
    solvers1 = {aa: GraphFormSolver(A1, dtype=jnp.float32) for aa in (0, 1)}

    def solve_lasso_aa(aa):
        s = solvers1[int(aa)]
        s.reset_warm_start()
        return s.solve(f1, g1, settings=graph_settings(aa))

    rows += run_family("lasso_500x300", solve_lasso_aa)

    A2 = rng.standard_normal((300, 150)).astype(np.float32)
    b2 = (A2 @ np.abs(rng.standard_normal(150))
          + 0.1 * rng.standard_normal(300)).astype(np.float32)
    f2 = FunctionVector(Function.SQUARE, 300, b=b2, dtype=jnp.float32)
    g2 = FunctionVector(Function.INDGE0, 150, dtype=jnp.float32)
    solvers2 = {aa: GraphFormSolver(A2, dtype=jnp.float32) for aa in (0, 1)}

    def solve_nnls_aa(aa):
        s = solvers2[int(aa)]
        s.reset_warm_start()
        return s.solve(f2, g2, settings=graph_settings(aa))

    rows += run_family("nnls_300x150", solve_nnls_aa)

    # HSDE cone family (DR loop AA).  polish off so AA's effect on the
    # raw DR tail is visible rather than masked by the IPM finisher.
    lp = problems.lp_ineq(400, 150, seed=3)
    m_lp = lp["A"].shape[0]
    Ky = [ConeConstraint(Cone.NON_NEG, range(m_lp))]

    def solve_lp_aa(aa):
        st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=20000,
                            polish=False, use_anderson=aa, anderson_mem=5)
        s = ConeSolver(np.asarray(lp["A"]), Ky=Ky, settings=st,
                       dtype=np.float64)
        return s.solve(lp["b"], lp["c"], settings=st)

    rows += run_family("lp_ineq_400x150", solve_lp_aa)

    from benchmarks.head_to_head import merge_results

    merge_results("anderson", rows)
    print("merged into results.json under 'anderson'")


if __name__ == "__main__":
    main()
