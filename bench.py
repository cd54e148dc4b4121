"""Headline benchmark: Lasso 500x300, time to abs/rel tolerance 1e-4/1e-3.

Reference baseline: 51 ms on Apple M1 (README.md:28, BASELINE.md).
Problem generation follows the reference's benchmark protocol
(run_pogs_comparison.py:245-291, benchmarks/problems.py:lasso): A ~ N(0,1),
90%-sparse x_true, b = A x_true + 0.1 noise, lambda = 0.1 * ||A'b||_inf.

Three stages run in this one process on the GPU: single solves, a batched
K=128 lambda sweep, and the same lasso in float64 to 1e-8.  Each solve is
timed up to ``block_until_ready``; every stage reports the median, the 90th
percentile and the sample count, and checks its answer with the lasso KKT
certificate.  Without a GPU the script exits non-zero.

Prints ONE JSON line naming the device:
  {"metric": ..., "value": N, "unit": "ms", "vs_baseline": N, "device": ...}
vs_baseline > 1 means faster than the reference's 51 ms.
"""

import json
import subprocess
import sys
import time

import numpy as np

from benchmarks.problems import lasso, lasso_kkt

BASELINE_MS = 51.0
M, N = 500, 300
SEED = 42
REPS = 50
BATCH_K = 128
BATCH_REPS = 10
F64_REPS = 10


def _median_p90(times_s):
    t = np.asarray(times_s) * 1e3
    return {"median_ms": float(np.median(t)),
            "p90_ms": float(np.percentile(t, 90)), "n": int(t.size)}


def _problem(dtype):
    p = lasso(M, N, seed=SEED)
    return p["A"].astype(dtype), p["b"].astype(dtype), float(p["lambd"])


def stage_headline():
    """Cold single solves (warm start reset), each with a perturbed rho."""
    import jax
    from pogs_tpu import (Function, FunctionVector, GraphFormSolver,
                          SolverSettings, Status)

    A, b, lam = _problem(np.float32)
    settings = SolverSettings(abs_tol=1e-4, rel_tol=1e-3, gap_stop=False)
    f = FunctionVector(Function.SQUARE, M, b=b, dtype=np.float32)
    g = FunctionVector(Function.ABS, N, c=lam, dtype=np.float32)
    solver = GraphFormSolver(A, dtype=np.float32, settings=settings)

    t0 = time.perf_counter()
    res = solver.solve(f, g)
    setup_s = time.perf_counter() - t0
    if res.status != Status.SUCCESS:
        raise RuntimeError(f"headline solve: {res.status.name}")
    kkt = lasso_kkt(A, b, lam, np.asarray(res.x), 1e-5)

    times = []
    for i in range(REPS):
        solver.reset_warm_start()
        t0 = time.perf_counter()
        out = solver.solve(f, g, rho=1.0 + 1e-4 * (i + 1), _no_sync=True)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    stats = _median_p90(times)
    return {
        "value": stats["median_ms"],
        "vs_baseline": BASELINE_MS / stats["median_ms"],
        "p90_ms": stats["p90_ms"], "n_solves": stats["n"],
        "iterations": int(res.final_iter),
        "kkt_violation_rel": kkt,
        "setup_s": setup_s,
    }


def stage_batched():
    """K lambda values solved as one vmapped device program."""
    import jax
    from pogs_tpu import Function, FunctionVector, SolverSettings
    from pogs_tpu.parallel.batch import batched_graph_solve

    A, b, lam = _problem(np.float32)
    settings = SolverSettings(abs_tol=1e-4, rel_tol=1e-3, gap_stop=False)
    f = FunctionVector(Function.SQUARE, M, b=b, dtype=np.float32)
    g = FunctionVector(Function.ABS, N, dtype=np.float32)
    lambdas = (np.linspace(1.0, 0.5, BATCH_K) * lam).astype(np.float32)
    A_dev = jax.device_put(A)

    t0 = time.perf_counter()
    out = jax.block_until_ready(
        batched_graph_solve(A_dev, f, g, lambdas, settings=settings))
    setup_s = time.perf_counter() - t0
    if not bool(np.all(np.asarray(out["status"]) == 0)):
        raise RuntimeError("batched sweep: not every lane converged")
    x = np.asarray(out["x"])
    kkt = max(lasso_kkt(A, b, float(lambdas[k]), x[k], 1e-5)
              for k in range(BATCH_K))

    times = []
    for i in range(BATCH_REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(batched_graph_solve(
            A_dev, f, g, lambdas * (1.0 + 1e-4 * (i + 1)), settings=settings))
        times.append(time.perf_counter() - t0)
    stats = _median_p90(times)
    return {
        "batched_ms_per_solve": stats["median_ms"] / BATCH_K,
        "batched_median_ms": stats["median_ms"],
        "batched_p90_ms": stats["p90_ms"], "batched_n": stats["n"],
        "batched_k": BATCH_K,
        "batched_kkt_violation_rel": kkt,
        "batched_setup_s": setup_s,
    }


def stage_f64():
    """The same lasso in float64 to abs/rel 1e-8."""
    import jax
    from pogs_tpu import (Function, FunctionVector, GraphFormSolver,
                          SolverSettings, Status)

    A, b, lam = _problem(np.float64)
    st = SolverSettings(abs_tol=1e-8, rel_tol=1e-8, gap_stop=False,
                        max_iter=20000)
    f = FunctionVector(Function.SQUARE, M, b=b, dtype=np.float64)
    g = FunctionVector(Function.ABS, N, c=lam, dtype=np.float64)
    solver = GraphFormSolver(A, dtype=np.float64, settings=st)
    t0 = time.perf_counter()
    res = solver.solve(f, g)
    setup_s = time.perf_counter() - t0
    if res.status != Status.SUCCESS:
        raise RuntimeError(f"f64 solve: {res.status.name}")
    kkt = lasso_kkt(A, b, lam, np.asarray(res.x), 1e-9)

    times = []
    for i in range(F64_REPS):
        solver.reset_warm_start()
        t0 = time.perf_counter()
        jax.block_until_ready(solver.solve(
            f, g, rho=1.0 + 1e-9 * (i + 1), _no_sync=True))
        times.append(time.perf_counter() - t0)
    stats = _median_p90(times)
    return {
        "f64_median_ms": stats["median_ms"], "f64_p90_ms": stats["p90_ms"],
        "f64_n": stats["n"], "f64_tol": 1e-8,
        "f64_iterations": int(res.final_iter),
        "f64_kkt_violation_rel": kkt,
        "f64_setup_s": setup_s,
    }


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    from pogs_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    result = {
        "metric": "lasso_500x300_time_to_tol_ms",
        "unit": "ms",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
    }
    for stage in (stage_headline, stage_batched, stage_f64):
        result.update(stage())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
