"""README benchmark suite: the reference's comparison table.

Reproduces the workload of python/benchmarks/run_pogs_comparison.py (the
generator of the README table: lasso / ridge / logistic / elastic net / svm
at 500×300, default tolerances) plus cone-form problems.  Timing dispatches
a batch of varied-input solves and syncs once.

Usage:
    python benchmarks/run_benchmarks.py [--sizes] [--cone] [--reps N]

Prints a markdown table and writes benchmarks/results.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pogs_tpu import (  # noqa: E402
    Function, FunctionVector, GraphFormSolver, SolverSettings,
    solve_cone_problem,
)
from benchmarks import problems  # noqa: E402
from benchmarks.roofline_bench import peak_gbps  # noqa: E402
from pogs_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

# Historical reference timings (Apple M1, README.md:26-34) for the 500×300
# table.  These are a LABELED HISTORY column only — measured same-host
# numbers against the actual reference binary live in
# benchmarks/head_to_head.py (results.json "head_to_head").
REFERENCE_MS = {"lasso": 51, "ridge": 8, "logistic": 34,
                "elastic_net": 45, "svm": 42}


def _graph_spec(name, m, n, seed):
    if name == "lasso":
        p = problems.lasso(m, n, seed=seed)
        f = FunctionVector(Function.SQUARE, m, b=p["b"], dtype=jnp.float32)
        g = FunctionVector(Function.ABS, n, c=p["lambd"], dtype=jnp.float32)
    elif name == "ridge":
        p = problems.ridge(m, n, seed=seed)
        f = FunctionVector(Function.SQUARE, m, b=p["b"], dtype=jnp.float32)
        g = FunctionVector(Function.SQUARE, n, c=p["lambd"], dtype=jnp.float32)
    elif name == "logistic":
        p = problems.logistic(m, n, seed=seed)
        f = FunctionVector(Function.LOGISTIC, m, a=-p["b"], dtype=jnp.float32)
        g = FunctionVector(Function.ABS, n, c=p["lambd"], dtype=jnp.float32)
    elif name == "elastic_net":
        p = problems.elastic_net(m, n, seed=seed)
        f = FunctionVector(Function.SQUARE, m, b=p["b"], dtype=jnp.float32)
        g = FunctionVector(Function.ABS, n, c=p["lambda1"], e=p["lambda2"],
                           dtype=jnp.float32)
    elif name == "svm":
        p = problems.svm(m, n, seed=seed)
        f = FunctionVector(Function.MAXPOS0, m, a=-p["b"], b=-1.0, dtype=jnp.float32)
        g = FunctionVector(Function.SQUARE, n, c=p["lambd"], dtype=jnp.float32)
    elif name == "tv_denoising":
        p = problems.tv_denoising(n=n)
        sz = p["y"].shape[0]
        h = np.r_[np.full(sz, int(Function.SQUARE)),
                  np.full(sz - 1, int(Function.ABS))]
        f = FunctionVector(h, b=np.r_[p["y"], np.zeros(sz - 1)],
                           c=np.r_[np.ones(sz), np.full(sz - 1, p["lam"])],
                           dtype=jnp.float32)
        g = FunctionVector(Function.ZERO, sz, dtype=jnp.float32)
        return p["A"].astype(np.float32), f, g
    else:
        raise ValueError(name)
    return p["A"].astype(np.float32), f, g


def bench_graph(name, m=500, n=300, reps=30, seed=42):
    """Pipelined cold-solve timing (see bench.py for methodology)."""
    A, f, g = _graph_spec(name, m, n, seed)
    settings = SolverSettings(abs_tol=1e-4, rel_tol=1e-3, gap_stop=False)
    solver = GraphFormSolver(A, dtype=jnp.float32, settings=settings)
    res = solver.solve(f, g)
    status = res.status
    iters = int(res.final_iter)

    def run(i):
        solver.reset_warm_start()
        return solver.solve(f, g, rho=1.0 + 1e-4 * (i + 1), _no_sync=True)

    def batch(k):
        t0 = time.perf_counter()
        outs = [run(k * reps + i) for i in range(reps)]
        np.asarray(jnp.stack([o["optval"] for o in outs]))
        return (time.perf_counter() - t0) * 1e3 / reps

    batch(0)  # ramp
    ms = float(np.median([batch(1), batch(2), batch(3)]))

    # Device-bound throughput: K independent solves (a λ-sweep over g.c)
    # in ONE launch through the vmapped path — device-resident inputs,
    # (K,) scalar ladder (device-side broadcast), pipelined dispatch.
    from pogs_tpu.parallel.batch import batched_graph_solve

    K = 64
    scale0 = float(np.asarray(g.c).ravel()[0])
    c_ladder = (scale0 * np.linspace(1.0, 0.5, K)).astype(np.float32)
    A_dev = jax.device_put(jnp.asarray(A))
    f.to_device()
    g.to_device()
    out = batched_graph_solve(A_dev, f, g, c_ladder, settings=settings)
    jax.block_until_ready(out["optval"])
    B = 4
    bts = []
    for trial in range(3):
        t0 = time.perf_counter()
        outs = [
            batched_graph_solve(
                A_dev, f, g, c_ladder * (1.0 + 1e-4 * (trial * B + i + 1)),
                settings=settings,
            )
            for i in range(B)
        ]
        np.asarray(jnp.stack([o["optval"] for o in outs]))
        bts.append((time.perf_counter() - t0) / B)
    batched_ms = float(np.min(bts[1:])) * 1e3 / K

    return {"problem": name, "m": m, "n": n, "ms": round(ms, 3),
            "batched_ms": round(batched_ms, 3),
            "iterations": iters, "status": status.name,
            "ref_ms": REFERENCE_MS.get(name),
            "speedup_vs_ref": round(REFERENCE_MS[name] / ms, 1)
            if name in REFERENCE_MS else None,
            "batched_speedup_vs_ref": round(REFERENCE_MS[name] / batched_ms, 1)
            if name in REFERENCE_MS else None}


def bench_xl(m=30000, n=8000, reps=3, seed=1):
    """Single-chip XL solve: ~1 GB dense matrix, HBM-roofline regime.
    (40000x10000 exceeds the 16 GB HBM with the solver's working set —
    shard over a mesh for larger problems.)"""
    import jax

    from pogs_tpu import GraphFormSolver

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    x_true = rng.standard_normal(n)
    x_true[rng.random(n) < 0.95] = 0
    b = (A @ x_true + 0.1 * rng.standard_normal(m)).astype(np.float32)
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    st = SolverSettings(abs_tol=1e-4, rel_tol=1e-3, gap_stop=False)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=jnp.float32)
    g = FunctionVector(Function.ABS, n, c=lam, dtype=jnp.float32)
    solver = GraphFormSolver(A, dtype=jnp.float32, settings=st)
    res = solver.solve(f, g)
    ts = []
    for r in range(reps):
        solver.reset_warm_start()
        t0 = time.perf_counter()
        res = solver.solve(f, g, rho=1.0 + 1e-4 * (r + 1))
        ts.append(time.perf_counter() - t0)
    it = int(res.final_iter)
    ms = min(ts) * 1e3
    gb_per_iter = 2.5 * m * n * 4 / 1e9  # ~2.5 A-passes/iteration
    peak = peak_gbps(jax.devices()[0].device_kind)
    return {"problem": "lasso_xl", "m": m, "n": n, "ms": round(ms, 1),
            "iterations": it, "ms_per_iter": round(ms / it, 3),
            "roofline_frac": round(gb_per_iter / (ms / it / 1e3) / peak, 3),
            "status": res.status.name,
            "backend": jax.devices()[0].platform}


def bench_cone(name, reps=10, **kw):
    gen = getattr(problems, name)
    p = gen(**kw)
    kws = dict(P=p.get("P"), abs_tol=1e-4, rel_tol=1e-4, max_iter=20000)
    out = solve_cone_problem(p["c"], p["A"], p["b"], p["dims"], **kws)  # compile
    # Warm timing with a perturbed b (the protocol of bench.py).
    t0 = time.perf_counter()
    out = solve_cone_problem(p["c"], p["A"], p["b"] * (1 + 1e-5), p["dims"],
                             **kws)
    wall = (time.perf_counter() - t0) * 1e3
    return {"problem": name, "m": p["A"].shape[0], "n": p["A"].shape[1],
            "ms_warm_call": round(wall, 1), "iterations": out["num_iters"],
            "status": out["status_name"]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", action="store_true",
                    help="also run the lasso size ladder (500..4000 rows)")
    ap.add_argument("--cone", action="store_true", help="run cone-form suite")
    ap.add_argument("--xl", action="store_true",
                    help="single-chip XL lasso (30000x8000, ~1 GB matrix)")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    use_compile_cache()

    results = []
    print(f"backend: {jax.devices()[0].platform}\n")
    print("| Problem | Size | time/solve | batched/solve | iters | ref (M1 hist.) | speedup | batched speedup |")
    print("|---------|------|-----------:|--------------:|------:|---------:|--------:|----------------:|")
    for name in ["lasso", "ridge", "logistic", "elastic_net", "svm"]:
        r = bench_graph(name, reps=args.reps)
        results.append(r)
        print(f"| {r['problem']} | {r['m']}x{r['n']} | {r['ms']:.2f} ms "
              f"| {r['batched_ms']:.2f} ms | {r['iterations']} "
              f"| {r['ref_ms']} ms | {r['speedup_vs_ref']}x "
              f"| {r['batched_speedup_vs_ref']}x |")

    if args.sizes:
        for m, n in [(500, 250), (1000, 500), (2000, 1000), (4000, 2000)]:
            r = bench_graph("lasso", m=m, n=n, reps=max(args.reps // 3, 5))
            results.append(r)
            print(f"| lasso | {m}x{n} | {r['ms']:.2f} ms | {r['iterations']} | — | — |")
        r = bench_graph("tv_denoising", n=1000, reps=max(args.reps // 3, 5))
        results.append(r)
        print(f"| tv_denoising | n=1000 | {r['ms']:.2f} ms | {r['iterations']} | — | — |")

    if args.xl:
        r = bench_xl()
        results.append(r)
        print(f"| lasso XL | {r['m']}x{r['n']} | {r['ms']:.0f} ms "
              f"({r['ms_per_iter']:.2f} ms/iter, ~{r['roofline_frac']:.0%} "
              f"of HBM roofline) | {r['iterations']} iters |")

    if args.cone:
        print("\n| Cone problem | Size | warm call | iters | status |")
        print("|--------------|------|--------------:|------:|--------|")
        for name, kw in [("lp_ineq", {}), ("lp_eq", {}), ("qp_box", {}),
                         ("socp_ball", {}), ("sdp_min_eig", {}),
                         ("portfolio", {}), ("mpc_qp", {})]:
            r = bench_cone(name, **kw)
            results.append(r)
            print(f"| {r['problem']} | {r['m']}x{r['n']} | {r['ms_warm_call']} ms "
                  f"| {r['iterations']} | {r['status']} |")

    from benchmarks.head_to_head import merge_results

    merge_results("readme_suite", results)
    print("\nmerged readme_suite rows into benchmarks/results.json")


if __name__ == "__main__":
    main()
