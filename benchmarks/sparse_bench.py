"""Sparse-path benchmark.

Measures the SAME sparse lasso through every route the framework ships:

  * ``bcoo``      — JAX BCOO kept sparse (gather + segment-sum matvec,
                    CGLS projector), what ``sparse_policy="auto"`` does
  * ``densified`` — the same matrix densified (``sparse_policy=
                    "densify"``); the pair measures the dense/sparse
                    crossover on the current backend
  * ``native``    — the C++ host runtime's CSR handle (CGLS)
  * ``sklearn``   — coordinate descent on scipy CSR (the standard tool)

plus one sparse cone LP (BCOO through the HSDE 'cg' strategy).  Rows
land under the "sparse" key of benchmarks/results.json with honest
backend labels.  Reference counterpart: examples/cpp_sp/lasso_path (the
reference benchmarks sparse single-node only).

Usage: python benchmarks/sparse_bench.py [--cpu] [--quick]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _canonical_lasso_obj(A, b, lam, x):
    x = np.asarray(x, np.float64)
    r = A @ x - b
    return float(0.5 * r @ r + lam * np.abs(x).sum())


def _warm_time(fn, reps=3):
    out = fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def bench_lasso(m, n, density, reps=3):
    import scipy.sparse as sp
    import jax
    import jax.numpy as jnp

    from pogs_tpu import Function, FunctionVector, GraphFormSolver
    from pogs_tpu.types import SolverSettings

    rng = np.random.default_rng(5)
    A = sp.random(m, n, density=density, random_state=3, format="csr")
    A.data[:] = rng.standard_normal(A.nnz)
    x_true = np.zeros(n)
    idx = rng.choice(n, n // 20, replace=False)
    x_true[idx] = rng.standard_normal(idx.size)
    b = A @ x_true + 0.1 * rng.standard_normal(m)
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    st = SolverSettings(abs_tol=1e-4, rel_tol=1e-4, max_iter=2500)
    backend = jax.default_backend()
    rows = []

    def row(solver_name, wall, x, iters=None, note=""):
        obj = _canonical_lasso_obj(A, b, lam, x)
        on_device = solver_name.startswith("pogs_tpu") and \
            "native" not in solver_name
        r = {"problem": f"sparse_lasso_{m}x{n}_d{density}", "m": m, "n": n,
             "density": density, "solver": solver_name,
             "warm_ms": round(wall * 1e3, 2), "objective": round(obj, 6),
             "backend": backend if on_device else "host",
             "note": note}
        if iters is not None:
            r["iterations"] = int(iters)
        rows.append(r)
        print(r)

    f = FunctionVector(Function.SQUARE, m, b=np.asarray(b, np.float32),
                       dtype=jnp.float32)
    g = FunctionVector(Function.ABS, n, c=lam, dtype=jnp.float32)

    # BCOO kept sparse.
    s_bcoo = GraphFormSolver(A, dtype=jnp.float32)

    def run_bcoo():
        s_bcoo.reset_warm_start()
        return s_bcoo.solve(f, g, settings=st)

    wall, out = _warm_time(run_bcoo, reps)
    row("pogs_tpu_bcoo", wall, np.asarray(out.x), out.final_iter)

    # Densified.
    s_dense = GraphFormSolver(A.toarray().astype(np.float32),
                              dtype=jnp.float32)

    def run_dense():
        s_dense.reset_warm_start()
        return s_dense.solve(f, g, settings=st)

    wall, out = _warm_time(run_dense, reps)
    row("pogs_tpu_densified", wall, np.asarray(out.x), out.final_iter)

    # Native CSR runtime.
    try:
        from pogs_tpu import native as native_mod

        def run_native():
            return native_mod.solve_graph_native(
                A, f, g, abs_tol=1e-4, rel_tol=1e-4, max_iter=2500)

        wall, out = _warm_time(run_native, reps)
        row("pogs_tpu_native_csr", wall, out["x"],
            out.get("iterations"), note="f64 host")
    except Exception as exc:  # pragma: no cover - lib not built
        print(f"native sparse skipped: {exc}")

    # sklearn CD on CSR.
    try:
        from sklearn.linear_model import Lasso

        mdl = Lasso(alpha=lam / m, fit_intercept=False, tol=1e-6,
                    max_iter=5000)

        def run_sk():
            mdl.fit(A, b)
            return mdl

        wall, mdl = _warm_time(run_sk, reps)
        row("sklearn_cd", wall, mdl.coef_)
    except Exception as exc:  # pragma: no cover
        print(f"sklearn skipped: {exc}")

    return rows


def bench_cone_lp(m0, n, density, reps=3):
    """Sparse cone LP, three routes:

      * densify on the ambient backend, f32, run to convergence;
      * BCOO on the SAME device: per-DR-iteration cost over capped
        iterations (compare per_iter_ms with the densified row);
      * BCOO f64 on the host CPU, run to full convergence.
    """
    import time as _time

    import scipy.sparse as sp
    import jax

    from pogs_tpu.solver.cone import ConeSolver
    from pogs_tpu.types import Cone, ConeConstraint, SolverSettings

    rng = np.random.default_rng(2)
    Araw = sp.random(m0, n, density=density, random_state=8, format="csr")
    Araw.data[:] = rng.standard_normal(Araw.nnz)
    A = sp.vstack([Araw, sp.eye(n), -sp.eye(n)]).tocsr()
    m = A.shape[0]
    x0 = rng.standard_normal(n)
    b = A @ x0 + rng.random(m) + 0.1
    c = rng.standard_normal(n)
    Ky = [ConeConstraint(Cone.NON_NEG, range(m))]
    rows = []
    prob = f"sparse_lp_{m}x{n}_d{density}"

    # Route 1: densified on the ambient backend.
    st32 = SolverSettings(abs_tol=1e-5, rel_tol=1e-5, max_iter=20000)
    s_auto = ConeSolver(A, Ky=Ky, settings=st32, dtype=np.float32,
                        sparse_policy="densify")

    def run_auto():
        return s_auto.solve(b.astype(np.float32), c.astype(np.float32),
                            settings=st32)

    wall, out = _warm_time(run_auto, reps)
    rows.append({"problem": prob, "m": m, "n": n, "density": density,
                 "solver": "pogs_tpu_densified",
                 "warm_ms": round(wall * 1e3, 2), "status": int(out.status),
                 "iterations": int(out.final_iter),
                 "objective": round(float(out.optval), 6),
                 "backend": jax.default_backend(),
                 "note": "sparse_policy=densify, f32 1e-5"})

    # Route 2: forced BCOO on the same backend — per-iteration cost only.
    stk = SolverSettings(abs_tol=1e-5, rel_tol=1e-5, max_iter=100)
    s_keep = ConeSolver(A, Ky=Ky, settings=stk, dtype=np.float32)
    out = s_keep.solve(b.astype(np.float32), c.astype(np.float32),
                       settings=stk)  # compile
    t0 = _time.perf_counter()
    out = s_keep.solve(b.astype(np.float32) * 1.00001,
                       c.astype(np.float32), settings=stk)
    per_iter = (_time.perf_counter() - t0) * 1e3 / max(int(out.final_iter), 1)
    rows.append({"problem": prob, "m": m, "n": n, "density": density,
                 "solver": "pogs_tpu_bcoo_hsde",
                 "per_iter_ms": round(per_iter, 2),
                 "iterations_capped_at": stk.max_iter,
                 "status": int(out.status),
                 "backend": jax.default_backend(),
                 "note": "BCOO on-device: per-iteration cost (not run to "
                         "convergence; compare per_iter_ms with the "
                         "densified row)"})

    # Route 3: BCOO to convergence on the host CPU, in a SUBPROCESS: once
    # this process holds the accelerator, flipping jax_platforms does not
    # re-route dispatch.  The child gets JAX_PLATFORMS=cpu in its
    # environment, so it pins the CPU before any backend starts and never
    # opens the card this process holds.
    import json as _json
    import subprocess as _subprocess

    cmd = [sys.executable, os.path.abspath(__file__), "--cone-cpu-row",
           str(m0), str(n), str(density)]
    try:
        p = _subprocess.run(cmd, capture_output=True, text=True,
                            timeout=900, check=True,
                            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        rows.append(_json.loads(p.stdout.strip().splitlines()[-1]))
    except Exception as exc:  # noqa: BLE001 - row-level degradation
        print(f"cone cpu row skipped: {exc}")
    for r in rows:
        print(r)
    return rows


def _cone_cpu_row(m0, n, density):
    """Subprocess worker for bench_cone_lp route 3 (CPU-pinned by its
    environment)."""
    import json as _json

    import jax

    jax.config.update("jax_enable_x64", True)
    import scipy.sparse as sp

    from pogs_tpu.solver.cone import ConeSolver
    from pogs_tpu.types import Cone, ConeConstraint, SolverSettings

    rng = np.random.default_rng(2)
    Araw = sp.random(m0, n, density=density, random_state=8, format="csr")
    Araw.data[:] = rng.standard_normal(Araw.nnz)
    A = sp.vstack([Araw, sp.eye(n), -sp.eye(n)]).tocsr()
    m = A.shape[0]
    x0 = rng.standard_normal(n)
    b = A @ x0 + rng.random(m) + 0.1
    c = rng.standard_normal(n)
    Ky = [ConeConstraint(Cone.NON_NEG, range(m))]
    st64 = SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=20000)
    s_cpu = ConeSolver(A, Ky=Ky, settings=st64, dtype=np.float64)

    def run_cpu():
        return s_cpu.solve(b, c, settings=st64)

    wall, out = _warm_time(run_cpu, 3)
    print(_json.dumps({
        "problem": f"sparse_lp_{m}x{n}_d{density}", "m": m, "n": n,
        "density": density, "solver": "pogs_tpu_bcoo_hsde",
        "warm_ms": round(wall * 1e3, 2), "status": int(out.status),
        "iterations": int(out.final_iter),
        "objective": round(float(out.optval), 6), "backend": "cpu",
        "note": "f64 cg strategy, BCOO kept"}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="pin the JAX CPU backend")
    ap.add_argument("--quick", action="store_true",
                    help="small sizes only")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_enable_x64", True)  # cone LP runs f64
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from pogs_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()

    rows = []
    rows += bench_lasso(2000, 1000, 0.01)
    rows += bench_cone_lp(800, 300, 0.02)
    if not args.quick:
        rows += bench_lasso(10000, 5000, 0.01)

    from benchmarks.head_to_head import merge_results

    merge_results("sparse", rows)
    print("merged into results.json under 'sparse'")


if __name__ == "__main__":
    if len(sys.argv) >= 5 and sys.argv[1] == "--cone-cpu-row":
        _cone_cpu_row(int(sys.argv[2]), int(sys.argv[3]),
                      float(sys.argv[4]))
        sys.exit(0)
    main()
