"""HBM-roofline benchmark for the per-iteration hot path.

Protocol: a large dense lasso (HBM-resident) run for a FIXED iteration
count at three multiples (K, 2K, 4K) so the per-iteration time is a
least-squares slope — per-launch, transfer, and init costs cancel, and the
fit residual exposes a non-linear (i.e. broken) measurement instead of
silently publishing it.  Every timed region ends in ``block_until_ready``.

Bytes per iteration come from an analytic model (below).  XLA's
``cost_analysis()['bytes accessed']`` is printed as a diagnostic only: it
counts a while_loop body ONCE regardless of trip count.  Beside the paper
peak, a gemv streaming ceiling measured on the same device is reported,
and a row whose achieved rate exceeds either bound is marked invalid.
``--trace-dir`` captures a jax.profiler device trace.

Prints one JSON line.  Peak bandwidth comes from ``PEAK_GBPS``, keyed by
``device_kind``; a device missing from it is an error.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

# `python benchmarks/roofline_bench.py` puts benchmarks/ (not the repo
# root) on sys.path; make pogs_tpu importable either way.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

M, N = 10000, 5000
# --xl: 40000x10000 f32 (1.6 GB of A); the projector's row-blocked Gram
# (projector/direct.py:_gram) bounds the factorization's transient memory.
XL_M, XL_N = 40000, 10000
K_ITERS = 120
REPS = 5

# Published HBM bandwidth per device_kind (GB/s).  NVIDIA H100 SXM data
# sheet: 80 GB HBM3 at 3.35 TB/s, at the full 700 W power limit.
PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def peak_gbps(kind: str) -> float:
    """Published HBM peak for ``kind``; no peak is assumed for others."""
    if kind not in PEAK_GBPS:
        raise KeyError(f"no published HBM peak for device_kind {kind!r}")
    return PEAK_GBPS[kind]


def _settings(iters):
    from pogs_tpu.types import SolverSettings

    # Zero tolerances: the loop runs exactly ``iters`` iterations (the
    # exact-residual branch never fires), matching the bytes model.
    return SolverSettings(abs_tol=1e-30, rel_tol=1e-30, max_iter=iters)


def measure_gemv_ceiling(A_np, m, n, reps=4):
    """Measured streaming ceiling: least-squares slope of K isolated
    y = A @ x gemvs (fori_loop, HIGHEST precision), streaming A (m*n*4
    bytes) once per iteration.  Constant dispatch/transfer cost cancels
    in the slope."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    A = jnp.asarray(A_np)
    x = jnp.ones((n,), A.dtype)

    def loop(K):
        @jax.jit
        def fn(A, x):
            def body(i, xv):
                y = jnp.matmul(A, xv, precision=lax.Precision.HIGHEST)
                return xv * (1.0 + 1e-9 * y[0])
            return lax.fori_loop(0, K, body, x)
        return fn

    ks = np.array([25, 50, 100])
    ts = []
    for K in ks:
        fn = loop(int(K))
        jax.block_until_ready(fn(A, x))  # compile+warm
        best = min(_timed(lambda: jax.block_until_ready(fn(A, x)))
                   for _ in range(reps))
        ts.append(best)
    ts = np.array(ts)
    slope, intercept = np.polyfit(ks, ts, 1)
    fit = np.polyval([slope, intercept], ks)
    r2 = 1.0 - float(((ts - fit) ** 2).sum()
                     / max(((ts - ts.mean()) ** 2).sum(), 1e-30))
    if slope <= 0:
        # A negative/zero slope means the measurement is noise-dominated:
        # no ceiling can be quoted (clamping would yield an astronomical
        # bound that silently defeats the refusal check downstream).
        return None, r2
    return float(m * n * A.dtype.itemsize / slope / 1e9), r2


def _timed(thunk):
    t0 = time.perf_counter()
    thunk()
    return time.perf_counter() - t0


def measure(solver, f, g, iters):
    st = _settings(iters)
    import jax

    jax.block_until_ready(solver.solve(f, g, settings=st, _no_sync=True))
    ts = []
    for rep in range(REPS):
        solver.reset_warm_start()
        t0 = time.perf_counter()
        jax.block_until_ready(solver.solve(
            f, g, settings=st, rho=1.0 + 1e-4 * (rep + 1), _no_sync=True))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts[1:]))


def xla_bytes_accessed(solver, f, g, iters):
    """XLA cost-model bytes for the whole compiled solve (diagnostic
    only: XLA counts the while_loop body once regardless of trip count).
    None when the backend does not expose cost analysis."""
    from pogs_tpu.solver import graph as graph_mod

    st = _settings(iters)
    fn = graph_mod._get_solve_fn(
        (solver.m, solver.n), solver.dtype, f.h, g.h, st,
        solver.projector, solver.direct_method,
        has_warm=False, has_x0=False, has_nu0=False,
    )
    try:
        lowered = fn.lower(solver._init_state, tuple(f.params),
                           tuple(g.params), 1.0, {})
        cost = lowered.compile().cost_analysis()
        if isinstance(cost, (list, tuple)):
            cost = cost[0]
        return float(cost["bytes accessed"])
    except Exception:
        return None


def main():
    import jax
    import jax.numpy as jnp

    from pogs_tpu import Function, FunctionVector, GraphFormSolver
    from pogs_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()

    ap = argparse.ArgumentParser()
    ap.add_argument("--xl", action="store_true",
                    help=f"run the {XL_M}x{XL_N} HBM-wall configuration")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--trace-dir", default=None,
                    help="capture a jax.profiler device trace of one timed "
                         "solve into this directory")
    args = ap.parse_args()
    m, n = (XL_M, XL_N) if args.xl else (M, N)
    k_iters = args.iters or (K_ITERS // 2 if args.xl else K_ITERS)

    rng = np.random.default_rng(11)
    A = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=jnp.float32)
    g = FunctionVector(Function.ABS, n, c=lam, dtype=jnp.float32)

    solver = GraphFormSolver(A, dtype=jnp.float32)
    solver.init()

    # Three-point least-squares slope: t(K) for K in {k, 2k, 4k}.
    ks = np.array([k_iters, 2 * k_iters, 4 * k_iters])
    ts = np.array([measure(solver, f, g, int(k)) for k in ks])
    slope, intercept = np.polyfit(ks, ts, 1)
    per_iter_s = max(float(slope), 1e-9)
    fit = np.polyval([slope, intercept], ks)
    r2 = 1.0 - float(((ts - fit) ** 2).sum() / max(((ts - ts.mean()) ** 2).sum(), 1e-30))

    if args.trace_dir:
        import jax.profiler as profiler

        with profiler.trace(args.trace_dir):
            st = _settings(int(ks[0]))
            solver.reset_warm_start()
            jax.block_until_ready(solver.solve(f, g, settings=st,
                                               _no_sync=True))

    # Bytes/iteration: the direct-inverse tall path streams A twice
    # (A'y0 for the projection rhs, A x for y), the min(m,n)^2 Gram inverse
    # once, and ~14 vector-length passes (prox, over-relax, dual update,
    # residual norms).  Exact-residual iterations would add 2 more m*n
    # streams but never fire at zero tolerance.
    itemsize = 4
    k_dim = min(m, n)
    kind = jax.devices()[0].device_kind
    peak = peak_gbps(kind)
    bytes_per_iter = (2 * m * n + k_dim * k_dim + 14 * (m + n)) * itemsize
    xla_total = xla_bytes_accessed(solver, f, g, int(ks[0]))
    achieved_gbps = bytes_per_iter / per_iter_s / 1e9

    # Calibrated streaming ceiling: slope of K isolated y = A @ x gemvs
    # (streams A once per iteration).  This is what the DEVICE actually
    # sustains for this access pattern — the honest upper bound for any
    # gemv-bound loop, typically below the paper HBM peak.
    gemv_ceiling_gbps, ceiling_r2 = measure_gemv_ceiling(A, m, n)

    out = {
        "metric": f"roofline_lasso_{m}x{n}",
        "us_per_iter": round(per_iter_s * 1e6, 1),
        "bytes_per_iter_mb": round(bytes_per_iter / 1e6, 1),
        "bytes_source": "analytic_model",
        "xla_whole_solve_mb": (round(xla_total / 1e6, 1)
                               if xla_total is not None else None),
        "slope_fit_r2": round(r2, 5),
        "achieved_gbps": round(achieved_gbps, 1),
        "measured_gemv_ceiling_gbps": (round(gemv_ceiling_gbps, 1)
                                       if gemv_ceiling_gbps else None),
        "gemv_ceiling_fit_r2": round(ceiling_r2, 5),
        "device_kind": kind,
        "backend": jax.devices()[0].platform,
    }
    if gemv_ceiling_gbps is None or ceiling_r2 < 0.95:
        out["warning"] = ("gemv ceiling slope non-positive or fit poor "
                          f"(r2={ceiling_r2:.3f}): ceiling measurement "
                          "invalid; do not publish this row")
    else:
        out["fraction_of_measured_ceiling"] = round(
            achieved_gbps / gemv_ceiling_gbps, 3)
        if achieved_gbps > 1.05 * gemv_ceiling_gbps:
            out["warning"] = ("achieved > measured ceiling: measurement or "
                              "cost model invalid; do not publish this row")
    out["peak_gbps"] = peak
    out["fraction_of_roofline"] = round(achieved_gbps / peak, 3)
    if achieved_gbps > peak:
        out["warning"] = ("achieved > paper peak: measurement or cost "
                          "model invalid; do not publish this row")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
