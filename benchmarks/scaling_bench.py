"""Weak-scaling benchmark: row-sharded lasso solves over growing meshes.

Protocol: fix n and the per-device row count, grow m with the mesh
(m = rows_per_device * D), run a fixed-iteration solve (so every mesh size
does identical per-device work plus collectives), and report
time-per-iteration and efficiency vs the 1-device run, together with the
collectives XLA inserted into each solve program.

On several GPUs it measures scaling directly.  On a virtual CPU mesh it
validates the sharding structure only (the devices share cores):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/scaling_bench.py

Prints one JSON line per mesh size plus a summary line.
"""

import json
import os
import re
import time

import numpy as np


ROWS_PER_DEVICE = 2048
N = 512
ITERS = 60
REPS = 8

def count_collectives(txt: str, name: str, scope: str = "") -> int:
    """Count ``name`` collective ops in HLO text (optionally restricted to
    lines containing ``scope``, e.g. "while/body").  Single source of
    truth — tests/test_sharding.py imports this."""
    lines = [l for l in txt.splitlines() if scope in l] if scope else [txt]
    return sum(len(re.findall(rf"{name}(?:\.\d+)?\(", l)) for l in lines)


def collective_counts(solver, f, g, rho0=1.0):
    """Lower the FULL jitted solve program for this (sharded) solver and
    count the collectives GSPMD inserted — structural evidence of the
    communication plan, no multi-device hardware needed.

    Expected row plan: the hot loop's only all-reduces are Aᵀ-side psums
    (projector + residual norms); no all-gather of A anywhere."""
    from pogs_tpu.solver.graph import _get_solve_fn

    solver.init()
    fn = _get_solve_fn(
        (solver.m, solver.n), solver.dtype, f.h, g.h, solver.settings,
        solver.projector, solver.direct_method, False, False, False,
    )
    f.to_device()
    g.to_device()
    txt = fn.lower(solver._init_state, tuple(f.params), tuple(g.params),
                   rho0, {}).compile().as_text()
    return {
        name: count_collectives(txt, name)
        for name in ("all-reduce", "all-gather", "reduce-scatter",
                     "collective-permute", "all-to-all")
    }


def measure_loop_collective_shapes(n_devices=None):
    """Lower the row-plan solve on the virtual mesh and return the
    while-body all-reduce structure: (count of n-length vector
    all-reduces, count of scalar all-reduces).  This is MEASURED from
    the SPMD-partitioned HLO, not assumed; the counts are
    shape-independent (the vector ops are the two Aᵀ-side psums of a
    length-n operand, the scalar one is the bundled residual-norm
    reduction)."""
    import re as _re

    import jax

    if len(jax.devices()) < 2:
        raise RuntimeError(
            "measure_loop_collective_shapes needs a multi-device mesh; "
            "run under JAX_PLATFORMS=cpu "
            "XLA_FLAGS=--xla_force_host_platform_device_count=8 before "
            "any other jax use")

    import jax.numpy as jnp

    from pogs_tpu.types import Function, FunctionVector, SolverSettings
    from pogs_tpu.parallel.mesh import make_mesh, shard_matrix
    from pogs_tpu.solver.graph import GraphFormSolver, _get_solve_fn

    D = n_devices or len(jax.devices())
    m, n = 256 * D, 128
    rng = np.random.default_rng(7)
    A = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=jnp.float32)
    g = FunctionVector(Function.ABS, n, c=0.5, dtype=jnp.float32)
    st = SolverSettings(abs_tol=1e-30, rel_tol=1e-30, max_iter=8)
    mesh = make_mesh((D,), ("rows",))
    solver = GraphFormSolver(shard_matrix(jnp.asarray(A), mesh),
                             dtype=jnp.float32, settings=st)
    solver.init()
    fn = _get_solve_fn((m, n), solver.dtype, f.h, g.h, st, solver.projector,
                       solver.direct_method, False, False, False)
    f.to_device()
    g.to_device()
    txt = fn.lower(solver._init_state, tuple(f.params), tuple(g.params),
                   1.0, {}).compile().as_text()
    counts = {"main_vector": 0, "main_small": 0,
              "exact_branch_vector": 0, "exact_branch_small": 0}
    for line in txt.splitlines():
        # Def lines look like `%x = f32[128]{0} all-reduce(...)` or, for
        # XLA's bundled reductions, `%x = (f32[], f32[3]{0}, ...) all-reduce(`
        # — capture everything between '= ' and ' all-reduce('.  Each OP is
        # one collective regardless of how many tuple members ride it.
        mm = _re.search(r"= (.+?) all-reduce\(", line)
        if not mm or "while/body" not in line:
            continue
        shape = mm.group(1)
        kind = "vector" if f"[{n}]" in shape else "small"
        # The exact-residual branch (lax.cond) only executes when the
        # approximate residuals are within 10x of tolerance
        # (pogs.cpp:310-336) — a handful of iterations per solve.
        scope = "exact_branch" if "/cond/" in line else "main"
        counts[f"{scope}_{kind}"] += 1
    return counts


def main():
    import jax
    import jax.numpy as jnp

    from pogs_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()

    from pogs_tpu.types import Function, FunctionVector, SolverSettings
    from pogs_tpu.parallel.mesh import make_mesh, shard_matrix
    from pogs_tpu.solver.graph import GraphFormSolver

    n_dev = len(jax.devices())
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]
    # Fixed iteration count: tolerance 0 never converges -> exactly ITERS.
    st = SolverSettings(abs_tol=1e-30, rel_tol=1e-30, max_iter=ITERS,
                        adaptive_rho=True)

    results = []
    rows = []
    for d in sizes:
        m = ROWS_PER_DEVICE * d
        rng = np.random.default_rng(7)
        A = rng.standard_normal((m, N)).astype(np.float32)
        b = rng.standard_normal(m).astype(np.float32)
        lam = 0.2 * float(np.max(np.abs(A.T @ b)))
        f = FunctionVector(Function.SQUARE, m, b=b, dtype=jnp.float32)
        g = FunctionVector(Function.ABS, N, c=lam, dtype=jnp.float32)

        mesh = make_mesh((d,), ("rows",))
        A_sh = shard_matrix(jnp.asarray(A), mesh)
        solver = GraphFormSolver(A_sh, dtype=jnp.float32, settings=st)
        colls = collective_counts(solver, f, g)
        solver.solve(f, g)  # compile + init

        ts = []
        for rep in range(REPS):
            solver.reset_warm_start()
            t0 = time.perf_counter()
            out = solver.solve(f, g, rho=1.0 + 1e-4 * (rep + 1))
            ts.append(time.perf_counter() - t0)
        per_iter_us = float(np.median(ts[2:])) / ITERS * 1e6
        results.append((d, per_iter_us))
        eff = results[0][1] / per_iter_us if per_iter_us > 0 else 0.0
        row = {
            "metric": "weak_scaling_lasso",
            "devices": d,
            "rows": m,
            "cols": N,
            "us_per_iter": round(per_iter_us, 1),
            "weak_scaling_efficiency": round(eff, 3),
            "collectives_in_solve_program": colls,
            "backend": jax.devices()[0].platform,
        }
        rows.append(row)
        print(json.dumps(row))

    summary = None
    if len(results) > 1:
        final_eff = results[0][1] / results[-1][1]
        summary = {
            "metric": "weak_scaling_efficiency_final",
            "value": round(final_eff, 3),
            "devices": results[-1][0],
        }
        if jax.devices()[0].platform == "cpu":
            # Virtual CPU devices share the same physical cores: total work
            # grows with D on fixed silicon, so efficiency trends to 1/D by
            # construction.  This mode validates the sharding structure
            # (collectives compile + run, results match single-device);
            # the efficiency number is only meaningful on real devices.
            summary["note"] = (
                "virtual CPU mesh: devices share cores; efficiency ~1/D "
                "expected. Structural validation only."
            )
        print(json.dumps(summary))



if __name__ == "__main__":
    import sys as _sys

    # `python benchmarks/scaling_bench.py` puts benchmarks/ (not the repo
    # root) on sys.path; make pogs_tpu importable either way.
    _sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
