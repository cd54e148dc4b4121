"""Smoke test of the solver's main path on NVIDIA GPUs.

Run from the repository root:

    python chip_smoke.py               # seven phases on one GPU
    python chip_smoke.py --four-cards  # the mesh path on four GPUs vs one

Each phase drives public entry points at a realistic size, checks the
answer with a solver-independent certificate (float64 NumPy KKT residuals,
HiGHS, a published optimum), asserts that the solver's arrays live on the
GPU, and prints one line with its wall time, iterations and check value.
The last line of standard output is one JSON object naming the device; it
is printed only when every phase passed.  Without a GPU the script exits
non-zero before running anything.

Tolerances.  Float32 phases stop ADMM at abs/rel 1e-4/1e-3 (the reference
protocol), so their KKT residual, relative to the soft-threshold level λ,
sits near the stopping tolerance and far above f32 rounding; every f32
product is traced under ``highest_precision`` (utils/precision.py), so TF32
never enters.  The CPU tests call the same phase functions, at toy sizes,
against the same constants.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

from benchmarks.problems import lasso, lasso_kkt, lp_ineq

# --- sizes (the defaults of each phase) ------------------------------------
HEADLINE = (500, 300)          # reference README benchmark, bench.py
LARGE = (10000, 5000)          # largest README head-to-head row: 200 MB of A
SWEEP_K = 128                  # λ values in the batched sweep
LP = (2000, 1000)              # random rows of the dense LP (+ 2n box rows)
QP_N, QP_OPT = 1000, 1.0875115673e6   # CVXQP1_M and its published optimum
QP_HSDE_ITERS = 40000          # device HSDE seed for the PDAS polish
SPARSE = (10000, 5000, 0.01)   # benchmarks/sparse_bench.py's instance

# --- tolerances and why ---------------------------------------------------
# f32 ADMM stopped at abs/rel 1e-4/1e-3: the KKT residual over λ follows the
# relative stopping tolerance, not f32 rounding (~1e-7).  On the CPU the
# full-size phases reach 2.3e-3 (headline) and 9.3e-3 (worst sweep lane).
KKT_F32 = 2e-2
# f64 lasso at 1e-8: the CPU record of this solve reached 1.9e-8.
KKT_F64 = 1.9e-8
# f64 HSDE at 1e-6 with the IPM tail polish: objective within 1e-6 of HiGHS.
LP_REL = 1e-6
# CVXQP with PDAS polish in f64: KKT residuals at 1e-6 and the objective
# within 1e-6 of the published value (quoted to 8 significant digits).
QP_KKT, QP_REL = 1e-6, 1e-6
# Mesh vs one card, f32: reductions run in another order across shards, so
# ADMM stops a few iterations apart; solutions agree to the stopping
# tolerance, relative to the solution's max norm.
MESH_REL = 5e-3


class CheckFailed(Exception):
    """A phase's result failed its certificate."""


def check(ok: bool, what: str):
    if not ok:
        raise CheckFailed(what)


def on_platform(platform: str, tree) -> int:
    """Assert every jax.Array leaf of ``tree`` lives on ``platform``; return
    the number of distinct devices they use."""
    import jax

    leaves = [x for x in jax.tree_util.tree_leaves(tree)
              if isinstance(x, jax.Array)]
    check(bool(leaves), "no device arrays to check")
    devs = set()
    for x in leaves:
        for d in x.devices():
            check(d.platform == platform,
                  f"array on {d.platform}, expected {platform}")
            devs.add(d.id)
    return len(devs)


def _lasso(m, n, seed=42, dtype=np.float32):
    p = lasso(m, n, seed=seed)
    return p["A"].astype(dtype), p["b"].astype(dtype), float(p["lambd"])


def _cold(solver):
    """Forget a GraphFormSolver's previous solve (warm-start iterate and
    adapted rho), so that a repeat is a cold solve."""
    solver.reset_warm_start()
    solver.rho = float(solver.settings.rho)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


# --- phases ---------------------------------------------------------------

def phase_headline(platform, m=HEADLINE[0], n=HEADLINE[1]):
    """solve_lasso at the reference protocol, f32, abs/rel 1e-4/1e-3."""
    from pogs_tpu import GraphFormSolver, solve_lasso

    A, b, lam = _lasso(m, n)
    solver = GraphFormSolver(A)

    def run():
        _cold(solver)
        return solve_lasso(A, b, lam, abs_tol=1e-4, rel_tol=1e-3,
                           gap_stop=False, backend="jax", solver=solver)

    out, wall = _timed(run)
    out, solve_s = _timed(run)
    on_platform(platform, (solver._init_state, solver._z))
    check(out["status"] == 0, f"status {out['status']}")
    kkt = lasso_kkt(A, b, lam, out["x"], 1e-5)
    check(kkt <= KKT_F32, f"KKT {kkt:.3e} > {KKT_F32}")
    return {"wall_s": wall, "solve_s": solve_s, "iters": out["iterations"],
            "kkt": kkt}


def phase_large(platform, m=LARGE[0], n=LARGE[1]):
    """GraphFormSolver on a large dense lasso: blocked Gram, panel inverse."""
    from pogs_tpu import Function, FunctionVector, GraphFormSolver
    from pogs_tpu.types import SolverSettings, Status

    A, b, lam = _lasso(m, n, seed=7)
    st = SolverSettings(abs_tol=1e-4, rel_tol=1e-3)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=np.float32)
    g = FunctionVector(Function.ABS, n, c=lam, dtype=np.float32)
    solver = GraphFormSolver(A, settings=st)
    res, wall = _timed(lambda: solver.solve(f, g))
    _cold(solver)
    res, solve_s = _timed(lambda: solver.solve(f, g))
    on_platform(platform, (res.x, solver._init_state))
    check(res.status == Status.SUCCESS, f"status {res.status.name}")
    kkt = lasso_kkt(A, b, lam, np.asarray(res.x), 1e-5)
    check(kkt <= KKT_F32, f"KKT {kkt:.3e} > {KKT_F32}")
    return {"wall_s": wall, "solve_s": solve_s,
            "iters": int(res.final_iter), "kkt": kkt}


def phase_sweep(platform, m=HEADLINE[0], n=HEADLINE[1], K=SWEEP_K):
    """batched_graph_solve over K λ values, then the warm path on the same
    grid; every lane checked by its own KKT certificate."""
    import jax
    from pogs_tpu import Function, FunctionVector, SolverSettings
    from pogs_tpu.parallel.batch import batched_graph_solve, solve_lasso_path

    A, b, lam = _lasso(m, n)
    lambdas = (np.geomspace(1.0, 0.1, K) * lam).astype(np.float32)
    st = SolverSettings(abs_tol=1e-4, rel_tol=1e-3)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=np.float32)
    g = FunctionVector(Function.ABS, n, dtype=np.float32)

    def run_batch():
        return jax.block_until_ready(
            batched_graph_solve(A, f, g, lambdas, settings=st))

    def run_warm():
        return jax.block_until_ready(
            solve_lasso_path(A, b, lambdas, settings=st, warm=True))

    out, wall = _timed(run_batch)
    out, batch_s = _timed(run_batch)
    warm, warm_wall = _timed(run_warm)
    warm, warm_s = _timed(run_warm)
    on_platform(platform, (out["x"], warm["x"]))
    worst = 0.0
    for res in (out, warm):
        x = np.asarray(res["x"])
        check(x.shape == (K, n), f"x shape {x.shape}")
        check(bool(np.all(np.asarray(res["status"]) == 0)),
              f"statuses {np.asarray(res['status']).tolist()}")
        # Each lane's violation is taken relative to the headline λ (the
        # grid's largest), so one threshold holds across the grid.
        worst = max(worst, max(
            lasso_kkt(A, b, float(lambdas[k]), x[k], 1e-5) * float(lambdas[k]) / lam
            for k in range(K)))
    check(worst <= KKT_F32, f"worst lane KKT {worst:.3e} > {KKT_F32}")
    return {"wall_s": wall + warm_wall, "solve_s": batch_s,
            "warm_path_s": warm_s,
            "iters": int(np.sum(np.asarray(out["iterations"]))),
            "warm_iters": int(np.sum(np.asarray(warm["iterations"]))),
            "kkt": worst}


def phase_lp(platform, m=LP[0], n=LP[1]):
    """Dense inequality LP through solve_cone_problem (XLA HSDE loop), f64,
    against scipy's HiGHS."""
    from scipy.optimize import linprog

    from pogs_tpu import ConeSolver, dims_to_cones, solve_cone_problem
    from pogs_tpu.types import SolverSettings

    p = lp_ineq(m, n, seed=3)
    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=20000)
    solver = ConeSolver(p["A"], Ky=dims_to_cones(p["dims"]), settings=st,
                        dtype=np.float64)
    def run():
        return solve_cone_problem(
            p["c"], p["A"], p["b"], p["dims"], abs_tol=1e-6, rel_tol=1e-6,
            max_iter=20000, dtype=np.float64, solver=solver)

    out, wall = _timed(run)
    out, solve_s = _timed(run)
    on_platform(platform, solver._init_state)
    check(out["status"] == 0, f"status {out['status_name']}")
    ref = linprog(p["c"], A_ub=p["A"], b_ub=p["b"], bounds=(None, None),
                  method="highs")
    check(ref.status == 0, f"HiGHS status {ref.status}")
    rel = abs(out["optval"] - ref.fun) / max(1.0, abs(ref.fun))
    check(rel <= LP_REL, f"objective off HiGHS by {rel:.3e} > {LP_REL}")
    return {"wall_s": wall, "solve_s": solve_s,
            "iters": out["iterations"], "rel_obj_err": rel}


def phase_qp(platform, n=QP_N, optval=QP_OPT):
    """CVXQP1 in f64 by two routes, each checked by the instance's KKT
    certificate and its published optimum: solve_qp (for a polyhedral QP
    the host interior-point method, then the PDAS polish) and
    batched_qp_solve (the HSDE loop on the device seeds the PDAS polish).
    Both return host arrays, so the placement check covers every array the
    process holds."""
    import jax

    from benchmarks.maros_meszaros import (cvxqp_problem, kkt_certificate,
                                           to_cone_form)
    from pogs_tpu import Cone, ConeConstraint, SolverSettings, solve_qp
    from pogs_tpu.parallel.batch import batched_qp_solve

    p = cvxqp_problem(1, n, optval)
    out, wall = _timed(lambda: solve_qp(
        p["Q"], p["c"], A=p["A"], b=p["rhs"], lb=p["lb"], ub=p["ub"],
        abs_tol=1e-6, rel_tol=1e-6, max_iter=40000, dtype=np.float64))
    check(out["status"] == 0, f"solve_qp status {out['status_name']}")
    P, c, A_bar, b_bar, n_eq = to_cone_form(p)
    Ky = [ConeConstraint(Cone.ZERO, range(n_eq)),
          ConeConstraint(Cone.NON_NEG, range(n_eq, A_bar.shape[0]))]
    dev, dev_wall = _timed(lambda: batched_qp_solve(
        A_bar, P, b_bar[None], c[None], Ky,
        settings=SolverSettings(abs_tol=1e-6, rel_tol=1e-6,
                                max_iter=QP_HSDE_ITERS)))
    on_platform(platform, jax.live_arrays())
    check(bool(dev["polished"][0]) and int(dev["status"][0]) == 0,
          f"device route status {int(dev['status'][0])}, "
          f"polished {bool(dev['polished'][0])}")
    worst, rel = 0.0, 0.0
    for x in (out["x"], dev["x"][0]):
        worst = max(worst, max(kkt_certificate(p, x).values()))
        rel = max(rel, abs(p["c"] @ x + 0.5 * x @ p["Q"] @ x - optval)
                  / abs(optval))
    check(worst <= QP_KKT, f"KKT {worst:.3e} > {QP_KKT}")
    check(rel <= QP_REL, f"objective off the published value by {rel:.3e}")
    return {"wall_s": wall, "device_route_s": dev_wall,
            "iters": out["iterations"],
            "device_hsde_iters": int(dev["iterations"][0]),
            "kkt": worst, "rel_obj_err": rel}


def phase_sparse(platform, m=SPARSE[0], n=SPARSE[1], density=SPARSE[2]):
    """Sparse lasso kept as BCOO, solved with the CGLS projector, f32."""
    import scipy.sparse as sp

    from pogs_tpu import Function, FunctionVector, GraphFormSolver
    from pogs_tpu.types import SolverSettings, Status

    rng = np.random.default_rng(5)
    A = sp.random(m, n, density=density, random_state=3, format="csr")
    A.data[:] = rng.standard_normal(A.nnz)
    x_true = np.zeros(n)
    idx = rng.choice(n, max(n // 20, 1), replace=False)
    x_true[idx] = rng.standard_normal(idx.size)
    b = A @ x_true + 0.1 * rng.standard_normal(m)
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    st = SolverSettings(abs_tol=1e-4, rel_tol=1e-3)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=np.float32)
    g = FunctionVector(Function.ABS, n, c=lam, dtype=np.float32)
    solver = GraphFormSolver(A, dtype=np.float32, settings=st)
    check(solver.A.is_sparse and solver.projector == "cgls",
          "sparse input was not kept sparse with the CGLS projector")
    res, wall = _timed(lambda: solver.solve(f, g))
    _cold(solver)
    res, solve_s = _timed(lambda: solver.solve(f, g))
    on_platform(platform, (res.x, solver._init_state))
    check(res.status == Status.SUCCESS, f"status {res.status.name}")
    kkt = lasso_kkt(A, b, lam, np.asarray(res.x), 1e-5)
    check(kkt <= KKT_F32, f"KKT {kkt:.3e} > {KKT_F32}")
    return {"wall_s": wall, "solve_s": solve_s,
            "iters": int(res.final_iter), "kkt": kkt}


def phase_f64(platform, m=HEADLINE[0], n=HEADLINE[1]):
    """The headline lasso in float64 to abs/rel 1e-8."""
    from pogs_tpu import GraphFormSolver, solve_lasso

    A, b, lam = _lasso(m, n, dtype=np.float64)
    solver = GraphFormSolver(A, dtype=np.float64)

    def run():
        _cold(solver)
        return solve_lasso(A, b, lam, abs_tol=1e-8, rel_tol=1e-8,
                           gap_stop=False, max_iter=20000, backend="jax",
                           dtype=np.float64, solver=solver)

    out, wall = _timed(run)
    out, solve_s = _timed(run)
    on_platform(platform, (solver._init_state, solver._z))
    check(out["status"] == 0, f"status {out['status']}")
    kkt = lasso_kkt(A, b, lam, out["x"], 1e-9)
    check(kkt <= KKT_F64, f"KKT {kkt:.3e} > {KKT_F64}")
    return {"wall_s": wall, "solve_s": solve_s, "iters": out["iterations"],
            "kkt": kkt}


PHASES = [
    ("headline_lasso", phase_headline),
    ("large_dense_lasso", phase_large),
    ("batched_sweep", phase_sweep),
    ("dense_cone_lp", phase_lp),
    ("qp_cvxqp", phase_qp),
    ("sparse_lasso", phase_sparse),
    ("f64_lasso", phase_f64),
]


# --- the mesh path (--four-cards) ----------------------------------------

def _agree(x_mesh, x_one, what):
    x_mesh = np.asarray(x_mesh, np.float64)
    x_one = np.asarray(x_one, np.float64)
    err = float(np.max(np.abs(x_mesh - x_one))
                / max(1.0, float(np.max(np.abs(x_one)))))
    check(err <= MESH_REL, f"{what}: mesh vs one device {err:.3e} > {MESH_REL}")
    return err


def mesh_phases(platform, n_dev=4, rows_dense=(20000, 5000),
                wide=(2000, 20000), sweep=(HEADLINE[0], HEADLINE[1], SWEEP_K),
                sparse_lp=(800, 300, 0.02)):
    """The sharded plans on ``n_dev`` devices, each against the same problem
    on one device.  Yields (name, fields) per plan."""
    import jax
    import scipy.sparse as sp

    from pogs_tpu import (Cone, ConeConstraint, ConeSolver, Function,
                          FunctionVector, GraphFormSolver, SolverSettings)
    from pogs_tpu.parallel.batch import batched_graph_solve
    from pogs_tpu.parallel.mesh import (make_mesh, shard_matrix,
                                        shard_matrix_cols)
    from pogs_tpu.parallel.sparse import pad_cone_rows, shard_sparse

    check(len(jax.devices()) >= n_dev,
          f"{len(jax.devices())} devices, need {n_dev}")
    mesh = make_mesh((n_dev,), ("rows",))
    st = SolverSettings(abs_tol=1e-4, rel_tol=1e-3)

    def lasso_pair(A, b, lam, place):
        f = FunctionVector(Function.SQUARE, A.shape[0], b=b, dtype=np.float32)
        g = FunctionVector(Function.ABS, A.shape[1], c=lam, dtype=np.float32)
        one = GraphFormSolver(A, settings=st).solve(f, g)
        solver = GraphFormSolver(place(A, mesh), settings=st)
        (res, wall) = _timed(lambda: solver.solve(f, g))
        n_on = on_platform(platform, solver._init_state["A"])
        check(n_on == n_dev, f"A spans {n_on} devices, expected {n_dev}")
        kkt = lasso_kkt(A, b, lam, np.asarray(res.x), 1e-5)
        check(kkt <= KKT_F32, f"KKT {kkt:.3e} > {KKT_F32}")
        return {"wall_s": wall, "iters": int(res.final_iter),
                "iters_one": int(one.final_iter), "kkt": kkt,
                "rel_diff": _agree(res.x, one.x, "lasso")}

    A, b, lam = _lasso(*rows_dense, seed=11)
    yield "rows_dense_lasso", lasso_pair(A, b, lam, shard_matrix)
    A, b, lam = _lasso(*wide, seed=12)
    yield "cols_wide_lasso", lasso_pair(A, b, lam, shard_matrix_cols)

    m, n, K = sweep
    A, b, lam = _lasso(m, n)
    lambdas = (np.geomspace(1.0, 0.1, K) * lam).astype(np.float32)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=np.float32)
    g = FunctionVector(Function.ABS, n, dtype=np.float32)
    one = batched_graph_solve(A, f, g, lambdas, settings=st)
    bmesh = make_mesh((n_dev,), ("batch",))
    out, wall = _timed(lambda: jax.block_until_ready(batched_graph_solve(
        A, f, g, lambdas, settings=st, mesh=bmesh, batch_axis="batch")))
    n_on = on_platform(platform, out["x"])
    check(n_on == n_dev, f"sweep spans {n_on} devices, expected {n_dev}")
    check(bool(np.all(np.asarray(out["status"]) == 0)), "sweep statuses")
    yield "batch_sharded_sweep", {
        "wall_s": wall, "iters": int(np.sum(np.asarray(out["iterations"]))),
        "iters_one": int(np.sum(np.asarray(one["iterations"]))),
        "rel_diff": _agree(out["x"], one["x"], "sweep")}

    m0, n, density = sparse_lp
    rng = np.random.default_rng(2)
    Araw = sp.random(m0, n, density=density, random_state=8, format="csr")
    Araw.data[:] = rng.standard_normal(Araw.nnz)
    A = sp.vstack([Araw, sp.eye(n), -sp.eye(n)]).tocsr()
    x0 = rng.standard_normal(n)
    b = (A @ x0 + rng.random(A.shape[0]) + 0.1).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    Ky = [ConeConstraint(Cone.NON_NEG, range(A.shape[0]))]
    st_lp = SolverSettings(abs_tol=1e-4, rel_tol=1e-4, max_iter=20000)

    def sparse_lp(mesh_):
        # The same row-block operator on one device is the reference: a
        # plain BCOO solve takes another route (the IPM tail polish).
        op, _ = shard_sparse(A, mesh_, dtype=np.float32)
        b_pad, Ky_pad = pad_cone_rows(b, Ky, op.shape[0])
        solver = ConeSolver(op, Ky=Ky_pad, settings=st_lp)
        return op, _timed(lambda: solver.solve(b_pad, c))

    _, (one, _) = sparse_lp(make_mesh((1,), ("rows",)))
    op, (res, wall) = sparse_lp(mesh)
    n_on = on_platform(platform, (op.data, op.rows, op.cols))
    check(n_on == n_dev, f"sparse A spans {n_on} devices, expected {n_dev}")
    check(int(res.status) == 0 and int(one.status) == 0,
          f"statuses {int(res.status)} / {int(one.status)}")
    rel = abs(float(res.optval) - float(one.optval)) / max(
        1.0, abs(float(one.optval)))
    check(rel <= MESH_REL, f"sparse LP objective mesh vs one {rel:.3e}")
    yield "rows_sparse_cone_lp", {
        "wall_s": wall, "iters": int(res.final_iter),
        "iters_one": int(one.final_iter), "rel_obj_diff": rel}


# --- entry point ----------------------------------------------------------

def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _fmt(fields: dict) -> str:
    return " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in fields.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh path on four GPUs, against one")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    from pogs_tpu.utils.compile_cache import use_compile_cache

    cache = use_compile_cache()
    print(_card_line())
    print(f"jax {jax.__version__} device_kind={dev.device_kind} "
          f"devices={len(jax.devices())} compile_cache={cache}")

    t_all = time.perf_counter()
    if args.four_cards:
        for name, fields in mesh_phases("gpu", n_dev=4):
            print(f"phase {name}: {_fmt(fields)}", flush=True)
    else:
        for name, fn in PHASES:
            print(f"phase {name}: {_fmt(fn('gpu'))}", flush=True)
    print(f"total_s={time.perf_counter() - t_all:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
