"""Real-data & regression benchmark suite (VERDICT round-1 item 5).

Counterpart of the reference's real_data_benchmark.py / maros_benchmark.py
(reference python/benchmarks/), adapted to a no-network environment:

  1. **Maros–Mészáros QP subset** — vendored classics (benchmarks/
     maros_meszaros.py) solved through the QP path and checked against
     their PUBLISHED optimal values (plus a scipy-SLSQP cross-check).
  2. **Real datasets** — sklearn's bundled real data (no download):
     breast-cancer (569×30, classification → logistic / SVM), diabetes
     (442×10, regression → lasso / ridge / elastic net).  Pass criterion:
     pogs_tpu's canonical objective within rel 1e-3 of the sklearn
     production solver's on the identical problem.
  3. **Structured regression problems** — TV denoising, MPC QP, portfolio
     (benchmarks/problems.py) against stored expected optima
     (benchmarks/regression_expected.json; refresh with --record on a
     trusted f64 run).

Usage:
    python benchmarks/real_data_benchmark.py [--record]

Prints a pass table and merges rows under the "real_data" key of
benchmarks/results.json.
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

# The suite solves at abs/rel 1e-6 in float64; without x64 JAX silently
# truncates to f32 (the QP polish still rescues accuracy host-side, but
# what is advertised as an f64 run must actually be one).  It is the f64
# *correctness* suite; bench.py is the performance suite.
jax.config.update("jax_enable_x64", True)

from benchmarks import maros_meszaros as mm  # noqa: E402
from benchmarks import problems  # noqa: E402
from benchmarks.head_to_head import canonical_objective, merge_results  # noqa: E402

EXPECTED_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "regression_expected.json")


def run_maros():
    """HS-family toys: arithmetic validation.  `ms` is the WARM re-solve
    (deployment methodology — the first call is compile+transport and is
    recorded separately as cold_ms, never presented as solve time)."""
    rows = []
    for p in mm.problems():
        t0 = time.perf_counter()
        r = mm.solve_with_pogs_tpu(p)
        cold_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        r = mm.solve_with_pogs_tpu(p)
        ms = (time.perf_counter() - t0) * 1e3
        err = abs(r["objective"] - p["optval"]) / max(abs(p["optval"]), 1.0)
        rows.append({
            "suite": "maros_meszaros", "problem": p["name"],
            "n": int(p["c"].shape[0]),
            "objective": round(r["objective"], 9),
            "published": p["optval"],
            "rel_err": round(err, 9),
            "iterations": r["iterations"], "ms": round(ms, 2),
            "cold_ms": round(cold_ms, 2),
            "pass": bool(err <= 1e-4 + 1e-4 * abs(p["optval"])
                         and r["status"] == 0),
        })
    return rows


def run_midsize(include_m_size=True):
    """Mid-size Maros–Mészáros-class suite (CVXQP/AUG2D/DUAL structures,
    n = 100–1000, cond(Q) up to ~1e18, degenerate constraint variants).

    Every solve carries a solver-independent KKT certificate
    (mm.kkt_certificate: dual estimate by sign-constrained least squares
    from x alone); `pass` requires certificate residuals ≤ 1e-6 AND
    agreement with the published / oracle optimum where one exists.
    """
    rows = []
    for p in mm.midsize_problems(include_m_size=include_m_size):
        n = int(p["c"].shape[0])
        max_iter = 1500 if n <= 300 else 300
        t0 = time.perf_counter()
        r = mm.solve_with_pogs_tpu(p, max_iter=max_iter)
        cold_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        r = mm.solve_with_pogs_tpu(p, max_iter=max_iter)
        ms = (time.perf_counter() - t0) * 1e3
        cert = mm.kkt_certificate(p, r["x"])
        optval = p["optval"]
        if not np.isfinite(optval):  # DUAL_*: live SLSQP oracle
            optval = mm.solve_with_slsqp(p)
        err = abs(r["objective"] - optval) / max(abs(optval), 1.0)
        rows.append({
            "suite": "maros_meszaros_midsize", "problem": p["name"],
            "n": n, "m_rows": int(p["A"].shape[0]),
            "objective": round(r["objective"], 6),
            "oracle": round(float(optval), 6),
            "rel_err": round(err, 12),
            "kkt_stat": round(cert["stat"], 12),
            "kkt_pri": round(cert["pri"], 12),
            "kkt_comp": round(cert["comp"], 12),
            "iterations": r["iterations"], "ms": round(ms, 2),
            "cold_ms": round(cold_ms, 2),
            "pass": bool(r["status"] == 0 and err <= 1e-6
                         and max(cert.values()) <= 1e-6),
        })
    # Receding-horizon evidence: the QP warm start (round-3) re-solves a
    # perturbed DUAL_200 through the same ConeSolver.  (DUAL_200 is the
    # representative whose ADMM converges on its own — on the CVXQP
    # family the iterate count is pinned at max_iter and the PDAS polish
    # does the converging, so an iteration comparison says nothing.)
    rep = [p for p in mm.midsize_problems(include_m_size=False)
           if p["name"] == "DUAL_200"][0]
    ci, wi, wms, werr = mm.warm_resolve_stats(rep, max_iter=5000)
    rows.append({
        "suite": "maros_meszaros_midsize", "problem": "DUAL_200_warm_resolve",
        "n": 200, "m_rows": 1,
        "objective": None, "oracle": None,
        "rel_err": round(werr, 12),
        "kkt_stat": None, "kkt_pri": None, "kkt_comp": None,
        "iterations": wi, "cold_iterations": ci,
        "ms": round(wms, 2), "cold_ms": None,
        # Evidence criterion: the warm re-solve must not be WORSE than
        # cold, and must match the cold optimum.  Strict wi < ci is only
        # demandable when the cold solve leaves room — the staged PDAS
        # polish now certifies this instance in ~10 iterations, where a
        # warm start has nothing left to save.
        "pass": bool(wi <= ci and werr <= 1e-6),
    })
    return rows


def _real_datasets():
    from sklearn.datasets import load_breast_cancer, load_diabetes

    bc = load_breast_cancer()
    Xb = (bc.data - bc.data.mean(0)) / bc.data.std(0)
    yb = 2.0 * bc.target - 1.0  # ±1 labels
    db = load_diabetes()
    Xd = (db.data - db.data.mean(0)) / db.data.std(0)
    yd = (db.target - db.target.mean()) / db.target.std()
    return {
        "breast_cancer": (Xb.astype(np.float64), yb.astype(np.float64)),
        "diabetes": (Xd.astype(np.float64), yd.astype(np.float64)),
    }


def run_real_datasets():
    """Classification + regression on genuinely real data, scored by the
    canonical-objective protocol of head_to_head.py."""
    from pogs_tpu.api.graph import (
        solve_elastic_net, solve_lasso, solve_logistic, solve_ridge, solve_svm,
    )
    import sklearn.linear_model as lm
    import sklearn.svm as svm_mod
    import warnings

    data = _real_datasets()
    rows = []

    def row(dataset, problem, p, x_mine, x_skl, ms_mine, ms_skl, iters):
        obj_mine = canonical_objective(problem, p, x_mine)
        obj_skl = canonical_objective(problem, p, x_skl)
        best = min(obj_mine, obj_skl)
        gap = (obj_mine - best) / max(abs(best), 1.0)
        rows.append({
            "suite": "real_data", "dataset": dataset, "problem": problem,
            "m": p["A"].shape[0], "n": p["A"].shape[1],
            "objective": round(obj_mine, 6),
            "sklearn_objective": round(obj_skl, 6),
            "obj_rel_gap": round(gap, 8),
            "ms": round(ms_mine, 2), "sklearn_ms": round(ms_skl, 2),
            "iterations": iters,
            "pass": bool(gap <= 1e-3),
        })

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # --- diabetes regression family
        X, y = data["diabetes"]
        m = X.shape[0]
        lam = 0.1 * np.max(np.abs(X.T @ y))
        for problem, solver, skl in [
            ("lasso",
             lambda: solve_lasso(X, y, lam, abs_tol=1e-6, rel_tol=1e-6,
                                 dtype=np.float64, gap_stop=False),
             lambda: lm.Lasso(alpha=lam / m, fit_intercept=False,
                              tol=1e-8).fit(X, y)),
            ("ridge",
             lambda: solve_ridge(X, y, lam, abs_tol=1e-6, rel_tol=1e-6,
                                 dtype=np.float64, gap_stop=False),
             lambda: lm.Ridge(alpha=lam, fit_intercept=False,
                              solver="cholesky").fit(X, y)),
            ("elastic_net",
             lambda: solve_elastic_net(X, y, lam, lam, abs_tol=1e-6,
                                       rel_tol=1e-6, dtype=np.float64,
                                       gap_stop=False),
             lambda: lm.ElasticNet(alpha=2 * lam / m, l1_ratio=0.5,
                                   fit_intercept=False, tol=1e-8).fit(X, y)),
        ]:
            p = {"A": X, "b": y, "lambd": lam, "lambda1": lam, "lambda2": lam}
            t0 = time.perf_counter(); r = solver(); ms_mine = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter(); mdl = skl(); ms_skl = (time.perf_counter() - t0) * 1e3
            row("diabetes", problem, p, np.asarray(r["x"]),
                np.ravel(mdl.coef_), ms_mine, ms_skl, r["iterations"])

        # --- breast-cancer classification family
        X, y = data["breast_cancer"]
        lam = 1.0
        p = {"A": X, "b": y, "lambd": lam}
        t0 = time.perf_counter()
        r = solve_logistic(X, y, lam, abs_tol=1e-6, rel_tol=1e-6,
                           dtype=np.float64, gap_stop=False)
        ms_mine = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mdl = lm.LogisticRegression(penalty="l1", C=1.0 / lam,
                                    solver="liblinear", fit_intercept=False,
                                    tol=1e-8).fit(X, y)
        ms_skl = (time.perf_counter() - t0) * 1e3
        row("breast_cancer", "logistic", p, np.asarray(r["x"]),
            np.ravel(mdl.coef_), ms_mine, ms_skl, r["iterations"])

        t0 = time.perf_counter()
        r = solve_svm(X, y, lam, abs_tol=1e-6, rel_tol=1e-6,
                      dtype=np.float64, gap_stop=False)
        ms_mine = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mdl = svm_mod.LinearSVC(C=1.0 / lam, loss="hinge",
                                fit_intercept=False, tol=1e-8,
                                max_iter=200000).fit(X, y)
        ms_skl = (time.perf_counter() - t0) * 1e3
        row("breast_cancer", "svm", p, np.asarray(r["x"]),
            np.ravel(mdl.coef_), ms_mine, ms_skl, r["iterations"])
    return rows


def run_libsvm_scale():
    """LIBSVM-class workloads through the JAX solver path.

    The reference's real_data_benchmark pulls LIBSVM sets off the network
    (reference python/benchmarks/real_data_benchmark.py:1-13); this
    environment has no egress, so the suite has two honest tiers:

      * ``digits`` — the largest REAL dataset shipped with sklearn
        (1797x64 handwritten digits, binary split digit<5), l1-logistic
        and hinge SVM vs sklearn oracles.
      * ``rcv1_scale_synthetic`` — a sparse problem with EXACTLY the
        published shape/density/label statistics of rcv1.binary
        (20242x47236, ~0.16% nnz, balanced ±1) — synthetic data, real
        scale; it exercises the BCOO + CGLS route no small dataset can.
        Labeled synthetic; the objective is certified against sklearn
        coordinate descent on the same matrix.
    """
    import warnings

    import scipy.sparse as sp
    import sklearn.linear_model as lm

    from pogs_tpu.api.graph import solve_lasso, solve_logistic

    rows = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # --- digits (real data) --------------------------------------
        from sklearn.datasets import load_digits

        dg = load_digits()
        # Standardize (zero-variance border pixels dropped), as the
        # breast_cancer family does — raw pixel features leave the
        # problem ill-conditioned for every first-order solver.
        keep = dg.data.std(0) > 0
        Xr = dg.data[:, keep]
        X = (Xr - Xr.mean(0)) / Xr.std(0)
        y = np.where(dg.target < 5, -1.0, 1.0)
        lam = 1.0
        p = {"A": X, "b": y, "lambd": lam}
        t0 = time.perf_counter()
        r = solve_logistic(X, y, lam, abs_tol=1e-6, rel_tol=1e-6,
                           dtype=np.float64, gap_stop=False, max_iter=20000)
        ms_mine = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mdl = lm.LogisticRegression(penalty="l1", C=1.0 / lam,
                                    solver="liblinear", fit_intercept=False,
                                    tol=1e-8).fit(X, y)
        ms_skl = (time.perf_counter() - t0) * 1e3
        obj_mine = canonical_objective("logistic", p, np.asarray(r["x"]))
        obj_skl = canonical_objective("logistic", p, np.ravel(mdl.coef_))
        best = min(obj_mine, obj_skl)
        rows.append({
            "suite": "libsvm_scale", "dataset": "digits", "problem": "logistic",
            "m": X.shape[0], "n": X.shape[1],
            "objective": round(obj_mine, 6),
            "sklearn_objective": round(obj_skl, 6),
            "obj_rel_gap": round((obj_mine - best) / max(abs(best), 1.0), 8),
            "ms": round(ms_mine, 2), "sklearn_ms": round(ms_skl, 2),
            "iterations": r["iterations"],
            "pass": bool((obj_mine - best) / max(abs(best), 1.0) <= 1e-3),
        })

        # --- rcv1-scale sparse lasso (synthetic data, real scale) ----
        m, n, density = 20242, 47236, 0.0016
        rng = np.random.default_rng(11)
        A = sp.random(m, n, density=density, random_state=7, format="csr",
                      dtype=np.float64)
        A.data[:] = rng.standard_normal(A.nnz)
        x_true = np.zeros(n)
        idx = rng.choice(n, 200, replace=False)
        x_true[idx] = rng.standard_normal(200)
        b = np.asarray(A @ x_true + 0.1 * rng.standard_normal(m))
        lam = 0.1 * float(np.max(np.abs(A.T @ b)))
        t0 = time.perf_counter()
        r = solve_lasso(A, b, lam, abs_tol=1e-4, rel_tol=1e-4,
                        dtype=np.float32, gap_stop=False, max_iter=1000)
        ms_mine = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mdl = lm.Lasso(alpha=lam / m, fit_intercept=False, tol=1e-6,
                       max_iter=5000).fit(A, b)
        ms_skl = (time.perf_counter() - t0) * 1e3

        def lasso_obj(x):
            res = A @ np.asarray(x, np.float64) - b
            return float(0.5 * res @ res + lam * np.abs(x).sum())

        obj_mine, obj_skl = lasso_obj(r["x"]), lasso_obj(mdl.coef_)
        best = min(obj_mine, obj_skl)
        rows.append({
            "suite": "libsvm_scale", "dataset": "rcv1_scale_synthetic",
            "problem": "lasso", "m": m, "n": n,
            "nnz": int(A.nnz), "density": density,
            "objective": round(obj_mine, 6),
            "sklearn_objective": round(obj_skl, 6),
            "obj_rel_gap": round((obj_mine - best) / max(abs(best), 1.0), 8),
            "ms": round(ms_mine, 2), "sklearn_ms": round(ms_skl, 2),
            "iterations": r["iterations"], "status": int(r["status"]),
            "note": "synthetic data at rcv1.binary's published shape/"
                    "density/label stats (no egress: real LIBSVM files "
                    "not downloadable); BCOO + CGLS sparse route",
            "pass": bool((obj_mine - best) / max(abs(best), 1.0) <= 1e-3),
        })
    for r_ in rows:
        print(json.dumps(r_))
    return rows


def run_structured(record=False):
    """TV denoising / MPC / portfolio against stored expected optima."""
    from pogs_tpu import Function, FunctionVector
    from pogs_tpu.api.graph import solve_graph_form
    from pogs_tpu.api.cone import solve_cone_problem

    rows = []
    got = {}

    # TV denoising (graph form).
    p = problems.tv_denoising(n=500)
    sz = p["y"].shape[0]
    h = np.r_[np.full(sz, int(Function.SQUARE)), np.full(sz - 1, int(Function.ABS))]
    f = FunctionVector(h, b=np.r_[p["y"], np.zeros(sz - 1)],
                       c=np.r_[np.ones(sz), np.full(sz - 1, p["lam"])],
                       dtype=np.float64)
    g = FunctionVector(Function.ZERO, sz, dtype=np.float64)
    t0 = time.perf_counter()
    r = solve_graph_form(p["A"], f, g, abs_tol=1e-6, rel_tol=1e-6,
                         dtype=np.float64, gap_stop=False, max_iter=20000)
    got["tv_denoising"] = (float(r["optval"]), r["iterations"],
                           (time.perf_counter() - t0) * 1e3, int(r["status"]))

    # MPC QP and portfolio (cone form).
    for name in ("mpc_qp", "portfolio"):
        p = getattr(problems, name)()
        t0 = time.perf_counter()
        r = solve_cone_problem(p["c"], p["A"], p["b"], p["dims"],
                               P=p.get("P"), abs_tol=1e-6, rel_tol=1e-6,
                               dtype=np.float64, max_iter=40000)
        got[name] = (float(r["optval"]), r["num_iters"],
                     (time.perf_counter() - t0) * 1e3, int(r["status"]))

    if record:
        with open(EXPECTED_PATH, "w") as fh:
            json.dump({k: v[0] for k, v in got.items()}, fh, indent=2)
    expected = {}
    if os.path.exists(EXPECTED_PATH):
        with open(EXPECTED_PATH) as fh:
            expected = json.load(fh)
    for name, (optval, iters, ms, status) in got.items():
        exp = expected.get(name)
        err = (abs(optval - exp) / max(abs(exp), 1.0)) if exp is not None else None
        rows.append({
            "suite": "structured_regression", "problem": name,
            "objective": round(optval, 9),
            "expected": exp,
            "rel_err": round(err, 9) if err is not None else None,
            "iterations": iters, "ms": round(ms, 2),
            "pass": bool(status == 0 and (err is None or err <= 1e-4)),
        })
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--record", action="store_true",
                    help="refresh regression_expected.json from this run")
    ap.add_argument("--no-m-size", action="store_true",
                    help="skip the n=1000 CVXQP1_M instance (slow on CPU)")
    args = ap.parse_args()
    from pogs_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()

    rows = (run_maros()
            + run_midsize(include_m_size=not args.no_m_size)
            + run_real_datasets() + run_structured(args.record)
            + run_libsvm_scale())
    width = max(len(str(r.get("problem"))) for r in rows)
    for r in rows:
        tag = "PASS" if r["pass"] else "FAIL"
        extra = (f"rel_err {r['rel_err']:.2e}" if r.get("rel_err") is not None
                 else f"obj_gap {r.get('obj_rel_gap', 0):.2e}")
        print(f"[{tag}] {r['suite']:22s} {str(r['problem']):{width}s} "
              f"{extra}  {r['ms']:.1f} ms")
    n_fail = sum(not r["pass"] for r in rows)
    merge_results("real_data", rows)
    print(f"\n{len(rows) - n_fail}/{len(rows)} passed; "
          f"rows merged into benchmarks/results.json")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
