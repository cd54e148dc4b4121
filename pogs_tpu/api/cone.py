"""Cone-form problem API with SCS-style dims.

Counterpart of python/pogs_cone.py (solve_cone, :183+) and the dims→cone
mapping + auto-ρ heuristics of python/pogs_cvxpy.py:179-277.

    solve_cone_problem(c, A, b, dims)  solves
        minimize    c'x (+ ½ x'P x)
        subject to  b − A x ∈ K,   K given by dims:
            f: #equality rows (zero cone)      l: #inequality rows (R₊)
            q: list of SOC sizes               s: list of SDP block sizes
            ep/ed: #primal/dual exp cones

Unlike the reference, quadratic objectives are solved *correctly* (via an
automatic epigraph/SOC reformulation inside ConeSolver) instead of warned
about (pogs_cvxpy.py:160-173).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from pogs_tpu.types import Cone, ConeConstraint, SolverSettings, Status
from pogs_tpu.solver.cone import ConeSolver

# solve_cone_problem solver reuse (matrix-fingerprint keyed).
_CONE_PROBLEM_SOLVERS: dict = {}


def dims_to_cones(dims: dict) -> list:
    """SCS-style dims dict → list of ConeConstraint on the y rows
    (pogs_cvxpy.py:230-277). Order: f, l, q, s, ep, ed."""
    cones = []
    offset = 0
    nf = int(dims.get("f", 0) or 0)
    if nf > 0:
        cones.append(ConeConstraint(Cone.ZERO, range(offset, offset + nf)))
        offset += nf
    nl = int(dims.get("l", 0) or 0)
    if nl > 0:
        cones.append(ConeConstraint(Cone.NON_NEG, range(offset, offset + nl)))
        offset += nl
    for q_dim in dims.get("q") or []:
        cones.append(ConeConstraint(Cone.SOC, range(offset, offset + int(q_dim))))
        offset += int(q_dim)
    for s_dim in dims.get("s") or []:
        vec = int(s_dim) * (int(s_dim) + 1) // 2
        cones.append(ConeConstraint(Cone.SDP, range(offset, offset + vec)))
        offset += vec
    for _ in range(int(dims.get("ep", 0) or 0)):
        cones.append(ConeConstraint(Cone.EXP_PRIMAL, range(offset, offset + 3)))
        offset += 3
    for _ in range(int(dims.get("ed", 0) or 0)):
        cones.append(ConeConstraint(Cone.EXP_DUAL, range(offset, offset + 3)))
        offset += 3
    return cones


def auto_rho(A, b, c, dims: dict, P=None, mode: Optional[str] = None,
             scale: Optional[float] = None) -> float:
    """Auto-ρ heuristics (pogs_cvxpy.py:179-218): ‖c‖/‖b‖ clamped [1e-3,1e3],
    or ‖c‖/(‖b‖‖A‖_F) clamped [1e-4,10] for SOC/SDP/EXP/QP problems."""
    norm_c = float(np.linalg.norm(c))
    norm_b = float(np.linalg.norm(b))

    def _frob(M):
        if hasattr(M, "power"):  # scipy sparse
            return float(np.sqrt(M.power(2).sum()))
        if hasattr(M, "frob2"):
            return float(np.sqrt(M.frob2()))
        return float(np.linalg.norm(np.asarray(M)))
    has_nonsep = bool(dims.get("q")) or bool(dims.get("s")) \
        or int(dims.get("ep", 0) or 0) > 0 or int(dims.get("ed", 0) or 0) > 0
    if mode is None or mode == "auto":
        mode = "ratio_normA" if (has_nonsep or P is not None) else "ratio"
    if mode == "ratio_normA":
        norm_A = _frob(A)
        if norm_b > 1e-10 and norm_c > 1e-10 and norm_A > 1e-10:
            rho = min(max(norm_c / (norm_b * norm_A), 1e-4), 1e1)
        else:
            rho = 1.0
    elif mode == "ratio":
        if norm_b > 1e-10 and norm_c > 1e-10:
            rho = min(max(norm_c / norm_b, 1e-3), 1e3)
        else:
            rho = 1.0
    else:
        raise ValueError(f"unknown rho_mode {mode!r}")
    if scale not in (None, 1.0):
        rho *= scale
    return rho


def solve_cone(
    A,
    b,
    c,
    Kx: Sequence[ConeConstraint] = (),
    Ky: Sequence[ConeConstraint] = (),
    P=None,
    rho: Optional[float] = None,
    abs_tol: float = 1e-4,
    rel_tol: float = 1e-4,
    max_iter: int = 2500,
    verbose: int = 0,
    adaptive_rho: bool = True,
    dtype=None,
    strategy: Optional[str] = None,
    solver: Optional[ConeSolver] = None,
    assume_svec: bool = False,
    warm_start: bool = False,
    polish: bool = True,
    qp_via: str = "socp",
):
    """General cone-form solve; returns the reference result-dict contract."""
    settings = SolverSettings(
        abs_tol=abs_tol, rel_tol=rel_tol, max_iter=max_iter, verbose=verbose,
        adaptive_rho=adaptive_rho, rho=rho if rho is not None else 1.0,
        polish=polish,
    )
    if solver is None:
        solver = ConeSolver(A, Kx=Kx, Ky=Ky, settings=settings,
                            strategy=strategy, dtype=dtype,
                            assume_svec=assume_svec, qp_via=qp_via)
    if rho is not None:
        solver.rho = float(rho)
    t0 = time.perf_counter()
    res = solver.solve(b, c, P=P, settings=settings, warm_start=warm_start)
    # One bundled device-to-host transfer instead of one per array.
    import jax

    x_np, y_np, nu_np, optval, final_iter = jax.device_get(
        (res.x, res.y, res.nu, res.optval, res.final_iter)
    )
    solve_time = time.perf_counter() - t0

    out = {
        "x": np.asarray(x_np),
        "y": np.asarray(y_np),
        "l": np.asarray(nu_np),
        "z": np.asarray(nu_np),
        "optval": float(optval),
        "iterations": int(final_iter),
        "num_iters": int(final_iter),
        "status": int(res.status),
        "status_name": Status(int(res.status)).name,
        "solve_time": solve_time,
        "abs_tol": abs_tol,
        "rel_tol": rel_tol,
    }
    out["s"] = np.asarray(b) - out["y"]
    # Primal residual diagnostic (pogs_cvxpy.py:296-311).
    r = A @ out["x"] - out["y"] if hasattr(A, "dot") else np.asarray(A) @ out["x"] - out["y"]
    primal_res = float(np.linalg.norm(r))
    eps_pri = float(
        np.sqrt(len(out["y"])) * abs_tol
        + rel_tol * max(np.linalg.norm(out["x"]), np.linalg.norm(out["y"]))
    )
    out["primal_res"] = primal_res
    out["eps_pri"] = eps_pri
    if eps_pri > 0:
        out["primal_res_ratio"] = primal_res / eps_pri
    return out


def solve_cone_problem(
    c,
    A,
    b,
    dims: dict,
    P=None,
    rho: Optional[float] = None,
    rho_mode: Optional[str] = None,
    rho_scale: Optional[float] = None,
    abs_tol: float = 1e-4,
    rel_tol: float = 1e-4,
    max_iter: int = 2500,
    verbose: int = 0,
    dtype=None,
    **kw,
):
    """SCS-style entry point (pogs_cvxpy.py:76-356): c, A, b, dims."""
    if not hasattr(A, "tocoo"):  # keep scipy sparse as-is
        A = np.asarray(A)
    cones_y = dims_to_cones(dims)
    if rho is None:
        rho = auto_rho(A, b, c, dims, P=P, mode=rho_mode, scale=rho_scale)
    # Reuse the ConeSolver (equilibration + factorization + compiled solve)
    # across calls with the same matrix and cone structure — the warm-call
    # pattern of CVXPY resolves and parameter sweeps.
    solver = kw.pop("solver", None)
    if solver is None:
        import hashlib

        arr = A if isinstance(A, np.ndarray) else A.data
        h = hashlib.sha256()
        h.update(str(A.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
        key = (h.hexdigest(), tuple((int(cc.cone), cc.indices)
                                    for cc in cones_y),
               str(dtype), kw.get("assume_svec", False),
               kw.get("strategy"))
        cached = _CONE_PROBLEM_SOLVERS.get(key)
        if cached is None:
            if len(_CONE_PROBLEM_SOLVERS) > 8:
                _CONE_PROBLEM_SOLVERS.clear()
            settings = SolverSettings(abs_tol=abs_tol, rel_tol=rel_tol,
                                      max_iter=max_iter, verbose=verbose)
            cached = ConeSolver(A, Ky=cones_y, settings=settings,
                                strategy=kw.get("strategy"), dtype=dtype,
                                assume_svec=kw.get("assume_svec", False))
            _CONE_PROBLEM_SOLVERS[key] = cached
        solver = cached
    return solve_cone(
        A, b, c, Ky=cones_y, P=P, rho=rho, abs_tol=abs_tol, rel_tol=rel_tol,
        max_iter=max_iter, verbose=verbose, dtype=dtype, solver=solver, **kw,
    )
