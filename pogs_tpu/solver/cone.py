"""Cone-form solver front end.

Counterpart of PogsCone (src/cpu/pogs.cpp:1905-1976):

    minimize    c'x (+ 1/2 x'Px)
    subject to  b − A x ∈ K_y,   x ∈ K_x

Dispatch mirrors the reference: K_x empty → HSDE Douglas–Rachford
(pogs.cpp:1946-1971); K_x non-empty → graph-form ADMM with the cone
objective (PogsObjectiveCone, pogs.cpp:642-785), whose prox is a linear
x-step followed by cone projections, run in exact-tolerance mode.
Quadratic objectives with K_x constraints are rejected (pogs.cpp:1941-1944).

Equilibration uses the cone-averaging hooks: scalings are uniform within
each non-separable cone (pogs.cpp:758-782).
"""

from __future__ import annotations

import time
import warnings
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from pogs_tpu.types import (
    Cone, ConeConstraint, DEFAULT_RHO, SolverResult, SolverSettings, Status,
)
from pogs_tpu.cones.sets import ConeSet
from pogs_tpu.linalg.equil import equilibrate
from pogs_tpu.linalg.matrix import apply_sparse_policy, as_matrix_op
from pogs_tpu.linalg.norm import norm2_est
from pogs_tpu.projector.direct import DirectProjector
from pogs_tpu.projector.indirect import CglsProjector
from pogs_tpu.solver.admm import admm_loop, postsolve_verify
from pogs_tpu.solver.hsde import hsde_solve
from pogs_tpu.utils.precision import highest_precision

_PRECISION = jax.lax.Precision.HIGHEST
_CONE_INIT_CACHE: dict = {}
_CONE_SOLVE_CACHE: dict = {}

# Staged QP solve (see _solve_qp_as_socp): HSDE segment length between
# PDAS-polish attempts, and the largest n for which the host-side
# Newton/LU polish is cheap enough to attempt mid-solve.  One fixed
# segment size means ONE extra compiled loop variant regardless of how
# many segments run.
K_QP_SEGMENT_ITERS = 500
# Raised from 2000 in round 4: with bound-row elimination the dense-P
# PDAS KKT stays within _MAX_KKT_DIM well past n=2000, and the staged
# path is now only the FALLBACK behind the host IPM (qp_ipm.py), so the
# cap guards pathological cases rather than the common route.
K_QP_STAGED_N_MAX = 4000


def _cone_key(cones: Sequence[ConeConstraint]):
    return tuple((int(c.cone), c.indices) for c in cones)


class ConeSolver:
    """Reusable cone-form solver for a fixed matrix A and cone structure."""

    def __init__(
        self,
        A,
        Kx: Sequence[ConeConstraint] = (),
        Ky: Sequence[ConeConstraint] = (),
        settings: Optional[SolverSettings] = None,
        strategy: Optional[str] = None,
        projector: str = "direct",
        dtype=None,
        assume_svec: bool = False,
        qp_via: str = "socp",
        sparse_policy: str = "auto",
    ):
        if qp_via not in ("admm", "socp"):
            raise ValueError(f"unknown qp_via {qp_via!r}")
        self.qp_via = qp_via
        if dtype is None:
            in_dtype = getattr(A, "dtype", None) or jnp.float32
            dtype = jnp.result_type(in_dtype, jnp.float32)
        A = apply_sparse_policy(A, sparse_policy)
        self._A_raw = A
        Aop = as_matrix_op(A, dtype)
        self.m, self.n = Aop.shape
        self.Kx = ConeSet(list(Kx), self.n)
        self.Ky = ConeSet(list(Ky), self.m)
        # svec transform: conjugate SDP coordinates by the √2 off-diagonal
        # weights so all cone projections are true Euclidean projections.
        self._row_scale = self.Ky.svec_scale()
        self._col_scale = self.Kx.svec_scale()
        # assume_svec: caller's data is already in svec (sqrt-2) convention
        # (e.g. CVXPY/SCS conic data) - skip the internal transform.
        self._needs_svec = (self.Ky.has_sdp or self.Kx.has_sdp) and not assume_svec
        if self._needs_svec:
            Aop = Aop.scale(
                jnp.asarray(self._row_scale, dtype),
                jnp.asarray(1.0 / self._col_scale, dtype),
            )
        self.A = Aop
        self.dtype = Aop.dtype
        base = settings or SolverSettings()
        # Cone problems run the graph loop in exact-tolerance mode
        # (PogsObjectiveCone::UseExactTol, pogs.cpp:784).
        self.settings = base.replace(use_exact_tol=True)
        self.use_hsde = self.Kx.is_empty
        if self.A.is_sparse and projector == "direct":
            projector = "cgls"  # sparse pairs with CGLS (pogs.cpp:1979-2010)
        self.projector = projector
        if strategy is None:
            # Reference selection (pogs.cpp:1510-1614): SMW through the
            # graph projector for dense LPs; direct normal-equations
            # Cholesky for small embeddings (kDirectLimit = 2000); Jacobi-
            # preconditioned CG otherwise.
            if self.A.is_sparse:
                strategy = "cg"  # matrix-free; 'direct' would densify Q
            elif projector == "direct":
                strategy = "smw"
            elif self.n + self.m + 1 <= 2000:
                strategy = "direct"
            else:
                strategy = "cg"
        self.strategy = strategy
        self._init_state = None
        self.rho = float(base.rho)

    # -- one-time init: equilibrate with cone hooks + factor ----------------

    def init(self):
        if self._init_state is not None:
            return self
        key = (
            (self.m, self.n), str(self.dtype), _cone_key(self.Kx.constraints),
            _cone_key(self.Ky.constraints), self.projector,
        )
        fn = _CONE_INIT_CACHE.get(key)
        if fn is None:
            Kx, Ky = self.Kx, self.Ky
            proj = (DirectProjector() if self.projector == "direct"
                    else CglsProjector())

            def init_fn(A):
                eq = equilibrate(
                    A,
                    constrain_d=Ky.constrain_average,
                    constrain_e=Kx.constrain_average,
                )
                norm_A = norm2_est(eq.A)
                factor = proj.init(eq.A, s=1.0)
                return {"A": eq.A, "d": eq.d, "e": eq.e,
                        "norm_A": norm_A, "factor": factor}

            fn = jax.jit(highest_precision(init_fn))
            _CONE_INIT_CACHE[key] = fn
        self._init_state = fn(self.A)
        return self

    # -- solve ---------------------------------------------------------------

    def solve(self, b, c, P=None, settings: Optional[SolverSettings] = None,
              warm_start: bool = False, _no_sync: bool = False):
        settings = (settings.replace(use_exact_tol=True)
                    if settings is not None else self.settings)
        if (self.dtype == jnp.float32
                and min(settings.abs_tol, settings.rel_tol) < 1e-5):
            warnings.warn(
                "tolerances below 1e-5 sit at the float32 accuracy floor "
                "(solves may report MAX_ITER at the optimum); use "
                "dtype='float64' with jax.config.update('jax_enable_x64', "
                "True) for tighter accuracy",
                stacklevel=2,
            )
        # rho is a *traced* argument (self.rho), never compile-time state;
        # normalize it out of the settings so data-dependent auto-rho values
        # don't fragment the compile cache (a cache miss costs a ~1 s
        # recompile per solve).
        if settings.rho != DEFAULT_RHO:
            self.rho = float(settings.rho)
            settings = settings.replace(rho=DEFAULT_RHO)
        if P is not None:
            P = np.asarray(P)
            if P.ndim == 1:
                # Diagonal Hessian (separable quadratic): the epigraph
                # factor is ONE sparse row per positive entry — no
                # O(n^3) eigh, so this scales to n ~ 10^5.
                if P.shape != (self.n,):
                    raise ValueError(
                        f"diagonal P must have length {self.n}")
                if np.any(P < 0):
                    raise ValueError("diagonal P must be nonnegative")
            elif P.shape != (self.n, self.n):
                raise ValueError(
                    f"P must be {self.n}x{self.n} or a length-{self.n} "
                    "diagonal")
            if not self.use_hsde:
                raise ValueError(
                    "quadratic objectives with K_x constraints are not supported"
                )
            # The naive HSDE embedding with P in Q does not have the QP
            # optimum as a fixed point (the reference documents this and
            # merely warns, pogs.cpp:1511-1513 / pogs_cvxpy.py:160-173).
            # We solve QPs correctly instead.  Default: epigraph +
            # rotated-SOC reformulation through the conic HSDE path —
            # measured the far stronger seed on ill-conditioned QPs
            # (CVXQP1_M: HSDE 300-iteration seed polishes to 1e-11;
            # graph-ADMM stalls at O(1) residuals, and the native
            # runtime's independent implementation of the same
            # graph-form split stalls identically, so it is the split
            # that is weak there, not an implementation).
            # qp_via="admm" selects that graph-form cone ADMM with a
            # quadratic x-prox — the reference's PogsObjectiveCone
            # x-step (pogs.cpp:687-712) with the ρ-shift applied through
            # a ONE-TIME eigendecomposition of the scaled P
            # ((P+ρI)⁻¹v = V·(Vᵀv)/(λ+ρ); adaptive ρ never refactors) —
            # cheaper per iteration and a good fit for small or
            # well-conditioned QPs.
            if self.qp_via == "admm":
                return self._solve_qp_admm(b, c, P, settings, _no_sync)
            return self._solve_qp_as_socp(b, c, P, settings, _no_sync,
                                          warm_start=warm_start)
        self.init()

        has_warm = bool(warm_start and self.use_hsde
                        and getattr(self, "_u", None) is not None)
        key = (
            (self.m, self.n), str(self.dtype), _cone_key(self.Kx.constraints),
            _cone_key(self.Ky.constraints), settings, self.use_hsde,
            self.strategy, self.projector, P is not None, has_warm,
        )
        fn = _CONE_SOLVE_CACHE.get(key)
        if fn is None:
            fn = jax.jit(highest_precision(
                self._build_solve(settings, P is not None, has_warm)
            ))
            _CONE_SOLVE_CACHE[key] = fn

        npdt = np.dtype(str(self.dtype))
        b = np.asarray(b, npdt)
        c = np.asarray(c, npdt)
        if self._needs_svec:
            b = b * self._row_scale.astype(npdt)
            c = c / self._col_scale.astype(npdt)
        t0 = time.perf_counter()
        u0 = self._u if has_warm else np.zeros((1,), np.float32)
        out = fn(self._init_state, b, c,
                 P if P is not None else np.zeros((0, 0), np.float32),
                 float(self.rho), u0)
        if self.use_hsde and "u" in out:
            # HSDE warm start for the next solve (receding-horizon pattern;
            # the reference has no cone-path warm start).
            self._u = out["u"]
        if self._needs_svec:
            rs = jnp.asarray(self._row_scale, self.dtype)
            cs = jnp.asarray(self._col_scale, self.dtype)
            out = dict(out)
            out["x"] = out["x"] / cs
            out["y"] = out["y"] / rs
            out["mu"] = out["mu"] * cs
            out["nu"] = out["nu"] * rs
        if _no_sync:
            return out
        status = Status(int(out["status"]))
        solve_time = time.perf_counter() - t0
        return SolverResult(
            x=out["x"], y=out["y"], mu=out["mu"], nu=out["nu"],
            optval=out["optval"], final_iter=out["final_iter"], status=status,
            nrm_r=out.get("r_pri"), nrm_s=out.get("r_dua"), gap=out.get("gap"),
            solve_time=solve_time,
        )

    # -- QP → SOCP reformulation ----------------------------------------------

    def _solve_qp_as_socp(self, b, c, P, settings, _no_sync,
                          warm_start=False):
        """min c'x + ½x'Px s.t. b−Ax ∈ K_y  ⇒  epigraph variable t with
        ½x'Px ≤ t as a rotated second-order cone:

            (t+1, t−1, √2 L'x) ∈ SOC,   P = L L'  (eigh-based square root)

        then minimize c'x + t through the (correct) conic HSDE path."""
        n, m = self.n, self.m
        npdt = np.dtype(str(self.dtype))
        # Host IPM fast path (round-4): for polyhedral K_y a Mehrotra
        # predictor-corrector with a sparse/structured KKT factorization
        # (solver/qp_ipm.py) reaches ~1e-12 relative KKT residuals in
        # O(20) Newton steps — 10-30x faster than seeding the epigraph-SOC
        # HSDE with O(10^2-10^3) DR iterations on mid-size instances
        # (CVXQP1_M: 22 s staged -> ~1.2 s).  Acceptance is certified: the
        # point is returned only when its full KKT residuals (the same
        # qp_polish.kkt_residuals the staged path certifies with) meet
        # tolerance; any failure falls through to the splitting path,
        # which owns infeasibility/unboundedness certificates.
        if settings.polish and not _no_sync:
            res_ipm = self._try_qp_ipm(P, b, c, settings)
            if res_ipm is not None:
                return res_ipm
        P = np.asarray(P, np.float64)
        diag_p = P.ndim == 1
        if diag_p:
            w = P
            keep_idx = np.flatnonzero(
                w > max(1e-12, 1e-10 * max(float(w.max(initial=0.0)), 1.0)))
            sqw = np.sqrt(w[keep_idx])
            r = keep_idx.size
            Lt = None  # rows sqrt(w_i) e_i', materialized per branch below
            lt_key = (b"diag", sqw.tobytes(), keep_idx.tobytes())
        else:
            w, V = np.linalg.eigh((P + P.T) / 2)
            keep = w > max(1e-12, 1e-10 * max(w.max(), 1.0))
            Lt = (np.sqrt(w[keep])[:, None] * V[:, keep].T)  # P = Lt'Lt
            r = Lt.shape[0]
            lt_key = Lt.tobytes()

        # Extended variable (x, t); extended rows: original m + SOC(r+2).
        if self.A.is_sparse:
            # Sparse A + dense P (the reference supports this pairing via
            # PogsConeQD over MatrixSparse, pogs_c.cpp:208-305): keep the
            # extension sparse so the CGLS projector stays O(nnz).
            import scipy.sparse as sp_mod

            Araw = self._A_raw
            if hasattr(Araw, "tocsr"):
                A_csr = Araw.tocsr().astype(np.float64)
            else:  # jax BCOO
                ij = np.asarray(Araw.indices)
                A_csr = sp_mod.coo_matrix(
                    (np.asarray(Araw.data, np.float64), (ij[:, 0], ij[:, 1])),
                    shape=(m, n),
                ).tocsr()
            t_rows = sp_mod.csr_matrix(
                (np.array([-1.0, -1.0]),
                 (np.array([0, 1]), np.array([n, n]))),
                shape=(2, n + 1),
            )
            if diag_p:
                Lt_sp = sp_mod.csr_matrix(
                    (-np.sqrt(2.0) * sqw, (np.arange(r), keep_idx)),
                    shape=(r, n))
            else:
                Lt_sp = sp_mod.csr_matrix(-np.sqrt(2.0) * Lt)
            A_ext = sp_mod.vstack([
                sp_mod.hstack([A_csr, sp_mod.csr_matrix((m, 1))]),
                t_rows,
                sp_mod.hstack([Lt_sp, sp_mod.csr_matrix((r, 1))]),
            ]).tocsr().astype(npdt)
        else:
            A_np = np.asarray(self._A_raw, np.float64)
            A_ext = np.zeros((m + r + 2, n + 1))
            A_ext[:m, :n] = A_np
            A_ext[m, n] = -1.0       # s0 = 1 + t
            A_ext[m + 1, n] = -1.0   # s1 = -1 + t
            if diag_p:
                A_ext[m + 2 + np.arange(r), keep_idx] = -np.sqrt(2.0) * sqw
            else:
                A_ext[m + 2:, :n] = -np.sqrt(2.0) * Lt
            A_ext = A_ext.astype(npdt)
        b_ext = np.concatenate([np.asarray(b, np.float64),
                                [1.0, -1.0], np.zeros(r)])
        c_ext = np.concatenate([np.asarray(c, np.float64), [1.0]])
        Ky_ext = list(self.Ky.constraints) + [
            ConeConstraint(Cone.SOC, range(m, m + r + 2))
        ]
        sub_key = (A_ext.shape, lt_key, _cone_key(self.Ky.constraints))
        sub = getattr(self, "_qp_sub", None)
        if sub is None or getattr(self, "_qp_sub_key", None) != sub_key:
            sub = ConeSolver(
                A_ext, Ky=Ky_ext, settings=settings,
                strategy=self.strategy, projector=self.projector,
                dtype=self.dtype,
            )
            self._qp_sub = sub
            self._qp_sub_key = sub_key
        # Thread the warm start through to the extended solver: the
        # epigraph variable/cone structure is identical across re-solves
        # with perturbed (b, c, P-diagonal), which is the receding-horizon
        # QP pattern (MPC) the cone warm start exists for.
        #
        # Staged solve with inter-segment polish: the DR tail on the
        # epigraph SOC is linear and can take O(10^4) iterations even on
        # tiny QPs, while the PDAS polish certifies the optimum from a
        # few-hundred-iteration seed (CVXQP family, qp_polish.py).  For
        # polyhedral K_y we therefore run the HSDE in fixed-size segments
        # (one compiled variant, warm-start continuation) and attempt the
        # host-side polish after each: the solve exits as soon as the
        # active set is identified instead of burning max_iter DR
        # iterations.  A failed attempt costs one small-LU Newton pass.
        from pogs_tpu.solver.qp_polish import row_kinds

        b_run = b_ext.astype(npdt)
        c_run = c_ext.astype(npdt)
        staged = (
            settings.polish and not _no_sync
            and settings.max_iter > K_QP_SEGMENT_ITERS
            # A diagonal P polishes at any n (bound-row elimination + a
            # small Schur complement, qp_polish.py); a dense P needs its
            # KKT LU to fit.
            and (diag_p or n <= K_QP_STAGED_N_MAX)
            and row_kinds(m, self.Ky.constraints) is not None
        )
        if not staged:
            res = sub.solve(b_run, c_run, settings=settings,
                            _no_sync=_no_sync, warm_start=warm_start)
            if _no_sync:
                return res
            total_iter = res.final_iter
            polished = None
        else:
            import dataclasses as _dc

            seg_settings = _dc.replace(settings,
                                       max_iter=K_QP_SEGMENT_ITERS)
            total_iter = 0
            ws = warm_start
            polished = None
            while True:
                res = sub.solve(b_run, c_run, settings=seg_settings,
                                warm_start=ws)
                ws = True
                total_iter += int(res.final_iter)
                if res.status != Status.MAX_ITER \
                        or total_iter >= settings.max_iter:
                    break
                x_t, y_t, nu_t, st_t, nr_t, ns_t = self._polish_qp(
                    P, b, c, res.x[:n], res.y[:m], res.nu[:m],
                    res.status, res.nrm_r, res.nrm_s, settings)
                if st_t == Status.SUCCESS:
                    polished = (x_t, y_t, nu_t, st_t, nr_t, ns_t)
                    break
        if polished is not None:
            x, y, nu, status, final_nrm_r, final_nrm_s = polished
        else:
            x, y, nu, status, final_nrm_r, final_nrm_s = self._polish_qp(
                P, b, c, res.x[:n], res.y[:m], res.nu[:m],
                res.status, res.nrm_r, res.nrm_s, settings)
        Px = (jnp.asarray(P, self.dtype) * x if diag_p
              else jnp.asarray(P, self.dtype) @ x)
        optval = jnp.vdot(jnp.asarray(c, self.dtype), x) + 0.5 * jnp.vdot(
            x, Px
        )
        return SolverResult(
            x=x, y=y, mu=res.mu[:n], nu=nu,
            optval=optval, final_iter=total_iter, status=status,
            nrm_r=final_nrm_r, nrm_s=final_nrm_s, gap=res.gap,
            solve_time=res.solve_time,
        )

    def _try_qp_ipm(self, P, b, c, settings):
        """Attempt the host IPM on a polyhedral QP; None on any miss.

        Only certified successes return: the IPM point must pass the
        relative KKT residual test at the solve tolerance (stationarity,
        primal, dual sign, complementarity — qp_polish.kkt_residuals).
        """
        import time as _time

        from pogs_tpu.solver.qp_ipm import ipm_solve
        from pogs_tpu.solver.qp_polish import kkt_residuals, row_kinds

        kind = row_kinds(self.m, self.Ky.constraints)
        if kind is None:
            return None
        t0 = _time.perf_counter()
        P64 = np.asarray(P, np.float64) if not hasattr(P, "tocsr") else P
        c64 = np.asarray(c, np.float64)
        b64 = np.asarray(b, np.float64)
        A_raw = self._A_raw
        A_host = (A_raw if hasattr(A_raw, "toarray")
                  else np.asarray(A_raw, np.float64))
        tol = float(max(settings.abs_tol, settings.rel_tol))
        out = ipm_solve(P64, c64, A_host, b64, kind,
                        tol=min(1e-9, tol), max_iter=50)
        if out is None:
            return None
        res = kkt_residuals(P64, c64, A_host, b64, kind,
                            out["x"], out["lam"])
        x64, lam64 = out["x"], out["lam"]
        score = max(res.values())
        # Complementarity snap: the IPM stops at mu-level pairwise
        # products (~1e-8 relative); a short PDAS pass from its
        # (near-exact) active set recovers exact complementarity at the
        # cost of one or two small KKT solves.  Best-iterate acceptance
        # means this can only improve the point.
        from pogs_tpu.solver.qp_polish import active_set_polish

        pol = active_set_polish(P64, c64, A_host, b64, kind, x64, lam64,
                                tol, max_pdas=3)
        if pol is not None and pol["score"] < score:
            x64, lam64, res, score = (pol["x"], pol["lam"], pol["res"],
                                      pol["score"])
        if score > tol:
            return None
        Px64 = P64 * x64 if getattr(P64, "ndim", 2) == 1 else P64 @ x64
        optval = jnp.asarray(float(c64 @ x64 + 0.5 * (x64 @ Px64)),
                             self.dtype)
        x = jnp.asarray(x64, self.dtype)
        return SolverResult(
            x=x,
            y=jnp.asarray(A_host @ x64, self.dtype),
            mu=jnp.zeros(self.n, self.dtype),
            nu=jnp.asarray(lam64, self.dtype),
            optval=optval,
            final_iter=int(out["iters"]),
            status=Status.SUCCESS,
            nrm_r=jnp.asarray(res["pri"], self.dtype),
            nrm_s=jnp.asarray(res["stat"], self.dtype),
            gap=jnp.asarray(res["comp"], self.dtype),
            solve_time=_time.perf_counter() - t0,
        )

    def _polish_qp(self, P, b, c, x, y, nu, status, nrm_r, nrm_s, settings):
        """Active-set KKT polish (qp_polish.py): one direct f64 PDAS pass
        on the detected active rows lifts ADMM-accuracy iterates to
        ~machine precision, and rescues MAX_ITER exits whose active set
        is already identified (ill-conditioned CVXQP-class problems).
        Rejected polishes leave the iterate untouched."""
        if not (settings.polish
                and status in (Status.SUCCESS, Status.MAX_ITER)):
            return x, y, nu, status, nrm_r, nrm_s
        # A 1-D (diagonal) P passes through unchanged: the polish solves
        # its KKT systems via bound-row elimination + a small Schur
        # complement, never forming an (n, n) object.
        P = np.asarray(P, np.float64)
        from pogs_tpu.solver.qp_polish import active_set_polish, row_kinds

        kind = row_kinds(self.m, self.Ky.constraints)
        if kind is None:
            return x, y, nu, status, nrm_r, nrm_s
        A_raw = self._A_raw
        A_host = (A_raw if hasattr(A_raw, "toarray")
                  else np.asarray(A_raw, np.float64))
        tol = float(max(settings.abs_tol, settings.rel_tol))
        pol = active_set_polish(
            P, np.asarray(c, np.float64), A_host, np.asarray(b, np.float64),
            kind, np.asarray(x, np.float64), np.asarray(nu, np.float64), tol,
        )
        if pol is None:
            return x, y, nu, status, nrm_r, nrm_s
        return (
            jnp.asarray(pol["x"], self.dtype),
            jnp.asarray(A_host @ pol["x"], self.dtype),
            jnp.asarray(pol["lam"], self.dtype),
            Status.SUCCESS,
            jnp.asarray(pol["res"]["pri"], self.dtype),
            jnp.asarray(pol["res"]["stat"], self.dtype),
        )

    # -- QP → graph-form cone ADMM (quadratic x-prox) -------------------------

    def _solve_qp_admm(self, b, c, P, settings, _no_sync):
        """min cᵀx + ½xᵀPx s.t. b − Ax ∈ K_y via graph-form cone ADMM.

        x-prox: (P_s + ρI)⁻¹(ρv − c_s) through a one-time eigh of the
        equilibrated P_s = E·P·E, so the adaptive-ρ shift is a diagonal
        divide between two matrix products (no refactorization — contrast
        the reference's per-ρ-change Cholesky refactor, pogs.cpp:694-703).
        y-prox: cone projection of b_s − y (pogs.cpp:714-721).  Much
        cheaper per iteration than the epigraph-SOC HSDE route (no
        extended system, no inner CG), and the PDAS polish finishes the
        job for polyhedral cones."""
        if self._needs_svec:
            # SDP cones under the internal svec transform would conjugate
            # P too; the SOCP route handles that pairing already.
            return self._solve_qp_as_socp(b, c, P, settings, _no_sync)
        n, m = self.n, self.m
        self.init()
        npdt = np.dtype(str(self.dtype))
        P64 = np.asarray(P, np.float64)
        diag_mode = P64.ndim == 1
        e_host = np.asarray(self._init_state["e"], np.float64)
        if diag_mode:
            # Diagonal Hessian: the eigenbasis IS the coordinate basis, so
            # the x-prox is one elementwise divide — no eigh, no (n, n)
            # anything.  This is the scalable route for big separable QPs
            # (the epigraph-SOC route drags a 2(n)-row extension through
            # CGLS there).
            lam_eig = np.maximum(P64, 0.0) * e_host * e_host
            V = np.zeros((0, 0), npdt)
        else:
            P64 = (P64 + P64.T) / 2
            eig_key = (hash(P64.tobytes()), hash(e_host.tobytes()))
            cached = getattr(self, "_qp_eig", None)
            if cached is None or cached[0] != eig_key:
                P_s = P64 * e_host[:, None] * e_host[None, :]
                lam_eig, V = np.linalg.eigh(P_s)
                lam_eig = np.maximum(lam_eig, 0.0)  # PSD clamp
                cached = (eig_key, V.astype(npdt), lam_eig)
                self._qp_eig = cached
            _, V, lam_eig = cached
        # Objective normalization — the QP analogue of the LP path's
        # ‖c‖→1 (pogs.cpp:738-755): divide the WHOLE objective (c and P
        # together, so the argmin is untouched) by σ = max(λmax(P_s),
        # ‖c_s‖).  Without it λmax(P_s) ~ 1e6 dwarfs the unit-scale
        # constraints and the ρ≈1 ADMM stalls with primal residuals O(1).
        c_s_norm = float(np.linalg.norm(np.asarray(c, np.float64) * e_host))
        sigma = max(float(lam_eig.max(initial=0.0)), c_s_norm, 1e-12)
        lam_hat = (lam_eig / sigma).astype(npdt)

        key = ((m, n), str(self.dtype), _cone_key(self.Ky.constraints),
               settings, self.projector, "qp_admm", diag_mode)
        fn = _CONE_SOLVE_CACHE.get(key)
        if fn is None:
            fn = jax.jit(highest_precision(
                self._build_qp_admm_solve(settings, diag_mode)))
            _CONE_SOLVE_CACHE[key] = fn
        b_in = np.asarray(b, npdt)
        c_in = np.asarray(c, npdt)
        t0 = time.perf_counter()
        out = fn(self._init_state, b_in, c_in, V, lam_hat, float(sigma),
                 float(self.rho))
        if _no_sync:
            return out
        status = Status(int(out["status"]))
        x, y, nu = out["x"], out["y"], out["nu"]
        x, y, nu, status, final_nrm_r, final_nrm_s = self._polish_qp(
            P64, b_in, c_in, x, y, nu, status, out["r_pri"], out["r_dua"],
            settings)
        Px = (jnp.asarray(P64, self.dtype) * x if diag_mode
              else jnp.asarray(P64, self.dtype) @ x)
        optval = jnp.vdot(jnp.asarray(c_in, self.dtype), x) + 0.5 * jnp.vdot(
            x, Px)
        solve_time = time.perf_counter() - t0
        return SolverResult(
            x=x, y=y, mu=out["mu"], nu=nu,
            optval=optval, final_iter=out["final_iter"], status=status,
            nrm_r=final_nrm_r, nrm_s=final_nrm_s, gap=out["gap"],
            solve_time=solve_time,
        )

    def _build_qp_admm_solve(self, settings: SolverSettings,
                             diag_mode: bool = False):
        m, n = self.m, self.n
        Ky = self.Ky
        dt = self.dtype
        proj = (DirectProjector() if self.projector == "direct"
                else CglsProjector(max_iter=settings.cgls_max_iter))

        def solve(init_state, b_orig, c_orig, V, lam_hat, sigma, rho0):
            A = init_state["A"]
            d = init_state["d"]
            e = init_state["e"]
            sig = jnp.asarray(sigma, dt)
            b_s = jnp.asarray(b_orig, dt) * d
            c_s = jnp.asarray(c_orig, dt) * e / sig  # normalized objective
            Vj = jnp.asarray(V, dt)
            lamj = jnp.asarray(lam_hat, dt)

            def prox_fn(x_in, y_in, rho):
                if diag_mode:  # P_s is diagonal: the prox is elementwise
                    x12 = (rho * x_in - c_s) / (lamj + rho)
                else:
                    w = jnp.matmul(Vj.T, rho * x_in - c_s,
                                   precision=_PRECISION)
                    x12 = jnp.matmul(Vj, w / (lamj + rho),
                                     precision=_PRECISION)
                y12 = b_s - Ky.project(b_s - y_in)
                return x12, y12

            def eval_fn(x12, y12):
                # cᵀx + ½xᵀP_s x without materializing P_s: P_s = VΛVᵀ.
                w = (x12 if diag_mode
                     else jnp.matmul(Vj.T, x12, precision=_PRECISION))
                return jnp.vdot(c_s, x12) + 0.5 * jnp.vdot(w, lamj * w)

            factor = init_state["factor"]

            def project_fn(px, py, tol, x_warm):
                return proj.project(A, factor, px, py, tol, x_warm)

            z0 = jnp.zeros((m + n,), dt)
            out = admm_loop(
                A, init_state["norm_A"], d, e, prox_fn, eval_fn, project_fn,
                settings, z0, z0, jnp.asarray(rho0, dt),
            )
            out["status"] = postsolve_verify(
                A, d, e, out["x12"], out["y12"], out["status"],
                settings.abs_tol, settings.rel_tol,
            )
            # Undo the objective normalization: optval and the duals of
            # the σ-scaled objective are σ× the original's.
            return {
                "x": out["x12"] * e, "y": out["y12"] / d,
                "mu": out["mu_scaled"] / e * sig,
                "nu": out["nu_scaled"] * d * sig,
                "optval": out["optval"] * sig,
                "final_iter": out["final_iter"],
                "status": out["status"], "r_pri": out["nrm_r"],
                "r_dua": out["nrm_s"], "gap": out["gap"],
            }

        return solve

    # -- jitted solve builders -------------------------------------------------

    def _build_solve(self, settings: SolverSettings, has_P: bool,
                     has_warm: bool = False):
        m, n = self.m, self.n
        Kx, Ky = self.Kx, self.Ky
        strategy = self.strategy
        use_hsde = self.use_hsde
        dt = self.dtype
        proj = (DirectProjector() if self.projector == "direct"
                else CglsProjector(max_iter=settings.cgls_max_iter))

        def solve(init_state, b_orig, c_orig, P_orig, rho0, u0):
            A = init_state["A"]
            d = init_state["d"]
            e = init_state["e"]
            b_orig = jnp.asarray(b_orig, dt)
            c_orig = jnp.asarray(c_orig, dt)
            # Scale by the equilibration (pogs.cpp:1463-1475, 723-726).
            b_s = b_orig * d
            c_s = c_orig * e
            P_s = None
            if has_P:
                P_o = jnp.asarray(P_orig, dt)
                P_s = P_o * e[:, None] * e[None, :]

            if use_hsde:
                smw_factor = None
                if strategy == "smw" and not has_P and self.projector == "direct":
                    # Reuse the cached Gram inverse from init.  Tall case:
                    # the factor IS (I + AᵀA)⁻¹.  Wide case: the factor is
                    # the m×m (I + AAᵀ)⁻¹ — apply the n×n inverse through
                    # Woodbury: (I+AᵀA)⁻¹v = v − Aᵀ(I+AAᵀ)⁻¹(A v).
                    Kinv = init_state["factor"]["op"]
                    if m >= n:
                        def apply_kinv(v):
                            return jnp.matmul(Kinv, v, precision=_PRECISION)
                    else:
                        def apply_kinv(v):
                            w = jnp.matmul(Kinv, A.mv(v), precision=_PRECISION)
                            return v - A.rmv(w)
                    rhs = c_s - A.rmv(b_s)
                    t_x = apply_kinv(rhs)
                    t_y = b_s + A.mv(t_x)
                    s_den = 1.0 + jnp.vdot(c_s, t_x) + jnp.vdot(b_s, t_y)
                    smw_factor = {"apply": apply_kinv, "t_x": t_x, "t_y": t_y,
                                  "s_den": s_den}
                out = hsde_solve(
                    A, b_s, c_s, Ky, P=P_s, strategy=strategy,
                    abs_tol=settings.abs_tol, rel_tol=settings.rel_tol,
                    max_iter=settings.max_iter, smw_factor=smw_factor,
                    use_anderson=settings.use_anderson,
                    anderson_mem=settings.anderson_mem,
                    anderson_start=settings.anderson_start,
                    u0=u0 if has_warm else None,
                    polish=settings.polish,
                )
                w = out["w"]
                tau = w[n + m]
                tau_ok = tau > 1e-8
                tau_safe = jnp.where(tau_ok, tau, 1.0)
                x_s = w[:n] / tau_safe
                y_s = w[n:n + m] / tau_safe
                s_scaled = b_s - A.mv(x_s)
                # Unscale (pogs.cpp:1841-1865).  When tau ~ 0, return the
                # (unscaled) certificate ray instead: consumers (e.g. the
                # CVXPY plugin) normalize by b'y or c'x themselves.
                x = jnp.where(tau_ok, x_s * e, w[:n] * e)
                s_orig = s_scaled / d
                y = jnp.where(tau_ok, b_orig - s_orig, jnp.zeros(m, dt))
                nu = jnp.where(tau_ok, y_s * d, w[n:n + m] * d)
                optval = jnp.vdot(c_orig, x)
                if has_P:
                    optval = optval + 0.5 * jnp.vdot(x, jnp.matmul(P_o, x))
                return {
                    "x": x, "y": y, "mu": jnp.zeros(n, dt), "nu": nu,
                    "optval": optval, "final_iter": out["final_iter"],
                    "status": out["status"], "r_pri": out["r_pri"],
                    "r_dua": out["r_dua"], "gap": out["gap"],
                    "u": out["u"],
                }

            # ---- graph-form cone path (Kx non-empty, P empty) --------------
            # Normalize c to unit norm, folding the scale into optval
            # (pogs.cpp:738-755).
            c_nrm = jnp.linalg.norm(c_s)
            c_scale = jnp.where(c_nrm > 0, 1.0 / jnp.maximum(c_nrm, 1e-30), 1.0)
            c_n = c_s * c_scale

            def prox_fn(x_in, y_in, rho):
                # Linear x-step + cone projections (pogs.cpp:687-721).
                x12 = Kx.project(x_in - c_n / rho)
                y12 = b_s - Ky.project(b_s - y_in)
                return x12, y12

            def eval_fn(x12, y12):
                return jnp.vdot(c_n, x12) / c_scale

            factor = init_state["factor"]

            def project_fn(px, py, tol, x_warm):
                return proj.project(A, factor, px, py, tol, x_warm)

            z0 = jnp.zeros((m + n,), dt)
            out = admm_loop(
                A, init_state["norm_A"], d, e, prox_fn, eval_fn, project_fn,
                settings, z0, z0, jnp.asarray(rho0, dt),
            )
            out["status"] = postsolve_verify(
                A, d, e, out["x12"], out["y12"], out["status"],
                settings.abs_tol, settings.rel_tol,
            )
            return {
                "x": out["x12"] * e, "y": out["y12"] / d,
                "mu": out["mu_scaled"] / e, "nu": out["nu_scaled"] * d,
                "optval": out["optval"], "final_iter": out["final_iter"],
                "status": out["status"], "r_pri": out["nrm_r"],
                "r_dua": out["nrm_s"], "gap": out["gap"],
            }

        return solve
