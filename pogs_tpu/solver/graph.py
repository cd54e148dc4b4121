"""Graph-form solver front end: init (equilibrate + factor) and solve.

Counterpart of PogsSeparable (src/cpu/pogs.cpp:590-637) plus the
implementation plumbing of PogsImplementation (_Init at pogs.cpp:58-88,
warm-start handling at pogs.cpp:143-180, output unscaling at 509-518).

Compilation strategy: the expensive one-time work (Sinkhorn equilibration,
‖A‖₂ power method, Gram factorization) is one jitted ``init`` program per
(shape, dtype, projector); each solve is one jitted program per
(shape, dtype, h-pattern, settings) — both cached at module level so
repeated solves (λ-paths, benchmarks, CVXPY calls) never re-trace.
The solver instance keeps the factorization and final iterate across
``solve`` calls, giving the same implicit warm-start behavior that powers
the reference's LassoPath example (examples/cpp/lasso_path.cpp:90-106).
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from pogs_tpu.types import (
    DEFAULT_RHO,
    FunctionVector,
    SolverResult,
    SolverSettings,
    Status,
)
from pogs_tpu.prox.vector import prox_eval, func_eval, scale_f, scale_g
from pogs_tpu.linalg.equil import equilibrate
from pogs_tpu.linalg.matrix import apply_sparse_policy, as_matrix_op
from pogs_tpu.linalg.norm import norm2_est
from pogs_tpu.projector.direct import DirectProjector
from pogs_tpu.projector.indirect import CglsProjector
from pogs_tpu.solver.admm import admm_loop, postsolve_verify
from pogs_tpu.utils.precision import highest_precision

_INIT_CACHE: dict = {}
_SOLVE_CACHE: dict = {}


def _make_projector(kind: str, direct_method: str, cgls_max_iter: int):
    if kind == "direct":
        return DirectProjector(method=direct_method)
    if kind == "cgls":
        return CglsProjector(max_iter=cgls_max_iter)
    raise ValueError(f"unknown projector {kind!r}")


def _get_init_fn(shape, dtype, kind, direct_method, cgls_max_iter):
    key = (shape, str(dtype), kind, direct_method, cgls_max_iter)
    fn = _INIT_CACHE.get(key)
    if fn is None:
        projector = _make_projector(kind, direct_method, cgls_max_iter)

        def init(A):
            eq = equilibrate(A)
            norm_A = norm2_est(eq.A)
            factor = projector.init(eq.A, s=1.0)
            return {"A": eq.A, "d": eq.d, "e": eq.e, "norm_A": norm_A, "factor": factor}

        fn = jax.jit(highest_precision(init))
        _INIT_CACHE[key] = fn
    return fn


def _fv(h: np.ndarray, params) -> FunctionVector:
    """Rebuild a FunctionVector around traced params without re-clamping."""
    fv = FunctionVector.__new__(FunctionVector)
    fv.h = h
    fv.n = h.shape[0]
    fv.a, fv.b, fv.c, fv.d, fv.e = params
    return fv


def _get_solve_fn(shape, dtype, h_f: np.ndarray, h_g: np.ndarray,
                  settings: SolverSettings, kind, direct_method,
                  has_warm: bool, has_x0: bool, has_nu0: bool):
    key = (
        shape, str(dtype), h_f.tobytes(), h_g.tobytes(), settings,
        kind, direct_method, has_warm, has_x0, has_nu0,
    )
    fn = _SOLVE_CACHE.get(key)
    if fn is not None:
        return fn

    projector = _make_projector(kind, direct_method, settings.cgls_max_iter)
    m, n = shape

    # Every per-call array (zeros, scalar rho, warm state) is created or
    # converted *inside* this one jit program, so a solve is exactly one
    # dispatch: no eager device op runs on the host's side of it.
    def solve(init_state, f_params, g_params, rho0, opt):
        A = init_state["A"]
        d = init_state["d"]
        e = init_state["e"]
        factor = init_state["factor"]
        norm_A = init_state["norm_A"]
        dt = A.dtype
        rho0 = jnp.asarray(rho0, dt)

        def _clamp(params):
            a, b, c, dd, ee = (jnp.asarray(p, dt) for p in params)
            # Convexity clamps (prox_lib.h:62-69).
            return (a, b, jnp.maximum(c, 0), dd, jnp.maximum(ee, 0))

        # Scale the objective by the equilibration (pogs.cpp:141, 608-617).
        f_s = scale_f(_fv(h_f, _clamp(f_params)), d)
        g_s = scale_g(_fv(h_g, _clamp(g_params)), e)

        if has_warm:
            z0 = opt["z"]
            zt0 = opt["zt"]
        else:
            z0 = jnp.zeros((m + n,), dt)
            zt0 = jnp.zeros((m + n,), dt)

        # Warm start from (x0, nu0) (pogs.cpp:143-156).
        if has_x0:
            xs = jnp.asarray(opt["x0"], dt) / e
            z0 = jnp.concatenate([xs, A.mv(xs)])
        if has_nu0:
            nus = jnp.asarray(opt["nu0"], dt) / d
            zt0 = jnp.concatenate([A.rmv(nus), -nus]) / rho0

        def prox_fn(x_in, y_in, rho):
            return prox_eval(g_s, x_in, rho), prox_eval(f_s, y_in, rho)

        def eval_fn(x12, y12):
            return func_eval(f_s, y12) + func_eval(g_s, x12)

        def project_fn(px, py, tol, x_warm):
            return projector.project(A, factor, px, py, tol, x_warm)

        out = admm_loop(
            A, norm_A, d, e, prox_fn, eval_fn, project_fn, settings,
            z0, zt0, rho0,
        )

        if settings.use_exact_tol:
            out["status"] = postsolve_verify(
                A, d, e, out["x12"], out["y12"], out["status"],
                settings.abs_tol, settings.rel_tol,
            )

        # Unscale to the original space (pogs.cpp:509-518).
        out["x"] = out.pop("x12") * e
        out["y"] = out.pop("y12") / d
        out["mu"] = out.pop("mu_scaled") / e
        out["nu"] = out.pop("nu_scaled") * d
        return out

    fn = jax.jit(highest_precision(solve))
    _SOLVE_CACHE[key] = fn
    return fn


class GraphFormSolver:
    """Reusable graph-form ADMM solver for a fixed matrix A.

    ``solve(f, g)`` may be called repeatedly; the equilibration and Gram
    factorization are computed once, and the final iterate carries over as
    a warm start (exactly the reference's λ-path pattern).
    """

    def __init__(
        self,
        A,
        projector: str = "direct",
        direct_method: str = "inverse",
        dtype=None,
        settings: Optional[SolverSettings] = None,
        sparse_policy: str = "auto",
    ):
        if dtype is None:
            in_dtype = getattr(A, "dtype", None) or jnp.float32
            dtype = jnp.result_type(in_dtype, jnp.float32)
        A = apply_sparse_policy(A, sparse_policy)
        self.A = as_matrix_op(A, dtype)
        self.m, self.n = self.A.shape
        self.dtype = self.A.dtype
        if self.A.is_sparse and projector == "direct":
            # Parity with the reference: sparse matrices pair with the CGLS
            # projector only (explicit instantiations, pogs.cpp:1979-2010).
            projector = "cgls"
        self.projector = projector
        self.direct_method = direct_method
        self.settings = settings or SolverSettings()
        self.rho = float(self.settings.rho)
        self._init_state = None
        self._z = None
        self._zt = None

    # -- lifecycle ----------------------------------------------------------

    def init(self):
        """Equilibrate + factor (idempotent)."""
        if self._init_state is None:
            t0 = time.perf_counter()
            fn = _get_init_fn(
                (self.m, self.n), self.dtype, self.projector,
                self.direct_method, self.settings.cgls_max_iter,
            )
            self._init_state = fn(self.A)
            # Init-vs-solve time split (reference pogs.cpp:485-490).
            self.init_time = time.perf_counter() - t0
        return self

    def reset_warm_start(self):
        self._z = None
        self._zt = None
        return self

    def save_state(self, path):
        """Checkpoint the warm-start state (z, zt, rho) to ``path`` (.npz)."""
        from pogs_tpu.utils.checkpoint import save_state
        save_state(self, path)
        return self

    def load_state(self, path, strict: bool = True):
        """Restore a checkpoint created by :meth:`save_state`."""
        from pogs_tpu.utils.checkpoint import load_state
        return load_state(self, path, strict=strict)

    # -- solving -------------------------------------------------------------

    def solve(
        self,
        f: FunctionVector,
        g: FunctionVector,
        settings: Optional[SolverSettings] = None,
        x_init=None,
        nu_init=None,
        rho: Optional[float] = None,
        _no_sync: bool = False,
    ):
        if f.n != self.m:
            raise ValueError(f"f has length {f.n}, expected m={self.m}")
        if g.n != self.n:
            raise ValueError(f"g has length {g.n}, expected n={self.n}")
        settings = settings or self.settings
        if (self.dtype == jnp.float32
                and min(settings.abs_tol, settings.rel_tol) < 1e-5):
            warnings.warn(
                "tolerances below 1e-5 sit at the float32 accuracy floor; "
                "use dtype='float64' (with jax_enable_x64) for tighter "
                "accuracy",
                stacklevel=2,
            )
        # rho is a traced argument; keep data-dependent values out of the
        # compile cache key (see ConeSolver.solve).
        if settings.rho != DEFAULT_RHO:
            if rho is None:
                rho = float(settings.rho)
            settings = settings.replace(rho=DEFAULT_RHO)
        self.init()

        has_warm = self._z is not None
        rho0 = float(rho if rho is not None else self.rho)

        fn = _get_solve_fn(
            (self.m, self.n), self.dtype, f.h, g.h, settings,
            self.projector, self.direct_method,
            has_warm, x_init is not None, nu_init is not None,
        )

        opt = {}
        if has_warm:
            opt["z"] = self._z
            opt["zt"] = self._zt
        if x_init is not None:
            opt["x0"] = x_init
        if nu_init is not None:
            opt["nu0"] = nu_init

        if settings.verbose > 0:
            # Banner (reference pogs.cpp:186-196).
            print(
                "---------------------------------------------------------\n"
                " pogs_tpu — graph-form ADMM\n"
                f"   A: {self.m} x {self.n} ({'sparse' if self.A.is_sparse else 'dense'}, "
                f"{self.dtype}), projector: {self.projector}\n"
                f"   abs_tol {settings.abs_tol:g}, rel_tol {settings.rel_tol:g}, "
                f"rho {rho0:g}, max_iter {settings.max_iter}\n"
                "---------------------------------------------------------"
            )
            if settings.verbose > 1:
                print("  iter:    r        eps_pri    s        eps_dua"
                      "    gap      eps_gap   optval")

        f.to_device()
        g.to_device()
        t0 = time.perf_counter()
        out = fn(self._init_state, tuple(f.params), tuple(g.params), rho0, opt)
        if _no_sync:
            # Async path for pipelined benchmarking: no host sync; the raw
            # device-array dict is returned and warm-start state still chains.
            self._z = out["z"]
            self._zt = out["zt"]
            return out
        status_val = int(out["status"])  # blocks until the solve finishes
        solve_time = time.perf_counter() - t0

        # Persist warm-start state (pogs.cpp:573) and adapted rho.
        self._z = out["z"]
        self._zt = out["zt"]
        self.rho = float(out["rho"])

        if settings.verbose > 0:
            # Final summary (reference pogs.cpp:484-500).
            init_ms = getattr(self, "init_time", 0.0) * 1e3
            print(
                f" status: {Status(status_val).name}, "
                f"iterations: {int(out['final_iter'])}, "
                f"init: {init_ms:.2f} ms, "
                f"solve time: {solve_time * 1e3:.2f} ms\n"
                f" optval: {float(out['optval']):.6e}, "
                f"nrm_r: {float(out['nrm_r']):.2e}, "
                f"nrm_s: {float(out['nrm_s']):.2e}, "
                f"gap: {float(out['gap']):.2e}"
            )

        return SolverResult(
            x=out["x"],
            y=out["y"],
            mu=out["mu"],
            nu=out["nu"],
            optval=out["optval"],
            final_iter=out["final_iter"],
            status=Status(status_val),
            nrm_r=out["nrm_r"],
            nrm_s=out["nrm_s"],
            gap=out["gap"],
            rho=out["rho"],
            solve_time=solve_time,
        )


def admm_solve(
    A,
    f: FunctionVector,
    g: FunctionVector,
    settings: Optional[SolverSettings] = None,
    **kw,
) -> SolverResult:
    """One-shot functional front end: solve min f(y) + g(x) s.t. y = Ax."""
    solver = GraphFormSolver(A, settings=settings)
    return solver.solve(f, g, **kw)
