"""Batched solves: vmapped λ-paths / scenario sweeps, optionally mesh-sharded.

The reference solves λ-paths sequentially with warm starts
(examples/cpp/lasso_path.cpp:90-106).  Here the whole path can run *in
parallel*: equilibrate + factor once, then vmap the ADMM loop over the
regularization values — one batched matrix product per iteration instead
of a string of matrix-vector products, with the per-op launch cost shared
by every lane.  With a mesh, the batch axis shards data-parallel (zero
cross-device traffic) while A can row-shard over a second axis.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pogs_tpu.types import Function, FunctionVector, SolverSettings
from pogs_tpu.prox.vector import prox_eval, func_eval, scale_f, scale_g
from pogs_tpu.linalg.equil import equilibrate
from pogs_tpu.linalg.norm import norm2_est
from pogs_tpu.projector.direct import DirectProjector
from pogs_tpu.solver.admm import admm_loop
from pogs_tpu.utils.precision import highest_precision

_BATCH_CACHE: dict = {}


def _fv(h, params):
    fv = FunctionVector.__new__(FunctionVector)
    fv.h = h
    fv.n = h.shape[0]
    fv.a, fv.b, fv.c, fv.d, fv.e = params
    return fv


def batched_graph_solve(
    A,
    f: FunctionVector,
    g: FunctionVector,
    g_c_batch=None,
    g_e_batch=None,
    f_b_batch=None,
    settings: Optional[SolverSettings] = None,
    mesh: Optional[Mesh] = None,
    batch_axis: str = "batch",
):
    """Solve min f_k(y) + g_k(x) s.t. y = Ax for a batch of parameter
    overrides: g_c_batch[k] replaces g.c, g_e_batch[k] replaces g.e
    (regularization sweeps), f_b_batch[k] replaces f.b (scenario targets —
    multi-right-hand-side regression).  Everything — equilibration,
    factorization, the vmapped while loop — is one jit program.

    Returns dict of batched results: x (K,n), y (K,m), optval (K,),
    iterations (K,), status (K,).
    """
    settings = settings or SolverSettings()
    A = jnp.asarray(A)
    dt = A.dtype
    m, n = A.shape
    npdt = np.dtype(str(dt))
    # One bundled upload per FunctionVector (idempotent) instead of one
    # transfer per parameter array.
    f.to_device()
    g.to_device()
    if g_c_batch is not None:
        K = np.asarray(g_c_batch).shape[0]
    elif f_b_batch is not None:
        K = np.asarray(f_b_batch).shape[0]
    else:
        raise ValueError("provide at least one of g_c_batch / f_b_batch")

    # Batch arguments keep their NATURAL shapes host-side — per-lane
    # scalars stay (K,), shared vectors stay (n,)/(m,) — and broadcast on
    # DEVICE, so a (K,) λ ladder is never inflated into a (K, n) upload.
    def _mode(arr, shared, per_lane_scalar_ok=True):
        """(array, vmap_axis, kind) for one batch argument.  Shared args
        that already live on device pass through untouched — np.asarray
        on a jax.Array is a BLOCKING device-to-host copy that would
        serialize every pipelined dispatch."""
        if arr is None:
            if isinstance(shared, jax.Array):
                return shared, None, "shared"
            return np.asarray(shared, npdt), None, "shared"
        if isinstance(arr, jax.Array):
            # Already on device: coerce dtype device-side if needed; a
            # np.asarray here would be the same blocking d2h copy the
            # shared branch avoids.
            if arr.dtype != npdt:
                arr = arr.astype(npdt)
        else:
            arr = np.asarray(arr, npdt)
        if arr.ndim == 1 and per_lane_scalar_ok:
            return arr, 0, "lane_scalar"
        return arr, 0, "lane_vec"

    c_arg, c_ax, c_kind = _mode(g_c_batch, g.c)
    e_arg, e_ax, e_kind = _mode(g_e_batch, g.e)
    fb_arg, fb_ax, fb_kind = _mode(f_b_batch, f.b, per_lane_scalar_ok=False)
    if fb_kind == "lane_vec" and fb_arg.shape != (K, m):
        raise ValueError(f"f_b_batch must be (K, m) = {(K, m)}")

    key = (A.shape, str(dt), f.h.tobytes(), g.h.tobytes(), settings, K,
           c_kind, e_kind, fb_kind,
           mesh if mesh is None else (tuple(mesh.shape.items()), batch_axis))
    fn = _BATCH_CACHE.get(key)
    if fn is None:
        projector = DirectProjector()

        def solve_all(A, f_params, g_params, c_batch, e_batch, fb_batch):
            dt = A.dtype
            f_params = tuple(jnp.asarray(p, dt) for p in f_params)
            g_params = tuple(jnp.asarray(p, dt) for p in g_params)
            eq = equilibrate(A)
            norm_A = norm2_est(eq.A)
            factor = projector.init(eq.A, s=1.0)

            def project_fn(px, py, tol, x_warm):
                return projector.project(eq.A, factor, px, py, tol, x_warm)

            def solve_one(ck, ek, fbk):
                ck = jnp.broadcast_to(jnp.asarray(ck, dt), (n,))
                ek = jnp.broadcast_to(jnp.asarray(ek, dt), (n,))
                fbk = jnp.broadcast_to(jnp.asarray(fbk, dt), (m,))
                fa, fbp, fc, fd, fe = f_params
                f_k = _fv(f.h, (fa, fbk, fc, fd, fe))
                f_s = scale_f(f_k, eq.d)
                a, b, c, d, e = g_params
                g_k = _fv(g.h, (a, b, ck, d, ek))
                g_s = scale_g(g_k, eq.e)

                def prox_fn(x_in, y_in, rho):
                    return prox_eval(g_s, x_in, rho), prox_eval(f_s, y_in, rho)

                def eval_fn(x12, y12):
                    return func_eval(f_s, y12) + func_eval(g_s, x12)

                z0 = jnp.zeros((m + n,), dt)
                out = admm_loop(
                    eq.A, norm_A, eq.d, eq.e, prox_fn, eval_fn, project_fn,
                    settings, z0, z0, jnp.asarray(settings.rho, dt),
                )
                return {
                    "x": out["x12"] * eq.e,
                    "y": out["y12"] / eq.d,
                    "optval": out["optval"],
                    "iterations": out["final_iter"],
                    "status": out["status"],
                }

            return jax.vmap(solve_one, in_axes=(c_ax, e_ax, fb_ax),
                            axis_size=K)(c_batch, e_batch, fb_batch)

        if mesh is not None:
            batch_sharding = NamedSharding(mesh, P(batch_axis))
            rep = NamedSharding(mesh, P())
            fn = jax.jit(
                highest_precision(solve_all),
                in_shardings=(
                    rep,  # A replicated (row-shard via device_put upstream)
                    None, None,
                    batch_sharding if c_ax == 0 else rep,
                    batch_sharding if e_ax == 0 else rep,
                    batch_sharding if fb_ax == 0 else rep,
                ),
            )
        else:
            fn = jax.jit(highest_precision(solve_all))
        _BATCH_CACHE[key] = fn

    return fn(A, tuple(f.params), tuple(g.params), c_arg, e_arg, fb_arg)


def warm_path_graph_solve(
    A,
    f: FunctionVector,
    g: FunctionVector,
    g_c_batch,
    settings: Optional[SolverSettings] = None,
):
    """Sequential WARM-STARTED regularization path as one device program.

    The reference's LassoPath pattern (examples/cpp/lasso_path.cpp:90-106
    + the implicit warm start at pogs.cpp:573) re-solves per λ on the
    host; here the whole path is a single ``lax.scan`` whose carry is the
    warm-start state (z, z̃, ρ) — each λ starts from the previous
    solution, so a fine grid costs far fewer total iterations than the
    independent vmap batch (`batched_graph_solve`).  Order the λ values
    the way a path should be walked (large → small for lasso).

    ``g_c_batch``: (K,) or (K, n) — per-step overrides of ``g.c``.
    Returns dict of stacked results: x (K, n), optval (K,),
    iterations (K,), status (K,).
    """
    settings = settings or SolverSettings()
    A = jnp.asarray(A)
    dt = A.dtype
    m, n = A.shape
    c_arr = np.asarray(g_c_batch)
    K = c_arr.shape[0]

    key = ("warm_path", A.shape, str(dt), f.h.tobytes(), g.h.tobytes(),
           settings, K)
    fn = _BATCH_CACHE.get(key)
    if fn is None:
        projector = DirectProjector(method="cholesky")

        def solve_path(A, f_params, g_params, c_batch):
            dt = A.dtype
            f_params = tuple(jnp.asarray(p, dt) for p in f_params)
            g_params = tuple(jnp.asarray(p, dt) for p in g_params)
            c_batch = jnp.asarray(c_batch, dt)
            eq = equilibrate(A)
            norm_A = norm2_est(eq.A)
            factor = projector.init(eq.A, s=1.0)
            f_s = scale_f(_fv(f.h, f_params), eq.d)

            def project_fn(px, py, tol, x_warm):
                return projector.project(eq.A, factor, px, py, tol, x_warm)

            def step(carry, ck):
                z0, zt0, rho0 = carry
                ck = jnp.broadcast_to(jnp.asarray(ck, dt), (n,))
                a, b, c, d, e = g_params
                g_s = scale_g(_fv(g.h, (a, b, ck, d, e)), eq.e)

                def prox_fn(x_in, y_in, rho):
                    return (prox_eval(g_s, x_in, rho),
                            prox_eval(f_s, y_in, rho))

                def eval_fn(x12, y12):
                    return func_eval(f_s, y12) + func_eval(g_s, x12)

                out = admm_loop(
                    eq.A, norm_A, eq.d, eq.e, prox_fn, eval_fn,
                    project_fn, settings, z0, zt0, rho0,
                )
                res = {
                    "x": out["x12"] * eq.e,
                    "optval": out["optval"],
                    "iterations": out["final_iter"],
                    "status": out["status"],
                }
                return (out["z"], out["zt"], out["rho"]), res

            z_init = jnp.zeros((m + n,), dt)
            carry0 = (z_init, z_init, jnp.asarray(settings.rho, dt))
            _, res = lax.scan(step, carry0, c_batch)
            return res

        fn = jax.jit(highest_precision(solve_path))
        _BATCH_CACHE[key] = fn

    npdt = np.dtype(str(dt))
    c_batch = np.asarray(g_c_batch, npdt)  # (K,) or (K, n); device broadcasts
    return fn(A, tuple(f.params), tuple(g.params), c_batch)


def solve_lasso_path(
    A,
    b,
    lambdas,
    settings: Optional[SolverSettings] = None,
    mesh: Optional[Mesh] = None,
    warm: bool = False,
):
    """Solve the full lasso λ-path: vmapped-independent by default, or
    sequentially warm-started (``warm=True``, the reference's LassoPath
    pattern as one lax.scan program — fewer total iterations on fine
    grids; λ values should then be ordered large → small)."""
    A = jnp.asarray(A)
    m, n = A.shape
    b = jnp.asarray(b, A.dtype).ravel()
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=A.dtype)
    g = FunctionVector(Function.ABS, n, dtype=A.dtype)
    if warm:
        if mesh is not None:
            raise ValueError(
                "warm=True runs a sequential scan on one device; mesh "
                "sharding applies to the independent (warm=False) batch"
            )
        return warm_path_graph_solve(A, f, g, lambdas, settings=settings)
    return batched_graph_solve(A, f, g, lambdas, settings=settings, mesh=mesh)


_CONE_BATCH_CACHE: dict = {}


def batched_cone_solve(
    A,
    b_batch,
    c_batch,
    Ky,
    settings: Optional[SolverSettings] = None,
    strategy: str = "smw",
    mesh: Optional[Mesh] = None,
    batch_axis: str = "batch",
):
    """Solve a batch of cone problems  min c_k'x  s.t.  b_k − A x ∈ K_y
    sharing one matrix and cone structure (scenario LPs, MPC over initial
    states): equilibrate + factor once, vmap the HSDE DR loop — one
    batched matrix product per iteration for the whole batch.

    ``b_batch``: (K, m); ``c_batch``: (K, n) or (n,) to broadcast.
    Returns dict of batched results: x (K, n), y (K, m), optval (K,),
    iterations (K,), status (K,).
    """
    import warnings

    from pogs_tpu.types import ConeConstraint
    from pogs_tpu.cones.sets import ConeSet
    from pogs_tpu.solver.hsde import hsde_solve

    settings = settings or SolverSettings()
    A = jnp.asarray(A)
    dt = A.dtype
    if dt == jnp.float32 and min(settings.abs_tol, settings.rel_tol) < 1e-5:
        warnings.warn(
            "tolerances below 1e-5 sit at the float32 accuracy floor; "
            "borderline lanes may report MAX_ITER at the optimum",
            stacklevel=2,
        )
    m, n = A.shape
    b_batch = np.asarray(b_batch, np.dtype(str(dt)))
    K = b_batch.shape[0]
    c_batch = np.asarray(c_batch, np.dtype(str(dt)))
    c_shared = c_batch.ndim == 1  # one c for all lanes: no host broadcast

    Ky = [c if isinstance(c, ConeConstraint) else ConeConstraint(*c) for c in Ky]
    Kset = ConeSet(Ky, m)

    key = (A.shape, str(dt), tuple((int(c.cone), c.indices) for c in Ky),
           settings, strategy, K, c_shared,
           mesh if mesh is None else (tuple(mesh.shape.items()), batch_axis))
    fn = _CONE_BATCH_CACHE.get(key)
    if fn is None:
        def solve_all(A, bs, cs):
            eq = equilibrate(A, constrain_d=Kset.constrain_average)
            Aeq = eq.A

            def solve_one(b_orig, c_orig):
                b_s = b_orig * eq.d
                c_s = c_orig * eq.e
                out = hsde_solve(
                    Aeq, b_s, c_s, Kset, strategy=strategy,
                    abs_tol=settings.abs_tol, rel_tol=settings.rel_tol,
                    max_iter=settings.max_iter,
                    use_anderson=settings.use_anderson,
                    anderson_mem=settings.anderson_mem,
                    anderson_start=settings.anderson_start,
                )
                w = out["w"]
                tau = w[n + m]
                ok = tau > 1e-8
                tau_safe = jnp.where(ok, tau, 1.0)
                x_s = w[:n] / tau_safe
                y_s = w[n:n + m] / tau_safe
                s_orig = (b_s - Aeq.mv(x_s) if hasattr(Aeq, "mv")
                          else b_s - Aeq @ x_s) / eq.d
                x = jnp.where(ok, x_s * eq.e, jnp.zeros(n, A.dtype))
                y = jnp.where(ok, b_orig - s_orig, jnp.zeros(m, A.dtype))
                nu = jnp.where(ok, y_s * eq.d, jnp.zeros(m, A.dtype))
                return {
                    "x": x, "y": y, "nu": nu,
                    "optval": jnp.vdot(c_orig, x),
                    "iterations": out["final_iter"],
                    "status": out["status"],
                }

            return jax.vmap(solve_one, in_axes=(0, None if c_shared else 0),
                            axis_size=K)(bs, cs)

        if mesh is not None:
            bsh = NamedSharding(mesh, P(batch_axis))
            rep = NamedSharding(mesh, P())
            fn = jax.jit(highest_precision(solve_all),
                         in_shardings=(rep, bsh, rep if c_shared else bsh))
        else:
            fn = jax.jit(highest_precision(solve_all))
        _CONE_BATCH_CACHE[key] = fn

    return fn(A, b_batch, c_batch)


def warm_path_cone_solve(
    A,
    b_batch,
    c,
    Ky,
    settings: Optional[SolverSettings] = None,
    strategy: str = "smw",
):
    """Sequential WARM-STARTED cone-problem path as one device program.

    The receding-horizon / homotopy pattern: a sequence of problems
    min cᵀx s.t. b_k − Ax ∈ K_y whose b_k drift gradually (MPC steps,
    scenario sweeps).  One ``lax.scan`` carries the HSDE embedding u
    between steps, so each problem starts on the previous solution ray —
    typically a large iteration saving over independent solves when
    consecutive b_k are close.

    ``b_batch``: (K, m); ``c``: (n,).  Returns stacked x (K, n),
    optval (K,), iterations (K,), status (K,).
    """
    from pogs_tpu.types import ConeConstraint
    from pogs_tpu.cones.sets import ConeSet
    from pogs_tpu.solver.hsde import hsde_solve

    settings = settings or SolverSettings()
    A = jnp.asarray(A)
    dt = A.dtype
    m, n = A.shape
    b_batch = np.asarray(b_batch, np.dtype(str(dt)))
    K = b_batch.shape[0]
    c = np.asarray(c, np.dtype(str(dt)))

    Ky = [k if isinstance(k, ConeConstraint) else ConeConstraint(*k) for k in Ky]
    Kset = ConeSet(Ky, m)

    key = ("warm_cone_path", A.shape, str(dt),
           tuple((int(k.cone), k.indices) for k in Ky), settings, strategy, K)
    fn = _CONE_BATCH_CACHE.get(key)
    if fn is None:
        def solve_path(A, bs, c_orig):
            eq = equilibrate(A, constrain_d=Kset.constrain_average)
            Aeq = eq.A
            c_s = jnp.asarray(c_orig, Aeq.dtype) * eq.e

            def step(u_carry, b_orig):
                b_s = b_orig * eq.d
                out = hsde_solve(
                    Aeq, b_s, c_s, Kset, strategy=strategy,
                    abs_tol=settings.abs_tol, rel_tol=settings.rel_tol,
                    max_iter=settings.max_iter, u0=u_carry,
                    use_anderson=settings.use_anderson,
                    anderson_mem=settings.anderson_mem,
                    anderson_start=settings.anderson_start,
                )
                w = out["w"]
                tau = w[n + m]
                ok = tau > 1e-8
                tau_safe = jnp.where(ok, tau, 1.0)
                x_s = w[:n] / tau_safe
                x = jnp.where(ok, x_s * eq.e, jnp.zeros(n, A.dtype))
                res = {
                    "x": x,
                    "optval": jnp.vdot(jnp.asarray(c_orig, A.dtype), x),
                    "iterations": out["final_iter"],
                    "status": out["status"],
                }
                return out["u"], res

            u0 = jnp.zeros(n + m + 1, Aeq.dtype).at[n + m].set(1.0)
            _, res = lax.scan(step, u0, bs)
            return res

        fn = jax.jit(highest_precision(solve_path))
        _CONE_BATCH_CACHE[key] = fn

    return fn(A, b_batch, c)


def batched_qp_solve(
    A,
    P_qp,
    b_batch,
    c_batch,
    Ky,
    settings: Optional[SolverSettings] = None,
    strategy: str = "smw",
    mesh: Optional[Mesh] = None,
    batch_axis: str = "batch",
    polish: bool = True,
):
    """Solve a batch of QPs  min c_kᵀx + ½xᵀPx  s.t.  b_k − Ax ∈ K_y
    sharing one (A, P, K_y) — scenario MPC with quadratic stage costs,
    parameter sweeps over tracking targets.

    The shared epigraph rotated-SOC extension (solver/cone.py
    ``_solve_qp_as_socp``) is built ONCE: P = LtᵀLt by eigendecomposition,
    extended rows = [A | −t; √2·Lt].  Lanes differ only in the extended
    (b, c), so the whole sweep is one vmapped HSDE solve — one batched
    matrix product per DR iteration for all K problems.  When ``polish`` and
    K_y is polyhedral, each lane finishes with the host-f64 PDAS
    active-set polish (solver/qp_polish.py), so f32 device sweeps return
    certified-accuracy optima.

    ``b_batch``: (K, m); ``c_batch``: (K, n) or (n,) to broadcast.
    Returns dict of batched results: x (K, n), optval (K,),
    iterations (K,), status (K,), polished (K,) bool.
    """
    from pogs_tpu.types import Cone, ConeConstraint
    from pogs_tpu.solver.qp_polish import active_set_polish, row_kinds

    settings = settings or SolverSettings()
    A = np.asarray(A, np.float64)
    m, n = A.shape
    P64 = np.asarray(P_qp, np.float64)
    P64 = (P64 + P64.T) / 2
    if P64.shape != (n, n):
        raise ValueError(f"P must be {n}x{n}")
    b_batch = np.asarray(b_batch, np.float64)
    K = b_batch.shape[0]
    c_batch = np.asarray(c_batch, np.float64)
    c_shared = c_batch.ndim == 1

    # Shared epigraph extension (same construction as the single-solve
    # route, solver/cone.py): variables (x, t); rows [A | 0; t-rows; SOC].
    w_eig, V = np.linalg.eigh(P64)
    keep = w_eig > max(1e-12, 1e-10 * max(float(w_eig.max(initial=0.0)), 1.0))
    Lt = np.sqrt(w_eig[keep])[:, None] * V[:, keep].T  # (r, n)
    r = Lt.shape[0]
    A_ext = np.zeros((m + r + 2, n + 1))
    A_ext[:m, :n] = A
    A_ext[m, n] = -1.0
    A_ext[m + 1, n] = -1.0
    A_ext[m + 2:, :n] = -np.sqrt(2.0) * Lt
    tail = np.concatenate([[1.0, -1.0], np.zeros(r)])
    b_ext = np.concatenate([b_batch, np.broadcast_to(tail, (K, r + 2))],
                           axis=1)
    if c_shared:
        c_ext = np.concatenate([c_batch, [1.0]])
    else:
        c_ext = np.concatenate([c_batch, np.ones((K, 1))], axis=1)
    Ky = [c if isinstance(c, ConeConstraint) else ConeConstraint(*c)
          for c in Ky]
    Ky_ext = list(Ky) + [ConeConstraint(Cone.SOC, range(m, m + r + 2))]

    out = batched_cone_solve(A_ext, b_ext, c_ext, Ky_ext,
                             settings=settings, strategy=strategy,
                             mesh=mesh, batch_axis=batch_axis)
    x = np.array(np.asarray(out["x"], np.float64)[:, :n])
    nu = np.array(np.asarray(out["nu"], np.float64)[:, :m])
    status = np.asarray(out["status"]).copy()
    iterations = np.asarray(out["iterations"])
    optval = np.einsum("kn,kn->k", x, x @ P64) * 0.5
    optval = optval + (x @ c_batch if c_shared
                       else np.einsum("kn,kn->k", c_batch, x))
    polished = np.zeros(K, bool)
    kind = row_kinds(m, Ky) if polish else None
    if kind is not None:
        tol = float(max(settings.abs_tol, settings.rel_tol))
        for k in range(K):
            if status[k] not in (0, 3):
                continue
            ck = c_batch if c_shared else c_batch[k]
            pol = active_set_polish(P64, ck, A, b_batch[k], kind,
                                    x[k], nu[k], tol)
            if pol is not None:
                x[k] = pol["x"]
                nu[k] = pol["lam"]
                status[k] = 0
                optval[k] = ck @ x[k] + 0.5 * x[k] @ P64 @ x[k]
                polished[k] = True
    return {"x": x, "nu": nu, "optval": optval,
            "iterations": iterations, "status": status,
            "polished": polished}
