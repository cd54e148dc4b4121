"""Graph-form ADMM core loop — one jitted ``lax.while_loop``, zero host syncs.

Re-design of PogsImplementation::Solve (src/cpu/pogs.cpp:90-581).
The reference runs a host-driven loop (every norm syncs device→host on the
GPU build, §3.4 of SURVEY.md); here the *entire* solve — prox, projection,
residuals, adaptive ρ, convergence test — is a single compiled while_loop
over a pytree carry, so an N-iteration solve is one device program.

Algorithmic parity (constants from pogs.cpp:93-110):
  * over-relaxation α = 1.7 (1.0 in exact-tol/cone mode)
  * approximate residuals ‖A‖‖Δx‖+‖Δy‖ with exact residuals (2 extra
    matvecs) only computed when within 10× of tolerance — expressed as a
    ``lax.cond`` so the taken branch alone executes at runtime
  * adaptive ρ: spectral (residual-imbalance) update every 50 iters with
    clamped √imbalance ratio, residual-balancing fallback with xi-damping
    (pogs.cpp:401-466); ρ changes rescale the scaled dual zt
  * residual-tied projection tolerance proj_tol = tol_min·min(r,1)^p
  * exact-tol mode computes residuals in the original (unscaled) space and
    re-verifies the primal residual post-solve (pogs.cpp:520-564)
  * implicit warm start: the final complete iterate z is returned for reuse

Layout: the reference packs z = [x (n) ; y (m)]; this loop carries the x
and y parts as SEPARATE pytree leaves instead.  Same math (d scales rows/
y, e scales columns/x), but under a device mesh the two parts have
different natural shardings (y row-sharded, x replicated on the row plan)
— slicing a packed z at the n-boundary inside the loop forced GSPMD to
insert per-iteration collective-permutes (measured 28 in the loop body on
an 8-way mesh); with split state the loop body's only collectives are the
Aᵀ-side psums.  Packing happens once at the solve boundary for the
warm-start interface.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from pogs_tpu.types import SolverSettings, Status
from pogs_tpu.solver.anderson import AndersonState, anderson_init, anderson_step

_PRECISION = lax.Precision.HIGHEST

# Adaptive-rho / over-relaxation constants (pogs.cpp:94-110).
K_DELTA_MIN = 1.05
K_GAMMA = 1.01
K_TAU = 0.8
K_RHO_MIN = 1e-4
K_RHO_MAX = 1e4
# f32 needs tighter rho bounds: z̃ = dual/ρ grows as ρ shrinks, and the dual
# residual Aᵀ(y12+ỹ−yprev)+... then sits on an f32 cancellation floor above
# eps_dua (∝ ρ) — adaptive ρ can spiral to K_RHO_MIN and stall convergence
# permanently.  Equilibrated problems have unit scale, so [1e-2, 1e2] loses
# nothing.  (f64 keeps the reference's [1e-4, 1e4].)
K_RHO_MIN_F32 = 1e-2
K_RHO_MAX_F32 = 1e2
K_KAPPA = 0.9
# Spectral-update schedule, normal (non-exact-tol) mode (pogs.cpp:401-438).
# The exact-tol mode uses (10, 0.5, 2.0, 5.0) — see the body below.
K_SPEC_FREQ = 50
K_SPEC_CHANGE_MIN = 0.67
K_SPEC_CHANGE_MAX = 1.5
K_SPEC_IMB_THRESH = 10.0
K_SPEC_MIN_DELTA = 0.05


class LoopState(NamedTuple):
    x: jax.Array        # current iterate (projected), x part (n,)
    y: jax.Array        # current iterate (projected), y part (m,)
    xt: jax.Array       # scaled dual, x part
    yt: jax.Array       # scaled dual, y part
    x12: jax.Array      # half-iterate (prox output), x part
    y12: jax.Array      # half-iterate (prox output), y part
    xprev: jax.Array    # last *complete* iterate, x part
    yprev: jax.Array    # last *complete* iterate, y part
    rho: jax.Array
    delta: jax.Array
    xi: jax.Array
    kd: jax.Array
    ku: jax.Array
    k: jax.Array
    done: jax.Array
    converged: jax.Array
    nan_found: jax.Array
    nrm_r: jax.Array
    nrm_s: jax.Array
    gap: jax.Array
    eps_pri: jax.Array
    eps_dua: jax.Array
    eps_gap: jax.Array
    prev_nrm_r: jax.Array
    aa: AndersonState

    # Pre-round-2 compat: the state used to carry packed z/zt arrays.
    # Read-only views keep external introspection code working.
    @property
    def z(self):
        """Packed [x; y] iterate (round-1 field layout)."""
        return jnp.concatenate([self.x, self.y])

    @property
    def zt(self):
        """Packed [x; y] scaled dual (round-1 field layout)."""
        return jnp.concatenate([self.xt, self.yt])


def _nrm2(v):
    return jnp.sum(v * v)


def _nrm_pair(a, b):
    """‖[a; b]‖₂ without materializing the concatenation."""
    return jnp.sqrt(_nrm2(a) + _nrm2(b))


def admm_loop(
    A,
    norm_A,
    d,
    e,
    prox_fn: Callable,      # (x_in, y_in, rho) -> (x12, y12)   [scaled objective]
    eval_fn: Callable,      # (x12, y12) -> optval              [scaled objective]
    project_fn: Callable,   # (x0, y0, tol, x_warm) -> (x, y)
    settings: SolverSettings,
    z0,
    zt0,
    rho0,
):
    """Run the scaled-space ADMM iteration. Pure/traceable.

    ``z0``/``zt0`` use the packed [x; y] warm-start convention (split once
    here, re-packed once in the outputs).  Returns a dict of scaled-space
    results plus diagnostics; unscaling to the original space happens in
    the caller (solver wrapper).
    """
    m, n = A.shape
    dt = A.dtype
    exact_mode = settings.use_exact_tol

    alpha = jnp.asarray(1.0 if exact_mode else 1.7, dt)
    abs_tol = jnp.asarray(settings.abs_tol, dt)
    rel_tol = jnp.asarray(settings.rel_tol, dt)
    sqrtn_atol = jnp.sqrt(jnp.asarray(n, dt)) * abs_tol
    sqrtm_atol = jnp.sqrt(jnp.asarray(m, dt)) * abs_tol
    sqrtmn_atol = jnp.sqrt(jnp.asarray(m + n, dt)) * abs_tol

    # Projection-tolerance ladder (pogs.cpp:103-110, 287-290).
    proj_tol_max = jnp.asarray(1e-10 if exact_mode else 1e-8, dt)
    proj_tol_min = jnp.asarray(1e-3 if exact_mode else 1e-2, dt)
    proj_pow = jnp.asarray(1.0 if exact_mode else 0.5, dt)

    max_iter = settings.max_iter
    one = jnp.asarray(1.0, dt)

    if hasattr(A, "mv"):
        matvec, rmatvec = A.mv, A.rmv
    else:
        def matvec(x):
            return jnp.matmul(A, x, precision=_PRECISION)

        def rmatvec(y):
            return jnp.matmul(A.T, y, precision=_PRECISION)

    def nrm(v):
        return jnp.linalg.norm(v)

    def body(st: LoopState) -> LoopState:
        xprev, yprev = st.x, st.y
        rho = st.rho

        # --- Proximal step: z^{k+1/2} = prox(z^k - z̃^k) -------------------
        xin = st.x - st.xt
        yin = st.y - st.yt
        x12, y12 = prox_fn(xin, yin, rho)

        # --- Gap / tolerances (pogs.cpp:266-273) ---------------------------
        xm = xin - x12  # x-part of zprev - zt - z12; equals mu/rho
        ym = yin - y12
        # The m-part reductions are STACKED into one (3, m) reduce: on the
        # row-sharded plan each separate norm/dot lowers to its own scalar
        # all-reduce (pure ICI latency per iteration); one stacked reduce
        # is a single all-reduce of f32[3].  The x-parts are replicated on
        # that plan, so their reductions are collective-free.
        ym2, y12_2, ym_y12 = jnp.sum(
            jnp.stack([ym * ym, y12 * y12, ym * y12]), axis=1)
        gap = jnp.abs(jnp.vdot(xm, x12) + ym_y12)
        eps_gap = sqrtmn_atol + rel_tol * (
            jnp.sqrt(_nrm2(xm) + ym2) * jnp.sqrt(_nrm2(x12) + y12_2))
        eps_pri = sqrtm_atol + rel_tol * jnp.sqrt(y12_2)
        eps_dua = rho * (sqrtn_atol + rel_tol * nrm(xm))

        # --- Over-relaxed projection input (pogs.cpp:276-278) --------------
        x_or = st.xt + alpha * x12 + (one - alpha) * xprev
        y_or = st.yt + alpha * y12 + (one - alpha) * yprev

        # Residual-tied projection tolerance.  The raw ladder has a fixed
        # point at r = tol_min^(1/(1-p)) (normal mode: r = 0.01*sqrt(r)
        # stalls at 1e-4): an inexact (CGLS) projector stops exactly at
        # proj_tol, so the ADMM residual can never drop below it.  Capping
        # by abs_tol keeps the projection error under the target accuracy.
        proj_tol = proj_tol_min * jnp.power(jnp.minimum(st.prev_nrm_r, one), proj_pow)
        proj_tol = jnp.minimum(proj_tol, abs_tol)
        proj_tol = jnp.maximum(proj_tol, proj_tol_max)

        x_new, y_new = project_fn(x_or, y_or, proj_tol, xprev)

        # --- Approximate residuals (pogs.cpp:299-308) ----------------------
        # Same stacking trick: the three m-part reductions (two residual
        # norms + the NaN-probe sum of y_new) ride one all-reduce.
        dyp = yprev - y_new
        dy12 = y12 - y_new
        dyp2, dy12_2, y_new_sum = jnp.sum(
            jnp.stack([dyp * dyp, dy12 * dy12, y_new]), axis=1)
        nrm_s = rho * (norm_A * jnp.sqrt(dyp2) + nrm(xprev - x_new))
        nrm_r = norm_A * nrm(x12 - x_new) + jnp.sqrt(dy12_2)

        # --- Exact residuals only near tolerance (pogs.cpp:310-336) --------
        near = jnp.logical_and(nrm_r < 10 * eps_pri, nrm_s < 10 * eps_dua)
        if exact_mode:
            near = jnp.asarray(True)

        def exact_branch(_):
            r_vec = matvec(x12) - y12
            s_in = y12 + st.yt - yprev
            s_vec = rmatvec(s_in) + (x12 + st.xt - xprev)
            if exact_mode:
                # Original-space metrics (pogs.cpp:210-248).
                dm = jnp.where(d == 0, jnp.ones_like(d), d)
                r_o = jnp.where(d == 0, jnp.zeros_like(r_vec), r_vec / dm)
                y_o = jnp.where(d == 0, jnp.zeros_like(y12), y12 / dm)
                ax_o = jnp.where(d == 0, jnp.zeros_like(r_vec), (r_vec + y12) / dm)
                x_o = x12 * e
                nrm_r_e = nrm(r_o)
                eps_pri_e = sqrtm_atol + rel_tol * jnp.maximum(nrm(ax_o), nrm(y_o))
                eps_dua_e = rho * (sqrtn_atol + rel_tol * nrm(x_o))
                em = jnp.where(e == 0, jnp.ones_like(e), e)
                s_o = jnp.where(e == 0, jnp.zeros_like(s_vec), s_vec / em)
                nrm_s_e = rho * nrm(s_o)
                return nrm_r_e, nrm_s_e, eps_pri_e, eps_dua_e, jnp.asarray(True)
            return nrm(r_vec), rho * nrm(s_vec), eps_pri, eps_dua, jnp.asarray(True)

        def approx_branch(_):
            return nrm_r, nrm_s, eps_pri, eps_dua, jnp.asarray(False)

        nrm_r, nrm_s, eps_pri, eps_dua, exact = lax.cond(
            near, exact_branch, approx_branch, operand=None
        )

        converged = jnp.logical_and(
            exact, jnp.logical_and(nrm_r < eps_pri, nrm_s < eps_dua)
        )
        if settings.gap_stop:
            converged = jnp.logical_and(converged, gap < eps_gap)

        nan_found = jnp.logical_not(
            jnp.logical_and(
                jnp.isfinite(nrm_r),
                jnp.isfinite(jnp.sum(x_new)) & jnp.isfinite(y_new_sum),
            )
        )
        # MONOTONE done: under vmap the loop runs until ALL lanes finish, and
        # a frozen lane's recomputed convergence test can flicker false —
        # without the st.done OR, a converged batch kept looping to max_iter
        # (measured 90x slowdown on a 256-lane batch).
        done = st.done | converged | nan_found | (st.k >= max_iter - 1)

        if settings.verbose > 1:
            stride = 10 if settings.verbose > 2 else 100

            def _report(_):
                optval = eval_fn(x12, y12)
                jax.debug.print(
                    "{k:5d} : {r:.2e}  {ep:.2e}  {s:.2e}  {ed:.2e}  {g:.2e}  {eg:.2e}  {o:.2e}",
                    k=st.k, r=nrm_r, ep=eps_pri, s=nrm_s, ed=eps_dua,
                    g=gap, eg=eps_gap, o=optval,
                )
                return 0

            lax.cond((st.k % stride == 0) | converged, _report, lambda _: 0, None)

        # --- Dual update (pogs.cpp:396-399); skipped once done -------------
        xt_new = st.xt + alpha * x12 + (one - alpha) * xprev - x_new
        yt_new = st.yt + alpha * y12 + (one - alpha) * yprev - y_new

        # --- Adaptive rho (pogs.cpp:401-466) --------------------------------
        rho_new, delta_new, xi_new, kd_new, ku_new = (
            rho, st.delta, st.xi, st.kd, st.ku
        )
        if settings.adaptive_rho:
            rho_min = K_RHO_MIN_F32 if dt == jnp.float32 else K_RHO_MIN
            rho_max = K_RHO_MAX_F32 if dt == jnp.float32 else K_RHO_MAX
            freq = 10 if exact_mode else K_SPEC_FREQ
            change_max = jnp.asarray(2.0 if exact_mode else K_SPEC_CHANGE_MAX, dt)
            change_min = jnp.asarray(0.5 if exact_mode else K_SPEC_CHANGE_MIN, dt)
            imb_thresh = jnp.asarray(5.0 if exact_mode else K_SPEC_IMB_THRESH, dt)

            pri_n = nrm_r / eps_pri
            dua_n = nrm_s / eps_dua
            spec_slot = (st.k > 0) & (st.k % freq == 0) & (eps_pri > 0) & (eps_dua > 0)
            safe_dua = jnp.where(dua_n == 0, jnp.ones_like(dua_n), dua_n)
            imb = pri_n / safe_dua
            spec_cond = (
                (pri_n > 0) & (dua_n > 0)
                & ((imb > imb_thresh) | (imb < one / imb_thresh))
            )
            rho_ratio = jnp.clip(jnp.sqrt(imb), change_min, change_max)
            rho_spec = jnp.clip(rho * rho_ratio, rho_min, rho_max)
            spec_apply = (spec_slot & spec_cond
                          & (jnp.abs(rho_spec - rho) / rho > K_SPEC_MIN_DELTA))

            kf = st.k.astype(dt)
            bal_slot = jnp.logical_not(spec_slot)
            s_small = nrm_s < st.xi * eps_dua
            r_small = nrm_r < st.xi * eps_pri
            bal_up = bal_slot & s_small & jnp.logical_not(r_small) & (K_TAU * kf > st.kd)
            bal_dn = (
                bal_slot & jnp.logical_not(s_small) & r_small
                & (K_TAU * kf > st.ku) & jnp.logical_not(bal_up)
            )
            bal_both = (
                bal_slot & s_small & r_small
                & jnp.logical_not(bal_up) & jnp.logical_not(bal_dn)
            )
            bal_else = (
                bal_slot & jnp.logical_not(bal_up) & jnp.logical_not(bal_dn)
                & jnp.logical_not(bal_both)
            )
            up_apply = bal_up & (rho < rho_max)
            dn_apply = bal_dn & (rho > rho_min)

            rho_new = jnp.where(
                spec_apply, rho_spec,
                jnp.where(up_apply, rho * st.delta,
                          jnp.where(dn_apply, rho / st.delta, rho)),
            )
            zt_scale = jnp.where(
                spec_apply, rho / rho_spec,
                jnp.where(up_apply, one / st.delta,
                          jnp.where(dn_apply, st.delta, one)),
            )
            xt_new = xt_new * zt_scale
            yt_new = yt_new * zt_scale
            rho_rescaled = zt_scale != one
            delta_new = jnp.where(
                up_apply | dn_apply, K_GAMMA * st.delta,
                jnp.where(bal_else, jnp.asarray(K_DELTA_MIN, dt), st.delta),
            )
            xi_new = jnp.where(bal_both, st.xi * K_KAPPA, st.xi)
            ku_new = jnp.where(up_apply, kf, st.ku)
            kd_new = jnp.where(dn_apply, kf, st.kd)

        # Anderson acceleration on the (z, z~) pair (experimental knob,
        # off by default; docs/api/configuration.md:150-196). History is
        # invalidated whenever rho rescales z~.  The packed history vector
        # reintroduces concat/slice resharding under a mesh — acceptable
        # for an off-by-default knob.
        aa_state = st.aa
        if settings.use_anderson:
            s_prev = jnp.concatenate([xprev, yprev, st.xt, st.yt])
            s_vec = jnp.concatenate([x_new, y_new, xt_new, yt_new])
            s_acc, aa_state = anderson_step(aa_state, s_prev, s_vec)
            if settings.adaptive_rho:
                aa_state = aa_state._replace(
                    k=jnp.where(rho_rescaled, 0, aa_state.k)
                )
            use_aa = (st.k >= settings.anderson_start) & jnp.logical_not(done)
            x_new = jnp.where(use_aa, s_acc[:n], x_new)
            y_new = jnp.where(use_aa, s_acc[n:n + m], y_new)
            xt_new = jnp.where(use_aa, s_acc[n + m:2 * n + m], xt_new)
            yt_new = jnp.where(use_aa, s_acc[2 * n + m:], yt_new)

        # Freeze post-convergence state (the reference breaks before the
        # dual/rho updates, pogs.cpp:391-394).
        keep = done

        def sel(new, old):
            return jnp.where(keep, old, new)

        return LoopState(
            x=x_new,
            y=y_new,
            xt=sel(xt_new, st.xt),
            yt=sel(yt_new, st.yt),
            x12=x12,
            y12=y12,
            xprev=xprev,
            yprev=yprev,
            rho=sel(rho_new, rho),
            delta=sel(delta_new, st.delta),
            xi=sel(xi_new, st.xi),
            kd=sel(kd_new, st.kd),
            ku=sel(ku_new, st.ku),
            k=jnp.where(done, st.k, st.k + 1),
            done=done,
            # Latch at the firing iteration: frozen lanes keep iterating
            # under vmap (zt/rho frozen, z refining), and the recomputed
            # flag can flicker on marginal lanes — the status must report
            # the decision that stopped the lane, not the last re-check.
            converged=jnp.where(st.done, st.converged, converged),
            nan_found=jnp.where(st.done, st.nan_found, nan_found),
            nrm_r=nrm_r,
            nrm_s=nrm_s,
            gap=gap,
            eps_pri=eps_pri,
            eps_dua=eps_dua,
            eps_gap=eps_gap,
            prev_nrm_r=sel(nrm_r, st.prev_nrm_r),
            aa=aa_state,
        )

    z0 = jnp.asarray(z0, dt)
    zt0 = jnp.asarray(zt0, dt)
    init = LoopState(
        x=z0[:n],
        y=z0[n:],
        xt=zt0[:n],
        yt=zt0[n:],
        x12=jnp.zeros((n,), dt),
        y12=jnp.zeros((m,), dt),
        xprev=jnp.zeros((n,), dt),
        yprev=jnp.zeros((m,), dt),
        rho=jnp.asarray(rho0, dt),
        delta=jnp.asarray(K_DELTA_MIN, dt),
        xi=jnp.asarray(1.0, dt),
        kd=jnp.asarray(0.0, dt),
        ku=jnp.asarray(0.0, dt),
        k=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
        nan_found=jnp.asarray(False),
        nrm_r=jnp.asarray(0.0, dt),
        nrm_s=jnp.asarray(0.0, dt),
        gap=jnp.asarray(0.0, dt),
        eps_pri=jnp.asarray(0.0, dt),
        eps_dua=jnp.asarray(0.0, dt),
        eps_gap=jnp.asarray(0.0, dt),
        prev_nrm_r=jnp.asarray(jnp.finfo(dt).max, dt),
        aa=anderson_init(
            2 * (m + n) if settings.use_anderson else 0,
            settings.anderson_mem if settings.use_anderson else 1,
            dt,
        ),
    )

    st = lax.while_loop(lambda s: jnp.logical_not(s.done), body, init)

    # --- Outputs (scaled space), pogs.cpp:472-518 --------------------------
    optval = eval_fn(st.x12, st.y12)

    # (mu, nu)/rho = -(zt - zprev + z12); scaled duals.
    mu_scaled = -st.rho * (st.xt - st.xprev + st.x12)
    nu_scaled = -st.rho * (st.yt - st.yprev + st.y12)

    status = jnp.where(
        st.converged,
        Status.SUCCESS.value,
        jnp.where(st.nan_found, Status.NAN_FOUND.value, Status.MAX_ITER.value),
    ).astype(jnp.int32)

    return {
        "x12": st.x12,
        "y12": st.y12,
        "mu_scaled": mu_scaled,
        "nu_scaled": nu_scaled,
        "optval": optval,
        "final_iter": st.k,
        "status": status,
        "rho": st.rho,
        "nrm_r": st.nrm_r,
        "nrm_s": st.nrm_s,
        "gap": st.gap,
        "eps_pri": st.eps_pri,
        "eps_dua": st.eps_dua,
        # The last complete iterate, for implicit warm starts (pogs.cpp:573).
        # Packed once here — the [x; y] convention is the warm-start ABI.
        "z": jnp.concatenate([st.xprev, st.yprev]),
        "zt": jnp.concatenate([st.xt, st.yt]),
    }


def postsolve_verify(A, d, e, x12, y12, status, abs_tol, rel_tol):
    """Exact-tol post-solve verification (pogs.cpp:520-564).

    Recomputes the primal residual in the original space; downgrades
    SUCCESS → MAX_ITER if it misses tolerance. x12/y12 here are *scaled*.
    """
    m = A.shape[0]
    dt = A.dtype
    sqrtm_atol = jnp.sqrt(jnp.asarray(m, dt)) * jnp.asarray(abs_tol, dt)
    dm = jnp.where(d == 0, jnp.ones_like(d), d)
    ax = A.mv(x12) if hasattr(A, "mv") else jnp.matmul(A, x12, precision=_PRECISION)
    ax_orig = ax / dm
    y_orig = y12 / dm
    r = ax_orig - y_orig
    res = jnp.linalg.norm(r)
    eps = sqrtm_atol + jnp.asarray(rel_tol, dt) * jnp.maximum(
        jnp.linalg.norm(ax_orig), jnp.linalg.norm(y_orig)
    )
    bad = jnp.logical_and(status == Status.SUCCESS.value, res > eps)
    return jnp.where(bad, Status.MAX_ITER.value, status).astype(jnp.int32)
