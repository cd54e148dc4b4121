"""Conjugate-Gradient Least Squares with shift, as an on-device while_loop.

Solves   minimize ‖A x − b‖² + shift ‖x‖²   from a warm start x0.

Counterpart of src/cpu/include/cgls.h (convergence when
‖s‖ ≤ tol·‖s₀‖ or tol·‖x‖ ≥ 1, with s = Aᵀr − shift·x, cgls.h:298-305).
The operator is passed as a pair of closures so dense, sharded, and sparse
matvecs all reuse the same loop.

Unlike the reference (whose scalar recurrences are always double,
cgls.h:204 — even for the float instantiation), this loop keeps every
quantity in the iterate dtype so the matvec stays in f32.
That requires a safeguard the reference does not need: near the f32
noise floor the CG recurrence loses conjugacy, beta becomes a noise
ratio, and the iterate random-walks away (measured: a warm-started
f32 ADMM solve diverged by 6 orders of magnitude once each projection
burned all 500 iterations at the floor).  The loop therefore tracks
the best iterate by gradient norm and exits on divergence (‖s‖ grows
4x past the best seen) or stall (no improvement for 50 iterations),
returning the best iterate rather than the last.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def cgls_solve(
    matvec: Callable,
    rmatvec: Callable,
    b,
    x0,
    shift,
    tol,
    max_iter: int = 500,
):
    """Returns (x, iterations). All inputs may be traced."""
    dt = b.dtype
    shift = jnp.asarray(shift, dt)
    tol = jnp.asarray(tol, dt)
    eps = jnp.asarray(jnp.finfo(dt).eps, dt)

    r = b - matvec(x0)
    s = rmatvec(r) - shift * x0
    p = s
    norms0 = jnp.linalg.norm(s)
    gamma = norms0 * norms0

    stall_window = jnp.asarray(50, jnp.int32)
    div_factor = jnp.asarray(4.0, dt)

    def cond(carry):
        (x, r, p, gamma, k, done, x_best, norms_best, k_best) = carry
        return jnp.logical_and(k < max_iter, jnp.logical_not(done))

    def body(carry):
        x, r, p, gamma, k, _, x_best, norms_best, k_best = carry
        q = matvec(p)
        normp2 = jnp.vdot(p, p)
        normq2 = jnp.vdot(q, q)
        delta = normq2 + shift * normp2
        delta = jnp.where(delta <= 0, eps, delta)
        alpha = gamma / delta
        x = x + alpha * p
        r = r - alpha * q
        s = rmatvec(r) - shift * x
        gamma_new = jnp.vdot(s, s)
        beta = gamma_new / gamma
        p = s + beta * p
        norms = jnp.sqrt(gamma_new)
        normx = jnp.linalg.norm(x)
        improved = norms < norms_best
        x_best = jnp.where(improved, x, x_best)
        k_best = jnp.where(improved, k, k_best)
        norms_best = jnp.minimum(norms, norms_best)
        converged = jnp.logical_or(norms <= norms0 * tol, normx * tol >= 1.0)
        diverged = norms > div_factor * norms_best
        stalled = (k - k_best) >= stall_window
        done = converged | diverged | stalled
        return (x, r, p, gamma_new, k + 1, done, x_best, norms_best, k_best)

    init_done = norms0 < eps
    x, _, _, _, k, _, x_best, _, _ = jax.lax.while_loop(
        cond, body,
        (x0, r, p, gamma, jnp.asarray(0, jnp.int32), init_done,
         x0, norms0, jnp.asarray(0, jnp.int32)),
    )
    return x_best, k
