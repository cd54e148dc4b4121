"""The 16-function proximal-operator library, vectorized elementwise.

Each entry h in the library defines f(x) = c*h(a*x - b) + d*x + (e/2) x^2 and
three evaluations (parity with src/include/prox_lib.h):

  * ``PROX[h](v, rho)``     — prox of the *base* h with penalty rho; the
                              (a,b,c,d,e) transform is applied generically in
                              :mod:`pogs_tpu.prox.vector` exactly as the
                              reference does (prox_lib.h:206-230).
  * ``FUNC[h](x)``          — h(x) itself (prox_lib.h:240-322).
  * ``SUBGRAD[h](v, x)``    — projection of v onto the subdifferential of h
                              at x (prox_lib.h:361-465).

All functions are elementwise jnp expressions (branch-free via jnp.where)
so they fuse into single elementwise kernels under XLA.
"""

from __future__ import annotations

import jax.numpy as jnp

from pogs_tpu.types import Function
from pogs_tpu.prox.tools import lambertw_exp, cubic_solve, sigmoid


def _dt(v):
    return jnp.asarray(v).dtype


# ---------------------------------------------------------------------------
# Proximal operators of the base functions h (penalty parameter rho):
#   prox_h(v; rho) = argmin_x h(x) + (rho/2)(x - v)^2
# Closed forms follow the standard catalogue (soft-threshold, shrinkage,
# Huber, Lambert-W for exponentials, quadratic formula for -log, cubic root
# for 1/x, guarded Newton/bisection for logistic).
# ---------------------------------------------------------------------------

def prox_abs(v, rho):
    """Soft-thresholding: shrink v toward 0 by 1/rho."""
    k = 1.0 / rho
    return jnp.maximum(v - k, 0) + jnp.minimum(v + k, 0)


def prox_neg_entr(v, rho):
    """prox of x log x: W(e^{rho v - 1 + log rho}) / rho."""
    return lambertw_exp(rho * v - 1.0 + jnp.log(rho)) / rho


def prox_exp(v, rho):
    """prox of e^x: v - W(e^{v - log rho})."""
    return v - lambertw_exp(v - jnp.log(rho))


def prox_huber(v, rho):
    """prox of huber: pure shrinkage inside |v| < 1 + 1/rho, else shift."""
    small = jnp.abs(v) < 1.0 + 1.0 / rho
    return jnp.where(small, v * rho / (1.0 + rho), v - jnp.sign(v) / rho)


def prox_identity(v, rho):
    return v - 1.0 / rho


def prox_ind_box01(v, rho):
    return jnp.clip(v, 0.0, 1.0)


def prox_ind_eq0(v, rho):
    return jnp.zeros_like(v)


def prox_ind_ge0(v, rho):
    return jnp.maximum(v, 0)


def prox_ind_le0(v, rho):
    return jnp.minimum(v, 0)


def prox_logistic(v, rho, newton_iters: int = 5, bisect_iters: int = 30):
    """prox of log(1 + e^x): root of sigma(x) + rho (x - v) = 0.

    Bracketed on [v - 1/rho, v] (the root always lies there since
    0 < sigma < 1).  Warm Newton steps with bracket safeguarding, then
    fixed-count bisection, then two Newton polish steps — all fixed
    iteration counts so the whole thing is one unrolled elementwise expression.
    """
    l = v - 1.0 / rho
    u = v
    # Piecewise-linear initial guess.
    x = jnp.where(
        v < -2.5,
        v,
        jnp.where(v > 2.5 + 1.0 / rho, v - 1.0 / rho, (rho * v - 0.5) / (0.2 + rho)),
    )

    def newton(x, l, u):
        sig = sigmoid(x)
        f = sig + rho * (x - v)
        g = sig * (1.0 - sig) + rho
        l = jnp.where(f < 0, x, l)
        u = jnp.where(f < 0, u, x)
        x = jnp.clip(x - f / g, l, u)
        return x, l, u

    for _ in range(newton_iters):
        x, l, u = newton(x, l, u)

    for _ in range(bisect_iters):
        mid = 0.5 * (l + u)
        f = sigmoid(mid) + rho * (mid - v)
        l = jnp.where(f < 0, mid, l)
        u = jnp.where(f < 0, u, mid)
    x = 0.5 * (l + u)

    for _ in range(2):
        x, l, u = newton(x, l, u)
    return x


def prox_max_neg0(v, rho):
    """prox of max(0, -x)."""
    z = jnp.maximum(v, 0)
    return jnp.where(v + 1.0 / rho <= 0, v + 1.0 / rho, z)


def prox_max_pos0(v, rho):
    """prox of max(0, x)."""
    z = jnp.minimum(v, 0)
    return jnp.where(v >= 1.0 / rho, v - 1.0 / rho, z)


def prox_neg_log(v, rho):
    """prox of -log x: positive root of x^2 - v x - 1/rho = 0."""
    return 0.5 * (v + jnp.sqrt(v * v + 4.0 / rho))


def prox_recipr(v, rho):
    """prox of 1/x (on x > 0): positive root of x^3 - v x^2 - 1/rho = 0.

    The root exists and is the unique stationary point for ANY v (also
    v < 0) — clamping v at 0 first would return a point strictly above
    the true minimizer."""
    return cubic_solve(-v, jnp.zeros_like(v), -1.0 / rho)


def prox_square(v, rho):
    """prox of (1/2) x^2: pure shrinkage."""
    return rho * v / (1.0 + rho)


def prox_zero(v, rho):
    return v


PROX = {
    Function.ABS: prox_abs,
    Function.EXP: prox_exp,
    Function.HUBER: prox_huber,
    Function.IDENTITY: prox_identity,
    Function.INDBOX01: prox_ind_box01,
    Function.INDEQ0: prox_ind_eq0,
    Function.INDGE0: prox_ind_ge0,
    Function.INDLE0: prox_ind_le0,
    Function.LOGISTIC: prox_logistic,
    Function.MAXNEG0: prox_max_neg0,
    Function.MAXPOS0: prox_max_pos0,
    Function.NEGENTR: prox_neg_entr,
    Function.NEGLOG: prox_neg_log,
    Function.RECIPR: prox_recipr,
    Function.SQUARE: prox_square,
    Function.ZERO: prox_zero,
}


# ---------------------------------------------------------------------------
# Function evaluation h(x).
# ---------------------------------------------------------------------------

def func_abs(x):
    return jnp.abs(x)


def func_neg_entr(x):
    return jnp.where(x <= 0, jnp.zeros_like(x), x * jnp.log(jnp.maximum(x, jnp.finfo(_dt(x)).tiny)))


def func_exp(x):
    return jnp.exp(x)


def func_huber(x):
    ax = jnp.abs(x)
    return jnp.where(ax < 1, 0.5 * ax * ax, ax - 0.5)


def func_identity(x):
    return x


def _func_zero(x):
    return jnp.zeros_like(x)


def func_logistic(x):
    # log(1 + e^x), stable for large |x|.
    return jnp.logaddexp(jnp.zeros_like(x), x)


def func_max_neg0(x):
    return jnp.maximum(-x, 0)


def func_max_pos0(x):
    return jnp.maximum(x, 0)


def func_neg_log(x):
    return -jnp.log(jnp.maximum(x, 0))


def func_recipr(x):
    return 1.0 / jnp.maximum(x, 0)


def func_square(x):
    return 0.5 * x * x


FUNC = {
    Function.ABS: func_abs,
    Function.EXP: func_exp,
    Function.HUBER: func_huber,
    Function.IDENTITY: func_identity,
    Function.INDBOX01: _func_zero,
    Function.INDEQ0: _func_zero,
    Function.INDGE0: _func_zero,
    Function.INDLE0: _func_zero,
    Function.LOGISTIC: func_logistic,
    Function.MAXNEG0: func_max_neg0,
    Function.MAXPOS0: func_max_pos0,
    Function.NEGENTR: func_neg_entr,
    Function.NEGLOG: func_neg_log,
    Function.RECIPR: func_recipr,
    Function.SQUARE: func_square,
    Function.ZERO: _func_zero,
}


# ---------------------------------------------------------------------------
# Projection of v onto the subdifferential of h at x (prox_lib.h:361-465).
# Used by warm-start initialization.
# ---------------------------------------------------------------------------

def subgrad_abs(v, x):
    return jnp.where(x < 0, -jnp.ones_like(v), jnp.where(x > 0, jnp.ones_like(v), jnp.clip(v, -1.0, 1.0)))


def subgrad_neg_entr(v, x):
    return -jnp.log(jnp.maximum(x, jnp.finfo(_dt(x)).tiny)) - 1.0


def subgrad_exp(v, x):
    return jnp.exp(x)


def subgrad_huber(v, x):
    return jnp.clip(x, -1.0, 1.0)


def subgrad_identity(v, x):
    return jnp.ones_like(v)


def subgrad_ind_box01(v, x):
    return jnp.where(x <= 0, jnp.minimum(v, 0), jnp.where(x >= 1, jnp.maximum(v, 0), jnp.zeros_like(v)))


def subgrad_ind_eq0(v, x):
    return v


def subgrad_ind_ge0(v, x):
    return jnp.where(x <= 0, jnp.minimum(v, 0), jnp.zeros_like(v))


def subgrad_ind_le0(v, x):
    return jnp.where(x >= 0, jnp.maximum(v, 0), jnp.zeros_like(v))


def subgrad_logistic(v, x):
    return sigmoid(x)


def subgrad_max_neg0(v, x):
    return jnp.where(x < 0, -jnp.ones_like(v), jnp.where(x > 0, jnp.zeros_like(v), jnp.clip(v, -1.0, 0.0)))


def subgrad_max_pos0(v, x):
    return jnp.where(x < 0, jnp.zeros_like(v), jnp.where(x > 0, jnp.ones_like(v), jnp.clip(v, 0.0, 1.0)))


def subgrad_neg_log(v, x):
    return -1.0 / x


def subgrad_recipr(v, x):
    return 1.0 / (x * x)


def subgrad_square(v, x):
    return x


def subgrad_zero(v, x):
    return jnp.zeros_like(v)


SUBGRAD = {
    Function.ABS: subgrad_abs,
    Function.EXP: subgrad_exp,
    Function.HUBER: subgrad_huber,
    Function.IDENTITY: subgrad_identity,
    Function.INDBOX01: subgrad_ind_box01,
    Function.INDEQ0: subgrad_ind_eq0,
    Function.INDGE0: subgrad_ind_ge0,
    Function.INDLE0: subgrad_ind_le0,
    Function.LOGISTIC: subgrad_logistic,
    Function.MAXNEG0: subgrad_max_neg0,
    Function.MAXPOS0: subgrad_max_pos0,
    Function.NEGENTR: subgrad_neg_entr,
    Function.NEGLOG: subgrad_neg_log,
    Function.RECIPR: subgrad_recipr,
    Function.SQUARE: subgrad_square,
    Function.ZERO: subgrad_zero,
}
