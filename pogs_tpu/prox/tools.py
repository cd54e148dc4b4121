"""Vectorized special-function kernels used by the prox library.

Analogues of src/include/prox_tools.h (LambertWExp, CubicSolve).
Both are branch-free jnp implementations (fixed iteration counts, masked
selects) so they vectorize and trace cleanly under jit/vmap.
"""

from __future__ import annotations

import jax.numpy as jnp


def lambertw_exp(x):
    """Principal-branch Lambert W of e^x, i.e. the w > 0 with w * e^w = e^x.

    Solved in log form — find the root of  w + log(w) = x  — which never
    overflows (unlike iterating on w e^w = e^x directly).  Newton iteration

        w <- w - (w + log w - x) * w / (w + 1)

    with a two-regime initial guess:
      * x > 1:  w ~= x - log(x)           (large-x asymptote)
      * x <= 1: w ~= e^x                  (small-w regime, w ~ e^x as x -> -inf)

    A fixed 20 iterations converges to machine precision across the full
    range for both f32 and f64 (Newton is quadratic once close; the guess
    is within a factor ~e everywhere).
    """
    x = jnp.asarray(x)
    dt = x.dtype
    one = jnp.asarray(1.0, dt)
    big = x > one
    w = jnp.where(big, x - jnp.log(jnp.maximum(x, one)), jnp.exp(jnp.minimum(x, one)))
    tiny = jnp.asarray(jnp.finfo(dt).tiny, dt)
    for _ in range(20):
        w = jnp.maximum(w, tiny)
        f = w + jnp.log(w) - x
        w = w - f * w / (w + one)
    return jnp.maximum(w, tiny)


def cubic_solve(p, q, r):
    """The single positive real root of x^3 + p x^2 + q x + r = 0.

    Depressed-cubic reduction plus Cardano (one real root) / trigonometric
    (three real roots) formulas, selected by the discriminant.  Matches the
    contract of CubicSolve (prox_tools.h:131-149): the caller guarantees a
    single positive root exists (used by the prox of f(x)=1/x).
    """
    p = jnp.asarray(p)
    dt = p.dtype
    q = jnp.asarray(q, dt)
    r = jnp.asarray(r, dt)
    third = jnp.asarray(1.0 / 3.0, dt)
    half = jnp.asarray(0.5, dt)

    s = p * third
    s2 = s * s
    a = q * third - s2           # depressed cubic: t^3 + 3 a t + 2 b = 0
    b = s * s2 - s * q * half + r * half
    disc = a * a * a + b * b

    # Cardano branch (disc >= 0): one real root t = A - a / A,
    # A = cbrt(sqrt(disc) - b).  jnp.cbrt handles negative arguments.
    A_card = jnp.cbrt(jnp.sqrt(jnp.maximum(disc, 0)) - b)
    safe_A = jnp.where(A_card == 0, jnp.asarray(1.0, dt), A_card)
    t_card = A_card - a / safe_A
    t_card = jnp.where(A_card == 0, jnp.zeros_like(t_card), t_card)

    # Trigonometric branch (disc < 0, so a < 0): three real roots; the
    # largest is 2 sqrt(-a) cos(theta/3) with cos(theta) = -b / (-a)^{3/2}.
    na = jnp.maximum(-a, jnp.asarray(jnp.finfo(dt).tiny, dt))
    sq_na = jnp.sqrt(na)
    cos_arg = jnp.clip(-b / (na * sq_na), -1.0, 1.0)
    theta = jnp.arccos(cos_arg)
    t_trig = 2 * sq_na * jnp.cos(theta * third)

    t = jnp.where(disc >= 0, t_card, t_trig)
    return t - s


def sigmoid(x):
    """Numerically stable logistic sigmoid 1 / (1 + e^-x)."""
    return 0.5 * (jnp.tanh(0.5 * jnp.asarray(x)) + 1.0)
