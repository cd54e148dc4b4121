"""Anderson acceleration (type-II, Walker & Ni 2011) for fixed-point loops.

Counterpart of src/cpu/include/anderson.h (QR least-squares over a residual
history with a circular buffer).  The reference ships the class but never
wires it into a solver (SURVEY.md §2.5); here it is a functional, pytree-
state component usable inside ``lax.while_loop``, and the graph-form ADMM
loop applies it to the (z, z̃) pair behind the documented knobs
(use_anderson / anderson_mem / anderson_start, off by default,
docs/api/configuration.md:150-196).

State is fixed-shape: circular difference buffers ΔF (residual diffs) and
ΔG (map-output diffs); each step solves the m×m regularized normal
equations for the mixing weights — an O(mem²·dim) cost that fuses into a
couple of small matmuls.  Safeguards: weights are rejected (plain iterate
kept) if non-finite or larger than ``max_weight``; callers should reset the
state whenever the underlying map changes (e.g. a ρ rescale).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class AndersonState(NamedTuple):
    dF: jax.Array      # (mem, dim) residual differences
    dG: jax.Array      # (mem, dim) map-output differences
    prev_f: jax.Array  # (dim,) last residual
    prev_g: jax.Array  # (dim,) last map output
    k: jax.Array       # iterations since (re)start


def anderson_init(dim: int, mem: int, dtype) -> AndersonState:
    return AndersonState(
        dF=jnp.zeros((mem, dim), dtype),
        dG=jnp.zeros((mem, dim), dtype),
        prev_f=jnp.zeros((dim,), dtype),
        prev_g=jnp.zeros((dim,), dtype),
        k=jnp.asarray(0, jnp.int32),
    )


def anderson_reset(st: AndersonState) -> AndersonState:
    return st._replace(k=jnp.zeros_like(st.k))


def anderson_step(
    st: AndersonState,
    s_prev,
    s_new,
    reg: float = 1e-10,
    max_weight: float = 20.0,
):
    """One AA step for the map output s_new = G(s_prev).

    Returns (s_acc, new_state).  s_acc equals s_new until at least one
    difference pair is stored; the caller decides when to *use* s_acc
    (e.g. only after anderson_start iterations).
    """
    mem, dim = st.dF.shape
    dt = s_new.dtype
    f = s_new - s_prev
    g = s_new

    # Store differences once a previous (f, g) pair exists.
    slot = (st.k - 1) % mem
    have_prev = st.k >= 1
    df = f - st.prev_f
    dg = g - st.prev_g
    dF = jnp.where(have_prev, st.dF.at[slot].set(df), st.dF)
    dG = jnp.where(have_prev, st.dG.at[slot].set(dg), st.dG)

    # Valid columns mask: min(k, mem) most recent slots.
    m_k = jnp.minimum(st.k, mem)
    col_ids = jnp.arange(mem)
    valid = col_ids < m_k

    dF_m = dF * valid[:, None]
    G_mat = dF_m @ dF_m.T + jnp.asarray(reg, dt) * jnp.eye(mem, dtype=dt)
    # Keep masked rows/cols identity so the solve stays well-posed.
    G_mat = jnp.where(
        valid[:, None] & valid[None, :], G_mat,
        jnp.eye(mem, dtype=dt),
    )
    rhs = (dF_m @ f) * valid
    # G_mat is SPD (Gram + reg): Cholesky-based solve.
    L = jnp.linalg.cholesky(G_mat)
    theta = jax.scipy.linalg.cho_solve((L, True), rhs) * valid

    ok = jnp.all(jnp.isfinite(theta)) & (jnp.max(jnp.abs(theta)) <= max_weight) \
        & (m_k > 0)
    s_acc = jnp.where(ok, g - theta @ (dG * valid[:, None]), g)

    new_state = AndersonState(dF=dF, dG=dG, prev_f=f, prev_g=g, k=st.k + 1)
    return s_acc, new_state
