"""Batched Euclidean projections onto cones (counterpart of prox_lib_cone).

Counterpart of src/include/prox_lib_cone.h.  Where the reference walks
cone constraints one at a time (OpenMP threads on CPU, one CUDA stream per
constraint on GPU, prox_lib_cone.h:448-468, 633-652), we batch: all cones
of the same type and size are stacked into one (K, L) tensor and projected
with a single vectorized kernel — one `eigh` call for all SDP blocks, one
masked-norm pass for all SOC blocks, one fixed-iteration bisection for all
exponential cones.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

E1 = 2.718281828459045  # e


def project_soc(v):
    """Project rows of v=(p, x) onto the second-order cone ‖x‖ ≤ p.

    v: (..., L); element 0 is the cone head p, the rest is x.
    Closed form (prox_lib_cone.h:330-346):
      ‖x‖ ≤ −p → 0;  ‖x‖ ≤ |p| (p ≥ 0) → v;  else scale by (1 + p/‖x‖)/2.
    """
    p = v[..., :1]
    x = v[..., 1:]
    nrm = jnp.linalg.norm(x, axis=-1, keepdims=True)
    tiny = jnp.asarray(jnp.finfo(v.dtype).tiny, v.dtype)
    scale = 0.5 * (1.0 + p / jnp.maximum(nrm, tiny))
    # General case: head = (nrm + p)/2, tail scaled by (1 + p/nrm)/2.
    head = jnp.where(nrm <= -p, 0.0, jnp.where(nrm >= jnp.abs(p), scale * nrm, p))
    tail_scale = jnp.where(nrm <= -p, 0.0, jnp.where(nrm >= jnp.abs(p), scale, 1.0))
    return jnp.concatenate([head, x * tail_scale], axis=-1)


def _packed_indices(nmat: int):
    import numpy as np

    # Column-major lower-triangle packing (prox_lib_cone.h:366-379):
    # for 3x3: [a11, a21, a31, a22, a32, a33].
    rows, cols = [], []
    for col in range(nmat):
        for row in range(col, nmat):
            rows.append(row)
            cols.append(col)
    return np.asarray(rows), np.asarray(cols)


def project_sdp_packed(v, nmat: int, scaled: bool = False):
    """Project packed-lower-triangular symmetric matrices onto the PSD cone.

    v: (K, L) with L = nmat(nmat+1)/2, column-major lower-tri packing.
    Batched eigendecomposition + eigenvalue clamp + reconstruction
    (prox_lib_cone.h:349-435).

    ``scaled=True`` uses the svec convention (off-diagonal entries carry a
    √2 weight) so that the packed ℓ2 norm equals the matrix Frobenius norm
    — then the eigh-clamp IS the Euclidean projection in packed space.
    The reference packs *unscaled* (scaled=False), for which the eigh-clamp
    is only an approximation of the packed-space projection; splitting
    solvers need the scaled form to converge reliably.
    """
    K, L = v.shape
    assert L == nmat * (nmat + 1) // 2, "packed size mismatch"
    rows, cols = _packed_indices(nmat)
    off = jnp.asarray((rows != cols), v.dtype)
    if scaled:
        vmat = v * (1.0 + off * (np.sqrt(0.5) - 1.0))  # off-diag / sqrt(2)
    else:
        vmat = v
    X = jnp.zeros((K, nmat, nmat), v.dtype)
    X = X.at[:, rows, cols].set(vmat)
    X = X.at[:, cols, rows].set(vmat)
    w, V = jnp.linalg.eigh(X)
    w = jnp.maximum(w, 0.0)
    Xp = jnp.einsum("kil,kl,kjl->kij", V, w, V,
                    precision=jax.lax.Precision.HIGHEST)
    out = Xp[:, rows, cols]
    if scaled:
        out = out * (1.0 + off * (np.sqrt(2.0) - 1.0))  # off-diag * sqrt(2)
    return out


def _project_exp_primal_impl(v, bisect_iters: int = 50):
    """Project rows v=(r,s,t) onto cl K_exp = {(r,s,t): s>0, s e^{r/s} ≤ t}
    ∪ {(r,s,t): r ≤ 0, s = 0, t ≥ 0}.

    KKT reduction to a 1-D root find in u = x*/y* (same equation as
    prox_lib_cone.h:152-232):

        λ(u) = (r e^u − u t) / (e^{2u} + u),   λ ≥ 0
        F(u) = s e^u − t − λ(u) (1 + e^{2u}(1 − u)) = 0

    F has a pole where e^{2u} + u = 0 and a sign structure the reference's
    single [-50,50] bisection can silently miss (losing the root and
    returning an infeasible point).  We instead (a) grid-scan each side of
    the (unique) pole on a cancellation-free reformulation of F and bisect
    EVERY sign-change bracket (F can have several roots per branch; only
    the λ ≥ 0 one is the projection), and (b) select the final answer as
    the closest **valid** candidate among {v if in-cone, the ray point, 0,
    the boundary points from the roots} — the projection is unique, so
    feasible-nearest is exact whenever the candidate set contains it, and
    never returns an infeasible point.  Fully vectorized over the batch.
    """
    dt = v.dtype
    f32 = dt == jnp.float32
    tol = jnp.asarray(1e-6 if f32 else 1e-8, dt)
    U = 22.0 if f32 else 50.0

    r, s, t = v[..., 0], v[..., 1], v[..., 2]

    def safe_exp(x):
        return jnp.exp(jnp.clip(x, -3 * U, 3 * U))

    # The KKT residual
    #   F(u) = s e^u − t − λ(u)(1 + e^{2u}(1−u)),  λ(u) = (r e^u − u t)/(e^{2u}+u)
    # has a pole where e^{2u}+u = 0 (u_pole ≈ −0.42630275; the denominator is
    # strictly increasing so the pole is unique), and evaluating it directly
    # at large |u| suffers catastrophic cancellation (−t against +λ·1).
    # Clearing the denominator, the ±ut terms cancel *symbolically*:
    #   F(u) = e^u · G(u) / (e^{2u} + u),
    #   G(u) = e^{2u}(s − r(1−u)) + u(s + t e^u(1−u)) − t e^u − r
    # so sign(F) = sign(G)·sign(e^{2u}+u) with no cancellation at either end.
    u_pole = -0.4263027510068963
    eps = 1e-6 if f32 else 1e-9

    def sign_F(u):
        w = safe_exp(u)
        w2 = w * w
        G = w2 * (s - r * (1.0 - u)) + u * (s + t * w * (1.0 - u)) - t * w - r
        return jnp.sign(G) * jnp.sign(w2 + u)

    def bisect(lo, hi):
        slo = sign_F(lo)
        for _ in range(bisect_iters):
            mid = 0.5 * (lo + hi)
            go_right = sign_F(mid) == slo
            lo = jnp.where(go_right, mid, lo)
            hi = jnp.where(go_right, hi, mid)
        return 0.5 * (lo + hi)

    # G can have SEVERAL roots per branch, and only the KKT-valid one
    # (λ(u) ≥ 0) is the projection: a single whole-branch bisection can
    # converge to an invalid root while missing the valid one, producing
    # a feasible-but-suboptimal "projection" (observed on ~1% of random
    # points; SLSQP-verified).  Scan each branch on a fixed grid, bisect
    # EVERY sign-change bracket (up to _N_KEEP per branch), and let the
    # λ ≥ 0 filter in gen_candidate discard invalid roots.
    N_GRID, N_KEEP = 65, 3

    def branch_roots(lo0, hi0):
        us = jnp.linspace(jnp.asarray(lo0, dt), jnp.asarray(hi0, dt), N_GRID)
        sg = sign_F(us.reshape((N_GRID,) + (1,) * r.ndim))
        flip = sg[:-1] * sg[1:] <= 0
        rank = jnp.cumsum(flip, axis=0)
        roots = []
        for j in range(1, N_KEEP + 1):
            sel = flip & (rank == j)
            has = jnp.any(sel, axis=0)
            idx = jnp.argmax(sel, axis=0)
            u_root = bisect(us[idx], us[idx + 1])
            roots.append((u_root, has))
        return roots

    def gen_candidate(u, bracketed):
        """Exact boundary point from a root u; valid iff the bracket is
        real, z > 0, and the KKT multiplier is nonnegative.

        Uses the cancellation-free identities
            λ(u)  = (r w − u t)/(w² + u) = −t + w (r + t w)/(w² + u)
            z*    = t + λ = w (r + t w)/(w² + u)
            y*    = z*/w  =    (r + t w)/(w² + u)
        so z*, y* stay accurate as w → 0 (projections near the z = 0 edge,
        where the t + λ form loses ~6 digits to cancellation)."""
        w = safe_exp(u)
        denom = w * w + u
        denom = jnp.where(jnp.abs(denom) < 1e-30, jnp.asarray(1e-30, dt), denom)
        num = (r + t * w) / denom
        z_star = w * num
        y_star = num
        x_star = u * num
        lam_raw = z_star - t
        feas = bracketed & (z_star > 0) & (lam_raw >= -tol * (1.0 + jnp.abs(t)))
        return jnp.stack([x_star, y_star, z_star], axis=-1), feas

    gens = [gen_candidate(u, has)
            for u, has in (branch_roots(-U, u_pole - eps)
                           + branch_roots(u_pole + eps, U))]

    ray = jnp.stack(
        [jnp.minimum(r, 0.0), jnp.zeros_like(s), jnp.maximum(t, 0.0)], axis=-1
    )
    zero = jnp.zeros_like(v)

    spos = jnp.maximum(s, jnp.asarray(jnp.finfo(dt).tiny, dt))
    v_in_cone = ((s > tol) & (spos * safe_exp(r / spos) <= t + tol)) | (
        (jnp.abs(s) <= tol) & (r <= tol) & (t >= -tol)
    )

    def dist2(c):
        return jnp.sum((c - v) ** 2, axis=-1)

    INF = jnp.asarray(jnp.finfo(dt).max, dt)
    cands = jnp.stack([v, ray, zero] + [g for g, _ in gens], axis=-2)
    d2 = jnp.stack(
        [
            jnp.where(v_in_cone, dist2(v), INF),
            dist2(ray),
            dist2(zero),
        ]
        + [jnp.where(feas, dist2(g), INF) for g, feas in gens],
        axis=-1,
    )
    best = jnp.argmin(d2, axis=-1)
    return jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]


def _exp_primal_tangent(v, p, dv):
    """Generalized-Jacobian action dΠ_K(v)[dv] at p = Π_K(v), case-wise:

    1. v in the cone:            dΠ = I
    2. v in the polar cone:      dΠ = 0   (p = 0)
    3. p on the ray face
       {(x,0,z): x ≤ 0, z ≥ 0}: dΠ = diag(1{r<0}, 0, 1{t>0})
    4. p on the smooth boundary (y > 0, φ(p) = y e^{x/y} − z = 0,
       v − p = λ∇φ(p), λ > 0): implicit differentiation of the KKT
       system  [p + λ∇φ(p) − v; φ(p)] = 0  in (p, λ) — one batched
       4×4 solve:

           [[I + λ∇²φ, ∇φ], [∇φᵀ, 0]] [dp; dλ] = [dv; 0]

       with ∇φ = (w, w(1−u), −1), ∇²φ = (w/y)[[1,−u,0],[−u,u²,0],[0,0,0]],
       u = x/y, w = e^u.

    Case boundaries are measure-zero; any selection there is a valid
    element of the generalized Jacobian.
    """
    dt = v.dtype
    f32 = dt == jnp.float32
    tol = 1e-5 if f32 else 1e-9
    r, t = v[..., 0], v[..., 2]
    y = p[..., 1]
    sc = 1.0 + jnp.linalg.norm(v, axis=-1)
    in_cone = jnp.linalg.norm(p - v, axis=-1) <= tol * sc
    in_polar = jnp.linalg.norm(p, axis=-1) <= tol * sc
    on_ray = y <= tol * sc
    generic = ~(in_cone | in_polar | on_ray)

    # --- case 4: batched 4x4 implicit solve (guarded where not generic) ---
    y_safe = jnp.where(generic, jnp.maximum(y, tol), 1.0)
    x_g = jnp.where(generic, p[..., 0], 0.0)
    u = x_g / y_safe
    w = jnp.exp(jnp.clip(u, -50.0, 50.0))
    one = jnp.ones_like(w)
    g = jnp.stack([w, w * (1.0 - u), -one], axis=-1)
    lam = jnp.sum((v - p) * g, axis=-1) / jnp.sum(g * g, axis=-1)
    lam = jnp.where(generic, jnp.maximum(lam, 0.0), 0.0)
    coef = lam * w / y_safe
    zero = jnp.zeros_like(w)
    H = jnp.stack([
        jnp.stack([coef, -coef * u, zero], axis=-1),
        jnp.stack([-coef * u, coef * u * u, zero], axis=-1),
        jnp.stack([zero, zero, zero], axis=-1),
    ], axis=-2)
    eye3 = jnp.eye(3, dtype=dt)
    M = jnp.zeros(v.shape[:-1] + (4, 4), dt)
    M = M.at[..., :3, :3].set(eye3 + H)
    M = M.at[..., :3, 3].set(g)
    M = M.at[..., 3, :3].set(g)
    M = jnp.where(generic[..., None, None], M, jnp.eye(4, dtype=dt))
    rhs = jnp.concatenate([dv, jnp.zeros_like(dv[..., :1])], axis=-1)
    dp_gen = jnp.linalg.solve(M, rhs[..., None])[..., :3, 0]

    dp_ray = jnp.stack([
        jnp.where(r < 0, dv[..., 0], 0.0),
        jnp.zeros_like(dv[..., 1]),
        jnp.where(t > 0, dv[..., 2], 0.0),
    ], axis=-1)

    return jnp.where(
        in_cone[..., None], dv,
        jnp.where(in_polar[..., None], jnp.zeros_like(dv),
                  jnp.where(on_ray[..., None], dp_ray, dp_gen)))


@partial(jax.custom_jvp, nondiff_argnums=(1,))
def project_exp_primal(v, bisect_iters: int = 50):
    """`_project_exp_primal_impl` with an implicit-differentiation JVP:
    the unrolled bisection's own autodiff tangent is structurally zero at
    the root (the lo/hi selects are piecewise-constant), so the custom
    rule differentiates the projection's KKT system instead
    (`_exp_primal_tangent`) — making exp cones first-class in
    `diff_cone_solve` and anywhere else `ConeSet.project` is
    differentiated."""
    return _project_exp_primal_impl(v, bisect_iters)


@project_exp_primal.defjvp
def _project_exp_primal_jvp(bisect_iters, primals, tangents):
    (v,), (dv,) = primals, tangents
    p = _project_exp_primal_impl(v, bisect_iters)
    return p, _exp_primal_tangent(v, p, dv)


def project_exp_dual(v, bisect_iters: int = 80):
    """Project onto the dual exponential cone via Moreau decomposition:
    Π_{K*}(v) = v + Π_K(−v)  (prox_lib_cone.h:282-294)."""
    return v + project_exp_primal(-v, bisect_iters)
