"""Value-parity fuzz against the ACTUAL reference binary (libpogs_cpu).

VERDICT round-1 item 2: every cross-check so far was against this repo's
own native twin or analytic oracles; this tier builds the upstream
reference out-of-source (benchmarks/reference_oracle.py) and fuzzes value
agreement between the JAX solver and the reference C ABI:

  * dense graph form  (PogsD          vs GraphFormSolver)  — 4 families
  * sparse graph form (PogsSparseD    vs the BCOO/CGLS path)
  * cone LP, Kx path  (PogsConeD      vs ConeSolver graph-ADMM branch)
  * cone LP, HSDE     (PogsConeD      vs ConeSolver HSDE branch,
                        known-optimum complementary-slackness construction)
  * dense QP          (PogsConeQD / PogsConeDirectQD vs the QP path)

Agreement criterion: objective values within the solvers' own tolerance
band.  Both run at abs 1e-4 / rel 1e-4 (the benchmark defaults), which
certifies ~3 digits; we assert rel 5e-3.  Where an analytic optimum exists
(complementary-slackness LPs) both solvers are additionally checked
against it.  ≥32 fuzz seeds total, with FIXED shapes per family so the
jitted JAX solver compiles once per (shape, h-pattern) key.

Skipped automatically when the reference source tree / toolchain is not
present (e.g. end-user installs).
"""

import numpy as np
import pytest

from benchmarks import reference_oracle as ref

pytestmark = pytest.mark.skipif(
    not ref.available(), reason="reference libpogs_cpu not buildable here"
)

from pogs_tpu.api.graph import solve_graph_form  # noqa: E402
from pogs_tpu.api.cone import solve_cone  # noqa: E402
from pogs_tpu.types import Cone, ConeConstraint, Function, FunctionVector  # noqa: E402

TOL = dict(abs_tol=1e-4, rel_tol=1e-4, max_iter=4000)
# The reference cone paths (HSDE + exact-tol ADMM) need their native
# rel_tol=1e-3 (pogs.h:22) and more headroom to converge on random LPs.
REF_CONE_TOL = dict(abs_tol=1e-4, rel_tol=1e-3, max_iter=20000)


def _agree(a: float, b: float, rel: float = 5e-3, abs_: float = 2e-3):
    scale = max(abs(a), abs(b), 1.0)
    assert abs(a - b) <= abs_ + rel * scale, f"optval mismatch: {a} vs {b}"


def _run_graph(A, f, g):
    r_ref = ref.ref_solve_graph(A, f, g, **TOL)
    r_jax = solve_graph_form(A, f, g, dtype=np.float64, gap_stop=False, **TOL)
    assert r_ref["status"] == 0, f"reference failed: {r_ref['status']}"
    assert r_jax["status"] == 0, f"JAX solver failed: {r_jax['status']}"
    _agree(r_ref["optval"], r_jax["optval"])
    return r_ref, r_jax


# ---------------------------------------------------------------- graph form

SHAPES = [(60, 30), (30, 60)]  # tall and wide — two jit keys per family


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", range(5))
def test_parity_lasso(shape, seed):
    rng = np.random.default_rng(1000 + seed)
    m, n = shape
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    lam = 0.2 * np.max(np.abs(A.T @ b))
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=np.float64)
    g = FunctionVector(Function.ABS, n, c=lam, dtype=np.float64)
    _run_graph(A, f, g)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", range(4))
def test_parity_ridge(shape, seed):
    rng = np.random.default_rng(2000 + seed)
    m, n = shape
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=np.float64)
    g = FunctionVector(Function.SQUARE, n, c=0.5 + rng.random(), dtype=np.float64)
    _run_graph(A, f, g)


@pytest.mark.parametrize("seed", range(4))
def test_parity_nonneg_ls(seed):
    rng = np.random.default_rng(3000 + seed)
    m, n = 60, 30
    A = np.abs(rng.standard_normal((m, n)))
    b = A @ np.abs(rng.standard_normal(n)) + 0.1 * rng.standard_normal(m)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=np.float64)
    g = FunctionVector(Function.INDGE0, n, dtype=np.float64)
    _run_graph(A, f, g)


@pytest.mark.parametrize("seed", range(5))
def test_parity_mixed_objective(seed):
    """Random per-coordinate (a,b,c,d,e) over a fixed mixed h-pattern —
    exercises the generic prox transform on both sides."""
    rng = np.random.default_rng(4000 + seed)
    m, n = 60, 30
    # Fixed h patterns (jit key) — params vary per seed.
    hf = np.array([int(Function.SQUARE)] * 40 + [int(Function.HUBER)] * 20,
                  dtype=np.int32)
    hg = np.array([int(Function.ABS)] * 15 + [int(Function.SQUARE)] * 15,
                  dtype=np.int32)
    A = rng.standard_normal((m, n))
    f = FunctionVector(hf, a=1.0 + 0.5 * rng.random(m),
                       b=rng.standard_normal(m),
                       c=0.5 + rng.random(m), d=0.1 * rng.standard_normal(m),
                       e=0.0, dtype=np.float64)
    g = FunctionVector(hg, a=1.0, b=0.0, c=0.3 + rng.random(n),
                       d=0.0, e=0.1 * rng.random(n), dtype=np.float64)
    _run_graph(A, f, g)


@pytest.mark.parametrize("seed", range(4))
def test_parity_sparse_lasso(seed):
    scipy_sparse = pytest.importorskip("scipy.sparse")
    rng = np.random.default_rng(5000 + seed)
    m, n = 80, 40
    A = scipy_sparse.random(m, n, density=0.3, random_state=int(seed),
                            format="csr", dtype=np.float64)
    A = A + scipy_sparse.eye(m, n, format="csr") * 0.5  # ensure nonempty rows
    b = rng.standard_normal(m)
    lam = 0.2 * np.max(np.abs(A.T @ b))
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=np.float64)
    g = FunctionVector(Function.ABS, n, c=lam, dtype=np.float64)
    _run_graph(A, f, g)


# ----------------------------------------------------------------- cone form


def _lp_known_optimum(rng, m, n):
    """Inequality LP with analytically-known optimum via KKT construction.

    For min cᵀx s.t. Ax ≤ b (x free), stationarity of the Lagrangian
    c + Aᵀy = 0 requires c = −Aᵀy* with y* ≥ 0; complementary slackness
    y*ᵢ(b − Ax*)ᵢ = 0 holds by choosing an active set of exactly n rows
    (y* > 0 there, slack s* > 0 elsewhere).  Then x* is optimal and
    optval = cᵀx*."""
    A = rng.standard_normal((m, n))
    xstar = rng.standard_normal(n)
    act = rng.permutation(m)[:n]
    mask = np.zeros(m, dtype=bool)
    mask[act] = True
    ystar = np.where(mask, np.abs(rng.standard_normal(m)) + 0.5, 0.0)
    sstar = np.where(mask, 0.0, np.abs(rng.standard_normal(m)) + 0.5)
    b = A @ xstar + sstar
    c = -(A.T @ ystar)
    return A, b, c, float(c @ xstar)


@pytest.mark.parametrize("seed", range(5))
def test_parity_cone_lp_hsde(seed):
    """Kx empty → both solvers take their HSDE branch; optimum is known.

    At matched tolerances the two HSDE implementations are
    trajectory-equivalent: seed 6000 converges in exactly the same number
    of iterations on both sides (1040), so we additionally pin the
    iteration counts to within 20%.  polish=False pins the BASE DR
    trajectory — with the round-3 IPM polish on, pogs_tpu finishes in a
    fraction of the reference's iterations (a deliberate divergence,
    covered by test_fuzz.py::test_polish_tail_convergence_lp_ineq)."""
    rng = np.random.default_rng(6000 + seed)
    m, n = 50, 25
    A, b, c, opt = _lp_known_optimum(rng, m, n)
    Ky = [ConeConstraint(Cone.NON_NEG, np.arange(m))]
    r_ref = ref.ref_solve_cone(A, b, c, Kx=[], Ky=Ky, **REF_CONE_TOL)
    r_jax = solve_cone(A, b, c, Kx=(), Ky=Ky, dtype=np.float64,
                       polish=False, **REF_CONE_TOL)
    assert r_ref["status"] == 0
    assert r_jax["status"] == 0
    _agree(r_ref["optval"], opt, rel=1e-2, abs_=1e-2)
    _agree(r_jax["optval"], opt, rel=1e-2, abs_=1e-2)
    _agree(r_ref["optval"], r_jax["optval"])
    assert abs(r_ref["iterations"] - r_jax["iterations"]) <= \
        0.2 * max(r_ref["iterations"], r_jax["iterations"])


@pytest.mark.parametrize("seed", range(4))
def test_parity_cone_lp_kx_path(seed):
    """Kx non-empty → the graph-ADMM cone branch on both sides.
    Standard-form LP: min cᵀx s.t. Ax = b, x ≥ 0 (feasible bounded by
    dual-feasible construction).

    Parity-in-failure-mode: on these LPs BOTH implementations usually
    exhaust max_iter under the exact-tolerance stopping rule while the
    iterate value is already within ~0.5% of optimal (the reference fails
    3 of 4 seeds here exactly like the JAX solver).  So the oracle is
    HiGHS: both returned values must be within 1% of the true optimum,
    and the two solvers must agree with each other."""
    linprog = pytest.importorskip("scipy.optimize").linprog
    rng = np.random.default_rng(7000 + seed)
    m, n = 25, 50
    A = rng.standard_normal((m, n))
    x0 = np.abs(rng.standard_normal(n)) + 0.1
    b = A @ x0
    c = A.T @ rng.standard_normal(m) + np.abs(rng.standard_normal(n)) + 0.1
    opt = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs").fun
    Kx = [ConeConstraint(Cone.NON_NEG, np.arange(n))]
    Ky = [ConeConstraint(Cone.ZERO, np.arange(m))]
    r_ref = ref.ref_solve_cone(A, b, c, Kx=Kx, Ky=Ky, **REF_CONE_TOL)
    r_jax = solve_cone(A, b, c, Kx=Kx, Ky=Ky, dtype=np.float64,
                       abs_tol=1e-4, rel_tol=1e-3, max_iter=20000)
    _agree(r_ref["optval"], opt, rel=1e-2, abs_=1e-2)
    _agree(r_jax["optval"], opt, rel=1e-2, abs_=1e-2)
    _agree(r_ref["optval"], r_jax["optval"], rel=1e-2, abs_=1e-2)


@pytest.mark.parametrize("direct", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_parity_qp(direct, seed):
    """Dense QP: min ½xᵀPx + cᵀx s.t. b − Ax ≥ 0, with a KKT-constructed
    known optimum (stationarity: c = −Px* − Aᵀy*, y* ≥ 0 complementary).

    Upstream limitation pinned here: the reference's ``PogsConeQD`` /
    ``PogsConeDirectQD`` with empty Kx route to HSDE, which its own code
    declares broken for QP ("the optimal solution is not a fixed point of
    the HSDE iteration ... users should use OSQP, SCS, or CLARABEL
    instead", reference ``src/cpu/pogs.cpp:1510-1514``).  The JAX solver's
    QP-extended embedding DOES solve these problems — we assert our value
    against the analytic optimum, and compare with the reference only if
    upstream ever starts converging."""
    rng = np.random.default_rng(8000 + seed)
    m, n = 40, 20
    A = rng.standard_normal((m, n))
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + 0.5 * np.eye(n)
    xstar = rng.standard_normal(n)
    act = rng.permutation(m)[: n // 2]
    mask = np.zeros(m, dtype=bool)
    mask[act] = True
    ystar = np.where(mask, np.abs(rng.standard_normal(m)) + 0.5, 0.0)
    sstar = np.where(mask, 0.0, np.abs(rng.standard_normal(m)) + 0.5)
    b = A @ xstar + sstar
    c = -(P @ xstar) - A.T @ ystar
    opt = float(0.5 * xstar @ P @ xstar + c @ xstar)
    Ky = [ConeConstraint(Cone.NON_NEG, np.arange(m))]
    r_ref = ref.ref_solve_cone(A, b, c, Kx=[], Ky=Ky, P=P, direct=direct,
                               **REF_CONE_TOL)
    r_jax = solve_cone(A, b, c, Kx=(), Ky=Ky, P=P, dtype=np.float64,
                       abs_tol=1e-4, rel_tol=1e-4, max_iter=20000)
    assert r_jax["status"] == 0
    _agree(r_jax["optval"], opt, rel=1e-2, abs_=1e-2)
    if r_ref["status"] == 0:  # upstream QP-HSDE fixed? then require parity
        _agree(r_ref["optval"], r_jax["optval"], rel=1e-2, abs_=1e-2)


def test_elastic_net_compat_pin():
    """Pin the documented elastic-net deviation (migration guide).

    The reference's solve_elastic_net encodes e = λ₂/2, so it penalizes
    (λ₂/4)‖x‖² — a bug vs its own docstring.  pogs_tpu encodes e = λ₂
    (the documented objective).  Pin BOTH: (a) feeding the reference's
    exact arrays to both solvers gives the same optimum (the solvers
    agree — the deviation is in the ENCODING, not the math); (b) calling
    pogs_tpu with λ₂/2 reproduces the reference's builder behavior, and
    with λ₂ it yields a lower value of the documented objective."""
    from pogs_tpu.api.graph import solve_elastic_net

    rng = np.random.default_rng(4242)
    m, n = 60, 30
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    lam1, lam2 = 0.3, 0.8

    # (a) identical FunctionObj arrays → identical solves.
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=np.float64)
    g_ref_encoding = FunctionVector(Function.ABS, n, c=lam1, e=lam2 / 2,
                                    dtype=np.float64)
    r_ref = ref.ref_solve_graph(A, f, g_ref_encoding, **TOL)
    r_jax_same = solve_graph_form(A, f, g_ref_encoding, dtype=np.float64,
                                  gap_stop=False, **TOL)
    assert r_ref["status"] == 0 and r_jax_same["status"] == 0
    _agree(r_ref["optval"], r_jax_same["optval"])

    # (b) builder behaviors.
    def documented_obj(x):
        r = A @ x - b
        return (0.5 * r @ r + lam1 * np.abs(x).sum()
                + 0.5 * lam2 * float(x @ x))

    mine = solve_elastic_net(A, b, lam1, lam2, dtype=np.float64,
                             gap_stop=False, **TOL)
    compat = solve_elastic_net(A, b, lam1, lam2 / 2, dtype=np.float64,
                               gap_stop=False, **TOL)
    # compat call == reference builder output (same optimizer).
    np.testing.assert_allclose(compat["x"], r_ref["x"], atol=5e-3)
    # our builder minimizes the documented objective better than the
    # reference's encoding does.
    assert documented_obj(np.asarray(mine["x"])) <= \
        documented_obj(np.asarray(r_ref["x"])) + 1e-6


@pytest.mark.parametrize("seed", range(4))
def test_parity_socp_ball(seed):
    """SOCP with analytic optimum: min cᵀx s.t. ‖x − x₀‖ ≤ r
    (b − Ax = [r; x − x₀] ∈ SOC with A = [0; −I], b = [r; −x₀])
    ⇒ x* = x₀ − r·c/‖c‖, optval = cᵀx₀ − r‖c‖.  Kx empty → both
    solvers take their HSDE branch."""
    rng = np.random.default_rng(9000 + seed)
    n = 20
    x0 = rng.standard_normal(n)
    c = rng.standard_normal(n)
    r = 1.0 + rng.random()
    A = np.vstack([np.zeros((1, n)), -np.eye(n)])
    b = np.concatenate([[r], -x0])
    opt = float(c @ x0 - r * np.linalg.norm(c))
    Ky = [ConeConstraint(Cone.SOC, np.arange(n + 1))]
    r_ref = ref.ref_solve_cone(A, b, c, Kx=[], Ky=Ky, **REF_CONE_TOL)
    r_jax = solve_cone(A, b, c, Kx=(), Ky=Ky, dtype=np.float64,
                       **REF_CONE_TOL)
    assert r_ref["status"] == 0
    assert r_jax["status"] == 0
    _agree(r_ref["optval"], opt, rel=1e-2, abs_=1e-2)
    _agree(r_jax["optval"], opt, rel=1e-2, abs_=1e-2)
    _agree(r_ref["optval"], r_jax["optval"], rel=1e-2, abs_=1e-2)


def test_parity_exp_cone():
    """Exp-cone LP: max r s.t. (r, 1, e) ∈ K_exp ⇒ r* = 1 — both
    solvers through their HSDE branch with the exponential projection."""
    e_const = float(np.e)
    A = np.array([[-1.0], [0.0], [0.0]])
    b = np.array([0.0, 1.0, e_const])
    c = np.array([-1.0])
    Ky = [ConeConstraint(Cone.EXP_PRIMAL, [0, 1, 2])]
    r_ref = ref.ref_solve_cone(A, b, c, Kx=[], Ky=Ky, **REF_CONE_TOL)
    r_jax = solve_cone(A, b, c, Kx=(), Ky=Ky, dtype=np.float64,
                       **REF_CONE_TOL)
    assert r_jax["status"] == 0
    _agree(r_jax["optval"], -1.0, rel=1e-2, abs_=1e-2)
    if r_ref["status"] == 0:
        _agree(r_ref["optval"], r_jax["optval"], rel=1e-2, abs_=1e-2)


@pytest.mark.parametrize("seed", range(3))
def test_parity_native_runtime_vs_reference(seed):
    """Triangle closure: the repo's own native C++ runtime vs the actual
    reference binary (both host CPU, no accelerator in the loop)."""
    from pogs_tpu import native as nat

    if not nat.is_available():
        pytest.skip("native runtime not built")
    rng = np.random.default_rng(11000 + seed)
    m, n = 60, 30
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    lam = 0.2 * np.max(np.abs(A.T @ b))
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=np.float64)
    g = FunctionVector(Function.ABS, n, c=lam, dtype=np.float64)
    r_ref = ref.ref_solve_graph(A, f, g, **TOL)
    r_nat = nat.solve_graph_native(A, f, g, abs_tol=1e-4, rel_tol=1e-4,
                                   max_iter=4000)
    assert r_ref["status"] == 0
    assert int(r_nat["status"]) == 0
    _agree(r_ref["optval"], r_nat["optval"])


def test_parity_infeasible_certificate():
    """Both solvers must flag primal infeasibility (status 1) on an LP
    with contradictory rows: x ≤ -1 and x ≥ 1 (enum values ABI-matched)."""
    A = np.array([[1.0], [-1.0]])
    b = np.array([-1.0, -1.0])  # x <= -1  and  -x <= -1
    c = np.array([1.0])
    Ky = [ConeConstraint(Cone.NON_NEG, [0, 1])]
    r_ref = ref.ref_solve_cone(A, b, c, Kx=[], Ky=Ky, **REF_CONE_TOL)
    r_jax = solve_cone(A, b, c, Kx=(), Ky=Ky, dtype=np.float64,
                       **REF_CONE_TOL)
    assert r_jax["status"] == 1, r_jax["status_name"]
    assert r_ref["status"] == 1


def test_parity_unbounded_certificate():
    """Unboundedness detection: min -x s.t. x ≥ 0.

    The JAX solver must certify UNBOUNDED (status 2).  Upstream behavior
    pinned: the reference's HSDE misses this trivial certificate and
    exhausts max_iter (its τ→0 test at pogs.cpp:1826 checks ‖Ax̂‖ = 0,
    which only holds when every row is a Zero cone — the recession-cone
    fix in hsde.py handles NonNeg rows).  Whatever it returns, it must
    not claim SUCCESS."""
    A = np.array([[-1.0]])
    b = np.array([0.0])  # -(-x) = x >= 0
    c = np.array([-1.0])
    Ky = [ConeConstraint(Cone.NON_NEG, [0])]
    r_ref = ref.ref_solve_cone(A, b, c, Kx=[], Ky=Ky, **REF_CONE_TOL)
    r_jax = solve_cone(A, b, c, Kx=(), Ky=Ky, dtype=np.float64,
                       **REF_CONE_TOL)
    assert r_jax["status"] == 2, r_jax["status_name"]
    assert r_ref["status"] != 0  # upstream: MAX_ITER today, UNBOUNDED if fixed
