"""Mesh-sharded execution tests (8-device virtual CPU mesh).

SURVEY.md §5.8: the distributed capability is row-sharding A over a
``jax.sharding.Mesh`` and letting GSPMD insert the collectives.  These
tests verify the sharded solve produces the SAME results as the
single-device solve — collectives change the schedule, not the math —
and that the mesh helpers place data as advertised.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from pogs_tpu.types import Function, FunctionVector, SolverSettings, Status
from pogs_tpu.parallel.mesh import make_mesh, shard_matrix, replicate, pad_rows_to
from pogs_tpu.parallel.batch import solve_lasso_path


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh((8,), ("rows",))


@pytest.fixture(scope="module")
def mesh24():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh((2, 4), ("batch", "rows"))


def _problem(m, n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    lam = 0.2 * float(np.max(np.abs(A.T @ b)))
    return A, b, lam


def test_mesh_helpers_place_data(mesh8):
    A = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    A_sh = shard_matrix(A, mesh8)
    assert A_sh.sharding.spec == P("rows", None)
    assert len(A_sh.sharding.device_set) == 8
    x = replicate(np.ones(4, np.float32), mesh8)
    assert x.sharding.spec == P()
    np.testing.assert_array_equal(np.asarray(A_sh), A)


def test_pad_rows_to():
    A = np.ones((10, 3))
    b = np.ones(10)
    A_p, b_p, m0 = pad_rows_to(A, b, 8)
    assert A_p.shape == (16, 3) and b_p.shape == (16,) and m0 == 10
    assert np.all(A_p[10:] == 0) and np.all(b_p[10:] == 0)


def test_row_sharded_solve_matches_single_device(mesh8):
    """Full solve with A row-sharded == unsharded solve (same compile-time
    semantics, different schedule)."""
    from pogs_tpu.solver.graph import GraphFormSolver

    m, n = 64, 24
    A, b, lam = _problem(m, n, seed=1)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=jnp.float32)
    g = FunctionVector(Function.ABS, n, c=lam, dtype=jnp.float32)
    st = SolverSettings(abs_tol=1e-5, rel_tol=1e-5)

    res_ref = GraphFormSolver(A, dtype=jnp.float32, settings=st).solve(f, g)

    A_sh = shard_matrix(jnp.asarray(A), mesh8)
    res_sh = GraphFormSolver(A_sh, dtype=jnp.float32, settings=st).solve(f, g)

    assert res_ref.status == Status.SUCCESS
    assert res_sh.status == Status.SUCCESS
    assert int(res_sh.final_iter) == int(res_ref.final_iter)
    np.testing.assert_allclose(
        np.asarray(res_sh.x), np.asarray(res_ref.x), atol=5e-4
    )


def test_batched_path_on_2d_mesh(mesh24):
    """λ-path batch sharded over 'batch', A row-sharded over 'rows'."""
    m, n, K = 32, 12, 8
    A, b, _ = _problem(m, n, seed=2)
    lambdas = np.linspace(0.5, 0.1, K).astype(np.float32)

    out_ref = solve_lasso_path(A, b, lambdas)
    out_sh = solve_lasso_path(A, b, lambdas, mesh=mesh24)

    assert bool(jnp.all(out_ref["status"] == 0))
    assert bool(jnp.all(out_sh["status"] == 0))
    np.testing.assert_allclose(
        np.asarray(out_sh["x"]), np.asarray(out_ref["x"]), atol=5e-4
    )
    np.testing.assert_allclose(
        np.asarray(out_sh["optval"]), np.asarray(out_ref["optval"]),
        rtol=1e-4,
    )


def test_sharded_equilibration_and_norm(mesh8):
    """Init-time pieces (Sinkhorn, power method, Gram) under row sharding."""
    from pogs_tpu.linalg.equil import equilibrate
    from pogs_tpu.linalg.norm import norm2_est

    m, n = 64, 16
    A, _, _ = _problem(m, n, seed=3)

    @jax.jit
    def init(A):
        eq = equilibrate(A)
        return eq.A, eq.d, eq.e, norm2_est(eq.A)

    Ar, dr, er, nr = init(jnp.asarray(A))
    A_sh = shard_matrix(jnp.asarray(A), mesh8)
    As, ds, es, ns = init(A_sh)
    np.testing.assert_allclose(np.asarray(ds), np.asarray(dr), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(es), np.asarray(er), rtol=1e-5)
    assert float(ns) == pytest.approx(float(nr), rel=1e-4)


def test_explicit_shard_map_matvec(mesh8):
    """The manual collective plan: local gemv + psum for Aᵀy."""
    from jax import shard_map

    m, n = 64, 16
    A, b, _ = _problem(m, n, seed=4)
    A_dev = jax.device_put(jnp.asarray(A), NamedSharding(mesh8, P("rows", None)))
    y_dev = jax.device_put(jnp.asarray(b), NamedSharding(mesh8, P("rows")))

    def local_rmv(A_blk, y_blk):
        return jax.lax.psum(A_blk.T @ y_blk, "rows")

    rmv = shard_map(local_rmv, mesh=mesh8,
                    in_specs=(P("rows", None), P("rows")), out_specs=P())
    out = jax.jit(rmv)(A_dev, y_dev)
    np.testing.assert_allclose(np.asarray(out), A.T @ b, rtol=2e-4)


def test_row_sharded_cone_solve(mesh8):
    """Cone LP/SOCP with row-sharded A (BASELINE config 5 structure):
    HSDE with the SMW linear solve under GSPMD sharding."""
    from pogs_tpu.types import Cone, ConeConstraint
    from pogs_tpu.solver.cone import ConeSolver
    from pogs_tpu.types import SolverSettings

    rng = np.random.default_rng(9)
    n = 15  # SOC ball over n+1 = 16 rows: divides the 8-way mesh evenly
    x0 = rng.standard_normal(n).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    r = 1.5
    A_full = np.vstack([np.zeros((1, n)), -np.eye(n)]).astype(np.float32)
    b = np.concatenate([[r], -x0]).astype(np.float32)
    Ky = [ConeConstraint(Cone.SOC, range(n + 1))]
    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6)

    res_ref = ConeSolver(A_full, Ky=Ky, settings=st).solve(b, c)

    A_sh = shard_matrix(jnp.asarray(A_full), mesh8)
    res_sh = ConeSolver(A_sh, Ky=Ky, settings=st).solve(b, c)

    expect = float(c @ x0 - r * np.linalg.norm(c))
    assert res_ref.status == Status.SUCCESS
    assert res_sh.status == Status.SUCCESS
    assert float(res_sh.optval) == pytest.approx(expect, rel=1e-3, abs=1e-3)
    assert float(res_sh.optval) == pytest.approx(float(res_ref.optval),
                                                 rel=1e-4, abs=1e-4)


def test_row_sharded_cone_solve_dryrun_config(mesh24):
    """Regression for the round-4 red multichip gate: the dryrun's EXACT
    config — a 64-row SOC ball (nc=63) row-sharded on the (2,4) mesh at
    abs/rel 1e-5 in f32.  The SOC radius row is all-zero in A, so the
    effective-count Sinkhorn (equil.py) leaves the problem with an
    objective magnitude ~|c'x| >> 1; the reference's absolute gap test
    eps_gap = abs + rel*max(1, gap) (pogs.cpp:1767) then demands more
    significant digits than the f32 iterate floor provides and the solve
    stalls at MAX_ITER.  The scale-invariant gap criterion
    (hsde.py::hsde_solve, SCS convention) must converge this well under
    100 iterations, matching the closed-form optimum."""
    from pogs_tpu.types import Cone, ConeConstraint
    from pogs_tpu.solver.cone import ConeSolver

    rng = np.random.default_rng(0)
    # Mirror of __graft_entry__.dryrun_multichip: rows=4 → nc = 2*4*8-1.
    nc = 63
    # The dryrun draws from the same generator stream; seeds differ but the
    # structure (standard normal x0/c, radius 1.5) is identical.
    x0 = rng.standard_normal(nc).astype(np.float32)
    c = rng.standard_normal(nc).astype(np.float32)
    r = 1.5
    A_soc = np.vstack([np.zeros((1, nc)), -np.eye(nc)]).astype(np.float32)
    b = np.concatenate([[r], -x0]).astype(np.float32)
    A_sh = jax.device_put(jnp.asarray(A_soc),
                          NamedSharding(mesh24, P("rows", None)))
    st = SolverSettings(abs_tol=1e-5, rel_tol=1e-5)
    res = ConeSolver(A_sh, Ky=[ConeConstraint(Cone.SOC, range(nc + 1))],
                     settings=st).solve(b, c)

    expect = float(c @ x0 - r * np.linalg.norm(c))
    assert res.status == Status.SUCCESS, f"dryrun-config SOC: {res.status}"
    assert int(res.final_iter) < 200
    assert float(res.optval) == pytest.approx(expect, rel=1e-4, abs=1e-4)


def test_batched_cone_solve_matches_single():
    """Scenario batch of SOC projections problems: vmapped HSDE == per-
    problem solves."""
    from pogs_tpu.parallel.batch import batched_cone_solve
    from pogs_tpu.types import Cone, ConeConstraint

    rng = np.random.default_rng(12)
    n, K = 7, 5
    c = rng.standard_normal(n).astype(np.float32)
    A = np.vstack([np.zeros((1, n)), -np.eye(n)]).astype(np.float32)
    Ky = [ConeConstraint(Cone.SOC, range(n + 1))]
    r = 1.2
    x0s = rng.standard_normal((K, n)).astype(np.float32)
    b_batch = np.concatenate(
        [np.full((K, 1), r, np.float32), -x0s], axis=1
    )

    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6)
    out = batched_cone_solve(A, b_batch, c, Ky, settings=st)
    assert bool(jnp.all(out["status"] == 0))
    for k in range(K):
        expect = float(c @ x0s[k] - r * np.linalg.norm(c))
        assert float(out["optval"][k]) == pytest.approx(expect, rel=1e-3,
                                                        abs=1e-3)


def test_batched_multi_rhs_regression():
    """f_b_batch: K regression targets sharing one design matrix — each
    lane must match its individual solve."""
    from pogs_tpu.parallel.batch import batched_graph_solve
    from pogs_tpu.api.graph import solve_lasso

    rng = np.random.default_rng(3)
    m, n, K = 40, 20, 4
    A = rng.standard_normal((m, n)).astype(np.float32)
    B = rng.standard_normal((K, m)).astype(np.float32)
    lam = 0.3
    f = FunctionVector(Function.SQUARE, m, dtype=jnp.float32)
    g = FunctionVector(Function.ABS, n, c=lam, dtype=jnp.float32)
    st = SolverSettings(abs_tol=1e-5, rel_tol=1e-5)
    out = batched_graph_solve(A, f, g, f_b_batch=B, settings=st)
    assert bool(jnp.all(out["status"] == 0))
    for k in range(K):
        ref = solve_lasso(A, B[k], lam, abs_tol=1e-5, rel_tol=1e-5,
                          gap_stop=False)
        assert float(out["optval"][k]) == pytest.approx(ref["optval"],
                                                        rel=2e-3, abs=1e-3)


def test_batched_cone_large_batch_reliability():
    """K=64 scenario batch at f32-appropriate tolerances: every lane
    converges (guards the f32 floor policy)."""
    from pogs_tpu.parallel.batch import batched_cone_solve
    from pogs_tpu.types import Cone, ConeConstraint

    rng = np.random.default_rng(77)
    nc, K = 15, 64
    x0s = rng.standard_normal((K, nc)).astype(np.float32)
    c = rng.standard_normal(nc).astype(np.float32)
    A = np.vstack([np.zeros((1, nc)), -np.eye(nc)]).astype(np.float32)
    bb = np.concatenate([np.full((K, 1), 1.2, np.float32), -x0s], axis=1)
    st = SolverSettings(abs_tol=1e-5, rel_tol=1e-5)
    out = batched_cone_solve(A, bb, c, [ConeConstraint(Cone.SOC, range(nc + 1))],
                             settings=st)
    assert int(jnp.sum(out["status"] != 0)) == 0


# ---------------------------------------------------------------------------
# Round-2 additions (VERDICT items 7/10): wide-A column plan, collective-
# structure assertions on lowered HLO, adversarial shardings, and
# init_distributed failure surfacing.
# ---------------------------------------------------------------------------

def _count_collective(txt: str, name: str) -> int:
    from benchmarks.scaling_bench import count_collectives

    return count_collectives(txt, name)


def test_wide_A_column_sharded_solve(mesh8):
    """Wide A column-sharded (the P(None,'rows') plan) == unsharded solve."""
    from pogs_tpu.parallel.mesh import shard_matrix_cols
    from pogs_tpu.solver.graph import GraphFormSolver

    m, n = 24, 64
    A, b, lam = _problem(m, n, seed=11)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=jnp.float32)
    g = FunctionVector(Function.ABS, n, c=lam, dtype=jnp.float32)
    st = SolverSettings(abs_tol=1e-5, rel_tol=1e-5)

    res_ref = GraphFormSolver(A, dtype=jnp.float32, settings=st).solve(f, g)
    A_sh = shard_matrix_cols(jnp.asarray(A), mesh8)
    assert A_sh.sharding.spec == P(None, "rows")
    res_sh = GraphFormSolver(A_sh, dtype=jnp.float32, settings=st).solve(f, g)

    assert res_ref.status == Status.SUCCESS
    assert res_sh.status == Status.SUCCESS
    assert int(res_sh.final_iter) == int(res_ref.final_iter)
    np.testing.assert_allclose(np.asarray(res_sh.x), np.asarray(res_ref.x),
                               atol=5e-4)


def test_auto_shard_picks_plan(mesh8):
    from pogs_tpu.parallel.mesh import auto_shard

    tall = auto_shard(jnp.ones((64, 8)), mesh8)
    wide = auto_shard(jnp.ones((8, 64)), mesh8)
    assert tall.sharding.spec == P("rows", None)
    assert wide.sharding.spec == P(None, "rows")


def test_collective_structure_row_plan(mesh8):
    """Row plan cost model, asserted on the LOWERED HLO (no hardware
    needed): Aᵀy = one all-reduce of a length-n vector; A@x = zero
    collectives (y stays row-sharded)."""
    m, n = 64, 16
    A_sh = jax.device_put(jnp.ones((m, n)), NamedSharding(mesh8, P("rows", None)))
    y_sh = jax.device_put(jnp.ones(m), NamedSharding(mesh8, P("rows")))
    x_rep = jax.device_put(jnp.ones(n), NamedSharding(mesh8, P()))

    rmv = jax.jit(lambda A, y: A.T @ y, out_shardings=NamedSharding(mesh8, P()))
    txt = rmv.lower(A_sh, y_sh).compile().as_text()
    assert _count_collective(txt, "all-reduce") == 1
    assert _count_collective(txt, "all-gather") == 0

    mv = jax.jit(lambda A, x: A @ x,
                 out_shardings=NamedSharding(mesh8, P("rows")))
    txt = mv.lower(A_sh, x_rep).compile().as_text()
    assert _count_collective(txt, "all-reduce") == 0
    assert _count_collective(txt, "all-gather") == 0


def test_collective_structure_col_plan(mesh8):
    """Column plan (wide A): A@x = one all-reduce of length m; Aᵀy free."""
    m, n = 16, 64
    A_sh = jax.device_put(jnp.ones((m, n)), NamedSharding(mesh8, P(None, "rows")))
    x_sh = jax.device_put(jnp.ones(n), NamedSharding(mesh8, P("rows")))
    y_rep = jax.device_put(jnp.ones(m), NamedSharding(mesh8, P()))

    mv = jax.jit(lambda A, x: A @ x, out_shardings=NamedSharding(mesh8, P()))
    txt = mv.lower(A_sh, x_sh).compile().as_text()
    assert _count_collective(txt, "all-reduce") == 1

    rmv = jax.jit(lambda A, y: A.T @ y,
                  out_shardings=NamedSharding(mesh8, P("rows")))
    txt = rmv.lower(A_sh, y_rep).compile().as_text()
    assert _count_collective(txt, "all-reduce") == 0


def test_collective_structure_residual_norms(mesh8):
    """Distributed residual norm = partial reduction + ONE all-reduce."""
    y_sh = jax.device_put(jnp.ones(64), NamedSharding(mesh8, P("rows")))
    nrm = jax.jit(lambda y: jnp.sqrt(jnp.sum(y * y)),
                  out_shardings=NamedSharding(mesh8, P()))
    txt = nrm.lower(y_sh).compile().as_text()
    assert _count_collective(txt, "all-reduce") == 1


def test_adversarial_sharding_still_correct(mesh8):
    """Force the WRONG plan (column-shard a tall A): GSPMD must still
    produce the identical solve — plans change cost, never semantics."""
    from pogs_tpu.parallel.mesh import shard_matrix_cols
    from pogs_tpu.solver.graph import GraphFormSolver

    m, n = 64, 16
    A, b, lam = _problem(m, n, seed=13)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=jnp.float32)
    g = FunctionVector(Function.ABS, n, c=lam, dtype=jnp.float32)
    st = SolverSettings(abs_tol=1e-5, rel_tol=1e-5)

    res_ref = GraphFormSolver(A, dtype=jnp.float32, settings=st).solve(f, g)
    A_bad = shard_matrix_cols(jnp.asarray(A), mesh8)  # tall A, column plan
    res_bad = GraphFormSolver(A_bad, dtype=jnp.float32, settings=st).solve(f, g)

    assert res_bad.status == Status.SUCCESS
    assert int(res_bad.final_iter) == int(res_ref.final_iter)
    np.testing.assert_allclose(np.asarray(res_bad.x), np.asarray(res_ref.x),
                               atol=5e-4)


def test_init_distributed_surfaces_failure(monkeypatch):
    """Genuine multi-host init failures must raise (after logging), not
    silently degrade to single-host; idempotent re-init stays silent."""
    from pogs_tpu.parallel import mesh as mesh_mod

    def boom(**kw):
        raise RuntimeError("coordinator unreachable at 10.0.0.1:1234")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        mesh_mod.init_distributed(coordinator_address="10.0.0.1:1234",
                                  num_processes=2, process_id=0)

    def already(**kw):
        raise RuntimeError("jax.distributed.initialize has already been called")

    monkeypatch.setattr(jax.distributed, "initialize", already)
    n = mesh_mod.init_distributed(coordinator_address="10.0.0.1:1234",
                                  num_processes=2, process_id=0)
    assert n == len(jax.devices())


def test_loop_body_collective_budget(mesh8):
    """Round-5 regression: the ADMM body once carried 12 scalar
    all-reduces per iteration (one per m-part norm/dot — each pure
    interconnect latency on real devices).  After stacking the same-point
    reductions the steady-state budget is 2 vector + 1 small all-reduce
    OP; the exact-residual branch may add a couple more."""
    from benchmarks.scaling_bench import measure_loop_collective_shapes

    counts = measure_loop_collective_shapes()
    assert counts["main_vector"] <= 2, counts
    assert counts["main_small"] <= 1, counts
    assert (counts["exact_branch_vector"]
            + counts["exact_branch_small"]) <= 3, counts


def test_loop_body_has_no_collective_permutes(mesh8):
    """Split (x, y) loop state regression: packing z = [x; y] and slicing
    it inside the loop forced GSPMD to insert per-iteration
    collective-permutes (28 in the body on this mesh).  The loop body's
    only collectives must be reduces (Aᵀ-side psums + norms)."""
    from pogs_tpu.solver.graph import GraphFormSolver, _get_solve_fn

    m, n = 64, 16
    A, b, lam = _problem(m, n, seed=21)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=jnp.float32)
    g = FunctionVector(Function.ABS, n, c=lam, dtype=jnp.float32)
    st = SolverSettings(abs_tol=1e-4, rel_tol=1e-3)
    A_sh = shard_matrix(jnp.asarray(A), mesh8)
    solver = GraphFormSolver(A_sh, dtype=jnp.float32, settings=st)
    solver.init()
    fn = _get_solve_fn((m, n), solver.dtype, f.h, g.h, st, solver.projector,
                       solver.direct_method, False, False, False)
    f.to_device()
    g.to_device()
    txt = fn.lower(solver._init_state, tuple(f.params), tuple(g.params),
                   1.0, {}).compile().as_text()
    body_lines = [line for line in txt.splitlines() if "while/body" in line]
    n_permute = sum("collective-permute" in line for line in body_lines)
    assert n_permute == 0, f"{n_permute} collective-permutes in the loop body"


def test_hsde_loop_body_has_no_collective_permutes(mesh8):
    """Same regression for the cone path: the packed u = [x; y; τ]
    embedding forced 19 per-iteration collective-permutes; the split
    (ux, uy, uτ) carry must keep the DR body reduce-only."""
    from pogs_tpu.types import Cone, ConeConstraint
    from pogs_tpu.solver.cone import ConeSolver, _CONE_SOLVE_CACHE

    m, n = 64, 16
    rng = np.random.default_rng(31)
    A = rng.standard_normal((m, n)).astype(np.float32)
    xstar = rng.standard_normal(n)
    b = (A @ xstar + np.abs(rng.standard_normal(m))).astype(np.float32)
    c = (-A.T @ np.abs(rng.standard_normal(m))).astype(np.float32)
    Ky = [ConeConstraint(Cone.NON_NEG, np.arange(m))]
    st = SolverSettings(abs_tol=1e-4, rel_tol=1e-3)
    A_sh = shard_matrix(jnp.asarray(A), mesh8)
    solver = ConeSolver(A_sh, Ky=Ky, settings=st)
    n_before = len(_CONE_SOLVE_CACHE)
    solver.solve(b, c)
    fn = list(_CONE_SOLVE_CACHE.values())[n_before]
    args = (solver._init_state, b, c, np.zeros((0, 0), np.float32), 1.0,
            jnp.zeros((m + n + 1,), jnp.float32))
    txt = fn.lower(*args).compile().as_text()
    body_lines = [line for line in txt.splitlines() if "while/body" in line]
    n_permute = sum("collective-permute" in line for line in body_lines)
    assert n_permute == 0, f"{n_permute} collective-permutes in the DR body"


def test_warm_path_matches_vmap_path():
    """Sequential warm-started λ-path (lax.scan carry, LassoPath §3.5
    pattern): same optima as independent solves, far fewer iterations."""
    from pogs_tpu.parallel.batch import solve_lasso_path

    rng = np.random.default_rng(5)
    m, n, K = 100, 50, 16
    A = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    lam_max = float(np.max(np.abs(A.T @ b)))
    lambdas = (np.geomspace(0.5, 0.05, K) * lam_max).astype(np.float32)
    st = SolverSettings(abs_tol=1e-5, rel_tol=1e-5)
    vm = solve_lasso_path(A, b, lambdas, settings=st)
    wm = solve_lasso_path(A, b, lambdas, settings=st, warm=True)
    assert bool(jnp.all(vm["status"] == 0))
    assert bool(jnp.all(wm["status"] == 0))
    np.testing.assert_allclose(np.asarray(wm["optval"]),
                               np.asarray(vm["optval"]), rtol=2e-3)
    # Warm starts must pay off substantially on a geometric grid.
    assert int(jnp.sum(wm["iterations"])) < 0.5 * int(jnp.sum(vm["iterations"]))


def test_warm_cone_path_matches_batch():
    """Warm-started cone path (HSDE u carried through lax.scan): same
    optima as independent scenario solves, far fewer iterations on a
    drifting-b sequence (receding-horizon pattern)."""
    from pogs_tpu.parallel.batch import batched_cone_solve, warm_path_cone_solve
    from pogs_tpu.types import Cone, ConeConstraint

    rng = np.random.default_rng(1)
    m, n, K = 60, 30, 16
    A = rng.standard_normal((m, n)).astype(np.float32)
    xstar = rng.standard_normal(n)
    b0 = (A @ xstar + np.abs(rng.standard_normal(m))).astype(np.float32)
    c = (-A.T @ np.abs(rng.standard_normal(m))).astype(np.float32)
    drift = rng.standard_normal((K, m)).astype(np.float32) * 0.02
    b_seq = b0[None, :] * (1 + np.cumsum(drift, axis=0) * 0.1)
    Ky = [ConeConstraint(Cone.NON_NEG, np.arange(m))]
    st = SolverSettings(abs_tol=1e-4, rel_tol=1e-3, max_iter=20000)
    vm = batched_cone_solve(A, b_seq, c, Ky, settings=st)
    wm = warm_path_cone_solve(A, b_seq, c, Ky, settings=st)
    assert bool(jnp.all(vm["status"] == 0))
    assert bool(jnp.all(wm["status"] == 0))
    rel = np.abs(np.asarray(vm["optval"]) - np.asarray(wm["optval"])) / \
        np.maximum(np.abs(np.asarray(vm["optval"])), 1.0)
    assert float(rel.max()) < 1e-2  # both within their own tol bands
    assert int(jnp.sum(wm["iterations"])) < 0.5 * int(jnp.sum(vm["iterations"]))


def test_batched_qp_solve_vs_slsqp(rng):
    """Scenario-QP sweep (round-3): K lanes share (A, P, K_y); the whole
    sweep is one vmapped HSDE solve on the shared epigraph-SOC extension
    plus per-lane PDAS polish.  Oracle: independent SLSQP per lane."""
    from scipy.optimize import minimize

    from pogs_tpu.parallel import batched_qp_solve
    from pogs_tpu.types import Cone, ConeConstraint, SolverSettings

    n, K = 10, 4
    B = rng.normal(size=(n, n))
    Pq = B @ B.T + 0.5 * np.eye(n)
    A = np.vstack([np.ones((1, n)), np.eye(n), -np.eye(n)])
    Ky = [ConeConstraint(Cone.ZERO, [0]),
          ConeConstraint(Cone.NON_NEG, range(1, 1 + 2 * n))]
    b_batch = np.stack([
        np.concatenate([[1.0 + 0.1 * k], np.full(n, 1.0), np.full(n, 1.0)])
        for k in range(K)])
    c_batch = rng.normal(size=(K, n))
    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=20000)
    out = batched_qp_solve(A, Pq, b_batch, c_batch, Ky, settings=st)
    assert np.all(out["status"] == 0)
    for k in range(K):
        target = 1.0 + 0.1 * k
        ref = minimize(
            lambda x, ck=c_batch[k]: 0.5 * x @ Pq @ x + ck @ x,
            np.zeros(n), jac=lambda x, ck=c_batch[k]: Pq @ x + ck,
            constraints=[{"type": "eq",
                          "fun": lambda x, t=target: x.sum() - t,
                          "jac": lambda x: np.ones(n)}],
            bounds=[(-1.0, 1.0)] * n, method="SLSQP",
            options={"maxiter": 500, "ftol": 1e-14})
        assert out["optval"][k] == pytest.approx(float(ref.fun),
                                                 rel=1e-6, abs=1e-6)


def test_batched_qp_shared_c_broadcast(rng):
    """c as a single (n,) vector broadcasts across lanes."""
    from pogs_tpu.parallel import batched_qp_solve
    from pogs_tpu.types import Cone, ConeConstraint, SolverSettings

    n, K = 8, 3
    B = rng.normal(size=(n, n))
    Pq = B @ B.T + np.eye(n)
    c = rng.normal(size=n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    Ky = [ConeConstraint(Cone.NON_NEG, range(2 * n))]
    b_batch = np.stack([np.concatenate([np.full(n, 1.0 + 0.2 * k),
                                        np.full(n, 1.0)])
                        for k in range(K)])
    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=20000)
    out = batched_qp_solve(A, Pq, b_batch, c, Ky, settings=st)
    assert np.all(out["status"] == 0)
    # Wider boxes can only improve the optimum: optval non-increasing.
    assert np.all(np.diff(out["optval"]) <= 1e-8)


# --------------------------------------------------------------------------
# Sparse x sharded (BASELINE config 5 verbatim: row-sharded SPARSE A).
# The dense plan rides GSPMD propagation; sparse matvecs need the explicit
# row-block shard_map operator (parallel/sparse.py).
# --------------------------------------------------------------------------

def _sparse_op_fixture(mesh):
    import scipy.sparse as sp

    from pogs_tpu.parallel.sparse import shard_sparse

    rng = np.random.default_rng(3)
    m0, n = 11, 12
    Araw = sp.random(m0, n, density=0.3, random_state=4, format="csr")
    A = sp.vstack([Araw, sp.eye(n), -sp.eye(n)]).tocsr()
    op, m_orig = shard_sparse(A, mesh, dtype=np.float32)
    return A, op, m_orig, rng


def test_sharded_sparse_operator_matches_dense(mesh8):
    """mv/rmv/sq_mv/sq_rmv/scale/frob2 of the row-block sharded sparse
    operator agree with the dense oracle (padding rows inert)."""
    A, op, m_orig, rng = _sparse_op_fixture(mesh8)
    Ad = A.toarray().astype(np.float32)
    m, n = Ad.shape
    x = rng.normal(size=n).astype(np.float32)
    y = rng.normal(size=op.shape[0]).astype(np.float32)
    mv = np.asarray(op.mv(x))
    assert mv[:m] == pytest.approx(Ad @ x, abs=1e-5)
    assert np.all(mv[m:] == 0.0)
    assert np.asarray(op.rmv(y)) == pytest.approx(Ad.T @ y[:m], abs=1e-5)
    assert np.asarray(op.sq_mv(x))[:m] == pytest.approx(
        (Ad * Ad) @ x, abs=1e-5)
    d = (rng.random(op.shape[0]) + 0.5).astype(np.float32)
    e = (rng.random(n) + 0.5).astype(np.float32)
    scaled = np.asarray(op.scale(jnp.asarray(d), jnp.asarray(e)).mv(x))
    assert scaled[:m] == pytest.approx(
        (d[:m, None] * Ad * e[None, :]) @ x, abs=1e-4)
    assert float(op.frob2()) == pytest.approx(float((Ad ** 2).sum()),
                                              rel=1e-5)


def test_sharded_sparse_cone_lp_matches_single(mesh8):
    """Row-sharded sparse LP through the HSDE cone path == single-device
    sparse solve (BASELINE config 5)."""
    import scipy.sparse as sp

    from pogs_tpu.parallel.sparse import pad_cone_rows, shard_sparse
    from pogs_tpu.solver.cone import ConeSolver
    from pogs_tpu.types import Cone, ConeConstraint

    rng = np.random.default_rng(7)
    m0, n = 9, 10
    Araw = sp.random(m0, n, density=0.4, random_state=1, format="csr")
    A = sp.vstack([Araw, sp.eye(n), -sp.eye(n)]).tocsr()
    m = A.shape[0]
    x0 = rng.normal(size=n)
    b = A @ x0 + rng.random(m) + 0.1
    c = rng.normal(size=n)
    Ky = [ConeConstraint(Cone.NON_NEG, range(m))]
    # f64: the sharded path's different reduction order can park the f32
    # dual residual a hair above a 1e-5 floor-level tolerance.
    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=1500)

    r_single = ConeSolver(A, Ky=Ky, settings=st, dtype=np.float64).solve(b, c, settings=st)

    op, _ = shard_sparse(A, mesh8, dtype=np.float64)
    b_pad, Ky_pad = pad_cone_rows(b, Ky, op.shape[0])
    r_shard = ConeSolver(op, Ky=Ky_pad, settings=st,
                         dtype=np.float64).solve(b_pad, c, settings=st)

    assert r_single.status == Status.SUCCESS
    assert r_shard.status == Status.SUCCESS
    assert float(r_shard.optval) == pytest.approx(
        float(r_single.optval), rel=1e-4, abs=1e-4)
    assert np.asarray(r_shard.x) == pytest.approx(
        np.asarray(r_single.x), abs=1e-3)


def test_sharded_sparse_socp(mesh8):
    """Sparse SOC-ball problem row-sharded: min c'x s.t. ||x - x0|| <= r
    (closed-form optimum c'x0 - r||c||)."""
    import scipy.sparse as sp

    from pogs_tpu.parallel.sparse import pad_cone_rows, shard_sparse
    from pogs_tpu.solver.cone import ConeSolver
    from pogs_tpu.types import Cone, ConeConstraint

    rng = np.random.default_rng(9)
    n = 15  # SOC over n+1 = 16 rows: 2 per shard on the 8-way mesh
    x0 = rng.standard_normal(n).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    r = 1.5
    A = sp.vstack([sp.csr_matrix((1, n)), -sp.eye(n)]).tocsr()
    b = np.concatenate([[r], -x0]).astype(np.float32)
    Ky = [ConeConstraint(Cone.SOC, range(n + 1))]
    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6)

    op, _ = shard_sparse(A, mesh8, dtype=np.float32)
    b_pad, Ky_pad = pad_cone_rows(b, Ky, op.shape[0])
    res = ConeSolver(op, Ky=Ky_pad, settings=st,
                     dtype=np.float32).solve(b_pad, c, settings=st)

    expect = float(c @ x0 - r * np.linalg.norm(c))
    assert res.status == Status.SUCCESS
    assert float(res.optval) == pytest.approx(expect, rel=1e-3, abs=1e-3)
