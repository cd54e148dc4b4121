"""chip_smoke.py's phases and checkers at toy sizes on the CPU, its refusal
to run without a GPU, and (``gpu`` marker) the phases at full size on a
card."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

TOY = {
    "headline_lasso": dict(m=60, n=40),
    "large_dense_lasso": dict(m=200, n=100),
    "batched_sweep": dict(m=60, n=40, K=8),
    "dense_cone_lp": dict(m=60, n=30),
    "qp_cvxqp": dict(n=100, optval=1.1590718e4),   # CVXQP1_S
    "sparse_lasso": dict(m=400, n=200, density=0.05),
    "f64_lasso": dict(m=60, n=40),
}


def test_toy_sizes_cover_every_phase():
    assert [name for name, _ in cs.PHASES] == list(TOY)


@pytest.mark.parametrize("name", list(TOY))
def test_phase_at_toy_size(name):
    fields = dict(cs.PHASES)[name]("cpu", **TOY[name])
    assert fields["wall_s"] > 0
    assert fields["iters"] > 0


def test_mesh_phases_on_four_virtual_devices():
    """The --four-cards path on four of the harness's CPU devices."""
    names = []
    for name, fields in cs.mesh_phases(
            "cpu", n_dev=4, rows_dense=(400, 100), wide=(60, 400),
            sweep=(60, 40, 8), sparse_lp=(200, 20, 0.2)):
        names.append(name)
        assert fields["iters"] > 0
    assert names == ["rows_dense_lasso", "cols_wide_lasso",
                     "batch_sharded_sweep", "rows_sparse_cone_lp"]


def test_on_platform_rejects_other_platform():
    import jax.numpy as jnp

    x = jnp.ones(3)
    assert cs.on_platform("cpu", {"x": x, "skip": np.ones(2)}) == 1
    with pytest.raises(cs.CheckFailed, match="expected gpu"):
        cs.on_platform("gpu", x)
    with pytest.raises(cs.CheckFailed, match="no device arrays"):
        cs.on_platform("cpu", [np.ones(2)])


def test_lasso_kkt_certifies_only_the_optimum():
    from benchmarks.problems import lasso_kkt

    rng = np.random.default_rng(0)
    A = rng.standard_normal((30, 10))
    b = rng.standard_normal(30)
    lam_max = float(np.max(np.abs(A.T @ b)))
    # x = 0 is optimal iff lambda >= ||A'b||_inf.
    assert lasso_kkt(A, b, 1.01 * lam_max, np.zeros(10), 1e-9) == 0.0
    assert lasso_kkt(A, b, 0.5 * lam_max, np.zeros(10), 1e-9) > 0.5
    # Orthonormal columns: the lasso solution is soft(Q'b, lambda).
    Q = np.linalg.qr(A)[0]
    lam = 0.5 * float(np.max(np.abs(Q.T @ b)))
    v = Q.T @ b
    x = np.sign(v) * np.maximum(np.abs(v) - lam, 0.0)
    assert lasso_kkt(Q, b, lam, x, 1e-12) < 1e-12
    assert lasso_kkt(Q, b, lam, 1.1 * x, 1e-12) > 1e-3


def _run_script(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_refuses_without_gpu():
    p = _run_script(REPO, {"JAX_PLATFORMS": "cpu"})
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "needs a GPU" in p.stderr


def test_refuses_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run_script(str(tmp_path), {"JAX_PLATFORMS": "cpu"})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(TOY))
def test_phase_at_full_size_on_gpu(gpu, name):
    fields = dict(cs.PHASES)[name]("gpu")
    assert fields["iters"] > 0
