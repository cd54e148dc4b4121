"""pogs_tpu — a graph-form / cone-form ADMM convex solver in JAX.

A from-scratch JAX/XLA implementation of the capabilities of POGS
(Proximal Operator Graph Solver, Fougner & Boyd).  It solves problems in
*graph form*

    minimize    f(y) + g(x)       (f, g separable)
    subject to  y = A x

via ADMM with closed-form proximal operators, and in *cone form*

    minimize    c'x (+ 1/2 x'Px)
    subject to  b - A x in K_y,  x in K_x

via the same ADMM loop or a homogeneous self-dual embedding (HSDE).

Design: the whole solve is one jit-compiled ``lax.while_loop`` over a pytree
state — no host round-trips inside the loop.  Dense linear algebra goes to
the vendor libraries through XLA; elementwise prox stages are fused by XLA;
multi-device scaling uses ``jax.sharding`` meshes with XLA collectives.

Reference parity: feature surface of POGS (foges/pogs); see docstrings for
file:line citations into its sources.
"""

from pogs_tpu.types import (
    Function,
    FunctionObj,
    FunctionVector,
    Cone,
    ConeConstraint,
    Status,
    SolverSettings,
    SolverResult,
    # Reference-spelling function aliases (kAbs = Function.ABS, ...).
    kAbs, kExp, kHuber, kIdentity, kIndBox01, kIndEq0, kIndGe0, kIndLe0,
    kLogistic, kMaxNeg0, kMaxPos0, kNegEntr, kNegLog, kRecipr, kSquare, kZero,
)
from pogs_tpu.prox import prox_eval, func_eval, proj_subgrad_eval
from pogs_tpu.solver import SolverState, admm_solve, GraphFormSolver
from pogs_tpu.solver.cone import ConeSolver
from pogs_tpu.api.cone import solve_cone, solve_cone_problem, dims_to_cones, auto_rho
from pogs_tpu.api.cvxpy_interface import (
    pogs_solve,
    detect_graph_form,
    register_solver as register_cvxpy_solver,
    HAS_CVXPY,
)
from pogs_tpu.api.graph import (
    solve_graph_form,
    solve_lasso,
    solve_ridge,
    solve_elastic_net,
    solve_logistic,
    solve_huber,
    solve_svm,
    solve_nonneg_ls,
)
from pogs_tpu.api.qp import solve_lp, solve_qp, solve_qps
from pogs_tpu.api.diff import (
    make_diff_solver,
    diff_lasso,
    diff_ridge,
    diff_elastic_net,
    diff_logistic,
    diff_nonneg_ls,
    diff_qp,
)
from pogs_tpu.api.diff_cone import make_diff_cone_solver, diff_cone_solve
from pogs_tpu.utils.profiling import trace, PhaseTimer, device_time
from pogs_tpu.utils.checkpoint import save_state, load_state

__version__ = "0.1.0"

__all__ = [
    "Function",
    "FunctionObj",
    "FunctionVector",
    "Cone",
    "ConeConstraint",
    "Status",
    "SolverSettings",
    "SolverResult",
    "SolverState",
    "prox_eval",
    "func_eval",
    "proj_subgrad_eval",
    "admm_solve",
    "GraphFormSolver",
    "ConeSolver",
    "solve_cone",
    "solve_cone_problem",
    "dims_to_cones",
    "auto_rho",
    "pogs_solve",
    "detect_graph_form",
    "register_cvxpy_solver",
    "HAS_CVXPY",
    "solve_graph_form",
    "solve_lasso",
    "solve_ridge",
    "solve_elastic_net",
    "solve_logistic",
    "solve_huber",
    "solve_svm",
    "solve_nonneg_ls",
    "solve_lp",
    "solve_qp",
    "solve_qps",
    "make_diff_solver",
    "diff_lasso",
    "diff_ridge",
    "diff_elastic_net",
    "diff_logistic",
    "diff_nonneg_ls",
    "diff_qp",
    "make_diff_cone_solver",
    "diff_cone_solve",
    "trace",
    "PhaseTimer",
    "device_time",
    "save_state",
    "load_state",
    "kAbs", "kExp", "kHuber", "kIdentity", "kIndBox01", "kIndEq0",
    "kIndGe0", "kIndLe0", "kLogistic", "kMaxNeg0", "kMaxPos0",
    "kNegEntr", "kNegLog", "kRecipr", "kSquare", "kZero",
]
