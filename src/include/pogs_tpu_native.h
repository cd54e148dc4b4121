/* pogs_tpu native host runtime — C ABI.
 *
 * This is the native-code layer of the pogs_tpu framework: a dependency-free
 * C++ implementation of the graph-form ADMM solver exposed through a flat C
 * ABI, mirroring the capability surface of the reference C interface
 * (reference: src/interface_c/pogs_c.h — PogsD/PogsS dense entry points
 * :75-91, PogsSparseD/S :99-119, enums :51-69) with a redesigned, handle-based
 * API:
 *
 *   - One-shot calls (pogs_native_solve_dense_*) match the reference's
 *     stateless entry points.
 *   - Handle-based calls (pogs_native_dense_new / _solve / _free) keep the
 *     equilibration + Gram factorization and the final iterate across solves,
 *     exposing the warm-start / lambda-path capability the reference only
 *     offers through its C++ API (reference: examples/cpp/lasso_path.cpp).
 *
 * Role in the framework: the accelerator path is JAX/XLA (pogs_tpu Python
 * package); this library is the host-side runtime for (a) callers outside
 * Python, (b) small problems where device dispatch dominates, and (c) an
 * independent numerics oracle for the JAX path.
 *
 * Function codes, cone codes and statuses use the same integer values as
 * pogs_tpu.types (which match the reference enums for ABI familiarity).
 */
#ifndef POGS_TPU_NATIVE_H
#define POGS_TPU_NATIVE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Row/column-major order of a dense A. */
enum PogsNativeOrd { POGS_NATIVE_ROW_MAJ = 0, POGS_NATIVE_COL_MAJ = 1 };

/* Function codes h in c*h(a*x-b) + d*x + (e/2)x^2; values match
 * pogs_tpu.types.Function (and the reference FUNCTION enum). */
enum PogsNativeFunction {
  POGS_NATIVE_ABS = 0,
  POGS_NATIVE_EXP = 1,
  POGS_NATIVE_HUBER = 2,
  POGS_NATIVE_IDENTITY = 3,
  POGS_NATIVE_INDBOX01 = 4,
  POGS_NATIVE_INDEQ0 = 5,
  POGS_NATIVE_INDGE0 = 6,
  POGS_NATIVE_INDLE0 = 7,
  POGS_NATIVE_LOGISTIC = 8,
  POGS_NATIVE_MAXNEG0 = 9,
  POGS_NATIVE_MAXPOS0 = 10,
  POGS_NATIVE_NEGENTR = 11,
  POGS_NATIVE_NEGLOG = 12,
  POGS_NATIVE_RECIPR = 13,
  POGS_NATIVE_SQUARE = 14,
  POGS_NATIVE_ZERO = 15
};

/* Exit statuses; values match pogs_tpu.types.Status. */
enum PogsNativeStatus {
  POGS_NATIVE_SUCCESS = 0,
  POGS_NATIVE_INFEASIBLE = 1,
  POGS_NATIVE_UNBOUNDED = 2,
  POGS_NATIVE_MAX_ITER = 3,
  POGS_NATIVE_NAN_FOUND = 4,
  POGS_NATIVE_ERROR = 5
};

/* Solver knobs (defaults match pogs_tpu.types.SolverSettings). A zeroed
 * struct is NOT valid; call pogs_native_settings_default first. */
typedef struct {
  double abs_tol;
  double rel_tol;
  double rho;
  int32_t max_iter;
  int32_t verbose;
  int32_t adaptive_rho; /* bool */
  int32_t gap_stop;     /* bool */
  int32_t warm_start;   /* bool: reuse the handle's previous iterate */
  int32_t cgls_max_iter;
  int32_t polish;       /* bool: QP active-set polish (cone QP path) */
} PogsNativeSettings;

/* Solve diagnostics. */
typedef struct {
  double optval;
  int32_t final_iter;
  int32_t status;
  double nrm_r;
  double nrm_s;
  double gap;
  double rho_final;
} PogsNativeInfo;

void pogs_native_settings_default(PogsNativeSettings* s);

/* ABI/version stamp: returns 10000*major + 100*minor + patch. */
int32_t pogs_native_version(void);

/* ------------------------------------------------------------------ */
/* Handle-based dense API (double precision).                          */
/* ------------------------------------------------------------------ */

typedef struct PogsNativeDense PogsNativeDense;

/* Create a solver for a dense m x n matrix A (copied; equilibrated and
 * factorized lazily on first solve). */
PogsNativeDense* pogs_native_dense_new(int32_t ord, size_t m, size_t n,
                                       const double* A);

/* Solve min f(y) + g(x) s.t. y = Ax.
 * f_* arrays have length m, g_* arrays length n; h codes are int32.
 * Outputs x[n], y[m], mu[n], nu[m] (any may be NULL). Returns status. */
int32_t pogs_native_dense_solve(
    PogsNativeDense* s, const PogsNativeSettings* settings,
    const int32_t* f_h, const double* f_a, const double* f_b,
    const double* f_c, const double* f_d, const double* f_e,
    const int32_t* g_h, const double* g_a, const double* g_b,
    const double* g_c, const double* g_d, const double* g_e,
    double* x, double* y, double* mu, double* nu, PogsNativeInfo* info);

void pogs_native_dense_free(PogsNativeDense* s);

/* ------------------------------------------------------------------ */
/* Handle-based sparse CSR API (double precision, CGLS projector).     */
/* ------------------------------------------------------------------ */

typedef struct PogsNativeSparse PogsNativeSparse;

PogsNativeSparse* pogs_native_sparse_new(size_t m, size_t n, size_t nnz,
                                         const int64_t* indptr,
                                         const int64_t* indices,
                                         const double* data);

int32_t pogs_native_sparse_solve(
    PogsNativeSparse* s, const PogsNativeSettings* settings,
    const int32_t* f_h, const double* f_a, const double* f_b,
    const double* f_c, const double* f_d, const double* f_e,
    const int32_t* g_h, const double* g_a, const double* g_b,
    const double* g_c, const double* g_d, const double* g_e,
    double* x, double* y, double* mu, double* nu, PogsNativeInfo* info);

void pogs_native_sparse_free(PogsNativeSparse* s);

/* ------------------------------------------------------------------ */
/* Cone-form API (graph-form cone ADMM; counterpart of PogsConeD).     */
/* Cones: ZERO=0, NON_NEG=1, NON_POS=2, SOC=3, SDP=4, EXP_PRIMAL=5,    */
/* EXP_DUAL=6 (values match pogs_tpu.types.Cone).  SDP blocks are      */
/* svec-packed: column-major lower triangle with sqrt(2)-scaled        */
/* off-diagonals; num_indices must be a triangular number d(d+1)/2.    */
/* (Beyond the reference GPU backend, which omits SDP; matches the     */
/* reference CPU's syevd path via a built-in Jacobi eigensolver.)      */
/* ------------------------------------------------------------------ */

typedef struct {
  int32_t cone;            /* cone kind (see above)                    */
  const int64_t* indices;  /* coordinate indices belonging to the cone */
  size_t num_indices;
} PogsNativeCone;

typedef struct PogsNativeConeSolver PogsNativeConeSolver;

/* Create a cone solver for  min c'x  s.t.  b - Ax in K_y, x in K_x.
 * Returns NULL on invalid input (overlapping/out-of-range indices, SDP). */
PogsNativeConeSolver* pogs_native_cone_new(
    int32_t ord, size_t m, size_t n, const double* A,
    const PogsNativeCone* Kx, size_t num_Kx,
    const PogsNativeCone* Ky, size_t num_Ky);

/* Sparse-CSR variant (CGLS projector; the reference's PogsConeD/S are
 * likewise indirect). Same solve/free entry points. */
PogsNativeConeSolver* pogs_native_cone_sparse_new(
    size_t m, size_t n, size_t nnz,
    const int64_t* indptr, const int64_t* indices, const double* data,
    const PogsNativeCone* Kx, size_t num_Kx,
    const PogsNativeCone* Ky, size_t num_Ky);

/* Quadratic-objective variants:  min ½x'Px + c'x  s.t.  b - Ax in K_y.
 * Counterparts of the reference's PogsConeQD/QS and PogsConeDirectQD/QS
 * (pogs_c.h:167-243).  P is n x n (ord-major for the dense entry,
 * row-major for the sparse one).  K_x must be empty — the quadratic
 * x-prox composed with a cone projection is not an exact prox; the
 * reference rejects the combination too (pogs.cpp:1941-1944).  Unlike
 * the reference, whose empty-Kx QPs route to an HSDE its own code
 * declares broken for QP (pogs.cpp:1510-1514), these entries use the
 * graph-form cone ADMM with a cached Cholesky of P+rho*I and converge. */
PogsNativeConeSolver* pogs_native_cone_qp_new(
    int32_t ord, size_t m, size_t n, const double* A, const double* P,
    const PogsNativeCone* Ky, size_t num_Ky);

PogsNativeConeSolver* pogs_native_cone_qp_sparse_new(
    size_t m, size_t n, size_t nnz,
    const int64_t* indptr, const int64_t* indices, const double* data,
    const double* P, const PogsNativeCone* Ky, size_t num_Ky);

/* Solve for given (b, c); the equilibration/factorization and (with
 * settings->warm_start) the iterate persist in the handle. */
int32_t pogs_native_cone_solve(
    PogsNativeConeSolver* s, const PogsNativeSettings* settings,
    const double* b, const double* c,
    double* x, double* y, double* mu, double* nu, PogsNativeInfo* info);

void pogs_native_cone_free(PogsNativeConeSolver* s);

/* ------------------------------------------------------------------ */
/* One-shot convenience entry points (counterparts of PogsD/PogsS).    */
/* ------------------------------------------------------------------ */

int32_t pogs_native_solve_dense_d(
    int32_t ord, size_t m, size_t n, const double* A,
    const PogsNativeSettings* settings,
    const int32_t* f_h, const double* f_a, const double* f_b,
    const double* f_c, const double* f_d, const double* f_e,
    const int32_t* g_h, const double* g_a, const double* g_b,
    const double* g_c, const double* g_d, const double* g_e,
    double* x, double* y, double* mu, double* nu, PogsNativeInfo* info);

int32_t pogs_native_solve_dense_s(
    int32_t ord, size_t m, size_t n, const float* A,
    const PogsNativeSettings* settings,
    const int32_t* f_h, const float* f_a, const float* f_b,
    const float* f_c, const float* f_d, const float* f_e,
    const int32_t* g_h, const float* g_a, const float* g_b,
    const float* g_c, const float* g_d, const float* g_e,
    float* x, float* y, float* mu, float* nu, PogsNativeInfo* info);

/* ------------------------------------------------------------------ */
/* Coordinate descent for elastic-net least squares:                   */
/*   min (1/2)||Ax - b||^2 + sum_j l1[j]|x_j| + (1/2) sum_j l2[j]x_j^2 */
/* A row-major (m x n); l1/l2 length-n (l2 may be NULL = zeros).       */
/* settings: abs_tol scales the KKT stop, max_iter bounds the sweeps,  */
/* warm_start reuses the x passed in as the start point.               */
/* Outputs (each may be NULL): x, y = Ax, mu = A'(b-Ax) (in dg(x)),    */
/* nu = Ax - b.  info: optval, final_iter = sweeps, nrm_s = KKT resid. */
/* ------------------------------------------------------------------ */

int32_t pogs_native_lasso_cd(
    size_t m, size_t n, const double* A, const double* b,
    const double* l1, const double* l2,
    const PogsNativeSettings* settings,
    double* x, double* y, double* mu, double* nu, PogsNativeInfo* info);


/* ------------------------------------------------------------------ */
/* Specialized GLM fast paths (see src/native/glm.hpp).                */
/* ------------------------------------------------------------------ */

/* Ridge, closed form: min 1/2||Ax-b||^2 + 1/2 sum_j l2[j] x_j^2.      */
int32_t pogs_native_ridge_direct(
    size_t m, size_t n, const double* A, const double* b, const double* l2,
    double* x, PogsNativeInfo* info);

/* Hinge-loss SVM via liblinear-style dual CD:                         */
/*   min sum_i max(0, 1 - y[i] a_i'x) + (lambda/2)||x||^2.             */
/* settings: abs_tol = projected-gradient stop, max_iter = epochs.     */
int32_t pogs_native_svm_dual_cd(
    size_t m, size_t n, const double* A, const double* y, double lambda,
    const PogsNativeSettings* settings, double* x, PogsNativeInfo* info);

/* L1 logistic regression via glmnet-style prox-Newton:                */
/*   min sum_i log(1+exp(-y[i] a_i'x)) + sum_j l1[j]|x_j|.             */
int32_t pogs_native_logistic_pn(
    size_t m, size_t n, const double* A, const double* y, const double* l1,
    const PogsNativeSettings* settings, double* x, PogsNativeInfo* info);

/* Huber regression (+ optional l1) via IRLS / majorize-minimize:      */
/*   min sum_i huber_delta(a_i'x - b[i]) + sum_j l1[j]|x_j|.           */
int32_t pogs_native_huber_irls(
    size_t m, size_t n, const double* A, const double* b, double delta,
    const double* l1, const PogsNativeSettings* settings, double* x,
    PogsNativeInfo* info);

/* Nonnegative least squares via active-set on the normal equations:   */
/*   min 1/2||Ax - b||^2  s.t.  x >= 0.  Returns ERROR when the        */
/* active-set solve is rejected (caller falls back to ADMM).           */
int32_t pogs_native_nnls(
    size_t m, size_t n, const double* A, const double* b,
    const PogsNativeSettings* settings, double* x, PogsNativeInfo* info);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* POGS_TPU_NATIVE_H */
