// C ABI implementation for the pogs_tpu native host runtime.
//
// Wires the templated core (admm.hpp / prox.hpp / linalg.hpp) to the flat C
// surface declared in src/include/pogs_tpu_native.h.  Counterpart of the
// reference's src/interface_c/pogs_c.cpp, redesigned handle-first so the
// equilibration/factorization and warm-start iterate persist across solves.

#include "../include/pogs_tpu_native.h"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <memory>
#include <new>
#include <vector>

#include "admm.hpp"
#include "cd.hpp"
#include "glm.hpp"
#include "cone.hpp"
#include "qp_polish.hpp"
#include "linalg.hpp"
#include "prox.hpp"

namespace pn = pogs_native;

extern "C" void pogs_native_settings_default(PogsNativeSettings* s) {
  s->abs_tol = 1e-4;
  s->rel_tol = 1e-3;
  s->rho = 1.0;
  s->max_iter = 2500;
  s->verbose = 0;
  s->adaptive_rho = 1;
  s->gap_stop = 0;
  s->warm_start = 0;
  s->cgls_max_iter = 500;
  s->polish = 1;
}

extern "C" int32_t pogs_native_version(void) { return 10100; /* 1.1.0 */ }

namespace {

pn::Settings to_settings(const PogsNativeSettings* s) {
  pn::Settings out;
  if (!s) return out;
  out.abs_tol = s->abs_tol;
  out.rel_tol = s->rel_tol;
  out.rho = s->rho;
  out.max_iter = s->max_iter;
  out.verbose = s->verbose;
  out.adaptive_rho = s->adaptive_rho != 0;
  out.gap_stop = s->gap_stop != 0;
  out.cgls_max_iter = s->cgls_max_iter;
  out.polish = s->polish != 0;
  return out;
}

// Objective scaling by the equilibration (reference pogs.cpp:608-617; same
// as pogs_tpu/prox/vector.py scale_f / scale_g), with the convexity clamps
// c,e >= 0 (prox_lib.h:62-69).
struct ScaledObjective {
  std::vector<std::int32_t> h;
  std::vector<double> a, b, c, d, e;

  template <typename T>
  void load(std::size_t n, const std::int32_t* hh, const T* aa, const T* bb,
            const T* cc, const T* dd, const T* ee) {
    h.assign(hh, hh + n);
    a.resize(n); b.resize(n); c.resize(n); d.resize(n); e.resize(n);
    for (std::size_t i = 0; i < n; ++i) {
      a[i] = aa ? double(aa[i]) : 1.0;
      b[i] = bb ? double(bb[i]) : 0.0;
      c[i] = std::max(cc ? double(cc[i]) : 1.0, 0.0);
      d[i] = dd ? double(dd[i]) : 0.0;
      e[i] = std::max(ee ? double(ee[i]) : 0.0, 0.0);
    }
  }

  // f scales by the row equilibration d: a,d /= d_i, e /= d_i^2.
  void scale_rows(const std::vector<double>& drow) {
    for (std::size_t i = 0; i < h.size(); ++i) {
      a[i] /= drow[i];
      d[i] /= drow[i];
      e[i] /= drow[i] * drow[i];
    }
  }

  // g scales by the column equilibration e: a,d *= e_j, e *= e_j^2.
  void scale_cols(const std::vector<double>& ecol) {
    for (std::size_t j = 0; j < h.size(); ++j) {
      a[j] *= ecol[j];
      d[j] *= ecol[j];
      e[j] *= ecol[j] * ecol[j];
    }
  }

  pn::FunctionArrays<double> view() const {
    return {h.data(), a.data(), b.data(), c.data(), d.data(), e.data()};
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// Dense handle.
// ---------------------------------------------------------------------------

struct PogsNativeDense {
  std::size_t m = 0, n = 0;
  std::vector<double> A;  // row-major, equilibrated in place on init
  std::vector<double> Asq;  // |A|^2, built for equilibration, then freed
  std::vector<double> d, e;
  double norm_A = 1.0;
  pn::DirectFactor factor;
  bool initialized = false;
  bool init_failed = false;
  pn::WarmState warm;

  pn::LinOp linop() {
    pn::LinOp op;
    op.m = m;
    op.n = n;
    double* Ap = A.data();
    const std::size_t mm = m, nn = n;
    op.mv = [Ap, mm, nn](const double* x, double* y) {
      pn::gemv(mm, nn, Ap, x, y);
    };
    op.rmv = [Ap, mm, nn](const double* x, double* y) {
      pn::gemv_t(mm, nn, Ap, x, y);
    };
    // Sinkhorn runs 50 iterations of sq_mv/sq_rmv: use the precomputed
    // |A|^2 when available (built in ensure_init, freed after) so each
    // pass is a plain gemv instead of squaring every element again.
    const double* Sq = Asq.empty() ? nullptr : Asq.data();
    op.sq_mv = [Ap, Sq, mm, nn](const double* x, double* y) {
      if (Sq) { pn::gemv(mm, nn, Sq, x, y); return; }
      for (std::size_t i = 0; i < mm; ++i) {
        double acc = 0.0;
        const double* row = Ap + i * nn;
        for (std::size_t j = 0; j < nn; ++j) acc += row[j] * row[j] * x[j];
        y[i] = acc;
      }
    };
    op.sq_rmv = [Ap, Sq, mm, nn](const double* x, double* y) {
      if (Sq) { pn::gemv_t(mm, nn, Sq, x, y); return; }
      std::vector<double> acc(nn, 0.0);
      for (std::size_t i = 0; i < mm; ++i) {
        const double* row = Ap + i * nn;
        for (std::size_t j = 0; j < nn; ++j) acc[j] += row[j] * row[j] * x[i];
      }
      for (std::size_t j = 0; j < nn; ++j) y[j] = acc[j];
    };
    op.rescale = [Ap, mm, nn](const double* dd, const double* ee, double s) {
      for (std::size_t i = 0; i < mm; ++i) {
        double* row = Ap + i * nn;
        for (std::size_t j = 0; j < nn; ++j) row[j] *= dd[i] * ee[j] * s;
      }
    };
    return op;
  }

  bool ensure_init() {
    if (initialized) return !init_failed;
    initialized = true;
    Asq.resize(m * n);
    for (std::size_t k = 0; k < m * n; ++k) Asq[k] = A[k] * A[k];
    pn::LinOp op = linop();
    pn::equilibrate(op, 0.0, d, e);
    Asq.clear();               // stale after the in-place rescale of A
    Asq.shrink_to_fit();
    op = linop();              // rebind without the |A|^2 fast path
    norm_A = pn::norm2_est(op);
    init_failed = !pn::direct_init(m, n, A.data(), factor);
    return !init_failed;
  }
};

extern "C" PogsNativeDense* pogs_native_dense_new(int32_t ord, size_t m,
                                                  size_t n, const double* A) {
  if (!A || m == 0 || n == 0) return nullptr;
  auto* s = new (std::nothrow) PogsNativeDense;
  if (!s) return nullptr;
  s->m = m;
  s->n = n;
  s->A.resize(m * n);
  if (ord == POGS_NATIVE_ROW_MAJ) {
    std::copy(A, A + m * n, s->A.begin());
  } else {
    for (size_t i = 0; i < m; ++i)
      for (size_t j = 0; j < n; ++j) s->A[i * n + j] = A[j * m + i];
  }
  return s;
}

extern "C" void pogs_native_dense_free(PogsNativeDense* s) { delete s; }

namespace {

template <typename Handle, typename ProjectFn>
int32_t run_solve(Handle* s, ProjectFn&& project, const PogsNativeSettings* cs,
                  const ScaledObjective& fobj_in, const ScaledObjective& gobj_in,
                  double* x, double* y, double* mu, double* nu,
                  PogsNativeInfo* info, const pn::LinOp& op) {
  ScaledObjective fobj = fobj_in;
  ScaledObjective gobj = gobj_in;
  fobj.scale_rows(s->d);
  gobj.scale_cols(s->e);

  pn::Settings st = to_settings(cs);
  if (!cs || !cs->warm_start) {
    s->warm.z.clear();
    s->warm.zt.clear();
    s->warm.rho = 0.0;
  }

  const std::size_t m = s->m, n = s->n;
  std::vector<double> x12(n), y12(m), mus(n), nus(m);
  pn::Info res = pn::admm_solve(op, s->norm_A, fobj.view(), gobj.view(),
                                project, st, s->warm, x12.data(), y12.data(),
                                mus.data(), nus.data());

  // Unscale to the original space (pogs.cpp:509-518).
  for (std::size_t j = 0; j < n; ++j) {
    if (x) x[j] = x12[j] * s->e[j];
    if (mu) mu[j] = mus[j] / s->e[j];
  }
  for (std::size_t i = 0; i < m; ++i) {
    if (y) y[i] = y12[i] / s->d[i];
    if (nu) nu[i] = nus[i] * s->d[i];
  }
  if (info) {
    info->optval = res.optval;
    info->final_iter = res.final_iter;
    info->status = res.status;
    info->nrm_r = res.nrm_r;
    info->nrm_s = res.nrm_s;
    info->gap = res.gap;
    info->rho_final = res.rho_final;
  }
  return res.status;
}

}  // namespace

extern "C" int32_t pogs_native_dense_solve(
    PogsNativeDense* s, const PogsNativeSettings* settings,
    const int32_t* f_h, const double* f_a, const double* f_b,
    const double* f_c, const double* f_d, const double* f_e,
    const int32_t* g_h, const double* g_a, const double* g_b,
    const double* g_c, const double* g_d, const double* g_e,
    double* x, double* y, double* mu, double* nu, PogsNativeInfo* info) {
  if (!s || !f_h || !g_h) return POGS_NATIVE_ERROR;
  if (!s->ensure_init()) return POGS_NATIVE_ERROR;

  ScaledObjective fobj, gobj;
  fobj.load(s->m, f_h, f_a, f_b, f_c, f_d, f_e);
  gobj.load(s->n, g_h, g_a, g_b, g_c, g_d, g_e);

  const pn::DirectFactor& fac = s->factor;
  auto project = [&fac](const double* x0, const double* y0, double /*tol*/,
                        double* px, double* py) {
    pn::direct_project(fac, x0, y0, px, py);
  };
  pn::LinOp op = s->linop();
  return run_solve(s, project, settings, fobj, gobj, x, y, mu, nu, info, op);
}

// ---------------------------------------------------------------------------
// Sparse CSR handle (CGLS projector).
// ---------------------------------------------------------------------------

struct PogsNativeSparse {
  std::size_t m = 0, n = 0;
  std::vector<long long> indptr, indices;
  std::vector<double> data;
  std::vector<double> d, e;
  double norm_A = 1.0;
  bool initialized = false;
  pn::WarmState warm;
  int cgls_max_iter = 500;

  pn::Csr<double> csr() const {
    return {m, n, indptr.data(), indices.data(), data.data()};
  }

  pn::LinOp linop() {
    pn::LinOp op;
    op.m = m;
    op.n = n;
    auto* self = this;
    op.mv = [self](const double* x, double* y) { pn::spmv(self->csr(), x, y); };
    op.rmv = [self](const double* x, double* y) {
      pn::spmv_t(self->csr(), x, y);
    };
    op.sq_mv = [self](const double* x, double* y) {
      const auto A = self->csr();
      for (std::size_t i = 0; i < A.m; ++i) {
        double acc = 0.0;
        for (long long p = A.indptr[i]; p < A.indptr[i + 1]; ++p)
          acc += A.data[p] * A.data[p] * x[A.indices[p]];
        y[i] = acc;
      }
    };
    op.sq_rmv = [self](const double* x, double* y) {
      const auto A = self->csr();
      std::vector<double> acc(A.n, 0.0);
      for (std::size_t i = 0; i < A.m; ++i)
        for (long long p = A.indptr[i]; p < A.indptr[i + 1]; ++p)
          acc[A.indices[p]] += A.data[p] * A.data[p] * x[i];
      for (std::size_t j = 0; j < A.n; ++j) y[j] = acc[j];
    };
    op.rescale = [self](const double* dd, const double* ee, double sc) {
      const auto& ip = self->indptr;
      for (std::size_t i = 0; i < self->m; ++i)
        for (long long p = ip[i]; p < ip[i + 1]; ++p)
          self->data[p] *= dd[i] * ee[self->indices[p]] * sc;
    };
    return op;
  }

  void ensure_init() {
    if (initialized) return;
    initialized = true;
    pn::LinOp op = linop();
    pn::equilibrate(op, 0.0, d, e);
    norm_A = pn::norm2_est(op);
  }
};

extern "C" PogsNativeSparse* pogs_native_sparse_new(size_t m, size_t n,
                                                    size_t nnz,
                                                    const int64_t* indptr,
                                                    const int64_t* indices,
                                                    const double* data) {
  if (!indptr || !indices || !data || m == 0 || n == 0) return nullptr;
  auto* s = new (std::nothrow) PogsNativeSparse;
  if (!s) return nullptr;
  s->m = m;
  s->n = n;
  s->indptr.assign(indptr, indptr + m + 1);
  s->indices.assign(indices, indices + nnz);
  s->data.assign(data, data + nnz);
  return s;
}

extern "C" void pogs_native_sparse_free(PogsNativeSparse* s) { delete s; }

extern "C" int32_t pogs_native_sparse_solve(
    PogsNativeSparse* s, const PogsNativeSettings* settings,
    const int32_t* f_h, const double* f_a, const double* f_b,
    const double* f_c, const double* f_d, const double* f_e,
    const int32_t* g_h, const double* g_a, const double* g_b,
    const double* g_c, const double* g_d, const double* g_e,
    double* x, double* y, double* mu, double* nu, PogsNativeInfo* info) {
  if (!s || !f_h || !g_h) return POGS_NATIVE_ERROR;
  s->ensure_init();
  s->cgls_max_iter = settings ? settings->cgls_max_iter : 500;

  ScaledObjective fobj, gobj;
  fobj.load(s->m, f_h, f_a, f_b, f_c, f_d, f_e);
  gobj.load(s->n, g_h, g_a, g_b, g_c, g_d, g_e);

  pn::LinOp op = s->linop();
  const int cg_max = s->cgls_max_iter;
  auto project = [&op, cg_max](const double* x0, const double* y0, double tol,
                               double* px, double* py) {
    pn::cgls_project(op, x0, y0, tol, cg_max, px, py);
  };
  return run_solve(s, project, settings, fobj, gobj, x, y, mu, nu, info, op);
}

// ---------------------------------------------------------------------------
// Cone-form handle (graph-form cone ADMM, exact-tol mode).
// Mirrors pogs_tpu/solver/cone.py (the non-HSDE path) and the reference's
// PogsObjectiveCone (src/cpu/pogs.cpp:642-785).
// ---------------------------------------------------------------------------

struct PogsNativeConeSolver {
  // Dense backing (direct projector) or sparse CSR backing (CGLS).
  PogsNativeDense dense;
  PogsNativeSparse sp;
  bool is_sparse = false;
  pn::ConeSetNative Kx, Ky;

  // Quadratic objective (QP): min ½xᵀPx + cᵀx.  Counterpart of the
  // reference's PogsConeQD/QS & Direct variants (pogs_c.h:167-243) — but
  // solved through the graph-form cone ADMM whose quadratic x-prox
  // (cached Cholesky of P+ρI, pogs.cpp:687-712) actually converges; the
  // reference routes empty-Kx QPs to its HSDE, which its own code
  // declares broken for QP (pogs.cpp:1510-1514).
  bool has_qp = false;
  std::vector<double> P;          // n x n, row-major, original space
  std::vector<double> P_s;        // E P E (built at first solve)
  std::vector<double> qp_factor;  // Cholesky of P_s/sigma + rho I
  double qp_rho = -1.0;           // rho the factor was built for
  double qp_factor_sigma = -1.0;  // sigma the factor was built for
  double qp_p_norm = -1.0;        // ||P_s||_2 power-method estimate
  bool qp_factor_failed = false;  // Cholesky of P_s + rho I failed

  std::size_t m() const { return is_sparse ? sp.m : dense.m; }
  std::size_t n() const { return is_sparse ? sp.n : dense.n; }
  std::vector<double>& d() { return is_sparse ? sp.d : dense.d; }
  std::vector<double>& e() { return is_sparse ? sp.e : dense.e; }
  pn::WarmState& warm() { return is_sparse ? sp.warm : dense.warm; }
  double norm_A() const { return is_sparse ? sp.norm_A : dense.norm_A; }
  pn::LinOp linop() { return is_sparse ? sp.linop() : dense.linop(); }

  bool ensure_init() {
    bool& initialized = is_sparse ? sp.initialized : dense.initialized;
    if (initialized) return is_sparse || !dense.init_failed;
    initialized = true;
    if (!is_sparse) {
      dense.Asq.resize(dense.m * dense.n);
      for (std::size_t k = 0; k < dense.m * dense.n; ++k)
        dense.Asq[k] = dense.A[k] * dense.A[k];
    }
    pn::LinOp op = linop();
    // Cone-averaged Sinkhorn constraints (pogs.cpp:758-782).
    pn::equilibrate(
        op, 0.0, d(), e(),
        [this](std::vector<double>& w) { Ky.constrain_average(w); },
        [this](std::vector<double>& w) { Kx.constrain_average(w); });
    if (is_sparse) {
      sp.norm_A = pn::norm2_est(op);
      return true;
    }
    dense.Asq.clear();         // stale after the in-place rescale of A
    dense.Asq.shrink_to_fit();
    op = linop();              // rebind without the |A|^2 fast path
    dense.norm_A = pn::norm2_est(op);
    dense.init_failed =
        !pn::direct_init(dense.m, dense.n, dense.A.data(), dense.factor);
    return !dense.init_failed;
  }
};

namespace {

bool load_cones(const PogsNativeCone* cones, size_t count, size_t dim,
                pn::ConeSetNative& out) {
  out.dim = dim;
  std::vector<bool> seen(dim, false);
  for (size_t k = 0; k < count; ++k) {
    const PogsNativeCone& c = cones[k];
    if (c.cone < 0 || c.cone > pn::kConeExpDual) return false;
    // SDP blocks must have a triangular-number packed length (svec).
    if (c.cone == pn::kConeSdp &&
        pn::sdp_side_from_packed(c.num_indices) == 0)
      return false;
    if ((c.cone == pn::kConeExpPrimal || c.cone == pn::kConeExpDual) &&
        c.num_indices != 3)
      return false;
    pn::ConeConstraintNative cc;
    cc.cone = c.cone;
    cc.indices.reserve(c.num_indices);
    for (size_t i = 0; i < c.num_indices; ++i) {
      const int64_t idx = c.indices[i];
      if (idx < 0 || size_t(idx) >= dim || seen[idx]) return false;
      seen[idx] = true;
      cc.indices.push_back(size_t(idx));
    }
    out.constraints.push_back(std::move(cc));
  }
  return true;
}

}  // namespace

extern "C" PogsNativeConeSolver* pogs_native_cone_new(
    int32_t ord, size_t m, size_t n, const double* A,
    const PogsNativeCone* Kx, size_t num_Kx,
    const PogsNativeCone* Ky, size_t num_Ky) {
  if (!A || m == 0 || n == 0) return nullptr;
  auto* s = new (std::nothrow) PogsNativeConeSolver;
  if (!s) return nullptr;
  s->dense.m = m;
  s->dense.n = n;
  s->dense.A.resize(m * n);
  if (ord == POGS_NATIVE_ROW_MAJ) {
    std::copy(A, A + m * n, s->dense.A.begin());
  } else {
    for (size_t i = 0; i < m; ++i)
      for (size_t j = 0; j < n; ++j) s->dense.A[i * n + j] = A[j * m + i];
  }
  if (!load_cones(Kx, num_Kx, n, s->Kx) ||
      !load_cones(Ky, num_Ky, m, s->Ky)) {
    delete s;
    return nullptr;
  }
  return s;
}

extern "C" void pogs_native_cone_free(PogsNativeConeSolver* s) { delete s; }

extern "C" PogsNativeConeSolver* pogs_native_cone_sparse_new(
    size_t m, size_t n, size_t nnz,
    const int64_t* indptr, const int64_t* indices, const double* data,
    const PogsNativeCone* Kx, size_t num_Kx,
    const PogsNativeCone* Ky, size_t num_Ky) {
  if (!indptr || !indices || !data || m == 0 || n == 0) return nullptr;
  auto* s = new (std::nothrow) PogsNativeConeSolver;
  if (!s) return nullptr;
  s->is_sparse = true;
  s->sp.m = m;
  s->sp.n = n;
  s->sp.indptr.assign(indptr, indptr + m + 1);
  s->sp.indices.assign(indices, indices + nnz);
  s->sp.data.assign(data, data + nnz);
  if (!load_cones(Kx, num_Kx, n, s->Kx) ||
      !load_cones(Ky, num_Ky, m, s->Ky)) {
    delete s;
    return nullptr;
  }
  return s;
}

static bool qp_matrix_ok(std::size_t n, const double* P) {
  // Reject NaN/Inf entries and gross asymmetry up front: a bad P would
  // otherwise surface only as a Cholesky failure deep in the solve, and
  // a silent fallback there would return SUCCESS for the wrong problem
  // (the LP with P dropped).  PSD-ness proper is checked by the first
  // factorization (P + rho I), which flips qp_factor_failed.
  double scale = 0.0;
  for (std::size_t k = 0; k < n * n; ++k) {
    if (!std::isfinite(P[k])) return false;
    scale = std::max(scale, std::abs(P[k]));
  }
  const double tol = 1e-8 * std::max(scale, 1.0);
  for (std::size_t i = 0; i < n; ++i)
    for (std::size_t j = i + 1; j < n; ++j)
      if (std::abs(P[i * n + j] - P[j * n + i]) > tol) return false;
  return true;
}

extern "C" PogsNativeConeSolver* pogs_native_cone_qp_new(
    int32_t ord, size_t m, size_t n, const double* A, const double* P,
    const PogsNativeCone* Ky, size_t num_Ky) {
  // QP variant: min ½xᵀPx + cᵀx s.t. b − Ax ∈ K_y (counterpart of
  // PogsConeQD/PogsConeDirectQD, pogs_c.h:178-243).  K_x must be empty:
  // composing the quadratic x-prox with a cone projection is not the
  // exact prox of (quadratic + indicator); the reference rejects the
  // combination for the same reason (pogs.cpp:1941-1944).
  if (!P || !qp_matrix_ok(n, P)) return nullptr;
  PogsNativeConeSolver* s =
      pogs_native_cone_new(ord, m, n, A, nullptr, 0, Ky, num_Ky);
  if (!s) return nullptr;
  s->has_qp = true;
  s->P.resize(n * n);
  if (ord == POGS_NATIVE_ROW_MAJ) {
    std::copy(P, P + n * n, s->P.begin());
  } else {
    for (size_t i = 0; i < n; ++i)
      for (size_t j = 0; j < n; ++j) s->P[i * n + j] = P[j * n + i];
  }
  return s;
}

extern "C" PogsNativeConeSolver* pogs_native_cone_qp_sparse_new(
    size_t m, size_t n, size_t nnz,
    const int64_t* indptr, const int64_t* indices, const double* data,
    const double* P, const PogsNativeCone* Ky, size_t num_Ky) {
  // Sparse-A QP (CGLS projector) — the reference supports this pairing
  // via PogsConeQD over MatrixSparse (pogs_c.cpp:208-305).
  if (!P || !qp_matrix_ok(n, P)) return nullptr;
  PogsNativeConeSolver* s = pogs_native_cone_sparse_new(
      m, n, nnz, indptr, indices, data, nullptr, 0, Ky, num_Ky);
  if (!s) return nullptr;
  s->has_qp = true;
  s->P.assign(P, P + n * n);
  return s;
}

extern "C" int32_t pogs_native_cone_solve(
    PogsNativeConeSolver* s, const PogsNativeSettings* settings,
    const double* b, const double* c,
    double* x, double* y, double* mu, double* nu, PogsNativeInfo* info) {
  if (!s || !b || !c) return POGS_NATIVE_ERROR;
  if (!s->ensure_init()) return POGS_NATIVE_ERROR;
  const std::size_t m = s->m(), n = s->n();

  // Scale by the equilibration (pogs.cpp:1463-1475, 723-726) and normalize
  // c to unit norm, folding the scale into the optval (pogs.cpp:738-755).
  // QP keeps c unnormalized: rescaling c but not P would change the
  // optimizer, not just the objective scale.
  std::vector<double> b_s(m), c_n(n);
  for (std::size_t i = 0; i < m; ++i) b_s[i] = b[i] * s->d()[i];
  double c_nrm = 0.0;
  for (std::size_t j = 0; j < n; ++j) {
    c_n[j] = c[j] * s->e()[j];
    c_nrm += c_n[j] * c_n[j];
  }
  c_nrm = std::sqrt(c_nrm);
  const double c_scale =
      (!s->has_qp && c_nrm > 0) ? 1.0 / std::max(c_nrm, 1e-30) : 1.0;
  for (auto& v : c_n) v *= c_scale;

  if (s->has_qp && s->P_s.empty()) {
    // P ← E P E (pogs.cpp:727-736), cached: e is fixed after init.
    s->P_s.resize(n * n);
    for (std::size_t i = 0; i < n; ++i)
      for (std::size_t j = 0; j < n; ++j)
        s->P_s[i * n + j] = s->P[i * n + j] * s->e()[i] * s->e()[j];
  }
  // QP objective normalization: divide the WHOLE objective (c and P
  // together — same argmin) by sigma = max(||P_s||_2, ||c_s||); without
  // it an O(1e6)-scale P dwarfs the unit-scale equilibrated constraints
  // and the rho~1 ADMM stalls with O(1) residuals.  sigma folds back
  // into optval via c_scale; reported duals are rescaled below.
  double qp_sigma = 1.0;
  if (s->has_qp) {
    if (s->qp_p_norm < 0.0) {
      pn::LinOp pop;
      pop.m = n;
      pop.n = n;
      const double* Pp = s->P_s.data();
      pop.mv = [Pp, n](const double* v, double* out) {
        pn::gemv(n, n, Pp, v, out);
      };
      pop.rmv = pop.mv;  // symmetric
      s->qp_p_norm = pn::norm2_est(pop, 30);
    }
    qp_sigma = std::max(std::max(s->qp_p_norm, c_nrm), 1e-12);
    for (auto& v : c_n) v /= qp_sigma;
  }

  pn::Settings st = to_settings(settings);
  st.use_exact_tol = true;
  if (!settings || !settings->warm_start) {
    s->warm().z.clear();
    s->warm().zt.clear();
    s->warm().rho = 0.0;
  }

  pn::ProxCallbacks prox;
  const pn::ConeSetNative& Kx = s->Kx;
  const pn::ConeSetNative& Ky = s->Ky;
  if (s->has_qp) {
    prox.prox_x = [s, &c_n, n, qp_sigma](const double* v, double rho,
                                          double* out) {
      // Quadratic x-step: (P_s/σ + ρI) x = ρv − c (pogs.cpp:687-712);
      // the Cholesky factor is cached and rebuilt only on ρ/σ change.
      if (rho != s->qp_rho || qp_sigma != s->qp_factor_sigma) {
        s->qp_factor = s->P_s;
        for (auto& pv : s->qp_factor) pv /= qp_sigma;
        for (std::size_t j = 0; j < n; ++j) s->qp_factor[j * n + j] += rho;
        if (!pn::cholesky(n, s->qp_factor.data())) {
          // P + ρI should be SPD for a valid (symmetric, PSD-ish) P —
          // qp_matrix_ok screens NaN/asymmetry at construction, so a
          // failure here means P is badly indefinite.  Record it and
          // keep iterating on a regularized identity factor; the solve
          // entry downgrades the final status to NAN_FOUND so the
          // caller can never mistake the P-dropped solution for SUCCESS.
          s->qp_factor_failed = true;
          s->qp_factor.assign(n * n, 0.0);
          for (std::size_t j = 0; j < n; ++j)
            s->qp_factor[j * n + j] = std::sqrt(rho);
        }
        s->qp_rho = rho;
        s->qp_factor_sigma = qp_sigma;
      }
      std::vector<double> rhs(n);
      for (std::size_t j = 0; j < n; ++j) rhs[j] = rho * v[j] - c_n[j];
      pn::cholesky_solve(n, s->qp_factor.data(), rhs.data(), out);
    };
  } else {
    prox.prox_x = [&](const double* v, double rho, double* out) {
      // Linear x-step + K_x projection (pogs.cpp:687-721).
      for (std::size_t j = 0; j < n; ++j) out[j] = v[j] - c_n[j] / rho;
      Kx.project(out);
    };
  }
  prox.prox_y = [&](const double* v, double /*rho*/, double* out) {
    // y12 = b - Pi_{K_y}(b - v).
    for (std::size_t i = 0; i < m; ++i) out[i] = b_s[i] - v[i];
    Ky.project(out);
    for (std::size_t i = 0; i < m; ++i) out[i] = b_s[i] - out[i];
  };
  prox.objective = [&](const double* x12, const double* /*y12*/) {
    double acc = 0.0;
    for (std::size_t j = 0; j < n; ++j) acc += c_n[j] * x12[j];
    if (s->has_qp) {
      // + ½ x12ᵀ P_s x12 (equals ½ xᵀPx in the original space: P_s = EPE
      // and x = x12 ∘ e).
      double quad = 0.0;
      for (std::size_t i = 0; i < n; ++i) {
        double row = 0.0;
        for (std::size_t j = 0; j < n; ++j)
          row += s->P_s[i * n + j] * x12[j];
        quad += x12[i] * row;
      }
      acc += 0.5 * quad / qp_sigma;
    }
    return acc * (s->has_qp ? qp_sigma : 1.0 / c_scale);
  };

  pn::LinOp op = s->linop();
  const pn::DirectFactor& fac = s->dense.factor;
  const int cg_max = settings ? settings->cgls_max_iter : 500;
  const bool is_sparse = s->is_sparse;
  auto project = [&fac, &op, cg_max, is_sparse](
                     const double* x0, const double* y0, double tol,
                     double* px, double* py) {
    if (is_sparse) {
      pn::cgls_project(op, x0, y0, tol, cg_max, px, py);
    } else {
      pn::direct_project(fac, x0, y0, px, py);
    }
  };

  std::vector<double> x12(n), y12(m), mus(n), nus(m);
  s->qp_factor_failed = false;
  pn::Info res = pn::admm_solve_impl(op, s->norm_A(), prox, project, st,
                                     s->warm(), &s->d(), &s->e(),
                                     x12.data(), y12.data(), mus.data(),
                                     nus.data());
  if (s->qp_factor_failed) {
    // The quadratic x-prox fell back to an identity step at least once:
    // whatever came out solved a different problem.  Never SUCCESS.
    res.status = POGS_NATIVE_NAN_FOUND;
  }
  // The QP solve ran on the sigma-normalized objective: its duals (and
  // nothing else) are 1/sigma times the original problem's.
  const double dual_scale = s->has_qp ? qp_sigma : 1.0;
  for (std::size_t j = 0; j < n; ++j) {
    if (x) x[j] = x12[j] * s->e()[j];
    if (mu) mu[j] = mus[j] / s->e()[j] * dual_scale;
  }
  for (std::size_t i = 0; i < m; ++i) {
    if (y) y[i] = y12[i] / s->d()[i];
    if (nu) nu[i] = nus[i] * s->d()[i] * dual_scale;
  }
  // PDAS active-set polish (qp_polish.hpp): dense-A QPs over polyhedral
  // K_y finish with a direct KKT refinement in the ORIGINAL space —
  // rescues ill-conditioned instances that stall at ADMM accuracy.
  if (s->has_qp && !s->is_sparse && st.polish && !s->qp_factor_failed &&
      (res.status == POGS_NATIVE_SUCCESS ||
       res.status == POGS_NATIVE_MAX_ITER) &&
      x && nu) {
    std::vector<std::int8_t> kind;
    if (pn::qp_row_kinds(s->Ky, m, kind)) {
      // Reconstruct the original A from the in-place equilibrated copy:
      // A_eq = D' A E' with the stored (already √norm_a-folded) d/e.
      std::vector<double> A_orig(m * n);
      for (std::size_t i = 0; i < m; ++i)
        for (std::size_t j = 0; j < n; ++j)
          A_orig[i * n + j] =
              s->dense.A[i * n + j] / (s->d()[i] * s->e()[j]);
      const double tol =
          std::max(st.abs_tol, st.rel_tol) > 0
              ? std::max(st.abs_tol, st.rel_tol) : 1e-6;
      std::vector<double> x_pol, lam_pol;
      pn::QpKktResiduals pres;
      if (pn::qp_active_set_polish(m, n, s->P.data(), c, A_orig.data(), b,
                                   kind, x, nu, tol, x_pol, lam_pol,
                                   pres)) {
        for (std::size_t j = 0; j < n; ++j) x[j] = x_pol[j];
        for (std::size_t i = 0; i < m; ++i) {
          nu[i] = lam_pol[i];
          if (y) {
            double acc = 0.0;
            for (std::size_t j = 0; j < n; ++j)
              acc += A_orig[i * n + j] * x_pol[j];
            y[i] = acc;
          }
        }
        double lin = 0.0, quad = 0.0;
        std::vector<double> Px(n);
        pn::gemv(n, n, s->P.data(), x_pol.data(), Px.data());
        for (std::size_t j = 0; j < n; ++j) {
          lin += c[j] * x_pol[j];
          quad += x_pol[j] * Px[j];
        }
        res.optval = lin + 0.5 * quad;
        res.status = POGS_NATIVE_SUCCESS;
        res.nrm_r = pres.pri;
        res.nrm_s = pres.stat;
      }
    }
  }
  if (info) {
    info->optval = res.optval;
    info->final_iter = res.final_iter;
    info->status = res.status;
    info->nrm_r = res.nrm_r;
    info->nrm_s = res.nrm_s;
    info->gap = res.gap;
    info->rho_final = res.rho_final;
  }
  return res.status;
}

// ---------------------------------------------------------------------------
// One-shot entry points.
// ---------------------------------------------------------------------------

extern "C" int32_t pogs_native_solve_dense_d(
    int32_t ord, size_t m, size_t n, const double* A,
    const PogsNativeSettings* settings,
    const int32_t* f_h, const double* f_a, const double* f_b,
    const double* f_c, const double* f_d, const double* f_e,
    const int32_t* g_h, const double* g_a, const double* g_b,
    const double* g_c, const double* g_d, const double* g_e,
    double* x, double* y, double* mu, double* nu, PogsNativeInfo* info) {
  std::unique_ptr<PogsNativeDense, void (*)(PogsNativeDense*)> s(
      pogs_native_dense_new(ord, m, n, A), pogs_native_dense_free);
  if (!s) return POGS_NATIVE_ERROR;
  return pogs_native_dense_solve(s.get(), settings, f_h, f_a, f_b, f_c, f_d,
                                 f_e, g_h, g_a, g_b, g_c, g_d, g_e, x, y, mu,
                                 nu, info);
}

extern "C" int32_t pogs_native_solve_dense_s(
    int32_t ord, size_t m, size_t n, const float* A,
    const PogsNativeSettings* settings,
    const int32_t* f_h, const float* f_a, const float* f_b,
    const float* f_c, const float* f_d, const float* f_e,
    const int32_t* g_h, const float* g_a, const float* g_b,
    const float* g_c, const float* g_d, const float* g_e,
    float* x, float* y, float* mu, float* nu, PogsNativeInfo* info) {
  // Single precision promotes to the double core (the host runtime always
  // iterates in f64; f32 is an accelerator-side concern).
  std::vector<double> Ad(A, A + m * n);
  auto up = [](const float* p, size_t len) {
    std::vector<double> v;
    if (p) v.assign(p, p + len);
    return v;
  };
  std::vector<double> fa = up(f_a, m), fb = up(f_b, m), fc = up(f_c, m),
                      fd = up(f_d, m), fe = up(f_e, m);
  std::vector<double> ga = up(g_a, n), gb = up(g_b, n), gc = up(g_c, n),
                      gd = up(g_d, n), ge = up(g_e, n);
  std::vector<double> xd(n), yd(m), mud(n), nud(m);
  PogsNativeInfo inf;
  const int32_t status = pogs_native_solve_dense_d(
      ord, m, n, Ad.data(), settings, f_h,
      f_a ? fa.data() : nullptr, f_b ? fb.data() : nullptr,
      f_c ? fc.data() : nullptr, f_d ? fd.data() : nullptr,
      f_e ? fe.data() : nullptr, g_h,
      g_a ? ga.data() : nullptr, g_b ? gb.data() : nullptr,
      g_c ? gc.data() : nullptr, g_d ? gd.data() : nullptr,
      g_e ? ge.data() : nullptr, xd.data(), yd.data(), mud.data(), nud.data(),
      &inf);
  for (size_t j = 0; j < n; ++j) {
    if (x) x[j] = float(xd[j]);
    if (mu) mu[j] = float(mud[j]);
  }
  for (size_t i = 0; i < m; ++i) {
    if (y) y[i] = float(yd[i]);
    if (nu) nu[i] = float(nud[i]);
  }
  if (info) *info = inf;
  return status;
}

extern "C" int32_t pogs_native_lasso_cd(
    size_t m, size_t n, const double* A, const double* b,
    const double* l1, const double* l2,
    const PogsNativeSettings* settings,
    double* x, double* y, double* mu, double* nu, PogsNativeInfo* info) {
  if (!A || !b || !l1 || !x) return POGS_NATIVE_ERROR;
  PogsNativeSettings st;
  if (settings) st = *settings;
  else pogs_native_settings_default(&st);
  std::vector<double> l2v;
  if (!l2) {
    l2v.assign(n, 0.0);
    l2 = l2v.data();
  }
  if (!st.warm_start) std::memset(x, 0, n * sizeof(double));
  double l1_max = 0.0;
  for (size_t j = 0; j < n; ++j) l1_max = std::max(l1_max, l1[j]);
  // KKT stop scaled like the benchmark's relative-to-lambda metric:
  // abs_tol * (1 + max l1) keeps the default 1e-4 meaning "1e-4 of the
  // soft-threshold level" on unit-scale problems.
  const double tol_kkt = st.abs_tol * (1.0 + l1_max);
  std::vector<double> r(m);
  pogs_native::CdResult res = pogs_native::cd_elastic_net(
      m, n, A, b, l1, l2, /*tol_move=*/1e-3 * st.abs_tol + 1e-10, tol_kkt,
      st.max_iter, x, r.data());
  if (y || nu)
    for (size_t i = 0; i < m; ++i) {
      const double yi = b[i] - r[i];
      if (y) y[i] = yi;
      if (nu) nu[i] = -r[i];
    }
  if (mu)
    for (size_t j = 0; j < n; ++j) {
      double acc = 0.0;
      for (size_t i = 0; i < m; ++i) acc += A[i * n + j] * r[i];
      mu[j] = acc;
    }
  if (info) {
    info->optval = res.optval;
    info->final_iter = res.sweeps;
    info->status = res.converged ? 0 : 3; /* SUCCESS : MAX_ITER */
    info->nrm_r = 0.0;
    info->nrm_s = res.kkt;
    info->gap = 0.0;
    info->rho_final = 0.0;
  }
  return res.converged ? 0 : 3;
}

extern "C" int32_t pogs_native_ridge_direct(
    size_t m, size_t n, const double* A, const double* b, const double* l2,
    double* x, PogsNativeInfo* info) {
  if (!A || !b || !l2 || !x) return POGS_NATIVE_ERROR;
  pogs_native::GlmResult res =
      pogs_native::ridge_direct(m, n, A, b, l2, x);
  if (info) {
    info->optval = res.optval;
    info->final_iter = res.iters;
    info->status = res.converged ? 0 : 5; /* SUCCESS : ERROR */
    info->nrm_r = 0.0;
    info->nrm_s = res.kkt;
    info->gap = 0.0;
    info->rho_final = 0.0;
  }
  return res.converged ? 0 : POGS_NATIVE_ERROR;
}

extern "C" int32_t pogs_native_svm_dual_cd(
    size_t m, size_t n, const double* A, const double* y, double lambda,
    const PogsNativeSettings* settings, double* x, PogsNativeInfo* info) {
  if (!A || !y || !x || lambda <= 0.0) return POGS_NATIVE_ERROR;
  PogsNativeSettings st;
  if (settings) st = *settings;
  else pogs_native_settings_default(&st);
  // Projected-gradient threshold at 0.1x abs_tol: the dual pg-to-
  // primal-objective gap amplifies roughly 10x on margin-heavy
  // problems, so this keeps the default 1e-4 meaning ~1e-4 relative
  // objective accuracy.
  pogs_native::GlmResult res = pogs_native::svm_dual_cd(
      m, n, A, y, lambda, 0.1 * st.abs_tol, st.max_iter, x);
  if (info) {
    info->optval = res.optval;
    info->final_iter = res.iters;
    info->status = res.converged ? 0 : 3; /* SUCCESS : MAX_ITER */
    info->nrm_r = 0.0;
    info->nrm_s = res.kkt;
    info->gap = 0.0;
    info->rho_final = 0.0;
  }
  return res.converged ? 0 : 3;
}

extern "C" int32_t pogs_native_logistic_pn(
    size_t m, size_t n, const double* A, const double* y, const double* l1,
    const PogsNativeSettings* settings, double* x, PogsNativeInfo* info) {
  if (!A || !y || !l1 || !x) return POGS_NATIVE_ERROR;
  PogsNativeSettings st;
  if (settings) st = *settings;
  else pogs_native_settings_default(&st);
  if (!st.warm_start) std::memset(x, 0, n * sizeof(double));
  double l1_max = 0.0;
  for (size_t j = 0; j < n; ++j) l1_max = std::max(l1_max, l1[j]);
  pogs_native::GlmResult res = pogs_native::logistic_prox_newton(
      m, n, A, y, l1, st.abs_tol * (1.0 + l1_max),
      /*max_newton=*/std::min(st.max_iter, 100), /*max_cd_sweeps=*/200, x);
  if (info) {
    info->optval = res.optval;
    info->final_iter = res.iters;
    info->status = res.converged ? 0 : 3;
    info->nrm_r = 0.0;
    info->nrm_s = res.kkt;
    info->gap = 0.0;
    info->rho_final = 0.0;
  }
  return res.converged ? 0 : 3;
}

extern "C" int32_t pogs_native_huber_irls(
    size_t m, size_t n, const double* A, const double* b, double delta,
    const double* l1, const PogsNativeSettings* settings, double* x,
    PogsNativeInfo* info) {
  if (!A || !b || !l1 || !x || delta <= 0.0) return POGS_NATIVE_ERROR;
  PogsNativeSettings st;
  if (settings) st = *settings;
  else pogs_native_settings_default(&st);
  if (!st.warm_start) std::memset(x, 0, n * sizeof(double));
  double l1_max = 0.0;
  for (size_t j = 0; j < n; ++j) l1_max = std::max(l1_max, l1[j]);
  pogs_native::GlmResult res = pogs_native::huber_irls(
      m, n, A, b, delta, l1,
      st.abs_tol * (1.0 + std::max(l1_max, delta)),
      /*max_irls=*/std::min(st.max_iter, 200), /*max_cd_sweeps=*/200, x);
  if (info) {
    info->optval = res.optval;
    info->final_iter = res.iters;
    info->status = res.converged ? 0 : 3;
    info->nrm_r = 0.0;
    info->nrm_s = res.kkt;
    info->gap = 0.0;
    info->rho_final = 0.0;
  }
  return res.converged ? 0 : 3;
}

extern "C" int32_t pogs_native_nnls(
    size_t m, size_t n, const double* A, const double* b,
    const PogsNativeSettings* settings, double* x, PogsNativeInfo* info) {
  if (!A || !b || !x) return POGS_NATIVE_ERROR;
  PogsNativeSettings st;
  if (settings) st = *settings;
  else pogs_native_settings_default(&st);
  pogs_native::GlmResult res =
      pogs_native::nnls_pdas(m, n, A, b, st.abs_tol, x);
  if (info) {
    info->optval = res.optval;
    info->final_iter = res.iters;
    info->status = res.converged ? 0 : 5; /* falls back on !converged */
    info->nrm_r = 0.0;
    info->nrm_s = res.kkt;
    info->gap = 0.0;
    info->rho_final = 0.0;
  }
  return res.converged ? 0 : POGS_NATIVE_ERROR;
}
