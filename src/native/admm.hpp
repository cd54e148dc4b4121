// Graph-form ADMM — native host runtime.
//
// Semantics match the JAX solve loop (pogs_tpu/solver/admm.py) so the two
// runtimes are cross-checkable oracles of each other; both encode the
// reference algorithm (reference: src/cpu/pogs.cpp:90-581, constants
// :94-110): over-relaxation alpha = 1.7, approximate-then-exact residuals,
// adaptive rho (spectral + residual-balancing with xi damping), Sinkhorn
// equilibration, residual-tied projection tolerance, implicit warm start.
//
// The host runtime always iterates in double (the host has fast f64; the
// f32-vs-f64 split is an accelerator concern), so the reference's [1e-4, 1e4] rho
// bounds apply directly.
#pragma once

#include <cmath>
#include <cstdint>
#include <functional>
#include <limits>
#include <vector>

#include "linalg.hpp"
#include "prox.hpp"

namespace pogs_native {

// Exit statuses; values mirror PogsStatus (reference src/include/pogs.h:31-37).
enum Status : std::int32_t {
  kSuccess = 0,
  kInfeasible = 1,
  kUnbounded = 2,
  kMaxIter = 3,
  kNanFound = 4,
  kError = 5,
};

struct Settings {
  double abs_tol = 1e-4;
  double rel_tol = 1e-3;
  double rho = 1.0;
  int max_iter = 2500;
  int verbose = 0;
  bool adaptive_rho = true;
  bool gap_stop = false;
  int cgls_max_iter = 500;
  // Exact-tolerance (cone) mode: alpha = 1.0, residuals measured in the
  // original (unscaled) space via d/e, tighter projection ladder, exact
  // residuals every iteration (reference pogs.cpp:102-110, 210-248).
  bool use_exact_tol = false;
  // QP active-set polish (cone QP path; see qp_polish.hpp).
  bool polish = true;
};

struct Info {
  double optval = 0.0;
  int final_iter = 0;
  std::int32_t status = kError;
  double nrm_r = 0.0, nrm_s = 0.0, gap = 0.0;
  double rho_final = 0.0;
};

// Abstract linear operator: y = A x and x = A^T y.
struct LinOp {
  std::size_t m = 0, n = 0;
  std::function<void(const double*, double*)> mv;   // (x[n]) -> y[m]
  std::function<void(const double*, double*)> rmv;  // (y[m]) -> x[n]
  std::function<void(const double*, double*)> sq_mv;   // |A|^2 x
  std::function<void(const double*, double*)> sq_rmv;  // |A|^2.T y
  // In-place rescale A <- diag(d) A diag(e) * s.
  std::function<void(const double*, const double*, double)> rescale;
};

// --------------------------------------------------------------------------
// Equilibration (reference equil_helper.h:140-164, matrix_dense.cpp:116-200;
// same pipeline as pogs_tpu/linalg/equil.py).
// --------------------------------------------------------------------------

inline void equilibrate(
    LinOp& A, double frob2, std::vector<double>& d, std::vector<double>& e,
    const std::function<void(std::vector<double>&)>& constrain_d = nullptr,
    const std::function<void(std::vector<double>&)>& constrain_e = nullptr) {
  const std::size_t m = A.m, n = A.n;
  const double reg_e = 1e-4 * double(m + n) / double(m);
  const double reg_d = 1e-4 * double(m + n) / double(n);
  d.assign(m, 1.0);
  e.assign(n, 1.0);
  std::vector<double> tmp_m(m), tmp_n(n);
  for (int it = 0; it < 50; ++it) {
    A.sq_rmv(d.data(), tmp_n.data());
    for (std::size_t j = 0; j < n; ++j) tmp_n[j] += reg_e;
    if (constrain_e) constrain_e(tmp_n);
    for (std::size_t j = 0; j < n; ++j) e[j] = double(m) / tmp_n[j];
    A.sq_mv(e.data(), tmp_m.data());
    for (std::size_t i = 0; i < m; ++i) tmp_m[i] += reg_d;
    if (constrain_d) constrain_d(tmp_m);
    for (std::size_t i = 0; i < m; ++i) d[i] = double(n) / tmp_m[i];
  }
  for (auto& v : d) v = std::sqrt(v);
  for (auto& v : e) v = std::sqrt(v);
  // Frobenius normalization of the scaled matrix (matrix_dense.cpp:183-192):
  // ||DAE||_F^2 = sum_ij d_i^2 |a_ij|^2 e_j^2 = d^2 . (|A|^2 e^2).
  std::vector<double> e2(n), col(m);
  for (std::size_t j = 0; j < n; ++j) e2[j] = e[j] * e[j];
  A.sq_mv(e2.data(), col.data());
  double fro2 = 0.0;
  for (std::size_t i = 0; i < m; ++i) fro2 += d[i] * d[i] * col[i];
  (void)frob2;
  double norm_a = std::sqrt(fro2 / double(std::min(m, n)));
  if (norm_a <= 0.0) norm_a = 1.0;  // A = 0: skip normalization
  A.rescale(d.data(), e.data(), 1.0 / norm_a);
  const double s = std::sqrt(norm_a);
  for (auto& v : d) v /= s;
  for (auto& v : e) v /= s;
}

// Power-method spectral-norm estimate (reference equil_helper.h:107-135).
inline double norm2_est(const LinOp& A, int iters = 50) {
  std::vector<double> x(A.n), y(A.m);
  // Deterministic pseudo-random start (xorshift), no <random> dependency.
  std::uint64_t s = 0x9E3779B97F4A7C15ull;
  for (auto& v : x) {
    s ^= s << 13; s ^= s >> 7; s ^= s << 17;
    v = double(s % 10007) / 10007.0 - 0.5;
  }
  double norm = 1.0;
  for (int it = 0; it < iters; ++it) {
    const double nx = nrm2(A.n, x.data());
    if (nx == 0.0) break;
    scal(A.n, 1.0 / nx, x.data());
    A.mv(x.data(), y.data());
    A.rmv(y.data(), x.data());
    const double nrm = nrm2(A.n, x.data());
    if (std::abs(nrm - norm) <= 1e-4 * norm) { norm = nrm; break; }
    norm = nrm;
  }
  return std::sqrt(norm);
}

// --------------------------------------------------------------------------
// Projectors: minimize ||Ax - y0||^2 + s||x - x0||^2 (s = 1 in the loop).
// --------------------------------------------------------------------------

struct DirectFactor {
  bool tall = true;
  std::size_t m = 0, n = 0;
  std::vector<double> L;        // Cholesky factor of (Gram + I), k x k
  std::vector<double> Kinv;     // explicit (Gram + I)^{-1}, k x k — makes
                                // every per-iteration op a row-major gemv
                                // (unrolled/SIMD) instead of two serial
                                // triangular solves; fine at f64 since
                                // cond(Gram + I) <= 1 + ||A||^2 and the
                                // equilibrated A has unit-ish Fro norm
  const double* A = nullptr;    // equilibrated dense A, row-major
  std::vector<double> At;       // transposed copy: A^T row-major (n x m) —
                                // makes A^T y a parallel row-major gemv
                                // (the reference's dual-format trick,
                                // matrix_sparse.cpp:97-128, applied dense)
};

inline bool direct_init(std::size_t m, std::size_t n, const double* A,
                        DirectFactor& fac) {
  fac.tall = m >= n;
  fac.m = m; fac.n = n; fac.A = A;
  fac.At.resize(m * n);
#pragma omp parallel for if (m * n > 16384)
  for (std::size_t i = 0; i < m; ++i)
    for (std::size_t j = 0; j < n; ++j) fac.At[j * m + i] = A[i * n + j];
  const std::size_t k = fac.tall ? n : m;
  fac.L.resize(k * k);
  gram(m, n, A, fac.tall, fac.L.data());
  for (std::size_t i = 0; i < k; ++i) fac.L[i * k + i] += 1.0;
  if (!cholesky(k, fac.L.data())) return false;
  // Explicit inverse via ONE multi-RHS solve of the identity (one-time
  // O(k^3), vectorized across columns; the loop then never runs a
  // triangular solve again).
  fac.Kinv.assign(k * k, 0.0);
  for (std::size_t i = 0; i < k; ++i) fac.Kinv[i * k + i] = 1.0;
  cholesky_solve_multi(k, fac.L.data(), k, fac.Kinv.data());
  return true;
}

inline void direct_project(const DirectFactor& fac, const double* x0,
                           const double* y0, double* x, double* y) {
  const std::size_t m = fac.m, n = fac.n;
  if (fac.tall) {
    // x = (A^T A + I)^{-1} (x0 + A^T y0); y = A x.
    std::vector<double> rhs(n);
    gemv(n, m, fac.At.data(), y0, rhs.data());  // A^T y0, parallel
    axpy(n, 1.0, x0, rhs.data());
    gemv(n, n, fac.Kinv.data(), rhs.data(), x);
    gemv(m, n, fac.A, x, y);
  } else {
    // w = (A A^T + I)^{-1} (A x0 - y0); x = x0 - A^T w; y = y0 + w.
    std::vector<double> rhs(m), w(m), atw(n);
    gemv(m, n, fac.A, x0, rhs.data());
    axpy(m, -1.0, y0, rhs.data());
    gemv(m, m, fac.Kinv.data(), rhs.data(), w.data());
    gemv(n, m, fac.At.data(), w.data(), atw.data());  // A^T w, parallel
    for (std::size_t j = 0; j < n; ++j) x[j] = x0[j] - atw[j];
    for (std::size_t i = 0; i < m; ++i) y[i] = y0[i] + w[i];
  }
}

// CGLS projector for operator/sparse matrices: warm-started delta form
// (reference src/cpu/projector/projector_cgls.cpp:52-88, cgls.h).
// Solves min ||A dx - (y0 - A x0)||^2 + ||dx||^2, then x = x0 + dx, y = A x.
inline void cgls_project(const LinOp& A, const double* x0, const double* y0,
                         double tol, int max_iter, double* x, double* y) {
  const std::size_t m = A.m, n = A.n;
  const double shift = 1.0;  // s = 1
  std::vector<double> b(m), dx(n, 0.0), r(m), s_(n), p(n), q(m);
  A.mv(x0, b.data());
  for (std::size_t i = 0; i < m; ++i) b[i] = y0[i] - b[i];
  // r = b - A dx (dx = 0); s = A^T r - shift dx.
  r = b;
  A.rmv(r.data(), s_.data());
  p = s_;
  double gamma = dot(n, s_.data(), s_.data());
  const double norms0 = std::sqrt(gamma);
  for (int it = 0; it < max_iter && norms0 > 0.0; ++it) {
    A.mv(p.data(), q.data());
    const double delta =
        dot(m, q.data(), q.data()) + shift * dot(n, p.data(), p.data());
    if (delta <= 0.0) break;
    const double alpha = gamma / delta;
    axpy(n, alpha, p.data(), dx.data());
    axpy(m, -alpha, q.data(), r.data());
    A.rmv(r.data(), s_.data());
    axpy(n, -shift, dx.data(), s_.data());
    const double gamma_new = dot(n, s_.data(), s_.data());
    if (std::sqrt(gamma_new) <= tol * norms0) break;
    const double beta = gamma_new / gamma;
    for (std::size_t j = 0; j < n; ++j) p[j] = s_[j] + beta * p[j];
    gamma = gamma_new;
  }
  for (std::size_t j = 0; j < n; ++j) x[j] = x0[j] + dx[j];
  A.mv(x, y);
}

// --------------------------------------------------------------------------
// The ADMM loop.  z layout: [x (n) ; y (m)] (matches the Python solver).
// --------------------------------------------------------------------------

struct WarmState {
  std::vector<double> z, zt;  // empty => cold start
  double rho = 0.0;           // 0 => use settings.rho
};

// Generic proximal interface: the separable objective uses FunctionArrays;
// the cone objective supplies its own callables.
struct ProxCallbacks {
  // (v, rho, out) for the x-part (length n) and y-part (length m).
  std::function<void(const double*, double, double*)> prox_x, prox_y;
  std::function<double(const double*, const double*)> objective;  // (x12, y12)
};

template <typename ProjectFn>
inline Info admm_solve_impl(const LinOp& A, double norm_A,
                            const ProxCallbacks& prox, ProjectFn&& project,
                            const Settings& st, WarmState& warm,
                            const std::vector<double>* d_scale,
                            const std::vector<double>* e_scale,
                            double* x12_out, double* y12_out,
                            double* mu_out, double* nu_out) {
  // Constants: reference pogs.cpp:94-110.
  const bool exact_mode = st.use_exact_tol;
  const double kDeltaMin = 1.05, kGamma = 1.01, kTau = 0.8;
  const double kRhoMin = 1e-4, kRhoMax = 1e4, kKappa = 0.9;
  const double kProjTolMax = exact_mode ? 1e-10 : 1e-8;
  const double kProjTolMin = exact_mode ? 1e-3 : 1e-2;
  const double kProjTolPow = exact_mode ? 1.0 : 0.5;
  const double alpha = exact_mode ? 1.0 : 1.7;
  const double rho_freq = exact_mode ? 10 : 50;
  const double imb_thresh = exact_mode ? 5.0 : 10.0;
  const double clamp_lo = exact_mode ? 0.5 : 0.67;
  const double clamp_hi = exact_mode ? 2.0 : 1.5;

  const std::size_t m = A.m, n = A.n, N = m + n;
  const double sqrtn_atol = std::sqrt(double(n)) * st.abs_tol;
  const double sqrtm_atol = std::sqrt(double(m)) * st.abs_tol;
  const double sqrtmn_atol = std::sqrt(double(N)) * st.abs_tol;

  std::vector<double> z(N, 0.0), zt(N, 0.0), z12(N), zprev(N), ztemp(N);
  double rho = warm.rho > 0.0 ? warm.rho : st.rho;
  if (!warm.z.empty()) z = warm.z;
  if (!warm.zt.empty()) zt = warm.zt;

  double delta = kDeltaMin, xi = 1.0, kd = 0.0, ku = 0.0;
  double prev_nrm_r = std::numeric_limits<double>::max();

  Info info;
  info.status = kMaxIter;

  int k = 0;
  for (; k < st.max_iter; ++k) {
    zprev = z;

    // Prox step: z12 = prox(z - zt).
    for (std::size_t i = 0; i < N; ++i) ztemp[i] = z[i] - zt[i];
    prox.prox_x(ztemp.data(), rho, z12.data());
    prox.prox_y(ztemp.data() + n, rho, z12.data() + n);

    // Gap and tolerances (pogs.cpp:266-273).
    for (std::size_t i = 0; i < N; ++i) ztemp[i] -= z12[i];
    const double gap = std::abs(dot(N, ztemp.data(), z12.data()));
    const double eps_gap =
        sqrtmn_atol + st.rel_tol * nrm2(N, ztemp.data()) * nrm2(N, z12.data());
    double eps_pri = sqrtm_atol + st.rel_tol * nrm2(m, z12.data() + n);
    double eps_dua = rho * (sqrtn_atol + st.rel_tol * nrm2(n, ztemp.data()));

    // Over-relaxed projection input (pogs.cpp:276-278).
    for (std::size_t i = 0; i < N; ++i)
      ztemp[i] = zt[i] + alpha * z12[i] + (1.0 - alpha) * zprev[i];
    double proj_tol =
        kProjTolMin * std::pow(std::min(prev_nrm_r, 1.0), kProjTolPow);
    // The raw ladder has a fixed point at r = tol_min^2 (r = 0.01*sqrt(r)
    // stalls at 1e-4): an inexact projector stops exactly at proj_tol, so
    // the ADMM residual can never drop below it.  Capping by abs_tol keeps
    // the projection error under the target accuracy.
    proj_tol = std::min(proj_tol, st.abs_tol);
    proj_tol = std::max(proj_tol, kProjTolMax);
    project(ztemp.data(), ztemp.data() + n, proj_tol, z.data(),
            z.data() + n);

    // Approximate residuals (pogs.cpp:299-308).
    double nrm_s = 0.0, nrm_r = 0.0;
    {
      std::vector<double> dz(N);
      for (std::size_t i = 0; i < N; ++i) dz[i] = zprev[i] - z[i];
      nrm_s = rho * (norm_A * nrm2(m, dz.data() + n) + nrm2(n, dz.data()));
      for (std::size_t i = 0; i < N; ++i) dz[i] = z12[i] - z[i];
      nrm_r = norm_A * nrm2(n, dz.data()) + nrm2(m, dz.data() + n);
    }

    // Exact residuals only near tolerance (pogs.cpp:310-336); exact-tol
    // mode computes them every iteration in the ORIGINAL space via d/e
    // (pogs.cpp:210-248).
    bool exact = false;
    if (exact_mode || (nrm_r < 10.0 * eps_pri && nrm_s < 10.0 * eps_dua)) {
      std::vector<double> rv(m), sv(n), tmp(m);
      A.mv(z12.data(), rv.data());
      for (std::size_t i = 0; i < m; ++i) rv[i] -= z12[n + i];
      for (std::size_t i = 0; i < m; ++i)
        tmp[i] = z12[n + i] + zt[n + i] - zprev[n + i];
      A.rmv(tmp.data(), sv.data());
      for (std::size_t j = 0; j < n; ++j)
        sv[j] += z12[j] + zt[j] - zprev[j];
      if (exact_mode) {
        const std::vector<double>& dv = *d_scale;
        const std::vector<double>& ev = *e_scale;
        double r2 = 0, ax2 = 0, y2 = 0, s2 = 0, x2 = 0;
        for (std::size_t i = 0; i < m; ++i) {
          const double di = dv[i] == 0.0 ? 1.0 : dv[i];
          const double ro = dv[i] == 0.0 ? 0.0 : rv[i] / di;
          const double yo = dv[i] == 0.0 ? 0.0 : z12[n + i] / di;
          const double axo = dv[i] == 0.0 ? 0.0 : (rv[i] + z12[n + i]) / di;
          r2 += ro * ro; y2 += yo * yo; ax2 += axo * axo;
        }
        for (std::size_t j = 0; j < n; ++j) {
          const double ej = ev[j] == 0.0 ? 1.0 : ev[j];
          const double so = ev[j] == 0.0 ? 0.0 : sv[j] / ej;
          const double xo = z12[j] * ev[j];
          s2 += so * so; x2 += xo * xo;
        }
        nrm_r = std::sqrt(r2);
        nrm_s = rho * std::sqrt(s2);
        eps_pri = sqrtm_atol +
                  st.rel_tol * std::max(std::sqrt(ax2), std::sqrt(y2));
        eps_dua = rho * (sqrtn_atol + st.rel_tol * std::sqrt(x2));
      } else {
        nrm_r = nrm2(m, rv.data());
        nrm_s = rho * nrm2(n, sv.data());
      }
      exact = true;
    }

    const bool nan_found = !std::isfinite(nrm_r) || !std::isfinite(nrm_s);
    const bool converged = exact && nrm_r < eps_pri && nrm_s < eps_dua &&
                           (!st.gap_stop || gap < eps_gap);
    info.nrm_r = nrm_r;
    info.nrm_s = nrm_s;
    info.gap = gap;
    if (st.verbose > 1 && (k % (st.verbose > 2 ? 10 : 100) == 0 || converged)) {
      std::printf("%5d : %.3e  %.3e  %.3e  %.3e  %.3e\n", k, nrm_r, eps_pri,
                  nrm_s, eps_dua, gap);
    }
    if (converged || nan_found) {
      info.status = nan_found ? kNanFound : kSuccess;
      break;
    }
    prev_nrm_r = nrm_r;

    // Dual update (pogs.cpp:396-399).
    for (std::size_t i = 0; i < N; ++i)
      zt[i] += alpha * z12[i] + (1.0 - alpha) * zprev[i] - z[i];

    // Adaptive rho (pogs.cpp:401-466).
    if (st.adaptive_rho && eps_pri > 0.0 && eps_dua > 0.0) {
      const double pri_n = nrm_r / eps_pri, dua_n = nrm_s / eps_dua;
      const bool spec_slot = k > 0 && k % int(rho_freq) == 0;
      bool handled = false;
      if (spec_slot && pri_n > 0.0 && dua_n > 0.0) {
        const double imb = pri_n / dua_n;
        if (imb > imb_thresh || imb < 1.0 / imb_thresh) {
          const double ratio = std::clamp(std::sqrt(imb), clamp_lo, clamp_hi);
          const double rho_new = std::clamp(rho * ratio, kRhoMin, kRhoMax);
          if (std::abs(rho_new - rho) / rho > 0.05) {
            scal(N, rho / rho_new, zt.data());
            rho = rho_new;
            handled = true;
          }
        }
      }
      if (!spec_slot && !handled) {
        const double kf = double(k);
        const bool s_small = nrm_s < xi * eps_dua;
        const bool r_small = nrm_r < xi * eps_pri;
        if (s_small && !r_small && kTau * kf > kd) {
          if (rho < kRhoMax) {
            rho *= delta;
            scal(N, 1.0 / delta, zt.data());
            delta = std::min(kGamma * delta, 1e3);
            ku = kf;
          }
        } else if (!s_small && r_small && kTau * kf > ku) {
          if (rho > kRhoMin) {
            rho /= delta;
            scal(N, delta, zt.data());
            delta = std::min(kGamma * delta, 1e3);
            kd = kf;
          }
        } else if (s_small && r_small) {
          xi *= kKappa;
        } else {
          delta = kDeltaMin;
        }
      }
    }
  }

  info.final_iter = std::min(k, st.max_iter - 1) + 1;
  if (k >= st.max_iter) info.status = kMaxIter;
  info.rho_final = rho;
  info.optval = prox.objective(z12.data(), z12.data() + n);

  // Post-solve verification in exact-tol mode (pogs.cpp:520-564):
  // re-check the original-space primal residual, downgrade on miss.
  if (exact_mode && info.status == kSuccess) {
    const std::vector<double>& dv = *d_scale;
    std::vector<double> ax(m);
    A.mv(z12.data(), ax.data());
    double r2 = 0, ax2 = 0, y2 = 0;
    for (std::size_t i = 0; i < m; ++i) {
      const double di = dv[i] == 0.0 ? 1.0 : dv[i];
      const double axo = ax[i] / di, yo = z12[n + i] / di;
      r2 += (axo - yo) * (axo - yo); ax2 += axo * axo; y2 += yo * yo;
    }
    const double eps = sqrtm_atol +
        st.rel_tol * std::max(std::sqrt(ax2), std::sqrt(y2));
    if (std::sqrt(r2) > eps) info.status = kMaxIter;
  }

  // Scaled duals: (mu, nu) = -rho (zt - zprev + z12) (pogs.cpp:509-518).
  for (std::size_t j = 0; j < n; ++j) {
    x12_out[j] = z12[j];
    mu_out[j] = -rho * (zt[j] - zprev[j] + z12[j]);
  }
  for (std::size_t i = 0; i < m; ++i) {
    y12_out[i] = z12[n + i];
    nu_out[i] = -rho * (zt[n + i] - zprev[n + i] + z12[n + i]);
  }

  // Implicit warm start for the next solve (pogs.cpp:573).
  warm.z = zprev;
  warm.zt = zt;
  warm.rho = rho;
  return info;
}

// Separable-objective entry point (graph form with FunctionArrays).
template <typename ProjectFn>
inline Info admm_solve(const LinOp& A, double norm_A,
                       const FunctionArrays<double>& f_scaled,
                       const FunctionArrays<double>& g_scaled,
                       ProjectFn&& project, const Settings& st,
                       WarmState& warm, double* x12_out, double* y12_out,
                       double* mu_out, double* nu_out) {
  const std::size_t m = A.m, n = A.n;
  ProxCallbacks prox;
  prox.prox_x = [&g_scaled, n](const double* v, double rho, double* out) {
    prox_eval(g_scaled, n, v, rho, out);
  };
  prox.prox_y = [&f_scaled, m](const double* v, double rho, double* out) {
    prox_eval(f_scaled, m, v, rho, out);
  };
  prox.objective = [&, m, n](const double* x12, const double* y12) {
    return func_eval(f_scaled, m, y12) + func_eval(g_scaled, n, x12);
  };
  return admm_solve_impl(A, norm_A, prox, project, st, warm, nullptr,
                         nullptr, x12_out, y12_out, mu_out, nu_out);
}

}  // namespace pogs_native
