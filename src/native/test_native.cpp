// Smoke tests for the native host runtime (run via ctest).
//
// Oracles are analytic solutions, mirroring the reference's integration
// tests (reference: tests/test_solver.cpp:43-173 uses identity-block lasso
// with closed-form soft-threshold answers).  Deeper cross-checks against
// the JAX solver live in tests/test_native.py.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "../include/pogs_tpu_native.h"
#include "cone.hpp"
#include "linalg.hpp"

static int failures = 0;

#define CHECK_NEAR(a, b, tol)                                              \
  do {                                                                     \
    const double va = (a), vb = (b);                                       \
    if (!(std::abs(va - vb) <= (tol))) {                                   \
      std::printf("FAIL %s:%d: |%g - %g| > %g\n", __FILE__, __LINE__, va,  \
                  vb, (double)(tol));                                      \
      ++failures;                                                          \
    }                                                                      \
  } while (0)

#define CHECK(cond)                                                 \
  do {                                                               \
    if (!(cond)) {                                                   \
      std::printf("FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond);    \
      ++failures;                                                    \
    }                                                                \
  } while (0)

// Lasso with A = I: x* = soft_threshold(b, lambda).
static void test_identity_lasso() {
  const size_t n = 8;
  std::vector<double> A(n * n, 0.0);
  for (size_t i = 0; i < n; ++i) A[i * n + i] = 1.0;
  std::vector<double> b = {3.0, -2.0, 0.5, -0.25, 1.5, 0.0, -4.0, 2.0};
  const double lam = 1.0;

  std::vector<int32_t> fh(n, POGS_NATIVE_SQUARE), gh(n, POGS_NATIVE_ABS);
  std::vector<double> fb = b, gc(n, lam);

  PogsNativeSettings st;
  pogs_native_settings_default(&st);
  st.abs_tol = 1e-6;
  st.rel_tol = 1e-6;

  std::vector<double> x(n), y(n);
  PogsNativeInfo info;
  const int32_t status = pogs_native_solve_dense_d(
      POGS_NATIVE_ROW_MAJ, n, n, A.data(), &st, fh.data(), nullptr,
      fb.data(), nullptr, nullptr, nullptr, gh.data(), nullptr, nullptr,
      gc.data(), nullptr, nullptr, x.data(), y.data(), nullptr, nullptr,
      &info);
  CHECK(status == POGS_NATIVE_SUCCESS);
  for (size_t i = 0; i < n; ++i) {
    const double st_b =
        (b[i] > lam) ? b[i] - lam : (b[i] < -lam ? b[i] + lam : 0.0);
    CHECK_NEAR(x[i], st_b, 5e-4);
  }
}

// Random tall lasso: verify the KKT conditions of the solution.
static void test_random_lasso_kkt() {
  const size_t m = 60, n = 30;
  std::vector<double> A(m * n), b(m);
  unsigned long long s = 12345;
  auto rnd = [&]() {
    s ^= s << 13; s ^= s >> 7; s ^= s << 17;
    return double(s % 100003) / 100003.0 - 0.5;
  };
  for (auto& v : A) v = rnd();
  for (auto& v : b) v = rnd();
  const double lam = 0.1;

  std::vector<int32_t> fh(m, POGS_NATIVE_SQUARE), gh(n, POGS_NATIVE_ABS);
  std::vector<double> fb = b, gc(n, lam);

  PogsNativeSettings st;
  pogs_native_settings_default(&st);
  st.abs_tol = 1e-7;
  st.rel_tol = 1e-7;
  st.max_iter = 5000;

  std::vector<double> x(n), y(m);
  PogsNativeInfo info;
  const int32_t status = pogs_native_solve_dense_d(
      POGS_NATIVE_ROW_MAJ, m, n, A.data(), &st, fh.data(), nullptr,
      fb.data(), nullptr, nullptr, nullptr, gh.data(), nullptr, nullptr,
      gc.data(), nullptr, nullptr, x.data(), y.data(), nullptr, nullptr,
      &info);
  CHECK(status == POGS_NATIVE_SUCCESS);

  // KKT: g = A^T (A x - b); |g_j| <= lam, and g_j = -lam*sign(x_j) on support.
  std::vector<double> r(m, 0.0), g(n, 0.0);
  for (size_t i = 0; i < m; ++i) {
    double acc = 0.0;
    for (size_t j = 0; j < n; ++j) acc += A[i * n + j] * x[j];
    r[i] = acc - b[i];
  }
  for (size_t j = 0; j < n; ++j) {
    double acc = 0.0;
    for (size_t i = 0; i < m; ++i) acc += A[i * n + j] * r[i];
    g[j] = acc;
  }
  for (size_t j = 0; j < n; ++j) {
    if (std::abs(x[j]) > 1e-5) {
      CHECK_NEAR(g[j], -lam * (x[j] > 0 ? 1.0 : -1.0), 2e-3);
    } else {
      CHECK(std::abs(g[j]) <= lam + 2e-3);
    }
  }
}

// Handle reuse: lambda path with warm starts converges in fewer iterations.
static void test_warm_start_path() {
  const size_t m = 40, n = 20;
  std::vector<double> A(m * n), b(m);
  unsigned long long s = 777;
  auto rnd = [&]() {
    s ^= s << 13; s ^= s >> 7; s ^= s << 17;
    return double(s % 100003) / 100003.0 - 0.5;
  };
  for (auto& v : A) v = rnd();
  for (auto& v : b) v = rnd();

  PogsNativeDense* h =
      pogs_native_dense_new(POGS_NATIVE_ROW_MAJ, m, n, A.data());
  CHECK(h != nullptr);

  std::vector<int32_t> fh(m, POGS_NATIVE_SQUARE), gh(n, POGS_NATIVE_ABS);
  std::vector<double> fb = b, gc(n, 0.5);

  PogsNativeSettings st;
  pogs_native_settings_default(&st);
  st.warm_start = 1;

  std::vector<double> x(n), y(m);
  PogsNativeInfo info1, info2;
  pogs_native_dense_solve(h, &st, fh.data(), nullptr, fb.data(), nullptr,
                          nullptr, nullptr, gh.data(), nullptr, nullptr,
                          gc.data(), nullptr, nullptr, x.data(), y.data(),
                          nullptr, nullptr, &info1);
  // Slightly smaller lambda, warm-started: should converge quickly.
  for (auto& v : gc) v = 0.45;
  pogs_native_dense_solve(h, &st, fh.data(), nullptr, fb.data(), nullptr,
                          nullptr, nullptr, gh.data(), nullptr, nullptr,
                          gc.data(), nullptr, nullptr, x.data(), y.data(),
                          nullptr, nullptr, &info2);
  CHECK(info1.status == POGS_NATIVE_SUCCESS);
  CHECK(info2.status == POGS_NATIVE_SUCCESS);
  CHECK(info2.final_iter <= info1.final_iter);
  pogs_native_dense_free(h);
}

// Sparse CSR solve agrees with the dense solve on the same data.
static void test_sparse_matches_dense() {
  const size_t m = 30, n = 15;
  std::vector<double> A(m * n, 0.0);
  unsigned long long s = 999;
  auto rnd = [&]() {
    s ^= s << 13; s ^= s >> 7; s ^= s << 17;
    return double(s % 100003) / 100003.0 - 0.5;
  };
  // ~40% dense.
  std::vector<int64_t> indptr(m + 1, 0), indices;
  std::vector<double> data;
  for (size_t i = 0; i < m; ++i) {
    for (size_t j = 0; j < n; ++j) {
      const double u = rnd();
      if (u > 0.1) continue;  // keep ~40% of entries
      const double v = rnd();
      A[i * n + j] = v;
      indices.push_back(int64_t(j));
      data.push_back(v);
    }
    indptr[i + 1] = int64_t(indices.size());
  }
  std::vector<double> b(m);
  for (auto& v : b) v = rnd();

  std::vector<int32_t> fh(m, POGS_NATIVE_SQUARE), gh(n, POGS_NATIVE_ABS);
  std::vector<double> fb = b, gc(n, 0.05);

  PogsNativeSettings st;
  pogs_native_settings_default(&st);
  st.abs_tol = 1e-6;
  st.rel_tol = 1e-6;
  st.max_iter = 5000;

  std::vector<double> xd(n), yd(m), xs(n), ys(m);
  PogsNativeInfo id_, is_;
  pogs_native_solve_dense_d(POGS_NATIVE_ROW_MAJ, m, n, A.data(), &st,
                            fh.data(), nullptr, fb.data(), nullptr, nullptr,
                            nullptr, gh.data(), nullptr, nullptr, gc.data(),
                            nullptr, nullptr, xd.data(), yd.data(), nullptr,
                            nullptr, &id_);
  PogsNativeSparse* h = pogs_native_sparse_new(m, n, data.size(),
                                               indptr.data(), indices.data(),
                                               data.data());
  CHECK(h != nullptr);
  pogs_native_sparse_solve(h, &st, fh.data(), nullptr, fb.data(), nullptr,
                           nullptr, nullptr, gh.data(), nullptr, nullptr,
                           gc.data(), nullptr, nullptr, xs.data(), ys.data(),
                           nullptr, nullptr, &is_);
  pogs_native_sparse_free(h);
  CHECK(id_.status == POGS_NATIVE_SUCCESS);
  CHECK(is_.status == POGS_NATIVE_SUCCESS);
  CHECK_NEAR(id_.optval, is_.optval, 1e-3 * (1.0 + std::abs(id_.optval)));
}

// Cone LP with known solution: min x1 + 2 x2 s.t. x1 + x2 = 1, x >= 0.
static void test_cone_lp() {
  const size_t m = 3, n = 2;
  const double A[m * n] = {1.0, 1.0, -1.0, 0.0, 0.0, -1.0};
  const double b[m] = {1.0, 0.0, 0.0};
  const double c[n] = {1.0, 2.0};
  const int64_t zero_idx[1] = {0};
  const int64_t pos_idx[2] = {1, 2};
  PogsNativeCone Ky[2] = {{0 /*ZERO*/, zero_idx, 1},
                          {1 /*NON_NEG*/, pos_idx, 2}};

  PogsNativeConeSolver* s =
      pogs_native_cone_new(POGS_NATIVE_ROW_MAJ, m, n, A, nullptr, 0, Ky, 2);
  CHECK(s != nullptr);
  PogsNativeSettings st;
  pogs_native_settings_default(&st);
  st.abs_tol = 1e-6;
  st.rel_tol = 1e-6;
  double x[n], y[m];
  PogsNativeInfo info;
  const int32_t status = pogs_native_cone_solve(s, &st, b, c, x, y, nullptr,
                                                nullptr, &info);
  pogs_native_cone_free(s);
  CHECK(status == POGS_NATIVE_SUCCESS);
  CHECK_NEAR(info.optval, 1.0, 2e-3);
  CHECK_NEAR(x[0], 1.0, 5e-3);
  CHECK_NEAR(x[1], 0.0, 5e-3);
}

static void test_jacobi_eigh() {
  // Known spectrum: S = V diag(5, 2, -1) V^T for a random orthogonal V
  // built from a fixed rotation composition.
  const size_t n = 3;
  // Hand-built symmetric matrix with eigenvalues {6, 3, 1}:
  // S = Q diag(6,3,1) Q^T, Q = rotation by 0.3 in (0,1) then 0.7 in (1,2).
  double c1 = std::cos(0.3), s1 = std::sin(0.3);
  double c2 = std::cos(0.7), s2 = std::sin(0.7);
  double Q[9] = {c1, -s1, 0, s1 * c2, c1 * c2, -s2, s1 * s2, c1 * s2, c2};
  double D[3] = {6, 3, 1};
  double S[9], V[9], lam[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double acc = 0;
      for (int k = 0; k < 3; ++k) acc += Q[i * 3 + k] * D[k] * Q[j * 3 + k];
      S[i * 3 + j] = acc;
    }
  pogs_native::jacobi_eigh(n, S, V, lam);
  std::sort(lam, lam + 3);
  CHECK_NEAR(lam[0], 1.0, 1e-10);
  CHECK_NEAR(lam[1], 3.0, 1e-10);
  CHECK_NEAR(lam[2], 6.0, 1e-10);
}

static void test_sdp_projection() {
  // Project svec(diag(2, -3)) onto the PSD cone -> svec(diag(2, 0)).
  double packed[3] = {2.0, 0.0, -3.0};  // [a11, sqrt2*a21, a22]
  pogs_native::project_sdp_svec(packed, 3);
  CHECK_NEAR(packed[0], 2.0, 1e-10);
  CHECK_NEAR(packed[1], 0.0, 1e-10);
  CHECK_NEAR(packed[2], 0.0, 1e-10);
  // Idempotence on a PSD matrix: X = [[2,1],[1,2]] (eigs 1 and 3).
  double psd[3] = {2.0, std::sqrt(2.0), 2.0};
  pogs_native::project_sdp_svec(psd, 3);
  CHECK_NEAR(psd[0], 2.0, 1e-10);
  CHECK_NEAR(psd[1], std::sqrt(2.0), 1e-10);
  CHECK_NEAR(psd[2], 2.0, 1e-10);
}

static void test_exp_projection_multiroot() {
  // Multi-root regression (same points as tests/test_cones.py): a single
  // whole-branch bisection lands on a lambda<0 root and returns a
  // feasible but suboptimal point.  d2 oracles verified with SLSQP.
  const double pts[2][3] = {{-0.66891234, 1.95006689, 1.16531048},
                            {-0.1722013, 1.18620918, 0.68929045}};
  const double d2_opt[2] = {0.0200935505711086, 0.0429971935234799};
  for (int k = 0; k < 2; ++k) {
    double out[3];
    pogs_native::project_exp_primal(pts[k], out);
    double d2 = 0.0;
    for (int j = 0; j < 3; ++j)
      d2 += (out[j] - pts[k][j]) * (out[j] - pts[k][j]);
    CHECK_NEAR(d2, d2_opt[k], 1e-10);
  }
  // Idempotence at a generic boundary projection.
  const double v[3] = {1.0, 1.0, 1.0};
  double p[3], p2[3];
  pogs_native::project_exp_primal(v, p);
  pogs_native::project_exp_primal(p, p2);
  for (int j = 0; j < 3; ++j) CHECK_NEAR(p2[j], p[j], 1e-12);
}

static void test_cone_qp() {
  // min ½x'Px + c'x s.t. x free (Ky empty on a 1-row dummy constraint
  // that is always satisfied: b - 0·x >= 0). Optimum: x = -P^{-1}c.
  const size_t m = 1, n = 2;
  double A[2] = {0.0, 0.0};
  double P[4] = {2.0, 0.0, 0.0, 4.0};
  double b[1] = {1.0};
  double c[2] = {-2.0, -4.0};  // x* = (1, 1), optval = ½(2+4) - 6 = -3
  PogsNativeCone ky[1];
  int64_t idx[1] = {0};
  ky[0].cone = 1;  // NON_NEG
  ky[0].indices = idx;
  ky[0].num_indices = 1;
  PogsNativeConeSolver* s =
      pogs_native_cone_qp_new(POGS_NATIVE_ROW_MAJ, m, n, A, P, ky, 1);
  CHECK(s != nullptr);
  PogsNativeSettings st;
  pogs_native_settings_default(&st);
  st.abs_tol = 1e-7;
  st.rel_tol = 1e-7;
  st.max_iter = 20000;
  double x[n], y[m];
  PogsNativeInfo info;
  const int32_t status =
      pogs_native_cone_solve(s, &st, b, c, x, y, nullptr, nullptr, &info);
  pogs_native_cone_free(s);
  CHECK(status == POGS_NATIVE_SUCCESS);
  CHECK_NEAR(x[0], 1.0, 1e-3);
  CHECK_NEAR(x[1], 1.0, 1e-3);
  CHECK_NEAR(info.optval, -3.0, 1e-3);
}

int main() {
  test_identity_lasso();
  test_random_lasso_kkt();
  test_warm_start_path();
  test_sparse_matches_dense();
  test_cone_lp();
  test_jacobi_eigh();
  test_sdp_projection();
  test_exp_projection_multiroot();
  test_cone_qp();
  if (failures == 0) {
    std::printf("native smoke tests: ALL PASSED\n");
    return 0;
  }
  std::printf("native smoke tests: %d FAILURES\n", failures);
  return 1;
}
