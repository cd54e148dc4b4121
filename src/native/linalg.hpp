// Minimal dense linear algebra for the native host runtime.
//
// The accelerator path of pogs_tpu is JAX/XLA; this native library is the
// host-side runtime used by the C ABI (src/include/pogs_tpu_native.h) as a
// dependency-free CPU execution engine: small problems solve faster on the
// host than a device dispatch costs, and it doubles as a numerics oracle
// for the JAX path.  Functional counterpart of the reference's GSL/CBLAS
// shims (reference: src/cpu/include/gsl/gsl_blas.h:95-234,
// gsl_linalg.h:14-60) but written as free functions over std::vector /
// raw spans with OpenMP-parallel loops — no BLAS dependency.
#pragma once

#include <cmath>
#include <cstddef>
#include <vector>

namespace pogs_native {

using std::size_t;

// ---------------------------------------------------------------------------
// Vector kernels.
// ---------------------------------------------------------------------------

template <typename T>
T dot(size_t n, const T* x, const T* y) {
  // Eight partial sums break the sequential-addition dependency chain:
  // strict FP forbids the compiler from vectorizing a single-accumulator
  // reduction, which otherwise serializes at ~1 element per add-latency
  // (measured 5-6x slower on the solver's hot gemv path; 8 accumulators
  // saturate this machine's ~11 GF/s memory-bound gemv ceiling).
  // Accumulate in double for f32 robustness.
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
  double a4 = 0.0, a5 = 0.0, a6 = 0.0, a7 = 0.0;
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    a0 += double(x[i]) * double(y[i]);
    a1 += double(x[i + 1]) * double(y[i + 1]);
    a2 += double(x[i + 2]) * double(y[i + 2]);
    a3 += double(x[i + 3]) * double(y[i + 3]);
    a4 += double(x[i + 4]) * double(y[i + 4]);
    a5 += double(x[i + 5]) * double(y[i + 5]);
    a6 += double(x[i + 6]) * double(y[i + 6]);
    a7 += double(x[i + 7]) * double(y[i + 7]);
  }
  double acc = ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7));
  for (; i < n; ++i) acc += double(x[i]) * double(y[i]);
  return T(acc);
}

template <typename T>
T nrm2(size_t n, const T* x) {
  return T(std::sqrt(double(dot(n, x, x))));
}

template <typename T>
void axpy(size_t n, T alpha, const T* x, T* y) {
  for (size_t i = 0; i < n; ++i) y[i] += alpha * x[i];
}

template <typename T>
void scal(size_t n, T alpha, T* x) {
  for (size_t i = 0; i < n; ++i) x[i] *= alpha;
}

// ---------------------------------------------------------------------------
// Dense row-major matrix kernels.
// ---------------------------------------------------------------------------

// y = A x  (A: m x n, row-major).
template <typename T>
void gemv(size_t m, size_t n, const T* A, const T* x, T* y) {
#pragma omp parallel for if (m * n > 262144)
  for (size_t i = 0; i < m; ++i) {
    const T* row = A + i * n;
    y[i] = dot(n, row, x);
  }
}

// y = A^T x  (A: m x n, row-major; y has length n).
template <typename T>
void gemv_t(size_t m, size_t n, const T* A, const T* x, T* y) {
  // Column access of a row-major matrix: accumulate row by row into a
  // double buffer (cache-friendlier than striding columns).  Four rows
  // per pass quarters the accumulator load/store traffic, which is what
  // bounds this kernel.
  std::vector<double> acc(n, 0.0);
  size_t i = 0;
  for (; i + 4 <= m; i += 4) {
    const T* r0 = A + i * n;
    const T* r1 = r0 + n;
    const T* r2 = r1 + n;
    const T* r3 = r2 + n;
    const double x0 = double(x[i]), x1 = double(x[i + 1]);
    const double x2 = double(x[i + 2]), x3 = double(x[i + 3]);
    for (size_t j = 0; j < n; ++j)
      acc[j] += x0 * double(r0[j]) + x1 * double(r1[j])
              + x2 * double(r2[j]) + x3 * double(r3[j]);
  }
  for (; i < m; ++i) {
    const T* row = A + i * n;
    const double xi = double(x[i]);
    for (size_t j = 0; j < n; ++j) acc[j] += xi * double(row[j]);
  }
  for (size_t j = 0; j < n; ++j) y[j] = T(acc[j]);
}

// G = A^T A (n x n) if trans, else G = A A^T (m x m).  Row-major output.
template <typename T>
void gram(size_t m, size_t n, const T* A, bool trans, T* G) {
  const size_t k = trans ? n : m;
  if (trans) {
    // G[j1, j2] = sum_i A[i, j1] A[i, j2].  Accumulate per row of A.
    std::vector<double> acc(k * k, 0.0);
    for (size_t i = 0; i < m; ++i) {
      const T* row = A + i * n;
      for (size_t j1 = 0; j1 < n; ++j1) {
        const double a = double(row[j1]);
        if (a == 0.0) continue;
        double* out = acc.data() + j1 * n;
        for (size_t j2 = j1; j2 < n; ++j2) out[j2] += a * double(row[j2]);
      }
    }
    for (size_t j1 = 0; j1 < k; ++j1)
      for (size_t j2 = j1; j2 < k; ++j2) {
        G[j1 * k + j2] = T(acc[j1 * k + j2]);
        G[j2 * k + j1] = T(acc[j1 * k + j2]);
      }
  } else {
#pragma omp parallel for if (m * n > 16384)
    for (size_t i1 = 0; i1 < m; ++i1) {
      for (size_t i2 = i1; i2 < m; ++i2) {
        const double v = double(dot(n, A + i1 * n, A + i2 * n));
        G[i1 * k + i2] = T(v);
        G[i2 * k + i1] = T(v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Cholesky (in-place, lower triangle of a row-major SPD matrix).
// Returns false if a non-positive pivot is hit.
// ---------------------------------------------------------------------------

template <typename T>
bool cholesky(size_t n, T* K) {
  for (size_t j = 0; j < n; ++j) {
    double diag = double(K[j * n + j]);
    for (size_t p = 0; p < j; ++p) diag -= double(K[j * n + p]) * double(K[j * n + p]);
    if (diag <= 0.0) return false;
    const double ljj = std::sqrt(diag);
    K[j * n + j] = T(ljj);
#pragma omp parallel for if (n > 256)
    for (size_t i = j + 1; i < n; ++i) {
      double v = double(K[i * n + j]);
      for (size_t p = 0; p < j; ++p) v -= double(K[i * n + p]) * double(K[j * n + p]);
      K[i * n + j] = T(v / ljj);
    }
  }
  return true;
}

// Solve K x = b given the Cholesky factor L in the lower triangle of K.
template <typename T>
void cholesky_solve(size_t n, const T* L, const T* b, T* x) {
  // Forward:  L w = b.
  for (size_t i = 0; i < n; ++i) {
    double v = double(b[i]);
    for (size_t p = 0; p < i; ++p) v -= double(L[i * n + p]) * double(x[p]);
    x[i] = T(v / double(L[i * n + i]));
  }
  // Backward: L^T x = w.
  for (size_t ii = n; ii-- > 0;) {
    double v = double(x[ii]);
    for (size_t p = ii + 1; p < n; ++p) v -= double(L[p * n + ii]) * double(x[p]);
    x[ii] = T(v / double(L[ii * n + ii]));
  }
}

// Multi-RHS Cholesky solve (trsm-style): solves K X = B in place for an
// n x r row-major block.  The inner loops run OVER THE RHS COLUMNS, so
// they vectorize (a column-at-a-time loop serializes on the triangular
// dependency instead) — building an explicit inverse this way is ~5x
// faster than n single-vector solves.
template <typename T>
void cholesky_solve_multi(size_t n, const T* L, size_t r, T* X) {
  // Forward:  L W = B  (B arrives in X, W leaves in X).
  for (size_t i = 0; i < n; ++i) {
    T* xi = X + i * r;
    for (size_t p = 0; p < i; ++p) {
      const double lip = double(L[i * n + p]);
      if (lip == 0.0) continue;
      const T* xp = X + p * r;
      for (size_t q = 0; q < r; ++q) xi[q] -= T(lip * double(xp[q]));
    }
    const double inv = 1.0 / double(L[i * n + i]);
    for (size_t q = 0; q < r; ++q) xi[q] = T(double(xi[q]) * inv);
  }
  // Backward: L^T X = W.
  for (size_t ii = n; ii-- > 0;) {
    T* xi = X + ii * r;
    for (size_t p = ii + 1; p < n; ++p) {
      const double lpi = double(L[p * n + ii]);
      if (lpi == 0.0) continue;
      const T* xp = X + p * r;
      for (size_t q = 0; q < r; ++q) xi[q] -= T(lpi * double(xp[q]));
    }
    const double inv = 1.0 / double(L[ii * n + ii]);
    for (size_t q = 0; q < r; ++q) xi[q] = T(double(xi[q]) * inv);
  }
}

// ---------------------------------------------------------------------------
// Symmetric eigendecomposition via cyclic Jacobi rotations.
//
// Dependency-free replacement for LAPACK syevd at the block sizes the SDP
// cone sees (reference projects SDP blocks with syevd,
// prox_lib_cone.h:349-435; typical blocks are tens of rows).  Cyclic
// sweeps annihilate every off-diagonal pair until the off-diagonal
// Frobenius norm falls below eps * ||A||_F; convergence is quadratic, and
// 8-15 sweeps suffice at double precision for n up to a few hundred.
//
// In:  S (n x n, row-major, symmetric; DESTROYED — becomes diagonal).
// Out: lam[n] eigenvalues, V (n x n, row-major) with columns V(:,k) the
//      eigenvectors:  S = V diag(lam) V^T.
// ---------------------------------------------------------------------------

template <typename T>
void jacobi_eigh(size_t n, T* S, T* V, T* lam) {
  // V <- I.
  for (size_t i = 0; i < n; ++i)
    for (size_t j = 0; j < n; ++j) V[i * n + j] = T(i == j ? 1 : 0);
  if (n == 0) return;
  if (n == 1) { lam[0] = S[0]; return; }

  double fro2 = 0.0;
  for (size_t i = 0; i < n * n; ++i) fro2 += double(S[i]) * double(S[i]);
  const double tol2 = std::max(fro2, 1e-300) * 1e-28;  // (eps*||A||_F)^2-ish

  const int kMaxSweeps = 30;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    double off2 = 0.0;
    for (size_t p = 0; p < n; ++p)
      for (size_t q = p + 1; q < n; ++q)
        off2 += 2.0 * double(S[p * n + q]) * double(S[p * n + q]);
    if (off2 <= tol2) break;
    for (size_t p = 0; p < n - 1; ++p) {
      for (size_t q = p + 1; q < n; ++q) {
        const double apq = double(S[p * n + q]);
        if (apq == 0.0) continue;
        const double app = double(S[p * n + p]);
        const double aqq = double(S[q * n + q]);
        // Stable rotation (Golub & Van Loan §8.5.2).
        const double theta = (aqq - app) / (2.0 * apq);
        const double t = (theta >= 0 ? 1.0 : -1.0) /
                         (std::abs(theta) + std::sqrt(theta * theta + 1.0));
        const double c = 1.0 / std::sqrt(t * t + 1.0);
        const double s = t * c;
        // Rows/cols p,q of S.
        for (size_t k = 0; k < n; ++k) {
          const double skp = double(S[k * n + p]);
          const double skq = double(S[k * n + q]);
          S[k * n + p] = T(c * skp - s * skq);
          S[k * n + q] = T(s * skp + c * skq);
        }
        for (size_t k = 0; k < n; ++k) {
          const double spk = double(S[p * n + k]);
          const double sqk = double(S[q * n + k]);
          S[p * n + k] = T(c * spk - s * sqk);
          S[q * n + k] = T(s * spk + c * sqk);
        }
        // Accumulate V (columns rotate like the columns of S).
        for (size_t k = 0; k < n; ++k) {
          const double vkp = double(V[k * n + p]);
          const double vkq = double(V[k * n + q]);
          V[k * n + p] = T(c * vkp - s * vkq);
          V[k * n + q] = T(s * vkp + c * vkq);
        }
      }
    }
  }
  for (size_t i = 0; i < n; ++i) lam[i] = S[i * n + i];
}

// ---------------------------------------------------------------------------
// CSR sparse matrix (for the indirect/CGLS path).
// ---------------------------------------------------------------------------

template <typename T>
struct Csr {
  size_t m = 0, n = 0;
  const long long* indptr = nullptr;   // length m+1
  const long long* indices = nullptr;  // length nnz
  const T* data = nullptr;             // length nnz
};

template <typename T>
void spmv(const Csr<T>& A, const T* x, T* y) {
#pragma omp parallel for if (A.m > 1024)
  for (size_t i = 0; i < A.m; ++i) {
    double acc = 0.0;
    for (long long p = A.indptr[i]; p < A.indptr[i + 1]; ++p)
      acc += double(A.data[p]) * double(x[A.indices[p]]);
    y[i] = T(acc);
  }
}

template <typename T>
void spmv_t(const Csr<T>& A, const T* x, T* y) {
  std::vector<double> acc(A.n, 0.0);
  for (size_t i = 0; i < A.m; ++i) {
    const double xi = double(x[i]);
    if (xi == 0.0) continue;
    for (long long p = A.indptr[i]; p < A.indptr[i + 1]; ++p)
      acc[A.indices[p]] += xi * double(A.data[p]);
  }
  for (size_t j = 0; j < A.n; ++j) y[j] = T(acc[j]);
}

}  // namespace pogs_native
