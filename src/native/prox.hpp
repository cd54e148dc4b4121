// The 16-function proximal-operator library — native host version.
//
// Same function catalogue and parameter encoding as the Python/JAX library
// (pogs_tpu/prox/scalar.py, pogs_tpu/prox/vector.py), which mirrors the
// reference semantics c*h(a*x - b) + d*x + (e/2)x^2 (reference:
// src/include/prox_lib.h:23-70, generic transform :206-230).  Scalar math
// helpers (Lambert-W-of-exp, positive cubic root) are independent
// implementations using bracketed Newton iterations.
#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace pogs_native {

enum FunctionKind : std::int32_t {
  kAbs = 0,
  kExp = 1,
  kHuber = 2,
  kIdentity = 3,
  kIndBox01 = 4,
  kIndEq0 = 5,
  kIndGe0 = 6,
  kIndLe0 = 7,
  kLogistic = 8,
  kMaxNeg0 = 9,
  kMaxPos0 = 10,
  kNegEntr = 11,
  kNegLog = 12,
  kRecipr = 13,
  kSquare = 14,
  kZero = 15,
};

// Struct-of-arrays objective terms, matching FunctionVector on the Python
// side (one array per parameter instead of an array of records).
template <typename T>
struct FunctionArrays {
  const std::int32_t* h = nullptr;
  const T* a = nullptr;
  const T* b = nullptr;
  const T* c = nullptr;
  const T* d = nullptr;
  const T* e = nullptr;
};

// --------------------------------------------------------------------------
// Scalar math helpers.
// --------------------------------------------------------------------------

// Solve w + log(w) = x for w > 0, i.e. w = W(e^x), by safeguarded Newton.
inline double lambertw_exp(double x) {
  if (x < -36.0) return std::exp(x);  // w ≈ e^x for very negative x
  double w = x > 1.0 ? x - std::log(x) : std::exp(std::min(x, 1.0)) * 0.5 + 0.1;
  w = std::max(w, 1e-300);
  for (int it = 0; it < 32; ++it) {
    const double f = std::log(w) + w - x;
    const double step = f * w / (1.0 + w);
    double wn = w - step;
    if (wn <= 0.0) wn = w * 0.5;
    if (std::abs(wn - w) <= 1e-15 * std::abs(wn) + 1e-300) return wn;
    w = wn;
  }
  return w;
}

// Positive root of x^3 - v x^2 - k = 0 (k > 0): bracketed bisection+Newton.
inline double cubic_pos_root(double v, double k) {
  auto f = [&](double x) { return x * x * x - v * x * x - k; };
  double lo = 0.0;
  double hi = std::max({1.0, v + 1.0, std::cbrt(k) + std::max(v, 0.0) + 1.0});
  while (f(hi) < 0.0) hi *= 2.0;
  double x = 0.5 * (lo + hi);
  for (int it = 0; it < 64; ++it) {
    const double fx = f(x);
    if (fx > 0.0) hi = x; else lo = x;
    const double g = 3.0 * x * x - 2.0 * v * x;
    double xn = (g > 0.0) ? x - fx / g : 0.5 * (lo + hi);
    if (!(xn > lo && xn < hi)) xn = 0.5 * (lo + hi);
    if (std::abs(xn - x) <= 1e-15 * std::abs(xn) + 1e-300) return xn;
    x = xn;
  }
  return x;
}

inline double sigmoid(double x) {
  if (x >= 0.0) {
    const double z = std::exp(-x);
    return 1.0 / (1.0 + z);
  }
  const double z = std::exp(x);
  return z / (1.0 + z);
}

// --------------------------------------------------------------------------
// Base proxes: prox_h(v; rho) = argmin_x h(x) + (rho/2)(x - v)^2.
// --------------------------------------------------------------------------

inline double prox_base(std::int32_t h, double v, double rho) {
  switch (h) {
    case kAbs: {
      const double k = 1.0 / rho;
      return std::max(v - k, 0.0) + std::min(v + k, 0.0);
    }
    case kExp:
      return v - lambertw_exp(v - std::log(rho));
    case kHuber:
      return (std::abs(v) < 1.0 + 1.0 / rho) ? v * rho / (1.0 + rho)
                                             : v - std::copysign(1.0, v) / rho;
    case kIdentity:
      return v - 1.0 / rho;
    case kIndBox01:
      return std::clamp(v, 0.0, 1.0);
    case kIndEq0:
      return 0.0;
    case kIndGe0:
      return std::max(v, 0.0);
    case kIndLe0:
      return std::min(v, 0.0);
    case kLogistic: {
      // Root of sigma(x) + rho (x - v) = 0, bracketed on [v - 1/rho, v].
      double lo = v - 1.0 / rho, hi = v;
      double x = (v < -2.5) ? v
                 : (v > 2.5 + 1.0 / rho) ? v - 1.0 / rho
                                         : (rho * v - 0.5) / (0.2 + rho);
      x = std::clamp(x, lo, hi);
      for (int it = 0; it < 40; ++it) {
        const double s = sigmoid(x);
        const double f = s + rho * (x - v);
        if (f < 0.0) lo = x; else hi = x;
        const double g = s * (1.0 - s) + rho;
        double xn = x - f / g;
        if (!(xn > lo && xn < hi)) xn = 0.5 * (lo + hi);
        if (std::abs(xn - x) <= 1e-14 * (std::abs(xn) + 1.0)) return xn;
        x = xn;
      }
      return x;
    }
    case kMaxNeg0:
      return (v + 1.0 / rho <= 0.0) ? v + 1.0 / rho : std::max(v, 0.0);
    case kMaxPos0:
      return (v >= 1.0 / rho) ? v - 1.0 / rho : std::min(v, 0.0);
    case kNegEntr:
      return lambertw_exp(rho * v - 1.0 + std::log(rho)) / rho;
    case kNegLog:
      return 0.5 * (v + std::sqrt(v * v + 4.0 / rho));
    case kRecipr:
      // Positive root exists for any v (incl. v < 0); no clamping.
      return cubic_pos_root(v, 1.0 / rho);
    case kSquare:
      return rho * v / (1.0 + rho);
    case kZero:
    default:
      return v;
  }
}

inline double func_base(std::int32_t h, double x) {
  switch (h) {
    case kAbs: return std::abs(x);
    case kExp: return std::exp(x);
    case kHuber: {
      const double ax = std::abs(x);
      return ax < 1.0 ? 0.5 * ax * ax : ax - 0.5;
    }
    case kIdentity: return x;
    case kLogistic: return x > 0.0 ? x + std::log1p(std::exp(-x)) : std::log1p(std::exp(x));
    case kMaxNeg0: return std::max(-x, 0.0);
    case kMaxPos0: return std::max(x, 0.0);
    case kNegEntr: return x <= 0.0 ? 0.0 : x * std::log(x);
    case kNegLog: return -std::log(std::max(x, 0.0));
    case kRecipr: return x > 0.0 ? 1.0 / x : HUGE_VAL;
    case kSquare: return 0.5 * x * x;
    default: return 0.0;  // Zero and all indicators
  }
}

// --------------------------------------------------------------------------
// Vector forms with the generic (a, b, c, d, e) parameter transform
// (prox_lib.h:206-230):  v' = a(v rho - d)/(e + rho) - b ;
// rho' = (e + rho)/(c a^2) ; result (prox_h(v', rho') + b)/a.
// --------------------------------------------------------------------------

template <typename T>
void prox_eval(const FunctionArrays<T>& f, std::size_t n, const T* v, double rho,
               T* out) {
#pragma omp parallel for if (n > 512)
  for (std::size_t i = 0; i < n; ++i) {
    const double a = f.a[i], b = f.b[i], c = f.c[i], d = f.d[i], e = f.e[i];
    if (a == 0.0) {  // h-term constant: pure quadratic/linear minimizer
      out[i] = T((double(v[i]) * rho - d) / (e + rho));
      continue;
    }
    const double vt = a * (double(v[i]) * rho - d) / (e + rho) - b;
    const double rt = (e + rho) / (c * a * a);
    out[i] = T((prox_base(f.h[i], vt, rt) + b) / a);
  }
}

template <typename T>
double func_eval(const FunctionArrays<T>& f, std::size_t n, const T* x) {
  double acc = 0.0;
#pragma omp parallel for reduction(+ : acc) if (n > 512)
  for (std::size_t i = 0; i < n; ++i) {
    const double xi = double(x[i]);
    const double z = f.a[i] * xi - f.b[i];
    acc += f.c[i] * func_base(f.h[i], z) + f.d[i] * xi + 0.5 * f.e[i] * xi * xi;
  }
  return acc;
}

}  // namespace pogs_native
