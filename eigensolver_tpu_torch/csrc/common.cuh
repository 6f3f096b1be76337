// Device code shared by the dispersion kernels (cylinder_disp.cu,
// slab_disp.cu): the equilibrium profiles of `profiles.make_profile`, their
// closed-form derivatives (`profiles.make_profile_derivative`), powers as
// `profiles.power` forms them, the pressure-balanced speeds of
// `equilibrium.make_equilibrium`, the RK4 grid, dual numbers (`dual.Dual`),
// and two helpers that keep the JAX code's NaN pattern.
//
// Every expression follows the plain PyTorch version operation for
// operation; the build disables FMA contraction (--fmad=false), so kernel
// and plain version agree bit for bit. Constants arrive as doubles, formed
// on the host as the Python code forms them, and are rounded to T at use.
#pragma once

#include <cmath>

#include <cuda_runtime.h>

namespace eigk {

// config.ProfileKind
enum ProfileKindId : int { kUniform = 0, kGaussian = 1, kEpstein = 2, kPowerLaw = 3 };

// profiles.make_profile(cfg, f0, fe) and its derivatives; mirrored by
// kernels/common.py::ProfileParams
struct ProfileParams {
  int kind;
  double f0, fe;
  double f0_minus_fe;  // (f0 - fe), a Python float in the JAX code
  double center;       // Gaussian x0
  double width;        // Epstein a
  double w2;           // Gaussian width ** 2
  double amplitude, power;
  // profiles.derivative_coefs: f' and f'' constants (a1, a2, b2), and the
  // power-law exponents p - 1, p - 2
  double d1, d2, d2_shift;
  double power_m1, power_m2;
};

// x ** e for a Python float e, as profiles.power evaluates it: the
// exponents that PyTorch's pow special-cases written out, pow for the rest
// (the twist profiles' powers; see profile's power law)
template <class T>
__device__ __forceinline__ T tpow(T x, double e) {
  if (e == 0.0) return T(1);
  if (e == 1.0) return x;
  if (e == 2.0) return x * x;
  if (e == 3.0) return x * x * x;
  if (e == 0.5) return sqrt(x);
  if (e == -0.5) return T(1) / sqrt(x);
  if (e == -1.0) return T(1) / x;
  if (e == -2.0) return T(1) / (x * x);
  return pow(x, T(e));
}

template <class T>
__device__ __forceinline__ T profile(const ProfileParams& p, T x) {
  switch (p.kind) {
    case kGaussian: {
      const T d = x - T(p.center);
      return T(p.fe) + T(p.f0_minus_fe) * exp(-(d * d) / T(p.w2));
    }
    case kEpstein: {
      const T c = cosh(x / T(p.width));
      const T c2 = c * c;
      const T c4 = c2 * c2;
      return T(p.fe) + T(p.f0_minus_fe) / (c4 * c4);
    }
    case kPowerLaw:  // refused for density and flow by the wrappers
                     // (kernels/common.py::density_flow_params); the twist
                     // profiles go through cylinder_disp.cu::tw_profile
      return T(p.amplitude) * pow(x, T(p.power));
    default:
      return T(p.f0);  // f0 + 0.0 * x, for the finite x visited here
  }
}

// d profile / dx (profiles.make_profile_derivative, order 1)
template <class T>
__device__ __forceinline__ T profile_d1(const ProfileParams& p, T x) {
  switch (p.kind) {
    case kGaussian: {
      const T d = x - T(p.center);
      const T e = exp(-(d * d) / T(p.w2));
      return T(p.d1) * d * e;
    }
    case kEpstein: {
      const T y = x / T(p.width);
      const T c = cosh(y);
      const T t = tanh(y);
      const T c2 = c * c;
      const T c4 = c2 * c2;
      return T(p.d1) * t / (c4 * c4);
    }
    case kPowerLaw:
      return T(p.d1) * pow(x, T(p.power_m1));
    default:
      return T(0);
  }
}

// d^2 profile / dx^2 (profiles.make_profile_derivative, order 2)
template <class T>
__device__ __forceinline__ T profile_d2(const ProfileParams& p, T x) {
  switch (p.kind) {
    case kGaussian: {
      const T d = x - T(p.center);
      const T e = exp(-(d * d) / T(p.w2));
      return e * (T(p.d2) * (d * d) - T(p.d2_shift));
    }
    case kEpstein: {
      const T y = x / T(p.width);
      const T c = cosh(y);
      const T t = tanh(y);
      const T c2 = c * c;
      const T c4 = c2 * c2;
      return T(p.d2) * (T(8) * (t * t) - T(1) / c2) / (c4 * c4);
    }
    case kPowerLaw:
      return T(p.d2) * pow(x, T(p.power_m2));
    default:
      return T(0);
  }
}

// The density branch of equilibrium.make_equilibrium at x: rho_i, vA_i and
// the pressure-balanced c_i (the regime constants for a uniform density).
template <class T>
__device__ __forceinline__ void density_speeds(const ProfileParams& rho_p,
                                               int uniform_density,
                                               double vA_i0, double c_i0,
                                               double rho_i0, double c2_num,
                                               double half_g, T x, T& rho,
                                               T& vA, T& ci) {
  rho = profile(rho_p, x);
  if (uniform_density) {
    vA = T(vA_i0);
    ci = T(c_i0);
  } else {
    vA = T(vA_i0) * sqrt(T(rho_i0) / rho);
    ci = sqrt(T(c2_num) / rho - T(half_g) * (vA * vA));
  }
}

// 0 / x without a division: NaN where x is 0 or NaN, else zero.
template <class T>
__device__ __forceinline__ T zero_over(T x) {
  return (x == T(0) || x != x) ? T(NAN) : T(0);
}

// RK4 step sizes (h, h/2, h/6) of n steps from x0 to x1
template <class T>
__device__ __forceinline__ void rk4_spacing(T x0, T x1, int n, T& h, T& hh,
                                            T& h6) {
  h = (x1 - x0) / T(n);
  hh = T(0.5) * h;
  h6 = h / T(6);
}

// Abscissa a (0: x, 1: x + h/2, 2: x + h) of RK4 step i from x0, formed as
// the one-thread kernels' loops form it: x = x0 + i h, not an accumulated
// sum.
template <class T>
__device__ __forceinline__ T rk4_abscissa(T x0, T h, T hh, int i, int a) {
  const T x = x0 + T(i) * h;
  return a == 0 ? x : (a == 1 ? x + hh : x + h);
}

// A dual number (value, d/dr): the rules of dual.Dual, operation for
// operation. A T operand is a constant (derivative 0, no term).
template <class T>
struct Dual {
  T v, d;
};

template <class T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return {a.v + b.v, a.d + b.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return {a.v - b.v, a.d - b.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator-(T c, Dual<T> a) {
  return {c - a.v, -a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) {
  return {-a.v, -a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, T c) {
  return {a.v * c, a.d * c};
}
template <class T>
__device__ __forceinline__ Dual<T> operator*(T c, Dual<T> a) {
  return {c * a.v, c * a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
template <class T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, T c) {
  return {a.v / c, a.d / c};
}
template <class T>
__device__ __forceinline__ Dual<T> dsqrt(Dual<T> a) {
  const T s = sqrt(a.v);
  return {s, a.d / (T(2) * s)};
}

// jnp.maximum / torch.maximum: NaN if either operand is NaN
template <class T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if (a != a || b != b) return a + b;
  return a > b ? a : b;
}

}  // namespace eigk
