// Device code shared by the dispersion kernels (cylinder_disp.cu,
// slab_disp.cu): the equilibrium profiles of `profiles.make_profile`, their
// closed-form derivatives (`profiles.make_profile_derivative`), powers as
// `profiles.power` forms them, the pressure-balanced speeds of
// `equilibrium.make_equilibrium`, the RK4 grid, a kernel's attributes
// (kernel_attrs), dual numbers (`dual.Dual`), and two helpers that keep
// the JAX code's NaN pattern.
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
// (every power law's power and its derivatives' powers)
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

// The closed forms of profiles.make_profile (order 0) and
// make_profile_derivative (orders 1 and 2) of each kind, from the
// constants of the order: a = fe, b = f0 - fe at order 0; a = a1 at order
// 1; a = a2, b = b2 at order 2 (a power law: a = amplitude, a1, a2)
template <class T>
__device__ __forceinline__ T gaussian_form(T x, double center, double w2,
                                           double a, double b, int order) {
  const T d = x - T(center);
  const T e = exp(-(d * d) / T(w2));
  if (order == 0) return T(a) + T(b) * e;
  if (order == 1) return T(a) * d * e;
  return e * (T(a) * (d * d) - T(b));
}

template <class T>
__device__ __forceinline__ T epstein_form(T x, double width, double a,
                                          double b, int order) {
  const T y = x / T(width);
  const T c = cosh(y);
  const T c2 = c * c;
  const T c4 = c2 * c2;
  if (order == 0) return T(a) + T(b) / (c4 * c4);
  const T t = tanh(y);
  if (order == 1) return T(a) * t / (c4 * c4);
  return T(a) * (T(8) * (t * t) - T(1) / c2) / (c4 * c4);
}

template <class T>
__device__ __forceinline__ T power_form(T x, double e, double a) {
  return T(a) * tpow(x, e);
}

// The same, out of line
template <class T>
__device__ __noinline__ T gaussian_call(T x, double center, double w2,
                                        double a, double b, int order) {
  return gaussian_form(x, center, w2, a, b, order);
}
template <class T>
__device__ __noinline__ T epstein_call(T x, double width, double a, double b,
                                       int order) {
  return epstein_form(x, width, a, b, order);
}
template <class T>
__device__ __noinline__ T power_call(T x, double e, double a) {
  return power_form(x, e, a);
}

// The kinds whose closed forms a call site inlines (profile<kInline>); the
// others go out of line. Inlined or not, a kind's exps, cosh, divisions
// and pow shape its kernel's register allocation whether or not a launch
// takes it, so each kernel family takes the mask that times best on the
// shipped cases (tools_torch/time_kernels.py, PERF.md section 6); the bits
// are the same.
enum : unsigned {
  kInlineGaussian = 1u << kGaussian,
  kInlineEpstein = 1u << kEpstein,
  kInlinePowerLaw = 1u << kPowerLaw,
  kInlineAll = kInlineGaussian | kInlineEpstein | kInlinePowerLaw,
};

// profiles.make_profile(cfg, f0, fe) at x (order 0) and its derivatives
// (orders 1, 2), every kind: the kind is a launch-wide parameter, so no
// warp diverges on it
template <unsigned kInline, class T>
__device__ __forceinline__ T profile_form(const ProfileParams& p, T x,
                                          int order) {
  const double a = order == 0 ? p.fe : (order == 1 ? p.d1 : p.d2);
  const double b = order == 0 ? p.f0_minus_fe : p.d2_shift;
  switch (p.kind) {
    case kGaussian:
      if constexpr ((kInline & kInlineGaussian) != 0) {
        return gaussian_form(x, p.center, p.w2, a, b, order);
      } else {
        return gaussian_call(x, p.center, p.w2, a, b, order);
      }
    case kEpstein:
      if constexpr ((kInline & kInlineEpstein) != 0) {
        return epstein_form(x, p.width, a, b, order);
      } else {
        return epstein_call(x, p.width, a, b, order);
      }
    case kPowerLaw: {  // amplitude x^power: f0 and fe take no part
      const double e = order == 0 ? p.power
                                  : (order == 1 ? p.power_m1 : p.power_m2);
      const double c = order == 0 ? p.amplitude : a;
      if constexpr ((kInline & kInlinePowerLaw) != 0) {
        return power_form(x, e, c);
      } else {
        return power_call(x, e, c);
      }
    }
    default:  // f0 + 0.0 * x, for the finite x visited here; its
              // derivatives 0
      return order == 0 ? T(p.f0) : T(0);
  }
}

template <unsigned kInline, class T>
__device__ __forceinline__ T profile(const ProfileParams& p, T x) {
  return profile_form<kInline>(p, x, 0);
}
template <unsigned kInline, class T>
__device__ __forceinline__ T profile_d1(const ProfileParams& p, T x) {
  return profile_form<kInline>(p, x, 1);
}
template <unsigned kInline, class T>
__device__ __forceinline__ T profile_d2(const ProfileParams& p, T x) {
  return profile_form<kInline>(p, x, 2);
}

// The density branch of equilibrium.make_equilibrium at x: rho_i, vA_i and
// the pressure-balanced c_i (the regime constants for a uniform density);
// the density's closed forms inlined for the kinds of kInline
template <unsigned kInline = kInlineAll, class T>
__device__ __forceinline__ void density_speeds(const ProfileParams& rho_p,
                                               int uniform_density,
                                               double vA_i0, double c_i0,
                                               double rho_i0, double c2_num,
                                               double half_g, T x, T& rho,
                                               T& vA, T& ci) {
  rho = profile<kInline>(rho_p, x);
  if (uniform_density) {
    vA = T(vA_i0);
    ci = T(c_i0);
  } else {
    vA = T(vA_i0) * sqrt(T(rho_i0) / rho);
    ci = sqrt(T(c2_num) / rho - T(half_g) * (vA * vA));
  }
}

// 0 / x, the plain version's zeros_like(x) / x, without a division: NaN
// where x is 0 or NaN, else +0 (the division's zero takes x's sign; a
// signed zero here costs the scan a sixth of its time, and the two differ
// only where what they are added to is an exact zero). At float64 the NaN
// has the division's bits, which a bisection's sign test reads: where x
// is NaN that NaN (0 + x propagates it as the division does), where x is
// 0 CUDART_NAN (0xfff8...). At float32 any FP32 operation gives the one
// canonical NaN (0x7fffffff), so the plain select has the same bits there
// once the chain adds it to anything, and is the cheaper.
template <class T>
__device__ __forceinline__ T zero_over(T x) {
  if constexpr (sizeof(T) == 8) {
    if (x == T(0)) return __longlong_as_double(0xfff8000000000000ULL);
    return x != x ? T(0) + x : T(0);
  } else {
    return (x == T(0) || x != x) ? T(NAN) : T(0);
  }
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

// Bitwise equality: a candidate is in a tabled row when its (k, m) have
// the row's bits, so that the row's values are the ones it would compute
template <class T>
__device__ __forceinline__ bool same_bits(T a, T b) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(a) == __float_as_uint(b);
  } else {
    return __double_as_longlong(a) == __double_as_longlong(b);
  }
}

// Whether step i's first abscissa is step i - 1's last, bit for bit
// (rk4_abscissa(x0, h, hh, i, 0) against rk4_abscissa(x0, h, hh, i - 1,
// 2); i >= 1). A chain that depends on the abscissa alone has the same
// value at both: it is computed once, at step i - 1, and kept. The test
// depends on the grid alone, so every thread of a launch takes the same
// branch. The cylinder's grid from r = 1 to eps holds it at some steps
// and not at others (its complex-omega kernel asks at each step); the
// one-argument form says whether it holds at every step of a grid from
// x0 = 0 to 1 in n_steps steps: where n is a power of two, h = 1 / n and
// every i h and i h + h are exact, and (i + 1) h equals i h + h (the slab
// kernels: 2 chains a step, not 3).
template <class T>
__device__ __forceinline__ bool chain_reuse(T x0, T h, T hh, int i) {
  return same_bits(rk4_abscissa(x0, h, hh, i, 0),
                   rk4_abscissa(x0, h, hh, i - 1, 2));
}
__host__ __device__ __forceinline__ bool chain_reuse(int n_steps) {
  return n_steps > 0 && (n_steps & (n_steps - 1)) == 0;
}

// A kernel's registers, local (spill) bytes a thread and resident blocks
// per SM with `smem` bytes of dynamic shared memory at `threads` a block
template <class K>
int kernel_attrs(K* kern, int threads, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = per_sm;
  return 0;
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
// 1/b (dual.recip): one division, the derivative -(b' (1/b)) (1/b)
template <class T>
__device__ __forceinline__ Dual<T> drcp(Dual<T> b) {
  const T iv = T(1) / b.v;
  return {iv, -(b.d * iv) * iv};
}
// a / b with ib = 1/b.v (dual.over): the quotient rule with its divisions
// as products by ib, the same inf or NaN where b.v is 0
template <class T>
__device__ __forceinline__ Dual<T> dover(Dual<T> a, Dual<T> b, T ib) {
  const T q = a.v * ib;
  return {q, (a.d - q * b.d) * ib};
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

// The numeric exteriors (exterior_method="numeric"): port of
// `eigensolver_tpu/ode.py::rk4_final_renorm` (:75-110) and `rk4_final`
// (:22-47) as `physics/slab.py:362-381` and `physics/cylinder.py:319-351`
// call them, in the operation order of the plain version
// (eigensolver_tpu_torch/ode.py). Each depends on the candidate alone
// (m_e, k, m), so a thread integrates its own n steps in registers, after
// its interior shoot; the cylinder's exps depend on k alone, and the
// cylinder scan reads them from a table of its block. The span of the
// exterior, W 2 pi, is formed in double as the Python code forms it and
// rounded to T before it is divided by k. Every division stays a division (the renormalisation
// divides by its scale), and each stage takes its own exp: x0 + (i + 1) h
// is not bitwise (x0 + i h) + h.
constexpr double kPi = 3.141592653589793;
// rk4_final_renorm's `every`: the state is rescaled after each 64th step
constexpr int kRenormEvery = 64;

// vx'/vx at x = 1 of the slab exterior: n RK4 steps of (vx, vx')' =
// (vx', m_e vx) from x = 1 + W 2 pi / k down to 1, from (1e-8, -1e-15), the
// state divided by max(|vx|, |vx'|) (NaN-propagating; 1 where it is 0 or
// NaN) after every kRenormEvery-th step
template <class T>
__device__ __forceinline__ T slab_exterior(T m_e, T k, double wavelengths,
                                           int n) {
  const T x0 = T(1) + T(wavelengths * 2.0 * kPi) / k;
  T h, hh, h6;
  rk4_spacing(x0, T(1), n, h, hh, h6);
  T y0 = T(1e-8), y1 = T(-1e-15);
  for (int i = 0; i < n; ++i) {
    const T k10 = y1, k11 = m_e * y0;
    const T k20 = y1 + hh * k11, k21 = m_e * (y0 + hh * k10);
    const T k30 = y1 + hh * k21, k31 = m_e * (y0 + hh * k20);
    const T k40 = y1 + h * k31, k41 = m_e * (y0 + h * k30);
    y0 = y0 + h6 * (k10 + T(2) * k20 + T(2) * k30 + k40);
    y1 = y1 + h6 * (k11 + T(2) * k21 + T(2) * k31 + k41);
    if ((i + 1) % kRenormEvery == 0) {
      T s = nan_max(fabs(y0), fabs(y1));
      s = s > T(0) ? s : T(1);
      y0 = y0 / s;
      y1 = y1 / s;
    }
  }
  return y1 / y0;
}

// The cylinder exterior's span and grid: r_far = W 2 pi / k, t0 = ln r_far
// and the RK4 spacing (h, h/2, h/6) of n steps from t0 to 0; they depend
// on k alone
template <class T>
struct CylExtK {
  T r_far, t0, h, hh, h6;
};

template <class T>
__device__ __forceinline__ void cyl_ext_grid(T k, double wavelengths, int n,
                                             T& r_far, T& t0, T& h, T& hh,
                                             T& h6) {
  r_far = T(wavelengths * 2.0 * kPi) / k;
  t0 = log(r_far);
  rk4_spacing(t0, T(0), n, h, hh, h6);
}

// exp(2 t) at abscissa a (0: t, 1: t + h/2, 2: t + h) of the exterior's
// step i
template <class T>
__device__ __forceinline__ T cyl_ext_exp(T t0, T h, T hh, int i, int a) {
  const T x = t0 + T(i) * h;
  return exp(T(2) * (a == 0 ? x : (a == 1 ? x + hh : x + h)));
}

// One RK4 step of (P, dP/dt)' = (dP/dt, (m^2 + m_e e^{2t}) P) with e^{2t}
// at the step's 3 abscissae (eA, eM, eB); the state W real, or at complex
// omega a complex value or dual (complex.cuh)
template <class T, class W>
__device__ __forceinline__ void cyl_ext_step(T mm, W m_e, T eA, T eM, T eB,
                                             T h, T hh, T h6, W& P, W& D) {
  const W gA = mm + m_e * eA;
  const W gM = mm + m_e * eM;
  const W gB = mm + m_e * eB;
  const W k1P = D, k1D = gA * P;
  const W k2P = D + hh * k1D, k2D = gM * (P + hh * k1P);
  const W k3P = D + hh * k2D, k3D = gM * (P + hh * k2P);
  const W k4P = D + h * k3D, k4D = gB * (P + h * k3P);
  P = P + h6 * (k1P + T(2) * k2P + T(2) * k3P + k4P);
  D = D + h6 * (k1D + T(2) * k2D + T(2) * k3D + k4D);
}

// dP/dr / P at r = 1 of the cylinder exterior: n RK4 steps in t = ln r of
// (P, dP/dt)' = (dP/dt, (m^2 + m_e e^{2t}) P) from t = ln(W 2 pi / k) down
// to 0, from (1e-8, -1e-8 r_far); no renormalisation. The scan
// (cylinder_disp.cu) reads the exps from a table of its block instead.
template <class T>
__device__ __forceinline__ T cyl_exterior(T m_e, T k, T m, double wavelengths,
                                          int n) {
  T r_far, t0, h, hh, h6;
  cyl_ext_grid(k, wavelengths, n, r_far, t0, h, hh, h6);
  const T mm = m * m;
  T P = T(1e-8), D = T(-1e-8) * r_far;
  for (int i = 0; i < n; ++i) {
    cyl_ext_step(mm, m_e, cyl_ext_exp(t0, h, hh, i, 0),
                 cyl_ext_exp(t0, h, hh, i, 1), cyl_ext_exp(t0, h, hh, i, 2),
                 h, hh, h6, P, D);
  }
  return D / P;
}

}  // namespace eigk
