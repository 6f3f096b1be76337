// Complex numbers as (re, im) pairs of reals, and dual numbers over them:
// the operations of `eigensolver_tpu_torch/cplx.py` and of `dual.Dual` with
// complex values, operation for operation, so that the kernels that use
// them (slab_complex.cu) agree with the plain PyTorch version bit for bit
// (built with --fmad=false). No c10::complex: the kernels are built
// without PyTorch's headers, and PyTorch's own complex kernels may contract
// a*c - b*d into one fused multiply-add.
//
//   (a + bi)(c + di) = (ac - bd, ad + bc);  r (a + bi) = (ra, rb);
//   r - (a + bi) = (r - a, -b);  (a + bi) - r = (a - r, b)
//   quotients: Smith's algorithm as numpy and c10::complex divide, split
//   into the divisor's two divisions (cdivisor: u, v, scl) and their
//   application to a numerator, ((a u + b v) scl, (b u - a v) scl), with
//   (u, v) = (1, d/c) where |c| >= |d|, (c/d, 1) elsewhere, (1, 0) and
//   scl = inf for a zero divisor; a real numerator drops its zero terms
//   |z| = m sqrt(1 + (n/m)^2), m = max(|a|, |b|), n = min(|a|, |b|)
//   sqrt: the principal root, Re >= 0; on the real axis, either sign of
//   zero, (sqrt|a|, 0) or (0, sqrt|a|), as XLA's complex sqrt gives
#pragma once

#include <cmath>

#include <cuda_runtime.h>

#include "common.cuh"

namespace eigk {

template <class T>
struct Cx {
  T re, im;
};

template <class T>
__device__ __forceinline__ Cx<T> operator+(Cx<T> a, Cx<T> b) {
  return {a.re + b.re, a.im + b.im};
}
template <class T>
__device__ __forceinline__ Cx<T> operator-(Cx<T> a, Cx<T> b) {
  return {a.re - b.re, a.im - b.im};
}
template <class T>
__device__ __forceinline__ Cx<T> operator-(Cx<T> a) {
  return {-a.re, -a.im};
}
template <class T>
__device__ __forceinline__ Cx<T> operator*(Cx<T> a, Cx<T> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
template <class T>
__device__ __forceinline__ Cx<T> operator*(T r, Cx<T> a) {
  return {r * a.re, r * a.im};
}
template <class T>
__device__ __forceinline__ Cx<T> operator*(Cx<T> a, T r) {
  return {a.re * r, a.im * r};
}
template <class T>
__device__ __forceinline__ Cx<T> operator-(T r, Cx<T> a) {
  return {r - a.re, -a.im};
}
template <class T>
__device__ __forceinline__ Cx<T> operator-(Cx<T> a, T r) {
  return {a.re - r, a.im};
}
// a + r and r + a (cplx.C.__add__, __radd__): (a.re + r, a.im)
template <class T>
__device__ __forceinline__ Cx<T> operator+(Cx<T> a, T r) {
  return {a.re + r, a.im};
}
template <class T>
__device__ __forceinline__ Cx<T> operator+(T r, Cx<T> a) {
  return {a.re + r, a.im};
}
// a / r for a real r, one division a part (dual.divn)
template <class T>
__device__ __forceinline__ Cx<T> operator/(Cx<T> a, T r) {
  return {a.re / r, a.im / r};
}

// The divisions of a quotient by one divisor (cplx.Divisor)
template <class T>
struct CDiv {
  T u, v, scl;
};

template <class T>
__device__ __forceinline__ CDiv<T> cdivisor(Cx<T> z) {
  const T c = z.re, d = z.im;
  const bool big = fabs(c) >= fabs(d);  // false where either is NaN
  const T num = big ? d : c;
  const T den = big ? c : d;
  const T rat = num / den;
  T scl = T(1) / (den + num * rat);
  const bool zero = den == T(0);        // c = d = 0
  const T u = big ? T(1) : rat;
  const T v = zero ? T(0) : (big ? rat : T(1));
  if (zero) scl = T(INFINITY);
  return {u, v, scl};
}
template <class T>
__device__ __forceinline__ Cx<T> operator/(Cx<T> a, CDiv<T> q) {
  return {(a.re * q.u + a.im * q.v) * q.scl, (a.im * q.u - a.re * q.v) * q.scl};
}
template <class T>
__device__ __forceinline__ Cx<T> operator/(T r, CDiv<T> q) {
  return {(r * q.u) * q.scl, (-(r * q.v)) * q.scl};
}
template <class T>
__device__ __forceinline__ Cx<T> operator/(Cx<T> a, Cx<T> b) {
  return a / cdivisor(b);
}

// torch.minimum: NaN if either operand is NaN
template <class T>
__device__ __forceinline__ T nan_min(T a, T b) {
  if (a != a || b != b) return a + b;
  return a < b ? a : b;
}

template <class T>
__device__ __forceinline__ T cabs(Cx<T> z) {
  const T ax = fabs(z.re), ay = fabs(z.im);
  const T m = nan_max(ax, ay);
  const T n = nan_min(ax, ay);
  const T r = n / m;
  T s = m * sqrt(T(1) + r * r);
  if (m == T(0)) s = T(0);
  if (m == T(INFINITY)) s = m;
  return s;
}

template <class T>
__device__ __forceinline__ Cx<T> csqrt(Cx<T> z) {
  const T a = z.re, b = z.im;
  const T t = sqrt((fabs(a) + cabs(z)) * T(0.5));
  const T t2 = T(2) * t;
  const bool pos = a >= T(0);
  Cx<T> s{pos ? t : fabs(b) / t2, pos ? b / t2 : copysign(t, b)};
  if (b == T(0)) {
    const T r = sqrt(fabs(a));
    s = {pos ? r : T(0), pos ? T(0) : r};
  }
  return s;
}

// A dual number over complex values (dual.Dual with cplx.C parts): value
// and d/d omega. A Cx or T operand is a constant (no derivative term).
template <class T>
struct CDual {
  Cx<T> v, d;
};

template <class T>
__device__ __forceinline__ CDual<T> operator+(CDual<T> a, CDual<T> b) {
  return {a.v + b.v, a.d + b.d};
}
template <class T>
__device__ __forceinline__ CDual<T> operator-(CDual<T> a, CDual<T> b) {
  return {a.v - b.v, a.d - b.d};
}
template <class T>
__device__ __forceinline__ CDual<T> operator-(CDual<T> a) {
  return {-a.v, -a.d};
}
template <class T>
__device__ __forceinline__ CDual<T> operator*(CDual<T> a, CDual<T> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <class T>
__device__ __forceinline__ CDual<T> operator*(T r, CDual<T> a) {
  return {r * a.v, r * a.d};
}

// A constant c added, subtracted or multiplied (dual.Dual's constant
// rules): (a + c)' = a', (c - a)' = -a', (a c)' = a' c
template <class T>
__device__ __forceinline__ CDual<T> operator+(CDual<T> a, T c) {
  return {a.v + c, a.d};
}
template <class T>
__device__ __forceinline__ CDual<T> operator+(T c, CDual<T> a) {
  return {a.v + c, a.d};
}
template <class T>
__device__ __forceinline__ CDual<T> operator-(CDual<T> a, T c) {
  return {a.v - c, a.d};
}
template <class T>
__device__ __forceinline__ CDual<T> operator-(T c, CDual<T> a) {
  return {c - a.v, -a.d};
}
template <class T>
__device__ __forceinline__ CDual<T> operator*(CDual<T> a, T c) {
  return {a.v * c, a.d * c};
}
template <class T>
__device__ __forceinline__ CDual<T> operator/(CDual<T> a, T c) {
  return {a.v / c, a.d / c};
}

// The quotients of dual.quot and dual.rquot: a / b, and r / b for a real r,
// of complex values or complex duals; a dual's two parts share b's
// divisions: q = a / b, ((a' - q b') / b); r / b: (-(q b')) / b
template <class T>
__device__ __forceinline__ Cx<T> quot(Cx<T> a, Cx<T> b) {
  return a / cdivisor(b);
}
template <class T>
__device__ __forceinline__ CDual<T> quot(CDual<T> a, CDual<T> b) {
  const CDiv<T> ib = cdivisor(b.v);
  const Cx<T> q = a.v / ib;
  return {q, (a.d - q * b.d) / ib};
}
template <class T>
__device__ __forceinline__ Cx<T> rquot(T r, Cx<T> b) {
  return r / cdivisor(b);
}
template <class T>
__device__ __forceinline__ CDual<T> rquot(T r, CDual<T> b) {
  const CDiv<T> ib = cdivisor(b.v);
  const Cx<T> q = r / ib;
  return {q, (-(q * b.d)) / ib};
}

// cplx.clog: (log|z|, atan2(im, re)); of a dual, log(a)' = a' / a (dual.dlog)
template <class T>
__device__ __forceinline__ Cx<T> wlog(Cx<T> z) {
  return {log(cabs(z)), atan2(z.im, z.re)};
}
template <class T>
__device__ __forceinline__ CDual<T> wlog(CDual<T> z) {
  return {wlog(z.v), z.d / cdivisor(z.v)};
}

// The value of a complex dual, or z
template <class T>
__device__ __forceinline__ Cx<T> value(Cx<T> z) {
  return z;
}
template <class T>
__device__ __forceinline__ Cx<T> value(CDual<T> z) {
  return z.v;
}

// A real constant r as a complex value or dual (derivative 0)
template <class W>
struct Const;
template <class T>
struct Const<Cx<T>> {
  __device__ static Cx<T> of(T r) { return {r, T(0)}; }
};
template <class T>
struct Const<CDual<T>> {
  __device__ static CDual<T> of(T r) { return {{r, T(0)}, {T(0), T(0)}}; }
};

// dual.dsqrt of a complex dual: (s, a' / (2 s)), s the principal root
template <class T>
__device__ __forceinline__ CDual<T> dcsqrt(CDual<T> a) {
  const Cx<T> s = csqrt(a.v);
  return {s, a.d / (T(2) * s)};
}

template <class T>
__device__ __forceinline__ Cx<T> wsqrt(Cx<T> a) {
  return csqrt(a);
}
template <class T>
__device__ __forceinline__ CDual<T> wsqrt(CDual<T> a) {
  return dcsqrt(a);
}

}  // namespace eigk
