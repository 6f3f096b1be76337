// (K_0'/K_0, K_1'/K_1) at a complex argument z with Re z > 0, as a device
// function on complex values (Cx) or on duals of them in omega (CDual):
// kernel B1 at complex z, the exact exterior of the cylinder at complex
// omega, where z = sqrt(m_e) is the principal root.
//
// Port of `eigensolver_tpu/special.py::kve_ratio_both` (:109-127), with
// `_series_ik` (:29-72) and `_cf2_h` (:90-106), at complex z: the JAX
// package sends complex arguments to that XLA chain, not to the Pallas
// kernel (kernels/bessel.py:141, :165). The same algorithm, term counts and
// branch point as kve_ratio.cuh's real function:
//   |z| <  2 (cabs): ascending I/K series, 24 terms, K_1/K_0, with
//             log(z/2) the principal logarithm (complex.cuh::wlog);
//   |z| >= 2: CF2 at order 0, 60 iterations, K_1/K_0 = (z + 0.5 - h)/z;
//   r0 = -K_1/K_0, r1 = -K_0/K_1 - 1/z,
// every quotient by Smith's divisions (complex.cuh::quot, rquot). The
// series runs all its 24 terms: the real function's early stop rests on
// the terms' magnitudes shrinking monotonically and the sums being
// non-negative, which complex terms need not satisfy (their parts change
// sign). On duals each operation carries its derivative by the rules of
// dual.Dual (the JAX package's jax.jvp of the same expressions).
//
// The plain version is `eigensolver_tpu_torch/special.py::kve_ratio_both_c`,
// operation for operation; built with --fmad=false they agree bit for bit.
#pragma once

#include <cuda_runtime.h>

#include "complex.cuh"
#include "kve_ratio.cuh"

namespace eigk {

// K_1/K_0 by the ascending series (special._series_ik at orders 0 and 1);
// I_1 and the K_1 sum share their terms
template <class T, class W>
__device__ __forceinline__ W kve_series_ratio_c(W z) {
  const W z2 = T(0.25) * z * z;
  const W half_log = wlog(T(0.5) * z);
  const W one = Const<W>::of(T(1));
  W term = one;
  W I0 = one;
  W K0sum = T(0) * one;
  double Hk = 0.0;
#pragma unroll
  for (int k = 1; k <= kSeriesTerms; ++k) {
    term = term * z2 / T(k * k);
    Hk = Hk + 1.0 / k;
    I0 = I0 + term;
    K0sum = K0sum + term * T(Hk);
  }
  const W K0 = (-(half_log + T(kEulerGamma))) * I0 + K0sum;
  W s = one;
  W ssum = one;  // the k = 0 term: 1 (H_0 + H_1)
  term = one;
  Hk = 0.0;
  double Hk1 = 1.0;
#pragma unroll
  for (int k = 1; k <= kSeriesTerms; ++k) {
    term = term * z2 / T(k * (k + 1));
    Hk = Hk + 1.0 / k;
    Hk1 = Hk1 + 1.0 / (k + 1);
    s = s + term;
    ssum = ssum + term * T(Hk + Hk1);
  }
  const W I1 = T(0.5) * z * s;
  const W K1 = rquot(T(1), z) + (half_log + T(kEulerGamma)) * I1
             - T(0.25) * z * ssum;
  return quot(K1, K0);
}

// K_1/K_0 by CF2 (special._cf2_h)
template <class T, class W>
__device__ __forceinline__ W kve_cf2_ratio_c(W z) {
  const double a1 = 0.25;
  W b = T(2) * (z + T(1));
  W d = rquot(T(1), b);
  W delh = d;
  W h = d;
  double a = -a1;
#pragma unroll 4
  for (int i = 2; i < kCF2Iters + 2; ++i) {
    a = a - 2.0 * (i - 1);
    b = b + T(2);
    d = rquot(T(1), b + T(a) * d);
    delh = (b * d - T(1)) * delh;
    h = h + delh;
  }
  h = T(a1) * h;
  return quot(z + T(0.5) - h, z);
}

// K_m'/K_m at z for m = 0 (sausage) or m >= 1 (K_1'/K_1)
template <class T, class W>
__device__ __forceinline__ W kve_ratio_c(W z, bool sausage) {
  const W r10 = cabs(value(z)) < T(2) ? kve_series_ratio_c<T>(z)
                                      : kve_cf2_ratio_c<T>(z);
  if (sausage) return -r10;
  return rquot(T(-1), r10) - rquot(T(1), z);
}

}  // namespace eigk
