// (K_0'/K_0, K_1'/K_1) of a real argument z > 0, as a device function.
//
// Port of the TPU kernel `eigensolver_tpu/kernels/bessel.py::kve_ratio_pallas`
// (body `_kve_ratio_block`), which fuses the same math as
// `eigensolver_tpu/special.py::kve_ratio_both` into one VMEM-resident pass.
// Same algorithm, term counts and branch point:
//   |z| <  2: ascending I/K series, 24 terms (special._N_SERIES), K_1/K_0;
//   |z| >= 2: Steed/Temme continued fraction CF2 at order 0, 60 iterations
//             (special._N_CF2), K_1/K_0 = (z + 0.5 - h)/z;
//   r0 = -K_1/K_0,  r1 = -K_0/K_1 - 1/z.
//
// What bounds it on Hopper: each argument costs a few hundred dependent
// flops and 30-60 IEEE divisions for 8 bytes in and 16 bytes out (f64), so
// it is bound by operations, not memory. The Pallas block computed both
// branches for every element of a VPU tile and selected one (`jnp.where`);
// a thread here runs only the branch its argument takes, which gives the
// selected value's bits (a NaN fails |z| < 2 and takes CF2, as there). The
// series stops once its terms no longer change its sums, with the same
// bits (kve_series_ratio). I_1 and the K_1 sum share one recursion (the
// plain version runs the same recursion twice). Loops are unrolled so the
// harmonic-number constants fold at compile time. The same function is
// inlined into the cylinder dispersion kernel (cylinder_disp.cu), where it
// runs in the thread that owns the candidate.
//
// Rounding follows the JAX code: the harmonic sums H_k are Python floats
// there (double), rounded to T where they meet a tensor; literals are
// weakly typed, i.e. rounded to T once.
#pragma once

#include <cuda_runtime.h>

namespace eigk {

constexpr int kSeriesTerms = 24;                 // special._N_SERIES
constexpr int kCF2Iters = 60;                    // special._N_CF2
constexpr double kEulerGamma = 0.5772156649015328606;

// K_1/K_0 by the ascending series (special._series_ik), for |z| < 2.
// Each recursion stops at the first term that changes none of its sums,
// which gives the 24-term sums' bits: with |z| < 2, z^2/4 < 1, so every
// rounded addend (term, term H_k, term (H_k + H_{k+1})) is no larger than
// the one before, and the sums (>= +0, finite) are final once an addend no
// larger than the later ones leaves them as they are. A term that is an
// exact 0 stops it too. Without the stop, float32 terms shrink toward the
// denormal range within the 24, where `div.rn.f32` calls its slow-path
// subroutine, at a different term in each lane of a warp: that made the
// float32 series slower than the float64 one (PERF.md).
template <class T>
__device__ __forceinline__ T kve_series_ratio(T z) {
  const T z2 = T(0.25) * z * z;
  const T half_log = log(T(0.5) * z);

  // K_0 = -(log(z/2) + gamma) I_0 + sum_k (z^2/4)^k / (k!)^2 H_k
  T term = T(1);
  T I0 = T(1);
  T K0sum = T(0);
  double Hk = 0.0;
#pragma unroll
  for (int k = 1; k <= kSeriesTerms; ++k) {
    term = term * z2 / T(k * k);
    Hk = Hk + 1.0 / k;
    const T I0_next = I0 + term;
    const T K0_next = K0sum + term * T(Hk);
    if (I0_next == I0 && K0_next == K0sum) break;  // final: see above
    I0 = I0_next;
    K0sum = K0_next;
  }
  const T K0 = -(half_log + T(kEulerGamma)) * I0 + K0sum;

  // I_1 = (z/2) sum_k (z^2/4)^k / (k! (k+1)!)
  // K_1 = 1/z + (log(z/2) + gamma) I_1
  //       - (z/4) sum_k (z^2/4)^k (H_k + H_{k+1}) / (k! (k+1)!)
  T s = T(1);
  T ssum = T(1);  // the k = 0 term: 1 (H_0 + H_1)
  term = T(1);
  Hk = 0.0;
  double Hk1 = 1.0;
#pragma unroll
  for (int k = 1; k <= kSeriesTerms; ++k) {
    term = term * z2 / T(k * (k + 1));
    Hk = Hk + 1.0 / k;
    Hk1 = Hk1 + 1.0 / (k + 1);
    const T s_next = s + term;
    const T ssum_next = ssum + term * T(Hk + Hk1);
    if (s_next == s && ssum_next == ssum) break;   // final: see above
    s = s_next;
    ssum = ssum_next;
  }
  const T I1 = T(0.5) * z * s;
  const T K1 = T(1) / z + (half_log + T(kEulerGamma)) * I1 - T(0.25) * z * ssum;
  return K1 / K0;
}

// K_1/K_0 by CF2 (special._cf2_h), for |z| >= 2
template <class T>
__device__ __forceinline__ T kve_cf2_ratio(T z) {
  const double a1 = 0.25;
  T b = T(2) * (T(1) + z);
  T d = T(1) / b;
  T delh = d;
  T h = d;
  double a = -a1;
#pragma unroll
  for (int i = 2; i < kCF2Iters + 2; ++i) {
    a = a - 2.0 * (i - 1);
    b = b + T(2);
    d = T(1) / (b + T(a) * d);
    delh = (b * d - T(1)) * delh;
    h = h + delh;
  }
  h = T(a1) * h;
  return (z + T(0.5) - h) / z;
}

template <class T>
__device__ __forceinline__ void kve_ratio_both(T z, T& r0, T& r1) {
  T r10;
  if (fabs(z) < T(2)) {
    r10 = kve_series_ratio(z);
  } else {
    r10 = kve_cf2_ratio(z);
  }
  r0 = -r10;
  r1 = T(-1) / r10 - T(1) / z;
}

}  // namespace eigk
