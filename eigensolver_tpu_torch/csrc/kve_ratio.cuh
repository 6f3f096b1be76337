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
// What bounds it on Hopper: each element costs a few hundred dependent
// flops and ~90 divisions for 8 bytes in and 16 bytes out (f64), so it is
// compute- and latency-bound and memory traffic is negligible. The Pallas
// kernel kept its ~30 live series/CF temporaries out of HBM by tiling them
// into VMEM; here they live in the registers of one thread, and the loops
// are unrolled so the constants below fold at compile time. The same
// function is inlined into the cylinder dispersion kernel
// (cylinder_disp.cu), where it runs in the thread that owns the candidate.
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

template <class T>
__device__ __forceinline__ void kve_ratio_both(T z, T& r0, T& r1) {
  const bool small = fabs(z) < T(2);
  const T zs = small ? z : T(1);  // keep the series argument in range
  const T zl = small ? T(4) : z;

  const T z2 = T(0.25) * zs * zs;
  const T half_log = log(T(0.5) * zs);

  // K_0 = -(log(z/2) + gamma) I_0 + sum_k (z^2/4)^k / (k!)^2 H_k
  T term = T(1);
  T I0 = T(1);
  T K0sum = T(0);
  double Hk = 0.0;
#pragma unroll
  for (int k = 1; k <= kSeriesTerms; ++k) {
    term = term * z2 / T(k * k);
    Hk = Hk + 1.0 / k;
    I0 = I0 + term;
    K0sum = K0sum + term * T(Hk);
  }
  const T K0 = -(half_log + T(kEulerGamma)) * I0 + K0sum;

  // I_1 = (z/2) sum_k (z^2/4)^k / (k! (k+1)!)
  T s = T(1);
  term = T(1);
#pragma unroll
  for (int k = 1; k <= kSeriesTerms; ++k) {
    term = term * z2 / T(k * (k + 1));
    s = s + term;
  }
  const T I1 = T(0.5) * zs * s;

  // K_1 = 1/z + (log(z/2) + gamma) I_1
  //       - (z/4) sum_k (z^2/4)^k (H_k + H_{k+1}) / (k! (k+1)!)
  T ssum = T(0);
  term = T(1);
  Hk = 0.0;
  double Hk1 = 1.0;
  ssum = ssum + term * T(Hk + Hk1);
#pragma unroll
  for (int k = 1; k <= kSeriesTerms; ++k) {
    term = term * z2 / T(k * (k + 1));
    Hk = Hk + 1.0 / k;
    Hk1 = Hk1 + 1.0 / (k + 1);
    ssum = ssum + term * T(Hk + Hk1);
  }
  const T K1 = T(1) / zs + (half_log + T(kEulerGamma)) * I1 - T(0.25) * zs * ssum;

  // CF2 for |z| >= 2: h with K_1/K_0 = (z + 0.5 - h)/z
  const double a1 = 0.25;
  T b = T(2) * (T(1) + zl);
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

  const T r10 = small ? K1 / K0 : (zl + T(0.5) - h) / zl;
  r0 = -r10;
  r1 = T(-1) / r10 - T(1) / z;
}

}  // namespace eigk
