// Slab dispersion determinant, one thread per (omega, k, parity) candidate.
//
// Port of the XLA program `jit(vmap(disp))` of
// `eigensolver_tpu/physics/slab.py::SlabPhysics.make_dispersion`
// (slab.py:285-406) with the parity as a per-candidate column
// (`eigensolver_tpu/sweep.py::make_dispersion_moded`), for the real-omega
// cases with the exact exponential exterior. On the TPU this was an
// XLA-fused `lax.scan` with no Pallas original; in eager PyTorch it would
// be ~100 launches per RK4 step. Here one thread carries the whole shoot:
//   flux form (density cases, no flow): state (vx, w = F vx') from
//     (par, (1 - par) F(0)), n_interior RK4 steps of `_rk4_linear_flux`
//     from x = 0 to 1 with the chain (1/F, F m0) at the 3 distinct
//     abscissae per step; PT_i = w / Omega;
//   shear form (flow cases): state (vx, vx') from (par, 1 - par), RK4 of
//     vx'' = -D vx' - coeff vx (`_rk4_linear_shear`), D in the legacy or
//     the corrected form, U' and U'' from the closed-form profile
//     derivatives; PT_i = F(1)/Omega (vx' - add vx), add the optional
//     shear-pressure term;
//   then m_e, p_e, sqrt(max(m_e, 0)), the determinant and the % mismatch.
//
// What bounds it on Hopper: per candidate, 3 n_interior evaluations of the
// coefficient chain (2-3 IEEE divisions, 2 square roots and 1-2 exp for a
// Gaussian profile, ~30 other flops) plus the RK4 update, against 24 bytes
// in and 17 bytes out. It is arithmetic- and latency-bound; memory traffic
// is negligible, so there is no tiling, shared memory, TMA or wgmma. Every
// temporary stays in registers and the equilibrium is read as scalars from
// the kernel parameters.
//
// Arithmetic order follows the JAX code expression for expression (no
// algebraic simplification; c_i(x)^2 is a square root squared), and the
// build disables FMA contraction (--fmad=false), so the kernel agrees bit
// for bit with the plain PyTorch version (physics/slab.py) on the card.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace eigk {

// Everything of the case the determinant reads; mirrored by
// kernels/slab.py::_SlabParams. Doubles are rounded to T at use.
struct SlabDispParams {
  ProfileParams rho;     // density rho_i(x): f0 = rho_i0, fe = rho_e
  ProfileParams flow;    // flow U_i(x): f0 = U_i0, fe = U_e
  int uniform_density;   // vA_i, c_i are the regime constants
  int zero_flow;         // U_i == 0 identically
  double vA_i0, c_i0, rho_i0;
  double c2_num;         // rho_e (c_e^2 + g/2 vA_e^2)
  double half_g;         // 0.5 g
  double U_e;
  double vA_e2, c_e2, cT_e2, vAc_e2;  // vA_e^2, c_e^2, cT_e^2, vA_e^2 + c_e^2
  double pe_coef;        // rho_e (vA_e^2 + c_e^2)
  // shear chain: c_i0^2, vA_i0^2, their cT^2 and c_i0^2 + vA_i0^2, as the
  // Python floats of make_shear_coef
  double sc2, sa2, scT2, sca;
  int n_interior;
  int shear;             // has_flow: the direct (vx, vx') form
  int legacy_D;          // case.shear_D_legacy
  int shear_pressure;    // include_shear_pressure
};

namespace slab {

// Om, rho, c^2, vA^2 of the interior at x (the equilibrium's U_i, rho_i,
// c_i(x)^2, vA_i(x)^2)
template <class T>
__device__ __forceinline__ void local(const SlabDispParams& p, T omega, T k,
                                      T x, T& Om, T& rho, T& c2, T& a2) {
  T vA, ci;
  density_speeds(p.rho, p.uniform_density, p.vA_i0, p.c_i0, p.rho_i0,
                 p.c2_num, p.half_g, x, rho, vA, ci);
  const T U = p.zero_flow ? T(0) : profile(p.flow, x);
  Om = omega - k * U;
  c2 = ci * ci;
  a2 = vA * vA;
}

// interior_F (slab.py:167-175)
template <class T>
__device__ __forceinline__ T interior_F(const SlabDispParams& p, T omega, T k,
                                        T x) {
  T Om, rho, c2, a2;
  local(p, omega, k, x, Om, rho, c2, a2);
  const T cT2 = c2 * a2 / (c2 + a2);
  const T k2 = k * k;
  const T Om2 = Om * Om;
  return rho * (c2 + a2) * (k2 * cT2 - Om2) / (k2 * c2 - Om2);
}

// make_flux_coef (slab.py:215-230): (1/F, F m0)
template <class T>
__device__ __forceinline__ void flux_coef(const SlabDispParams& p, T omega,
                                          T k, T x, T& a, T& b) {
  T Om, rho, c2, a2;
  local(p, omega, k, x, Om, rho, c2, a2);
  const T cT2 = c2 * a2 / (c2 + a2);
  const T k2 = k * k;
  const T Om2 = Om * Om;
  a = (k2 * c2 - Om2) / (rho * (c2 + a2) * (k2 * cT2 - Om2));
  b = rho * (k2 * a2 - Om2);
}

// make_shear_coef (slab.py:247-281): (D, coeff)
template <class T>
__device__ __forceinline__ void shear_coef(const SlabDispParams& p, T omega,
                                           T k, T x, T& Dx, T& coeff) {
  const T Om = omega - k * profile(p.flow, x);
  const T dUx = profile_d1(p.flow, x);
  const T ddUx = profile_d2(p.flow, x);
  const T c2 = T(p.sc2), a2 = T(p.sa2), cT2 = T(p.scT2), ca = T(p.sca);
  const T k2 = k * k;
  const T Om2 = Om * Om;
  const T m0 = (k2 * c2 - Om2) * (k2 * a2 - Om2) / (ca * (k2 * cT2 - Om2));
  if (p.legacy_D) {
    Dx = T(2) * k * dUx
         * ((Om2 - k2 * cT2) + ((k2 * k2) * cT2 * c2) / (ca * (Om2 - k2 * cT2)))
         / (Om * (Om2 - k2 * c2));
  } else {
    Dx = T(2) * k * dUx
         * (Om2 / (Om2 - k2 * c2) - (k2 * cT2) / (Om2 - k2 * cT2)) / Om;
  }
  coeff = (k * ddUx / Om) + (k * dUx * Dx / Om) - m0;
}

template <class T, bool kShear>
__device__ __forceinline__ void coef(const SlabDispParams& p, T omega, T k,
                                     T x, T& a, T& b) {
  if (kShear) {
    shear_coef(p, omega, k, x, a, b);
  } else {
    flux_coef(p, omega, k, x, a, b);
  }
}

// right-hand side of the linear system with chain (a, b) at state (y0, y1):
// flux (w a, b vx), shear (vx', -D vx' - coeff vx)
template <class T, bool kShear>
__device__ __forceinline__ void apply(T a, T b, T y0, T y1, T& f0, T& f1) {
  if (kShear) {
    f0 = y1;
    f1 = -a * y1 - b * y0;
  } else {
    f0 = y1 * a;
    f1 = b * y0;
  }
}

// `_rk4_linear_flux` / `_rk4_linear_shear` (slab.py:41-113) from x = 0 to 1
template <class T, bool kShear>
__device__ __forceinline__ void rk4(const SlabDispParams& p, T omega, T k,
                                    int n, T& y0, T& y1) {
  const T x0 = T(0);
  const T h = (T(1) - x0) / T(n);
  const T hh = T(0.5) * h;
  const T h6 = h / T(6);
  for (int i = 0; i < n; ++i) {
    const T x = x0 + T(i) * h;              // not an accumulated x += h
    T aA, bA, aM, bM, aB, bB;
    coef<T, kShear>(p, omega, k, x, aA, bA);
    coef<T, kShear>(p, omega, k, x + hh, aM, bM);
    coef<T, kShear>(p, omega, k, x + h, aB, bB);
    T k10, k11, k20, k21, k30, k31, k40, k41;
    apply<T, kShear>(aA, bA, y0, y1, k10, k11);
    apply<T, kShear>(aM, bM, y0 + hh * k10, y1 + hh * k11, k20, k21);
    apply<T, kShear>(aM, bM, y0 + hh * k20, y1 + hh * k21, k30, k31);
    apply<T, kShear>(aB, bB, y0 + h * k30, y1 + h * k31, k40, k41);
    y0 = y0 + h6 * (k10 + T(2) * k20 + T(2) * k30 + k40);
    y1 = y1 + h6 * (k11 + T(2) * k21 + T(2) * k31 + k41);
  }
}

template <class T, bool kShear>
__global__ void __launch_bounds__(128)
slab_disp_kernel(const T* __restrict__ omega_, const T* __restrict__ k_,
                 const T* __restrict__ par_, T* __restrict__ det_,
                 T* __restrict__ mism_, bool* __restrict__ valid_, int64_t n,
                 const __grid_constant__ SlabDispParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T omega = omega_[i];
  const T k = k_[i];
  const T par = par_[i];
  const T zero = T(0);
  const T one = T(1);
  const T k2 = k * k;

  // exterior coefficients (slab.py:146-165)
  const T Om_e = omega - k * T(p.U_e);
  const T Om_e2 = Om_e * Om_e;
  const T m_e = (k2 * T(p.vA_e2) - Om_e2) * (k2 * T(p.c_e2) - Om_e2)
              / (T(p.vAc_e2) * (k2 * T(p.cT_e2) - Om_e2));
  const T p_e = T(p.pe_coef) * (k2 * T(p.cT_e2) - Om_e2)
              / (Om_e * (k2 * T(p.c_e2) - Om_e2));
  const T sqm = sqrt(nan_max(m_e, zero));

  T vx_b, y1_b, PT_i;
  T Om_i, rho1, c2_1, a2_1;
  local(p, omega, k, one, Om_i, rho1, c2_1, a2_1);
  if (!kShear) {
    // sausage (par = 0): vx odd, (0, F(0)); kink: (1, 0 F(0)), NaN where
    // F(0) is not finite
    const T F0 = interior_F(p, omega, k, zero);
    vx_b = par * one;
    y1_b = (one - par) * F0;
    rk4<T, false>(p, omega, k, p.n_interior, vx_b, y1_b);
    PT_i = y1_b / Om_i;                     // PT = F vx' / Omega = w / Omega
  } else {
    vx_b = par;
    y1_b = one - par;
    rk4<T, true>(p, omega, k, p.n_interior, vx_b, y1_b);
    const T F1 = interior_F(p, omega, k, one);
    if (p.shear_pressure) {
      const T add = -(k * profile_d1(p.flow, one)) / Om_i;
      PT_i = (F1 / Om_i) * (y1_b - add * vx_b);
    } else {
      PT_i = (F1 / Om_i) * y1_b;
    }
  }

  // exact decaying exterior vx_e = exp(-sqm (x - 1))
  const T PT_e = p_e * (-sqm);
  const T xi_e = one / Om_e;
  const T xi_i = vx_b / Om_i;
  det_[i] = xi_i * PT_e - xi_e * PT_i;

  // reference-style % mismatch of PT once xi is matched
  const T s = xi_e / xi_i;
  const T num = fabs(PT_e - s * PT_i);
  const T den = nan_max(fabs(PT_e), fabs(s * PT_i));
  mism_[i] = T(100) * num / den;
  valid_[i] = m_e > zero;
}

template <class T>
int launch(const void* omega, const void* k, const void* par, void* det,
           void* mism, void* valid, long long n, const SlabDispParams* p,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kThreads = 128;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* om = static_cast<const T*>(omega);
  const auto* kk = static_cast<const T*>(k);
  const auto* pp = static_cast<const T*>(par);
  auto* d = static_cast<T*>(det);
  auto* m = static_cast<T*>(mism);
  auto* v = static_cast<bool*>(valid);
  if (p->shear) {
    slab_disp_kernel<T, true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        om, kk, pp, d, m, v, n, *p);
  } else {
    slab_disp_kernel<T, false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        om, kk, pp, d, m, v, n, *p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slab
}  // namespace eigk

extern "C" {

// Each entry returns the cudaError_t of the launch (0 on success); n > 0.
int eigk_slab_disp_f32(const void* omega, const void* k, const void* par,
                       void* det, void* mism, void* valid, long long n,
                       const eigk::SlabDispParams* p, int device, void* stream) {
  return eigk::slab::launch<float>(omega, k, par, det, mism, valid, n, p,
                                   device, stream);
}

int eigk_slab_disp_f64(const void* omega, const void* k, const void* par,
                       void* det, void* mism, void* valid, long long n,
                       const eigk::SlabDispParams* p, int device, void* stream) {
  return eigk::slab::launch<double>(omega, k, par, det, mism, valid, n, p,
                                    device, stream);
}

// sizeof(SlabDispParams), for the Python mirror's layout check
long long eigk_slab_params_size() {
  return static_cast<long long>(sizeof(eigk::SlabDispParams));
}

}  // extern "C"
