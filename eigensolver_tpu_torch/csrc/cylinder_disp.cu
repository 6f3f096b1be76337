// Cylinder dispersion determinant, one thread per (omega, k, m) candidate.
//
// Port of the XLA program `jit(vmap(disp))` of
// `eigensolver_tpu/physics/cylinder.py::CylinderPhysics.make_dispersion`
// (cylinder.py:236-385) with the mode as a per-candidate column
// (`eigensolver_tpu/sweep.py::make_dispersion_moded`), for the non-twisted,
// real-omega cases with the analytic ("bessel") exterior. On the TPU the
// interior was an XLA-fused `lax.scan` and the exterior either fused XLA or
// the Pallas kernel `kernels/bessel.py::kve_ratio_pallas`; here the whole
// candidate runs in registers of one thread:
//   two-basis state (P1, w1, P2, w2) from u0 = (1, 0, 0, F(1));
//   n_interior RK4 steps of `_rk4_linear2` from r = 1 to eps, the
//   coefficient chain evaluated at the 3 distinct abscissae per step;
//   the log tail of n_axis_log steps in t = ln r down to eps_final, with
//   coefficients (r iF, r g);
//   the axis condition, the interface values, m_e, sqrt(m_e), the exterior
//   ratio from the inlined device function of kve_ratio.cuh, xi_e, the
//   determinant and the % mismatch.
//
// What bounds it on Hopper: per candidate, (n_interior + n_axis_log) * 3
// evaluations of the Hain-Lust chain (~10 divisions, 3 square roots and an
// exp each) plus the RK4 updates, against 24 bytes in and 17 bytes out.
// It is arithmetic- and latency-bound (f64 divisions and square roots are
// multi-instruction sequences); memory traffic is negligible, so there is no
// tiling, shared memory, TMA or wgmma: nothing here is a matrix product.
// The design keeps every temporary in registers and reads the equilibrium
// as scalars from the kernel parameters, evaluating the profile closed
// forms inline (no tables in device memory).
//
// Arithmetic order follows the JAX code expression for expression (no
// algebraic simplification), and the build disables FMA contraction
// (--fmad=false): the NaN/inf pattern at pole points and agreement with the
// plain PyTorch version to rounding level depend on it. Constants the JAX
// code forms from Python floats arrive as doubles and are rounded to T at
// use, as JAX's weakly typed scalars are.
//
// For these cases v_phi == B_phi == 0, so C1 == B == C3diff == 0 and the
// chain reduces to (cylinder.py:110-208)
//   D  = rho (c^2 + vA^2) (s^2 - wA^2) (s^2 - wc^2),   A = rho (s^2 - wA^2),
//   C2 = s^4 - (c^2 + vA^2) (m^2/r^2 + k^2) (s^2 - wc^2),   C3 = D A + B,
//   1/F = A/r + B/(r D),   g = -d(r C1/C3)/dr - r (C2 - C1^2/C3)/D,
// where every zero-valued term is kept only as what it does to the NaN
// pattern (`zero_over`).
//
// cylinder_bisect, the second kernel here, is the fused bracket stage over
// the same chain: it replaces `eigensolver_tpu/search.py::bisect`
// (:142-169) and the bisection of `refine_on_cpu` (:468-522) over
// `physics/cylinder.py`, which the port ran as n_iter + 2 launches of
// cylinder_disp on cyl_co_09's 17,280 brackets (~4 warps per SM, each
// launch one thread's 2176-step chain long). Bound by operations (3 chain
// evaluations per RK4 step per bracket per evaluation); the design
// (bisect.cuh) computes the chain in producer warps, which do not depend
// on the ODE state, and runs the serial two-basis update in one consumer
// lane per bracket, in this file's order (interface1, rk4_step2, finish),
// so its (root, mismatch) are bit-equal to the launch loop's.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "bisect.cuh"
#include "common.cuh"
#include "kve_ratio.cuh"

namespace eigk {

// Everything of the case the determinant reads; mirrored by
// kernels/cylinder.py::_CylParams. Doubles are rounded to T at use.
struct CylDispParams {
  ProfileParams rho;     // density rho_i(r): f0 = rho_i0, fe = rho_e
  ProfileParams flow;    // axial flow U_i(r)
  int uniform_density;   // vA_i, c_i are the regime constants
  int zero_flow;         // U_i == 0 identically
  double vA_i0, c_i0, rho_i0, B_0;
  double c2_num;         // rho_e (c_e^2 + g/2 vA_e^2)
  double half_g;         // 0.5 g
  double vA_e2, c_e2, cT_e2, vAc_e2;  // vA_e^2, c_e^2, cT_e^2, vA_e^2 + c_e^2
  double rho_e;
  double m_e_floor;      // 1e-300 (0 once rounded to float)
  double axis_eps, axis_eps_final;
  int n_interior, n_axis_log;
  int log_tail;          // integrate the t = ln r tail eps -> eps_final
};

// D, A, C2 of the Hain-Lust chain at radius r (cylinder.py:110-168 with
// v_phi == B_phi == 0; equilibrium.py:225-242 inline).
template <class T>
__device__ __forceinline__ void hain_lust(const CylDispParams& p, T omega, T k,
                                          T m, T r, T& D, T& A, T& C2) {
  T rho, vA, ci;
  density_speeds(p.rho, p.uniform_density, p.vA_i0, p.c_i0, p.rho_i0,
                 p.c2_num, p.half_g, r, rho, vA, ci);
  const T U = p.zero_flow ? T(0) : profile(p.flow, r);

  const T shift = omega - k * U;            // omega - m v_phi/r - k U
  const T alf = k * T(p.B_0) / sqrt(rho);   // m B_phi/r + k B_z/sqrt(rho)
  const T csum = ci * ci + vA * vA;
  const T cusp = alf * ci / sqrt(csum);
  const T s2 = shift * shift;
  const T da = s2 - alf * alf;
  const T dc = s2 - cusp * cusp;
  D = rho * csum * da * dc;
  A = rho * da;                             // + r dC3diff/dr == 0
  C2 = s2 * s2 - csum * (m * m / (r * r) + k * k) * dc;
}

// invF_g (cylinder.py:189-208): (1/F, g) at radius r
template <class T>
__device__ __forceinline__ void invF_g(const CylDispParams& p, T omega, T k,
                                       T m, T r, T& iF, T& g) {
  T D, A, C2;
  hain_lust(p, omega, k, m, r, D, A, C2);
  const T C3 = D * A + T(0);               // + B, B == 0
  const T c1c3 = zero_over(C3);            // C1^2/C3 and d(r C1/C3)/dr
  iF = A / r + zero_over(r * D);           // A/r + B/(r D)
  g = -c1c3 - r * (C2 - c1c3) / D;
}

// Coefficients of the linear system at abscissa x: (iF, g) in r, or
// (r iF, r g) at r = exp(t) on the log tail (cylinder.py:273-279).
template <class T, bool kLog>
__device__ __forceinline__ void coef(const CylDispParams& p, T omega, T k, T m,
                                     T x, T& iF, T& g) {
  if (kLog) {
    const T r = exp(x);
    invF_g(p, omega, k, m, r, iF, g);
    iF = r * iF;
    g = r * g;
  } else {
    invF_g(p, omega, k, m, x, iF, g);
  }
}

// One step of `_rk4_linear2` (cylinder.py:50-85): classical RK4 for the
// two-basis linear system d(P, w)/dx = (w iF, g P) with the coefficients at
// the step's 3 abscissae (A: x, M: x + h/2, B: x + h); shared by the
// one-thread kernel and the consumer warp of the fused bisection.
template <class T>
__device__ __forceinline__ void rk4_step2(T h, T hh, T h6, T iFA, T gA, T iFM,
                                          T gM, T iFB, T gB, T& P1, T& w1,
                                          T& P2, T& w2) {
  const T k1P1 = w1 * iFA, k1w1 = gA * P1, k1P2 = w2 * iFA, k1w2 = gA * P2;
  T yP1 = P1 + hh * k1P1, yw1 = w1 + hh * k1w1;
  T yP2 = P2 + hh * k1P2, yw2 = w2 + hh * k1w2;
  const T k2P1 = yw1 * iFM, k2w1 = gM * yP1, k2P2 = yw2 * iFM, k2w2 = gM * yP2;
  yP1 = P1 + hh * k2P1;
  yw1 = w1 + hh * k2w1;
  yP2 = P2 + hh * k2P2;
  yw2 = w2 + hh * k2w2;
  const T k3P1 = yw1 * iFM, k3w1 = gM * yP1, k3P2 = yw2 * iFM, k3w2 = gM * yP2;
  yP1 = P1 + h * k3P1;
  yw1 = w1 + h * k3w1;
  yP2 = P2 + h * k3P2;
  yw2 = w2 + h * k3w2;
  const T k4P1 = yw1 * iFB, k4w1 = gB * yP1, k4P2 = yw2 * iFB, k4w2 = gB * yP2;

  P1 = P1 + h6 * (k1P1 + T(2) * k2P1 + T(2) * k3P1 + k4P1);
  w1 = w1 + h6 * (k1w1 + T(2) * k2w1 + T(2) * k3w1 + k4w1);
  P2 = P2 + h6 * (k1P2 + T(2) * k2P2 + T(2) * k3P2 + k4P2);
  w2 = w2 + h6 * (k1w2 + T(2) * k2w2 + T(2) * k3w2 + k4w2);
}

// `_rk4_linear2` from x0 to x1 in n steps, coefficients at x, x + h/2, x + h
template <class T, bool kLog>
__device__ __forceinline__ void rk4_linear2(const CylDispParams& p, T omega,
                                            T k, T m, T x0, T x1, int n,
                                            T& P1, T& w1, T& P2, T& w2) {
  T h, hh, h6;
  rk4_spacing(x0, x1, n, h, hh, h6);
  for (int i = 0; i < n; ++i) {
    const T x = x0 + T(i) * h;              // not an accumulated x += h
    T iFA, gA, iFM, gM, iFB, gB;
    coef<T, kLog>(p, omega, k, m, x, iFA, gA);
    coef<T, kLog>(p, omega, k, m, x + hh, iFM, gM);
    coef<T, kLog>(p, omega, k, m, x + h, iFB, gB);
    rk4_step2(h, hh, h6, iFA, gA, iFM, gM, iFB, gB, P1, w1, P2, w2);
  }
}

// interface chain at r = 1: C3(1) and F(1) = r D / C3
template <class T>
__device__ __forceinline__ void interface1(const CylDispParams& p, T omega,
                                           T k, T m, T& C3_1, T& F1) {
  const T one = T(1);
  T D1, A1, C2_1;
  hain_lust(p, omega, k, m, one, D1, A1, C2_1);
  C3_1 = D1 * A1 + T(0);
  F1 = one * D1 / C3_1;
}

// The axis condition, the interface values, the K_m exterior, det, the %
// mismatch and valid from the basis states at eps_final (cylinder.py:352-385)
template <class T>
__device__ __forceinline__ void finish(const CylDispParams& p, T omega, T k,
                                       T m, T C3_1, T F1, T P1, T w1, T P2,
                                       T w2, T& det, T& mism, bool& valid) {
  const T zero = T(0);
  const T one = T(1);

  // axis condition: m=0: w(eps)=0; m>=1: P(eps)=0
  const bool is_sausage = m < T(0.5);
  const T a1 = is_sausage ? w1 : P1;
  const T a2 = is_sausage ? w2 : P2;

  // interface values: xi_r = C1 P / C3 + w / r
  const T xi1 = zero_over(C3_1) + zero;    // C1(1) * 1.0 / C3(1) + zero
  const T xi2 = F1 / one;

  // exterior: P_e = K_m(sqrt(m_e) r), logarithmic derivative at r = 1
  const T k2 = k * k;
  const T om2 = omega * omega;
  const T m_e = (k2 * T(p.vA_e2) - om2) * (k2 * T(p.c_e2) - om2)
              / (T(p.vAc_e2) * (k2 * T(p.cT_e2) - om2));
  // jnp.maximum(m_e, 1e-300); the floor is 0 in float
  const T sq = sqrt(nan_max(m_e, T(p.m_e_floor)));
  T r0, r1;
  kve_ratio_both(sq, r0, r1);
  const T dP_e = sq * (is_sausage ? r0 : r1);
  const T P_e = one;
  const T xi_e = dP_e / (T(p.rho_e) * (om2 - k2 * T(p.vA_e2)));

  // determinant; the twisted jump term J is 0 for these cases
  const T J = zero;
  const T m1 = xi1 * P_e - xi_e * one;
  const T m2 = xi2 * P_e - xi_e * zero;
  det = a1 * m2 - a2 * m1 + J * xi_e * xi2;

  // % mismatch of xi_r for the combination meeting the axis condition
  const T B = -(a1 + J * xi_e) / a2;
  const T xi_i = xi1 + B * xi2;
  const T num = fabs(xi_e - xi_i);
  const T den = nan_max(fabs(xi_e), fabs(xi_i));
  mism = T(100) * num / den;
  valid = m_e > zero;
}

template <class T>
__global__ void __launch_bounds__(128)
cylinder_disp_kernel(const T* __restrict__ omega_, const T* __restrict__ k_,
                     const T* __restrict__ m_, T* __restrict__ det_,
                     T* __restrict__ mism_, bool* __restrict__ valid_,
                     int64_t n, const __grid_constant__ CylDispParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T omega = omega_[i];
  const T k = k_[i];
  const T m = m_[i];
  const T zero = T(0);
  const T one = T(1);

  T C3_1, F1;
  interface1(p, omega, k, m, C3_1, F1);

  // u1: P(1)=1, P'(1)=0  |  u2: P(1)=0, P'(1)=1  (w = F P')
  T P1 = one, w1 = zero, P2 = zero, w2 = F1 * one;
  const T eps = T(p.axis_eps);
  rk4_linear2<T, false>(p, omega, k, m, one, eps, p.n_interior, P1, w1, P2, w2);
  if (p.log_tail) {
    rk4_linear2<T, true>(p, omega, k, m, log(eps), log(T(p.axis_eps_final)),
                         p.n_axis_log, P1, w1, P2, w2);
  }
  T det, mism;
  bool valid;
  finish(p, omega, k, m, C3_1, F1, P1, w1, P2, w2, det, mism, valid);
  det_[i] = det;
  mism_[i] = mism;
  valid_[i] = valid;
}

// The cylinder chain as the fused bisection (bisect.cuh) runs it: steps
// 0 .. n_interior - 1 in r from 1 to eps, then the log tail in t = ln r;
// the producers call coef<T, kLog>, the consumer interface1 / rk4_step2 /
// finish.
template <class T_>
struct BisectChain {
  using T = T_;
  using Params = CylDispParams;
  static constexpr int kState = 4;  // (P1, w1, P2, w2)
  struct Ctx {
    T C3_1, F1;
  };
  const Params& p;
  int n_int, n_log;
  T x0i, hi, hhi, h6i;  // r: 1 -> eps
  T x0l, hl, hhl, h6l;  // t: ln eps -> ln eps_final

  __device__ explicit BisectChain(const Params& p_)
      : p(p_), n_int(p_.n_interior), n_log(p_.log_tail ? p_.n_axis_log : 0) {
    const T eps = T(p.axis_eps);
    x0i = T(1);
    rk4_spacing(x0i, eps, n_int, hi, hhi, h6i);
    x0l = log(eps);
    rk4_spacing(x0l, log(T(p.axis_eps_final)), p.n_axis_log, hl, hhl, h6l);
  }
  __device__ int n_steps() const { return n_int + n_log; }
  __device__ void coef(T omega, T k, T m, int i, int a, T& c0, T& c1) const {
    if (i < n_int) {
      eigk::coef<T, false>(p, omega, k, m, rk4_abscissa(x0i, hi, hhi, i, a),
                           c0, c1);
    } else {
      eigk::coef<T, true>(p, omega, k, m,
                          rk4_abscissa(x0l, hl, hhl, i - n_int, a), c0, c1);
    }
  }
  __device__ void start(T omega, T k, T m, T* y, Ctx& ctx) const {
    interface1(p, omega, k, m, ctx.C3_1, ctx.F1);
    y[0] = T(1);
    y[1] = T(0);
    y[2] = T(0);
    y[3] = ctx.F1 * T(1);
  }
  __device__ void step(int i, const T* c, int s, T* y) const {
    const bool in_r = i < n_int;
    rk4_step2(in_r ? hi : hl, in_r ? hhi : hhl, in_r ? h6i : h6l, c[0], c[s],
              c[2 * s], c[3 * s], c[4 * s], c[5 * s], y[0], y[1], y[2], y[3]);
  }
  __device__ void finish(T omega, T k, T m, const T* y, const Ctx& ctx, T& det,
                         T& mism) const {
    bool valid;
    eigk::finish(p, omega, k, m, ctx.C3_1, ctx.F1, y[0], y[1], y[2], y[3], det,
                 mism, valid);
  }
};

template <class T>
int launch_cylinder(const void* omega, const void* k, const void* m, void* det,
           void* mism, void* valid, long long n, const CylDispParams* p,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kThreads = 128;
  const long long blocks = (n + kThreads - 1) / kThreads;
  cylinder_disp_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(omega), static_cast<const T*>(k),
      static_cast<const T*>(m), static_cast<T*>(det), static_cast<T*>(mism),
      static_cast<bool*>(valid), n, *p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace eigk

extern "C" {

// Each entry returns the cudaError_t of the launch (0 on success); n > 0.
int eigk_cylinder_disp_f32(const void* omega, const void* k, const void* m,
                           void* det, void* mism, void* valid, long long n,
                           const eigk::CylDispParams* p, int device,
                           void* stream) {
  return eigk::launch_cylinder<float>(omega, k, m, det, mism, valid, n, p, device, stream);
}

int eigk_cylinder_disp_f64(const void* omega, const void* k, const void* m,
                           void* det, void* mism, void* valid, long long n,
                           const eigk::CylDispParams* p, int device,
                           void* stream) {
  return eigk::launch_cylinder<double>(omega, k, m, det, mism, valid, n, p, device, stream);
}

// Fused bisection of n brackets (lo, hi, k, m): root, and the % mismatch at
// the root when final_eval (mism may be null otherwise); B brackets per
// block, P producer warps, C steps per stage, S stages, the register budget
// of min_blocks blocks of 512 threads per SM.
int eigk_cylinder_bisect_f32(const void* lo, const void* hi, const void* k,
                             const void* m, void* root, void* mism,
                             long long n, int n_iter, int final_eval, int B,
                             int P, int C, int S, int min_blocks,
                             const eigk::CylDispParams* p, int device,
                             void* stream) {
  return eigk::launch_bisect<eigk::BisectChain<float>>(
      lo, hi, k, m, root, mism, n, n_iter, final_eval, B, P, C, S, min_blocks,
      p, device, stream);
}

int eigk_cylinder_bisect_f64(const void* lo, const void* hi, const void* k,
                             const void* m, void* root, void* mism,
                             long long n, int n_iter, int final_eval, int B,
                             int P, int C, int S, int min_blocks,
                             const eigk::CylDispParams* p, int device,
                             void* stream) {
  return eigk::launch_bisect<eigk::BisectChain<double>>(
      lo, hi, k, m, root, mism, n, n_iter, final_eval, B, P, C, S, min_blocks,
      p, device, stream);
}

// sizeof(CylDispParams), for the Python mirror's layout check
long long eigk_cylinder_params_size() {
  return static_cast<long long>(sizeof(eigk::CylDispParams));
}

}  // extern "C"
