// The cylinder's dispersion determinant at complex omega (kernels
// B4-complex, B4-twisted at complex omega, B1 at complex z, B6-complex on
// the cylinder) and the damped Newton iteration on it (kernel B7 on the
// cylinder): every cylinder family that `sweep --complex` makes complex, on
// one kernel, newton_kernel.
//
// B4-complex is the port of the XLA-fused `jit(vmap(disp))` of
// `eigensolver_tpu/physics/cylinder.py::CylinderPhysics.make_dispersion` at
// complex omega (cylinder.py:220-390): the two-basis shoot `_rk4_linear2`
// (:50-85) with the state (P1, w1, P2, w2) complex from (1, 0, 0, F(1)), the
// non-twisted chain `coefficients` (:106-210; C1 == B == 0, kept as its NaN
// pattern, czero_over) with its one complex division an abscissa (by D),
// the log-r axis tail (:265-284), the exterior's m_e, xi_e, det and the %
// mismatch with the complex modulus, valid = Re m_e > 0 (:354-385). B1 at
// complex z is the exact exterior's K_m'/K_m at sqrt(m_e), the principal
// root with no floor (kve_complex.cuh). B4-twisted at complex omega (kTw)
// is the twisted chain (C1 with shift^2, B, A with r dC3diff/dr, :138-208)
// on complex values carried as duals in r (RD), whose r-derivative of
// r C1/C3 enters g; no log tail; the kink's jump term J (:361-363).
// B6-complex (kNum) is the numeric exterior (`ode.py::rk4_final`, :22-47,
// as cylinder.py:319-351 calls it) on a complex state: n_exterior RK4
// steps of d^2P/dt^2 = (m^2 + m_e e^{2t}) P in t = ln r from ln(W 2 pi /
// k) down to 0, from the real start (1e-8, -1e-8 r_far), no
// renormalisation, its dP/dr / P in place of the K_m ratio. B7 fuses
// `eigensolver_tpu/search.py::newton_complex` (:581-603) over a seed batch:
// all n_iter damped Newton steps of every seed, each one pass of the shoot
// on duals in omega (complex.cuh::CDual; the JAX package's holomorphic
// jax.jvp), then step = d/dd (0 where dd == 0), clamped to 0.2 (1 +
// |omega|). On the twisted chain the Newton pass nests the duals: each
// value of the chain is an RD<CDual>, so that g, which holds
// -d(r C1/C3)/dr, carries d^2(r C1/C3)/dr domega. The sweep's evaluation of
// its roots is one more round of the same launch (final_eval), and the
// argument-principle audit the kernel's evaluation mode (no Newton round,
// the value round at the candidates).
//
// What bounds it on Hopper: operations. Per seed and RK4 step, 3
// evaluations of the complex chain (a complex division, 2 real divisions
// and the r-only values' square roots and exp; the twisted chain 2 complex
// divisions and its dual products; twice the products on the Newton pass)
// and the update of 4 complex (dual) states, against 32 bytes in and 48
// out per seed. The design is the simple one: one thread a seed carries
// its whole shoot, its exterior, the determinant and the Newton update in
// registers, forming the r-only values of each abscissa itself (they
// depend on r alone, so every thread of a warp forms the same ones). A
// complex sweep's 129,600 (density) or 36,000 (twisted) seeds a mode fill
// the card at 128 threads a block.
//
// Arithmetic order follows the plain PyTorch version
// (`physics/cylinder.py::_complex_plain`, `complex_invF_g`, `twisted_chain`
// and `twisted_invF_g` on `dual.RDual`, `complex_exterior` over
// `ode.rk4_final`, `special.kve_ratio_both_c`, `search.py::newton_step`)
// operation for operation; with --fmad=false the kernel agrees with it bit
// for bit on the card.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "common.cuh"
#include "complex.cuh"
#include "cylinder.cuh"
#include "kve_complex.cuh"

namespace eigk {
namespace cyl_cx {

// The real type of a complex value or dual
template <class W>
struct Real;
template <class T>
struct Real<Cx<T>> {
  using type = T;
};
template <class T>
struct Real<CDual<T>> {
  using type = T;
};
template <class W>
using RealOf = typename Real<W>::type;

// A dual in r of complex values or complex duals (dual.RDual): value and
// d/dr. The other operand is an RD, an r-only value (Dual<T>, real) or a
// real constant; the rules of dual.RDual, operand order included.
template <class W>
struct RD {
  W v, d;
};

template <class W>
__device__ __forceinline__ RD<W> operator+(RD<W> a, RD<W> b) {
  return {a.v + b.v, a.d + b.d};
}
template <class W>
__device__ __forceinline__ RD<W> operator+(RD<W> a, Dual<RealOf<W>> b) {
  return {a.v + b.v, a.d + b.d};
}
template <class W>
__device__ __forceinline__ RD<W> operator+(Dual<RealOf<W>> a, RD<W> b) {
  return {a.v + b.v, a.d + b.d};
}
template <class W>
__device__ __forceinline__ RD<W> operator-(RD<W> a, RD<W> b) {
  return {a.v - b.v, a.d - b.d};
}
template <class W>
__device__ __forceinline__ RD<W> operator-(RD<W> a, Dual<RealOf<W>> b) {
  return {a.v - b.v, a.d - b.d};
}
template <class W>
__device__ __forceinline__ RD<W> operator-(Dual<RealOf<W>> a, RD<W> b) {
  return {a.v - b.v, a.d - b.d};
}
template <class W>
__device__ __forceinline__ RD<W> operator-(RD<W> a) {
  return {-a.v, -a.d};
}
template <class W>
__device__ __forceinline__ RD<W> operator*(RD<W> a, RD<W> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <class W>
__device__ __forceinline__ RD<W> operator*(RD<W> a, Dual<RealOf<W>> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <class W>
__device__ __forceinline__ RD<W> operator*(Dual<RealOf<W>> a, RD<W> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <class W>
__device__ __forceinline__ RD<W> operator*(RD<W> a, RealOf<W> c) {
  return {a.v * c, a.d * c};
}
template <class W>
__device__ __forceinline__ RD<W> operator*(RealOf<W> c, RD<W> a) {
  return {c * a.v, c * a.d};
}

// 0 / z (physics/cylinder.py::czero_over): NaN where z is 0 or either part
// NaN, else 0; of a dual that pattern for both parts
template <class T>
__device__ __forceinline__ Cx<T> czero_over(Cx<T> z) {
  const bool bad = (z.re == T(0) && z.im == T(0)) || z.re != z.re
                || z.im != z.im;
  const T v = bad ? T(NAN) : T(0);
  return {v, v};
}
template <class T>
__device__ __forceinline__ CDual<T> czero_over(CDual<T> z) {
  const Cx<T> v = czero_over(z.v);
  return {v, v};
}

// omega as the shoot carries it: a value, or a dual with d/d omega = 1
template <class T>
__device__ __forceinline__ void make_omega(Cx<T> om, Cx<T>& w) {
  w = om;
}
template <class T>
__device__ __forceinline__ void make_omega(Cx<T> om, CDual<T>& w) {
  w = {om, {T(1), T(0)}};
}

// D, A, C2 of the non-twisted chain (physics/cylinder.py::_plain_parts) at
// the radius of q, from the candidate's row values w
template <class T, class W>
__device__ __forceinline__ void parts(const RPoint<T>& q,
                                      const RowPoint<T>& w, W omega, W& D,
                                      W& A, W& C2) {
  const W shift = omega - w.kU;
  const W s2 = shift * shift;
  const W da = s2 - w.alf2;
  const W dc = s2 - w.cusp2;
  D = q.rho_csum * da * dc;
  A = q.rho * da;
  C2 = s2 * s2 - w.X * dc;
}

// (1/F, g) of the non-twisted chain (physics/cylinder.py::complex_invF_g)
// at the radius of q; on the log tail (kLog) (r iF, r g)
template <class T, class W, bool kLog>
__device__ __forceinline__ void invF_g_plain(const CylDispParams& p, T r,
                                             const Cand<T>& c, W omega, W& iF,
                                             W& g) {
  const RPoint<T> q = r_point(p, r);
  W D, A, C2;
  parts(q, row_point(q, c), omega, D, A, C2);
  const W C3 = D * A + T(0);
  const W c1c3 = czero_over(C3);
  iF = A / q.r + czero_over(q.r * D);
  g = -c1c3 - quot(q.r * (C2 - c1c3), D);
  if (kLog) {
    iF = q.r * iF;
    g = q.r * g;
  }
}

// The twisted chain at the radius of q (physics/cylinder.py::twisted_chain
// with omega an RD): D, C1, A, B, C3 and r C1/C3 (rc) with their
// r-derivatives, C2 and 1/C3 without
template <class W>
struct TwChainC {
  RD<W> D, C1, A, B, C3, rc;
  W C2, iC3;
};

template <class T, class W>
__device__ __forceinline__ TwChainC<W> twisted_chain_c(const RPointTw<T>& q,
                                                       W omega, T k, T m) {
  TwChainC<W> c;
  const Dual<T> R{q.r, T(1)};
  const RD<W> om{omega, T(0) * omega};
  const Dual<T> mb_r = m * q.b * q.iR;
  const RD<W> shift = om - m * q.v * q.iR - k * q.U;
  const Dual<T> alf = mb_r + k * q.Bz * q.isr;
  const Dual<T> cusp = alf * q.cr;
  const RD<W> s2 = shift * shift;
  const RD<W> da = s2 - alf * alf;
  const RD<W> dc = s2 - cusp * cusp;
  c.D = q.rho * q.csum * da * dc;
  const Dual<T> fb = mb_r + k * q.Bz;
  const RD<W> Q = -da * q.rho * (q.v * q.v) * q.iR
                + T(2) * s2 * (q.b * q.b) * q.iR
                + T(2) * shift * q.b * q.v * fb * q.iR;
  const RD<W> Tt = fb * q.b + q.rho * q.v * shift;
  c.C1 = Q * s2 - T(2) * m * q.csum * dc * Tt * q.iRR;
  c.C2 = s2.v * s2.v - q.csum.v * (m * m * q.iRR.v + k * k) * dc.v;
  c.A = q.rho * da + q.rdc;
  c.B = Q * Q - T(4) * q.csum * dc * (Tt * Tt) * q.iRR;
  c.C3 = c.D * c.A + c.B;
  c.iC3 = rquot(T(1), c.C3.v);
  // r C1/C3 by the quotient rule on 1/C3 (dual.over)
  const RD<W> RC1 = R * c.C1;
  const W qv = RC1.v * c.iC3;
  c.rc = {qv, (RC1.d - qv * c.C3.d) * c.iC3};
  return c;
}

// (1/F, g) of the twisted chain at r (physics/cylinder.py::twisted_invF_g)
template <class T, class W>
__device__ __forceinline__ void invF_g_tw(const CylDispParams& p, T r,
                                          W omega, T k, T m, W& iF, W& g) {
  const RPointTw<T> q = r_point_tw(p, r);
  const TwChainC<W> c = twisted_chain_c<T>(q, omega, k, m);
  const W iD = rquot(T(1), c.D.v);
  iF = c.A.v * q.iR.v + c.B.v * q.iR.v * iD;
  g = -c.rc.d - q.r * (c.C2 - c.C1.v * c.C1.v * c.iC3) * iD;
}

// One step of `_rk4_linear2` on complex values or duals (cylinder.cuh::
// rk4_step2's operations)
template <class T, class W>
__device__ __forceinline__ void rk4_step2_c(T h, T hh, T h6, const W& iFA,
                                            const W& gA, const W& iFM,
                                            const W& gM, const W& iFB,
                                            const W& gB, W& P1, W& w1, W& P2,
                                            W& w2) {
  const W k1P1 = w1 * iFA, k1w1 = gA * P1, k1P2 = w2 * iFA, k1w2 = gA * P2;
  W yP1 = P1 + hh * k1P1, yw1 = w1 + hh * k1w1;
  W yP2 = P2 + hh * k1P2, yw2 = w2 + hh * k1w2;
  const W k2P1 = yw1 * iFM, k2w1 = gM * yP1, k2P2 = yw2 * iFM, k2w2 = gM * yP2;
  yP1 = P1 + hh * k2P1;
  yw1 = w1 + hh * k2w1;
  yP2 = P2 + hh * k2P2;
  yw2 = w2 + hh * k2w2;
  const W k3P1 = yw1 * iFM, k3w1 = gM * yP1, k3P2 = yw2 * iFM, k3w2 = gM * yP2;
  yP1 = P1 + h * k3P1;
  yw1 = w1 + h * k3w1;
  yP2 = P2 + h * k3P2;
  yw2 = w2 + h * k3w2;
  const W k4P1 = yw1 * iFB, k4w1 = gB * yP1, k4P2 = yw2 * iFB, k4w2 = gB * yP2;
  P1 = P1 + h6 * (k1P1 + T(2) * k2P1 + T(2) * k3P1 + k4P1);
  w1 = w1 + h6 * (k1w1 + T(2) * k2w1 + T(2) * k3w1 + k4w1);
  P2 = P2 + h6 * (k1P2 + T(2) * k2P2 + T(2) * k3P2 + k4P2);
  w2 = w2 + h6 * (k1w2 + T(2) * k2w2 + T(2) * k3w2 + k4w2);
}

// dP/dr / P at r = 1 of the numeric exterior at complex omega
// (physics/cylinder.py::complex_exterior; common.cuh::cyl_exterior's steps
// on a complex state or its duals), exp(2 t) as cyl_exterior forms it
template <class T, class W>
__device__ __forceinline__ W exterior_c(W m_e, T k, T m, double wavelengths,
                                        int n) {
  T r_far, t0, h, hh, h6;
  cyl_ext_grid(k, wavelengths, n, r_far, t0, h, hh, h6);
  const T mm = m * m;
  W P = Const<W>::of(T(1e-8));
  W D = Const<W>::of(T(-1e-8) * r_far);
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const W gA = mm + m_e * cyl_ext_exp(t0, h, hh, i, 0);
    const W gM = mm + m_e * cyl_ext_exp(t0, h, hh, i, 1);
    const W gB = mm + m_e * cyl_ext_exp(t0, h, hh, i, 2);
    const W k1P = D, k1D = gA * P;
    const W k2P = D + hh * k1D, k2D = gM * (P + hh * k1P);
    const W k3P = D + hh * k2D, k3D = gM * (P + hh * k2P);
    const W k4P = D + h * k3D, k4D = gB * (P + h * k3P);
    P = P + h6 * (k1P + T(2) * k2P + T(2) * k3P + k4P);
    D = D + h6 * (k1D + T(2) * k2D + T(2) * k3D + k4D);
  }
  return quot(D, P);
}

// One shoot at complex omega (physics/cylinder.py::_complex_plain): W a
// complex value (the value round: det, and the % mismatch and valid to
// *mism, *valid) or a complex dual (a Newton round: det and d det/d omega)
template <class T, class W, bool kTw, bool kNum>
__device__ __forceinline__ W shoot(const CylDispParams& p, Cx<T> omega_c,
                                   T k, T m, T* mism, bool* valid) {
  const T one = T(1), zero = T(0);
  W om;
  make_omega(omega_c, om);
  const Cand<T> cd(p, zero, k, m);
  const Grid<T> gr(p);

  // the chain's values at r = 1: F(1), xi_r of u1
  W F1, xi1;
  if constexpr (kTw) {
    const TwChainC<W> c1 = twisted_chain_c<T>(r_point_tw(p, one), om, k, m);
    F1 = quot(one * c1.D.v, c1.C3.v);
    xi1 = quot(c1.C1.v * one, c1.C3.v) + zero;
  } else {
    const RPoint<T> q1 = r_point(p, one);
    W D1, A1, C2_1;
    parts(q1, row_point(q1, cd), om, D1, A1, C2_1);
    const W C3_1 = D1 * A1 + zero;
    F1 = quot(one * D1, C3_1);
    xi1 = czero_over(C3_1);
  }

  // interior: u1 = (1, 0), u2 = (0, F(1)) from r = 1 inward
  W P1 = Const<W>::of(one), w1 = Const<W>::of(zero);
  W P2 = Const<W>::of(zero), w2 = F1;
#pragma unroll 1
  for (int i = 0; i < gr.n_int; ++i) {
    W iF[3], g[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T r = rk4_abscissa(gr.x0i, gr.hi, gr.hhi, i, a);
      if constexpr (kTw) {
        invF_g_tw<T>(p, r, om, k, m, iF[a], g[a]);
      } else {
        invF_g_plain<T, W, false>(p, r, cd, om, iF[a], g[a]);
      }
    }
    rk4_step2_c(gr.hi, gr.hhi, gr.h6i, iF[0], g[0], iF[1], g[1], iF[2], g[2],
                P1, w1, P2, w2);
  }
  if constexpr (!kTw) {
    // the log tail eps -> eps_final in t = ln r (none where log_tail is 0)
#pragma unroll 1
    for (int i = 0; i < gr.n_log; ++i) {
      W iF[3], g[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const T r = exp(rk4_abscissa(gr.x0l, gr.hl, gr.hhl, i, a));
        invF_g_plain<T, W, true>(p, r, cd, om, iF[a], g[a]);
      }
      rk4_step2_c(gr.hl, gr.hhl, gr.h6l, iF[0], g[0], iF[1], g[1], iF[2],
                  g[2], P1, w1, P2, w2);
    }
  }

  // axis condition: m = 0: w(eps) = 0; m >= 1: P(eps) = 0
  const bool sausage = m < T(0.5);
  const W a1 = sausage ? w1 : P1;
  const W a2 = sausage ? w2 : P2;
  const W xi2 = F1;

  // exterior
  const T k2 = k * k;
  const W om2 = om * om;
  const W X1 = k2 * T(p.vA_e2) - om2;
  const W X2 = k2 * T(p.c_e2) - om2;
  const W X3 = k2 * T(p.cT_e2) - om2;
  const W m_e = quot(X1 * X2, T(p.vAc_e2) * X3);
  W dP_e;
  if constexpr (kNum) {
    dP_e = exterior_c<T>(m_e, k, m, p.exterior_wavelengths, p.n_exterior);
  } else {
    const W sq = wsqrt(m_e);
    dP_e = sq * kve_ratio_c<T>(sq, sausage);
  }
  const W xi_e = quot(dP_e, T(p.rho_e) * (om2 - k2 * T(p.vA_e2)));

  // determinant with the twisted kink's jump term (P_e = 1)
  T J = zero;
  if constexpr (kTw) {
    const T b1 = tw_profile(p.bphi, one, 0);
    const T v1 = tw_profile(p.vphi, one, 0);
    J = b1 * b1 - T(p.rho_i0) * (v1 * v1);
  }
  if (sausage) J = zero;
  const W m1 = xi1 - xi_e;
  const W m2 = xi2 - xi_e * zero;
  const W det = a1 * m2 - a2 * m1 + J * xi_e * xi2;
  if constexpr (std::is_same<W, Cx<T>>::value) {
    const W B = quot(-(a1 + J * xi_e), a2);
    const W xi_i = xi1 + B * xi2;
    const T num = cabs(xi_e - xi_i);
    const T den = nan_max(cabs(xi_e), cabs(xi_i));
    *mism = (T(100) * num) / den;
    *valid = m_e.re > zero;
  }
  return det;
}

constexpr int kCxCylThreads = 128;

// B7, B4-complex, B4-twisted, B1 and B6-complex: n_iter damped Newton
// rounds of every seed (one thread each), then with final_eval the value
// round at the final omega (n_iter = 0: the evaluation of the candidates),
// in the case's chain (kTw) and exterior (kNum). out (omega) is written if
// out_re is given, det / mism / valid after the value round.
template <class T, bool kTw, bool kNum>
__global__ void __launch_bounds__(kCxCylThreads)
newton_kernel(const T* __restrict__ om_re, const T* __restrict__ om_im,
              const T* __restrict__ k_, const T* __restrict__ m_,
              T* __restrict__ out_re, T* __restrict__ out_im, int64_t n,
              T* __restrict__ det_re, T* __restrict__ det_im,
              T* __restrict__ mism_, bool* __restrict__ valid_, int n_iter,
              double damping, int final_eval,
              const __grid_constant__ CylDispParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                  + threadIdx.x;
  if (i >= n) return;
  Cx<T> om{om_re[i], om_im[i]};
  const T k = k_[i], m = m_[i];
#pragma unroll 1
  for (int round = 0; round < n_iter; ++round) {
    const CDual<T> det =
        shoot<T, CDual<T>, kTw, kNum>(p, om, k, m, nullptr, nullptr);
    // search.py::newton_step
    const Cx<T> d = det.v, dd = det.d;
    const Cx<T> q = d / dd;
    Cx<T> step = (dd.re == T(0) && dd.im == T(0)) ? Cx<T>{T(0), T(0)} : q;
    const T max_step = T(0.2) * (T(1) + cabs(om));
    const T mag = cabs(step);
    if (mag > max_step) step = step * (max_step / mag);
    om = om - T(damping) * step;
  }
  if (final_eval) {
    T mism;
    bool valid;
    const Cx<T> d = shoot<T, Cx<T>, kTw, kNum>(p, om, k, m, &mism, &valid);
    det_re[i] = d.re;
    det_im[i] = d.im;
    mism_[i] = mism;
    valid_[i] = valid;
  }
  if (out_re != nullptr) {
    out_re[i] = om.re;
    out_im[i] = om.im;
  }
}

// Launch newton_kernel<T, kTw, kNum> over n seeds. Returns the cudaError_t.
template <class T, bool kTw, bool kNum>
int launch_variant(const void* om_re, const void* om_im, const void* k,
                   const void* m, void* out_re, void* out_im, long long n,
                   void* det_re, void* det_im, void* mism, void* valid,
                   int n_iter, double damping, int final_eval,
                   const CylDispParams* p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + kCxCylThreads - 1) / kCxCylThreads;
  newton_kernel<T, kTw, kNum>
      <<<static_cast<unsigned>(blocks), kCxCylThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(om_re), static_cast<const T*>(om_im),
          static_cast<const T*>(k), static_cast<const T*>(m),
          static_cast<T*>(out_re), static_cast<T*>(out_im), n,
          static_cast<T*>(det_re), static_cast<T*>(det_im),
          static_cast<T*>(mism), static_cast<bool*>(valid), n_iter, damping,
          final_eval, *p);
  return static_cast<int>(cudaGetLastError());
}

// The variant of the case's chain (p->twisted) and exterior
// (p->exterior_numeric)
template <class T>
int launch(const void* om_re, const void* om_im, const void* k,
           const void* m, void* out_re, void* out_im, long long n,
           void* det_re, void* det_im, void* mism, void* valid, int n_iter,
           double damping, int final_eval, const CylDispParams* p,
           int device, void* stream) {
  if (n <= 0 || n_iter < 0 || final_eval < 0 || final_eval > 1
      || (n_iter > 0 && out_re == nullptr)
      || (final_eval && det_re == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto go = p->twisted ? (p->exterior_numeric ? &launch_variant<T, true, true>
                                              : &launch_variant<T, true, false>)
                       : (p->exterior_numeric
                              ? &launch_variant<T, false, true>
                              : &launch_variant<T, false, false>);
  return go(om_re, om_im, k, m, out_re, out_im, n, det_re, det_im, mism,
            valid, n_iter, damping, final_eval, p, device, stream);
}

// B1 at complex z alone (kve_complex.cuh's device function, which the
// shoot inlines): K_m'/K_m at z for each (z, m), one thread each, for its
// own timing and checks
template <class T>
__global__ void __launch_bounds__(kCxCylThreads)
kve_kernel(const T* __restrict__ z_re, const T* __restrict__ z_im,
           const T* __restrict__ m_, T* __restrict__ out_re,
           T* __restrict__ out_im, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                  + threadIdx.x;
  if (i >= n) return;
  const Cx<T> r = kve_ratio_c<T>(Cx<T>{z_re[i], z_im[i]}, m_[i] < T(0.5));
  out_re[i] = r.re;
  out_im[i] = r.im;
}

template <class T>
int launch_kve(const void* z_re, const void* z_im, const void* m,
               void* out_re, void* out_im, long long n, int device,
               void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + kCxCylThreads - 1) / kCxCylThreads;
  kve_kernel<T><<<static_cast<unsigned>(blocks), kCxCylThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(z_re), static_cast<const T*>(z_im),
      static_cast<const T*>(m), static_cast<T*>(out_re),
      static_cast<T*>(out_im), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cyl_cx
}  // namespace eigk

extern "C" {

// B7, B4-complex, B4-twisted, B1 and B6-complex over n seeds or candidates
// (omega re, omega im, k, m), in the case's chain and exterior: n_iter
// damped Newton steps, the final omega (re, im) to out (null with n_iter =
// 0), then with final_eval the value round there: det (re, im), the %
// mismatch and valid (null without final_eval). The count comes 7th, as
// in every entry. Returns the cudaError_t of the launch.
int eigk_cylinder_newton_f32(const void* om_re, const void* om_im,
                             const void* k, const void* m, void* out_re,
                             void* out_im, long long n, void* det_re,
                             void* det_im, void* mism, void* valid,
                             int n_iter, double damping, int final_eval,
                             const eigk::CylDispParams* p, int device,
                             void* stream) {
  return eigk::cyl_cx::launch<float>(om_re, om_im, k, m, out_re, out_im, n,
                                     det_re, det_im, mism, valid, n_iter,
                                     damping, final_eval, p, device, stream);
}

int eigk_cylinder_newton_f64(const void* om_re, const void* om_im,
                             const void* k, const void* m, void* out_re,
                             void* out_im, long long n, void* det_re,
                             void* det_im, void* mism, void* valid,
                             int n_iter, double damping, int final_eval,
                             const eigk::CylDispParams* p, int device,
                             void* stream) {
  return eigk::cyl_cx::launch<double>(om_re, om_im, k, m, out_re, out_im, n,
                                      det_re, det_im, mism, valid, n_iter,
                                      damping, final_eval, p, device, stream);
}

// K_m'/K_m at n complex arguments (z re, z im, m: sausage where m < 0.5),
// out (re, im); the count comes 6th. Returns the cudaError_t of the launch.
int eigk_kve_ratio_complex_f32(const void* z_re, const void* z_im,
                               const void* m, void* out_re, void* out_im,
                               long long n, int device, void* stream) {
  return eigk::cyl_cx::launch_kve<float>(z_re, z_im, m, out_re, out_im, n,
                                         device, stream);
}

int eigk_kve_ratio_complex_f64(const void* z_re, const void* z_im,
                               const void* m, void* out_re, void* out_im,
                               long long n, int device, void* stream) {
  return eigk::cyl_cx::launch_kve<double>(z_re, z_im, m, out_re, out_im, n,
                                          device, stream);
}

}  // extern "C"
