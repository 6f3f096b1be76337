// Device code shared by the cylinder kernels: the case's parameters
// (CylDispParams), a candidate (Cand), the chains' r-only values (RPoint,
// RowPoint; the twisted RPointTw), the RK4 step of the two-basis
// system, the integration grid and the end of the shoot (finish). The
// density/axial-flow chain's kernels (cylinder_disp.cu), the twisted
// chain's (cylinder_twisted.cu) and the complex-omega ones
// (cylinder_complex.cu) include it; cylinder_disp.cu's C entries
// call the twisted launchers declared at the end when
// CylDispParams::twisted is set.
#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

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
  // the twisted chain instead of the plain one (then log_tail == 0)
  int twisted;
  ProfileParams vphi;    // v_phi(r): the twist profile, f0 = fe = 0
  ProfileParams bphi;    // B_phi(r): the magnetic twist, else uniform 0
  double P_0, gamma;
  double amp2;           // v_twist^2
  double pw2, pw2_m1;    // 2 p, 2 p - 1 (p the twist power)
  double B0_sq;          // B_0^2
  // the numeric exterior (exterior_method="numeric"): W of its span
  // W 2 pi / k, its RK4 steps; else the K_m ratio
  double exterior_wavelengths;
  int exterior_numeric, n_exterior;
};

// A candidate as the chain reads it, with the products of k and m that
// every abscissa repeats
template <class T>
struct Cand {
  T omega, k, m, kB0, k2, mm;
  __device__ Cand(const CylDispParams& p, T omega_, T k_, T m_)
      : omega(omega_), k(k_), m(m_), kB0(k_ * T(p.B_0)), k2(k_ * k_),
        mm(m_ * m_) {}
};

// The values of the Hain-Lust chain that depend on the radius alone
// (cylinder.py:113-127; equilibrium.py:225-242 inline): one entry of the
// r-only table. 16-byte aligned, so a thread reads an entry in a few
// vector loads; a candidate whose row is tabled reads the first three.
template <class T>
struct alignas(16) RPoint {
  T r, rho, rho_csum, U, rr, sqrt_rho, ci, csum, sqrt_csum;
};

template <class T>
__device__ __forceinline__ RPoint<T> r_point(const CylDispParams& p, T r) {
  RPoint<T> q;
  T vA;
  density_speeds(p.rho, p.uniform_density, p.vA_i0, p.c_i0, p.rho_i0,
                 p.c2_num, p.half_g, r, q.rho, vA, q.ci);
  q.U = p.zero_flow ? T(0) : profile(p.flow, r);
  q.r = r;
  q.rr = r * r;
  q.sqrt_rho = sqrt(q.rho);
  q.csum = q.ci * q.ci + vA * vA;
  q.sqrt_csum = sqrt(q.csum);
  q.rho_csum = q.rho * q.csum;
  return q;
}

// The values of the chain that depend on (k, m, r) and not on omega
// (cylinder.py:181-190): k U, alf^2 and cusp^2 (alf = k B_z / sqrt(rho),
// cusp = alf c_i / sqrt(c_i^2 + vA^2)) and X = (c_i^2 + vA^2) (m^2/r^2 +
// k^2); one entry of the scan's row table. Three of an evaluation's five
// divisions are here.
template <class T>
struct alignas(16) RowPoint {
  T kU, alf2, cusp2, X;
};

template <class T>
__device__ __forceinline__ RowPoint<T> row_point(const RPoint<T>& q,
                                                 const Cand<T>& c) {
  RowPoint<T> w;
  w.kU = c.k * q.U;                         // m v_phi/r + k U
  const T alf = c.kB0 / q.sqrt_rho;         // m B_phi/r + k B_z/sqrt(rho)
  const T cusp = alf * q.ci / q.sqrt_csum;
  w.alf2 = alf * alf;
  w.cusp2 = cusp * cusp;
  w.X = q.csum * (c.mm / q.rr + c.k2);
  return w;
}

// The twisted chain's r-only values (physics/cylinder.py::TwistedPoint),
// with the r-derivatives that r C1/C3 needs and the reciprocals of the
// chain's r-only divisors: 21 values, 96 / 176 bytes.
template <class T>
struct alignas(16) RPointTw {
  T r, rho, isr;
  Dual<T> iR, v, b, Bz, csum, cr, U, rdc, iRR;
};

// A twist profile (v_phi, B_phi: profiles.make_profile with f0 = fe = 0)
// or its derivative of `order` 1 or 2: a power law, with its powers as
// profiles.power forms them, or uniform 0 (the wrapper refuses other kinds)
template <class T>
__device__ __forceinline__ T tw_profile(const ProfileParams& p, T x,
                                        int order) {
  if (p.kind != kPowerLaw) return order == 0 ? T(p.f0) : T(0);
  if (order == 0) return T(p.amplitude) * tpow(x, p.power);
  if (order == 1) return T(p.d1) * tpow(x, p.power_m1);
  return T(p.d2) * tpow(x, p.power_m2);
}

// physics/cylinder.py::twisted_point_fn, operation for operation: the
// profiles and their closed-form derivatives, then dual arithmetic; C3diff'
// and its derivative from x = B_phi/r, y = v_phi/r and their derivatives
template <class T>
__device__ __forceinline__ RPointTw<T> r_point_tw(const CylDispParams& p,
                                                  T r) {
  RPointTw<T> q;
  const Dual<T> R{r, T(1)};
  q.r = r;
  q.iR = drcp(R);
  q.rho = T(p.rho_i0);
  const T sqrt_rho = sqrt(q.rho);
  q.isr = T(1) / sqrt_rho;
  const T rho_a2 = q.rho * T(p.amp2);
  const Dual<T> P{rho_a2 * (tpow(r, p.pw2) / T(p.pw2)) + T(p.P_0),
                  rho_a2 * tpow(r, p.pw2_m1)};
  const Dual<T> ci = dsqrt(P * T(p.gamma) / q.rho);
  const Dual<T> b{tw_profile(p.bphi, r, 0), tw_profile(p.bphi, r, 1)};
  q.b = b;
  q.Bz = T(p.B_0) * dsqrt(T(1) - T(2) * (b * b / T(p.B0_sq)));
  const Dual<T> vA = (q.Bz + b) / sqrt_rho;
  q.csum = ci * ci + vA * vA;
  q.cr = ci / dsqrt(q.csum);
  const Dual<T> v{tw_profile(p.vphi, r, 0), tw_profile(p.vphi, r, 1)};
  q.v = v;
  const T x = b.v / r;
  const T x1 = (b.d - x) / r;
  const T y = v.v / r;
  const T y1 = (v.d - y) / r;
  const Dual<T> X1{x1, (tw_profile(p.bphi, r, 2) - T(2) * x1) / r};
  const Dual<T> Y1{y1, (tw_profile(p.vphi, r, 2) - T(2) * y1) / r};
  const Dual<T> dC = T(2) * Dual<T>{x, x1} * X1
                   - q.rho * (T(2) * Dual<T>{y, y1} * Y1);
  q.U = p.zero_flow ? Dual<T>{T(0), T(0)}
                    : Dual<T>{profile(p.flow, r), profile_d1(p.flow, r)};
  q.rdc = R * dC;
  q.iRR = drcp(R * R);
  return q;
}

// One step of `_rk4_linear2` (cylinder.py:50-85): classical RK4 for the
// two-basis linear system d(P, w)/dx = (w iF, g P) with the coefficients at
// the step's 3 abscissae (A: x, M: x + h/2, B: x + h); shared by the scan
// and the consumer warp of the fused bisection.
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

// The integration grid: n_int steps in r from 1 to eps, then n_log steps
// in t = ln r from ln eps to ln eps_final (none without the log tail); the
// abscissae are formed as `_rk4_linear2` forms them (common.cuh:
// rk4_abscissa)
template <class T>
struct Grid {
  int n_int, n_log;
  T x0i, hi, hhi, h6i;  // r: 1 -> eps
  T x0l, hl, hhl, h6l;  // t: ln eps -> ln eps_final

  __device__ explicit Grid(const CylDispParams& p)
      : n_int(p.n_interior), n_log(p.log_tail ? p.n_axis_log : 0) {
    const T eps = T(p.axis_eps);
    x0i = T(1);
    rk4_spacing(x0i, eps, n_int, hi, hhi, h6i);
    x0l = log(eps);
    rk4_spacing(x0l, log(T(p.axis_eps_final)), p.n_axis_log, hl, hhl, h6l);
  }
};

// The axis condition, the interface values, the exterior, det, the %
// mismatch and valid from the basis states at the axis (cylinder.py:
// 319-385); xi1 = C1(1) / C3(1), J the kink's jump term. ext(m_e) is the
// exterior's dP/dr / P at r = 1 (P_e = 1), taken where the plain version
// takes it.
template <class T, class Ext>
__device__ __forceinline__ void finish_with(const CylDispParams& p, T omega,
                                            T k, T m, T xi1, T F1, T J_kink,
                                            T P1, T w1, T P2, T w2,
                                            const Ext& ext, T& det, T& mism,
                                            bool& valid) {
  const T zero = T(0);
  const T one = T(1);

  // axis condition: m=0: w(eps)=0; m>=1: P(eps)=0
  const bool is_sausage = m < T(0.5);
  const T a1 = is_sausage ? w1 : P1;
  const T a2 = is_sausage ? w2 : P2;

  // interface values: xi_r = C1 P / C3 + w / r
  const T xi2 = F1 / one;

  const T k2 = k * k;
  const T om2 = omega * omega;
  const T m_e = (k2 * T(p.vA_e2) - om2) * (k2 * T(p.c_e2) - om2)
              / (T(p.vAc_e2) * (k2 * T(p.cT_e2) - om2));
  const T dP_e = ext(m_e);
  const T P_e = one;
  const T xi_e = dP_e / (T(p.rho_e) * (om2 - k2 * T(p.vA_e2)));

  // determinant with the twisted kink's jump term (none for m = 0)
  const T J = is_sausage ? zero : J_kink;
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

// finish_with the K_m ratio, or with kNum the numeric exterior
// (common.cuh::cyl_exterior)
template <class T, bool kNum>
__device__ __forceinline__ void finish(const CylDispParams& p, T omega, T k,
                                       T m, T xi1, T F1, T J_kink, T P1, T w1,
                                       T P2, T w2, T& det, T& mism,
                                       bool& valid) {
  const auto ext = [&](T m_e) {
    if constexpr (kNum) {
      // integrated inward from r_far: dP/dr(1) / P(1), P_e = 1
      return cyl_exterior(m_e, k, m, p.exterior_wavelengths, p.n_exterior);
    } else {
      // P_e = K_m(sqrt(m_e) r), logarithmic derivative at r = 1;
      // jnp.maximum(m_e, 1e-300), the floor 0 in float
      const T sq = sqrt(nan_max(m_e, T(p.m_e_floor)));
      T r0, r1;
      kve_ratio_both(sq, r0, r1);
      return sq * (m < T(0.5) ? r0 : r1);
    }
  };
  finish_with(p, omega, k, m, xi1, F1, J_kink, P1, w1, P2, w2, ext, det,
              mism, valid);
}

// The twisted chain's scan (cylinder_twisted.cu), for T = float and double,
// at `threads` a block (kTwScanThreads only); returns the cudaError_t
template <class T>
int launch_cylinder_tw(const void* omega, const void* k, const void* m,
                       void* det, void* mism, void* valid, long long n,
                       int threads, int chunk, const CylDispParams* p,
                       cudaStream_t stream);

}  // namespace eigk
