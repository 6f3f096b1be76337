// Cylinder dispersion determinant over a batch of (omega, k, m) candidates.
//
// Port of the XLA program `jit(vmap(disp))` of
// `eigensolver_tpu/physics/cylinder.py::CylinderPhysics.make_dispersion`
// (cylinder.py:236-385) with the mode as a per-candidate column
// (`eigensolver_tpu/sweep.py::make_dispersion_moded`), for the non-twisted,
// real-omega cases with the analytic ("bessel") exterior. On the TPU the
// interior was an XLA-fused `lax.scan` and the exterior either fused XLA or
// the Pallas kernel `kernels/bessel.py::kve_ratio_pallas`; here each
// candidate's state stays in the registers of one thread:
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
// evaluations of the Hain-Lust chain plus the RK4 updates, against 24 bytes
// in and 17 bytes out: operations, not memory. Much of the chain depends on
// r alone (cylinder.py:113-127): rho, vA, c_i, sqrt(rho), c_i^2 + vA^2 and
// its square root, U(r), r r, and r = exp(t) on the tail - every exp, every
// square root and 3 of the 8 divisions of an evaluation. And r itself comes
// from the launch parameters only. So the scan (cylinder_disp_kernel) keeps
// a table of those values in shared memory: each block computes them for a
// chunk of steps cooperatively, one abscissa per thread, into a
// double-buffered ring (one barrier per chunk), and every thread reads them
// as warp-uniform broadcasts. What stays per candidate and abscissa is the
// shift, alpha, the cusp speed, the D, A, C2 products and 1/F, g: 5
// divisions, no square root, no exp. The plain PyTorch version computes the
// r-only values once per abscissa as 0-d tensors, in this order, so the
// table gives its bits.
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
// so its (root, mismatch) are bit-equal to the launch loop's. Its
// producers compute both parts of the chain per bracket.
//
// The twisted tubes (rotational flow v_phi, magnetic twist B_phi) are a
// compile-time variant of both kernels (kTwisted), which the C entries
// pick from CylDispParams::twisted, so the non-twisted instantiations are
// the code they were. There every term of the chain is live: C1 with shift^2, B, A with r dC3diff/dr, C3 =
// D A + B, and g with -d(r C1/C3)/dr, which the JAX code takes from a
// jax.jvp (cylinder.py:189-208). Here the chain runs on dual numbers
// (value, d/dr; common.cuh::Dual) in the plain version's order
// (physics/cylinder.py::twisted_chain). The r-only part (RPointTw: v_phi,
// B_phi, B_z, c_i, c^2 + vA^2 and its root, U, r dC3diff/dr, each with its
// derivative; rho, sqrt(rho), r) fills the scan's table, 19 values; no log
// tail (the JAX code keeps the reference's eps there), and the kink's jump
// term J = B_phi(1)^2 - rho v_phi(1)^2 enters the determinant. Per
// candidate and abscissa the dual chain costs ~25 divisions, against 5 of
// the non-twisted one. The fused bisection's producers compute the r-only
// part per bracket, as for the other chain.
#include <cmath>
#include <cstdint>
#include <type_traits>

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
  // the twisted chain instead of the plain one (then log_tail == 0)
  int twisted;
  ProfileParams vphi;    // v_phi(r): the twist profile, f0 = fe = 0
  ProfileParams bphi;    // B_phi(r): the magnetic twist, else uniform 0
  double P_0, gamma;
  double amp2;           // v_twist^2
  double pw2, pw2_m1;    // 2 p, 2 p - 1 (p the twist power)
  double B0_sq;          // B_0^2
};

// The values of the Hain-Lust chain that depend on the radius alone
// (cylinder.py:113-127; equilibrium.py:225-242 inline): one entry of the
// scan's table. 16-byte aligned, so a thread reads an entry in a few
// vector loads.
template <class T>
struct alignas(16) RPoint {
  T r, rr, rho, sqrt_rho, ci, csum, sqrt_csum, rho_csum, U;
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

// The twisted chain's r-only values, with the r-derivatives that r C1/C3
// needs (physics/cylinder.py::TwistedPoint): 19 values, 80 / 160 bytes.
template <class T>
struct alignas(16) RPointTw {
  T r, rho, sqrt_rho;
  Dual<T> v, b, Bz, ci, csum, sqrt_csum, U, rdc;
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
  q.rho = T(p.rho_i0);
  q.sqrt_rho = sqrt(q.rho);
  const T rho_a2 = q.rho * T(p.amp2);
  const Dual<T> P{rho_a2 * (tpow(r, p.pw2) / T(p.pw2)) + T(p.P_0),
                  rho_a2 * tpow(r, p.pw2_m1)};
  q.ci = dsqrt(P * T(p.gamma) / q.rho);
  const Dual<T> b{tw_profile(p.bphi, r, 0), tw_profile(p.bphi, r, 1)};
  q.b = b;
  q.Bz = T(p.B_0) * dsqrt(T(1) - T(2) * (b * b / T(p.B0_sq)));
  const Dual<T> vA = (q.Bz + b) / q.sqrt_rho;
  q.csum = q.ci * q.ci + vA * vA;
  q.sqrt_csum = dsqrt(q.csum);
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
  return q;
}

// The twisted chain at the radius of q (physics/cylinder.py::twisted_chain,
// cylinder.py:110-208 with C1's shift^2): D, C1, A, B, C3 and r C1/C3 with
// their r-derivatives, C2 without
template <class T>
struct TwChain {
  Dual<T> D, C1, A, B, C3, rc;
  T C2;
};

template <class T>
__device__ __forceinline__ TwChain<T> twisted_chain(const RPointTw<T>& q,
                                                    T omega, T k, T m) {
  TwChain<T> c;
  const Dual<T> R{q.r, T(1)};
  const Dual<T> RR = R * R;
  const Dual<T> mb_r = m * q.b / R;
  const Dual<T> shift = omega - m * q.v / R - k * q.U;
  const Dual<T> alf = mb_r + k * q.Bz / q.sqrt_rho;
  const Dual<T> cusp = alf * q.ci / q.sqrt_csum;
  const Dual<T> s2 = shift * shift;
  const Dual<T> da = s2 - alf * alf;
  const Dual<T> dc = s2 - cusp * cusp;
  c.D = q.rho * q.csum * da * dc;
  const Dual<T> fb = mb_r + k * q.Bz;
  const Dual<T> Q = -da * q.rho * (q.v * q.v) / R
                  + T(2) * s2 * (q.b * q.b) / R
                  + T(2) * shift * q.b * q.v * fb / R;
  const Dual<T> Tt = fb * q.b + q.rho * q.v * shift;
  c.C1 = Q * s2 - T(2) * m * q.csum * dc * Tt / RR;
  c.C2 = s2.v * s2.v - q.csum.v * (m * m / RR.v + k * k) * dc.v;
  c.A = q.rho * da + q.rdc;
  c.B = Q * Q - T(4) * q.csum * dc * (Tt * Tt) / RR;
  c.C3 = c.D * c.A + c.B;
  c.rc = R * c.C1 / c.C3;
  return c;
}

// (1/F, g) of the twisted chain at the radius of q
template <class T>
__device__ __forceinline__ void invF_g_tw(const RPointTw<T>& q, T omega, T k,
                                          T m, T& iF, T& g) {
  const TwChain<T> c = twisted_chain(q, omega, k, m);
  iF = c.A.v / q.r + c.B.v / (q.r * c.D.v);
  g = -c.rc.d - q.r * (c.C2 - c.C1.v * c.C1.v / c.C3.v) / c.D.v;
}

// A candidate as the chain reads it, with the products of k and m that
// every abscissa repeats
template <class T>
struct Cand {
  T omega, k, m, kB0, k2, mm;
  __device__ Cand(const CylDispParams& p, T omega_, T k_, T m_)
      : omega(omega_), k(k_), m(m_), kB0(k_ * T(p.B_0)), k2(k_ * k_),
        mm(m_ * m_) {}
};

// D, A, C2 of the Hain-Lust chain at the radius of q (cylinder.py:110-168
// with v_phi == B_phi == 0)
template <class T>
__device__ __forceinline__ void hain_lust(const RPoint<T>& q, const Cand<T>& c,
                                          T& D, T& A, T& C2) {
  const T shift = c.omega - c.k * q.U;      // omega - m v_phi/r - k U
  const T alf = c.kB0 / q.sqrt_rho;         // m B_phi/r + k B_z/sqrt(rho)
  const T cusp = alf * q.ci / q.sqrt_csum;
  const T s2 = shift * shift;
  const T da = s2 - alf * alf;
  const T dc = s2 - cusp * cusp;
  D = q.rho_csum * da * dc;
  A = q.rho * da;                           // + r dC3diff/dr == 0
  C2 = s2 * s2 - q.csum * (c.mm / q.rr + c.k2) * dc;
}

// invF_g (cylinder.py:189-208): (1/F, g) at the radius of q; on the log
// tail (kLog) the coefficients in t = ln r, (r iF, r g) (cylinder.py:273-279)
template <class T, bool kLog>
__device__ __forceinline__ void invF_g(const RPoint<T>& q, const Cand<T>& c,
                                       T& iF, T& g) {
  T D, A, C2;
  hain_lust(q, c, D, A, C2);
  const T C3 = D * A + T(0);               // + B, B == 0
  const T c1c3 = zero_over(C3);            // C1^2/C3 and d(r C1/C3)/dr
  iF = A / q.r + zero_over(q.r * D);       // A/r + B/(r D)
  g = -c1c3 - q.r * (C2 - c1c3) / D;
  if (kLog) {
    iF = q.r * iF;
    g = q.r * g;
  }
}

// The radius at abscissa x: x in r, exp(x) on the log tail
template <class T, bool kLog>
__device__ __forceinline__ T radius(T x) {
  return kLog ? exp(x) : x;
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

// interface chain at r = 1: C3(1) and F(1) = r D / C3
template <class T>
__device__ __forceinline__ void interface1(const CylDispParams& p,
                                           const Cand<T>& c, T& C3_1, T& F1) {
  const T one = T(1);
  T D1, A1, C2_1;
  hain_lust(r_point(p, one), c, D1, A1, C2_1);
  C3_1 = D1 * A1 + T(0);
  F1 = one * D1 / C3_1;
}

// What the end of the shoot reads from r = 1: the u1 basis' xi_r and F(1)
// = r D / C3, and J = B_phi(1)^2 - rho v_phi(1)^2; non-twisted (C3(1),
// F(1)), from which xi_r = zero_over(C3(1)) and J = 0
template <class T>
struct Iface {
  T C3_1, F1;
};

template <class T>
struct IfaceTw {
  T xi1, F1, J;
};

// the twisted chain at r = 1
template <class T>
__device__ __forceinline__ IfaceTw<T> interface1_tw(const CylDispParams& p,
                                                    const Cand<T>& c) {
  const T one = T(1);
  IfaceTw<T> f;
  const TwChain<T> t = twisted_chain(r_point_tw(p, one), c.omega, c.k, c.m);
  f.F1 = one * t.D.v / t.C3.v;
  f.xi1 = t.C1.v * one / t.C3.v + T(0);
  const T b1 = tw_profile(p.bphi, one, 0);
  const T v1 = tw_profile(p.vphi, one, 0);
  f.J = b1 * b1 - T(p.rho_i0) * (v1 * v1);
  return f;
}

// The axis condition, the interface values, the K_m exterior, det, the %
// mismatch and valid from the basis states at the axis (cylinder.py:
// 352-385); xi1 = C1(1) / C3(1), J the kink's jump term
template <class T>
__device__ __forceinline__ void finish(const CylDispParams& p, T omega, T k,
                                       T m, T xi1, T F1, T J_kink, T P1, T w1,
                                       T P2, T w2, T& det, T& mism,
                                       bool& valid) {
  const T zero = T(0);
  const T one = T(1);

  // axis condition: m=0: w(eps)=0; m>=1: P(eps)=0
  const bool is_sausage = m < T(0.5);
  const T a1 = is_sausage ? w1 : P1;
  const T a2 = is_sausage ? w2 : P2;

  // interface values: xi_r = C1 P / C3 + w / r
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

// The scan's chunks: steps [c C, c C + C) of the r part for c < nci, then
// the log tail's; a chunk never spans both
struct Chunk {
  bool log;
  int i0, count;
};

template <class T>
__device__ __forceinline__ Chunk chunk_at(const Grid<T>& g, int nci, int C,
                                          int c) {
  if (c < nci) return {false, c * C, min(C, g.n_int - c * C)};
  const int i0 = (c - nci) * C;
  return {true, i0, min(C, g.n_log - i0)};
}

// The scan's table entry: the r-only values of the chain
template <class T, bool kTwisted>
using TableEntry = std::conditional_t<kTwisted, RPointTw<T>, RPoint<T>>;

// The block fills the table entries of a chunk, 3 per step (A, M, B), one
// entry per thread at a time. The twisted chain has no log tail.
template <class T, bool kTwisted>
__device__ __forceinline__ void fill_chunk(const CylDispParams& p,
                                           const Grid<T>& g, const Chunk& ch,
                                           TableEntry<T, kTwisted>* dst) {
  for (int e = threadIdx.x; e < 3 * ch.count; e += blockDim.x) {
    const int i = ch.i0 + e / 3, a = e % 3;
    if constexpr (kTwisted) {
      dst[e] = r_point_tw(p, rk4_abscissa(g.x0i, g.hi, g.hhi, i, a));
    } else {
      dst[e] = ch.log ? r_point(p, radius<T, true>(
                                       rk4_abscissa(g.x0l, g.hl, g.hhl, i, a)))
                      : r_point(p, rk4_abscissa(g.x0i, g.hi, g.hhi, i, a));
    }
  }
}

// A candidate's RK4 steps over one chunk of the table
template <class T, bool kLog, bool kTwisted>
__device__ __forceinline__ void run_chunk(const TableEntry<T, kTwisted>* q,
                                          int count, T h, T hh, T h6,
                                          const Cand<T>& c, T& P1, T& w1,
                                          T& P2, T& w2) {
  for (int j = 0; j < count; ++j, q += 3) {
    T iFA, gA, iFM, gM, iFB, gB;
    if constexpr (kTwisted) {
      invF_g_tw(q[0], c.omega, c.k, c.m, iFA, gA);
      invF_g_tw(q[1], c.omega, c.k, c.m, iFM, gM);
      invF_g_tw(q[2], c.omega, c.k, c.m, iFB, gB);
    } else {
      invF_g<T, kLog>(q[0], c, iFA, gA);
      invF_g<T, kLog>(q[1], c, iFM, gM);
      invF_g<T, kLog>(q[2], c, iFB, gB);
    }
    rk4_step2(h, hh, h6, iFA, gA, iFM, gM, iFB, gB, P1, w1, P2, w2);
  }
}

// The ladder scan: one thread per candidate, kThreads per block, the
// r-only table in chunks of `chunk` steps (dynamic shared memory: 2 x 3
// chunk entries). Threads past n evaluate a copy of the last candidate, so
// that every thread reaches the block's barriers, and store nothing.
// kTwisted: the twisted chain (RPointTw, twisted_chain; no log tail, which
// the host guarantees with log_tail = 0).
template <class T, bool kTwisted, int kThreads>
__global__ void __launch_bounds__(kThreads)
cylinder_disp_kernel(const T* __restrict__ omega_, const T* __restrict__ k_,
                     const T* __restrict__ m_, T* __restrict__ det_,
                     T* __restrict__ mism_, bool* __restrict__ valid_,
                     int64_t n, int chunk,
                     const __grid_constant__ CylDispParams p) {
  using Entry = TableEntry<T, kTwisted>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Entry* table = reinterpret_cast<Entry*>(smem_raw);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t idx = i < n ? i : n - 1;
  const Cand<T> c(p, omega_[idx], k_[idx], m_[idx]);
  const Grid<T> g(p);

  std::conditional_t<kTwisted, IfaceTw<T>, Iface<T>> f;
  if constexpr (kTwisted) {
    f = interface1_tw(p, c);
  } else {
    interface1(p, c, f.C3_1, f.F1);
  }

  // u1: P(1)=1, P'(1)=0  |  u2: P(1)=0, P'(1)=1  (w = F P')
  T P1 = T(1), w1 = T(0), P2 = T(0), w2 = f.F1 * T(1);
  const int nci = (g.n_int + chunk - 1) / chunk;
  const int n_chunks = nci + (g.n_log + chunk - 1) / chunk;
  const int slot = 3 * chunk;
  if (n_chunks > 0) {
    fill_chunk<T, kTwisted>(p, g, chunk_at(g, nci, chunk, 0), table);
  }
  __syncthreads();
  for (int ci = 0; ci < n_chunks; ++ci) {
    // fill the other buffer while this one is read: the barrier below
    // publishes it and retires this one
    if (ci + 1 < n_chunks) {
      fill_chunk<T, kTwisted>(p, g, chunk_at(g, nci, chunk, ci + 1),
                              table + ((ci + 1) & 1) * slot);
    }
    const Chunk ch = chunk_at(g, nci, chunk, ci);
    const Entry* q = table + (ci & 1) * slot;
    if (!kTwisted && ch.log) {
      run_chunk<T, true, kTwisted>(q, ch.count, g.hl, g.hhl, g.h6l, c, P1, w1,
                                   P2, w2);
    } else {
      run_chunk<T, false, kTwisted>(q, ch.count, g.hi, g.hhi, g.h6i, c, P1,
                                    w1, P2, w2);
    }
    __syncthreads();
  }
  T det, mism;
  bool valid;
  if constexpr (kTwisted) {
    finish(p, c.omega, c.k, c.m, f.xi1, f.F1, f.J, P1, w1, P2, w2, det, mism,
           valid);
  } else {
    finish(p, c.omega, c.k, c.m, zero_over(f.C3_1) + T(0), f.F1, T(0), P1, w1,
           P2, w2, det, mism, valid);
  }
  if (i < n) {
    det_[i] = det;
    mism_[i] = mism;
    valid_[i] = valid;
  }
}

// The cylinder chain as the fused bisection (bisect.cuh) runs it: steps
// 0 .. n_interior - 1 in r from 1 to eps, then the log tail in t = ln r;
// the producers compute both parts of the chain (r_point, invF_g; twisted:
// r_point_tw, invF_g_tw) per bracket, the consumer runs interface1 /
// rk4_step2 / finish.
template <class T_, bool kTwisted>
struct BisectChain {
  using T = T_;
  using Params = CylDispParams;
  static constexpr int kState = 4;  // (P1, w1, P2, w2)
  using Ctx = std::conditional_t<kTwisted, IfaceTw<T>, Iface<T>>;
  const Params& p;
  Grid<T> g;

  __device__ explicit BisectChain(const Params& p_) : p(p_), g(p_) {}
  __device__ int n_steps() const { return g.n_int + g.n_log; }
  __device__ void coef(T omega, T k, T m, int i, int a, T& c0, T& c1) const {
    if constexpr (kTwisted) {
      invF_g_tw(r_point_tw(p, rk4_abscissa(g.x0i, g.hi, g.hhi, i, a)), omega,
                k, m, c0, c1);
    } else {
      const Cand<T> c(p, omega, k, m);
      if (i < g.n_int) {
        invF_g<T, false>(r_point(p, rk4_abscissa(g.x0i, g.hi, g.hhi, i, a)),
                         c, c0, c1);
      } else {
        invF_g<T, true>(
            r_point(p, radius<T, true>(
                           rk4_abscissa(g.x0l, g.hl, g.hhl, i - g.n_int, a))),
            c, c0, c1);
      }
    }
  }
  __device__ void start(T omega, T k, T m, T* y, Ctx& ctx) const {
    if constexpr (kTwisted) {
      ctx = interface1_tw(p, Cand<T>(p, omega, k, m));
    } else {
      interface1(p, Cand<T>(p, omega, k, m), ctx.C3_1, ctx.F1);
    }
    y[0] = T(1);
    y[1] = T(0);
    y[2] = T(0);
    y[3] = ctx.F1 * T(1);
  }
  __device__ void step(int i, const T* c, int s, T* y) const {
    const bool in_r = i < g.n_int;
    rk4_step2(in_r ? g.hi : g.hl, in_r ? g.hhi : g.hhl, in_r ? g.h6i : g.h6l,
              c[0], c[s], c[2 * s], c[3 * s], c[4 * s], c[5 * s], y[0], y[1],
              y[2], y[3]);
  }
  __device__ void finish(T omega, T k, T m, const T* y, const Ctx& ctx, T& det,
                         T& mism) const {
    bool valid;
    if constexpr (kTwisted) {
      eigk::finish(p, omega, k, m, ctx.xi1, ctx.F1, ctx.J, y[0], y[1], y[2],
                   y[3], det, mism, valid);
    } else {
      eigk::finish(p, omega, k, m, zero_over(ctx.C3_1) + T(0), ctx.F1, T(0),
                   y[0], y[1], y[2], y[3], det, mism, valid);
    }
  }
};

template <class T, bool kTwisted, int kThreads>
cudaError_t launch_scan(const void* omega, const void* k, const void* m,
                        void* det, void* mism, void* valid, long long n,
                        int chunk, size_t smem, const CylDispParams* p,
                        cudaStream_t stream) {
  auto* kern = cylinder_disp_kernel<T, kTwisted, kThreads>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(omega), static_cast<const T*>(k),
      static_cast<const T*>(m), static_cast<T*>(det), static_cast<T*>(mism),
      static_cast<bool*>(valid), n, chunk, *p);
  return cudaGetLastError();
}

// The scan's launch at `threads` a block (128, 256 or 512)
template <class T, bool kTwisted>
int launch_scan_threads(const void* omega, const void* k, const void* m,
                        void* det, void* mism, void* valid, long long n,
                        int threads, int chunk, const CylDispParams* p,
                        cudaStream_t s) {
  const size_t smem =
      2 * 3 * static_cast<size_t>(chunk) * sizeof(TableEntry<T, kTwisted>);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (threads) {
    case 128:
      err = launch_scan<T, kTwisted, 128>(omega, k, m, det, mism, valid, n,
                                          chunk, smem, p, s);
      break;
    case 256:
      err = launch_scan<T, kTwisted, 256>(omega, k, m, det, mism, valid, n,
                                          chunk, smem, p, s);
      break;
    case 512:
      err = launch_scan<T, kTwisted, 512>(omega, k, m, det, mism, valid, n,
                                          chunk, smem, p, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The scan of n candidates with `threads` (128, 256 or 512) a block and
// chunks of `chunk` steps, over the chain that p->twisted names; returns
// the cudaError_t
template <class T>
int launch_cylinder(const void* omega, const void* k, const void* m, void* det,
                    void* mism, void* valid, long long n, int threads,
                    int chunk, const CylDispParams* p, int device,
                    void* stream) {
  // the twisted chain has no log tail (the host sets log_tail = 0)
  if (n <= 0 || chunk < 1 || (p->twisted && p->log_tail)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  return p->twisted
             ? launch_scan_threads<T, true>(omega, k, m, det, mism, valid, n,
                                            threads, chunk, p, s)
             : launch_scan_threads<T, false>(omega, k, m, det, mism, valid, n,
                                             threads, chunk, p, s);
}

// The fused bisection of n brackets over the chain that p->twisted names
template <class T>
int launch_cylinder_bisect(const void* lo, const void* hi, const void* k,
                           const void* m, void* root, void* mism, long long n,
                           int n_iter, int final_eval, int B, int P, int C,
                           int S, int min_blocks, const CylDispParams* p,
                           int device, void* stream) {
  if (p->twisted && p->log_tail) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return p->twisted
             ? launch_bisect<BisectChain<T, true>>(
                   lo, hi, k, m, root, mism, n, n_iter, final_eval, B, P, C,
                   S, min_blocks, p, device, stream)
             : launch_bisect<BisectChain<T, false>>(
                   lo, hi, k, m, root, mism, n, n_iter, final_eval, B, P, C,
                   S, min_blocks, p, device, stream);
}

}  // namespace eigk

extern "C" {

// Each scan entry returns the cudaError_t of the launch (0 on success);
// n > 0; threads 128, 256 or 512 a block, chunks of `chunk` table steps.
// Both entries run the twisted chain when p->twisted is set (then with
// log_tail = 0), the plain one otherwise.
int eigk_cylinder_disp_f32(const void* omega, const void* k, const void* m,
                           void* det, void* mism, void* valid, long long n,
                           int threads, int chunk,
                           const eigk::CylDispParams* p, int device,
                           void* stream) {
  return eigk::launch_cylinder<float>(omega, k, m, det, mism, valid, n,
                                      threads, chunk, p, device, stream);
}

int eigk_cylinder_disp_f64(const void* omega, const void* k, const void* m,
                           void* det, void* mism, void* valid, long long n,
                           int threads, int chunk,
                           const eigk::CylDispParams* p, int device,
                           void* stream) {
  return eigk::launch_cylinder<double>(omega, k, m, det, mism, valid, n,
                                       threads, chunk, p, device, stream);
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
  return eigk::launch_cylinder_bisect<float>(
      lo, hi, k, m, root, mism, n, n_iter, final_eval, B, P, C, S, min_blocks,
      p, device, stream);
}

int eigk_cylinder_bisect_f64(const void* lo, const void* hi, const void* k,
                             const void* m, void* root, void* mism,
                             long long n, int n_iter, int final_eval, int B,
                             int P, int C, int S, int min_blocks,
                             const eigk::CylDispParams* p, int device,
                             void* stream) {
  return eigk::launch_cylinder_bisect<double>(
      lo, hi, k, m, root, mism, n, n_iter, final_eval, B, P, C, S, min_blocks,
      p, device, stream);
}

// sizeof(CylDispParams), for the Python mirror's layout check
long long eigk_cylinder_params_size() {
  return static_cast<long long>(sizeof(eigk::CylDispParams));
}

}  // extern "C"
