// Device code shared by the cylinder kernels: the case's parameters
// (CylDispParams), a candidate (Cand), the chains' r-only values (RPoint,
// RowPoint; the twisted RPointTw), the RK4 step of the two-basis
// system, the integration grid, the tables that a block fills chunk by
// chunk in shared memory (Chunk, fill_chunk; the numeric exterior's exps,
// cyl_exterior_scan) and the end of the shoot (finish). The
// density/axial-flow chain's kernels
// (cylinder_disp.cu), the twisted chain's (cylinder_twisted.cu) and the
// complex-omega ones (cylinder_complex.cu) include it; cylinder_disp.cu's
// C entries call the twisted launchers declared at the end when
// CylDispParams::twisted is set.
#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "complex.cuh"
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

// (kInline: the density's and the flow's kinds inlined, profile_form)
template <unsigned kInline = kInlineAll, class T>
__device__ __forceinline__ RPoint<T> r_point(const CylDispParams& p, T r) {
  RPoint<T> q;
  T vA;
  density_speeds<kInline>(p.rho, p.uniform_density, p.vA_i0, p.c_i0,
                          p.rho_i0, p.c2_num, p.half_g, r, q.rho, vA, q.ci);
  q.U = p.zero_flow ? T(0) : profile<kInline>(p.flow, r);
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

// physics/cylinder.py::twisted_point_fn, operation for operation: the
// profiles and their closed-form derivatives (the twist profiles v_phi
// and B_phi of any kind, with f0 = fe = 0; B_phi uniform 0 without a
// magnetic twist), then dual arithmetic; C3diff' and its derivative from
// x = B_phi/r, y = v_phi/r and their derivatives (the kinds inlined,
// profile_form: kInline of the twist profiles, kFlow of the flow's)
template <unsigned kInline = kInlineAll, unsigned kFlow = kInlineAll,
          class T>
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
  const Dual<T> b{profile<kInline>(p.bphi, r),
                   profile_d1<kInline>(p.bphi, r)};
  q.b = b;
  q.Bz = T(p.B_0) * dsqrt(T(1) - T(2) * (b * b / T(p.B0_sq)));
  const Dual<T> vA = (q.Bz + b) / sqrt_rho;
  q.csum = ci * ci + vA * vA;
  q.cr = ci / dsqrt(q.csum);
  const Dual<T> v{profile<kInline>(p.vphi, r),
                   profile_d1<kInline>(p.vphi, r)};
  q.v = v;
  const T x = b.v / r;
  const T x1 = (b.d - x) / r;
  const T y = v.v / r;
  const T y1 = (v.d - y) / r;
  const Dual<T> X1{
      x1, (profile_d2<kInline>(p.bphi, r) - T(2) * x1) / r};
  const Dual<T> Y1{
      y1, (profile_d2<kInline>(p.vphi, r) - T(2) * y1) / r};
  const Dual<T> dC = T(2) * Dual<T>{x, x1} * X1
                   - q.rho * (T(2) * Dual<T>{y, y1} * Y1);
  q.U = p.zero_flow ? Dual<T>{T(0), T(0)}
                    : Dual<T>{profile<kFlow>(p.flow, r),
                              profile_d1<kFlow>(p.flow, r)};
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

// The radius at abscissa x: x in r, exp(x) on the log tail
template <class T, bool kLog>
__device__ __forceinline__ T radius(T x) {
  return kLog ? exp(x) : x;
}

// The tables' chunks: steps [c C, c C + C) of the r part for c < nci, then
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

// Rows of a block's row table: a block tables the (k, m) rows of its
// first and of its last candidate (or seed). A ladder row is a run of
// n_omega candidates that share (k, m) (search.py flattens the scan as
// (rows, n_omega)), a complex sweep's a run of a k's seeds
// (sweep.complex_seeds: per k, per band); where the run is at least the
// block, a block spans at most two rows, and the table covers every
// candidate of it.
constexpr int kRows = 2;

// The rows of a block of `threads` candidates from b0 (of n): its first
// and last candidates' (k, m), published in the block's shared km[4], two
// unless they are one, filled (`fill`) unless no warp reads them; returns
// the row of the candidate (k, m) (0, 1; -1 where it, or a lane of its
// warp, is in neither: a warp takes one path, so that a batch of short
// rows does not run both in its warps), and adds to `count` the batch's
// candidates (`counted`) that read a row. Every thread of the block calls
// it (it holds the block's barriers).
template <class T>
__device__ __forceinline__ int block_row(const T* k_, const T* m_, int64_t b0,
                                         int64_t n, int threads, T k, T m,
                                         bool counted, T* km, bool& two,
                                         bool& fill,
                                         unsigned long long* count) {
  const int64_t end = b0 + threads;
  const int64_t last = (end < n ? end : n) - 1;
  const T k0 = k_[b0], m0 = m_[b0], k1 = k_[last], m1 = m_[last];
  two = !(same_bits(k1, k0) && same_bits(m1, m0));
  int row = same_bits(k, k0) && same_bits(m, m0)         ? 0
          : two && same_bits(k, k1) && same_bits(m, m1) ? 1
                                                         : -1;
  if (!__all_sync(0xffffffffu, row >= 0)) row = -1;
  if (threadIdx.x == 0) {
    km[0] = k0;
    km[1] = m0;
    km[2] = k1;
    km[3] = m1;
  }
  // publishes km
  const int n_tabled = __syncthreads_count(row >= 0 && counted);
  fill = __syncthreads_or(row >= 0);
  if (threadIdx.x == 0 && n_tabled) {
    atomicAdd(count, static_cast<unsigned long long>(n_tabled));
  }
  return row;
}

// The block fills the table entries of a chunk, 3 per step (A, M, B), one
// abscissa per thread at a time: its r-only entry point(r) (on the log
// tail at r = exp(t)) and, from it, its entry in the first row,
// row_of(q, 0), and, where the block has two, in the second,
// row_of(q, 1), `slot` further, unless no warp reads them (!rows).
template <class T, class Q, class Row, class PointF, class RowF>
__device__ __forceinline__ void fill_chunk(const Grid<T>& g, const Chunk& ch,
                                           bool rows, bool two, int slot,
                                           Q* dst, Row* wdst,
                                           const PointF& point,
                                           const RowF& row_of) {
  for (int e = threadIdx.x; e < 3 * ch.count; e += blockDim.x) {
    const int i = ch.i0 + e / 3, a = e % 3;
    const Q q = point(ch.log ? radius<T, true>(
                                   rk4_abscissa(g.x0l, g.hl, g.hhl, i, a))
                             : rk4_abscissa(g.x0i, g.hi, g.hhi, i, a));
    dst[e] = q;
    if (rows) {
      wdst[e] = row_of(q, 0);
      if (two) wdst[slot + e] = row_of(q, 1);
    }
  }
}

// The numeric exterior of a block (common.cuh::cyl_exterior, operation
// for operation, on a real state or, at complex omega, a complex value or
// dual W), with exp(2 t) read from a table of the block for the distinct k
// of its rows (km, block_row's: k0 and, where it differs, k1; the
// candidate's k, or a lane's of its warp, may be neither): the block
// fills exp(2 t) at the 3 abscissae of as many steps of each tabled k at
// a time as `tab_bytes` hold into `tab`, where no table of the interior is
// live any more. Every thread of the block calls it (it holds the block's
// barriers); `counted`: the candidate is one of the batch's, which `count`
// (if set) counts where it read the table.
template <class T, class W>
__device__ W cyl_exterior_scan(const CylDispParams& p, W m_e, T k, T m,
                               const T* km, size_t tab_bytes, T* tab,
                               bool counted, unsigned long long* count) {
  const T k0 = km[0], k1 = km[2];
  const bool two = !same_bits(k1, k0);
  int ek = same_bits(k, k0) ? 0 : two && same_bits(k, k1) ? 1 : -1;
  const int ec = static_cast<int>(tab_bytes / (kRows * 3 * sizeof(T)));
  const int n = p.n_exterior;
  const double Wl = p.exterior_wavelengths;
  T r_far, t0, h, hh, h6;
  cyl_ext_grid(k, Wl, n, r_far, t0, h, hh, h6);
  // the tabled ks' grids, for the fill
  T rf0, t00, h0, hh0, h60, rf1, t01, h1, hh1, h61;
  cyl_ext_grid(k0, Wl, n, rf0, t00, h0, hh0, h60);
  cyl_ext_grid(k1, Wl, n, rf1, t01, h1, hh1, h61);
  const T mm = m * m;
  W P = Const<W>::of(T(1e-8));
  W D = Const<W>::of(T(-1e-8) * r_far);
  // a warp takes one path; a block none of whose warps reads the table
  // does not fill it
  if (!__all_sync(0xffffffffu, ek >= 0)) ek = -1;
  const int n_tabled = __syncthreads_count(ek >= 0 && counted);
  if (threadIdx.x == 0 && n_tabled && count != nullptr) {
    atomicAdd(count, static_cast<unsigned long long>(n_tabled));
  }
  const int n_fill = __syncthreads_or(ek >= 0) ? (two ? 2 : 1) : 0;
  for (int s0 = 0; s0 < n; s0 += ec) {
    const int cnt = min(ec, n - s0);
    if (s0 > 0) __syncthreads();           // the last chunk's readers done
    for (int e = threadIdx.x; e < n_fill * 3 * cnt; e += blockDim.x) {
      const bool second = e >= 3 * cnt;
      const int f = second ? e - 3 * cnt : e;
      tab[e] = second ? cyl_ext_exp(t01, h1, hh1, s0 + f / 3, f % 3)
                      : cyl_ext_exp(t00, h0, hh0, s0 + f / 3, f % 3);
    }
    __syncthreads();
    if (ek >= 0) {
      const T* E = tab + ek * 3 * cnt;
      for (int j = 0; j < cnt; ++j, E += 3) {
        cyl_ext_step(mm, m_e, E[0], E[1], E[2], h, hh, h6, P, D);
      }
    } else {
      for (int i = s0; i < s0 + cnt; ++i) {
        cyl_ext_step(mm, m_e, cyl_ext_exp(t0, h, hh, i, 0),
                     cyl_ext_exp(t0, h, hh, i, 1),
                     cyl_ext_exp(t0, h, hh, i, 2), h, hh, h6, P, D);
      }
    }
  }
  return quot(D, P);
}

// The exterior's m_e at (omega, k) (cylinder.py:304), in finish_with's
// order: the fused bisection's producers form it for their exterior
template <class T>
__device__ __forceinline__ T exterior_m_e(const CylDispParams& p, T omega,
                                          T k) {
  const T k2 = k * k;
  const T om2 = omega * omega;
  return (k2 * T(p.vA_e2) - om2) * (k2 * T(p.c_e2) - om2)
       / (T(p.vAc_e2) * (k2 * T(p.cT_e2) - om2));
}

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
  const T m_e = exterior_m_e(p, omega, k);
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
