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
// What bounds it on Hopper: operations. Per seed and RK4 step, up to 3
// evaluations of the complex chain (a complex division, 2 real divisions;
// the twisted chain 2 complex divisions and its dual products; twice the
// products on the Newton pass) and the update of 4 complex (dual) states,
// against 32 bytes in and 48 out per seed. One thread a seed carries its
// whole shoot, its exterior, the determinant and the Newton update in
// registers: a complex sweep's 129,600 (density) or 36,000 (twisted)
// seeds a mode fill the card. Much of the chain does not depend on omega,
// and the seeds of a block share it (sweep.complex_seeds lays them out by
// (k, band) cell, one m a launch: 1,440 seeds a k on cx_cyl_co_09, 600 on
// cx_twist_v01_p1), so, as the real-omega scans do (cylinder_disp.cu,
// cylinder_twisted.cu):
//   - each shoot, the block fills tables in shared memory chunk by chunk
//     (a double-buffered ring, one barrier a chunk; cylinder.cuh::
//     fill_chunk): per abscissa the r-only entry (RPoint, on the log tail
//     at r = exp(t); the twisted RPointTw) and the (k, m, r) entries of the
//     block's rows, its first and last seeds' (k, m) (RowPoint; the
//     twisted RowPointTw: the omega-free values that twisted_chain_c takes
//     as whole operands, in its order of operations); with the numeric
//     exterior, exp(2 t) of the rows' k (cylinder.cuh::cyl_exterior_scan).
//     A warp whose seeds are all in tabled rows reads them; any other (a
//     ragged batch, random draws) forms its own from the r-only table,
//     with the same operations, so the bits do not depend on the path;
//   - where a step's first abscissa is the step before's last, bit for
//     bit (common.cuh::chain_reuse, asked at each step: on cx_cyl_co_09's
//     grids 67% of the interior's steps and 76% of the log tail's at
//     float64, 31% of cx_twist_v01_p1's), the chain formed there is kept;
//     not across the join of the interior and the log tail;
//   - each (type, chain) is built at one launch shape (threads a block,
//     the register budget of min_blocks blocks an SM: CxShape), and the
//     table's chunk is the launch's (kernels.cylinder.NEWTON_SHAPE).
// The Newton rounds, the value round and the evaluation mode run the
// same shoot; threads past n follow a copy of the last seed, so that every
// thread reaches the block's barriers, and store nothing.
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
// at the radius of q from its row's values w; on the log tail (kLog)
// (r iF, r g)
template <class T, class W, bool kLog>
__device__ __forceinline__ void invF_g_plain(const RPoint<T>& q,
                                             const RowPoint<T>& w, W omega,
                                             W& iF, W& g) {
  W D, A, C2;
  parts(q, w, omega, D, A, C2);
  const W C3 = D * A + T(0);
  const W c1c3 = czero_over(C3);
  iF = A / q.r + czero_over(q.r * D);
  g = -c1c3 - quot(q.r * (C2 - c1c3), D);
  if (kLog) {
    iF = q.r * iF;
    g = q.r * g;
  }
}

// The twisted chain's values that do not depend on omega, at the radius
// of q for (k, m): the operands that twisted_chain_c takes whole, each
// formed by the plain version's operations in its order (a product of
// omega-free factors inside a longer product, evaluated left to right
// with omega's, is not among them). Those of (k, m, r), then those of r
// alone that the chain multiplies by; one entry of the row table.
template <class T>
struct alignas(16) RowPointTw {
  Dual<T> mv;    // m v_phi / r: m * v * (1/r)
  Dual<T> kU;    // k U
  Dual<T> alf2;  // alf * alf, alf = m B_phi / r + k B_z / sqrt(rho)
  Dual<T> cusp2; // cusp * cusp, cusp = alf c_i / sqrt(c_i^2 + vA^2)
  Dual<T> fb;    // m B_phi / r + k B_z
  Dual<T> fbb;   // fb * B_phi
  Dual<T> m2cs;  // 2 m (c_i^2 + vA^2)
  Dual<T> rcs;   // rho (c_i^2 + vA^2)
  Dual<T> vv;    // v_phi * v_phi
  Dual<T> bb;    // B_phi * B_phi
  Dual<T> rv;    // rho v_phi
  Dual<T> c4;    // 4 (c_i^2 + vA^2)
  T X;           // (c_i^2 + vA^2) (m^2 / r^2 + k^2)
};

template <class T>
__device__ __forceinline__ RowPointTw<T> row_point_tw(const RPointTw<T>& q,
                                                      T k, T m) {
  RowPointTw<T> w;
  const Dual<T> mb_r = m * q.b * q.iR;
  w.mv = m * q.v * q.iR;
  w.kU = k * q.U;
  const Dual<T> alf = mb_r + k * q.Bz * q.isr;
  const Dual<T> cusp = alf * q.cr;
  w.alf2 = alf * alf;
  w.cusp2 = cusp * cusp;
  w.fb = mb_r + k * q.Bz;
  w.fbb = w.fb * q.b;
  w.m2cs = T(2) * m * q.csum;
  w.X = q.csum.v * (m * m * q.iRR.v + k * k);
  w.rcs = q.rho * q.csum;
  w.vv = q.v * q.v;
  w.bb = q.b * q.b;
  w.rv = q.rho * q.v;
  w.c4 = T(4) * q.csum;
  return w;
}

// The twisted chain at the radius of q (physics/cylinder.py::twisted_chain
// with omega an RD) from its row's values w: D, C1, A, B, C3 and r C1/C3
// (rc) with their r-derivatives, C2 and 1/C3 without
template <class W>
struct TwChainC {
  RD<W> D, C1, A, B, C3, rc;
  W C2, iC3;
};

template <class T, class W>
__device__ __forceinline__ TwChainC<W> twisted_chain_c(
    const RPointTw<T>& q, const RowPointTw<T>& w, W omega) {
  TwChainC<W> c;
  const Dual<T> R{q.r, T(1)};
  const RD<W> om{omega, T(0) * omega};
  const RD<W> shift = om - w.mv - w.kU;
  const RD<W> s2 = shift * shift;
  const RD<W> da = s2 - w.alf2;
  const RD<W> dc = s2 - w.cusp2;
  c.D = w.rcs * da * dc;
  const RD<W> Q = -da * q.rho * w.vv * q.iR + T(2) * s2 * w.bb * q.iR
                + T(2) * shift * q.b * q.v * w.fb * q.iR;
  const RD<W> Tt = w.fbb + w.rv * shift;
  c.C1 = Q * s2 - w.m2cs * dc * Tt * q.iRR;
  c.C2 = s2.v * s2.v - w.X * dc.v;
  c.A = q.rho * da + q.rdc;
  c.B = Q * Q - w.c4 * dc * (Tt * Tt) * q.iRR;
  c.C3 = c.D * c.A + c.B;
  c.iC3 = rquot(T(1), c.C3.v);
  // r C1/C3 by the quotient rule on 1/C3 (dual.over)
  const RD<W> RC1 = R * c.C1;
  const W qv = RC1.v * c.iC3;
  c.rc = {qv, (RC1.d - qv * c.C3.d) * c.iC3};
  return c;
}

// (1/F, g) of the twisted chain at the radius of q from its row's values w
// (physics/cylinder.py::twisted_invF_g)
template <class T, class W>
__device__ __forceinline__ void invF_g_tw(const RPointTw<T>& q,
                                          const RowPointTw<T>& w, W omega,
                                          W& iF, W& g) {
  const TwChainC<W> c = twisted_chain_c<T>(q, w, omega);
  const W iD = rquot(T(1), c.D.v);
  iF = c.A.v * q.iR.v + c.B.v * q.iR.v * iD;
  g = -c.rc.d - q.r * (c.C2 - c.C1.v * c.C1.v * c.iC3) * iD;
}

// A chain's table entries and evaluation: the r-only entry of a radius,
// a (k, m) row's entry from it, (1/F, g) from the two
template <class T, bool kTw>
struct Chain {
  using Q = RPoint<T>;
  using Row = RowPoint<T>;
  __device__ static Q point(const CylDispParams& p, T r) {
    return r_point(p, r);
  }
  __device__ static Row row(const CylDispParams& p, const Q& q, T k, T m) {
    return row_point(q, Cand<T>(p, T(0), k, m));
  }
  template <class W, bool kLog>
  __device__ static void coef(const Q& q, const Row& w, W om, W& iF, W& g) {
    invF_g_plain<T, W, kLog>(q, w, om, iF, g);
  }
};

template <class T>
struct Chain<T, true> {
  using Q = RPointTw<T>;
  using Row = RowPointTw<T>;
  __device__ static Q point(const CylDispParams& p, T r) {
    return r_point_tw<kInlinePowerLaw, kInlineGaussian>(p, r);
  }
  __device__ static Row row(const CylDispParams&, const Q& q, T k, T m) {
    return row_point_tw(q, k, m);
  }
  template <class W, bool>
  __device__ static void coef(const Q& q, const Row& w, W om, W& iF, W& g) {
    invF_g_tw<T>(q, w, om, iF, g);
  }
};

// The tables of a block in its dynamic shared memory, double-buffered by
// chunk: 2 x 3 C r-only entries, then 2 x kRows x 3 C row entries; the
// numeric exterior's exps where they were, once the interior is done
template <class T, bool kTw>
__host__ __device__ constexpr size_t tab_smem(int chunk) {
  return 2 * 3 * static_cast<size_t>(chunk)
       * (sizeof(typename Chain<T, kTw>::Q)
          + kRows * sizeof(typename Chain<T, kTw>::Row));
}

// Where a block's seeds read the tables: the ring (q, w: 2 x 3 C r-only
// entries, 2 x kRows x 3 C row entries; slot = 3 C), the rows' (k, m) in
// km, whether the rows are filled (some warp reads them) and are two, and
// the seed's row (-1: its warp forms its own)
template <class T, bool kTw>
struct Tables {
  typename Chain<T, kTw>::Q* q;
  typename Chain<T, kTw>::Row* w;
  const T* km;
  int chunk, slot, row;
  bool fill_rows, two;
};

// Launches since the host last read them (eigk_cylinder_newton_counts):
// [0] seeds that read a tabled row, [1] seeds whose numeric exterior read
// the tabled exps, [2] the steps of one shoot whose first chain was kept,
// [3] the steps of one shoot (block 0 of each launch adds [2] and [3])
__device__ unsigned long long g_cx_counts[4];

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

// A seed's steps over one chunk of the tables (q, and its row's entries w,
// or null: its own from q), on the interior's grid or (kLog) the log
// tail's; (iFB, gB): the chain at the step before's last abscissa, kept
// where chain_reuse holds
template <class T, class W, bool kTw, bool kLog>
__device__ __forceinline__ void run_chunk(
    const CylDispParams& p, const typename Chain<T, kTw>::Q* q,
    const typename Chain<T, kTw>::Row* w, const Chunk& ch, T x0, T h, T hh,
    T h6, T k, T m, W om, W& iFB, W& gB, W& P1, W& w1, W& P2, W& w2) {
  using Ch = Chain<T, kTw>;
  for (int j = 0; j < ch.count; ++j) {
    const typename Ch::Q* qj = q + 3 * j;
    const typename Ch::Row* wj = w != nullptr ? w + 3 * j : nullptr;
    const auto coef = [&](int a, W& iF, W& g) {
      if (wj != nullptr) {
        Ch::template coef<W, kLog>(qj[a], wj[a], om, iF, g);
      } else {
        Ch::template coef<W, kLog>(qj[a], Ch::row(p, qj[a], k, m), om, iF,
                                   g);
      }
    };
    const int i = ch.i0 + j;
    W iFA, gA, iFM, gM;
    if (i > 0 && chain_reuse(x0, h, hh, i)) {
      iFA = iFB;
      gA = gB;
    } else {
      coef(0, iFA, gA);
    }
    coef(1, iFM, gM);
    coef(2, iFB, gB);
    rk4_step2_c(h, hh, h6, iFA, gA, iFM, gM, iFB, gB, P1, w1, P2, w2);
  }
}

// One shoot at complex omega (physics/cylinder.py::_complex_plain): W a
// complex value (the value round: det, and the % mismatch and valid to
// *mism, *valid) or a complex dual (a Newton round: det and d det/d omega).
// Every thread of the block calls it (it holds the block's barriers);
// `counted`: the seed is one of the batch's, `count`: the shoot adds its
// exterior's tabled seeds to g_cx_counts (the launch's first).
template <class T, class W, bool kTw, bool kNum>
__device__ __forceinline__ W shoot(const CylDispParams& p, const Grid<T>& gr,
                                   const Tables<T, kTw>& tb, Cx<T> omega_c,
                                   T k, T m, bool counted, bool count,
                                   T* mism, bool* valid) {
  using Ch = Chain<T, kTw>;
  const T one = T(1), zero = T(0);
  W om;
  make_omega(omega_c, om);

  // the chain's values at r = 1: F(1), xi_r of u1
  W F1, xi1;
  if constexpr (kTw) {
    const RPointTw<T> q1 =
        r_point_tw<kInlinePowerLaw, kInlineGaussian>(p, one);
    const TwChainC<W> c1 = twisted_chain_c<T>(q1, row_point_tw(q1, k, m), om);
    F1 = quot(one * c1.D.v, c1.C3.v);
    xi1 = quot(c1.C1.v * one, c1.C3.v) + zero;
  } else {
    const RPoint<T> q1 = r_point(p, one);
    W D1, A1, C2_1;
    parts(q1, row_point(q1, Cand<T>(p, zero, k, m)), om, D1, A1, C2_1);
    const W C3_1 = D1 * A1 + zero;
    F1 = quot(one * D1, C3_1);
    xi1 = czero_over(C3_1);
  }

  // interior: u1 = (1, 0), u2 = (0, F(1)) from r = 1 inward, then the log
  // tail eps -> eps_final in t = ln r (none where log_tail is 0; none on
  // the twisted chain), chunk by chunk through the tables
  W P1 = Const<W>::of(one), w1 = Const<W>::of(zero);
  W P2 = Const<W>::of(zero), w2 = F1;
  W iFB = Const<W>::of(zero), gB = Const<W>::of(zero);
  const int C = tb.chunk;
  const int nci = (gr.n_int + C - 1) / C;
  const int n_chunks = nci + (kTw ? 0 : (gr.n_log + C - 1) / C);
  const auto fill = [&](int ci, int b) {
    const T k0 = tb.km[0], m0 = tb.km[1], k1 = tb.km[2], m1 = tb.km[3];
    fill_chunk(
        gr, chunk_at(gr, nci, C, ci), tb.fill_rows, tb.two, tb.slot,
        tb.q + b * tb.slot, tb.w + b * kRows * tb.slot,
        [&](T r) { return Ch::point(p, r); },
        [&](const typename Ch::Q& q, int j) {
          return j ? Ch::row(p, q, k1, m1) : Ch::row(p, q, k0, m0);
        });
  };
  __syncthreads();                 // the shoot before is done with them
  if (n_chunks > 0) fill(0, 0);
  __syncthreads();
  for (int ci = 0; ci < n_chunks; ++ci) {
    // fill the other buffer while this one is read: the barrier below
    // publishes it and retires this one
    const int cb = ci & 1;
    if (ci + 1 < n_chunks) fill(ci + 1, cb ^ 1);
    const Chunk ch = chunk_at(gr, nci, C, ci);
    const typename Ch::Q* q = tb.q + cb * tb.slot;
    const typename Ch::Row* w =
        tb.row >= 0 ? tb.w + (cb * kRows + tb.row) * tb.slot : nullptr;
    if (!kTw && ch.log) {
      run_chunk<T, W, kTw, true>(p, q, w, ch, gr.x0l, gr.hl, gr.hhl, gr.h6l,
                                 k, m, om, iFB, gB, P1, w1, P2, w2);
    } else {
      run_chunk<T, W, kTw, false>(p, q, w, ch, gr.x0i, gr.hi, gr.hhi,
                                  gr.h6i, k, m, om, iFB, gB, P1, w1, P2,
                                  w2);
    }
    __syncthreads();
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
    // the exps' table of the rows' k, in the shared memory that the
    // interior's tables leave
    dP_e = cyl_exterior_scan<T, W>(p, m_e, k, m, tb.km, tab_smem<T, kTw>(C),
                                   reinterpret_cast<T*>(tb.q), counted,
                                   count ? &g_cx_counts[1] : nullptr);
  } else {
    const W sq = wsqrt(m_e);
    dP_e = sq * kve_ratio_c<T>(sq, sausage);
  }
  const W xi_e = quot(dP_e, T(p.rho_e) * (om2 - k2 * T(p.vA_e2)));

  // determinant with the twisted kink's jump term (P_e = 1)
  T J = zero;
  if constexpr (kTw) {
    const T b1 = profile<kInlinePowerLaw>(p.bphi, one);
    const T v1 = profile<kInlinePowerLaw>(p.vphi, one);
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

// The launch shape each (type, chain) is built for: threads a block and
// the register budget of min_blocks blocks an SM (__launch_bounds__); the
// numeric exterior's variant shares its chain's. A build may set them
// (tools_torch/tune_disp.py --kernel cylinder_newton builds this file at
// each shape it times). From timings on an H100 (PERF.md section 6; the
// table's chunk in kernels.cylinder.NEWTON_SHAPE):
//   - float64, density: 3 blocks of 128 (168 registers, 232 B spilled,
//     12 warps an SM), 4.6% ahead of 2 blocks (214 registers, no spill)
//     on cx_cyl_co_09's Newton launch and 15% on its audit;
//   - float64, twisted: 4 blocks of 64 (255 registers, 104 B spilled; 8
//     warps an SM, so cx_twist_v01_p1's 36,000 seeds take 563 blocks of
//     528 resident): the fastest, within 1% of one wave at 9 warps or
//     more, where a sub-partition of the SM holds 3 warps and 168
//     registers spill 488 B;
//   - float32: density 128 threads at any budget (127 registers; every
//     shape timed within 1.5%), twisted 2 blocks of 192 (168 registers,
//     no spill).
#ifndef EIGK_CX_CYL_F32_THREADS
#define EIGK_CX_CYL_F32_THREADS 128
#endif
#ifndef EIGK_CX_CYL_F32_MIN_BLOCKS
#define EIGK_CX_CYL_F32_MIN_BLOCKS 1
#endif
#ifndef EIGK_CX_CYL_F64_THREADS
#define EIGK_CX_CYL_F64_THREADS 128
#endif
#ifndef EIGK_CX_CYL_F64_MIN_BLOCKS
#define EIGK_CX_CYL_F64_MIN_BLOCKS 3
#endif
#ifndef EIGK_CX_CYL_TW_F32_THREADS
#define EIGK_CX_CYL_TW_F32_THREADS 192
#endif
#ifndef EIGK_CX_CYL_TW_F32_MIN_BLOCKS
#define EIGK_CX_CYL_TW_F32_MIN_BLOCKS 2
#endif
#ifndef EIGK_CX_CYL_TW_F64_THREADS
#define EIGK_CX_CYL_TW_F64_THREADS 64
#endif
#ifndef EIGK_CX_CYL_TW_F64_MIN_BLOCKS
#define EIGK_CX_CYL_TW_F64_MIN_BLOCKS 4
#endif

template <class T, bool kTw>
struct CxShape;
template <>
struct CxShape<float, false> {
  static constexpr int threads = EIGK_CX_CYL_F32_THREADS;
  static constexpr int min_blocks = EIGK_CX_CYL_F32_MIN_BLOCKS;
};
template <>
struct CxShape<double, false> {
  static constexpr int threads = EIGK_CX_CYL_F64_THREADS;
  static constexpr int min_blocks = EIGK_CX_CYL_F64_MIN_BLOCKS;
};
template <>
struct CxShape<float, true> {
  static constexpr int threads = EIGK_CX_CYL_TW_F32_THREADS;
  static constexpr int min_blocks = EIGK_CX_CYL_TW_F32_MIN_BLOCKS;
};
template <>
struct CxShape<double, true> {
  static constexpr int threads = EIGK_CX_CYL_TW_F64_THREADS;
  static constexpr int min_blocks = EIGK_CX_CYL_TW_F64_MIN_BLOCKS;
};

// B1 at complex z alone (kve_kernel): threads a block
constexpr int kCxCylThreads = 128;

// B7, B4-complex, B4-twisted, B1 and B6-complex: n_iter damped Newton
// rounds of every seed (one thread each), then with final_eval the value
// round at the final omega (n_iter = 0: the evaluation of the candidates),
// in the case's chain (kTw) and exterior (kNum), through tables of `chunk`
// steps. out (omega) is written if out_re is given, det / mism / valid
// after the value round.
template <class T, bool kTw, bool kNum>
__global__ void __launch_bounds__(CxShape<T, kTw>::threads,
                                  CxShape<T, kTw>::min_blocks)
newton_kernel(const T* __restrict__ om_re, const T* __restrict__ om_im,
              const T* __restrict__ k_, const T* __restrict__ m_,
              T* __restrict__ out_re, T* __restrict__ out_im, int64_t n,
              T* __restrict__ det_re, T* __restrict__ det_im,
              T* __restrict__ mism_, bool* __restrict__ valid_, int n_iter,
              double damping, int final_eval, int chunk,
              const __grid_constant__ CylDispParams p) {
  constexpr int kThreads = CxShape<T, kTw>::threads;
  static_assert(kThreads % 32 == 0, "whole warps: the warp votes");
  using Ch = Chain<T, kTw>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T row_km[2 * kRows];           // the rows' (k, m)
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t i = b0 + threadIdx.x;
  const int64_t idx = i < n ? i : n - 1;
  Cx<T> om{om_re[idx], om_im[idx]};
  const T k = k_[idx], m = m_[idx];
  const Grid<T> gr(p);

  // the block's rows and the seed's (cylinder.cuh::block_row)
  bool two, fill_rows;
  const int row = block_row(k_, m_, b0, n, kThreads, k, m, i < n, row_km, two,
                            fill_rows, &g_cx_counts[0]);
  const int slot = 3 * chunk;
  auto* q = reinterpret_cast<typename Ch::Q*>(smem_raw);
  const Tables<T, kTw> tb{q, reinterpret_cast<typename Ch::Row*>(q + 2 * slot),
                          row_km, chunk, slot, row, fill_rows, two};
  const bool counted = i < n;
#pragma unroll 1
  for (int round = 0; round < n_iter; ++round) {
    const CDual<T> det = shoot<T, CDual<T>, kTw, kNum>(
        p, gr, tb, om, k, m, counted, round == 0, nullptr, nullptr);
    // search.py::newton_step
    const Cx<T> d = det.v, dd = det.d;
    const Cx<T> qd = d / dd;
    Cx<T> step = (dd.re == T(0) && dd.im == T(0)) ? Cx<T>{T(0), T(0)} : qd;
    const T max_step = T(0.2) * (T(1) + cabs(om));
    const T mag = cabs(step);
    if (mag > max_step) step = step * (max_step / mag);
    om = om - T(damping) * step;
  }
  if (final_eval) {
    T mism;
    bool valid;
    const Cx<T> d = shoot<T, Cx<T>, kTw, kNum>(p, gr, tb, om, k, m, counted,
                                               n_iter == 0, &mism, &valid);
    if (i < n) {
      det_re[i] = d.re;
      det_im[i] = d.im;
      mism_[i] = mism;
      valid_[i] = valid;
    }
  }
  if (out_re != nullptr && i < n) {
    out_re[i] = om.re;
    out_im[i] = om.im;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    // the steps of a shoot, and those whose first chain it kept
    unsigned long long kept = 0;
    for (int s = 1; s < gr.n_int; ++s) {
      kept += chain_reuse(gr.x0i, gr.hi, gr.hhi, s);
    }
    const int n_log = kTw ? 0 : gr.n_log;
    for (int s = 1; s < n_log; ++s) {
      kept += chain_reuse(gr.x0l, gr.hl, gr.hhl, s);
    }
    atomicAdd(&g_cx_counts[2], kept);
    atomicAdd(&g_cx_counts[3],
              static_cast<unsigned long long>(gr.n_int + n_log));
  }
}

// Launch newton_kernel<T, kTw, kNum> over n seeds at `threads` a block
// (its CxShape's) and tables of `chunk` steps. Returns the cudaError_t.
template <class T, bool kTw, bool kNum>
int launch_variant(const void* om_re, const void* om_im, const void* k,
                   const void* m, void* out_re, void* out_im, long long n,
                   void* det_re, void* det_im, void* mism, void* valid,
                   int n_iter, double damping, int final_eval, int threads,
                   int chunk, const CylDispParams* p, int device,
                   void* stream) {
  constexpr int kThreads = CxShape<T, kTw>::threads;
  const size_t smem = tab_smem<T, kTw>(chunk);
  if (threads != kThreads || chunk < 1 || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* kern = newton_kernel<T, kTw, kNum>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(om_re), static_cast<const T*>(om_im),
      static_cast<const T*>(k), static_cast<const T*>(m),
      static_cast<T*>(out_re), static_cast<T*>(out_im), n,
      static_cast<T*>(det_re), static_cast<T*>(det_im),
      static_cast<T*>(mism), static_cast<bool*>(valid), n_iter, damping,
      final_eval, chunk, *p);
  return static_cast<int>(cudaGetLastError());
}

// The variant of the case's chain (p->twisted) and exterior
// (p->exterior_numeric)
template <class T>
int launch(const void* om_re, const void* om_im, const void* k,
           const void* m, void* out_re, void* out_im, long long n,
           void* det_re, void* det_im, void* mism, void* valid, int n_iter,
           double damping, int final_eval, int threads, int chunk,
           const CylDispParams* p, int device, void* stream) {
  if (n <= 0 || n_iter < 0 || final_eval < 0 || final_eval > 1
      || (n_iter > 0 && out_re == nullptr)
      || (final_eval && det_re == nullptr) || (p->twisted && p->log_tail)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto go = p->twisted ? (p->exterior_numeric ? &launch_variant<T, true, true>
                                              : &launch_variant<T, true, false>)
                       : (p->exterior_numeric
                              ? &launch_variant<T, false, true>
                              : &launch_variant<T, false, false>);
  return go(om_re, om_im, k, m, out_re, out_im, n, det_re, det_im, mism,
            valid, n_iter, damping, final_eval, threads, chunk, p, device,
            stream);
}

// Registers, local bytes a thread and blocks per SM (out[0..2]) of the
// variant at `chunk`, and its shape (out[3] threads, out[4] min_blocks)
template <class T, bool kTw>
int attrs(bool numeric, int chunk, int* out) {
  constexpr int kThreads = CxShape<T, kTw>::threads;
  const size_t smem = tab_smem<T, kTw>(chunk);
  const int err =
      numeric ? kernel_attrs(newton_kernel<T, kTw, true>, kThreads, smem, out)
              : kernel_attrs(newton_kernel<T, kTw, false>, kThreads, smem,
                             out);
  out[3] = kThreads;
  out[4] = CxShape<T, kTw>::min_blocks;
  return err;
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
// mismatch and valid (null without final_eval); `threads` a block (the
// variant's built shape: eigk_cylinder_newton_attrs) and tables of `chunk`
// steps. The count comes 7th, as in every entry. Returns the cudaError_t
// of the launch.
int eigk_cylinder_newton_f32(const void* om_re, const void* om_im,
                             const void* k, const void* m, void* out_re,
                             void* out_im, long long n, void* det_re,
                             void* det_im, void* mism, void* valid,
                             int n_iter, double damping, int final_eval,
                             int threads, int chunk,
                             const eigk::CylDispParams* p, int device,
                             void* stream) {
  return eigk::cyl_cx::launch<float>(om_re, om_im, k, m, out_re, out_im, n,
                                     det_re, det_im, mism, valid, n_iter,
                                     damping, final_eval, threads, chunk, p,
                                     device, stream);
}

int eigk_cylinder_newton_f64(const void* om_re, const void* om_im,
                             const void* k, const void* m, void* out_re,
                             void* out_im, long long n, void* det_re,
                             void* det_im, void* mism, void* valid,
                             int n_iter, double damping, int final_eval,
                             int threads, int chunk,
                             const eigk::CylDispParams* p, int device,
                             void* stream) {
  return eigk::cyl_cx::launch<double>(om_re, om_im, k, m, out_re, out_im, n,
                                      det_re, det_im, mism, valid, n_iter,
                                      damping, final_eval, threads, chunk, p,
                                      device, stream);
}

// The bytes of the Newton kernel's tables at `chunk` steps (f64: double,
// else float; twisted: the twisted chain's), for the Python mirror's check
long long eigk_cylinder_newton_smem(int f64, int twisted, int chunk) {
  using namespace eigk::cyl_cx;
  return static_cast<long long>(
      f64 ? (twisted ? tab_smem<double, true>(chunk)
                     : tab_smem<double, false>(chunk))
          : (twisted ? tab_smem<float, true>(chunk)
                     : tab_smem<float, false>(chunk)));
}

// Registers, local (spill) bytes a thread and resident blocks an SM
// (out[0..2]) of the Newton kernel's variant (f64, twisted, numeric) at
// tables of `chunk` steps, and the shape it is built for (out[3] threads a
// block, out[4] __launch_bounds__' min blocks). Returns the cudaError_t.
int eigk_cylinder_newton_attrs(int f64, int twisted, int numeric, int chunk,
                               int* out) {
  using namespace eigk::cyl_cx;
  return f64 ? (twisted ? attrs<double, true>(numeric, chunk, out)
                        : attrs<double, false>(numeric, chunk, out))
             : (twisted ? attrs<float, true>(numeric, chunk, out)
                        : attrs<float, false>(numeric, chunk, out));
}

// The Newton kernel's counts on `device` since the last read
// (g_cx_counts: seeds through a tabled row, seeds whose numeric exterior
// read the tabled exps, the steps of a shoot whose first chain was kept
// and the steps of a shoot, each summed over the launches), to out[4];
// then zeroes them. Waits for the device's work. Returns the cudaError_t.
int eigk_cylinder_newton_counts(int device, unsigned long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(out, eigk::cyl_cx::g_cx_counts,
                               sizeof(eigk::cyl_cx::g_cx_counts));
  }
  if (err == cudaSuccess) {
    const unsigned long long zero[4] = {0, 0, 0, 0};
    err = cudaMemcpyToSymbol(eigk::cyl_cx::g_cx_counts, zero, sizeof(zero));
  }
  return static_cast<int>(err);
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
