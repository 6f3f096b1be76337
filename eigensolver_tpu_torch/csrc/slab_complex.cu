// The slab's dispersion determinant at complex omega (kernel B5-complex)
// and the damped Newton iteration on it (kernel B7): the Kelvin-Helmholtz
// growth-rate path, both on one warp-specialised kernel, newton_kernel.
//
// B5-complex is the port of the XLA-fused `jit(vmap(disp))` of
// `eigensolver_tpu/physics/slab.py::SlabPhysics.make_dispersion` at complex
// omega (slab.py:80-113, :247-281, :309-318, :341-358, :384-400): the shear
// form (flow cases) with the exact exterior, omega complex, k real, the
// state (vx, vx') complex from (par, 1 - par), sqrt(m_e) the principal
// root, the % mismatch with the complex modulus, valid = Re m_e > 0, the
// shear-pressure term as the parameters say. Outputs (det re, det im,
// mismatch, valid). B7 fuses `eigensolver_tpu/search.py::newton_complex`
// (:581-603) over a seed batch: all n_iter damped Newton steps of every
// seed, each one pass of the shoot on dual numbers in omega
// (complex.cuh::CDual; the JAX package's holomorphic jax.jvp), which gives
// D and dD/domega, then step = d/dd (0 where dd == 0), clamped to
// 0.2 (1 + |omega|). The sweep's evaluation of its roots is one more round
// of the same launch (final_eval), and the argument-principle audit
// (search.py:536-578) the kernel's evaluation mode: no Newton round, the
// value round at the candidates.
//
// What bounds them on Hopper: per candidate and RK4 step, 3 evaluations of
// the complex chain (8 real divisions each, 4 divisors; twice the products
// on the dual pass) and the complex update, against 32-48 bytes in and out
// per candidate: float64 operations. The chain's coefficients do not
// depend on the ODE state, only on omega, k and the x-only values (U, U',
// U''); the update (rk4_step: ~280 float64 operations a step on duals) is
// the one serial part. One thread a seed (this port's first design) left
// 7,200 seeds in 225 warps, under 2 an SM, each a serial chain of
// divisions.
//
// The design, spec_kernel's (bisect.cuh) for complex omega: a block serves
// B <= 32 seeds (candidates) with one consumer warp and P producer warps.
//   Consumer (warp 0): lane j carries column j's state in registers (two
//     CDuals on a Newton round, two Cx on the value round) and runs
//     rk4_step in the one-thread order, reading each step's coefficients
//     from the ring; at the end of a round the interface (edge, finish),
//     then the damped Newton update, and publishes the next omega.
//   Producers: per ring stage of C steps, the block's 3 C x-only entries
//     once (a double-buffered table behind the ring), then for each
//     (column, step) of the stage, the chain at the step's 3 abscissae,
//     the 3 chains in flight at once: 24 reals a step and column on a
//     Newton round, 12 on the value round, into a ring of S stages. Item
//     e = column C + step, so that a producer warp holds the steps of a
//     few columns, and a column whose divisions leave CUDA's fast path (a
//     quotient near the bottom of the exponent range: the seeds that
//     converge onto the real axis, whose Im omega reaches 0; PERF.md
//     section 6) slows its own warps, not every warp of the block. Where
//     n_interior is a power of two, a step's first abscissa is the step
//     before's last, bit for bit, and its chain is not computed again
//     (common.cuh::chain_reuse): 2 chains a step, not 3.
//   Hand-off: bisect.cuh's named barriers, its protocol: a full and an
//     empty barrier per stage, an omega barrier per round.
// A launch runs n_iter Newton rounds, then, with final_eval, one value
// round at the final omega. Shared memory holds the omegas and k of the
// columns, the ring (S x C x 24 x B reals) and the table; B, C and S are
// launch arguments (kernels/common.py::complex_spec_shape); P is fixed by
// the type (kCxProducers), one instantiation each at 2 blocks an SM, which
// sets its register budget.
//
// Arithmetic order follows the plain PyTorch version
// (`physics/slab.py::complex_shear_coef`, `complex_edge`, `complex_det`,
// `complex_mismatch`, `search.py::newton_step`) operation for operation;
// with --fmad=false the kernel agrees with it bit for bit on the card.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "bisect.cuh"
#include "common.cuh"
#include "complex.cuh"
#include "slab.cuh"

namespace eigk {
namespace slab_cx {

using slab::ShearPoint;

// A candidate with the products of k that every abscissa repeats
// (physics/slab.py::shear_cand)
template <class T>
struct Cand {
  Cx<T> omega;
  T k, twok, k2c2, k2a2, k2cT2, k4cT2c2, ca;
  __device__ Cand(const SlabDispParams& p, Cx<T> omega_, T k_)
      : omega(omega_), k(k_) {
    const T k2 = k * k;
    twok = T(2) * k;
    k2c2 = k2 * T(p.sc2);
    k2a2 = k2 * T(p.sa2);
    k2cT2 = k2 * T(p.scT2);
    k4cT2c2 = (k2 * k2) * T(p.scT2) * T(p.sc2);
    ca = T(p.sca);
  }
};

// The chain's coefficients at one abscissa: values, or duals in omega
template <class T, bool kDual>
struct Coef;
template <class T>
struct Coef<T, false> {
  Cx<T> D, c;
};
template <class T>
struct Coef<T, true> {
  CDual<T> D, c;
};

// make_shear_coef (slab.py:247-281) at complex omega
// (physics/slab.py::complex_shear_coef): Omega' = 1, (Omega^2)' =
// Omega + Omega, a quotient's derivative (a' - q b') / b by its value's
// divisor
template <class T, bool kDual>
__device__ __forceinline__ Coef<T, kDual> shear_coef(const SlabDispParams& p,
                                                     const ShearPoint<T>& q,
                                                     const Cand<T>& c) {
  const Cx<T> Om = c.omega - c.k * q.U;
  const Cx<T> Om2 = Om * Om;
  const Cx<T> A = c.k2c2 - Om2;
  const Cx<T> B = c.k2a2 - Om2;
  const Cx<T> G0 = c.k2cT2 - Om2;
  const CDiv<T> iden = cdivisor(c.ca * G0);
  const Cx<T> m0 = (A * B) / iden;
  const T kdU = c.twok * q.dU;
  const CDiv<T> iOm = cdivisor(Om);
  const Cx<T> E = Om2 - c.k2c2;
  const Cx<T> G = Om2 - c.k2cT2;
  Cx<T> Dx, t1, t2, t3;
  CDiv<T> iE, iG, iH, iQ;
  if (p.legacy_D) {
    iH = cdivisor(c.ca * G);
    t3 = c.k4cT2c2 / iH;
    iQ = cdivisor(Om * E);
    Dx = (kdU * (G + t3)) / iQ;
  } else {
    iE = cdivisor(E);
    iG = cdivisor(G);
    t1 = Om2 / iE;
    t2 = c.k2cT2 / iG;
    Dx = (kdU * (t1 - t2)) / iOm;
  }
  const Cx<T> s1 = (c.k * q.ddU) / iOm;
  const Cx<T> s2 = ((c.k * q.dU) * Dx) / iOm;
  const Cx<T> coeff = (s1 + s2) - m0;
  if constexpr (!kDual) {
    return {Dx, coeff};
  } else {
    const Cx<T> dOm2 = Om + Om;
    const Cx<T> dG0 = -dOm2;
    const Cx<T> dm0 =
        ((-dOm2) * B + A * (-dOm2) - m0 * (c.ca * dG0)) / iden;
    Cx<T> dDx;
    if (p.legacy_D) {
      const Cx<T> dt3 = (-(t3 * (c.ca * dOm2))) / iH;
      const Cx<T> dQ = E + Om * dOm2;
      dDx = (kdU * (dOm2 + dt3) - Dx * dQ) / iQ;
    } else {
      const Cx<T> dt1 = (dOm2 - t1 * dOm2) / iE;
      const Cx<T> dt2 = (-(t2 * dOm2)) / iG;
      dDx = (kdU * (dt1 - dt2) - Dx) / iOm;
    }
    const Cx<T> ds1 = (-s1) / iOm;
    const Cx<T> ds2 = ((c.k * q.dU) * dDx - s2) / iOm;
    const Cx<T> dcoeff = (ds1 + ds2) - dm0;
    return {{Dx, dDx}, {coeff, dcoeff}};
  }
}

// d(vx, vx')/dx = (vx', -D vx' - coeff vx) (_apply_shear)
template <class S>
__device__ __forceinline__ void apply(const S& D, const S& co, const S& y0,
                                      const S& y1, S& f0, S& f1) {
  f0 = y1;
  f1 = (-D) * y1 - co * y0;
}

// One RK4 step (slab.py:98-110), the chain at the step's 3 abscissae
template <class T, class S>
__device__ __forceinline__ void rk4_step(T h, T hh, T h6, const S& aA,
                                         const S& bA, const S& aM,
                                         const S& bM, const S& aB,
                                         const S& bB, S& y0, S& y1) {
  S k10, k11, k20, k21, k30, k31, k40, k41;
  apply(aA, bA, y0, y1, k10, k11);
  apply(aM, bM, y0 + hh * k10, y1 + hh * k11, k20, k21);
  apply(aM, bM, y0 + hh * k20, y1 + hh * k21, k30, k31);
  apply(aB, bB, y0 + h * k30, y1 + h * k31, k40, k41);
  y0 = y0 + h6 * (k10 + T(2) * k20 + T(2) * k30 + k40);
  y1 = y1 + h6 * (k11 + T(2) * k21 + T(2) * k31 + k41);
}

template <class T>
__device__ __forceinline__ ShearPoint<T> shear_point(const SlabDispParams& p,
                                                     T x) {
  return {profile(p.flow, x), profile_d1(p.flow, x), profile_d2(p.flow, x)};
}

template <class T, bool kDual>
using State = typename std::conditional<kDual, CDual<T>, Cx<T>>::type;

// The interface's state-free values (physics/slab.py::complex_edge)
template <class T, bool kDual>
struct Edge {
  State<T, kDual> m_e, sqm, p_e, xi_e, W, add;
  CDiv<T> iOm_i;
};

template <class T, bool kDual>
__device__ __forceinline__ Edge<T, kDual> edge(const SlabDispParams& p,
                                               Cx<T> omega, T k) {
  const T one = T(1);
  const T k2 = k * k;
  const Cx<T> Om_e = omega - k * T(p.U_e);
  const Cx<T> Om_e2 = Om_e * Om_e;
  const Cx<T> X1 = k2 * T(p.vA_e2) - Om_e2;
  const Cx<T> X2 = k2 * T(p.c_e2) - Om_e2;
  const Cx<T> X3 = k2 * T(p.cT_e2) - Om_e2;
  const CDiv<T> iDm = cdivisor(T(p.vAc_e2) * X3);
  const Cx<T> m_e = (X1 * X2) / iDm;
  const CDiv<T> iD2 = cdivisor(Om_e * X2);
  const Cx<T> p_e = (T(p.pe_coef) * X3) / iD2;
  const CDiv<T> iOm_e = cdivisor(Om_e);
  const Cx<T> xi_e = one / iOm_e;
  // the interior at x = 1 (interior_F, slab.py:167-175)
  const T U1 = p.zero_flow ? T(0) : profile(p.flow, one);
  const Cx<T> Om_i = omega - k * U1;
  const Cx<T> Om_i2 = Om_i * Om_i;
  T rho1, vA, ci;
  density_speeds(p.rho, p.uniform_density, p.vA_i0, p.c_i0, p.rho_i0,
                 p.c2_num, p.half_g, one, rho1, vA, ci);
  const T c2 = ci * ci;
  const T a2 = vA * vA;
  const T cT2 = c2 * a2 / (c2 + a2);
  const CDiv<T> iY2 = cdivisor(k2 * c2 - Om_i2);
  const Cx<T> F1 = ((rho1 * (c2 + a2)) * (k2 * cT2 - Om_i2)) / iY2;
  const CDiv<T> iOm_i = cdivisor(Om_i);
  const Cx<T> W = F1 / iOm_i;
  const T kdU1 = -(k * profile_d1(p.flow, one));
  const Cx<T> add = kdU1 / iOm_i;
  Edge<T, kDual> e;
  e.iOm_i = iOm_i;
  if constexpr (!kDual) {
    e.m_e = m_e;
    e.sqm = csqrt(m_e);
    e.p_e = p_e;
    e.xi_e = xi_e;
    e.W = W;
    e.add = add;
  } else {
    const Cx<T> dOm_e2 = Om_e + Om_e;
    const Cx<T> dX = -dOm_e2;
    const Cx<T> dm_e =
        (dX * X2 + X1 * dX - m_e * (T(p.vAc_e2) * dX)) / iDm;
    const Cx<T> dp_e = ((T(p.pe_coef) * dX) - p_e * (X2 + Om_e * dX)) / iD2;
    const Cx<T> dxi_e = (-xi_e) / iOm_e;
    const Cx<T> dOm_i2 = Om_i + Om_i;
    const Cx<T> dF1 =
        ((rho1 * (c2 + a2)) * (-dOm_i2) - F1 * (-dOm_i2)) / iY2;
    const Cx<T> dW = (dF1 - W) / iOm_i;
    const Cx<T> dadd = (-add) / iOm_i;
    e.m_e = {m_e, dm_e};
    e.sqm = dcsqrt(e.m_e);
    e.p_e = {p_e, dp_e};
    e.xi_e = {xi_e, dxi_e};
    e.W = {W, dW};
    e.add = {add, dadd};
  }
  return e;
}

// xi_i = vx / Omega_i (and its derivative (vx' - xi_i) / Omega_i)
template <class T>
__device__ __forceinline__ Cx<T> xi_of(const Cx<T>& vx, CDiv<T> iOm_i) {
  return vx / iOm_i;
}
template <class T>
__device__ __forceinline__ CDual<T> xi_of(const CDual<T>& vx,
                                          CDiv<T> iOm_i) {
  const Cx<T> xi = vx.v / iOm_i;
  return {xi, (vx.d - xi) / iOm_i};
}

// det = xi_i PT_e - xi_e PT_i (physics/slab.py::complex_det); with the
// value pass, the % mismatch and valid (complex_mismatch)
template <class T, bool kDual>
__device__ __forceinline__ State<T, kDual> finish(const SlabDispParams& p,
                                                  const Edge<T, kDual>& e,
                                                  const State<T, kDual>& vx,
                                                  const State<T, kDual>& dvx,
                                                  T* mism, bool* valid) {
  const State<T, kDual> PT_i =
      p.shear_pressure ? e.W * (dvx - e.add * vx) : e.W * dvx;
  const State<T, kDual> PT_e = e.p_e * (-e.sqm);
  const State<T, kDual> xi_i = xi_of(vx, e.iOm_i);
  const State<T, kDual> det = xi_i * PT_e - e.xi_e * PT_i;
  if constexpr (!kDual) {
    const Cx<T> s = e.xi_e / cdivisor(xi_i);
    const Cx<T> sPT = s * PT_i;
    const T num = cabs(PT_e - sPT);
    const T den = nan_max(cabs(PT_e), cabs(sPT));
    *mism = T(100) * num / den;
    *valid = e.m_e.re > T(0);
  }
  return det;
}

// The start state (par, 1 - par), the derivative 0
template <class T>
__device__ __forceinline__ void start(T par, Cx<T>& y0, Cx<T>& y1) {
  y0 = {par, T(0)};
  y1 = {T(1) - par, T(0)};
}
template <class T>
__device__ __forceinline__ void start(T par, CDual<T>& y0, CDual<T>& y1) {
  const Cx<T> z{T(0), T(0)};
  y0 = {{par, T(0)}, z};
  y1 = {{T(1) - par, T(0)}, z};
}

// Producer warps by type, at 2 blocks an SM (__launch_bounds__): up to 128
// registers a thread at float64 (P = 7), 112 at float32 (P = 8);
// kernels/common.py::COMPLEX_PRODUCERS mirrors them
template <class T>
constexpr int kCxProducers = std::is_same<T, double>::value ? 7 : 8;

// Reals a column and step in the ring: 3 abscissae x (D, coeff) x (value,
// d/d omega) x (re, im); the value round uses the first 12
constexpr int kCxValues = 24;
// Reals ahead of the ring: the omegas (re, im) and k of 32 columns
constexpr int kCxHead = 3 * 32;

// Byte offset of the x-only table in a block's shared memory (after the
// head and the ring), 16-byte aligned; kernels/common.py::complex_smem
// mirrors it
template <class T>
__host__ __device__ __forceinline__ size_t cx_table_offset(int B, int C,
                                                          int S) {
  const size_t ring =
      (kCxHead + static_cast<size_t>(S) * C * kCxValues * B) * sizeof(T);
  return (ring + 15) / 16 * 16;
}

// Position of column col at step c of a stage: the columns of a step in a
// row of B, XOR-swizzled by the step so that a producer warp's stores (a
// few columns at up to 8 steps) fall in distinct banks; the consumer's
// loads (every column at one step) stay a permutation of one row. B is a
// power of two.
__device__ __forceinline__ int cx_pos(int c, int col, int B) {
  return col ^ ((c << 2) & (B - 1));
}

// A chain's (D, coeff) at one abscissa to the ring and back: value v of
// the abscissa's block at src[v B]
template <class T>
__device__ __forceinline__ void put(T* dst, int B, const Coef<T, true>& a) {
  const T v[8] = {a.D.v.re, a.D.v.im, a.D.d.re, a.D.d.im,
                  a.c.v.re, a.c.v.im, a.c.d.re, a.c.d.im};
#pragma unroll
  for (int q = 0; q < 8; ++q) dst[q * B] = v[q];
}
template <class T>
__device__ __forceinline__ void put(T* dst, int B, const Coef<T, false>& a) {
  const T v[4] = {a.D.re, a.D.im, a.c.re, a.c.im};
#pragma unroll
  for (int q = 0; q < 4; ++q) dst[q * B] = v[q];
}
template <class T>
__device__ __forceinline__ void get(const T* src, int B, CDual<T>& D,
                                    CDual<T>& c) {
  D = {{src[0], src[B]}, {src[2 * B], src[3 * B]}};
  c = {{src[4 * B], src[5 * B]}, {src[6 * B], src[7 * B]}};
}
template <class T>
__device__ __forceinline__ void get(const T* src, int B, Cx<T>& D, Cx<T>& c) {
  D = {src[0], src[B]};
  c = {src[2 * B], src[3 * B]};
}

// The consumer's shoot over one round's stages of the ring, from (y0, y1);
// g counts the launch's stages
template <class T, bool kDual>
__device__ __forceinline__ void consume(const T* ring, int B, int C, int S,
                                        int n_steps, int total, int nthr,
                                        int col, int& g, State<T, kDual>& y0,
                                        State<T, kDual>& y1) {
  constexpr int V = kDual ? 8 : 4;  // reals an abscissa
  T h, hh, h6;
  rk4_spacing(T(0), T(1), n_steps, h, hh, h6);
  const bool reuse = chain_reuse(n_steps);
  const int stage_len = C * kCxValues * B;
  State<T, kDual> aB, bB;           // the last step's last abscissa
  for (int i0 = 0; i0 < n_steps; i0 += C, ++g) {
    const int slot = g % S;
    bar::sync(bar::kFull + slot, nthr);
    const T* st = ring + slot * stage_len;
    const int c_end = min(C, n_steps - i0);
#pragma unroll 1
    for (int c = 0; c < c_end; ++c) {
      const T* src = st + c * kCxValues * B + cx_pos(c, col, B);
      State<T, kDual> aA, bA, aM, bM;
      if (reuse && i0 + c > 0) {
        aA = aB;
        bA = bB;
      } else {
        get(src, B, aA, bA);
      }
      get(src + V * B, B, aM, bM);
      get(src + 2 * V * B, B, aB, bB);
      rk4_step(h, hh, h6, aA, bA, aM, bM, aB, bB, y0, y1);
    }
    if (g < total - S) bar::arrive(bar::kFull + S + slot, nthr);
  }
}

// The producers' work of one round: per stage the table, then the chain at
// each (column, step) pair of the stage, item e = column C + step, thread
// t taking e = t, t + 32 P, ...
template <class T, bool kDual>
__device__ __forceinline__ void produce(const SlabDispParams& p,
                                        const T* head, T* ring,
                                        ShearPoint<T>* table, int B, int C,
                                        int S, int n_steps, int nthr, int& g) {
  constexpr int V = kDual ? 8 : 4;
  const int t = threadIdx.x - 32;
  const int np = nthr - 32;
  T h, hh, h6;
  rk4_spacing(T(0), T(1), n_steps, h, hh, h6);
  const bool reuse = chain_reuse(n_steps);
  const int stage_len = C * kCxValues * B;
  for (int i0 = 0; i0 < n_steps; i0 += C, ++g) {
    const int slot = g % S;
    const int c_end = min(C, n_steps - i0);
    ShearPoint<T>* tb = table + (g & 1) * 3 * C;
    // written while the consumer reads earlier stages; the buffer's
    // readers of stage g - 2 passed stage g - 1's table barrier
    for (int e = t; e < 3 * c_end; e += np) {
      tb[e] = shear_point<T>(p, rk4_abscissa(T(0), h, hh, i0 + e / 3, e % 3));
    }
    bar::sync(bar::kTable, np);
    if (g >= S) bar::sync(bar::kFull + S + slot, nthr);
    T* st = ring + slot * stage_len;
    for (int e = t; e < B * C; e += np) {
      const int col = e / C, c = e % C;
      if (c >= c_end) continue;
      const Cand<T> cd(p, Cx<T>{head[col], head[32 + col]}, head[64 + col]);
      T* dst = st + c * kCxValues * B + cx_pos(c, col, B);
      if (reuse && i0 + c > 0) {
        // the first abscissa's chain is the consumer's from the step before
        Coef<T, kDual> v[2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          v[a] = shear_coef<T, kDual>(p, tb[3 * c + 1 + a], cd);
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) put(dst + (1 + a) * V * B, B, v[a]);
      } else {
        Coef<T, kDual> v[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          v[a] = shear_coef<T, kDual>(p, tb[3 * c + a], cd);
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) put(dst + a * V * B, B, v[a]);
      }
    }
    bar::arrive(bar::kFull + slot, nthr);
  }
}

// B7 and B5-complex: n_iter damped Newton rounds of every seed, then with
// final_eval the value round at the final omega (n_iter = 0: the
// evaluation of the candidates). Columns past n take a copy of the last
// candidate and store nothing; lanes j >= B of the consumer shadow column
// j % B. out (omega) is written if out_re is given, det / mism / valid
// after the value round.
template <class T>
__global__ void __launch_bounds__(32 * (kCxProducers<T> + 1), 2)
newton_kernel(const T* __restrict__ om_re, const T* __restrict__ om_im,
              const T* __restrict__ k_, const T* __restrict__ par_,
              T* __restrict__ out_re, T* __restrict__ out_im, int64_t n,
              T* __restrict__ det_re, T* __restrict__ det_im,
              T* __restrict__ mism_, bool* __restrict__ valid_, int n_iter,
              double damping, int final_eval, int B, int C, int S,
              const __grid_constant__ SlabDispParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* head = reinterpret_cast<T*>(smem_raw);  // [3][32] omega re, im; k
  T* ring = head + kCxHead;                  // [S][C][24][B]
  auto* table = reinterpret_cast<ShearPoint<T>*>(
      smem_raw + cx_table_offset<T>(B, C, S));  // [2][3 C]
  constexpr int nthr = 32 * (kCxProducers<T> + 1);
  const int n_steps = p.n_interior;
  const int n_stages = (n_steps + C - 1) / C;
  const int n_rounds = n_iter + (final_eval ? 1 : 0);
  const int total = n_rounds * n_stages;     // ring stages in the launch
  int g = 0;
  if (threadIdx.x < 32) {
    const int col = threadIdx.x % B;
    const bool own = threadIdx.x < B;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * B + col;
    const int64_t idx = i < n ? i : n - 1;
    Cx<T> om{om_re[idx], om_im[idx]};
    const T k = k_[idx], par = par_[idx];
    if (own) head[64 + col] = k;
    for (int round = 0; round < n_iter; ++round) {
      if (own) {
        head[col] = om.re;
        head[32 + col] = om.im;
      }
      bar::arrive(bar::kOmega, nthr);
      CDual<T> y0, y1;
      start(par, y0, y1);
      consume<T, true>(ring, B, C, S, n_steps, total, nthr, col, g, y0, y1);
      const CDual<T> det =
          finish<T, true>(p, edge<T, true>(p, om, k), y0, y1, nullptr,
                          nullptr);
      const Cx<T> d = det.v, dd = det.d;
      const Cx<T> q = d / dd;
      Cx<T> step = (dd.re == T(0) && dd.im == T(0)) ? Cx<T>{T(0), T(0)} : q;
      const T max_step = T(0.2) * (T(1) + cabs(om));
      const T mag = cabs(step);
      if (mag > max_step) step = step * (max_step / mag);
      om = om - T(damping) * step;
    }
    if (final_eval) {
      if (own) {
        head[col] = om.re;
        head[32 + col] = om.im;
      }
      bar::arrive(bar::kOmega, nthr);
      Cx<T> y0, y1;
      start(par, y0, y1);
      consume<T, false>(ring, B, C, S, n_steps, total, nthr, col, g, y0, y1);
      T mism;
      bool valid;
      const Cx<T> d = finish<T, false>(p, edge<T, false>(p, om, k), y0, y1,
                                       &mism, &valid);
      if (own && i < n) {
        det_re[i] = d.re;
        det_im[i] = d.im;
        mism_[i] = mism;
        valid_[i] = valid;
      }
    }
    if (own && i < n && out_re != nullptr) {
      out_re[i] = om.re;
      out_im[i] = om.im;
    }
  } else {
    for (int round = 0; round < n_rounds; ++round) {
      bar::sync(bar::kOmega, nthr);
      if (round < n_iter) {
        produce<T, true>(p, head, ring, table, B, C, S, n_steps, nthr, g);
      } else {
        produce<T, false>(p, head, ring, table, B, C, S, n_steps, nthr, g);
      }
    }
  }
}

// Launch newton_kernel over n seeds (candidates) with B a block, C steps
// a stage and S stages. Only the shear form with the exact exterior.
// Returns the cudaError_t.
template <class T>
int launch(const void* om_re, const void* om_im, const void* k,
           const void* par, void* out_re, void* out_im, long long n,
           void* det_re, void* det_im, void* mism, void* valid, int n_iter,
           double damping, int final_eval, int B, int C, int S,
           const SlabDispParams* p, int device, void* stream) {
  const size_t smem = cx_table_offset<T>(B, C, S)
                      + 2 * 3 * static_cast<size_t>(C) * sizeof(ShearPoint<T>);
  if (n <= 0 || n_iter < 0 || final_eval < 0 || final_eval > 1 || B < 1
      || B > 32 || (B & (B - 1)) != 0 || C < 1 || S < 1
      || S > kBisectMaxStages || smem > 227 * 1024 || !p->shear
      || p->exterior_numeric || (n_iter > 0 && out_re == nullptr)
      || (final_eval && det_re == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kern = newton_kernel<T>;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n + B - 1) / B;
  kern<<<static_cast<unsigned>(blocks), 32 * (kCxProducers<T> + 1), smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(om_re), static_cast<const T*>(om_im),
      static_cast<const T*>(k), static_cast<const T*>(par),
      static_cast<T*>(out_re), static_cast<T*>(out_im), n,
      static_cast<T*>(det_re), static_cast<T*>(det_im),
      static_cast<T*>(mism), static_cast<bool*>(valid), n_iter, damping,
      final_eval, B, C, S, *p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slab_cx
}  // namespace eigk

extern "C" {

// B7 and B5-complex over n seeds or candidates (omega re, omega im, k,
// parity): n_iter damped Newton steps, the final omega (re, im) to out
// (null with n_iter = 0), then with final_eval the value round there: det
// (re, im), the % mismatch and valid (null without final_eval). B seeds a
// block, C steps a ring stage, S stages (P producer warps by type). The
// count comes 7th, as in every entry. Returns the cudaError_t of the launch.
int eigk_slab_newton_f32(const void* om_re, const void* om_im, const void* k,
                         const void* par, void* out_re, void* out_im,
                         long long n, void* det_re, void* det_im, void* mism,
                         void* valid, int n_iter, double damping,
                         int final_eval, int B, int C, int S,
                         const eigk::SlabDispParams* p, int device,
                         void* stream) {
  return eigk::slab_cx::launch<float>(
      om_re, om_im, k, par, out_re, out_im, n, det_re, det_im, mism, valid,
      n_iter, damping, final_eval, B, C, S, p, device, stream);
}

int eigk_slab_newton_f64(const void* om_re, const void* om_im, const void* k,
                         const void* par, void* out_re, void* out_im,
                         long long n, void* det_re, void* det_im, void* mism,
                         void* valid, int n_iter, double damping,
                         int final_eval, int B, int C, int S,
                         const eigk::SlabDispParams* p, int device,
                         void* stream) {
  return eigk::slab_cx::launch<double>(
      om_re, om_im, k, par, out_re, out_im, n, det_re, det_im, mism, valid,
      n_iter, damping, final_eval, B, C, S, p, device, stream);
}

}  // extern "C"
