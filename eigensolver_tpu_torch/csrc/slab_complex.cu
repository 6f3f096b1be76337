// The slab's dispersion determinant at complex omega (kernels B5-complex,
// B2-complex, B6-complex) and the damped Newton iteration on it (kernel
// B7): the Kelvin-Helmholtz growth-rate path and every other complex-omega
// slab sweep, on two kernels by form: the shear form on the
// warp-specialised newton_kernel, the flux form on flux_kernel, one thread
// a seed.
//
// B5-complex is the port of the XLA-fused `jit(vmap(disp))` of
// `eigensolver_tpu/physics/slab.py::SlabPhysics.make_dispersion` at complex
// omega (slab.py:80-113, :247-281, :309-318, :341-358, :384-400): the shear
// form (flow cases), omega complex, k real, the state (vx, vx') complex
// from (par, 1 - par), sqrt(m_e) the principal root, the % mismatch with
// the complex modulus, valid = Re m_e > 0, the shear-pressure term as the
// parameters say. B2-complex is its flux form (density cases; slab.py:
// 41-78, :215-230, :321-339): the state (vx, w) complex from (par, (1 -
// par) F(0)), the chain (1/F, F m0) with one complex division an abscissa,
// PT_i = w / Omega_i. B6-complex is the numeric exterior (kNum;
// `ode.py::rk4_final_renorm`, :75-110, as slab.py:360-381 calls it) on a
// complex state: n_exterior RK4 steps from 1 + W 2 pi / k down to 1,
// renormalised every 64, its vx'/vx in place of -sqrt(m_e); either form.
// Outputs (det re, det im, mismatch, valid). B7 fuses
// `eigensolver_tpu/search.py::newton_complex` (:581-603) over a seed
// batch: all n_iter damped Newton steps of every seed, each one pass of
// the shoot on dual numbers in omega (complex.cuh::CDual; the JAX package's
// holomorphic jax.jvp), which gives D and dD/domega, then step = d/dd (0
// where dd == 0), clamped to 0.2 (1 + |omega|). The sweep's evaluation of
// its roots is one more round of the same launch (final_eval), and the
// argument-principle audit (search.py:536-578) the kernel's evaluation
// mode: no Newton round, the value round at the candidates.
//
// What bounds them on Hopper: float64 operations. Per candidate and RK4
// step, 3 evaluations of the complex chain (2 where a step's first
// abscissa is the step before's last, bit for bit: common.cuh::
// chain_reuse, n_interior a power of two) and the complex update (~264
// float64 operations a step on duals), against 32-48 bytes in and out per
// candidate. The chain's coefficients depend on omega, k and the x-only
// values alone, not on the state; the update is the one serial part.
//
// The shear form (newton_kernel, producer/consumer): its chain is heavy (8
// real divisions an abscissa, 4 divisors; twice the products on the dual
// pass) and its sweep small (KH: 7,200 seeds), so a block serves B <= 32
// seeds with one consumer warp and P producer warps.
//   Consumer (warp 0): lane j carries column j's state in registers (two
//     CDuals on a Newton round, two Cx on the value round) and runs
//     rk4_step in the one-thread order, reading each step's coefficients
//     from the ring; at the end of a round the interface (edge, finish),
//     then the damped Newton update, and publishes the next omega.
//   Producers: per ring stage of C steps, the block's 3 C x-only entries
//     once (a double-buffered table behind the ring), then for each
//     (column, step) of the stage, the chain at the step's abscissae, the
//     chains in flight at once: 24 reals a step and column on a Newton
//     round, 12 on the value round, into a ring of S stages. Item e =
//     column C + step, so that a producer warp holds the steps of a few
//     columns.
//   The numeric exterior (kNum): the consumer lane integrates it after its
//     interior shoot (exterior_ratio, on duals on a Newton round). Handing
//     it to a producer warp of its own, which integrates every column's
//     during the round, was tried on an H100 and did not pay (PERF.md
//     section 6): the shear form's numeric exterior costs ~7% over its
//     exact one either way.
//   Hand-off: bisect.cuh's named barriers, its protocol: a full and an
//     empty barrier per stage, an omega barrier per round.
// Shared memory holds the omegas and k of the columns, the ring (S x C x
// 24 x B reals) and the table (slab.cuh::x_point); B, C and S are launch
// arguments (kernels/common.py::complex_spec_shape); P is fixed by the type
// (kCxProducers), one instantiation per type and exterior at 2 blocks an
// SM, which sets its register budget.
//
// The flux form (flux_kernel): its chain is light (one complex divisor an
// abscissa) and a density sweep's seeds many (cx_ph_09: 37,800 a mode), so
// the update, not the chain, sets the pace, and one thread a seed carries
// its whole round in registers: the shoot, the interface, the numeric
// exterior (kNum), the determinant and the Newton update. Each shoot the
// block fills the x-only entries (FluxPoint) of a chunk of steps into a
// double-buffered table in shared memory, one barrier a chunk (as
// cylinder.cuh::fill_chunk); every lane of a warp reads the same entry, a
// broadcast. Where chain_reuse holds, a step's last chain stays in
// registers as the next step's first. Threads past n follow a copy of the
// last seed, so that they reach the barriers, and store nothing. Built at
// one launch shape a type (FluxShape: threads a block, the register
// budget of min_blocks blocks an SM, the table's chunk;
// kernels/common.py::FLUX_NEWTON_SHAPE mirrors it).
//
// Every complex divisor's ratio goes through complex.cuh::fast_div, the
// division's bits off CUDA's slow path, which a quotient near the bottom
// of the exponent range takes: the seeds whose Im omega converges onto the
// real axis reach it in every chain.
//
// Arithmetic order follows the plain PyTorch version
// (`physics/slab.py::complex_shear_coef`, `complex_flux_coef`,
// `complex_flux_F`, `complex_edge`, `complex_exterior` over
// `ode.rk4_final_renorm`, `complex_det`, `complex_mismatch`,
// `search.py::newton_step`) operation for operation;
// with --fmad=false the kernels agree with it bit for bit on the card.
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

using slab::FluxPoint;
using slab::ShearPoint;
using slab::x_point;

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

// A candidate of the flux chain (physics/slab.py::flux_cand): k k and
// Omega^2 (no flow: Omega = omega - k 0 at every x), and nd = -(Omega +
// Omega), the derivative of k^2 c^2 - Omega^2
template <class T>
struct FluxCand {
  T k2;
  Cx<T> Om2, nd;
  __device__ FluxCand(Cx<T> omega, T k) : k2(k * k) {
    const Cx<T> Om = omega - k * T(0);
    Om2 = Om * Om;
    nd = -(Om + Om);
  }
};

// make_flux_coef (slab.py:215-230) at complex omega
// (physics/slab.py::complex_flux_coef): (1/F, F m0) as (D, c)
template <class T, bool kDual>
__device__ __forceinline__ Coef<T, kDual> flux_coef(const FluxPoint<T>& q,
                                                    const FluxCand<T>& c) {
  const Cx<T> A = c.k2 * q.c2 - c.Om2;
  const CDiv<T> iden = cdivisor(q.rho_csum * (c.k2 * q.cT2 - c.Om2));
  const Cx<T> inv_F = A / iden;
  const Cx<T> w_rate = q.rho * (c.k2 * q.a2 - c.Om2);
  if constexpr (!kDual) {
    return {inv_F, w_rate};
  } else {
    const Cx<T> dinv_F = (c.nd - inv_F * (q.rho_csum * c.nd)) / iden;
    return {{inv_F, dinv_F}, {w_rate, q.rho * c.nd}};
  }
}

// The right-hand side with the chain (a, b) at the state (y0, y1): shear
// d(vx, vx')/dx = (vx', -D vx' - coeff vx) (_apply_shear), flux
// d(vx, w)/dx = (w / F, F m0 vx) (_apply_flux)
template <bool kShear, class S>
__device__ __forceinline__ void apply(const S& a, const S& b, const S& y0,
                                      const S& y1, S& f0, S& f1) {
  if constexpr (kShear) {
    f0 = y1;
    f1 = (-a) * y1 - b * y0;
  } else {
    f0 = y1 * a;
    f1 = b * y0;
  }
}

// One RK4 step (slab.py:41-113), the chain at the step's 3 abscissae
template <bool kShear, class T, class S>
__device__ __forceinline__ void rk4_step(T h, T hh, T h6, const S& aA,
                                         const S& bA, const S& aM,
                                         const S& bM, const S& aB,
                                         const S& bB, S& y0, S& y1) {
  S k10, k11, k20, k21, k30, k31, k40, k41;
  apply<kShear>(aA, bA, y0, y1, k10, k11);
  apply<kShear>(aM, bM, y0 + hh * k10, y1 + hh * k11, k20, k21);
  apply<kShear>(aM, bM, y0 + hh * k20, y1 + hh * k21, k30, k31);
  apply<kShear>(aB, bB, y0 + h * k30, y1 + h * k31, k40, k41);
  y0 = y0 + h6 * (k10 + T(2) * k20 + T(2) * k30 + k40);
  y1 = y1 + h6 * (k11 + T(2) * k21 + T(2) * k31 + k41);
}

template <class T, bool kDual>
using State = typename std::conditional<kDual, CDual<T>, Cx<T>>::type;

// A real constant r as a state value (derivative 0)
template <class T>
__device__ __forceinline__ void constant(T r, Cx<T>& z) {
  z = {r, T(0)};
}
template <class T>
__device__ __forceinline__ void constant(T r, CDual<T>& z) {
  z = {{r, T(0)}, {T(0), T(0)}};
}

// interior_F (slab.py:167-175) at the abscissa of q
// (physics/slab.py::complex_flux_F), a value or a dual
template <class T>
__device__ __forceinline__ void flux_F(const FluxPoint<T>& q,
                                       const FluxCand<T>& c, Cx<T>& F) {
  F = (q.rho_csum * (c.k2 * q.cT2 - c.Om2)) / cdivisor(c.k2 * q.c2 - c.Om2);
}
template <class T>
__device__ __forceinline__ void flux_F(const FluxPoint<T>& q,
                                       const FluxCand<T>& c, CDual<T>& F) {
  const CDiv<T> iY = cdivisor(c.k2 * q.c2 - c.Om2);
  const Cx<T> v = (q.rho_csum * (c.k2 * q.cT2 - c.Om2)) / iY;
  F = {v, (q.rho_csum * c.nd - v * c.nd) / iY};
}

// The start state: shear (vx, vx') = (par, 1 - par); flux (vx, w) =
// (par, (1 - par) F(0)): sausage (0, F(0)), kink (1, 0 F(0)); the
// derivative of the constants 0
template <class T, bool kShear, class S>
__device__ __forceinline__ void start(const SlabDispParams& p, Cx<T> omega,
                                      T k, T par, S& y0, S& y1) {
  constant(par, y0);
  if constexpr (kShear) {
    constant(T(1) - par, y1);
  } else {
    S F0;
    flux_F(x_point<T, false, kInlineGaussian>(p, T(0)),
           FluxCand<T>(omega, k), F0);
    y1 = (T(1) - par) * F0;
  }
}

// The interface's state-free values (physics/slab.py::complex_edge); W
// and add in the shear form only
template <class T, bool kDual>
struct Edge {
  State<T, kDual> m_e, sqm, p_e, xi_e, W, add;
  CDiv<T> iOm_i;
};

// m_e = (k^2 vA_e^2 - Om_e^2)(k^2 c_e^2 - Om_e^2) / ((vA_e^2 + c_e^2)(k^2
// cT_e^2 - Om_e^2)), Om_e = omega - k U_e (complex_edge's), a value or its
// dual: the interface's and the numeric exterior's
template <class T>
__device__ __forceinline__ void exterior_m(const SlabDispParams& p,
                                           Cx<T> omega, T k, Cx<T>& m_e) {
  const T k2 = k * k;
  const Cx<T> Om_e = omega - k * T(p.U_e);
  const Cx<T> Om_e2 = Om_e * Om_e;
  const Cx<T> X1 = k2 * T(p.vA_e2) - Om_e2;
  const Cx<T> X2 = k2 * T(p.c_e2) - Om_e2;
  const Cx<T> X3 = k2 * T(p.cT_e2) - Om_e2;
  m_e = (X1 * X2) / cdivisor(T(p.vAc_e2) * X3);
}
template <class T>
__device__ __forceinline__ void exterior_m(const SlabDispParams& p,
                                           Cx<T> omega, T k, CDual<T>& m_e) {
  const T k2 = k * k;
  const Cx<T> Om_e = omega - k * T(p.U_e);
  const Cx<T> Om_e2 = Om_e * Om_e;
  const Cx<T> X1 = k2 * T(p.vA_e2) - Om_e2;
  const Cx<T> X2 = k2 * T(p.c_e2) - Om_e2;
  const Cx<T> X3 = k2 * T(p.cT_e2) - Om_e2;
  const CDiv<T> iDm = cdivisor(T(p.vAc_e2) * X3);
  const Cx<T> v = (X1 * X2) / iDm;
  const Cx<T> dX = -(Om_e + Om_e);
  m_e = {v, (dX * X2 + X1 * dX - v * (T(p.vAc_e2) * dX)) / iDm};
}

template <class T, bool kDual, bool kShear>
__device__ __forceinline__ Edge<T, kDual> edge(const SlabDispParams& p,
                                               Cx<T> omega, T k) {
  const T one = T(1);
  const T k2 = k * k;
  const Cx<T> Om_e = omega - k * T(p.U_e);
  const Cx<T> Om_e2 = Om_e * Om_e;
  const Cx<T> X2 = k2 * T(p.c_e2) - Om_e2;
  const Cx<T> X3 = k2 * T(p.cT_e2) - Om_e2;
  const CDiv<T> iD2 = cdivisor(Om_e * X2);
  const Cx<T> p_e = (T(p.pe_coef) * X3) / iD2;
  const CDiv<T> iOm_e = cdivisor(Om_e);
  const Cx<T> xi_e = one / iOm_e;
  // the flux form has no flow (U == 0): its kernels inline no profile here
  const T U1 = p.zero_flow ? T(0)
                           : profile<(kShear ? kInlineAll : 0u)>(p.flow, one);
  const Cx<T> Om_i = omega - k * U1;
  const CDiv<T> iOm_i = cdivisor(Om_i);
  Cx<T> W, add, F1;
  T rho1 = T(0), c2 = T(0), a2 = T(0);
  CDiv<T> iY2;
  if constexpr (kShear) {
    // the interior at x = 1 (interior_F, slab.py:167-175)
    const Cx<T> Om_i2 = Om_i * Om_i;
    T vA, ci;
    density_speeds(p.rho, p.uniform_density, p.vA_i0, p.c_i0, p.rho_i0,
                   p.c2_num, p.half_g, one, rho1, vA, ci);
    c2 = ci * ci;
    a2 = vA * vA;
    const T cT2 = c2 * a2 / (c2 + a2);
    iY2 = cdivisor(k2 * c2 - Om_i2);
    F1 = ((rho1 * (c2 + a2)) * (k2 * cT2 - Om_i2)) / iY2;
    W = F1 / iOm_i;
    const T kdU1 = -(k * profile_d1<kInlineAll>(p.flow, one));
    add = kdU1 / iOm_i;
  }
  Edge<T, kDual> e;
  e.iOm_i = iOm_i;
  exterior_m(p, omega, k, e.m_e);
  if constexpr (!kDual) {
    e.sqm = csqrt(e.m_e);
    e.p_e = p_e;
    e.xi_e = xi_e;
    if constexpr (kShear) {
      e.W = W;
      e.add = add;
    }
  } else {
    const Cx<T> dX = -(Om_e + Om_e);
    const Cx<T> dp_e = ((T(p.pe_coef) * dX) - p_e * (X2 + Om_e * dX)) / iD2;
    const Cx<T> dxi_e = (-xi_e) / iOm_e;
    e.sqm = dcsqrt(e.m_e);
    e.p_e = {p_e, dp_e};
    e.xi_e = {xi_e, dxi_e};
    if constexpr (kShear) {
      const Cx<T> dOm_i2 = Om_i + Om_i;
      const Cx<T> dF1 =
          ((rho1 * (c2 + a2)) * (-dOm_i2) - F1 * (-dOm_i2)) / iY2;
      const Cx<T> dW = (dF1 - W) / iOm_i;
      const Cx<T> dadd = (-add) / iOm_i;
      e.W = {W, dW};
      e.add = {add, dadd};
    }
  }
  return e;
}

// z / Omega_i, and of a dual its derivative (z' - q) / Omega_i
// (physics/slab.py::_over_Om_i)
template <class T>
__device__ __forceinline__ Cx<T> over_Om_i(const Cx<T>& z, CDiv<T> iOm_i) {
  return z / iOm_i;
}
template <class T>
__device__ __forceinline__ CDual<T> over_Om_i(const CDual<T>& z,
                                              CDiv<T> iOm_i) {
  const Cx<T> q = z.v / iOm_i;
  return {q, (z.d - q) / iOm_i};
}

// The numeric exterior's helpers: a value's modulus, division by a real
// scale part by part (ode.py::_modulus, _unscale), the quotient a / b
template <class T>
__device__ __forceinline__ T modulus(const Cx<T>& z) {
  return cabs(z);
}
template <class T>
__device__ __forceinline__ T modulus(const CDual<T>& z) {
  return cabs(z.v);
}
template <class T>
__device__ __forceinline__ Cx<T> unscale(const Cx<T>& z, T s) {
  return {z.re / s, z.im / s};
}
template <class T>
__device__ __forceinline__ CDual<T> unscale(const CDual<T>& z, T s) {
  return {unscale(z.v, s), unscale(z.d, s)};
}
template <class T>
__device__ __forceinline__ Cx<T> quotient(const Cx<T>& a, const Cx<T>& b) {
  return a / b;
}
template <class T>
__device__ __forceinline__ CDual<T> quotient(const CDual<T>& a,
                                             const CDual<T>& b) {
  const CDiv<T> ib = cdivisor(b.v);
  const Cx<T> q = a.v / ib;
  return {q, (a.d - q * b.d) / ib};
}

// vx'/vx at x = 1 of the numeric exterior at complex omega
// (physics/slab.py::complex_exterior; common.cuh::slab_exterior's steps on
// a complex state, or its duals): n RK4 steps of (vx, vx')' = (vx', m_e
// vx) from x = 1 + W 2 pi / k down to 1, from (1e-8, -1e-15), each part
// divided by max(|vx|, |vx'|) (NaN-propagating; 1 where it is 0 or NaN)
// after every kRenormEvery-th step
template <class T, class S>
__device__ __forceinline__ S exterior_ratio(const S& m_e, T k,
                                            double wavelengths, int n) {
  const T x0 = T(1) + T(wavelengths * 2.0 * kPi) / k;
  T h, hh, h6;
  rk4_spacing(x0, T(1), n, h, hh, h6);
  S y0, y1;
  constant(T(1e-8), y0);
  constant(T(-1e-15), y1);
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const S k10 = y1, k11 = m_e * y0;
    const S k20 = y1 + hh * k11, k21 = m_e * (y0 + hh * k10);
    const S k30 = y1 + hh * k21, k31 = m_e * (y0 + hh * k20);
    const S k40 = y1 + h * k31, k41 = m_e * (y0 + h * k30);
    y0 = y0 + h6 * (k10 + T(2) * k20 + T(2) * k30 + k40);
    y1 = y1 + h6 * (k11 + T(2) * k21 + T(2) * k31 + k41);
    if ((i + 1) % kRenormEvery == 0) {
      T s = nan_max(modulus(y0), modulus(y1));
      s = s > T(0) ? s : T(1);
      y0 = unscale(y0, s);
      y1 = unscale(y1, s);
    }
  }
  return quotient(y1, y0);
}

// A round's end at omega from the state (vx, y1) at x = 1: the interface
// (edge), det = xi_i PT_e - xi_e PT_i (physics/slab.py::complex_det) with
// PT_i = F(1)/Omega_i (vx' - add vx) in the shear form, w / Omega_i in the
// flux form, PT_e = p_e vx'/vx of the numeric exterior (kNum, in the
// seed's own thread) or p_e (-sqrt(m_e)); with the value pass, the %
// mismatch and valid (complex_mismatch)
template <class T, bool kDual, bool kShear, bool kNum>
__device__ __forceinline__ State<T, kDual> finish(const SlabDispParams& p,
                                                  Cx<T> om, T k,
                                                  const State<T, kDual>& vx,
                                                  const State<T, kDual>& y1,
                                                  T* mism, bool* valid) {
  const Edge<T, kDual> e = edge<T, kDual, kShear>(p, om, k);
  State<T, kDual> PT_i;
  if constexpr (kShear) {
    PT_i = p.shear_pressure ? e.W * (y1 - e.add * vx) : e.W * y1;
  } else {
    PT_i = over_Om_i(y1, e.iOm_i);
  }
  State<T, kDual> PT_e;
  if constexpr (kNum) {
    PT_e = e.p_e * exterior_ratio(e.m_e, k, p.exterior_wavelengths,
                                  p.n_exterior);
  } else {
    PT_e = e.p_e * (-e.sqm);
  }
  const State<T, kDual> xi_i = over_Om_i(vx, e.iOm_i);
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

// One damped Newton step from omega with det = (D, dD/domega)
// (search.py::newton_step)
template <class T>
__device__ __forceinline__ Cx<T> newton_update(Cx<T> om, const CDual<T>& det,
                                               double damping) {
  const Cx<T> d = det.v, dd = det.d;
  const Cx<T> q = d / dd;
  Cx<T> step = (dd.re == T(0) && dd.im == T(0)) ? Cx<T>{T(0), T(0)} : q;
  const T max_step = T(0.2) * (T(1) + cabs(om));
  const T mag = cabs(step);
  if (mag > max_step) step = step * (max_step / mag);
  return om - T(damping) * step;
}

// -- the shear form: newton_kernel -------------------------------------------

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
      rk4_step<true>(h, hh, h6, aA, bA, aM, bM, aB, bB, y0, y1);
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
                                        int S, int n_steps, int nthr,
                                        int& g) {
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
      tb[e] = x_point<T, true>(
          p, rk4_abscissa(T(0), h, hh, i0 + e / 3, e % 3));
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

// B7 and B5-complex in the shear form, with the exact or the numeric
// exterior (kNum, B6-complex): n_iter damped Newton rounds of every seed,
// then with final_eval the value round at the final omega (n_iter = 0:
// the evaluation of the candidates). Columns past n take a copy of the
// last candidate and store nothing; lanes j >= B of the consumer shadow
// column j % B. out (omega) is written if out_re is given, det / mism /
// valid after the value round.
template <class T, bool kNum>
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
      start<T, true>(p, om, k, par, y0, y1);
      consume<T, true>(ring, B, C, S, n_steps, total, nthr, col, g, y0, y1);
      om = newton_update(om, finish<T, true, true, kNum>(p, om, k, y0, y1,
                                                         nullptr, nullptr),
                         damping);
    }
    if (final_eval) {
      if (own) {
        head[col] = om.re;
        head[32 + col] = om.im;
      }
      bar::arrive(bar::kOmega, nthr);
      Cx<T> y0, y1;
      start<T, true>(p, om, k, par, y0, y1);
      consume<T, false>(ring, B, C, S, n_steps, total, nthr, col, g, y0, y1);
      T mism;
      bool valid;
      const Cx<T> d =
          finish<T, false, true, kNum>(p, om, k, y0, y1, &mism, &valid);
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

// Launch newton_kernel<T, kNum> over n seeds (candidates) with B a block,
// C steps a stage and S stages. Returns the cudaError_t.
template <class T, bool kNum>
int launch_shear(const void* om_re, const void* om_im, const void* k,
                 const void* par, void* out_re, void* out_im, long long n,
                 void* det_re, void* det_im, void* mism, void* valid,
                 int n_iter, double damping, int final_eval, int B, int C,
                 int S, const SlabDispParams* p, int device, void* stream) {
  const size_t smem =
      cx_table_offset<T>(B, C, S)
      + 2 * 3 * static_cast<size_t>(C) * sizeof(ShearPoint<T>);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const auto kern = newton_kernel<T, kNum>;
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

// The shear form's variant of the case's exterior (p->exterior_numeric)
template <class T>
int launch(const void* om_re, const void* om_im, const void* k,
           const void* par, void* out_re, void* out_im, long long n,
           void* det_re, void* det_im, void* mism, void* valid, int n_iter,
           double damping, int final_eval, int B, int C, int S,
           const SlabDispParams* p, int device, void* stream) {
  if (n <= 0 || n_iter < 0 || final_eval < 0 || final_eval > 1 || B < 1
      || B > 32 || (B & (B - 1)) != 0 || C < 1 || S < 1
      || S > kBisectMaxStages || (n_iter > 0 && out_re == nullptr)
      || (final_eval && det_re == nullptr) || !p->shear) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto go = p->exterior_numeric ? &launch_shear<T, true>
                                : &launch_shear<T, false>;
  return go(om_re, om_im, k, par, out_re, out_im, n, det_re, det_im, mism,
            valid, n_iter, damping, final_eval, B, C, S, p, device, stream);
}

// -- the flux form: flux_kernel ----------------------------------------------

// The launch shape each type is built for: threads a block, the register
// budget of min_blocks blocks an SM (__launch_bounds__) and the RK4 steps
// of a chunk of the table; the numeric exterior's variant shares its
// type's. A build may set them (tools_torch/tune_disp.py --kernel
// slab_newton_flux builds this file at each shape it times);
// kernels/common.py::FLUX_NEWTON_SHAPE mirrors them. From timings on an
// H100 (PERF.md section 6): float64 2 blocks of 128 (154 registers, no
// spill; 3 blocks fit an SM), the fastest on cx_ph_09's Newton launch and
// on a checkpointed block's 8,640 seeds by under 1%: every block of 32-128
// threads is within 3%, as a density sweep's 1,182 warps put 2-3 on each
// of the 528 sub-partitions whatever the block; 192 threads and more are
// 8-35% slower; chunks of 16-64 steps within 2%. float32 3 blocks of 96.
#ifndef EIGK_CX_SLAB_F32_THREADS
#define EIGK_CX_SLAB_F32_THREADS 96
#endif
#ifndef EIGK_CX_SLAB_F32_MIN_BLOCKS
#define EIGK_CX_SLAB_F32_MIN_BLOCKS 3
#endif
#ifndef EIGK_CX_SLAB_F32_CHUNK
#define EIGK_CX_SLAB_F32_CHUNK 64
#endif
#ifndef EIGK_CX_SLAB_F64_THREADS
#define EIGK_CX_SLAB_F64_THREADS 128
#endif
#ifndef EIGK_CX_SLAB_F64_MIN_BLOCKS
#define EIGK_CX_SLAB_F64_MIN_BLOCKS 2
#endif
#ifndef EIGK_CX_SLAB_F64_CHUNK
#define EIGK_CX_SLAB_F64_CHUNK 64
#endif

template <class T>
struct FluxShape;
template <>
struct FluxShape<float> {
  static constexpr int threads = EIGK_CX_SLAB_F32_THREADS;
  static constexpr int min_blocks = EIGK_CX_SLAB_F32_MIN_BLOCKS;
  static constexpr int chunk = EIGK_CX_SLAB_F32_CHUNK;
};
template <>
struct FluxShape<double> {
  static constexpr int threads = EIGK_CX_SLAB_F64_THREADS;
  static constexpr int min_blocks = EIGK_CX_SLAB_F64_MIN_BLOCKS;
  static constexpr int chunk = EIGK_CX_SLAB_F64_CHUNK;
};

// Bytes of the flux kernel's table: 2 buffers of 3 chunk entries;
// kernels/common.py::flux_newton_smem mirrors it
template <class T>
__host__ __device__ constexpr size_t flux_smem() {
  return 2 * 3 * static_cast<size_t>(FluxShape<T>::chunk)
         * sizeof(FluxPoint<T>);
}
static_assert(FluxShape<float>::chunk >= 1 && FluxShape<double>::chunk >= 1
                  && flux_smem<float>() <= 227 * 1024
                  && flux_smem<double>() <= 227 * 1024,
              "the flux kernel's table fits a block's shared memory");

// The flux kernel's counts since the last read, each shoot of thread 0 of
// block 0 adding its own: the steps whose first chain it kept, the steps
// it took
__device__ unsigned long long g_flux_counts[2];

// One shoot of the flux form (physics/slab.py::_rk4_linear with
// complex_flux_coef) at omega, on values or duals (kDual), from the start
// state; every thread of the block calls it (it holds the block's
// barriers). The block fills the x-only entries of chunk steps at a time
// into one buffer of tab while it reads the other.
template <class T, bool kDual>
__device__ __forceinline__ void flux_shoot(const SlabDispParams& p,
                                           FluxPoint<T>* tab, Cx<T> om, T k,
                                           T par, State<T, kDual>& y0,
                                           State<T, kDual>& y1) {
  constexpr int chunk = FluxShape<T>::chunk;
  const int n = p.n_interior;
  T h, hh, h6;
  rk4_spacing(T(0), T(1), n, h, hh, h6);
  const bool reuse = chain_reuse(n);
  const int n_chunks = (n + chunk - 1) / chunk;
  const int slot = 3 * chunk;
  const auto fill = [&](int ci, int b) {
    const int i0 = ci * chunk;
    const int cnt = min(chunk, n - i0);
    FluxPoint<T>* dst = tab + b * slot;
    for (int e = threadIdx.x; e < 3 * cnt; e += blockDim.x) {
      dst[e] = x_point<T, false, kInlineGaussian>(
          p, rk4_abscissa(T(0), h, hh, i0 + e / 3, e % 3));
    }
  };
  start<T, false>(p, om, k, par, y0, y1);
  const FluxCand<T> cd(om, k);
  __syncthreads();                 // the shoot before is done with the table
  if (n_chunks > 0) fill(0, 0);
  __syncthreads();
  Coef<T, kDual> cB;               // the step before's last chain
  int kept = 0, steps = 0;         // g_flux_counts' terms
  for (int ci = 0; ci < n_chunks; ++ci) {
    // fill the other buffer while this one is read: the barrier below
    // publishes it and retires this one
    const int cb = ci & 1;
    if (ci + 1 < n_chunks) fill(ci + 1, cb ^ 1);
    const FluxPoint<T>* q = tab + cb * slot;
    const int i0 = ci * chunk;
    const int cnt = min(chunk, n - i0);
    // two steps at a time, so that a step's chains overlap the update
    // before
#pragma unroll 2
    for (int j = 0; j < cnt; ++j) {
      Coef<T, kDual> cA;
      if (reuse && i0 + j > 0) {
        cA = cB;
        ++kept;
      } else {
        cA = flux_coef<T, kDual>(q[3 * j], cd);
      }
      const Coef<T, kDual> cM = flux_coef<T, kDual>(q[3 * j + 1], cd);
      cB = flux_coef<T, kDual>(q[3 * j + 2], cd);
      rk4_step<false>(h, hh, h6, cA.D, cA.c, cM.D, cM.c, cB.D, cB.c, y0, y1);
      ++steps;
    }
    __syncthreads();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(&g_flux_counts[0], static_cast<unsigned long long>(kept));
    atomicAdd(&g_flux_counts[1], static_cast<unsigned long long>(steps));
  }
}

// B7, B5-complex and B2-complex in the flux form, with the exact or the
// numeric exterior (kNum, B6-complex): n_iter damped Newton rounds of
// every seed (one thread each), then with final_eval the value round at
// the final omega (n_iter = 0: the evaluation of the candidates), through
// tables of FluxShape's chunk of steps. out (omega) is written if out_re
// is given, det / mism / valid after the value round.
template <class T, bool kNum>
__global__ void __launch_bounds__(FluxShape<T>::threads,
                                  FluxShape<T>::min_blocks)
flux_kernel(const T* __restrict__ om_re, const T* __restrict__ om_im,
            const T* __restrict__ k_, const T* __restrict__ par_,
            T* __restrict__ out_re, T* __restrict__ out_im, int64_t n,
            T* __restrict__ det_re, T* __restrict__ det_im,
            T* __restrict__ mism_, bool* __restrict__ valid_, int n_iter,
            double damping, int final_eval,
            const __grid_constant__ SlabDispParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* tab = reinterpret_cast<FluxPoint<T>*>(smem_raw);  // [2][3 chunk]
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * FluxShape<T>::threads + threadIdx.x;
  const int64_t idx = i < n ? i : n - 1;
  Cx<T> om{om_re[idx], om_im[idx]};
  const T k = k_[idx], par = par_[idx];
#pragma unroll 1
  for (int round = 0; round < n_iter; ++round) {
    CDual<T> y0, y1;
    flux_shoot<T, true>(p, tab, om, k, par, y0, y1);
    om = newton_update(om, finish<T, true, false, kNum>(p, om, k, y0, y1,
                                                        nullptr, nullptr),
                       damping);
  }
  if (final_eval) {
    Cx<T> y0, y1;
    flux_shoot<T, false>(p, tab, om, k, par, y0, y1);
    T mism;
    bool valid;
    const Cx<T> d =
        finish<T, false, false, kNum>(p, om, k, y0, y1, &mism, &valid);
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
}

// Launch flux_kernel<T, kNum> over n seeds at its FluxShape. Returns the
// cudaError_t.
template <class T, bool kNum>
int launch_flux_variant(const void* om_re, const void* om_im, const void* k,
                        const void* par, void* out_re, void* out_im,
                        long long n, void* det_re, void* det_im, void* mism,
                        void* valid, int n_iter, double damping,
                        int final_eval, const SlabDispParams* p, int device,
                        void* stream) {
  constexpr int kThreads = FluxShape<T>::threads;
  constexpr size_t smem = flux_smem<T>();
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* kern = flux_kernel<T, kNum>;
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
      static_cast<const T*>(k), static_cast<const T*>(par),
      static_cast<T*>(out_re), static_cast<T*>(out_im), n,
      static_cast<T*>(det_re), static_cast<T*>(det_im),
      static_cast<T*>(mism), static_cast<bool*>(valid), n_iter, damping,
      final_eval, *p);
  return static_cast<int>(cudaGetLastError());
}

// The flux form's variant of the case's exterior (p->exterior_numeric)
template <class T>
int launch_flux(const void* om_re, const void* om_im, const void* k,
                const void* par, void* out_re, void* out_im, long long n,
                void* det_re, void* det_im, void* mism, void* valid,
                int n_iter, double damping, int final_eval,
                const SlabDispParams* p, int device, void* stream) {
  if (n <= 0 || n_iter < 0 || final_eval < 0 || final_eval > 1
      || (n_iter > 0 && out_re == nullptr)
      || (final_eval && det_re == nullptr) || p->shear) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto go = p->exterior_numeric ? &launch_flux_variant<T, true>
                                : &launch_flux_variant<T, false>;
  return go(om_re, om_im, k, par, out_re, out_im, n, det_re, det_im, mism,
            valid, n_iter, damping, final_eval, p, device, stream);
}

// Registers, local bytes a thread and blocks per SM (out[0..2]) of the
// flux variant, and its shape (out[3] threads, out[4] min_blocks, out[5]
// chunk)
template <class T>
int flux_attrs(bool numeric, int* out) {
  constexpr int kThreads = FluxShape<T>::threads;
  constexpr size_t smem = flux_smem<T>();
  const int err =
      numeric ? kernel_attrs(flux_kernel<T, true>, kThreads, smem, out)
              : kernel_attrs(flux_kernel<T, false>, kThreads, smem, out);
  out[3] = kThreads;
  out[4] = FluxShape<T>::min_blocks;
  out[5] = FluxShape<T>::chunk;
  return err;
}

// complex.cuh::fast_div and the division it stands for on n operand pairs
__global__ void fast_div_kernel(const double* __restrict__ num,
                                const double* __restrict__ den,
                                double* __restrict__ fast,
                                double* __restrict__ plain, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i < n) {
    fast[i] = fast_div(num[i], den[i]);
    plain[i] = plain_div(num[i], den[i]);
  }
}

}  // namespace slab_cx
}  // namespace eigk

extern "C" {

// B7, B5-complex and B6-complex in the shear form over n seeds or
// candidates (omega re, omega im, k, parity), with the case's exterior:
// n_iter damped Newton steps, the final omega (re, im) to out (null with
// n_iter = 0), then with final_eval the value round there: det (re, im),
// the % mismatch and valid (null without final_eval). B seeds a block, C
// steps a ring stage, S stages (P producer warps by type). A flux-form
// case is refused (eigk_slab_newton_flux_*). The count comes 7th, as in
// every entry. Returns the cudaError_t of the launch.
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

// B7, B5-complex, B2-complex and B6-complex in the flux form, the same
// arguments but the shape, which the build fixes
// (eigk_slab_newton_flux_attrs). A shear-form case is refused. Returns
// the cudaError_t of the launch.
int eigk_slab_newton_flux_f32(const void* om_re, const void* om_im,
                              const void* k, const void* par, void* out_re,
                              void* out_im, long long n, void* det_re,
                              void* det_im, void* mism, void* valid,
                              int n_iter, double damping, int final_eval,
                              const eigk::SlabDispParams* p, int device,
                              void* stream) {
  return eigk::slab_cx::launch_flux<float>(
      om_re, om_im, k, par, out_re, out_im, n, det_re, det_im, mism, valid,
      n_iter, damping, final_eval, p, device, stream);
}

int eigk_slab_newton_flux_f64(const void* om_re, const void* om_im,
                              const void* k, const void* par, void* out_re,
                              void* out_im, long long n, void* det_re,
                              void* det_im, void* mism, void* valid,
                              int n_iter, double damping, int final_eval,
                              const eigk::SlabDispParams* p, int device,
                              void* stream) {
  return eigk::slab_cx::launch_flux<double>(
      om_re, om_im, k, par, out_re, out_im, n, det_re, det_im, mism, valid,
      n_iter, damping, final_eval, p, device, stream);
}

// The bytes of the flux kernel's table (f64: double, else float), for the
// Python mirror's check
long long eigk_slab_newton_flux_smem(int f64) {
  using namespace eigk::slab_cx;
  return static_cast<long long>(f64 ? flux_smem<double>()
                                    : flux_smem<float>());
}

// Registers, local (spill) bytes a thread and resident blocks an SM
// (out[0..2]) of the flux kernel's variant (f64, numeric), and the shape
// it is built for (out[3] threads a block, out[4] __launch_bounds__' min
// blocks, out[5] the table's chunk of steps). Returns the cudaError_t.
int eigk_slab_newton_flux_attrs(int f64, int numeric, int* out) {
  using namespace eigk::slab_cx;
  return f64 ? flux_attrs<double>(numeric, out)
             : flux_attrs<float>(numeric, out);
}

// The flux kernel's counts on `device` since the last read (g_flux_counts:
// the steps of thread 0 of block 0 whose first chain it kept, and its
// steps, each summed over its shoots and the launches), to out[2]; then
// zeroes them. Waits for the device's work. Returns the cudaError_t.
int eigk_slab_newton_flux_counts(int device, unsigned long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(out, eigk::slab_cx::g_flux_counts,
                               sizeof(eigk::slab_cx::g_flux_counts));
  }
  if (err == cudaSuccess) {
    const unsigned long long zero[2] = {0, 0};
    err = cudaMemcpyToSymbol(eigk::slab_cx::g_flux_counts, zero,
                             sizeof(zero));
  }
  return static_cast<int>(err);
}

// complex.cuh::fast_div (to fast) and the division (to plain) of n float64
// operand pairs (num, den) on the card, for the tests that hold the one's
// bits to the other's. Returns the cudaError_t of the launch.
int eigk_fast_div_f64(const void* num, const void* den, void* fast,
                      void* plain, long long n, int device, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  eigk::slab_cx::fast_div_kernel<<<static_cast<unsigned>((n + 255) / 256),
                                   256, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(num), static_cast<const double*>(den),
      static_cast<double*>(fast), static_cast<double*>(plain), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
