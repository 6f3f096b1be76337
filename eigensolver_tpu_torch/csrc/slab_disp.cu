// Slab dispersion determinant over a batch of (omega, k, parity) candidates.
//
// Port of the XLA program `jit(vmap(disp))` of
// `eigensolver_tpu/physics/slab.py::SlabPhysics.make_dispersion`
// (slab.py:285-406) with the parity as a per-candidate column
// (`eigensolver_tpu/sweep.py::make_dispersion_moded`), for the real-omega
// cases, with the exact exponential exterior or, in a variant built apart
// (kNum), the numeric one (`eigensolver_tpu/ode.py::rk4_final_renorm` as
// `physics/slab.py:362-381` calls it; common.cuh::slab_exterior: after its
// interior shoot a thread integrates the exterior's 512 steps in
// registers, no table, the bisection's consumer lane alike). On the TPU
// this was an XLA-fused `lax.scan` with no Pallas original; in eager
// PyTorch it would be ~100 launches per RK4 step. Here one thread carries
// a candidate's whole shoot in registers:
//   flux form (density cases, no flow): state (vx, w = F vx') from
//     (par, (1 - par) F(0)), n_interior RK4 steps of `_rk4_linear_flux`
//     from x = 0 to 1 with the chain (1/F, F m0) at the 3 distinct
//     abscissae per step; PT_i = w / Omega;
//   shear form (flow cases): state (vx, vx') from (par, 1 - par), RK4 of
//     vx'' = -D vx' - coeff vx (`_rk4_linear_shear`), D in the legacy or
//     the corrected form, U' and U'' from the closed-form profile
//     derivatives; PT_i = F(1)/Omega (vx' - add vx), add the optional
//     shear-pressure term;
//   then m_e, p_e, sqrt(max(m_e, 0)) (or the numeric exterior's vx'/vx),
//   the determinant and the % mismatch.
//
// What bounds it on Hopper: per candidate, n_interior evaluations of the
// coefficient chain's RK4 update and 2 or 3 of the chain a step, against
// 24 bytes in and 17 bytes out: operations, not memory. The work repeats
// what the batch shares in three ways, and the scan takes each:
// - Most of the chain depends on x alone (slab.py:162-171, :187-190): in
//   the flux form the profile, the pressure-balanced speeds, c^2, vA^2,
//   cT^2 and rho (c^2 + vA^2) - the exp, both square roots and 4 of the 5
//   divisions of an evaluation (U == 0 there, so Omega is the candidate's
//   own); in the shear form U, U' and U'' - 3 exps and 3 divisions for a
//   Gaussian flow. And x itself comes from the launch parameters only. So
//   each block computes those values for a chunk of steps cooperatively,
//   one abscissa per thread, into a double-buffered table in shared
//   memory (one barrier per chunk), and every thread reads them as
//   warp-uniform broadcasts. What stays per candidate and abscissa is 1
//   division (flux) or 5-6 (shear), no square root, no exp. The plain
//   PyTorch version computes the x-only values once per abscissa as 0-d
//   tensors, in this order, so the table gives its bits.
// - Where n_interior is a power of two (common.cuh::chain_reuse), a step's
//   first abscissa is the step before's last, bit for bit: its chain is
//   kept in registers, not formed again, and the table holds 2 n + 1
//   entries, not 3 n. 2 chains a step, not 3.
// - Only the start depends on the parity. A sweep scans the same (omega,
//   k) rows once per parity, so the paired variant (kPaired) gives a
//   thread both parities of one (omega, k): Cand, edge, F(0), the chain at
//   every abscissa and the exterior once, then two updates a step and two
//   interfaces, parity 0's results first, parity 1's n after them. Batches
//   that are not both parities of the same rows (the refine windows and
//   the re-judge, single-parity sweeps, the needle pass, random draws)
//   take the unpaired scan, one thread a candidate.
//
// Arithmetic order follows the JAX code expression for expression (no
// algebraic simplification; c_i(x)^2 is a square root squared), and the
// build disables FMA contraction (--fmad=false), so the kernel agrees bit
// for bit with the plain PyTorch version (physics/slab.py) on the card.
//
// slab_bisect, the second kernel here, is the fused bracket stage over the
// same chain: it replaces `eigensolver_tpu/search.py::bisect` (:142-169)
// and the bisection of `refine_on_cpu` (:468-522) over `physics/slab.py`,
// which the port ran as n_iter + 2 launches of slab_disp on 5,040
// (slab_ph_09) or ~150 (refinement) brackets, each launch one thread's
// serial chain long. Bound by operations (3 chain evaluations per RK4 step
// per bracket per evaluation); it runs on bisect.cuh::spec_kernel over
// SpecChain, with either exterior: the producers compute the x-only
// entries of a stage once per block into a table, as the scan does, and
// each bracket's chain from them; one consumer lane per bracket (2^L on a
// small batch, which speculates L levels a round) runs the serial update
// in this file's order (rk4_step, start, finish), so its (root, mismatch)
// are bit-equal to the launch loop's.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "bisect.cuh"
#include "common.cuh"
#include "slab.cuh"

namespace eigk {

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

// A candidate as the chain reads it, with the products of k that every
// abscissa repeats: k^2 and, in the flux form, Omega^2 (U == 0 there, so
// Omega = omega - k 0 at every x); in the shear form k^2 times the
// regime's c^2, vA^2, cT^2, and (k^2 k^2) cT^2 c^2.
template <class T>
struct Cand {
  T omega, k, k2, Om2, twok, ca, k2c2, k2a2, k2cT2, k4cT2c2;
  __device__ Cand(const SlabDispParams& p, T omega_, T k_)
      : omega(omega_), k(k_), k2(k_ * k_) {
    const T Om = omega - k * T(0);
    Om2 = Om * Om;
    twok = T(2) * k;
    ca = T(p.sca);
    k2c2 = k2 * T(p.sc2);
    k2a2 = k2 * T(p.sa2);
    k2cT2 = k2 * T(p.scT2);
    k4cT2c2 = (k2 * k2) * T(p.scT2) * T(p.sc2);
  }
};

// make_flux_coef (slab.py:215-230): (1/F, F m0) at the abscissa of q
template <class T>
__device__ __forceinline__ void flux_coef(const FluxPoint<T>& q,
                                          const Cand<T>& c, T& a, T& b) {
  a = (c.k2 * q.c2 - c.Om2) / (q.rho_csum * (c.k2 * q.cT2 - c.Om2));
  b = q.rho * (c.k2 * q.a2 - c.Om2);
}

// make_shear_coef (slab.py:247-281): (D, coeff) at the abscissa of q
template <class T>
__device__ __forceinline__ void shear_coef(const SlabDispParams& p,
                                           const ShearPoint<T>& q,
                                           const Cand<T>& c, T& Dx,
                                           T& coeff) {
  const T Om = c.omega - c.k * q.U;
  const T Om2 = Om * Om;
  const T m0 = (c.k2c2 - Om2) * (c.k2a2 - Om2) / (c.ca * (c.k2cT2 - Om2));
  if (p.legacy_D) {
    Dx = c.twok * q.dU
         * ((Om2 - c.k2cT2) + c.k4cT2c2 / (c.ca * (Om2 - c.k2cT2)))
         / (Om * (Om2 - c.k2c2));
  } else {
    Dx = c.twok * q.dU * (Om2 / (Om2 - c.k2c2) - c.k2cT2 / (Om2 - c.k2cT2))
         / Om;
  }
  coeff = (c.k * q.ddU / Om) + (c.k * q.dU * Dx / Om) - m0;
}

// The chain (a, b) of candidate c at the abscissa of the table entry q
template <class T, bool kShear>
__device__ __forceinline__ void coef_at(const SlabDispParams& p,
                                        const XPoint<T, kShear>& q,
                                        const Cand<T>& c, T& a, T& b) {
  if constexpr (kShear) {
    shear_coef(p, q, c, a, b);
  } else {
    flux_coef(q, c, a, b);
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

// One RK4 step of the linear system with the chain (a, b) at the step's 3
// abscissae (A: x, M: x + h/2, B: x + h); shared by the scan and the
// consumer warp of the fused bisection
template <class T, bool kShear>
__device__ __forceinline__ void rk4_step(T h, T hh, T h6, T aA, T bA, T aM,
                                         T bM, T aB, T bB, T& y0, T& y1) {
  T k10, k11, k20, k21, k30, k31, k40, k41;
  apply<T, kShear>(aA, bA, y0, y1, k10, k11);
  apply<T, kShear>(aM, bM, y0 + hh * k10, y1 + hh * k11, k20, k21);
  apply<T, kShear>(aM, bM, y0 + hh * k20, y1 + hh * k21, k30, k31);
  apply<T, kShear>(aB, bB, y0 + h * k30, y1 + h * k31, k40, k41);
  y0 = y0 + h6 * (k10 + T(2) * k20 + T(2) * k30 + k40);
  y1 = y1 + h6 * (k11 + T(2) * k21 + T(2) * k31 + k41);
}

// What the start state reads of the candidate: F(0) in the flux form (the
// shear form's start reads none), shared by both parities of an (omega, k)
template <class T, bool kShear>
__device__ __forceinline__ T start_F0(const SlabDispParams& p, T omega, T k) {
  if constexpr (kShear) {
    return T(0);
  } else {
    return interior_F(p, omega, k, T(0));
  }
}

// Start state at the slab centre: flux (vx, w): sausage (par = 0) vx odd,
// (0, F(0)); kink (1, 0 F(0)), NaN where F(0) is not finite. Shear (vx,
// vx'): (par, 1 - par).
template <class T, bool kShear>
__device__ __forceinline__ void start_at(T F0, T par, T& y0, T& y1) {
  const T one = T(1);
  if (!kShear) {
    y0 = par * one;
    y1 = (one - par) * F0;
  } else {
    y0 = par;
    y1 = one - par;
  }
}

template <class T, bool kShear>
__device__ __forceinline__ void start(const SlabDispParams& p, T omega, T k,
                                      T par, T& y0, T& y1) {
  start_at<T, kShear>(start_F0<T, kShear>(p, omega, k), par, y0, y1);
}

// What the interface reads besides the state: the exterior coefficients
// (slab.py:146-165) and the interior Omega at x = 1
template <class T>
struct Edge {
  T Om_e, m_e, p_e, sqm, Om_i;
};

template <class T>
__device__ __forceinline__ Edge<T> edge(const SlabDispParams& p, T omega,
                                        T k) {
  const T zero = T(0);
  const T k2 = k * k;
  Edge<T> e;
  e.Om_e = omega - k * T(p.U_e);
  const T Om_e2 = e.Om_e * e.Om_e;
  e.m_e = (k2 * T(p.vA_e2) - Om_e2) * (k2 * T(p.c_e2) - Om_e2)
          / (T(p.vAc_e2) * (k2 * T(p.cT_e2) - Om_e2));
  e.p_e = T(p.pe_coef) * (k2 * T(p.cT_e2) - Om_e2)
          / (e.Om_e * (k2 * T(p.c_e2) - Om_e2));
  e.sqm = sqrt(nan_max(e.m_e, zero));
  T rho1, c2_1, a2_1;
  local(p, omega, k, T(1), e.Om_i, rho1, c2_1, a2_1);
  return e;
}

// PT_e, the exterior's total pressure at x = 1: p_e vx'/vx of the numeric
// exterior (kNum, common.cuh::slab_exterior) or of the exact decaying vx_e
// = exp(-sqm (x - 1)). It depends on (omega, k) alone.
template <class T, bool kNum>
__device__ __forceinline__ T exterior_PT(const SlabDispParams& p, T k,
                                         const Edge<T>& e) {
  if constexpr (kNum) {
    return e.p_e * slab_exterior(e.m_e, k, p.exterior_wavelengths,
                                 p.n_exterior);
  } else {
    return e.p_e * (-e.sqm);
  }
}

// The interface at x = 1 from the state (vx_b, y1_b) there: PT_i, the
// exterior's PT_e = ext() (exterior_PT, formed where the one-thread order
// forms it, or a value both parities of an (omega, k) share), det, the %
// mismatch and valid (slab.py:362-406)
template <class T, bool kShear, class Ext>
__device__ __forceinline__ void finish_with(const SlabDispParams& p, T omega,
                                            T k, const Edge<T>& e, T vx_b,
                                            T y1_b, Ext ext, T& det, T& mism,
                                            bool& valid) {
  const T zero = T(0);
  const T one = T(1);
  const T Om_e = e.Om_e, m_e = e.m_e;
  const T Om_i = e.Om_i;

  T PT_i;
  if (!kShear) {
    PT_i = y1_b / Om_i;                     // PT = F vx' / Omega = w / Omega
  } else {
    const T F1 = interior_F(p, omega, k, one);
    if (p.shear_pressure) {
      const T add = -(k * profile_d1(p.flow, one)) / Om_i;
      PT_i = (F1 / Om_i) * (y1_b - add * vx_b);
    } else {
      PT_i = (F1 / Om_i) * y1_b;
    }
  }

  const T PT_e = ext();
  const T xi_e = one / Om_e;
  const T xi_i = vx_b / Om_i;
  det = xi_i * PT_e - xi_e * PT_i;

  // reference-style % mismatch of PT once xi is matched
  const T s = xi_e / xi_i;
  const T num = fabs(PT_e - s * PT_i);
  const T den = nan_max(fabs(PT_e), fabs(s * PT_i));
  mism = T(100) * num / den;
  valid = m_e > zero;
}

// finish with the exterior of kNum, exact or numeric
template <class T, bool kShear, bool kNum>
__device__ __forceinline__ void finish(const SlabDispParams& p, T omega, T k,
                                       const Edge<T>& e, T vx_b, T y1_b,
                                       T& det, T& mism, bool& valid) {
  finish_with<T, kShear>(
      p, omega, k, e, vx_b, y1_b,
      [&] { return exterior_PT<T, kNum>(p, k, e); }, det, mism, valid);
}

// The block fills the table entries of steps [i0, i0 + count), one entry
// per thread at a time: 3 a step (A, M, B), or where chain_reuse holds 2 (M
// at entry 1 + 2 j, B at 2 + 2 j), A of the run's first step at entry 0 in
// the first chunk only (every later A is the B before it). The abscissae
// are formed as the RK4 loop of `_rk4_linear_*` forms them (common.cuh:
// rk4_abscissa).
template <class T, bool kShear>
__device__ __forceinline__ void fill_chunk(const SlabDispParams& p, T h, T hh,
                                           int i0, int count, bool reuse,
                                           XPoint<T, kShear>* dst) {
  if (reuse) {
    for (int e = threadIdx.x + (i0 > 0); e <= 2 * count; e += blockDim.x) {
      const int j = e > 0 ? (e - 1) / 2 : 0;
      const int a = e > 0 ? 1 + (e - 1) % 2 : 0;
      dst[e] = x_point<T, kShear>(p, rk4_abscissa(T(0), h, hh, i0 + j, a));
    }
  } else {
    for (int e = threadIdx.x; e < 3 * count; e += blockDim.x) {
      dst[e] = x_point<T, kShear>(p, rk4_abscissa(T(0), h, hh, i0 + e / 3,
                                                  e % 3));
    }
  }
}

// A thread's RK4 steps over one chunk of the table: one chain at each
// abscissa, the update of each of its kP states (one candidate, or both
// parities of an (omega, k)). Where chain_reuse holds, the chain at a step's
// first abscissa is the one at the step before's last, kept in (aA, bA)
// across chunks; the first chunk forms it from entry 0.
template <class T, bool kShear, int kP>
__device__ __forceinline__ void run_chunk(const SlabDispParams& p,
                                          const XPoint<T, kShear>* q,
                                          int count, bool first, bool reuse,
                                          T h, T hh, T h6, const Cand<T>& c,
                                          T& aA, T& bA, T (&y0)[kP],
                                          T (&y1)[kP]) {
  if (reuse) {
    if (first) coef_at<T, kShear>(p, q[0], c, aA, bA);
    for (int j = 0; j < count; ++j) {
      T aM, bM, aB, bB;
      coef_at<T, kShear>(p, q[1 + 2 * j], c, aM, bM);
      coef_at<T, kShear>(p, q[2 + 2 * j], c, aB, bB);
#pragma unroll
      for (int v = 0; v < kP; ++v) {
        rk4_step<T, kShear>(h, hh, h6, aA, bA, aM, bM, aB, bB, y0[v], y1[v]);
      }
      aA = aB;
      bA = bB;
    }
  } else {
    for (int j = 0; j < count; ++j, q += 3) {
      T a0, b0, aM, bM, aB, bB;
      coef_at<T, kShear>(p, q[0], c, a0, b0);
      coef_at<T, kShear>(p, q[1], c, aM, bM);
      coef_at<T, kShear>(p, q[2], c, aB, bB);
#pragma unroll
      for (int v = 0; v < kP; ++v) {
        rk4_step<T, kShear>(h, hh, h6, a0, b0, aM, bM, aB, bB, y0[v], y1[v]);
      }
    }
  }
}

// The scan: kThreads threads per block, the x-only table in chunks of
// `chunk` steps (dynamic shared memory: 2 x 3 chunk entries),
// `_rk4_linear_flux` / `_rk4_linear_shear` (slab.py:41-113) from x = 0 to
// 1, the exterior of kNum. A thread carries one candidate (omega[i], k[i],
// par[i]) of n, or with kPaired both parities of the pair (omega[i], k[i])
// of n: Cand, edge, F(0), the chain at every abscissa and the exterior
// once, the start, the update and the interface (finish_with) per parity,
// parity 0's result at i and parity 1's at n + i. Threads past n evaluate
// a copy of the last candidate (pair), so that every thread reaches the
// block's barriers, and store nothing.
template <class T, bool kShear, int kThreads, bool kNum, bool kPaired>
__global__ void __launch_bounds__(kThreads)
slab_disp_kernel(const T* __restrict__ omega_, const T* __restrict__ k_,
                 const T* __restrict__ par_, T* __restrict__ det_,
                 T* __restrict__ mism_, bool* __restrict__ valid_, int64_t n,
                 int chunk, const __grid_constant__ SlabDispParams p) {
  constexpr int kP = kPaired ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* table = reinterpret_cast<XPoint<T, kShear>*>(smem_raw);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t idx = i < n ? i : n - 1;
  const T omega = omega_[idx];
  const T k = k_[idx];
  // the edge values first, as the JAX code orders them: nvcc then keeps
  // the chain's loop-invariant parameter conversions out of the RK4 loop
  const Edge<T> e = edge(p, omega, k);
  T y0[kP], y1[kP];
  const T F0 = start_F0<T, kShear>(p, omega, k);
  if constexpr (kPaired) {
    start_at<T, kShear>(F0, T(0), y0[0], y1[0]);
    start_at<T, kShear>(F0, T(1), y0[1], y1[1]);
  } else {
    start_at<T, kShear>(F0, par_[idx], y0[0], y1[0]);
  }
  const Cand<T> c(p, omega, k);

  const int n_steps = p.n_interior;
  const bool reuse = chain_reuse(n_steps);
  T h, hh, h6;
  rk4_spacing(T(0), T(1), n_steps, h, hh, h6);
  const int n_chunks = (n_steps + chunk - 1) / chunk;
  const int slot = 3 * chunk;
  if (n_chunks > 0) {
    fill_chunk<T, kShear>(p, h, hh, 0, min(chunk, n_steps), reuse, table);
  }
  __syncthreads();
  T aA = T(0), bA = T(0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    // fill the other buffer while this one is read: the barrier below
    // publishes it and retires this one
    if (ci + 1 < n_chunks) {
      const int i1 = (ci + 1) * chunk;
      fill_chunk<T, kShear>(p, h, hh, i1, min(chunk, n_steps - i1), reuse,
                            table + ((ci + 1) & 1) * slot);
    }
    run_chunk<T, kShear, kP>(p, table + (ci & 1) * slot,
                             min(chunk, n_steps - ci * chunk), ci == 0,
                             reuse, h, hh, h6, c, aA, bA, y0, y1);
    __syncthreads();
  }
  if constexpr (kPaired) {
    const T PT_e = exterior_PT<T, kNum>(p, k, e);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      T det, mism;
      bool valid;
      finish_with<T, kShear>(p, omega, k, e, y0[v], y1[v],
                             [&] { return PT_e; }, det, mism, valid);
      if (i < n) {
        det_[v * n + i] = det;
        mism_[v * n + i] = mism;
        valid_[v * n + i] = valid;
      }
    }
  } else {
    T det, mism;
    bool valid;
    finish<T, kShear, kNum>(p, omega, k, e, y0[0], y1[0], det, mism, valid);
    if (i < n) {
      det_[i] = det;
      mism_[i] = mism;
      valid_[i] = valid;
    }
  }
}

// The slab chain as bisect.cuh::spec_kernel runs it, with the exterior of
// kNum: the producers compute an abscissa's x-only entry (x_point) once per
// block and each column's chain from it (coef_at), the consumer runs start
// / rk4_step / finish, the exterior included, in the scan's order, so
// every value is the scan's.
template <class T_, bool kShear, bool kNum>
struct SpecChain {
  using T = T_;
  using Params = SlabDispParams;
  using Entry = XPoint<T, kShear>;
  static constexpr int kState = 2;  // (vx, w) flux, (vx, vx') shear
  struct Ctx {};
  const Params& p;
  int n;
  T h, hh, h6;

  __device__ explicit SpecChain(const Params& p_) : p(p_), n(p_.n_interior) {
    rk4_spacing(T(0), T(1), n, h, hh, h6);
  }
  __device__ int n_steps() const { return n; }
  __device__ Entry entry(int i, int a) const {
    return x_point<T, kShear>(p, rk4_abscissa(T(0), h, hh, i, a));
  }
  __device__ void coef(int, const Entry& q, T omega, T k, T, T& c0,
                       T& c1) const {
    coef_at<T, kShear>(p, q, Cand<T>(p, omega, k), c0, c1);
  }
  __device__ void start(T omega, T k, T par, T* y, Ctx&) const {
    slab::start<T, kShear>(p, omega, k, par, y[0], y[1]);
  }
  __device__ void step(int, const T* c, int s, T* y) const {
    rk4_step<T, kShear>(h, hh, h6, c[0], c[s], c[2 * s], c[3 * s], c[4 * s],
                        c[5 * s], y[0], y[1]);
  }
  __device__ void finish(T omega, T k, T, const T* y, const Ctx&, T& det,
                         T& mism, bool& valid) const {
    slab::finish<T, kShear, kNum>(p, omega, k, edge(p, omega, k), y[0], y[1],
                                  det, mism, valid);
  }
};

template <class T, bool kShear, int kThreads, bool kNum, bool kPaired>
cudaError_t launch_scan(const void* omega, const void* k, const void* par,
                        void* det, void* mism, void* valid, long long n,
                        int chunk, size_t smem, const SlabDispParams* p,
                        cudaStream_t stream) {
  auto* kern = slab_disp_kernel<T, kShear, kThreads, kNum, kPaired>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(omega), static_cast<const T*>(k),
      static_cast<const T*>(par), static_cast<T*>(det), static_cast<T*>(mism),
      static_cast<bool*>(valid), n, chunk, *p);
  return cudaGetLastError();
}

template <class T, bool kShear, bool kNum, bool kPaired>
cudaError_t launch_form(const void* omega, const void* k, const void* par,
                        void* det, void* mism, void* valid, long long n,
                        int threads, int chunk, const SlabDispParams* p,
                        cudaStream_t s) {
  const size_t smem =
      2 * 3 * static_cast<size_t>(chunk) * sizeof(XPoint<T, kShear>);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if constexpr (kPaired) {
    // built only at the block size kernels/slab.py::PAIRS_SHAPE picks: 128
    // threads in the flux form, 256 in the shear form
    constexpr int kT = kShear ? 256 : 128;
    if (threads != kT) return cudaErrorInvalidValue;
    return launch_scan<T, kShear, kT, kNum, true>(omega, k, par, det, mism,
                                                  valid, n, chunk, smem, p,
                                                  s);
  } else if constexpr (kNum) {
    // built only at the shapes kernels/slab.py::scan_shape picks: 128
    // threads, and 256 for the flux form
    if (threads == 128) {
      return launch_scan<T, kShear, 128, true, false>(
          omega, k, par, det, mism, valid, n, chunk, smem, p, s);
    }
    if constexpr (!kShear) {
      if (threads == 256) {
        return launch_scan<T, kShear, 256, true, false>(
            omega, k, par, det, mism, valid, n, chunk, smem, p, s);
      }
    }
    return cudaErrorInvalidValue;
  } else {
    switch (threads) {
      case 32:
        return launch_scan<T, kShear, 32, false, false>(
            omega, k, par, det, mism, valid, n, chunk, smem, p, s);
      case 64:
        return launch_scan<T, kShear, 64, false, false>(
            omega, k, par, det, mism, valid, n, chunk, smem, p, s);
      case 128:
        return launch_scan<T, kShear, 128, false, false>(
            omega, k, par, det, mism, valid, n, chunk, smem, p, s);
      case 256:
        return launch_scan<T, kShear, 256, false, false>(
            omega, k, par, det, mism, valid, n, chunk, smem, p, s);
      case 512:
        return launch_scan<T, kShear, 512, false, false>(
            omega, k, par, det, mism, valid, n, chunk, smem, p, s);
      default:
        return cudaErrorInvalidValue;
    }
  }
}

// The form and the exterior that p names
template <class T, bool kPaired>
cudaError_t launch_any(const void* omega, const void* k, const void* par,
                       void* det, void* mism, void* valid, long long n,
                       int threads, int chunk, const SlabDispParams* p,
                       cudaStream_t s) {
  if (p->shear) {
    return p->exterior_numeric
               ? launch_form<T, true, true, kPaired>(
                     omega, k, par, det, mism, valid, n, threads, chunk, p, s)
               : launch_form<T, true, false, kPaired>(
                     omega, k, par, det, mism, valid, n, threads, chunk, p,
                     s);
  }
  return p->exterior_numeric
             ? launch_form<T, false, true, kPaired>(
                   omega, k, par, det, mism, valid, n, threads, chunk, p, s)
             : launch_form<T, false, false, kPaired>(
                   omega, k, par, det, mism, valid, n, threads, chunk, p, s);
}

// The scan of n candidates (kPaired: of n (omega, k) pairs, 2 n results,
// par unread) with `threads` a block and chunks of `chunk` steps; returns
// the cudaError_t
template <class T, bool kPaired>
int launch(const void* omega, const void* k, const void* par, void* det,
           void* mism, void* valid, long long n, int threads, int chunk,
           const SlabDispParams* p, int device, void* stream) {
  if (n <= 0 || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  err = launch_any<T, kPaired>(omega, k, par, det, mism, valid, n, threads,
                               chunk, p, s);
  return static_cast<int>(err);
}

// The fused bisection (bisect.cuh::launch_spec over SpecChain) in the form
// and with the exterior that p names; the flux form with the exact exterior
// at float64 only at 128 registers a thread, where
// kernels/common.py::analytic_spec_shape launches it (64 spill its chain)
template <class T>
int launch_spec_slab(const void* lo, const void* hi, const void* k,
                     const void* par, void* root, void* mism, long long n,
                     int n_iter, int final_eval, int B, int L, int P, int C,
                     int S, int min_blocks, const SlabDispParams* p,
                     int device, void* stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  auto* launch = p->shear ? (p->exterior_numeric
                                 ? launch_spec<SpecChain<T, true, true>>
                                 : launch_spec<SpecChain<T, true, false>>)
                          : (p->exterior_numeric
                                 ? launch_spec<SpecChain<T, false, true>>
                                 : launch_spec<SpecChain<T, false, false>,
                                               kF32>);
  return launch(lo, hi, k, par, root, mism, nullptr, n, n_iter, final_eval, 0,
                B, L, P, C, S, min_blocks, p, device, stream);
}

}  // namespace slab
}  // namespace eigk

extern "C" {

// Each entry returns the cudaError_t of the launch (0 on success); n > 0;
// threads 32, 64, 128, 256 or 512 a block (the numeric exterior's 128, and
// 256 in the flux form), chunks of `chunk` table steps.
int eigk_slab_disp_f32(const void* omega, const void* k, const void* par,
                       void* det, void* mism, void* valid, long long n,
                       int threads, int chunk, const eigk::SlabDispParams* p,
                       int device, void* stream) {
  return eigk::slab::launch<float, false>(omega, k, par, det, mism, valid, n,
                                          threads, chunk, p, device, stream);
}

int eigk_slab_disp_f64(const void* omega, const void* k, const void* par,
                       void* det, void* mism, void* valid, long long n,
                       int threads, int chunk, const eigk::SlabDispParams* p,
                       int device, void* stream) {
  return eigk::slab::launch<double, false>(omega, k, par, det, mism, valid,
                                           n, threads, chunk, p, device,
                                           stream);
}

// Both parities of each of n (omega, k) pairs: parity 0's n results, then
// parity 1's (det, mism and valid hold 2 n); par is not read (null);
// threads 128 a block in the flux form, 256 in the shear form.
int eigk_slab_pairs_f32(const void* omega, const void* k, const void* par,
                        void* det, void* mism, void* valid, long long n,
                        int threads, int chunk, const eigk::SlabDispParams* p,
                        int device, void* stream) {
  return eigk::slab::launch<float, true>(omega, k, par, det, mism, valid, n,
                                         threads, chunk, p, device, stream);
}

int eigk_slab_pairs_f64(const void* omega, const void* k, const void* par,
                        void* det, void* mism, void* valid, long long n,
                        int threads, int chunk, const eigk::SlabDispParams* p,
                        int device, void* stream) {
  return eigk::slab::launch<double, true>(omega, k, par, det, mism, valid, n,
                                          threads, chunk, p, device, stream);
}

// Fused bisection of n brackets (lo, hi, k, parity) with the exterior
// that p names: root, and the % mismatch at the root when final_eval (mism
// may be null otherwise); B brackets a block, L levels a round on 2^L
// lanes a bracket (B 2^L <= 32; 0 the loop's schedule), P producer warps,
// C steps per stage, S stages, the register budget of min_blocks blocks of
// 512 threads per SM (0: chosen at launch).
int eigk_slab_spec_f32(const void* lo, const void* hi, const void* k,
                       const void* par, void* root, void* mism, long long n,
                       int n_iter, int final_eval, int B, int L, int P, int C,
                       int S, int min_blocks, const eigk::SlabDispParams* p,
                       int device, void* stream) {
  return eigk::slab::launch_spec_slab<float>(lo, hi, k, par, root, mism, n,
                                             n_iter, final_eval, B, L, P, C,
                                             S, min_blocks, p, device, stream);
}

int eigk_slab_spec_f64(const void* lo, const void* hi, const void* k,
                       const void* par, void* root, void* mism, long long n,
                       int n_iter, int final_eval, int B, int L, int P, int C,
                       int S, int min_blocks, const eigk::SlabDispParams* p,
                       int device, void* stream) {
  return eigk::slab::launch_spec_slab<double>(lo, hi, k, par, root, mism, n,
                                              n_iter, final_eval, B, L, P, C,
                                              S, min_blocks, p, device,
                                              stream);
}

// sizeof(SlabDispParams), for the Python mirror's layout check
long long eigk_slab_params_size() {
  return static_cast<long long>(sizeof(eigk::SlabDispParams));
}

}  // extern "C"
