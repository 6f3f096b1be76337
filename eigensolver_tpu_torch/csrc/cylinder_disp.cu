// Cylinder dispersion determinant over a batch of (omega, k, m) candidates.
//
// Port of the XLA program `jit(vmap(disp))` of
// `eigensolver_tpu/physics/cylinder.py::CylinderPhysics.make_dispersion`
// (cylinder.py:236-385) with the mode as a per-candidate column
// (`eigensolver_tpu/sweep.py::make_dispersion_moded`), for the non-twisted,
// real-omega cases, with the analytic ("bessel") exterior or, in a variant
// built apart (kNum), the numeric one (`eigensolver_tpu/ode.py::rk4_final`
// as `physics/cylinder.py:319-351` calls it, in t = ln r;
// common.cuh::cyl_exterior; the K_m ratio is then not computed). On the
// TPU the interior was an XLA-fused `lax.scan` and the exterior either
// fused XLA or the Pallas kernel `kernels/bessel.py::kve_ratio_pallas`;
// here each candidate's state stays in the registers of one thread:
//   two-basis state (P1, w1, P2, w2) from u0 = (1, 0, 0, F(1));
//   n_interior RK4 steps of `_rk4_linear2` from r = 1 to eps, the
//   coefficient chain evaluated at the 3 distinct abscissae per step;
//   the log tail of n_axis_log steps in t = ln r down to eps_final, with
//   coefficients (r iF, r g);
//   the axis condition, the interface values, m_e, sqrt(m_e), the exterior
//   ratio from the inlined device function of kve_ratio.cuh (or the
//   numeric exterior's 512 steps), xi_e, the determinant and the %
//   mismatch.
//
// What bounds it on Hopper: per candidate, (n_interior + n_axis_log) * 3
// evaluations of the Hain-Lust chain plus the RK4 updates, against 24 bytes
// in and 17 bytes out: operations, not memory, and among them the IEEE
// divisions (built without fast math, each a reciprocal on the 16-lane
// MUFU pipe, its refinement and a range check). Much of the chain does not
// depend on the candidate's omega, and the scan shares it:
//   - what depends on r alone (cylinder.py:113-127): rho, vA, c_i,
//     sqrt(rho), c_i^2 + vA^2 and its square root, U(r), r r, and r =
//     exp(t) on the tail - every exp and square root of the chain;
//   - what depends on (k, m, r) (cylinder.py:181-190): k U, alpha^2 and
//     cusp^2 (alpha = k B_z / sqrt(rho), cusp = alpha c_i / sqrt(c_i^2 +
//     vA^2)) and (c_i^2 + vA^2)(m^2/r^2 + k^2) - 3 of an evaluation's 5
//     divisions. search.py flattens the ladder as (rows, n_omega), so a
//     block of candidates spans few (k, m) rows;
//   - the numeric exterior's exp(2 t), which depends on k alone.
// So the scan (cylinder_disp_kernel) keeps tables in shared memory: each
// block computes, for a chunk of steps, one abscissa per thread, its
// r-only entry and the entries of the (k, m) rows of its first and last
// candidates, into a double-buffered ring (one barrier per chunk), and
// every thread reads them as warp-uniform broadcasts; after the interior
// the numeric variant tables exp(2 t) for the rows' k. A candidate of a
// tabled row keeps per abscissa only what depends on omega: the shift,
// D, A, C2, C3 and 1/F, g - 2 divisions (A/r and r (C2 - C1^2/C3)/D), no
// square root, no exp. A candidate outside the block's rows (rows shorter
// than a block, random draws, refine windows) forms its own (k, m, r)
// values from the r-only table, and its own exps. Either path applies the
// plain version's operations to the same operands, in its order, so the
// bits do not depend on it; the plain PyTorch version computes the r-only
// values once per abscissa as 0-d tensors, in this order, so the table
// gives its bits.
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
// evaluations per RK4 step per bracket per evaluation); it runs on
// bisect.cuh::spec_kernel over SpecChain, with either exterior: the
// producers compute the r-only entries of a stage once per block into a
// table, as the scan does, and each bracket's (1/F, g) from them; one
// consumer lane per bracket (2^L on a small batch, which speculates L
// levels a round) runs the serial two-basis update in this file's order
// (interface1, rk4_step2, finish with the inlined K_m ratio or the numeric
// exterior), so its (root, mismatch) are bit-equal to the launch loop's.
//
// The twisted tubes (rotational flow v_phi, magnetic twist B_phi) have
// kernels of their own (cylinder_twisted.cu), which this file's scan entries
// call when CylDispParams::twisted is set; the code both share is in
// cylinder.cuh.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "bisect.cuh"
#include "common.cuh"
#include "cylinder.cuh"

namespace eigk {

// D, A, C2 of the Hain-Lust chain at the radius of q (cylinder.py:110-168
// with v_phi == B_phi == 0): the part that depends on omega
template <class T>
__device__ __forceinline__ void hain_lust(const RPoint<T>& q,
                                          const RowPoint<T>& w, T omega, T& D,
                                          T& A, T& C2) {
  const T shift = omega - w.kU;             // omega - m v_phi/r - k U
  const T s2 = shift * shift;
  const T da = s2 - w.alf2;
  const T dc = s2 - w.cusp2;
  D = q.rho_csum * da * dc;
  A = q.rho * da;                           // + r dC3diff/dr == 0
  C2 = s2 * s2 - w.X * dc;
}

// invF_g (cylinder.py:189-208): (1/F, g) at the radius of q; on the log
// tail (kLog) the coefficients in t = ln r, (r iF, r g) (cylinder.py:273-279)
template <class T, bool kLog>
__device__ __forceinline__ void invF_g(const RPoint<T>& q,
                                       const RowPoint<T>& w, T omega, T& iF,
                                       T& g) {
  T D, A, C2;
  hain_lust(q, w, omega, D, A, C2);
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

// interface chain at r = 1: C3(1) and F(1) = r D / C3
template <class T>
__device__ __forceinline__ void interface1(const CylDispParams& p,
                                           const Cand<T>& c, T& C3_1, T& F1) {
  const T one = T(1);
  const RPoint<T> q = r_point(p, one);
  T D1, A1, C2_1;
  hain_lust(q, row_point(q, c), c.omega, D1, A1, C2_1);
  C3_1 = D1 * A1 + T(0);
  F1 = one * D1 / C3_1;
}

// What the end of the shoot reads from r = 1: (C3(1), F(1) = r D / C3),
// from which xi_r = zero_over(C3(1)); J = 0
template <class T>
struct Iface {
  T C3_1, F1;
};

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

// Rows of the scan's row table: a block tables the (k, m) rows of its
// first and of its last candidate. A ladder row is a run of n_omega
// candidates that share (k, m) (search.py flattens the scan as (rows,
// n_omega)); where n_omega is at least the block, a block spans at most
// two rows, and the table covers every candidate of it.
constexpr int kRows = 2;

// bitwise equality: a candidate is in a tabled row when its (k, m) have
// the row's bits, so that the row's values are the ones it would compute
template <class T>
__device__ __forceinline__ bool same_bits(T a, T b) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(a) == __float_as_uint(b);
  } else {
    return __double_as_longlong(a) == __double_as_longlong(b);
  }
}

// The scan's tables in the block's dynamic shared memory, double-buffered
// by chunk: 2 x 3 C r-only entries, then 2 x kRows x 3 C row entries
template <class T>
__host__ __device__ constexpr size_t scan_smem(int chunk) {
  return 2 * 3 * static_cast<size_t>(chunk)
       * (sizeof(RPoint<T>) + kRows * sizeof(RowPoint<T>));
}

// The block fills the table entries of a chunk, 3 per step (A, M, B), one
// abscissa per thread at a time: its r-only entry and, from it, its entry
// in the first row and, where the block has two, in the second (`slot`
// further), unless no warp reads them (!rows); km: the rows' (k, m), in
// shared memory (not held in registers across the scan's steps).
template <class T>
__device__ __forceinline__ void fill_chunk(const CylDispParams& p,
                                           const Grid<T>& g, const Chunk& ch,
                                           const T* km, bool rows, bool two,
                                           int slot, RPoint<T>* dst,
                                           RowPoint<T>* wdst) {
  const Cand<T> r0(p, T(0), km[0], km[1]), r1(p, T(0), km[2], km[3]);
  for (int e = threadIdx.x; e < 3 * ch.count; e += blockDim.x) {
    const int i = ch.i0 + e / 3, a = e % 3;
    const RPoint<T> q =
        ch.log ? r_point(p, radius<T, true>(
                                rk4_abscissa(g.x0l, g.hl, g.hhl, i, a)))
               : r_point(p, rk4_abscissa(g.x0i, g.hi, g.hhi, i, a));
    dst[e] = q;
    if (rows) {
      wdst[e] = row_point(q, r0);
      if (two) wdst[slot + e] = row_point(q, r1);
    }
  }
}

// A candidate's RK4 steps over one chunk of the tables: with kTab its
// row's entries w, else (w unused) its own from the r-only entries q
template <class T, bool kLog, bool kTab>
__device__ __forceinline__ void run_chunk(const RPoint<T>* q,
                                          const RowPoint<T>* w, int count,
                                          T h, T hh, T h6, const Cand<T>& c,
                                          T& P1, T& w1, T& P2, T& w2) {
  for (int j = 0; j < count; ++j, q += 3) {
    RowPoint<T> wA, wM, wB;
    if constexpr (kTab) {
      wA = w[3 * j];
      wM = w[3 * j + 1];
      wB = w[3 * j + 2];
    } else {
      wA = row_point(q[0], c);
      wM = row_point(q[1], c);
      wB = row_point(q[2], c);
    }
    T iFA, gA, iFM, gM, iFB, gB;
    invF_g<T, kLog>(q[0], wA, c.omega, iFA, gA);
    invF_g<T, kLog>(q[1], wM, c.omega, iFM, gM);
    invF_g<T, kLog>(q[2], wB, c.omega, iFB, gB);
    rk4_step2(h, hh, h6, iFA, gA, iFM, gM, iFB, gB, P1, w1, P2, w2);
  }
}

// run_chunk through the row table where w is set, else through the
// candidate's own values
template <class T, bool kLog>
__device__ __forceinline__ void run_chunk_any(const RPoint<T>* q,
                                              const RowPoint<T>* w, int count,
                                              T h, T hh, T h6,
                                              const Cand<T>& c, T& P1, T& w1,
                                              T& P2, T& w2) {
  if (w != nullptr) {
    run_chunk<T, kLog, true>(q, w, count, h, hh, h6, c, P1, w1, P2, w2);
  } else {
    run_chunk<T, kLog, false>(q, w, count, h, hh, h6, c, P1, w1, P2, w2);
  }
}

// Candidates that the scans evaluated through a tabled row, and through
// tabled exterior exps, since the host last read them
// (eigk_cylinder_scan_tabled); a block adds its count once
__device__ unsigned long long g_scan_tabled[2];

// The numeric exterior of the scan (common.cuh::cyl_exterior, operation
// for operation), with exp(2 t) read from a table of the block for the
// distinct k of its tabled rows (k0 and, with two, k1; ek the candidate's,
// -1 where its k, or a lane's of its warp, is neither): the block fills
// exp(2 t) at the 3 abscissae of ec steps of each tabled k at a time into
// `tab`, where no table of the interior is live any more. Every thread of
// the block calls it (it holds the block's barriers); `counted`: the
// candidate is one of the batch's.
template <class T>
__device__ T cyl_exterior_scan(const CylDispParams& p, T m_e, T k, T m, T k0,
                               T k1, bool two, int ek, int ec, T* tab,
                               bool counted) {
  const int n = p.n_exterior;
  const double W = p.exterior_wavelengths;
  T r_far, t0, h, hh, h6;
  cyl_ext_grid(k, W, n, r_far, t0, h, hh, h6);
  // the tabled ks' grids, for the fill
  T rf0, t00, h0, hh0, h60, rf1, t01, h1, hh1, h61;
  cyl_ext_grid(k0, W, n, rf0, t00, h0, hh0, h60);
  cyl_ext_grid(k1, W, n, rf1, t01, h1, hh1, h61);
  const T mm = m * m;
  T P = T(1e-8), D = T(-1e-8) * r_far;
  // a warp takes one path; a block none of whose warps reads the table
  // does not fill it
  if (!__all_sync(0xffffffffu, ek >= 0)) ek = -1;
  const int n_tabled = __syncthreads_count(ek >= 0 && counted);
  if (threadIdx.x == 0 && n_tabled) {
    atomicAdd(&g_scan_tabled[1], static_cast<unsigned long long>(n_tabled));
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
  return D / P;
}

// The ladder scan: one thread per candidate, kThreads per block, chunks of
// `chunk` steps of two tables in dynamic shared memory (scan_smem): the
// r-only values, and the (k, m, r) values of the block's kRows rows
// (its first and last candidates'). A warp whose candidates are all in
// tabled rows reads their (k, m, r) values; any other (a batch whose rows
// are shorter than a block, random draws, refine windows) forms its own
// from the r-only table, with the same operations, so the bits do not
// depend on the path. The
// exterior: the K_m ratio or, with kNum, the numeric one, whose exps the
// block tables for the k of its rows once the interior is done. Threads
// past n evaluate a copy of the last candidate, so that every thread
// reaches the block's barriers, and store nothing.
template <class T, int kThreads, bool kNum>
__global__ void __launch_bounds__(kThreads)
cylinder_disp_kernel(const T* __restrict__ omega_, const T* __restrict__ k_,
                     const T* __restrict__ m_, T* __restrict__ det_,
                     T* __restrict__ mism_, bool* __restrict__ valid_,
                     int64_t n, int chunk,
                     const __grid_constant__ CylDispParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T row_km[2 * kRows];           // the rows' (k, m)
  const int slot = 3 * chunk;
  RPoint<T>* table = reinterpret_cast<RPoint<T>*>(smem_raw);
  RowPoint<T>* wtable = reinterpret_cast<RowPoint<T>*>(table + 2 * slot);
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t i = b0 + threadIdx.x;
  const int64_t idx = i < n ? i : n - 1;
  const Cand<T> c(p, omega_[idx], k_[idx], m_[idx]);
  const Grid<T> g(p);

  // the block's rows, its first and last candidates' (k, m) (two unless
  // they are one), and the candidate's (-1: neither, or a lane of its warp
  // in neither: a warp takes one path, so that a batch of short rows does
  // not run both in its warps)
  const int64_t end = b0 + kThreads;
  const int64_t last = (end < n ? end : n) - 1;
  const T k0 = k_[b0], m0 = m_[b0], k1 = k_[last], m1 = m_[last];
  const bool two = !(same_bits(k1, k0) && same_bits(m1, m0));
  int row = same_bits(c.k, k0) && same_bits(c.m, m0)         ? 0
          : two && same_bits(c.k, k1) && same_bits(c.m, m1) ? 1
                                                             : -1;
  if (!__all_sync(0xffffffffu, row >= 0)) row = -1;
  if (threadIdx.x == 0) {
    row_km[0] = k0;
    row_km[1] = m0;
    row_km[2] = k1;
    row_km[3] = m1;
  }
  // publishes row_km; a block none of whose warps reads the row table
  // does not fill it
  const int n_tabled = __syncthreads_count(row >= 0 && i < n);
  const bool fill_rows = __syncthreads_or(row >= 0);
  if (threadIdx.x == 0 && n_tabled) {
    atomicAdd(&g_scan_tabled[0], static_cast<unsigned long long>(n_tabled));
  }

  Iface<T> f;
  interface1(p, c, f.C3_1, f.F1);

  // u1: P(1)=1, P'(1)=0  |  u2: P(1)=0, P'(1)=1  (w = F P')
  T P1 = T(1), w1 = T(0), P2 = T(0), w2 = f.F1 * T(1);
  const int nci = (g.n_int + chunk - 1) / chunk;
  const int n_chunks = nci + (g.n_log + chunk - 1) / chunk;
  if (n_chunks > 0) {
    fill_chunk<T>(p, g, chunk_at(g, nci, chunk, 0), row_km, fill_rows, two,
                  slot, table, wtable);
  }
  __syncthreads();
  for (int ci = 0; ci < n_chunks; ++ci) {
    // fill the other buffer while this one is read: the barrier below
    // publishes it and retires this one
    const int nb = (ci + 1) & 1, cb = ci & 1;
    if (ci + 1 < n_chunks) {
      fill_chunk<T>(p, g, chunk_at(g, nci, chunk, ci + 1), row_km,
                    fill_rows, two, slot, table + nb * slot,
                    wtable + nb * kRows * slot);
    }
    const Chunk ch = chunk_at(g, nci, chunk, ci);
    const RPoint<T>* q = table + cb * slot;
    const RowPoint<T>* w =
        row >= 0 ? wtable + (cb * kRows + row) * slot : nullptr;
    if (ch.log) {
      run_chunk_any<T, true>(q, w, ch.count, g.hl, g.hhl, g.h6l, c, P1, w1,
                             P2, w2);
    } else {
      run_chunk_any<T, false>(q, w, ch.count, g.hi, g.hhi, g.h6i, c, P1, w1,
                              P2, w2);
    }
    __syncthreads();
  }
  T det, mism;
  bool valid;
  const T xi1 = zero_over(f.C3_1) + T(0);
  if constexpr (kNum) {
    // the exterior's table: the distinct k of the rows (ek the
    // candidate's), in the smem that the interior's tables leave (the
    // loop's last barrier retired them)
    const T ka = row_km[0], kb = row_km[2];
    const bool two_k = !same_bits(kb, ka);
    const int ek = same_bits(c.k, ka) ? 0 : two_k && same_bits(c.k, kb) ? 1
                                                                        : -1;
    const int ec =
        static_cast<int>(scan_smem<T>(chunk) / (kRows * 3 * sizeof(T)));
    const auto ext = [&](T m_e) {
      return cyl_exterior_scan(p, m_e, c.k, c.m, ka, kb, two_k, ek, ec,
                               reinterpret_cast<T*>(smem_raw), i < n);
    };
    finish_with(p, c.omega, c.k, c.m, xi1, f.F1, T(0), P1, w1, P2, w2, ext,
                det, mism, valid);
  } else {
    finish<T, false>(p, c.omega, c.k, c.m, xi1, f.F1, T(0), P1, w1, P2, w2,
                     det, mism, valid);
  }
  if (i < n) {
    det_[i] = det;
    mism_[i] = mism;
    valid_[i] = valid;
  }
}

// The chain as bisect.cuh::spec_kernel runs it, with the exterior of kNum
// (the K_m ratio or the numeric one): steps 0 .. n_interior - 1 in r from
// 1 to eps, then the log tail in t = ln r; the producers compute an
// abscissa's r-only entry (r_point; on the log tail at r = exp(t)) once per
// block and each column's (1/F, g) from it (invF_g), the consumer runs
// interface1 / rk4_step2 / finish, the exterior included, in the scan's
// order, so every value is the scan's.
template <class T_, bool kNum>
struct SpecChain {
  using T = T_;
  using Params = CylDispParams;
  using Entry = RPoint<T>;
  static constexpr int kState = 4;  // (P1, w1, P2, w2)
  using Ctx = Iface<T>;
  const Params& p;
  Grid<T> g;

  __device__ explicit SpecChain(const Params& p_) : p(p_), g(p_) {}
  __device__ int n_steps() const { return g.n_int + g.n_log; }
  __device__ Entry entry(int i, int a) const {
    if (i < g.n_int) {
      return r_point(p, rk4_abscissa(g.x0i, g.hi, g.hhi, i, a));
    }
    return r_point(p, radius<T, true>(
                          rk4_abscissa(g.x0l, g.hl, g.hhl, i - g.n_int, a)));
  }
  __device__ void coef(int i, const Entry& q, T omega, T k, T m, T& c0,
                       T& c1) const {
    const RowPoint<T> w = row_point(q, Cand<T>(p, omega, k, m));
    if (i < g.n_int) {
      invF_g<T, false>(q, w, omega, c0, c1);
    } else {
      invF_g<T, true>(q, w, omega, c0, c1);
    }
  }
  __device__ void start(T omega, T k, T m, T* y, Ctx& ctx) const {
    interface1(p, Cand<T>(p, omega, k, m), ctx.C3_1, ctx.F1);
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
                         T& mism, bool& valid) const {
    eigk::finish<T, kNum>(p, omega, k, m, zero_over(ctx.C3_1) + T(0), ctx.F1,
                          T(0), y[0], y[1], y[2], y[3], det, mism, valid);
  }
};

template <class T, int kThreads, bool kNum>
cudaError_t launch_scan(const void* omega, const void* k, const void* m,
                        void* det, void* mism, void* valid, long long n,
                        int chunk, size_t smem, const CylDispParams* p,
                        cudaStream_t stream) {
  auto* kern = cylinder_disp_kernel<T, kThreads, kNum>;
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

// The scan's launch at `threads` a block (128, 256 or 512; the numeric
// exterior's at 256 only, kernels/cylinder.py::SCAN_SHAPE)
template <class T, bool kNum>
cudaError_t launch_scan_threads(const void* omega, const void* k,
                                const void* m, void* det, void* mism,
                                void* valid, long long n, int threads,
                                int chunk, size_t smem, const CylDispParams* p,
                                cudaStream_t s) {
  if constexpr (kNum) {
    return threads == 256
               ? launch_scan<T, 256, true>(omega, k, m, det, mism, valid, n,
                                           chunk, smem, p, s)
               : cudaErrorInvalidValue;
  } else {
    switch (threads) {
      case 128:
        return launch_scan<T, 128, false>(omega, k, m, det, mism, valid, n,
                                          chunk, smem, p, s);
      case 256:
        return launch_scan<T, 256, false>(omega, k, m, det, mism, valid, n,
                                          chunk, smem, p, s);
      case 512:
        return launch_scan<T, 512, false>(omega, k, m, det, mism, valid, n,
                                          chunk, smem, p, s);
      default:
        return cudaErrorInvalidValue;
    }
  }
}

// The scan over the exterior that p names
template <class T>
int launch_scan_any(const void* omega, const void* k, const void* m,
                    void* det, void* mism, void* valid, long long n,
                    int threads, int chunk, const CylDispParams* p,
                    cudaStream_t s) {
  const size_t smem = scan_smem<T>(chunk);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      p->exterior_numeric
          ? launch_scan_threads<T, true>(omega, k, m, det, mism, valid, n,
                                         threads, chunk, smem, p, s)
          : launch_scan_threads<T, false>(omega, k, m, det, mism, valid, n,
                                          threads, chunk, smem, p, s));
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
             ? launch_cylinder_tw<T>(omega, k, m, det, mism, valid, n, threads,
                                     chunk, p, s)
             : launch_scan_any<T>(omega, k, m, det, mism, valid, n, threads,
                                  chunk, p, s);
}

// The fused bisection of n brackets over the density/axial-flow chain
// (bisect.cuh::launch_spec over SpecChain) with the exterior that p names;
// the K_m ratio's at float64 only at 128 registers a thread, where
// kernels/common.py::analytic_spec_shape launches it (64 spill its chain).
// The twisted chain's is cylinder_twisted.cu's.
template <class T>
int launch_cylinder_bisect(const void* lo, const void* hi, const void* k,
                           const void* m, void* root, void* mism, long long n,
                           int n_iter, int final_eval, int B, int L, int P,
                           int C, int S, int min_blocks,
                           const CylDispParams* p, int device, void* stream) {
  if (p->twisted) return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool kF32 = std::is_same<T, float>::value;
  auto* launch = p->exterior_numeric ? launch_spec<SpecChain<T, true>>
                                     : launch_spec<SpecChain<T, false>, kF32>;
  return launch(lo, hi, k, m, root, mism, nullptr, n, n_iter, final_eval, 0,
                B, L, P, C, S, min_blocks, p, device, stream);
}

}  // namespace eigk

extern "C" {

// Each scan entry returns the cudaError_t of the launch (0 on success);
// n > 0; threads 128, 256 or 512 a block, chunks of `chunk` table steps.
// Both entries run the twisted chain when p->twisted is set (then with
// log_tail = 0 and 128 threads a block), the plain one otherwise.
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

// Fused bisection of n brackets (lo, hi, k, m) over the density/axial-flow
// chain with the exterior that p names (the K_m ratio or the numeric one):
// root, and the % mismatch at the root when final_eval (mism may be null
// otherwise); B brackets a block, L levels a round on 2^L lanes a bracket
// (B 2^L <= 32; 0 the loop's schedule), P producer warps, C steps per
// stage, S stages, the register budget of min_blocks blocks of 512 threads
// per SM (0: chosen at launch). The twisted chain's is
// eigk_cylinder_spec_* (cylinder_twisted.cu).
int eigk_cylinder_bisect_spec_f32(const void* lo, const void* hi,
                                  const void* k, const void* m, void* root,
                                  void* mism, long long n, int n_iter,
                                  int final_eval, int B, int L, int P, int C,
                                  int S, int min_blocks,
                                  const eigk::CylDispParams* p, int device,
                                  void* stream) {
  return eigk::launch_cylinder_bisect<float>(lo, hi, k, m, root, mism, n,
                                             n_iter, final_eval, B, L, P, C,
                                             S, min_blocks, p, device, stream);
}

int eigk_cylinder_bisect_spec_f64(const void* lo, const void* hi,
                                  const void* k, const void* m, void* root,
                                  void* mism, long long n, int n_iter,
                                  int final_eval, int B, int L, int P, int C,
                                  int S, int min_blocks,
                                  const eigk::CylDispParams* p, int device,
                                  void* stream) {
  return eigk::launch_cylinder_bisect<double>(lo, hi, k, m, root, mism, n,
                                              n_iter, final_eval, B, L, P, C,
                                              S, min_blocks, p, device,
                                              stream);
}

// The scans' tabled counts on `device` since the last read: out[0] the
// candidates evaluated through a tabled row, out[1] those whose exterior
// read the tabled exps (g_scan_tabled); then zeroes them. Waits for the
// device's work. Returns the cudaError_t.
int eigk_cylinder_scan_tabled(int device, unsigned long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(out, eigk::g_scan_tabled,
                               sizeof(eigk::g_scan_tabled));
  }
  if (err == cudaSuccess) {
    const unsigned long long zero[2] = {0, 0};
    err = cudaMemcpyToSymbol(eigk::g_scan_tabled, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}

// scan_smem: the bytes of the density/axial-flow scan's tables at
// `chunk` steps (f64: double, else float), for the Python mirror's check
long long eigk_cylinder_scan_smem(int f64, int chunk) {
  return static_cast<long long>(f64 ? eigk::scan_smem<double>(chunk)
                                    : eigk::scan_smem<float>(chunk));
}

// sizeof(CylDispParams), for the Python mirror's layout check
long long eigk_cylinder_params_size() {
  return static_cast<long long>(sizeof(eigk::CylDispParams));
}

}  // extern "C"
