// Fused bracket stage: the whole fixed-count bisection of a batch of
// brackets in one launch (spec_kernel), over the chain of a Model: the
// slab's (slab_disp.cu, slab_bisect), the density/axial-flow cylinder's
// (cylinder_disp.cu, cylinder_bisect) and the twisted cylinder's
// (cylinder_twisted.cu, which also evaluates its small batches with it),
// each with the exact or the numeric exterior.
//
// Port of `eigensolver_tpu/search.py::bisect` (search.py:142-169) and of the
// bisection half of `refine_on_cpu` (search.py:468-522), over the dispersion
// chains of `physics/slab.py` / `physics/cylinder.py`. On the TPU that was an
// XLA `fori_loop` around the vmapped dispersion; the port first ran it as
// n_iter + 2 launches of the one-thread scan kernels. Per bracket:
//   f(lo) -> lo_neg; n_iter times mid = 0.5 (lo + hi), det(mid),
//   go_right = signbit(det) == lo_neg, select; root = 0.5 (lo + hi);
//   optionally one last evaluation at the root for the % mismatch.
//
// What bounds it on Hopper. One evaluation is an RK4 chain of n_steps
// (slab 2048; cylinder 2048 + a 128-step log tail; twisted 1536) steps.
// Each step is mostly a coefficient chain at 3 abscissae (divisions, square
// roots, exps) that does not depend on the ODE state, and ~15 dependent
// flops of state update. With one thread per bracket a bracket batch of
// 5,040 (slab) or 17,280 (cylinder) fills 1-4 warps per SM, so each launch
// lasts one thread's serial chain of dependent divisions: latency-bound at
// a few percent of the card's issue rate. Bound by operations: 3 chain
// evaluations per step per bracket per evaluation, and the chain's
// x-only / r-only part once per abscissa.
//
// The design: a warp-specialised block serves B brackets on B 2^L columns.
//   Consumer warp (warp 0): lane j carries column j's state in registers
//     and runs the serial update in exactly the scan's order (the same
//     __device__ step function), reading each step's 6 coefficients from
//     shared memory; it also runs the start state, the epilogue (det,
//     mismatch, the exterior), the sign test and the bracket update, and
//     publishes the next omega of each column to shared memory.
//   Producer warps (P of them): per ring stage of C steps, first the
//     x-only / r-only entries of its 3 C abscissae (Model::entry; the
//     scan's table values) once for the block, into a double-buffered table
//     behind the ring (one producer barrier per stage); then each column's
//     chain from them (Model::coef), a step's 3 abscissae per thread at once
//     (3 independent chains in flight), into a ring of S stages in dynamic
//     shared memory, up to S stages ahead of the consumer.
//   Hand-off: named barriers (bar.sync / bar.arrive, which order the shared
//     memory accesses of the threads that take part): per stage a "full"
//     barrier (producers arrive, consumer waits) and an "empty" barrier
//     (consumer arrives, producers wait), and an "omega" barrier per round
//     (consumer arrives, producers wait).
// Optional parts of a Model (SpecOpts; the cylinder's SpecChain has them):
//   a row table: per stage, beside the r-only entries, the producers fill
//     the omega-free (k, m, r) values of each (k, m) row of the block's
//     brackets where they form at most kRows runs of one (k, m) (a
//     batch's rows of 8, 24 or more brackets); every column then reads
//     its row's values, and in any other block (random draws, refine
//     windows) forms its own from the r-only entry with the same
//     operations, so the bits do not depend on the path;
//   kept chains: a producer row group takes a run of consecutive steps of
//     a stage, and keeps a step's first chain from the step before's last
//     where Model::kept(i) says their abscissae have the same bits;
//   the exterior off the consumer's tail: where the exterior depends on
//     (omega, k, m) alone, the producer lanes of the last row group (the
//     one with the fewest steps) integrate each column's exterior for the
//     round's omega while the consumer runs the interior, ceil(n_ext /
//     n_stages) steps a stage, their abscissae's values (exps) from a
//     table of the block's distinct k that they fill; the result is
//     published before the round's last "full" barrier and the
//     consumer's finish reads it.
// Shared memory holds the 32 omegas, the ring (C x 6 x B 2^L values per
// stage) and the tables; registers hold the state; no tensor cores and no
// TMA (no matrix product, and a bracket's input is 4 scalars). B, L, P, C
// and S are launch arguments, chosen by the wrapper
// (kernels/common.py::spec_shape and its tuned neighbours). The register
// budget is 128 registers a thread (1 block of 512 threads per SM) or 64
// (2), each an instantiation; chosen by the wrapper, or at launch from the
// card's occupancy: the wider where the whole batch is resident on the card
// at once with it (a small batch, whose serial consumer chain sets the
// pace), else the narrower (a batch of several waves, where the producers'
// throughput does). The entries and coefficients are the scan's values and
// the update is its code, built with --fmad=false, so (root, mismatch) are
// bit-equal to the loop of scan launches, and so to the plain PyTorch
// version.
#pragma once

#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include <cuda_runtime.h>

#include "common.cuh"

namespace eigk {

// 1 consumer + up to 15 producer warps
constexpr int kBisectMaxThreads = 512;
constexpr int kBisectMaxStages = 6;     // barrier ids 1 + 2 S <= 15

namespace bar {
constexpr int kOmega = 1;  // next omega of every bracket published
constexpr int kFull = 2;   // + slot: stage written; kFull + S + slot: stage read
constexpr int kTable = 15;  // producers: the stage's table written

// bar.sync / bar.arrive without .aligned: every thread of the block takes
// part; the memory clobber keeps shared memory accesses on their side
__device__ __forceinline__ void sync(int id, int n) {
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void arrive(int id, int n) {
  asm volatile("barrier.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
}  // namespace bar

// Model: the dispersion chain of one geometry, with
//   T, Params, kState, Ctx (per-evaluation values of the consumer), Entry
//   (the x-only / r-only values at one abscissa);
//   Model(p); n_steps(); entry(i, a): the entry at abscissa a of step i;
//   coef(i, entry, omega, k, mode, c0, c1): a column's chain there;
//   start(omega, k, mode, y, ctx); step(i, c, stride, y) with the step's 6
//   coefficients at c[0], c[stride], ..., c[5 stride];
//   finish(omega, k, mode, y, ctx, det, mismatch, valid).
//
// Speculation. The next L levels of a bisection have 2^L - 1 possible
// midpoints, each formed from (lo, hi) as the loop forms it (mid = 0.5 (lo
// + hi) along the path of go_right decisions), and the loop's sign test
// compares each with the one sign of f(lo). So a round evaluates all of
// them at once and the walk down the tree then takes the same midpoints and
// root bits as L iterations of the loop. A bracket takes G = 2^L consumer
// lanes: lane 1 .. 2^d - 1 the nodes of the round's d <= L levels in heap
// order (node n's children 2n, 2n + 1), lane 0 f(lo) in the first round
// (idle after); B brackets a block, so B G <= 32 columns, each fed by the
// producers alike. The residual at the root is one more level (the root is
// the midpoint of the last interval), so n_iter + 1 levels take
// ceil((n_iter + 1) / L) rounds. Lanes read the signs of their group's
// nodes with warp shuffles. L = 0 is the loop's own schedule on one lane a
// bracket: f(lo) in a round of its own, then one level a round (the
// speculation's extra work does not pay where the producers, not the
// serial chain, set the pace: a large batch).
//
// Evaluation mode (eval, L = 0): each column is a candidate (omega = lo),
// one round; out0 = det, out1 = mismatch, valid. A batch too small to fill
// the card with one thread per candidate takes this instead of the scan.

// Byte offset of the x-only / r-only table in a block's shared memory
// (after the 32 omegas and the ring), 16-byte aligned
template <class T>
__host__ __device__ __forceinline__ size_t spec_table_offset(int NC, int C,
                                                            int S) {
  const size_t ring = (32 + static_cast<size_t>(S) * C * 6 * NC) * sizeof(T);
  return (ring + 15) / 16 * 16;
}

// The optional parts of a Model (see the note above): kRows > 0 names a
// Model with a row table (Model::Row, row, coef_row), kept chains
// (Model::kept) and, with kSideExt, the exterior off the consumer's tail
// (Model::ExtK, ExtState, n_ext, ext_k, ext_exp, ext_start, ext_step,
// ext_end, finish_side) and the kernel's counts (Model::counts)
template <class M, class = void>
struct SpecOpts {
  static constexpr int rows = 0;
  static constexpr bool side_ext = false;
  using Row = char;
  using ExtK = char;
  using ExtState = char;
};
template <class M>
struct SpecOpts<M, std::void_t<decltype(M::kRows)>> {
  static constexpr int rows = M::kRows;
  static constexpr bool side_ext = M::kSideExt;
  using Row = typename M::Row;
  using ExtK = typename M::ExtK;
  using ExtState = typename M::ExtState;
};

// The dynamic shared memory of a block: the ring, then per abscissa of
// the double-buffered stage the entry, a Row a tabled row and, with the
// exterior off the tail, a value (exp) a tabled k
template <class Model>
__host__ __device__ __forceinline__ size_t spec_smem(int NC, int C, int S) {
  using T = typename Model::T;
  using O = SpecOpts<Model>;
  const size_t per = sizeof(typename Model::Entry)
                   + O::rows * (sizeof(typename O::Row)
                                + (O::side_ext ? sizeof(T) : 0));
  return spec_table_offset<T>(NC, C, S) + 2 * 3 * static_cast<size_t>(C) * per;
}

// A block's rows (static shared memory of the Models with a row table):
// each row's (k, m) and the index of its k among the distinct ones (kd),
// a row of each distinct k (kr) and, with the exterior off the tail, that
// k's exterior grid (Model::ext_k); the rows (0: the block's columns form
// their own values) and the distinct k; each column's exterior as the
// producers publish it
template <class Model>
struct BlockRows {
  using T = typename Model::T;
  static constexpr int R = Model::kRows;
  T k[R], m[R];
  int kd[R], kr[R];
  typename Model::ExtK grid[R];
  int n, nk;
  T ext[32];
};

template <class Model>
__device__ __forceinline__ BlockRows<Model>& block_rows() {
  __shared__ BlockRows<Model> rows;
  return rows;
}

// The block's rows from its brackets base .. base + B - 1 (clamped to n):
// where their (k, m), compared bit for bit, form at most Model::kRows
// runs, each run a row; else none. Warp 0 calls it; the caller publishes
// it with a barrier.
template <class Model>
__device__ void find_rows(const Model& md, const typename Model::T* k_,
                          const typename Model::T* m_, int64_t base,
                          int64_t n, int B, BlockRows<Model>& br) {
  using T = typename Model::T;
  const int b = threadIdx.x;
  const int64_t ib = base + b < n ? base + b : n - 1;
  const T kb = k_[ib], mb = m_[ib];
  const T kp = __shfl_up_sync(0xffffffffu, kb, 1);
  const T mp = __shfl_up_sync(0xffffffffu, mb, 1);
  const bool start =
      b > 0 && b < B && !(same_bits(kb, kp) && same_bits(mb, mp));
  const unsigned starts = __ballot_sync(0xffffffffu, start);
  const int n_rows = __popc(starts) + 1;
  const bool tabled = n_rows <= Model::kRows;
  if (tabled && b < B && (b == 0 || start)) {
    const int r = __popc(starts & ((2u << b) - 1u));   // this lane's run
    br.k[r] = kb;
    br.m[r] = mb;
  }
  __syncwarp();
  if (b == 0) {
    int nk = 0;
    for (int j = 0; tabled && j < n_rows; ++j) {
      int d = 0;
      while (d < nk && !same_bits(br.k[j], br.k[br.kr[d]])) ++d;
      if (d == nk) br.kr[nk++] = j;
      br.kd[j] = d;
    }
    br.n = tabled ? n_rows : 0;
    br.nk = nk;
  }
  __syncwarp();
  if constexpr (SpecOpts<Model>::side_ext) {
    if (b < br.nk) br.grid[b] = md.ext_k(br.k[br.kr[b]]);
  }
}

template <class Model, int kMinBlocks>
__global__ void __launch_bounds__(kBisectMaxThreads, kMinBlocks)
spec_kernel(const typename Model::T* __restrict__ lo_,
            const typename Model::T* __restrict__ hi_,
            const typename Model::T* __restrict__ k_,
            const typename Model::T* __restrict__ mode_,
            typename Model::T* __restrict__ out0_,
            typename Model::T* __restrict__ out1_, bool* __restrict__ valid_,
            int64_t n, int n_iter, int final_eval, int eval, int B, int L,
            int C, int S, const __grid_constant__ typename Model::Params p) {
  using T = typename Model::T;
  using Entry = typename Model::Entry;
  using Opt = SpecOpts<Model>;
  using Row = typename Opt::Row;
  constexpr int R = Opt::rows;               // 0: no row table
  constexpr bool kSide = Opt::side_ext;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* om_s = reinterpret_cast<T*>(smem_raw);  // [32] omega of each column
  T* ring = om_s + 32;                       // [S][C][6][NC]
  const int G = 1 << L;                      // lanes (columns) a bracket
  const int NC = B << L;                     // columns
  Entry* table = reinterpret_cast<Entry*>(
      smem_raw + spec_table_offset<T>(NC, C, S));  // [2][3 C]
  Row* rtab = reinterpret_cast<Row*>(table + 2 * 3 * C);  // [2][R][3 C]
  T* etab = reinterpret_cast<T*>(rtab + 2 * R * 3 * C);   // [2][R][3 C]
  const int nthr = blockDim.x;
  const int stage_len = C * 6 * NC;
  const Model m(p);
  const int n_steps = m.n_steps();
  const int n_stages = (n_steps + C - 1) / C;
  // tree levels: the n_iter sign levels and the residual's
  const int n_lv = eval ? 1 : n_iter + final_eval;
  const bool need_lo = !eval && n_iter > 0;  // f(lo) only if it is used
  const int n_rounds = eval ? 1
                       : L == 0 ? n_lv + need_lo
                                : (n_lv + L - 1) / L;
  const int total = n_rounds * n_stages;     // ring stages in the launch
  const int64_t base = static_cast<int64_t>(blockIdx.x) * B;
  int n_rows = 0;                            // the block's tabled rows
  if constexpr (R > 0) {
    auto& br = block_rows<Model>();
    if (threadIdx.x < 32) find_rows(m, k_, mode_, base, n, B, br);
    __syncthreads();
    n_rows = br.n;
    if (threadIdx.x == 0 && n_rows) {
      // the launch's columns through the row table (and the exps' table)
      const int64_t left = n - base;
      const auto cols = static_cast<unsigned long long>(
          (left < B ? left : B) << L);
      atomicAdd(&Model::counts()[0], cols);
      if constexpr (kSide) atomicAdd(&Model::counts()[1], cols);
    }
  }

  if (threadIdx.x < 32) {
    // consumer: lane j <-> column j, position j % G of bracket j / G;
    // lanes j >= NC shadow column j % NC
    const int j = threadIdx.x;
    const int col = j % NC;
    const int pos = col & (G - 1);
    const int lane0 = col - pos;             // the bracket's first lane
    const int64_t bi = base + (col >> L);
    const int64_t idx = bi < n ? bi : n - 1;
    T lo = lo_[idx], hi = eval ? lo_[idx] : hi_[idx];
    const T k = k_[idx], md = mode_[idx];
    bool lo_neg = false;
    T det = T(0), mism = T(0);
    bool valid = false;
    int g = 0, done = 0;
    for (int round = 0; round < n_rounds; ++round) {
      const bool lo_round = L == 0 && need_lo && round == 0;  // f(lo) alone
      const int d = eval || lo_round ? 0 : min(max(L, 1), n_lv - done);
      const int node = L > 0 ? pos : (lo_round ? 0 : 1);
      // this lane's point: f(lo) (node 0), or node's midpoint along its
      // path from (lo, hi); nodes past the round's tree evaluate, unread
      T om = lo;
      if (!eval && node > 0) {
        T a = lo, b = hi;
        for (int t = 30 - __clz(node); t >= 0; --t) {
          const T mid = T(0.5) * (a + b);
          if ((node >> t) & 1) {
            a = mid;
          } else {
            b = mid;
          }
        }
        om = T(0.5) * (a + b);
      }
      if (j < NC) om_s[j] = om;
      bar::arrive(bar::kOmega, nthr);
      T y[Model::kState];
      typename Model::Ctx ctx;
      m.start(om, k, md, y, ctx);
      for (int s = 0; s < n_stages; ++s, ++g) {
        const int slot = g % S;
        bar::sync(bar::kFull + slot, nthr);
        const T* st = ring + slot * stage_len + col;
        const int i0 = s * C;
        const int c_end = min(C, n_steps - i0);
#pragma unroll 2
        for (int c = 0; c < c_end; ++c) {
          m.step(i0 + c, st + c * 6 * NC, NC, y);
        }
        if (g < total - S) bar::arrive(bar::kFull + S + slot, nthr);
      }
      T r;
      if constexpr (kSide) {
        // the exterior the producers integrated for this round's omega,
        // published before the last stage's "full" barrier
        m.finish_side(om, k, md, y, ctx, block_rows<Model>().ext[col], det,
                      r, valid);
      } else {
        m.finish(om, k, md, y, ctx, det, r, valid);
      }
      if (eval) {
        mism = r;
        continue;
      }
      // the walk: every lane of the bracket takes its group's decisions
      const int neg = signbit(det) != 0;     // NaN's sign too
      if (round == 0 && need_lo) lo_neg = __shfl_sync(0xffffffffu, neg, lane0);
      int cur = 1;
      for (int t = 0; t < d; ++t) {
        const int src = lane0 + (L > 0 ? cur : 0);   // the node's lane
        const int cneg = __shfl_sync(0xffffffffu, neg, src);
        const T cr = __shfl_sync(0xffffffffu, r, src);
        if (done + t < n_iter) {
          const bool go_right = (cneg != 0) == lo_neg;  // root in [mid, hi]
          const T mid = T(0.5) * (lo + hi);
          lo = go_right ? mid : lo;
          hi = go_right ? hi : mid;
          cur = 2 * cur + (go_right ? 1 : 0);
        } else {
          mism = cr;                         // the residual at the root
        }
      }
      done += d;
    }
    if (j < NC && pos == 0 && bi < n) {
      if (eval) {
        out0_[bi] = det;
        out1_[bi] = mism;
        valid_[bi] = valid;
      } else {
        out0_[bi] = T(0.5) * (lo + hi);
        if (final_eval) out1_[bi] = mism;
      }
    }
  } else {
    // producers: thread t fills column t % NC (NC divides 32 P) of each
    // stage, in row group c0 = t / NC of c_step: the steps c0, c0 +
    // c_step, ... (with a row table: the run of steps c0 spg .. c0 spg +
    // spg - 1), all 3 abscissae of a step at once
    const int t = threadIdx.x - 32;
    const int np = nthr - 32;
    const int col = t % NC;
    const int c0 = t / NC;
    const int c_step = np / NC;
    const int64_t bi = base + (col >> L);
    const int64_t idx = bi < n ? bi : n - 1;
    const T k = k_[idx], md = mode_[idx];
    // the column's row (block-uniform: all or none of them tabled)
    int row = -1;
    if constexpr (R > 0) {
      const auto& br = block_rows<Model>();
      for (int r = n_rows - 1; r >= 0; --r) {
        if (same_bits(k, br.k[r]) && same_bits(md, br.m[r])) row = r;
      }
    }
    // the exterior's lanes: the last row group's (the fewest steps)
    const bool ext_lane = kSide && c0 == c_step - 1;
    int e_per = 0;                           // exterior steps a stage
    unsigned e_mask = 0;                     // the exterior's lanes
    int e_chunk = 0;                         // exps chunks filled
    typename Opt::ExtK e_own{};   // its k's grid
    if constexpr (kSide) {
      e_per = (m.n_ext() + n_stages - 1) / n_stages;
      e_mask = NC == 32 ? 0xffffffffu : ((1u << NC) - 1u) << (32 - NC);
      if (ext_lane) e_own = m.ext_k(k);
    }
    // counts of block 0's first round, per row group: steps, kept chains
    int n_own = 0, n_kept = 0;
    int g = 0;
    for (int round = 0; round < n_rounds; ++round) {
      bar::sync(bar::kOmega, nthr);
      const T om = om_s[col];
      typename Opt::ExtState es{};
      if constexpr (kSide) {
        if (ext_lane) m.ext_start(om, k, md, e_own, es);
      }
      for (int s = 0; s < n_stages; ++s, ++g) {
        const int slot = g % S;
        const int i0 = s * C;
        const int c_end = min(C, n_steps - i0);
        Entry* tb = table + (g & 1) * 3 * C;
        // written while the consumer reads earlier stages; the buffer's
        // readers of stage g - 2 passed stage g - 1's barrier
        for (int e = t; e < 3 * c_end; e += np) {
          tb[e] = m.entry(i0 + e / 3, e % 3);
        }
        Row* rb = rtab + (g & 1) * R * 3 * C;
        if constexpr (R > 0) {
          if (n_rows) {
            // each row's values from the stage's entries
            const auto& br = block_rows<Model>();
            bar::sync(bar::kTable, np);
            const int per = 3 * c_end;
            for (int e = t; e < n_rows * per; e += np) {
              const int r = e / per, f = e - r * per;
              rb[r * 3 * C + f] = m.row(tb[f], br.k[r], br.m[r]);
            }
          }
        }
        bar::sync(bar::kTable, np);
        if (g >= S) bar::sync(bar::kFull + S + slot, nthr);
        T* st = ring + slot * stage_len + col;
        if constexpr (R > 0) {
          // the row group's run of steps; a step's first chain kept from
          // the step before's last where their abscissae agree
          const Row* wr = row >= 0 ? rb + row * 3 * C : nullptr;
          const int spg = (C + c_step - 1) / c_step;
          const int cb = c0 * spg;
          const int ce = min(cb + spg, c_end);
          T kept0 = T(0), kept1 = T(0);
          for (int c = cb; c < ce; ++c) {
            const int i = i0 + c;
            T v[6];
            const bool keep = c > cb && m.kept(i);
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              if (a == 0 && keep) {
                v[0] = kept0;
                v[1] = kept1;
              } else if (wr != nullptr) {
                m.coef_row(i, tb[3 * c + a], wr[3 * c + a], om, v[2 * a],
                           v[2 * a + 1]);
              } else {
                m.coef(i, tb[3 * c + a], om, k, md, v[2 * a], v[2 * a + 1]);
              }
            }
            kept0 = v[4];
            kept1 = v[5];
            n_kept += keep;
            T* dst = st + c * 6 * NC;
#pragma unroll
            for (int q = 0; q < 6; ++q) dst[q * NC] = v[q];
          }
          n_own += max(ce - cb, 0);
        } else {
          for (int c = c0; c < c_end; c += c_step) {
            T v[6];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              m.coef(i0 + c, tb[3 * c + a], om, k, md, v[2 * a],
                     v[2 * a + 1]);
            }
            T* dst = st + c * 6 * NC;
#pragma unroll
            for (int q = 0; q < 6; ++q) dst[q * NC] = v[q];
          }
        }
        if constexpr (kSide) {
          if (ext_lane) {
            // this stage's exterior steps, the exps of a tabled block's
            // distinct k from a double-buffered table that the lanes fill
            // a chunk of at most C steps at a time
            auto& br = block_rows<Model>();
            const int lane = t - (np - NC);
            const int j1 = min((s + 1) * e_per, m.n_ext());
            for (int j0 = s * e_per; j0 < j1; j0 += C) {
              const int cnt = min(C, j1 - j0);
              if (n_rows) {
                T* eb = etab + (e_chunk++ & 1) * R * 3 * C;
                for (int e = lane; e < br.nk * 3 * cnt; e += NC) {
                  const int dk = e / (3 * cnt), f = e - dk * 3 * cnt;
                  eb[dk * 3 * C + f] =
                      m.ext_exp(br.grid[dk], j0 + f / 3, f % 3);
                }
                __syncwarp(e_mask);
                const T* E = eb + br.kd[row] * 3 * C;
                for (int q = 0; q < cnt; ++q, E += 3) {
                  m.ext_step(es, e_own, E[0], E[1], E[2]);
                }
              } else {
                for (int q = j0; q < j0 + cnt; ++q) {
                  m.ext_step(es, e_own, m.ext_exp(e_own, q, 0),
                             m.ext_exp(e_own, q, 1), m.ext_exp(e_own, q, 2));
                }
              }
            }
            if (s == n_stages - 1) br.ext[col] = m.ext_end(es);
          }
        }
        bar::arrive(bar::kFull + slot, nthr);
      }
      if constexpr (R > 0) {
        if (round == 0 && blockIdx.x == 0 && col == 0) {
          atomicAdd(&Model::counts()[2],
                    static_cast<unsigned long long>(n_kept));
          atomicAdd(&Model::counts()[3],
                    static_cast<unsigned long long>(n_own));
        }
      }
    }
  }
}

// Launch the speculative fused bisection (eval = 0: n brackets, L levels a
// round, 0 the loop's schedule) or the fused evaluation (eval = 1, L = 0:
// n candidates lo, det to out0, mismatch to out1, valid) with B brackets
// (candidates) a block, P producer warps, C steps per stage, S stages and
// the register budget of min_blocks (1 or 2; 0: the wider if every block
// is resident at once with it, else the narrower). kNarrow: whether the
// 64-register instantiation is built (else min_blocks 2 is refused and 0
// takes the wider). Returns the cudaError_t.
template <class Model, bool kNarrow = true>
int launch_spec(const void* lo, const void* hi, const void* k,
                const void* mode, void* out0, void* out1, void* valid,
                long long n, int n_iter, int final_eval, int eval, int B,
                int L, int P, int C, int S, int min_blocks,
                const typename Model::Params* p, int device, void* stream) {
  using T = typename Model::T;
  if (n <= 0 || n_iter < 0 || B < 1 || B > 32 || 32 % B != 0 || L < 0
      || L > 5 || (B << L) > 32 || (eval && L != 0) || P < 1
      || 32 * (P + 1) > kBisectMaxThreads || C < 1 || S < 1
      || S > kBisectMaxStages || min_blocks < 0 || min_blocks > 2
      || (!kNarrow && min_blocks == 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 32 * (P + 1);
  const long long blocks = (n + B - 1) / B;
  const size_t smem = spec_smem<Model>(B << L, C, S);
  auto* wide = spec_kernel<Model, 1>;    // up to 128 registers a thread
  decltype(wide) narrow = nullptr;       // up to 64
  if constexpr (kNarrow) narrow = spec_kernel<Model, 2>;
  if (smem > 48 * 1024) {
    for (auto* kern : {wide, narrow}) {
      if (kern == nullptr) continue;
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (min_blocks == 0 && !kNarrow) min_blocks = 1;
  if (min_blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wide, threads,
                                                        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    min_blocks = blocks <= static_cast<long long>(sms) * per_sm ? 1 : 2;
  }
  auto* kern = min_blocks == 1 ? wide : narrow;
  kern<<<static_cast<unsigned>(blocks), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(lo), static_cast<const T*>(hi),
      static_cast<const T*>(k), static_cast<const T*>(mode),
      static_cast<T*>(out0), static_cast<T*>(out1), static_cast<bool*>(valid),
      n, n_iter, final_eval, eval, B, L, C, S, *p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace eigk
