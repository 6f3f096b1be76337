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
// Shared memory holds the 32 omegas, the ring (C x 6 x B 2^L values per
// stage) and the table; registers hold the state; no tensor cores and no
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

#include <cuda_runtime.h>

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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* om_s = reinterpret_cast<T*>(smem_raw);  // [32] omega of each column
  T* ring = om_s + 32;                       // [S][C][6][NC]
  const int G = 1 << L;                      // lanes (columns) a bracket
  const int NC = B << L;                     // columns
  Entry* table = reinterpret_cast<Entry*>(
      smem_raw + spec_table_offset<T>(NC, C, S));  // [2][3 C]
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
        for (int c = 0; c < c_end; ++c) m.step(i0 + c, st + c * 6 * NC, NC, y);
        if (g < total - S) bar::arrive(bar::kFull + S + slot, nthr);
      }
      T r;
      m.finish(om, k, md, y, ctx, det, r, valid);
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
    // stage, the steps c = t / NC, t / NC + 32 P / NC, ..., all 3 abscissae
    // of a step at once
    const int t = threadIdx.x - 32;
    const int np = nthr - 32;
    const int col = t % NC;
    const int c0 = t / NC;
    const int c_step = np / NC;
    const int64_t bi = base + (col >> L);
    const int64_t idx = bi < n ? bi : n - 1;
    const T k = k_[idx], md = mode_[idx];
    int g = 0;
    for (int round = 0; round < n_rounds; ++round) {
      bar::sync(bar::kOmega, nthr);
      const T om = om_s[col];
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
        bar::sync(bar::kTable, np);
        if (g >= S) bar::sync(bar::kFull + S + slot, nthr);
        T* st = ring + slot * stage_len + col;
        for (int c = c0; c < c_end; c += c_step) {
          T v[6];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            m.coef(i0 + c, tb[3 * c + a], om, k, md, v[2 * a], v[2 * a + 1]);
          }
          T* dst = st + c * 6 * NC;
#pragma unroll
          for (int q = 0; q < 6; ++q) dst[q * NC] = v[q];
        }
        bar::arrive(bar::kFull + slot, nthr);
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
  const size_t smem =
      spec_table_offset<T>(B << L, C, S)
      + 2 * 3 * static_cast<size_t>(C) * sizeof(typename Model::Entry);
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
