// The twisted cylinders (rotational flow v_phi, magnetic twist B_phi): the
// dispersion determinant over a batch of (omega, k, m) candidates and the
// fused bisection of a bracket batch, over the twisted Hain-Lust chain.
//
// Port of the XLA program `jit(vmap(disp))` of
// `eigensolver_tpu/physics/cylinder.py` for a case with a twist profile,
// whose coefficients take -d(r C1/C3)/dr from a `jax.jvp` (cylinder.py:
// 189-208, J :361-367), and of the XLA `fori_loop` bisection over it
// (`eigensolver_tpu/search.py:142-169`, :468-522). Every term of the chain
// is live: C1 with shift^2, B, A with r dC3diff/dr, C3 = D A + B. The chain
// runs on dual numbers (value, d/dr; common.cuh::Dual) in the order of the
// plain version (physics/cylinder.py::twisted_point_fn, twisted_chain,
// twisted_invF_g), built with --fmad=false, so kernel and plain version
// agree bit for bit. No log tail (the JAX code keeps the reference's eps);
// the kink's jump term J = B_phi(1)^2 - rho v_phi(1)^2 enters the
// determinant. The exterior is the K_m ratio or, in a variant built apart
// (kNum), the numeric one (cylinder.cuh::finish), so the K_m kernels keep
// their code. cylinder_disp.cu's scan entries call launch_cylinder_tw when
// CylDispParams::twisted is set; the fused kernels have entries of their
// own (eigk_cylinder_eval_*, eigk_cylinder_spec_*).
//
// What bounds it on Hopper: operations. Per candidate and RK4 step, 3
// evaluations of a ~180-operation dual chain with (1/F, g), against 24
// bytes in and 17 out per candidate. An IEEE division compiles to a
// reciprocal, a Newton sequence and a range check, so the divisions set the
// cost: the chain divided ~25 times an abscissa, 20 of them by values of
// the radius alone. The design:
//   - the r-only values (RPointTw) carry the reciprocals the chain divides
//     by (1/r, 1/r^2, 1/sqrt(rho), each a dual where its derivative
//     counts) and the cusp ratio c_i / sqrt(c_i^2 + vA_i^2) whole; the chain
//     multiplies by them, and 1/D, 1/C3 are its 2 divisions an abscissa
//     (r C1/C3 the quotient rule on 1/C3, common.cuh::dover, so a pole
//     gives the quotient's inf or NaN);
//   - the scan (tw_scan_kernel): one thread per candidate, the r-only
//     values in a shared-memory table that its block fills chunk by chunk,
//     128 threads a block at the register budget of 5 blocks per SM, so
//     that a 76,800-candidate batch runs in one wave at f64 (within 1% of
//     the fastest of 18 (threads, budget, chunk) shapes timed on an H100:
//     PERF.md section 6);
//   - a batch too small to fill the card one thread per candidate (the
//     refine stage's window ends) goes through the fused kernel's
//     evaluation mode (bisect.cuh::spec_kernel): producer warps compute
//     the chain, one consumer lane per candidate runs the serial update;
//   - the fused bisection (the same spec_kernel): its producers read the
//     r-only values from a per-stage table of the block instead of
//     computing them per bracket (3.8x faster on an H100 at a sweep's
//     2,400 brackets: PERF.md section 6), and a
//     batch too small to fill the card (the refine stage's roots) runs L
//     levels of the bisection a round on 2^L lanes a bracket; a sweep's
//     bracket stage keeps the loop's schedule (L = 0), where speculation
//     only adds producer work.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "bisect.cuh"
#include "common.cuh"
#include "cylinder.cuh"

namespace eigk {

// The twisted chain at the radius of q (physics/cylinder.py::twisted_chain,
// cylinder.py:110-208 with C1's shift^2): D, C1, A, B, C3 and r C1/C3 with
// their r-derivatives, C2 and 1/C3 without
template <class T>
struct TwChain {
  Dual<T> D, C1, A, B, C3, rc;
  T C2, iC3;
};

template <class T>
__device__ __forceinline__ TwChain<T> twisted_chain(const RPointTw<T>& q,
                                                    T omega, T k, T m) {
  TwChain<T> c;
  const Dual<T> R{q.r, T(1)};
  const Dual<T> mb_r = m * q.b * q.iR;
  const Dual<T> shift = omega - m * q.v * q.iR - k * q.U;
  const Dual<T> alf = mb_r + k * q.Bz * q.isr;
  const Dual<T> cusp = alf * q.cr;
  const Dual<T> s2 = shift * shift;
  const Dual<T> da = s2 - alf * alf;
  const Dual<T> dc = s2 - cusp * cusp;
  c.D = q.rho * q.csum * da * dc;
  const Dual<T> fb = mb_r + k * q.Bz;
  const Dual<T> Q = -da * q.rho * (q.v * q.v) * q.iR
                  + T(2) * s2 * (q.b * q.b) * q.iR
                  + T(2) * shift * q.b * q.v * fb * q.iR;
  const Dual<T> Tt = fb * q.b + q.rho * q.v * shift;
  c.C1 = Q * s2 - T(2) * m * q.csum * dc * Tt * q.iRR;
  c.C2 = s2.v * s2.v - q.csum.v * (m * m * q.iRR.v + k * k) * dc.v;
  c.A = q.rho * da + q.rdc;
  c.B = Q * Q - T(4) * q.csum * dc * (Tt * Tt) * q.iRR;
  c.C3 = c.D * c.A + c.B;
  c.iC3 = T(1) / c.C3.v;
  c.rc = dover(R * c.C1, c.C3, c.iC3);
  return c;
}

// (1/F, g) of the twisted chain at the radius of q
// (physics/cylinder.py::twisted_invF_g): 1/D is its second division
template <class T>
__device__ __forceinline__ void invF_g_tw(const RPointTw<T>& q, T omega, T k,
                                          T m, T& iF, T& g) {
  const TwChain<T> c = twisted_chain(q, omega, k, m);
  const T iD = T(1) / c.D.v;
  iF = c.A.v * q.iR.v + c.B.v * q.iR.v * iD;
  g = -c.rc.d - q.r * (c.C2 - c.C1.v * c.C1.v * c.iC3) * iD;
}

// What the end of the shoot reads from r = 1: the u1 basis' xi_r = C1/C3,
// F(1) = r D / C3, and J = B_phi(1)^2 - rho v_phi(1)^2
template <class T>
struct IfaceTw {
  T xi1, F1, J;
};

template <class T>
__device__ __forceinline__ IfaceTw<T> interface1_tw(const CylDispParams& p,
                                                    T omega, T k, T m) {
  const T one = T(1);
  IfaceTw<T> f;
  const TwChain<T> t = twisted_chain(r_point_tw(p, one), omega, k, m);
  f.F1 = one * t.D.v / t.C3.v;
  f.xi1 = t.C1.v * one / t.C3.v + T(0);
  const T b1 = tw_profile(p.bphi, one, 0);
  const T v1 = tw_profile(p.vphi, one, 0);
  f.J = b1 * b1 - T(p.rho_i0) * (v1 * v1);
  return f;
}

// The scan: one thread per candidate, kTwScanThreads per block at the
// register budget of kTwScanMinBlocks blocks per SM, the r-only table in
// chunks of `chunk` steps (dynamic shared memory: 2 x 3 chunk entries, one
// barrier a chunk). Threads past n evaluate a copy of the last candidate,
// so that every thread reaches the block's barriers, and store nothing.
constexpr int kTwScanThreads = 128;
constexpr int kTwScanMinBlocks = 5;

template <class T, bool kNum>
__global__ void __launch_bounds__(kTwScanThreads, kTwScanMinBlocks)
tw_scan_kernel(const T* __restrict__ omega_, const T* __restrict__ k_,
               const T* __restrict__ m_, T* __restrict__ det_,
               T* __restrict__ mism_, bool* __restrict__ valid_, int64_t n,
               int chunk, const __grid_constant__ CylDispParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RPointTw<T>* table = reinterpret_cast<RPointTw<T>*>(smem_raw);
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kTwScanThreads + threadIdx.x;
  const int64_t idx = i < n ? i : n - 1;
  const T omega = omega_[idx], k = k_[idx], m = m_[idx];
  const Grid<T> g(p);
  const IfaceTw<T> f = interface1_tw(p, omega, k, m);

  // u1: P(1)=1, P'(1)=0  |  u2: P(1)=0, P'(1)=1  (w = F P')
  T P1 = T(1), w1 = T(0), P2 = T(0), w2 = f.F1 * T(1);
  const int n_chunks = (g.n_int + chunk - 1) / chunk;
  const int slot = 3 * chunk;
  auto fill = [&](int c, RPointTw<T>* dst) {
    const int i0 = c * chunk, count = min(chunk, g.n_int - i0);
    for (int e = threadIdx.x; e < 3 * count; e += kTwScanThreads) {
      dst[e] = r_point_tw(p, rk4_abscissa(g.x0i, g.hi, g.hhi, i0 + e / 3,
                                          e % 3));
    }
  };
  fill(0, table);
  __syncthreads();
  for (int ci = 0; ci < n_chunks; ++ci) {
    // fill the other buffer while this one is read: the barrier below
    // publishes it and retires this one
    if (ci + 1 < n_chunks) fill(ci + 1, table + ((ci + 1) & 1) * slot);
    const RPointTw<T>* q = table + (ci & 1) * slot;
    const int count = min(chunk, g.n_int - ci * chunk);
    for (int j = 0; j < count; ++j, q += 3) {
      T iFA, gA, iFM, gM, iFB, gB;
      invF_g_tw(q[0], omega, k, m, iFA, gA);
      invF_g_tw(q[1], omega, k, m, iFM, gM);
      invF_g_tw(q[2], omega, k, m, iFB, gB);
      rk4_step2(g.hi, g.hhi, g.h6i, iFA, gA, iFM, gM, iFB, gB, P1, w1, P2,
                w2);
    }
    __syncthreads();
  }
  T det, mism;
  bool valid;
  finish<T, kNum>(p, omega, k, m, f.xi1, f.F1, f.J, P1, w1, P2, w2, det,
                  mism, valid);
  if (i < n) {
    det_[i] = det;
    mism_[i] = mism;
    valid_[i] = valid;
  }
}

// The twisted chain as bisect.cuh::spec_kernel runs it: the producers
// compute an abscissa's r-only entry (r_point_tw) and a column's (1/F, g)
// from it (invF_g_tw), the consumer runs interface1_tw / rk4_step2 / finish
// in the scan's order, so every value is the scan's.
template <class T_, bool kNum>
struct TwModel {
  using T = T_;
  using Params = CylDispParams;
  using Entry = RPointTw<T>;
  using Ctx = IfaceTw<T>;
  static constexpr int kState = 4;  // (P1, w1, P2, w2)
  const Params& p;
  Grid<T> g;

  __device__ explicit TwModel(const Params& p_) : p(p_), g(p_) {}
  __device__ int n_steps() const { return g.n_int; }
  __device__ Entry entry(int i, int a) const {
    return r_point_tw(p, rk4_abscissa(g.x0i, g.hi, g.hhi, i, a));
  }
  __device__ void coef(int, const Entry& q, T omega, T k, T m, T& c0,
                       T& c1) const {
    invF_g_tw(q, omega, k, m, c0, c1);
  }
  __device__ void start(T omega, T k, T m, T* y, Ctx& ctx) const {
    ctx = interface1_tw(p, omega, k, m);
    y[0] = T(1);
    y[1] = T(0);
    y[2] = T(0);
    y[3] = ctx.F1 * T(1);
  }
  __device__ void step(int i, const T* c, int s, T* y) const {
    rk4_step2(g.hi, g.hhi, g.h6i, c[0], c[s], c[2 * s], c[3 * s], c[4 * s],
              c[5 * s], y[0], y[1], y[2], y[3]);
  }
  __device__ void finish(T omega, T k, T m, const T* y, const Ctx& ctx, T& det,
                         T& mism, bool& valid) const {
    eigk::finish<T, kNum>(p, omega, k, m, ctx.xi1, ctx.F1, ctx.J, y[0], y[1],
                          y[2], y[3], det, mism, valid);
  }
};

template <class T>
int launch_cylinder_tw(const void* omega, const void* k, const void* m,
                       void* det, void* mism, void* valid, long long n,
                       int threads, int chunk, const CylDispParams* p,
                       cudaStream_t stream) {
  const size_t smem = 2 * 3 * static_cast<size_t>(chunk) * sizeof(RPointTw<T>);
  if (threads != kTwScanThreads || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* kern = p->exterior_numeric ? tw_scan_kernel<T, true>
                                   : tw_scan_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n + kTwScanThreads - 1) / kTwScanThreads;
  kern<<<static_cast<unsigned>(blocks), kTwScanThreads, smem, stream>>>(
      static_cast<const T*>(omega), static_cast<const T*>(k),
      static_cast<const T*>(m), static_cast<T*>(det), static_cast<T*>(mism),
      static_cast<bool*>(valid), n, chunk, *p);
  return static_cast<int>(cudaGetLastError());
}

template int launch_cylinder_tw<float>(const void*, const void*, const void*,
                                       void*, void*, void*, long long, int, int,
                                       const CylDispParams*, cudaStream_t);
template int launch_cylinder_tw<double>(const void*, const void*, const void*,
                                        void*, void*, void*, long long, int,
                                        int, const CylDispParams*,
                                        cudaStream_t);

// bisect.cuh::launch_spec over the twisted chain with the exterior that p
// names
template <class T>
int launch_tw_spec(const void* lo, const void* hi, const void* k,
                   const void* mode, void* out0, void* out1, void* valid,
                   long long n, int n_iter, int final_eval, int eval, int B,
                   int L, int P, int C, int S, int min_blocks,
                   const CylDispParams* p, int device, void* stream) {
  return p->exterior_numeric
             ? launch_spec<TwModel<T, true>>(lo, hi, k, mode, out0, out1,
                                             valid, n, n_iter, final_eval,
                                             eval, B, L, P, C, S, min_blocks,
                                             p, device, stream)
             : launch_spec<TwModel<T, false>>(lo, hi, k, mode, out0, out1,
                                              valid, n, n_iter, final_eval,
                                              eval, B, L, P, C, S, min_blocks,
                                              p, device, stream);
}

// A kernel's registers, local (spill) bytes a thread and resident blocks
// per SM with `smem` bytes of dynamic shared memory at `threads` a block
template <class K>
int kernel_attrs(K* kern, int threads, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = per_sm;
  return 0;
}

template <class T>
int tw_attrs(int kind, int threads, int min_blocks, long long smem,
             int* out) {
  if (kind == 0 && threads == kTwScanThreads) {
    return kernel_attrs(tw_scan_kernel<T, false>, threads,
                        static_cast<size_t>(smem),
                        out);
  } else if (kind == 1 && min_blocks == 1) {
    return kernel_attrs(spec_kernel<TwModel<T, false>, 1>, threads,
                        static_cast<size_t>(smem), out);
  } else if (kind == 1 && min_blocks == 2) {
    return kernel_attrs(spec_kernel<TwModel<T, false>, 2>, threads,
                        static_cast<size_t>(smem), out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace eigk

extern "C" {

// The fused evaluation of n twisted candidates (omega, k, m): det, the %
// mismatch and valid, as the scan gives them; B candidates a block (one
// consumer lane each), P producer warps, C steps per stage, S stages, the
// register budget of min_blocks blocks of 512 threads per SM (0: chosen at
// launch). Returns the cudaError_t; p->twisted must be set.
int eigk_cylinder_eval_f32(const void* omega, const void* k, const void* m,
                           void* det, void* mism, void* valid, long long n,
                           int B, int P, int C, int S, int min_blocks,
                           const eigk::CylDispParams* p, int device,
                           void* stream) {
  if (!p->twisted || p->log_tail) return static_cast<int>(cudaErrorInvalidValue);
  return eigk::launch_tw_spec<float>(omega, nullptr, k, m, det, mism, valid, n,
                                     0, 1, 1, B, 0, P, C, S, min_blocks, p,
                                     device, stream);
}

int eigk_cylinder_eval_f64(const void* omega, const void* k, const void* m,
                           void* det, void* mism, void* valid, long long n,
                           int B, int P, int C, int S, int min_blocks,
                           const eigk::CylDispParams* p, int device,
                           void* stream) {
  if (!p->twisted || p->log_tail) return static_cast<int>(cudaErrorInvalidValue);
  return eigk::launch_tw_spec<double>(omega, nullptr, k, m, det, mism, valid,
                                      n, 0, 1, 1, B, 0, P, C, S, min_blocks, p,
                                      device, stream);
}

// The speculative fused bisection of n twisted brackets (lo, hi, k, m):
// root, and the % mismatch at the root when final_eval (mism may be null
// otherwise); B brackets a block, L >= 1 levels a round on 2^L lanes a
// bracket (B 2^L <= 32), the rest as eigk_cylinder_eval_*.
int eigk_cylinder_spec_f32(const void* lo, const void* hi, const void* k,
                           const void* m, void* root, void* mism, long long n,
                           int n_iter, int final_eval, int B, int L, int P,
                           int C, int S, int min_blocks,
                           const eigk::CylDispParams* p, int device,
                           void* stream) {
  if (!p->twisted || p->log_tail) return static_cast<int>(cudaErrorInvalidValue);
  return eigk::launch_tw_spec<float>(lo, hi, k, m, root, mism, nullptr, n,
                                     n_iter, final_eval, 0, B, L, P, C, S,
                                     min_blocks, p, device, stream);
}

int eigk_cylinder_spec_f64(const void* lo, const void* hi, const void* k,
                           const void* m, void* root, void* mism, long long n,
                           int n_iter, int final_eval, int B, int L, int P,
                           int C, int S, int min_blocks,
                           const eigk::CylDispParams* p, int device,
                           void* stream) {
  if (!p->twisted || p->log_tail) return static_cast<int>(cudaErrorInvalidValue);
  return eigk::launch_tw_spec<double>(lo, hi, k, m, root, mism, nullptr, n,
                                      n_iter, final_eval, 0, B, L, P, C, S,
                                      min_blocks, p, device, stream);
}

// Registers, local bytes a thread and blocks per SM (out[0..2]) of a
// twisted kernel: kind 0 the scan (threads 128, min_blocks unread), kind 1
// the fused kernel at min_blocks 1 or 2; f64 selects the type, smem the
// dynamic shared memory a block. Returns the cudaError_t.
int eigk_cylinder_tw_attrs(int f64, int kind, int threads, int min_blocks,
                           long long smem, int* out) {
  return f64 ? eigk::tw_attrs<double>(kind, threads, min_blocks, smem, out)
             : eigk::tw_attrs<float>(kind, threads, min_blocks, smem, out);
}

}  // extern "C"
