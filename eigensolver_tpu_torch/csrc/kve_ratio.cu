// Standalone launch of the K_m-ratio device function (kve_ratio.cuh): the
// direct counterpart of the TPU kernel
// `eigensolver_tpu/kernels/bessel.py::kve_ratio_pallas` (pl.pallas_call at
// bessel.py:125), a flat batch in, two flat batches out.
//
// The bound is arithmetic (see kve_ratio.cuh): the series and the continued
// fraction are two long code paths, and a warp whose arguments take both
// runs them one after the other. So each block partitions its tile of
// arguments by branch before it computes: it loads the tile into shared
// memory, counts the series arguments of each warp with a ballot, places
// every argument at its rank within its branch (series first, by a prefix
// sum over the warps), lets thread t evaluate the t-th argument of that
// order, and puts the results back in element order through shared memory
// for coalesced stores. Then at most one warp of a block holds both kinds.
// The Pallas (rows, 128) tiling and its padding have no role on this card.
#include <cstdint>

#include <cuda_runtime.h>

#include "kve_ratio.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 32;  // grid-stride beyond 32 blocks per SM

template <class T>
__global__ void __launch_bounds__(kThreads)
kve_ratio_kernel(const T* __restrict__ z, T* __restrict__ r0,
                 T* __restrict__ r1, int64_t n) {
  __shared__ T arg_s[kThreads];    // branch order; then r0 in element order
  __shared__ T r1_s[kThreads];     // r1 in element order
  __shared__ int elem_s[kThreads]; // tile element of each branch-ordered slot
  __shared__ int small_s[kWarps];  // series arguments per warp
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads; base < n;
       base += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t i = base + t;
    const bool live = i < n;
    const T v = live ? z[i] : T(0);
    const bool small = live && fabs(v) < T(2);
    const unsigned ball = __ballot_sync(0xffffffffu, small);
    if (lane == 0) small_s[warp] = __popc(ball);
    __syncthreads();
    int before = 0, n_small = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = small_s[w];
      n_small += c;
      before += w < warp ? c : 0;
    }
    // series arguments before this one in the tile; the CF2 ones (and the
    // slots past n, which are the tile's last) follow all series ones
    const int rank = before + __popc(ball & ((1u << lane) - 1u));
    const int slot = small ? rank : n_small + (t - rank);
    arg_s[slot] = v;
    elem_s[slot] = live ? t : -1;
    __syncthreads();
    const T a = arg_s[t];
    const int e = elem_s[t];
    T q0 = T(0), q1 = T(0);
    if (e >= 0) eigk::kve_ratio_both(a, q0, q1);
    __syncthreads();  // every argument read before arg_s takes results
    if (e >= 0) {
      arg_s[e] = q0;
      r1_s[e] = q1;
    }
    __syncthreads();
    if (live) {
      r0[i] = arg_s[t];
      r1[i] = r1_s[t];
    }
    // the next tile writes small_s, then passes a barrier before it writes
    // arg_s: every read above is done by then
  }
}

template <class T>
int launch(const void* z, void* r0, void* r1, long long n, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (static_cast<int64_t>(n) + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  kve_ratio_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(z), static_cast<T*>(r0), static_cast<T*>(r1), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry returns the cudaError_t of the launch (0 on success); n > 0.
int eigk_kve_ratio_f32(const void* z, void* r0, void* r1, long long n,
                       int device, void* stream) {
  return launch<float>(z, r0, r1, n, device, stream);
}

int eigk_kve_ratio_f64(const void* z, void* r0, void* r1, long long n,
                       int device, void* stream) {
  return launch<double>(z, r0, r1, n, device, stream);
}

const char* eigk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
