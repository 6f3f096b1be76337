// Standalone launch of the K_m-ratio device function (kve_ratio.cuh): the
// direct counterpart of the TPU kernel
// `eigensolver_tpu/kernels/bessel.py::kve_ratio_pallas` (pl.pallas_call at
// bessel.py:125), a flat batch in, two flat batches out.
//
// One thread per element, grid-stride over the flat array: the Pallas
// (rows, 128) tiling and its padding have no role on this card. The bound is
// arithmetic (see kve_ratio.cuh), so the launch only has to fill the SMs.
#include <cstdint>

#include <cuda_runtime.h>

#include "kve_ratio.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // grid-stride beyond 32 blocks per SM

template <class T>
__global__ void __launch_bounds__(kThreads)
kve_ratio_kernel(const T* __restrict__ z, T* __restrict__ r0,
                 T* __restrict__ r1, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    T a, b;
    eigk::kve_ratio_both(z[i], a, b);
    r0[i] = a;
    r1[i] = b;
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
