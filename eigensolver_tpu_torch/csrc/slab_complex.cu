// The slab's dispersion determinant at complex omega (kernel B5-complex,
// slab_complex_kernel) and the damped Newton iteration on it (kernel B7,
// slab_newton_kernel): the Kelvin-Helmholtz growth-rate path.
//
// slab_complex_kernel is the port of the XLA-fused `jit(vmap(disp))` of
// `eigensolver_tpu/physics/slab.py::SlabPhysics.make_dispersion` at complex
// omega (slab.py:80-113, :247-281, :309-318, :341-358, :384-400): the shear
// form (flow cases) with the exact exterior, omega complex, k real, the
// state (vx, vx') complex from (par, 1 - par), sqrt(m_e) the principal
// root, the % mismatch with the complex modulus, valid = Re m_e > 0, the
// shear-pressure term as the parameters say. One thread per (omega, k,
// parity) candidate carries the shoot in registers; its block computes the
// chain's x-only values (U, U', U'': ShearPoint, which do not depend on
// omega) into a shared-memory table chunk by chunk, as slab_disp.cu's scan
// does. Outputs (det re, det im, mismatch, valid). It serves the final
// evaluation of a complex sweep's Newton roots and, in one launch, every
// contour point of the argument-principle audit (search.py:536-578).
//
// slab_newton_kernel fuses `eigensolver_tpu/search.py::newton_complex`
// (:581-603) over a seed batch: one launch runs all n_iter damped Newton
// steps of every seed, one thread a seed. A step takes one pass of the
// shoot on dual numbers in omega (complex.cuh::CDual; the JAX package's
// holomorphic jax.jvp), which gives D and dD/domega, then step = d/dd (0
// where dd == 0), clamped to 0.2 (1 + |omega|). The same x-only table
// serves every step: the block refills it chunk by chunk on each pass.
//
// What bounds them on Hopper: per candidate and RK4 step, 3 evaluations of
// the complex chain (8 real divisions each, 4 divisors; twice the products
// on the dual pass) and the complex update, against 32-48 bytes in and out
// per candidate: operations. The serial chain of a thread is the latency
// of its divisions; 7,200 seeds (the published sweep) give 225 warps, under
// two a multiprocessor, so the card is latency-bound and under-filled: one
// thread a seed is this port's first design, and spreading a seed's chain
// over lanes (as bisect.cuh::spec_kernel does for the bisection) is later
// work.
//
// Arithmetic order follows the plain PyTorch version
// (`physics/slab.py::complex_shear_coef`, `complex_edge`, `complex_det`,
// `complex_mismatch`, `search.py::newton_step`) operation for operation;
// with --fmad=false the kernels agree with it bit for bit on the card.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

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

// The block fills the table entries of steps [i0, i0 + count), 3 per step
template <class T>
__device__ __forceinline__ void fill_chunk(const SlabDispParams& p, T h, T hh,
                                           int i0, int count,
                                           ShearPoint<T>* dst) {
  for (int e = threadIdx.x; e < 3 * count; e += blockDim.x) {
    dst[e] = shear_point<T>(p, rk4_abscissa(T(0), h, hh, i0 + e / 3, e % 3));
  }
}

template <class T, bool kDual>
using State = typename std::conditional<kDual, CDual<T>, Cx<T>>::type;

// The shoot from x = 0 to 1 (`_rk4_linear_shear`) of candidate c from
// (y0, y1), through the table in chunks of `chunk` steps (2 x 3 chunk
// entries of shared memory). Every thread of the block calls it: the fill
// is cooperative, one barrier per chunk.
template <class T, bool kDual>
__device__ __forceinline__ void shoot(const SlabDispParams& p,
                                      ShearPoint<T>* table, int chunk,
                                      const Cand<T>& c, State<T, kDual>& y0,
                                      State<T, kDual>& y1) {
  const int n_steps = p.n_interior;
  T h, hh, h6;
  rk4_spacing(T(0), T(1), n_steps, h, hh, h6);
  const int n_chunks = (n_steps + chunk - 1) / chunk;
  const int slot = 3 * chunk;
  if (n_chunks > 0) fill_chunk<T>(p, h, hh, 0, min(chunk, n_steps), table);
  __syncthreads();
  for (int ci = 0; ci < n_chunks; ++ci) {
    if (ci + 1 < n_chunks) {
      const int i1 = (ci + 1) * chunk;
      fill_chunk<T>(p, h, hh, i1, min(chunk, n_steps - i1),
                    table + ((ci + 1) & 1) * slot);
    }
    const ShearPoint<T>* q = table + (ci & 1) * slot;
    const int count = min(chunk, n_steps - ci * chunk);
    for (int j = 0; j < count; ++j, q += 3) {
      const Coef<T, kDual> A = shear_coef<T, kDual>(p, q[0], c);
      const Coef<T, kDual> M = shear_coef<T, kDual>(p, q[1], c);
      const Coef<T, kDual> B = shear_coef<T, kDual>(p, q[2], c);
      rk4_step(h, hh, h6, A.D, A.c, M.D, M.c, B.D, B.c, y0, y1);
    }
    __syncthreads();
  }
}

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

// Threads a block of both kernels, the one size they are built at. A
// thread's chain is serial and latency-bound, and the block size did not
// move the main path's times on the H100 (PERF.md section 6, PR 10).
constexpr int kThreads = 64;

// The scan (B5-complex): one thread per candidate; threads past n take a
// copy of the last candidate, so that every thread reaches the block's
// barriers, and store nothing
template <class T>
__global__ void __launch_bounds__(kThreads)
slab_complex_kernel(const T* __restrict__ om_re, const T* __restrict__ om_im,
                    const T* __restrict__ k_, const T* __restrict__ par_,
                    T* __restrict__ det_re, T* __restrict__ det_im, int64_t n,
                    T* __restrict__ mism_, bool* __restrict__ valid_,
                    int chunk, const __grid_constant__ SlabDispParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* table = reinterpret_cast<ShearPoint<T>*>(smem_raw);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t idx = i < n ? i : n - 1;
  const Cx<T> omega{om_re[idx], om_im[idx]};
  const T k = k_[idx];
  const Cand<T> c(p, omega, k);
  Cx<T> y0, y1;
  start(par_[idx], y0, y1);
  shoot<T, false>(p, table, chunk, c, y0, y1);
  T mism;
  bool valid;
  const Cx<T> d =
      finish<T, false>(p, edge<T, false>(p, omega, k), y0, y1, &mism, &valid);
  if (i < n) {
    det_re[i] = d.re;
    det_im[i] = d.im;
    mism_[i] = mism;
    valid_[i] = valid;
  }
}

// The fused Newton iteration (B7): n_iter damped steps per seed
// (search.py::newton_step), each on one dual pass of the shoot
template <class T>
__global__ void __launch_bounds__(kThreads)
slab_newton_kernel(const T* __restrict__ om_re, const T* __restrict__ om_im,
                   const T* __restrict__ k_, const T* __restrict__ par_,
                   T* __restrict__ out_re, T* __restrict__ out_im, int64_t n,
                   int n_iter, double damping, int chunk,
                   const __grid_constant__ SlabDispParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* table = reinterpret_cast<ShearPoint<T>*>(smem_raw);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t idx = i < n ? i : n - 1;
  Cx<T> om{om_re[idx], om_im[idx]};
  const T k = k_[idx];
  const T par = par_[idx];
  for (int it = 0; it < n_iter; ++it) {
    const Cand<T> c(p, om, k);
    CDual<T> y0, y1;
    start(par, y0, y1);
    shoot<T, true>(p, table, chunk, c, y0, y1);
    const CDual<T> det =
        finish<T, true>(p, edge<T, true>(p, om, k), y0, y1, nullptr, nullptr);
    const Cx<T> d = det.v, dd = det.d;
    const Cx<T> q = d / dd;
    Cx<T> step = (dd.re == T(0) && dd.im == T(0)) ? Cx<T>{T(0), T(0)} : q;
    const T max_step = T(0.2) * (T(1) + cabs(om));
    const T mag = cabs(step);
    if (mag > max_step) step = step * (max_step / mag);
    om = om - T(damping) * step;
  }
  if (i < n) {
    out_re[i] = om.re;
    out_im[i] = om.im;
  }
}

template <class T>
size_t table_bytes(int chunk) {
  return 2 * 3 * static_cast<size_t>(chunk) * sizeof(ShearPoint<T>);
}

// Set the kernel's dynamic shared memory for the table of `chunk` steps on
// `device`; the grid covering n threads. Only the shear form with the exact
// exterior.
template <class Kern>
cudaError_t prepare(Kern* kern, long long n, int chunk, size_t smem,
                    const SlabDispParams* p, int device, unsigned* blocks) {
  if (n <= 0 || chunk < 1 || !p->shear || p->exterior_numeric ||
      smem > 227 * 1024) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  *blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  return cudaSuccess;
}

template <class T>
int scan(const void* om_re, const void* om_im, const void* k, const void* par,
         void* det_re, void* det_im, long long n, void* mism, void* valid,
         int chunk, const SlabDispParams* p, int device, void* stream) {
  auto* kern = slab_complex_kernel<T>;
  const size_t smem = table_bytes<T>(chunk);
  unsigned blocks = 0;
  cudaError_t err = prepare(kern, n, chunk, smem, p, device, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(om_re), static_cast<const T*>(om_im),
      static_cast<const T*>(k), static_cast<const T*>(par),
      static_cast<T*>(det_re), static_cast<T*>(det_im), n,
      static_cast<T*>(mism), static_cast<bool*>(valid), chunk, *p);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int newton(const void* om_re, const void* om_im, const void* k,
           const void* par, void* out_re, void* out_im, long long n,
           int n_iter, double damping, int chunk, const SlabDispParams* p,
           int device, void* stream) {
  if (n_iter < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* kern = slab_newton_kernel<T>;
  const size_t smem = table_bytes<T>(chunk);
  unsigned blocks = 0;
  cudaError_t err = prepare(kern, n, chunk, smem, p, device, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(om_re), static_cast<const T*>(om_im),
      static_cast<const T*>(k), static_cast<const T*>(par),
      static_cast<T*>(out_re), static_cast<T*>(out_im), n, n_iter, damping,
      chunk, *p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slab_cx
}  // namespace eigk

extern "C" {

// B5-complex over n candidates (omega re, omega im, k, parity): det (re,
// im), the % mismatch and valid, chunks of `chunk` table steps. The count
// comes 7th, as in every entry. Returns the cudaError_t of the launch.
int eigk_slab_complex_f32(const void* om_re, const void* om_im, const void* k,
                          const void* par, void* det_re, void* det_im,
                          long long n, void* mism, void* valid, int chunk,
                          const eigk::SlabDispParams* p, int device,
                          void* stream) {
  return eigk::slab_cx::scan<float>(om_re, om_im, k, par, det_re, det_im, n,
                                    mism, valid, chunk, p, device, stream);
}

int eigk_slab_complex_f64(const void* om_re, const void* om_im, const void* k,
                          const void* par, void* det_re, void* det_im,
                          long long n, void* mism, void* valid, int chunk,
                          const eigk::SlabDispParams* p, int device,
                          void* stream) {
  return eigk::slab_cx::scan<double>(om_re, om_im, k, par, det_re, det_im, n,
                                     mism, valid, chunk, p, device, stream);
}

// B7 over n seeds (omega re, omega im, k, parity): n_iter damped Newton
// steps each, the final omega (re, im)
int eigk_slab_newton_f32(const void* om_re, const void* om_im, const void* k,
                         const void* par, void* out_re, void* out_im,
                         long long n, int n_iter, double damping, int chunk,
                         const eigk::SlabDispParams* p, int device,
                         void* stream) {
  return eigk::slab_cx::newton<float>(om_re, om_im, k, par, out_re, out_im, n,
                                      n_iter, damping, chunk, p, device,
                                      stream);
}

int eigk_slab_newton_f64(const void* om_re, const void* om_im, const void* k,
                         const void* par, void* out_re, void* out_im,
                         long long n, int n_iter, double damping, int chunk,
                         const eigk::SlabDispParams* p, int device,
                         void* stream) {
  return eigk::slab_cx::newton<double>(om_re, om_im, k, par, out_re, out_im,
                                       n, n_iter, damping, chunk, p, device,
                                       stream);
}

}  // extern "C"
