// The slab kernels' case parameters and the chains' x-only table entries
// (x_point: the flux or the shear form's), shared by slab_disp.cu (real
// omega) and slab_complex.cu (complex omega).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace eigk {

// Everything of the case the determinant reads; mirrored by
// kernels/slab.py::_SlabParams. Doubles are rounded to T at use.
struct SlabDispParams {
  ProfileParams rho;     // density rho_i(x): f0 = rho_i0, fe = rho_e
  ProfileParams flow;    // flow U_i(x): f0 = U_i0, fe = U_e
  int uniform_density;   // vA_i, c_i are the regime constants
  int zero_flow;         // U_i == 0 identically
  double vA_i0, c_i0, rho_i0;
  double c2_num;         // rho_e (c_e^2 + g/2 vA_e^2)
  double half_g;         // 0.5 g
  double U_e;
  double vA_e2, c_e2, cT_e2, vAc_e2;  // vA_e^2, c_e^2, cT_e^2, vA_e^2 + c_e^2
  double pe_coef;        // rho_e (vA_e^2 + c_e^2)
  // shear chain: c_i0^2, vA_i0^2, their cT^2 and c_i0^2 + vA_i0^2, as the
  // Python floats of make_shear_coef
  double sc2, sa2, scT2, sca;
  int n_interior;
  int shear;             // has_flow: the direct (vx, vx') form
  int legacy_D;          // case.shear_D_legacy
  int shear_pressure;    // include_shear_pressure
  // the numeric exterior (exterior_method="numeric"): W of its span
  // W 2 pi / k, its RK4 steps; else the exact exp(-sqrt(m_e) (x - 1))
  double exterior_wavelengths;
  int exterior_numeric, n_exterior;
};

namespace slab {

// The shear chain's: U, U', U'' (slab.py:187-190)
template <class T>
struct alignas(16) ShearPoint {
  T U, dU, ddU;
};

// The values of the flux chain that depend on x alone (slab.py:162-171):
// one entry of the scan's table, 16-byte aligned, so that a thread reads it
// in a few vector loads.
template <class T>
struct alignas(16) FluxPoint {
  T rho, c2, a2, cT2, rho_csum;
};

template <class T, bool kShear>
using XPoint =
    typename std::conditional<kShear, ShearPoint<T>, FluxPoint<T>>::type;

template <class T, bool kShear>
__device__ __forceinline__ XPoint<T, kShear> x_point(const SlabDispParams& p,
                                                     T x) {
  if constexpr (kShear) {
    return {profile(p.flow, x), profile_d1(p.flow, x), profile_d2(p.flow, x)};
  } else {
    FluxPoint<T> q;
    T vA, ci;
    density_speeds(p.rho, p.uniform_density, p.vA_i0, p.c_i0, p.rho_i0,
                   p.c2_num, p.half_g, x, q.rho, vA, ci);
    q.c2 = ci * ci;
    q.a2 = vA * vA;
    q.cT2 = q.c2 * q.a2 / (q.c2 + q.a2);
    q.rho_csum = q.rho * (q.c2 + q.a2);
    return q;
  }
}

}  // namespace slab
}  // namespace eigk
