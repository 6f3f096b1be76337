// The slab kernels' case parameters and the shear chain's x-only table
// entry, shared by slab_disp.cu (real omega) and slab_complex.cu (complex
// omega).
#pragma once

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

}  // namespace slab
}  // namespace eigk
