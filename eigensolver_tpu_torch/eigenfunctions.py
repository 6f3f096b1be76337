"""Eigenfunction reconstruction at converged roots (PyTorch port).

Port of `eigensolver_tpu.eigenfunctions` (eigenfunctions.py:36-257): at a
chosen root the interior shoot of the dispersion path is integrated again
with its trajectory kept (`ode.rk4_trajectory`), on `device` in float64,
and the remaining components follow algebraically on the host (numpy, as
in the JAX package; the outputs are numpy arrays). No root-finding.

The interior uses the dispersion path's own form: the slab's flux form for
density cases, its shear form when the case has flow (slab.py:195-246);
the cylinder's (1/F, g) pair of `CylinderPhysics.coefficients` (`invF_g`;
the JAX package's gfun / invFfun, bit-identical to its fused form for the
density and axial-flow tubes, cylinder.py:190-198), twisted tubes
included. The derivatives the JAX code takes with `elementwise_grad`
(d(v_phi/r)/dr and U_i', eigenfunctions.py:231-232) are the closed forms
of `profiles.make_profile_derivative`: d(v_phi/r)/dr = (v_phi' - v_phi/r)/r;
they agree with jax.grad to rounding.

Derived-component algebra (cited lines of the reference; B_z == B_i):
  f_B = m B_phi/r + k B_z ;  g_B = m B_z/r + k B_phi   (`:2665-2671`)
  xi_z, xi_phi interior: `:2823`, `:2840`
  v_r = -Om xi_r ; v_phi = -Om xi_phi - r (v_phi0/r)' xi_r  (`:2862-2863`)
  v_z = -Om xi_z - v_z0' xi_r  (`:2888-2889`)
  exterior xi_z: k c_e^2 P/((c_e^2+vA_e^2) rho_e (om^2 - k^2 cT_e^2))
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import CaseConfig, ProfileKind
from .ode import LinearRHS, rk4_trajectory
from .physics.cylinder import CylinderPhysics, is_twisted
from .physics.slab import SlabPhysics
from .profiles import make_profile, make_profile_derivative


@dataclasses.dataclass
class RadialEigenfunction:
    """Radial profiles of one eigenmode on the combined interior+exterior grid
    (ascending coordinate; `i_boundary` indexes the interface point)."""

    omega: float
    k: float
    mode: int                    # slab parity or cylinder azimuthal order m
    x: np.ndarray
    P_T: np.ndarray              # total-pressure perturbation
    xi_r: np.ndarray             # radial (cylinder) / x (slab) displacement
    i_boundary: int
    vx: Optional[np.ndarray] = None      # slab velocity perturbation
    xi_phi: Optional[np.ndarray] = None  # cylinder only
    xi_z: Optional[np.ndarray] = None
    v_r: Optional[np.ndarray] = None
    v_phi: Optional[np.ndarray] = None
    v_z: Optional[np.ndarray] = None

    def normalised(self, by: str = "xi_r") -> "RadialEigenfunction":
        ref = np.max(np.abs(getattr(self, by)))
        out = dataclasses.replace(self)
        for f in ("P_T", "xi_r", "vx", "xi_phi", "xi_z", "v_r", "v_phi", "v_z"):
            v = getattr(self, f)
            if v is not None:
                setattr(out, f, v / ref)
        return out


def _on(device):
    """x (numpy or a number) -> float64 tensor on device; fn(tensor) ->
    numpy, for the equilibrium's closed forms."""
    def to_t(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    def ev(fn, x):
        return fn(to_t(x)).cpu().numpy()
    return to_t, ev


def reconstruct_slab(case: CaseConfig, parity: int, omega: float, k: float,
                     n_interior: int = 1024, n_exterior: int = 256,
                     exterior_extent: float = 2.0, *, device
                     ) -> RadialEigenfunction:
    """vx(x), PT(x), xi(x) on [-x_ext, +x_ext] for a slab root, the
    interior integrated on `device` (eigenfunctions.py:66-164).

    Uses the SAME interior form as the dispersion path: the self-adjoint
    flux form for density cases, the D(x)/coeff(x) shear form when the
    case has a flow - so the reconstructed mode is the eigenfunction of the
    equation whose determinant the sweep zeroed."""
    device = torch.device(device)
    to_t, ev = _on(device)
    ph = SlabPhysics.from_case(case)
    eq = ph.eq
    omega = float(omega)
    k = float(k)
    x_half = np.linspace(0.0, 1.0, n_interior + 1)
    Om = omega - k * ev(eq.U_i, x_half)

    if ph.has_flow:
        # shear form, state (vx, vx'); PT = (F/Om) vx' (the real
        # Gaussian-flow solver's interface pressure, without the complex
        # solver's -kU'/Om shear-pressure term, as in make_dispersion)
        rhs = ph.make_shear_rhs(omega, k)
        y0 = (0.0, 1.0) if parity == 0 else (1.0, 0.0)
        _, traj = rk4_trajectory(rhs, tuple(map(to_t, y0)), 0.0, 1.0,
                                 n_interior)
        vx_half, dvx_half = (t.cpu().numpy() for t in traj)
        Fv = ph.interior_F(to_t(x_half), omega, k).cpu().numpy()
        PT_half = (Fv / Om) * dvx_half
    else:
        rhs = ph.make_flux_rhs(omega, k)
        F0 = float(ph.interior_F(to_t(0.0), omega, k))
        y0 = (0.0, F0) if parity == 0 else (1.0, 0.0)
        _, traj = rk4_trajectory(rhs, tuple(map(to_t, y0)), 0.0, 1.0,
                                 n_interior)
        vx_half, w_half = (t.cpu().numpy() for t in traj)
        PT_half = w_half / Om

    # mirror by parity: vx odd (sausage) / even (kink); PT has opposite parity
    sgn = -1.0 if parity == 0 else 1.0
    x_int = np.concatenate([-x_half[::-1][:-1], x_half])
    vx_int = np.concatenate([sgn * vx_half[::-1][:-1], vx_half])
    PT_int = np.concatenate([-sgn * PT_half[::-1][:-1], PT_half])

    # exterior (analytic): vx = vx(1) exp(-sqrt(m_e)(x-1)) scaled for xi continuity
    m_e = float(ph.exterior_m(omega, k))
    sq = np.sqrt(max(m_e, 0.0))
    p_e = float(ph.exterior_PT_coeff(omega, k))
    x_ext = np.linspace(1.0, 1.0 + exterior_extent * 2 * np.pi / k, n_exterior + 1)[1:]
    Om_i1 = omega - k * float(ev(eq.U_i, 1.0))
    Om_e = omega - k * eq.regime.U_e
    vx_b = vx_half[-1]
    # xi continuity: vx_e(1) = vx_i(1) * Om_e / Om_i(1)
    amp = vx_b * Om_e / Om_i1
    decay = np.exp(-sq * (x_ext - 1.0))
    vx_ext = amp * decay
    PT_ext = p_e * (-sq) * amp * decay

    x = np.concatenate([x_int, x_ext])
    vx = np.concatenate([vx_int, vx_ext])
    PT = np.concatenate([PT_int, PT_ext])
    Om_full = omega - k * ev(eq.U_i, x)
    Om_full = np.where(np.abs(x) > 1.0, Om_e, Om_full)
    xi = vx / Om_full

    # mirror exterior to the left for a symmetric full-domain profile
    xL = -x[len(x_int):][::-1]
    vxL = sgn * vx[len(x_int):][::-1]
    PTL = -sgn * PT[len(x_int):][::-1]
    xiL = sgn * xi[len(x_int):][::-1]
    x = np.concatenate([xL, x])
    vx = np.concatenate([vxL, vx])
    PT = np.concatenate([PTL, PT])
    xi = np.concatenate([xiL, xi])

    return RadialEigenfunction(
        omega=omega, k=k, mode=parity, x=x, P_T=PT, xi_r=xi, vx=vx,
        i_boundary=int(np.searchsorted(x, 1.0)))


def _flow_derivatives(case: CaseConfig):
    """(d(v_phi/r)/dr, dU_i/dr) as functions of an r tensor, in closed
    form: v_phi' from the twist profile (0 without one), U_i' from the
    flow profile (0 without a flow), as `make_equilibrium` builds them."""
    rg = case.regime
    zero = torch.zeros_like
    if is_twisted(case):
        tp = case.twist_profile
        v = make_profile(tp, 0.0, 0.0)
        dv = make_profile_derivative(tp, 0.0, 0.0, 1)

        def dvp_over_r(r):
            return (dv(r) - v(r) / r) / r
    else:
        dvp_over_r = zero
    if case.flow_profile.kind == ProfileKind.UNIFORM and rg.U_i0 == rg.U_e == 0.0:
        dvz = zero
    else:
        dvz = make_profile_derivative(case.flow_profile, rg.U_i0, rg.U_e, 1)
    return dvp_over_r, dvz


def reconstruct_cylinder(case: CaseConfig, m: int, omega: float, k: float,
                         n_interior: int = 1024, n_exterior: int = 512, *,
                         device) -> RadialEigenfunction:
    """P(r), xi_r(r) and the derived xi_phi, xi_z, v_* for a cylinder root,
    the shoots integrated on `device` (eigenfunctions.py:167-257): the two
    interior basis solutions from r = 1 to the axis cutoff in one batch,
    combined to meet the axis condition (P(eps) = 0 for m != 0, P'(eps) = 0
    for m = 0), and the exterior from r_far in to 1."""
    device = torch.device(device)
    to_t, ev = _on(device)
    ph = CylinderPhysics.from_case(case)
    eq = ph.eq
    rg = eq.regime
    gr = case.grid
    omega = float(omega)
    k = float(k)
    eps = gr.axis_epsilon

    Dfun, C1fun, C3fun, Ffun, invF_g = ph.coefficients(omega, k, m)

    def interior(r):
        iF, g = invF_g(r)
        return 0.0, iF, g, 0.0

    F1 = float(Ffun(to_t(1.0)))
    # the basis solutions (P, w)(1) = (1, 0) and (0, F(1)), one per column
    _, (P_b, w_b) = rk4_trajectory(LinearRHS(interior),
                                   (to_t([1.0, 0.0]), to_t([0.0, F1])),
                                   1.0, eps, n_interior)
    P_b, w_b = P_b.cpu().numpy(), w_b.cpu().numpy()
    t1 = np.stack([P_b[:, 0], w_b[:, 0]], axis=1)
    t2 = np.stack([P_b[:, 1], w_b[:, 1]], axis=1)
    if m == 0:
        a1, a2 = t1[-1, 1], t2[-1, 1]
    else:
        a1, a2 = t1[-1, 0], t2[-1, 0]
    B = -a1 / a2
    traj = t1 + B * t2                    # axis-regular combination, P(1)=1
    r_in = np.linspace(1.0, eps, n_interior + 1)

    P_in = traj[:, 0]
    w_in = traj[:, 1]
    C1v = ev(C1fun, r_in)
    C3v = ev(C3fun, r_in)
    xi_in = C1v * P_in / C3v + w_in / r_in

    # exterior
    m_e = float(ph.exterior_m(omega, k))
    r_far = gr.exterior_wavelengths * 2 * np.pi / k

    def exterior(r):
        return 0.0, 1.0, m_e + (m * m) / r ** 2, -1.0 / r

    _, te = rk4_trajectory(LinearRHS(exterior), (to_t(1e-8), to_t(-1e-8)),
                           r_far, 1.0, n_exterior)
    te = np.stack([t.cpu().numpy() for t in te], axis=1)
    r_ex = np.linspace(r_far, 1.0, n_exterior + 1)
    scale = te[-1, 0]                     # normalise P_e(1) = P_i(1) = 1
    P_ex = te[:, 0] / scale
    dP_ex = te[:, 1] / scale
    xi_ex = dP_ex / (rg.rho_e * (omega**2 - k**2 * rg.vA_e**2))

    # ---- derived components (interior; citations in module docstring) -------
    rho = ev(eq.rho_i, r_in)
    c2 = ev(eq.c_i, r_in) ** 2
    vA2 = ev(eq.vA_i, r_in) ** 2
    Bz = ev(eq.B_i, r_in)
    Bp = ev(eq.B_phi, r_in)
    vp = ev(eq.v_phi, r_in)
    vz0 = ev(eq.U_i, r_in)
    Om = omega - m * vp / r_in - k * vz0
    omA = (m * Bp / r_in + k * Bz) / np.sqrt(rho)
    omC = omA * np.sqrt(c2) / np.sqrt(c2 + vA2)
    f_B = m * Bp / r_in + k * Bz
    g_B = m * Bz / r_in + k * Bp
    Qv = (-(Om**2 - omA**2) * rho * vp**2 / r_in
          + 2 * Om**2 * Bp**2 / r_in + 2 * Om * Bp * vp * f_B / r_in)
    Tv = f_B * Bp + rho * vp * Om

    xi_z_in = ((f_B * (c2 / (c2 + vA2)) * (Om**2 * P_in - Qv * xi_in)
                / (Om**2 * rho * (Om**2 - omC**2)))
               - ((2 * Om * vp * Bp + f_B * vp**2) * (xi_in / r_in))
               - (Bp * (g_B * P_in - 2 * Bz * Tv * (xi_in / r_in))
                  / (Bz * rho * (Om**2 - omA**2)))) / (Bp**2 / Bz + Bz)
    xi_phi_in = (((g_B * P_in - 2 * Bz * Tv * (xi_in / r_in))
                  / (rho * (Om**2 - omA**2))) + Bp * xi_z_in) / Bz

    dvp_over_r, dvz = _flow_derivatives(case)
    v_r_in = -Om * xi_in
    v_phi_in = -Om * xi_phi_in - ev(dvp_over_r, r_in) * r_in * xi_in
    v_z_in = -Om * xi_z_in - ev(dvz, r_in) * xi_in

    # exterior derived components (static exterior)
    cT_e2 = rg.cT_e**2
    xi_z_ex = (k * rg.c_e**2 * P_ex
               / ((rg.c_e**2 + rg.vA_e**2) * rg.rho_e * (omega**2 - k**2 * cT_e2)))
    xi_phi_ex = (m * P_ex / r_ex) / (rg.rho_e * (omega**2 - k**2 * rg.vA_e**2))
    v_r_ex = -omega * xi_ex
    v_phi_ex = -omega * xi_phi_ex
    v_z_ex = -omega * xi_z_ex

    # assemble ascending grid: interior (eps -> 1) + exterior (1 -> r_far)
    def j(a_in, a_ex):
        return np.concatenate([a_in[::-1], a_ex[::-1][1:]])

    x = j(r_in, r_ex)
    return RadialEigenfunction(
        omega=omega, k=k, mode=m, x=x,
        P_T=j(P_in, P_ex), xi_r=j(xi_in, xi_ex),
        xi_phi=j(xi_phi_in, xi_phi_ex), xi_z=j(xi_z_in, xi_z_ex),
        v_r=j(v_r_in, v_r_ex), v_phi=j(v_phi_in, v_phi_ex),
        v_z=j(v_z_in, v_z_ex),
        i_boundary=n_interior)
