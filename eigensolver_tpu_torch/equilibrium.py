"""Derived equilibrium fields on torch tensors.

Port of `eigensolver_tpu.equilibrium.Equilibrium` and `make_equilibrium`,
both branches, expression for expression. For the density cases every
internal speed follows from the density profile under total-pressure
balance:

    rho_i(x) = profile(x)
    vA_i(x)  = vA_i0 sqrt(rho_i0 / rho_i(x))        [B constant]
    c_i(x)   = sqrt( rho_e (c_e^2 + g/2 vA_e^2) / rho_i(x)  -  g/2 vA_i(x)^2 )
    cT_i(x)  = c_i vA_i / sqrt(c_i^2 + vA_i^2)

For the twisted (rotational flow) cases the pressure follows from radial
force balance: P_i(r) = rho_i0 v_twist^2 r^(2p) / (2p) + P_0. The continuum
masks (`continuum_bands`, `genuine_continua*`) are not ported yet
(ROADMAP A11).
"""
from __future__ import annotations

import dataclasses

import torch

from .config import CaseConfig, ProfileKind, Regime
from .profiles import Profile, div, make_profile, rdiv, sqrt


@dataclasses.dataclass(frozen=True)
class Equilibrium:
    """Bundle of callable equilibrium fields f(x) -> tensor (closed form)."""

    regime: Regime
    rho_i: Profile
    c_i: Profile
    vA_i: Profile
    cT_i: Profile
    B_i: Profile                    # longitudinal field B_z(r) (cylinder) / B_0
    U_i: Profile                    # longitudinal flow profile (slab flow cases)
    v_phi: Profile                  # azimuthal flow v_phi(r) (rotational flow)
    B_phi: Profile                  # azimuthal field B_phi(r)
    P_i: Profile

    def boundary_speeds(self, x_b: float = 1.0):
        """Characteristic speeds at the layer edge |x| = x_b, in float64 on
        the host."""
        xb = torch.tensor(x_b, dtype=torch.float64)
        c_b = float(self.c_i(xb))
        vA_b = float(self.vA_i(xb))
        cT_b = (c_b * vA_b) / (c_b ** 2 + vA_b ** 2) ** 0.5
        return c_b, vA_b, cT_b


def _const(v: float) -> Profile:
    def f(x):
        return v + 0.0 * x
    return f


def make_equilibrium(case: CaseConfig) -> Equilibrium:
    rg = case.regime
    rho_e, g = rg.rho_e, rg.gamma

    # --- density profile and pressure-balanced speeds -----------------------
    rho_i = make_profile(case.density_profile, rg.rho_i0, rho_e)

    if case.twist_profile is not None:
        # Rotational-flow case: uniform density, force-balanced pressure.
        v_phi = make_profile(case.twist_profile, 0.0, 0.0)
        tp = case.twist_profile
        amp, p = tp.amplitude, tp.power
        P_0 = rg.P_0

        if case.b_twist_profile is not None:
            B_phi = make_profile(case.b_twist_profile, 0.0, 0.0)
        else:
            B_phi = _const(0.0)

        def rho_u(x):
            return rg.rho_i0 + 0.0 * x

        def P_i(r):
            # radial force balance for v_phi = amp * r^p
            return rho_u(r) * amp ** 2 * div(r ** (2.0 * p), 2.0 * p) + P_0

        def B_i(r):
            # pressure-balanced B_z when an azimuthal field is present
            return rg.B_0 * sqrt(1.0 - 2.0 * div(B_phi(r) ** 2, rg.B_0 ** 2))

        def c_i(r):
            return sqrt(P_i(r) * g / rho_u(r))

        def vA_i(r):
            return (B_i(r) + B_phi(r)) / sqrt(rho_u(r))

        rho_fn = rho_u
    else:
        v_phi = _const(0.0)
        B_phi = _const(0.0)
        B_i = _const(rg.B_0)

        if case.density_profile.kind == ProfileKind.UNIFORM:
            # uniform density: the speeds are the exact regime constants
            vA_i = _const(rg.vA_i0)
            c_i = _const(rg.c_i0)
        else:
            def vA_i(x):
                return rg.vA_i0 * sqrt(rdiv(rg.rho_i0, rho_i(x)))

            def c_i(x):
                return sqrt(
                    rdiv(rho_e * (rg.c_e ** 2 + 0.5 * g * rg.vA_e ** 2), rho_i(x))
                    - 0.5 * g * vA_i(x) ** 2
                )

        def P_i(x):
            return div(c_i(x) ** 2 * rho_i(x), g)

        rho_fn = rho_i

    def cT_i(x):
        c2 = c_i(x) ** 2
        a2 = vA_i(x) ** 2
        return sqrt(c2 * a2 / (c2 + a2))

    # --- longitudinal flow profile (slab flow / cylinder axial flow) --------
    if case.flow_profile.kind == ProfileKind.UNIFORM and rg.U_i0 == rg.U_e == 0.0:
        U_i = _const(0.0)
    else:
        U_i = make_profile(case.flow_profile, rg.U_i0, rg.U_e)

    return Equilibrium(
        regime=rg,
        rho_i=rho_fn,
        c_i=c_i,
        vA_i=vA_i,
        cT_i=cT_i,
        B_i=B_i,
        U_i=U_i,
        v_phi=v_phi,
        B_phi=B_phi,
        P_i=P_i,
    )
