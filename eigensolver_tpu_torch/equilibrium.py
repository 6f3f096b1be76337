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
force balance: P_i(r) = rho_i0 v_twist^2 r^(2p) / (2p) + P_0.

`continuum_bands` and `genuine_continua` give a case's phase-speed
continuum ranges (the search masks the genuine ones with
`SearchConfig.exclude_v_ranges`); `genuine_continua_rowfn` the twisted
family's row-local ranges, which the search masks
(`SearchConfig.exclude_omega_rowfn`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .config import CaseConfig, ProfileKind, Regime
from .profiles import Profile, div, make_profile, power, rdiv, sqrt


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
            return rho_u(r) * amp ** 2 * div(power(r, 2.0 * p), 2.0 * p) + P_0

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


def _layer_values(case: CaseConfig, n: int):
    """The layer's abscissae from eps (the cylinder's axis_epsilon, the
    slab's 0) to 1, n of them in float64 (numpy's linspace), and a function
    that evaluates an equilibrium field on them as a float64 numpy array."""
    eps = case.grid.axis_epsilon if case.geometry.value == "cylinder" else 0.0
    xs = torch.from_numpy(np.linspace(eps, 1.0, n))

    def values(fn):
        return np.broadcast_to(fn(xs).numpy(), (n,)).astype(float)

    return values


def continuum_bands(case: CaseConfig, n: int = 512):
    """[(v_lo, v_hi, label), ...]: the range each characteristic speed
    sweeps across the non-uniform layer (port of `eigensolver_tpu.
    equilibrium.continuum_bands`, equilibrium.py:59-91), the cT, c and vA
    bands and, where the layer flows, U -+ cT and U's own; zero-width bands
    dropped. Plain Python floats, from float64 values at n abscissae."""
    eq = make_equilibrium(case)
    values = _layer_values(case, n)
    out = []
    for fn, label in ((eq.cT_i, "$c_T$ continuum"),
                      (eq.c_i, "$c$ continuum"),
                      (eq.vA_i, "$v_A$ continuum")):
        v = values(fn)
        lo, hi = float(np.min(v)), float(np.max(v))
        if hi - lo > 1e-9 * max(1.0, abs(hi)):
            out.append((lo, hi, label))
    # the Doppler-shifted cusp bands and the flow (critical-layer) band
    u = values(eq.U_i)
    if np.ptp(u) > 1e-12 or abs(u[0]) > 1e-12:
        ct = values(eq.cT_i)
        out.append((float(np.min(u - ct)), float(np.max(u - ct)),
                    "$U - c_T$ continuum"))
        out.append((float(np.min(u + ct)), float(np.max(u + ct)),
                    "$U + c_T$ continuum"))
        if np.ptp(u) > 1e-12:
            out.append((float(np.min(u)), float(np.max(u)),
                        "$U$ flow continuum"))
    return out


def genuine_continua(case: CaseConfig, n: int = 512, guard: float = 2e-4):
    """Signed phase-speed ranges [(lo, hi, label), ...] of the genuine
    interior continua: the Doppler-shifted Alfven (U +- vA) and cusp
    (U +- cT) bands and, where the flow is sheared, the critical layer
    omega = k U(x) (port of `eigensolver_tpu.equilibrium.genuine_continua`,
    equilibrium.py:94-134). The apparent c(x) band is not one: genuine slow
    body modes live there. Each range shrinks by `guard` x max(1, |lo|,
    |hi|) at both ends, and one narrower than twice that is dropped. []
    for twisted cases, whose continua depend on (k, m) and are masked row
    by row (`genuine_continua_rowfn`). Plain Python floats."""
    if case.twist_profile is not None:
        return []
    eq = make_equilibrium(case)
    values = _layer_values(case, n)
    u = values(eq.U_i)
    out = []
    for fn, label in ((eq.vA_i, "alfven"), (eq.cT_i, "cusp")):
        v = values(fn)
        for s in (+1.0, -1.0):
            lo, hi = float(np.min(u + s * v)), float(np.max(u + s * v))
            if hi - lo > 1e-9 * max(1.0, abs(hi)):
                out.append((lo, hi, f"{label}{'+' if s > 0 else '-'}"))
    if np.ptp(u) > 1e-12:
        out.append((float(np.min(u)), float(np.max(u)), "flow"))

    def scale(lo, hi):
        return max(1.0, abs(lo), abs(hi))

    return [(lo + guard * scale(lo, hi), hi - guard * scale(lo, hi), lab)
            for lo, hi, lab in out
            if hi - lo > 2 * guard * scale(lo, hi)]


def genuine_continua_rowfn(case: CaseConfig, n: int = 192,
                           guard: float = 2e-4) -> Optional[Callable]:
    """Row-local continuum ranges of the twisted (rotational-flow /
    magnetic-twist) family: port of `eigensolver_tpu.equilibrium.
    genuine_continua_rowfn`, batched over ladder rows.

    Returns fn(ks, ms) -> (lo, hi), for (rows,) tensors of wavenumbers and
    azimuthal orders, two (rows, 4) tensors in their dtype and on their
    device: the OMEGA ranges of the Doppler Alfven+- and cusp+- continua of
    each row, omega = m v_phi(r)/r + k U(r) +- w(r) over r in [eps, 1] with
    w = m B_phi/r + k B_z/sqrt(rho) (Alfven) or w c_i / sqrt(c_i^2 + vA_i^2)
    (cusp), on a grid of n radii, each range shrunk by `guard` times
    max(1, |lo|, |hi|). Zero-width bands come out with lo > hi and match
    nothing. None for non-twisted cases."""
    if case.twist_profile is None:
        return None
    eq = make_equilibrium(case)
    eps = case.grid.axis_epsilon
    # the radii in float64 numpy: torch.linspace rounds otherwise
    rr64 = torch.from_numpy(np.linspace(eps, 1.0, n))

    def rowfn(ks: torch.Tensor, ms: torch.Tensor):
        rr = rr64.to(device=ks.device, dtype=ks.dtype)
        k, m = ks[:, None], ms[:, None]
        dop = m * eq.v_phi(rr) / rr + k * eq.U_i(rr)
        w_a = m * eq.B_phi(rr) / rr + k * eq.B_i(rr) / sqrt(eq.rho_i(rr))
        ci = eq.c_i(rr)
        w_c = w_a * ci / sqrt(ci * ci + eq.vA_i(rr) * eq.vA_i(rr))
        los, his = [], []
        for s in (w_a, -w_a, w_c, -w_c):
            band = dop + s
            lo, hi = band.amin(dim=1), band.amax(dim=1)
            scale = torch.maximum(lo.abs(), hi.abs()).clamp_min(1.0)
            los.append(lo + guard * scale)
            his.append(hi - guard * scale)
        return torch.stack(los, dim=1), torch.stack(his, dim=1)

    return rowfn
