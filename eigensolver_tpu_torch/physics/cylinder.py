"""Cylinder dispersion function (Hain-Lust P_T formulation) in PyTorch.

Port of `eigensolver_tpu.physics.cylinder` for the real-omega cases: the
density and axial-flow tubes, and the twisted ones (rotational flow v_phi
and magnetic twist B_phi). Two basis
solutions (P, w = F P') are integrated inward from r = 1 to eps (and, for
the non-twisted tubes, on down a log-spaced tail to eps_final), and the 2x2
determinant

    D(omega, k) = axis(u1) * match(u2) - axis(u2) * match(u1) + J xi_e xi2

combines the axis condition (kink: P(eps) = 0; sausage: P'(eps) = 0) with
continuity of xi_r against the decaying exterior K_m(sqrt(m_e) r) ("bessel")
or, with exterior_method="numeric", the exterior integrated inward from
r_far = W 2 pi / k in t = ln r (`ode.rk4_final`, cylinder.py:319-351); the
twisted kink adds the jump term J = B_phi(1)^2 - rho v_phi(1)^2.

The twisted chain needs d(r C1/C3)/dr, which the JAX package takes from
`jax.jvp`: here every quantity of the chain that r C1/C3 depends on is a
`dual.Dual` (value, d/dr), the r-only ones entering with closed-form
derivatives (`twisted_point_fn`).

`make_dispersion` returns the batched function the search calls. It casts
its inputs to the working dtype and hands them to
`kernels.cylinder.cylinder_disp`, which launches the CUDA kernel on a CUDA
tensor and runs the plain version here (`make_dispersion_plain`) on a CPU
tensor. The plain version is the JAX code's arithmetic, expression for
expression, with a Python loop over RK4 steps on tensors of candidates in
place of `lax.scan` over a vmapped scalar.

At complex omega (`case.complex_omega`: any cylinder case that the CLI's
`sweep --complex` makes complex; cylinder.py:229-234, :314-315, :379-385)
every family runs on complex numbers carried as (re, im) pairs of real
tensors (`cplx.C`): omega and the state are complex, k and m stay real,
the non-twisted chain keeps its `czero_over` NaN pattern (C1 == B == 0),
the twisted chain is a `dual.RDual` (a dual in r of complex values), the
exact exterior takes K_m at sqrt(m_e), the principal root with no floor
(`special.kve_ratio_both_c`), the numeric one integrates a complex state,
the mismatch takes the complex modulus and valid is Re m_e > 0.
`make_dispersion_dual_plain` is the same shoot on duals in omega
(`dual.Dual` of complex pairs): (det, d det / d omega) for the Newton
iteration, which the JAX package takes from a holomorphic `jax.jvp`
(search.py:581-603); the twisted chain's g = -d(r C1/C3)/dr - ... then
carries d^2(r C1/C3)/dr domega, the derivative in omega of its RDual's
derivative. On the card these run in `kernels.cylinder.cylinder_newton`
and `cylinder_disp_complex` (`csrc/cylinder_complex.cu`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from ..config import CaseConfig, ProfileConfig, ProfileKind
from ..cplx import C, cabs, csqrt
from ..dual import (Dual, RDual, divn, dsqrt, dwhere, over, quot, recip,
                    rquot)
from ..equilibrium import Equilibrium, make_equilibrium
from .. import special
from ..ode import rk4_final
from ..profiles import div, make_profile_derivative, power, rdiv, sqrt

# plain (eager PyTorch) dispersion evaluations since the last reset
plain_calls = 0


def _zero_over(x):
    """0 / x: NaN where x is 0 or NaN, else a signed zero."""
    return torch.zeros_like(x) / x


def czero_over(z):
    """0 / z of a complex pair: NaN (both parts) where z is 0 or either part
    NaN, else 0; of a dual in omega that pattern for both parts."""
    if isinstance(z, Dual):
        v = czero_over(z.v)
        return Dual(v, v)
    bad = ((z.re == 0) & (z.im == 0)) | torch.isnan(z.re) | torch.isnan(z.im)
    v = torch.where(bad, torch.full_like(z.re, math.nan),
                    torch.zeros_like(z.re))
    return C(v, v)


def _inv(x):
    """1 / x: a complex pair's (or a dual's in omega) by `dual.rquot`, else
    a real tensor's IEEE reciprocal."""
    if isinstance(x, (C, Dual)):
        return rquot(1.0, x)
    return rdiv(1.0, x)


def _rk4_linear2(coef, y0, x0, x1, n_steps: int):
    """Classical RK4 for the two-basis linear system d(P, w)/dx = (w iF, g P):
    `coef(x) -> (iF, g)` at the 3 distinct abscissae (x, x + h/2, x + h) of
    each step; the abscissa is x0 + i h, not an accumulated sum."""
    h = div(x1 - x0, n_steps)

    def apply(c, y):
        iF, g = c
        P1, w1, P2, w2 = y
        return (w1 * iF, g * P1, w2 * iF, g * P2)

    def axpy(a, y, k):
        return tuple(yi + a * ki for yi, ki in zip(y, k))

    y = y0
    for i in range(n_steps):
        x = x0 + i * h
        cA = coef(x)
        cM = coef(x + 0.5 * h)
        cB = coef(x + h)
        k1 = apply(cA, y)
        k2 = apply(cM, axpy(0.5 * h, y, k1))
        k3 = apply(cM, axpy(0.5 * h, y, k2))
        k4 = apply(cB, axpy(h, y, k3))
        y = tuple(
            yi + div(h, 6.0) * (a + 2 * b + 2 * c_ + d)
            for yi, a, b, c_, d in zip(y, k1, k2, k3, k4))
    return y


class CylinderInterface(NamedTuple):
    det: torch.Tensor
    mismatch_pct: torch.Tensor
    valid: torch.Tensor


def is_twisted(case: CaseConfig) -> bool:
    """The twisted chain (as the JAX package decides: a twist profile)."""
    return case.twist_profile is not None


def log_tail(case: CaseConfig) -> bool:
    """Whether the shoot continues on the log tail eps -> eps_final: not for
    twisted cases, whose axis cutoff is physics (v_phi ~ r^(p-1))."""
    gr = case.grid
    return not is_twisted(case) and gr.axis_epsilon_final < gr.axis_epsilon


class TwistedPoint(NamedTuple):
    """The twisted chain's values that depend on the radius alone, with
    their r-derivatives where r C1/C3 needs them, and the reciprocals of
    the chain's r-only divisors (the cusp speed's ratio c_i / sqrt(c_i^2
    + vA_i^2) whole): one entry of the kernel's table
    (`csrc/cylinder_twisted.cu::RPointTw`)."""
    r: torch.Tensor
    iR: Dual                  # 1/r
    rho: torch.Tensor         # uniform: no derivative
    isr: torch.Tensor         # 1/sqrt(rho)
    v: Dual                   # v_phi
    b: Dual                   # B_phi
    Bz: Dual                  # B_0 sqrt(1 - 2 B_phi^2 / B_0^2)
    csum: Dual                # c_i^2 + vA_i^2, vA_i = (B_z + B_phi)/sqrt(rho)
    cr: Dual                  # c_i / sqrt(c_i^2 + vA_i^2), c_i = sqrt(gamma P_i
                              # / rho), P_i force-balanced
    U: Dual                   # axial flow
    rdc: Dual                 # r d C3diff/dr, C3diff = (B_phi/r)^2 - rho (v_phi/r)^2
    iRR: Dual                 # 1/r^2


class TwistedChain(NamedTuple):
    """The twisted Hain-Lust chain at one radius: D, C1, A, B, C3 and
    r C1/C3 with their r-derivatives, C2 and 1/C3 without."""
    D: Dual
    C1: Dual
    C2: torch.Tensor
    A: Dual
    B: Dual
    C3: Dual
    iC3: torch.Tensor
    rc: Dual


def _check_supported(case: CaseConfig):
    if case.grid.exterior_method not in ("bessel", "numeric"):
        raise ValueError(
            f"unknown exterior_method {case.grid.exterior_method!r}")


@dataclasses.dataclass(frozen=True)
class CylinderPhysics:
    case: CaseConfig
    eq: Equilibrium

    @classmethod
    def from_case(cls, case: CaseConfig) -> "CylinderPhysics":
        return cls(case=case, eq=make_equilibrium(case))

    def coefficients(self, omega, k, m):
        """Closed-form coefficient functions of r: (Dfun, C1fun, C3fun,
        Ffun, invF_g), invF_g(r) -> (1/F, g) the pair the interior RK4
        integrates."""
        if is_twisted(self.case):
            return self._twisted_coefficients(omega, k, m)
        return self._plain_coefficients(omega, k, m)

    def _plain_coefficients(self, omega, k, m):
        """The non-twisted chain.

        With v_phi == B_phi == 0, C1 == B == C3diff == 0 identically, so the
        chain reduces to D, A = rho (s^2 - wA^2), C2, C3 = D A + B,
        F = r D / C3, 1/F = A/r + B/(r D) and
        g = -d(r C1/C3)/dr - r (C2 - C1^2/C3)/D. Each zero-valued term is
        kept only as what it does to the NaN pattern (`_zero_over`); the
        rest is the JAX chain's order of operations."""
        eq = self.eq

        def parts(r):
            return self._plain_parts(omega, k, m, r)

        def Dfun(r):
            return parts(r)[0]

        def C1fun(r):
            return torch.zeros_like(Dfun(r))

        def C3fun(r):
            D, A, _ = parts(r)
            return D * A + 0.0                     # + B, B == 0

        def Ffun(r):
            D, A, _ = parts(r)
            return r * D / (D * A + 0.0)

        def invF_g(r):
            D, A, C2 = parts(r)
            C3 = D * A + 0.0
            c1c3 = _zero_over(C3)                  # C1^2/C3, d(r C1/C3)/dr
            iF = A / r + _zero_over(r * D)         # A/r + B/(r D)
            g = -c1c3 - r * (C2 - c1c3) / D
            return iF, g

        return Dfun, C1fun, C3fun, Ffun, invF_g

    def _plain_parts(self, omega, k, m, r):
        """(D, A, C2) of the non-twisted chain at r, for real omega or a
        complex pair (or a dual of one) alike."""
        eq = self.eq
        rho = eq.rho_i(r)
        ci = eq.c_i(r)
        vA = eq.vA_i(r)
        shift = omega - k * eq.U_i(r)          # omega - m v_phi/r - k U
        alf = k * eq.B_i(r) / sqrt(rho)        # m B_phi/r + k B_z/sqrt(rho)
        csum = ci * ci + vA * vA
        cusp = alf * ci / sqrt(csum)
        s2 = shift * shift
        da = s2 - alf * alf
        dc = s2 - cusp * cusp
        D = rho * csum * da * dc
        A = rho * da                           # + r dC3diff/dr == 0
        C2 = s2 * s2 - csum * (m * m / (r * r) + k * k) * dc
        return D, A, C2

    def complex_invF_g(self, omega, k, m):
        """r -> (1/F, g) of the non-twisted chain at complex omega (a
        `cplx.C`, or a `dual.Dual` of one): invF_g's expressions with
        r D / C3's and g's divisions by D complex (`dual.quot`), A/r one
        real division a part."""
        def invF_g(r):
            D, A, C2 = self._plain_parts(omega, k, m, r)
            C3 = D * A + 0.0
            c1c3 = czero_over(C3)                  # C1^2/C3, d(r C1/C3)/dr
            iF = divn(A, r) + czero_over(r * D)    # A/r + B/(r D)
            g = -c1c3 - quot(r * (C2 - c1c3), D)
            return iF, g

        return invF_g

    def twisted_point_fn(self) -> Callable[[torch.Tensor], TwistedPoint]:
        """r -> TwistedPoint, the r-only part of the twisted chain.

        The profiles' derivatives are closed-form (`profiles.
        make_profile_derivative`); the rest follows by dual arithmetic,
        except C3diff' and C3diff'', from x = B_phi/r, y = v_phi/r:
            x' = (B_phi' - x)/r,   x'' = (B_phi'' - 2 x')/r   (y alike),
            C3diff' = 2 x x' - rho 2 y y',
        evaluated on the duals (x, x'), (x', x''), (y, y'), (y', y''), so
        that its tangent is C3diff''; the force balance gives P_i' = rho
        v_twist^2 r^(2p - 1). The reciprocals 1/r, 1/r^2 and 1/sqrt(rho)
        (`dual.recip`), and the cusp ratio c_i / sqrt(c_i^2 + vA_i^2), are
        what the chain multiplies by in place of dividing."""
        case, eq = self.case, self.eq
        rg = case.regime
        tp = case.twist_profile
        bp = case.b_twist_profile or ProfileConfig(kind=ProfileKind.UNIFORM)
        amp2, p = tp.amplitude ** 2, tp.power
        dv1, dv2 = (make_profile_derivative(tp, 0.0, 0.0, o) for o in (1, 2))
        db1, db2 = (make_profile_derivative(bp, 0.0, 0.0, o) for o in (1, 2))
        zero_flow = (case.flow_profile.kind == ProfileKind.UNIFORM
                     and rg.U_i0 == rg.U_e == 0.0)
        dU = (torch.zeros_like if zero_flow else make_profile_derivative(
            case.flow_profile, rg.U_i0, rg.U_e, 1))

        def point(r):
            R = Dual(r, torch.ones_like(r))
            rho = eq.rho_i(r)
            sqrt_rho = sqrt(rho)
            P = Dual(eq.P_i(r), rho * amp2 * power(r, 2.0 * p - 1.0))
            ci = dsqrt(P * rg.gamma / rho)
            b = Dual(eq.B_phi(r), db1(r))
            Bz = rg.B_0 * dsqrt(1.0 - 2.0 * (b * b / rg.B_0 ** 2))
            vA = (Bz + b) / sqrt_rho
            csum = ci * ci + vA * vA
            v = Dual(eq.v_phi(r), dv1(r))
            x = b.v / r
            x1 = (b.d - x) / r
            y = v.v / r
            y1 = (v.d - y) / r
            X1 = Dual(x1, (db2(r) - 2 * x1) / r)
            Y1 = Dual(y1, (dv2(r) - 2 * y1) / r)
            dC = 2 * Dual(x, x1) * X1 - rho * (2 * Dual(y, y1) * Y1)
            return TwistedPoint(
                r=r, iR=recip(R), rho=rho, isr=rdiv(1.0, sqrt_rho), v=v, b=b,
                Bz=Bz, csum=csum, cr=ci / dsqrt(csum),
                U=Dual(eq.U_i(r), dU(r)), rdc=R * dC, iRR=recip(R * R))
        return point

    @staticmethod
    def twisted_chain(q: TwistedPoint, omega, k, m) -> TwistedChain:
        """The twisted chain at the radius of q for candidates (omega, k,
        m): the JAX chain's expressions (cylinder.py:110-208, C1 with
        shift^2) in its order of operations, on duals, with each quotient
        by an r-only value (r, r^2, sqrt(rho)) a product by the reciprocal
        that q carries, and the cusp speed alf c_i / sqrt(c^2 + vA^2) the
        product of alf and q's ratio (as a product by 1/sqrt(c^2 + vA^2) it
        rounds beyond 1e-9 of JAX's det at f64 near the cusp resonance);
        1/C3 is the one division, and r C1/C3 the quotient rule on it
        (`dual.over`)."""
        R = Dual(q.r, torch.ones_like(q.r))
        if isinstance(omega, (C, Dual)):
            # complex omega: the chain's omega-dependent values are RDuals
            omega = RDual(omega, 0.0 * omega)
        mb_r = m * q.b * q.iR
        shift = omega - m * q.v * q.iR - k * q.U
        alf = mb_r + k * q.Bz * q.isr
        cusp = alf * q.cr
        s2 = shift * shift
        da = s2 - alf * alf
        dc = s2 - cusp * cusp
        D = q.rho * q.csum * da * dc
        fb = mb_r + k * q.Bz
        Q = (-da * q.rho * (q.v * q.v) * q.iR
             + 2.0 * s2 * (q.b * q.b) * q.iR
             + 2.0 * shift * q.b * q.v * fb * q.iR)
        T = fb * q.b + q.rho * q.v * shift
        C1 = Q * s2 - 2.0 * m * q.csum * dc * T * q.iRR
        C2 = s2.v * s2.v - q.csum.v * (m * m * q.iRR.v + k * k) * dc.v
        A = q.rho * da + q.rdc
        B = Q * Q - 4.0 * q.csum * dc * (T * T) * q.iRR
        C3 = D * A + B
        iC3 = _inv(C3.v)
        return TwistedChain(D=D, C1=C1, C2=C2, A=A, B=B, C3=C3, iC3=iC3,
                            rc=over(R * C1, C3, iC3))

    @staticmethod
    def twisted_invF_g(q: TwistedPoint, c: TwistedChain):
        """(1/F, g) of the twisted chain c at the radius of q: A/r +
        B/(r D) and -d(r C1/C3)/dr - r (C2 - C1^2/C3)/D, with 1/D the one
        division (at complex omega on complex values, `dual.rquot`)."""
        iD = _inv(c.D.v)
        iF = c.A.v * q.iR.v + c.B.v * q.iR.v * iD
        g = -c.rc.d - q.r * (c.C2 - c.C1.v * c.C1.v * c.iC3) * iD
        return iF, g

    def _twisted_coefficients(self, omega, k, m):
        """The twisted chain: the functions of `coefficients`, each from
        one evaluation of `twisted_chain` at r."""
        point = self.twisted_point_fn()

        def chain(r):
            return self.twisted_chain(point(r), omega, k, m)

        def Dfun(r):
            return chain(r).D.v

        def C1fun(r):
            return chain(r).C1.v

        def C3fun(r):
            return chain(r).C3.v

        def Ffun(r):
            c = chain(r)
            return r * c.D.v / c.C3.v

        def invF_g(r):
            q = point(r)
            return self.twisted_invF_g(q, self.twisted_chain(q, omega, k, m))

        return Dfun, C1fun, C3fun, Ffun, invF_g

    def numeric_exterior(self, m_e, k, mm):
        """dP/dr / P at r = 1 of the exterior solution (cylinder.py:
        319-351): n_exterior RK4 steps in t = ln r of (P, dP/dt)' = (dP/dt,
        (m^2 + m_e e^{2t}) P) from t = ln r_far, r_far = W 2 pi / k (W 2 pi
        a Python float, then divided in k's dtype), down to 0, from (1e-8,
        -1e-8 r_far)."""
        gr = self.case.grid
        r_far = rdiv(gr.exterior_wavelengths * 2.0 * math.pi, k)

        def rhs(t, y):
            P, Pdot = y
            return (Pdot, (mm * mm + m_e * torch.exp(2.0 * t)) * P)

        y0 = (torch.full((), 1e-8, dtype=k.dtype, device=k.device),
              -1e-8 * r_far)
        P, dP = rk4_final(rhs, y0, torch.log(r_far), torch.zeros_like(r_far),
                          gr.n_exterior)
        return dP / P

    def complex_exterior(self, m_e, k, mm):
        """`numeric_exterior` at complex omega: the state complex (m_e a
        `cplx.C`), or on the Newton pass `Dual`s of complex pairs (m_e a
        `Dual`), from the same real start, no renormalisation; dP/dr / P at
        r = 1, the complex quotient (cylinder.py:319-351)."""
        gr = self.case.grid
        r_far = rdiv(gr.exterior_wavelengths * 2.0 * math.pi, k)

        def rhs(t, y):
            P, Pdot = y
            return (Pdot, (mm * mm + m_e * torch.exp(2.0 * t)) * P)

        nil = torch.zeros_like(r_far)
        y0 = (C(torch.full_like(r_far, 1e-8), nil), C(-1e-8 * r_far, nil))
        if isinstance(m_e, Dual):
            y0 = tuple(Dual(y, C(nil, nil)) for y in y0)
        P, dP = rk4_final(rhs, y0, torch.log(r_far), torch.zeros_like(r_far),
                          gr.n_exterior)
        return quot(dP, P)

    def complex_m_e(self, omega, k):
        """exterior_m at complex omega (a `cplx.C` or a dual of one), its
        one complex quotient by Smith's divisions (`dual.quot`): (m_e,
        omega^2, k^2), the last two for xi_e."""
        rg = self.eq.regime
        k2 = k * k
        om2 = omega * omega
        X1 = k2 * rg.vA_e ** 2 - om2
        X2 = k2 * rg.c_e ** 2 - om2
        X3 = k2 * rg.cT_e ** 2 - om2
        return quot(X1 * X2, (rg.vA_e ** 2 + rg.c_e ** 2) * X3), om2, k2

    def exterior_m(self, omega, k):
        rg = self.eq.regime
        num = (k**2 * rg.vA_e**2 - omega**2) * (k**2 * rg.c_e**2 - omega**2)
        den = (rg.vA_e**2 + rg.c_e**2) * (k**2 * rg.cT_e**2 - omega**2)
        return num / den

    # -- dispersion function ---------------------------------------------------

    def make_dispersion_plain(self, m: int | None = None,
                              dtype=torch.float64) -> Callable:
        """The plain version: disp(omega, k[, m]) -> CylinderInterface on
        tensors of candidates, on any device, in eager PyTorch. With m=None
        the azimuthal order is a third tensor argument. At complex omega
        omega is a `cplx.C` (or a complex tensor) and det a `cplx.C`."""
        _check_supported(self.case)
        if self.case.complex_omega:
            return self._complex_plain(m, dtype, dual=False)
        gr = self.case.grid
        eq = self.eq

        def disp(omega, k, m_arg):
            global plain_calls
            plain_calls += 1
            dev = omega.device
            omega = omega.to(dtype)
            k = k.to(dtype)
            mm = torch.as_tensor(m_arg, dtype=dtype, device=dev)
            rg = eq.regime
            Dfun, C1fun, C3fun, Ffun, invF_g = self.coefficients(omega, k, mm)

            # ---- interior: two basis solutions, inward r: 1 -> eps ----------
            one = torch.ones((), dtype=dtype, device=dev)
            zero = torch.zeros((), dtype=dtype, device=dev)
            r1 = one
            F1 = Ffun(r1)
            #       u1: P(1)=1, P'(1)=0   |   u2: P(1)=0, P'(1)=1  (w = F P')
            u0 = (one, zero, zero, F1 * one)
            re_ = torch.tensor(gr.axis_epsilon, dtype=dtype, device=dev)
            state = _rk4_linear2(invF_g, u0, r1, re_, gr.n_interior)
            if log_tail(self.case):
                # log-spaced tail eps -> eps_final in t = ln r, where the
                # linear system's coefficients are (r iF, r g)
                def coef_log(t):
                    r = torch.exp(t)
                    iF, g = invF_g(r)
                    return (r * iF, r * g)

                re_final = torch.tensor(gr.axis_epsilon_final, dtype=dtype,
                                        device=dev)
                state = _rk4_linear2(coef_log, state, torch.log(re_),
                                     torch.log(re_final), gr.n_axis_log)
            P1e, w1e, P2e, w2e = state

            # axis condition: m=0: P'(eps)=0 -> w(eps)=0 ; m>=1: P(eps)=0
            is_sausage = mm < 0.5
            a1 = torch.where(is_sausage, w1e, P1e)
            a2 = torch.where(is_sausage, w2e, P2e)

            # interface values at r=1: xi_r = C1 P / C3 + w / r
            C1_1 = C1fun(r1)
            C3_1 = C3fun(r1)
            xi1 = C1_1 * 1.0 / C3_1 + zero          # u1: P=1, w=0
            xi2 = F1 / 1.0                           # u2: P=0, w=F(1)

            # ---- exterior: log-derivative at r=1 of the decaying solution --
            m_e = self.exterior_m(omega, k)
            if gr.exterior_method == "numeric":
                # integrated inward from r_far with tiny start values
                dP_e = self.numeric_exterior(m_e, k, mm)
            else:
                # K_m(sqrt(m_e) r); the floor is 0 in f32
                floor = torch.tensor(1e-300, dtype=dtype, device=dev)
                sq = sqrt(torch.maximum(m_e, floor))
                r0, r1_ = special.kve_ratio_both(sq)
                dP_e = sq * torch.where(is_sausage, r0, r1_)
            P_e = torch.ones_like(dP_e)
            xi_e = dP_e / (rg.rho_e * (omega ** 2 - k ** 2 * rg.vA_e ** 2))

            # ---- determinant -------------------------------------------------
            # twisted jump term J = B_phi(1)^2 - rho_i(1) v_phi(1)^2 (0 for
            # the non-twisted tubes)
            b1, v1 = eq.B_phi(r1), eq.v_phi(r1)
            J = b1 * b1 - eq.rho_i(r1) * (v1 * v1)
            J = torch.where(is_sausage, torch.zeros_like(J), J)
            m1 = xi1 * P_e - xi_e * 1.0    # u1: P_u(1)=1
            m2 = xi2 * P_e - xi_e * 0.0    # u2: P_u(1)=0
            det = a1 * m2 - a2 * m1 + J * xi_e * xi2

            # reference-style % mismatch of xi_r for the combination with the
            # axis condition satisfied, scaled so P(1) = P_e(1) = 1
            B = -(a1 + J * xi_e) / a2
            xi_i = xi1 + B * xi2
            num = torch.abs(xi_e - xi_i)
            den = torch.maximum(torch.abs(xi_e), torch.abs(xi_i))
            mismatch = 100.0 * num / den
            valid = m_e > 0
            return CylinderInterface(det=det, mismatch_pct=mismatch,
                                     valid=valid)

        if m is None:
            return disp
        m_const = float(m)
        return lambda omega, k: disp(omega, k, m_const)

    # -- complex omega (cylinder.py:229-234, :314-315, :379-385) ---------------

    def _complex_plain(self, m, dtype, dual: bool) -> Callable:
        case, eq = self.case, self.eq
        gr = case.grid
        twisted = is_twisted(case)
        numeric = gr.exterior_method == "numeric"
        point = self.twisted_point_fn() if twisted else None

        def disp(omega, k, m_arg):
            global plain_calls
            plain_calls += 1
            if not isinstance(omega, C):
                omega = C.of(omega)
            omega = C(omega.re.to(dtype), omega.im.to(dtype))
            dev = omega.re.device
            k = k.to(dtype)
            mm = torch.as_tensor(m_arg, dtype=dtype, device=dev)
            rg = eq.regime
            one = torch.ones((), dtype=dtype, device=dev)
            zero = torch.zeros((), dtype=dtype, device=dev)
            nil = torch.zeros_like(omega.re)

            def constant(x):
                z = C(x + nil, nil)
                return Dual(z, C(nil, nil)) if dual else z

            om = Dual(omega, C(nil + 1.0, nil)) if dual else omega

            # ---- the chain, and its values at r = 1 -----------------------
            r1 = one
            if twisted:
                def invF_g(r):
                    q = point(r)
                    return self.twisted_invF_g(
                        q, self.twisted_chain(q, om, k, mm))

                c1 = self.twisted_chain(point(r1), om, k, mm)
                F1 = quot(r1 * c1.D.v, c1.C3.v)
                xi1 = quot(c1.C1.v * 1.0, c1.C3.v) + zero
            else:
                invF_g = self.complex_invF_g(om, k, mm)
                D1, A1, _ = self._plain_parts(om, k, mm, r1)
                C3_1 = D1 * A1 + 0.0
                F1 = quot(r1 * D1, C3_1)
                xi1 = czero_over(C3_1)               # C1(1) == 0: 0 / C3(1)

            # ---- interior: two basis solutions, inward r: 1 -> eps ----------
            #       u1: P(1)=1, P'(1)=0   |   u2: P(1)=0, P'(1)=1  (w = F P')
            u0 = (constant(1.0), constant(0.0), constant(0.0), F1)
            re_ = torch.tensor(gr.axis_epsilon, dtype=dtype, device=dev)
            state = _rk4_linear2(invF_g, u0, r1, re_, gr.n_interior)
            if log_tail(case):
                def coef_log(t):
                    r = torch.exp(t)
                    iF, g = invF_g(r)
                    return (r * iF, r * g)

                re_final = torch.tensor(gr.axis_epsilon_final, dtype=dtype,
                                        device=dev)
                state = _rk4_linear2(coef_log, state, torch.log(re_),
                                     torch.log(re_final), gr.n_axis_log)
            P1e, w1e, P2e, w2e = state
            is_sausage = (mm < 0.5) & torch.ones_like(nil, dtype=torch.bool)
            a1 = dwhere(is_sausage, w1e, P1e)
            a2 = dwhere(is_sausage, w2e, P2e)
            xi2 = F1

            # ---- exterior ---------------------------------------------------
            m_e, om2, k2 = self.complex_m_e(om, k)
            if numeric:
                dP_e = self.complex_exterior(m_e, k, mm)
            else:
                # K_m(sqrt(m_e) r), the principal root with no floor
                sq = dsqrt(m_e) if dual else csqrt(m_e)
                r0, r1_ = special.kve_ratio_both_c(sq)
                dP_e = sq * dwhere(is_sausage, r0, r1_)
            xi_e = quot(dP_e, rg.rho_e * (om2 - k2 * rg.vA_e ** 2))

            # ---- determinant (P_e = 1) ---------------------------------------
            b1, v1 = eq.B_phi(r1), eq.v_phi(r1)
            J = b1 * b1 - eq.rho_i(r1) * (v1 * v1)
            J = torch.where(is_sausage, torch.zeros_like(nil), J + nil)
            m1 = xi1 - xi_e                   # u1: P_u(1)=1
            m2 = xi2 - xi_e * 0.0             # u2: P_u(1)=0
            det = a1 * m2 - a2 * m1 + J * xi_e * xi2
            if dual:
                return det.v, det.d
            B = quot(-(a1 + J * xi_e), a2)
            xi_i = xi1 + B * xi2
            num = cabs(xi_e - xi_i)
            den = torch.maximum(cabs(xi_e), cabs(xi_i))
            mismatch = (100.0 * num) / den
            return CylinderInterface(det=det, mismatch_pct=mismatch,
                                     valid=m_e.re > 0)

        if m is None:
            return disp
        m_const = float(m)
        return lambda omega, k: disp(omega, k, m_const)

    def make_dispersion_dual_plain(self, m: int | None = None,
                                   dtype=torch.float64) -> Callable:
        """The plain version of the Newton kernel's shoot: disp(omega, k[,
        m]) -> (det, d det / d omega), complex pairs (`cplx.C`), the
        complex shoot carried on dual numbers in omega (the holomorphic
        jvp of cylinder.py's disp with tangent 1). Complex-omega cases
        only."""
        _check_supported(self.case)
        if not self.case.complex_omega:
            raise ValueError("make_dispersion_dual_plain: the case has real "
                             "omega (complex_omega=False)")
        return self._complex_plain(m, dtype, dual=True)

    def make_dispersion(self, m: int | None = None,
                        dtype=torch.float64) -> Callable:
        """disp(omega, k[, m]) -> CylinderInterface for azimuthal order m
        (0 = sausage, 1 = kink), on 1-D tensors of candidates. With m=None
        the azimuthal order is a third tensor argument, so one call serves
        both mode families. CUDA tensors run the `cylinder_disp` kernel, CPU
        tensors the plain version.

        The callable carries `disp.bisect(lo, hi, k, m, n_iter,
        final_eval=True) -> (root, mismatch)`, the whole bisection of a
        bracket batch (`search.bisect_loop`'s result): one `cylinder_bisect`
        launch on CUDA tensors (m None for a fixed-m disp).

        At complex omega (`case.complex_omega`) omega is a `cplx.C` (or a
        complex tensor), det a `cplx.C`, and CUDA tensors run
        `cylinder_disp_complex`; the callable carries instead
        `disp.newton(omega0, k, m, n_iter, damping, final_eval=False) ->
        omega`, the whole damped Newton iteration of a seed batch, with
        final_eval (omega, disp(omega, k, m)): one `cylinder_newton` launch
        on CUDA tensors, the evaluation its last round; `search.newton_loop`
        over the plain dual shoot, then the plain dispersion, on the CPU (m
        dropped for a fixed-m disp)."""
        _check_supported(self.case)
        from ..kernels.cylinder import cylinder_bisect, cylinder_disp, disp_params
        params = disp_params(self.case)

        def column(m_arg, like):
            mm = torch.as_tensor(m_arg, dtype=dtype, device=like.device)
            return mm.expand_as(like).contiguous()

        if self.case.complex_omega:
            from .complex_omega import complex_dispersion
            from ..kernels.cylinder import (cylinder_disp_complex,
                                            cylinder_newton)
            return complex_dispersion(cylinder_disp_complex, cylinder_newton,
                                      m, dtype, params, column)

        def disp(omega, k, m_arg):
            omega = omega.to(dtype)
            return cylinder_disp(omega, k.to(dtype), column(m_arg, omega),
                                 params)

        def bisect(lo, hi, k, m_arg, n_iter, final_eval=True):
            lo = lo.to(dtype).contiguous()
            return cylinder_bisect(lo, hi.to(dtype).contiguous(),
                                   k.to(dtype).contiguous(),
                                   column(m_arg, lo), n_iter, params,
                                   final_eval)

        if m is None:
            disp.bisect = bisect
            return disp
        m_const = float(m)

        def fixed(omega, k):
            return disp(omega, k, m_const)

        fixed.bisect = (lambda lo, hi, k, _none, n_iter, final_eval=True:
                        bisect(lo, hi, k, m_const, n_iter, final_eval))
        return fixed
