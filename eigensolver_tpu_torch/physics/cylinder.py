"""Cylinder dispersion function (Hain-Lust P_T formulation) in PyTorch.

Port of `eigensolver_tpu.physics.cylinder` for the non-twisted, real-omega
cases (density and axial-flow tubes) with the analytic ("bessel") exterior.
Two basis solutions (P, w = F P') are integrated inward from r = 1 to eps
and on down a log-spaced tail to eps_final, and the 2x2 determinant

    D(omega, k) = axis(u1) * match(u2) - axis(u2) * match(u1)

combines the axis condition (kink: P(eps) = 0; sausage: P'(eps) = 0) with
continuity of xi_r against the decaying exterior K_m(sqrt(m_e) r).

`make_dispersion` returns the batched function the search calls. It casts
its inputs to the working dtype and hands them to
`kernels.cylinder.cylinder_disp`, which launches the CUDA kernel on a CUDA
tensor and runs the plain version here (`make_dispersion_plain`) on a CPU
tensor. The plain version is the JAX code's arithmetic, expression for
expression, with a Python loop over RK4 steps on tensors of candidates in
place of `lax.scan` over a vmapped scalar.

Not ported yet: twisted (rotational-flow / magnetic-twist) cases, which need
d(r C1/C3)/dr (ROADMAP A9); complex omega (A10); the numeric exterior (A8).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..config import CaseConfig
from ..equilibrium import Equilibrium, make_equilibrium
from .. import special
from ..profiles import div, sqrt

# plain (eager PyTorch) dispersion evaluations since the last reset
plain_calls = 0


def _zero_over(x):
    """0 / x: NaN where x is 0 or NaN, else a signed zero."""
    return torch.zeros_like(x) / x


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


def _check_supported(case: CaseConfig):
    if case.twist_profile is not None or case.b_twist_profile is not None:
        raise NotImplementedError(
            "twisted cylinder cases need d(r C1/C3)/dr: ROADMAP A9")
    if case.complex_omega:
        raise NotImplementedError("complex omega: ROADMAP A10")
    if case.grid.exterior_method != "bessel":
        raise NotImplementedError(
            f"exterior_method={case.grid.exterior_method!r}: ROADMAP A8")


@dataclasses.dataclass(frozen=True)
class CylinderPhysics:
    case: CaseConfig
    eq: Equilibrium

    @classmethod
    def from_case(cls, case: CaseConfig) -> "CylinderPhysics":
        return cls(case=case, eq=make_equilibrium(case))

    def coefficients(self, omega, k, m):
        """Closed-form coefficient functions of r for the non-twisted chain:
        (Dfun, C1fun, C3fun, Ffun, invF_g).

        With v_phi == B_phi == 0, C1 == B == C3diff == 0 identically, so the
        chain reduces to D, A = rho (s^2 - wA^2), C2, C3 = D A + B,
        F = r D / C3, 1/F = A/r + B/(r D) and
        g = -d(r C1/C3)/dr - r (C2 - C1^2/C3)/D. Each zero-valued term is
        kept only as what it does to the NaN pattern (`_zero_over`); the
        rest is the JAX chain's order of operations."""
        eq = self.eq

        def parts(r):
            rho = eq.rho_i(r)
            ci = eq.c_i(r)
            vA = eq.vA_i(r)
            shift = omega - k * eq.U_i(r)          # omega - m v_phi/r - k U
            alf = k * eq.B_i(r) / sqrt(rho)  # m B_phi/r + k B_z/sqrt(rho)
            csum = ci * ci + vA * vA
            cusp = alf * ci / sqrt(csum)
            s2 = shift * shift
            da = s2 - alf * alf
            dc = s2 - cusp * cusp
            D = rho * csum * da * dc
            A = rho * da                           # + r dC3diff/dr == 0
            C2 = s2 * s2 - csum * (m * m / (r * r) + k * k) * dc
            return D, A, C2

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
        the azimuthal order is a third tensor argument."""
        _check_supported(self.case)
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
            if gr.axis_epsilon_final < gr.axis_epsilon:
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

            # ---- exterior: decaying K_m solution, log-derivative at r=1 -----
            m_e = self.exterior_m(omega, k)
            floor = torch.tensor(1e-300, dtype=dtype, device=dev)  # 0 in f32
            sq = sqrt(torch.maximum(m_e, floor))
            r0, r1_ = special.kve_ratio_both(sq)
            dP_e = sq * torch.where(is_sausage, r0, r1_)
            P_e = torch.ones_like(dP_e)
            xi_e = dP_e / (rg.rho_e * (omega ** 2 - k ** 2 * rg.vA_e ** 2))

            # ---- determinant -------------------------------------------------
            # twisted jump term J = B_phi(1)^2 - rho_i(1) v_phi(1)^2 (0 here)
            J = eq.B_phi(r1) ** 2 - eq.rho_i(r1) * eq.v_phi(r1) ** 2
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
        launch on CUDA tensors (m None for a fixed-m disp)."""
        _check_supported(self.case)
        from ..kernels.cylinder import cylinder_bisect, cylinder_disp, disp_params
        params = disp_params(self.case)

        def column(m_arg, like):
            mm = torch.as_tensor(m_arg, dtype=dtype, device=like.device)
            return mm.expand_as(like).contiguous()

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
