"""Slab dispersion function (vx formulation) in PyTorch.

Port of `eigensolver_tpu.physics.slab` for the real-omega cases. From the
slab centre x = 0 to the edge x = 1 the interior is integrated in one of two
forms:

- density cases (no flow): the self-adjoint flux form, state (vx, w = F vx'),
  d(vx, w)/dx = (w / F, F m0 vx); parity sets the start (sausage (0, F(0)),
  kink (1, 0 F(0)));
- flow cases: the direct form with the shear terms, state (vx, vx'),
  vx'' = -D(x) vx' - coeff(x) vx, where D and coeff carry U' and U''
  (hand-written derivatives, `profiles.make_profile_derivative`, in place of
  the JAX code's `jax.grad`); start (0, 1) for sausage, (1, 0) for kink.

The determinant matches xi = vx / Omega and the total pressure against the
exterior: the exact decaying vx_e = exp(-sqrt(m_e) (x - 1)), or with
exterior_method="numeric" (the reference's own, for parity with its
pickles) vx'/vx at x = 1 of (vx, vx')' = (vx', m_e vx) integrated inward from
x = 1 + W 2 pi / k (`ode.rk4_final_renorm`, slab.py:362-381).

At complex omega (`case.complex_omega`: the Kelvin-Helmholtz growth rates,
slab.py:309-318, :341-358, :384-400, and any case the CLI's `sweep
--complex` makes complex) either form runs on complex numbers carried as
(re, im) pairs of real tensors (`cplx.C`): omega and the state are
complex, k stays real, sqrt(m_e) is the principal root, the numeric
exterior integrates a complex state (`ode.rk4_final_renorm` on pairs), the
mismatch takes the complex modulus, valid is Re m_e > 0, and the
shear-pressure term is on. `make_dispersion_dual_plain` is the same shoot
on dual numbers in omega: (det, d det / d omega) for the Newton iteration,
which the JAX package takes from a holomorphic `jax.jvp` (search.py:
592-594). Each quotient by one divisor shares its divisions
(`cplx.divisor`).

`make_dispersion` returns the batched function the search calls; it hands
its inputs to `kernels.slab.slab_disp`, which launches the CUDA kernel on a
CUDA tensor and runs the plain version here (`make_dispersion_plain`) on a
CPU tensor. The plain version is the JAX code's arithmetic, expression for
expression, with a Python loop over RK4 steps on tensors of candidates in
place of `lax.scan` over a vmapped scalar.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from ..config import CaseConfig, ProfileKind
from ..cplx import C, cabs, csqrt, divisor
from ..dual import Dual, dsqrt
from ..equilibrium import Equilibrium, make_equilibrium
from ..ode import LinearRHS, rk4_final_renorm
from ..profiles import div, make_profile_derivative, rdiv, sqrt

# plain (eager PyTorch) dispersion evaluations since the last reset
plain_calls = 0


def _rk4_linear(apply, coef, y0, x0, x1, n_steps: int):
    """Classical RK4 for a linear two-component system with a tuple state:
    `coef(x)` at the 3 distinct abscissae (x, x + h/2, x + h) of each step,
    `apply(c, y)` the right-hand side; the abscissa is x0 + i h, not an
    accumulated sum (slab.py:41-113, both forms)."""
    h = div(x1 - x0, n_steps)

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


def _apply_flux(c, y):
    """d(vx, w)/dx = (w invF, w_rate vx), c = (invF, w_rate)."""
    invF, w_rate = c
    vx, w = y
    return (w * invF, w_rate * vx)


def _apply_shear(c, y):
    """d(vx, dvx)/dx = (dvx, -D dvx - coeff vx), c = (D, coeff)."""
    Dx, coeff = c
    vx, dvx = y
    return (dvx, -Dx * dvx - coeff * vx)


class SlabInterface(NamedTuple):
    det: torch.Tensor
    mismatch_pct: torch.Tensor
    valid: torch.Tensor


def _check_supported(case: CaseConfig):
    if case.grid.exterior_method not in ("bessel", "numeric"):
        raise ValueError(
            f"unknown exterior_method {case.grid.exterior_method!r}")


def _sq(x):
    # k**2, Om**2: integer powers lower to products in XLA, as here
    return x * x


class ShearCand(NamedTuple):
    """A candidate of the complex shear chain: omega (complex), k and the
    products of k that every abscissa repeats, formed as the JAX expression
    forms them (k**2 is k k, k**4 (k k)(k k); the regime's c_i0^2, vA_i0^2,
    cT^2 and c_i0^2 + vA_i0^2 are Python floats there)."""
    omega: C
    k: torch.Tensor
    twok: torch.Tensor
    k2c2: torch.Tensor
    k2a2: torch.Tensor
    k2cT2: torch.Tensor
    k4cT2c2: torch.Tensor
    ca: float


def shear_cand(omega: C, k: torch.Tensor, c2: float, a2: float) -> ShearCand:
    cT2 = c2 * a2 / (c2 + a2)
    k2 = k * k
    return ShearCand(omega=omega, k=k, twok=2.0 * k, k2c2=k2 * c2,
                     k2a2=k2 * a2, k2cT2=k2 * cT2,
                     k4cT2c2=(k2 * k2) * cT2 * c2, ca=c2 + a2)


def complex_shear_coef(c: ShearCand, U, dU, ddU, legacy: bool, dual: bool):
    """make_shear_coef (slab.py:247-281) at complex omega, at the abscissa
    whose x-only values are (U, U', U''): (D, coeff), or with `dual` the
    pair of `Dual`s (value, d/d omega). Omega = omega - k U, so Omega' = 1
    and (Omega^2)' = Omega + Omega; a quotient's derivative is the rule of
    `dual.Dual`, (a' - q b') / b, by the divisor that its value used. The
    kernels (csrc/slab_complex.cu::shear_coef) repeat these operations in
    this order."""
    Om = c.omega - c.k * U
    Om2 = Om * Om
    A = c.k2c2 - Om2
    B = c.k2a2 - Om2
    G0 = c.k2cT2 - Om2
    iden = divisor(c.ca * G0)
    m0 = (A * B) / iden
    kdU = c.twok * dU
    iOm = divisor(Om)
    E = Om2 - c.k2c2
    G = Om2 - c.k2cT2
    if legacy:
        iH = divisor(c.ca * G)
        t3 = c.k4cT2c2 / iH
        iQ = divisor(Om * E)
        Dx = (kdU * (G + t3)) / iQ
    else:
        iE, iG = divisor(E), divisor(G)
        t1 = Om2 / iE
        t2 = c.k2cT2 / iG
        Dx = (kdU * (t1 - t2)) / iOm
    s1 = (c.k * ddU) / iOm
    s2 = ((c.k * dU) * Dx) / iOm
    coeff = (s1 + s2) - m0
    if not dual:
        return Dx, coeff
    dOm2 = Om + Om
    dG0 = -dOm2
    dm0 = ((-dOm2) * B + A * (-dOm2) - m0 * (c.ca * dG0)) / iden
    if legacy:
        dt3 = (-(t3 * (c.ca * dOm2))) / iH
        dQ = E + Om * dOm2
        dDx = (kdU * (dOm2 + dt3) - Dx * dQ) / iQ
    else:
        dt1 = (dOm2 - t1 * dOm2) / iE
        dt2 = (-(t2 * dOm2)) / iG
        dDx = (kdU * (dt1 - dt2) - Dx) / iOm
    ds1 = (-s1) / iOm
    ds2 = ((c.k * dU) * dDx - s2) / iOm
    dcoeff = (ds1 + ds2) - dm0
    return Dual(Dx, dDx), Dual(coeff, dcoeff)


class FluxCand(NamedTuple):
    """A candidate of the complex flux chain: k k and Omega^2 (a density
    slab has no flow, so Omega = omega - k U_i is the same at every x), and
    on the dual pass nd = -(Omega + Omega), the derivative of k^2 c^2 -
    Omega^2 (and of k^2 cT^2 - Omega^2, k^2 vA^2 - Omega^2)."""
    k2: torch.Tensor
    Om2: C
    nd: Optional[C]


def flux_cand(Om: C, k: torch.Tensor, dual: bool) -> FluxCand:
    return FluxCand(k2=k * k, Om2=Om * Om, nd=-(Om + Om) if dual else None)


def flux_point(eq: Equilibrium, x: torch.Tensor):
    """The flux chain's values that depend on x alone (slab.py:221-227):
    rho, c^2, vA^2, cT^2 and rho (c^2 + vA^2), as the kernels table them."""
    rho = eq.rho_i(x)
    c2 = eq.c_i(x) ** 2
    a2 = eq.vA_i(x) ** 2
    cT2 = c2 * a2 / (c2 + a2)
    return rho, c2, a2, cT2, rho * (c2 + a2)


def complex_flux_coef(c: FluxCand, q, dual: bool):
    """make_flux_coef (slab.py:215-230) at complex omega, at the abscissa
    whose x-only values are q (`flux_point`): (1/F, F m0), or with `dual`
    the pair of `Dual`s. The kernels (csrc/slab_complex.cu::flux_coef)
    repeat these operations in this order."""
    rho, c2, a2, cT2, rho_csum = q
    A = c.k2 * c2 - c.Om2
    iden = divisor(rho_csum * (c.k2 * cT2 - c.Om2))
    inv_F = A / iden
    w_rate = rho * (c.k2 * a2 - c.Om2)
    if not dual:
        return inv_F, w_rate
    dinv_F = (c.nd - inv_F * (rho_csum * c.nd)) / iden
    return Dual(inv_F, dinv_F), Dual(w_rate, rho * c.nd)


def complex_flux_F(c: FluxCand, q, dual: bool):
    """interior_F (slab.py:167-175) at the abscissa of q at complex omega,
    or its `Dual`: the flux form's start reads F(0)."""
    rho, c2, a2, cT2, rho_csum = q
    iY = divisor(c.k2 * c2 - c.Om2)
    F = (rho_csum * (c.k2 * cT2 - c.Om2)) / iY
    if not dual:
        return F
    return Dual(F, (rho_csum * c.nd - F * c.nd) / iY)


class ComplexEdge(NamedTuple):
    """The interface's values that do not depend on the state (slab.py:
    146-165, :352-358, :384-386): the exterior m_e, its root, p_e, xi_e,
    and in the shear form F(1)/Omega_i and the shear-pressure factor (None
    in the flux form), 1/Omega_i (a divisor); with `dual` each a `Dual`."""
    m_e: object
    sqm: object
    p_e: object
    xi_e: object
    W: object
    add: object
    iOm_i: object


def complex_edge(ph: "SlabPhysics", omega: C, k: torch.Tensor,
                 shear_pressure: bool, dual: bool,
                 shear: bool = True) -> ComplexEdge:
    rg, eq = ph.eq.regime, ph.eq
    dev, dt = k.device, k.dtype
    one = torch.ones((), dtype=dt, device=dev)
    k2 = k * k
    Om_e = omega - k * rg.U_e
    Om_e2 = Om_e * Om_e
    X1 = k2 * rg.vA_e ** 2 - Om_e2
    X2 = k2 * rg.c_e ** 2 - Om_e2
    X3 = k2 * rg.cT_e ** 2 - Om_e2
    iDm = divisor((rg.vA_e ** 2 + rg.c_e ** 2) * X3)
    m_e = (X1 * X2) / iDm
    pe_coef = rg.rho_e * (rg.vA_e ** 2 + rg.c_e ** 2)
    iD2 = divisor(Om_e * X2)
    p_e = (pe_coef * X3) / iD2
    iOm_e = divisor(Om_e)
    xi_e = 1.0 / iOm_e
    Om_i = omega - k * eq.U_i(one)
    iOm_i = divisor(Om_i)
    W = add = None                     # the flux form: PT_i = w / Omega_i
    if shear:
        # the interior at x = 1 (interior_F, slab.py:167-175)
        Om_i2 = Om_i * Om_i
        c2 = eq.c_i(one) ** 2
        a2 = eq.vA_i(one) ** 2
        cT2 = c2 * a2 / (c2 + a2)
        Y2 = k2 * c2 - Om_i2
        iY2 = divisor(Y2)
        F1 = ((eq.rho_i(one) * (c2 + a2)) * (k2 * cT2 - Om_i2)) / iY2
        W = F1 / iOm_i
        kdU1 = -(k * ph.flow_derivative(1)(one))
        add = kdU1 / iOm_i if shear_pressure else None
    if not dual:
        return ComplexEdge(m_e, csqrt(m_e), p_e, xi_e, W, add, iOm_i)
    dOm_e2 = Om_e + Om_e
    dX = -dOm_e2                       # X1' = X2' = X3'
    dm_e = (dX * X2 + X1 * dX - m_e * ((rg.vA_e ** 2 + rg.c_e ** 2) * dX)
            ) / iDm
    dp_e = ((pe_coef * dX) - p_e * (X2 + Om_e * dX)) / iD2
    dxi_e = (-xi_e) / iOm_e
    if shear:
        dOm_i2 = Om_i + Om_i
        dF1 = ((eq.rho_i(one) * (c2 + a2)) * (-dOm_i2) - F1 * (-dOm_i2)
               ) / iY2
        W = Dual(W, (dF1 - W) / iOm_i)
        add = None if add is None else Dual(add, (-add) / iOm_i)
    return ComplexEdge(Dual(m_e, dm_e), dsqrt(Dual(m_e, dm_e)),
                       Dual(p_e, dp_e), Dual(xi_e, dxi_e), W, add, iOm_i)


def _over_Om_i(z, iOm_i):
    """z / Omega_i, and of a `Dual` its derivative (z' - q) / Omega_i
    (Omega_i' = 1)."""
    if isinstance(z, Dual):
        q = z.v / iOm_i
        return Dual(q, (z.d - q) / iOm_i)
    return z / iOm_i


def complex_det(e: ComplexEdge, vx, y1, ext=None):
    """det = xi_i PT_e - xi_e PT_i from the state at x = 1 (slab.py:
    333-388): (vx, vx') in the shear form, (vx, w) in the flux form (PT_i
    = w / Omega_i); PT_e = p_e ext with the numeric exterior's vx'/vx
    `ext`, else p_e (-sqrt(m_e)); values or `Dual`s."""
    if e.W is None:
        PT_i = _over_Om_i(y1, e.iOm_i)
    elif e.add is not None:
        PT_i = e.W * (y1 - e.add * vx)
    else:
        PT_i = e.W * y1
    PT_e = e.p_e * ext if ext is not None else e.p_e * (-e.sqm)
    xi_i = _over_Om_i(vx, e.iOm_i)
    return xi_i * PT_e - e.xi_e * PT_i, xi_i, PT_e, PT_i


def complex_mismatch(e: ComplexEdge, xi_i: C, PT_e: C, PT_i: C):
    """The % total-pressure mismatch once xi is matched (slab.py:390-395),
    with the complex modulus."""
    s = e.xi_e / divisor(xi_i)
    sPT = s * PT_i
    num = cabs(PT_e - sPT)
    den = torch.maximum(cabs(PT_e), cabs(sPT))
    return (100.0 * num) / den


@dataclasses.dataclass(frozen=True)
class SlabPhysics:
    case: CaseConfig
    eq: Equilibrium

    @classmethod
    def from_case(cls, case: CaseConfig) -> "SlabPhysics":
        return cls(case=case, eq=make_equilibrium(case))

    @property
    def has_flow(self) -> bool:
        case = self.case
        return (case.regime.U_i0 != 0.0 or case.regime.U_e != 0.0
                or case.flow_profile.kind != ProfileKind.UNIFORM)

    def flow_derivative(self, order: int):
        """U_i' or U_i'' (closed form; the JAX code's elementwise_grad)."""
        rg = self.case.regime
        if not self.has_flow:
            return torch.zeros_like
        return make_profile_derivative(self.case.flow_profile, rg.U_i0,
                                       rg.U_e, order)

    # -- coefficient functions (slab.py:146-184) ------------------------------

    def exterior_m(self, omega, k):
        rg = self.eq.regime
        Om = omega - k * rg.U_e
        num = (k ** 2 * rg.vA_e ** 2 - Om ** 2) * (k ** 2 * rg.c_e ** 2 - Om ** 2)
        den = (rg.vA_e ** 2 + rg.c_e ** 2) * (k ** 2 * rg.cT_e ** 2 - Om ** 2)
        return num / den

    def exterior_PT_coeff(self, omega, k):
        rg = self.eq.regime
        Om = omega - k * rg.U_e
        return (rg.rho_e * (rg.vA_e ** 2 + rg.c_e ** 2)
                * (k ** 2 * rg.cT_e ** 2 - Om ** 2)
                / (Om * (k ** 2 * rg.c_e ** 2 - Om ** 2)))

    def numeric_exterior(self, m_e, k):
        """vx'/vx at x = 1 of the exterior solution (slab.py:362-381):
        n_exterior RK4 steps of (vx, vx')' = (vx', m_e vx) from x = 1 + L,
        L = W 2 pi / k (W 2 pi a Python float, then divided in k's dtype),
        down to 1, from (1e-8, -1e-15), renormalised every 64 steps."""
        gr = self.case.grid
        x0 = 1.0 + rdiv(gr.exterior_wavelengths * 2.0 * math.pi, k)
        one = torch.ones((), dtype=k.dtype, device=k.device)
        y0 = tuple(torch.full((), v, dtype=k.dtype, device=k.device)
                   for v in (1e-8, -1e-15))
        (vx, dvx), _ = rk4_final_renorm(lambda x, y: (y[1], m_e * y[0]), y0,
                                        x0, one, gr.n_exterior)
        return dvx / vx

    def complex_exterior(self, m_e, k):
        """`numeric_exterior` at complex omega: the state complex (m_e a
        `cplx.C`), or on the dual pass `Dual`s of complex pairs (m_e a
        `Dual`), from the same real start; vx'/vx at x = 1, the complex
        quotient (slab.py:378-379)."""
        gr = self.case.grid
        x0 = 1.0 + rdiv(gr.exterior_wavelengths * 2.0 * math.pi, k)
        one = torch.ones((), dtype=k.dtype, device=k.device)
        nil = torch.zeros((), dtype=k.dtype, device=k.device)
        y0 = tuple(C(torch.full((), v, dtype=k.dtype, device=k.device), nil)
                   for v in (1e-8, -1e-15))
        if isinstance(m_e, Dual):
            y0 = tuple(Dual(y, C(nil, nil)) for y in y0)
        (vx, dvx), _ = rk4_final_renorm(lambda x, y: (y[1], m_e * y[0]), y0,
                                        x0, one, gr.n_exterior)
        return dvx / vx

    def interior_F(self, x, omega, k):
        eq = self.eq
        Om = omega - k * eq.U_i(x)
        c2 = eq.c_i(x) ** 2
        a2 = eq.vA_i(x) ** 2
        cT2 = c2 * a2 / (c2 + a2)
        return (eq.rho_i(x) * (c2 + a2) * (k ** 2 * cT2 - Om ** 2)
                / (k ** 2 * c2 - Om ** 2))

    def interior_m0(self, x, omega, k):
        eq = self.eq
        Om = omega - k * eq.U_i(x)
        c2 = eq.c_i(x) ** 2
        a2 = eq.vA_i(x) ** 2
        cT2 = c2 * a2 / (c2 + a2)
        return ((k ** 2 * c2 - Om ** 2) * (k ** 2 * a2 - Om ** 2)
                / ((c2 + a2) * (k ** 2 * cT2 - Om ** 2)))

    def make_flux_coef(self, omega, k):
        """coef(x) -> (1/F, F m0) of the flux form (slab.py:215-230)."""
        eq = self.eq

        def coef(x):
            Om = omega - k * eq.U_i(x)
            rho = eq.rho_i(x)
            c2 = eq.c_i(x) ** 2
            a2 = eq.vA_i(x) ** 2
            cT2 = c2 * a2 / (c2 + a2)
            inv_F = (k ** 2 * c2 - Om ** 2) / (
                rho * (c2 + a2) * (k ** 2 * cT2 - Om ** 2))
            w_rate = rho * (k ** 2 * a2 - Om ** 2)
            return inv_F, w_rate

        return coef

    def make_shear_coef(self, omega, k):
        """coef(x) -> (D(x), coeff(x)) of the shear form (slab.py:247-281):
        the regime's c_i0^2, vA_i0^2 and cT^2 are Python floats there,
        rounded at use, and k**4 is (k k)(k k) as XLA lowers it."""
        case, eq = self.case, self.eq
        dU = self.flow_derivative(1)
        ddU = self.flow_derivative(2)
        rgl = eq.regime
        c2 = rgl.c_i0 ** 2
        a2 = rgl.vA_i0 ** 2
        cT2 = c2 * a2 / (c2 + a2)

        def coef(x):
            Om = omega - k * eq.U_i(x)
            dUx = dU(x)
            ddUx = ddU(x)
            k2 = _sq(k)
            Om2 = _sq(Om)
            m0 = ((k2 * c2 - Om2) * (k2 * a2 - Om2)
                  / ((c2 + a2) * (k2 * cT2 - Om2)))
            if case.shear_D_legacy:
                Dx = (2.0 * k * dUx
                      * ((Om2 - k2 * cT2)
                         + (_sq(k2) * cT2 * c2)
                         / ((c2 + a2) * (Om2 - k2 * cT2)))
                      / (Om * (Om2 - k2 * c2)))
            else:
                Dx = (2.0 * k * dUx
                      * (Om2 / (Om2 - k2 * c2)
                         - (k2 * cT2) / (Om2 - k2 * cT2)) / Om)
            coeff = (k * ddUx / Om) + (k * dUx * Dx / Om) - m0
            return Dx, coeff

        return coef

    def make_flux_rhs(self, omega, k) -> LinearRHS:
        """The flux form's right-hand side (slab.py:195-213), state (vx,
        w = F vx'): d(vx, w)/dx = (w / F, F m0 vx), the products formed
        from `make_flux_coef`, for the eigenfunctions."""
        coef = self.make_flux_coef(omega, k)

        def matrix(x):
            inv_F, w_rate = coef(x)
            return 0.0, inv_F, w_rate, 0.0

        return LinearRHS(matrix)

    def make_shear_rhs(self, omega, k) -> LinearRHS:
        """The shear form's right-hand side (slab.py:232-245), state (vx,
        vx'): vx'' = -D(x) vx' - coeff(x) vx from `make_shear_coef`, for
        the eigenfunctions."""
        coef = self.make_shear_coef(omega, k)

        def matrix(x):
            Dx, coeff = coef(x)
            return 0.0, 1.0, -coeff, -Dx

        return LinearRHS(matrix)

    # -- dispersion function (slab.py:285-406) ----------------------------------

    def make_dispersion_plain(self, parity: Optional[int] = None,
                              dtype=torch.float64,
                              include_shear_pressure: Optional[bool] = None
                              ) -> Callable:
        """The plain version: disp(omega, k[, parity]) -> SlabInterface on
        tensors of candidates, on any device, in eager PyTorch. parity 0 =
        sausage (vx odd), 1 = kink (vx even); with parity=None it is a third
        tensor argument."""
        _check_supported(self.case)
        if self.case.complex_omega:
            return self._complex_plain(parity, dtype, include_shear_pressure,
                                       dual=False)
        case, eq = self.case, self.eq
        n_steps = case.grid.n_interior
        numeric = case.grid.exterior_method == "numeric"
        has_flow = self.has_flow
        if include_shear_pressure is None:
            include_shear_pressure = case.complex_omega
        dU = self.flow_derivative(1)

        def disp(omega, k, parity_arg):
            global plain_calls
            plain_calls += 1
            dev = omega.device
            omega = omega.to(dtype)
            k = k.to(dtype)
            par = torch.as_tensor(parity_arg, dtype=dtype, device=dev)
            zero = torch.zeros((), dtype=dtype, device=dev)
            one = torch.ones((), dtype=dtype, device=dev)

            m_e = self.exterior_m(omega, k)
            p_e = self.exterior_PT_coeff(omega, k)
            sqm = sqrt(torch.maximum(m_e, torch.zeros_like(m_e)))

            if not has_flow:
                coef = self.make_flux_coef(omega, k)
                F0 = self.interior_F(zero, omega, k)
                # sausage (par=0): vx odd => y0 = (0, F0); kink: (1, 0 F0)
                y0 = (par * torch.ones_like(F0), (1.0 - par) * F0)
                vx_b, w_b = _rk4_linear(_apply_flux, coef, y0, zero, one,
                                        n_steps)
                Om_i = omega - k * eq.U_i(one)
                PT_i = w_b / Om_i
            else:
                coef = self.make_shear_coef(omega, k)
                y0 = (par, 1.0 - par)
                vx_b, dvx_b = _rk4_linear(_apply_shear, coef, y0, zero, one,
                                          n_steps)
                Om_i = omega - k * eq.U_i(one)
                F1 = self.interior_F(one, omega, k)
                PT_i = (F1 / Om_i) * dvx_b
                if include_shear_pressure:
                    add = -(k * dU(one)) / Om_i
                    PT_i = (F1 / Om_i) * (dvx_b - add * vx_b)

            Om_e = omega - k * eq.regime.U_e
            if numeric:
                PT_e = p_e * self.numeric_exterior(m_e, k)
            else:
                PT_e = p_e * (-sqm)             # vx_e = exp(-sqm (x - 1))
            xi_e = rdiv(1.0, Om_e)
            xi_i = vx_b / Om_i
            det = xi_i * PT_e - xi_e * PT_i

            # reference-style % mismatch of PT once xi is matched
            s = xi_e / xi_i
            num = torch.abs(PT_e - s * PT_i)
            den = torch.maximum(torch.abs(PT_e), torch.abs(s * PT_i))
            mismatch = 100.0 * num / den
            valid = m_e > 0
            return SlabInterface(det=det, mismatch_pct=mismatch, valid=valid)

        if parity is None:
            return disp
        p_const = float(parity)
        return lambda omega, k: disp(omega, k, p_const)

    # -- complex omega (slab.py:309-318, :341-358, :384-400) ----------------

    def _complex_plain(self, parity, dtype, include_shear_pressure,
                       dual: bool) -> Callable:
        case, eq = self.case, self.eq
        n_steps = case.grid.n_interior
        shear = self.has_flow
        numeric = case.grid.exterior_method == "numeric"
        if include_shear_pressure is None:
            include_shear_pressure = case.complex_omega
        legacy = case.shear_D_legacy
        dU = self.flow_derivative(1)
        ddU = self.flow_derivative(2)
        rgl = eq.regime

        def disp(omega, k, parity_arg):
            global plain_calls
            plain_calls += 1
            if not isinstance(omega, C):
                omega = C.of(omega)
            omega = C(omega.re.to(dtype), omega.im.to(dtype))
            dev = omega.re.device
            k = k.to(dtype)
            par = torch.as_tensor(parity_arg, dtype=dtype, device=dev)
            zero = torch.zeros((), dtype=dtype, device=dev)
            one = torch.ones((), dtype=dtype, device=dev)
            nil = torch.zeros_like(par)

            def constant(z):
                return Dual(z, C(nil, nil)) if dual else z

            if shear:
                cand = shear_cand(omega, k, rgl.c_i0 ** 2, rgl.vA_i0 ** 2)

                def coef(x):
                    return complex_shear_coef(cand, eq.U_i(x), dU(x), ddU(x),
                                              legacy, dual)

                apply = _apply_shear
                y0 = (constant(C(par, nil)), constant(C(1.0 - par, nil)))
            else:
                # sausage (par = 0): (0, F(0)); kink: (1, 0 F(0))
                fc = flux_cand(omega - k * eq.U_i(zero), k, dual)

                def coef(x):
                    return complex_flux_coef(fc, flux_point(eq, x), dual)

                apply = _apply_flux
                F0 = complex_flux_F(fc, flux_point(eq, zero), dual)
                y0 = (constant(C(par, nil)), (1.0 - par) * F0)
            vx_b, y1_b = _rk4_linear(apply, coef, y0, zero, one, n_steps)
            e = complex_edge(self, omega, k, include_shear_pressure, dual,
                             shear)
            ext = self.complex_exterior(e.m_e, k) if numeric else None
            det, xi_i, PT_e, PT_i = complex_det(e, vx_b, y1_b, ext)
            if dual:
                return det.v, det.d
            mism = complex_mismatch(e, xi_i, PT_e, PT_i)
            return SlabInterface(det=det, mismatch_pct=mism,
                                 valid=e.m_e.re > 0)

        if parity is None:
            return disp
        p_const = float(parity)
        return lambda omega, k: disp(omega, k, p_const)

    def make_dispersion_dual_plain(self, parity: Optional[int] = None,
                                   dtype=torch.float64,
                                   include_shear_pressure: Optional[bool] = None
                                   ) -> Callable:
        """The plain version of the Newton kernel's shoot: disp(omega, k[,
        parity]) -> (det, d det / d omega), complex pairs (`cplx.C`), the
        complex shoot carried on dual numbers in omega (the holomorphic
        jvp of slab.py's disp with tangent 1). Complex-omega cases only."""
        _check_supported(self.case)
        if not self.case.complex_omega:
            raise ValueError("make_dispersion_dual_plain: the case has real "
                             "omega (complex_omega=False)")
        return self._complex_plain(parity, dtype, include_shear_pressure,
                                   dual=True)

    def make_dispersion(self, parity: Optional[int] = None, dtype=torch.float64,
                        include_shear_pressure: Optional[bool] = None
                        ) -> Callable:
        """disp(omega, k[, parity]) -> SlabInterface on 1-D tensors of
        candidates. With parity=None the parity is a third tensor argument,
        so one call serves both mode families. CUDA tensors run the
        `slab_disp` kernel, CPU tensors the plain version.

        The callable carries `disp.bisect(lo, hi, k, parity, n_iter,
        final_eval=True) -> (root, mismatch)`, the whole bisection of a
        bracket batch (`search.bisect_loop`'s result): one `slab_bisect`
        launch on CUDA tensors (parity None for a fixed-parity disp). With
        parity=None it also carries `disp.both_parities(omega, k)`: the
        SlabInterface of disp(omega, k, 0) and disp(omega, k, 1)
        concatenated, as one call on (omega, k) repeated twice with the
        parity column (0 ... 0, 1 ... 1) gives it; on CUDA tensors one
        launch of the paired scan (`kernels.slab.slab_disp_pairs`), which
        shares each (omega, k)'s chain and exterior between its parities.

        At complex omega (`case.complex_omega`) omega is a `cplx.C` (or a
        complex tensor), det a `cplx.C`, and CUDA tensors run
        `slab_disp_complex`; the callable carries instead `disp.newton(
        omega0, k, parity, n_iter, damping, final_eval=False) -> omega`,
        the whole damped Newton iteration of a seed batch, with final_eval
        (omega, disp(omega, k, parity)): one `slab_newton` launch on CUDA
        tensors, the evaluation its last round; `search.newton_loop` over
        the plain dual shoot, then the plain dispersion, on the CPU (parity
        dropped for a fixed-parity disp)."""
        _check_supported(self.case)
        from ..kernels.slab import (disp_params, slab_bisect, slab_disp,
                                    slab_disp_pairs)
        if include_shear_pressure is None:
            include_shear_pressure = self.case.complex_omega
        params = disp_params(self.case, include_shear_pressure)

        def column(parity_arg, like):
            par = torch.as_tensor(parity_arg, dtype=dtype, device=like.device)
            return par.expand_as(like).contiguous()

        if self.case.complex_omega:
            from .complex_omega import complex_dispersion
            from ..kernels.slab import slab_disp_complex, slab_newton
            return complex_dispersion(slab_disp_complex, slab_newton, parity,
                                      dtype, params, column)

        def disp(omega, k, parity_arg):
            omega = omega.to(dtype)
            return slab_disp(omega, k.to(dtype), column(parity_arg, omega),
                             params)

        def bisect(lo, hi, k, parity_arg, n_iter, final_eval=True):
            lo = lo.to(dtype).contiguous()
            return slab_bisect(lo, hi.to(dtype).contiguous(),
                               k.to(dtype).contiguous(),
                               column(parity_arg, lo), n_iter, params,
                               final_eval)

        def both_parities(omega, k):
            return slab_disp_pairs(omega.to(dtype).contiguous(),
                                   k.to(dtype).contiguous(), params)

        if parity is None:
            disp.bisect = bisect
            disp.both_parities = both_parities
            return disp
        p_const = float(parity)

        def fixed(omega, k):
            return disp(omega, k, p_const)

        fixed.bisect = (lambda lo, hi, k, _none, n_iter, final_eval=True:
                        bisect(lo, hi, k, p_const, n_iter, final_eval))
        return fixed
