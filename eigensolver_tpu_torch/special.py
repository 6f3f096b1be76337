"""Modified Bessel functions I_m, K_m (m = 0, 1) and the logarithmic
derivative of K_m for real and complex tensors, on any device.

Port of `eigensolver_tpu.special`: `kve_ratio_both` / `kve_ratio` and
their helpers `_series_ik` and `_cf2_h`, the same series, term counts,
continued fraction and branch point, operation for operation. This is the
plain version of the CUDA kernel behind `kernels.bessel.kve_ratio_both`.
The unscaled `k0`, `k1` (the series for |z| <= 9, the asymptotic expansion
`_asymp_k_scaled` beyond), `i0`, `i1` and `ive_ratio` are the uniform
limit's analytic checks.

`kve_ratio_both_c` is the same evaluation at complex z (Re z > 0) on
complex pairs (`cplx.C`), or on duals of them in omega (`dual.Dual`) for the
Newton pass of the complex cylinder: the plain version of the device
function `csrc/kve_complex.cuh`. The series runs all its 24 terms there.
"""
from __future__ import annotations

import math

import torch

from .cplx import C, cabs
from .dual import Dual, divn, dlog, dwhere, quot, rquot, value
from .profiles import div, rdiv, sqrt

_EULER_GAMMA = 0.5772156649015328606
_N_SERIES = 24          # (z^2/4)^k / (k!)^2 converges ~1e-16 by k=24 at |z|=9
_N_ASYMP = 10
_N_CF2 = 60


def _series_ik(z, m: int):
    """(I_m, K_m) of z by their ascending series (valid |z| <~ 9)."""
    z2 = 0.25 * z * z
    half_log = torch.log(0.5 * z)
    one = torch.ones_like(z)
    if m == 0:
        # K_0 = -(log(z/2)+gamma) I_0 + sum_{k>=1} (z^2/4)^k/(k!)^2 * H_k
        term = one
        I = one
        Ksum = torch.zeros_like(z)
        Hk = 0.0
        for k in range(1, _N_SERIES + 1):
            term = div(term * z2, k * k)
            Hk = Hk + 1.0 / k
            I = I + term
            Ksum = Ksum + term * Hk
        K = -(half_log + _EULER_GAMMA) * I + Ksum
        return I, K
    # I1 = (z/2) * sum_k (z^2/4)^k / (k!(k+1)!)
    s = one
    term = one
    for k in range(1, _N_SERIES + 1):
        term = div(term * z2, k * (k + 1))
        s = s + term
    I1 = 0.5 * z * s
    # K1 = 1/z + (log(z/2)+gamma) I1 - (z/4) sum_k (z^2/4)^k (H_k + H_{k+1}) / (k!(k+1)!)
    ssum = torch.zeros_like(z)
    term = one
    Hk = 0.0
    Hk1 = 1.0
    ssum = ssum + term * (Hk + Hk1)
    for k in range(1, _N_SERIES + 1):
        term = div(term * z2, k * (k + 1))
        Hk = Hk + 1.0 / k
        Hk1 = Hk1 + 1.0 / (k + 1)
        ssum = ssum + term * (Hk + Hk1)
    K1 = rdiv(1.0, z) + (half_log + _EULER_GAMMA) * I1 - 0.25 * z * ssum
    return I1, K1


def _cf2_h(z):
    """Steed/Temme continued fraction CF2 for K at order 0: h with
    K_1/K_0 = (z + 0.5 - h)/z. Converges for Re z > 0, |z| >~ 1."""
    a1 = 0.25
    b = 2.0 * (1.0 + z)
    d = rdiv(1.0, b)
    delh = d
    h = d
    a = -a1
    for i in range(2, _N_CF2 + 2):
        a = a - 2.0 * (i - 1)
        b = b + 2.0
        d = rdiv(1.0, b + a * d)
        delh = (b * d - 1.0) * delh
        h = h + delh
    return a1 * h


def kve_ratio_both(z):
    """(K_0'/K_0, K_1'/K_1) for real z > 0 or complex z with Re z > 0.

    K_0' = -K_1 and K_1' = -K_0 - K_1/z; the K_1/K_0 ratio comes from the
    ascending series for |z| < 2 and from CF2 at order 0 for |z| >= 2.
    """
    az = torch.abs(z)
    small = az < 2.0
    zs = torch.where(small, z, 1.0)          # keep series args in range
    zl = torch.where(small, 4.0, z)

    _, K0s = _series_ik(zs, 0)
    _, K1s = _series_ik(zs, 1)
    h = _cf2_h(zl)
    r10 = torch.where(small, K1s / K0s, (zl + 0.5 - h) / zl)
    return -r10, rdiv(-1.0, r10) - rdiv(1.0, z)


def kve_ratio(m: int, z):
    """K_m'(z) / K_m(z) for m in {0, 1} (see kve_ratio_both)."""
    r0, r1 = kve_ratio_both(z)
    return r0 if m == 0 else r1


def _asymp_k_scaled(z, m: int):
    """K_m(z) e^{z} sqrt(2 z / pi) (the bracket of A&S 9.7.2), |z| >~ 9."""
    mu = 4.0 * m * m
    term = torch.ones_like(z)
    s = torch.ones_like(z)
    for k in range(1, _N_ASYMP + 1):
        term = term * (mu - (2 * k - 1) ** 2) / (8.0 * k * z)
        s = s + term
    return s


def _k(z, m: int):
    """K_m(z) unscaled: the series where |z| <= 9, else the asymptotic
    expansion (each on the arguments the JAX code gives it: 1 and 10 in
    the other branch's lanes)."""
    small = torch.abs(z) <= 9.0
    zs = torch.where(small, z, 1.0)
    zl = torch.where(small, 10.0, z)
    _, Ks = _series_ik(zs, m)
    large = (sqrt(rdiv(math.pi, 2.0 * zl)) * torch.exp(-zl)
             * _asymp_k_scaled(zl, m))
    return torch.where(small, Ks, large)


def k0(z):
    """K_0(z) (unscaled; overflows or underflows outside |z| <~ 700)."""
    return _k(z, 0)


def k1(z):
    """K_1(z) (unscaled)."""
    return _k(z, 1)


def i0(z):
    """I_0(z) by its series (accurate for |z| <~ 9)."""
    return _series_ik(z, 0)[0]


def i1(z):
    """I_1(z) by its series (accurate for |z| <~ 9)."""
    return _series_ik(z, 1)[0]


def ive_ratio(m: int, z):
    """I_m'(z) / I_m(z) by the series (the interior's uniform limit):
    I_0' = I_1, I_1' = I_0 - I_1/z."""
    I0v, _ = _series_ik(z, 0)
    I1v, _ = _series_ik(z, 1)
    if m == 0:
        return I1v / I0v
    return I0v / I1v - rdiv(1.0, z)


# -- complex z (the cylinder exterior at complex omega) ---------------------

def _series_ratio_c(z):
    """K_1/K_0 by the ascending series (_series_ik at orders 0 and 1, the
    JAX code's expressions) at a complex pair or a dual of one; I_1 and
    the K_1 sum share their terms, which the two recursions form alike."""
    z2 = 0.25 * z * z
    half_log = dlog(0.5 * z)
    one = _one_like(z)
    term = one
    I = one
    Ksum = 0.0 * one
    Hk = 0.0
    for k in range(1, _N_SERIES + 1):
        term = divn(term * z2, k * k)
        Hk = Hk + 1.0 / k
        I = I + term
        Ksum = Ksum + term * Hk
    K0 = -(half_log + _EULER_GAMMA) * I + Ksum
    s = one
    ssum = one          # the k = 0 term, 1 (H_0 + H_1)
    term = one
    Hk = 0.0
    Hk1 = 1.0
    for k in range(1, _N_SERIES + 1):
        term = divn(term * z2, k * (k + 1))
        Hk = Hk + 1.0 / k
        Hk1 = Hk1 + 1.0 / (k + 1)
        s = s + term
        ssum = ssum + term * (Hk + Hk1)
    I1 = 0.5 * z * s
    K1 = rquot(1.0, z) + (half_log + _EULER_GAMMA) * I1 - 0.25 * z * ssum
    return quot(K1, K0)


def _cf2_ratio_c(z):
    """K_1/K_0 by CF2 (_cf2_h) at a complex pair or a dual of one."""
    a1 = 0.25
    b = 2.0 * (1.0 + z)
    d = rquot(1.0, b)
    delh = d
    h = d
    a = -a1
    for i in range(2, _N_CF2 + 2):
        a = a - 2.0 * (i - 1)
        b = b + 2.0
        d = rquot(1.0, b + a * d)
        delh = (b * d - 1.0) * delh
        h = h + delh
    h = a1 * h
    return quot(z + 0.5 - h, z)


def _one_like(z):
    v = value(z)
    one = C(torch.ones_like(v.re), torch.zeros_like(v.re))
    if isinstance(z, Dual):
        return Dual(one, 0.0 * one)
    return one


def kve_ratio_both_c(z):
    """(K_0'/K_0, K_1'/K_1) at complex z with Re z > 0, a `cplx.C` or a
    `dual.Dual` of one (special.py:109-127): the series where |z| < 2
    (`cplx.cabs`), CF2 elsewhere, each on the arguments the JAX code gives
    it (1 and 4 in the other branch's lanes)."""
    small = cabs(value(z)) < 2.0
    one = _one_like(z)
    zs = dwhere(small, z, one)
    zl = dwhere(small, 4.0 * one, z)
    r10 = dwhere(small, _series_ratio_c(zs), _cf2_ratio_c(zl))
    return -r10, rquot(-1.0, r10) - rquot(1.0, z)
