"""Modified-Bessel K logarithmic derivative for real and complex tensors.

Port of `eigensolver_tpu.special.kve_ratio_both` / `kve_ratio` and their
helpers `_series_ik` and `_cf2_h`: the same series, term counts, continued
fraction and branch point, operation for operation. This is the plain
version of the CUDA kernel behind `kernels.bessel.kve_ratio_both`. The
unscaled `k0/k1/i0/i1` and `ive_ratio` serve only the JAX package's own
tests and are not ported.
"""
from __future__ import annotations

import torch

from .profiles import div, rdiv

_EULER_GAMMA = 0.5772156649015328606
_N_SERIES = 24          # (z^2/4)^k / (k!)^2 converges ~1e-16 by k=24 at |z|=9
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
