"""Port cylinder sweep vs the analytic uniform-tube Bessel dispersion relation
(Edwin & Roberts form), the oracle of tests/test_cylinder_analytic.py: on
cylinder_density_coronal(width=1e5), a uniform tube to within 1e-5 of the
interface, every root of the relation in the fast-body window at k = 1 is
found by the port's ladder scan and bisection to 1e-5 relative.

On the CPU the plain version runs at a reduced grid (n_interior=512,
n_axis_log=32, 501 omega points, 24 bisections; both modes in one scan and
one bisection), which meets the same 1e-5. On the card (marker `gpu`) the
full grid of the JAX test (n_interior=2048, n_axis_log=128, 3001 points,
60 bisections) goes through one `cylinder_disp` and one `cylinder_bisect`
launch.
"""
import dataclasses

import numpy as np
import pytest
import torch
from scipy.optimize import brentq
from scipy.special import iv, jv, kv

from eigensolver_tpu_torch import cases, search
from eigensolver_tpu_torch.kernels import cylinder as kcyl
from eigensolver_tpu_torch.physics import cylinder as tcyl

K = 1.0
V_LO, V_HI = 0.92, 4.8   # fast-body window, above cT accumulation


def analytic_det(rg, W, K, m):
    om = W * K

    def msq(c2, a2, o):
        cT2 = c2 * a2 / (c2 + a2)
        return (K**2 * c2 - o**2) * (K**2 * a2 - o**2) / (
            (c2 + a2) * (K**2 * cT2 - o**2))

    mi2 = msq(rg.c_i0**2, rg.vA_i0**2, om)
    me2 = msq(rg.c_e**2, rg.vA_e**2, om)
    if me2 <= 0:
        return np.nan
    se = np.sqrt(me2)
    ext = se * (kv(m - 1, se) + kv(m + 1, se)) / (-2 * kv(m, se)) / (
        rg.rho_e * (om**2 - K**2 * rg.vA_e**2))
    if mi2 > 0:
        si = np.sqrt(mi2)
        intr = si * (iv(m - 1, si) + iv(m + 1, si)) / (2 * iv(m, si)) / (
            rg.rho_i0 * (om**2 - K**2 * rg.vA_i0**2))
    else:
        ni = np.sqrt(-mi2)
        intr = ni * (jv(m - 1, ni) - jv(m + 1, ni)) / (2 * jv(m, ni)) / (
            rg.rho_i0 * (om**2 - K**2 * rg.vA_i0**2))
    return intr - ext


def analytic_roots(rg, W, m):
    """Roots of the relation between sign changes on the grid W, without the
    sign changes at the poles of J_m."""
    vals = np.array([analytic_det(rg, w, K, m) for w in W])
    s = np.sign(vals)
    ok = np.isfinite(vals)
    want = []
    for i in np.nonzero((s[:-1] * s[1:] < 0) & ok[:-1] & ok[1:])[0]:
        r = brentq(lambda w: analytic_det(rg, w, K, m), W[i], W[i + 1],
                   xtol=1e-13)
        if abs(analytic_det(rg, r, K, m)) < 1e-5:
            want.append(r)
    return np.asarray(want)


def port_roots(case, W, n_bisect, device):
    """Phase speeds of the accepted roots per mode (0, 1): one ladder scan
    of both modes' rows, one bisection of their brackets, at float64."""
    disp = tcyl.CylinderPhysics.from_case(case).make_dispersion(
        m=None, dtype=torch.float64)
    t = torch.tensor
    om = t(np.stack([W * K] * 2), dtype=torch.float64, device=device)
    ks = t([K, K], dtype=torch.float64, device=device)
    modes = t([0.0, 1.0], dtype=torch.float64, device=device)
    det, valid, mism = search.ladder_scan(disp, om, ks, modes)
    br = search.find_brackets(om, ks, det, valid, 16, modes)
    pr = search.bisect(disp, br, n_bisect)
    keep = (pr.mask & (pr.mismatch < 0.5)).cpu().numpy()
    root = pr.omega.cpu().numpy() / K
    md = pr.mode.cpu().numpy()
    return {m: np.sort(root[keep & (md == m)]) for m in (0, 1)}


def check_every_root_found(case, W, got):
    rg = case.regime
    for m in (0, 1):
        want = analytic_roots(rg, W, m)
        assert len(want) > 0
        for r in want:
            d = np.min(np.abs(got[m] - r)) / r
            assert d < 1e-5, (m, r, got[m])


def test_uniform_coronal_cylinder_matches_bessel_cpu():
    full = cases.cylinder_density_coronal(width=1e5)
    case = dataclasses.replace(full, grid=dataclasses.replace(
        full.grid, n_interior=512, n_axis_log=32))
    W = np.linspace(V_LO, V_HI, 501)
    before = kcyl.launches, kcyl.bisect_launches
    got = port_roots(case, W, 24, "cpu")
    assert (kcyl.launches, kcyl.bisect_launches) == before
    check_every_root_found(case, W, got)


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_uniform_coronal_cylinder_matches_bessel_on_card():
    case = cases.cylinder_density_coronal(width=1e5)
    W = np.linspace(V_LO, V_HI, 3001)
    before = (kcyl.launches, kcyl.bisect_launches, tcyl.plain_calls)
    got = port_roots(case, W, 60, "cuda")
    assert (kcyl.launches - before[0], kcyl.bisect_launches - before[1],
            tcyl.plain_calls - before[2]) == (1, 1, 0)
    check_every_root_found(case, W, got)
