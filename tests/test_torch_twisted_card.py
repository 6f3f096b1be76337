"""The twisted cylinder's row mask and fused bisection entry on the CPU; on
the card, the twisted `cylinder_disp` and `cylinder_bisect` bit-equal to
their plain versions and to the loop of one-thread launches; and (slow) the
independent sympy + scipy shoot of the magnetic-twist kink eigenvalues.

Reduced grid as tests/test_torch_twisted_sweep.py's: k in {0.8, 1.4, 2.0},
n_interior=128.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from eigensolver_tpu import cases as jcases
from eigensolver_tpu_torch import config, search, sweep
from eigensolver_tpu_torch.equilibrium import genuine_continua_rowfn
from eigensolver_tpu_torch.kernels import common as kcommon
from eigensolver_tpu_torch.kernels import cylinder as kcyl
from eigensolver_tpu_torch.physics import cylinder as tcyl

FAMILIES = {
    "photospheric": lambda: jcases.cylinder_twisted_photospheric(
        v_twist=0.1, power=1.0, mode=1),
    "magnetic": lambda: jcases.cylinder_twisted_magnetic(
        B_twist=0.1, v_twist=0.15, power=1.25, mode=1),
}


def reduced(name, n_interior=128):
    c = FAMILIES[name]()
    return dataclasses.replace(
        c, k_values=(0.8, 1.4, 2.0),
        grid=dataclasses.replace(c.grid, n_interior=n_interior))


def test_mask_removes_roots_inside_the_continua():
    """Masked, no root of the magnetic case lies strictly inside a row
    range; unmasked, some do (the ladder crosses the continua)."""
    case = config.from_jax(reduced("magnetic"))
    rowfn = genuine_continua_rowfn(case)
    kw = dict(n_omega=48, n_bisect=20)

    def inside(rs):
        om = torch.from_numpy(rs["kink"].omegas)
        lo, hi = rowfn(torch.from_numpy(rs["kink"].ks), torch.ones_like(om))
        return int(((om[:, None] > lo) & (om[:, None] < hi)).any(1).sum())

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plain, _ = sweep.run_case(case, search.SearchConfig(**kw), device="cpu")
        masked, _ = sweep.run_case(case, search.SearchConfig(
            **kw, exclude_omega_rowfn=rowfn), device="cpu")
    assert inside(plain) > 0
    assert inside(masked) == 0


def test_bisect_entry_equals_loop_on_cpu():
    case = config.from_jax(reduced("magnetic"))
    disp = tcyl.CylinderPhysics.from_case(case).make_dispersion(m=None)
    om, ks = sweep.build_ladders(case, 24)
    t = torch.from_numpy
    md = torch.ones(om.shape[0], dtype=torch.float64)
    det, valid, mism = search.ladder_scan(disp, t(om), t(ks), md)
    br = search.find_brackets(t(om), t(ks), det, valid, 4, md, mism=mism)
    assert int(br.mask.sum()) >= 5
    before = (tcyl.plain_calls, kcyl.bisect_launches, kcyl.launches)
    root, mis = disp.bisect(br.lo, br.hi, br.k, br.mode, 6)
    assert (tcyl.plain_calls - before[0], kcyl.bisect_launches - before[1],
            kcyl.launches - before[2]) == (8, 0, 0)
    want = search.bisect_loop(disp, br.lo, br.hi, br.k, br.mode, 6)
    for a, b in zip((root, mis), want):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a[~a.isnan()], b[~b.isnan()])


# -- on the card ----------------------------------------------------------------

def _same(a, b):
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        a[~a.isnan()], b[~b.isnan()])


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_twisted_scan_bit_equal_to_plain_on_card(name, dtype):
    """The twisted scan's (det, mismatch, valid) are the plain version's
    bits, on 1,001 candidates and 250 steps (no multiple of a block or a
    chunk), at several chunks; the kernel is built for 128 threads a
    block and refuses other block sizes."""
    case = config.from_jax(reduced(name, n_interior=250))
    rng = np.random.default_rng(6)
    om, ks = sweep.build_ladders(case, 256)
    row = rng.integers(0, om.shape[0], 1001)
    col = rng.integers(0, om.shape[1], 1001)
    m = rng.integers(0, 2, 1001).astype(np.float64)
    args = [torch.from_numpy(x).to(device="cuda", dtype=dtype)
            for x in (om[row, col], ks[row], m)]
    ph = tcyl.CylinderPhysics.from_case(case)
    want = ph.make_dispersion_plain(m=None, dtype=dtype)(*args)
    params = kcyl.disp_params(case)
    for threads in (256, 512):
        with pytest.raises(ValueError, match="launch shape"):
            kcyl.cylinder_disp(*args, params, shape=(threads, 32))
    for shape in (None, (128, 7), (128, 32), (128, 64), (128, 100)):
        before = kcyl.launches
        got = kcyl.cylinder_disp(*args, params, shape=shape)
        torch.cuda.synchronize()
        assert kcyl.launches == before + 1
        assert torch.equal(got.valid, want.valid), shape
        for a, b in ((got.det, want.det),
                     (got.mismatch_pct, want.mismatch_pct)):
            same = (a == b) | (a.isnan() & b.isnan())
            assert bool(same.all()), (shape, int((~same).sum()))
    assert bool(want.det.isfinite().any())


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_twisted_fused_bisect_bit_equal_to_launch_loop_on_card(name, dtype):
    case = config.from_jax(reduced(name))
    disp = tcyl.CylinderPhysics.from_case(case).make_dispersion(
        m=None, dtype=dtype)
    om, ks = sweep.build_ladders(case, 32)
    rows = om.shape[0]
    t = torch.from_numpy
    omegas, kcol = t(np.concatenate([om, om])), t(np.concatenate([ks, ks]))
    modes = t(np.repeat([0.0, 1.0], rows))
    d64 = tcyl.CylinderPhysics.from_case(case).make_dispersion(m=None)
    det, valid, mism = search.ladder_scan(d64, omegas, kcol, modes)
    br = search.find_brackets(omegas, kcol, det, valid, 4, modes, mism=mism)
    lo, hi, k, md = (x.to(dtype).cuda() for x in (br.lo, br.hi, br.k, br.mode))
    n = lo.numel() - 3
    lo, hi, k, md = lo[:n].clone(), hi[:n].clone(), k[:n], md[:n]
    lo[5], hi[7] = float("nan"), float("nan")
    for n_iter in (0, 18):
        for final_eval in (True, False):
            before = (kcyl.bisect_launches, kcyl.launches)
            root, mis = disp.bisect(lo, hi, k, md, n_iter, final_eval)
            torch.cuda.synchronize()
            assert (kcyl.bisect_launches - before[0],
                    kcyl.launches - before[1]) == (1, 0)
            want_root, want_mis = search.bisect_loop(
                lambda *a: disp(*a), lo, hi, k, md, n_iter, final_eval)
            assert _same(root, want_root)
            if final_eval:
                assert _same(mis, want_mis)
    want = disp.bisect(lo, hi, k, md, 6)
    params = kcyl.disp_params(case)
    # the speculative kernel's block shapes (B, L, P, C, S, budget)
    for shape in ((1, 0, 1, 7, 1, 1), (8, 2, 3, 32, 2, 2),
                  (1, 5, 15, 16, 6, 1)):
        got = kcyl.cylinder_bisect(lo, hi, k, md, 6, params,
                                   shape=kcommon.SpecShape(*shape))
        assert _same(got[0], want[0]) and _same(got[1], want[1]), shape


# -- the independent oracle ------------------------------------------------------

@pytest.mark.slow
def test_kink_eigenvalues_vs_independent_scipy_shooting():
    """Kink eigenvalues of the magnetic twist from the port (its sweep with
    its row mask) re-located by the independent pipeline of
    tests/test_btwist.py (sympy chain with (omega, k) free, scipy LSODA
    through the same flux-form ODE, scipy K_m): <= 1e-4 relative at 3+
    roots."""
    import sympy as sym
    from scipy.integrate import solve_ivp
    from scipy.optimize import brentq
    from scipy.special import kv

    jcase = jcases.cylinder_twisted_magnetic(
        B_twist=0.1, v_twist=0.15, power=1.25, mode=1)
    case = dataclasses.replace(config.from_jax(jcase), k_values=(0.8, 1.4, 2.0),
                               speeds=(1.02, 1.2, 1.35))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rs, _ = sweep.run_case(case, search.SearchConfig(
            n_omega=128, n_bisect=55,
            exclude_omega_rowfn=genuine_continua_rowfn(case)), device="cpu")
    br = rs["kink"]
    assert len(br) >= 3

    rg, eps, mval = case.regime, case.grid.axis_epsilon, 1
    B_T, V_T, P = 0.1, 0.15, 1.25
    r, om_s, k_s = sym.symbols("r omega k", positive=True)
    gamma = sym.Rational(5, 3)
    rho = sym.Float(rg.rho_i0)
    B_0 = rg.vA_i0 * sym.sqrt(rho)
    P_0 = rg.c_i0 ** 2 * rho / gamma
    B_phi = B_T * r
    B_i = B_0 * sym.sqrt(1 - 2 * B_phi ** 2 / B_0 ** 2)
    v_phi = V_T * r ** P
    P_i = rho * V_T ** 2 * r ** (2 * P) / (2 * P) + P_0
    c_i = sym.sqrt(P_i * gamma / rho)
    vA_i = (B_i + B_phi) / sym.sqrt(rho)
    shift = om_s - mval * v_phi / r
    alf = mval * B_phi / r + k_s * B_i / sym.sqrt(rho)
    csum = c_i ** 2 + vA_i ** 2
    cusp = alf * c_i / sym.sqrt(csum)
    D = rho * csum * (shift ** 2 - alf ** 2) * (shift ** 2 - cusp ** 2)
    fb = mval * B_phi / r + k_s * B_i
    Q = (-(shift ** 2 - alf ** 2) * rho * v_phi ** 2 / r
         + 2 * shift ** 2 * B_phi ** 2 / r + 2 * shift * B_phi * v_phi * fb / r)
    T = fb * B_phi + rho * v_phi * shift
    C1 = Q * shift ** 2 - 2 * mval * csum * (shift ** 2 - cusp ** 2) * T / r ** 2
    C2 = shift ** 4 - csum * (mval ** 2 / r ** 2 + k_s ** 2) * (
        shift ** 2 - cusp ** 2)
    C3diff = (B_phi / r) ** 2 - rho * (v_phi / r) ** 2
    C3 = (D * (rho * (shift ** 2 - alf ** 2) + r * sym.diff(C3diff, r))
          + Q ** 2 - 4 * csum * (shift ** 2 - cusp ** 2) * T ** 2 / r ** 2)
    g = -sym.diff(r * C1 / C3, r) - r * (C2 - C1 ** 2 / C3) / D
    lam = {n: sym.lambdify((r, om_s, k_s), e, "numpy") for n, e in
           [("C1", C1), ("C3", C3), ("F", r * D / C3), ("g", g),
            ("invF", C3 / (r * D))]}
    cT_e2 = rg.c_e ** 2 * rg.vA_e ** 2 / (rg.c_e ** 2 + rg.vA_e ** 2)

    def indep_det(omega, k):
        F1 = lam["F"](1.0, omega, k)
        nfev = [0]

        def rhs(rr, y):
            nfev[0] += 1
            if nfev[0] > 100_000:
                raise RuntimeError("stiff")
            return [y[1] * lam["invF"](rr, omega, k),
                    lam["g"](rr, omega, k) * y[0]]

        def shoot(y0):
            try:
                s = solve_ivp(rhs, (1.0, eps), y0, method="LSODA",
                              rtol=1e-10, atol=1e-12)
            except RuntimeError:
                return np.nan
            return s.y[0, -1]

        xi1 = lam["C1"](1.0, omega, k) / lam["C3"](1.0, omega, k)
        m_e = ((k ** 2 * rg.vA_e ** 2 - omega ** 2)
               * (k ** 2 * rg.c_e ** 2 - omega ** 2)
               / ((rg.vA_e ** 2 + rg.c_e ** 2) * (k ** 2 * cT_e2 - omega ** 2)))
        sq = np.sqrt(m_e)
        dlog_K = sq * (-(kv(mval - 1, sq) + kv(mval + 1, sq)) / 2.0) / kv(
            mval, sq)
        xi_e = dlog_K / (rg.rho_e * (omega ** 2 - k ** 2 * rg.vA_e ** 2))
        J = B_T ** 2 - rg.rho_i0 * V_T ** 2
        return (shoot([1.0, 0.0]) * (F1 - xi_e * 0.0)
                - shoot([0.0, F1]) * (xi1 - xi_e) + J * xi_e * F1)

    checked = 0
    for omega, k in zip(br.omegas, br.ks):
        if checked >= 4:
            break
        lo, hi = omega * (1 - 5e-4), omega * (1 + 5e-4)
        f_lo, f_hi = indep_det(lo, k), indep_det(hi, k)
        if not (np.isfinite(f_lo) and np.isfinite(f_hi)):
            continue
        if np.sign(f_lo) == np.sign(f_hi):
            continue
        om_indep = brentq(lambda w: indep_det(w, k), lo, hi, xtol=1e-12)
        np.testing.assert_allclose(om_indep, omega, rtol=1e-4)
        checked += 1
    assert checked >= 3, f"only {checked} roots bracketed by the scipy shoot"
