"""The twisted chain's redesign: the reciprocal and quotient rules of
`dual.py`; the pole pattern of the chain's two divisions (1/D, 1/C3)
against the quotients they replace; the plain speculative bisection
(`search.bisect_loop(levels=L)`) bit-equal to the loop; the block shapes of
the speculative kernel; and on the card the twisted scan's small-batch path
and the speculative `cylinder_bisect` at every level count, bit-equal to
their plain versions and to the loop of one-thread launches.

Reduced grids: n_interior=24 (the plain bisections), 40 (the pole
candidates), 128 and 250 on the card, k in {0.8, 1.4, 2.0}.
"""
import dataclasses

import numpy as np
import pytest
import torch

from eigensolver_tpu_torch import cases, search, sweep
from eigensolver_tpu_torch.dual import Dual, dsqrt, over, recip
from eigensolver_tpu_torch.kernels import common as kcommon
from eigensolver_tpu_torch.kernels import cylinder as kcyl
from eigensolver_tpu_torch.physics import cylinder as tcyl
from eigensolver_tpu_torch.profiles import rdiv

FAMILIES = {
    "photospheric": lambda: cases.cylinder_twisted_photospheric(0.1, 1.0, 1),
    "magnetic": lambda: cases.cylinder_twisted_magnetic(0.1, 0.15, 1.25, 1),
}


def reduced(name, n_interior):
    c = FAMILIES[name]()
    return dataclasses.replace(
        c, k_values=(0.8, 1.4, 2.0),
        grid=dataclasses.replace(c.grid, n_interior=n_interior))


def _same(a, b):
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        a[~a.isnan()], b[~b.isnan()])


def test_recip_and_over_rules():
    """recip and over against the closed-form derivative of
    f(r) = (3 - r) / (r^2 + 1) + 1 / sqrt(r); recip's value is the one
    IEEE division 1/b."""
    r = torch.linspace(0.1, 1.9, 50, dtype=torch.float64)
    R = Dual(r, torch.ones_like(r))
    den = R * R + Dual(torch.ones_like(r), torch.zeros_like(r))
    f = over(3.0 - R, den, rdiv(1.0, den.v)) + recip(dsqrt(R))
    want_v = (3 - r) / (r * r + 1) + 1 / torch.sqrt(r)
    want_d = (-(r * r + 1) - (3 - r) * 2 * r) / (r * r + 1) ** 2 - 0.5 * r ** -1.5
    np.testing.assert_allclose(f.v.numpy(), want_v.numpy(), rtol=1e-14)
    np.testing.assert_allclose(f.d.numpy(), want_d.numpy(), rtol=1e-12)
    assert torch.equal(recip(den).v, torch.ones_like(r) / den.v)
    # x (1/0) is x / 0: the same inf or NaN, sign included
    b = Dual(torch.tensor([0.0, -0.0, 0.0, 0.0]), torch.tensor([1.0, 2.0,
                                                               -1.0, 0.0]))
    a = Dual(torch.tensor([1.0, 1.0, 0.0, -2.0]), torch.tensor([1.0, -1.0,
                                                               3.0, 0.0]))
    q, want = over(a, b, rdiv(1.0, b.v)), a / b
    assert _same(q.v, want.v) and _same(q.d, want.d)


def _division_invF_g(q, c):
    """(1/F, g) with the quotients by D and C3 as divisions, as before the
    chain took their reciprocals (the r-only parts as now)."""
    rc = Dual(q.r, torch.ones_like(q.r)) * c.C1 / c.C3
    iF = c.A.v * q.iR.v + c.B.v / (q.r * c.D.v)
    g = -rc.d - q.r * (c.C2 - c.C1.v * c.C1.v / c.C3.v) / c.D.v
    return iF, g


def _pattern(x):
    return (x.isnan(), torch.isposinf(x), torch.isneginf(x))


def test_pole_pattern_at_zero_D_and_C3():
    """At points where D or C3 is exactly 0 (and both), the chain's (1/F,
    g) have the inf and NaN of the quotients they replace: synthetic points
    with v_phi = B_phi = 0 and r dC3diff/dr = -rho (s^2 - wA^2), so that
    A = B = 0 and C3 = D A + B = 0, and candidates at the Alfven
    resonance s^2 = wA^2, where D = 0."""
    ph = tcyl.CylinderPhysics.from_case(FAMILIES["photospheric"]())
    r = torch.tensor(0.7, dtype=torch.float64)
    q = ph.twisted_point_fn()(r)
    k = torch.tensor([1.3, 0.9, 1.1, 2.0], dtype=torch.float64)
    m = torch.tensor([0.0, 1.0, 0.0, 1.0], dtype=torch.float64)
    alf = (m * q.b * q.iR + k * q.Bz * q.isr).v
    omega = torch.stack([alf[0], 1.05 * alf[1], alf[2], 0.97 * alf[3]])
    zero = Dual(torch.zeros_like(r), torch.zeros_like(r))
    flat = q._replace(v=zero, b=zero, rdc=zero)   # Q = T = B = 0
    c0 = ph.twisted_chain(flat, omega, k, m)      # A = rho (s^2 - wA^2)
    synthetic = flat._replace(rdc=Dual(-c0.A.v, torch.zeros_like(omega)))
    for point in (q, synthetic):
        c = ph.twisted_chain(point, omega, k, m)
        got, want = ph.twisted_invF_g(point, c), _division_invF_g(point, c)
        for a, b in zip(got, want):
            for x, y in zip(_pattern(a), _pattern(b)):
                assert torch.equal(x, y)
        assert not bool(got[1].isfinite()[0])       # the poles are hit
        assert torch.equal(c.D.v == 0, torch.tensor([True, False, True,
                                                     False]))
    assert bool((c.C3.v == 0).all())                # D A + B, A = B = 0


def test_pole_pattern_of_the_dispersion():
    """Candidates at D(1) = 0 (m = 0, omega at the Alfven frequency of r =
    1, where the shoot starts): the dispersion's inf and NaN are those of
    the chain with the quotients by D and C3."""
    case = reduced("photospheric", 40)
    ph = tcyl.CylinderPhysics.from_case(case)
    one = torch.ones((), dtype=torch.float64)
    q = ph.twisted_point_fn()(one)
    k = torch.tensor([0.8, 1.4, 2.0, 1.4], dtype=torch.float64)
    alf = (k * q.Bz * q.isr).v
    omega = torch.cat([alf[:3], 1.2 * alf[3:]])
    m = torch.zeros_like(k)
    got = ph.make_dispersion_plain(m=None)(omega, k, m)
    patched = ph.twisted_invF_g
    try:
        tcyl.CylinderPhysics.twisted_invF_g = staticmethod(_division_invF_g)
        want = ph.make_dispersion_plain(m=None)(omega, k, m)
    finally:
        tcyl.CylinderPhysics.twisted_invF_g = staticmethod(patched)
    for a, b in ((got.det, want.det), (got.mismatch_pct, want.mismatch_pct)):
        for x, y in zip(_pattern(a), _pattern(b)):
            assert torch.equal(x, y)
    assert not bool(got.det[:3].isfinite().any())
    assert bool(got.det[3].isfinite())


class _Synthetic:
    """A dispersion with many sign changes, a NaN band and the batch's
    (k, mode) in its value, counting its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, omega, k, mode):
        from types import SimpleNamespace
        self.calls += 1
        det = torch.sin(7.0 * omega) * torch.cos(k * omega) + 0.1 * k - mode
        det = torch.where(omega > 2.9, torch.full_like(omega, torch.nan), det)
        return SimpleNamespace(det=det, mismatch_pct=omega * omega + k)


@pytest.mark.parametrize("levels", [2, 3, 4, 5])
@pytest.mark.parametrize("n_iter", [0, 7, 18])
def test_speculative_plain_bisect_equals_loop_synthetic(levels, n_iter):
    rng = np.random.default_rng(3)
    lo = torch.from_numpy(rng.uniform(0.0, 3.0, 64))
    hi = lo + torch.from_numpy(rng.uniform(0.0, 0.5, 64))
    k = torch.from_numpy(rng.uniform(0.0, 1.0, 64))
    mode = torch.from_numpy(rng.integers(0, 2, 64).astype(np.float64)) * 0.05
    for final in (True, False):
        want = search.bisect_loop(_Synthetic(), lo, hi, k, mode, n_iter, final)
        disp = _Synthetic()
        got = search.bisect_loop(disp, lo, hi, k, mode, n_iter, final,
                                 levels=levels)
        assert _same(got[0], want[0])
        assert (got[1] is None) == (want[1] is None)
        if final:
            assert _same(got[1], want[1])
        # one call a round: ceil((n_iter + final) / levels)
        assert disp.calls == -(-(n_iter + final) // levels)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_speculative_plain_bisect_equals_loop_twisted(name):
    """The plain twisted chain's brackets, 7 iterations (no multiple of L),
    bit-equal to the loop at L = 1..5."""
    case = reduced(name, 24)
    disp = tcyl.CylinderPhysics.from_case(case).make_dispersion_plain(m=None)
    om, ks = sweep.build_ladders(case, 24)
    t = torch.from_numpy
    md = torch.ones(om.shape[0], dtype=torch.float64)
    det, valid, mism = search.ladder_scan(disp, t(om), t(ks), md)
    br = search.find_brackets(t(om), t(ks), det, valid, 2, md, mism=mism)
    assert int(br.mask.sum()) >= 4
    args = (br.lo, br.hi, br.k, br.mode)
    want = search.bisect_loop(disp, *args, 7)
    for levels in range(1, 6):
        got = search.bisect_loop(disp, *args, 7, levels=levels)
        assert _same(got[0], want[0]) and _same(got[1], want[1]), levels


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("evaluate", [False, True])
@pytest.mark.parametrize("n", [1, 309, 2400, 3090, 76800])
def test_spec_shape_fits(n, evaluate, dtype):
    """The default speculative shapes: B 2^L <= 32 columns dividing the
    producers' threads, two blocks per SM where the batch allows, the ring
    and the r-only table within a block's shared memory."""
    eb = kcyl._ENTRY_BYTES[dtype, True]
    s = kcommon.spec_shape(n, dtype, eb, evaluate)
    kcommon._check_spec_shape("t", s, dtype, eb, evaluate)
    cols = s.brackets << s.levels
    assert cols <= 32 and (32 * s.producers) % cols == 0
    # evaluating, or a batch that fills the card: the loop's schedule
    assert (s.levels == 0) == (evaluate or n >= kcommon._SPEC_COLUMNS)
    assert s.levels != 1
    if s.levels == 0 and -(-n // 8) >= 2 * 132:
        assert -(-n // s.brackets) >= 2 * 132
    for lv in range(6):
        forced = kcommon.spec_shape(n, dtype, eb, levels=lv)
        assert forced.levels == lv and forced.brackets << lv <= 32
    with pytest.raises(ValueError, match="block shape"):
        kcommon._check_spec_shape("t", s._replace(brackets=64), dtype, eb,
                                  evaluate)


# -- on the card ----------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_small_batch_path_bit_equal_on_card(name, dtype):
    """The fused evaluation (the small-batch path) at ragged sizes and
    several block shapes, and the scan at several chunks, give the plain
    version's bits."""
    case = reduced(name, 250)
    rng = np.random.default_rng(11)
    om, ks = sweep.build_ladders(case, 256)
    ph = tcyl.CylinderPhysics.from_case(case)
    params = kcyl.disp_params(case)
    for n in (1, 97, 4097):
        row = rng.integers(0, om.shape[0], n)
        col = rng.integers(0, om.shape[1], n)
        m = rng.integers(0, 2, n).astype(np.float64)
        args = [torch.from_numpy(x).to(device="cuda", dtype=dtype)
                for x in (om[row, col], ks[row], m)]
        want = ph.make_dispersion_plain(m=None, dtype=dtype)(*args)
        shapes = [None, kcommon.SpecShape(1, 0, 1, 7, 1, 1),
                  kcommon.SpecShape(8, 0, 3, 12, 3, 2),
                  kcommon.SpecShape(32, 0, 15, 16, 2, 1)]
        shapes += [kcommon.ScanShape(kcyl.TW_SCAN_THREADS, c)
                   for c in (7, 32, 64)]
        for shape in shapes:
            before = (kcyl.launches, kcyl.small_launches)
            got = kcyl.cylinder_disp(*args, params, shape=shape)
            torch.cuda.synchronize()
            small = isinstance(shape, kcommon.SpecShape) or shape is None
            assert (kcyl.launches - before[0],
                    kcyl.small_launches - before[1]) == (1, int(small))
            assert torch.equal(got.valid, want.valid), shape
            assert _same(got.det, want.det), shape
            assert _same(got.mismatch_pct, want.mismatch_pct), shape


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_speculative_bisect_every_level_on_card(name, dtype):
    """Every level count and bracket width the kernel takes, on a ragged
    bracket count with NaN ends: the loop of one-thread launches' (root,
    mismatch), bit for bit."""
    case = reduced(name, 128)
    disp = tcyl.CylinderPhysics.from_case(case).make_dispersion(m=None,
                                                                dtype=dtype)
    d64 = tcyl.CylinderPhysics.from_case(case).make_dispersion(m=None)
    om, ks = sweep.build_ladders(case, 32)
    rows = om.shape[0]
    t = torch.from_numpy
    omegas, kcol = t(np.concatenate([om, om])), t(np.concatenate([ks, ks]))
    modes = t(np.repeat([0.0, 1.0], rows))
    det, valid, mism = search.ladder_scan(d64, omegas, kcol, modes)
    br = search.find_brackets(omegas, kcol, det, valid, 4, modes, mism=mism)
    lo, hi, k, md = (x.to(dtype).cuda() for x in (br.lo, br.hi, br.k, br.mode))
    n = lo.numel() - 5
    lo, hi, k, md = lo[:n].clone(), hi[:n].clone(), k[:n], md[:n]
    lo[3], hi[6] = float("nan"), float("nan")
    params = kcyl.disp_params(case)
    for n_iter, final in ((0, True), (7, False), (18, True)):
        want = search.bisect_loop(disp, lo, hi, k, md, n_iter, final)
        for lv in range(6):
            for b in sorted({32 >> lv, 1, 2 if lv < 5 else 1}):
                for p, c, s, mb in ((7, 16, 2, 0), (3, 9, 3, 2)):
                    shape = kcommon.SpecShape(b, lv, p, c, s, mb)
                    before = kcyl.bisect_launches
                    got = kcyl.cylinder_bisect(lo, hi, k, md, n_iter, params,
                                               final, shape=shape)
                    assert kcyl.bisect_launches == before + 1
                    assert _same(got[0], want[0]), shape
                    assert (got[1] is None) == (not final)
                    if final:
                        assert _same(got[1], want[1]), shape


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_non_twisted_bisect_keeps_its_kernel_on_card():
    """The density tube's cylinder_bisect keeps its own chain (SpecChain,
    the K_m ratio) on bisect.cuh::spec_kernel: bit-equal to the launch loop
    at its default shape and at a speculative one."""
    base = cases.cylinder_density_coronal(0.9)
    case = dataclasses.replace(
        base, k_values=(0.5, 2.0),
        grid=dataclasses.replace(base.grid, n_interior=128, n_axis_log=16))
    disp = tcyl.CylinderPhysics.from_case(case).make_dispersion(
        m=None, dtype=torch.float32)
    om, ks = sweep.build_ladders(case, 32)
    rows = om.shape[0]
    dev = {"device": "cuda", "dtype": torch.float32}
    omegas = torch.tensor(np.concatenate([om, om]), **dev)
    kcol = torch.tensor(np.concatenate([ks, ks]), **dev)
    modes = torch.tensor(np.repeat([0.0, 1.0], rows), **dev)
    det, valid, mism = search.ladder_scan(disp, omegas, kcol, modes)
    br = search.find_brackets(omegas, kcol, det, valid, 4, modes, mism=mism)
    args = [x.contiguous() for x in (br.lo, br.hi, br.k, br.mode)]
    got = disp.bisect(*args, 9)
    want = search.bisect_loop(disp, *args, 9)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    got = kcyl.cylinder_bisect(*args, 9, kcyl.disp_params(case), True,
                               shape=kcommon.SpecShape(8, 2, 7, 16, 2, 0))
    assert _same(got[0], want[0]) and _same(got[1], want[1])
