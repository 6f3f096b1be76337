"""The paired slab scan: both parities of an (omega, k) through one chain,
and a step's first chain taken from the step before where n_interior is a
power of two (csrc/slab_disp.cu, `kernels.slab.slab_disp_pairs`,
`disp.both_parities`, `search.ladder_scan(paired=True)`).

On the CPU: the abscissae that the reuse rule relies on, a torch model of
the paired, reused shoot bit-equal to the plain version, the paired entry
equal to the unpaired call, and the sweep's use of the paired layout
(the reduced slab_ph_09 sweep equal to its unpaired run and, at float64,
to the JAX package's within test_torch_sweep.py's 1e-10). On the card:
both kernels bit-equal to the plain version. Bit-equal means det,
mismatch and valid with the same bits, NaN where NaN.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from eigensolver_tpu import cases as jcases
from eigensolver_tpu import search as jsearch
from eigensolver_tpu import sweep as jsweep
from eigensolver_tpu_torch import cases, config, search, sweep
from eigensolver_tpu_torch.kernels import slab as kslab
from eigensolver_tpu_torch.physics import slab as tslab
from eigensolver_tpu_torch.profiles import div, rdiv, sqrt


def _grid(case, **grid):
    return dataclasses.replace(case, grid=dataclasses.replace(case.grid,
                                                              **grid))


# slab_ph_09 (flux form) and the Gaussian-flow slab (shear form), each with
# the exact exterior or the numeric one of its parity configuration
# (tools_torch/parity.py: 7 wavelengths; the flow at 3), on a few k
FORMS = {
    "flux": lambda: dataclasses.replace(
        cases.slab_density_photospheric(0.9), k_values=(0.5, 2.5)),
    "shear": lambda: dataclasses.replace(
        cases.slab_flow_gaussian_coronal(), k_values=(0.3, 1.7)),
}
NUMERIC = {"flux": 7.0, "shear": 3.0}


def form_case(form: str, exterior: str, n_interior: int):
    case = _grid(FORMS[form](), n_interior=n_interior)
    if exterior == "numeric":
        case = _grid(case, exterior_method="numeric",
                     exterior_wavelengths=NUMERIC[form])
    return case


def pairs_of(case, n_omega: int = 16):
    """The sweep's ladder (omega, k) pairs: the rows of one parity, in
    ladder order, float64 tensors."""
    om, ks = sweep.build_ladders(case, n_omega)
    return (torch.from_numpy(om.reshape(-1)),
            torch.from_numpy(np.repeat(ks, n_omega)))


def _same_bits(got, want, what=""):
    assert torch.equal(got.valid, want.valid), what
    for a, b in ((got.det, want.det), (got.mismatch_pct, want.mismatch_pct)):
        same = (a == b) | (a.isnan() & b.isnan())
        assert bool(same.all()), (what, int((~same).sum()))


def _repeated(omega, k):
    """(omega, k) twice with the parity column 0 ... 0, 1 ... 1."""
    return (omega.repeat(2), k.repeat(2),
            torch.cat([torch.zeros_like(omega), torch.ones_like(omega)]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [256, 512, 2048, 250])
def test_step_boundary_abscissae_bitwise(n, dtype):
    """The abscissae as `_rk4_linear` forms them (x0 + i h, h = (1 - 0) / n):
    where n is a power of two each step's last, (x0 + i h) + h, is the next
    step's first, x0 + (i + 1) h, bit for bit; at n = 250 some are not, so
    the reuse rests on the power of two (common.cuh::chain_reuse)."""
    zero = torch.zeros((), dtype=dtype)
    h = div(torch.ones((), dtype=dtype) - zero, n)
    i = torch.arange(n, dtype=dtype)
    last = (zero + i * h) + h
    first = zero + (i + 1) * h
    if n & (n - 1) == 0:
        assert torch.equal(last, first)
    else:
        assert not torch.equal(last, first)


def _rk4_step(apply, cA, cM, cB, y, h):
    """One step of physics/slab.py::_rk4_linear from the chain at its 3
    abscissae, in its order."""
    def axpy(a, y, k):
        return tuple(yi + a * ki for yi, ki in zip(y, k))
    k1 = apply(cA, y)
    k2 = apply(cM, axpy(0.5 * h, y, k1))
    k3 = apply(cM, axpy(0.5 * h, y, k2))
    k4 = apply(cB, axpy(h, y, k3))
    return tuple(yi + div(h, 6.0) * (a + 2 * b + 2 * c_ + d)
                 for yi, a, b, c_, d in zip(y, k1, k2, k3, k4))


def paired_model(ph, omega, k, dtype, reuse=None):
    """Both parities of each (omega, k) as the paired scan forms them: the
    chain at each abscissa once for the pair, at a step's first abscissa
    the step before's last where n_interior is a power of two (reuse None)
    or where `reuse` says so; the exterior once for the pair; the update
    and the interface per parity. Parity 0's results, then parity 1's."""
    case, eq = ph.case, ph.eq
    n_steps = case.grid.n_interior
    if reuse is None:
        reuse = n_steps & (n_steps - 1) == 0
    omega, k = omega.to(dtype), k.to(dtype)
    zero = torch.zeros((), dtype=dtype)
    one = torch.ones((), dtype=dtype)
    m_e = ph.exterior_m(omega, k)
    p_e = ph.exterior_PT_coeff(omega, k)
    sqm = sqrt(torch.maximum(m_e, torch.zeros_like(m_e)))
    pars = (torch.zeros_like(omega), torch.ones_like(omega))
    if ph.has_flow:
        coef, apply = ph.make_shear_coef(omega, k), tslab._apply_shear
        ys = [(par, 1.0 - par) for par in pars]
    else:
        coef, apply = ph.make_flux_coef(omega, k), tslab._apply_flux
        F0 = ph.interior_F(zero, omega, k)
        ys = [(par * torch.ones_like(F0), (1.0 - par) * F0) for par in pars]
    h = div(one - zero, n_steps)
    cB = None
    for i in range(n_steps):
        x = zero + i * h
        cA = cB if reuse and i > 0 else coef(x)
        cM = coef(x + 0.5 * h)
        cB = coef(x + h)
        ys = [_rk4_step(apply, cA, cM, cB, y, h) for y in ys]
    Om_i = omega - k * eq.U_i(one)
    Om_e = omega - k * eq.regime.U_e
    if case.grid.exterior_method == "numeric":
        PT_e = p_e * ph.numeric_exterior(m_e, k)
    else:
        PT_e = p_e * (-sqm)
    out = []
    for vx_b, y1_b in ys:
        if ph.has_flow:
            PT_i = (ph.interior_F(one, omega, k) / Om_i) * y1_b
        else:
            PT_i = y1_b / Om_i
        xi_e = rdiv(1.0, Om_e)
        xi_i = vx_b / Om_i
        det = xi_i * PT_e - xi_e * PT_i
        s = xi_e / xi_i
        num = torch.abs(PT_e - s * PT_i)
        den = torch.maximum(torch.abs(PT_e), torch.abs(s * PT_i))
        out.append(tslab.SlabInterface(det=det, mismatch_pct=100.0 * num / den,
                                       valid=m_e > 0))
    return tslab.SlabInterface(*(torch.cat(x) for x in zip(*out)))


@pytest.mark.parametrize("n_interior", [256, 250])
@pytest.mark.parametrize("exterior", ["exact", "numeric"])
@pytest.mark.parametrize("form", ["flux", "shear"])
def test_paired_reused_model_equals_plain(form, exterior, n_interior):
    """The model of the paired scan, chains once per (omega, k) and, at a
    power of two, once per step boundary, gives the plain version's bits on
    the moded ladder (both parities of every row, in the sweep's order);
    at n_interior = 250 reusing the chain anyway would change them."""
    case = form_case(form, exterior, n_interior)
    ph = tslab.SlabPhysics.from_case(case)
    dtype = torch.float64
    om, k = pairs_of(case)
    want = ph.make_dispersion_plain(parity=None, dtype=dtype)(
        *_repeated(om, k))
    _same_bits(paired_model(ph, om, k, dtype), want)
    if n_interior == 250:
        wrong = paired_model(ph, om, k, dtype, reuse=True)
        assert not torch.equal(wrong.det, want.det)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("exterior", ["exact", "numeric"])
@pytest.mark.parametrize("form", ["flux", "shear"])
def test_both_parities_on_cpu_equals_the_moded_call(form, exterior, dtype):
    """`disp.both_parities(omega, k)` on CPU tensors: det, valid and
    mismatch of disp(omega, k, parity) on the repeated batch, bit for bit,
    in its order, through one plain evaluation."""
    case = form_case(form, exterior, 64)
    disp = tslab.SlabPhysics.from_case(case).make_dispersion(parity=None,
                                                             dtype=dtype)
    om, k = pairs_of(case, 8)
    before = tslab.plain_calls
    got = disp.both_parities(om, k)
    assert tslab.plain_calls == before + 1
    assert got.det.shape == (2 * om.numel(),)
    _same_bits(got, disp(*_repeated(om, k)))


def test_ladder_scan_paired_keeps_the_grid_order():
    """ladder_scan with paired=True returns the (rows, n_omega) grid of the
    unpaired scan, bit for bit, from one call on its parity-0 half."""
    case = form_case("flux", "exact", 64)
    disp = tslab.SlabPhysics.from_case(case).make_dispersion(parity=None)
    om, ks = sweep.build_ladders(case, 8)
    rows = om.shape[0]
    grid = torch.from_numpy(np.concatenate([om, om]))
    kcol = torch.from_numpy(np.concatenate([ks, ks]))
    modes = torch.from_numpy(np.repeat([0.0, 1.0], rows))
    calls = []

    def pairs(o, k):
        calls.append(o.numel())
        return disp.both_parities(o, k)
    spy = lambda o, k, m: disp(o, k, m)   # noqa: E731
    spy.both_parities = pairs
    got = search.ladder_scan(spy, grid, kcol, modes, paired=True)
    want = search.ladder_scan(disp, grid, kcol, modes)
    assert calls == [rows * 8]
    for a, b in zip(got, want):
        assert a.shape == b.shape == (2 * rows, 8)
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a[~a.isnan()], b[~b.isnan()])


def _reduced_slab_jax():
    c = jcases.slab_density_photospheric(0.9)
    return dataclasses.replace(
        c, k_values=(0.5, 1.5, 2.5, 3.5),
        grid=dataclasses.replace(c.grid, n_interior=256))


def _unpaired(monkeypatch):
    """run_case with its scan forced through the unpaired call, as before
    the paired path."""
    real = sweep.search_rows

    def search_rows(*args, paired=False, **kw):
        return real(*args, **kw)
    monkeypatch.setattr(sweep, "search_rows", search_rows)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_reduced_sweep_same_rootset_and_matches_jax(monkeypatch, dtype):
    """run_case on the reduced slab_ph_09 (n_interior = 256) through the
    paired scan gives the RootSet of the unpaired one exactly, and at
    float64 the JAX package's counts and roots within 1e-10."""
    jcase = _reduced_slab_jax()
    jcfg = jsearch.SearchConfig(n_omega=64, n_bisect=30 if dtype == "float64"
                                else 18, scan_dtype=dtype,
                                polish_dtype=dtype)
    case, cfg = config.from_jax(jcase), search.SearchConfig.from_jax(jcfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # saturated-row notices
        got, _ = sweep.run_case(case, cfg, device="cpu")
        with monkeypatch.context() as m:
            _unpaired(m)
            before, _ = sweep.run_case(case, cfg, device="cpu")
        jrs = jsweep.run_case(jcase, jcfg)[0] if dtype == "float64" else None
    assert got.counts() == before.counts()
    for b in before.branches:
        np.testing.assert_array_equal(got[b].ks, before[b].ks)
        np.testing.assert_array_equal(got[b].omegas, before[b].omegas)
    if jrs is not None:
        assert got.counts() == jrs.counts()
        for b in jrs.branches:
            np.testing.assert_array_equal(got[b].ks, jrs[b].ks)
            np.testing.assert_allclose(got[b].omegas, jrs[b].omegas,
                                       rtol=1e-10, atol=0)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("what,want", [
    ("slab modes (0, 1)", True), ("slab modes (0,)", False),
    ("slab needle (0, 1)", False), ("cylinder modes (0, 1)", False)])
def test_sweep_passes_the_paired_layout(monkeypatch, what, want):
    """run_case tells search_rows that its ladder is one row set per parity
    for a slab at modes (0, 1), not at modes (0,), not for a cylinder,
    whose chain depends on m, and the needle pass scans unpaired."""
    seen = []

    def spy(*args, paired=False, **kw):
        seen.append(paired)
        raise _Stop
    monkeypatch.setattr(sweep, "search_rows", spy)
    slab = form_case("flux", "exact", 64)
    with pytest.raises(_Stop):
        if what == "slab modes (0, 1)":
            sweep.run_case(slab, device="cpu")
        elif what == "slab modes (0,)":
            sweep.run_case(slab, modes=(0,), device="cpu")
        elif what == "slab needle (0, 1)":
            sweep.run_needle_pass(slab, modes=(0, 1), device="cpu")
        else:
            sweep.run_case(cases.cylinder_density_coronal(0.9), modes=(0, 1),
                           device="cpu")
    assert seen == [want]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shear", [False, True])
def test_paired_shapes_built_and_refused(shear, dtype):
    """The paired scan is built at one block size a form, its default's:
    128 threads in the flux form, 256 in the shear form, at any chunk that
    fits; other block sizes, a chunk of 0 or past shared memory raise on
    any device, before any evaluation; the unpaired numeric scan keeps its
    own set."""
    threads = 256 if shear else 128
    assert kslab.PAIRS_SHAPE[shear] == (threads, 128)
    for good in ((threads, 1), (threads, 64), (threads, 300)):
        kslab._check_scan_shape(kslab.ScanShape(*good), dtype, shear,
                                pairs=True)
    for bad in ((32, 64), (64, 64), (384 - threads, 64), (512, 64),
                (96, 32), (threads, 0), (threads, 100_000)):
        with pytest.raises(ValueError, match="launch shape"):
            kslab._check_scan_shape(kslab.ScanShape(*bad), dtype, shear,
                                    pairs=True)
    case = form_case("shear" if shear else "flux", "numeric", 64)
    params = kslab.disp_params(case)
    om, k = pairs_of(case, 4)
    before = tslab.plain_calls
    with pytest.raises(ValueError, match="launch shape"):
        kslab.slab_disp_pairs(om.to(dtype), k.to(dtype), params,
                              shape=(64, 64))
    assert tslab.plain_calls == before
    if shear:
        with pytest.raises(ValueError, match="launch shape"):
            kslab._check_scan_shape(kslab.ScanShape(256, 64), dtype, shear,
                                    numeric=True)


# -- on the card ------------------------------------------------------------

def _draws(case, n: int, seed: int):
    """n (omega, k) pairs drawn from the case's n_omega = 256 ladder."""
    om, ks = sweep.build_ladders(case, 256)
    rng = np.random.default_rng(seed)
    row = rng.integers(0, om.shape[0], n)
    col = rng.integers(0, om.shape[1], n)
    return om[row, col], ks[row]


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("n_interior", [2048, 250])
@pytest.mark.parametrize("exterior", ["exact", "numeric"])
@pytest.mark.parametrize("form", ["flux", "shear"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_paired_kernel_bit_equal_to_plain_on_card(dtype, form, exterior,
                                                  n_interior):
    """The paired scan's 2 h results are the plain version's bits on the
    repeated batch, for h = 1, a multiple of the block (3 x 256) and 8,191
    (ragged), at the default shape and others (chunks of 1 and 5 steps
    carry the reused chain across many table chunks); one launch each, all
    counted as paired; a shape it is not built for raises."""
    case = form_case(form, exterior, n_interior)
    params = kslab.disp_params(case)
    om, k = (torch.from_numpy(x).to(device="cuda", dtype=dtype)
             for x in _draws(case, 8191, seed=31))
    plain = tslab.SlabPhysics.from_case(case).make_dispersion_plain(
        parity=None, dtype=dtype)
    full = plain(*_repeated(om, k))
    for h in (1, 768, 8191):
        want = tslab.SlabInterface(*(torch.cat([x[:h], x[8191:8191 + h]])
                                     for x in full))
        threads = kslab.PAIRS_SHAPE[form == "shear"].threads
        for shape in (None, (threads, 1), (threads, 5), (threads, 300)):
            before = (kslab.launches, kslab.paired)
            got = kslab.slab_disp_pairs(om[:h].contiguous(),
                                        k[:h].contiguous(), params,
                                        shape=shape)
            torch.cuda.synchronize()
            assert (kslab.launches, kslab.paired) == (before[0] + 1,
                                                      before[1] + 2 * h)
            _same_bits(got, want, (h, shape))
    with pytest.raises(ValueError, match="launch shape"):
        kslab.slab_disp_pairs(om, k, params, shape=(64, 64))


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("exterior", ["exact", "numeric"])
@pytest.mark.parametrize("form", ["flux", "shear"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_unpaired_kernel_with_reuse_bit_equal_on_card(dtype, form, exterior):
    """At n_interior = 2048 the unpaired scan takes each step's first chain
    from the step before: its bits are the plain version's on random
    draws of both parities and on refine windows (10 ends a root of 150
    ladder points), none of them counted as paired."""
    case = form_case(form, exterior, 2048)
    params = kslab.disp_params(case)
    om, k = _draws(case, 1001, seed=32)
    par = np.random.default_rng(33).integers(0, 2, om.size).astype(float)
    draws = [torch.from_numpy(x).to(device="cuda", dtype=dtype)
             for x in (om, k, par)]
    windows = [x.to(dtype) for x in search.refine_window_ends(
        *(torch.from_numpy(x[:150]).cuda() for x in (om, k, par)))[2]]
    plain = tslab.SlabPhysics.from_case(case).make_dispersion_plain(
        parity=None, dtype=dtype)
    for what, args in (("draws", draws), ("windows", windows)):
        want = plain(*args)
        for shape in (None, (128, 1), (128, 7)):
            before = kslab.paired
            got = kslab.slab_disp(*args, params, shape=shape)
            torch.cuda.synchronize()
            assert kslab.paired == before
            _same_bits(got, want, (what, shape))
