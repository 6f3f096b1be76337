"""Port slab dispersion vs the JAX package's, at n_interior=256, both forms.

Tolerance: f64 det and mismatch to rtol 1e-9 for the flux form (density
cases) and the uniform-flow case; 1e-8 for the Gaussian-flow shear form,
whose U' and U'' are closed forms here and jax.grad there (they differ by
~1e-16 and, where U'' crosses zero, ~1e-13 relative) and the shear shoot
amplifies that near poles and zeros. Points within 1e-6 relative of a pole,
|det| > 1e6 x the median, are masked. At f32 only det signs are held, on
points where the JAX package's f32 sign is the f64 sign (the f32 noise
floor of the shear form reaches ~|det| there).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.optimize import brentq

from eigensolver_tpu import cases as jcases
from eigensolver_tpu.physics.slab import SlabPhysics as JPhysics
from eigensolver_tpu_torch import config, search
from eigensolver_tpu_torch.kernels import slab as kslab
from eigensolver_tpu_torch.physics import slab as tslab

N_POINTS = 2000


def _reduced(case, **kw):
    return dataclasses.replace(
        case, grid=dataclasses.replace(case.grid, n_interior=256), **kw)


CASES = {
    "slab_ph_09": lambda: _reduced(jcases.slab_density_photospheric(0.9)),
    "slab_co_09": lambda: _reduced(jcases.slab_density_coronal(0.9)),
    "flow_gauss": lambda: _reduced(jcases.slab_flow_gaussian_coronal()),
    "flow_gauss_legacy_D": lambda: _reduced(jcases.slab_flow_gaussian_coronal(),
                                            shear_D_legacy=True),
    "flow_uniform": lambda: _reduced(jcases.slab_flow_uniform_photospheric()),
}
RTOL64 = {"flow_gauss": 1e-8, "flow_gauss_legacy_D": 1e-8}


def candidates(case, n, seed):
    """(omega, k, parity) spread over the case's speed bands and both
    parities."""
    rng = np.random.default_rng(seed)
    sp = np.asarray(case.sorted_speeds())
    band = rng.integers(0, len(sp) - 1, n)
    v = sp[band] + (sp[band + 1] - sp[band]) * rng.uniform(0.002, 0.998, n)
    k = rng.uniform(case.k_min, case.k_max, n)
    return v * k, k, rng.integers(0, 2, n).astype(np.float64)


def _jax_disp(case, om, k, par, dtype):
    fn = jax.jit(jax.vmap(JPhysics.from_case(case).make_dispersion(
        parity=None, dtype=dtype)))
    res = fn(jnp.asarray(om, dtype), jnp.asarray(k, dtype),
             jnp.asarray(par, dtype))
    return tuple(np.asarray(x) for x in res)


def _torch_disp(case, om, k, par, dtype):
    fn = tslab.SlabPhysics.from_case(config.from_jax(case)).make_dispersion(
        parity=None, dtype=dtype)
    res = fn(*(torch.from_numpy(x) for x in (om, k, par)))
    return tuple(x.numpy() for x in res)


@pytest.fixture(scope="module")
def results():
    out = {}
    for name, make in CASES.items():
        case = make()
        om, k, par = candidates(case, N_POINTS, seed=0)
        out[name] = {dt: (_jax_disp(case, om, k, par, getattr(jnp, dt)),
                          _torch_disp(case, om, k, par, getattr(torch, dt)))
                     for dt in ("float64", "float32")}
        out[name]["par"] = par
    return out


def _away_from_poles(det):
    med = np.median(np.abs(det[np.isfinite(det)]))
    return np.isfinite(det) & (np.abs(det) < 1e6 * med), med


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_valid_and_finite_masks_equal(results, name, dtype):
    """Valid masks equal; finite masks equal (at f32 away from the f64
    det's poles, where an f32 det can round to a huge finite value in one
    package and overflow in the other)."""
    (jdet, _, jval), (tdet, _, tval) = results[name][dtype]
    np.testing.assert_array_equal(tval, jval)
    at = (np.ones(len(jdet), bool) if dtype == "float64"
          else _away_from_poles(results[name]["float64"][0][0])[0])
    np.testing.assert_array_equal(np.isfinite(tdet[at]), np.isfinite(jdet[at]))
    assert tval.any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_det_and_mismatch_f64(results, name):
    (jdet, jmis, _), (tdet, tmis, _) = results[name]["float64"]
    par = results[name]["par"]
    ok, _ = _away_from_poles(jdet)
    assert ok.sum() > 0.5 * len(jdet)
    assert set(np.unique(par[ok])) == {0.0, 1.0}
    rtol = RTOL64.get(name, 1e-9)
    np.testing.assert_allclose(tdet[ok], jdet[ok], rtol=rtol, atol=0)
    np.testing.assert_allclose(tmis[ok], jmis[ok], rtol=rtol, atol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_det_sign_f32(results, name):
    (jdet, _, _), (tdet, _, _) = results[name]["float32"]
    (d64, _, _), _ = results[name]["float64"]
    ok, med = _away_from_poles(d64)
    big = ok & (np.abs(d64) > 1e-3 * med)
    held = big & (np.signbit(jdet) == np.signbit(d64))
    assert held.sum() > 0.9 * big.sum() > 0.2 * len(d64)
    np.testing.assert_array_equal(np.signbit(tdet[held]), np.signbit(jdet[held]))


@pytest.mark.parametrize("name", ["slab_ph_09", "flow_gauss", "flow_uniform"])
@pytest.mark.parametrize("fn", ["exterior_m", "exterior_PT_coeff",
                                "interior_F", "interior_m0"])
def test_coefficient_functions_match_jax(name, fn):
    """The exterior and interior coefficient functions at f64 on a grid of
    x in [0, 1] and the candidates' (omega, k): rtol 1e-12 (no shoot)."""
    jcase = CASES[name]()
    om, k, _ = candidates(jcase, 64, seed=6)
    jph = JPhysics.from_case(jcase)
    tph = tslab.SlabPhysics.from_case(config.from_jax(jcase))
    if fn.startswith("exterior"):
        want = np.asarray(getattr(jph, fn)(jnp.asarray(om), jnp.asarray(k)))
        got = getattr(tph, fn)(torch.from_numpy(om), torch.from_numpy(k))
    else:
        x = np.linspace(0.0, 1.0, 64)
        want = np.asarray(getattr(jph, fn)(jnp.asarray(x), jnp.asarray(om),
                                           jnp.asarray(k)))
        got = getattr(tph, fn)(torch.from_numpy(x), torch.from_numpy(om),
                               torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", ["slab_ph_09", "flow_gauss"])
def test_fixed_parity_matches_moded(name):
    case = config.from_jax(CASES[name]())
    om, k, _ = candidates(CASES[name](), 64, seed=3)
    ph = tslab.SlabPhysics.from_case(case)
    moded = ph.make_dispersion(parity=None)
    for parity in (0, 1):
        fixed = ph.make_dispersion(parity=parity)(torch.from_numpy(om),
                                                  torch.from_numpy(k))
        ref = moded(torch.from_numpy(om), torch.from_numpy(k),
                    torch.full((64,), float(parity), dtype=torch.float64))
        for a, b in zip(fixed, ref):
            assert torch.equal(a.isnan(), b.isnan())
            assert torch.equal(a[~a.isnan()], b[~b.isnan()])


def test_cpu_tensors_take_the_plain_version():
    case = config.from_jax(CASES["slab_ph_09"]())
    om, k, par = candidates(CASES["slab_ph_09"](), 16, seed=4)
    before_plain, before_kernel = tslab.plain_calls, kslab.launches
    tslab.SlabPhysics.from_case(case).make_dispersion(parity=None)(
        *(torch.from_numpy(x) for x in (om, k, par)))
    assert tslab.plain_calls == before_plain + 1
    assert kslab.launches == before_kernel
    with pytest.raises(ValueError, match="unsupported device"):
        kslab.slab_disp(*(torch.empty(4, device="meta") for _ in range(3)),
                        kslab.disp_params(case))


def test_kink_start_is_nan_where_F0_is_not_finite():
    """Kink starts at (1, 0 F(0)): at the sound point of the centre, where
    F(0) is infinite, the determinant is NaN in both packages."""
    from eigensolver_tpu.config import ProfileConfig, ProfileKind
    jcase = dataclasses.replace(
        CASES["slab_ph_09"](),
        density_profile=ProfileConfig(kind=ProfileKind.UNIFORM))
    # uniform density: c_i(x) = c_i0 = 1, so omega = k = 1 puts the centre
    # on its sound point, k^2 c_i^2 - omega^2 = 0 and F(0) = inf
    k = np.array([1.0, 1.0, 1.0])
    om = np.array([1.0, 1.0, 0.9])
    par = np.array([1.0, 0.0, 1.0])
    jdet = _jax_disp(jcase, om, k, par, jnp.float64)[0]
    tdet = _torch_disp(jcase, om, k, par, torch.float64)[0]
    assert np.isnan(jdet[0]) and np.isnan(tdet[0])
    np.testing.assert_array_equal(np.isfinite(tdet), np.isfinite(jdet))


def _analytic_relation(rg, W, K, parity):
    """Uniform-slab (with uniform flow) tanh relation; surface + body in one
    complex-sqrt expression whose real part has the same zeros."""
    Wc = np.asarray(W, complex)
    Om_i = Wc - rg.U_i0
    Om_e = Wc - rg.U_e

    def msq(c2, a2, Om):
        cT2 = c2 * a2 / (c2 + a2) if (c2 + a2) else 0.0
        return (c2 - Om**2) * (a2 - Om**2) / ((c2 + a2) * (cT2 - Om**2))

    m0 = np.sqrt(msq(rg.c_i0**2, rg.vA_i0**2, Om_i))
    me = np.sqrt(msq(rg.c_e**2, rg.vA_e**2, Om_e))
    R1 = rg.rho_e / rg.rho_i0
    base = R1 * (rg.vA_e**2 - Om_e**2) * m0 / (me * (rg.vA_i0**2 - Om_i**2))
    th = np.tanh(K * m0)
    val = base * th + 1 if parity == 0 else base / th + 1
    return val.real


@pytest.mark.parametrize("parity", [0, 1])
def test_uniform_slab_matches_tanh_relation(parity):
    """The port's polished roots on the uniform slab (width 1e5) against the
    analytic relation, as tests/test_slab_analytic.py holds the JAX package:
    rtol 2e-6 (here at n_interior=256, a 401-point ladder and 40
    bisections, to keep the eager CPU run short)."""
    from eigensolver_tpu_torch import cases
    case = cases.slab_density_photospheric(width=1e5)
    rg = case.regime
    k = 1.5
    case = dataclasses.replace(
        case, grid=dataclasses.replace(case.grid, n_interior=256))
    disp = tslab.SlabPhysics.from_case(case).make_dispersion(parity=parity)
    W = np.linspace(0.95, 1.29, 401)
    om = torch.from_numpy(W * k)[None, :]
    ks = torch.tensor([k], dtype=torch.float64)
    det, valid, _ = search.ladder_scan(disp, om, ks)
    br = search.find_brackets(om, ks, det, valid, max_per_row=16)
    pr = search.bisect(disp, br, n_iter=40)
    mask = pr.mask.numpy() & (pr.mismatch.numpy() < 0.5)
    got = np.sort(pr.omega.numpy()[mask]) / k

    Wa = np.linspace(0.95, 1.29, 8001)
    s = np.sign(_analytic_relation(rg, Wa, k, parity))
    want = []
    for i in np.nonzero(s[:-1] * s[1:] < 0)[0]:
        r = brentq(lambda w: _analytic_relation(rg, w, k, parity), Wa[i],
                   Wa[i + 1], xtol=1e-13)
        if abs(_analytic_relation(rg, r, k, parity)) < 1e-6:
            want.append(r)
    want = np.asarray(want)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, rtol=2e-6)


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_card(name):
    """Kernel and plain version on the card: f64 to rtol 1e-9 (bit-equal by
    construction, --fmad=false), masks equal."""
    case = config.from_jax(CASES[name]())
    om, k, par = candidates(CASES[name](), 512, seed=5)
    ph = tslab.SlabPhysics.from_case(case)
    args = [torch.from_numpy(x).cuda() for x in (om, k, par)]
    before = kslab.launches
    kdet, kmis, kval = ph.make_dispersion(parity=None)(*args)
    torch.cuda.synchronize()
    assert kslab.launches == before + 1
    pdet, pmis, pval = ph.make_dispersion_plain(parity=None)(*args)
    assert torch.equal(kval, pval)
    assert torch.equal(kdet.isfinite(), pdet.isfinite())
    kd, pd = kdet.cpu().numpy(), pdet.cpu().numpy()
    ok, _ = _away_from_poles(pd)
    np.testing.assert_allclose(kd[ok], pd[ok], rtol=1e-9, atol=0)
    np.testing.assert_allclose(kmis.cpu().numpy()[ok], pmis.cpu().numpy()[ok],
                               rtol=1e-9, atol=0)


# The largest table chunk (RK4 steps) whose 2 x 3 entries fit a block's
# 227 KiB of shared memory: entries of 32 / 48 bytes (flux, f32 / f64) and
# 16 / 32 (shear)
MAX_CHUNK = {(False, torch.float32): 1210, (False, torch.float64): 807,
             (True, torch.float32): 2421, (True, torch.float64): 1210}


@pytest.mark.parametrize("shear", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scan_shape_fits_the_card(dtype, shear):
    """The default launch shapes are ones the kernel is built for and their
    tables fit a block's shared memory in both forms; every block size the
    kernel is built for is taken, up to the largest chunk that fits; other
    shapes are refused."""
    for n in (1, 1530, 161_280, 179_200):
        kslab._check_scan_shape(kslab.scan_shape(n, shear), dtype, shear)
    top = MAX_CHUNK[(shear, dtype)]
    for good in ((32, 1), (64, 7), (128, 300), (256, top), (512, 64)):
        kslab._check_scan_shape(kslab.ScanShape(*good), dtype, shear)
    for bad in ((96, 32), (16, 32), (256, 0), (1024, 32), (256, top + 1)):
        with pytest.raises(ValueError, match="launch shape"):
            kslab._check_scan_shape(kslab.ScanShape(*bad), dtype, shear)


@pytest.mark.parametrize("n,shear,want", [
    (161_280, False, (256, 128)),    # slab_ph_09's scan
    (33_792, False, (256, 128)),     # 132 blocks of 256
    (33_791, False, (128, 128)),
    (1_530, False, (128, 128)),      # its refine stage's window ends
    (179_200, True, (128, 128)),     # slab_flow_gaussian_coronal's scan
    (1_530, True, (128, 128))])
def test_default_launch_shape_by_regime(n, shear, want):
    """256 threads a block for the flux form's scans, 128 for the shear
    form and for batches that blocks of 256 would not spread over every
    SM; chunks of 128 steps."""
    assert kslab.scan_shape(n, shear) == kslab.ScanShape(*want)


@pytest.mark.parametrize("name", ["slab_ph_09", "flow_gauss"])
def test_bad_launch_shape_raises_on_any_device(name):
    """A launch shape the kernel is not built for raises before any
    dispersion runs, on CPU tensors too; a good one leaves the plain
    version's result as it is."""
    case = config.from_jax(CASES[name]())
    om, k, par = (torch.from_numpy(x)
                  for x in candidates(CASES[name](), 8, seed=8))
    params = kslab.disp_params(case)
    before = tslab.plain_calls
    with pytest.raises(ValueError, match="launch shape"):
        kslab.slab_disp(om, k, par, params, shape=(96, 32))
    assert tslab.plain_calls == before
    want = kslab.slab_disp(om, k, par, params)
    got = kslab.slab_disp(om, k, par, params, shape=(64, 7))
    for a, b in zip(got, want):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a[~a.isnan()], b[~b.isnan()])


def _assert_same_bits(got, want, what):
    assert torch.equal(got.valid, want.valid), what
    for a, b in ((got.det, want.det), (got.mismatch_pct, want.mismatch_pct)):
        same = (a == b) | (a.isnan() & b.isnan())
        assert bool(same.all()), (what, int((~same).sum()))


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("name,pressure",
                         [(n, False) for n in sorted(CASES)]
                         + [("flow_gauss", True), ("flow_uniform", True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_bit_equal_to_plain_on_card(dtype, name, pressure):
    """The scan's (det, mismatch, valid) are the plain version's bits, both
    forms (the shear form with and without the shear-pressure term), both
    types, with a candidate count and a step count that are no multiple of
    a block or a table chunk, at several launch shapes."""
    full = config.from_jax(CASES[name]())
    case = dataclasses.replace(full, grid=dataclasses.replace(
        full.grid, n_interior=250))
    om, k, par = candidates(CASES[name](), 1001, seed=7)
    args = [torch.from_numpy(x).to(device="cuda", dtype=dtype)
            for x in (om, k, par)]
    want = tslab.SlabPhysics.from_case(case).make_dispersion_plain(
        parity=None, dtype=dtype, include_shear_pressure=pressure)(*args)
    params = kslab.disp_params(case, include_shear_pressure=pressure)
    for shape in (None, (32, 5), (64, 7), (128, 32), (256, 64), (512, 300)):
        before = kslab.launches
        got = kslab.slab_disp(*args, params, shape=shape)
        torch.cuda.synchronize()
        assert kslab.launches == before + 1
        _assert_same_bits(got, want, shape)
    with pytest.raises(ValueError, match="launch shape"):
        kslab.slab_disp(*args, params, shape=(96, 32))


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_kernel_bit_equal_to_plain_on_card_at_window_size():
    """float64 at the refine stage's size on slab_ph_09 (1,530 candidates,
    the full 2048 steps): the plain version's bits at the default launch
    shape and at smaller blocks."""
    case = config.from_jax(jcases.slab_density_photospheric(0.9))
    om, k, par = candidates(jcases.slab_density_photospheric(0.9), 1530,
                            seed=9)
    args = [torch.from_numpy(x).cuda() for x in (om, k, par)]
    want = tslab.SlabPhysics.from_case(case).make_dispersion_plain(
        parity=None, dtype=torch.float64)(*args)
    params = kslab.disp_params(case)
    for shape in (None, (32, 16), (64, 64), (128, 64)):
        got = kslab.slab_disp(*args, params, shape=shape)
        _assert_same_bits(got, want, shape)
