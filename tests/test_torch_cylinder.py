"""Port cylinder dispersion vs the JAX package's, on the reduced
cylinder_density_coronal(0.9) grid (n_interior=256, n_axis_log=32).

Tolerance: f64 det and mismatch to rtol 1e-9. The two packages order some
floating-point operations differently (and their exp/log differ by an ulp),
and the inward shoot amplifies such differences: the irregular r^-m
component of the m = 1 basis solution costs ~100x (search.py:177-187), and
near poles more (a 1-ulp change of the profile width moves det by up to 1e-9
relative there). Points within 1e-6 relative of a pole, |det| > 1e6 x the
median, are masked. At f32 the determinant carries noise of that size, so
only its sign is held, wherever |det| > 1e-3 x the median.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from eigensolver_tpu import cases as jcases
from eigensolver_tpu.physics.cylinder import CylinderPhysics as JPhysics
from eigensolver_tpu_torch import config
from eigensolver_tpu_torch.kernels import cylinder as kcyl
from eigensolver_tpu_torch.physics import cylinder as tcyl

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools_torch import batches  # noqa: E402

N_POINTS = 2000


def reduced_case():
    c = jcases.cylinder_density_coronal(0.9)
    return dataclasses.replace(
        c, grid=dataclasses.replace(c.grid, n_interior=256, n_axis_log=32))


def candidates(case, n, seed):
    """(omega, k, m) spread over the case's speed bands and both m."""
    rng = np.random.default_rng(seed)
    sp = np.asarray(case.sorted_speeds())
    band = rng.integers(0, len(sp) - 1, n)
    v = sp[band] + (sp[band + 1] - sp[band]) * rng.uniform(0.002, 0.998, n)
    k = rng.uniform(case.k_min, case.k_max, n)
    return v * k, k, rng.integers(0, 2, n).astype(np.float64)


def _jax_disp(case, om, k, m, dtype):
    fn = jax.jit(jax.vmap(JPhysics.from_case(case).make_dispersion(
        m=None, dtype=dtype)))
    res = fn(jnp.asarray(om, dtype), jnp.asarray(k, dtype),
             jnp.asarray(m, dtype))
    return tuple(np.asarray(x) for x in res)


def _torch_disp(case, om, k, m, dtype):
    fn = tcyl.CylinderPhysics.from_case(config.from_jax(case)).make_dispersion(
        m=None, dtype=dtype)
    res = fn(*(torch.from_numpy(x) for x in (om, k, m)))
    return tuple(x.numpy() for x in res)


def _both(dtype):
    case = reduced_case()
    om, k, m = candidates(case, N_POINTS, seed=0)
    jd = _jax_disp(case, om, k, m, getattr(jnp, dtype))
    td = _torch_disp(case, om, k, m, getattr(torch, dtype))
    return jd, td, m


@pytest.fixture(scope="module")
def both64():
    return _both("float64")


@pytest.fixture(scope="module")
def both32():
    return _both("float32")


def _away_from_poles(det):
    med = np.median(np.abs(det[np.isfinite(det)]))
    return np.isfinite(det) & (np.abs(det) < 1e6 * med), med


@pytest.mark.parametrize("fixture", ["both64", "both32"])
def test_valid_and_finite_masks_equal(fixture, request):
    (jdet, _, jval), (tdet, _, tval), _ = request.getfixturevalue(fixture)
    np.testing.assert_array_equal(tval, jval)
    np.testing.assert_array_equal(np.isfinite(tdet), np.isfinite(jdet))
    assert tval.any()


def test_det_and_mismatch_f64(both64):
    (jdet, jmis, _), (tdet, tmis, _), m = both64
    ok, _ = _away_from_poles(jdet)
    assert ok.sum() > 0.99 * len(jdet)
    assert set(np.unique(m[ok])) == {0.0, 1.0}
    np.testing.assert_allclose(tdet[ok], jdet[ok], rtol=1e-9, atol=0)
    np.testing.assert_allclose(tmis[ok], jmis[ok], rtol=1e-9, atol=0)


def test_det_sign_f32(both32):
    (jdet, _, _), (tdet, _, _), _ = both32
    ok, med = _away_from_poles(jdet)
    big = ok & (np.abs(jdet) > 1e-3 * med)
    assert big.sum() > 0.5 * len(jdet)
    np.testing.assert_array_equal(np.signbit(tdet[big]), np.signbit(jdet[big]))


def test_fixed_mode_matches_moded():
    case = config.from_jax(reduced_case())
    om, k, m = candidates(reduced_case(), 64, seed=3)
    ph = tcyl.CylinderPhysics.from_case(case)
    moded = ph.make_dispersion(m=None)
    for mode in (0, 1):
        fixed = ph.make_dispersion(m=mode)(torch.from_numpy(om),
                                           torch.from_numpy(k))
        ref = moded(torch.from_numpy(om), torch.from_numpy(k),
                    torch.full((64,), float(mode), dtype=torch.float64))
        for a, b in zip(fixed, ref):
            assert torch.equal(a.isnan(), b.isnan())
            assert torch.equal(a[~a.isnan()], b[~b.isnan()])


def test_cpu_tensors_take_the_plain_version():
    case = config.from_jax(reduced_case())
    om, k, m = candidates(reduced_case(), 16, seed=4)
    before_plain, before_kernel = tcyl.plain_calls, kcyl.launches
    tcyl.CylinderPhysics.from_case(case).make_dispersion(m=None)(
        *(torch.from_numpy(x) for x in (om, k, m)))
    assert tcyl.plain_calls == before_plain + 1
    assert kcyl.launches == before_kernel
    with pytest.raises(ValueError, match="unsupported device"):
        kcyl.cylinder_disp(*(torch.empty(4, device="meta") for _ in range(3)),
                           kcyl.disp_params(case))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scan_shape_fits_the_card(dtype):
    """The default launch shape is one the kernel is built for and its
    table fits a block's shared memory; other shapes are refused."""
    kcyl._check_scan_shape(kcyl.SCAN_SHAPE, dtype)
    for bad in ((96, 32), (256, 0), (1024, 32), (256, 1000)):
        with pytest.raises(ValueError, match="launch shape"):
            kcyl._check_scan_shape(kcyl.ScanShape(*bad), dtype)


# -- the scan's row table, modelled on the CPU -------------------------------

def row_table_model(ph, omega, k, m):
    """invF_g(r) of the scan with its row table (csrc/cylinder_disp.cu::
    row_point, hain_lust): the values that depend on (k, m, r) alone - k U,
    alf^2, cusp^2, (c^2 + vA^2)(m^2/r^2 + k^2) - formed once per distinct
    (k, m) row with the plain version's operations, each candidate's omega
    part from its row's values. Returns (invF_g, number of rows)."""
    pairs, row_of = np.unique(np.stack([k.numpy(), m.numpy()], axis=1),
                              axis=0, return_inverse=True)
    row_of = torch.from_numpy(row_of.reshape(-1))
    rk, rm = (torch.from_numpy(pairs[:, j]).to(k.dtype) for j in (0, 1))
    eq = ph.eq

    def invF_g(r):
        rho, ci, vA = eq.rho_i(r), eq.c_i(r), eq.vA_i(r)
        csum = ci * ci + vA * vA
        # per row
        kU = rk * eq.U_i(r)
        alf = rk * eq.B_i(r) / tcyl.sqrt(rho)
        cusp = alf * ci / tcyl.sqrt(csum)
        alf2, cusp2 = alf * alf, cusp * cusp
        X = csum * (rm * rm / (r * r) + rk * rk)
        # per candidate
        shift = omega - kU[row_of]
        s2 = shift * shift
        da = s2 - alf2[row_of]
        dc = s2 - cusp2[row_of]
        D = rho * csum * da * dc
        A = rho * da
        C2 = s2 * s2 - X[row_of] * dc
        C3 = D * A + 0.0
        c1c3 = tcyl._zero_over(C3)
        iF = A / r + tcyl._zero_over(r * D)
        g = -c1c3 - r * (C2 - c1c3) / D
        return iF, g
    return invF_g, len(pairs)


ROW_CASES = {
    # the density tube with the log tail, and the axial-flow tube of the
    # cyl_flow_1 parity target (k U differs from row to row)
    "density": lambda: dataclasses.replace(
        config.from_jax(jcases.cylinder_density_coronal(0.9)),
        k_values=(0.3, 1.7, 4.1), grid=dataclasses.replace(
            config.from_jax(jcases.cylinder_density_coronal(0.9)).grid,
            n_interior=48, n_axis_log=12)),
    "flow": lambda: dataclasses.replace(
        config.from_jax(jcases.cylinder_flow_coronal(0.05, 1.0)),
        k_values=(0.2, 2.3), grid=dataclasses.replace(
            config.from_jax(jcases.cylinder_flow_coronal(0.05, 1.0)).grid,
            n_interior=48, n_axis_log=12)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(ROW_CASES))
def test_row_table_model_bit_equal_to_plain_chain(name, dtype, monkeypatch):
    """The factoring of the scan's row table keeps the bits: at every
    abscissa of the plain shoot (interior and log tail), (1/F, g) from the
    (k, m, r) values formed once per row equal _plain_coefficients'
    per-candidate chain bit for bit, NaN and inf where it has them."""
    case = ROW_CASES[name]()
    ph = tcyl.CylinderPhysics.from_case(case)
    om, k, m = batches.flat_ladder(case, 37, dtype, "cpu")
    seen = []
    plain_coefficients = tcyl.CylinderPhysics.coefficients

    def recording(self, omega, k_, m_):
        fns = plain_coefficients(self, omega, k_, m_)

        def invF_g(r):
            out = fns[4](r)
            seen.append((r, out))
            return out
        return (*fns[:4], invF_g)
    monkeypatch.setattr(tcyl.CylinderPhysics, "coefficients", recording)
    ph.make_dispersion_plain(m=None, dtype=dtype)(om, k, m)
    model, n_rows = row_table_model(ph, om, k, m)
    g = case.grid
    assert len(seen) == 3 * (g.n_interior + g.n_axis_log)
    assert n_rows == len(case.k_values) * len(case.modes) < om.numel()
    for r, want in seen:
        for a, b in zip(model(r), want):
            assert torch.equal(a.isnan(), b.isnan())
            assert torch.equal(a[~a.isnan()], b[~b.isnan()])


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_kernel_matches_plain_on_card():
    case = config.from_jax(reduced_case())
    om, k, m = candidates(reduced_case(), 512, seed=5)
    ph = tcyl.CylinderPhysics.from_case(case)
    args = [torch.from_numpy(x).cuda() for x in (om, k, m)]
    before = kcyl.launches
    kdet, kmis, kval = ph.make_dispersion(m=None)(*args)
    torch.cuda.synchronize()
    assert kcyl.launches == before + 1
    pdet, pmis, pval = ph.make_dispersion_plain(m=None)(*args)
    assert torch.equal(kval, pval)
    kd, pd = kdet.cpu().numpy(), pdet.cpu().numpy()
    ok, _ = _away_from_poles(pd)
    np.testing.assert_allclose(kd[ok], pd[ok], rtol=1e-9, atol=0)
    np.testing.assert_allclose(kmis.cpu().numpy()[ok], pmis.cpu().numpy()[ok],
                               rtol=1e-9, atol=0)


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_kernel_bit_equal_to_plain_f32_on_card():
    """float32: the scan's (det, mismatch, valid) are the plain version's
    bits, with a candidate count and step counts that are no multiple of a
    block or a table chunk, at several launch shapes."""
    full = config.from_jax(jcases.cylinder_density_coronal(0.9))
    case = dataclasses.replace(full, grid=dataclasses.replace(
        full.grid, n_interior=250, n_axis_log=30))
    om, k, m = candidates(reduced_case(), 1001, seed=6)
    args = [torch.from_numpy(x).to(device="cuda", dtype=torch.float32)
            for x in (om, k, m)]
    ph = tcyl.CylinderPhysics.from_case(case)
    want = ph.make_dispersion_plain(m=None, dtype=torch.float32)(*args)
    params = kcyl.disp_params(case)
    for shape in (None, (128, 7), (256, 32), (512, 64), (256, 300)):
        before = kcyl.launches
        got = kcyl.cylinder_disp(*args, params, shape=shape)
        torch.cuda.synchronize()
        assert kcyl.launches == before + 1
        assert torch.equal(got.valid, want.valid), shape
        for a, b in ((got.det, want.det), (got.mismatch_pct, want.mismatch_pct)):
            same = (a == b) | (a.isnan() & b.isnan())
            assert bool(same.all()), (shape, int((~same).sum()))
    with pytest.raises(ValueError, match="launch shape"):
        kcyl.cylinder_disp(*args, params, shape=(96, 32))


# -- card: the scan's row table on the batches' row layouts -----------------

def card_layout_case(exterior: str):
    """The density/axial-flow scan at a reduced depth, with the K_m ratio
    (the density tube) or the numeric exterior (the cyl_flow_1 tube);
    3 k values, both modes."""
    if exterior == "bessel":
        full = config.from_jax(jcases.cylinder_density_coronal(0.9))
        grid = dataclasses.replace(full.grid, n_interior=250, n_axis_log=30)
    else:
        full = config.from_jax(jcases.cylinder_flow_coronal(0.05, 1.0))
        grid = dataclasses.replace(
            full.grid, n_interior=250, n_axis_log=30,
            exterior_method="numeric", exterior_wavelengths=3.0,
            n_exterior=200)
    return dataclasses.replace(full, grid=grid, k_values=(0.15, 1.3, 3.9))


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("exterior", ["bessel", "numeric"])
def test_scan_row_layouts_bit_equal_to_plain_on_card(exterior, dtype):
    """Both scan instantiations give the plain version's bits on every row
    layout (tools_torch.batches.row_layout_batches, at a reduced depth),
    one launch a batch: where the rows are at least a block long every
    candidate takes its block's row table (and the numeric exterior's
    exps' table), on the runs of 37 some warps do and the rest form their
    own values, on the others every warp does
    (kernels.cylinder.scan_tabled); the pole points' NaN and inf where the
    plain version has them."""
    case = card_layout_case(exterior)
    ph = tcyl.CylinderPhysics.from_case(case)
    kern = ph.make_dispersion(m=None, dtype=dtype)
    plain = ph.make_dispersion_plain(m=None, dtype=dtype)
    kcyl.scan_tabled("cuda")
    non_finite = 0
    layouts = batches.row_layout_batches(
        case, dtype, runs=((1519, 3), (256, 5), (37, 30), (1, 200)),
        n_continua=700, n_draws=777, n_windows=60)
    for name, args in layouts.items():
        n = args[0].numel()
        got, want = kern(*args), plain(*args)
        rows, ext = kcyl.scan_tabled("cuda")
        assert torch.equal(got.valid, want.valid), name
        for a, b in ((got.det, want.det),
                     (got.mismatch_pct, want.mismatch_pct)):
            assert bool(((a == b) | (a.isnan() & b.isnan())).all()), name
        non_finite += int((~want.det.isfinite()).sum())
        if name in batches.LONG_RUNS:
            assert rows == n, name
        elif name == batches.MIXED_RUNS:   # some warps on each path
            assert 0 < rows < n, name
        else:                              # every warp on its own values
            assert rows == 0, name
        if exterior == "numeric":
            assert rows <= ext <= n, name
        else:
            assert ext == 0
    assert non_finite > 0


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("exterior", ["bessel", "numeric"])
def test_bisect_equals_launch_loop_of_the_scan_on_card(exterior, dtype):
    """The fused bisection (its per-column chain) stays bit-equal to the
    loop of launches of the row-table scan, on the brackets of a reduced
    sweep of either exterior: (root, mismatch) at 6 iterations."""
    from eigensolver_tpu_torch import search
    case = card_layout_case(exterior)
    disp = tcyl.CylinderPhysics.from_case(case).make_dispersion(
        m=None, dtype=dtype)
    om, k, m = batches.flat_ladder(case, 64, dtype)
    n = om.numel() // 64
    det, valid, mism = search.ladder_scan(disp, om.view(n, 64),
                                          k.view(n, 64)[:, 0],
                                          m.view(n, 64)[:, 0])
    br = search.find_brackets(om.view(n, 64), k.view(n, 64)[:, 0], det,
                              valid, 8, m.view(n, 64)[:, 0], mism=mism)
    br = [x.contiguous() for x in (br.lo, br.hi, br.k, br.mode)]
    assert br[0].numel() > 10
    got = disp.bisect(*br, 6)
    want = search.bisect_loop(disp, *br, 6)
    for a, b in zip(got, want):
        assert bool(((a == b) | (a.isnan() & b.isnan())).all())
