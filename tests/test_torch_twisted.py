"""The port's twisted cylinder chain (rotational flow and magnetic twist)
against the sympy oracle and the JAX package, and its pieces: `dual.Dual`,
`profiles.power`, `equilibrium.genuine_continua_rowfn` and the row mask.

Tolerances, as tests/test_torch_cylinder.py states them: the chain against
the sympy oracle and the dispersion against the JAX package at f64 to rtol
1e-9 (the port's dual arithmetic orders its tangent products otherwise than
jax.jvp, and the inward shoot amplifies rounding), with points within 1e-6
relative of a pole (|det| > 1e6 x the median) masked; at f32 the sign where
|det| > 1e-3 x the median. The row ranges to rtol 1e-12 (the same radii and
expressions). Reduced grid: n_interior=256.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from eigensolver_tpu import cases as jcases
from eigensolver_tpu import search as jsearch
from eigensolver_tpu.equilibrium import genuine_continua_rowfn as jrowfn
from eigensolver_tpu.physics.cylinder import CylinderPhysics as JPhysics
from eigensolver_tpu_torch import cases, config, search
from eigensolver_tpu_torch.dual import Dual, dsqrt
from eigensolver_tpu_torch.equilibrium import genuine_continua_rowfn
from eigensolver_tpu_torch.kernels import cylinder as kcyl
from eigensolver_tpu_torch.physics import cylinder as tcyl
from eigensolver_tpu_torch.profiles import power

N_POINTS = 1000
# tests/test_btwist.py's magnetic twist
B_TWIST, V_TWIST, POWER = 0.1, 0.15, 1.25

FAMILIES = {
    # bench.py's twist_v01_p1: B_phi = 0, p = 1
    "photospheric": lambda: jcases.cylinder_twisted_photospheric(
        v_twist=0.1, power=1.0, mode=1),
    # tests/test_btwist.py's configuration: every term of the chain live
    "magnetic": lambda: jcases.cylinder_twisted_magnetic(
        B_twist=B_TWIST, v_twist=V_TWIST, power=POWER, mode=1),
}


def reduced(jcase, **grid):
    return dataclasses.replace(jcase, grid=dataclasses.replace(
        jcase.grid, n_interior=256, **grid))


def candidates(case, n, seed):
    """(omega, k, m) over the case's speed bands, m in {0, 1}."""
    rng = np.random.default_rng(seed)
    sp = np.asarray(case.sorted_speeds())
    band = rng.integers(0, len(sp) - 1, n)
    v = sp[band] + (sp[band + 1] - sp[band]) * rng.uniform(0.002, 0.998, n)
    k = rng.uniform(case.k_min, case.k_max, n)
    return v * k, k, rng.integers(0, 2, n).astype(np.float64)


def _jax_disp(jcase, om, k, m, dtype):
    fn = jax.jit(jax.vmap(JPhysics.from_case(jcase).make_dispersion(
        m=None, dtype=dtype)))
    res = fn(*(jnp.asarray(x, dtype) for x in (om, k, m)))
    return tuple(np.asarray(x) for x in res)


def _torch_disp(jcase, om, k, m, dtype):
    fn = tcyl.CylinderPhysics.from_case(config.from_jax(jcase)).make_dispersion(
        m=None, dtype=dtype)
    return tuple(x.numpy() for x in fn(*(torch.from_numpy(x)
                                         for x in (om, k, m))))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def both(request):
    """Both packages' dispersion of one family at f64 and f32."""
    jcase = reduced(FAMILIES[request.param]())
    om, k, m = candidates(jcase, N_POINTS, seed=0)
    out = {}
    for name in ("float64", "float32"):
        out[name] = (_jax_disp(jcase, om, k, m, getattr(jnp, name)),
                     _torch_disp(jcase, om, k, m, getattr(torch, name)))
    return out, m


def _away_from_poles(det):
    med = np.median(np.abs(det[np.isfinite(det)]))
    return np.isfinite(det) & (np.abs(det) < 1e6 * med), med


@pytest.mark.parametrize("m", [0, 1])
def test_chain_matches_sympy(m):
    """D, C1, C3, F, g and 1/F of the port's chain, and the fused pair
    invF_g the shoot integrates, against the reference's symbolic chain
    (tests/test_btwist.py's, which needs sympy)."""
    pytest.importorskip("sympy")
    from test_btwist import _sympy_chain
    case = cases.cylinder_twisted_magnetic(
        B_twist=B_TWIST, v_twist=V_TWIST, power=POWER, mode=m)
    oracle = _sympy_chain(case.regime, 1.3, 0.9, m)

    def t(x):
        return torch.tensor(x, dtype=torch.float64)

    Dfun, C1fun, C3fun, Ffun, invF_g = tcyl.CylinderPhysics.from_case(
        case).coefficients(t(1.3), t(0.9), t(float(m)))
    for rv in (0.3, 0.7, 0.95):
        iF, g = invF_g(t(rv))
        got = {"D": Dfun(t(rv)), "C1": C1fun(t(rv)), "C3": C3fun(t(rv)),
               "F": Ffun(t(rv)), "g": g, "invF": iF}
        for name, value in got.items():
            np.testing.assert_allclose(
                float(value), float(oracle[name](rv)), rtol=1e-9,
                err_msg=f"{name}(r={rv}) m={m}")


def test_valid_and_finite_masks_equal(both):
    out, _ = both
    for name, ((jdet, _, jval), (tdet, _, tval)) in out.items():
        np.testing.assert_array_equal(tval, jval, err_msg=name)
        np.testing.assert_array_equal(np.isfinite(tdet), np.isfinite(jdet),
                                      err_msg=name)
        assert tval.any()


def test_det_and_mismatch_f64(both):
    out, m = both
    (jdet, jmis, _), (tdet, tmis, _) = out["float64"]
    ok, _ = _away_from_poles(jdet)
    assert ok.sum() > 0.99 * len(jdet)
    assert set(np.unique(m[ok])) == {0.0, 1.0}
    np.testing.assert_allclose(tdet[ok], jdet[ok], rtol=1e-9, atol=0)
    np.testing.assert_allclose(tmis[ok], jmis[ok], rtol=1e-9, atol=0)


def test_det_sign_f32(both):
    out, _ = both
    (jdet, _, _), (tdet, _, _) = out["float32"]
    ok, med = _away_from_poles(jdet)
    big = ok & (np.abs(jdet) > 1e-3 * med)
    assert big.sum() > 0.5 * len(jdet)
    np.testing.assert_array_equal(np.signbit(tdet[big]), np.signbit(jdet[big]))


def test_zero_field_reduces_to_flow_twist():
    """B_twist -> 0 gives the rotational-flow determinant (the port's
    version of tests/test_btwist.py's reduction)."""
    base = reduced(jcases.cylinder_twisted_photospheric(0.1, 1.0, 1))
    withb = reduced(jcases.cylinder_twisted_magnetic(0.0, 0.1, 1.0, 1))
    om = np.linspace(1.05, 1.25, 32)
    k = np.full(32, 1.2)
    m = np.ones(32)
    d0 = _torch_disp(base, om, k, m, torch.float64)[0]
    d1 = _torch_disp(withb, om, k, m, torch.float64)[0]
    assert np.isfinite(d0).all()
    np.testing.assert_allclose(d1, d0, rtol=1e-9)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_twisted_cases_take_no_log_tail(name):
    """Twisted cases end the shoot at axis_epsilon, in the plain version
    (n_axis_log does not matter) and in the kernel parameters."""
    jcase = FAMILIES[name]()
    case = config.from_jax(jcase)
    assert case.grid.axis_epsilon_final < case.grid.axis_epsilon
    params = kcyl.disp_params(case)
    assert (params.struct.twisted, params.struct.log_tail) == (1, 0)
    assert not tcyl.log_tail(case)
    plain = kcyl.disp_params(cases.cylinder_density_coronal())
    assert (plain.struct.twisted, plain.struct.log_tail) == (0, 1)
    om, k, m = candidates(jcase, 8, seed=1)
    args = [torch.from_numpy(x) for x in (om, k, m)]
    small = reduced(jcase, n_axis_log=4)
    dets = [tcyl.CylinderPhysics.from_case(config.from_jax(c)).make_dispersion(
        m=None)(*args).det for c in (reduced(jcase), small)]
    assert torch.equal(dets[0], dets[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_twisted_scan_shape_fits_the_card(dtype):
    """The default launch shape's twisted table (19 values an entry) fits a
    block's shared memory at both types."""
    kcyl._check_scan_shape(kcyl.SCAN_SHAPE, dtype, twisted=True)
    assert kcyl._ENTRY_BYTES[dtype, True] == (80 if dtype == torch.float32
                                              else 160)
    # a chunk whose table fits at 9 values an entry, not at 19
    big = kcyl.ScanShape(256, 500 if dtype == torch.float32 else 300)
    kcyl._check_scan_shape(big, dtype)
    with pytest.raises(ValueError, match="launch shape"):
        kcyl._check_scan_shape(big, dtype, twisted=True)


@pytest.mark.parametrize("geometry", ["slab", "cylinder"])
@pytest.mark.parametrize("field", ["density_profile", "flow_profile"])
def test_power_law_density_and_flow_are_refused(geometry, field):
    """Only the twist profiles may be power laws: the kernels' density and
    flow profiles form a power with pow, not as profiles.power does."""
    from eigensolver_tpu_torch.kernels import slab as kslab
    base = (cases.slab_density_photospheric() if geometry == "slab"
            else cases.cylinder_density_coronal())
    kmod = kslab if geometry == "slab" else kcyl
    kmod.disp_params(base)
    law = config.ProfileConfig(kind=config.ProfileKind.POWER_LAW,
                               amplitude=0.1, power=1.25)
    with pytest.raises(NotImplementedError, match="power-law"):
        kmod.disp_params(dataclasses.replace(base, **{field: law}))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_rowfn_matches_jax(name):
    jcase = FAMILIES[name]()
    ks = np.linspace(0.15, 4.0, 9)
    ms = np.array([0.0, 1.0, 1.0, 0.0, 1.0, 0.0, 1.0, 1.0, 0.0])
    jlo, jhi = jax.vmap(jrowfn(jcase))(jnp.asarray(ks), jnp.asarray(ms))
    lo, hi = genuine_continua_rowfn(config.from_jax(jcase))(
        torch.from_numpy(ks), torch.from_numpy(ms))
    assert lo.shape == hi.shape == (9, 4)
    np.testing.assert_allclose(lo.numpy(), np.asarray(jlo), rtol=1e-12)
    np.testing.assert_allclose(hi.numpy(), np.asarray(jhi), rtol=1e-12)
    # some band of the kink rows has width, and the p = 1 flow-only
    # Alfven bands are degenerate (lo > hi)
    assert bool((lo < hi)[ms == 1.0].any())
    if name == "photospheric":
        assert bool((lo[:, :2] > hi[:, :2]).all())
    assert genuine_continua_rowfn(cases.cylinder_density_coronal()) is None


def test_mask_rows_nans_det_strictly_inside():
    omegas = torch.tensor([[0.5, 1.0, 1.5, 2.0, 2.5]], dtype=torch.float32)
    ks = torch.ones(1, dtype=torch.float32)
    det = torch.arange(5, dtype=torch.float32)[None]

    def rowfn(k, m):
        assert k.dtype == m.dtype == torch.float64
        return (torch.tensor([[1.0, 2.2]], dtype=torch.float64),
                torch.tensor([[2.0, 2.1]], dtype=torch.float64))

    got = search.mask_rows(omegas, ks, None, det, rowfn)
    assert got.dtype == det.dtype
    np.testing.assert_array_equal(got.isnan().numpy(),
                                  [[False, False, True, False, False]])


def test_from_jax_refuses_a_jax_rowfn():
    jcase = FAMILIES["magnetic"]()
    cfg = jsearch.SearchConfig(n_omega=64, exclude_omega_rowfn=jrowfn(jcase))
    with pytest.raises(TypeError, match="genuine_continua_rowfn"):
        search.SearchConfig.from_jax(cfg)
    ported = search.SearchConfig.from_jax(
        dataclasses.replace(cfg, exclude_omega_rowfn=None))
    assert ported.n_omega == 64 and ported.exclude_omega_rowfn is None


@pytest.mark.parametrize("p", [0.0, 1.0, 2.0, 3.0, 0.5, -0.5, -1.0, -2.0,
                               1.25, 0.25, -0.75, 2.5])
def test_power_is_the_power(p):
    """profiles.power writes out the exponents pow special-cases; every
    value within an ulp of x ** p (the special forms round more than once)."""
    x = torch.linspace(0.01, 3.0, 257, dtype=torch.float64)
    np.testing.assert_allclose(power(x, p).numpy(), (x ** p).numpy(),
                               rtol=4e-16, atol=0)


def test_dual_rules():
    """Each rule of dual.Dual against the closed-form derivative of
    f(r) = sqrt(1 - r^2 / 4) (3 - r) / (2 r) + r^2 - r / 4."""
    r = torch.linspace(0.1, 1.9, 50, dtype=torch.float64)
    R = Dual(r, torch.ones_like(r))
    f = (dsqrt(1.0 - R * R / 4.0) * (3.0 - R) / (2 * R) + R * R
         - R * torch.full_like(r, 0.25))
    s = torch.sqrt(1 - r * r / 4)
    want_v = s * (3 - r) / (2 * r) + r * r - r / 4
    g = (3 - r) / (2 * r)
    dg = -3 / (2 * r * r)
    want_d = -r / (4 * s) * g + s * dg + 2 * r - 0.25
    np.testing.assert_allclose(f.v.numpy(), want_v.numpy(), rtol=1e-14)
    np.testing.assert_allclose(f.d.numpy(), want_d.numpy(), rtol=1e-12)
    n = -(R - R * 2.0)
    assert torch.equal(n.d, torch.ones_like(r))


def _load(path):
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(Path(path).stem, root / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("b_phi_zero", [False, True])
def test_twisted_op_counts_match_chip_smoke(b_phi_zero):
    """chip_smoke.py's bound counts the twisted chain's operations as
    tools_torch/count_ops.py traces them from the plain chain; without
    B_phi the chain needs fewer."""
    counts = _load("tools_torch/count_ops.py").twisted_ops(b_phi_zero)
    ops = _load("chip_smoke.py").OPS
    assert counts and {key: ops[key] for key in counts} == counts
    if b_phi_zero:
        assert ops["cyl_tw_b0_step"] < ops["cyl_tw_step"]
