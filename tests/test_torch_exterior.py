"""The numeric exteriors (exterior_method="numeric") of the port vs the JAX
package's, and their kernels vs the plain version on the card.

CPU: the plain slab dispersion (flux and shear forms, 7 and 3 wavelengths)
and the plain cylinder dispersion (density, axial flow, one twisted case)
against the JAX package's, at n_interior=256 and 128-512 exterior steps,
f64 det and mismatch to rtol 1e-9 away from poles: points with |det| above
1e6 x the median are masked (as in tests/test_torch_cylinder.py), for the
slab above 1e3 x the median. Its exterior enters a determinant whose two
terms cancel near a pole, where a last-bit difference between the
packages' operations (XLA's are fused, contracted and reordered, the
port's are not) grows to ~1e-9 of det at |det| ~ 2e3 x the median. The
Gaussian-flow shear form is held to 1e-8, as in tests/test_torch_slab.py:
its U' and U'' are closed forms here and jax.grad there. Then the
Bessel/numeric root oracle of tests/test_special.py:101-132 on the port's
plain version (roots to rtol 1e-6).

Card (marker `gpu`): each kernel variant with the numeric exterior
(slab_disp in both forms, slab_bisect, cylinder_disp, cylinder_bisect, the
twisted scan, its small-batch path and the speculative bisection) bit-equal
to its plain version on ragged sizes, at f32 and f64.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from eigensolver_tpu import cases as jcases
from eigensolver_tpu.physics.cylinder import CylinderPhysics as JCyl
from eigensolver_tpu.physics.slab import SlabPhysics as JSlab
from eigensolver_tpu_torch import cases, config, search, sweep
from eigensolver_tpu_torch.kernels import cylinder as kcyl
from eigensolver_tpu_torch.kernels import slab as kslab
from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
from eigensolver_tpu_torch.physics.slab import SlabPhysics

# |det| above POLE x the median: near a pole, masked
POLE = {"slab": 1e3, "cylinder": 1e6}
RTOL64 = 1e-9


def numeric(case, wavelengths=7.0, n_exterior=512, **grid):
    return dataclasses.replace(case, grid=dataclasses.replace(
        case.grid, exterior_method="numeric",
        exterior_wavelengths=wavelengths, n_exterior=n_exterior, **grid))


def candidates(case, n, seed):
    """(omega, k, mode) spread over the case's speed bands and both modes."""
    rng = np.random.default_rng(seed)
    sp = np.asarray(case.sorted_speeds())
    band = rng.integers(0, len(sp) - 1, n)
    v = sp[band] + (sp[band + 1] - sp[band]) * rng.uniform(0.002, 0.998, n)
    k = rng.uniform(case.k_min, case.k_max, n)
    return v * k, k, rng.integers(0, 2, n).astype(np.float64)


def assert_close(got, want, pole, rtol=RTOL64):
    """det and mismatch to rtol away from poles (|det| < pole x the
    median); the masks equal."""
    gd, gm, gv = got
    wd, wm, wv = want
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(wd))
    fin = np.isfinite(wd)
    med = np.median(np.abs(wd[fin]))
    ok = fin & (np.abs(wd) < pole * med)
    assert ok.sum() > 0.75 * fin.sum()
    np.testing.assert_allclose(gd[ok], wd[ok], rtol=rtol)
    okm = ok & np.isfinite(wm)
    np.testing.assert_allclose(gm[okm], wm[okm], rtol=rtol)


SLAB_CASES = {
    "flux_W7": lambda: numeric(jcases.slab_density_photospheric(0.9), 7.0,
                               256, n_interior=256),
    "flux_W3": lambda: numeric(jcases.slab_density_coronal(1.5), 3.0, 128,
                               n_interior=256),
    "shear_W7": lambda: numeric(jcases.slab_flow_gaussian_coronal(), 7.0,
                                512, n_interior=256),
    "shear_W3": lambda: numeric(jcases.slab_flow_uniform_photospheric(), 3.0,
                                128, n_interior=256),
}


@pytest.mark.parametrize("name", sorted(SLAB_CASES))
def test_slab_numeric_dispersion_matches_jax(name):
    case = SLAB_CASES[name]()
    om, k, par = candidates(case, 600, seed=1)
    jfn = jax.jit(jax.vmap(JSlab.from_case(case).make_dispersion(
        parity=None, dtype=jnp.float64)))
    want = [np.asarray(x) for x in jfn(om, k, par)]
    tfn = SlabPhysics.from_case(config.from_jax(case)).make_dispersion(
        parity=None, dtype=torch.float64)
    got = [x.numpy() for x in tfn(*(torch.from_numpy(x)
                                    for x in (om, k, par)))]
    assert_close(got, want, POLE["slab"],
                 1e-8 if name == "shear_W7" else RTOL64)


def _twisted():
    return jcases.cylinder_twisted_magnetic(0.1, 0.15, 1.25, 1)


CYL_CASES = {
    "density": lambda: numeric(jcases.cylinder_density_coronal(0.9), 3.0,
                               256, n_interior=256, n_axis_log=32),
    "axial_flow": lambda: numeric(jcases.cylinder_flow_coronal(0.05, 1.0),
                                  3.0, 512, n_interior=256, n_axis_log=32),
    "twisted": lambda: numeric(_twisted(), 3.0, 128, n_interior=128),
}


@pytest.mark.parametrize("name", sorted(CYL_CASES))
def test_cylinder_numeric_dispersion_matches_jax(name):
    case = CYL_CASES[name]()
    om, k, m = candidates(case, 400, seed=2)
    if name == "twisted":
        m = np.ones_like(m)
    jfn = jax.jit(jax.vmap(JCyl.from_case(case).make_dispersion(
        m=None, dtype=jnp.float64)))
    want = [np.asarray(x) for x in jfn(om, k, m)]
    tfn = CylinderPhysics.from_case(config.from_jax(case)).make_dispersion(
        m=None, dtype=torch.float64)
    got = [x.numpy() for x in tfn(*(torch.from_numpy(x) for x in (om, k, m)))]
    assert_close(got, want, POLE["cylinder"])


def test_numeric_exterior_keeps_the_exact_signs():
    """On a ladder at k = 1 inside the photospheric slab's bands, away from
    m_e -> 0 (where the finite domain matters), the numeric exterior at 7
    wavelengths gives the exact exterior's det signs at every point."""
    exact = jcases.slab_density_photospheric(0.9)
    exact = dataclasses.replace(exact, grid=dataclasses.replace(
        exact.grid, n_interior=256))
    num = numeric(exact, 7.0, 512)
    k = torch.full((400,), 1.0, dtype=torch.float64)
    om = torch.linspace(0.905, 0.985, 400, dtype=torch.float64)
    signs = []
    for c in (exact, num):
        d = SlabPhysics.from_case(config.from_jax(c)).make_dispersion(
            parity=0)(om, k).det
        signs.append(torch.signbit(d))
    assert torch.equal(signs[0], signs[1])


def _ladder_roots(case, m, k, w):
    disp = CylinderPhysics.from_case(case).make_dispersion(m=m)
    om = torch.from_numpy(w * k)[None, :]
    det, valid, _ = search.ladder_scan(disp, om, torch.tensor([k],
                                                              dtype=om.dtype))
    d, v = det[0].numpy(), valid[0].numpy()
    s = np.sign(d)
    i = np.nonzero((s[:-1] * s[1:] < 0) & v[:-1] & v[1:])[0]
    return w[i] - d[i] * (w[i + 1] - w[i]) / (d[i + 1] - d[i])


def test_bessel_exterior_equals_numeric_exterior():
    """tests/test_special.py:101-132 on the port's plain version: the
    cylinder roots under the K_m-ratio and the numeric exterior agree to
    rtol 1e-6 (the numeric one carries its own RK4 error, ~1e-8)."""
    case_b = cases.cylinder_density_coronal(width=1e5)
    case_b = dataclasses.replace(
        case_b, grid=dataclasses.replace(case_b.grid, n_interior=256))
    case_n = dataclasses.replace(
        case_b, grid=dataclasses.replace(case_b.grid,
                                         exterior_method="numeric"))
    w = np.linspace(2.0, 4.0, 801)
    rb = _ladder_roots(case_b, 1, 1.0, w)
    rn = _ladder_roots(case_n, 1, 1.0, w)
    assert len(rb) == len(rn) > 0
    np.testing.assert_allclose(rb, rn, rtol=1e-6)


def test_kernel_params_carry_the_exterior():
    """The kernels' parameter structs name the exterior: numeric, W and the
    step count, formed on the host from the case."""
    slab = numeric(cases.slab_density_photospheric(0.9), 7.0, 384)
    s = kslab.disp_params(slab).struct
    assert (s.exterior_numeric, s.exterior_wavelengths, s.n_exterior) == \
        (1, 7.0, 384)
    c = kcyl.disp_params(cases.cylinder_flow_coronal(0.05, 1.0)).struct
    assert (c.exterior_numeric, c.exterior_wavelengths, c.n_exterior) == \
        (0, 3.0, 512)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_exterior_exp_table_model_bit_equal_to_plain(dtype):
    """The factoring of the numeric cylinder scan's exterior keeps the bits:
    with exp(2 t) formed once per distinct k at each abscissa of its grid
    (csrc/cylinder_disp.cu::cyl_exterior_scan's table) and each
    candidate's RK4 step from its k's values (ode._step), dP/dr / P equals
    the plain exterior's bit for bit on a ladder batch, at both modes."""
    from eigensolver_tpu_torch import ode
    from eigensolver_tpu_torch.profiles import rdiv
    case = dataclasses.replace(
        numeric(cases.cylinder_flow_coronal(0.05, 1.0), 3.0, 96,
                n_interior=64), k_values=(0.05, 0.9, 3.7))
    ph = CylinderPhysics.from_case(case)
    om, ks = sweep.build_ladders(case, 37)
    om = torch.from_numpy(np.concatenate([om, om]).reshape(-1)).to(dtype)
    k = torch.from_numpy(np.repeat(np.concatenate([ks, ks]), 37)).to(dtype)
    m = torch.from_numpy(np.repeat([0.0, 1.0], len(ks) * 37)).to(dtype)
    m_e = ph.exterior_m(om, k)
    want = ph.numeric_exterior(m_e, k, m)
    # the table: per distinct k, its grid and exp(2 t) at each abscissa
    uk, k_of = np.unique(k.numpy(), return_inverse=True)
    k_of = torch.from_numpy(k_of.reshape(-1))
    uk = torch.from_numpy(uk)
    gr = case.grid
    r_far = rdiv(gr.exterior_wavelengths * 2.0 * np.pi, uk)
    t0 = torch.log(r_far)
    h, hh, h6 = ode._spacing(t0, torch.zeros_like(t0), gr.n_exterior)
    y = (torch.full_like(k, 1e-8), -1e-8 * r_far[k_of])
    for i in range(gr.n_exterior):
        x = t0 + i * h
        ex = [torch.exp(2.0 * x), torch.exp(2.0 * (x + hh))]
        ex = iter([ex[0], ex[1], ex[1], torch.exp(2.0 * (x + h))])
        y = ode._step(
            lambda t, y: (y[1], (m * m + m_e * next(ex)[k_of]) * y[0]), y,
            x[k_of], h[k_of], hh[k_of], h6[k_of])
    got = y[1] / y[0]
    assert len(uk) == 3 < k.numel()
    assert bool(want.isfinite().all())
    assert torch.equal(got, want)


def test_exterior_op_counts_match_chip_smoke():
    """chip_smoke.py's bounds count the exteriors' operations as
    tools_torch/count_ops.py traces them from the plain RK4 step, and the
    density/axial-flow chain's split into what depends on omega and what
    on its (k, m, r) row alone as it traces the plain chain, and the slab
    chain's split from its update as it traces the plain flux and shear
    chains and `_rk4_linear`."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent

    def load(path):
        spec = importlib.util.spec_from_file_location(Path(path).stem,
                                                      root / path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    count_ops = load("tools_torch/count_ops.py")
    counts = {**count_ops.slab_ops(), **count_ops.cylinder_ops(),
              **count_ops.exterior_ops()}
    smoke = load("chip_smoke.py")
    ops = smoke.OPS
    assert counts and {key: ops[key] for key in counts} == counts
    # the slab chain split from its update: the flux form's 3 chains a step
    # (1 division each) and its update are the 61 operations a step that
    # the bound counted before; the shear chain (5 divisions) 24 an
    # abscissa; a shoot at a power of two needs 2 n + 1 chains, else 3 n
    assert 3 * ops["slab_chain"] + ops["slab_update"] == 61
    assert (ops["slab_chain"], ops["slab_shear_chain"]) == (9, 24)
    assert smoke.slab_chains(2048) == 4097
    assert smoke.slab_chains(250) == smoke.slab_chains(2048, True) // 2048 * 250
    paired = smoke.slab_ops(2, 1, 2048, n_chains=1)
    assert smoke.slab_ops(2, 1, 2048) - paired == 4097 * ops["slab_chain"]
    # the cylinder's step takes 3 exps (k2 and k3 share x + h/2), of its
    # abscissae 2 t, which depend on k alone: with the abscissae and their
    # forming x0 + i h, 10 a step once per distinct k; per candidate its
    # products by m_e besides the slab's step
    assert sum(key[0] == "exp" for key in count_ops.Sym.nodes) == 3
    assert ops["cyl_ext_k_step"] == 3 + 3 + 2 + 2
    assert ops["cyl_ext_step"] > ops["slab_ext_step"]
    # the chain's row class: k U, alpha = k B_z / sqrt(rho) and its
    # square, the cusp speed (2) and its square, m^2 / r^2 + k^2 and its
    # product by c^2 + vA^2: 9 of an evaluation, 3 a step; what stays per
    # candidate is the rest of the hand count (155 a step)
    assert ops["cyl_row_step"] == ops["cyl_log_row_step"] == 3 * 9
    assert ops["cyl_step"] + ops["cyl_row_step"] == 155
    assert ops["cyl_log_step"] - ops["cyl_step"] == 6


@pytest.mark.parametrize("module", [kslab, kcyl], ids=["slab", "cylinder"])
def test_every_entry_has_its_signature(module):
    """Every C entry a wrapper calls has its ctypes signature, with the
    batch count (the 7th argument) a 64-bit integer: passed without one it
    arrives truncated. The fused bisections, with either exterior, take
    the speculative kernel's arguments; no entry of the per-bracket-chain
    kernel they replaced is left."""
    import ctypes
    from eigensolver_tpu_torch.kernels import _build
    tables = {k: v for k, v in vars(module).items()
              if k.startswith("_") and k.endswith("ENTRY")}
    assert len(tables) >= 2
    for table in tables.values():
        assert set(table) == {torch.float32, torch.float64}
        for name in table.values():
            argtypes, restype = _build._SIGNATURES[name]
            assert argtypes[6] is ctypes.c_longlong and restype is ctypes.c_int
    spec = ([kslab._SPEC_ENTRY] if module is kslab
            else [kcyl._SPEC_ENTRY, kcyl._BISECT_SPEC_ENTRY])
    assert all(_build._SIGNATURES[name] == _build._SPEC_ARGS
               for table in spec for name in table.values())
    assert not [name for name in _build._SIGNATURES
                if name.startswith(("eigk_slab_bisect_f",
                                    "eigk_cylinder_bisect_f"))]
    if module is kslab:
        # one complex-omega kernel behind both complex wrappers; the
        # one-thread scan it replaced has no entry left
        assert all(_build._SIGNATURES[name] == _build._NEWTON_ARGS
                   for name in kslab._NEWTON_ENTRY.values())
        assert len(_build._NEWTON_ARGS[0]) == 20
        assert not [name for name in _build._SIGNATURES
                    if name.startswith("eigk_slab_complex_f")]
    else:
        # the cylinder's complex-omega kernel (csrc/cylinder_complex.cu):
        # its Newton entry and the K_m ratio at complex z alone, whose
        # count comes 6th
        from eigensolver_tpu_torch.kernels import bessel
        assert all(_build._SIGNATURES[name] == _build._CYL_NEWTON_ARGS
                   for name in kcyl._NEWTON_ENTRY.values())
        assert len(_build._CYL_NEWTON_ARGS[0]) == 17
        for name in bessel._COMPLEX_ENTRY.values():
            argtypes, restype = _build._SIGNATURES[name]
            assert argtypes[5] is ctypes.c_longlong and restype is ctypes.c_int
            assert len(argtypes) == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_numeric_spec_shape(dtype):
    """The numeric exterior's speculative bisection keeps spec_shape's
    speculation on small batches and takes the tuned loop schedule (32
    brackets, 7 producer warps, 32 or 16 steps a stage) on the parity
    sweeps' batches; every shape fits the card."""
    from eigensolver_tpu_torch.kernels import common
    steps = 32 if dtype == torch.float32 else 16
    for eb in {kslab._ENTRY_BYTES[(shear, dtype)] for shear in (False, True)
               } | {kcyl._ENTRY_BYTES[dtype, False]}:
        for n in (45, 600, 2111):
            got = common.numeric_spec_shape(n, dtype, eb)
            assert got == common.spec_shape(n, dtype, eb) and got.levels >= 2
            common._check_spec_shape("x", got, dtype, eb, False)
        for n in (17_920, 21_840, 47_520):
            got = common.numeric_spec_shape(n, dtype, eb)
            assert tuple(got) == (32, 0, 7, steps, 2, 0)
            common._check_spec_shape("x", got, dtype, eb, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", ["slab_flux", "slab_shear", "cylinder"])
def test_numeric_scan_shapes_are_the_wrappers(form, dtype):
    """The numeric exterior's scan is built only at the launch shapes the
    wrappers pick (slab: scan_shape's 128 and, in the flux form, 256
    threads; cylinder: SCAN_SHAPE); other block sizes are refused, and
    the exact exterior keeps all of its."""
    if form == "cylinder":
        kcyl._check_scan_shape(kcyl.SCAN_SHAPE, dtype, numeric=True)
        for threads in (128, 512):
            bad = kcyl.ScanShape(threads, 64)
            kcyl._check_scan_shape(bad, dtype)
            with pytest.raises(ValueError, match="launch shape"):
                kcyl._check_scan_shape(bad, dtype, numeric=True)
        return
    shear = form == "slab_shear"
    for n in (1, 1530, 161_280, 349_440):
        kslab._check_scan_shape(kslab.scan_shape(n, shear), dtype, shear,
                                numeric=True)
    for threads in (32, 64, 512) + ((256,) if shear else ()):
        bad = kslab.ScanShape(threads, 64)
        kslab._check_scan_shape(bad, dtype, shear)
        with pytest.raises(ValueError, match="launch shape"):
            kslab._check_scan_shape(bad, dtype, shear, numeric=True)


# -- card: the kernels' numeric exteriors bit-equal to the plain version ----

def _same(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _card_candidates(case, n, seed, dtype, mode=None):
    om, k, m = candidates(case, n, seed)
    if mode is not None:
        m = np.full_like(m, float(mode))
    return [torch.from_numpy(x).to(device="cuda", dtype=dtype)
            for x in (om, k, m)]


CARD_CASES = {
    "slab_flux": lambda: numeric(cases.slab_density_photospheric(0.9), 7.0,
                                 200, n_interior=250),
    "slab_shear": lambda: numeric(cases.slab_flow_gaussian_coronal(), 3.0,
                                  130, n_interior=250),
    "cyl_flow": lambda: numeric(cases.cylinder_flow_coronal(0.05, 1.0), 3.0,
                                200, n_interior=250, n_axis_log=30),
    "twisted": lambda: numeric(cases.cylinder_twisted_photospheric(
        0.1, 1.0, 1), 3.0, 130, n_interior=250),
}


def _physics(case):
    """(kernel, plain): the moded dispersion of each, by dtype."""
    if case.geometry.value == "slab":
        ph = SlabPhysics.from_case(case)
        return (lambda dt: ph.make_dispersion(parity=None, dtype=dt),
                lambda dt: ph.make_dispersion_plain(parity=None, dtype=dt))
    ph = CylinderPhysics.from_case(case)
    return (lambda dt: ph.make_dispersion(m=None, dtype=dt),
            lambda dt: ph.make_dispersion_plain(m=None, dtype=dt))


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_numeric_scan_bit_equal_to_plain_on_card(name, dtype):
    """The scan (and, for the twisted chain, its small-batch path) with the
    numeric exterior gives the plain version's bits on 1,001 and 37
    candidates, one launch each."""
    case = CARD_CASES[name]()
    kern, plain = _physics(case)
    mode = 1 if name == "twisted" else None
    for n in (1001, 37):
        args = _card_candidates(case, n, 3, dtype, mode)
        want = plain(dtype)(*args)
        module = kslab if name.startswith("slab") else kcyl
        before = module.launches
        got = kern(dtype)(*args)
        torch.cuda.synchronize()
        assert module.launches == before + 1
        assert torch.equal(got.valid, want.valid)
        assert _same(got.det, want.det) and _same(got.mismatch_pct,
                                                  want.mismatch_pct), n
        assert bool(want.det.isfinite().any())
    if name == "twisted":      # the scan too (the batches above are small)
        args = _card_candidates(case, 1001, 4, dtype, mode)
        got = kcyl.cylinder_disp(*args, kcyl.disp_params(case),
                                 shape=kcyl.TW_SCAN_SHAPE[dtype])
        want = plain(dtype)(*args)
        assert _same(got.det, want.det) and _same(got.mismatch_pct,
                                                  want.mismatch_pct)


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_numeric_bisect_bit_equal_to_plain_on_card(name, dtype):
    """The fused bisection with the numeric exterior (the speculative
    kernel of slab_bisect, cylinder_bisect and the twisted chain, at its
    default L and at L = 0) gives the (root, mismatch) of
    search.bisect_loop over the plain dispersion, on 45 brackets (3
    iterations and the residual)."""
    from eigensolver_tpu_torch.kernels import common
    case = CARD_CASES[name]()
    kern, plain = _physics(case)
    mode = 1 if name == "twisted" else None
    om, k, m = _card_candidates(case, 45, 5, dtype, mode)
    lo, hi = om, om * 1.01
    want = search.bisect_loop(plain(dtype), lo, hi, k, m, 3)
    disp = kern(dtype)
    if name.startswith("slab"):
        fn, params = kslab.slab_bisect, kslab.disp_params(case)
        eb = kslab._ENTRY_BYTES[(bool(params.struct.shear), dtype)]
    else:
        fn, params = kcyl.cylinder_bisect, kcyl.disp_params(case)
        eb = kcyl._ENTRY_BYTES[dtype, name == "twisted"]
    for shape in (None, common.spec_shape(45, dtype, eb, levels=0)):
        if shape is None:
            got = disp.bisect(lo, hi, k, m, 3)
        else:
            got = fn(lo, hi, k, m, 3, params, shape=shape)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert _same(a, b), shape


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_numeric_sweep_on_card_matches_cpu():
    """A reduced slab sweep with the numeric exterior, the continuum mask
    and fuzz acceptance: on the card (2 launches) as on the CPU."""
    case = dataclasses.replace(
        CARD_CASES["slab_flux"](), k_values=(0.5, 1.5, 2.5))
    from eigensolver_tpu_torch.equilibrium import genuine_continua
    cfg = search.SearchConfig(
        n_omega=64, n_bisect=30, max_brackets_per_row=24,
        exclude_v_ranges=tuple((lo, hi) for lo, hi, _ in
                               genuine_continua(case)) or None,
        fuzz_accept_pct=3.0)
    before = (kslab.launches, kslab.bisect_launches)
    rs_gpu, _ = sweep.run_case(case, cfg, device="cuda")
    assert (kslab.launches, kslab.bisect_launches) == (before[0] + 1,
                                                        before[1] + 1)
    rs_cpu, _ = sweep.run_case(case, cfg, device="cpu")
    assert rs_gpu.counts() == rs_cpu.counts()
    for b in rs_cpu.branches:
        np.testing.assert_allclose(rs_gpu[b].omegas, rs_cpu[b].omegas,
                                   rtol=1e-12)
