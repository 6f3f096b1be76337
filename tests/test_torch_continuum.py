"""The port's continuum masks, fuzz acceptance and pole pre-filter vs the
JAX package's.

- `equilibrium.continuum_bands` and `genuine_continua`: equal to JAX's,
  labels and floats, on the slab photospheric, slab Gaussian flow,
  cylinder axial flow and twisted cases: bit-equal where the profiles take
  no exp; the Gaussian flows' U(x) takes XLA's exp in the one and the C
  library's in the other, which differ in the last bit, so there to 1e-15
  absolute (the phase speeds are O(1); a difference U - cT of them can
  show the ulp of U as several of its own).
- `search_rows` with `exclude_v_ranges`, with fuzz acceptance (strides 1
  and 9, `fuzz_v_ranges`) and with the pole pre-filter, on the synthetic
  dispersions of tests/test_fuzz_stride.py and
  tests/test_continuum_exclusion.py: every field of the result equal to
  JAX's (the same arithmetic on the same inputs).
- `search.nanmedian` against `jnp.nanmedian` on rows of even and odd
  finite counts, where `torch.nanmedian` (the lower middle value) differs.
- The weak-type hazard: in an f32 sweep the JAX package rounds a bound to
  f32 before it compares; the port does the same.
"""
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from eigensolver_tpu import cases as jcases
from eigensolver_tpu import equilibrium as jeq
from eigensolver_tpu import search as jsearch
from eigensolver_tpu_torch import config, equilibrium, search

# case, and whether its profiles take an exp (then equal to 1e-15)
CASES = {
    "slab_photospheric": (lambda: jcases.slab_density_photospheric(0.9),
                          False),
    "slab_gaussian_flow": (jcases.slab_flow_gaussian_coronal, True),
    "cylinder_flow": (lambda: jcases.cylinder_flow_coronal(0.05, 1.0), True),
    "twisted": (lambda: jcases.cylinder_twisted_photospheric(0.1, 1.0, 1),
                False),
}


@pytest.mark.parametrize("fn", ["continuum_bands", "genuine_continua"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_continua_equal_jax(name, fn):
    make, uses_exp = CASES[name]
    want = getattr(jeq, fn)(make())
    got = getattr(equilibrium, fn)(config.from_jax(make()))
    assert [lab for *_, lab in got] == [lab for *_, lab in want]
    assert all(type(x) is float for lo, hi, _ in got for x in (lo, hi))
    g = np.array([(lo, hi) for lo, hi, _ in got], float).reshape(-1)
    w = np.array([(lo, hi) for lo, hi, _ in want], float).reshape(-1)
    if uses_exp:
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-15)
    else:
        np.testing.assert_array_equal(g, w)
    if name == "twisted" and fn == "genuine_continua":
        assert got == []


def _port_disp(fn):
    """A synthetic dispersion for the port's search, with the `.bisect`
    entry the search calls (the plain loop)."""
    def disp(omega, k):
        return fn(omega, k)

    disp.bisect = (lambda lo, hi, k, md, n_iter, final_eval=True:
                   search.bisect_loop(disp, lo, hi, k, md, n_iter, final_eval))
    return disp


def _assert_same(got, want):
    for field in ("omega", "k", "mismatch", "mask", "fuzz"):
        g, w = getattr(got, field), getattr(want, field)
        if w is None or g is None:
            assert g is None and field == "fuzz", field
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)


def _swath(omega, k, xp):
    det = omega - 2.0
    return SimpleNamespace(det=det, valid=xp.ones_like(omega) > 0,
                           mismatch_pct=100.0 * xp.abs(det))


@pytest.mark.parametrize("v_ranges", [None, ((1.5, 1.99),),
                                      ((1.0, 1.98), (2.02, 2.5))])
@pytest.mark.parametrize("stride", [1, 9])
def test_fuzz_acceptance_equals_jax(stride, v_ranges):
    """tests/test_fuzz_stride.py's swath (det = omega - 2, residual 100
    |det|) on a 91-point ladder: the polished roots and every strided fuzz
    record (omega, k, residual, acceptance) equal JAX's."""
    n_omega = 91
    kw = dict(n_omega=n_omega, n_bisect=50, max_brackets_per_row=4,
              accept_pct=1.0, fuzz_accept_pct=3.0, fuzz_stride=stride,
              fuzz_v_ranges=v_ranges)
    om = np.linspace(1.0, 3.0, n_omega)[None, :].repeat(2, axis=0)
    ks = np.array([1.0, 1.0])
    want = jsearch.search_rows(lambda o, k: _swath(o, k, jnp),
                               lambda o, k: _swath(o, k, jnp),
                               jnp.asarray(om), jnp.asarray(ks),
                               jsearch.SearchConfig(**kw))
    disp = _port_disp(lambda o, k: _swath(o, k, torch))
    got = search.search_rows(disp, disp, torch.from_numpy(om),
                             torch.from_numpy(ks), search.SearchConfig(**kw))
    n_fuzz = -(-n_omega // stride)
    assert got.omega.numel() == 2 * 4 + 2 * n_fuzz
    assert int(got.fuzz.sum()) == 2 * n_fuzz
    if v_ranges is None:
        assert int((got.mask & got.fuzz).sum()) > 0
    _assert_same(got, want)


def _sine(omega, k, xp):
    det = xp.sin(20.0 * np.pi * omega / k)
    return SimpleNamespace(det=det, valid=xp.ones_like(det) > 0,
                           mismatch_pct=xp.zeros_like(det))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_exclude_v_ranges_equals_jax(dtype):
    """tests/test_continuum_exclusion.py's sine: excluding v in (0.4, 0.6)
    removes the brackets there, as in JAX, root for root; a third field in
    a range (a label, as genuine_continua gives) is ignored."""
    om = np.linspace(0.30, 0.70, 801)[None, :]
    ks = np.ones(1)
    kw = dict(n_omega=801, max_brackets_per_row=16, n_bisect=30,
              scan_dtype=dtype, polish_dtype=dtype, accept_pct=50.0)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    disp = _port_disp(lambda o, k: _sine(o, k, torch))
    results = []
    for ranges in (None, ((0.4, 0.6, "band"),)):
        cfg = dict(kw, exclude_v_ranges=ranges)
        want = jsearch.search_rows(lambda o, k: _sine(o, k, jnp),
                                   lambda o, k: _sine(o, k, jnp),
                                   jnp.asarray(om, jd), jnp.asarray(ks, jd),
                                   jsearch.SearchConfig(**cfg))
        got = search.search_rows(disp, disp, torch.from_numpy(om).to(td),
                                 torch.from_numpy(ks).to(td),
                                 search.SearchConfig(**cfg))
        for field in ("omega", "k", "mask"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)))
        results.append(got.omega[got.mask].numpy())
    full, masked = results
    assert 0 < len(masked) < len(full)
    assert np.all((masked <= 0.4 + 1e-6) | (masked >= 0.6 - 1e-6))


def _ladder_arrays(seed, rows=24, n_omega=40):
    """det/valid with NaN, inf, invalid points and rows of every finite
    count parity, so the median takes both forms."""
    rng = np.random.default_rng(seed)
    omegas = np.sort(rng.uniform(0.1, 5.0, (rows, n_omega)), axis=1)
    ks = rng.uniform(0.01, 4.5, rows)
    det = rng.normal(size=(rows, n_omega)) * 10.0 ** rng.uniform(
        -3, 3, (rows, n_omega))
    det[rng.random((rows, n_omega)) < 0.05] = np.nan
    det[rng.random((rows, n_omega)) < 0.03] = np.inf
    valid = rng.random((rows, n_omega)) > 0.05
    valid[0, 1] = False                 # an odd and an even row, for sure
    valid[1, 1:3] = False
    det[:2] = np.where(np.isfinite(det[:2]), det[:2], 1.0)
    return omegas, ks, det, valid


@pytest.mark.parametrize("factor", [0.5, 3.0, 1e3])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pole_prefilter_equals_jax(seed, dtype, factor):
    omegas, ks, det, valid = _ladder_arrays(seed)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jsearch.find_brackets(jnp.asarray(omegas, jd), jnp.asarray(ks, jd),
                                 jnp.asarray(det, jd), jnp.asarray(valid), 8,
                                 pole_det_factor=factor)
    t = torch.from_numpy
    got = search.find_brackets(t(omegas).to(td), t(ks).to(td),
                               t(det).to(td), t(valid), 8,
                               pole_det_factor=factor)
    for name in ("lo", "hi", "k", "mask", "n_in_row"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    unfiltered = search.find_brackets(t(omegas).to(td), t(ks).to(td),
                                      t(det).to(td), t(valid), 8)
    if factor < 1e3:
        assert int(got.n_in_row.sum()) < int(unfiltered.n_in_row.sum())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_nanmedian_averages_the_middle_pair(dtype):
    """An even finite count: the mean of the two middle values, as
    jnp.nanmedian gives it; torch.nanmedian takes the lower one."""
    x = np.array([[3.0, np.nan, 1.0, 10.0, 2.0],        # 4 finite: 2.5
                  [7.0, 1.0, np.nan, 4.0, np.nan],      # 3 finite: 4
                  [np.nan] * 5,                         # none: NaN
                  [0.1, 0.2, np.nan, np.nan, np.nan]])  # 2 finite
    td = getattr(torch, dtype)
    want = np.asarray(jnp.nanmedian(jnp.asarray(x, getattr(jnp, dtype)),
                                    axis=1, keepdims=True))
    got = search.nanmedian(torch.from_numpy(x).to(td))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == td and float(got[0, 0]) == 2.5
    lower = torch.nanmedian(torch.from_numpy(x).to(td), dim=1).values
    assert float(lower[0]) == 2.0 != float(got[0, 0])


def test_f32_bound_rounds_as_jax():
    """fuzz_v_ranges' upper bound 0.1 meets the f32 ladder point
    float32(0.1) = 0.100000001...: JAX compares in f32 (weak-typed bound,
    so float32(0.1) <= float32(0.1) and the point is kept); a float64
    comparison would drop it. The port keeps it too, and so do its masks
    (v > float32(0.1) is false there)."""
    om = np.linspace(0.08, 0.12, 41)[None, :]
    ks = np.ones(1)
    om32 = om.astype(np.float32)
    at = int(np.nonzero(om32[0] == np.float32(0.1))[0][0])
    assert float(om32[0, at]) > 0.1
    kw = dict(n_omega=41, n_bisect=18, max_brackets_per_row=4,
              scan_dtype="float32", polish_dtype="float32", accept_pct=1.0,
              fuzz_accept_pct=30.0, fuzz_v_ranges=((0.05, 0.1),))

    def swath(o, k, xp):            # residual 0 at float32(0.1)
        det = o - 0.1
        return SimpleNamespace(det=det, valid=xp.ones_like(o) > 0,
                               mismatch_pct=100.0 * xp.abs(det))

    want = jsearch.search_rows(lambda o, k: swath(o, k, jnp),
                               lambda o, k: swath(o, k, jnp),
                               jnp.asarray(om32), jnp.asarray(ks, jnp.float32),
                               jsearch.SearchConfig(**kw))
    disp = _port_disp(lambda o, k: swath(o, k, torch))
    got = search.search_rows(disp, disp, torch.from_numpy(om32),
                             torch.from_numpy(ks).float(),
                             search.SearchConfig(**kw))
    _assert_same(got, want)
    # the residual's minimum, kept, where a float64 bound would drop it
    assert got.mask[got.fuzz].numpy()[at]
    assert not bool(torch.from_numpy(om32[0]).double()[at] <= 0.1)
    det = torch.ones(1, 41)
    masked = search.mask_v_ranges(torch.from_numpy(om32), torch.ones(1),
                                  det, ((0.1, 0.11),))
    assert not bool(masked[0, at].isnan())
    assert bool(masked[0, at + 1].isnan())
