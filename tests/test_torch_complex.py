"""The complex-omega Kelvin-Helmholtz path of the port against the JAX
package, on the CPU in float64, at a reduced depth (n_interior=128):

- `cplx` against numpy's complex arithmetic (Smith division bit-equal to
  numpy's scalar division) and XLA's sqrt;
- the plain complex dispersion (`make_dispersion_plain` at complex omega)
  against the JAX disp, widths 1e5 and 1.0, both parities, the legacy D:
  det to rtol 1e-11 (points within 1e-6 of a pole, |det| > 1e6 x the
  median, masked), mismatch to 1e-9, valid equal;
- the dual shoot's d det / d omega against jax.jvp (rtol 1e-9: XLA's
  complex division rounds otherwise, and the shoot amplifies it near
  poles) and against torch.func.jvp of the plain determinant (rtol 1e-10);
- `dedup_complex_roots`, `count_roots_rectangle` per cell, and
  `run_case_complex` on the reduced uniform (width 1e5) and layer (width
  1.0) cases: equal counts and completeness, roots within 1e-9 relative;
  the flow-reversal mirror (tests/test_complex_kh.py:103) and the analytic
  growth rate (:42) for the port;
- the refusals (the complex cylinder: ROADMAP A10b) and run_case on a
  complex case.

`python tests/test_torch_complex.py jax-counts NAME` takes the JAX
package's full-size counts that `chip_smoke.py` holds (tools_torch/kh.py).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools_torch import kh  # noqa: E402

N_INTERIOR = 128
_RUNS: dict = {}


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def _cases(width, n_k=1, k_min=0.5, k_max=0.5, n_interior=N_INTERIOR,
           **fields):
    """(JAX case, port case) of slab_flow_complex_coronal(width) reduced."""
    from eigensolver_tpu import cases as jcases
    from eigensolver_tpu_torch import config
    c = jcases.slab_flow_complex_coronal(width=width)
    c = dataclasses.replace(
        c, n_k=n_k, k_min=k_min, k_max=k_max,
        grid=dataclasses.replace(c.grid, n_interior=n_interior), **fields)
    return c, config.from_jax(c)


def _draws(n, seed):
    rng = np.random.default_rng(seed)
    k = rng.uniform(0.05, 2.5, n)
    om = (rng.uniform(-0.5, 1.2, n) + 1j * rng.uniform(-0.3, 0.8, n)) * k
    return om, k


def _pair(om):
    from eigensolver_tpu_torch.cplx import C
    return C(torch.from_numpy(om.real.copy()), torch.from_numpy(om.imag.copy()))


def _np(z):
    out = np.empty(z.re.shape, np.complex128)
    out.real, out.imag = z.re.numpy(), z.im.numpy()
    return out


# -- cplx --------------------------------------------------------------------

def test_cplx_division_bit_equal_numpy_scalar():
    from eigensolver_tpu_torch.cplx import C
    rng = np.random.default_rng(0)
    n = 3000
    a = rng.normal(size=n) * 10.0 ** rng.integers(-5, 5, n) \
        + 1j * rng.normal(size=n) * 10.0 ** rng.integers(-5, 5, n)
    b = rng.normal(size=n) * 10.0 ** rng.integers(-5, 5, n) \
        + 1j * rng.normal(size=n) * 10.0 ** rng.integers(-5, 5, n)
    b[:50] = b[:50].real             # both branches' edge: d = 0 and c = 0
    b[50:100] = 1j * b[50:100].imag
    b[100:110] = 0.0                 # a zero divisor: (a/0, b/0)
    with np.errstate(all="ignore"):
        want = np.array([x / y for x, y in zip(a, b)])
    got = _np(_pair(a) / _pair(b))
    assert np.array_equal(got, want, equal_nan=True)
    # a real numerator: r / z equals numpy's r / z where r z != 0
    r = rng.normal(size=n)
    want_r = np.array([complex(x) / y for x, y in zip(r[110:], b[110:])])
    got_r = _np(torch.from_numpy(r[110:]) / _pair(b[110:]))
    np.testing.assert_array_equal(got_r, want_r)
    prod = _np(_pair(a) * _pair(b))
    np.testing.assert_array_equal(prod.real, a.real * b.real - a.imag * b.imag)
    np.testing.assert_array_equal(prod.imag, a.real * b.imag + a.imag * b.real)
    assert isinstance(C(1, 2) + C(3, 4), C)


def test_cplx_sqrt_abs_angle():
    """The principal root against XLA's complex sqrt (within 2 ulp of the
    root's modulus; exactly on the real axis, either sign of zero, where it
    and numpy differ), |z| against hypot (2 ulp), angle against numpy's."""
    jax = _jax()
    import jax.numpy as jnp
    from eigensolver_tpu_torch.cplx import angle, cabs, csqrt
    rng = np.random.default_rng(1)
    n = 4000
    z = rng.normal(size=n) * 10.0 ** rng.integers(-6, 6, n) \
        + 1j * rng.normal(size=n) * 10.0 ** rng.integers(-6, 6, n)
    axis = np.array([complex(-4, -0.0), complex(-4, 0.0), complex(4, -0.0),
                     complex(0.0, -0.0), complex(-0.0, 0.0),
                     complex(-2.5e-3, -0.0), complex(9.0, 0.0)])
    z = np.concatenate([z, axis])
    s = _np(csqrt(_pair(z)))
    want = np.asarray(jax.jit(jnp.sqrt)(jnp.asarray(z)))
    assert (s.real >= 0).all()
    eps = np.finfo(np.float64).eps
    assert np.all(np.abs(s - want) <= 2 * eps * np.abs(want))
    ax = slice(n, None)
    np.testing.assert_array_equal(s[ax].real, want[ax].real)
    np.testing.assert_array_equal(s[ax].imag, want[ax].imag)
    m = cabs(_pair(z)).numpy()
    h = np.hypot(z.real, z.imag)
    assert np.all(np.abs(m - h) <= 2 * eps * h)
    specials = np.array([0.0, complex(np.inf, 1.0), complex(3.0, np.nan)])
    ms = cabs(_pair(specials)).numpy()
    assert ms[0] == 0.0 and ms[1] == np.inf and np.isnan(ms[2])
    np.testing.assert_allclose(angle(_pair(z)).numpy(), np.angle(z),
                               rtol=4 * eps, atol=0)


# -- the dispersion and its dual ----------------------------------------------

_JDISP: dict = {}


def _jdisp(jcase, parity):
    """jit(vmap(disp)) of the JAX package, one compile per (case, parity)."""
    jax = _jax()
    from eigensolver_tpu.physics.slab import SlabPhysics as JPhysics
    key = (jcase, parity)
    if key not in _JDISP:
        disp = JPhysics.from_case(jcase).make_dispersion(parity=parity)
        _JDISP[key] = (jax.jit(jax.vmap(disp)), jax.jit(jax.vmap(
            lambda o, k: jax.jvp(lambda oo: disp(oo, k).det, (o,),
                                 (jax.numpy.ones_like(o),)))))
    return _JDISP[key]


DISP_CASES = {
    "uniform": dict(width=1e5),
    "layer": dict(width=1.0),
    "layer_legacy_D": dict(width=1.0, shear_D_legacy=True),
}


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("name", sorted(DISP_CASES))
def test_complex_dispersion_and_dual_equal_jax(name, parity):
    import jax.numpy as jnp
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    kw = dict(DISP_CASES[name])
    jcase, case = _cases(kw.pop("width"), **kw)
    om, k = _draws(64, 7 + parity)
    jdisp, jjvp = _jdisp(jcase, parity)
    want = jdisp(jnp.asarray(om), jnp.asarray(k))
    ph = SlabPhysics.from_case(case)
    got = ph.make_dispersion_plain(parity=parity)(_pair(om),
                                                  torch.from_numpy(k))
    det, jdet = _np(got.det), np.asarray(want.det)
    keep = np.abs(jdet) < 1e6 * np.median(np.abs(jdet))
    assert keep.mean() > 0.9
    np.testing.assert_allclose(det[keep], jdet[keep], rtol=1e-11)
    np.testing.assert_allclose(got.mismatch_pct.numpy()[keep],
                               np.asarray(want.mismatch_pct)[keep],
                               rtol=1e-9)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    # the dual shoot: its value is the plain determinant, bit for bit; its
    # derivative jax.jvp's
    d, dd = ph.make_dispersion_dual_plain(parity=parity)(
        _pair(om), torch.from_numpy(k))
    np.testing.assert_array_equal(_np(d), det)
    jd, jdd = jjvp(jnp.asarray(om), jnp.asarray(k))
    np.testing.assert_allclose(_np(dd)[keep], np.asarray(jdd)[keep],
                               rtol=1e-9)


def test_dual_derivative_equals_torch_func_jvp(monkeypatch):
    """torch.func.jvp of the plain complex determinant (omega a complex
    tensor, tangent 1) is f'(omega) for the holomorphic determinant; the
    dual shoot gives it to rtol 1e-10. The plain roots go through numpy on
    a CPU tensor (profiles.sqrt), which forward AD cannot see, so torch's
    own sqrt stands in for this test."""
    from eigensolver_tpu_torch import cplx
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    monkeypatch.setattr(cplx, "rsqrt", torch.sqrt)
    _, case = _cases(1.0)
    om, k = _draws(48, 11)
    kk = torch.from_numpy(k)
    ph = SlabPhysics.from_case(case)
    disp = ph.make_dispersion_plain(parity=1)

    def f(z):
        return disp(C.of(z), kk).det.complex()

    z = torch.from_numpy(om)
    _, tangent = torch.func.jvp(f, (z,), (torch.ones_like(z),))
    d, dd = ph.make_dispersion_dual_plain(parity=1)(_pair(om), kk)
    np.testing.assert_allclose(_np(dd), tangent.numpy(), rtol=1e-10)


def test_newton_entry_equals_loop_on_cpu():
    """On CPU tensors the dispersion's Newton entry is `search.newton_loop`
    over the plain dual shoot (no kernel launch), and newton_complex takes
    complex tensors as well as pairs."""
    from eigensolver_tpu_torch import search, sweep
    from eigensolver_tpu_torch.kernels import slab as kslab
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    _, case = _cases(1.0, n_interior=32)
    om, k = _draws(20, 2)
    kk = torch.from_numpy(k)
    before = (kslab.complex_launches, kslab.newton_launches)
    disp = sweep.make_dispersion(case, 1)
    got = search.newton_complex(disp, torch.from_numpy(om), kk, n_iter=3,
                                damping=0.8)
    dual = SlabPhysics.from_case(case).make_dispersion_dual_plain(parity=1)
    want = search.newton_loop(dual, _pair(om), kk, None, 3, 0.8)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert (kslab.complex_launches, kslab.newton_launches) == before


def test_newton_entry_final_eval_equals_loop_and_jax():
    """The Newton entry with its final evaluation (`newton_complex(...,
    final_eval=True)`, one launch on the card) is, on CPU tensors,
    `search.newton_loop` over the plain dual shoot followed by the plain
    value dispersion at its roots, bit for bit (no kernel launch); at
    this size JAX's newton_complex followed by its disp: the roots to rtol
    1e-9 (the dual's derivative agrees with jax.jvp to 1e-9), the
    evaluation to JAX's disp at the same roots as
    test_complex_dispersion_and_dual_equal_jax holds the dispersion (det
    to 1e-11 away from poles, the mismatch to 1e-9, valid equal)."""
    import jax.numpy as jnp
    from eigensolver_tpu.search import newton_complex as jnewton
    from eigensolver_tpu_torch import search, sweep
    from eigensolver_tpu_torch.kernels import slab as kslab
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    jcase, case = _cases(1.0, n_interior=32)
    om, k = _draws(20, 2)
    kk = torch.from_numpy(k)
    before = (kslab.complex_launches, kslab.newton_launches)
    disp = sweep.make_dispersion(case, 1)
    got, res = search.newton_complex(disp, _pair(om), kk, n_iter=3,
                                     final_eval=True)
    ph = SlabPhysics.from_case(case)
    want = search.newton_loop(ph.make_dispersion_dual_plain(parity=1),
                              _pair(om), kk, None, 3)
    plain = ph.make_dispersion_plain(parity=1)(want, kk)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(res.det), _np(plain.det))
    np.testing.assert_array_equal(res.mismatch_pct.numpy(),
                                  plain.mismatch_pct.numpy())
    np.testing.assert_array_equal(res.valid.numpy(), plain.valid.numpy())
    assert (kslab.complex_launches, kslab.newton_launches) == before
    jdisp, _ = _jdisp(jcase, 1)
    jom = jnewton(jdisp, jnp.asarray(om), jnp.asarray(k), n_iter=3)
    np.testing.assert_allclose(_np(got), np.asarray(jom), rtol=1e-9)
    jres = jdisp(jnp.asarray(_np(got)), jnp.asarray(k))
    jdet = np.asarray(jres.det)
    keep = np.abs(jdet) < 1e6 * np.median(np.abs(jdet))
    assert keep.mean() > 0.9
    np.testing.assert_allclose(_np(res.det)[keep], jdet[keep], rtol=1e-11)
    np.testing.assert_allclose(res.mismatch_pct.numpy()[keep],
                               np.asarray(jres.mismatch_pct)[keep],
                               rtol=1e-9)
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(jres.valid))


def _cpp_smem(dtype, shape):
    """The shear-form complex kernel's shared-memory bytes by the C++
    source's own expressions (csrc/slab_complex.cu: cx_table_offset and
    the table behind it in launch_shear; the table's entry a ShearPoint of
    3 values, 16-byte aligned), evaluated for shape."""
    import re
    src = (Path(__file__).resolve().parent.parent / "eigensolver_tpu_torch"
           / "csrc" / "slab_complex.cu").read_text()
    consts = {name: eval(val) for name, val in re.findall(
        r"constexpr int (kCx\w+) = ([\d\s*+]+);", src)}
    body = re.search(r"cx_table_offset\(int B, int C,\s*int S\) \{(.*?)\n\}",
                     src, re.S).group(1)
    ring_expr = re.search(r"const size_t ring =(.*?);", body, re.S).group(1)
    table_expr = re.search(r"cx_table_offset<T>\(B, C, S\)\s*\+(.*?);", src,
                           re.S).group(1)
    item = torch.empty((), dtype=dtype).element_size()

    def ev(expr, **names):
        expr = re.sub(r"static_cast<size_t>\((\w+)\)", r"\1", expr)
        entry = -(-3 * item // 16) * 16
        expr = expr.replace("sizeof(T)", str(item)).replace(
            "sizeof(ShearPoint<T>)", str(entry))
        return eval(" ".join(expr.split()).replace("/", "//"), {},
                    {**consts, **names})
    b, c, s = shape
    ring = ev(ring_expr, B=b, C=c, S=s)
    return -(-ring // 16) * 16 + ev(table_expr, C=c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_complex_spec_shape(dtype):
    """The shear-form complex kernel's block shape on the main path's
    batches (the KH sweep's 7,200 seeds and roots, the audit's 30,720
    contour points, the ragged 8,191): the producer count the C++ source
    builds at the type (kCxProducers), at most 512 threads a block, the
    shared memory of the 2 blocks an SM holds (__launch_bounds__(.., 2), 1
    KiB reserved a block) within an H100 SM's 228 KiB, a grid that covers
    n, the 7,200 seeds in one wave of 132 SMs; the Python byte count equal
    to the C++ source's."""
    import re
    from eigensolver_tpu_torch.kernels import common
    src = (Path(__file__).resolve().parent.parent / "eigensolver_tpu_torch"
           / "csrc" / "slab_complex.cu").read_text()
    p64, p32 = map(int, re.search(
        r"kCxProducers = std::is_same<T, double>::value \? (\d+) : (\d+);",
        src).groups())
    p = common.COMPLEX_PRODUCERS[dtype]
    assert p == (p64 if dtype == torch.float64 else p32)
    assert 32 * (p + 1) <= 512
    shape = common.complex_spec_shape(dtype)
    b, c, s = shape
    common.check_complex_shape("x", shape, dtype)
    smem = common.complex_smem(shape, dtype)
    assert smem == _cpp_smem(dtype, shape)
    assert 2 * (smem + 1024) <= 228 * 1024
    for n in (7_200, 30_720, 8_191):
        blocks = -(-n // b)
        assert blocks * b >= n > (blocks - 1) * b
        if n == 7_200:
            assert blocks <= 2 * 132
    for shape in [common.ComplexShape(8, 5, 3),
                  common.ComplexShape(16, 32, 2)]:
        assert common.complex_smem(shape, dtype) == _cpp_smem(dtype, shape)


# -- search, dedup, the sweep ---------------------------------------------------

def test_dedup_complex_roots_equals_jax():
    from eigensolver_tpu import roots as jroots
    from eigensolver_tpu_torch import roots
    rng = np.random.default_rng(4)
    base = rng.normal(size=40) + 1j * rng.normal(size=40)
    ks = rng.choice([0.5, 1.0, 1.5], 40)
    om = np.concatenate([base, base * (1 + 3e-5 * rng.normal(size=40)),
                         base * (1 + 3e-3)])
    kk = np.concatenate([ks, ks, ks])
    order = rng.permutation(len(om))
    got = roots.dedup_complex_roots(om[order], kk[order], 1e-4)
    want = jroots.dedup_complex_roots(om[order], kk[order], 1e-4)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert 80 <= len(got[0]) < 120
    e = roots.dedup_complex_roots(np.zeros(0, complex), np.zeros(0))
    assert len(e[0]) == 0


def test_count_roots_rectangle_per_cell_equals_jax():
    """The winding number of each (k, band) cell's rectangle against the
    JAX package's count_roots_rectangle, and the batched winding numbers
    (one dispersion call for every cell, as the audit makes it) against the
    per-cell ones."""
    _jax()
    from eigensolver_tpu import search as jsearch
    from eigensolver_tpu.sweep import make_dispersion_jitted
    from eigensolver_tpu_torch import search, sweep
    jcase, case = _cases(1e5)
    jdisp = make_dispersion_jitted(jcase, 1, np.float64)
    disp = sweep.make_dispersion(case, 1)
    k, imb = 0.5, case.imag_band
    speeds = case.sorted_speeds()
    cells = [(lo * k, hi * k) for lo, hi in zip(speeds[:-1], speeds[1:])]
    got = [search.count_roots_rectangle(disp, k, a, b, 0.05 * imb, 3 * imb,
                                        device="cpu") for a, b in cells]
    want = [float(jsearch.count_roots_rectangle(jdisp, k, a, b, 0.05 * imb,
                                                3 * imb)) for a, b in cells]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert round(sum(want)) >= 1          # the uniform grower
    paths = np.stack([search.rectangle_path(a, b, 0.05 * imb, 3 * imb)
                      for a, b in cells])
    det = disp(_pair(paths.reshape(-1)),
               torch.full((paths.size,), k, dtype=torch.float64)).det
    batched = search.winding_numbers(det.reshape(len(cells), -1)).numpy()
    np.testing.assert_allclose(batched, got, rtol=0, atol=1e-12)


KW = dict(n_re=8, n_im=6, newton_iters=30)


def _run(which, width, **case_kw):
    """run_case_complex of the port (and, unless `which` ends in "port",
    of the JAX package), cached for the tests that share it."""
    if which not in _RUNS:
        from eigensolver_tpu.sweep import run_case_complex as jrun
        from eigensolver_tpu_torch.sweep import run_case_complex
        jcase, case = _cases(width, **case_kw)
        got = run_case_complex(case, **KW, device="cpu")
        want = None if which.endswith("port") else (_jax() and
                                                    jrun(jcase, **KW))
        _RUNS[which] = (jcase, case, got, want)
    return _RUNS[which]


def _roots(rs):
    br = rs["kink"]
    return br.omegas + 1j * br.omegas_imag, br.ks


def _assert_equal_sweeps(got, want):
    (rs, st), (jrs, jst) = got, want
    assert rs.counts() == jrs.counts()
    assert st.completeness == jst.completeness
    assert st.n_candidates == jst.n_candidates
    om, ks = _roots(rs)
    jom, jks = _roots(jrs)
    np.testing.assert_array_equal(ks, jks)
    # per k the same roots: each of JAX's within 1e-9 relative of one of
    # the port's (the order within a k can differ where a conjugate pair's
    # real parts differ by an ulp)
    for k in np.unique(jks):
        a, b = om[ks == k], jom[jks == k]
        d = np.abs(a[:, None] - b[None, :]) / np.abs(b)[None, :]
        assert (d.min(axis=0) <= 1e-9).all() and (d.min(axis=1) <= 1e-9).all()


def test_run_case_complex_uniform_equals_jax_and_analytic():
    """The uniform limit (width 1e5): the JAX package's roots and audit,
    and the Doppler-tanh relation's growth rate within 2e-6
    (tests/test_complex_kh.py:42-55)."""
    from test_complex_kh import _analytic_newton
    jcase, case, got, want = _run("uniform", 1e5)
    _assert_equal_sweeps(got, want)
    br = got[0]["kink"]
    assert (br.omegas_imag > 1e-3).any() and (br.omegas_imag < -1e-3).any()
    i = int(np.argmax(br.omegas_imag))
    W = (br.omegas[i] + 1j * br.omegas_imag[i]) / br.ks[i]
    assert abs(W - _analytic_newton(case.regime, W, br.ks[i])) < 2e-6
    comp = got[1].completeness
    assert comp["checked"] >= 1 and comp["agree"] == comp["checked"]
    assert comp["missed"] == 0


def test_run_case_complex_layer_equals_jax():
    """The non-uniform KH layer (width 1.0) at 3 k: the JAX package's roots
    and audit (tests/test_complex_kh.py:58-73)."""
    _, _, got, want = _run("layer", 1.0, n_k=3, k_min=0.4, k_max=1.2)
    _assert_equal_sweeps(got, want)
    comp = got[1].completeness
    assert comp["cells"] == 9 and comp["checked"] >= 6
    assert comp["missed"] == 0 and comp["agree"] == comp["checked"]


def test_backward_modes_mirror_under_flow_reversal():
    """tests/test_complex_kh.py:102-132 for the port: reversing the flow
    mirrors the spectrum omega -> -conj(omega), so every forward grower has
    a backward twin at Re < 0."""
    jcase, case, (rs_f, _), _ = _run("uniform", 1e5)
    rg = case.regime
    rev = dataclasses.replace(
        case, regime=dataclasses.replace(rg, U_i0=-rg.U_i0, U_e=-rg.U_e),
        speeds=tuple(sorted(-s for s in case.speeds)))
    from eigensolver_tpu_torch.sweep import run_case_complex
    rs_b, _ = run_case_complex(rev, **KW, device="cpu")
    fwd, bwd = rs_f["kink"], rs_b["kink"]
    grow_f = fwd.omegas[fwd.omegas_imag > 1e-3]
    grow_b = bwd.omegas[bwd.omegas_imag > 1e-3]
    assert len(grow_f) and len(grow_b)
    for om in grow_f:
        assert np.min(np.abs(grow_b + om)) < 1e-5 * max(1.0, abs(om))
    assert (grow_b < 0).all()


def test_refusals_and_run_case():
    """run_case on a complex case raises ValueError (the JAX package's
    fails on the complex determinant) and points to run_case_complex. The
    flux form and the numeric exterior at complex omega, and the complex
    cylinder, which raised naming ROADMAP A10b, give the dispersion and
    its dual (their values: tests/test_torch_complex_slab.py,
    tests/test_torch_complex_cylinder.py)."""
    from eigensolver_tpu_torch import cases, sweep
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    _, case = _cases(1e5, n_interior=8)
    with pytest.raises(ValueError, match="run_case_complex"):
        sweep.run_case(case, device="cpu")
    with pytest.raises(ValueError, match="complex_omega"):
        sweep.run_case_complex(cases.slab_flow_gaussian_coronal(),
                               device="cpu")
    flux = dataclasses.replace(cases.slab_density_photospheric(),
                               complex_omega=True)
    numeric = dataclasses.replace(case, grid=dataclasses.replace(
        case.grid, exterior_method="numeric"))
    om, k = _draws(4, 1)
    for c in (flux, numeric):
        c = dataclasses.replace(c, grid=dataclasses.replace(
            c.grid, n_interior=8, n_exterior=8))
        res = SlabPhysics.from_case(c).make_dispersion(parity=1)(
            _pair(om), torch.from_numpy(k))
        d, dd = SlabPhysics.from_case(c).make_dispersion_dual_plain(
            parity=1)(_pair(om), torch.from_numpy(k))
        np.testing.assert_array_equal(_np(d), _np(res.det))
        assert np.isfinite(_np(dd)).all()
    cyl = dataclasses.replace(cases.cylinder_density_coronal(),
                              complex_omega=True)
    cyl = dataclasses.replace(cyl, grid=dataclasses.replace(
        cyl.grid, n_interior=8, n_axis_log=4))
    res = CylinderPhysics.from_case(cyl).make_dispersion(m=1)(
        _pair(om), torch.from_numpy(k))
    d, dd = CylinderPhysics.from_case(cyl).make_dispersion_dual_plain(m=1)(
        _pair(om), torch.from_numpy(k))
    np.testing.assert_array_equal(_np(d), _np(res.det))
    assert np.isfinite(_np(dd)).all()
    with pytest.raises(ValueError, match="real omega"):
        CylinderPhysics.from_case(cases.cylinder_density_coronal()
                                  ).make_dispersion_dual_plain(m=1)
    with pytest.raises(ValueError, match="real omega"):
        SlabPhysics.from_case(cases.slab_flow_gaussian_coronal()
                              ).make_dispersion_dual_plain(parity=1)


def _load(path):
    import importlib.util
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(Path(path).stem,
                                                  root / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_complex_op_counts_match_chip_smoke():
    """chip_smoke.py's bounds count the complex chain's operations as
    tools_torch/count_ops.py traces them from the plain chain; the dual
    pass needs more than twice the value pass's."""
    counts = _load("tools_torch/count_ops.py").complex_ops()
    ops = _load("chip_smoke.py").OPS
    assert counts and {key: ops[key] for key in counts} == counts
    assert ops["slab_cx_dual_step"] > 2 * ops["slab_cx_step"]
    assert 0 < ops["slab_cx_newton"] < ops["slab_cx_ends"]


def test_kh_targets_and_analytic_copy():
    """tools_torch/kh.py's copy of the Doppler-tanh relation is
    tests/test_complex_kh.py's, and its JAX targets agree with it at width
    1e5 (the published sweep's largest growth rate, 2e-6)."""
    from test_complex_kh import _analytic_newton
    from eigensolver_tpu_torch import cases
    case, kw = kh.configure("kh_w1e5", cases)
    assert kw == dict(n_re=12, n_im=10, newton_iters=30)
    assert (case.n_k, case.grid.n_interior, case.modes) == (20, 2048, (1,))
    for W0, K in ((0.5 + 0.2j, 0.4), (0.3 + 0.1j, 1.1)):
        assert kh.analytic_newton(case.regime, W0, K) == \
            _analytic_newton(case.regime, W0, K)
    t = kh.TARGETS["kh_w1e5"]
    W = complex(t["max_growth_omega_re"], t["max_growth"]) / t["max_growth_k"]
    assert abs(W - kh.analytic_newton(case.regime, W, t["max_growth_k"])) \
        < 2e-6
    for name, target in kh.TARGETS.items():
        comp = target["completeness"]
        assert comp["cells"] == 60 and comp["missed"] == 0
        assert target["counts_off_axis"]["kink"] <= target["counts"]["kink"]
        acc = kh.unpack_mask(target["seeds_accepted"], 7200)
        conv = kh.unpack_mask(target["seeds_converged"], 7200)
        assert (int(acc.sum()), int(conv.sum())) == \
            (target["accepted"], target["converged"])
        assert 0 < target["counts_converged"]["kink"] <= \
            target["counts"]["kink"]
        assert target["counts_exact"] == \
            (target["counts_converged"] == target["counts"])


def test_seed_verdicts_accept_what_the_sweep_accepts():
    """tools_torch/kh.py's per-seed verdicts (the acceptance chip_smoke.py
    holds seed by seed) accept what run_case_complex accepted, on the
    port's plain path at a reduced size; the converged seeds are those one
    more Newton step leaves within 1e-9; the masks survive packing."""
    from eigensolver_tpu_torch import search, sweep
    from eigensolver_tpu_torch.roots import dedup_complex_roots
    _, case = _cases(1.0, n_interior=64, n_k=2, k_min=0.4, k_max=1.0)
    kw = dict(n_re=4, n_im=3, newton_iters=12)
    rs, _ = sweep.run_case_complex(case, **kw, check_completeness=False,
                                   device="cpu")
    om0, k0 = sweep.complex_seeds(case, kw["n_re"], kw["n_im"])
    disp = sweep.make_dispersion(case, 1, torch.float64)
    kk = torch.from_numpy(k0)
    om = search.newton_complex(disp, torch.from_numpy(om0), kk,
                               n_iter=kw["newton_iters"])
    res = disp(om, kk)
    nxt = search.newton_complex(disp, om, kk, n_iter=1)
    om, nxt = _np(om), _np(nxt)
    acc, conv = kh.seed_verdicts(case, om, nxt, res.mismatch_pct.numpy(),
                                 res.valid.numpy(), k0)
    rel = case.tol.dedup_rel
    assert acc.any() and len(dedup_complex_roots(om[acc], k0[acc], rel)[0]) \
        == rs.counts()["kink"]
    np.testing.assert_array_equal(
        conv, np.abs(nxt - om) <= kh.CONVERGED_RTOL * np.abs(om))
    assert kh.converged_count(om, k0, acc, conv, dedup_complex_roots, rel) \
        <= rs.counts()["kink"]
    for mask in (acc, conv, ~acc):
        np.testing.assert_array_equal(
            kh.unpack_mask(kh.pack_mask(mask), len(mask)), mask)


# -- the JAX package's full-size counts -----------------------------------------

def jax_counts(name):
    """A KH target's full-size sweep through the JAX package on the CPU,
    and its seeds' verdicts (the Newton pass again, one step further)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from eigensolver_tpu import cases
    from eigensolver_tpu.roots import dedup_complex_roots as jdedup
    from eigensolver_tpu.search import newton_complex as jnewton
    from eigensolver_tpu.sweep import make_dispersion_jitted, run_case_complex
    from eigensolver_tpu_torch.sweep import complex_seeds
    case, kw = kh.configure(name, cases)
    t = time.perf_counter()
    rs, st = run_case_complex(case, **kw)
    wall = time.perf_counter() - t
    br = rs["kink"]
    i = int(np.argmax(br.omegas_imag))
    margin = 0.05 * case.imag_band
    om0, k0 = complex_seeds(case, kw["n_re"], kw["n_im"])
    disp = make_dispersion_jitted(case, 1, jnp.float64)
    kk = jnp.asarray(k0)
    om = jnewton(disp, jnp.asarray(om0), kk, n_iter=kw["newton_iters"])
    res = disp(om, kk)
    nxt = jnewton(disp, om, kk, n_iter=1)
    om = np.asarray(om)
    acc, conv = kh.seed_verdicts(case, om, np.asarray(nxt),
                                 np.asarray(res.mismatch_pct),
                                 np.asarray(res.valid), k0)
    n_conv = kh.converged_count(om, k0, acc, conv, jdedup,
                                case.tol.dedup_rel)
    # the verdicts accept what the sweep accepted
    assert len(jdedup(om[acc], k0[acc], case.tol.dedup_rel)[0]) == \
        rs.counts()["kink"]
    return {"target": name, "counts": rs.counts(),
            "counts_off_axis": {b: int(np.sum(np.abs(r.omegas_imag) > margin))
                                for b, r in rs.branches.items()},
            "completeness": st.completeness, "candidates": st.n_candidates,
            "max_growth": float(br.omegas_imag[i]),
            "max_growth_k": float(br.ks[i]),
            "max_growth_omega_re": float(br.omegas[i]),
            "counts_converged": {"kink": n_conv},
            "counts_exact": n_conv == rs.counts()["kink"],
            "accepted": int(acc.sum()), "converged": int(conv.sum()),
            "accepted_unconverged": int((acc & ~conv).sum()),
            "seeds_accepted": kh.pack_mask(acc),
            "seeds_converged": kh.pack_mask(conv),
            "wall_s": wall, "jax": jax.__version__}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("jax-counts")
    p.add_argument("target", choices=sorted(kh.CONFIGS))
    a = ap.parse_args()
    print(json.dumps(jax_counts(a.target)))


if __name__ == "__main__":
    main()
