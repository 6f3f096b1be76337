"""The fused bisection entries (`make_dispersion(...).bisect`, kernels
`slab_bisect` / `cylinder_bisect`) and the batched-window f64 refinement.

On the CPU a bisect entry runs `search.bisect_loop` over the plain
dispersion, so it equals the loop bit for bit; against the JAX package's
`bisect` on the same brackets it is held as tests/test_torch_search.py holds
the loop: roots to rtol 1e-12, the % residual at the root (~1e-5, set by the
root's last bits) to atol 1e-6. `refine_roots_f64` takes each root's first
bracketing window of one batched evaluation; that is bit-equal to the 4
rounds of widening it replaced (kept here as the oracle). Reduced grids:
n_interior=256, n_axis_log=32; each JAX dispersion is compiled once.

On the card (marker `gpu`) the fused kernels are held bit-equal to the loop
of scan launches: flux, shear and cylinder, float32 and float64, a bracket
count that is not a multiple of the block's, NaN filler brackets and
n_iter=0, at block shapes of L = 0, 1, 2 and 4 levels a round and both
register budgets.
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
from eigensolver_tpu import search as jsearch
from eigensolver_tpu.physics.cylinder import CylinderPhysics as JCylinder
from eigensolver_tpu.physics.slab import SlabPhysics as JSlab
from eigensolver_tpu_torch import config, search, sweep
from eigensolver_tpu_torch.kernels import common as kcommon
from eigensolver_tpu_torch.kernels import cylinder as kcyl
from eigensolver_tpu_torch.kernels import slab as kslab
from eigensolver_tpu_torch.physics import cylinder as tcyl
from eigensolver_tpu_torch.physics import slab as tslab

N_ITER = 20


def _reduced(case, k_values):
    return dataclasses.replace(
        case, k_values=k_values,
        grid=dataclasses.replace(case.grid, n_interior=256, n_axis_log=32))


JCASES = {
    "slab_ph_09": lambda: _reduced(jcases.slab_density_photospheric(0.9),
                                   (0.5, 2.0)),
    "flow_gauss": lambda: _reduced(jcases.slab_flow_gaussian_coronal(),
                                   (0.5, 2.0)),
    "cyl_co_09": lambda: _reduced(jcases.cylinder_density_coronal(0.9),
                                  (0.5, 2.0)),
}


def _port_disp(jcase, dtype=torch.float64):
    case = config.from_jax(jcase)
    if case.geometry == config.Geometry.SLAB:
        return tslab.SlabPhysics.from_case(case).make_dispersion(
            parity=None, dtype=dtype)
    return tcyl.CylinderPhysics.from_case(case).make_dispersion(
        m=None, dtype=dtype)


def _brackets(jcase, n_omega=24):
    """The brackets of one f64 ladder scan of the case, both modes."""
    disp = _port_disp(jcase)
    om, ks = sweep.build_ladders(config.from_jax(jcase), n_omega)
    rows = om.shape[0]
    t = torch.from_numpy
    omegas, kcol = t(np.concatenate([om, om])), t(np.concatenate([ks, ks]))
    modes = t(np.repeat([0.0, 1.0], rows))
    det, valid, mism = search.ladder_scan(disp, omegas, kcol, modes)
    return search.find_brackets(omegas, kcol, det, valid, 4, modes, mism=mism)


def _python_fori_loop(lower, upper, body, init):
    carry = init
    for i in range(lower, upper):
        carry = body(i, carry)
    return carry


@pytest.mark.parametrize("name", ["slab_ph_09", "cyl_co_09"])
def test_bisect_entry_equals_loop_and_jax(monkeypatch, name):
    """The entry on CPU tensors: the loop's (root, mismatch) bit for bit,
    n_iter + 2 plain evaluations, no launch; and the JAX package's bisect
    on the same brackets (its fori_loop run as a Python loop over its
    jitted dispersion, so the dispersion compiles once)."""
    jcase = JCASES[name]()
    disp = _port_disp(jcase)
    br = _brackets(jcase)
    mask = br.mask.numpy()
    assert mask.sum() > 10
    plain = tslab if name.startswith("slab") else tcyl
    kmod = kslab if name.startswith("slab") else kcyl
    before = (plain.plain_calls, kmod.bisect_launches, kmod.launches)
    root, mism = disp.bisect(br.lo, br.hi, br.k, br.mode, N_ITER)
    assert (plain.plain_calls - before[0], kmod.bisect_launches - before[1],
            kmod.launches - before[2]) == (N_ITER + 2, 0, 0)
    loop_root, loop_mism = search.bisect_loop(
        disp, br.lo, br.hi, br.k, br.mode, N_ITER)
    assert torch.equal(root, loop_root)
    assert torch.equal(mism.isnan(), loop_mism.isnan())
    assert torch.equal(mism[~mism.isnan()], loop_mism[~loop_mism.isnan()])
    # search.bisect takes the entry
    pr = search.bisect(disp, br, N_ITER)
    assert torch.equal(pr.omega, root)

    monkeypatch.setattr(jax.lax, "fori_loop", _python_fori_loop)
    jphys = (JSlab.from_case(jcase).make_dispersion(parity=None)
             if name.startswith("slab")
             else JCylinder.from_case(jcase).make_dispersion(m=None))
    jbr = jsearch.BracketBatch(*(jnp.asarray(x.numpy()) for x in br[:5]))
    want = jsearch.bisect(jax.jit(jax.vmap(jphys)), jbr, N_ITER)
    np.testing.assert_allclose(root.numpy()[mask],
                               np.asarray(want.omega)[mask], rtol=1e-12)
    np.testing.assert_allclose(mism.numpy()[mask],
                               np.asarray(want.mismatch)[mask], rtol=0,
                               atol=1e-6)


def test_fixed_parity_entry_matches_moded():
    jcase = JCASES["slab_ph_09"]()
    case = config.from_jax(jcase)
    br = _brackets(jcase)
    ph = tslab.SlabPhysics.from_case(case)
    sel = br.mode == 1.0
    lo, hi, k = br.lo[sel], br.hi[sel], br.k[sel]
    fixed = ph.make_dispersion(parity=1).bisect(lo, hi, k, None, 6)
    moded = ph.make_dispersion(parity=None).bisect(lo, hi, k, br.mode[sel], 6)
    for a, b in zip(fixed, moded):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a[~a.isnan()], b[~b.isnan()])


def _refine_four_rounds(disp64, omega, k, mode, n_iter, rel_halfwidth=4e-7):
    """The f64 refinement as 4 rounds of x8 widening, one dispersion call
    per window endpoint, then the bisection loop (the port's
    refine_roots_f64 before it batched the windows)."""
    om = omega.to(torch.float64)
    kk = k.to(torch.float64)

    def neg(x):
        return torch.signbit(disp64(x, kk, mode).det)

    lo = om * (1.0 - rel_halfwidth)
    hi = om * (1.0 + rel_halfwidth)
    w = rel_halfwidth
    for _ in range(4):
        bad = neg(lo) == neg(hi)
        w = 8.0 * w
        lo = torch.where(bad, om * (1.0 - w), lo)
        hi = torch.where(bad, om * (1.0 + w), hi)
    bad = neg(lo) == neg(hi)
    lo = torch.where(bad, om, lo)
    hi = torch.where(bad, om, hi)
    lo_neg = neg(lo)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        go_right = neg(mid) == lo_neg
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    return 0.5 * (lo + hi), ~bad


def _refine_inputs(jcase):
    """Roots of the f64 bisection moved off by 0, 1e-6, 1e-5 and 1e-4
    relative (first bracketed by the first to the fourth window), an omega
    with no zero within 0.2%, and a NaN."""
    br = _brackets(jcase)
    disp = _port_disp(jcase)
    root, _ = disp.bisect(br.lo, br.hi, br.k, br.mode, 30)
    sel = br.mask.numpy()
    om, kk, md = root[sel][:12], br.k[sel][:12], br.mode[sel][:12]
    shift = torch.tensor([0.0, 1e-6, 1e-5, 1e-4], dtype=torch.float64)
    om = om * (1.0 + shift.repeat(3))
    # the first ladder panel midpoint of mode 0 (first 2 rows) whose det
    # keeps its sign on 101 points across +-0.21%, i.e. over every window
    omegas, ks = sweep.build_ladders(config.from_jax(jcase), 24)
    omegas, ks = omegas[:2], ks[:2]
    mids = torch.from_numpy(0.5 * (omegas[:, :-1] + omegas[:, 1:])).reshape(-1)
    kmid = torch.from_numpy(np.repeat(ks, omegas.shape[1] - 1))
    grid = 1.0 + torch.linspace(-2.1e-3, 2.1e-3, 101, dtype=torch.float64)
    x = (mids[:, None] * grid).reshape(-1)
    d = disp(x, kmid.repeat_interleave(101), torch.zeros_like(x)).det
    d = d.reshape(-1, 101)
    s = torch.signbit(d)
    flat = (s == s[:, :1]).all(dim=1) & d.isfinite().all(dim=1)
    i = int(flat.nonzero()[0])
    far, far_k = float(mids[i]), float(kmid[i])
    om = torch.cat([om, torch.tensor([far, np.nan], dtype=torch.float64)])
    kk = torch.cat([kk, torch.tensor([far_k, 1.0], dtype=torch.float64)])
    md = torch.cat([md, torch.zeros(2, dtype=torch.float64)])
    return om, kk, md


@pytest.mark.parametrize("name", ["flow_gauss", "cyl_co_09"])
def test_batched_refine_windows_equal_four_rounds(name):
    jcase = JCASES[name]()
    disp = _port_disp(jcase)
    om, kk, md = _refine_inputs(jcase)
    got_root, got_ok = search.refine_roots_f64(disp, om, kk, md, n_iter=8)
    want_root, want_ok = _refine_four_rounds(disp, om, kk, md, n_iter=8)
    assert torch.equal(got_ok, want_ok)
    assert not bool(want_ok[-2:].any())        # never bracketed
    assert int(want_ok[:-2].sum()) >= 9        # the moved roots, mostly
    assert torch.equal(got_root.isnan(), want_root.isnan())
    assert torch.equal(got_root[~got_root.isnan()],
                       want_root[~want_root.isnan()])


@pytest.mark.parametrize("dtype", [torch.float16, torch.int64])
@pytest.mark.parametrize("name", ["slab", "cylinder"])
def test_bisect_wrappers_raise_on_unsupported_dtype(name, dtype):
    case = config.from_jax(JCASES["slab_ph_09" if name == "slab"
                                  else "cyl_co_09"]())
    kmod = kslab if name == "slab" else kcyl
    fn = getattr(kmod, f"{name}_bisect")
    x = torch.ones(4, dtype=dtype)
    with pytest.raises(TypeError, match="float32/float64"):
        fn(x, x, x, x, 2, kmod.disp_params(case))


# The main path's bracket batches: cyl_co_09's and slab_ph_09's bracket
# stages, slab_flow_gaussian_coronal's (the shear form), and the refine
# stage of the slab_ph_09 float32 sweep (its roots), with the bytes of each
# one's tables per abscissa (the slab's x-only entry; the cylinder's r-only
# entry and its 4 rows' entries) at float32 and float64
SHAPE_BATCHES = {"cyl_co_09": (17_280, (112, 208)),
                 "slab_ph_09": (5_040, (32, 48)),
                 "flow_gauss": (5_600, (16, 32)),
                 "slab_ph_09 refine": (153, (32, 48))}
# analytic_spec_shape's picks, (B, L, P, C, S, register budget): the
# fastest shapes on an H100 (tools_torch/tune_bisect.py, PERF.md section 6);
# cyl_co_09's C the fit of its row table's larger blocks (21, not 28)
ANALYTIC_SHAPES = {
    ("cyl_co_09", "float32"): (32, 0, 7, 21, 2, 0),
    ("cyl_co_09", "float64"): (32, 0, 7, 21, 2, 1),
    ("slab_ph_09", "float32"): (16, 0, 7, 56, 2, 0),
    ("slab_ph_09", "float64"): (32, 0, 7, 28, 2, 1),
    ("flow_gauss", "float32"): (16, 0, 7, 56, 2, 0),
    ("flow_gauss", "float64"): (16, 0, 7, 28, 2, 2),
    ("slab_ph_09 refine", "float32"): (2, 4, 7, 28, 2, 0),
    ("slab_ph_09 refine", "float64"): (2, 4, 7, 28, 2, 1),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("batch", sorted(SHAPE_BATCHES))
def test_analytic_spec_shape(batch, dtype):
    """The exact exterior's bisection takes the tuned block shape on each
    main-path batch: B 2^L columns within a warp, C a whole number of
    producer passes (32 P / B 2^L steps each), and as many blocks as the
    register budget lets share an SM fit its shared memory."""
    n, entry = SHAPE_BATCHES[batch]
    dt = getattr(torch, dtype)
    eb = entry[dt == torch.float64]
    assert eb == {"cyl_co_09": kcyl.bisect_entry_bytes(dt, False, False),
                  "flow_gauss": kslab._ENTRY_BYTES[(True, dt)]}.get(
                      batch, kslab._ENTRY_BYTES[(False, dt)])
    got = kcommon.analytic_spec_shape(n, dt, eb, shear=batch == "flow_gauss")
    assert tuple(got) == ANALYTIC_SHAPES[batch, dtype]
    b, lv, p, c, s, min_blocks = got
    assert (b << lv) <= 32 and 32 * p % (b << lv) == 0
    assert c % (32 * p // (b << lv)) == 0
    regs = 128 if min_blocks == 1 else 64
    blocks = min(32, 65536 // (regs * 32 * (p + 1)))
    assert blocks * kcommon.spec_smem(got, dt, eb) <= kcommon.MAX_SMEM
    kcommon._check_spec_shape("x", got, dt, eb, False)


# -- on the card ----------------------------------------------------------------

GPU_CASES = {
    "flux": lambda: _reduced(jcases.slab_density_photospheric(0.9),
                             (0.5, 1.5, 2.5)),
    "shear": lambda: _reduced(jcases.slab_flow_gaussian_coronal(),
                              (0.5, 1.5, 2.5)),
    "cylinder": lambda: _reduced(jcases.cylinder_density_coronal(0.9),
                                 (0.5, 1.5, 2.5)),
}


def _same(a, b):
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        a[~a.isnan()], b[~b.isnan()])


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(GPU_CASES))
def test_fused_bisect_bit_equal_to_launch_loop_on_card(name, dtype):
    jcase = GPU_CASES[name]()
    disp = _port_disp(jcase, dtype)
    br = _brackets(jcase, n_omega=32)
    lo, hi, k, md = (x.to(dtype).cuda() for x in (br.lo, br.hi, br.k, br.mode))
    # a count that is no multiple of a block's brackets, and NaN fillers
    n = lo.numel() - 3
    lo, hi, k, md = lo[:n].clone(), hi[:n].clone(), k[:n], md[:n]
    lo[5], hi[7] = float("nan"), float("nan")
    kmod = kslab if name != "cylinder" else kcyl
    for n_iter in (0, 18):
        for final_eval in (True, False):
            before = (kmod.bisect_launches, kmod.launches)
            root, mism = disp.bisect(lo, hi, k, md, n_iter, final_eval)
            torch.cuda.synchronize()
            assert (kmod.bisect_launches - before[0],
                    kmod.launches - before[1]) == (1, 0)
            want_root, want_mism = search.bisect_loop(
                lambda *a: disp(*a), lo, hi, k, md, n_iter, final_eval)
            assert _same(root, want_root)
            assert (mism is None) == (not final_eval)
            if final_eval:
                assert _same(mism, want_mism)
    # every block shape gives the loop's bits: L = 0, 1, 2, 4 levels a
    # round, both register budgets and the one chosen at launch
    fn = kslab.slab_bisect if name != "cylinder" else kcyl.cylinder_bisect
    params = (kslab.disp_params(config.from_jax(jcase)) if name != "cylinder"
              else kcyl.disp_params(config.from_jax(jcase)))
    # (the float64 flux and cylinder chains are built at 128 registers a
    # thread only: their launch at 64 fails)
    narrow = dtype == torch.float32 or name == "shear"
    for final_eval in (True, False):
        want = search.bisect_loop(lambda *a: disp(*a), lo, hi, k, md, 6,
                                  final_eval)
        for shape in ((1, 0, 1, 7, 1, 1), (8, 0, 3, 32, 2, 2),
                      (32, 0, 15, 16, 6, 1), (16, 1, 15, 16, 3, 2),
                      (8, 1, 3, 32, 2, 0), (8, 2, 7, 16, 2, 1),
                      (4, 2, 15, 60, 2, 2), (2, 4, 15, 16, 2, 2),
                      (1, 4, 3, 64, 2, 1)):
            if shape[-1] == 2 and not narrow:
                with pytest.raises(RuntimeError, match="CUDA error"):
                    fn(lo, hi, k, md, 6, params, final_eval,
                       shape=kcommon.SpecShape(*shape))
                continue
            got = fn(lo, hi, k, md, 6, params, final_eval,
                     shape=kcommon.SpecShape(*shape))
            assert _same(got[0], want[0]), shape
            assert (got[1] is None) == (not final_eval)
            if final_eval:
                assert _same(got[1], want[1]), shape


# -- the density/axial-flow cylinder_bisect's tables -----------------------------

def _cpp_bisect_smem(dtype, numeric: bool, nc: int, c: int, s: int) -> int:
    """csrc/bisect.cuh::spec_smem over csrc/cylinder_disp.cu::SpecChain,
    written out: the 32 omegas and the ring (S stages x C steps x 6 values
    x NC columns) to a 16-byte boundary, then per abscissa of the 2
    buffers x 3 C the r-only entry (RPoint<T>, 9 values), the kRows = 4
    rows' entries (RowPoint<T>, 4 values), each 16-byte aligned, and with
    the numeric exterior an exp of each row's k."""
    t = 4 if dtype == torch.float32 else 8

    def aligned(n):
        return -(-n // 16) * 16
    per = aligned(9 * t) + 4 * (aligned(4 * t) + (t if numeric else 0))
    return aligned((32 + s * c * 6 * nc) * t) + 2 * 3 * c * per


@pytest.mark.parametrize("numeric", [False, True], ids=["bessel", "numeric"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cylinder_bisect_smem_mirror(dtype, numeric):
    """The Python mirror of the density/axial-flow bisection's tables
    (kernels.cylinder.bisect_entry_bytes with common.spec_smem) is the C++
    formula at every block shape, and the wrapper's shapes fit a block."""
    eb = kcyl.bisect_entry_bytes(dtype, False, numeric)
    assert eb == {(torch.float32, False): 112, (torch.float32, True): 128,
                  (torch.float64, False): 208,
                  (torch.float64, True): 240}[dtype, numeric]
    assert kcyl.bisect_entry_bytes(dtype, True, numeric) == \
        kcyl._ENTRY_BYTES[dtype, True]
    for b, lv in ((32, 0), (16, 0), (8, 2), (1, 5), (4, 3)):
        for c in (1, 7, 16, 21, 32, 45, 64):
            for s in (1, 2, 6):
                shape = kcommon.SpecShape(b, lv, 7, c, s, 0)
                assert kcommon.spec_smem(shape, dtype, eb) == \
                    _cpp_bisect_smem(dtype, numeric, b << lv, c, s)
    for n in (45, 600, 17_280, 47_520):
        shape = (kcyl.numeric_bisect_shape(n, dtype)
                 if numeric else kcommon.analytic_spec_shape(n, dtype, eb))
        kcommon._check_spec_shape("x", shape, dtype, eb, False)


# numeric_bisect_shape's picks for the density/axial-flow cylinder, (B, L, P,
# C, S, register budget): the fastest shapes on an H100 on cyl_flow_1
# parity's 47,520 brackets and their first 600 (tools_torch/tune_bisect.py
# --numeric, PERF.md section 6)
NUMERIC_CYL_SHAPES = {
    (47_520, "float32"): (32, 0, 4, 24, 2, 1),
    (47_520, "float64"): (32, 0, 4, 16, 2, 1),
    (600, "float32"): (8, 2, 7, 32, 2, 0),
    (600, "float64"): (8, 2, 7, 32, 2, 1),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [47_520, 600])
def test_numeric_cylinder_spec_shape(n, dtype):
    """The numeric exterior's cylinder bisection takes the tuned block
    shape on the parity sweep's bracket stage and on a refine-sized batch:
    B 2^L columns within a warp, the exterior's row group a whole number of
    the producers' lanes; at the loop's schedule its blocks at 128
    registers (the 64 of the other budget spill the chain) fit an SM's
    shared memory as often as its registers allow (a speculative batch,
    75 blocks here, fills no SM twice)."""
    dt = getattr(torch, dtype)
    eb = kcyl.bisect_entry_bytes(dt, False, True)
    got = kcyl.numeric_bisect_shape(n, dt)
    assert tuple(got) == NUMERIC_CYL_SHAPES[n, dtype]
    b, lv, p, c, s, min_blocks = got
    assert (b << lv) <= 32 and 32 * p % (b << lv) == 0
    if lv == 0:
        blocks = min(32, 65536 // (128 * 32 * (p + 1)))
        assert blocks * kcommon.spec_smem(got, dt, eb) <= kcommon.MAX_SMEM
    else:
        assert -(-n // b) < kcommon._SMS
    kcommon._check_spec_shape("x", got, dt, eb, False)
    # the slab's rule is not the cylinder's
    assert kcommon.numeric_spec_shape(n, dt, eb) != got


def test_bisect_tabled_columns_mirror():
    """kernels.cylinder.bisect_tabled_columns (the mirror of csrc/
    bisect.cuh::find_rows): a block's columns read its row table where its
    brackets form at most 4 runs of one (k, m), bit for bit; 2^L columns a
    bracket; the last block's brackets alone."""
    def cols(k, m, b, lv=0):
        k = torch.tensor(k, dtype=torch.float64)
        return kcyl.bisect_tabled_columns(k, torch.tensor(
            m, dtype=torch.float64), kcommon.SpecShape(b, lv, 7, 16, 2, 0))
    k8 = [float(i // 8) for i in range(96)]       # rows of 8: 4 a block
    assert cols(k8, [0.0] * 96, 32) == 96
    assert cols(k8[3:], [0.0] * 93, 32) == 29     # 5 runs but in the last
    k24 = [float(i // 24) for i in range(100)]
    assert cols(k24, [1.0] * 100, 32) == 100
    assert cols(k24, [1.0] * 100, 8, 2) == 400
    # the mode and the bits count: -0.0 is another row than 0.0
    m = [float(i % 2) for i in range(32)]
    assert cols([1.0] * 32, m, 32) == 0
    assert cols([0.0] * 16 + [-0.0] * 16, [0.0] * 32, 32) == 32
    assert cols([0.0, -0.0] * 16, [0.0] * 32, 32) == 0
    assert cols([], [], 32) == 0


def _bisect_layout_case(exterior: str, dtype):
    """The density/axial-flow tube at a reduced depth with the K_m ratio
    (cyl_co_09) or the numeric exterior (cyl_flow_1's tube), 3 k values,
    both modes."""
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


def _bisect_layouts(case, dtype) -> dict:
    """Bracket batches (lo, hi, k, m) on the card of tools_torch.batches'
    row layouts, lo the layout's omega and hi 1.01 lo: rows of 8 and 24
    brackets from the batch's first (4 and 2-3 a block of 32), of 37, the
    runs through the continua (NaN and inf at the poles), rows of 8 from
    batches.ROW_OFFSET (5 runs a block: none tabled), random draws; and a
    speculative batch of 600 brackets of rows of 24."""
    from tools_torch import batches
    lay = batches.row_layout_batches(case, dtype, runs=(
        (8, 40), (24, 30), (37, 12)), n_continua=200, n_draws=300,
        n_windows=1, offset=0)
    lay.pop("refine windows")
    lay["rows 8 offset"] = batches.row_layout_batches(
        case, dtype, runs=((8, 40),), n_continua=1, n_draws=1,
        n_windows=1)["rows 8"]
    out = {name: [om, om * 1.01, k, m] for name, (om, k, m) in lay.items()}
    out["speculative 600"] = [x[:600].contiguous() for x in out["rows 24"]]
    return out


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("exterior", ["bessel", "numeric"])
def test_cylinder_bisect_row_layouts_bit_equal_on_card(exterior, dtype):
    """The density/axial-flow cylinder_bisect, at the wrapper's shape (L >
    0 below 2,112 brackets) and at the parity sweeps' loop schedule (L =
    0, B = 32), gives the roots and mismatches of the launch loop and of
    the plain loop bit for bit on every row layout; its launch's columns
    through the row table (and the tabled exps) are bisect_tabled_columns':
    every column where the rows are contiguous (rows of 8, 24, 37, the
    continua, the speculative batch); at the loop schedule none on the
    random draws and on the rows of 8 off the blocks but the last block's
    (blocks of a few brackets at L > 0 hold few runs, and read rows). Its
    producers keep the chains that kernels.cylinder.bisect_chain_kept
    says. The scan's dets at the lower ends equal the plain version's bit
    for bit, a NaN's sign included (csrc/common.cuh::zero_over)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    case = _bisect_layout_case(exterior, dtype)
    ph = tcyl.CylinderPhysics.from_case(case)
    disp = ph.make_dispersion(m=None, dtype=dtype)
    plain = ph.make_dispersion_plain(m=None, dtype=dtype)
    params = kcyl.disp_params(case)
    eb = kcyl.bisect_entry_bytes(dtype, False, exterior == "numeric")

    def rule(n_br, dt, entry):          # the wrapper's default shape
        if exterior == "numeric":
            return kcyl.numeric_bisect_shape(n_br, dt)
        return kcommon.analytic_spec_shape(n_br, dt, entry)
    loop_shape = rule(47_520, dtype, eb)
    assert loop_shape.levels == 0 and loop_shape.brackets == 32
    n_iter = 8
    kcyl.bisect_counts("cuda")
    for name, br in _bisect_layouts(case, dtype).items():
        n = br[0].numel()
        want = search.bisect_loop(disp, *br, n_iter)
        for shape in (rule(n, dtype, eb), loop_shape):
            got = kcyl.cylinder_bisect(*br, n_iter, params, shape=shape)
            counts = kcyl.bisect_counts("cuda")
            for a, b in zip(got, want):
                assert _same(a, b), (name, shape)
            tabled = kcyl.bisect_tabled_columns(br[2], br[3], shape)
            assert counts["rows"] == tabled, (name, shape, counts)
            assert counts["exterior"] == (tabled if exterior == "numeric"
                                          else 0), (name, counts)
            if name not in ("random draws", "rows 8 offset"):
                assert tabled == n << shape.levels, (name, shape)
            elif shape == loop_shape:
                # 5 runs a block of 32 (the last block of the rows of 8
                # off the blocks holds 3)
                assert tabled == (0 if name == "random draws"
                                  else n % 32), (name, tabled)
            # block 0's first round: every step, and the first chains kept
            # where their abscissae have the bits of the step before's last
            assert counts["steps"] == 280
            assert counts["kept"] == kcyl.bisect_chain_kept(
                case, dtype, shape, "cuda") > 0
        want_plain = search.bisect_loop(plain, *br, n_iter)
        for a, b in zip(want, want_plain):
            assert _same(a, b), name
        # the loop's sign test reads a NaN det's sign bit: the scan's dets
        # at the brackets' lower ends are the plain version's to the bit,
        # NaNs (the continua's edges) included
        it = torch.int32 if dtype == torch.float32 else torch.int64
        assert torch.equal(disp(*br[::2], br[3]).det.view(it),
                           plain(*br[::2], br[3]).det.view(it)), name
