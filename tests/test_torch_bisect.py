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
# stage of the slab_ph_09 float32 sweep (its roots), with each one's table
# entry (x-only or r-only) size in bytes at float32 and float64
SHAPE_BATCHES = {"cyl_co_09": (17_280, (48, 80)),
                 "slab_ph_09": (5_040, (32, 48)),
                 "flow_gauss": (5_600, (16, 32)),
                 "slab_ph_09 refine": (153, (32, 48))}
# analytic_spec_shape's picks, (B, L, P, C, S, register budget): the
# fastest shapes on an H100 (tools_torch/tune_bisect.py, PERF.md section 6)
ANALYTIC_SHAPES = {
    ("cyl_co_09", "float32"): (32, 0, 7, 28, 2, 0),
    ("cyl_co_09", "float64"): (32, 0, 7, 28, 2, 1),
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
    assert eb == {"cyl_co_09": kcyl._ENTRY_BYTES[dt, False],
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
