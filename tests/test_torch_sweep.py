"""The slice as a whole: the port's run_case vs the JAX package's on the
reduced cylinder_density_coronal(0.9) sweep (k in {0.5, 2.0}, n_interior=256,
n_axis_log=32, n_omega=64, n_bisect=30, float64).

Tolerance: both bisect the same brackets 30 times, to 2^-30 of the bracket,
and converge to the same f64 zero, so every root agrees within 1e-10
relative and the per-branch counts are equal.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from eigensolver_tpu import cases as jcases
from eigensolver_tpu import search as jsearch
from eigensolver_tpu import sweep as jsweep
from eigensolver_tpu_torch import config, search, sweep
from eigensolver_tpu_torch.kernels import cylinder as kcyl
from eigensolver_tpu_torch.physics import cylinder as tcyl
from eigensolver_tpu_torch.utils import StageTimer


def reduced_case():
    c = jcases.cylinder_density_coronal(0.9)
    return dataclasses.replace(
        c, k_values=(0.5, 2.0),
        grid=dataclasses.replace(c.grid, n_interior=256, n_axis_log=32))


@pytest.fixture(scope="module")
def sweeps():
    jcase = reduced_case()
    jcfg = jsearch.SearchConfig(n_omega=64, n_bisect=30)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # saturated-row notices
        jrs, jst = jsweep.run_case(jcase, jcfg)
        plain0, kernel0 = tcyl.plain_calls, kcyl.launches
        timer = StageTimer()
        trs, tst = sweep.run_case(config.from_jax(jcase),
                                  search.SearchConfig.from_jax(jcfg),
                                  device="cpu", timer=timer)
    calls = (tcyl.plain_calls - plain0, kcyl.launches - kernel0)
    return jrs, jst, trs, tst, timer, calls


def test_branch_counts_equal(sweeps):
    jrs, jst, trs, tst, _, _ = sweeps
    assert trs.counts() == jrs.counts()
    assert sum(trs.counts().values()) > 50
    assert tst.n_candidates == jst.n_candidates == 2 * 2 * 12 * 64
    assert tst.n_roots == jst.n_roots


@pytest.mark.parametrize("branch", ["sausage", "kink"])
def test_roots_agree(sweeps, branch):
    jrs, _, trs, _, _, _ = sweeps
    got, want = trs[branch], jrs[branch]
    np.testing.assert_array_equal(got.ks, want.ks)
    np.testing.assert_allclose(got.omegas, want.omegas, rtol=1e-10, atol=0)
    assert got.omegas.dtype == np.float64


def test_cpu_sweep_runs_the_plain_dispersion(sweeps):
    *_, timer, (plain, kernel) = sweeps
    # ladder scan, f(lo), 30 bisections, final residual
    assert plain == 1 + 1 + 30 + 1
    assert kernel == 0
    assert set(timer.report()) == {"ladders", "device_pipeline", "finalize"}


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_card_sweep_runs_the_kernel_and_matches_cpu():
    case = config.from_jax(reduced_case())
    cfg = search.SearchConfig(n_omega=64, n_bisect=30)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cpu, _ = sweep.run_case(case, cfg, device="cpu")
        before = (tcyl.plain_calls, kcyl.launches, kcyl.bisect_launches)
        gpu, _ = sweep.run_case(case, cfg, device="cuda")
    # one ladder-scan launch, one fused bisection launch, no plain call
    assert (tcyl.plain_calls - before[0], kcyl.launches - before[1],
            kcyl.bisect_launches - before[2]) == (0, 1, 1)
    assert gpu.counts() == cpu.counts()
    for branch in ("sausage", "kink"):
        np.testing.assert_array_equal(gpu[branch].ks, cpu[branch].ks)
        np.testing.assert_allclose(gpu[branch].omegas, cpu[branch].omegas,
                                   rtol=1e-10, atol=0)


# -- slab ---------------------------------------------------------------------
#
# The reduced slab_density_photospheric(0.9) sweep: k in {0.5, 1.5, 2.5, 3.5},
# n_interior=256, n_omega=64. At f64 (n_bisect=30) the port equals the JAX
# package per branch, roots within 1e-10. At f32 (n_bisect=18) XLA:CPU
# compiles the JAX package with fused multiply-adds and algebraic rewrites,
# while the port rounds every operation once, as IEEE does; compiled without
# them, the JAX package is bit-equal to the port (tests/test_torch_ieee.py).
# Marginal f32 acceptances flip with such ulp-level changes (full-size
# slab_ph_09 kink: 68 roots by default, 59 rounded as IEEE does), so here, in
# the default compilation, the counts are held to a band and the roots found
# by both to the f32 bisection's resolution.

def reduced_slab():
    c = jcases.slab_density_photospheric(0.9)
    return dataclasses.replace(
        c, k_values=(0.5, 1.5, 2.5, 3.5),
        grid=dataclasses.replace(c.grid, n_interior=256))


def _both_sweeps(jcase, jcfg, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # saturated-row notices
        jrs, _ = jsweep.run_case(jcase, jcfg, **kw)
        trs, _ = sweep.run_case(config.from_jax(jcase),
                                search.SearchConfig.from_jax(jcfg),
                                device="cpu", **kw)
    return jrs, trs


@pytest.fixture(scope="module")
def slab_sweeps():
    f64 = jsearch.SearchConfig(n_omega=64, n_bisect=30)
    f32 = jsearch.SearchConfig(n_omega=64, n_bisect=18, scan_dtype="float32",
                               polish_dtype="float32")
    return {"float64": _both_sweeps(reduced_slab(), f64),
            "float32": _both_sweeps(reduced_slab(), f32)}


def test_slab_branch_counts_equal(slab_sweeps):
    jrs, trs = slab_sweeps["float64"]
    assert trs.counts() == jrs.counts()
    assert min(trs.counts().values()) > 5


@pytest.mark.parametrize("branch", ["sausage", "kink"])
def test_slab_roots_agree(slab_sweeps, branch):
    jrs, trs = slab_sweeps["float64"]
    np.testing.assert_array_equal(trs[branch].ks, jrs[branch].ks)
    np.testing.assert_allclose(trs[branch].omegas, jrs[branch].omegas,
                               rtol=1e-10, atol=0)


@pytest.mark.parametrize("branch", ["sausage", "kink"])
def test_slab_f32_sweep_within_band_of_jax(slab_sweeps, branch):
    """f32 counts within 20% + 2 of the JAX package's per branch, and two
    thirds of each package's roots found by the other within 1e-5 relative
    (18 bisections of a ladder panel resolve ~4e-6 of it). At 10-25 roots a
    branch, 2-3 marginal acceptances flip with XLA's fused multiply-adds
    (measured here: sausage 20 JAX / 22 port, 19 in common; kink 13 / 11,
    10 in common)."""
    jrs, trs = slab_sweeps["float32"]
    got, want = trs[branch], jrs[branch]
    assert abs(len(got) - len(want)) <= 0.2 * len(want) + 2
    assert len(want) > 5

    def matched(a, b):
        hits = 0
        for om, k in zip(a.omegas, a.ks):
            same_k = b.omegas[b.ks == k]
            hits += bool(len(same_k)) and np.min(np.abs(same_k / om - 1)) < 1e-5
        return hits

    assert matched(got, want) >= 2 / 3 * len(got)
    assert matched(want, got) >= 2 / 3 * len(want)


@pytest.mark.parametrize("accept_pct_refined", [None, 1.0])
def test_refine_f64_on_the_same_roots_matches_jax(monkeypatch,
                                                  accept_pct_refined):
    """The port's finalize_branches(refine_f64=True) on the JAX package's own
    f32 polish result: the same roots, dropped and kept alike (counts
    equal), refined to within 1e-12 relative."""
    jcfg = jsearch.SearchConfig(n_omega=64, n_bisect=18, scan_dtype="float32",
                                polish_dtype="float32",
                                accept_pct_refined=accept_pct_refined)
    seen = {}
    real = jsweep.finalize_branches

    def spy(pr, *args, **kw):
        seen["pr"] = pr
        return real(pr, *args, **kw)

    monkeypatch.setattr(jsweep, "finalize_branches", spy)
    jcase = reduced_slab()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jrs, _ = jsweep.run_case(jcase, jcfg, refine_f64=True)
    jpr = seen["pr"]
    tpr = search.PolishResult(*(
        None if x is None else torch.from_numpy(np.array(x))
        for x in (jpr.omega, jpr.k, jpr.mismatch, jpr.mask, jpr.mode)))
    branches = sweep.finalize_branches(
        tpr, jcase.modes, config.from_jax(jcase),
        search.SearchConfig.from_jax(jcfg), refine_f64=True)
    assert {b: len(r) for b, r in branches.items()} == jrs.counts()
    for b, r in branches.items():
        np.testing.assert_array_equal(r.ks, jrs[b].ks)
        np.testing.assert_allclose(r.omegas, jrs[b].omegas, rtol=1e-12, atol=0)
        assert r.omegas.dtype == np.float64


def test_refine_f64_sweep_matches_jax():
    """run_case(f32, refine_f64=True) on the reduced uniform-flow slab (shear
    form), whose f32 root sets agree between the packages: counts equal,
    refined roots within 1e-12 relative."""
    c = jcases.slab_flow_uniform_photospheric()
    jcase = dataclasses.replace(
        c, k_values=(0.5, 1.5, 2.5, 3.5),
        grid=dataclasses.replace(c.grid, n_interior=256))
    jcfg = jsearch.SearchConfig(n_omega=64, n_bisect=18, scan_dtype="float32",
                                polish_dtype="float32")
    timer = StageTimer()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jrs, _ = jsweep.run_case(jcase, jcfg, refine_f64=True)
        trs, _ = sweep.run_case(config.from_jax(jcase),
                                search.SearchConfig.from_jax(jcfg),
                                device="cpu", refine_f64=True, timer=timer)
    assert trs.counts() == jrs.counts()
    assert min(trs.counts().values()) > 5
    assert "refine" in timer.report()
    for b in trs.branches:
        np.testing.assert_array_equal(trs[b].ks, jrs[b].ks)
        np.testing.assert_allclose(trs[b].omegas, jrs[b].omegas, rtol=1e-12,
                                   atol=0)


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_card_slab_sweep_runs_the_kernel_and_matches_cpu():
    from eigensolver_tpu_torch.kernels import slab as kslab
    from eigensolver_tpu_torch.physics import slab as tslab
    case = config.from_jax(reduced_slab())
    cfg = search.SearchConfig(n_omega=64, n_bisect=30)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cpu, _ = sweep.run_case(case, cfg, device="cpu")
        before = (tslab.plain_calls, kslab.launches, kslab.bisect_launches)
        gpu, _ = sweep.run_case(case, cfg, device="cuda")
    # one ladder-scan launch, one fused bisection launch, no plain call
    assert (tslab.plain_calls - before[0], kslab.launches - before[1],
            kslab.bisect_launches - before[2]) == (0, 1, 1)
    assert gpu.counts() == cpu.counts()
    for branch in ("sausage", "kink"):
        np.testing.assert_array_equal(gpu[branch].ks, cpu[branch].ks)
        np.testing.assert_allclose(gpu[branch].omegas, cpu[branch].omegas,
                                   rtol=1e-10, atol=0)
