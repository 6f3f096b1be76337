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
        plain0, kernel0 = tcyl.plain_calls, kcyl.launches
        gpu, _ = sweep.run_case(case, cfg, device="cuda")
    assert (tcyl.plain_calls - plain0, kcyl.launches - kernel0) == (0, 33)
    assert gpu.counts() == cpu.counts()
    for branch in ("sausage", "kink"):
        np.testing.assert_array_equal(gpu[branch].ks, cpu[branch].ks)
        np.testing.assert_allclose(gpu[branch].omegas, cpu[branch].omegas,
                                   rtol=1e-10, atol=0)
