"""Port bracket selection and bisection vs the JAX package's."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from eigensolver_tpu import cases as jcases
from eigensolver_tpu import search as jsearch
from eigensolver_tpu.physics.cylinder import CylinderPhysics as JPhysics
from eigensolver_tpu_torch import config, search, sweep
from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics


def _ladder_arrays(seed, rows=24, n_omega=40):
    """det/valid/mism with ties, non-finite entries and saturated rows."""
    rng = np.random.default_rng(seed)
    omegas = np.sort(rng.uniform(0.1, 5.0, (rows, n_omega)), axis=1)
    ks = rng.uniform(0.01, 4.5, rows)
    modes = (np.arange(rows) >= rows // 2).astype(np.float64)
    det = rng.normal(size=(rows, n_omega))
    det[rng.random((rows, n_omega)) < 0.05] = np.nan
    det[rng.random((rows, n_omega)) < 0.03] = np.inf
    det[3] = np.abs(det[3])                      # a row with no bracket
    det[5, ::2] = -np.abs(det[5, ::2])           # a row of only sign changes
    det[5, 1::2] = np.abs(det[5, 1::2])
    valid = rng.random((rows, n_omega)) > 0.05
    # residuals from a small set, so many brackets tie on their score
    mism = rng.choice([0.5, 1.0, 2.0, 7.0, np.inf, np.nan], (rows, n_omega))
    return omegas, ks, modes, det, valid, mism


@pytest.mark.parametrize("use_mism", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_brackets_matches_jax(seed, use_mism):
    omegas, ks, modes, det, valid, mism = _ladder_arrays(seed)
    want = jsearch.find_brackets(
        jnp.asarray(omegas), jnp.asarray(ks), jnp.asarray(det),
        jnp.asarray(valid), 8, jnp.asarray(modes),
        mism=jnp.asarray(mism) if use_mism else None)
    t = torch.from_numpy
    got = search.find_brackets(t(omegas), t(ks), t(det), t(valid), 8, t(modes),
                               mism=t(mism) if use_mism else None)
    assert int((np.asarray(want.n_in_row) > 8).sum()) > 0   # saturated rows
    for name in ("lo", "hi", "k", "mask", "mode", "n_in_row"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_find_brackets_clamps_budget_to_row_width():
    omegas, ks, modes, det, valid, mism = _ladder_arrays(0, n_omega=6)
    t = torch.from_numpy
    br = search.find_brackets(t(omegas), t(ks), t(det), t(valid), 8, t(modes),
                              mism=t(mism))
    assert br.lo.shape == (omegas.shape[0] * 5,)


def _python_fori_loop(lower, upper, body, init):
    carry = init
    for i in range(lower, upper):
        carry = body(i, carry)
    return carry


def test_bisect_matches_jax(monkeypatch):
    """Both bisections start from the brackets of one ladder scan (the
    port's, f64) and run 30 iterations on their own package's dispersion.
    JAX's fori_loop runs as a Python loop over its jitted dispersion: the
    same operations, without compiling the dispersion a second time inside
    the loop."""
    monkeypatch.setattr(jax.lax, "fori_loop", _python_fori_loop)
    c = jcases.cylinder_density_coronal(0.9)
    jcase = dataclasses.replace(
        c, k_values=(0.5, 2.0),
        grid=dataclasses.replace(c.grid, n_interior=256, n_axis_log=32))
    tdisp = CylinderPhysics.from_case(config.from_jax(jcase)).make_dispersion(
        m=None)
    om, ks = sweep.build_ladders(config.from_jax(jcase), 32)
    rows = om.shape[0]
    t = torch.from_numpy
    omegas, kcol = t(np.concatenate([om, om])), t(np.concatenate([ks, ks]))
    modes = t(np.repeat([0.0, 1.0], rows))
    det, valid, mism = search.ladder_scan(tdisp, omegas, kcol, modes)
    tbr = search.find_brackets(omegas, kcol, det, valid, 4, modes, mism=mism)
    mask = tbr.mask.numpy()
    assert mask.sum() > 10

    got = search.bisect(tdisp, tbr, 30)
    jdisp = jax.jit(jax.vmap(JPhysics.from_case(jcase).make_dispersion(m=None)))
    jbr = jsearch.BracketBatch(*(jnp.asarray(x.numpy()) for x in tbr[:5]))
    want = jsearch.bisect(jdisp, jbr, 30)
    np.testing.assert_allclose(got.omega.numpy()[mask],
                               np.asarray(want.omega)[mask], rtol=1e-12)
    # the % residual at a converged root is ~1e-5 and set by the root's
    # last bits, so it is held absolutely
    np.testing.assert_allclose(got.mismatch.numpy()[mask],
                               np.asarray(want.mismatch)[mask], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def test_collect_matches_jax():
    rng = np.random.default_rng(5)
    n = 50
    leaves = (rng.uniform(size=n), rng.uniform(size=n), rng.uniform(size=n),
              rng.random(n) > 0.5, (rng.random(n) > 0.5).astype(np.float64),
              rng.random(n) > 0.8)
    want = jsearch.collect(jsearch.PolishResult(*map(jnp.asarray, leaves)),
                           with_fuzz=True)
    got = search.collect(search.PolishResult(*map(torch.from_numpy, leaves)),
                         with_fuzz=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
