"""Twisted cylinder sweeps of the port against the JAX package's, with and
without the row-local continuum mask (`equilibrium.genuine_continua_rowfn`).

Reduced sweeps: k in {0.8, 1.4, 2.0}, n_interior=128, n_omega=48,
n_bisect=20, f64. Counts per branch equal; roots to rtol 1e-10 (a fixed-count
bisection gives the same root wherever the f64 signs agree).
"""
import dataclasses
import warnings

import numpy as np
import pytest

from eigensolver_tpu import cases as jcases
from eigensolver_tpu.equilibrium import genuine_continua_rowfn as jrowfn
from eigensolver_tpu.search import SearchConfig as JSearchConfig
from eigensolver_tpu.sweep import run_case as jrun_case
from eigensolver_tpu_torch import config, search, sweep
from eigensolver_tpu_torch.equilibrium import genuine_continua_rowfn

FAMILIES = {
    "photospheric": lambda: jcases.cylinder_twisted_photospheric(
        v_twist=0.1, power=1.0, mode=1),
    "magnetic": lambda: jcases.cylinder_twisted_magnetic(
        B_twist=0.1, v_twist=0.15, power=1.25, mode=1),
}


def reduced(name, n_interior=128):
    c = FAMILIES[name]()
    return dataclasses.replace(
        c, k_values=(0.8, 1.4, 2.0),
        grid=dataclasses.replace(c.grid, n_interior=n_interior))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_reduced_sweep_equals_jax(name, masked):
    jcase = reduced(name)
    case = config.from_jax(jcase)
    kw = dict(n_omega=48, n_bisect=20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, _ = jrun_case(jcase, JSearchConfig(
            **kw, exclude_omega_rowfn=jrowfn(jcase) if masked else None))
        got, st = sweep.run_case(case, search.SearchConfig(
            **kw, exclude_omega_rowfn=(genuine_continua_rowfn(case)
                                       if masked else None)), device="cpu")
    assert got.counts() == want.counts()
    assert sum(got.counts().values()) >= 5
    assert st.n_candidates == 3 * 5 * 48     # one mode family: modes=(1,)
    for b in want.branches:
        np.testing.assert_array_equal(got[b].ks, want[b].ks)
        np.testing.assert_allclose(got[b].omegas, want[b].omegas, rtol=1e-10)
