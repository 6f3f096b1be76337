"""The port's band-edge (needle) pass vs the JAX package's.

`needle_edges`, `_filter_edge_modes` and `roots.merge_rootsets` equal to
JAX's; a reduced `run_needle_pass` (slab_ph_3 with the numeric exterior at
7 wavelengths, one k, the positive cusp edges, mode 0, f64 on the CPU)
with the JAX package's roots to rtol 1e-12; and the needle oracle of
tests/test_needle.py:61-87 on the port, one k each: the band-edge
accumulation marker of slab_ph_3 at k = 0.43303 (omega 0.367977) and the
isolated zero above the coronal slab's cusp band at k = 0.080505 (omega
0.0716901), both within 3e-3. Then the needle target of the reference-parity
sweep (tools_torch/parity.py): slab_ph_3's reduced main sweep (one k,
n_interior=128, 128 exterior steps, n_omega=64, 20 bisections) merged with
its needle pass (n_omega=128) as tools/reproduce.py merges them, the JAX
package's merged set.
"""
import dataclasses
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from eigensolver_tpu import cases as jcases
from eigensolver_tpu import equilibrium as jeq
from eigensolver_tpu import roots as jroots
from eigensolver_tpu import search as jsearch
from eigensolver_tpu import sweep as jsweep
from eigensolver_tpu_torch import cases, config, equilibrium, roots, search
from eigensolver_tpu_torch import sweep

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools_torch import parity  # noqa: E402


def numeric(case):
    return dataclasses.replace(case, grid=dataclasses.replace(
        case.grid, exterior_method="numeric", exterior_wavelengths=7.0))


EDGE_CASES = {
    "slab_ph_3": lambda: jcases.slab_density_photospheric(width=3.0),
    "slab_co_15": lambda: jcases.slab_density_coronal(width=1.5),
    "cyl_flow_1": lambda: jcases.cylinder_flow_coronal(0.05, 1.0),
    "twisted": lambda: jcases.cylinder_twisted_photospheric(0.1, 1.0, 1),
}


@pytest.mark.parametrize("labels", [("cusp",), None])
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_needle_edges_equal_jax(name, labels):
    case = EDGE_CASES[name]()
    want = jsweep.needle_edges(case, labels)
    got = sweep.needle_edges(config.from_jax(case), labels)
    assert [(s, b) for _, s, b in got] == [(s, b) for _, s, b in want]
    # the edges are genuine_continua's (guard 0): exact but for exp ulps
    np.testing.assert_allclose([e for e, *_ in got], [e for e, *_ in want],
                               rtol=0, atol=1e-15)
    if name == "twisted":
        assert got == ()
    if name == "slab_ph_3" and labels:
        assert len(got) == 8 and sum(b for *_, b in got) == 4


def _random_branch(seed, edges, k_values, n=300):
    """Roots scattered around the edges (both sides, inside and past the
    width), at a few ks, plus far ones."""
    rng = np.random.default_rng(seed)
    e = np.array([edge for edge, *_ in edges])
    pick = rng.integers(0, len(e), n)
    d = 10.0 ** rng.uniform(-7, -1.5, n) * rng.choice([-1.0, 1.0], n)
    v = e[pick] * (1 + d)
    k = rng.choice(k_values, n)
    return v * k, k


@pytest.mark.parametrize("edge_modes", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_filter_edge_modes_equals_jax(seed, edge_modes):
    """Overlapping windows too (two edges 1e-3 apart, width 3e-3), where a
    root of one counts against the other, as in the JAX package."""
    edges = ((0.85, -1.0, False), (0.85, +1.0, True),
             (0.8508, -1.0, True), (0.8508, +1.0, False),
             (-0.9, -1.0, True), (-0.9, +1.0, False))
    om, kk = _random_branch(seed, edges, [0.3, 0.7, 1.9])
    want = jsweep._filter_edge_modes(jroots.RootBranch(om, kk), edges, 3e-3,
                                     edge_modes)
    got = sweep._filter_edge_modes(roots.RootBranch(om, kk), edges, 3e-3,
                                   edge_modes)
    np.testing.assert_array_equal(got.omegas, want.omegas)
    np.testing.assert_array_equal(got.ks, want.ks)
    assert 0 < len(got) < len(om)


def test_merge_rootsets_equals_jax():
    """Exact duplicates collapse, pairs 1e-6 relative apart or more stay
    (the tight default), branches only in one set carry over."""
    rng = np.random.default_rng(3)
    base = rng.uniform(0.1, 2.0, 50)
    ks = rng.choice([0.5, 1.0], 50)
    a = {"sausage": (base, ks), "kink": (base[:10] * 1.1, ks[:10])}
    near = base[:20] * (1 + rng.choice([0.0, 5e-7, 3e-6], 20))
    b = {"sausage": (near, ks[:20]), "m2": (base[:5], ks[:5])}

    def rootset(mod, d):
        return mod.RootSet({n: mod.RootBranch(om, kk)
                            for n, (om, kk) in d.items()}, "c")

    want = jroots.merge_rootsets(rootset(jroots, a), rootset(jroots, b))
    got = roots.merge_rootsets(rootset(roots, a), rootset(roots, b))
    assert set(got.branches) == set(want.branches) == {"sausage", "kink",
                                                       "m2"}
    for n in want.branches:
        np.testing.assert_array_equal(got[n].omegas, want[n].omegas)
        np.testing.assert_array_equal(got[n].ks, want[n].ks)
    assert 50 < len(got["sausage"]) < 70


def test_needle_pass_without_edges_is_empty():
    case = config.from_jax(EDGE_CASES["twisted"]())
    rs, st = sweep.run_needle_pass(case, device="cpu")
    assert rs.counts() == {"kink": 0} and st.n_candidates == 0


@pytest.fixture(scope="module")
def ph3_needle():
    case = numeric(EDGE_CASES["slab_ph_3"]())
    edges = tuple(e for e in jsweep.needle_edges(case) if e[0] > 0)
    want, _ = jsweep.run_needle_pass(case, modes=(0,), ks=[0.43303],
                                     edges=edges)
    got, st = sweep.run_needle_pass(config.from_jax(case), modes=(0,),
                                    ks=[0.43303], edges=edges, device="cpu")
    return got, st, want


def test_needle_pass_equals_jax(ph3_needle):
    got, st, want = ph3_needle
    assert st.n_candidates == 4 * 512
    assert got.counts() == want.counts()
    np.testing.assert_allclose(got["sausage"].omegas, want["sausage"].omegas,
                               rtol=1e-12)
    np.testing.assert_array_equal(got["sausage"].ks, want["sausage"].ks)


def test_needle_oracle_band_edge_marker(ph3_needle):
    om = ph3_needle[0]["sausage"].omegas
    assert len(om) > 0
    assert np.min(np.abs(om - 0.367977) / 0.367977) < 3e-3
    assert len(om) <= 2 + 8        # in-band windows keep one root each


def test_needle_oracle_isolated_zero():
    case = config.from_jax(numeric(jcases.slab_density_coronal(width=1.5)))
    edges = tuple(e for e in sweep.needle_edges(case) if e[0] > 0)
    rs, _ = sweep.run_needle_pass(case, modes=(0,), ks=[0.080505],
                                  edges=edges, device="cpu")
    om = rs["sausage"].omegas
    assert len(om) > 0
    assert np.min(np.abs(om - 0.0716901) / 0.0716901) < 3e-3


def test_reduced_needle_target_merge_equals_jax():
    """slab_ph_3: the main f64 sweep (one k) merged with its needle pass
    over the positive cusp edges, mode 0, as reproduce.py merges them."""
    name, ks = "slab_ph_3", (0.43303,)
    # the needle at its n_interior=512, 128 exterior steps: the marker
    # near 0.367977 (tests/test_needle.py) is in the merged set
    out = []
    for mods, sw, merge, kw in (
            ((jcases, jsearch.SearchConfig, jeq.genuine_continua), jsweep,
             jroots.merge_rootsets, {}),
            ((cases, search.SearchConfig, equilibrium.genuine_continua),
             sweep, roots.merge_rootsets, {"device": "cpu"})):
        case, cfg, _ = parity.configure(name, *mods)
        case = dataclasses.replace(case, k_values=ks, grid=dataclasses.replace(
            case.grid, n_interior=128, n_exterior=128))
        cfg = dataclasses.replace(cfg, n_omega=64, n_bisect=20)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            main, _ = sw.run_case(case, cfg, **kw)
            edges = parity.needle_edges(name, case, sw.needle_edges)
            ndl, _ = sw.run_needle_pass(case, edges=edges, n_omega=128,
                                        modes=parity.TARGETS[name]["needle"][
                                            "modes"], **kw)
        out.append((main, ndl, merge(main, ndl)))
    for want, got in zip(*out):
        assert got.counts() == want.counts()
        for b in want.branches:
            np.testing.assert_allclose(got[b].omegas, want[b].omegas,
                                       rtol=1e-12)
    merged = out[1][2]["sausage"].omegas
    assert len(merged) > out[1][0].counts()["sausage"]
    assert np.min(np.abs(merged / 0.367977 - 1)) < 3e-3
