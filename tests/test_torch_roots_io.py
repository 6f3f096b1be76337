"""The port's reference-pickle persistence (`roots.save_pickle` /
`load_pickle`) against the JAX package's: for the same RootSet the files
are byte-identical in the 2-, 4- and 8-array layouts, and each package
reads the other's file. Also pinned: the reference's kink-only 2-array
layout drops omegas_imag in both packages (ROADMAP C)."""
import numpy as np
import pytest

from eigensolver_tpu import roots as jroots
from eigensolver_tpu_torch import roots

def _sets(pkg, imag: bool, kink_only: bool):
    """One RootSet of pkg's classes, from the same seeded arrays."""
    rng = np.random.default_rng(11)
    s_om, s_k = rng.uniform(0.5, 2.0, 9), rng.uniform(0.1, 3.0, 9)
    k_om, k_k = rng.uniform(0.5, 2.0, 7), rng.uniform(0.1, 3.0, 7)
    s_im = rng.normal(0.0, 0.05, 9) if imag else None
    k_im = rng.normal(0.0, 0.05, 7) if imag else None
    branches = {"kink": pkg.RootBranch(k_om, k_k, omegas_imag=k_im)}
    if not kink_only:
        branches["sausage"] = pkg.RootBranch(s_om, s_k, omegas_imag=s_im)
    return pkg.RootSet(branches, "case")


LAYOUTS = {"2-array": (False, True), "4-array": (False, False),
           "8-array": (True, False)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pickle_bytes_equal_jax(layout, tmp_path):
    imag, kink_only = LAYOUTS[layout]
    pj, pt = tmp_path / "jax.pickle", tmp_path / "port.pickle"
    jroots.save_pickle(str(pj), _sets(jroots, imag, kink_only))
    roots.save_pickle(str(pt), _sets(roots, imag, kink_only))
    assert pt.read_bytes() == pj.read_bytes()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_each_package_reads_the_others_pickle(layout, tmp_path):
    imag, kink_only = LAYOUTS[layout]
    pj, pt = tmp_path / "jax.pickle", tmp_path / "port.pickle"
    jroots.save_pickle(str(pj), _sets(jroots, imag, kink_only))
    roots.save_pickle(str(pt), _sets(roots, imag, kink_only))
    for want_file, got in ((pj, roots.load_pickle(str(pj), "c")),
                           (pt, jroots.load_pickle(str(pt), "c"))):
        want = (jroots if want_file is pj else roots).load_pickle(
            str(want_file), "c")
        assert set(got.branches) == set(want.branches)
        for b in want.branches:
            np.testing.assert_array_equal(got[b].omegas, want[b].omegas)
            np.testing.assert_array_equal(got[b].ks, want[b].ks)
            if want[b].omegas_imag is None:
                assert got[b].omegas_imag is None
            else:
                np.testing.assert_array_equal(got[b].omegas_imag,
                                              want[b].omegas_imag)


def test_pickle_roundtrip_values(tmp_path):
    """The 4- and 8-array layouts round-trip values, growth rates
    included (tests/test_roots_io.py's round trips, on the port)."""
    p = str(tmp_path / "t8.pickle")
    rs = _sets(roots, True, False)
    roots.save_pickle(p, rs)
    rs2 = roots.load_pickle(p)
    for b in ("sausage", "kink"):
        np.testing.assert_array_equal(rs2[b].omegas, rs[b].omegas)
        np.testing.assert_array_equal(rs2[b].omegas_imag, rs[b].omegas_imag)


def test_kink_only_pickle_drops_growth_rates(tmp_path):
    """The reference's kink-only layout is [omegas, ks] (roots.py:139-140):
    a complex kink-only set (the KH case, modes=(1,)) loses its growth
    rates in both packages - the defect the port keeps (ROADMAP C)."""
    for pkg in (jroots, roots):
        p = str(tmp_path / f"{pkg.__name__}.pickle")
        pkg.save_pickle(p, _sets(pkg, True, True))
        back = pkg.load_pickle(p)
        assert set(back.branches) == {"kink"}
        assert back["kink"].omegas_imag is None
        assert len(back["kink"]) == 7


def test_pickle_refuses_sausage_only(tmp_path):
    rs = roots.RootSet({"sausage": roots.RootBranch(np.ones(2), np.ones(2))})
    with pytest.raises(ValueError):
        roots.save_pickle(str(tmp_path / "x.pickle"), rs)


def test_load_refuses_unknown_layout(tmp_path):
    import pickle
    p = tmp_path / "bad.pickle"
    p.write_bytes(pickle.dumps([[1.0], [2.0], [3.0]]))
    with pytest.raises(ValueError, match="3 arrays"):
        roots.load_pickle(str(p))
