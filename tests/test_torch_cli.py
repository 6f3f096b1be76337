"""The port's CLI (`python -m eigensolver_tpu_torch`): every subcommand
in-process with --device cpu at tests/test_cli.py's shapes, the float64
sweep's pickle against the JAX package's CLI (rtol 1e-10: both bisect the
same brackets in float64), the module entry as a subprocess, and the
device rules (no --device asks for "cuda", which this CPU-only torch
lacks: an error, not a run on the CPU); `sweep --sharded` gives the
one-device sweep's pickle."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from eigensolver_tpu import cli as jcli
from eigensolver_tpu import roots as jroots
from eigensolver_tpu_torch import cli, roots
from eigensolver_tpu_torch.native import store
from eigensolver_tpu_torch.physics import slab as pslab

SHAPE = ["--width", "1e5", "--n-k", "6", "--speeds", "0.86,0.92,0.98",
         "--n-interior", "256"]
CASE = ["--case", "slab_density_photospheric", *SHAPE]
CPU = ["--device", "cpu"]
# a cylinder kink root of cylinder_density_coronal(0.9) near k = 1.5 (any
# (omega, k) reconstructs; movie and vorticity need a cylinder)
CYL = ["--case", "cylinder_density_coronal", "--width", "0.9"]


@pytest.fixture(scope="module")
def sweep_pickle(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    out = d / "sweep.pickle"
    cli.main(["sweep", "slab_density_photospheric", *SHAPE, "--x64",
              "--n-omega", "96", "-o", str(out), *CPU])
    want = d / "jax.pickle"
    jcli.main(["sweep", "slab_density_photospheric", *SHAPE, "--x64",
               "--n-omega", "96", "-o", str(want)])
    return out, want


@pytest.fixture(scope="module")
def cyl_pickle(tmp_path_factory):
    p = tmp_path_factory.mktemp("cyl") / "cyl.pickle"
    roots.save_pickle(str(p), roots.RootSet({
        "sausage": roots.RootBranch(np.array([1.4]), np.array([1.5])),
        "kink": roots.RootBranch(np.array([1.425]), np.array([1.5]))}))
    return p


def test_cli_cases(capsys):
    cli.main(["cases"])
    out = capsys.readouterr().out
    assert "slab_density_photospheric" in out
    assert "cylinder_twisted_photospheric" in out


def test_cli_sweep_x64_equals_jax_cli(sweep_pickle):
    got, want = (roots.load_pickle(str(p)) for p in sweep_pickle)
    assert set(got.branches) == {"sausage", "kink"}
    assert got.counts() == want.counts()
    assert sum(got.counts().values()) > 0
    for b in want.branches:
        np.testing.assert_array_equal(got[b].ks, want[b].ks)
        np.testing.assert_allclose(got[b].omegas, want[b].omegas, rtol=1e-10)
    # and the JAX package reads the port's file
    assert jroots.load_pickle(str(sweep_pickle[0])).counts() == got.counts()


def test_cli_sweep_checkpoint_resumes(tmp_path, capsys):
    tiny = ["slab_density_photospheric", "--width", "1e5", "--n-k", "2",
            "--speeds", "0.86,0.92", "--n-interior", "32", "--n-omega",
            "16", "--x64", *CPU]
    ck = str(tmp_path / "s.eigr")
    cli.main(["sweep", *tiny, "--checkpoint", ck, "-o",
              str(tmp_path / "a.pickle")])
    first = json.loads(capsys.readouterr().out.splitlines()[0])
    assert first["device"] == "cpu" and "library_s" not in first
    before = pslab.plain_calls
    cli.main(["sweep", *tiny, "--checkpoint", ck, "-o",
              str(tmp_path / "b.pickle")])
    assert pslab.plain_calls == before           # resumed: nothing evaluated
    again = json.loads(capsys.readouterr().out.splitlines()[0])
    assert again["counts"] == first["counts"]
    assert (tmp_path / "a.pickle").read_bytes() == \
        (tmp_path / "b.pickle").read_bytes()
    assert len(store.read_all(ck)[0]) > 0


# a complex density cylinder at a reduced grid: 2 k, one band, 120 seeds a
# (k, band) cell at the CLI's defaults, n_interior 16 and (`short_tail`)
# 8 steps of the axis' log tail
CX_CYL = ["cylinder_density_coronal", "--width", "0.9", "--complex",
          "--n-k", "2", "--speeds", "0.9,1.0", "--n-interior", "16", *CPU]


@pytest.fixture
def short_tail(monkeypatch):
    """The CLI's cylinder_density_coronal with n_axis_log=8, which the CLI
    has no option for."""
    import dataclasses
    from eigensolver_tpu_torch import cases
    orig = cases.cylinder_density_coronal

    def factory(width: float = 0.9):
        c = orig(width)
        return dataclasses.replace(c, grid=dataclasses.replace(
            c.grid, n_axis_log=8))
    monkeypatch.setattr(cases, "cylinder_density_coronal", factory)


def test_cli_sweep_complex_cylinder_checkpoint_resumes(tmp_path, capsys,
                                                       short_tail):
    """`sweep cylinder_density_coronal --complex`: the sweep, then the same
    with --checkpoint (the same roots), then its resume, which evaluates
    nothing and writes the same pickle."""
    from eigensolver_tpu_torch.physics import cylinder as pcyl
    cli.main(["sweep", *CX_CYL, "-o", str(tmp_path / "a.pickle")])
    plain = json.loads(capsys.readouterr().out.splitlines()[0])
    assert plain["device"] == "cpu" and sum(plain["counts"].values()) > 0
    ck = str(tmp_path / "c.eigr")
    cli.main(["sweep", *CX_CYL, "--checkpoint", ck, "-o",
              str(tmp_path / "b.pickle")])
    first = json.loads(capsys.readouterr().out.splitlines()[0])
    assert first["counts"] == plain["counts"]
    a, b = (roots.load_pickle(str(tmp_path / f"{n}.pickle"))
            for n in ("a", "b"))
    for br in a.branches:
        np.testing.assert_array_equal(b[br].ks, a[br].ks)
        np.testing.assert_allclose(b[br].omegas, a[br].omegas, rtol=1e-12)
    before = pcyl.plain_calls
    cli.main(["sweep", *CX_CYL, "--checkpoint", ck, "-o",
              str(tmp_path / "c.pickle")])
    assert pcyl.plain_calls == before            # resumed: nothing evaluated
    again = json.loads(capsys.readouterr().out.splitlines()[0])
    assert again["counts"] == first["counts"]
    assert (tmp_path / "b.pickle").read_bytes() == \
        (tmp_path / "c.pickle").read_bytes()


def test_cli_complex_kink_only_cylinder_pickle_drops_growth_rates(tmp_path,
                                                                 capsys):
    """A complex twisted cylinder at --mode 1 is a kink-only set: its
    pickle has the reference's [omegas, ks] layout and drops the growth
    rates (roots.py:139-140; ROADMAP C), in the port as in the JAX package;
    --checkpoint keeps them in the store."""
    twist = ["cylinder_twisted_photospheric", "--v-twist", "0.1", "--power",
             "1.0", "--mode", "1", "--complex", "--n-k", "2", "--speeds",
             "1.0,1.1", "--n-interior", "16", *CPU]
    ck = str(tmp_path / "t.eigr")
    cli.main(["sweep", *twist, "--checkpoint", ck, "-o",
              str(tmp_path / "t.pickle")])
    out = json.loads(capsys.readouterr().out.splitlines()[0])
    assert set(out["counts"]) == {"kink"} and out["counts"]["kink"] > 0
    back = roots.load_pickle(str(tmp_path / "t.pickle"))
    assert set(back.branches) == {"kink"}
    assert back["kink"].omegas_imag is None
    assert len(back["kink"]) == out["counts"]["kink"]
    modes, ks, om, oi = store.read_all(ck)
    kept = np.isfinite(om)
    assert kept.sum() >= out["counts"]["kink"]
    assert np.isfinite(oi[kept]).all()


def test_cli_analyze(sweep_pickle, tmp_path, capsys):
    png = tmp_path / "disp.png"
    cli.main(["analyze", str(sweep_pickle[0]), *CASE, "--plot", str(png),
              "--analytic", "--growth", str(tmp_path / "g.png")])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert "branches" in rep and "counts" in rep
    assert png.exists() and png.stat().st_size > 0
    assert (tmp_path / "g.png").stat().st_size > 0


def test_cli_compare(sweep_pickle, tmp_path):
    png = tmp_path / "overlay.png"
    cli.main(["compare", str(sweep_pickle[0]), str(sweep_pickle[1]), *CASE,
              "--labels", "port,jax", "--continuum", "-o", str(png)])
    assert png.exists() and png.stat().st_size > 0


def test_cli_eigenfunction(sweep_pickle, tmp_path, capsys):
    png = tmp_path / "ef.png"
    cli.main(["eigenfunction", str(sweep_pickle[0]), *CASE, *CPU,
              "--k", "1.5", "--branch", "kink", "--plot", str(png)])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert 0.8 < rep["v_phase"] < 1.1
    assert png.exists() and png.stat().st_size > 0


def test_cli_vtk(sweep_pickle, tmp_path, capsys):
    base = tmp_path / "field"
    cli.main(["vtk", str(sweep_pickle[0]), *CASE, *CPU,
              "--k", "1.5", "--branch", "kink", "--frames", "2",
              "-o", str(base)])
    assert "saved 2 VTK files" in capsys.readouterr().out
    vtks = list(tmp_path.glob("field*.vtk"))
    assert len(vtks) == 2 and all(p.stat().st_size > 0 for p in vtks)


@pytest.mark.parametrize("three_d", [False, True])
def test_cli_movie(cyl_pickle, tmp_path, capsys, three_d):
    out = tmp_path / "wave.mp4"
    cli.main(["movie", str(cyl_pickle), *CYL, *CPU, "--k", "1.5",
              "--frames", "3", "-o", str(out)]
             + (["--three-d"] if three_d else []))
    saved = capsys.readouterr().out.strip().split("saved ")[-1]
    assert os.path.getsize(saved) > 0


@pytest.mark.parametrize("three_d", [False, True])
def test_cli_vorticity(cyl_pickle, tmp_path, capsys, three_d):
    png = tmp_path / "vort.png"
    cli.main(["vorticity", str(cyl_pickle), *CYL, *CPU, "--k", "1.5",
              "--cut", "y", "--n-xy", "24", "--background", "-o", str(png)]
             + (["--three-d"] if three_d else []))
    assert "saved" in capsys.readouterr().out
    assert png.stat().st_size > 0


@pytest.mark.parametrize("cmd", ["movie", "vorticity"])
def test_cli_cylinder_only_subcommands_refuse_a_slab(sweep_pickle, tmp_path,
                                                     cmd):
    """A slab eigenfunction has no azimuthal component (the JAX package
    fails with a KeyError there): the port exits saying so."""
    with pytest.raises(SystemExit, match="cylinder cases only"):
        cli.main([cmd, str(sweep_pickle[0]), *CASE, *CPU, "--k", "1.5",
                  "-o", str(tmp_path / "x.png")])


def test_cli_default_device_is_cuda():
    """No --device: the sweep asks for "cuda"; without a card that is an
    error before any evaluation, not a run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    before = pslab.plain_calls
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["sweep", "slab_density_photospheric", *SHAPE,
                  "--n-omega", "16"])
    assert pslab.plain_calls == before


def test_cli_sharded_names_a13(tmp_path, capsys):
    """`sweep --sharded` (which raised naming ROADMAP A13 until the
    sharded sweep was ported) runs parallel.run_case_sharded over the
    --device type's mesh: on the CPU one block, the same pickle as the
    sweep without it."""
    tiny = ["slab_density_photospheric", "--width", "1e5", "--n-k", "2",
            "--speeds", "0.86,0.92,0.98", "--n-interior", "32",
            "--n-omega", "24", "--x64", *CPU]
    for name, extra in (("s.pickle", ["--sharded"]), ("r.pickle", [])):
        cli.main(["sweep", *tiny, *extra, "-o", str(tmp_path / name)])
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[0])["counts"] == json.loads(out[2])["counts"]
    got, want = (roots.load_pickle(str(tmp_path / n))
                 for n in ("s.pickle", "r.pickle"))
    assert got.counts() == want.counts() and sum(got.counts().values())
    for b in want.branches:
        np.testing.assert_array_equal(got[b].omegas, want[b].omegas)
        np.testing.assert_array_equal(got[b].ks, want[b].ks)


def test_cli_unknown_case_exits():
    with pytest.raises(SystemExit):
        cli.main(["analyze", "/nonexistent.pickle", "--case", "not_a_case"])


def test_cli_module_entry():
    """`python -m eigensolver_tpu_torch cases` exits 0 and loads no jax."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c",
                        "import runpy, sys; sys.argv = ['x', 'cases']; "
                        "runpy.run_module('eigensolver_tpu_torch', "
                        "run_name='__main__'); "
                        "assert 'jax' not in sys.modules"],
                       capture_output=True, text=True, cwd=root, timeout=240)
    assert r.returncode == 0, r.stderr[-800:]
    assert "slab_density_photospheric" in r.stdout
    r = subprocess.run([sys.executable, "-m", "eigensolver_tpu_torch",
                        "cases"], capture_output=True, text=True, cwd=root,
                       timeout=240)
    assert r.returncode == 0, r.stderr[-800:]
    assert "cylinder_density_coronal" in r.stdout
