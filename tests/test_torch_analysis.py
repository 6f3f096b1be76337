"""The port's host-side layers against the JAX package's on the same
inputs: analysis (window classification, branch separation, fits),
analytic (the uniform-limit relations, the scanner, the overlay curves),
synthesis (fields, Cartesian components, boundary, vorticity) and the VTK
files, byte for byte with both writers; plus smoke tests of viz mirroring
tests/test_analysis_synthesis.py. All numpy in both packages, so equal
means equal: array_equal, files byte-identical."""
import dataclasses
import os

import numpy as np
import pytest

from eigensolver_tpu import analysis as janalysis
from eigensolver_tpu import analytic as janalytic
from eigensolver_tpu import cases as jcases
from eigensolver_tpu import eigenfunctions as jef
from eigensolver_tpu import roots as jroots
from eigensolver_tpu import synthesis as jsyn
from eigensolver_tpu.io import vtk as jvtk
from eigensolver_tpu_torch import analysis, analytic, cases, eigenfunctions
from eigensolver_tpu_torch import roots, synthesis
from eigensolver_tpu_torch.config import Regime
from eigensolver_tpu_torch.io import vtk
from eigensolver_tpu_torch.native import vtk_native


def _branch(pkg, seed=3):
    rng = np.random.default_rng(seed)
    k = np.linspace(0.5, 3.0, 20)
    ks = np.concatenate([k, k, rng.uniform(0.5, 3.0, 6)])
    v = np.concatenate([1.0 + 0.05 * k, 2.0 - 0.1 * k,
                        rng.uniform(0.3, 5.0, 6)])
    return pkg.RootBranch(omegas=v * ks, ks=ks)


def _ef(pkg):
    x = np.linspace(0.01, 3.0, 200)
    prof = np.exp(-((x - 0.8) ** 2) / 0.2)
    return pkg.RadialEigenfunction(
        omega=1.2, k=1.0, mode=1, x=x, P_T=prof, xi_r=prof * 0.5,
        xi_phi=prof * 0.3, xi_z=prof * 0.1, v_r=-1.2 * prof * 0.5,
        v_phi=-1.2 * prof * 0.3, v_z=-1.2 * prof * 0.1, i_boundary=100)


def _grid(pkg, n_r=30, n_th=24, n_z=5, n_t=3):
    return pkg.FieldGrid(t=np.linspace(0, 1, n_t),
                         r=np.linspace(0.05, 2.0, n_r),
                         theta=np.linspace(0, 2 * np.pi, n_th),
                         z=np.linspace(0.01, 2.0, n_z))


def _equal_branch(a, b):
    np.testing.assert_array_equal(a.omegas, b.omegas)
    np.testing.assert_array_equal(a.ks, b.ks)


RG = dict(c_i0=1.0, vA_i0=2.0, c_e=0.5, vA_e=5.0)


def test_analysis_equals_jax():
    from eigensolver_tpu.config import Regime as JRegime
    rg, jrg = Regime(**RG), JRegime(**RG)
    got = analysis.classify(_branch(roots), analysis.standard_windows(rg))
    want = janalysis.classify(_branch(jroots),
                              janalysis.standard_windows(jrg))
    assert list(got) == list(want)
    for w in want:
        _equal_branch(got[w], want[w])
    gc = analysis.separate_branches(_branch(roots), v_gap=0.05)
    wc = janalysis.separate_branches(_branch(jroots), v_gap=0.05)
    assert len(gc) == len(wc) and len([c for c in gc if len(c) >= 10]) == 2
    for a, b in zip(gc, wc):
        _equal_branch(a, b)
    fit = analysis.fit_branch(gc[0], order=2)
    jfit = janalysis.fit_branch(wc[0], order=2)
    np.testing.assert_array_equal(fit.coefs, jfit.coefs)
    assert fit.k_range == jfit.k_range
    rs = roots.RootSet({"kink": _branch(roots), "sausage": _branch(roots, 5)})
    jrs = jroots.RootSet({"kink": _branch(jroots),
                          "sausage": _branch(jroots, 5)})
    got, want = analysis.analyse(rs, rg), janalysis.analyse(jrs, jrg)
    for mode in want:
        for w in want[mode]:
            assert len(got[mode][w]) == len(want[mode][w])
            for a, b in zip(got[mode][w], want[mode][w]):
                np.testing.assert_array_equal(a.coefs, b.coefs)


def test_fit_branch_recovers_linear_phase_speed():
    k = np.linspace(0.5, 3.0, 20)
    v = 1.0 + 0.05 * k
    bf = analysis.fit_branch(roots.RootBranch(omegas=v * k, ks=k), order=1)
    np.testing.assert_allclose(bf(k), v, rtol=1e-10)


@pytest.mark.parametrize("parity", [0, 1])
def test_slab_relation_and_scan_equal_jax(parity):
    rg = cases.slab_flow_gaussian_coronal(width=1e5, U_i0=0.35).regime
    jrg = jcases.slab_flow_gaussian_coronal(width=1e5, U_i0=0.35).regime
    v = np.linspace(0.3, 2.5, 301)
    np.testing.assert_array_equal(analytic.slab_relation(rg, v, 1.0, parity),
                                  janalytic.slab_relation(jrg, v, 1.0, parity))
    got = analytic.scan_relation(
        lambda v: analytic.slab_relation(rg, v, 1.0, parity), 0.3, 2.5)
    want = janalytic.scan_relation(
        lambda v: janalytic.slab_relation(jrg, v, 1.0, parity), 0.3, 2.5)
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)


def test_cylinder_relation_and_curves_equal_jax():
    rg = cases.cylinder_density_coronal(width=1e5).regime
    jrg = jcases.cylinder_density_coronal(width=1e5).regime
    v = np.linspace(2.05, 4.9, 101)
    np.testing.assert_array_equal(analytic.cylinder_relation(rg, v, 1.5, 1),
                                  janalytic.cylinder_relation(jrg, v, 1.5, 1))
    ks = [0.5, 1.5]
    got = analytic.analytic_curves(rg, ks, 2.05, 4.9, geometry="cylinder",
                                   n_scan=801)
    want = janalytic.analytic_curves(jrg, ks, 2.05, 4.9, geometry="cylinder",
                                     n_scan=801)
    assert set(got) == set(want) == {"sausage", "kink"}
    for b in want:
        assert len(want[b]) > 0
        _equal_branch(got[b], want[b])


def test_synthesis_equals_jax():
    ef, jef_ = _ef(eigenfunctions), _ef(jef)
    grid, jgrid = _grid(synthesis), _grid(jsyn)
    got = synthesis.to_cartesian(synthesis.synthesize(ef, grid), grid)
    want = jsyn.to_cartesian(jsyn.synthesize(jef_, jgrid), jgrid)
    assert set(got) == set(want)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])
    for a, b in zip(synthesis.boundary_surface(got, grid, amplitude=0.2),
                    jsyn.boundary_surface(want, jgrid, amplitude=0.2)):
        np.testing.assert_array_equal(a, b)
    bg = synthesis.add_background_flow(got, grid, v_phi0=np.sqrt,
                                       v_z0=np.cos)
    jbg = jsyn.add_background_flow(want, jgrid, v_phi0=np.sqrt, v_z0=np.cos)
    np.testing.assert_array_equal(bg["v_phi"], jbg["v_phi"])
    out = synthesis.vorticity_pipeline(ef, grid, n_xy=24)
    jout = jsyn.vorticity_pipeline(jef_, jgrid, n_xy=24)
    for a, b in zip(out[:3], jout[:3]):
        np.testing.assert_array_equal(a, b)
    for c in ("v_x", "v_y", "v_z"):
        np.testing.assert_array_equal(out[3][c], jout[3][c])
    for a, b in zip(out[4], jout[4]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out[5], jout[5])


def test_synthesize_matches_loop_reference():
    """tests/test_analysis_synthesis.py's quadruple-loop oracle
    (`Gaussian_flow_Cylinder_movie.py:836-846`) on the port."""
    ef = _ef(eigenfunctions)
    grid = synthesis.FieldGrid(t=np.linspace(0, 1, 3),
                               r=np.linspace(0.05, 2.0, 7),
                               theta=np.linspace(0, 2 * np.pi, 5),
                               z=np.linspace(0.01, 2.0, 4))
    out = synthesis.synthesize(ef, grid)
    fr = np.interp(grid.r, ef.x, ef.xi_r)
    m, k, w = ef.mode, ef.k, ef.omega
    want = np.zeros((3, 7, 5, 4))
    for t in range(3):
        for i in range(7):
            for j in range(5):
                for kk in range(4):
                    want[t, i, j, kk] = (fr[i] * np.cos(m * grid.theta[j])
                                         * np.cos(k * grid.z[kk])
                                         * np.cos(w * grid.t[t]))
    np.testing.assert_allclose(out["xi_r"], want, rtol=1e-12)


def test_vorticity_of_rigid_rotation():
    n = 24
    xs = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    wx, wy, wz = synthesis.vorticity_3d(-0.7 * Y, 0.7 * X, np.zeros_like(X),
                                        xs, xs, xs)
    np.testing.assert_allclose(wz, 1.4, rtol=1e-10)
    np.testing.assert_allclose(wx, 0.0, atol=1e-12)


@pytest.mark.parametrize("writer", ["native", "python"])
def test_vtk_series_bytes_equal_jax(writer, tmp_path, monkeypatch):
    """export_field_series of the same fields: the port's files (through
    the C++ writer, or its Python writer with the library out of reach)
    equal the JAX package's byte for byte."""
    if writer == "python":
        monkeypatch.setattr(vtk_native, "available", lambda: False)
    else:
        assert vtk_native.available()
    ef, jef_ = _ef(eigenfunctions), _ef(jef)
    grid, jgrid = _grid(synthesis, n_t=2), _grid(jsyn, n_t=2)
    comps = ("P_T", "v_x", "v_y", "v_z", "xi_r")
    got = vtk.export_field_series(
        str(tmp_path / "port"),
        synthesis.to_cartesian(synthesis.synthesize(ef, grid), grid),
        grid, comps)
    want = jvtk.export_field_series(
        str(tmp_path / "jax"),
        jsyn.to_cartesian(jsyn.synthesize(jef_, jgrid), jgrid), jgrid,
        comps)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert open(g, "rb").read() == open(w, "rb").read()


def test_vtk_python_matches_reference_packing():
    import struct
    rng = np.random.default_rng(1)
    shape = (3, 2, 2)
    x, y, z = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    want = b""
    for k in range(shape[2]):
        for j in range(shape[1]):
            for i in range(shape[0]):
                want += struct.pack(">fff", x[i, j, k], y[i, j, k],
                                    z[i, j, k])
    assert vtk._points_block(x, y, z) == want


# --- viz smoke tests (tests/test_analysis_synthesis.py's, on the port) -----

def test_viz_figures(tmp_path):
    from eigensolver_tpu_torch import viz
    rg = Regime(**RG)
    rs = roots.RootSet({"sausage": _branch(roots), "kink": _branch(roots)},
                       "t")
    fits = analysis.analyse(rs, rg)
    an = {"kink": _branch(roots, 9)}
    p1 = viz.dispersion_diagram(rs, rg, path=str(tmp_path / "disp.png"),
                                fits=fits, analytic=an, title="t")
    p2 = viz.eigenfunction_figure([_ef(eigenfunctions)],
                                  path=str(tmp_path / "ef.png"))
    br = _branch(roots)
    im = np.zeros_like(br.omegas)
    im[::3] = 0.05
    kh = roots.RootSet({"kink": roots.RootBranch(br.omegas, br.ks,
                                                 omegas_imag=im)}, "kh")
    p3 = viz.growth_rate_diagram(kh, rg, path=str(tmp_path / "growth.png"),
                                 kh_threshold=1.2)
    p4 = viz.multi_width_overlay({"a": rs, "b": rs}, rg,
                                 path=str(tmp_path / "over.png"),
                                 continuum=[(0.9, 1.0, "cusp")])
    for p in (p1, p2, p3, p4):
        assert os.path.getsize(p) > 5000


def test_viz_vorticity_figures(tmp_path):
    from eigensolver_tpu_torch import viz
    ef = _ef(eigenfunctions)
    grid = _grid(synthesis, n_r=40, n_th=32, n_z=9, n_t=2)
    xs, ys, zs, vel, vort, PT = synthesis.vorticity_pipeline(ef, grid,
                                                             n_xy=24)
    for cut in ("x", "y", "z"):
        p = tmp_path / f"vort_{cut}.png"
        viz.vorticity_cut_figure(xs, ys, zs, vel, vort, PT=PT, cut=cut,
                                 path=str(p))
        assert p.stat().st_size > 0
    fields = synthesis.to_cartesian(synthesis.synthesize(ef, grid), grid)
    bx, by = synthesis.boundary_surface(fields, grid, amplitude=0.2)
    p = tmp_path / "vort3d.png"
    viz.vorticity_3d_figure(xs, ys, zs, vel, vort, boundary=(bx[0], by[0]),
                            path=str(p))
    assert p.stat().st_size > 5000


def test_viz_movies(tmp_path):
    """Both movie writers (mp4 through ffmpeg, else a gif)."""
    import matplotlib.pyplot as plt
    from eigensolver_tpu_torch import viz
    ef = _ef(eigenfunctions)
    grid = _grid(synthesis)
    fields = synthesis.to_cartesian(synthesis.synthesize(ef, grid), grid)
    bnd = synthesis.boundary_surface(fields, grid, amplitude=0.2)
    fig = viz.tube_3d_frame(fields, grid, bnd, t_index=0, z_indices=(0, -1))
    assert len(fig.axes) == 3
    plt.close(fig)
    for fn, name in ((viz.animate_tube_3d, "tube.mp4"),
                     (viz.animate_cross_section, "cross.mp4")):
        out = fn(fields, grid, str(tmp_path / name), boundary=bnd)
        assert os.path.getsize(out) > 0
