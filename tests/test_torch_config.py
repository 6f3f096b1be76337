"""The port's configuration modules equal the JAX package's, and the port
imports without jax."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from eigensolver_tpu import cases as jcases
from eigensolver_tpu import search as jsearch
from eigensolver_tpu_torch import cases, config, search, sweep
from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", sorted(jcases.ALL_CASES))
def test_from_jax_equals_port_constructor(name):
    got = config.from_jax(jcases.ALL_CASES[name]())
    want = cases.ALL_CASES[name]()
    assert got == want
    # field for field, nested dataclasses and enums included
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.regime.rho_e == jcases.ALL_CASES[name]().regime.rho_e


def test_search_config_defaults_equal():
    jfields = {f.name: f.default for f in dataclasses.fields(jsearch.SearchConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(search.SearchConfig)}
    assert tfields == jfields
    cfg = jsearch.SearchConfig(n_omega=64, n_bisect=18, scan_dtype="float32")
    assert dataclasses.asdict(search.SearchConfig.from_jax(cfg)) == \
        dataclasses.asdict(cfg)


def test_port_imports_without_jax():
    code = ("import eigensolver_tpu_torch, eigensolver_tpu_torch.sweep; "
            "import sys; assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def _reduced(case, **grid):
    return dataclasses.replace(case, grid=dataclasses.replace(case.grid, **grid))


@pytest.mark.parametrize("make_case, what", [
    (lambda: cases.cylinder_twisted_photospheric(), "A9"),
    (lambda: cases.cylinder_twisted_magnetic(), "A9"),
    (lambda: _reduced(cases.cylinder_density_coronal(),
                      exterior_method="numeric"), "A8"),
    (lambda: dataclasses.replace(cases.cylinder_density_coronal(),
                                 complex_omega=True), "A10"),
])
def test_unported_cylinder_variants_raise(make_case, what):
    with pytest.raises(NotImplementedError, match=what):
        CylinderPhysics.from_case(make_case()).make_dispersion(m=None)


def _tiny_cylinder():
    return dataclasses.replace(
        _reduced(cases.cylinder_density_coronal(), n_interior=8, n_axis_log=4),
        k_values=(1.0,))


def _tiny_slab(**grid):
    return dataclasses.replace(
        _reduced(cases.slab_density_photospheric(), n_interior=8, **grid),
        k_values=(1.0,))


@pytest.mark.parametrize("make_case, search_kw, what", [
    (_tiny_cylinder, {"fuzz_accept_pct": 3.0}, "A11"),
    (_tiny_cylinder, {"exclude_v_ranges": ((0.1, 0.2),)}, "A11"),
    (_tiny_cylinder, {"pole_det_factor": 1e3}, "A11"),
    (lambda: _tiny_slab(exterior_method="numeric"), {}, "A8"),
])
def test_unported_sweep_options_raise(make_case, search_kw, what):
    cfg = search.SearchConfig(n_omega=8, n_bisect=2, **search_kw)
    with pytest.raises(NotImplementedError, match=what):
        sweep.run_case(make_case(), cfg, device="cpu", refine_f64=True)


@pytest.mark.parametrize("make_case", [
    lambda: dataclasses.replace(_tiny_slab(), complex_omega=True),
    lambda: cases.slab_flow_complex_coronal(),
])
def test_unported_geometry_and_ladder_raise(make_case):
    with pytest.raises(NotImplementedError, match="A10"):
        sweep.run_case(make_case(), device="cpu")
    cheb = _reduced(cases.cylinder_density_coronal(), ladder_shape="chebyshev")
    with pytest.raises(NotImplementedError, match="chebyshev"):
        sweep.build_ladders(cheb)


def test_build_ladders_equal_jax():
    from eigensolver_tpu.sweep import build_ladders as jbuild
    import numpy as np
    case = cases.cylinder_density_coronal(0.9)
    om, ks = sweep.build_ladders(case, 32)
    jom, jks = jbuild(jcases.cylinder_density_coronal(0.9), 32)
    assert om.dtype == np.float64 and om.shape == (90 * 12, 32)
    np.testing.assert_array_equal(om, np.asarray(jom))
    np.testing.assert_array_equal(ks, np.asarray(jks))
