"""The port's configuration modules equal the JAX package's, and the port
imports without jax."""
import dataclasses
import enum
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
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


PORT_MODULES = (
    "sweep", "search", "roots", "ode", "eigenfunctions", "analysis",
    "analytic", "synthesis", "viz", "cli", "io.vtk", "native.store",
    "native.vtk_native", "native._lib", "physics.slab", "physics.cylinder",
    "physics.complex_omega",
    "kernels.bessel", "kernels.cylinder", "kernels.slab", "kernels._build",
    "kernels.common", "cplx", "dual", "special")


def test_port_imports_without_jax():
    code = ("import eigensolver_tpu_torch; "
            + "; ".join(f"import eigensolver_tpu_torch.{m}"
                        for m in PORT_MODULES)
            + "; import sys; assert 'jax' not in sys.modules, 'jax'"
            + "; assert not any(m.split('.')[0] == 'eigensolver_tpu' "
              "for m in sys.modules), 'eigensolver_tpu'")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def _code_lines(path: Path):
    """The lines of a Python file outside its comments and strings
    (docstrings included), from the tokenizer."""
    import io
    import tokenize
    keep = []
    for tok in tokenize.generate_tokens(io.StringIO(path.read_text()).readline):
        if tok.type not in (tokenize.COMMENT, tokenize.STRING):
            keep.append(tok.string)
    return " ".join(keep)


def test_no_port_file_imports_the_jax_package():
    """No module of the port, nor chip_smoke.py, imports jax or the JAX
    package outside a comment or a docstring."""
    import re
    files = sorted((REPO / "eigensolver_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 25
    pattern = re.compile(r"\b(import|from)\s+(eigensolver_tpu|jax)\b(?!_)")
    bad = [str(f.relative_to(REPO)) for f in files
           if pattern.search(_code_lines(f))]
    assert not bad, bad
    # the pattern does catch such a line
    assert pattern.search("from eigensolver_tpu . roots import x")
    assert pattern.search("import jax")
    assert not pattern.search("from eigensolver_tpu_torch import x")


def _reduced(case, **grid):
    return dataclasses.replace(case, grid=dataclasses.replace(case.grid, **grid))


def _tiny_cylinder():
    return dataclasses.replace(
        _reduced(cases.cylinder_density_coronal(), n_interior=8, n_axis_log=4),
        k_values=(1.0,))


def _tiny_slab(**grid):
    return dataclasses.replace(
        _reduced(cases.slab_density_photospheric(), n_interior=8, **grid),
        k_values=(1.0,))


def _to_jax(value):
    """The JAX package's config equal to a port config (config.from_jax
    the other way): dataclasses field by field, enums by value."""
    from eigensolver_tpu import config as jconfig
    if isinstance(value, enum.Enum):
        return getattr(jconfig, type(value).__name__)(value.value)
    if dataclasses.is_dataclass(value):
        return getattr(jconfig, type(value).__name__)(**{
            f.name: _to_jax(getattr(value, f.name))
            for f in dataclasses.fields(value)})
    return value


class _EagerJax:
    """jax for the JAX package's search module, with its pipeline left
    unjitted: the dispersion stays one jitted program (compiled once per
    shape, shared by these tests), its glue runs op by op."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kw):
        return fn


def _python_fori_loop(lower, upper, body, init):
    carry = init
    for i in range(lower, upper):
        carry = body(i, carry)
    return carry


def _sweep_equals_jax(case, cfg, refine_f64, monkeypatch):
    """run_case of the port on the CPU gives the JAX package's roots for the
    same case and config (the same counts, roots to rtol 1e-12). The JAX
    package's fused pipeline runs as its steps, around the jitted
    dispersion, so that the cases compile the dispersion once."""
    from eigensolver_tpu import sweep as jsweep
    import numpy as np
    monkeypatch.setattr(jsearch, "jax", _EagerJax())
    monkeypatch.setattr(jax.lax, "fori_loop", _python_fori_loop)
    jcase = _to_jax(case)
    assert config.from_jax(jcase) == case
    want, _ = jsweep.run_case(jcase, jsearch.SearchConfig(
        **dataclasses.asdict(cfg)), refine_f64=refine_f64)
    got, _ = sweep.run_case(case, cfg, device="cpu", refine_f64=refine_f64)
    assert got.counts() == want.counts()
    for b in want.branches:
        np.testing.assert_allclose(got[b].omegas, want[b].omegas, rtol=1e-12)
        np.testing.assert_array_equal(got[b].ks, want[b].ks)
    return got


# The numeric exterior (A8), the search options of A11 and the complex
# cylinder (A10b) raised until they were ported; these cases now hold that
# each runs on the CPU: the real sweeps give the JAX package's roots, the
# complex cylinder's sweep (its roots against JAX's:
# tests/test_torch_complex_cylinder.py) finite roots and, as a real sweep,
# the refusal that points to run_case_complex (the case keeps its test id).
@pytest.mark.parametrize("make_case, what", [
    (lambda: _reduced(_tiny_cylinder(), exterior_method="numeric"), "A8"),
    pytest.param(lambda: dataclasses.replace(_tiny_cylinder(),
                                             complex_omega=True), "A10b",
                 id="<lambda>-A10"),
])
def test_unported_cylinder_variants_raise(make_case, what, monkeypatch):
    if what == "A10b":
        assert callable(CylinderPhysics.from_case(
            make_case()).make_dispersion(m=None).newton)
        rs, st = sweep.run_case_complex(make_case(), n_re=3, n_im=2,
                                        newton_iters=3, device="cpu")
        assert st.n_candidates == 2 * 12 * 6
        for br in rs.branches.values():
            assert np.isfinite(br.omegas).all()
            assert np.isfinite(br.omegas_imag).all()
        with pytest.raises(ValueError, match="run_case_complex"):
            sweep.run_case(make_case(), search.SearchConfig(n_omega=8),
                           device="cpu")
        return
    CylinderPhysics.from_case(make_case()).make_dispersion(m=None)
    _sweep_equals_jax(make_case(), search.SearchConfig(n_omega=8, n_bisect=2),
                      False, monkeypatch)


@pytest.mark.parametrize("make_case, search_kw, what", [
    (_tiny_cylinder, {"fuzz_accept_pct": 3.0}, "A11"),
    (_tiny_cylinder, {"exclude_v_ranges": ((0.1, 0.2),)}, "A11"),
    (_tiny_cylinder, {"pole_det_factor": 1e3}, "A11"),
    (lambda: _tiny_slab(exterior_method="numeric"), {}, "A8"),
])
def test_unported_sweep_options_raise(make_case, search_kw, what,
                                      monkeypatch):
    cfg = search.SearchConfig(n_omega=8, n_bisect=2, **search_kw)
    _sweep_equals_jax(make_case(), cfg, False, monkeypatch)


# Complex omega (A10) raised until it was ported: run_case now refuses a
# complex case and points to run_case_complex (the JAX package's run_case
# fails on the complex determinant); run_case_complex runs the flow slab
# and, since the flux form was ported (A10b, slab part), the density slab.
@pytest.mark.parametrize("make_case", [
    lambda: dataclasses.replace(_tiny_slab(), complex_omega=True),
    lambda: cases.slab_flow_complex_coronal(),
])
def test_unported_geometry_and_ladder_raise(make_case):
    case = make_case()
    with pytest.raises(ValueError, match="run_case_complex"):
        sweep.run_case(case, device="cpu")
    tiny = dataclasses.replace(_reduced(case, n_interior=8),
                               k_values=(0.5,))
    rs, st = sweep.run_case_complex(tiny, n_re=2, n_im=2, newton_iters=2,
                                    device="cpu")
    n_bands = len(tiny.speeds) - 1
    assert st.n_candidates == len(tiny.modes) * n_bands * 2 * 2
    assert st.completeness["cells"] == len(tiny.modes) * n_bands
    assert all(br.omegas_imag is not None for br in rs.branches.values())
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
