"""The port's packages re-export what the JAX package's do.

Each `__init__.py` of `eigensolver_tpu` is read with `ast`, so jax never
loads: every name it binds (its `from ... import` names, its `import`
names and its assignments, such as `__version__`) must resolve on the
port's counterpart. Each port package, imported first in a fresh
interpreter, loads no jax and meets no import cycle.
"""
import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "eigensolver_tpu"
# the JAX package's __init__ files, as dotted suffixes ("" the top level)
PACKAGES = sorted(
    ".".join(p.parent.relative_to(JAX_PKG).parts)
    for p in JAX_PKG.rglob("__init__.py"))


def _bound_names(init: Path) -> set:
    """The names an __init__.py binds at its top level, outside a
    try/except that tolerates their absence (the JAX package's optional
    imports included: the port has every module)."""
    names = set()
    for node in ast.walk(ast.parse(init.read_text())):
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Import):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


def test_every_jax_package_is_read():
    assert {"", "io", "kernels", "native", "physics"} <= set(PACKAGES)
    assert "CaseConfig" in _bound_names(JAX_PKG / "__init__.py")
    assert "__version__" in _bound_names(JAX_PKG / "__init__.py")


@pytest.mark.parametrize("package", PACKAGES)
def test_port_package_reexports_the_jax_packages_names(package):
    init = JAX_PKG.joinpath(*package.split("."), "__init__.py") if package \
        else JAX_PKG / "__init__.py"
    names = _bound_names(init)
    assert names, init
    port = importlib.import_module(
        "eigensolver_tpu_torch" + (f".{package}" if package else ""))
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, f"{port.__name__} lacks {missing}"


def test_top_level_values_equal_the_jax_packages():
    import eigensolver_tpu_torch as port
    tree = ast.parse((JAX_PKG / "__init__.py").read_text())
    version = next(ast.literal_eval(n.value) for n in tree.body
                   if isinstance(n, ast.Assign)
                   and n.targets[0].id == "__version__")
    assert port.__version__ == version
    from eigensolver_tpu_torch import config
    assert port.CaseConfig is config.CaseConfig
    assert port.ProfileKind is config.ProfileKind


@pytest.mark.parametrize("package", PACKAGES)
def test_port_package_imports_first_without_jax_or_cycle(package):
    name = "eigensolver_tpu_torch" + (f".{package}" if package else "")
    code = (f"import {name}; import sys; "
            "assert 'jax' not in sys.modules, 'jax'; "
            "assert not any(m.split('.')[0] == 'eigensolver_tpu' "
            "for m in sys.modules), 'eigensolver_tpu'")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
