"""Complex omega on the twisted cylinders (ROADMAP A10b): the rotational
twist (`cylinder_twisted_photospheric`) and the magnetic twist
(`cylinder_twisted_magnetic`), against the JAX package on the CPU in
float64, at a reduced depth (n_interior 64, n_exterior 64):

- the twisted chain on `dual.RDual`s (a dual in r of complex values, and
  on the Newton pass of complex duals in omega): its derivatives against
  the chain's own finite differences;
- the plain complex dispersion against the JAX disp, and its dual shoot,
  whose g carries d^2(r C1/C3)/dr domega, against jax.jvp (the
  tolerances of tests/test_torch_complex_cylinder.py), both m in one
  batch (the sausage without the jump term): the rotational twist with
  the exact exterior and with the numeric one, the magnetic twist with
  the exact one;
- `run_case_complex` of the rotational twist with the numeric exterior,
  reduced (n_k=2, 4 x 3 seeds, 10 Newton steps, the audit on), against
  the JAX package's: counts and audit equal, roots within 1e-10 relative
  (tests/test_torch_complex_cylinder.py holds the exact exterior's sweep,
  chip_smoke.py the twisted one's per seed at full size).

Each JAX function compiles once in the file.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_complex_cylinder import (cases_of, check_disp_and_dual,
                                         check_reduced_sweep, draws, pair)

# name: (case factory, its keywords, exterior_method)
CONFIGS = {
    "twist": ("cylinder_twisted_photospheric",
              dict(v_twist=0.1, power=1.0, mode=1), "bessel"),
    "twist_numeric": ("cylinder_twisted_photospheric",
                      dict(v_twist=0.1, power=1.0, mode=1), "numeric"),
    "magnetic": ("cylinder_twisted_magnetic",
                 dict(B_twist=0.1, v_twist=0.15, power=1.25, mode=1),
                 "bessel"),
}


def test_twisted_chain_derivatives_by_differences():
    """The twisted chain at complex omega on RDuals of complex duals:
    the r-derivative of r C1/C3 (rc.d) against a central difference of
    rc's value in r, and the omega-derivative of rc.d (the mixed
    d^2/dr domega that g carries) against a central difference of rc.d in
    omega; the value pass's rc equal to the dual pass's value bit for
    bit."""
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.dual import Dual
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    _, case = cases_of(*CONFIGS["magnetic"])
    ph = CylinderPhysics.from_case(case)
    point = ph.twisted_point_fn()
    om, k, _ = draws(case, 16, 21)
    k = torch.from_numpy(k)
    m = torch.ones_like(k)
    r = torch.full_like(k, 0.43)

    def rc(rr, o):
        return ph.twisted_chain(point(rr), o, k, m).rc

    w = pair(om)
    one = C(torch.ones_like(k), torch.zeros_like(k))
    dual = rc(r, Dual(w, one))
    val = rc(r, w)
    np.testing.assert_array_equal(val.v.re.numpy(), dual.v.v.re.numpy())
    np.testing.assert_array_equal(val.d.im.numpy(), dual.d.v.im.numpy())
    h = 1e-5
    dr = (rc(r + h, w).v - rc(r - h, w).v)
    dr = C(dr.re / (2 * h), dr.im / (2 * h))
    np.testing.assert_allclose(val.d.re.numpy(), dr.re.numpy(), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(val.d.im.numpy(), dr.im.numpy(), rtol=1e-6,
                               atol=1e-9)
    do = (rc(r, w + C(torch.full_like(k, h), torch.zeros_like(k))).d
          - rc(r, w - C(torch.full_like(k, h), torch.zeros_like(k))).d)
    do = C(do.re / (2 * h), do.im / (2 * h))
    np.testing.assert_allclose(dual.d.d.re.numpy(), do.re.numpy(),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(dual.d.d.im.numpy(), do.im.numpy(),
                               rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dispersion_and_dual_equal_jax(name):
    jcase, case = cases_of(*CONFIGS[name])
    om, k, m = draws(case, 64, 6)
    check_disp_and_dual(jcase, case, om, k, m)


def test_reduced_sweep_equals_jax():
    jcase, case = cases_of(*CONFIGS["twist_numeric"], n_k=2)
    check_reduced_sweep(jcase, case)
