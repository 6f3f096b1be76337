"""Port equilibrium fields vs the JAX package's, at float64."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from eigensolver_tpu import cases as jcases
from eigensolver_tpu.equilibrium import make_equilibrium as jmake
from eigensolver_tpu_torch import config
from eigensolver_tpu_torch.equilibrium import make_equilibrium

FIELDS = ("rho_i", "c_i", "vA_i", "cT_i", "B_i", "U_i", "v_phi", "B_phi", "P_i")
CASES = {
    "cylinder_density_coronal": lambda: jcases.cylinder_density_coronal(0.9),
    "cylinder_flow_coronal": lambda: jcases.cylinder_flow_coronal(),
    "uniform": lambda: jcases.slab_flow_uniform_photospheric(),
    "twisted_magnetic": lambda: jcases.cylinder_twisted_magnetic(),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_equilibrium_fields_match_jax(name):
    jcase = CASES[name]()
    r = np.linspace(1e-5, 1.0, 257)
    jeq = jmake(jcase)
    teq = make_equilibrium(config.from_jax(jcase))
    for field in FIELDS:
        want = np.asarray(getattr(jeq, field)(jnp.asarray(r)))
        got = getattr(teq, field)(torch.tensor(r, dtype=torch.float64)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0,
                                   err_msg=f"{name}.{field}")


def test_boundary_speeds_match_jax():
    jcase = jcases.cylinder_density_coronal(0.9)
    got = make_equilibrium(config.from_jax(jcase)).boundary_speeds()
    want = jmake(jcase).boundary_speeds()
    np.testing.assert_allclose(got, want, rtol=1e-14)
