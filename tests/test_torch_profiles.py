"""Port profiles and their closed-form derivatives vs the JAX package's
`make_profile` and `elementwise_grad` / `elementwise_grad2` (jax.grad), at
float64.

Tolerance: the closed forms and jax.grad's reverse pass order their products
differently, so they agree to rounding: rtol 1e-12, with an absolute floor of
1e-12 x max|f^(n)| where a second derivative crosses zero (there the relative
error of either is unbounded).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from eigensolver_tpu import profiles as jprofiles
from eigensolver_tpu.config import ProfileConfig as JProfileConfig
from eigensolver_tpu_torch import config, profiles

PROFILES = {
    "uniform": dict(kind="uniform"),
    "gaussian": dict(kind="gaussian", width=0.9),
    "gaussian_offset": dict(kind="gaussian", width=0.4, center=0.3),
    "epstein": dict(kind="epstein", width=0.5),
    "power_law": dict(kind="power_law", amplitude=0.1, power=2.5),
    "power_law_linear": dict(kind="power_law", amplitude=0.3, power=1.0),
}
F0, FE = 1.0, 0.2


def _jax_cfg(spec):
    from eigensolver_tpu.config import ProfileKind
    spec = dict(spec)
    return JProfileConfig(kind=ProfileKind(spec.pop("kind")), **spec)


def _x():
    return np.linspace(0.01, 1.0, 397)


@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("order", [0, 1, 2])
def test_profile_and_derivatives_match_jax(name, order):
    jcfg = _jax_cfg(PROFILES[name])
    tcfg = config._convert(config.ProfileConfig, jcfg)
    jf = jprofiles.make_profile(jcfg, F0, FE)
    if order == 0:
        tf = profiles.make_profile(tcfg, F0, FE)
    else:
        jf = (jprofiles.elementwise_grad(jf) if order == 1
              else jprofiles.elementwise_grad2(jf))
        tf = profiles.make_profile_derivative(tcfg, F0, FE, order)
    x = _x()
    want = np.asarray(jf(jnp.asarray(x)))
    got = tf(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.max(np.abs(want)))


def test_derivative_order_checked():
    with pytest.raises(ValueError, match="order"):
        profiles.make_profile_derivative(config.ProfileConfig(), F0, FE, 3)
