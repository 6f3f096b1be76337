"""The port's RK4 integrators (eigensolver_tpu_torch/ode.py) vs the JAX
package's (eigensolver_tpu/ode.py), on seeded per-candidate linear systems.

Tolerance: f64 to rtol 1e-12, f32 to rtol 1e-4 (the same operations; XLA
contracts f32 multiply-adds into fused ones and reorders, so the last bits
differ per step, accumulate over up to 512 steps and grow where a
component passes near zero). Step counts that are and are not multiples of
the renormalisation interval (64).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from eigensolver_tpu import ode as jode
from eigensolver_tpu_torch import ode

RTOL = {"float64": 1e-12, "float32": 1e-4}


def _system(n, seed):
    """A damped oscillator y'' = -a y' - b y with per-candidate (a, b), its
    domain [x0, x1] and start (y0, y0')."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.5, 0.5, n)
    b = rng.uniform(-4.0, 4.0, n)
    x0 = rng.uniform(-1.0, 0.0, n)
    x1 = x0 + rng.uniform(0.5, 3.0, n)
    return a, b, x0, x1, (rng.normal(size=n), rng.normal(size=n))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n_steps", [37, 64, 200, 512])
def test_rk4_final_matches_jax(n_steps, dtype):
    """x enters the right-hand side (a cosine forcing of the stiffness), so
    the abscissae x0 + i h and x + h/2, x + h are held too."""
    a, b, x0, x1, y0 = _system(300, seed=n_steps)

    def jrhs(x, y, a, b):
        return (y[1], -a * y[1] - (b * jnp.cos(x)) * y[0])

    def jone(a, b, x0, x1, u, v):
        return jode.rk4_final(lambda x, y: jrhs(x, y, a, b), (u, v), x0, x1,
                              n_steps)

    jd = getattr(jnp, dtype)
    want = jax.jit(jax.vmap(jone))(*(jnp.asarray(z, jd)
                                     for z in (a, b, x0, x1, *y0)))
    td = getattr(torch, dtype)
    ta, tb, tx0, tx1, u, v = (torch.from_numpy(z).to(td)
                              for z in (a, b, x0, x1, *y0))
    got = ode.rk4_final(
        lambda x, y: (y[1], -ta * y[1] - (tb * torch.cos(x)) * y[0]),
        (u, v), tx0, tx1, n_steps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL[dtype],
                                   atol=RTOL[dtype] * float(np.abs(w).max()))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n_steps", [64, 100, 512])
def test_rk4_final_renorm_matches_jax(n_steps, dtype):
    """Exponential growth by up to e^60 from x0 down to 1, as the slab
    exterior integrates it: the state, its log-scale, and y1/y0 (what the
    slab exterior reads) equal JAX's."""
    rng = np.random.default_rng(7 + n_steps)
    n = 300
    m = rng.uniform(0.5, 3.0, n) ** 2
    x0 = 1.0 + rng.uniform(5.0, 20.0, n)

    def jone(m, x0):
        ye, logs = jode.rk4_final_renorm(
            lambda x, y: jnp.stack([y[1], m * y[0]]),
            jnp.stack([jnp.asarray(1e-8, m.dtype),
                       jnp.asarray(-1e-15, m.dtype)]),
            x0, jnp.asarray(1.0, m.dtype), n_steps)
        return ye[0], ye[1], logs

    jd = getattr(jnp, dtype)
    want = jax.jit(jax.vmap(jone))(jnp.asarray(m, jd), jnp.asarray(x0, jd))
    td = getattr(torch, dtype)
    tm, tx0 = (torch.from_numpy(z).to(td) for z in (m, x0))
    y0 = tuple(torch.full((), v, dtype=td) for v in (1e-8, -1e-15))
    (g0, g1), logs = ode.rk4_final_renorm(lambda x, y: (y[1], tm * y[0]), y0,
                                          tx0, torch.ones((), dtype=td),
                                          n_steps)
    assert bool(torch.isfinite(g1 / g0).all())
    rtol = RTOL[dtype]
    np.testing.assert_allclose(g0.numpy(), np.asarray(want[0]), rtol=rtol)
    np.testing.assert_allclose(g1.numpy(), np.asarray(want[1]), rtol=rtol)
    # log-scales near 0 (a scale near 1) to an absolute tolerance
    np.testing.assert_allclose(logs.numpy(), np.asarray(want[2]), rtol=rtol,
                               atol=rtol * float(np.abs(want[2]).max()))
    np.testing.assert_allclose((g1 / g0).numpy(),
                               np.asarray(want[1] / want[0]), rtol=rtol)
    # a renormalised state has unit max-norm after the last multiple of 64
    if n_steps % 64 == 0:
        top = torch.maximum(g0.abs(), g1.abs())
        assert bool((top == 1).all())


def test_renorm_scale_keeps_nan_and_zero():
    """A NaN state stays NaN (the scale is 1 there, as jnp.where(NaN > 0,
    ., 1) gives); a zero state stays zero."""
    y0 = (torch.tensor([np.nan, 0.0, 1.0]), torch.tensor([1.0, 0.0, 0.0]))
    (g0, g1), logs = ode.rk4_final_renorm(lambda x, y: (y[1], y[0]), y0,
                                          torch.zeros(()), torch.ones(()), 64)
    assert bool(g0[0].isnan()) and bool(g1[0].isnan())
    assert float(g0[1]) == 0.0 and float(g1[1]) == 0.0
    assert float(logs[0]) == 0.0 and float(logs[1]) == 0.0
    assert float(torch.maximum(g0[2].abs(), g1[2].abs())) == 1.0
