"""Eigenfunctions of the port (`ode.rk4_trajectory`,
`eigenfunctions.reconstruct_slab` / `reconstruct_cylinder`) against the
JAX package's on the CPU, and the uniform-slab kink oracle of
tests/test_eigenfunctions.py on the port.

Tolerances: the port's trajectory of a linear system folds each RK4 step
into its transfer matrix and the cylinder's derivatives are closed forms
where JAX differentiates, so the fields agree to rounding, amplified where
the cylinder's axis-regular combination cancels its two basis solutions
(xi_r = C1 P / C3 + w / r at the axis cutoff r = 1e-3): every field within
1e-9 x its largest value (measured: slabs ~2e-13, cylinder ~2e-10 at the
axis). The generic (staged) trajectory does the JAX step's operations, so
it agrees to 1e-13.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eigensolver_tpu import cases as jcases
from eigensolver_tpu import eigenfunctions as jef
from eigensolver_tpu import ode as jode
from eigensolver_tpu.physics.slab import SlabPhysics as JSlabPhysics
from eigensolver_tpu_torch import cases, config, eigenfunctions, ode, sweep
from eigensolver_tpu_torch.physics.slab import SlabPhysics

FIELDS = ("x", "P_T", "xi_r", "vx", "xi_phi", "xi_z", "v_r", "v_phi", "v_z")
N_INT = 256


def _close(got, want, rel):
    assert (got.omega, got.k, got.mode, got.i_boundary) == \
        (want.omega, want.k, want.mode, want.i_boundary)
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
            continue
        assert g.shape == w.shape, f
        scale = np.max(np.abs(w))
        assert np.max(np.abs(g - w)) <= rel * scale, (
            f, np.max(np.abs(g - w)) / scale)


def _t(*vals):
    return tuple(torch.tensor(v, dtype=torch.float64) for v in vals)


def test_rk4_trajectory_staged_equals_jax():
    """A generic rhs takes the staged RK4 steps of ode.py:50-72."""
    def jrhs(x, y):
        return jnp.stack([y[1], -x * y[0] - 0.3 * y[1] * y[1]])

    def trhs(x, y):
        return (y[1], -x * y[0] - 0.3 * y[1] * y[1])

    yf_j, traj_j = jode.rk4_trajectory(jrhs, jnp.array([1.0, 0.2]), 0.0,
                                       2.5, 64)
    yf_t, traj_t = ode.rk4_trajectory(trhs, _t(1.0, 0.2), 0.0, 2.5, 64)
    got = np.stack([t.numpy() for t in traj_t], axis=1)
    assert got.shape == (65, 2)
    np.testing.assert_allclose(got, np.asarray(traj_j), rtol=1e-13)
    np.testing.assert_array_equal(np.array([v.item() for v in yf_t]),
                                  got[-1])


def test_rk4_trajectory_linear_equals_staged_and_jax():
    """A LinearRHS takes the tabled transfer-matrix path; batched initial
    states are independent columns."""
    def matrix(x):
        return 0.0, 1.0 + 0.5 * x, -(2.0 + torch.sin(x)), -0.1 * x

    rhs = ode.LinearRHS(matrix)
    y0 = _t([1.0, 0.0], [0.0, 1.0])
    _, lin = ode.rk4_trajectory(rhs, y0, 1.0, 0.001, 200)
    staged = tuple(np.stack(
        [t.numpy() for t in ode.rk4_trajectory(
            lambda x, y: rhs(x, y), _t(y0[0][c].item(), y0[1][c].item()),
            1.0, 0.001, 200)[1]], axis=1) for c in range(2))
    for c in range(2):
        got = np.stack([lin[0][:, c].numpy(), lin[1][:, c].numpy()], axis=1)
        np.testing.assert_allclose(got, staged[c], rtol=1e-12, atol=1e-14)

    def jrhs(x, y):
        return jnp.stack([(1.0 + 0.5 * x) * y[1],
                          -(2.0 + jnp.sin(x)) * y[0] - 0.1 * x * y[1]])

    _, want = jode.rk4_trajectory(jrhs, jnp.array([0.0, 1.0]), 1.0, 0.001,
                                  200)
    got = np.stack([lin[0][:, 1].numpy(), lin[1][:, 1].numpy()], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("form", ["flux", "shear"])
def test_rhs_forms_equal_jax(form):
    """make_flux_rhs / make_shear_rhs integrate as JAX's forms do."""
    make = (lambda m: m.slab_density_photospheric(0.9)) if form == "flux" \
        else (lambda m: m.slab_flow_gaussian_coronal())
    jph = JSlabPhysics.from_case(make(jcases))
    tph = SlabPhysics.from_case(make(cases))
    omega, k = (1.17, 1.5) if form == "flux" else (1.6, 1.0)
    jr = getattr(jph, f"make_{form}_rhs")(omega, k)
    tr = getattr(tph, f"make_{form}_rhs")(omega, k)
    _, want = jode.rk4_trajectory(jr, jnp.array([1.0, 0.0]), 0.0, 1.0,
                                  N_INT)
    _, got = ode.rk4_trajectory(tr, _t(1.0, 0.0), 0.0, 1.0, N_INT)
    got = np.stack([t.numpy() for t in got], axis=1)
    want = np.asarray(want)
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


SLABS = {  # name: (case factory, parity, omega, k)
    "flux kink": (lambda m: m.slab_density_photospheric(0.9), 1, 1.17, 1.5),
    "flux sausage": (lambda m: m.slab_density_photospheric(0.9), 0, 1.3,
                     1.5),
    "shear kink": (lambda m: m.slab_flow_gaussian_coronal(), 1, 1.6, 1.0),
    "shear sausage": (lambda m: m.slab_flow_gaussian_coronal(), 0, 1.6,
                      1.0),
}


@pytest.mark.parametrize("name", sorted(SLABS))
def test_reconstruct_slab_equals_jax(name):
    make, parity, omega, k = SLABS[name]
    want = jef.reconstruct_slab(make(jcases), parity, omega, k,
                                n_interior=N_INT)
    got = eigenfunctions.reconstruct_slab(make(cases), parity, omega, k,
                                          n_interior=N_INT, device="cpu")
    assert SlabPhysics.from_case(make(cases)).has_flow == name.startswith(
        "shear")
    _close(got, want, 1e-9)


def _cylinder(make):
    c = make(jcases)
    return dataclasses.replace(c, grid=dataclasses.replace(
        c.grid, n_interior=N_INT))


CYLINDERS = {  # name: (case factory, m, omega, k)
    "density kink": (lambda m: m.cylinder_density_coronal(0.9), 1, 0.95,
                     1.5),
    "twisted kink": (lambda m: m.cylinder_twisted_photospheric(0.1, 1.0, 1),
                     1, 1.0, 1.0),
}


@pytest.mark.parametrize("name", sorted(CYLINDERS))
def test_reconstruct_cylinder_equals_jax(name):
    make, m, omega, k = CYLINDERS[name]
    jcase = _cylinder(make)
    want = jef.reconstruct_cylinder(jcase, m, omega, k, n_interior=N_INT)
    got = eigenfunctions.reconstruct_cylinder(
        config.from_jax(jcase), m, omega, k, n_interior=N_INT, device="cpu")
    _close(got, want, 1e-9)
    # the twisted tube's rotation enters v_phi through d(v_phi/r)/dr
    if name.startswith("twisted"):
        assert np.max(np.abs(got.v_phi + got.omega * got.xi_phi)) > 1e-6


def test_slab_kink_uniform_mode_shape():
    """tests/test_eigenfunctions.py:86-99 on the port: the uniform slab's
    kink surface mode is vx ~ cosh(m0 x) inside. The root is the analytic
    relation's (the port's `analytic` module; the JAX test bisects its
    dispersion, 62 eager shoots here), held to the port's dispersion."""
    from eigensolver_tpu_torch.analytic import scan_relation, slab_relation
    case = cases.slab_density_photospheric(width=1e5)
    k = 1.5
    rg = case.regime
    v = scan_relation(lambda v: slab_relation(rg, v, k, 1), 1.115, 1.13)
    assert len(v) == 1
    om = float(v[0] * k)
    res = sweep.make_dispersion(case, 1, torch.float64)(*_t([om], [k]))
    assert float(res.mismatch_pct[0]) < 1e-4
    ef = eigenfunctions.reconstruct_slab(case, 1, om, k, device="cpu")
    m0 = np.sqrt((k**2 * rg.c_i0**2 - om**2) * (k**2 * rg.vA_i0**2 - om**2)
                 / ((rg.c_i0**2 + rg.vA_i0**2) * (k**2 * rg.cT_i0**2 - om**2)))
    inside = np.abs(ef.x) <= 1.0
    want = np.cosh(m0 * ef.x[inside])
    got = ef.vx[inside] / ef.vx[np.argmin(np.abs(ef.x))]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_normalised():
    ef = eigenfunctions.reconstruct_slab(cases.slab_density_photospheric(0.9),
                                         1, 1.17, 1.5, n_interior=64,
                                         device="cpu")
    n = ef.normalised()
    assert np.max(np.abs(n.xi_r)) == pytest.approx(1.0)
    np.testing.assert_allclose(n.vx * np.max(np.abs(ef.xi_r)), ef.vx)
