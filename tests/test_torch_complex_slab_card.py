"""The complex-omega kernel's flux form (B2-complex) and numeric exterior
(B6-complex, both forms) on the card (csrc/slab_complex.cu, newton_kernel<T,
kShear, kNum>): each variant bit-equal to its plain version in all three
modes, the Newton rounds (`slab_newton` against `search.newton_loop` over
the plain dual shoot), the value round of the Newton launch (final_eval,
against the plain value dispersion at its roots) and the evaluation mode
(`slab_disp_complex`), at ragged batch sizes, at n_interior 2048 (where each
step's first chain is the step before's last, csrc/common.cuh::chain_reuse)
and 250 (where it is not), at float32 and float64.

The plain versions run eagerly on the card, some thousand launches a step:
the batches are small.
"""
import dataclasses

import numpy as np
import pytest
import torch

from eigensolver_tpu_torch import cases
from eigensolver_tpu_torch.cplx import C
from eigensolver_tpu_torch.kernels import slab as kslab
from eigensolver_tpu_torch.physics.slab import SlabPhysics
from eigensolver_tpu_torch.search import newton_loop

# name: (case factory, its keyword, exterior_method)
VARIANTS = {
    "flux": ("slab_density_photospheric", dict(width=0.9), "bessel"),
    "flux_numeric": ("slab_density_photospheric", dict(width=0.9),
                     "numeric"),
    "shear_numeric": ("slab_flow_complex_coronal", dict(width=1.0),
                      "numeric"),
}


def variant(name, n_interior):
    fac, kw, exterior = VARIANTS[name]
    c = getattr(cases, fac)(**kw)
    return dataclasses.replace(c, complex_omega=True, grid=dataclasses.replace(
        c.grid, n_interior=n_interior, exterior_method=exterior))


def draws(case, n, seed, dtype):
    """n candidates as the sweep's seeds spread them: phase speeds over the
    case's speed edges, Im omega over +-imag_band, k over its k range,
    either parity."""
    rng = np.random.default_rng(seed)
    v = np.asarray(case.sorted_speeds())
    k = rng.uniform(case.k_min, case.k_max, n)
    re = rng.uniform(v[0], v[-1], n) * k
    im = rng.uniform(-case.imag_band, case.imag_band, n)
    par = rng.integers(0, 2, n).astype(np.float64)

    def t(a):
        return torch.from_numpy(a).to("cuda", dtype)
    return C(t(re), t(im)), t(k), t(par)


def bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def same(a, b):
    return torch.equal(bits(a), bits(b))


def same_interface(got, want):
    return (same(got.det.re, want.det.re) and same(got.det.im, want.det.im)
            and same(got.mismatch_pct, want.mismatch_pct)
            and torch.equal(got.valid, want.valid))


@pytest.mark.parametrize("n_interior", [2048, 250])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_variant_bit_equal_in_every_mode(name, dtype, n_interior):
    """One Newton step with the value round in the launch, then the
    evaluation mode at its roots, on 77 seeds (three blocks, the last
    ragged); and the evaluation mode on 13 (under one block)."""
    case = variant(name, n_interior)
    params = kslab.disp_params(case, True)
    ph = SlabPhysics.from_case(case)
    om, k, par = draws(case, 77, 5, dtype)
    dual = ph.make_dispersion_dual_plain(parity=None, dtype=dtype)
    plain = ph.make_dispersion_plain(parity=None, dtype=dtype)
    want = newton_loop(dual, om, k, par, 1)
    before = (kslab.complex_flux_launches, kslab.complex_numeric_launches)
    got, res = kslab.slab_newton(om, k, par, 1, 1.0, params, final_eval=True)
    torch.cuda.synchronize()
    assert same(got.re, want.re) and same(got.im, want.im)
    assert torch.isfinite(got.re).float().mean() > 0.9
    at_roots = plain(want, k, par)
    assert same_interface(res, at_roots)
    assert same_interface(kslab.slab_disp_complex(got, k, par, params),
                          at_roots)
    om13, k13, par13 = draws(case, 13, 7, dtype)
    assert same_interface(kslab.slab_disp_complex(om13, k13, par13, params),
                          plain(om13, k13, par13))
    flux, numeric = name.startswith("flux"), name.endswith("numeric")
    assert (kslab.complex_flux_launches - before[0],
            kslab.complex_numeric_launches - before[1]) == \
        (3 * flux, 3 * numeric)


@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_variant_fused_equals_chained(name):
    """30 Newton steps in one launch equal 30 chained one-step launches,
    and the launch's value round the evaluation mode at its roots, at
    float64 (n_interior=256)."""
    case = variant(name, 256)
    params = kslab.disp_params(case, True)
    om, k, par = draws(case, 200, 9, torch.float64)
    chained = om
    for _ in range(30):
        chained = kslab.slab_newton(chained, k, par, 1, 1.0, params)
    fused, res = kslab.slab_newton(om, k, par, 30, 1.0, params,
                                   final_eval=True)
    torch.cuda.synchronize()
    assert same(fused.re, chained.re) and same(fused.im, chained.im)
    assert same_interface(res, kslab.slab_disp_complex(fused, k, par, params))
