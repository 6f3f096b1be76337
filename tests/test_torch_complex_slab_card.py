"""The complex-omega slab kernels' flux form (B2-complex: csrc/
slab_complex.cu::flux_kernel<T, kNum>, one thread a seed) and numeric
exterior (B6-complex, both forms; in the shear form newton_kernel<T,
true>, whose consumer lane integrates it) on the card: each variant
bit-equal to its plain version in all three modes, the Newton rounds
(`slab_newton` against `search.newton_loop` over the plain dual shoot),
the value round of the Newton launch (final_eval, against the plain value
dispersion at its roots) and the evaluation mode (`slab_disp_complex`), at
ragged batch sizes (1, 13, 31, 33, 77, 8,191), at n_interior 2048 and 512
(where each step's first chain is the step before's last,
csrc/common.cuh::chain_reuse) and 250 (where it is not), with seeds set
exactly on the real axis and at |Im omega| = 1e-300 and 1e-310 (float32:
1e-38), where a divisor's ratio leaves CUDA's fast path of division
unless complex.cuh::fast_div keeps it there,
at float32 and float64; the flux kernel's kept chains by its own counts,
its registers and launch shape.

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


def draws(case, n, seed, dtype, edge=False):
    """n candidates as the sweep's seeds spread them: phase speeds over the
    case's speed edges, Im omega over +-imag_band, k over its k range,
    either parity; with `edge` every third on the real axis (Im 0, either
    sign of zero) and every third at the bottom of the type's exponent
    range (|Im| 1e-300 and, subnormal, 1e-310 in turns at float64; 1e-38
    at float32)."""
    rng = np.random.default_rng(seed)
    v = np.asarray(case.sorted_speeds())
    k = rng.uniform(case.k_min, case.k_max, n)
    re = rng.uniform(v[0], v[-1], n) * k
    im = rng.uniform(-case.imag_band, case.imag_band, n)
    par = rng.integers(0, 2, n).astype(np.float64)
    if edge:
        turns = np.arange(len(im[1::3])) % 2
        tiny = (np.where(turns, 1e-310, 1e-300) if dtype == torch.float64
                else 1e-38)
        im[0::3] = np.where(np.arange(len(im[0::3])) % 2, -0.0, 0.0)
        im[1::3] = tiny * np.sign(im[1::3])

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


@pytest.mark.parametrize("n", [1, 31, 33, 8191])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_variant_ragged_edge_seeds(name, dtype, n):
    """At n_interior 512 (a quarter of the depth, chains kept) on n seeds,
    a third of them on the real axis and a third at the bottom of the
    exponent range: one Newton step with the value round, and the
    evaluation mode at its roots, bit-equal to the plain versions."""
    case = variant(name, 512)
    params = kslab.disp_params(case, True)
    ph = SlabPhysics.from_case(case)
    om, k, par = draws(case, n, 17, dtype, edge=True)
    want = newton_loop(ph.make_dispersion_dual_plain(parity=None,
                                                     dtype=dtype),
                       om, k, par, 1)
    got, res = kslab.slab_newton(om, k, par, 1, 1.0, params, final_eval=True)
    torch.cuda.synchronize()
    assert same(got.re, want.re) and same(got.im, want.im)
    at_roots = ph.make_dispersion_plain(parity=None, dtype=dtype)(want, k,
                                                                   par)
    assert same_interface(res, at_roots)
    assert same_interface(kslab.slab_disp_complex(om, k, par, params),
                          ph.make_dispersion_plain(parity=None,
                                                   dtype=dtype)(om, k, par))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_flux_kernel_counts_and_attrs(dtype):
    """The flux kernel keeps, by its own counts (thread 0 of block 0 counts
    the steps whose first chain it kept, and its steps, per shoot), the
    chains flux_chain_kept says: every step's first but the first at 512
    steps, none at 250, in each of the 4 shoots of a launch of 2 Newton
    rounds and the value round and of an evaluation; its variants run at
    the launch shape they are built for, with a table of the bytes the
    Python mirror gives."""
    from eigensolver_tpu_torch.kernels import common
    for n_interior in (512, 250):
        case = variant("flux", n_interior)
        params = kslab.disp_params(case, True)
        om, k, par = draws(case, 40, 3, dtype)
        kslab.flux_counts("cuda")
        kslab.slab_newton(om, k, par, 2, 1.0, params, final_eval=True)
        kslab.slab_disp_complex(om, k, par, params)
        kept = int(kslab.flux_chain_kept(n_interior).sum())
        assert kslab.flux_counts("cuda") == dict(kept=4 * kept,
                                                 steps=4 * n_interior)
    shape = common.FLUX_NEWTON_SHAPE[dtype]
    for numeric in (False, True):
        a = kslab.flux_attrs(dtype, numeric)
        assert (a["threads"], a["min_blocks"], a["chunk"]) == \
            (shape.threads, shape.min_blocks, shape.chunk)
        assert a["blocks_per_sm"] >= shape.min_blocks
        assert a["smem"] == common.flux_newton_smem(dtype, shape.chunk)
