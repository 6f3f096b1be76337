"""The complex-omega kernel on the card (csrc/slab_complex.cu, one
producer/consumer kernel): `slab_disp_complex` (B5-complex, its evaluation
mode) bit-equal to its plain version and `slab_newton` (B7) bit-equal to
the plain Newton loop over the dual shoot, at float32 and float64, on
ragged batches; n_iter fused steps bit-equal to as many chained one-step
launches; the final evaluation in the Newton launch bit-equal to the plain
value dispersion at the roots; other block shapes alike; the dtypes,
configurations and shapes they refuse.

Reduced depth (n_interior=256): the plain versions run eagerly on the card,
some thousand launches a step.
"""
import dataclasses

import numpy as np
import pytest
import torch

from eigensolver_tpu_torch import cases
from eigensolver_tpu_torch.cplx import C
from eigensolver_tpu_torch.kernels import common as kcommon
from eigensolver_tpu_torch.kernels import slab as kslab
from eigensolver_tpu_torch.physics.slab import SlabPhysics
from eigensolver_tpu_torch.search import newton_loop


def reduced(width, n_interior=256, **fields):
    c = cases.slab_flow_complex_coronal(width=width)
    return dataclasses.replace(
        c, grid=dataclasses.replace(c.grid, n_interior=n_interior), **fields)


def draws(n, seed, dtype, device="cuda"):
    """n candidates as the sweep's seeds and contours spread them: phase
    speeds over the speed edges (-0.5, 1), Im omega over [-0.75, 0.75], k
    over [0.01, 2.5], either parity."""
    rng = np.random.default_rng(seed)
    k = rng.uniform(0.01, 2.5, n)
    re = rng.uniform(-0.5, 1.0, n) * k
    im = rng.uniform(-0.75, 0.75, n)
    par = rng.integers(0, 2, n).astype(np.float64)

    def t(a):
        return torch.from_numpy(a).to(device, dtype)
    return C(t(re), t(im)), t(k), t(par)


def bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def same(a, b):
    return torch.equal(bits(a), bits(b))


CONFIGS = {
    "uniform": dict(width=1e5),
    "layer": dict(width=1.0),
    "layer_legacy_D": dict(width=1.0, shear_D_legacy=True),
    "layer_no_shear_pressure": dict(width=1.0),
}


def params_of(name):
    kw = dict(CONFIGS[name])
    case = reduced(kw.pop("width"), **kw)
    sp = name != "layer_no_shear_pressure"
    return case, kslab.disp_params(case, sp), sp


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_disp_complex_bit_equal(name, dtype):
    case, params, sp = params_of(name)
    om, k, par = draws(1000, 3, dtype)
    plain = SlabPhysics.from_case(case).make_dispersion_plain(
        parity=None, dtype=dtype, include_shear_pressure=sp)(om, k, par)
    assert torch.isfinite(plain.det.re).float().mean() > 0.9
    got = kslab.slab_disp_complex(om, k, par, params)
    torch.cuda.synchronize()
    assert same(got.det.re, plain.det.re)
    assert same(got.det.im, plain.det.im)
    assert same(got.mismatch_pct, plain.mismatch_pct)
    assert torch.equal(got.valid, plain.valid)
    whole = kslab.slab_disp_complex(om.complex(), k, par, params)
    assert same(whole.det.re, plain.det.re)
    assert same(whole.det.im, plain.det.im)


def plain_disp(name, dtype):
    case, _, sp = params_of(name)
    return SlabPhysics.from_case(case).make_dispersion_plain(
        parity=None, dtype=dtype, include_shear_pressure=sp)


def same_interface(got, want):
    return (same(got.det.re, want.det.re) and same(got.det.im, want.det.im)
            and same(got.mismatch_pct, want.mismatch_pct)
            and torch.equal(got.valid, want.valid))


@pytest.mark.parametrize("n", [13, 1001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_eval_mode_ragged_bit_equal(n, dtype):
    """The evaluation mode on a batch below one block (13 < B) and on one
    that is not a multiple of B (1001), with the shear-pressure layer, at
    a power-of-two depth and at another."""
    om, k, par = draws(n, 11, dtype)
    assert kcommon.complex_spec_shape(dtype).seeds == 32
    for n_interior in (256, 250):
        case = reduced(1.0, n_interior)
        got = kslab.slab_disp_complex(om, k, par,
                                      kslab.disp_params(case, True))
        plain = SlabPhysics.from_case(case).make_dispersion_plain(
            parity=None, dtype=dtype, include_shear_pressure=True)
        assert same_interface(got, plain(om, k, par)), n_interior


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_fused_equals_chained_and_final_eval(dtype):
    """30 Newton steps in one launch equal 30 chained one-step launches bit
    for bit, and the value round of the same launch (final_eval) equals
    the plain value dispersion at the roots."""
    _, params, _ = params_of("layer")
    om, k, par = draws(333, 7, dtype)
    chained = om
    for _ in range(30):
        chained = kslab.slab_newton(chained, k, par, 1, 1.0, params)
    fused, res = kslab.slab_newton(om, k, par, 30, 1.0, params,
                                   final_eval=True)
    torch.cuda.synchronize()
    assert same(fused.re, chained.re) and same(fused.im, chained.im)
    assert torch.isfinite(fused.re).float().mean() > 0.9
    assert same_interface(res, plain_disp("layer", dtype)(fused, k, par))


@pytest.mark.parametrize("n_interior", [256, 250])
@pytest.mark.parametrize("n_iter", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_newton_bit_equal(n_iter, dtype, n_interior):
    """At a power-of-two depth, where each step's first chain is the step
    before's last (csrc/common.cuh::chain_reuse), and at another."""
    case = reduced(1.0, n_interior)
    params = kslab.disp_params(case, True)
    om, k, par = draws(300, 5, dtype)
    dual = SlabPhysics.from_case(case).make_dispersion_dual_plain(
        parity=None, dtype=dtype)
    want = newton_loop(dual, om, k, par, n_iter)
    got = kslab.slab_newton(om, k, par, n_iter, 1.0, params)
    torch.cuda.synchronize()
    assert same(got.re, want.re) and same(got.im, want.im)
    assert torch.isfinite(got.re).float().mean() > 0.9


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_newton_legacy_and_damped_bit_equal():
    """The legacy D with damping, at the default block shape and at others:
    another stage length, fewer seeds a block, a stage that does not divide
    the steps, more stages; the final evaluation alike."""
    case, params, _ = params_of("layer_legacy_D")
    om, k, par = draws(77, 9, torch.float64)
    dual = SlabPhysics.from_case(case).make_dispersion_dual_plain(
        parity=None, dtype=torch.float64)
    want = newton_loop(dual, om, k, par, 2, damping=0.5)
    plain = plain_disp("layer_legacy_D", torch.float64)(want, k, par)
    got = kslab.slab_newton(om, k, par, 2, 0.5, params)
    assert same(got.re, want.re) and same(got.im, want.im)
    shapes = [kcommon.ComplexShape(32, 8, 2), kcommon.ComplexShape(8, 5, 3),
              kcommon.ComplexShape(16, 7, 4)]
    for shape in shapes:
        got, res = kslab.slab_newton(om, k, par, 2, 0.5, params,
                                     final_eval=True, shape=shape)
        assert same(got.re, want.re) and same(got.im, want.im), shape
        assert same_interface(res, plain), shape


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_refused_on_the_card():
    case, params, _ = params_of("layer")
    om, k, par = draws(64, 1, torch.float64)
    half = C(om.re.half(), om.im.half())
    with pytest.raises(TypeError, match="float32/float64"):
        kslab.slab_disp_complex(half, k.half(), par.half(), params)
    with pytest.raises(TypeError, match="float32/float64"):
        kslab.slab_newton(half, k.half(), par.half(), 1, 1.0, params)
    with pytest.raises(ValueError, match="must match"):
        kslab.slab_disp_complex(om, k.float(), par, params)
    strided = C(om.re[::2], om.im[::2])
    with pytest.raises(ValueError, match="contiguous"):
        kslab.slab_disp_complex(strided, k[::2], par[::2], params)
    numeric = dataclasses.replace(case, grid=dataclasses.replace(
        case.grid, exterior_method="numeric"))
    with pytest.raises(ValueError, match="exact exterior"):
        kslab.slab_disp_complex(om, k, par, kslab.disp_params(numeric, True))
    for shape in ((24, 8, 2), (32, 0, 2), (32, 8, 7), (32, 200, 2)):
        with pytest.raises(ValueError, match="block shape"):
            kslab.slab_newton(om, k, par, 1, 1.0, params,
                              shape=kcommon.ComplexShape(*shape))
