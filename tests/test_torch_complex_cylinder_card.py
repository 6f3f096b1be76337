"""The complex-omega cylinder kernel on the card (csrc/cylinder_complex.cu,
newton_kernel<T, kTw, kNum>): every variant bit-equal to its plain version
in all three modes, the Newton rounds (`cylinder_newton` against
`search.newton_loop` over the plain dual shoot), the value round of the
Newton launch (final_eval, against the plain value dispersion at its
roots) and the evaluation mode (`cylinder_disp_complex`), at ragged batch
sizes, at float32 and float64: the density and axial-flow chains
(B4-complex) with the K_m ratio at complex z (B1) or the numeric exterior
(B6-complex), and the twisted chains (B4-twisted at complex omega, the
rotational and the magnetic twist) with either exterior; and the K_m ratio
at complex z launched alone (`kernels.bessel.kve_ratio_complex`) against
`special.kve_ratio_both_c` on both sides of |z| = 2 and near the imaginary
axis.

The plain versions run eagerly on the card, some thousand launches a step:
the depth is reduced (n_interior 256, n_axis_log 32, n_exterior 128) and
the batches are small.
"""
import dataclasses

import numpy as np
import pytest
import torch

from eigensolver_tpu_torch import cases
from eigensolver_tpu_torch.cplx import C
from eigensolver_tpu_torch.kernels import cylinder as kcyl
from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
from eigensolver_tpu_torch.search import newton_loop

# name: (case factory, its keywords, exterior_method)
VARIANTS = {
    "density": ("cylinder_density_coronal", dict(width=0.9), "bessel"),
    "flow": ("cylinder_flow_coronal", dict(U=1.0), "bessel"),
    "density_numeric": ("cylinder_density_coronal", dict(width=0.9),
                        "numeric"),
    "twist": ("cylinder_twisted_photospheric",
              dict(v_twist=0.1, power=1.0, mode=1), "bessel"),
    "magnetic": ("cylinder_twisted_magnetic",
                 dict(B_twist=0.1, v_twist=0.15, power=1.25, mode=1),
                 "bessel"),
    "twist_numeric": ("cylinder_twisted_photospheric",
                      dict(v_twist=0.1, power=1.0, mode=1), "numeric"),
}


def variant(name):
    fac, kw, exterior = VARIANTS[name]
    c = getattr(cases, fac)(**kw)
    return dataclasses.replace(c, complex_omega=True, grid=dataclasses.replace(
        c.grid, n_interior=256, n_axis_log=32, n_exterior=128,
        exterior_method=exterior))


def draws(case, n, seed, dtype):
    """n seeds as the sweep spreads them: phase speeds over the case's
    speed edges, Im omega over +-imag_band, k over its k range, m 0 or 1."""
    rng = np.random.default_rng(seed)
    v = np.asarray(case.sorted_speeds())
    k = rng.uniform(case.k_min, case.k_max, n)
    re = rng.uniform(v[0], v[-1], n) * k
    im = rng.uniform(-case.imag_band, case.imag_band, n)
    m = rng.integers(0, 2, n).astype(np.float64)

    def t(a):
        return torch.from_numpy(a).to("cuda", dtype)
    return C(t(re), t(im)), t(k), t(m)


def bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def same(a, b):
    return torch.equal(bits(a), bits(b))


def same_interface(got, want):
    return (same(got.det.re, want.det.re) and same(got.det.im, want.det.im)
            and same(got.mismatch_pct, want.mismatch_pct)
            and torch.equal(got.valid, want.valid))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_variant_bit_equal_in_every_mode(name, dtype):
    """Two Newton steps with the value round in the launch, then the
    evaluation mode at its roots, on 133 seeds (two blocks, the last
    ragged); and the evaluation mode on 13."""
    case = variant(name)
    params = kcyl.disp_params(case)
    ph = CylinderPhysics.from_case(case)
    om, k, m = draws(case, 133, 5, dtype)
    dual = ph.make_dispersion_dual_plain(m=None, dtype=dtype)
    plain = ph.make_dispersion_plain(m=None, dtype=dtype)
    want = newton_loop(dual, om, k, m, 2)
    before = (kcyl.complex_twisted_launches, kcyl.complex_numeric_launches)
    got, res = kcyl.cylinder_newton(om, k, m, 2, 1.0, params,
                                    final_eval=True)
    torch.cuda.synchronize()
    assert same(got.re, want.re) and same(got.im, want.im)
    assert torch.isfinite(got.re).float().mean() > 0.9
    at_roots = plain(want, k, m)
    assert same_interface(res, at_roots)
    assert same_interface(kcyl.cylinder_disp_complex(got, k, m, params),
                          at_roots)
    om13, k13, m13 = draws(case, 13, 7, dtype)
    assert same_interface(kcyl.cylinder_disp_complex(om13, k13, m13, params),
                          plain(om13, k13, m13))
    twisted, numeric = name.startswith(("twist", "magnetic")), \
        name.endswith("numeric")
    assert (kcyl.complex_twisted_launches - before[0],
            kcyl.complex_numeric_launches - before[1]) == \
        (3 * twisted, 3 * numeric)


@pytest.mark.parametrize("name", ["density", "twist"])
@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_fused_equals_chained(name):
    """10 Newton steps in one launch equal 10 chained one-step launches,
    and the launch's value round the evaluation mode at its roots, at
    float64."""
    case = variant(name)
    params = kcyl.disp_params(case)
    om, k, m = draws(case, 300, 9, torch.float64)
    chained = om
    for _ in range(10):
        chained = kcyl.cylinder_newton(chained, k, m, 1, 1.0, params)
    fused, res = kcyl.cylinder_newton(om, k, m, 10, 1.0, params,
                                      final_eval=True)
    torch.cuda.synchronize()
    assert same(fused.re, chained.re) and same(fused.im, chained.im)
    assert same_interface(res,
                          kcyl.cylinder_disp_complex(fused, k, m, params))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_kve_ratio_complex_bit_equal(dtype):
    """B1 at complex z alone: 2,001 arguments with Re z > 0 (moduli from
    0.05 to 12, arguments to within 1e-3 of +-pi/2), m 0 or 1, bit-equal to
    the plain version on the card."""
    from eigensolver_tpu_torch import special
    from eigensolver_tpu_torch.cplx import where
    from eigensolver_tpu_torch.kernels import bessel
    rng = np.random.default_rng(13)
    n = 2001
    r = rng.uniform(0.05, 12.0, n)
    th = rng.uniform(-1.0, 1.0, n) * (np.pi / 2 - 1e-3)
    z = C(torch.from_numpy(r * np.cos(th)).to("cuda", dtype),
          torch.from_numpy(r * np.sin(th)).to("cuda", dtype))
    m = torch.from_numpy(rng.integers(0, 2, n).astype(np.float64)).to(
        "cuda", dtype)
    before = bessel.complex_launches
    got = bessel.kve_ratio_complex(z, m)
    r0, r1 = special.kve_ratio_both_c(z)
    want = where(m < 0.5, r0, r1)
    torch.cuda.synchronize()
    assert bessel.complex_launches - before == 1
    assert same(got.re, want.re) and same(got.im, want.im)
    assert torch.isfinite(got.re).all()
