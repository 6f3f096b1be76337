"""The pipeline of the port on a CUDA card (marked `gpu`; skipped without
one): the checkpointed sweeps against run_case / run_case_complex on the
card, and the eigenfunctions on the card against the same calls on the
CPU. Imports nothing of JAX: the CPU tests (test_torch_checkpoint.py,
test_torch_eigenfunctions.py) hold the port to the JAX package."""

import numpy as np
import pytest
import torch

from eigensolver_tpu_torch import cases, eigenfunctions, sweep
from eigensolver_tpu_torch.kernels import launch_counts
from eigensolver_tpu_torch.search import SearchConfig

pytestmark = [pytest.mark.gpu, pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA card")]

FIELDS = ("x", "P_T", "xi_r", "vx", "xi_phi", "xi_z", "v_r", "v_phi", "v_z")


def _equal(got, want, rtol, imag=False):
    assert got.counts() == want.counts()
    for b in want.branches:
        og = np.lexsort((got[b].omegas, got[b].ks))
        ow = np.lexsort((want[b].omegas, want[b].ks))
        np.testing.assert_array_equal(got[b].ks[og], want[b].ks[ow])
        np.testing.assert_allclose(got[b].omegas[og], want[b].omegas[ow],
                                   rtol=rtol)
        if imag:
            np.testing.assert_allclose(got[b].omegas_imag[og],
                                       want[b].omegas_imag[ow], rtol=rtol,
                                       atol=1e-15)


def test_checkpointed_slab_equals_run_case(tmp_path):
    """slab_ph_09 at float32 in blocks of 8 k (5 blocks, 2 launches each)
    gives run_case's roots; a resume launches nothing."""
    case = cases.slab_density_photospheric(0.9)
    cfg = SearchConfig(n_omega=256, n_bisect=18, scan_dtype="float32",
                       polish_dtype="float32")
    ref, _ = sweep.run_case(case, cfg, device="cuda")
    path = str(tmp_path / "s.eigr")
    before = launch_counts()
    ck, _ = sweep.run_case_checkpointed(case, cfg, checkpoint_path=path,
                                        device="cuda")
    after = launch_counts()
    assert after["slab_disp"] - before["slab_disp"] == 5
    assert after["slab_bisect"] - before["slab_bisect"] == 5
    _equal(ck, ref, rtol=1e-12)
    again, st = sweep.run_case_checkpointed(case, cfg, checkpoint_path=path,
                                            device="cuda")
    assert launch_counts() == after and st.n_candidates == 0
    _equal(again, ck, rtol=0)


def test_checkpointed_kh_equals_run_case_complex(tmp_path):
    """kh_w1e5 (float64) in blocks of 8 k (3 slab_newton launches) gives
    run_case_complex's 49 roots and growth rates."""
    case = cases.slab_flow_complex_coronal()
    kw = dict(n_re=12, n_im=10, newton_iters=30)
    ref, _ = sweep.run_case_complex(case, **kw, check_completeness=False,
                                    device="cuda")
    before = launch_counts()
    ck, _ = sweep.run_case_complex_checkpointed(
        case, checkpoint_path=str(tmp_path / "kh.eigr"), **kw,
        device="cuda")
    assert launch_counts()["slab_newton"] - before["slab_newton"] == 3
    assert ck.counts() == {"kink": 49}
    _equal(ck, ref, rtol=1e-12, imag=True)


EIGEN = {  # name: (reconstruct, case, mode, omega, k)
    "flux kink": (eigenfunctions.reconstruct_slab,
                  cases.slab_density_photospheric(0.9), 1, 1.17, 1.5),
    "flux sausage": (eigenfunctions.reconstruct_slab,
                     cases.slab_density_photospheric(0.9), 0, 1.3, 1.5),
    "shear kink": (eigenfunctions.reconstruct_slab,
                   cases.slab_flow_gaussian_coronal(), 1, 1.6, 1.0),
    "shear sausage": (eigenfunctions.reconstruct_slab,
                      cases.slab_flow_gaussian_coronal(), 0, 1.6, 1.0),
    "density kink": (eigenfunctions.reconstruct_cylinder,
                     cases.cylinder_density_coronal(0.9), 1, 0.95, 1.5),
    "twisted kink": (eigenfunctions.reconstruct_cylinder,
                     cases.cylinder_twisted_photospheric(0.1, 1.0, 1), 1,
                     1.0, 1.0),
}


def _close(got, want, rel, sel=slice(None)):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
            continue
        assert g.shape == w.shape, f
        scale = np.max(np.abs(w))
        err = np.max(np.abs(g - w)[sel])
        assert err <= rel * scale, (f, err / scale)


@pytest.mark.parametrize("name", sorted(EIGEN))
def test_eigenfunctions_equal_cpu(name):
    """The shoots on the card equal the CPU's within 1e-10 of each field's
    largest value, 1e-9 at a cylinder's points within 10 axis cutoffs of
    the axis: the same operations, but the card's exp differs from the
    CPU's in the last bit on ~8% of arguments, and at the axis cutoff the
    axis-regular combination of the two basis solutions amplifies that
    ~1e6-fold (the Gaussian tube's xi_r there: ~1.3e-10)."""
    fn, case, mode, omega, k = EIGEN[name]
    cpu = fn(case, mode, omega, k, device="cpu")
    card = fn(case, mode, omega, k, device="cuda")
    assert (card.omega, card.k, card.i_boundary) == \
        (cpu.omega, cpu.k, cpu.i_boundary)
    _close(card, cpu, 1e-9)
    off = np.ones(len(cpu.x), bool)
    if fn is eigenfunctions.reconstruct_cylinder:
        off = cpu.x >= 10 * case.grid.axis_epsilon
    _close(card, cpu, 1e-10, off)
