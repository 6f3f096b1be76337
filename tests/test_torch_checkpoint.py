"""Crash-safe sweeps of the port (`sweep.run_case_checkpointed`,
`run_case_complex_checkpointed`) on the CPU, on the configurations of the
JAX package's tests/test_checkpoint.py (`_case()`, `_complex_case()`),
with the interior cut to n_interior=64 (real) and 32 (complex) so that the
plain eager version runs in seconds (the JAX tests are all `slow`).

Held: the checkpointed sweep equals the port's run_case / run_case_complex
(rtol 1e-12; Im omega atol 1e-15 besides), which equals the JAX package's
on the same configuration (rtol 1e-10: both bisect the same brackets /
iterate the same seeds in float64); a resume of a finished store evaluates
no candidate (no dispersion call); a sweep stopped after its first block
and resumed on the same store gives the same roots. The JAX side runs once
per configuration, in a module fixture."""
import dataclasses

import numpy as np
import pytest

from eigensolver_tpu import sweep as jsweep
from eigensolver_tpu.search import SearchConfig as JSearchConfig
from eigensolver_tpu_torch import config, sweep
from eigensolver_tpu_torch.physics import slab as pslab
from eigensolver_tpu_torch.search import SearchConfig

from test_checkpoint import _case, _complex_case

CFG = dict(n_omega=96, n_bisect=45)
CX = dict(n_re=6, n_im=4, newton_iters=25)


def _cut(case, n_interior):
    return dataclasses.replace(case, grid=dataclasses.replace(
        case.grid, n_interior=n_interior))


def _equal(got, want, rtol, imag=False):
    assert got.counts() == want.counts()
    for b in want.branches:
        order_g = np.lexsort((got[b].omegas, got[b].ks))
        order_w = np.lexsort((want[b].omegas, want[b].ks))
        np.testing.assert_array_equal(got[b].ks[order_g], want[b].ks[order_w])
        np.testing.assert_allclose(got[b].omegas[order_g],
                                   want[b].omegas[order_w], rtol=rtol)
        if imag:
            np.testing.assert_allclose(got[b].omegas_imag[order_g],
                                       want[b].omegas_imag[order_w],
                                       rtol=rtol, atol=1e-15)


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    jcase = _cut(_case(), 64)
    case = config.from_jax(jcase)
    jrs, _ = jsweep.run_case(jcase, JSearchConfig(**CFG))
    rs, _ = sweep.run_case(case, SearchConfig(**CFG), device="cpu")
    path = str(tmp_path_factory.mktemp("ck") / "sweep.eigr")
    ck, st = sweep.run_case_checkpointed(case, SearchConfig(**CFG),
                                         checkpoint_path=path, k_block=3,
                                         device="cpu")
    return case, jrs, rs, ck, st, path


def test_checkpointed_equals_run_case_and_jax(real):
    case, jrs, rs, ck, st, _ = real
    assert sum(rs.counts().values()) > 5
    _equal(ck, rs, rtol=1e-12)
    _equal(rs, jrs, rtol=1e-10)
    # 6 k in 2 blocks of 3, both modes: every ladder candidate once
    assert st.n_candidates == 6 * 3 * 2 * CFG["n_omega"]
    assert st.n_roots == sum(ck.counts().values())


def test_resume_evaluates_nothing(real):
    case, _, _, ck, _, path = real
    before = pslab.plain_calls
    again, st = sweep.run_case_checkpointed(case, SearchConfig(**CFG),
                                            checkpoint_path=path, k_block=3,
                                            device="cpu")
    assert st.n_candidates == 0 and st.n_roots == 0
    assert pslab.plain_calls == before
    _equal(again, ck, rtol=0)


def test_kill_and_resume(real, tmp_path):
    case, _, _, ck, _, _ = real
    path = str(tmp_path / "killed.eigr")
    first = dataclasses.replace(case, k_values=tuple(case.k_grid()[:3]))
    _, st1 = sweep.run_case_checkpointed(first, SearchConfig(**CFG),
                                         checkpoint_path=path, k_block=3,
                                         device="cpu")
    done, st2 = sweep.run_case_checkpointed(case, SearchConfig(**CFG),
                                            checkpoint_path=path, k_block=3,
                                            device="cpu")
    # the durable first block is not evaluated again
    assert st1.n_candidates == st2.n_candidates == 3 * 3 * 2 * CFG["n_omega"]
    _equal(done, ck, rtol=0)


@pytest.fixture(scope="module")
def complex_(tmp_path_factory):
    jcase = _cut(_complex_case(), 32)
    case = config.from_jax(jcase)
    jrs, _ = jsweep.run_case_complex(jcase, **CX, check_completeness=False)
    rs, _ = sweep.run_case_complex(case, **CX, check_completeness=False,
                                   device="cpu")
    # stopped after the first block of 2 k, then resumed to the end
    path = str(tmp_path_factory.mktemp("kh") / "kh.eigr")
    first = dataclasses.replace(case, k_values=tuple(case.k_grid()[:2]))
    _, st1 = sweep.run_case_complex_checkpointed(
        first, checkpoint_path=path, k_block=2, **CX, device="cpu")
    ck, st2 = sweep.run_case_complex_checkpointed(
        case, checkpoint_path=path, k_block=2, **CX, device="cpu")
    return case, jrs, rs, ck, (st1, st2), path


def test_complex_kill_resume_equals_run_case_and_jax(complex_):
    _, jrs, rs, ck, (st1, st2), _ = complex_
    assert len(rs["kink"]) > 5
    assert np.abs(rs["kink"].omegas_imag).max() > 1e-2   # growing modes
    _equal(ck, rs, rtol=1e-12, imag=True)
    _equal(rs, jrs, rtol=1e-10, imag=True)
    # 2 blocks of 2 k x 3 bands x 24 seeds, each evaluated once
    assert st1.n_candidates == st2.n_candidates == 2 * 3 * 6 * 4
    assert st1.completeness is None


def test_complex_resume_evaluates_nothing(complex_):
    case, _, _, ck, _, path = complex_
    before = pslab.plain_calls
    again, st = sweep.run_case_complex_checkpointed(
        case, checkpoint_path=path, k_block=2, **CX, device="cpu")
    assert st.n_candidates == 0 and pslab.plain_calls == before
    _equal(again, ck, rtol=0, imag=True)


def test_complex_checkpoint_refuses_a_real_case(tmp_path):
    with pytest.raises(ValueError, match="complex_omega"):
        sweep.run_case_complex_checkpointed(
            config.from_jax(_case()), checkpoint_path=str(tmp_path / "x"),
            device="cpu")
