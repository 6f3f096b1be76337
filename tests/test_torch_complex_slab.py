"""Complex omega on the slab beyond the Kelvin-Helmholtz case: the flux
form (density slabs) and the numeric exterior (both forms), against the
JAX package on the CPU in float64, at a reduced depth:

- the plain complex dispersion (`make_dispersion_plain` at complex omega)
  against the JAX disp, both parities: det to rtol 1e-11 (points within
  1e-6 of a pole, |det| > 1e6 x the median, masked), the mismatch to
  1e-9, valid equal; the dual shoot's value equal to it bit for bit, its
  d det / d omega against jax.jvp to rtol 1e-9;
- `run_case_complex` of the density slab, with either exterior, and of the
  KH slab with the numeric one, reduced (n_k=2, n_interior=128, 4 x 3
  seeds, 10 Newton steps), against the JAX package's: counts and audit
  equal, roots within 1e-10 relative;
- the full-size JAX targets that `chip_smoke.py` holds
  (tools_torch/cx_slab.py) consistent with themselves, and the operation
  counts of chip_smoke.py's bounds those tools_torch/count_ops.py traces.

`python tests/test_torch_complex_slab.py jax-counts NAME [--k-stride N]`
takes those targets: the JAX package's full-size sweep on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools_torch import cx_slab, kh  # noqa: E402

MODE_NAMES = {0: "sausage", 1: "kink"}
N_INTERIOR = 128


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def _cases(name, **case_kw):
    """(JAX case, port case) of a cx_slab configuration, reduced."""
    from eigensolver_tpu import cases as jcases
    from eigensolver_tpu_torch import config
    jcase, _ = cx_slab.configure(name, jcases, n_interior=N_INTERIOR,
                                 **case_kw)
    return jcase, config.from_jax(jcase)


def _draws(case, n, seed):
    """n candidates over the case's speed edges and k range, Im omega
    within +-0.3 (numpy, complex128)."""
    rng = np.random.default_rng(seed)
    v = np.asarray(case.sorted_speeds())
    k = rng.uniform(case.k_min, case.k_max, n)
    om = (rng.uniform(v[0], v[-1], n) + 1j * rng.uniform(-0.3, 0.3, n)) * k
    return om, k


def _pair(om):
    from eigensolver_tpu_torch.cplx import C
    return C(torch.from_numpy(om.real.copy()),
             torch.from_numpy(om.imag.copy()))


def _np(z):
    out = np.empty(z.re.shape, np.complex128)
    out.real, out.imag = z.re.numpy(), z.im.numpy()
    return out


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("name", sorted(cx_slab.CONFIGS))
def test_dispersion_and_dual_equal_jax(name, parity):
    jax = _jax()
    import jax.numpy as jnp
    from eigensolver_tpu.physics.slab import SlabPhysics as JPhysics
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    jcase, case = _cases(name)
    om, k = _draws(case, 64, 3 + parity)
    jd = JPhysics.from_case(jcase).make_dispersion(parity=parity)
    want = jax.jit(jax.vmap(jd))(jnp.asarray(om), jnp.asarray(k))
    _, jdd = jax.jit(jax.vmap(lambda o, kk: jax.jvp(
        lambda oo: jd(oo, kk).det, (o,), (jnp.ones_like(o),))))(
            jnp.asarray(om), jnp.asarray(k))
    ph = SlabPhysics.from_case(case)
    got = ph.make_dispersion_plain(parity=parity)(_pair(om),
                                                  torch.from_numpy(k))
    det, jdet = _np(got.det), np.asarray(want.det)
    keep = np.abs(jdet) < 1e6 * np.median(np.abs(jdet))
    assert keep.mean() > 0.9
    np.testing.assert_allclose(det[keep], jdet[keep], rtol=1e-11)
    np.testing.assert_allclose(got.mismatch_pct.numpy()[keep],
                               np.asarray(want.mismatch_pct)[keep],
                               rtol=1e-9)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    d, dd = ph.make_dispersion_dual_plain(parity=parity)(
        _pair(om), torch.from_numpy(k))
    np.testing.assert_array_equal(_np(d), det)
    np.testing.assert_allclose(_np(dd)[keep], np.asarray(jdd)[keep],
                               rtol=1e-9)


KW = dict(n_re=4, n_im=3, newton_iters=10)


@pytest.mark.parametrize("name", sorted(cx_slab.CONFIGS))
def test_reduced_sweep_equals_jax(name):
    """run_case_complex with n_k=2 (the ends of the configuration's k
    range), on the CPU, against the JAX package's: counts and audit equal,
    each root within 1e-10 relative of the other package's. With 10 Newton
    steps a root can be accepted before it has converged that far, and
    where such an iterate stands follows rounding: a root that one more
    Newton step moves by more than 1e-10 relative is held to that step's
    length instead (the density slab's sausage root at k = 0.01: 5.8e-10,
    2.4e-10 from JAX's); at most one root a sweep. The full-size check
    holds the seeds per verdict (chip_smoke.py phase 22)."""
    _jax()
    from eigensolver_tpu.sweep import run_case_complex as jrun
    from eigensolver_tpu_torch import search, sweep
    jcase, case = _cases(name, n_k=2)
    rs, st = sweep.run_case_complex(case, **KW, device="cpu")
    jrs, jst = jrun(jcase, **KW)
    assert rs.counts() == jrs.counts() and sum(rs.counts().values()) > 0
    assert st.completeness == jst.completeness
    assert st.completeness["missed"] == 0
    assert st.n_candidates == jst.n_candidates
    n_converged = 0
    for mode in case.modes:
        b = MODE_NAMES[mode]
        g, w = rs[b], jrs[b]
        np.testing.assert_array_equal(g.ks, w.ks)
        om = g.omegas + 1j * g.omegas_imag
        jom = w.omegas + 1j * w.omegas_imag
        nxt = _np(search.newton_complex(
            sweep.make_dispersion(case, mode, torch.float64), _pair(om),
            torch.from_numpy(g.ks), n_iter=1))
        step = np.abs(nxt - om) / np.abs(om)
        tol = np.maximum(step, 1e-10)
        n_converged += int((step <= 1e-10).sum())
        for k in np.unique(w.ks):
            a, e, t = om[g.ks == k], jom[w.ks == k], tol[g.ks == k]
            d = np.abs(a[:, None] - e[None, :]) / np.abs(e)[None, :]
            assert (d.min(axis=1) <= t).all()
            assert (d[np.argmin(d, axis=0), np.arange(len(e))]
                    <= t[np.argmin(d, axis=0)]).all()
    assert n_converged >= sum(rs.counts().values()) - 1


def _load(path):
    import importlib.util
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(Path(path).stem,
                                                  root / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_op_counts_match_chip_smoke():
    """chip_smoke.py's bounds count the complex flux chain and the complex
    numeric exterior as tools_torch/count_ops.py traces them from the
    plain versions; the flux chain is lighter than the shear chain, a
    dual pass heavier than a value pass."""
    count_ops = _load("tools_torch/count_ops.py")
    ops = _load("chip_smoke.py").OPS
    counts = {**count_ops.complex_flux_ops(),
              **count_ops.complex_exterior_ops()}
    assert len(counts) == 12
    assert {key: ops[key] for key in counts} == counts
    assert ops["slab_cx_flux_chain"] < ops["slab_cx_chain"]
    for f in ("slab_cx_flux_", "slab_cx_"):
        assert ops[f + "dual_step"] > 2 * ops[f + "step"]
    assert ops["slab_cx_dual_ext_step"] > 2 * ops["slab_cx_ext_step"]


def test_targets_consistent():
    """tools_torch/cx_slab.py's JAX targets: one per configuration, of its
    full size (the seeds, the audit's cells), each branch's per-seed masks
    of its seed count whose sums the target states, the converged
    accepted seeds' roots at most the branch's; a density slab has no
    growing mode (no root off the real axis); every audit cell checked
    and agreeing."""
    from eigensolver_tpu_torch import cases
    assert set(cx_slab.TARGETS) == set(cx_slab.CONFIGS)
    for name, t in cx_slab.TARGETS.items():
        case, kw = cx_slab.configure(name, cases)
        assert kw == dict(n_re=12, n_im=10, newton_iters=30)
        n_cells = case.n_k * (len(case.speeds) - 1)
        n_seeds = n_cells * 120
        assert t["k_stride"] == 1
        assert t["candidates"] == n_seeds * len(case.modes)
        comp = t["completeness"]
        assert comp["cells"] == n_cells * len(case.modes)
        assert comp["checked"] == comp["agree"] == comp["cells"]
        assert comp["missed"] == 0
        assert set(t["counts"]) == {MODE_NAMES[m] for m in case.modes}
        for b, n in t["counts"].items():
            acc = kh.unpack_mask(t["seeds_accepted"][b], n_seeds)
            conv = kh.unpack_mask(t["seeds_converged"][b], n_seeds)
            assert (int(acc.sum()), int(conv.sum())) == \
                (t["accepted"][b], t["converged"][b])
            assert 0 < t["counts_converged"][b] <= n
            assert t["counts_off_axis"][b] <= n
            if not name.startswith("kh"):
                assert t["counts_off_axis"][b] == 0


# -- the JAX package's full-size targets -----------------------------------

def jax_counts(name, k_stride=1):
    """A target's sweep through the JAX package on the CPU, and its seeds'
    verdicts per mode (the Newton pass again, one step further)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from eigensolver_tpu import cases
    from eigensolver_tpu.roots import dedup_complex_roots as jdedup
    from eigensolver_tpu.search import newton_complex as jnewton
    from eigensolver_tpu.sweep import make_dispersion_jitted, run_case_complex
    from eigensolver_tpu_torch.sweep import complex_seeds
    case, kw = cx_slab.configure(name, cases)
    if k_stride > 1:
        case = dataclasses.replace(
            case, k_values=tuple(float(k) for k in case.k_grid()[::k_stride]))
    t = time.perf_counter()
    rs, st = run_case_complex(case, **kw)
    wall = time.perf_counter() - t
    margin = 0.05 * case.imag_band
    om0, k0 = complex_seeds(case, kw["n_re"], kw["n_im"])
    kk = jnp.asarray(k0)
    out = {"target": name, "k_stride": k_stride, "counts": rs.counts(),
           "counts_off_axis": {b: int(np.sum(np.abs(r.omegas_imag) > margin))
                               for b, r in rs.branches.items()},
           "completeness": st.completeness, "candidates": st.n_candidates,
           "counts_converged": {}, "accepted": {}, "converged": {},
           "seeds_accepted": {}, "seeds_converged": {}}
    for mode in case.modes:
        b = MODE_NAMES[mode]
        disp = make_dispersion_jitted(case, mode, jnp.float64)
        om = jnewton(disp, jnp.asarray(om0), kk, n_iter=kw["newton_iters"])
        res = disp(om, kk)
        nxt = jnewton(disp, om, kk, n_iter=1)
        om = np.asarray(om)
        acc, conv = kh.seed_verdicts(case, om, np.asarray(nxt),
                                     np.asarray(res.mismatch_pct),
                                     np.asarray(res.valid), k0)
        # the verdicts accept what the sweep accepted
        assert len(jdedup(om[acc], k0[acc], case.tol.dedup_rel)[0]) == \
            rs.counts()[b]
        out["counts_converged"][b] = kh.converged_count(
            om, k0, acc, conv, jdedup, case.tol.dedup_rel)
        out["accepted"][b] = int(acc.sum())
        out["converged"][b] = int(conv.sum())
        out["seeds_accepted"][b] = kh.pack_mask(acc)
        out["seeds_converged"][b] = kh.pack_mask(conv)
    out.update(wall_s=wall, jax=jax.__version__)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("jax-counts")
    p.add_argument("target", choices=sorted(cx_slab.CONFIGS))
    p.add_argument("--k-stride", type=int, default=1)
    a = ap.parse_args()
    print(json.dumps(jax_counts(a.target, a.k_stride)))


if __name__ == "__main__":
    main()
