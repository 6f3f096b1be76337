"""Complex omega on the density and axial-flow cylinders (ROADMAP A10b),
against the JAX package on the CPU in float64, at a reduced depth
(n_interior 64, n_axis_log 16, n_exterior 64):

- `cplx.clog` against numpy's complex log;
- the K_m ratio at complex z (`special.kve_ratio_both_c`) against JAX's
  `special.kve_ratio_both` on both sides of |z| = 2 and near the
  imaginary axis, to rtol 1e-13; on duals its derivative against jax.jvp;
- the plain complex dispersion (`make_dispersion_plain` at complex omega)
  against the JAX disp, both m in one batch: det to rtol 1e-11 (pole
  points, |det| > 1e6 x the median, masked), the mismatch to 1e-9, valid
  equal; the dual shoot's value equal to it bit for bit, its d det /
  d omega against jax.jvp to rtol 1e-9; the density cylinder with the
  exact exterior, the axial-flow one with the numeric exterior;
- `run_case_complex` of the density cylinder's kink, reduced (n_k=2, 4 x
  3 seeds, 10 Newton steps, the audit on), against the JAX package's:
  counts and audit equal, roots within 1e-10 relative;
- the full-size JAX targets that `chip_smoke.py` holds
  (tools_torch/cx_cyl.py) consistent with themselves, and the operation
  counts of chip_smoke.py's bounds those tools_torch/count_ops.py counts.

Each JAX function compiles once in the file.

`python tests/test_torch_complex_cylinder.py jax-counts NAME --k-stride N`
takes those targets: the JAX package's sweep on the CPU on every N-th k.
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
from tools_torch import cx_cyl, kh  # noqa: E402

MODE_NAMES = {0: "sausage", 1: "kink"}
GRID = dict(n_interior=64, n_axis_log=16, n_exterior=64)
# name: (case factory, its keywords, exterior_method)
CONFIGS = {
    "density": ("cylinder_density_coronal", dict(width=0.9), "bessel"),
    "flow_numeric": ("cylinder_flow_coronal", dict(U=1.0), "numeric"),
}


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def cases_of(fac, kw, exterior, **case_kw):
    """(JAX case, port case): the factory's case made complex, reduced."""
    from eigensolver_tpu import cases as jcases
    from eigensolver_tpu_torch import config
    c = getattr(jcases, fac)(**kw)
    jcase = dataclasses.replace(
        c, complex_omega=True, **case_kw,
        grid=dataclasses.replace(c.grid, exterior_method=exterior, **GRID))
    return jcase, config.from_jax(jcase)


def draws(case, n, seed, modes=(0, 1)):
    """n candidates over the case's speed edges and k range, Im omega
    within +-0.3, m from `modes` (numpy; omega complex128)."""
    rng = np.random.default_rng(seed)
    v = np.asarray(case.sorted_speeds())
    k = rng.uniform(case.k_min, case.k_max, n)
    om = (rng.uniform(v[0], v[-1], n) + 1j * rng.uniform(-0.3, 0.3, n)) * k
    m = np.asarray(modes, np.float64)[rng.integers(0, len(modes), n)]
    return om, k, m


def pair(om):
    from eigensolver_tpu_torch.cplx import C
    return C(torch.from_numpy(om.real.copy()),
             torch.from_numpy(om.imag.copy()))


def to_np(z):
    out = np.empty(z.re.shape, np.complex128)
    out.real, out.imag = z.re.numpy(), z.im.numpy()
    return out


def jax_disp_and_jvp(jcase, om, k, m):
    """The JAX package's disp (m traced) and its d det / d omega on the
    candidates, each compiled once."""
    jax = _jax()
    import jax.numpy as jnp
    from eigensolver_tpu.physics.cylinder import CylinderPhysics as JPhysics
    jd = JPhysics.from_case(jcase).make_dispersion(m=None)
    args = (jnp.asarray(om), jnp.asarray(k), jnp.asarray(m))
    want = jax.jit(jax.vmap(jd))(*args)
    _, jdd = jax.jit(jax.vmap(lambda o, kk, mm: jax.jvp(
        lambda oo: jd(oo, kk, mm).det, (o,), (jnp.ones_like(o),))))(*args)
    return want, np.asarray(jdd)


def check_disp_and_dual(jcase, case, om, k, m):
    """The plain complex dispersion and its dual shoot against the JAX
    package's disp and jax.jvp (see the module's docstring)."""
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    want, jdd = jax_disp_and_jvp(jcase, om, k, m)
    ph = CylinderPhysics.from_case(case)
    args = (pair(om), torch.from_numpy(k), torch.from_numpy(m))
    got = ph.make_dispersion_plain(m=None)(*args)
    det, jdet = to_np(got.det), np.asarray(want.det)
    keep = np.abs(jdet) < 1e6 * np.median(np.abs(jdet))
    assert keep.mean() > 0.9
    np.testing.assert_allclose(det[keep], jdet[keep], rtol=1e-11)
    np.testing.assert_allclose(got.mismatch_pct.numpy()[keep],
                               np.asarray(want.mismatch_pct)[keep],
                               rtol=1e-9)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    d, dd = ph.make_dispersion_dual_plain(m=None)(*args)
    np.testing.assert_array_equal(to_np(d), det)
    np.testing.assert_allclose(to_np(dd)[keep], jdd[keep], rtol=1e-9)


KW = dict(n_re=4, n_im=3, newton_iters=10)


def check_reduced_sweep(jcase, case, modes=None):
    """run_case_complex against the JAX package's, reduced (module's
    docstring). With 10 Newton steps a root can be accepted before it has
    converged that far, and where such an iterate stands follows
    rounding: a root that one more Newton step moves by more than 1e-10
    relative is held to that step's length instead, at most one root a
    sweep (as tests/test_torch_complex_slab.py holds the slab's)."""
    _jax()
    from eigensolver_tpu.sweep import run_case_complex as jrun
    from eigensolver_tpu_torch import search, sweep
    rs, st = sweep.run_case_complex(case, modes, **KW, device="cpu")
    jrs, jst = jrun(jcase, modes, **KW)
    assert rs.counts() == jrs.counts() and sum(rs.counts().values()) > 0
    assert st.completeness == jst.completeness
    assert st.completeness["missed"] == 0
    assert st.n_candidates == jst.n_candidates
    n_converged = 0
    for mode in modes or case.modes:
        b = MODE_NAMES[mode]
        g, w = rs[b], jrs[b]
        np.testing.assert_array_equal(g.ks, w.ks)
        om = g.omegas + 1j * g.omegas_imag
        jom = w.omegas + 1j * w.omegas_imag
        nxt = to_np(search.newton_complex(
            sweep.make_dispersion(case, mode, torch.float64), pair(om),
            torch.from_numpy(g.ks), n_iter=1))
        step = np.abs(nxt - om) / np.abs(om)
        tol = np.maximum(step, 1e-10)
        n_converged += int((step <= 1e-10).sum())
        for kv in np.unique(w.ks):
            a, e, t = om[g.ks == kv], jom[w.ks == kv], tol[g.ks == kv]
            d = np.abs(a[:, None] - e[None, :]) / np.abs(e)[None, :]
            assert (d.min(axis=1) <= t).all()
            assert (d[np.argmin(d, axis=0), np.arange(len(e))]
                    <= t[np.argmin(d, axis=0)]).all()
    assert n_converged >= sum(rs.counts().values()) - 1


def test_clog_equals_numpy():
    """cplx.clog against numpy.log: every quadrant, both axes, moduli
    from 1e-3 to 1e3 (|z| near 1 too, where log|z| is near 0)."""
    from eigensolver_tpu_torch.cplx import clog
    rng = np.random.default_rng(11)
    z = 10.0 ** rng.uniform(-3, 3, 500) * np.exp(1j * rng.uniform(
        -np.pi, np.pi, 500))
    z = np.concatenate([z, [2.0, -2.0, 3j, -0.5j, 1.0, 1 + 1e-9j,
                            -1 + 1e-300j]])
    got = to_np(clog(pair(z)))
    want = np.log(z)
    np.testing.assert_allclose(got.real, want.real, rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(got.imag, want.imag, rtol=1e-15, atol=0)


def _kve_points():
    """Complex z with Re z > 0: moduli on both sides of |z| = 2, and
    arguments up to within 1e-3 of +-pi/2 (near the imaginary axis)."""
    rng = np.random.default_rng(3)
    r = np.concatenate([rng.uniform(0.05, 2.0, 300),
                        rng.uniform(2.0, 12.0, 300),
                        rng.uniform(0.2, 8.0, 100)])
    th = np.concatenate([rng.uniform(-1.5, 1.5, 600),
                         np.sign(rng.uniform(-1, 1, 100))
                         * (np.pi / 2 - 10.0 ** rng.uniform(-3, -1, 100))])
    return r * np.exp(1j * th)


def test_kve_ratio_both_c_equals_jax():
    """The pair at complex z against JAX's special.kve_ratio_both to rtol
    1e-13; the dual's derivative against jax.jvp to rtol 1e-11 and its
    value bit-equal to the pair's."""
    jax = _jax()
    import jax.numpy as jnp
    from eigensolver_tpu import special as jspecial
    from eigensolver_tpu_torch.dual import Dual
    from eigensolver_tpu_torch.special import kve_ratio_both_c
    z = _kve_points()
    got = kve_ratio_both_c(pair(z))
    (want0, want1), (t0, t1) = jax.jvp(
        jspecial.kve_ratio_both, (jnp.asarray(z),),
        (jnp.ones_like(jnp.asarray(z)),))
    for g, w in zip(got, (want0, want1)):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-13)
    dual = kve_ratio_both_c(Dual(pair(z), pair(np.ones_like(z))))
    for dg, g, t in zip(dual, got, (t0, t1)):
        np.testing.assert_array_equal(to_np(dg.v), to_np(g))
        np.testing.assert_allclose(to_np(dg.d), np.asarray(t), rtol=1e-11)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dispersion_and_dual_equal_jax(name):
    jcase, case = cases_of(*CONFIGS[name])
    om, k, m = draws(case, 96, 4)
    check_disp_and_dual(jcase, case, om, k, m)


def test_reduced_sweep_equals_jax():
    """The density cylinder's kink (the dispersion test holds both m)."""
    jcase, case = cases_of(*CONFIGS["density"], n_k=2)
    check_reduced_sweep(jcase, case, modes=(1,))


def test_targets_consistent():
    """tools_torch/cx_cyl.py's JAX targets: one per configuration, on the
    seeds of every k_stride-th k of the full grid (the audit's cells
    alike), each branch's per-seed masks of that seed count whose sums
    the target states, the converged accepted seeds' roots at most the
    branch's; every audit cell checked and agreeing."""
    from eigensolver_tpu_torch import cases
    assert set(cx_cyl.TARGETS) == set(cx_cyl.CONFIGS)
    for name, t in cx_cyl.TARGETS.items():
        case, kw = cx_cyl.configure(name, cases)
        assert kw == dict(n_re=12, n_im=10, newton_iters=30)
        sub = cx_cyl.subset_seeds(case, t["k_stride"])
        n_k = len(cx_cyl.strided(case, t["k_stride"]).k_grid())
        n_cells = n_k * (len(case.speeds) - 1)
        assert len(sub) == n_cells * 120
        assert t["candidates"] == len(sub) * len(case.modes)
        comp = t["completeness"]
        assert comp["cells"] == n_cells * len(case.modes)
        assert comp["checked"] == comp["agree"] == comp["cells"]
        assert comp["missed"] == 0
        assert set(t["counts"]) == {MODE_NAMES[m] for m in case.modes}
        for b, n in t["counts"].items():
            acc = kh.unpack_mask(t["seeds_accepted"][b], len(sub))
            conv = kh.unpack_mask(t["seeds_converged"][b], len(sub))
            assert (int(acc.sum()), int(conv.sum())) == \
                (t["accepted"][b], t["converged"][b])
            assert 0 < t["counts_converged"][b] <= n
            assert t["counts_off_axis"][b] <= n


def _load(path):
    import importlib.util
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(Path(path).stem,
                                                  root / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_op_counts_match_chip_smoke():
    """chip_smoke.py's bounds count the complex cylinder as
    tools_torch/count_ops.py counts it from the plain versions; a dual
    pass costs more than twice a value pass, the twisted chain more than
    the density one, the series less than CF2."""
    count_ops = _load("tools_torch/count_ops.py")
    ops = _load("chip_smoke.py").OPS
    counts = count_ops.complex_cylinder_ops()
    assert len(counts) == 20
    assert {key: ops[key] for key in counts} == counts
    for f in ("cyl_cx_", "cyl_tw_cx_"):
        assert ops[f + "dual_step"] > 2 * ops[f + "step"]
    assert ops["cyl_tw_cx_step"] > 2 * ops["cyl_cx_step"]
    assert ops["cyl_cx_kve_series"] < ops["cyl_cx_kve_cf2"]
    assert ops["cyl_cx_log_step"] > ops["cyl_cx_step"]


def test_subset_seeds_are_the_strided_sweeps():
    """subset_seeds picks, from the full sweep's seeds, exactly the seeds
    of the strided case's sweep, in its order."""
    from eigensolver_tpu_torch import cases
    from eigensolver_tpu_torch.sweep import complex_seeds
    for name in cx_cyl.CONFIGS:
        case, _ = cx_cyl.configure(name, cases)
        om, k = complex_seeds(case)
        for stride in (1, 6, 30):
            om_s, k_s = complex_seeds(cx_cyl.strided(case, stride))
            sub = cx_cyl.subset_seeds(case, stride)
            np.testing.assert_array_equal(om[sub], om_s)
            np.testing.assert_array_equal(k[sub], k_s)


# -- the JAX package's targets ----------------------------------------------

def jax_counts(name, k_stride=1):
    """A target's sweep through the JAX package on the CPU on every
    k_stride-th k, and its seeds' verdicts per mode (the Newton pass
    again, one step further)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from eigensolver_tpu import cases
    from eigensolver_tpu.roots import dedup_complex_roots as jdedup
    from eigensolver_tpu.search import newton_complex as jnewton
    from eigensolver_tpu.sweep import make_dispersion_jitted, run_case_complex
    from eigensolver_tpu_torch.sweep import complex_seeds
    case, kw = cx_cyl.configure(name, cases)
    case = cx_cyl.strided(case, k_stride)
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
    out.update(wall_s=wall, total_s=time.perf_counter() - t,
               jax=jax.__version__)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("jax-counts")
    p.add_argument("target", choices=sorted(cx_cyl.CONFIGS))
    p.add_argument("--k-stride", type=int, default=1)
    a = ap.parse_args()
    print(json.dumps(jax_counts(a.target, a.k_stride)))


if __name__ == "__main__":
    main()
