"""The reference-parity sweep (tools_torch/parity.py: tools/reproduce.py's
targets) through the port vs through the JAX package.

CPU tests, at reduced sizes (one to three k, n_interior=128,
n_axis_log=16, 128 exterior steps, n_omega and n_bisect cut): the
configurations build equal on both sides (the continuum bounds to 1e-15,
where XLA's exp and the C library's differ in the last bit); the f64
sweeps of slab_ph_09 and cyl_flow_1 (numeric exterior, continuum mask,
fuzz acceptance; and slab_ph_09's refined configuration, scanned in f64)
give the JAX package's roots (the same counts, and roots to rtol
1e-12). The needle target's merged set: tests/test_torch_needle.py.

By hand (the constants `chip_smoke.py` holds the card's counts to):

    python tests/test_torch_parity.py jax-counts TARGET DTYPE [--k-stride N]

runs a target's full-size sweep through the JAX package on the CPU and
prints its counts per branch as JSON (f32: refined in f64, as the port's;
XLA_FLAGS="--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp" for
the counts of a JAX package that rounds as IEEE does; slab_ph_3 also the
needle pass's and the merged set's).
"""
import argparse
import dataclasses
import json
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools_torch import parity  # noqa: E402


def _jax_modules():
    from eigensolver_tpu import cases, equilibrium, search
    return cases, search.SearchConfig, equilibrium.genuine_continua


def _port_modules():
    from eigensolver_tpu_torch import cases, equilibrium, search
    return cases, search.SearchConfig, equilibrium.genuine_continua


def _reduced(case, ks, n_omega_cut, cfg):
    case = dataclasses.replace(case, k_values=ks, grid=dataclasses.replace(
        case.grid, n_interior=128, n_axis_log=16, n_exterior=128))
    return case, dataclasses.replace(cfg, n_omega=n_omega_cut, n_bisect=20)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(parity.TARGETS))
def test_parity_configs_equal_jax(name, dtype):
    from eigensolver_tpu_torch import config
    jcase, jcfg, jref = parity.configure(name, *_jax_modules(), dtype=dtype)
    tcase, tcfg, tref = parity.configure(name, *_port_modules(), dtype=dtype)
    assert config.from_jax(jcase) == tcase and jref == tref
    t, j = dataclasses.asdict(tcfg), dataclasses.asdict(jcfg)
    bands = t.pop("exclude_v_ranges"), j.pop("exclude_v_ranges")
    assert t == j
    np.testing.assert_allclose(*bands, rtol=0, atol=1e-15)
    assert tcfg.exclude_v_ranges          # the genuine continua are masked
    assert tcase.grid.exterior_method == "numeric"


# (target, ks, n_omega) of the reduced sweeps: cyl_flow_1's 70-seed fuzz
# grid at stride 22 needs n_omega = 22 j + 1
REDUCED = {"slab_ph_09": ((0.5, 1.5, 2.5), 64),
           "cyl_flow_1": ((2.0,), 111)}


@pytest.mark.parametrize("name", sorted(REDUCED))
def test_reduced_parity_sweep_equals_jax(name):
    from eigensolver_tpu.sweep import run_case as jrun
    from eigensolver_tpu_torch import config, sweep
    ks, n_omega = REDUCED[name]
    jcase, jcfg, _ = parity.configure(name, *_jax_modules())
    jcase, jcfg = _reduced(jcase, ks, n_omega, jcfg)
    tcase, tcfg, _ = parity.configure(name, *_port_modules())
    tcase, tcfg = _reduced(tcase, ks, n_omega, tcfg)
    assert config.from_jax(jcase) == tcase
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, _ = jrun(jcase, jcfg)
        got, _ = sweep.run_case(tcase, tcfg, device="cpu")
    assert got.counts() == want.counts()
    assert sum(got.counts().values()) > 5
    for b in want.branches:
        np.testing.assert_allclose(got[b].omegas, want[b].omegas, rtol=1e-12)
        np.testing.assert_array_equal(got[b].ks, want[b].ks)


def test_reduced_parity_refined_sweep_equals_jax():
    """slab_ph_09's refined configuration (accept_pct 25 at the scan,
    re-judged at 3% at the f64 roots), its scan in f64 so that XLA's f32
    contractions stay out: the fuzz records keep their scan seeds through
    refine_f64 and merge with the refined roots as the JAX package's
    finalize_branches merges them (sweep.py:436-475)."""
    from eigensolver_tpu.sweep import run_case as jrun
    from eigensolver_tpu_torch import sweep
    out = []
    for mods, run, kw in ((_jax_modules(), jrun, {}),
                          (_port_modules(), sweep.run_case,
                           {"device": "cpu"})):
        case, cfg, refine = parity.configure("slab_ph_09", *mods,
                                             dtype="float32")
        case, cfg = _reduced(case, (0.5, 1.5, 2.5), 64, cfg)
        cfg = dataclasses.replace(cfg, scan_dtype="float64",
                                  polish_dtype="float64")
        assert refine and cfg.accept_pct_refined == 3.0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out.append(run(case, cfg, refine_f64=True, **kw)[0])
    want, got = out
    assert got.counts() == want.counts()
    assert sum(got.counts().values()) > 5
    for b in want.branches:
        np.testing.assert_allclose(got[b].omegas, want[b].omegas, rtol=1e-12)
        np.testing.assert_array_equal(got[b].ks, want[b].ks)


def jax_counts(name, dtype, k_stride):
    """A target's full-size sweep through the JAX package on the CPU: its
    counts per branch (and, for the needle target, the needle pass's and
    the merged set's) and walls."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from eigensolver_tpu import roots, sweep
    case, cfg, refine = parity.configure(name, *_jax_modules(), dtype=dtype,
                                         k_stride=k_stride)
    t = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rs, st = sweep.run_case(case, cfg, refine_f64=refine)
    out = {"target": name, "dtype": dtype, "k_stride": k_stride,
           "n_k": len(case.k_grid()), "candidates": st.n_candidates,
           "counts": rs.counts(), "wall_s": time.perf_counter() - t,
           "jax": jax.__version__}
    if "needle" in parity.TARGETS[name]:
        t = time.perf_counter()
        edges = parity.needle_edges(name, case, sweep.needle_edges)
        nrs, nst = sweep.run_needle_pass(
            case, edges=edges, modes=parity.TARGETS[name]["needle"]["modes"])
        out.update(needle_counts=nrs.counts(),
                   needle_candidates=nst.n_candidates,
                   merged_counts=roots.merge_rootsets(rs, nrs).counts(),
                   needle_wall_s=time.perf_counter() - t)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("jax-counts")
    p.add_argument("target", choices=sorted(parity.TARGETS))
    p.add_argument("dtype", choices=["float64", "float32"])
    p.add_argument("--k-stride", type=int, default=1)
    a = ap.parse_args()
    print(json.dumps(jax_counts(a.target, a.dtype, a.k_stride)))


if __name__ == "__main__":
    main()
