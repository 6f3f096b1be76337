"""The port's float32 arithmetic against the JAX package's, bit for bit.

Why the two packages' f32 root counts differ. XLA:CPU compiles the JAX
package's float32 programs with fused multiply-adds and with the rewrites of
its algebraic simplifier; the port's plain version and its CUDA kernels (built
with --fmad=false) round every operation once, as IEEE arithmetic does.
Compiled with

    XLA_FLAGS="--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp"

(no FMA instructions, no simplifier) the JAX package rounds as IEEE does too.
Given the same exp and log (where two libraries may differ by an ulp), the two
packages then agree bit for bit on every f32 dispersion value and find the
same f32 roots. That holds only with `profiles.sqrt`: on a CPU tensor
`torch.sqrt` is not correctly rounded, and with it 17-26% of the f32 det
values differed. The Gaussian-flow slab is left out: its U' and U'' come from
jax.grad there and from closed forms here (tests/test_torch_slab.py).

XLA reads its flags once per process, so each case runs in a subprocess of
this file, which can also be run by hand:

    XLA_FLAGS="--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp" \\
        python tests/test_torch_ieee.py parity slab_density_photospheric

prints the fractions of bit-equal det, mismatch and valid on 2048 ladder
candidates and both packages' reduced f32 sweeps (with the default XLA_FLAGS
it shows how far the default compilation is from IEEE rounding), and

    python tests/test_torch_ieee.py counts [--small] [--cases TAG ...]
        [--out PATH]

runs the full-size f32 sweeps of cyl_co_09, slab_ph_09 and twist_v01_p1
(n_omega=256, n_bisect=18; slab_ph_09 also with refine_f64=True; `--cases
TAG ...` for some of them) four ways: the JAX package
on the CPU with the default and with the IEEE flags, the port's plain version
on the CPU, and the port on a CUDA card when there is one. It prints one JSON
object of per-branch counts and of the roots each pair has in common.
"""
import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
IEEE_XLA_FLAGS = "--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp"
# case: k values of the reduced sweep (n_interior=256, n_axis_log=32)
PARITY_CASES = {
    "slab_density_photospheric": (0.5, 1.5, 2.5),
    "slab_density_coronal": (0.5, 1.5, 2.5),
    "slab_flow_uniform_photospheric": (0.5, 1.5, 2.5),   # shear form, U' = 0
    "cylinder_density_coronal": (2.0,),
}


def _run_self(*args, xla_flags=None, timeout=900):
    """Run this file as a script in a fresh process; return its JSON line."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    if xla_flags:
        env["XLA_FLAGS"] = xla_flags
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, __file__, *args], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"{args} failed:\n{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_sqrt_is_correctly_rounded(dtype):
    from eigensolver_tpu_torch.profiles import sqrt
    x = np.random.default_rng(0).uniform(1e-3, 1e3, 20000)
    if dtype == torch.float32:
        x = x.astype(np.float32)
        # rounding the double root to float32 is the correctly rounded root
        want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    else:
        want = np.array([math.sqrt(v) for v in x])
    got = sqrt(torch.from_numpy(x))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.isnan(sqrt(torch.tensor([-1.0], dtype=dtype))).all()


@pytest.mark.parametrize("name", list(PARITY_CASES))
def test_f32_bit_equal_to_jax_compiled_ieee(name):
    res = _run_self("parity", name, xla_flags=IEEE_XLA_FLAGS)
    assert res["bit_equal"] == {"det": 1.0, "mismatch": 1.0, "valid": 1.0}
    assert res["port_counts"] == res["jax_counts"]
    assert min(res["port_counts"].values()) >= 5
    assert res["roots_equal"]


# -- subprocess side ----------------------------------------------------------

def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def _share_jax_exp_log():
    """Make the port's torch.exp and torch.log the JAX package's."""
    jax = _jax()
    import jax.numpy as jnp
    for name in ("exp", "log"):
        fn = jax.jit(getattr(jnp, name))
        setattr(torch, name,
                lambda t, fn=fn: torch.from_numpy(np.array(fn(t.numpy()))))


def _f32(n_omega):
    from eigensolver_tpu.search import SearchConfig
    return SearchConfig(n_omega=n_omega, n_bisect=18, scan_dtype="float32",
                        polish_dtype="float32")


def _same_roots(a, b):
    return a.counts() == b.counts() and all(
        np.array_equal(a[br].omegas, b[br].omegas)
        and np.array_equal(a[br].ks, b[br].ks) for br in a.branches)


def parity(name):
    _share_jax_exp_log()
    import jax.numpy as jnp
    from eigensolver_tpu import cases as jcases
    from eigensolver_tpu import sweep as jsweep
    from eigensolver_tpu_torch import config, search, sweep
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    c = getattr(jcases, name)()
    jcase = dataclasses.replace(
        c, k_values=PARITY_CASES[name],
        grid=dataclasses.replace(c.grid, n_interior=256, n_axis_log=32))
    case = config.from_jax(jcase)
    om, ks = sweep.build_ladders(case, 64)
    rng = np.random.default_rng(0)
    row, col = rng.integers(0, om.shape[0], 2048), rng.integers(0, om.shape[1], 2048)
    args = [om[row, col], ks[row], rng.integers(0, 2, 2048)]
    args = [a.astype(np.float32) for a in args]
    jres = jsweep.make_dispersion_moded(jcase, jnp.float32)(*args)
    phys = (SlabPhysics if name.startswith("slab") else CylinderPhysics)
    pres = phys.from_case(case).make_dispersion_plain(None, torch.float32)(
        *(torch.from_numpy(a) for a in args))

    def equal(a, b):
        a, b = np.asarray(a), b.numpy()
        return float(np.mean((a == b) | (np.isnan(a) & np.isnan(b))))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # saturated-row notices
        jrs, _ = jsweep.run_case(jcase, _f32(64))
        prs, _ = sweep.run_case(case, search.SearchConfig.from_jax(_f32(64)),
                                device="cpu")
    return {"xla_flags": os.environ.get("XLA_FLAGS"),
            "bit_equal": {"det": equal(jres.det, pres.det),
                          "mismatch": equal(jres.mismatch_pct, pres.mismatch_pct),
                          "valid": equal(jres.valid, pres.valid)},
            "jax_counts": jrs.counts(), "port_counts": prs.counts(),
            "roots_equal": _same_roots(jrs, prs)}


# (tag, JAX case name, refine_f64 values) of the full-size sweeps
FULL_CASES = (("cyl_co_09", "cylinder_density_coronal", (False,)),
              ("slab_ph_09", "slab_density_photospheric", (False, True)),
              ("twist_v01_p1", "cylinder_twisted_photospheric", (False, True)))
# the constructor arguments of each (default: width 0.9)
_CASE_ARGS = {"cylinder_twisted_photospheric": (0.1, 1.0, 1)}


def _case(name, small):
    """The case at width 0.9 (twist_v01_p1: v_twist 0.1, power 1, m = 1);
    with small, the reduced grid of the parity test (for a dry run on a
    CPU)."""
    from eigensolver_tpu import cases as jcases
    c = getattr(jcases, name)(*_CASE_ARGS.get(name, (0.9,)))
    if small:
        c = dataclasses.replace(
            c, k_values=PARITY_CASES.get(name, (0.8, 2.0)),
            grid=dataclasses.replace(c.grid, n_interior=256, n_axis_log=32))
    return c


def _roots(rs):
    return {b: [br.ks.tolist(), br.omegas.tolist()] for b, br in rs.branches.items()}


def jax_counts(name, refine, small):
    _jax()
    from eigensolver_tpu.sweep import run_case
    t = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rs, _ = run_case(_case(name, small), _f32(64 if small else 256),
                         refine_f64=refine)
    return {"counts": rs.counts(), "wall_s": time.perf_counter() - t,
            "roots": _roots(rs)}


def _common(a, b):
    """Roots of a that b has at the same k within 1e-5 relative (18
    bisections of a ladder panel resolve ~4e-6 of it), per branch."""
    out = {}
    for br, (ka, oa) in a.items():
        kb, ob = (np.asarray(x) for x in b[br])
        out[br] = int(sum(bool(np.any((kb == k) & (np.abs(ob / o - 1) < 1e-5)))
                          for k, o in zip(ka, oa)))
    return out


def counts(small, tags=None):
    from concurrent.futures import ThreadPoolExecutor
    from eigensolver_tpu_torch import config, search, sweep
    flag = ("--small",) if small else ()
    full = [c for c in FULL_CASES if tags is None or c[0] in tags]
    runs = {}
    with ThreadPoolExecutor(8) as pool:
        futures = {
            (tag, refine, xla): pool.submit(
                _run_self, "jax-counts", name, str(refine), *flag,
                xla_flags=None if xla == "jax_default" else IEEE_XLA_FLAGS,
                timeout=3000)
            for tag, name, refines in full for refine in refines
            for xla in ("jax_default", "jax_ieee")}
        for tag, name, refines in full:
            case = config.from_jax(_case(name, small))
            cfg = search.SearchConfig.from_jax(_f32(64 if small else 256))
            for refine in refines:
                # the port's CPU run only at f32, for the three-way count
                devices = ([] if refine else ["cpu"]) + (
                    ["cuda"] if torch.cuda.is_available() else [])
                for dev in devices:
                    if dev == "cuda":       # a warm-up run builds the kernels
                        sweep.run_case(case, cfg, device=dev, refine_f64=refine)
                    t = time.perf_counter()
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        rs, _ = sweep.run_case(case, cfg, device=dev,
                                               refine_f64=refine)
                    runs[(tag, refine, f"port_{dev}")] = {
                        "counts": rs.counts(), "wall_s": time.perf_counter() - t,
                        "roots": _roots(rs)}
        for key, fut in futures.items():
            runs[key] = fut.result()
    out = {"torch": torch.__version__,
           "device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else None,
           "small": small}
    for (tag, refine, who), r in sorted(runs.items()):
        key = f"{tag}{'_refined' if refine else ''}"
        out.setdefault(key, {})[who] = {"counts": r["counts"], "wall_s": r["wall_s"]}
    for tag, _, refines in full:
        for refine in refines:
            key = f"{tag}{'_refined' if refine else ''}"
            who = sorted(w for (t, rf, w) in runs if t == tag and rf == refine)
            out[key]["in_common"] = {
                f"{a}&{b}": _common(runs[(tag, refine, a)]["roots"],
                                    runs[(tag, refine, b)]["roots"])
                for i, a in enumerate(who) for b in who[i + 1:]}
    return out


def main():
    sys.path.insert(0, str(ROOT))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("parity")
    p.add_argument("case", choices=list(PARITY_CASES))
    p = sub.add_parser("jax-counts")
    p.add_argument("case")
    p.add_argument("refine", choices=["False", "True"])
    p.add_argument("--small", action="store_true")
    p = sub.add_parser("counts")
    p.add_argument("--small", action="store_true")
    p.add_argument("--cases", nargs="+", choices=[c[0] for c in FULL_CASES])
    p.add_argument("--out")
    a = ap.parse_args()
    if a.cmd == "parity":
        res = parity(a.case)
    elif a.cmd == "jax-counts":
        res = jax_counts(a.case, a.refine == "True", a.small)
    else:
        res = counts(a.small, a.cases)
        if a.out:
            Path(a.out).parent.mkdir(parents=True, exist_ok=True)
            Path(a.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
