#!/usr/bin/env python3
"""Smoke run of the PyTorch port (eigensolver_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--json-out PATH]

Run from the repository root. Phases, one line each; any failure raises and
the script exits non-zero:

1. device: a CUDA card is required; its nvidia-smi name and power limit.
2. build: the CUDA kernels, compiled with nvcc from eigensolver_tpu_torch/csrc.
3. kve_ratio kernel vs its plain PyTorch version, 552,960 arguments.
4. cylinder_disp kernel vs its plain PyTorch version, 8,192 candidates of
   the full cyl_co_09 ladder (n_interior=2048, n_axis_log=128); at the full
   sweep's 552,960 candidates, the kernel's time and, at float32, the plain
   version's time and agreement.
5. the sweep: run_case(cylinder_density_coronal(0.9), n_omega=256,
   n_bisect=18, float32) on the card - once with the launch counters reset
   (it must run through the cylinder_disp kernel and never the plain
   dispersion), then 3 timed runs, then once at float64; root counts held
   against the JAX package's own counts for the same configuration; a
   reduced sweep on the card held against the same sweep on the CPU.

Then one JSON line of the kernels the sweep ran, the nvidia-smi line, and
last `{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

N_SWEEP = 90 * 12 * 256 * 2     # cyl_co_09 candidates per sweep: 552,960
N_DISP_CHECK = 8192
# Root counts of eigensolver_tpu.sweep.run_case on the same case and config,
# measured with the JAX package on a CPU (JAX 0.9.0, x64):
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu');
#     jax.config.update('jax_enable_x64', True)
#     from eigensolver_tpu import cases; from eigensolver_tpu.sweep import run_case
#     from eigensolver_tpu.search import SearchConfig
#     print(run_case(cases.cylinder_density_coronal(width=0.9), SearchConfig(
#       n_omega=256, n_bisect=18, scan_dtype=DT, polish_dtype=DT))[0].counts())"
# f64: a difference can come only from determinant signs that flip within
# ~1e-12 of a zero, so the band is +-0.25%. f32: marginal acceptances flip
# at the ulp level (the TPU's f32 count was 2377), so +-3%.
JAX_COUNTS = {
    "float64": ({"sausage": 1709, "kink": 2238}, 0.0025),
    "float32": ({"sausage": 919, "kink": 1487}, 0.03),
}
# reduced sweep (k in {0.5, 2}, n_interior=256, n_axis_log=32, n_omega=64,
# n_bisect=30, f64): same JAX measurement, and tests/test_torch_sweep.py
JAX_COUNTS_REDUCED = {"sausage": 29, "kink": 43}


def line(phase: str, **fields) -> None:
    print(f"{phase}: {json.dumps(fields, default=float)}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    # no matmul is on the path; state the precision all the same
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line("phase 1 device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    return smi


def phase_build():
    from eigensolver_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    log = so.with_suffix(".log").read_text() if so.with_suffix(".log").is_file() else ""
    ptxas = [ln.split("ptxas info    :")[-1].strip() for ln in log.splitlines()
             if "Used" in ln or "spill" in ln]
    line("phase 2 build", seconds=seconds, library=so.name, ptxas=ptxas)


def phase_kve_ratio(out: dict):
    import torch
    from eigensolver_tpu_torch import special
    from eigensolver_tpu_torch.kernels import bessel
    rng = np.random.default_rng(0)
    # both branches: series for |z| < 2, CF2 above
    z64 = torch.from_numpy(10.0 ** rng.uniform(-2.0, 2.3, N_SWEEP)).cuda()
    res = {}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        z = z64.to(dtype)
        k0, k1 = bessel.kve_ratio_both(z)
        p0, p1 = special.kve_ratio_both(z)
        torch.cuda.synchronize()
        rel = max(float(((k - p).abs() / p.abs()).max())
                  for k, p in ((k0, p0), (k1, p1)))
        abs_err = max(float((k - p).abs().max()) for k, p in ((k0, p0), (k1, p1)))
        if not rel <= rtol:
            raise AssertionError(f"kve_ratio kernel vs plain ({dtype}): max "
                                 f"rel err {rel:.3e} > {rtol:g}")
        name = str(dtype).split(".")[-1]
        res[name] = dict(
            max_rel_err=rel, max_abs_err=abs_err, rtol=rtol,
            ms=cuda_ms(lambda: bessel.kve_ratio_both(z), 20),
            plain_ms=cuda_ms(lambda: special.kve_ratio_both(z), 3))
    out["kve_ratio"] = res
    line("phase 3 kve_ratio vs plain", n=N_SWEEP, **res)


def _ladder_candidates(case, n, seed):
    import torch
    from eigensolver_tpu_torch import sweep
    om, ks = sweep.build_ladders(case, 256)
    rng = np.random.default_rng(seed)
    row = rng.integers(0, om.shape[0], n)
    col = rng.integers(0, om.shape[1], n)
    m = rng.integers(0, 2, n).astype(np.float64)
    return [torch.from_numpy(x).cuda() for x in (om[row, col], ks[row], m)]


def _compare_disp(what: str, kres, pres, f64: bool) -> dict:
    """Hold the kernel's CylinderInterface against the plain version's.

    f64: det and mismatch to rtol 1e-9 away from poles (|det| > 1e6 x the
    median is masked). f32: det signs agree wherever |det| > 1e-3 x the
    median, above the f32 noise floor of the shoot."""
    import torch
    kdet, kmis, kval = kres
    pdet, pmis, pval = pres
    if not torch.equal(kval, pval):
        raise AssertionError(f"cylinder_disp ({what}): valid masks differ")
    if not torch.equal(kdet.isfinite(), pdet.isfinite()):
        raise AssertionError(f"cylinder_disp ({what}): finite masks differ")
    kd, pd = kdet.cpu().numpy(), pdet.cpu().numpy()
    fin = np.isfinite(pd)
    med = float(np.median(np.abs(pd[fin])))
    ok = fin & (np.abs(pd) < 1e6 * med)          # away from poles
    r = dict(n=len(pd), masked_poles=int((fin & ~ok).sum()),
             max_abs_err_det=float(np.max(np.abs(kd - pd)[ok])))
    if f64:
        km, pm = kmis.cpu().numpy(), pmis.cpu().numpy()
        r["max_rel_err_det"] = float(np.max(np.abs(kd - pd)[ok] / np.abs(pd)[ok]))
        r["max_rel_err_mismatch"] = float(np.nanmax(
            np.abs(km - pm)[ok] / np.abs(pm)[ok]))
        if not (r["max_rel_err_det"] <= 1e-9
                and r["max_rel_err_mismatch"] <= 1e-9):
            raise AssertionError(f"cylinder_disp ({what}) vs plain beyond "
                                 f"rtol 1e-9: {r}")
    else:
        big = ok & (np.abs(pd) > 1e-3 * med)
        agree = np.signbit(kd[big]) == np.signbit(pd[big])
        r["sign_checked"] = int(big.sum())
        r["sign_disagree"] = int((~agree).sum())
        if not agree.all():
            raise AssertionError(f"cylinder_disp ({what}) det signs differ: {r}")
    return r


def phase_cylinder_disp(out: dict):
    import torch
    from eigensolver_tpu_torch import cases
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    case = cases.cylinder_density_coronal(width=0.9)
    ph = CylinderPhysics.from_case(case)
    om, k, m = _ladder_candidates(case, N_DISP_CHECK, seed=1)
    res = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        args = [x.to(dtype) for x in (om, k, m)]
        kern = ph.make_dispersion(m=None, dtype=dtype)
        plain = ph.make_dispersion_plain(m=None, dtype=dtype)
        kres = kern(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pres = plain(*args)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        r = _compare_disp(name, kres, pres, f64=dtype == torch.float64)
        r.update(ms=cuda_ms(lambda: kern(*args), 5), plain_ms=plain_ms)
        res[name] = r
    # the full sweep's scan size: the kernel at both dtypes; the plain
    # version once at float32 (the sweep's scan dtype), held against the
    # kernel on the same candidates
    om_f, k_f, m_f = _ladder_candidates(case, N_SWEEP, seed=2)
    full = {}
    for dtype in (torch.float32, torch.float64):
        args = [x.to(dtype) for x in (om_f, k_f, m_f)]
        kern = ph.make_dispersion(m=None, dtype=dtype)
        full[str(dtype).split(".")[-1]] = cuda_ms(lambda: kern(*args), 3)
    args = [x.to(torch.float32) for x in (om_f, k_f, m_f)]
    kres = ph.make_dispersion(m=None, dtype=torch.float32)(*args)
    plain = ph.make_dispersion_plain(m=None, dtype=torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pres = plain(*args)
    torch.cuda.synchronize()
    full["plain_float32"] = 1e3 * (time.perf_counter() - t0)
    full["check_float32"] = _compare_disp("full float32", kres, pres, f64=False)
    res["full_ms"] = full
    out["cylinder_disp"] = res
    line("phase 4 cylinder_disp vs plain", **res)


def _check_counts(counts: dict, dtype: str):
    want, band = JAX_COUNTS[dtype]
    total, want_total = sum(counts.values()), sum(want.values())
    if abs(total - want_total) > band * want_total:
        raise AssertionError(f"{dtype} sweep: {total} roots {counts}, JAX "
                             f"package {want_total} {want} (band "
                             f"+-{band:.2%})")
    return total - want_total


def _check_roots(rs, case):
    lo, hi = min(case.speeds), max(case.speeds)
    for name, br in rs.branches.items():
        v = br.omegas / br.ks
        if not (np.all(np.isfinite(br.omegas)) and np.all((v > lo) & (v < hi))):
            raise AssertionError(f"{name}: non-finite roots or phase speeds "
                                 f"outside [{lo}, {hi}]")


def phase_sweep(out: dict):
    import torch
    from eigensolver_tpu_torch import cases, search, sweep
    from eigensolver_tpu_torch.kernels import bessel
    from eigensolver_tpu_torch.kernels import cylinder as kcyl
    from eigensolver_tpu_torch.physics import cylinder as pcyl
    from eigensolver_tpu_torch.utils import StageTimer
    import warnings
    warnings.simplefilter("ignore")     # saturated-row notices, as expected
    case = cases.cylinder_density_coronal(width=0.9)
    cfg = search.SearchConfig(n_omega=256, n_bisect=18, scan_dtype="float32",
                              polish_dtype="float32")

    # the main path, with every launch counter reset just before
    kcyl.launches = 0
    bessel.launches = 0
    pcyl.plain_calls = 0
    rs, st = sweep.run_case(case, cfg, device="cuda")
    launches = {"cylinder_disp": kcyl.launches, "kve_ratio": bessel.launches,
                "plain_dispersion": pcyl.plain_calls}
    if launches["cylinder_disp"] < cfg.n_bisect + 2:
        raise AssertionError(f"main path launched cylinder_disp "
                             f"{launches['cylinder_disp']} times")
    if launches["plain_dispersion"] != 0:
        raise AssertionError("main path ran the plain dispersion")
    if st.n_candidates != N_SWEEP:
        raise AssertionError(f"{st.n_candidates} candidates")
    _check_roots(rs, case)

    walls, stages, counts = [], [], []
    for _ in range(3):
        before = kcyl.launches
        timer = StageTimer()
        rs, st = sweep.run_case(case, cfg, device="cuda", timer=timer)
        if kcyl.launches - before < cfg.n_bisect + 2 or pcyl.plain_calls:
            raise AssertionError("timed run did not go through the kernel")
        walls.append(st.wall_s)
        stages.append(timer.report())
        counts.append(rs.counts())
    if any(c != counts[0] for c in counts):
        raise AssertionError(f"f32 root counts differ between runs: {counts}")
    f32 = dict(counts=counts[0], total=sum(counts[0].values()),
               minus_jax=_check_counts(counts[0], "float32"),
               wall_s=walls, median_wall_s=statistics.median(walls),
               candidates_per_s=N_SWEEP / statistics.median(walls),
               stages_median_s={k: statistics.median(s[k] for s in stages)
                                for k in stages[0]})

    cfg64 = dataclasses.replace(cfg, scan_dtype="float64",
                                polish_dtype="float64")
    rs64, st64 = sweep.run_case(case, cfg64, device="cuda")
    _check_roots(rs64, case)
    f64 = dict(counts=rs64.counts(), total=sum(rs64.counts().values()),
               minus_jax=_check_counts(rs64.counts(), "float64"),
               wall_s=st64.wall_s)

    # a small input against the reference: the same reduced sweep on the
    # card and on the CPU (plain version, held equal to the JAX package by
    # tests/test_torch_sweep.py), and the JAX package's counts
    small = dataclasses.replace(
        case, k_values=(0.5, 2.0),
        grid=dataclasses.replace(case.grid, n_interior=256, n_axis_log=32))
    scfg = search.SearchConfig(n_omega=64, n_bisect=30)
    rs_gpu, _ = sweep.run_case(small, scfg, device="cuda")
    rs_cpu, _ = sweep.run_case(small, scfg, device="cpu")
    if not rs_gpu.counts() == rs_cpu.counts() == JAX_COUNTS_REDUCED:
        raise AssertionError(f"reduced sweep: card {rs_gpu.counts()}, cpu "
                             f"{rs_cpu.counts()}, JAX {JAX_COUNTS_REDUCED}")
    dev = max(float(np.max(np.abs(rs_gpu[b].omegas / rs_cpu[b].omegas - 1)))
              for b in rs_cpu.branches)
    if not dev <= 1e-10:
        raise AssertionError(f"reduced sweep roots card vs cpu: {dev:.3e}")

    out["sweep"] = dict(main_path_launches=launches, float32=f32,
                        float64=f64, reduced_max_rel_dev=dev)
    line("phase 5 sweep cyl_co_09", **out["sweep"])
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", help="also write the full report here")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs the port on a "
                           "CUDA card")
    import eigensolver_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device()
    out: dict = {"nvidia_smi": smi}
    phase_build()
    phase_kve_ratio(out)
    phase_cylinder_disp(out)
    launches = phase_sweep(out)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    disp = out["cylinder_disp"]
    kernels = [{
        "name": "cylinder_disp",
        "route": "cuda",
        "source": "eigensolver_tpu_torch/csrc/cylinder_disp.cu",
        # the Pallas kernel runs inlined here (csrc/kve_ratio.cuh); the rest
        # of the kernel is the XLA-fused program of physics/cylinder.py:236
        "replaces": "eigensolver_tpu/kernels/bessel.py:125",
        "launches": launches["cylinder_disp"],
        # det, poles masked, on the candidates that "ms" and "plain_ms" time
        "max_abs_err": disp["full_ms"]["check_float32"]["max_abs_err_det"],
        "ms": disp["full_ms"]["float32"],
        "plain_ms": disp["full_ms"]["plain_float32"],
    }]
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(out, indent=1, default=float))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
