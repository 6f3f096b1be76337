#!/usr/bin/env python3
"""Smoke run of the PyTorch port (eigensolver_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--json-out PATH]

Run from the repository root. Phases, one line each; any failure raises and
the script exits non-zero:

1. device: a CUDA card is required; its nvidia-smi name and power limit.
2. build: the CUDA kernels, compiled with nvcc from eigensolver_tpu_torch/csrc
   (one nvcc per source, in parallel).
3. kve_ratio: the standalone kernel once on the exterior arguments
   sqrt(m_e) > 0 of the cyl_co_09 ladder (552,600 of 552,960; launch
   counters reset just before), then, at float32 and float64, on four
   argument sets (series only, CF2 only, 552,960 shuffled over both
   branches, and the ladder's arguments in ladder order): bit-equal to its
   plain PyTorch version on each, and timed beside the torch.special call at
   both types. No sweep launches it: its math runs inside cylinder_disp.
4. cylinder_disp kernel vs its plain PyTorch version, 8,192 candidates of
   the full cyl_co_09 ladder (n_interior=2048, n_axis_log=128); at the full
   sweep's 552,960 candidates, the kernel's time and, at float32, the plain
   version's time and agreement; the kernel's registers and spills (ptxas)
   and, printed, the float64 det values whose bits differ from the plain
   version's.
5. the cylinder sweep: run_case(cylinder_density_coronal(0.9), n_omega=256,
   n_bisect=18, float32) on the card - once with the launch counters reset
   (exactly one cylinder_disp launch, the ladder scan, and one
   cylinder_bisect launch, the bracket stage; never the plain dispersion),
   then 3 timed runs, then once at float64; root counts per branch held
   against the JAX package's for the same configuration; a reduced sweep on
   the card held against the same sweep on the CPU.
6. slab_disp kernel vs its plain version, 8,192 candidates of the full
   slab_ph_09 ladder (flux form) and of slab_flow_gaussian_coronal (shear
   form); at each sweep's scan size (161,280 and 179,200 candidates) and
   at float32 and float64, the kernel's time, its bound, and the plain
   version's time and bits on the same candidates; the same at the size of
   the refine stage's float64 window launch (the 1,530 window ends of the
   slab_ph_09 float32 sweep's roots); the launch shape of each, and the
   kernel's registers and spills (ptxas). Every set bit-equal at both
   types.
7. the slab sweep: run_case(slab_density_photospheric(0.9), n_omega=256,
   n_bisect=18, float32) with the counters reset (one slab_disp and one
   slab_bisect launch, never the plain dispersion), 3 timed runs, one
   float64 run, float64 sweeps of the two flow cases, float32 sweeps with
   refine_f64=True (4 launches each: the scan, the bracket stage, the f64
   refine windows and the f64 refine bisection; once, then 3 timed runs);
   counts per branch held against the JAX package's; reduced sweeps on the
   card (float64, and float32 refined in float64) held against the same
   sweeps on the CPU.
8. cylinder_bisect and 9. slab_bisect, the fused bracket stage, on the full
   sweeps' own brackets (17,280 and 5,040) at float32 and float64: (root,
   mismatch) bit-equal to search.bisect_loop over the one-thread kernel
   (n_iter + 2 launches), both timed; at float32 and n_iter=4, bit-equal to
   the same loop over the plain PyTorch dispersion, which is timed too.
10. the twisted cylinder_disp (the compile-time variant for rotational flow
   and magnetic twist) vs its plain version, 8,192 candidates of the full
   twist_v01_p1 ladder (cylinder_twisted_photospheric(0.1, 1.0, 1)) and of
   the magnetic p = 1.25 one (cylinder_twisted_magnetic(0.1, 0.15, 1.25,
   1)), float32 and float64, bit-equal; each case's whole 76,800-
   candidate scan (ladder order, m = 1) timed at both types beside its
   bound, twist_v01_p1's plain version's time and bits at float32;
   registers and
   spills (ptxas) of every cylinder_disp instantiation.
11. the twisted sweeps: run_case(twist_v01_p1, n_omega=256, n_bisect=18,
   float32) with the counters reset (one cylinder_disp and one
   cylinder_bisect launch, never the plain dispersion), 3 timed runs, float64
   sweeps of twist_v01_p1 and of the magnetic case, one float32 run with
   refine_f64=True (4 launches); counts held against the JAX package's; a
   reduced magnetic sweep with the row-local continuum mask on the card held
   against the same sweep on the CPU and the JAX package's count.
12. the twisted cylinder_bisect on twist_v01_p1's own 2,400 brackets, as in
   phase 8 (its plain loop at n_iter=1).

Then one JSON line of the kernels (with each one's bound: the operations
the function needs on this run's inputs over the card's peak rate, or its
bytes over the memory rate, whichever is longer), the nvidia-smi line, and
last
`{"ok": true, "device": {...}}`. Imports nothing of JAX.
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
N_SLAB = 35 * 9 * 256 * 2       # slab_ph_09 candidates per sweep: 161,280
N_FLOW = 35 * 10 * 256 * 2      # slab_flow_gaussian_coronal's: 179,200
N_DISP_CHECK = 8192
# Root counts per branch of run_case on the same case and config, each with
# the band per branch that the evidence supports (None: printed beside, not
# held). All measured with the JAX package on a CPU (JAX 0.9.0, x64):
#   python tests/test_torch_ieee.py counts      (the f32 counts)
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu');
#     jax.config.update('jax_enable_x64', True)
#     from eigensolver_tpu import cases; from eigensolver_tpu.sweep import run_case
#     from eigensolver_tpu.search import SearchConfig
#     print(run_case(CASE, SearchConfig(n_omega=256, n_bisect=18,
#       scan_dtype=DT, polish_dtype=DT))[0].counts())"     (the f64 counts)
# "jax_ieee": the JAX package compiled with XLA_FLAGS="--xla_cpu_max_isa=AVX
# --xla_disable_hlo_passes=algsimp", which rounds every f32 operation once,
# as the port's kernels (--fmad=false) and plain version do. With the same
# exp and log the two are bit-equal on every f32 dispersion value
# (tests/test_torch_ieee.py), so the card's f32 counts differ from these only
# through its exp/log ulps. Bands per branch: 1% (cylinder, ~1000 roots a
# branch) and 5% (slab, 60-95 roots: 3-4 roots); measured on an H100 (NVIDIA
# H100 80GB HBM3, 700 W): cylinder +2/+6 roots (0.2%/0.4%), slab 0/0, slab
# refined 0/0.
# "jax": the JAX package as XLA compiles it by default, with fused
# multiply-adds and algebraic rewrites; its f32 counts are printed, not held
# (slab_ph_09 kink 68 against 59 rounded as IEEE does, -13%).
# float64: only sign flips within ~1e-12 of a zero can differ: +-0.25%
# (every f64 count below is met exactly on an H100).
CYL_COUNTS = {
    "float64": [("jax", {"sausage": 1709, "kink": 2238}, 0.0025)],
    "float32": [("jax_ieee", {"sausage": 880, "kink": 1477}, 0.01),
                ("jax", {"sausage": 919, "kink": 1487}, None)],
}
SLAB_COUNTS = {
    "float64": [("jax", {"sausage": 289, "kink": 238}, 0.0025)],
    "float32": [("jax_ieee", {"sausage": 94, "kink": 59}, 0.05),
                ("jax", {"sausage": 97, "kink": 68}, None)],
    # refine_f64=True keeps the f32 roots that its f64 window brackets
    "float32_refined": [("jax_ieee", {"sausage": 94, "kink": 59}, 0.05),
                        ("jax", {"sausage": 97, "kink": 68}, None)],
}
FLOW_COUNTS = {     # float64
    "slab_flow_gaussian_coronal": [("jax", {"sausage": 452, "kink": 454},
                                    0.0025)],
    "slab_flow_uniform_photospheric": [("jax", {"sausage": 208, "kink": 183},
                                        0.0025)],
}
# reduced sweep (k in {0.5, 2}, n_interior=256, n_axis_log=32, n_omega=64,
# n_bisect=30, f64): same JAX measurement, and tests/test_torch_sweep.py
JAX_COUNTS_REDUCED = {"sausage": 29, "kink": 43}
# The twisted cases (one branch, m = 1), same commands (the f32 counts:
# python tests/test_torch_ieee.py counts --cases twist_v01_p1; JAX 0.9.0 on
# a CPU). BENCH_r05.json's count of twist_v01_p1, taken on a TPU at f32
# (306), is printed beside, not held.
TWIST_COUNTS = {
    "float64": [("jax", {"kink": 306}, 0.0025)],
    "float32": [("jax_ieee", {"kink": 308}, 0.01), ("jax", {"kink": 302}, None),
                ("tpu_bench_r05", {"kink": 306}, None)],
    "float32_refined": [("jax_ieee", {"kink": 308}, 0.01),
                        ("jax", {"kink": 302}, None)],
}
MAGNETIC_COUNTS = {"float64": [("jax", {"kink": 307}, 0.0025)]}
# reduced magnetic sweep with the row mask (k in {0.8, 1.4, 2.0},
# n_interior=128, n_omega=48, n_bisect=20, f64):
# tests/test_torch_twisted_sweep.py holds the port's CPU run equal to JAX's
JAX_COUNTS_MASKED_REDUCED = {"kink": 7}
N_TWIST = 60 * 5 * 256          # twist_v01_p1 candidates per sweep: 76,800
N_BR_TWIST = 60 * 5 * 8         # its brackets: 2,400
TWIST_PLAIN_N_ITER = 1          # the plain loop's iterations in phase 12
# brackets of the full sweeps' bracket stage: rows x 8 per row
N_BR_CYL = 90 * 12 * 2 * 8      # 17,280
N_BR_SLAB = 35 * 9 * 2 * 8      # 5,040
N_BISECT = 18
PLAIN_N_ITER = 4                # the plain loop's iterations in phases 8, 9

# Operations, the least each function needs, counted from the sources for
# the Gaussian density profile of slab_ph_09 and cyl_co_09 and the Gaussian
# flow of slab_flow_gaussian_coronal (uniform density, corrected D), each
# IEEE division, square root, exp and log as one operation. The chains'
# values that depend on the abscissa alone (profile, speeds, their roots;
# U, U', U'' from one exp; in the cylinder also r r, and r = exp(t) on the
# log tail) count once per RK4 step and launch ("*_x_step", "cyl_*r_step":
# 3 abscissae and their forming); per candidate (or bracket per evaluation)
# and step, the rest of the 3 chain evaluations and the state update
# ("slab_step", "slab_shear_step", "cyl_step", "cyl_log_step"; the
# products of k alone, and in the slab's flux form, where U == 0, Omega^2,
# once per candidate); per evaluation, the start state and the epilogue
# ("*_ends"), the cylinder's without the K_m ratio, which `kve_ops` counts
# from its arguments (csrc/kve_ratio.cuh: one branch per argument, the
# series up to the first term that changes none of its sums).
# The twisted cylinder chain ("cyl_tw_*": tools_torch/count_ops.py, which
# traces the plain chain that the kernel follows operation for operation):
# per abscissa the r-only values with their r-derivatives and the chain's
# r-only products (r r, rho (c^2 + vA^2), v_phi^2, B_phi^2, rho v_phi,
# 4 (c^2 + vA^2)), 3 abscissae per step; per candidate (or bracket per
# evaluation) and step, 3 x 174 dual-chain operations with (1/F, g) and the
# update; per evaluation, the values of the chain at r = 1, F(1),
# C1(1)/C3(1), the products of k and m alone and the epilogue; once per
# launch the r-only values at r = 1 and J. An operation repeated on the same
# operands is one (a dual square is 3), a negation and a product by the
# unit tangent dr/dr = 1 are free. With B_phi = 0 (twist_v01_p1) its exact
# zeros remove every term in B_phi ("cyl_tw_b0_*").
OPS = {"slab_x_step": 67, "slab_step": 61, "slab_ends": 93,
       "slab_shear_x_step": 40, "slab_shear_step": 114, "slab_shear_ends": 64,
       "cyl_r_step": 70, "cyl_log_r_step": 73, "cyl_step": 155,
       "cyl_log_step": 161, "cyl_ends": 98,
       "cyl_tw_r_step": 298, "cyl_tw_step": 590, "cyl_tw_ends": 86,
       "cyl_tw_launch": 99, "cyl_tw_b0_step": 425, "cyl_tw_b0_ends": 76,
       "kve_cf2": 491, "kve_series": 22, "kve_term": 5}
# NVIDIA H100 SXM data sheet, outside the tensor cores, at 700 W; HBM3 rate
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
HBM_BYTES_S = 3.35e12


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


def reset_counters() -> None:
    """Set every kernel launch counter and plain-dispersion count to 0."""
    from eigensolver_tpu_torch.kernels import bessel, cylinder, slab
    from eigensolver_tpu_torch.physics import cylinder as pcyl, slab as pslab
    bessel.launches = cylinder.launches = slab.launches = 0
    cylinder.bisect_launches = slab.bisect_launches = 0
    pcyl.plain_calls = pslab.plain_calls = 0


def read_counters() -> dict:
    from eigensolver_tpu_torch.kernels import bessel, cylinder, slab
    from eigensolver_tpu_torch.physics import cylinder as pcyl, slab as pslab
    return {"cylinder_disp": cylinder.launches,
            "cylinder_bisect": cylinder.bisect_launches,
            "slab_disp": slab.launches, "slab_bisect": slab.bisect_launches,
            "kve_ratio": bessel.launches, "plain_cylinder": pcyl.plain_calls,
            "plain_slab": pslab.plain_calls}


def counts_since(before: dict) -> dict:
    now = read_counters()
    return {k: now[k] - before[k] for k in now}


def check_launches(what: str, got: dict, want: dict) -> None:
    """Every counter of got equal to want's entry, 0 where want has none."""
    bad = {k: v for k, v in got.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def bound(n_ops: float, n_bytes: float, dtype: str) -> dict:
    """The least time the card could take: operations over the peak rate of
    their type, or bytes over the memory rate, whichever is longer."""
    t_ops = n_ops / PEAK_FLOPS[dtype]
    t_bytes = n_bytes / HBM_BYTES_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def slab_ops(n: int, n_evals: int, n_interior: int,
             shear: bool = False) -> int:
    """Operations of n_evals slab chains (the flux or the shear form) on
    each of n candidates, and the x-only values once."""
    f = "slab_shear_" if shear else "slab_"
    return (n * n_evals * (n_interior * OPS[f + "step"] + OPS[f + "ends"])
            + n_interior * OPS[f + "x_step"])


def cyl_ops(n: int, n_evals: int, n_interior: int, n_axis_log: int,
            z_ext) -> int:
    """Operations of n_evals cylinder chains on each of n candidates with
    the exterior arguments z_ext (those of one evaluation), and the r-only
    values once."""
    return (n * n_evals * (n_interior * OPS["cyl_step"]
                           + n_axis_log * OPS["cyl_log_step"]
                           + OPS["cyl_ends"])
            + n_evals * kve_ops(z_ext)
            + n_interior * OPS["cyl_r_step"]
            + n_axis_log * OPS["cyl_log_r_step"])


def cyl_tw_ops(case, n: int, n_evals: int, z_ext) -> int:
    """Operations of n_evals twisted cylinder chains of `case` on each of n
    candidates (no log tail) with the exterior arguments z_ext, and the
    r-only values once; without the terms in B_phi where the case has
    none."""
    f = "cyl_tw_b0_" if case.b_twist_profile is None else "cyl_tw_"
    n_interior = case.grid.n_interior
    return (n * n_evals * (n_interior * OPS[f + "step"] + OPS[f + "ends"])
            + n_evals * kve_ops(z_ext) + n_interior * OPS["cyl_tw_r_step"]
            + OPS["cyl_tw_launch"])


def twisted_cases() -> dict:
    """The twisted configurations: bench.py's twist_v01_p1 (B_phi = 0,
    p = 1) and tests/test_btwist.py's magnetic twist (every term live)."""
    from eigensolver_tpu_torch import cases
    return {"twist_v01_p1": cases.cylinder_twisted_photospheric(0.1, 1.0, 1),
            "magnetic_p125": cases.cylinder_twisted_magnetic(0.1, 0.15, 1.25,
                                                             1)}


def kve_ops(z) -> int:
    """Operations of kve_ratio_both on the arguments z (a tensor): CF2 for
    |z| >= 2 (and NaN); else the series' fixed part and, in each of its two
    recursions, every term up to the first that changes none of its sums,
    which ends it (csrc/kve_ratio.cuh)."""
    import torch
    from eigensolver_tpu_torch.profiles import div
    small = z.abs() < 2
    zs = z[small]
    total = (OPS["kve_cf2"] * int((~small).sum())
             + OPS["kve_series"] * zs.numel())
    z2 = 0.25 * zs * zs
    for k1 in (False, True):      # the K_0 recursion, then I_1's and K_1's
        term = torch.ones_like(zs)
        a, b = term, term if k1 else torch.zeros_like(zs)
        hk, hk1 = 0.0, 1.0
        alive = torch.ones_like(zs, dtype=torch.bool)
        for j in range(1, 25):
            term = div(term * z2, j * (j + 1) if k1 else j * j)
            hk, hk1 = hk + 1.0 / j, hk1 + 1.0 / (j + 1)
            a_next = a + term
            b_next = b + term * (hk + hk1 if k1 else hk)
            total += OPS["kve_term"] * int(alive.sum())
            alive &= ~((a_next == a) & (b_next == b))
            a, b = a_next, b_next
    return total


def exterior_args(case, om, k, dtype):
    """sqrt(max(m_e, floor)), the K_m ratio's arguments of the cylinder
    candidates (om, k), in dtype."""
    import torch
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    m_e = CylinderPhysics.from_case(case).exterior_m(om.to(dtype), k.to(dtype))
    floor = torch.tensor(1e-300, dtype=dtype, device=m_e.device)
    return torch.sqrt(torch.maximum(m_e, floor))


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
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    line("phase 2 build", seconds=seconds, library=so.name, ptxas=ptxas)


def phase_kve_ratio(out: dict):
    import torch
    from eigensolver_tpu_torch import cases, special, sweep
    from eigensolver_tpu_torch.kernels import bessel
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    # the exterior arguments sqrt(m_e) the cylinder sweep evaluates (valid
    # candidates of the cyl_co_09 ladder, both modes, in ladder order)
    case = cases.cylinder_density_coronal(width=0.9)
    om, ks = sweep.build_ladders(case, 256)
    om = torch.from_numpy(np.concatenate([om.ravel()] * 2)).cuda()
    kk = torch.from_numpy(np.repeat(np.concatenate([ks] * 2), 256)).cuda()
    m_e = CylinderPhysics.from_case(case).exterior_m(om, kk)
    z_ladder = torch.sqrt(m_e[m_e > 0]).contiguous()
    z_path = z_ladder.to(torch.float32)
    reset_counters()
    r_path = bessel.kve_ratio_both(z_path)
    torch.cuda.synchronize()
    standalone = read_counters()["kve_ratio"]
    if standalone != 1 or not all(bool(r.isfinite().all()) for r in r_path):
        raise AssertionError("kve_ratio standalone run failed")

    rng = np.random.default_rng(0)
    lg2 = float(np.log10(2.0))
    sets = {  # float64; each cast to the dtype, the series set kept below 2
        "shuffled": 10.0 ** rng.uniform(-2.0, 2.3, N_SWEEP),
        "series": np.minimum(10.0 ** rng.uniform(-2.0, lg2, N_SWEEP),
                             np.nextafter(np.float32(2), np.float32(0))),
        "cf2": 10.0 ** rng.uniform(lg2, 2.3, N_SWEEP),
    }
    sets = {name: torch.from_numpy(z).cuda() for name, z in sets.items()}
    sets["ladder"] = z_ladder
    res = {"standalone": dict(n=z_path.numel(), launches=standalone)}
    for name, z64 in sets.items():
        for dtype in (torch.float32, torch.float64):
            z = z64.to(dtype)
            pairs = [(k.cpu().numpy(), p.cpu().numpy()) for k, p in zip(
                bessel.kve_ratio_both(z), special.kve_ratio_both(z))]
            differ = sum(int((~_same_bits(k, p)).sum()) for k, p in pairs)
            if differ:
                raise AssertionError(f"kve_ratio {name} {dtype}: {differ} "
                                     f"values differ from the plain version")
            res[f"{name} {str(dtype)[6:]}"] = dict(
                n=z.numel(), n_series=int((z.abs() < 2).sum()),
                bits_differ=differ,
                max_abs_err=max(float(np.nanmax(np.abs(k - p)))
                                for k, p in pairs),
                ms=cuda_ms(lambda: bessel.kve_ratio_both(z), 20),
                library_ms=cuda_ms(lambda: _library_kve_ratio(z), 20),
                plain_ms=cuda_ms(lambda: special.kve_ratio_both(z), 2),
                **bound(kve_ops(z), z.numel() * 3 * z.element_size(),
                        str(dtype)[6:]))
    out["kve_ratio"] = res
    line("phase 3 kve_ratio vs plain", **res)


def _library_kve_ratio(z):
    """(K_0'/K_0, K_1'/K_1) from PyTorch's K_0 and K_1: the yardstick of
    kve_ratio (the port never calls it; its K underflow at large z in
    float32 is not the kernel's concern)."""
    import torch
    k0 = torch.special.modified_bessel_k0(z)
    k1 = torch.special.modified_bessel_k1(z)
    return -k1 / k0, -k0 / k1 - 1.0 / z


def _ladder_candidates(case, n, seed):
    """n (omega, k, mode) candidates drawn from the case's full ladder."""
    import torch
    from eigensolver_tpu_torch import sweep
    om, ks = sweep.build_ladders(case, 256)
    rng = np.random.default_rng(seed)
    row = rng.integers(0, om.shape[0], n)
    col = rng.integers(0, om.shape[1], n)
    m = rng.integers(0, 2, n).astype(np.float64)
    return [torch.from_numpy(x).cuda() for x in (om[row, col], ks[row], m)]


def _compare_disp(what: str, kres, pres, f64: bool,
                  bits: bool = False) -> dict:
    """Hold a dispersion kernel's (det, mismatch, valid) against the plain
    version's.

    f64: det and mismatch to rtol 1e-9 away from poles (|det| > 1e6 x the
    median is masked); the values whose bits differ are counted, and held
    to 0 with `bits`. f32: det and mismatch bit-equal everywhere (NaN where
    the plain version has NaN), as the kernels are designed to be (no FMA,
    the plain version's expression order); the det signs where |det| > 1e-3
    x the median are counted as well."""
    import torch
    kdet, kmis, kval = kres
    pdet, pmis, pval = pres
    if not torch.equal(kval, pval):
        raise AssertionError(f"{what}: valid masks differ")
    if not torch.equal(kdet.isfinite(), pdet.isfinite()):
        raise AssertionError(f"{what}: finite masks differ")
    kd, pd = kdet.cpu().numpy(), pdet.cpu().numpy()
    fin = np.isfinite(pd)
    med = float(np.median(np.abs(pd[fin])))
    ok = fin & (np.abs(pd) < 1e6 * med)          # away from poles
    r = dict(n=len(pd), masked_poles=int((fin & ~ok).sum()),
             max_abs_err_det=float(np.max(np.abs(kd - pd)[ok])))
    if f64:
        km, pm = kmis.cpu().numpy(), pmis.cpu().numpy()
        r["det_bits_differ"] = int((~_same_bits(kd, pd)).sum())
        r["mismatch_bits_differ"] = int((~_same_bits(km, pm)).sum())
        r["max_rel_err_det"] = float(np.max(np.abs(kd - pd)[ok] / np.abs(pd)[ok]))
        r["max_rel_err_mismatch"] = float(np.nanmax(
            np.abs(km - pm)[ok] / np.abs(pm)[ok]))
        if not (r["max_rel_err_det"] <= 1e-9
                and r["max_rel_err_mismatch"] <= 1e-9):
            raise AssertionError(f"{what} vs plain beyond rtol 1e-9: {r}")
        if bits and (r["det_bits_differ"] or r["mismatch_bits_differ"]):
            raise AssertionError(f"{what} not bit-equal to plain: {r}")
    else:
        km, pm = kmis.cpu().numpy(), pmis.cpu().numpy()
        r["det_bits_differ"] = int((~_same_bits(kd, pd)).sum())
        r["mismatch_bits_differ"] = int((~_same_bits(km, pm)).sum())
        big = ok & (np.abs(pd) > 1e-3 * med)
        r["sign_checked"] = int(big.sum())
        r["sign_disagree"] = int(
            (np.signbit(kd[big]) != np.signbit(pd[big])).sum())
        if r["det_bits_differ"] or r["mismatch_bits_differ"]:
            raise AssertionError(f"{what} not bit-equal to plain: {r}")
    return r


def _same_bits(a, b):
    return (a == b) | (np.isnan(a) & np.isnan(b))


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
        r = _compare_disp(f"cylinder_disp {name}", kres, pres,
                          f64=dtype == torch.float64)
        r.update(ms=cuda_ms(lambda: kern(*args), 5), plain_ms=plain_ms)
        res[name] = r
    # the full sweep's scan size: the kernel at both dtypes; the plain
    # version once at float32 (the sweep's scan dtype), held against the
    # kernel on the same candidates
    om_f, k_f, m_f = _ladder_candidates(case, N_SWEEP, seed=2)
    full = {}
    g = case.grid
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        args = [x.to(dtype) for x in (om_f, k_f, m_f)]
        kern = ph.make_dispersion(m=None, dtype=dtype)
        full[name] = cuda_ms(lambda: kern(*args), 3)
        full[f"bound_{name}"] = bound(
            cyl_ops(N_SWEEP, 1, g.n_interior, g.n_axis_log,
                    exterior_args(case, om_f, k_f, dtype)),
            N_SWEEP * (5 * args[0].element_size() + 1), name)
    args = [x.to(torch.float32) for x in (om_f, k_f, m_f)]
    kres = ph.make_dispersion(m=None, dtype=torch.float32)(*args)
    plain = ph.make_dispersion_plain(m=None, dtype=torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pres = plain(*args)
    torch.cuda.synchronize()
    full["plain_float32"] = 1e3 * (time.perf_counter() - t0)
    full["check_float32"] = _compare_disp("cylinder_disp full float32", kres,
                                          pres, f64=False)
    res["full_ms"] = full
    res["ptxas"] = ptxas_report("cylinder_disp_kernel", CYL_FORMS)
    out["cylinder_disp"] = res
    line("phase 4 cylinder_disp vs plain", **res)


# the bool template argument of each scan kernel, by its value
SLAB_FORMS = {"0": " flux", "1": " shear", None: ""}
CYL_FORMS = {"0": "", "1": " twisted", None: ""}


def ptxas_report(kernel: str, form: dict = SLAB_FORMS) -> dict:
    """Registers and spill bytes of each instantiation of `kernel`, from
    the build's ptxas report (-Xptxas -v), keyed by type, form (the slab's
    flux or shear, the cylinder's plain or twisted chain) and block size."""
    import re
    from eigensolver_tpu_torch.kernels import _build
    log = _build.library_path().with_suffix(".log").read_text()
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            continue
        if name is None:
            continue
        # kernel<T, [bool form,] int threads>
        t = re.search(kernel + r"I([fd])(?:Lb([01])E)?Li(\d+)E", name)
        key = (f"{'float32' if t.group(1) == 'f' else 'float64'}"
               f"{form[t.group(2)]} {t.group(3)}" if t else name)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(key, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def _check_counts(what: str, counts: dict, refs) -> dict:
    """Hold per-branch root counts against each (source, counts, band) of
    refs (band None: not held); return the differences per source and
    branch."""
    diff = {}
    for source, want, band in refs:
        for branch, n in want.items():
            got = counts[branch]
            if band is not None and abs(got - n) > band * n:
                raise AssertionError(
                    f"{what}: {branch} {got} roots, {source} {n} (band "
                    f"+-{band:.2%} per branch); all counts {counts}")
            diff[f"{source}_{branch}"] = got - n
    return diff


def _check_roots(rs, case):
    lo, hi = min(case.speeds), max(case.speeds)
    for name, br in rs.branches.items():
        v = br.omegas / br.ks
        if not (np.all(np.isfinite(br.omegas)) and np.all((v > lo) & (v < hi))):
            raise AssertionError(f"{name}: non-finite roots or phase speeds "
                                 f"outside [{lo}, {hi}]")


def phase_sweep(out: dict):
    from eigensolver_tpu_torch import cases, search, sweep
    from eigensolver_tpu_torch.utils import StageTimer
    import warnings
    warnings.simplefilter("ignore")     # saturated-row notices, as expected
    case = cases.cylinder_density_coronal(width=0.9)
    cfg = search.SearchConfig(n_omega=256, n_bisect=18, scan_dtype="float32",
                              polish_dtype="float32")

    # the cylinder path, with every launch counter reset just before: one
    # ladder scan launch and one fused bracket-stage launch, nothing else
    reset_counters()
    rs, st = sweep.run_case(case, cfg, device="cuda")
    launches = read_counters()
    check_launches("cylinder path", launches,
                   {"cylinder_disp": 1, "cylinder_bisect": 1})
    if st.n_candidates != N_SWEEP:
        raise AssertionError(f"{st.n_candidates} candidates")
    _check_roots(rs, case)

    walls, stages, counts = [], [], []
    for _ in range(3):
        before = read_counters()
        timer = StageTimer()
        rs, st = sweep.run_case(case, cfg, device="cuda", timer=timer)
        check_launches("timed cylinder run", counts_since(before),
                       {"cylinder_disp": 1, "cylinder_bisect": 1})
        walls.append(st.wall_s)
        stages.append(timer.report())
        counts.append(rs.counts())
    if any(c != counts[0] for c in counts):
        raise AssertionError(f"f32 root counts differ between runs: {counts}")
    f32 = dict(counts=counts[0], total=sum(counts[0].values()),
               minus_refs=_check_counts("cyl_co_09 float32", counts[0],
                                        CYL_COUNTS["float32"]),
               wall_s=walls, median_wall_s=statistics.median(walls),
               candidates_per_s=N_SWEEP / statistics.median(walls),
               stages_median_s={k: statistics.median(s[k] for s in stages)
                                for k in stages[0]})

    cfg64 = dataclasses.replace(cfg, scan_dtype="float64",
                                polish_dtype="float64")
    rs64, st64 = sweep.run_case(case, cfg64, device="cuda")
    _check_roots(rs64, case)
    f64 = dict(counts=rs64.counts(), total=sum(rs64.counts().values()),
               minus_refs=_check_counts("cyl_co_09 float64", rs64.counts(),
                                        CYL_COUNTS["float64"]),
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


def window_candidates(case):
    """The float64 window ends of the refine stage of the case's float32
    sweep (n_omega=256, n_bisect=18, on the card): 10 per root, in the
    order of the stage's one dispersion call, as CUDA tensors (omega, k,
    parity)."""
    import torch
    from eigensolver_tpu_torch import search, sweep
    cfg = search.SearchConfig(n_omega=256, n_bisect=18, scan_dtype="float32",
                              polish_dtype="float32")
    rs, _ = sweep.run_case(case, cfg, device="cuda")
    br = [(m, rs[name]) for m, name in sweep.MODE_NAMES.items()]
    om, kk, md = (torch.from_numpy(np.concatenate(x)).to(
        device="cuda", dtype=torch.float64) for x in (
        [b.omegas for _, b in br], [b.ks for _, b in br],
        [np.full(len(b.ks), float(m)) for m, b in br]))
    return list(search.refine_window_ends(om, kk, md)[2])


def _time_against_plain(what: str, ph, args, shear: bool) -> dict:
    """slab_disp on the candidates args: its time and bound; the plain
    version's time and bits on the same candidates."""
    import torch
    from eigensolver_tpu_torch.kernels import slab as kslab
    dtype = args[0].dtype
    dname = str(dtype).split(".")[-1]
    n = args[0].numel()
    kern = ph.make_dispersion(parity=None, dtype=dtype)
    r = dict(n=n, shape=list(kslab.scan_shape(n, shear)),
             ms=cuda_ms(lambda: kern(*args), 5),
             **bound(slab_ops(n, 1, ph.case.grid.n_interior, shear),
                     n * (5 * args[0].element_size() + 1), dname))
    kres = kern(*args)
    plain = ph.make_dispersion_plain(parity=None, dtype=dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pres = plain(*args)
    torch.cuda.synchronize()
    r["plain_ms"] = 1e3 * (time.perf_counter() - t0)
    r["check"] = _compare_disp(what, kres, pres, f64=dtype == torch.float64,
                               bits=True)
    return r


def phase_slab_disp(out: dict):
    import torch
    from eigensolver_tpu_torch import cases
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    res = {}
    forms = (("flux slab_ph_09", cases.slab_density_photospheric(0.9), N_SLAB),
             ("shear flow_gauss", cases.slab_flow_gaussian_coronal(), N_FLOW))
    for name, case, _ in forms:
        ph = SlabPhysics.from_case(case)
        om, k, par = _ladder_candidates(case, N_DISP_CHECK, seed=3)
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[-1]
            args = [x.to(dtype) for x in (om, k, par)]
            kern = ph.make_dispersion(parity=None, dtype=dtype)
            plain = ph.make_dispersion_plain(parity=None, dtype=dtype)
            kres = kern(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pres = plain(*args)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            r = _compare_disp(f"slab_disp {name} {dname}", kres, pres,
                              f64=dtype == torch.float64, bits=True)
            r.update(ms=cuda_ms(lambda: kern(*args), 5), plain_ms=plain_ms)
            res[f"{name} {dname}"] = r
    # each form at its sweep's scan size, both types
    full = {}
    for name, case, n in forms:
        ph = SlabPhysics.from_case(case)
        cand = _ladder_candidates(case, n, seed=4)
        for dtype in (torch.float32, torch.float64):
            what = f"{name} {str(dtype).split('.')[-1]}"
            full[what] = _time_against_plain(
                f"slab_disp full {what}", ph, [x.to(dtype) for x in cand],
                shear=name.startswith("shear"))
    res["full"] = full
    # the refine stage's float64 window launch of the slab_ph_09 f32 sweep
    case = forms[0][1]
    res["window float64"] = _time_against_plain(
        "slab_disp window float64", SlabPhysics.from_case(case),
        window_candidates(case), shear=False)
    res["ptxas"] = ptxas_report("slab_disp_kernel")
    out["slab_disp"] = res
    line("phase 6 slab_disp vs plain", **res)


def phase_slab_sweep(out: dict):
    from eigensolver_tpu_torch import cases, search, sweep
    from eigensolver_tpu_torch.utils import StageTimer
    import warnings
    warnings.simplefilter("ignore")     # saturated-row notices, as expected
    case = cases.slab_density_photospheric(0.9)
    cfg = search.SearchConfig(n_omega=256, n_bisect=18, scan_dtype="float32",
                              polish_dtype="float32")

    # the slab path, with every launch counter reset just before: one
    # ladder scan launch and one fused bracket-stage launch, nothing else
    reset_counters()
    rs, st = sweep.run_case(case, cfg, device="cuda")
    launches = read_counters()
    check_launches("slab path", launches, {"slab_disp": 1, "slab_bisect": 1})
    if st.n_candidates != N_SLAB:
        raise AssertionError(f"{st.n_candidates} candidates")
    _check_roots(rs, case)

    walls, stages, counts = [], [], []
    for _ in range(3):
        before = read_counters()
        timer = StageTimer()
        rs, st = sweep.run_case(case, cfg, device="cuda", timer=timer)
        check_launches("timed slab run", counts_since(before),
                       {"slab_disp": 1, "slab_bisect": 1})
        walls.append(st.wall_s)
        stages.append(timer.report())
        counts.append(rs.counts())
    if any(c != counts[0] for c in counts):
        raise AssertionError(f"f32 root counts differ between runs: {counts}")
    f32 = dict(counts=counts[0],
               minus_refs=_check_counts("slab_ph_09 float32", counts[0],
                                        SLAB_COUNTS["float32"]),
               wall_s=walls, median_wall_s=statistics.median(walls),
               candidates_per_s=N_SLAB / statistics.median(walls),
               stages_median_s={k: statistics.median(s[k] for s in stages)
                                for k in stages[0]})

    cfg64 = dataclasses.replace(cfg, scan_dtype="float64",
                                polish_dtype="float64")
    rs64, st64 = sweep.run_case(case, cfg64, device="cuda")
    _check_roots(rs64, case)
    f64 = dict(counts=rs64.counts(),
               minus_refs=_check_counts("slab_ph_09 float64", rs64.counts(),
                                        SLAB_COUNTS["float64"]),
               wall_s=st64.wall_s)

    flows = {}
    for name, refs in FLOW_COUNTS.items():
        fcase = getattr(cases, name)()
        frs, fst = sweep.run_case(fcase, cfg64, device="cuda")
        _check_roots(frs, fcase)
        flows[name] = dict(counts=frs.counts(), wall_s=fst.wall_s,
                           minus_refs=_check_counts(f"{name} float64",
                                                    frs.counts(), refs))

    # f32 sweep refined in f64 on the card: the scan and the bracket stage,
    # then the f64 refine windows (one slab_disp launch) and the f64 refine
    # bisection (one slab_bisect launch); once, then 3 timed runs
    walls, stages = [], []
    for _ in range(4):
        before = read_counters()
        timer = StageTimer()
        rsr, str_ = sweep.run_case(case, cfg, device="cuda", refine_f64=True,
                                   timer=timer)
        refined_launches = counts_since(before)
        check_launches("refined slab path", refined_launches,
                       {"slab_disp": 2, "slab_bisect": 2})
        _check_roots(rsr, case)
        if rsr.counts() != counts[0]:
            raise AssertionError(f"refined counts {rsr.counts()} differ from "
                                 f"the f32 sweep's {counts[0]}")
        walls.append(str_.wall_s)
        stages.append(timer.report())
    walls, stages = walls[1:], stages[1:]
    refined = dict(counts=rsr.counts(), wall_s=walls,
                   median_wall_s=statistics.median(walls),
                   stages_median_s={k: statistics.median(s[k] for s in stages)
                                    for k in stages[0]},
                   launches=refined_launches,
                   minus_refs=_check_counts(
                       "slab_ph_09 float32 refined", rsr.counts(),
                       SLAB_COUNTS["float32_refined"]))

    # a small input against the reference: the same reduced sweep on the
    # card and on the CPU (plain version, held equal to the JAX package by
    # tests/test_torch_sweep.py)
    small = dataclasses.replace(
        case, k_values=(0.5, 1.5, 2.5, 3.5),
        grid=dataclasses.replace(case.grid, n_interior=256))
    scfg = search.SearchConfig(n_omega=64, n_bisect=30)
    rs_gpu, _ = sweep.run_case(small, scfg, device="cuda")
    rs_cpu, _ = sweep.run_case(small, scfg, device="cpu")
    if rs_gpu.counts() != rs_cpu.counts():
        raise AssertionError(f"reduced slab sweep: card {rs_gpu.counts()}, "
                             f"cpu {rs_cpu.counts()}")
    dev = max(float(np.max(np.abs(rs_gpu[b].omegas / rs_cpu[b].omegas - 1)))
              for b in rs_cpu.branches)
    if not dev <= 1e-10:
        raise AssertionError(f"reduced slab sweep roots card vs cpu: {dev:.3e}")

    # the refinement on the card against the same on the CPU: a reduced
    # uniform-flow sweep (shear form) at f32, refined in f64 (the CPU run is
    # held equal to the JAX package's by tests/test_torch_sweep.py)
    flow = cases.slab_flow_uniform_photospheric()
    small = dataclasses.replace(
        flow, k_values=(0.5, 1.5, 2.5, 3.5),
        grid=dataclasses.replace(flow.grid, n_interior=256))
    scfg = search.SearchConfig(n_omega=64, n_bisect=18, scan_dtype="float32",
                               polish_dtype="float32")
    rf_gpu, _ = sweep.run_case(small, scfg, device="cuda", refine_f64=True)
    rf_cpu, _ = sweep.run_case(small, scfg, device="cpu", refine_f64=True)
    if rf_gpu.counts() != rf_cpu.counts():
        raise AssertionError(f"reduced refined sweep: card {rf_gpu.counts()}, "
                             f"cpu {rf_cpu.counts()}")
    rdev = max(float(np.max(np.abs(rf_gpu[b].omegas / rf_cpu[b].omegas - 1)))
               for b in rf_cpu.branches)
    if not rdev <= 1e-12:
        raise AssertionError(f"reduced refined roots card vs cpu: {rdev:.3e}")

    out["slab_sweep"] = dict(main_path_launches=launches, float32=f32,
                             float64=f64, flows_float64=flows,
                             float32_refined=refined,
                             reduced_counts=rs_gpu.counts(),
                             reduced_max_rel_dev=dev,
                             reduced_refined_counts=rf_gpu.counts(),
                             reduced_refined_max_rel_dev=rdev)
    line("phase 7 sweep slab_ph_09", **out["slab_sweep"])
    return launches


def sweep_brackets(case, dtype):
    """The brackets of the case's bracket stage (n_omega=256, 8 per row,
    the case's modes, scan in `dtype` on the card), as CUDA tensors (lo,
    hi, k, mode)."""
    import torch
    from eigensolver_tpu_torch import search, sweep
    omegas, ks = sweep.build_ladders(case, 256)
    rows = omegas.shape[0]
    n_modes = len(case.modes)

    def dev(a):
        return torch.from_numpy(a).to(device="cuda", dtype=dtype)

    om = dev(np.concatenate([omegas] * n_modes))
    kk = dev(np.concatenate([ks] * n_modes))
    md = dev(np.repeat([float(m) for m in case.modes], rows))
    disp = sweep.make_dispersion_moded(case, dtype)
    det, valid, mism = search.ladder_scan(disp, om, kk, md)
    br = search.find_brackets(om, kk, det, valid, 8, md, mism=mism)
    return [x.contiguous() for x in (br.lo, br.hi, br.k, br.mode)]


def phase_bisect(out: dict, phase: str, name: str, case, plain, n_br: int,
                 ops, key: str = None, plain_n_iter: int = PLAIN_N_ITER):
    """The fused bracket stage `name` on the case's own brackets: (root,
    mismatch) bit-equal to the loop of one-thread launches at float32 and
    float64 (both timed), and at float32 with n_iter=plain_n_iter to the
    loop over the plain dispersion `plain(dtype)` (timed once); the bound
    from `ops(brackets, dtype)`, the operations of the launch. The report
    goes to out[key or name]."""
    import torch
    from eigensolver_tpu_torch import search, sweep
    res = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        br = sweep_brackets(case, dtype)
        if br[0].numel() != n_br:
            raise AssertionError(f"{name}: {br[0].numel()} brackets")
        disp = sweep.make_dispersion_moded(case, dtype)
        before = read_counters()
        fused = disp.bisect(*br, N_BISECT)
        loop = search.bisect_loop(disp, *br, N_BISECT)
        torch.cuda.synchronize()
        check_launches(f"{name} {dname}", counts_since(before),
                       {name: 1, name.replace("bisect", "disp"): N_BISECT + 2})
        differ = [int((~_same_bits(a.cpu().numpy(), b.cpu().numpy())).sum())
                  for a, b in zip(fused, loop)]
        if any(differ):
            raise AssertionError(f"{name} {dname}: {differ} (root, mismatch) "
                                 f"values differ from the launch loop")
        r = dict(n=n_br, root_bits_differ=differ[0],
                 mismatch_bits_differ=differ[1],
                 ms=cuda_ms(lambda: disp.bisect(*br, N_BISECT), 5),
                 loop_ms=cuda_ms(lambda: search.bisect_loop(disp, *br,
                                                            N_BISECT), 2),
                 **bound(ops(br, dtype), n_br * 6 * br[0].element_size(),
                         dname))
        if dtype == torch.float32:
            pdisp = plain(dtype)
            fused4 = disp.bisect(*br, plain_n_iter)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain4 = search.bisect_loop(pdisp, *br, plain_n_iter)
            torch.cuda.synchronize()
            r["plain_ms"] = 1e3 * (time.perf_counter() - t0)
            r["plain_n_iter"] = plain_n_iter
            r["ms_plain_n_iter"] = cuda_ms(
                lambda: disp.bisect(*br, plain_n_iter), 5)
            a, b = fused4[0].cpu().numpy(), plain4[0].cpu().numpy()
            r["max_abs_err_vs_plain"] = float(np.nanmax(np.abs(a - b)))
            differ = [int((~_same_bits(x.cpu().numpy(), y.cpu().numpy())).sum())
                      for x, y in zip(fused4, plain4)]
            if any(differ):
                raise AssertionError(f"{name}: {differ} (root, mismatch) "
                                     f"values differ from the plain loop")
        res[dname] = r
    out[key or name] = res
    line(phase, **res)


def phase_twisted_disp(out: dict):
    import torch
    from eigensolver_tpu_torch import sweep
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    res = {}
    for name, case in twisted_cases().items():
        ph = CylinderPhysics.from_case(case)
        om, k, m = _ladder_candidates(case, N_DISP_CHECK, seed=7)
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[-1]
            args = [x.to(dtype) for x in (om, k, m)]
            kern = ph.make_dispersion(m=None, dtype=dtype)
            plain = ph.make_dispersion_plain(m=None, dtype=dtype)
            kres = kern(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pres = plain(*args)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            r = _compare_disp(f"twisted cylinder_disp {name} {dname}", kres,
                              pres, f64=dtype == torch.float64, bits=True)
            r.update(ms=cuda_ms(lambda: kern(*args), 5), plain_ms=plain_ms)
            res[f"{name} {dname}"] = r
    # each case's whole scan as its sweep gives it: the ladder in order,
    # m = 1; the kernel at both types beside its bound; twist_v01_p1's
    # plain version once at float32
    full = {}
    for case_name, case in twisted_cases().items():
        ph = CylinderPhysics.from_case(case)
        omegas, ks = sweep.build_ladders(case, 256)
        om_f = torch.from_numpy(omegas.ravel()).cuda()
        k_f = torch.from_numpy(np.repeat(ks, omegas.shape[1])).cuda()
        m_f = torch.ones_like(om_f)
        if om_f.numel() != N_TWIST:
            raise AssertionError(f"{om_f.numel()} twisted candidates")
        r = full[case_name] = {"n": N_TWIST}
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[-1]
            args = [x.to(dtype) for x in (om_f, k_f, m_f)]
            kern = ph.make_dispersion(m=None, dtype=dtype)
            r[name] = cuda_ms(lambda: kern(*args), 5)
            r[f"bound_{name}"] = bound(
                cyl_tw_ops(case, N_TWIST, 1,
                           exterior_args(case, om_f, k_f, dtype)),
                N_TWIST * (5 * args[0].element_size() + 1), name)
        if case_name != "twist_v01_p1":
            continue
        args = [x.to(torch.float32) for x in (om_f, k_f, m_f)]
        kres = ph.make_dispersion(m=None, dtype=torch.float32)(*args)
        plain = ph.make_dispersion_plain(m=None, dtype=torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pres = plain(*args)
        torch.cuda.synchronize()
        r["plain_float32"] = 1e3 * (time.perf_counter() - t0)
        r["check_float32"] = _compare_disp(
            "twisted cylinder_disp full float32", kres, pres, f64=False)
    res["full_ms"] = full
    res["ptxas"] = ptxas_report("cylinder_disp_kernel", CYL_FORMS)
    out["twisted_disp"] = res
    line("phase 10 twisted cylinder_disp vs plain", **res)


def phase_twisted_sweep(out: dict):
    from eigensolver_tpu_torch import search, sweep
    from eigensolver_tpu_torch.equilibrium import genuine_continua_rowfn
    from eigensolver_tpu_torch.utils import StageTimer
    import warnings
    warnings.simplefilter("ignore")     # saturated-row notices, as expected
    cases_ = twisted_cases()
    case = cases_["twist_v01_p1"]
    cfg = search.SearchConfig(n_omega=256, n_bisect=18, scan_dtype="float32",
                              polish_dtype="float32")

    # the twisted path, with every launch counter reset just before
    reset_counters()
    rs, st = sweep.run_case(case, cfg, device="cuda")
    launches = read_counters()
    check_launches("twisted path", launches,
                   {"cylinder_disp": 1, "cylinder_bisect": 1})
    if st.n_candidates != N_TWIST:
        raise AssertionError(f"{st.n_candidates} candidates")
    _check_roots(rs, case)

    walls, stages, counts = [], [], []
    for _ in range(3):
        before = read_counters()
        timer = StageTimer()
        rs, st = sweep.run_case(case, cfg, device="cuda", timer=timer)
        check_launches("timed twisted run", counts_since(before),
                       {"cylinder_disp": 1, "cylinder_bisect": 1})
        walls.append(st.wall_s)
        stages.append(timer.report())
        counts.append(rs.counts())
    if any(c != counts[0] for c in counts):
        raise AssertionError(f"f32 root counts differ between runs: {counts}")
    f32 = dict(counts=counts[0],
               minus_refs=_check_counts("twist_v01_p1 float32", counts[0],
                                        TWIST_COUNTS["float32"]),
               wall_s=walls, median_wall_s=statistics.median(walls),
               candidates_per_s=N_TWIST / statistics.median(walls),
               stages_median_s={k: statistics.median(s[k] for s in stages)
                                for k in stages[0]})

    cfg64 = dataclasses.replace(cfg, scan_dtype="float64",
                                polish_dtype="float64")
    f64 = {}
    for name, refs in (("twist_v01_p1", TWIST_COUNTS["float64"]),
                       ("magnetic_p125", MAGNETIC_COUNTS["float64"])):
        rs64, st64 = sweep.run_case(cases_[name], cfg64, device="cuda")
        _check_roots(rs64, cases_[name])
        f64[name] = dict(counts=rs64.counts(), wall_s=st64.wall_s,
                         minus_refs=_check_counts(f"{name} float64",
                                                  rs64.counts(), refs))

    # f32 refined in f64 on the card: 4 launches
    before = read_counters()
    rsr, str_ = sweep.run_case(case, cfg, device="cuda", refine_f64=True)
    refined_launches = counts_since(before)
    check_launches("refined twisted path", refined_launches,
                   {"cylinder_disp": 2, "cylinder_bisect": 2})
    _check_roots(rsr, case)
    refined = dict(counts=rsr.counts(), wall_s=str_.wall_s,
                   launches=refined_launches,
                   minus_refs=_check_counts("twist_v01_p1 float32 refined",
                                            rsr.counts(),
                                            TWIST_COUNTS["float32_refined"]))

    # a small input against the reference: the reduced magnetic sweep with
    # the row-local continuum mask on the card and on the CPU (the CPU run
    # held equal to the JAX package's by tests/test_torch_twisted_sweep.py)
    mag = cases_["magnetic_p125"]
    small = dataclasses.replace(
        mag, k_values=(0.8, 1.4, 2.0),
        grid=dataclasses.replace(mag.grid, n_interior=128))
    scfg = search.SearchConfig(n_omega=48, n_bisect=20,
                               exclude_omega_rowfn=genuine_continua_rowfn(small))
    rs_gpu, _ = sweep.run_case(small, scfg, device="cuda")
    rs_cpu, _ = sweep.run_case(small, scfg, device="cpu")
    if not rs_gpu.counts() == rs_cpu.counts() == JAX_COUNTS_MASKED_REDUCED:
        raise AssertionError(f"reduced masked sweep: card {rs_gpu.counts()}, "
                             f"cpu {rs_cpu.counts()}, JAX "
                             f"{JAX_COUNTS_MASKED_REDUCED}")
    dev = max(float(np.max(np.abs(rs_gpu[b].omegas / rs_cpu[b].omegas - 1)))
              for b in rs_cpu.branches)
    if not dev <= 1e-10:
        raise AssertionError(f"reduced masked roots card vs cpu: {dev:.3e}")

    out["twisted_sweep"] = dict(main_path_launches=launches, float32=f32,
                                float64=f64, float32_refined=refined,
                                reduced_masked_counts=rs_gpu.counts(),
                                reduced_masked_max_rel_dev=dev)
    line("phase 11 twisted sweeps", **out["twisted_sweep"])
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
    cyl_launches = phase_sweep(out)
    phase_slab_disp(out)
    slab_launches = phase_slab_sweep(out)
    from eigensolver_tpu_torch import cases
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    cyl_case = cases.cylinder_density_coronal(0.9)
    slab_case = cases.slab_density_photospheric(0.9)
    cg, sg = cyl_case.grid, slab_case.grid
    n_evals = N_BISECT + 2
    # the K_m ratio of each evaluation counted at the bracket's lower end
    phase_bisect(out, "phase 8 cylinder_bisect", "cylinder_bisect", cyl_case,
                 lambda dt: CylinderPhysics.from_case(
                     cyl_case).make_dispersion_plain(m=None, dtype=dt),
                 N_BR_CYL,
                 lambda br, dt: cyl_ops(
                     N_BR_CYL, n_evals, cg.n_interior, cg.n_axis_log,
                     exterior_args(cyl_case, br[0], br[2], dt)))
    phase_bisect(out, "phase 9 slab_bisect", "slab_bisect", slab_case,
                 lambda dt: SlabPhysics.from_case(
                     slab_case).make_dispersion_plain(parity=None, dtype=dt),
                 N_BR_SLAB,
                 lambda br, dt: slab_ops(N_BR_SLAB, n_evals, sg.n_interior))
    phase_twisted_disp(out)
    tw_launches = phase_twisted_sweep(out)
    tw_case = twisted_cases()["twist_v01_p1"]
    phase_bisect(out, "phase 12 twisted cylinder_bisect", "cylinder_bisect",
                 tw_case,
                 lambda dt: CylinderPhysics.from_case(
                     tw_case).make_dispersion_plain(m=None, dtype=dt),
                 N_BR_TWIST,
                 lambda br, dt: cyl_tw_ops(
                     tw_case, N_BR_TWIST, n_evals,
                     exterior_args(tw_case, br[0], br[2], dt)),
                 key="twisted_bisect", plain_n_iter=TWIST_PLAIN_N_ITER)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    kve = out["kve_ratio"]
    cyl = out["cylinder_disp"]["full_ms"]
    slab = out["slab_disp"]["full"]
    sf32 = slab["flux slab_ph_09 float32"]
    cbis = out["cylinder_bisect"]["float32"]
    sbis = out["slab_bisect"]["float32"]
    kve_f32 = kve["shuffled float32"]
    tw = out["twisted_disp"]["full_ms"]["twist_v01_p1"]
    tw_mag = out["twisted_disp"]["full_ms"]["magnetic_p125"]
    tbis = out["twisted_bisect"]
    kernels = [{
        "name": "cylinder_disp",
        "route": "cuda",
        "source": "eigensolver_tpu_torch/csrc/cylinder_disp.cu",
        # the XLA-fused program of physics/cylinder.py, with the Pallas
        # kernel's math (csrc/kve_ratio.cuh) inlined for the exterior
        "replaces": "eigensolver_tpu/physics/cylinder.py:236",
        "launches": cyl_launches["cylinder_disp"],
        # det, poles masked, on the candidates that "ms" and "plain_ms" time
        "max_abs_err": cyl["check_float32"]["max_abs_err_det"],
        "ms": cyl["float32"],
        "plain_ms": cyl["plain_float32"],
        **cyl["bound_float32"],
        "library_ms": None,
        # the compile-time variant for the twisted chain (the XLA program's
        # coefficients with jax.jvp, physics/cylinder.py:189), on
        # twist_v01_p1's 76,800 ladder candidates: its launches on the
        # twisted main path (phase 11), float32 unless said
        "twisted": {
            "replaces": "eigensolver_tpu/physics/cylinder.py:189",
            "n": N_TWIST,
            "launches": tw_launches["cylinder_disp"],
            "max_abs_err": tw["check_float32"]["max_abs_err_det"],
            "ms": tw["float32"], "plain_ms": tw["plain_float32"],
            **tw["bound_float32"],
            "float64_ms": tw["float64"],
            "float64_bound_ms": tw["bound_float64"]["bound_ms"],
            "library_ms": None,
            # the magnetic case's 76,800 (every term of the chain live)
            "magnetic_p125": {
                "ms": tw_mag["float32"],
                "bound_ms": tw_mag["bound_float32"]["bound_ms"],
                "float64_ms": tw_mag["float64"],
                "float64_bound_ms": tw_mag["bound_float64"]["bound_ms"]},
        },
    }, {
        "name": "kve_ratio",
        "route": "cuda",
        "source": "eigensolver_tpu_torch/csrc/kve_ratio.cu",
        "replaces": "eigensolver_tpu/kernels/bessel.py:125",
        # no main path launches it: its math (csrc/kve_ratio.cuh) runs inside
        # cylinder_disp's thread. Its own launch is phase 3's standalone run
        # on the cylinder sweep's exterior arguments; the other numbers here
        # are from phase 3's 552,960 shuffled float32 arguments.
        "launches": cyl_launches["kve_ratio"] + slab_launches["kve_ratio"],
        "inlined_in": "cylinder_disp",
        "standalone_launches": kve["standalone"]["launches"],
        "max_abs_err": kve_f32["max_abs_err"],
        "ms": kve_f32["ms"],
        "plain_ms": kve_f32["plain_ms"],
        "bound_ms": kve_f32["bound_ms"],
        "bound_by": kve_f32["bound_by"],
        # torch.special.modified_bessel_k0/_k1 and the ratios, a yardstick
        "library_ms": kve_f32["library_ms"],
    }, {
        "name": "slab_disp",
        "route": "cuda",
        "source": "eigensolver_tpu_torch/csrc/slab_disp.cu",
        # the XLA-fused lax.scan program of physics/slab.py (no Pallas
        # original), flux and shear forms
        "replaces": "eigensolver_tpu/physics/slab.py:285",
        "launches": slab_launches["slab_disp"],
        # det, poles masked, at slab_ph_09's scan size (flux form, f32);
        # bit-equal there and on every other set of phase 6
        "max_abs_err": sf32["check"]["max_abs_err_det"],
        "ms": sf32["ms"],
        "plain_ms": sf32["plain_ms"],
        "bound_ms": sf32["bound_ms"],
        "bound_by": sf32["bound_by"],
        "library_ms": None,
        "launch_shape": sf32["shape"],
        # the other forms and types, and the refine stage's window launch
        **{key: {f: r[f] for f in ("n", "shape", "ms", "plain_ms",
                                   "bound_ms", "bound_by")}
           for key, r in (("flux float64", slab["flux slab_ph_09 float64"]),
                          ("shear float32",
                           slab["shear flow_gauss float32"]),
                          ("shear float64",
                           slab["shear flow_gauss float64"]),
                          ("window float64",
                           out["slab_disp"]["window float64"]))},
    }, {
        "name": "cylinder_bisect",
        "route": "cuda",
        "source": "eigensolver_tpu_torch/csrc/cylinder_disp.cu",
        # the XLA fori_loop of search.bisect over physics/cylinder.py
        "replaces": "eigensolver_tpu/search.py:142",
        "launches": cyl_launches["cylinder_bisect"],
        # roots against the plain loop at plain_n_iter (bit-equal)
        "max_abs_err": cbis["max_abs_err_vs_plain"],
        "ms": cbis["ms"],
        "plain_ms": cbis["plain_ms"],
        "plain_n_iter": PLAIN_N_ITER,
        "ms_plain_n_iter": cbis["ms_plain_n_iter"],
        "launch_loop_ms": cbis["loop_ms"],
        "bound_ms": cbis["bound_ms"],
        "bound_by": cbis["bound_by"],
        "library_ms": None,
        # the twisted chain's fused bisection on twist_v01_p1's 2,400
        # brackets (phase 12), its launches on the twisted main path
        "twisted": {
            "n": N_BR_TWIST,
            "launches": tw_launches["cylinder_bisect"],
            "max_abs_err": tbis["float32"]["max_abs_err_vs_plain"],
            "ms": tbis["float32"]["ms"],
            "plain_ms": tbis["float32"]["plain_ms"],
            "plain_n_iter": TWIST_PLAIN_N_ITER,
            "ms_plain_n_iter": tbis["float32"]["ms_plain_n_iter"],
            "launch_loop_ms": tbis["float32"]["loop_ms"],
            "bound_ms": tbis["float32"]["bound_ms"],
            "bound_by": tbis["float32"]["bound_by"],
            "float64_ms": tbis["float64"]["ms"],
            "float64_bound_ms": tbis["float64"]["bound_ms"],
            "library_ms": None,
        },
    }, {
        "name": "slab_bisect",
        "route": "cuda",
        "source": "eigensolver_tpu_torch/csrc/slab_disp.cu",
        # the XLA fori_loop of search.bisect over physics/slab.py
        "replaces": "eigensolver_tpu/search.py:142",
        "launches": slab_launches["slab_bisect"],
        "max_abs_err": sbis["max_abs_err_vs_plain"],
        "ms": sbis["ms"],
        "plain_ms": sbis["plain_ms"],
        "plain_n_iter": PLAIN_N_ITER,
        "ms_plain_n_iter": sbis["ms_plain_n_iter"],
        "launch_loop_ms": sbis["loop_ms"],
        "bound_ms": sbis["bound_ms"],
        "bound_by": sbis["bound_by"],
        "library_ms": None,
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
