#!/usr/bin/env python3
"""Device times of the port's kernels for one checkout of the package.

    python3 tools_torch/time_kernels.py [--pkg-root DIR] [--label NAME]
                                        [--out PATH] [--complex]
                                        [--cylinder-scan] [--slab-scan]
                                        [--cylinder-bisect]
                                        [--cx-cylinder] [--cx-slab]
                                        [--digests] [--roots PATH]

Imports `eigensolver_tpu_torch` from DIR (default: this repository), builds
its kernels and prints one JSON line of device times (CUDA events, mean of
several launches after a warm-up):
  - kve_ratio at float32 and float64 on 552,960 arguments per range (series
    [0.01, 2), small [1e-3, 0.1), CF2 [2, 200), the two shuffled), beside
    torch.special's K_0 and K_1 and the two ratios;
  - cylinder_disp on the cyl_co_09 sweep's ladder scan (552,960), slab_disp
    on slab_ph_09's (161,280, flux form) and slab_flow_gaussian_coronal's
    (179,200, shear form), cylinder_bisect and slab_bisect on their sweeps'
    brackets (17,280, 5,040 and 5,600, 18 iterations), float32 and float64;
  - the twisted variants of cylinder_disp and cylinder_bisect on the
    twist_v01_p1 sweep's ladder scan (76,800) and brackets (2,400), and on
    the magnetic twist's (cylinder_twisted_magnetic(0.1, 0.15, 1.25, 1)),
    float32 and float64, where the checkout has them ("not ported" where it
    raises NotImplementedError);
  - slab_disp at float64 on the window ends of the refine stage of the
    slab_ph_09 float32 sweep (10 per root: 1,530) with the refine stage's
    float64 bisection of its roots (30 iterations), and the twisted
    cylinder_disp on those of the twist_v01_p1 float32 sweep (3,090) with
    the same bisection of its roots;
  - with the numeric exterior, where the checkout has it: slab_bisect and
    cylinder_bisect on the bracket stages of the reference-parity sweeps
    slab_ph_09 (21,840 brackets) and cyl_flow_1 (47,520;
    `tools_torch/parity.py`), 18 iterations, float32 and float64;
  - at complex omega, where the checkout has it: slab_newton (30 steps,
    and with the final evaluation in the launch) on the 7,200 seeds of the
    published Kelvin-Helmholtz sweep at width 1.0 (`tools_torch/kh.py`,
    float64), slab_disp_complex on its roots, on the audit's 30,720
    contour points and on 8,191 of those at float32, and the Newton pass
    as 30 chained one-step launches (`newton_chain`: each step's ms, its
    non-finite omegas and those whose Im omega has reached 0); the KH
    sweeps' walls at widths 1e5 and 1.0 (medians of 3, `kh_walls`);
  - the CALL instructions in each kve_ratio kernel's SASS (`cuobjdump`),
    where the toolkit has it, and every kernel's ptxas lines (registers,
    spills);
  - the scan cylinder_disp (`--cylinder-scan` times only this): with the
    numeric exterior on the whole cyl_flow_1 parity ladder in ladder order
    (3,007,620) and on 8,191 random draws of the cyl_flow_1 ladder (as
    chip_smoke.py's phase 13 draws them), with the K_m ratio on the
    cyl_co_09 sweep's ladder in ladder order (552,960) and on as many
    random draws of it (phase 4's), float32 and float64; the walls (medians of 3 after a first run) of the cyl_flow_1
    parity sweeps (float32 refined in float64, and float64) and of the
    cyl_co_09 float32 sweep; the scan's registers and spills (ptxas) and,
    per instantiation, the static counts of the SASS instructions behind
    its divisions and exps (MUFU.RCP, MUFU.RCP64H, MUFU.EX2, FCHK, DFMA,
    and the shared-memory loads LDS);
  - the scan slab_disp (`--slab-scan` times only this): on each sweep's
    whole ladder in ladder order, unpaired (one thread a candidate, the
    only path of a checkout without `both_parities`) and paired (both
    parities of an (omega, k) in one thread, `disp.both_parities` on the
    ladder's parity-0 half, where the checkout has it): with the numeric
    exterior on the slab_ph_09 parity ladder (349,440), with the exact one
    on the slab_ph_09 sweep's (161,280, flux form) and
    slab_flow_gaussian_coronal's (179,200, shear form), float32 and
    float64; unpaired on 8,191 random draws with the numeric exterior
    (chip_smoke.py phase 13's: the parity slab, flux, and the Gaussian flow
    at 3 wavelengths, shear) and on the slab_ph_09 float32 sweep's 1,530
    float64 refine window ends; the walls (medians of 3 after a first run)
    of the slab_ph_09 parity sweeps (float32 refined in float64, and
    float64) and of the slab_ph_09 float32 sweep, with their counts; the
    scan's ptxas lines and SASS counts, as for the cylinder.
  - the complex-omega cylinder kernel (`--cx-cylinder` times only this):
    `cylinder_newton` (30 steps; and with the roots' evaluation in the
    launch) on the seeds of the complex cylinder sweeps
    (`tools_torch/cx_cyl.py`: cx_cyl_co_09 at float64 in each mode and at
    float32 in the kink mode, cx_twist_v01_p1, cx_cyl_co_09 with the
    numeric exterior in the kink mode), per launch the roots that are not
    finite, those with |Im omega| below 1e-290 (a float64 division's slow
    path) and the warps of 32 seeds holding one; `cylinder_disp_complex`
    on each sweep's audit contour points; the two sweeps' walls (medians
    of 2 after a first run) and their roots' digests (`chip_smoke.py::
    root_digest`, bit for bit); the kernel's ptxas lines, and where the
    checkout has them its launch shape, registers and spills;
  - the complex-omega slab kernels (`--cx-slab` times only these):
    `slab_newton` (30 steps; and with the roots' evaluation in the launch)
    on the seeds of cx_ph_09 (the flux form) and cx_ph_09_num (with the
    numeric exterior) in each mode, of kh_w1e5_num (the shear form's
    numeric exterior) and kh_w1e5 (the exact one), kink (`tools_torch/
    cx_slab.py`, `kh.py`, float64), per launch the roots that are not
    finite, those with |Im omega| below 1e-290 and the warps of 32 seeds
    holding one; cx_ph_09's first 8,640 seeds (a checkpointed block of 8
    k) with the evaluation; `slab_disp_complex` on each sweep's audit
    contour points; the four sweeps' walls (medians of 2 after a first
    run) and root digests; cx_ph_09's Newton pass as 30 chained one-step
    launches (`newton_chain`: per step its ms, the seeds with |Im omega|
    below 1e-290 and their warps; a step on the roots with and without
    those lifted to 1e-100); the kernels' ptxas lines and, where the
    checkout has them, the flux kernel's attributes;
  - the density/axial-flow fused bisection cylinder_bisect
    (`--cylinder-bisect` times only this), float32 and float64, at the
    wrapper's block shape, beside the launch loop it replaces (the loop of
    cylinder_disp launches, `search.bisect_loop`), each held bit for bit
    to the loop: with the numeric exterior on the cyl_flow_1 parity
    sweep's 47,520 brackets (18 iterations; at float64 also the sweep's own
    50) and on their first 600 (the wrapper's speculative shape), with the
    K_m ratio on cyl_co_09's 17,280 (18 iterations); per launch, where
    the checkout has them, its tabled counts (`kernels.cylinder.
    bisect_counts`); the fused kernel's ptxas lines (registers, spills);
  - the shipped real-omega sweeps' roots (`--digests` runs only these):
    counts and root digests (`chip_smoke.py::root_digest`) of every
    real-omega `run_case` of chip_smoke.py's phases 5, 7, 11 and 14
    (slab_ph_09 at float32, float64 and float32 refined; the two flow
    slabs at float64; cyl_co_09 at float32 and float64; twist_v01_p1 at
    float32, float64 and float32 refined; the magnetic twist at float64;
    the parity sweeps of slab_ph_09 and cyl_flow_1 at float64 and float32
    refined), with each sweep's wall (one run after a first);
To compare two commits on one card, unpack the other into a git-ignored
directory and run both in turns (A B B A) on the same card; `--complex`
times only the complex-omega kernels, `--roots PATH` saves the KH Newton
roots, so that two checkouts' can be held bit for bit. Run from the
repository root; the first line is the card's nvidia-smi name and power
limit.
"""
import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
N = 552_960


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


def _warps(mask) -> int:
    """The warps of 32 consecutive seeds that hold a seed of `mask`."""
    import torch
    pad = (-mask.numel()) % 32
    m = torch.cat([mask, mask.new_zeros(pad)])
    return int(m.view(-1, 32).any(dim=1).sum())


def _event_ms(reps: int, fn):
    """fn's last result and its mean device time over reps calls after a
    warm-up call (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1) / reps


def kve_sets():
    """float64 argument sets of N values each, from seed 0."""
    rng = np.random.default_rng(0)
    lg2 = float(np.log10(2.0))
    below2 = float(np.nextafter(np.float32(2), np.float32(0)))
    return {"series": np.minimum(10.0 ** rng.uniform(-2.0, lg2, N), below2),
            "small": 10.0 ** rng.uniform(-3.0, -1.0, N),
            "cf2": 10.0 ** rng.uniform(lg2, 2.3, N),
            "shuffled": 10.0 ** rng.uniform(-2.0, 2.3, N)}


def library_kve_ratio(z):
    import torch
    k0 = torch.special.modified_bessel_k0(z)
    k1 = torch.special.modified_bessel_k1(z)
    return -k1 / k0, -k0 / k1 - 1.0 / z


def scan_and_brackets(case, dtype):
    """The case's ladder scan candidates (omega, k, mode) and the brackets
    of its bracket stage (lo, hi, k, mode), as CUDA tensors of dtype, over
    the case's modes."""
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
    n_om = om.shape[1]
    cand = [om.reshape(-1), kk.repeat_interleave(n_om),
            md.repeat_interleave(n_om)]
    disp = sweep.make_dispersion_moded(case, dtype)
    det, valid, mism = search.ladder_scan(disp, om, kk, md)
    br = search.find_brackets(om, kk, det, valid, 8, md, mism=mism)
    return disp, cand, [x.contiguous() for x in (br.lo, br.hi, br.k, br.mode)]


def window_ends(case):
    """The float64 window ends of the refine stage of the case's float32
    sweep on the card, formed as `search.refine_windows` forms them (here,
    so that a checkout without `search.refine_window_ends` is timed alike):
    (omega, k, mode) CUDA tensors, and the roots (omega, k, mode)."""
    import torch
    from eigensolver_tpu_torch import search, sweep
    cfg = search.SearchConfig(n_omega=256, n_bisect=18, scan_dtype="float32",
                              polish_dtype="float32")
    rs, _ = sweep.run_case(case, cfg, device="cuda")
    br = [(m, rs[name]) for m, name in sweep.MODE_NAMES.items()
          if name in rs.branches]
    om, kk, md = (torch.from_numpy(np.concatenate(x)).to(
        device="cuda", dtype=torch.float64) for x in (
        [b.omegas for _, b in br], [b.ks for _, b in br],
        [np.full(len(b.ks), float(m)) for m, b in br]))
    ws = [4e-7]
    for _ in range(4):
        ws.append(8.0 * ws[-1])
    ends = torch.cat([torch.stack([om * (1.0 - w) for w in ws]),
                      torch.stack([om * (1.0 + w) for w in ws])]).reshape(-1)
    return (ends, kk.repeat(2 * len(ws)), md.repeat(2 * len(ws))), (om, kk,
                                                                     md)


def parity_brackets(target: str, dtype):
    """The bracket stage's brackets of a reference-parity sweep (its scan at
    dtype on the card, its continuum mask and pole pre-filter) as CUDA
    tensors (lo, hi, k, mode), and its dispersion."""
    import torch
    from eigensolver_tpu_torch import cases, equilibrium, search, sweep
    from tools_torch import parity
    case, cfg, _ = parity.configure(target, cases, search.SearchConfig,
                                    equilibrium.genuine_continua,
                                    str(dtype)[6:])
    omegas, ks = sweep.build_ladders(case, cfg.n_omega)
    rows = omegas.shape[0]

    def dev(a):
        return torch.from_numpy(a).to(device="cuda", dtype=dtype)

    om = dev(np.concatenate([omegas] * len(case.modes)))
    kk = dev(np.concatenate([ks] * len(case.modes)))
    md = dev(np.repeat([float(m) for m in case.modes], rows))
    disp = sweep.make_dispersion_moded(case, dtype)
    det, valid, mism = search.ladder_scan(disp, om, kk, md)
    det = search.mask_v_ranges(om, kk, det, cfg.exclude_v_ranges)
    br = search.find_brackets(om, kk, det, valid, cfg.max_brackets_per_row,
                              md, pole_det_factor=cfg.pole_det_factor,
                              mism=mism)
    return disp, [x.contiguous() for x in (br.lo, br.hi, br.k, br.mode)]


def complex_times(roots_out=None) -> dict:
    """slab_newton on the published KH sweep's 7,200 seeds (width 1.0, 30
    steps; where the checkout has it, also with the final evaluation in
    the launch, the main path's) and slab_disp_complex on its roots, on
    the audit's 30,720 contour points (float64) and on 8,191 of those at
    float32. roots_out: also save the 30-step omegas there (numpy .npz),
    to hold two checkouts' bits against each other."""
    import inspect
    import torch
    from eigensolver_tpu_torch import cases, sweep
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.kernels import slab as kslab
    from tools_torch import kh
    case, kw = kh.configure("kh_w1", cases)
    params = kslab.disp_params(case, True)

    def pair(z, dtype=torch.float64):
        return C(torch.from_numpy(z.real.copy()).to("cuda", dtype),
                 torch.from_numpy(z.imag.copy()).to("cuda", dtype))
    om0, k0 = sweep.complex_seeds(case, kw["n_re"], kw["n_im"])
    seeds, kk = pair(om0), torch.from_numpy(k0).cuda()
    par = torch.ones_like(kk)
    n_iter = kw["newton_iters"]
    roots = kslab.slab_newton(seeds, kk, par, n_iter, 1.0, params)
    if roots_out:
        np.savez(roots_out, re=roots.re.cpu().numpy(),
                 im=roots.im.cpu().numpy())
    cells, paths, _, _ = sweep.audit_contours(
        np.asarray(case.k_grid()), np.asarray(case.sorted_speeds()),
        case.imag_band)
    za = paths.reshape(-1)
    ka = np.repeat([c[0] for c in cells], paths.shape[1])
    out = {"seeds": len(k0), "newton_ms": cuda_ms(
        lambda: kslab.slab_newton(seeds, kk, par, n_iter, 1.0, params), 3)}
    if "final_eval" in inspect.signature(kslab.slab_newton).parameters:
        out["newton_final_eval_ms"] = cuda_ms(lambda: kslab.slab_newton(
            seeds, kk, par, n_iter, 1.0, params, final_eval=True), 3)
    else:
        out["newton_final_eval_ms"] = "not in this checkout"
    for key, z, kz in (
            ("final_eval", roots, kk),
            ("audit", pair(za), torch.from_numpy(ka).cuda()),
            ("ragged_float32", pair(za[:8191], torch.float32),
             torch.from_numpy(ka[:8191]).to("cuda", torch.float32))):
        pz = torch.ones_like(kz)
        out[f"{key}_n"] = kz.numel()
        out[f"{key}_ms"] = cuda_ms(
            lambda: kslab.slab_disp_complex(z, kz, pz, params), 10)
    return out


def kh_walls(runs: int = 3) -> dict:
    """The published KH sweeps' walls (`sweep.run_case_complex`, widths 1e5
    and 1.0, float64): one warm-up run, then `runs` runs on the host clock,
    each ending in a synchronise (the sweep's own), their median and the
    root counts."""
    import statistics
    import time
    from eigensolver_tpu_torch import cases, sweep
    from tools_torch import kh
    out = {}
    for name in kh.CONFIGS:
        case, kw = kh.configure(name, cases)
        rs, _ = sweep.run_case_complex(case, **kw, device="cuda")
        walls = []
        for _ in range(runs):
            t0 = time.perf_counter()
            sweep.run_case_complex(case, **kw, device="cuda")
            walls.append(time.perf_counter() - t0)
        out[name] = {"wall_s": statistics.median(walls), "walls": walls,
                     "counts": rs.counts()}
    return out


def newton_chain(name: str = "kh_w1", n_steps: int = 30) -> dict:
    """A complex slab sweep's Newton pass as n_steps chained slab_newton
    launches of one step each, every launch from the previous one's output,
    float64: the published KH sweep at width 1.0 (`kh_w1`,
    `tools_torch/kh.py`: 7,200 seeds, kink) or the density slab's
    (`cx_ph_09`, `tools_torch/cx_slab.py`: 37,800 seeds, kink, the flux
    form). Per step: its device ms (mean of 3 launches from the same
    input), of its input omegas the non-finite ones, those whose |Im| is
    below 1e-30, below 1e-290 (where a division's quotient nears the
    bottom of the exponent range: the slow path of CUDA's float64
    division), subnormal and exactly 0, the warps of 32 seeds holding such
    a seed, and (KH) the smallest |omega - k U| over the finite seeds with
    U at x = 0 and at x = 1. Then whether the chain's last omega equals one n_steps launch bit
    for bit; one Newton step's ms on the roots as they are and with every
    |Im| below 1e-100 set to 1e-100 (the slow path's cost; timing only: no
    result of it is kept); slab_disp_complex's ms on the seeds, on the
    roots and on the lifted roots."""
    import torch
    from eigensolver_tpu_torch import cases, sweep
    from eigensolver_tpu_torch.cplx import C, cabs
    from eigensolver_tpu_torch.kernels import slab as kslab
    from eigensolver_tpu_torch.profiles import make_profile
    from tools_torch import cx_slab, kh
    case, kw = (kh if name in kh.CONFIGS else cx_slab).configure(name, cases)
    params = kslab.disp_params(case, True)
    rg = case.regime
    U = make_profile(case.flow_profile, rg.U_i0, rg.U_e)(
        torch.tensor([0.0, 1.0], dtype=torch.float64)).tolist()
    om0, k0 = sweep.complex_seeds(case, kw["n_re"], kw["n_im"])
    seeds = C(torch.from_numpy(om0.real.copy()).cuda(),
              torch.from_numpy(om0.imag.copy()).cuda())
    kk = torch.from_numpy(k0).cuda()
    par = torch.ones_like(kk)

    steps, om = [], seeds
    for _ in range(n_steps):
        fin = om.re.isfinite() & om.im.isfinite()
        tiny = fin & (om.im.abs() < 1e-290)
        zero = fin & (om.im == 0)
        sub = tiny & ~zero & (om.im.abs() < torch.finfo(om.im.dtype).tiny)
        small = fin & (om.im.abs() < 1e-30)
        nxt = kslab.slab_newton(om, kk, par, 1, 1.0, params)
        ms = cuda_ms(lambda: kslab.slab_newton(om, kk, par, 1, 1.0, params),
                     3)
        row = {"ms": ms, "non_finite": int((~fin).sum()),
               "small_im": int(small.sum()), "tiny_im": int(tiny.sum()),
               "zero_im": int(zero.sum()), "subnormal_im": int(sub.sum()),
               "warps_non_finite": _warps(~fin), "warps_tiny_im": _warps(tiny)}
        if name in kh.CONFIGS:
            for x, u in zip((0, 1), U):
                d = cabs(C(om.re - kk * u, om.im))
                row[f"min_abs_Omega_x{x}"] = float(d[fin].min())
        steps.append(row)
        om = nxt
    fused = kslab.slab_newton(seeds, kk, par, n_steps, 1.0, params)
    torch.cuda.synchronize()

    def bits(x):
        return x.view(torch.int64)
    same = (torch.equal(bits(fused.re), bits(om.re))
            and torch.equal(bits(fused.im), bits(om.im)))
    lifted = C(om.re, torch.where(om.im.abs() < 1e-100,
                                  torch.full_like(om.im, 1e-100), om.im))

    def eval_ms(z):
        return cuda_ms(lambda: kslab.slab_disp_complex(z, kk, par, params),
                       10)

    def step_ms(z):
        return cuda_ms(lambda: kslab.slab_newton(z, kk, par, 1, 1.0, params),
                       5)
    tiny = om.im.abs() < 1e-290
    return {"name": name, "n": len(k0), "U_x0_x1": U, "steps": steps,
            "chain_ms": sum(r["ms"] for r in steps),
            "fused_equals_chain": same,
            "roots_non_finite": int((~(om.re.isfinite()
                                       & om.im.isfinite())).sum()),
            "roots_tiny_im": int(tiny.sum()),
            "roots_warps_tiny_im": _warps(tiny),
            "warps": _warps(~tiny | tiny),
            "step_roots_ms": step_ms(om),
            "step_roots_lifted_ms": step_ms(lifted),
            "eval_seeds_ms": eval_ms(seeds), "eval_roots_ms": eval_ms(om),
            "eval_roots_lifted_ms": eval_ms(lifted)}


def cx_slab_times() -> dict:
    """The complex-omega slab kernels' launches and sweeps (see the module's
    docstring)."""
    import importlib.util
    import statistics
    import time
    import torch
    from eigensolver_tpu_torch import cases, sweep
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.kernels import slab as kslab
    from tools_torch import cx_slab, kh

    def pair(om, k):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
        return C(t(om.real), t(om.imag)), t(k)

    # this repository's digest, whichever checkout is timed
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    out = {}
    for name in ("cx_ph_09", "cx_ph_09_num", "kh_w1e5_num", "kh_w1e5"):
        mod = kh if name in kh.CONFIGS else cx_slab
        case, kw = mod.configure(name, cases)
        params = kslab.disp_params(case, True)
        om0, k0 = sweep.complex_seeds(case, kw["n_re"], kw["n_im"])
        seeds, kk = pair(om0, k0)
        n_iter = kw["newton_iters"]
        r = {"n": len(k0), "n_iter": n_iter}
        for mode in case.modes:
            par = torch.full_like(kk, float(mode))
            roots, ms = _event_ms(3, lambda: kslab.slab_newton(
                seeds, kk, par, n_iter, 1.0, params))
            _, ms_fe = _event_ms(3, lambda: kslab.slab_newton(
                seeds, kk, par, n_iter, 1.0, params, final_eval=True))
            fin = roots.re.isfinite() & roots.im.isfinite()
            tiny = fin & (roots.im.abs() < 1e-290)
            r[f"m{mode}"] = {
                "ms": ms, "ms_final_eval": ms_fe,
                "roots_non_finite": int((~fin).sum()),
                "roots_tiny_im": int(tiny.sum()),
                "warps_tiny_im": _warps(tiny), "warps": _warps(tiny | ~tiny)}
        if name == "cx_ph_09":
            # a checkpointed block (run_case_complex_checkpointed's 8 k):
            # its first 8,640 seeds, the kink mode, with the evaluation
            n_b = chip_smoke.CX_BLOCK_SEEDS
            sb = C(seeds.re[:n_b].contiguous(), seeds.im[:n_b].contiguous())
            kb = kk[:n_b].contiguous()
            pb = torch.ones_like(kb)
            _, r["block_ms_final_eval"] = _event_ms(
                3, lambda: kslab.slab_newton(sb, kb, pb, n_iter, 1.0, params,
                                             final_eval=True))
            r["block_n"] = n_b
        cells, paths, _, _ = sweep.audit_contours(
            np.asarray(case.k_grid()), np.asarray(case.sorted_speeds()),
            case.imag_band)
        z, ka = pair(paths.reshape(-1),
                     np.repeat(np.array([c[0] for c in cells]),
                               paths.shape[1]))
        pa = torch.full_like(ka, float(case.modes[-1]))
        _, r["audit_ms"] = _event_ms(
            3, lambda: kslab.slab_disp_complex(z, ka, pa, params))
        r["audit_n"] = ka.numel()
        rs, _ = sweep.run_case_complex(case, **kw, device="cuda")
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            sweep.run_case_complex(case, **kw, device="cuda")
            walls.append(time.perf_counter() - t0)
        r["sweep"] = {"wall_s": statistics.median(walls), "walls": walls,
                      "counts": rs.counts(),
                      "root_digest": chip_smoke.root_digest(rs)}
        print(name, json.dumps(r), flush=True)
        out[name] = r
    out["cx_ph_09 newton chain"] = newton_chain("cx_ph_09")
    print("cx_ph_09 newton chain", json.dumps(out["cx_ph_09 newton chain"]),
          flush=True)
    out["ptxas"] = ptxas_lines("slab_cx")
    if hasattr(kslab, "flux_attrs"):
        out["attrs"] = {f"{str(dt)[6:]}{' numeric' if num else ''}":
                        kslab.flux_attrs(dt, num)
                        for dt in (torch.float32, torch.float64)
                        for num in (False, True)}
    return out


def cx_cylinder_times() -> dict:
    """The complex-omega cylinder kernel's launches and sweeps (see the
    module's docstring)."""
    import importlib.util
    import statistics
    import time
    import torch
    from eigensolver_tpu_torch import cases, sweep
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.kernels import cylinder as kcyl
    from tools_torch import cx_cyl

    def pair(om, k, dtype):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dtype)
        return C(t(om.real), t(om.imag)), t(k)

    # this repository's digest, whichever checkout is timed
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    out = {}
    sets = (("cx_cyl_co_09", "cx_cyl_co_09", {}, ((torch.float64, 0),
                                                  (torch.float64, 1),
                                                  (torch.float32, 1))),
            ("cx_twist_v01_p1", "cx_twist_v01_p1", {},
             ((torch.float64, 1),)),
            ("cx_cyl_co_09 numeric", "cx_cyl_co_09",
             dict(exterior_method="numeric"), ((torch.float64, 1),)))
    for label, name, case_kw, runs in sets:
        case, kw = cx_cyl.configure(name, cases, **case_kw)
        params = kcyl.disp_params(case)
        om0, k0 = sweep.complex_seeds(case, kw["n_re"], kw["n_im"])
        n_iter = kw["newton_iters"]
        r = {"n": len(k0), "n_iter": n_iter}
        for dtype, mode in runs:
            seeds, kk = pair(om0, k0, dtype)
            mm = torch.full_like(kk, float(mode))
            roots, ms = _event_ms(2, lambda: kcyl.cylinder_newton(
                seeds, kk, mm, n_iter, 1.0, params))
            _, ms_fe = _event_ms(2, lambda: kcyl.cylinder_newton(
                seeds, kk, mm, n_iter, 1.0, params, final_eval=True))
            fin = roots.re.isfinite() & roots.im.isfinite()
            tiny = fin & (roots.im.abs() < 1e-290)
            r[f"{str(dtype)[6:]} m{mode}"] = {
                "ms": ms, "ms_final_eval": ms_fe,
                "roots_non_finite": int((~fin).sum()),
                "roots_tiny_im": int(tiny.sum()),
                "warps_tiny_im": _warps(tiny), "warps": _warps(tiny | ~tiny)}
        cells, paths, _, _ = sweep.audit_contours(
            np.asarray(case.k_grid()), np.asarray(case.sorted_speeds()),
            case.imag_band)
        z, ka = pair(paths.reshape(-1),
                     np.repeat(np.array([c[0] for c in cells]),
                               paths.shape[1]), torch.float64)
        ma = torch.full_like(ka, float(case.modes[-1]))
        _, r["audit_ms"] = _event_ms(
            2, lambda: kcyl.cylinder_disp_complex(z, ka, ma, params))
        r["audit_n"] = ka.numel()
        if not case_kw:
            rs, _ = sweep.run_case_complex(case, **kw, device="cuda")
            walls = []
            for _ in range(2):
                t0 = time.perf_counter()
                sweep.run_case_complex(case, **kw, device="cuda")
                walls.append(time.perf_counter() - t0)
            r["sweep"] = {"wall_s": statistics.median(walls),
                          "walls": walls, "counts": rs.counts(),
                          "root_digest": chip_smoke.root_digest(rs)}
        print(label, json.dumps(r), flush=True)
        out[label] = r
    out["ptxas"] = ptxas_lines("cyl_cx")
    if hasattr(kcyl, "newton_attrs"):
        out["attrs"] = {
            f"{str(dt)[6:]} {'twisted' if tw else 'plain'}"
            f"{' numeric' if num else ''}": kcyl.newton_attrs(dt, tw, num)
            for dt in (torch.float32, torch.float64)
            for tw in (False, True) for num in (False, True)}
    return out


def _sass_functions(lib: Path, kernel: str):
    """(mangled name, SASS lines) of each function of the library whose
    name holds `kernel` (cuobjdump); none without cuobjdump."""
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    tool = shutil.which("cuobjdump") or str(cuda / "bin" / "cuobjdump")
    if not Path(tool).is_file():
        return
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    name, lines = None, []
    for ln in sass.splitlines() + ["Function : <end>"]:
        m = re.search(r"Function : (\S+)", ln)
        if m:
            if name:
                yield name, lines
            name = m.group(1) if kernel in m.group(1) else None
            lines = []
        elif name:
            lines.append(ln)


def sass_calls(lib: Path) -> dict:
    """CALL instructions (and their targets) per kve_ratio kernel in the
    library's SASS; empty without cuobjdump."""
    out = {}
    for name, lines in _sass_functions(lib, "kve_ratio_kernel"):
        calls = [ln.split("CALL", 1)[1].split(";")[0].strip()
                 for ln in lines if re.search(r"\bCALL\b", ln)]
        out[name] = {"calls": len(calls),
                     "targets": list(dict.fromkeys(calls))}
    return out


# the SASS instructions behind a division (MUFU.RCP and its check FCHK at
# float32; MUFU.RCP64H and the DFMA refinement at float64) and an exp
# (MUFU.EX2), and the shared-memory loads
SASS_OPS = ("MUFU.RCP64H", "MUFU.RCP", "MUFU.EX2", "FCHK", "DFMA", "LDS")


def sass_counts(lib: Path, kernel: str) -> dict:
    """Static counts of SASS_OPS in each instantiation of `kernel` in the
    library's SASS (the function's whole body); empty without cuobjdump."""
    out = {}
    for name, lines in _sass_functions(lib, kernel):
        count = out[name] = dict.fromkeys(SASS_OPS, 0)
        for ln in lines:
            op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", ln)
            key = op and next((k for k in SASS_OPS if op.group(1) == k
                               or op.group(1).startswith(k + ".")), None)
            if key:
                count[key] += 1
    return out


def ptxas_lines(kernel: str, lib=None) -> dict:
    """The ptxas report (-Xptxas -v) of each instantiation of `kernel`:
    its registers, spills and shared memory lines, in the build of the
    library `lib` (default: the package's)."""
    from eigensolver_tpu_torch.kernels import _build
    lib = _build.library_path() if lib is None else Path(lib)
    log = lib.with_suffix(".log").read_text()
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            continue
        if name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.split("ptxas info    :")[-1]
                                            .strip())
    return out


def _walls(case, cfg, refine: bool, runs: int = 3) -> dict:
    """One sweep on the card, then `runs` timed ones: their median wall
    and the counts."""
    import statistics
    from eigensolver_tpu_torch import sweep
    rs, _ = sweep.run_case(case, cfg, device="cuda", refine_f64=refine)
    walls = [sweep.run_case(case, cfg, device="cuda",
                            refine_f64=refine)[1].wall_s
             for _ in range(runs)]
    return {"median_wall_s": statistics.median(walls), "walls": walls,
            "counts": rs.counts()}


def cylinder_scan_times(lib: Path) -> dict:
    """The scan cylinder_disp's times (see the module's docstring)."""
    import torch
    from eigensolver_tpu_torch import cases, equilibrium, search, sweep
    from tools_torch import batches, parity
    out = {}
    flow, _, _ = parity.configure("cyl_flow_1", cases, search.SearchConfig,
                                  equilibrium.genuine_continua, "float32")
    co = cases.cylinder_density_coronal(0.9)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype)[6:]
        disp = sweep.make_dispersion_moded(flow, dtype)
        cand = batches.flat_ladder(
            flow, parity.TARGETS["cyl_flow_1"]["n_omega"], dtype)
        out[f"numeric full {dname}"] = {
            "n": cand[0].numel(), "ms": cuda_ms(lambda: disp(*cand), 3)}
        cand = batches.ladder_draws(flow, 8191, 13, dtype)
        out[f"numeric ragged {dname}"] = {
            "n": cand[0].numel(), "ms": cuda_ms(lambda: disp(*cand), 10)}
        disp = sweep.make_dispersion_moded(co, dtype)
        cand = batches.flat_ladder(co, 256, dtype)
        out[f"analytic cyl_co_09 {dname}"] = {
            "n": cand[0].numel(), "ms": cuda_ms(lambda: disp(*cand), 5)}
        cand = batches.ladder_draws(co, cand[0].numel(), 2, dtype)
        out[f"analytic cyl_co_09 random {dname}"] = {
            "n": cand[0].numel(), "ms": cuda_ms(lambda: disp(*cand), 5)}
    for dtype in ("float32", "float64"):
        case, cfg, refine = parity.configure(
            "cyl_flow_1", cases, search.SearchConfig,
            equilibrium.genuine_continua, dtype)
        out[f"cyl_flow_1 parity {dtype} wall"] = _walls(case, cfg, refine)
    out["cyl_co_09 float32 wall"] = _walls(
        co, search.SearchConfig(n_omega=256, n_bisect=18,
                                scan_dtype="float32",
                                polish_dtype="float32"), False)
    out["ptxas"] = ptxas_lines("cylinder_disp_kernel")
    out["sass"] = sass_counts(lib, "cylinder_disp_kernel")
    return out


def cylinder_bisect_times() -> dict:
    """The density/axial-flow cylinder_bisect's times (see the module's
    docstring)."""
    import torch
    from eigensolver_tpu_torch import cases, search
    from eigensolver_tpu_torch.kernels import cylinder as kcyl
    counts = getattr(kcyl, "bisect_counts", None)
    out = {}

    def bits(a, b):
        return bool(((a == b) | (a.isnan() & b.isnan())).all())

    def entry(name, disp, br, n_iter, reps, loop=True):
        # the fused launch against the launch loop, bit for bit; its ms and
        # the tabled counts of one launch
        got = disp.bisect(*br, n_iter)
        want = search.bisect_loop(disp, *br, n_iter)
        if not all(bits(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: fused != launch loop")
        r = {"n": br[0].numel(), "n_iter": n_iter}
        if counts is not None:
            counts("cuda")
            disp.bisect(*br, n_iter)
            r["counts"] = counts("cuda")
        r["ms"] = cuda_ms(lambda: disp.bisect(*br, n_iter), reps)
        if loop:
            r["loop_ms"] = cuda_ms(lambda: search.bisect_loop(
                disp, *br, n_iter), 1)
        print(name, json.dumps(r), flush=True)
        out[name] = r

    co = cases.cylinder_density_coronal(0.9)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype)[6:]
        disp, br = parity_brackets("cyl_flow_1", dtype)
        entry(f"numeric {dname}", disp, br, 18, 3)
        if dtype == torch.float64:
            entry(f"numeric {dname} n_iter 50", disp, br, 50, 2, loop=False)
        entry(f"numeric 600 {dname}", disp,
              [x[:600].contiguous() for x in br], 18, 5)
        disp, _, br = scan_and_brackets(co, dtype)
        entry(f"analytic cyl_co_09 {dname}", disp, br, 18, 5)
    out["ptxas"] = ptxas_lines("9SpecChainI")
    return out


def slab_scan_times(lib: Path) -> dict:
    """The scan slab_disp's times (see the module's docstring)."""
    import dataclasses
    import torch
    from eigensolver_tpu_torch import cases, equilibrium, search, sweep
    from tools_torch import batches, parity
    out = {}
    par, par_cfg, _ = parity.configure("slab_ph_09", cases,
                                       search.SearchConfig,
                                       equilibrium.genuine_continua)
    main = cases.slab_density_photospheric(0.9)
    flow = cases.slab_flow_gaussian_coronal()
    ladders = (("numeric parity", par, par_cfg.n_omega),
               ("flux slab_ph_09", main, 256),
               ("shear flow_gauss", flow, 256))
    shear3 = dataclasses.replace(flow, grid=dataclasses.replace(
        flow.grid, exterior_method="numeric", exterior_wavelengths=3.0))
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype)[6:]
        for name, case, n_omega in ladders:
            disp = sweep.make_dispersion_moded(case, dtype)
            cand = batches.flat_ladder(case, n_omega, dtype)
            r = out[f"{name} {dname}"] = {
                "n": cand[0].numel(), "ms": cuda_ms(lambda: disp(*cand), 3)}
            pairs = getattr(disp, "both_parities", None)
            if pairs is not None:
                half = [x[:x.numel() // 2] for x in cand[:2]]
                r["paired_ms"] = cuda_ms(lambda: pairs(*half), 3)
        for name, case in (("numeric ragged flux", par),
                           ("numeric ragged shear", shear3)):
            disp = sweep.make_dispersion_moded(case, dtype)
            cand = batches.ladder_draws(case, 8191, 13, dtype)
            out[f"{name} {dname}"] = {
                "n": cand[0].numel(), "ms": cuda_ms(lambda: disp(*cand), 10)}
    win, _ = window_ends(main)
    disp64 = sweep.make_dispersion_moded(main, torch.float64)
    out["window float64"] = {"n": win[0].numel(),
                             "ms": cuda_ms(lambda: disp64(*win), 20)}
    for dtype in ("float32", "float64"):
        case, cfg, refine = parity.configure(
            "slab_ph_09", cases, search.SearchConfig,
            equilibrium.genuine_continua, dtype)
        out[f"slab_ph_09 parity {dtype} wall"] = _walls(case, cfg, refine)
    out["slab_ph_09 float32 wall"] = _walls(
        main, search.SearchConfig(n_omega=256, n_bisect=18,
                                  scan_dtype="float32",
                                  polish_dtype="float32"), False)
    out["ptxas"] = ptxas_lines("slab_disp_kernel")
    out["sass"] = sass_counts(lib, "slab_disp_kernel")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pkg-root", default=str(ROOT),
                    help="directory holding eigensolver_tpu_torch")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", help="also write the report here as JSON")
    ap.add_argument("--complex", action="store_true",
                    help="time only the complex-omega kernels")
    ap.add_argument("--cylinder-scan", action="store_true",
                    help="time only the scan cylinder_disp and its sweeps")
    ap.add_argument("--slab-scan", action="store_true",
                    help="time only the scan slab_disp and its sweeps")
    ap.add_argument("--cylinder-bisect", action="store_true",
                    help="time only the density/axial-flow cylinder_bisect")
    ap.add_argument("--cx-cylinder", action="store_true",
                    help="time only the complex-omega cylinder kernel and "
                         "its sweeps")
    ap.add_argument("--cx-slab", action="store_true",
                    help="time only the complex-omega slab kernels and "
                         "their sweeps")
    ap.add_argument("--digests", action="store_true",
                    help="only the shipped real-omega sweeps' counts and "
                         "root digests")
    ap.add_argument("--roots", help="save the KH Newton roots here (.npz)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.pkg_root).resolve()))
    sys.path.insert(1, str(ROOT))           # tools_torch
    import warnings
    import torch
    from eigensolver_tpu_torch.kernels import _build
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    warnings.simplefilter("ignore")         # saturated-row notices
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    lib = _build.build()
    out = {"label": args.label, "nvidia_smi": smi,
           "package": str(Path(_build.__file__).resolve().parents[1])}
    if args.cylinder_scan or args.slab_scan or args.cx_cylinder \
            or args.cx_slab or args.digests or args.cylinder_bisect:
        out.update(cylinder_scan_times(lib) if args.cylinder_scan
                   else slab_scan_times(lib) if args.slab_scan
                   else cylinder_bisect_times() if args.cylinder_bisect
                   else cx_cylinder_times() if args.cx_cylinder
                   else cx_slab_times() if args.cx_slab
                   else sweep_digests())
        print(json.dumps(out), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=1))
        return 0
    if not args.complex:
        real_times(out, args.pkg_root)
    try:
        out["kh_w1 complex float64"] = complex_times(args.roots)
        out["kh_w1 newton chain"] = newton_chain("kh_w1")
        out["kh walls"] = kh_walls()
    except (ImportError, AttributeError, NotImplementedError):
        # an older tree (--pkg-root) may lack the complex kernels
        if Path(args.pkg_root).resolve() == ROOT:
            raise
        out["kh_w1 complex float64"] = "not ported"
    if not args.complex:
        out["sass"] = sass_calls(lib)
        out["ptxas"] = ptxas_lines("")
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


def sweep_digests() -> dict:
    """Counts, root digests and walls of the shipped real-omega sweeps
    (see the module's docstring)."""
    import importlib.util
    import time
    import torch
    from eigensolver_tpu_torch import cases, equilibrium, search, sweep
    from tools_torch import parity
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    def cfg(dtype):
        return search.SearchConfig(n_omega=256, n_bisect=18,
                                   scan_dtype=dtype, polish_dtype=dtype)
    runs = []
    for name, case in (
            ("slab_ph_09", cases.slab_density_photospheric(0.9)),
            ("cyl_co_09", cases.cylinder_density_coronal(0.9)),
            ("twist_v01_p1",
             cases.cylinder_twisted_photospheric(0.1, 1.0, 1))):
        runs += [(f"{name} float32", case, cfg("float32"), False),
                 (f"{name} float64", case, cfg("float64"), False)]
        if name != "cyl_co_09":
            runs.append((f"{name} float32 refined", case, cfg("float32"),
                         True))
    for name, case in (
            ("slab_flow_gaussian_coronal", cases.slab_flow_gaussian_coronal()),
            ("slab_flow_uniform_photospheric",
             cases.slab_flow_uniform_photospheric()),
            ("magnetic_p125",
             cases.cylinder_twisted_magnetic(0.1, 0.15, 1.25, 1))):
        runs.append((f"{name} float64", case, cfg("float64"), False))
    for name in ("slab_ph_09", "cyl_flow_1"):
        for dtype in ("float64", "float32"):
            case, c, refine = parity.configure(
                name, cases, search.SearchConfig,
                equilibrium.genuine_continua, dtype)
            runs.append((f"{name} parity {dtype}", case, c, refine))
    out = {}
    for what, case, c, refine in runs:
        sweep.run_case(case, c, device="cuda", refine_f64=refine)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs, _ = sweep.run_case(case, c, device="cuda", refine_f64=refine)
        out[what] = {"counts": rs.counts(),
                     "wall_s": time.perf_counter() - t0,
                     "root_digest": chip_smoke.root_digest(rs)}
        print(what, json.dumps(out[what]), flush=True)
    return out


def real_times(out: dict, pkg_root: str) -> None:
    """The real-omega kernels' times, into out."""
    import torch
    from eigensolver_tpu_torch import cases, sweep
    from eigensolver_tpu_torch.kernels import bessel
    kve = {}
    for name, z64 in kve_sets().items():
        for dtype in (torch.float32, torch.float64):
            z = torch.from_numpy(z64).to(device="cuda", dtype=dtype)
            kve[f"{name} {str(dtype)[6:]}"] = {
                "ms": cuda_ms(lambda: bessel.kve_ratio_both(z), 20),
                "library_ms": cuda_ms(lambda: library_kve_ratio(z), 20)}
    out["kve_ratio"] = kve
    for case_name, case, n_disp in (
            ("cyl_co_09", cases.cylinder_density_coronal(0.9), 5),
            ("slab_ph_09", cases.slab_density_photospheric(0.9), 10),
            ("flow_gauss", cases.slab_flow_gaussian_coronal(), 10),
            ("twist_v01_p1",
             cases.cylinder_twisted_photospheric(0.1, 1.0, 1), 5),
            ("magnetic_p125",
             cases.cylinder_twisted_magnetic(0.1, 0.15, 1.25, 1), 5)):
        for dtype in (torch.float32, torch.float64):
            try:
                disp, cand, br = scan_and_brackets(case, dtype)
            except NotImplementedError:
                # an older tree (--pkg-root) may lack a case; this one may not
                if Path(pkg_root).resolve() == ROOT:
                    raise
                out[f"{case_name} {str(dtype)[6:]}"] = "not ported"
                continue
            out[f"{case_name} {str(dtype)[6:]}"] = {
                "scan_n": cand[0].numel(),
                "scan_ms": cuda_ms(lambda: disp(*cand), n_disp),
                "brackets": br[0].numel(),
                "bisect_ms": cuda_ms(lambda: disp.bisect(*br, 18), 5)}
    from eigensolver_tpu_torch import search
    slab = cases.slab_density_photospheric(0.9)
    win, roots = window_ends(slab)
    disp64 = sweep.make_dispersion_moded(slab, torch.float64)
    lo, hi, _ = search.refine_windows(disp64, *roots)
    br = [lo, hi, roots[1], roots[2]]
    out["slab_ph_09 window float64"] = {
        "n": win[0].numel(), "ms": cuda_ms(lambda: disp64(*win), 20),
        "brackets": lo.numel(),
        "bisect_ms": cuda_ms(lambda: disp64.bisect(*br, 30, final_eval=False),
                             5)}
    twist = cases.cylinder_twisted_photospheric(0.1, 1.0, 1)
    win, roots = window_ends(twist)
    disp64 = sweep.make_dispersion_moded(twist, torch.float64)
    lo, hi, _ = search.refine_windows(disp64, *roots)
    br = [lo, hi, roots[1], roots[2]]
    out["twist_v01_p1 refine float64"] = {
        "windows_n": win[0].numel(),
        "windows_ms": cuda_ms(lambda: disp64(*win), 5),
        "brackets": lo.numel(),
        "bisect_ms": cuda_ms(lambda: disp64.bisect(*br, 30, final_eval=False),
                             3)}
    for target in ("slab_ph_09", "cyl_flow_1"):
        for dtype in (torch.float32, torch.float64):
            key = f"{target} numeric {str(dtype)[6:]}"
            try:
                disp, br = parity_brackets(target, dtype)
            except (ImportError, AttributeError, NotImplementedError):
                # an older tree (--pkg-root) may lack the numeric exterior
                if Path(pkg_root).resolve() == ROOT:
                    raise
                out[key] = "not ported"
                continue
            out[key] = {"brackets": br[0].numel(),
                        "bisect_ms": cuda_ms(lambda: disp.bisect(*br, 18), 3)}


if __name__ == "__main__":
    sys.exit(main())
