#!/usr/bin/env python3
"""Block shapes of the fused bisection kernels, timed on a CUDA card.

    python3 tools_torch/tune_bisect.py [--out PATH]

For the bracket stage of slab_ph_09 and cyl_co_09 (SearchConfig(n_omega=256,
n_bisect=18), the full sweeps' own brackets, float32 and float64) and for
the refine stage of the slab_ph_09 float32 sweep (its roots' f64 windows,
30 iterations), times `slab_bisect` / `cylinder_bisect` at every block shape
(B brackets per block, P producer warps, C steps per stage, S stages, a
register budget of 64 or 128 a thread) of a grid, checks that each gives
the same bits as the default shape (`kernels.common.bisect_shape`), and
prints per batch the default's time,
the fastest shapes, the loop of one-thread launches it replaces, and the
serial floor: the fused kernel on one bracket, per evaluation. Then the
twisted cylinder_bisect (the speculative kernel, `kernels.common.
spec_shape`) on twist_v01_p1's bracket stage (2,400 brackets, float32 and
float64) and on its refine stage (the float32 sweep's roots' f64 windows,
30 iterations), at every level count L = 0..5 and a grid of (B, P, C, S,
register budget): each checked against the default's bits. Run from the repository root; the
first line is the card's nvidia-smi name and power limit.

    python3 tools_torch/tune_bisect.py --numeric [--out PATH]

times the numeric exterior's slab_bisect and cylinder_bisect instead (the
speculative kernel over the scans' x-only / r-only tables), on the bracket
stages of the reference-parity sweeps slab_ph_09 (21,840 brackets) and
cyl_flow_1 (47,520; `tools_torch/parity.py`, float32 and float64, 18
iterations) and on their first 600 brackets (a refine-sized batch), at
the default shape (`kernels.common.numeric_spec_shape`) and a grid of (L,
B, P, C, register budget), each checked against the default's bits,
beside the launch loop.
"""
import argparse
import dataclasses
import itertools
import json
import math
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


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


def sweep_brackets(case, cfg, dtype, modes=(0, 1)):
    """The brackets the sweep's bisection gets (scan in the scan dtype on the
    card, over the modes), as polish-dtype CUDA tensors (lo, hi, k,
    mode)."""
    import torch
    from eigensolver_tpu_torch import search, sweep
    omegas, ks = sweep.build_ladders(case, cfg.n_omega)
    rows = omegas.shape[0]
    scan_dt = search.torch_dtype(cfg.scan_dtype)

    def dev(a):
        return torch.from_numpy(a).to(device="cuda", dtype=scan_dt)

    om = dev(np.concatenate([omegas] * len(modes)))
    kk = dev(np.concatenate([ks] * len(modes)))
    md = dev(np.repeat([float(m) for m in modes], rows))
    disp = sweep.make_dispersion_moded(case, scan_dt)
    det, valid, mism = search.ladder_scan(disp, om, kk, md)
    br = search.find_brackets(om, kk, det, valid, cfg.max_brackets_per_row,
                              md, mism=mism)
    return [x.to(dtype).contiguous() for x in (br.lo, br.hi, br.k, br.mode)]


def refine_windows(case, cfg):
    """The f64 windows of the refine stage of the case's f32 sweep."""
    import torch
    from eigensolver_tpu_torch import search, sweep
    rs, _ = sweep.run_case(case, cfg, device="cuda")
    names = [(m, b) for m, b in enumerate(("sausage", "kink"))
             if b in rs.branches]
    om = np.concatenate([rs[b].omegas for _, b in names])
    kk = np.concatenate([rs[b].ks for _, b in names])
    md = np.concatenate([np.full(len(rs[b].omegas), float(m))
                         for m, b in names])
    om, kk, md = (torch.from_numpy(x).cuda().double() for x in (om, kk, md))
    disp64 = sweep.make_dispersion_moded(case, torch.float64)
    lo, hi, _ = search.refine_windows(disp64, om, kk, md)
    return [lo, hi, kk, md]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report here as JSON")
    ap.add_argument("--numeric", action="store_true",
                    help="the numeric exterior's parity bracket stages")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from eigensolver_tpu_torch import cases, search, sweep
    from eigensolver_tpu_torch.kernels import common
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    warnings.simplefilter("ignore")         # saturated-row notices
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    f32 = search.SearchConfig(n_omega=256, n_bisect=18, scan_dtype="float32",
                              polish_dtype="float32")
    f64 = dataclasses.replace(f32, scan_dtype="float64", polish_dtype="float64")
    slab = cases.slab_density_photospheric(0.9)
    cyl = cases.cylinder_density_coronal(0.9)
    # the big batches at 64 registers a thread (each default shape also at
    # 128, and with the budget chosen at launch); the small one at both
    big = [(b, p, c, 2, 2) for b, p in itertools.product((8, 16, 32),
                                                         (3, 4, 7, 8, 15))
           for c in _steps(b, p, (32, 64))]
    small = [(b, p, c, s, mb) for b, p in itertools.product((1, 2, 4, 8),
                                                            (1, 2, 4))
             for c in _steps(b, p, (16, 32, 64)) for s in (2, 3)
             for mb in (1, 2)]
    out = {"nvidia_smi": smi}
    if args.numeric:
        tune_numeric(out)
        batches = ()
    else:
        batches = _bessel_batches(slab, cyl, f32, f64, big, small)
    for name, case, args_, dtype, n_iter, final, grid in batches:
        disp = sweep.make_dispersion_moded(case, dtype)
        n = args_[0].numel()
        default = common.bisect_shape(n, dtype)

        def fused(shape=None, a=args_):
            return disp.bisect(*a, n_iter, final) if shape is None else (
                _fn(case)(*a, n_iter, _params(case), final, shape=shape))

        ref = fused()
        res = {}
        for shape in grid + [default, (*default[:4], 1), (*default[:4], 2)]:
            shape = common.BisectShape(*shape)
            if shape in res or common.bisect_smem(shape,
                                                  dtype) > common.MAX_SMEM:
                continue
            got = fused(shape)
            same = all(_same_bits(a, b) for a, b in zip(got, ref)
                       if a is not None)
            if not same:
                raise AssertionError(f"{name}: shape {shape} differs")
            res[shape] = cuda_ms(lambda: fused(shape), 3)
        loop_ms = cuda_ms(lambda: search.bisect_loop(disp, *args_, n_iter,
                                                     final), 1)
        # one bracket, with 3 x 128 = 384 chain evaluations per stage for
        # 480 producer threads: the consumer's serial chain sets the pace
        one = [x[:1].contiguous() for x in args_]
        n_evals = n_iter + 1 + int(final)
        floor = cuda_ms(lambda: fused(common.BisectShape(1, 15, 128, 3, 1),
                                      one), 3) / n_evals
        best = sorted(res.items(), key=lambda kv: kv[1])[:6]
        out[name] = {"n": n, "n_iter": n_iter, "default": list(default),
                     "default_ms": res.get(default, cuda_ms(fused, 3)),
                     "best": [[list(s), ms] for s, ms in best],
                     "loop_ms": loop_ms, "floor_ms_per_eval": floor,
                     "all": {",".join(map(str, s)): ms for s, ms in res.items()}}
        print(name, json.dumps({k: v for k, v in out[name].items()
                                if k != "all"}), flush=True)
    if not args.numeric:
        tune_twisted(out, f32, f64)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


def _bessel_batches(slab, cyl, f32, f64, big, small):
    """slab_ph_09's and cyl_co_09's bracket stages at both types, and the
    slab's refine stage: (name, case, brackets, dtype, n_iter, final_eval,
    grid) each."""
    import torch
    return (
        ("slab_ph_09 f32", slab, sweep_brackets(slab, f32, torch.float32),
         torch.float32, 18, True, big),
        ("slab_ph_09 f64", slab, sweep_brackets(slab, f64, torch.float64),
         torch.float64, 18, True, big),
        ("cyl_co_09 f32", cyl, sweep_brackets(cyl, f32, torch.float32),
         torch.float32, 18, True, big),
        ("cyl_co_09 f64", cyl, sweep_brackets(cyl, f64, torch.float64),
         torch.float64, 18, True, big),
        ("slab_ph_09 refine f64", slab, refine_windows(slab, f32),
         torch.float64, 30, False, small),
    )


def tune_numeric(out: dict) -> None:
    """The numeric exterior's fused bisections (the speculative kernel) on
    the bracket stages of the parity sweeps slab_ph_09 and cyl_flow_1 at
    both types, 18 iterations each, and on their first 600 brackets."""
    import torch
    from eigensolver_tpu_torch import cases, equilibrium, search, sweep
    from eigensolver_tpu_torch.kernels import common, cylinder, slab
    from tools_torch import parity
    for target in ("slab_ph_09", "cyl_flow_1"):
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[-1]
            case, cfg, _ = parity.configure(
                target, cases, search.SearchConfig,
                equilibrium.genuine_continua, dname)
            if case.geometry.value == "slab":
                kmod = slab
                eb = slab._ENTRY_BYTES[(bool(slab.disp_params(
                    case).struct.shear), dtype)]
            else:
                kmod, eb = cylinder, cylinder._ENTRY_BYTES[dtype, False]
            fn = _fn(case)
            params = kmod.disp_params(case)
            disp = sweep.make_dispersion_moded(case, dtype)
            full = sweep_brackets(case, cfg, dtype)
            for name, args_ in ((f"{target} numeric {dname}", full),
                                (f"{target} numeric 600 {dname}",
                                 [x[:600].contiguous() for x in full])):
                n = args_[0].numel()

                def fused(shape, a=args_):
                    return fn(*a, 18, params, True, shape=shape)

                default = common.numeric_spec_shape(n, dtype, eb)
                ref = fused(default)
                levels = (0,) if n >= 2 * common._SPEC_COLUMNS else range(5)
                grid = [common.SpecShape(b, lv, p, c, 2, mb)
                        for lv in levels for b in (32 >> lv, 16 >> lv)
                        if b >= 1 for p in (3, 7, 15) for c in (16, 32, 60)
                        for mb in (0, 1, 2)]
                res = {}
                for shape in [default, *grid]:
                    if tuple(shape) in res or common.spec_smem(
                            shape, dtype, eb) > common.MAX_SMEM:
                        continue
                    got = fused(shape)
                    if not all(_same_bits(a, b) for a, b in zip(got, ref)):
                        raise AssertionError(f"{name}: shape {shape} differs")
                    res[tuple(shape)] = cuda_ms(lambda: fused(shape), 2)
                loop_ms = cuda_ms(lambda: search.bisect_loop(
                    disp, *args_, 18, True), 1)
                best = sorted(res.items(), key=lambda kv: kv[1])[:8]
                out[name] = {"n": n, "n_iter": 18, "default": list(default),
                             "default_ms": res[tuple(default)],
                             "best": [[list(s), ms] for s, ms in best],
                             "loop_ms": loop_ms,
                             "all": {",".join(map(str, s)): ms
                                     for s, ms in res.items()}}
                print(name, json.dumps({k: v for k, v in out[name].items()
                                        if k != "all"}), flush=True)


def tune_twisted(out: dict, f32, f64) -> None:
    """The speculative twisted bisection's block shapes on twist_v01_p1's
    bracket stage and refine stage."""
    import torch
    from eigensolver_tpu_torch import cases, search, sweep
    from eigensolver_tpu_torch.kernels import common, cylinder
    case = cases.cylinder_twisted_photospheric(0.1, 1.0, 1)
    params = cylinder.disp_params(case)
    batches = (
        ("twist_v01_p1 f32", sweep_brackets(case, f32, torch.float32, (1,)),
         torch.float32, 18, True),
        ("twist_v01_p1 f64", sweep_brackets(case, f64, torch.float64, (1,)),
         torch.float64, 18, True),
        ("twist_v01_p1 refine f64", refine_windows(case, f32),
         torch.float64, 30, False))
    for name, args_, dtype, n_iter, final in batches:
        n = args_[0].numel()
        eb = cylinder._ENTRY_BYTES[dtype, True]
        disp = sweep.make_dispersion_moded(case, dtype)

        def fused(shape=None, a=args_):
            return cylinder.cylinder_bisect(*a, n_iter, params, final,
                                            shape=shape)

        default = common.spec_shape(n, dtype, eb)
        ref = fused(default)
        grid = [common.SpecShape(b, lv, p, c, s, mb)
                for lv in range(6) for b in (32 >> lv, 16 >> lv, 8 >> lv)
                if b >= 1 for p in (3, 7, 15) for c in (16, 32)
                for s in (2,) for mb in (1, 2)]
        grid += [common.spec_shape(n, dtype, eb, levels=lv)
                 for lv in range(6)]
        res = {}
        for shape in [default, *grid]:
            if tuple(shape) in res or common.spec_smem(
                    shape, dtype, eb) > common.MAX_SMEM:
                continue
            got = fused(shape)
            if not all(_same_bits(a, b) for a, b in zip(got, ref)
                       if a is not None):
                raise AssertionError(f"{name}: shape {shape} differs")
            res[tuple(shape)] = cuda_ms(lambda: fused(shape), 2)
        loop_ms = cuda_ms(lambda: search.bisect_loop(disp, *args_, n_iter,
                                                     final), 1)
        best = sorted(res.items(), key=lambda kv: kv[1])[:8]
        by_levels = {lv: min(ms for s, ms in res.items() if s[1] == lv)
                     for lv in range(6)}
        out[name] = {"n": n, "n_iter": n_iter, "default": list(default),
                     "default_ms": res[tuple(default)],
                     "best": [[list(s), ms] for s, ms in best],
                     "best_ms_by_levels": by_levels,
                     "loop_ms": loop_ms,
                     "all": {",".join(map(str, s)): ms
                             for s, ms in res.items()}}
        print(name, json.dumps({k: v for k, v in out[name].items()
                                if k != "all"}), flush=True)


def _steps(b, p, base):
    """C values of the grid: base, and the multiples of the producers' rows
    (32 P / B steps per pass over a stage) next below and above 32 and 64,
    so that no pass is partial."""
    rows = 32 * p // b
    return sorted({*base, *(rows * max(1, f(c / rows)) for c in (32, 64)
                            for f in (math.floor, math.ceil))})


def _fn(case):
    from eigensolver_tpu_torch.kernels import cylinder, slab
    return (slab.slab_bisect if case.geometry.value == "slab"
            else cylinder.cylinder_bisect)


def _params(case):
    from eigensolver_tpu_torch.kernels import cylinder, slab
    if case.geometry.value == "slab":
        return slab.disp_params(case)
    return cylinder.disp_params(case)


def _same_bits(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


if __name__ == "__main__":
    sys.exit(main())
