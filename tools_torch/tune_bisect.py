#!/usr/bin/env python3
"""Block shapes of the fused bisection kernels, timed on a CUDA card.

    python3 tools_torch/tune_bisect.py [--out PATH]

Times the exact exterior's `slab_bisect` and `cylinder_bisect`
(`csrc/bisect.cuh::spec_kernel` over the scans' x-only / r-only tables) on
the main path's batches: the bracket stages of slab_ph_09 (5,040
brackets, flux form), slab_flow_gaussian_coronal (5,600, shear form) and
cyl_co_09 (17,280) at float32 and float64 (SearchConfig(n_omega=256,
n_bisect=18), the sweeps' own brackets), and the refine stage of the
slab_ph_09 float32 sweep (its roots' f64 windows, 30 iterations, no
residual). Each batch at its default shape
(`kernels.common.analytic_spec_shape`) and at a grid of (L levels a round,
B brackets a block, P producer warps, C steps a stage, register budget):
L = 0-2 on the bracket stages, 0-5 on the refine batch; each checked
against the default's bits, and the default against the loop of scan
launches it replaces, which is timed too. Run from the repository root;
the first line is the card's nvidia-smi name and power limit.

    python3 tools_torch/tune_bisect.py --confirm [--out PATH]

times the fastest shapes of that grid again on the same batches, in 3
rounds of turns (medians), each at the three register budgets: the
choice of `analytic_spec_shape`.

    python3 tools_torch/tune_bisect.py --twisted [--out PATH]

times the twisted cylinder_bisect (`kernels.common.spec_shape`) instead, on
twist_v01_p1's bracket stage (2,400 brackets, float32 and float64) and on
its refine stage (the float32 sweep's roots' f64 windows, 30 iterations),
at every L = 0..5 and a grid of (B, P, C, register budget).

    python3 tools_torch/tune_bisect.py --complex [--out PATH]

times the complex-omega kernel (`csrc/slab_complex.cu`, block shape
`kernels.common.complex_spec_shape`) instead, on the main path's batches
of the published KH sweep at width 1.0 (`tools_torch/kh.py`): the Newton
launch (7,200 seeds, 30 steps and the final evaluation, float64), and the
evaluation mode on the 7,200 roots and the audit's 30,720 contour points
(float64) and on 8,191 of those (float32), at a grid of (B seeds a block,
C steps a stage, S stages) whose 2 blocks fit an SM, each checked against
the default's bits (the producer warps P are fixed by the type,
`kernels.common.COMPLEX_PRODUCERS`).

    python3 tools_torch/tune_bisect.py --numeric [--target NAME] [--out PATH]

times the numeric exterior's slab_bisect and cylinder_bisect instead, on
the bracket stages of the reference-parity sweeps slab_ph_09 (21,840
brackets) and cyl_flow_1 (47,520; `tools_torch/parity.py`, float32 and
float64, 18 iterations) and on their first 600 brackets (a refine-sized
batch), at the default shape (`kernels.common.numeric_spec_shape`; the
cylinder's `kernels.cylinder.numeric_bisect_shape`) and a grid of (L, B,
P, C, register budget), each checked against the default's bits, beside
the launch loop. `--target` times one of the two sweeps.
"""
import argparse
import dataclasses
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
    chain = ap.add_mutually_exclusive_group()
    chain.add_argument("--numeric", action="store_true",
                       help="the numeric exterior's parity bracket stages")
    chain.add_argument("--twisted", action="store_true",
                       help="the twisted chain's bracket and refine stages")
    chain.add_argument("--confirm", action="store_true",
                       help="the exact exterior's best shapes, in turns")
    chain.add_argument("--complex", action="store_true",
                       help="the complex-omega kernel on the KH batches")
    ap.add_argument("--target",
                    choices=("slab_ph_09", "flow_gauss", "cyl_co_09",
                             "cyl_flow_1"),
                    help="this sweep's batches only (--numeric: slab_ph_09 "
                         "or cyl_flow_1; else the exact exterior's three)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from eigensolver_tpu_torch import search
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
    out = {"nvidia_smi": smi}
    if args.numeric:
        if args.target not in (None, "slab_ph_09", "cyl_flow_1"):
            ap.error("--numeric --target: slab_ph_09 or cyl_flow_1")
        tune_numeric(out, (args.target,) if args.target
                     else ("slab_ph_09", "cyl_flow_1"))
    elif args.twisted:
        tune_twisted(out, f32, f64)
    elif args.confirm:
        confirm_analytic(out, f32, f64)
    elif args.complex:
        tune_complex(out)
    else:
        tune_analytic(out, f32, f64, args.target)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


def tune_batch(out: dict, name: str, fused, loop, default, grid, dtype,
               eb: int, top: int = 8) -> dict:
    """Time fused(shape) at the default shape and at every shape of grid
    that fits a block's shared memory, each checked against the default's
    bits, and the loop once (None: not timed); the report goes to
    out[name] and is printed."""
    from eigensolver_tpu_torch.kernels import common
    ref = fused(default)
    res = {}
    for shape in [default, *grid]:
        shape = common.SpecShape(*shape)
        if shape in res or common.spec_smem(shape, dtype, eb) > common.MAX_SMEM:
            continue
        got = fused(shape)
        if not all(_same_bits(a, b) for a, b in zip(got, ref)
                   if a is not None):
            raise AssertionError(f"{name}: shape {shape} differs")
        res[shape] = cuda_ms(lambda: fused(shape), 2)
    best = sorted(res.items(), key=lambda kv: kv[1])[:top]
    r = {"n": ref[0].numel(), "default": list(default),
         "default_ms": res[common.SpecShape(*default)],
         "best": [[list(s), ms] for s, ms in best],
         "best_ms_by_levels": {lv: min(ms for s, ms in res.items()
                                       if s.levels == lv)
                               for lv in sorted({s.levels for s in res})}}
    if loop is not None:
        r["loop_ms"] = cuda_ms(loop, 1)
    print(name, json.dumps(r), flush=True)
    r["all"] = {",".join(map(str, s)): ms for s, ms in res.items()}
    out[name] = r
    return r


def tune_complex(out: dict, top: int = 8) -> None:
    """The complex-omega kernel's block shapes on the KH batches (see the
    module's docstring); the report goes to out["complex"]."""
    import itertools
    import torch
    from eigensolver_tpu_torch import cases, sweep
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.kernels import common, slab as kslab
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
    cells, paths, _, _ = sweep.audit_contours(
        np.asarray(case.k_grid()), np.asarray(case.sorted_speeds()),
        case.imag_band)
    za = paths.reshape(-1)
    ka = np.repeat([c[0] for c in cells], paths.shape[1])
    f32 = torch.float32
    batches = {
        "newton float64": (lambda sh: kslab.slab_newton(
            seeds, kk, par, n_iter, 1.0, params, final_eval=True,
            shape=sh), torch.float64, 3),
        "roots float64": (lambda sh: kslab.slab_disp_complex(
            roots, kk, par, params, sh), torch.float64, 10)}
    for name, z, kz in (("audit float64", pair(za),
                         torch.from_numpy(ka).cuda()),
                        ("ragged float32", pair(za[:8191], f32),
                         torch.from_numpy(ka[:8191]).to("cuda", f32))):
        batches[name] = ((lambda sh, z=z, kz=kz: kslab.slab_disp_complex(
            z, kz, torch.ones_like(kz), params, sh)), kz.dtype, 10)
    # the shapes whose 2 blocks fit an SM's shared memory (1 KiB reserved
    # a block), the residency the kernel is built for
    grid = [sh for sh in map(common.ComplexShape._make, itertools.product(
        (8, 16, 32), (2, 4, 6, 7, 8, 12, 14, 16, 32), (2, 3, 4)))
        if 2 * (common.complex_smem(sh, torch.float64) + 1024) <= 228 * 1024]

    def flat(r):       # the tensors of an omega and / or a SlabInterface
        if isinstance(r, C):
            return [r.re, r.im]
        if isinstance(r, tuple):
            return [t for x in r for t in flat(x)]
        return [r]
    res = {}
    for name, (fn, dtype, reps) in batches.items():
        default = common.complex_spec_shape(dtype)
        ref = flat(fn(default))
        times = {}
        for shape in [default, *grid]:
            if (shape in times or common.complex_smem(shape, dtype)
                    > common.MAX_SMEM):
                continue
            if not all(_same_bits(a, b) for a, b in zip(flat(fn(shape)), ref)):
                raise AssertionError(f"{name}: shape {shape} differs")
            times[shape] = cuda_ms(lambda: fn(shape), reps)
        best = sorted(times.items(), key=lambda kv: kv[1])[:top]
        r = {"default": list(default), "default_ms": times[default],
             "best": [[list(s), ms] for s, ms in best]}
        print(name, json.dumps(r), flush=True)
        r["all"] = {",".join(map(str, s)): ms for s, ms in times.items()}
        res[name] = r
    out["complex"] = res


def analytic_batches(f32, f64):
    """The exact exterior's main-path batches: (name, case, brackets,
    dtype, n_iter, final_eval) of slab_ph_09's, the Gaussian-flow slab's
    and cyl_co_09's bracket stages at both types, and of the slab_ph_09
    refine stage's f64 bisection."""
    import torch
    from eigensolver_tpu_torch import cases
    slab = cases.slab_density_photospheric(0.9)
    flow = cases.slab_flow_gaussian_coronal()
    cyl = cases.cylinder_density_coronal(0.9)
    for name, case in (("slab_ph_09", slab), ("flow_gauss", flow),
                       ("cyl_co_09", cyl)):
        for dt in (torch.float32, torch.float64):
            yield (f"{name} {str(dt)[6:]}", case, sweep_brackets(
                case, f32 if dt == torch.float32 else f64, dt), dt, 18, True)
    yield ("slab_ph_09 refine f64", slab, refine_windows(slab, f32),
           torch.float64, 30, False)


def tune_analytic(out: dict, f32, f64, target=None) -> None:
    """The exact exterior's fused bisections on the main path's batches
    (those of `target` alone, if given), each default checked against the
    launch loop."""
    from eigensolver_tpu_torch import search, sweep
    from eigensolver_tpu_torch.kernels import common
    for name, case, args_, dtype, n_iter, final in analytic_batches(f32, f64):
        if target and name.split()[0] != target:
            continue
        n = args_[0].numel()
        eb = _entry_bytes(case, dtype)
        fn, params = _fn(case), _params(case)
        disp = sweep.make_dispersion_moded(case, dtype)

        def fused(shape, a=args_):
            return fn(*a, n_iter, params, final, shape=shape)

        default = common.analytic_spec_shape(n, dtype, eb, _shear(case))
        want = search.bisect_loop(disp, *args_, n_iter, final)
        if not all(_same_bits(a, b) for a, b in zip(fused(default), want)
                   if a is not None):
            raise AssertionError(f"{name}: the default differs from the loop")
        levels = range(6) if n < common._SPEC_COLUMNS else range(3)
        grid = [common.SpecShape(b, lv, p, c, 2, mb)
                for lv in levels for b in (32 >> lv, 16 >> lv, 8 >> lv)
                if b >= 1 for p in (3, 7, 15) for c in _steps(b << lv, p)
                for mb in (1, 2)]
        grid += [common.spec_shape(n, dtype, eb, levels=lv) for lv in levels]
        grid += [common.numeric_spec_shape(n, dtype, eb)]
        grid = [s for s in grid if _built(case, dtype, s[-1])]
        tune_batch(out, name, fused, lambda: search.bisect_loop(
            disp, *args_, n_iter, final), default, grid, dtype, eb)


# The shapes --confirm times in turns: the grid's fastest on the bracket
# stages (L = 0) and on the refine batch (L = 3-5), each at the register
# budgets 128 (1), 64 (2) and chosen at launch (0)
CONFIRM_STAGE = [(b, 0, p, c, 2, mb) for b, p, c in (
    (16, 7, 28), (16, 7, 42), (16, 7, 56), (16, 3, 30), (32, 7, 28),
    (32, 7, 35), (32, 15, 30), (32, 15, 60)) for mb in (0, 1, 2)]
CONFIRM_REFINE = [(b, lv, 7, c, 2, mb) for b, lv, c in (
    (4, 3, 56), (2, 4, 28), (2, 4, 63), (1, 5, 28), (1, 5, 63))
    for mb in (0, 1, 2)] + [(2, 4, 15, 60, 2, 1)]


def confirm_analytic(out: dict, f32, f64, rounds: int = 3,
                     reps: int = 5) -> None:
    """The exact exterior's fused bisections on the main path's batches at
    the default shape and the CONFIRM_* shapes, timed in `rounds` rounds
    of turns (each shape `reps` launches a round); medians."""
    import statistics
    from eigensolver_tpu_torch.kernels import common
    for name, case, args_, dtype, n_iter, final in analytic_batches(f32, f64):
        n = args_[0].numel()
        eb = _entry_bytes(case, dtype)
        fn, params = _fn(case), _params(case)
        default = common.analytic_spec_shape(n, dtype, eb, _shear(case))
        shapes = [default] + [common.SpecShape(*s) for s in (
            CONFIRM_STAGE if n >= common._SPEC_COLUMNS else CONFIRM_REFINE)
            if common.spec_smem(common.SpecShape(*s), dtype, eb)
            <= common.MAX_SMEM and _built(case, dtype, s[-1])]
        shapes = list(dict.fromkeys(shapes))
        ref = fn(*args_, n_iter, params, final, shape=default)
        times = {s: [] for s in shapes}
        for _ in range(rounds):
            for s in shapes:
                got = fn(*args_, n_iter, params, final, shape=s)
                if not all(_same_bits(a, b) for a, b in zip(got, ref)
                           if a is not None):
                    raise AssertionError(f"{name}: shape {s} differs")
                times[s].append(cuda_ms(lambda: fn(
                    *args_, n_iter, params, final, shape=s), reps))
        med = {s: statistics.median(t) for s, t in times.items()}
        r = {"n": n, "default": list(default), "default_ms": med[default],
             "ranked": [[list(s), ms] for s, ms in sorted(
                 med.items(), key=lambda kv: kv[1])],
             "spread": {",".join(map(str, s)): max(t) / min(t) - 1
                        for s, t in times.items()}}
        print(name, json.dumps({k: v for k, v in r.items() if k != "spread"}),
              flush=True)
        out[f"confirm {name}"] = r


def tune_numeric(out: dict, targets) -> None:
    """The numeric exterior's fused bisections (the speculative kernel) on
    the bracket stages of the parity sweeps `targets` (slab_ph_09,
    cyl_flow_1) at both types, 18 iterations each, and on their first 600
    brackets."""
    import torch
    from eigensolver_tpu_torch import cases, equilibrium, search, sweep
    from eigensolver_tpu_torch.kernels import common, cylinder
    from tools_torch import parity
    for target in targets:
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[-1]
            case, cfg, _ = parity.configure(
                target, cases, search.SearchConfig,
                equilibrium.genuine_continua, dname)
            eb = _entry_bytes(case, dtype)
            fn, params = _fn(case), _params(case)
            disp = sweep.make_dispersion_moded(case, dtype)
            full = sweep_brackets(case, cfg, dtype)
            for name, args_ in ((f"{target} numeric {dname}", full),
                                (f"{target} numeric 600 {dname}",
                                 [x[:600].contiguous() for x in full])):
                n = args_[0].numel()

                def fused(shape, a=args_):
                    return fn(*a, 18, params, True, shape=shape)

                levels = (0,) if n >= 2 * common._SPEC_COLUMNS else range(5)
                grid = [common.SpecShape(b, lv, p, c, 2, mb)
                        for lv in levels for b in (32 >> lv, 16 >> lv)
                        if b >= 1 for p in (3, 4, 7, 8, 15)
                        for c in (16, 24, 32, 48, 64) for mb in (0, 1, 2)]
                default = (cylinder.numeric_bisect_shape(n, dtype)
                           if case.geometry.value == "cylinder"
                           else common.numeric_spec_shape(n, dtype, eb))
                tune_batch(out, name, fused, lambda a=args_: search.bisect_loop(
                    disp, *a, 18, True), default, grid, dtype, eb)


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

        def fused(shape, a=args_):
            return cylinder.cylinder_bisect(*a, n_iter, params, final,
                                            shape=shape)

        grid = [common.SpecShape(b, lv, p, c, s, mb)
                for lv in range(6) for b in (32 >> lv, 16 >> lv, 8 >> lv)
                if b >= 1 for p in (3, 7, 15) for c in (16, 32)
                for s in (2,) for mb in (1, 2)]
        grid += [common.spec_shape(n, dtype, eb, levels=lv)
                 for lv in range(6)]
        tune_batch(out, name, fused, lambda a=args_: search.bisect_loop(
            disp, *a, n_iter, final), common.spec_shape(n, dtype, eb), grid,
            dtype, eb)


def _steps(columns: int, p: int) -> list:
    """C values of the grid: the multiples of the producers' rows (32 P /
    columns steps a pass over a stage) next below and above 32 and 64, so
    that no pass is partial."""
    rows = 32 * p // columns
    return sorted({rows * max(1, f(c / rows)) for c in (32, 64)
                   for f in (math.floor, math.ceil)})


def _fn(case):
    from eigensolver_tpu_torch.kernels import cylinder, slab
    return (slab.slab_bisect if case.geometry.value == "slab"
            else cylinder.cylinder_bisect)


def _params(case):
    from eigensolver_tpu_torch.kernels import cylinder, slab
    if case.geometry.value == "slab":
        return slab.disp_params(case)
    return cylinder.disp_params(case)


def _shear(case) -> bool:
    """Whether the case's slab chain takes the shear form."""
    return case.geometry.value == "slab" and bool(
        _params(case).struct.shear)


def _built(case, dtype, min_blocks: int) -> bool:
    """Whether the exact exterior's fused bisection of the case is built at
    the register budget: the float64 flux and cylinder chains at 128
    registers only (csrc/slab_disp.cu::launch_spec_slab,
    cylinder_disp.cu::launch_cylinder_bisect)."""
    import torch
    return min_blocks != 2 or dtype == torch.float32 or _shear(case)


def _entry_bytes(case, dtype) -> int:
    """Bytes per abscissa of the fused bisection's tables of the case at
    dtype: the slab's x-only entry, the cylinder's r-only entry with its
    rows' (and exps') tables."""
    from eigensolver_tpu_torch.kernels import cylinder, slab
    if case.geometry.value == "slab":
        return slab._ENTRY_BYTES[(bool(slab.disp_params(case).struct.shear),
                                  dtype)]
    st = cylinder.disp_params(case).struct
    return cylinder.bisect_entry_bytes(dtype, bool(st.twisted),
                                       bool(st.exterior_numeric))


def _same_bits(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


if __name__ == "__main__":
    sys.exit(main())
