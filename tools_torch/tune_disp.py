#!/usr/bin/env python3
"""Launch shapes of the scan kernels, timed on a CUDA card.

    python3 tools_torch/tune_disp.py [--kernel cylinder|cylinder_numeric|
                                              slab|slab_paired|twisted|
                                              cylinder_newton|
                                              slab_newton_flux|all]
                                     [--pkg-root DIR] [--out PATH]
                                     [--shapes T:B,...] [--chunks C,...]
                                     [--rounds N]

Times each scan kernel at every (threads per block, table chunk of RK4
steps) of a grid, checks that each shape gives the default shape's bits,
and prints per set the default's time and the fastest shapes:
  - `cylinder_disp` (default `kernels.cylinder.SCAN_SHAPE`) on the cyl_co_09
    sweep's own ladder scan (552,960 candidates, both modes, in ladder
    order), float32 and float64;
  - `cylinder_disp` with the numeric exterior (`cylinder_numeric`) on the
    cyl_flow_1 parity sweep's ladder scan (3,007,620 candidates, in
    ladder order), float32 and float64, at every chunk of each block size
    the checkout builds it for (`SCAN_SHAPE`'s; the tool tries 128 and 512
    too and reports the ones the checkout refuses: another block size is
    a local edit of `launch_scan_threads` in csrc/cylinder_disp.cu and of
    `kernels.cylinder._check_scan_shape`, run with `--pkg-root`);
  - the unpaired `slab_disp` (default `kernels.slab.scan_shape`) on
    slab_ph_09's ladder (161,280, flux form) and
    slab_flow_gaussian_coronal's (179,200, shear form), float32 and
    float64, on the float64 window launch of the slab_ph_09 float32
    sweep's refine stage (10 ends per root: 1,530), and with the numeric
    exterior on 8,191 random draws of the slab_ph_09 parity ladder (flux)
    and of the Gaussian flow at 3 wavelengths (shear), float32 and float64;
  - the paired `slab_disp` (`slab_paired`: `kernels.slab.slab_disp_pairs`,
    default `PAIRS_SHAPE`) on the same sweeps' (omega, k) pairs (80,640
    and 89,600) and, with the numeric exterior, on the slab_ph_09 parity
    sweep's (174,720), float32 and float64; it is built at one block size
    a form, and the others are listed as refused (another is a local edit
    of `launch_form` in csrc/slab_disp.cu and of `kernels.slab.
    _check_scan_shape`, run with `--pkg-root`);
  - the twisted `cylinder_disp` (default `kernels.cylinder.TW_SCAN_SHAPE`)
    on the 76,800-candidate ladder scans of twist_v01_p1 and of the
    magnetic twist (cylinder_twisted_magnetic(0.1, 0.15, 1.25, 1)), float32
    and float64, at every chunk (its kernel is built for one block size and
    register budget: csrc/cylinder_twisted.cu::kTwScanThreads,
    kTwScanMinBlocks); and on small batches (twist_v01_p1's refine windows, 3,090 ends
    at float64; the first 4,096 .. 32,768 candidates of its ladder) the
    scan's default beside the fused evaluation (`common.spec_shape(n,
    evaluate=True)`) and a grid of its block shapes, which picks
    `TW_EVAL_MAX`.
  - the complex-omega cylinder kernel (`cylinder_newton`, not in `all`:
    csrc/cylinder_complex.cu, built at one launch shape a (type, chain),
    `CxShape`): the tool builds csrc/cylinder_complex.cu (with the
    cylinder's other units, whose entries the wrappers call) once for
    each (threads a block, __launch_bounds__' min blocks) of `--shapes`
    (default 64:4, 64:5, 96:3, 96:4, 128:2, 128:3, 192:2, 256:1; every
    build at once, each shape set for every type and chain through the
    source's EIGK_CX_CYL_* macros), and times each build at each table
    chunk of `--chunks` (default 8, 16, 32, 64): the Newton launch (30
    steps) on the seeds of cx_cyl_co_09 (kink) and of cx_twist_v01_p1 at
    float64 and float32, and the evaluation mode on cx_cyl_co_09's audit
    contour points at float64, each checked bit-equal to the checkout's
    default shape (`kernels.cylinder.NEWTON_SHAPE`; one launch after a
    warm-up; with `--rounds N` every shape N times in turns, the medians
    kept); per build the registers, spill bytes and blocks an SM of each
    variant. A shape whose tables do not fit is listed as refused. ~12 s
    a build and chunk after the builds (~3 min).
  - the flux form's complex-omega slab kernel (`slab_newton_flux`, not in
    `all`: csrc/slab_complex.cu::flux_kernel, one thread a seed, built at
    one launch shape a type, `FluxShape`): the tool builds
    csrc/slab_complex.cu (with slab_disp.cu, whose entry the wrappers also
    call) once for each (threads a block, __launch_bounds__' min blocks)
    of `--shapes` (default `FLUX_SHAPES`, 12 shapes) and table chunk of
    `--chunks` (default 64 alone: 16, 32 and 64 came within 2% of each
    other; every build at once, each shape set for both types through the
    source's EIGK_CX_SLAB_* macros), and times
    each build: the Newton launch with the roots' evaluation (30
    steps) on cx_ph_09's 37,800 kink seeds (`tools_torch/cx_slab.py`) at
    float64 and float32 and on the 8,640 seeds of a checkpointed block of
    8 k at float64, and the evaluation mode on its audit's 161,280 contour
    points at float64, each checked bit-equal to the checkout's default
    shape (`kernels.common.FLUX_NEWTON_SHAPE`; `--rounds N` as above); per
    build the registers, spill bytes and blocks an SM of each variant.
Run from the repository root; the first line is the card's nvidia-smi name
and power limit.
"""
import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
THREADS = {"cylinder": (128, 256, 512), "slab": (32, 64, 128, 256, 512)}
CHUNKS = (8, 16, 32, 64, 128)


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


def window_candidates(case):
    """The float64 window ends of the refine stage of the case's float32
    sweep (n_omega=256, n_bisect=18) on the card, as CUDA tensors (omega,
    k, mode)."""
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
    return list(search.refine_window_ends(om, kk, md)[2])


def tune(label: str, kernel, default, threads, cand, params) -> dict:
    """kernel(*cand, params, shape=...) at every shape of the grid: each
    checked to give the default shape's bits, timed; the default's time and
    the fastest shapes (the shapes the checkout refuses listed apart)."""
    ref = kernel(*cand, params, shape=default)
    res, refused = {}, []
    for shape in itertools.product(threads, CHUNKS):
        shape = type(default)(*shape)
        try:
            got = kernel(*cand, params, shape=shape)
        except ValueError:
            refused.append(list(shape))
            continue
        for a, b in zip(got, ref):
            if not bool(((a == b) | (a.isnan() & b.isnan())).all()):
                raise AssertionError(f"{label}: shape {shape} differs")
        res[shape] = cuda_ms(lambda: kernel(*cand, params, shape=shape), 3)
    best = sorted(res.items(), key=lambda kv: kv[1])[:5]
    out = {"n": cand[0].numel(), "default": list(default),
           "default_ms": res[default],
           "best": [[list(s), ms] for s, ms in best],
           "all": {",".join(map(str, s)): ms for s, ms in res.items()},
           "refused": refused}
    print(label, json.dumps(out), flush=True)
    return out


def numeric_slabs() -> dict:
    """The slabs with the numeric exterior: the slab_ph_09 parity
    configuration (flux form) and the Gaussian flow at 3 wavelengths
    (shear form), as chip_smoke.py's phase 13 takes them."""
    import dataclasses
    from eigensolver_tpu_torch import cases, equilibrium, search
    from tools_torch import parity
    flux, _, _ = parity.configure("slab_ph_09", cases, search.SearchConfig,
                                  equilibrium.genuine_continua)
    flow = cases.slab_flow_gaussian_coronal()
    shear = dataclasses.replace(flow, grid=dataclasses.replace(
        flow.grid, exterior_method="numeric", exterior_wavelengths=3.0))
    return {"flux": flux, "shear": shear}


def tune_twisted(out: dict) -> None:
    """The twisted scan's launch shapes, and the small batches' two paths."""
    import torch
    from eigensolver_tpu_torch import cases
    from eigensolver_tpu_torch.kernels import common, cylinder
    from tools_torch import batches
    fams = {"twist_v01_p1": cases.cylinder_twisted_photospheric(0.1, 1.0, 1),
            "magnetic_p125": cases.cylinder_twisted_magnetic(0.1, 0.15, 1.25,
                                                             1)}
    shapes = [common.ScanShape(cylinder.TW_SCAN_THREADS, c)
              for c in (16, 32, 64, 128)]
    for fam, case in fams.items():
        params = cylinder.disp_params(case)
        for dtype in (torch.float32, torch.float64):
            # the sweep's own scan: its one mode (m = 1), the ladder in order
            cand = batches.flat_ladder(case, 256, dtype)
            label = f"twisted scan {fam} {str(dtype)[6:]}"
            out[label] = tune_grid(label, cylinder.cylinder_disp,
                                   cylinder.TW_SCAN_SHAPE[dtype], shapes,
                                   cand, params)
    case = fams["twist_v01_p1"]
    params = cylinder.disp_params(case)
    eb = cylinder._ENTRY_BYTES
    for dtype in (torch.float32, torch.float64):
        full = batches.flat_ladder(case, 256, dtype)
        sets = {n: [x[:n].contiguous() for x in full]
                for n in (4096, 8192, 16384, 24576, 32768)}
        if dtype == torch.float64:
            sets["windows"] = window_candidates(case)
        for name, cand in sets.items():
            n = cand[0].numel()
            default = common.spec_shape(n, dtype, eb[dtype, True], True)
            grid = [common.SpecShape(b, 0, p, c, 2, mb)
                    for b in (4, 8, 16, 32) for p in (3, 7, 15)
                    for c in {16, 32 * p // b} for mb in (1, 2)
                    if (32 * p) % b == 0]
            grid = [g for g in grid if common.spec_smem(
                g, dtype, eb[dtype, True]) <= common.MAX_SMEM]
            label = f"twisted small {name} {str(dtype)[6:]}"
            r = tune_grid(label, cylinder.cylinder_disp, default, grid, cand,
                          params, quiet=True)
            r["scan_ms"] = cuda_ms(lambda: cylinder.cylinder_disp(
                *cand, params, shape=cylinder.TW_SCAN_SHAPE[dtype]), 3)
            r["path"] = ("fused" if n < cylinder.TW_EVAL_MAX[dtype]
                         else "scan")
            print(label, json.dumps({k: v for k, v in r.items()
                                     if k != "all"}), flush=True)
            out[label] = r


def tune_grid(label: str, kernel, default, shapes, cand, params,
              quiet: bool = False) -> dict:
    """kernel(*cand, params, shape=...) at the default and every shape of
    `shapes`: each checked to give the default shape's bits, timed; the
    default's time and the fastest shapes."""
    ref = kernel(*cand, params, shape=default)
    res = {}
    for shape in [default, *shapes]:
        got = kernel(*cand, params, shape=shape)
        for a, b in zip(got, ref):
            if not bool(((a == b) | (a.isnan() & b.isnan())).all()):
                raise AssertionError(f"{label}: shape {shape} differs")
        res[tuple(shape)] = cuda_ms(lambda: kernel(*cand, params,
                                                   shape=shape), 3)
    best = sorted(res.items(), key=lambda kv: kv[1])[:5]
    out = {"n": cand[0].numel(), "default": list(default),
           "default_ms": res[tuple(default)],
           "best": [[list(s), ms] for s, ms in best],
           "all": {",".join(map(str, s)): ms for s, ms in res.items()}}
    if not quiet:
        print(label, json.dumps({k: v for k, v in out.items() if k != "all"}),
              flush=True)
    return out


NEWTON_SHAPES = ((64, 4), (64, 5), (96, 3), (96, 4), (128, 2), (128, 3),
                 (192, 2), (256, 1))
NEWTON_CHUNKS = (8, 16, 32, 64)


def tune_newton(out: dict, shapes, chunks, rounds: int = 1) -> None:
    """The complex-omega cylinder kernel's launch shapes (see the module's
    docstring)."""
    import contextlib
    import torch
    from eigensolver_tpu_torch import cases, sweep
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.kernels import _build, common
    from eigensolver_tpu_torch.kernels import cylinder as kcyl
    from tools_torch import cx_cyl

    def macros(threads, min_blocks):
        return [f"EIGK_CX_CYL_{c}{t}_{what}={v}"
                for c in ("", "TW_") for t in ("F32", "F64")
                for what, v in (("THREADS", threads),
                                ("MIN_BLOCKS", min_blocks))]
    # csrc/cylinder_complex.cu at each shape, with the units whose entries
    # its wrappers also call (the parameters' size, the twisted launcher)
    units = ["cylinder_complex.cu", "cylinder_disp.cu", "cylinder_twisted.cu"]
    libs = _build.build_variants([(units, macros(*sh)) for sh in shapes])

    @contextlib.contextmanager
    def built(path, threads, chunk):
        # the wrappers launch the build at this shape
        saved = _build._lib, kcyl.NEWTON_SHAPE
        _build._lib = _build.load(path)
        kcyl.NEWTON_SHAPE = {key: common.ScanShape(threads, chunk)
                             for key in saved[1]}
        try:
            yield _build._lib
        finally:
            _build._lib, kcyl.NEWTON_SHAPE = saved

    def pair(om, k, dtype):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dtype)
        return C(t(om.real), t(om.imag)), t(k)

    sets = {}
    for name in ("cx_cyl_co_09", "cx_twist_v01_p1"):
        case, kw = cx_cyl.configure(name, cases)
        params = kcyl.disp_params(case)
        om0, k0 = sweep.complex_seeds(case, kw["n_re"], kw["n_im"])
        for dtype in (torch.float64, torch.float32):
            seeds, kk = pair(om0, k0, dtype)
            mm = torch.ones_like(kk)
            sets[f"{name} newton {str(dtype)[6:]}"] = (
                lambda s=seeds, k=kk, m=mm, p=params, n=kw["newton_iters"]:
                kcyl.cylinder_newton(s, k, m, n, 1.0, p))
        if name == "cx_cyl_co_09":
            cells, paths, _, _ = sweep.audit_contours(
                np.asarray(case.k_grid()), np.asarray(case.sorted_speeds()),
                case.imag_band)
            z, ka = pair(paths.reshape(-1),
                         np.repeat(np.array([c[0] for c in cells]),
                                   paths.shape[1]), torch.float64)
            ma = torch.ones_like(ka)
            sets[f"{name} audit float64"] = (
                lambda z=z, k=ka, m=ma, p=params:
                kcyl.cylinder_disp_complex(z, k, m, p).det)
    ref = {label: fn() for label, fn in sets.items()}
    torch.cuda.synchronize()

    def same(a, b):
        it = torch.int32 if a.re.dtype == torch.float32 else torch.int64
        return all(torch.equal(x.view(it), y.view(it))
                   for x, y in ((a.re, b.re), (a.im, b.im)))
    res = {label: {} for label in sets}
    attrs, refused = {}, []
    combos = [(sh, path, chunk) for sh, path in zip(shapes, libs)
              for chunk in chunks]
    for (threads, min_blocks), path, chunk in combos * rounds:
        key = f"{threads}:{min_blocks}:{chunk}"
        if key in refused:
            continue
        with built(path, threads, chunk):
            try:
                attrs[key] = {
                    f"{str(dt)[6:]} {'twisted' if tw else 'plain'}":
                    kcyl.newton_attrs(dt, tw, False, chunk)
                    for dt in (torch.float32, torch.float64)
                    for tw in (False, True)}
            except (ValueError, RuntimeError):
                refused.append(key)
                continue
            for label, fn in sets.items():
                try:
                    got = fn()
                except (ValueError, RuntimeError):
                    res[label][key] = None
                    continue
                if not same(got, ref[label]):
                    raise AssertionError(f"{label}: shape {key} "
                                         f"differs")
                res[label].setdefault(key, []).append(cuda_ms(fn, 1))
        print("cylinder_newton", key, json.dumps(
            {label: r.get(key) for label, r in res.items()}),
            flush=True)
    for label, r in res.items():
        timed = {k: float(np.median(v)) for k, v in r.items()
                 if v is not None}
        best = sorted(timed.items(), key=lambda kv: kv[1])[:5]
        out[f"cylinder_newton {label}"] = {"best": best, "all": r}
        print(f"cylinder_newton {label}", json.dumps({"best": best}),
              flush=True)
    out["cylinder_newton attrs"] = attrs
    out["cylinder_newton refused"] = refused
    print("cylinder_newton attrs", json.dumps(attrs), flush=True)


# the flux form's complex-omega slab kernel (--kernel slab_newton_flux):
# (threads, min_blocks) builds and table chunks
FLUX_SHAPES = ((32, 8), (64, 4), (64, 6), (96, 3), (96, 4), (128, 2),
               (128, 3), (128, 4), (192, 2), (256, 1), (256, 2), (512, 1))
FLUX_CHUNKS = (64,)


def tune_slab_flux(out: dict, shapes, chunks, rounds: int = 1) -> None:
    """The flux form's complex-omega slab kernel's launch shapes (see the
    module's docstring)."""
    import contextlib
    import torch
    from eigensolver_tpu_torch import cases, sweep
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.kernels import _build, common
    from eigensolver_tpu_torch.kernels import slab as kslab
    from tools_torch import cx_slab

    def macros(threads, min_blocks, chunk):
        return [f"EIGK_CX_SLAB_{t}_{what}={v}" for t in ("F32", "F64")
                for what, v in (("THREADS", threads),
                                ("MIN_BLOCKS", min_blocks),
                                ("CHUNK", chunk))]
    # csrc/slab_complex.cu at each shape and chunk, with slab_disp.cu,
    # whose entry the wrappers also call (the parameters' size)
    units = ["slab_complex.cu", "slab_disp.cu"]
    combos = [(threads, min_blocks, chunk) for threads, min_blocks in shapes
              for chunk in chunks]
    libs = _build.build_variants([(units, macros(*c)) for c in combos])

    @contextlib.contextmanager
    def built(path, threads, min_blocks, chunk):
        # the wrappers launch the build at this shape, and its mirror
        # (flux_attrs holds the build to it) says so
        saved = _build._lib, dict(common.FLUX_NEWTON_SHAPE)
        _build._lib = _build.load(path)
        common.FLUX_NEWTON_SHAPE.update({
            dt: common.FluxNewtonShape(threads, chunk, min_blocks)
            for dt in saved[1]})
        try:
            yield _build._lib
        finally:
            _build._lib = saved[0]
            common.FLUX_NEWTON_SHAPE.update(saved[1])

    def pair(om, k, dtype):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dtype)
        return C(t(om.real), t(om.imag)), t(k)

    case, kw = cx_slab.configure("cx_ph_09", cases)
    params = kslab.disp_params(case, True)
    om0, k0 = sweep.complex_seeds(case, kw["n_re"], kw["n_im"])
    n_iter = kw["newton_iters"]
    n_block = 8 * 9 * kw["n_re"] * kw["n_im"]
    sets = {}
    for dtype in (torch.float64, torch.float32):
        seeds, kk = pair(om0, k0, dtype)
        par = torch.ones_like(kk)
        sets[f"cx_ph_09 newton {str(dtype)[6:]}"] = (
            lambda s=seeds, k=kk, m=par:
            kslab.slab_newton(s, k, m, n_iter, 1.0, params, final_eval=True))
    seeds, kk = pair(om0[:n_block], k0[:n_block], torch.float64)
    par = torch.ones_like(kk)
    sets[f"cx_ph_09 block {n_block} float64"] = (
        lambda s=seeds, k=kk, m=par:
        kslab.slab_newton(s, k, m, n_iter, 1.0, params, final_eval=True))
    cells, paths, _, _ = sweep.audit_contours(
        np.asarray(case.k_grid()), np.asarray(case.sorted_speeds()),
        case.imag_band)
    z, ka = pair(paths.reshape(-1),
                 np.repeat(np.array([c[0] for c in cells]), paths.shape[1]),
                 torch.float64)
    pa = torch.ones_like(ka)
    sets["cx_ph_09 audit float64"] = (
        lambda z=z, k=ka, m=pa:
        (None, kslab.slab_disp_complex(z, k, m, params)))
    ref = {label: fn() for label, fn in sets.items()}
    torch.cuda.synchronize()

    def same(a, b):
        def parts(r):
            om, res = r
            xs = [res.det.re, res.det.im, res.mismatch_pct]
            return xs + ([om.re, om.im] if om is not None else [])
        it = torch.int32 if b[1].det.re.dtype == torch.float32 else \
            torch.int64
        return all(torch.equal(x.view(it), y.view(it))
                   for x, y in zip(parts(a), parts(b)))
    res = {label: {} for label in sets}
    attrs, refused = {}, []
    for (threads, min_blocks, chunk), path in list(zip(combos, libs)) * rounds:
        key = f"{threads}:{min_blocks}:{chunk}"
        if key in refused:
            continue
        with built(path, threads, min_blocks, chunk):
            try:
                attrs[key] = {
                    f"{str(dt)[6:]}{' numeric' if num else ''}":
                    kslab.flux_attrs(dt, num)
                    for dt in (torch.float32, torch.float64)
                    for num in (False, True)}
            except (ValueError, RuntimeError):
                refused.append(key)
                continue
            for label, fn in sets.items():
                try:
                    got = fn()
                except (ValueError, RuntimeError):
                    res[label][key] = None
                    continue
                if not same(got, ref[label]):
                    raise AssertionError(f"{label}: shape {key} differs")
                res[label].setdefault(key, []).append(cuda_ms(fn, 1))
        print("slab_newton_flux", key, json.dumps(
            {label: r.get(key) for label, r in res.items()}), flush=True)
    for label, r in res.items():
        timed = {k: float(np.median(v)) for k, v in r.items()
                 if v is not None}
        best = sorted(timed.items(), key=lambda kv: kv[1])[:5]
        out[f"slab_newton_flux {label}"] = {"best": best, "all": r}
        print(f"slab_newton_flux {label}", json.dumps({"best": best}),
              flush=True)
    out["slab_newton_flux attrs"] = attrs
    out["slab_newton_flux refused"] = refused
    print("slab_newton_flux attrs", json.dumps(attrs), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("cylinder", "cylinder_numeric",
                                         "slab", "slab_paired", "twisted",
                                         "cylinder_newton",
                                         "slab_newton_flux", "all"),
                    default="all")
    ap.add_argument("--shapes", help="cylinder_newton, slab_newton_flux: "
                    "threads:min_blocks pairs, comma-separated")
    ap.add_argument("--chunks", help="cylinder_newton, slab_newton_flux: "
                    "table chunks, comma-separated")
    ap.add_argument("--rounds", type=int, default=1,
                    help="cylinder_newton, slab_newton_flux: time every "
                    "shape this many times, in turns, and keep the medians")
    ap.add_argument("--pkg-root", default=str(ROOT),
                    help="directory holding eigensolver_tpu_torch")
    ap.add_argument("--out", help="also write the report here as JSON")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.pkg_root).resolve()))
    sys.path.insert(1, str(ROOT))           # tools_torch
    import warnings
    import torch
    from eigensolver_tpu_torch import cases
    from eigensolver_tpu_torch.kernels import cylinder, slab
    from tools_torch import batches
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    warnings.simplefilter("ignore")         # saturated-row notices
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    out = {"nvidia_smi": smi}
    if args.kernel in ("cylinder", "all"):
        case = cases.cylinder_density_coronal(0.9)
        params = cylinder.disp_params(case)
        for dtype in (torch.float32, torch.float64):
            name = f"cylinder_disp {str(dtype)[6:]}"
            out[name] = tune(name, cylinder.cylinder_disp, cylinder.SCAN_SHAPE,
                             THREADS["cylinder"],
                             batches.flat_ladder(case, 256, dtype), params)
    if args.kernel in ("cylinder_numeric", "all"):
        from eigensolver_tpu_torch import equilibrium, search
        from tools_torch import parity
        case, cfg, _ = parity.configure("cyl_flow_1", cases,
                                        search.SearchConfig,
                                        equilibrium.genuine_continua)
        for dtype in (torch.float32, torch.float64):
            name = f"cylinder_disp numeric cyl_flow_1 {str(dtype)[6:]}"
            out[name] = tune(name, cylinder.cylinder_disp,
                             cylinder.SCAN_SHAPE, THREADS["cylinder"],
                             batches.flat_ladder(case, cfg.n_omega, dtype),
                             cylinder.disp_params(case))
    if args.kernel in ("slab", "all"):
        for form, case in (("flux slab_ph_09",
                            cases.slab_density_photospheric(0.9)),
                           ("shear flow_gauss",
                            cases.slab_flow_gaussian_coronal())):
            params = slab.disp_params(case)
            shear = bool(params.struct.shear)
            for dtype in (torch.float32, torch.float64):
                name = f"slab_disp {form} {str(dtype)[6:]}"
                cand = batches.flat_ladder(case, 256, dtype)
                out[name] = tune(name, slab.slab_disp,
                                 slab.scan_shape(cand[0].numel(), shear),
                                 THREADS["slab"], cand, params)
        case = cases.slab_density_photospheric(0.9)
        cand = window_candidates(case)
        out["slab_disp window float64"] = tune(
            "slab_disp window float64", slab.slab_disp,
            slab.scan_shape(cand[0].numel(), False), THREADS["slab"], cand,
            slab.disp_params(case))
        for form, case in numeric_slabs().items():
            params = slab.disp_params(case)
            shear = bool(params.struct.shear)
            for dtype in (torch.float32, torch.float64):
                name = f"slab_disp numeric {form} 8191 {str(dtype)[6:]}"
                cand = batches.ladder_draws(case, 8191, 13, dtype)
                out[name] = tune(name, slab.slab_disp,
                                 slab.scan_shape(8191, shear),
                                 THREADS["slab"], cand, params)
    if args.kernel in ("slab_paired", "all"):
        sets = {"flux slab_ph_09": (cases.slab_density_photospheric(0.9),
                                    256),
                "shear flow_gauss": (cases.slab_flow_gaussian_coronal(),
                                     256),
                "numeric parity": (numeric_slabs()["flux"], 384)}
        for form, (case, n_omega) in sets.items():
            params = slab.disp_params(case)
            shear = bool(params.struct.shear)
            for dtype in (torch.float32, torch.float64):
                name = f"slab_disp paired {form} {str(dtype)[6:]}"
                cand = batches.flat_ladder(case, n_omega, dtype)
                half = [x[:x.numel() // 2] for x in cand[:2]]
                out[name] = tune(name, slab.slab_disp_pairs,
                                 slab.PAIRS_SHAPE[shear],
                                 THREADS["slab"], half, params)
    if args.kernel in ("twisted", "all"):
        tune_twisted(out)
    if args.kernel == "cylinder_newton":
        shapes = (tuple(tuple(int(v) for v in sh.split(":"))
                        for sh in args.shapes.split(","))
                  if args.shapes else NEWTON_SHAPES)
        chunks = (tuple(int(c) for c in args.chunks.split(","))
                  if args.chunks else NEWTON_CHUNKS)
        tune_newton(out, shapes, chunks, args.rounds)
    if args.kernel == "slab_newton_flux":
        shapes = (tuple(tuple(int(v) for v in sh.split(":"))
                        for sh in args.shapes.split(","))
                  if args.shapes else FLUX_SHAPES)
        chunks = (tuple(int(c) for c in args.chunks.split(","))
                  if args.chunks else FLUX_CHUNKS)
        tune_slab_flux(out, shapes, chunks, args.rounds)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
