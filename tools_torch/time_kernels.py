#!/usr/bin/env python3
"""Device times of the port's kernels for one checkout of the package.

    python3 tools_torch/time_kernels.py [--pkg-root DIR] [--label NAME]
                                        [--out PATH]

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
  - at complex omega, where the checkout has it: slab_newton (30 steps) on
    the 7,200 seeds of the published Kelvin-Helmholtz sweep at width 1.0
    (`tools_torch/kh.py`, float64), and slab_disp_complex on its roots and
    on the audit's 30,720 contour points;
  - the CALL instructions in each kve_ratio kernel's SASS (`cuobjdump`),
    where the toolkit has it.
To compare two commits on one card, unpack the other into a git-ignored
directory and run both in turns (A B B A) on the same card. Run from the
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


def complex_times() -> dict:
    """slab_newton on the published KH sweep's 7,200 seeds (width 1.0, 30
    steps) and slab_disp_complex on its roots and the audit's contour
    points, float64."""
    import torch
    from eigensolver_tpu_torch import cases, sweep
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.kernels import slab as kslab
    from tools_torch import kh
    case, kw = kh.configure("kh_w1", cases)
    params = kslab.disp_params(case, True)

    def pair(z):
        return C(torch.from_numpy(z.real.copy()).cuda(),
                 torch.from_numpy(z.imag.copy()).cuda())
    om0, k0 = sweep.complex_seeds(case, kw["n_re"], kw["n_im"])
    seeds, kk = pair(om0), torch.from_numpy(k0).cuda()
    par = torch.ones_like(kk)
    n_iter = kw["newton_iters"]
    roots = kslab.slab_newton(seeds, kk, par, n_iter, 1.0, params)
    cells, paths, _, _ = sweep.audit_contours(
        np.asarray(case.k_grid()), np.asarray(case.sorted_speeds()),
        case.imag_band)
    za = pair(paths.reshape(-1))
    ka = torch.from_numpy(np.repeat([c[0] for c in cells],
                                    paths.shape[1])).cuda()
    return {"seeds": len(k0), "newton_ms": cuda_ms(
                lambda: kslab.slab_newton(seeds, kk, par, n_iter, 1.0,
                                          params), 3),
            "final_eval_ms": cuda_ms(
                lambda: kslab.slab_disp_complex(roots, kk, par, params), 10),
            "audit_n": ka.numel(), "audit_ms": cuda_ms(
                lambda: kslab.slab_disp_complex(za, ka, torch.ones_like(ka),
                                                params), 10)}


def sass_calls(lib: Path) -> dict:
    """CALL instructions (and their targets) per kve_ratio kernel in the
    library's SASS; empty without cuobjdump."""
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    tool = shutil.which("cuobjdump") or str(cuda / "bin" / "cuobjdump")
    if not Path(tool).is_file():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1) if "kve_ratio_kernel" in m.group(1) else None
            if name:
                out[name] = {"calls": 0, "targets": []}
        elif name and re.search(r"\bCALL\b", ln):
            out[name]["calls"] += 1
            tgt = ln.split("CALL", 1)[1].split(";")[0].strip()
            if tgt not in out[name]["targets"]:
                out[name]["targets"].append(tgt)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pkg-root", default=str(ROOT),
                    help="directory holding eigensolver_tpu_torch")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", help="also write the report here as JSON")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.pkg_root).resolve()))
    sys.path.insert(1, str(ROOT))           # tools_torch.parity
    import warnings
    import torch
    from eigensolver_tpu_torch import cases, sweep
    from eigensolver_tpu_torch.kernels import _build, bessel
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
                if Path(args.pkg_root).resolve() == ROOT:
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
                if Path(args.pkg_root).resolve() == ROOT:
                    raise
                out[key] = "not ported"
                continue
            out[key] = {"brackets": br[0].numel(),
                        "bisect_ms": cuda_ms(lambda: disp.bisect(*br, 18), 3)}
    try:
        out["kh_w1 complex float64"] = complex_times()
    except (ImportError, AttributeError, NotImplementedError):
        # an older tree (--pkg-root) may lack the complex kernels
        if Path(args.pkg_root).resolve() == ROOT:
            raise
        out["kh_w1 complex float64"] = "not ported"
    out["sass"] = sass_calls(lib)
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
