#!/usr/bin/env python3
"""Device-time breakdown of the port's full-size sweeps on a CUDA card.

    python3 tools_torch/profile_sweep.py [--out PATH]

Runs slab_ph_09 (f32, f64, f32 with refine_f64=True), cyl_co_09 (f32, f64),
twist_v01_p1 (cylinder_twisted_photospheric(0.1, 1.0, 1): f32, f64, f32 with
refine_f64=True) and the magnetic twist (cylinder_twisted_magnetic(0.1,
0.15, 1.25, 1): f64) at
SearchConfig(n_omega=256, n_bisect=18) through `sweep.run_case(...,
device="cuda")`, each once to warm up and once under `torch.profiler`, and
prints per run: the wall, the device busy time (sum of the kernels' self
device time), the idle share 1 - busy / wall, the launches and device time
of each kernel, and the root counts. Run from the repository root; the first
line is the card's nvidia-smi name and power limit.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report here as JSON")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from eigensolver_tpu_torch import cases, search, sweep
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
    twist = cases.cylinder_twisted_photospheric(0.1, 1.0, 1)
    runs = (("slab_ph_09 f32", slab, f32, False),
            ("slab_ph_09 f64", slab, f64, False),
            ("slab_ph_09 f32 refined", slab, f32, True),
            ("cyl_co_09 f32", cases.cylinder_density_coronal(0.9), f32, False),
            ("cyl_co_09 f64", cases.cylinder_density_coronal(0.9), f64, False),
            ("twist_v01_p1 f32", twist, f32, False),
            ("twist_v01_p1 f64", twist, f64, False),
            ("twist_v01_p1 f32 refined", twist, f32, True),
            ("magnetic_p125 f64",
             cases.cylinder_twisted_magnetic(0.1, 0.15, 1.25, 1), f64, False))
    out = {"nvidia_smi": smi}
    for name, case, cfg, refine in runs:
        sweep.run_case(case, cfg, device="cuda", refine_f64=refine)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rs, _ = sweep.run_case(case, cfg, device="cuda", refine_f64=refine)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us:
                kernels[e.key[:80]] = {"ms": us / 1e3, "count": e.count}
        busy = sum(k["ms"] for k in kernels.values())
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:8])
        out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                     "idle_share": 1 - busy / wall_ms, "counts": rs.counts(),
                     "kernels": top}
        print(name, json.dumps(out[name]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
