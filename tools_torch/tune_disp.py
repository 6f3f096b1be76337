#!/usr/bin/env python3
"""Launch shapes of the cylinder scan kernel, timed on a CUDA card.

    python3 tools_torch/tune_disp.py [--out PATH]

On the cyl_co_09 sweep's own ladder scan (552,960 candidates, both modes,
in ladder order), float32 and float64, times `cylinder_disp` at every
(threads per block, table chunk of RK4 steps) of a grid, checks that each
gives the default shape's bits (`kernels.cylinder.SCAN_SHAPE`), and prints
per type the default's time and the fastest shapes. Run from the repository
root; the first line is the card's nvidia-smi name and power limit.
"""
import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
THREADS = (128, 256, 512)
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


def ladder_candidates(case, dtype):
    """The sweep's scan candidates (omega, k, m), flat, as CUDA tensors."""
    import torch
    from eigensolver_tpu_torch import sweep
    om, ks = sweep.build_ladders(case, 256)
    n_om = om.shape[1]
    flat = [np.concatenate([om.ravel()] * 2),
            np.repeat(np.concatenate([ks] * 2), n_om),
            np.repeat([0.0, 1.0], om.size)]
    return [torch.from_numpy(x).to(device="cuda", dtype=dtype) for x in flat]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report here as JSON")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from eigensolver_tpu_torch import cases
    from eigensolver_tpu_torch.kernels import cylinder
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    case = cases.cylinder_density_coronal(0.9)
    params = cylinder.disp_params(case)
    out = {"nvidia_smi": smi}
    for dtype in (torch.float32, torch.float64):
        cand = ladder_candidates(case, dtype)
        default = cylinder.SCAN_SHAPE
        ref = cylinder.cylinder_disp(*cand, params)
        res = {}
        for shape in itertools.product(THREADS, CHUNKS):
            shape = cylinder.ScanShape(*shape)
            got = cylinder.cylinder_disp(*cand, params, shape=shape)
            for a, b in zip(got, ref):
                if not bool(((a == b) | (a.isnan() & b.isnan())).all()):
                    raise AssertionError(f"{dtype}: shape {shape} differs")
            res[shape] = cuda_ms(
                lambda: cylinder.cylinder_disp(*cand, params, shape=shape), 3)
        best = sorted(res.items(), key=lambda kv: kv[1])[:5]
        name = str(dtype)[6:]
        out[name] = {"n": cand[0].numel(), "default": list(default),
                     "default_ms": res[default],
                     "best": [[list(s), ms] for s, ms in best],
                     "all": {",".join(map(str, s)): ms for s, ms in res.items()}}
        print(name, json.dumps(out[name]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
