"""Per-stage wall-clock timing and device profiling (port of
`eigensolver_tpu.utils`: `StageTimer`, `device_trace`, `block_and_time`).

PyTorch returns before a CUDA device finishes, so a stage that ends in device
work must end with `synchronize(device)` for its time to include that work;
`sweep.run_case` does so at the end of its "device_pipeline" stage.
"""
from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path
from typing import Dict, Optional

import torch

log = logging.getLogger("eigensolver_tpu_torch")


class StageTimer:
    """Accumulates wall time per named stage; `report()` returns a dict."""

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.stages[name] = self.stages.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            log.debug("stage %s: %.3fs (total %.3fs x%d)", name, dt,
                      self.stages[name], self.counts[name])

    def report(self) -> Dict[str, float]:
        return dict(sorted(self.stages.items(), key=lambda kv: -kv[1]))


def synchronize(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """`torch.profiler` trace of the host and, where there is one, the CUDA
    device around a block, written to `log_dir/trace.json` as a Chrome
    trace (chrome://tracing, Perfetto); a no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def block_and_time(fn, *args, n: int = 1, device=None, **kwargs):
    """Run fn once, then n times, each call followed by `synchronize`
    (of `device`; of the current CUDA device where it is None and CUDA
    has been initialised); return (last result, seconds per timed call)."""
    def sync():
        if device is not None:
            synchronize(device)
        elif torch.cuda.is_initialized():
            torch.cuda.synchronize()

    out = fn(*args, **kwargs)
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, **kwargs)
        sync()
    return out, (time.perf_counter() - t0) / max(n, 1)
