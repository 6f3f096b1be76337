"""Per-stage wall-clock timing (port of `eigensolver_tpu.utils.StageTimer`).

PyTorch returns before a CUDA device finishes, so a stage that ends in device
work must end with `synchronize(device)` for its time to include that work;
`sweep.run_case` does so at the end of its "device_pipeline" stage.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict

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
