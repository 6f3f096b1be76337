"""Case-level sweep orchestration: config -> RootSet (PyTorch port).

Port of `eigensolver_tpu.sweep.run_case` and the pieces it runs: the
(k x speed-band) cell grid becomes ladder rows of one batch per mode family,
all families fused into one batch with a mode column, searched on the given
device, then gathered, deduplicated and sorted on the host.

Every public entry takes an explicit `device` ("cpu", "cuda", ...): on a
CUDA device the dispersion runs the `cylinder_disp` kernel, on the CPU its
plain version. Not ported yet: slab geometry (ROADMAP A3), f64 refinement
(A5), the complex-omega sweep (A10), the needle pass (A11), checkpointed
sweeps (A12).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .config import CaseConfig, Geometry
from .physics.cylinder import CylinderPhysics
from .roots import RootBranch, RootSet, dedup_roots
from .search import SearchConfig, collect, search_rows, torch_dtype
from .utils import StageTimer, synchronize

MODE_NAMES = {0: "sausage", 1: "kink"}


def make_physics(case: CaseConfig):
    if case.geometry == Geometry.SLAB:
        raise NotImplementedError("slab geometry: ROADMAP A3")
    return CylinderPhysics.from_case(case)


def make_dispersion(case: CaseConfig, mode: int,
                    dtype=torch.float64) -> Callable:
    return make_physics(case).make_dispersion(m=mode, dtype=dtype)


def make_dispersion_moded(case: CaseConfig, dtype) -> Callable:
    """Batched disp(omega, k, mode) with the mode family as a per-candidate
    column: one call covers sausage AND kink."""
    return make_physics(case).make_dispersion(m=None, dtype=dtype)


def build_ladders(case: CaseConfig, n_omega: Optional[int] = None,
                  edge_shrink: Optional[float] = None):
    """(rows, n_omega) omega ladders + (rows,) ks from the (k x band) grid,
    as float64 numpy arrays.

    Bands are phase-speed windows: omega in [v_lo k, v_hi k], edges shrunk
    by `edge_shrink` (default `case.grid.ladder_edge_shrink`) to avoid
    evaluating exactly on characteristic-speed singularities."""
    n_omega = n_omega or case.grid.n_omega_ladder
    if edge_shrink is None:
        edge_shrink = case.grid.ladder_edge_shrink
    ks = np.asarray(case.k_grid())
    speeds = np.asarray(case.sorted_speeds())
    if len(speeds) < 2:
        raise ValueError(f"case {case.name} needs >= 2 speed band edges")
    if case.grid.ladder_shape == "chebyshev":
        raise NotImplementedError("ladder_shape='chebyshev': no case uses it "
                                  "(ROADMAP A, do-not-port list)")
    if case.grid.ladder_shape != "uniform":
        raise ValueError(f"unknown ladder_shape {case.grid.ladder_shape!r}")
    t = np.linspace(0.0, 1.0, n_omega)
    rows_k = []
    rows_om = []
    for k in ks:
        for lo, hi in zip(speeds[:-1], speeds[1:]):
            gap = (hi - lo) * edge_shrink
            w = (lo + gap) + (hi - lo - 2 * gap) * t
            rows_k.append(k)
            rows_om.append(w * k)
    return np.stack(rows_om), np.array(rows_k)


@dataclasses.dataclass
class SweepStats:
    wall_s: float = 0.0
    n_candidates: int = 0
    n_roots: int = 0

    @property
    def roots_per_sec(self) -> float:
        return self.n_roots / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def candidates_per_sec(self) -> float:
        return self.n_candidates / self.wall_s if self.wall_s > 0 else 0.0


def finalize_branches(pr, modes, case: CaseConfig, search: SearchConfig,
                      refine_f64: bool = False) -> Dict[str, RootBranch]:
    """Host gather of accepted roots, per-mode dedup, sort by k."""
    if refine_f64:
        raise NotImplementedError("refine_f64: ROADMAP A5")
    om, kk, _, md = collect(pr)
    branches: Dict[str, RootBranch] = {}
    for mode in modes:
        sel = np.abs(md - float(mode)) < 0.5
        om_m, kk_m = dedup_roots(om[sel], kk[sel], rel_tol=case.tol.dedup_rel)
        name = MODE_NAMES.get(mode, f"m{mode}")
        branches[name] = RootBranch(omegas=om_m, ks=kk_m).sorted_by_k()
    return branches


def run_case(case: CaseConfig, search: Optional[SearchConfig] = None,
             modes=None, *, device, refine_f64: bool = False,
             timer: Optional[StageTimer] = None
             ) -> tuple[RootSet, SweepStats]:
    """Sweep one case on `device`. Returns (RootSet, SweepStats).

    timer: optional `utils.StageTimer`; accumulates the wall time of the
    three stages (ladders / device_pipeline / finalize). The device stage
    ends with a device synchronize, so its time includes the device work."""
    device = torch.device(device)
    search = search or SearchConfig(
        n_omega=case.grid.n_omega_ladder,
        n_bisect=case.grid.n_bisect,
    )
    if timer is None:
        timer = StageTimer()           # unobserved, but keeps one code path
    modes = tuple(modes) if modes is not None else case.modes
    scan_dt = torch_dtype(search.scan_dtype)
    polish_dt = torch_dtype(search.polish_dtype)

    with timer.stage("ladders"):
        omegas, ks = build_ladders(case, search.n_omega)
        rows = omegas.shape[0]
        # all mode families in one batch with a mode column, mode 0 rows
        # first; ladders are float64 until the one cast to the scan dtype
        omegas_f = np.concatenate([omegas] * len(modes))
        ks_f = np.concatenate([ks] * len(modes))
        modes_f = np.concatenate([np.full((rows,), float(mode))
                                  for mode in modes])
        disp_scan = make_dispersion_moded(case, scan_dt)
        disp_polish = (disp_scan if polish_dt == scan_dt
                       else make_dispersion_moded(case, polish_dt))

    stats = SweepStats()
    t0 = time.time()
    with timer.stage("device_pipeline"):
        def to_dev(a):
            return torch.from_numpy(a).to(device=device, dtype=scan_dt)

        pr = search_rows(disp_scan, disp_polish, to_dev(omegas_f),
                         to_dev(ks_f), search, modes=to_dev(modes_f))
        synchronize(device)
    with timer.stage("finalize"):
        branches = finalize_branches(pr, modes, case, search,
                                     refine_f64=refine_f64)
    stats.n_roots = sum(len(b) for b in branches.values())
    stats.n_candidates = omegas_f.size
    stats.wall_s = time.time() - t0
    return RootSet(branches, case_name=case.name), stats
