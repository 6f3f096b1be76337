"""Case-level sweep orchestration: config -> RootSet (PyTorch port).

Port of `eigensolver_tpu.sweep.run_case` and the pieces it runs: the
(k x speed-band) cell grid becomes ladder rows of one batch per mode family,
all families fused into one batch with a mode column, searched on the given
device, then gathered, deduplicated and sorted on the host.

Every public entry takes an explicit `device` ("cpu", "cuda", ...): on a
CUDA device the dispersion runs the `slab_disp` or `cylinder_disp` kernel,
on the CPU its plain version. The f64 refinement (`refine_f64=True`) and the
band-edge (needle) pass (`run_needle_pass`, which the JAX package runs on
the host CPU) run on the same device. The complex-omega sweep
(`run_case_complex`: Kelvin-Helmholtz growth rates, or any slab or
cylinder case made complex) runs its Newton iteration, the evaluation of its roots and its
argument-principle audit on the device too. The crash-safe sweeps (`run_case_checkpointed`,
`run_case_complex_checkpointed`) run either sweep block by block of k and
append each block's roots to the checkpoint store (`native.store`) before
the next block starts.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .config import CaseConfig, Geometry
from .physics.cylinder import CylinderPhysics
from .physics.slab import SlabPhysics
from .equilibrium import genuine_continua
from .roots import RootBranch, RootSet, dedup_complex_roots, dedup_roots
from .search import (SearchConfig, _bound, _path_tensors, collect,
                     newton_complex, polish_rows, rectangle_path,
                     refine_roots_f64, scan_rows, search_rows, torch_dtype,
                     warn_saturated, winding_numbers)
from .utils import StageTimer, synchronize

MODE_NAMES = {0: "sausage", 1: "kink"}


def make_physics(case: CaseConfig):
    if case.geometry == Geometry.SLAB:
        return SlabPhysics.from_case(case)
    return CylinderPhysics.from_case(case)


def make_dispersion(case: CaseConfig, mode: Optional[int],
                    dtype=torch.float64) -> Callable:
    """disp(omega, k) for one mode family (slab parity / cylinder azimuthal
    order), or disp(omega, k, mode) with mode=None."""
    ph = make_physics(case)
    if case.geometry == Geometry.SLAB:
        return ph.make_dispersion(parity=mode, dtype=dtype)
    return ph.make_dispersion(m=mode, dtype=dtype)


def make_dispersion_moded(case: CaseConfig, dtype) -> Callable:
    """Batched disp(omega, k, mode) with the mode family as a per-candidate
    column: one call covers sausage AND kink."""
    return make_dispersion(case, None, dtype)


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
    t = np.linspace(0.0, 1.0, n_omega)
    if case.grid.ladder_shape == "chebyshev":
        # cluster seeds quadratically toward both band edges (body-mode
        # families accumulate at the characteristic speeds the edges sit on)
        t = 0.5 * (1.0 - np.cos(np.pi * t))
    elif case.grid.ladder_shape != "uniform":
        raise ValueError(f"unknown ladder_shape {case.grid.ladder_shape!r}")
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
    # complex sweeps: argument-principle completeness audit (see
    # run_case_complex) - {"cells", "checked", "agree", "missed", "fraction"}
    completeness: Optional[dict] = None

    @property
    def roots_per_sec(self) -> float:
        return self.n_roots / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def candidates_per_sec(self) -> float:
        return self.n_candidates / self.wall_s if self.wall_s > 0 else 0.0


def finalize_branches(pr, modes, case: CaseConfig, search: SearchConfig,
                      refine_f64: bool = False,
                      timer: Optional[StageTimer] = None
                      ) -> Dict[str, RootBranch]:
    """Host gather of accepted roots, per-mode dedup, sort by k.

    refine_f64: re-bisect the polished roots in float64 on the sweep's own
    device (`search.refine_roots_f64`, the port of `refine_on_cpu`), drop
    the ones the f64 dispersion never brackets, re-judge acceptance at the
    refined root when `search.accept_pct_refined` is set, and dedup again
    (eigensolver_tpu/sweep.py:440-475). All modes go through one batch with
    a mode column; the arithmetic per root is that of a per-mode call."""
    return finalize_collected(collect(pr, with_fuzz=True), modes, case,
                              search, refine_f64=refine_f64, timer=timer,
                              device=pr.omega.device)


def finalize_collected(collected, modes, case: CaseConfig,
                       search: SearchConfig, refine_f64: bool = False,
                       timer: Optional[StageTimer] = None, *, device
                       ) -> Dict[str, RootBranch]:
    """`finalize_branches` from the host arrays that `search.collect(pr,
    with_fuzz=True)` gives, (omega, k, mismatch, mode, fuzz) of the
    accepted entries in the sweep's order, the refinement on `device`
    (the sharded sweep gathers them from every device first)."""
    om, kk, _, md, fz = collected
    sel = {mode: np.abs(md - float(mode)) < 0.5 for mode in modes}
    if refine_f64:
        # only polished roots are refined; fuzz records keep their scan
        # seeds (the reference records its swath entries at them)
        parts = [dedup_roots(om[sel[m] & ~fz], kk[sel[m] & ~fz],
                             rel_tol=case.tol.dedup_rel) for m in modes]
        om_r = np.concatenate([p[0] for p in parts])
        kk_r = np.concatenate([p[1] for p in parts])
        md_r = np.concatenate([np.full(len(p[0]), float(m))
                               for p, m in zip(parts, modes)])
        if len(om_r):
            with (timer or StageTimer()).stage("refine"):
                disp64 = make_dispersion_moded(case, torch.float64)

                def to_dev(a):
                    return torch.from_numpy(
                        np.asarray(a, np.float64)).to(device)

                om_t, k_t, md_t = to_dev(om_r), to_dev(kk_r), to_dev(md_r)
                root, bracketed = refine_roots_f64(disp64, om_t, k_t, md_t)
                keep = bracketed
                if search.accept_pct_refined is not None:
                    res = disp64(root, k_t, md_t)
                    keep = keep & (res.mismatch_pct
                                   < search.accept_pct_refined) & res.valid
                root = root.cpu().numpy()
                keep = keep.cpu().numpy()
            # never-bracketed entries are f32 scan noise, not roots
            om_r, kk_r, md_r = root[keep], kk_r[keep], md_r[keep]
    branches: Dict[str, RootBranch] = {}
    for mode in modes:
        if refine_f64:
            s = np.abs(md_r - float(mode)) < 0.5
            f = sel[mode] & fz
            om_m, kk_m = dedup_roots(np.concatenate([om_r[s], om[f]]),
                                     np.concatenate([kk_r[s], kk[f]]),
                                     rel_tol=case.tol.dedup_rel)
        else:
            om_m, kk_m = dedup_roots(om[sel[mode]], kk[sel[mode]],
                                     rel_tol=case.tol.dedup_rel)
        name = MODE_NAMES.get(mode, f"m{mode}")
        branches[name] = RootBranch(omegas=om_m, ks=kk_m).sorted_by_k()
    return branches


def needle_edges(case: CaseConfig, labels: Optional[tuple] = ("cusp",)):
    """Continuum band edges where near-edge spectral structure lives (port
    of `eigensolver_tpu.sweep.needle_edges`, sweep.py:484-505).

    Returns ((edge_v, side, in_band), ...): one thin window per band edge
    and direction, `side` = +-1 the direction of the window from the edge
    (v = edge + side |edge| d), `in_band` whether it points into the band;
    both edges of every genuine band whose label contains one of `labels`
    (None: every band), the unshrunk boundaries (guard 0)."""
    edges = []
    for lo, hi, lab in genuine_continua(case, guard=0.0):
        if labels is not None and not any(s in lab for s in labels):
            continue
        edges.append((float(lo), -1.0, False))
        edges.append((float(lo), +1.0, True))
        edges.append((float(hi), -1.0, True))
        edges.append((float(hi), +1.0, False))
    return tuple(edges)


def run_needle_pass(case: CaseConfig, search: Optional[SearchConfig] = None,
                    edges=None, modes=None, n_omega: int = 512,
                    width_rel: float = 3e-3, margin_rel: float = 2e-7,
                    max_brackets_per_row: int = 128, edge_modes: int = 1,
                    ks=None, n_interior: Optional[int] = 512, *, device
                    ) -> tuple[RootSet, SweepStats]:
    """The band-edge (needle) pass on `device`, in float64 (port of
    `eigensolver_tpu.sweep.run_needle_pass`, sweep.py:508-619; the JAX
    package runs it on the host CPU).

    For each k and edge, a window of n_omega phase speeds log-spaced in
    distance to the edge, from margin_rel to width_rel of |edge|, goes
    through the main sweep's path (`search_rows`: the scan, the fused
    bisection, acceptance; then `finalize_branches`) with the case at
    `n_interior` RK4 steps (None: the case's), dedup at 1e-6 relative, no
    fuzz acceptance, at most max_brackets_per_row (< n_omega) brackets a
    row; `search` defaults to SearchConfig(accept_pct=case.tol.p_tol,
    n_bisect=30). Outside the band every accepted zero is kept; inside,
    the `edge_modes` nearest the edge per (k, window)
    (`_filter_edge_modes`). Combine with a main sweep through
    `roots.merge_rootsets`.

    As in the JAX package (ROADMAP C, reference defects): the caller's
    exclude_v_ranges and exclude_omega_rowfn stay in force, and so can
    mask the very windows the pass scans."""
    device = torch.device(device)
    if edges is None:
        edges = needle_edges(case)
    modes = tuple(modes) if modes is not None else case.modes
    if not edges:
        empty = RootBranch(omegas=np.zeros(0), ks=np.zeros(0))
        return (RootSet({MODE_NAMES.get(m, f"m{m}"): empty for m in modes},
                        case_name=case.name), SweepStats())
    search = search or SearchConfig(accept_pct=case.tol.p_tol, n_bisect=30)
    search = dataclasses.replace(
        search, scan_dtype="float64", polish_dtype="float64",
        n_omega=n_omega,
        max_brackets_per_row=min(max_brackets_per_row, n_omega - 1),
        fuzz_accept_pct=None, fuzz_stride=1)
    if n_interior is not None:
        case = dataclasses.replace(case, grid=dataclasses.replace(
            case.grid, n_interior=n_interior))
    # near-edge zeros sit ~1e-5 apart: the production dedup would merge them
    case = dataclasses.replace(
        case, tol=dataclasses.replace(case.tol, dedup_rel=1e-6))
    ks = np.asarray(case.k_grid() if ks is None else ks, dtype=np.float64)
    d = np.geomspace(margin_rel, width_rel, n_omega)
    rows_om, rows_k = [], []
    for k in ks:
        for edge, side, _ in edges:
            rows_om.append(np.sort(edge + side * abs(edge) * d) * k)
            rows_k.append(k)
    rows = len(rows_k)

    def to_dev(a):
        return torch.from_numpy(np.asarray(a, np.float64)).to(device)

    omegas_f = to_dev(np.concatenate([np.stack(rows_om)] * len(modes)))
    ks_f = to_dev(np.concatenate([np.array(rows_k)] * len(modes)))
    modes_f = to_dev(np.concatenate([np.full(rows, float(m)) for m in modes]))
    disp = make_dispersion_moded(case, torch.float64)
    stats = SweepStats()
    t0 = time.time()
    pr = search_rows(disp, disp, omegas_f, ks_f, search, modes=modes_f)
    branches = finalize_branches(pr, modes, case, search)
    branches = {bn: _filter_edge_modes(br, edges, width_rel, edge_modes)
                for bn, br in branches.items()}
    stats.n_roots = sum(len(b) for b in branches.values())
    stats.n_candidates = omegas_f.numel()
    stats.wall_s = time.time() - t0
    return RootSet(branches, case_name=case.name), stats


def _filter_edge_modes(branch: RootBranch, edges, width_rel: float,
                       edge_modes: int) -> RootBranch:
    """Per (k, in-band window): keep the `edge_modes` roots nearest the
    edge, drop the rest (sweep.py:622-643). As in the JAX package (ROADMAP
    C, reference defects): where two in-band windows overlap, a root of one
    counts against the other, so one can delete the other's innermost
    marker."""
    om, kk = branch.omegas, branch.ks
    keep = np.ones(len(om), dtype=bool)
    v = np.where(kk != 0, om / np.where(kk != 0, kk, 1.0), 0.0)
    for edge, side, in_band in edges:
        if not in_band:
            continue
        dist = side * (v - edge) / abs(edge)
        member = (dist > 0) & (dist <= width_rel)
        for k in np.unique(kk[member]):
            idx = np.where(member & (kk == k))[0]
            if len(idx) > edge_modes:
                order = np.argsort(dist[idx])
                keep[idx[order[edge_modes:]]] = False
    return RootBranch(omegas=om[keep], ks=kk[keep]).sorted_by_k()


def run_case(case: CaseConfig, search: Optional[SearchConfig] = None,
             modes=None, *, device, refine_f64: bool = False,
             timer: Optional[StageTimer] = None
             ) -> tuple[RootSet, SweepStats]:
    """Sweep one case on `device`. Returns (RootSet, SweepStats): the
    sweep of `sweep_blocks` in one block.

    timer: optional `utils.StageTimer`; accumulates the wall time of the
    three stages (ladders / device_pipeline / finalize). The device stage
    ends with a device synchronize, so its time includes the device work.

    A complex-omega case raises ValueError (the JAX package's run_case
    fails on its complex determinant): sweep it with `run_case_complex`."""
    return sweep_blocks(case, [torch.device(device)], search, modes,
                        refine_f64=refine_f64, timer=timer)


def sweep_blocks(case: CaseConfig, mesh, search: Optional[SearchConfig] = None,
                 modes=None, *, refine_f64: bool = False,
                 timer: Optional[StageTimer] = None, rank: int = 0,
                 world: int = 1) -> tuple[RootSet, SweepStats]:
    """The sweep of `run_case` with its (omega, k) rows cut into blocks,
    one for each device of `mesh` in each of `world` processes (this one
    `rank`): the rows are padded with NaN ladders (no bracket, no fuzz
    record) to a multiple of world * len(mesh) and cut into contiguous
    blocks, this process's at rank * len(mesh). Each device sweeps its
    block for every mode, mode-major with a mode column, a slab's two
    parities through the paired scan; every block's launches go out
    before any result is read back. The accepted entries come to the host
    (from every process by one all-gather, `parallel.gather_blocks`), in
    `run_case`'s order: every row's polished entries, modes in turn, then
    the fuzz records alike. `finalize_collected` deduplicates them, and
    with refine_f64 re-bisects them in float64, on the mesh's first device.
    SweepStats counts the true rows' candidates. The root set does not
    depend on the cut, bit for bit."""
    if case.complex_omega:
        raise ValueError(f"run_case: case {case.name} has complex omega; "
                         f"sweep it with sweep.run_case_complex")
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
        per = -(-rows // (world * len(mesh)))            # rows a block
        pad = per * world * len(mesh) - rows
        omegas = np.concatenate([omegas, np.full((pad, omegas.shape[1]),
                                                 np.nan)])
        ks = np.concatenate([ks, np.ones(pad)])
        # the slab's chain does not depend on the parity: with both
        # parities the scan shares each (omega, k) between them
        paired = case.geometry == Geometry.SLAB and modes == (0, 1)
        disp_scan = make_dispersion_moded(case, scan_dt)
        disp_polish = (disp_scan if polish_dt == scan_dt
                       else make_dispersion_moded(case, polish_dt))

    stats = SweepStats()
    t0 = time.time()
    with timer.stage("device_pipeline"):
        # every block's ladders on its device first (a copy from the host
        # waits for the work queued on its device); all mode families in
        # one batch with a mode column, mode 0 rows first; ladders are
        # float64 until the one cast to the scan dtype
        blocks = []
        for j, dev in enumerate(mesh):
            b = (rank * len(mesh) + j) * per
            blk = slice(b, b + per)

            def to_dev(a):
                return torch.from_numpy(np.concatenate(a)).to(
                    device=dev, dtype=scan_dt)
            blocks.append((to_dev([omegas[blk]] * len(modes)),
                           to_dev([ks[blk]] * len(modes)),
                           to_dev([np.full(per, float(m)) for m in modes])))
        scanned = [scan_rows(disp_scan, om, kk, search, modes=md,
                             paired=paired) for om, kk, md in blocks]
        polished = [polish_rows(disp_polish, sc, search) for sc in scanned]
        for sc in scanned:
            warn_saturated(sc, search)
        for dev in set(mesh):
            synchronize(dev)
    with timer.stage("finalize"):
        local = [collect(pr, with_fuzz=True) for pr in polished]
        if world > 1:
            from .parallel import gather_blocks
            local = gather_blocks(local)
        branches = finalize_collected(_in_sweep_order(local, modes), modes,
                                      case, search, refine_f64=refine_f64,
                                      timer=timer, device=mesh[0])
    stats.n_roots = sum(len(b) for b in branches.values())
    stats.n_candidates = rows * len(modes) * search.n_omega
    stats.wall_s = time.time() - t0
    return RootSet(branches, case_name=case.name), stats


def _in_sweep_order(blocks: list, modes) -> tuple:
    """The blocks' collected entries (omega, k, mismatch, mode, fuzz), the
    blocks in row order, as one sweep of all rows collects them: the
    polished entries, modes in turn, then the fuzz records alike."""
    parts = []
    for fz_part in (False, True):
        for m in modes:
            for om, kk, mm, md, fz in blocks:
                sel = (np.abs(md - float(m)) < 0.5) & (fz == fz_part)
                parts.append((om[sel], kk[sel], mm[sel], md[sel], fz[sel]))
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(5))


def run_case_checkpointed(case: CaseConfig,
                          search: Optional[SearchConfig] = None,
                          checkpoint_path: str = "sweep.eigr",
                          k_block: int = 8, modes=None, *, device
                          ) -> tuple[RootSet, SweepStats]:
    """Crash-safe sweep on `device` (port of `eigensolver_tpu.sweep.
    run_case_checkpointed`, sweep.py:151-218): the k grid in blocks of
    k_block, each block a `run_case` (2 launches on the card), its accepted
    roots appended (fsync'd) to the store at checkpoint_path before the
    next block starts. Rerunning with the same path resumes after the last
    durable block; a block all of whose (mode, k) cells are durable is not
    run (0 launches).

    The k grid is float64 and never passes through float32, so the resume
    identity round(k, 12) is stable; the last block is padded with its last
    k to k_block; a (mode, k) cell without roots gets a durable "k done"
    sentinel (omega NaN, dropped on read). The result is the store's
    records deduplicated per mode (`roots.dedup_roots`), sorted by k."""
    from .native.store import ResultStore, read_all, resume_k_done

    search = search or SearchConfig(
        n_omega=case.grid.n_omega_ladder, n_bisect=case.grid.n_bisect)
    modes = tuple(modes) if modes is not None else case.modes
    ks_all = np.asarray(case.k_grid(), np.float64)
    done = {m: set(np.round(resume_k_done(checkpoint_path, m), 12))
            for m in modes}

    stats = SweepStats()
    t0 = time.time()
    with ResultStore(checkpoint_path) as store:
        for blk in _k_blocks(ks_all, k_block):
            todo_modes = [m for m in modes
                          if not all(round(k, 12) in done[m] for k in blk)]
            if not todo_modes:
                continue
            sub = dataclasses.replace(case, k_values=tuple(blk))
            rs_blk, st_blk = run_case(sub, search, modes=todo_modes,
                                      device=device)
            stats.n_candidates += st_blk.n_candidates
            for m in todo_modes:
                br = rs_blk[MODE_NAMES.get(m, f"m{m}")]
                stats.n_roots += _append_block(store, m, blk, br, done[m],
                                               complex_=False)

    modes_arr, ks_arr, om_arr, _ = read_all(checkpoint_path)
    branches: Dict[str, RootBranch] = {}
    for m in modes:
        sel = (modes_arr == m) & np.isfinite(om_arr)
        om_m, kk_m = dedup_roots(om_arr[sel], ks_arr[sel],
                                 rel_tol=case.tol.dedup_rel)
        branches[MODE_NAMES.get(m, f"m{m}")] = RootBranch(
            om_m, kk_m).sorted_by_k()
    stats.wall_s = time.time() - t0
    return RootSet(branches, case_name=case.name), stats


def run_case_complex_checkpointed(case: CaseConfig, modes=None,
                                  checkpoint_path: str = "sweep_kh.eigr",
                                  k_block: int = 8, n_re: int = 12,
                                  n_im: int = 10, newton_iters: int = 30,
                                  accept_pct: float = 0.5,
                                  dtype=torch.float64,
                                  check_completeness: bool = False, *,
                                  device) -> tuple[RootSet, SweepStats]:
    """Crash-safe complex-omega (KH) sweep on `device` (port of
    `eigensolver_tpu.sweep.run_case_complex_checkpointed`, sweep.py:
    221-301): the k grid in blocks of k_block, each block a
    `run_case_complex` (with the audit off, the default, 1 launch a mode
    on the card: `slab_newton` or `cylinder_newton`, whose last round
    evaluates the roots), its
    accepted roots appended with Im omega in the store's imaginary field.
    Resume, padding and sentinels as in `run_case_checkpointed`; with
    check_completeness the blocks' audit counts add up. The result is the
    store's records deduplicated in the complex plane per mode
    (`roots.dedup_complex_roots`)."""
    from .native.store import ResultStore, read_all, resume_k_done

    if not case.complex_omega:
        raise ValueError(f"run_case_complex_checkpointed: case {case.name} "
                         f"must have complex_omega=True")
    modes = tuple(modes) if modes is not None else case.modes
    ks_all = np.asarray(case.k_grid(), np.float64)
    done = {m: set(np.round(resume_k_done(checkpoint_path, m), 12))
            for m in modes}

    stats = SweepStats()
    t0 = time.time()
    with ResultStore(checkpoint_path) as store:
        for blk in _k_blocks(ks_all, k_block):
            todo_modes = [m for m in modes
                          if not all(round(k, 12) in done[m] for k in blk)]
            if not todo_modes:
                continue
            sub = dataclasses.replace(case, k_values=tuple(blk))
            rs_blk, st_blk = run_case_complex(
                sub, modes=todo_modes, n_re=n_re, n_im=n_im,
                newton_iters=newton_iters, accept_pct=accept_pct,
                dtype=dtype, check_completeness=check_completeness,
                device=device)
            stats.n_candidates += st_blk.n_candidates
            if st_blk.completeness:
                if stats.completeness is None:
                    stats.completeness = dict(st_blk.completeness)
                else:
                    for key in ("cells", "checked", "agree", "missed"):
                        stats.completeness[key] += st_blk.completeness[key]
            for m in todo_modes:
                br = rs_blk[MODE_NAMES.get(m, f"m{m}")]
                stats.n_roots += _append_block(store, m, blk, br, done[m],
                                               complex_=True)
    if stats.completeness and stats.completeness["checked"]:
        stats.completeness["fraction"] = round(
            stats.completeness["agree"] / stats.completeness["checked"], 4)

    modes_arr, ks_arr, om_arr, oi_arr = read_all(checkpoint_path)
    branches: Dict[str, RootBranch] = {}
    for m in modes:
        sel = (modes_arr == m) & np.isfinite(om_arr)
        om_c, k_d = dedup_complex_roots(om_arr[sel] + 1j * oi_arr[sel],
                                        ks_arr[sel], case.tol.dedup_rel)
        branches[MODE_NAMES.get(m, f"m{m}")] = RootBranch(
            omegas=om_c.real, ks=k_d, omegas_imag=om_c.imag).sorted_by_k()
    stats.wall_s = time.time() - t0
    return RootSet(branches, case_name=case.name), stats


def _k_blocks(ks_all: np.ndarray, k_block: int):
    """The k grid in blocks of k_block, the last padded with its last k so
    that every block has one shape (sweep.py:183-186)."""
    for start in range(0, len(ks_all), k_block):
        blk = ks_all[start:start + k_block]
        if len(blk) < k_block:
            blk = np.concatenate([blk, np.full(k_block - len(blk), blk[-1])])
        yield blk


def _append_block(store, mode: int, blk: np.ndarray, br: RootBranch,
                  done: set, complex_: bool) -> int:
    """Append one block's roots of one mode whose k is not yet durable,
    then a NaN "k done" sentinel for each of the block's k left without a
    root (without it a rootless (mode, k) would run again on every
    resume); update `done`. Returns the count of roots appended."""
    new = ~np.isin(np.round(br.ks, 12), list(done))
    imag = None
    if complex_:
        imag = (br.omegas_imag[new] if br.omegas_imag is not None
                else np.zeros(int(new.sum())))
    store.append(mode, br.ks[new], br.omegas[new], omegas_imag=imag)
    done.update(np.round(br.ks[new], 12))
    bare = np.asarray([k for k in np.unique(blk) if round(k, 12) not in done])
    if len(bare):
        store.append(mode, bare, np.full(len(bare), np.nan),
                     omegas_imag=np.zeros(len(bare)) if complex_ else None)
        done.update(np.round(bare, 12))
    return int(new.sum())


def run_case_complex(case: CaseConfig, modes=None, n_re: int = 12,
                     n_im: int = 10, newton_iters: int = 30,
                     accept_pct: float = 0.5, dtype=torch.float64,
                     check_completeness: bool = True, *, device
                     ) -> tuple[RootSet, SweepStats]:
    """Complex-omega sweep (Kelvin-Helmholtz growth rates; any slab or
    cylinder case with complex_omega, in either slab form, on every
    cylinder chain, with either exterior) on `device` (port of
    `eigensolver_tpu.sweep.run_case_complex`, sweep.py:304-383).

    Seeds: a Re ladder x Im ladder per (k, band) cell, n_re x n_im, Re over
    [lo k, hi k], Im over [-imag_band, imag_band]; newton_iters damped
    Newton steps of every seed and one evaluation at the results
    (`search.newton_complex` with final_eval: one `slab_newton` or
    `cylinder_newton` launch on the card, the evaluation its last round);
    accepted where the % mismatch is
    below accept_pct, Re m_e > 0, the phase speed Re(omega)/k within 0.05 of
    the speed edges, |Im omega| < 3 imag_band and |Re omega| > 1e-6 |k| (the
    acceptance is sign-symmetric in Re omega); deduplicated in the complex
    plane (`roots.dedup_complex_roots`). The bounds are compared as the
    JAX code compares them: the speed edges (numpy scalars) in float64,
    the Python floats in the sweep's dtype.

    check_completeness: the argument-principle audit of every cell
    (`_audit_completeness`); SweepStats.completeness holds its counts."""
    if not case.complex_omega:
        raise ValueError(f"run_case_complex: case {case.name} must have "
                         f"complex_omega=True")
    device = torch.device(device)
    modes = tuple(modes) if modes is not None else case.modes
    ks = np.asarray(case.k_grid())
    speeds = np.asarray(case.sorted_speeds())
    seeds_om, seeds_k = complex_seeds(case, n_re, n_im)
    omega0 = _path_tensors(seeds_om, device, dtype)
    kk = torch.from_numpy(seeds_k).to(device, dtype)
    np_complex = np.complex128 if dtype == torch.float64 else np.complex64

    branches: Dict[str, RootBranch] = {}
    stats = SweepStats()
    t0 = time.time()
    for mode in modes:
        disp = make_dispersion(case, mode, dtype)
        om, res = newton_complex(disp, omega0, kk, n_iter=newton_iters,
                                 final_eval=True)
        v = (om.re / kk).to(torch.float64)
        in_window = ((v > float(speeds[0] - 0.05))
                     & (v < float(speeds[-1] + 0.05))
                     & (om.im.abs() < _bound(3 * case.imag_band, om.im)))
        mism = res.mismatch_pct
        ok = ((mism < _bound(accept_pct, mism)) & res.valid & in_window
              & torch.isfinite(mism) & (om.re.abs() > 1e-6 * kk.abs()))
        ok = ok.cpu().numpy()
        om_h = np.empty(int(ok.sum()), np_complex)
        om_h.real = om.re.cpu().numpy()[ok]
        om_h.imag = om.im.cpu().numpy()[ok]
        k_h = kk.cpu().numpy()[ok]
        om_d, k_d = dedup_complex_roots(om_h, k_h, case.tol.dedup_rel)
        name = MODE_NAMES.get(mode, f"m{mode}")
        branches[name] = RootBranch(omegas=om_d.real, ks=k_d,
                                    omegas_imag=om_d.imag).sorted_by_k()
        stats.n_candidates += omega0.re.numel()
        stats.n_roots += len(om_d)
        if check_completeness:
            _audit_completeness(disp, ks, speeds, case.imag_band, om_d, k_d,
                                stats, device=device)
    synchronize(device)
    stats.wall_s = time.time() - t0
    return RootSet(branches, case_name=case.name), stats


def complex_seeds(case: CaseConfig, n_re: int = 12, n_im: int = 10):
    """The Newton seeds of run_case_complex (sweep.py:336-347): per (k,
    band) cell an n_re x n_im lattice, Re over [lo k, hi k], Im over
    [-imag_band, imag_band]; (omega complex128, k float64) numpy arrays."""
    ks = np.asarray(case.k_grid())
    speeds = np.asarray(case.sorted_speeds())
    seeds_om, seeds_k = [], []
    for k in ks:
        for lo, hi in zip(speeds[:-1], speeds[1:]):
            re = np.linspace(lo * k, hi * k, n_re)
            im = np.linspace(-case.imag_band, case.imag_band, n_im)
            RE, IM = np.meshgrid(re, im, indexing="ij")
            seeds_om.append((RE + 1j * IM).reshape(-1))
            seeds_k.append(np.full(RE.size, k))
    return np.concatenate(seeds_om), np.concatenate(seeds_k)


def audit_contours(ks, speeds, imag_band: float, margin_frac: float = 0.05):
    """The audit's cells and contours: ([(k, re_lo, re_hi), ...], the
    rectangles' closed polylines (cells, 512) complex128, im_lo, im_hi)."""
    im_lo = margin_frac * imag_band
    im_hi = 3.0 * imag_band
    cells = [(k, lo * k, hi * k) for k in ks
             for lo, hi in zip(speeds[:-1], speeds[1:])]
    paths = np.stack([rectangle_path(re_lo, re_hi, im_lo, im_hi)
                      for _, re_lo, re_hi in cells])
    return cells, paths, im_lo, im_hi


def _audit_completeness(disp, ks, speeds, imag_band, om_d, k_d,
                        stats: SweepStats, quant_tol: float = 0.1,
                        margin_frac: float = 0.05, *, device):
    """Argument-principle audit of a complex sweep (sweep.py:386-427).

    One upper-half-plane rectangle per (k, band) cell: real range
    [lo k, hi k], imaginary range [margin_frac imag_band, 3 imag_band],
    128 points a side (`search.rectangle_path`), lifted off the real axis
    where the determinant's continuum poles lie, so that its winding
    number counts the cell's growing modes. Every cell's contour goes
    through one dispersion call (one `slab_disp_complex` or
    `cylinder_disp_complex` launch on the card), the winding numbers from a (cells, 512) view
    (`search.winding_numbers`). A cell whose winding number is not within
    quant_tol of a non-negative integer is unchecked; a checked one agrees
    when it equals the accepted roots inside, and `missed` counts the
    roots the sweep lacks."""
    if stats.completeness is None:
        stats.completeness = {"cells": 0, "checked": 0, "agree": 0,
                              "missed": 0, "fraction": None}
    comp = stats.completeness
    roots = np.asarray(om_d)
    cells, paths, im_lo, im_hi = audit_contours(ks, speeds, imag_band,
                                                margin_frac)
    n_pts = paths.shape[1]
    z = _path_tensors(paths.reshape(-1), device)
    kk = torch.from_numpy(np.repeat(np.array([c[0] for c in cells],
                                             np.float64), n_pts)).to(device)
    det = disp(z, kk).det.reshape(len(cells), n_pts)
    wind = winding_numbers(det).cpu().numpy()
    for (k, re_lo, re_hi), w in zip(cells, wind):
        w = float(w)
        comp["cells"] += 1
        if abs(w - round(w)) > quant_tol or round(w) < 0:
            continue          # a zero grazes the contour: report unchecked
        comp["checked"] += 1
        sel = np.isclose(np.asarray(k_d), k, atol=1e-12)
        rr = roots[sel]
        inside = int(np.sum((rr.real > re_lo) & (rr.real < re_hi)
                            & (rr.imag > im_lo) & (rr.imag < im_hi)))
        agree = inside == int(round(w))
        comp["agree"] += int(agree)
        comp["missed"] += max(0, int(round(w)) - inside)
    comp["fraction"] = (comp["agree"] / comp["checked"]
                        if comp["checked"] else None)
