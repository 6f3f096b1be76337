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
(`run_case_complex`, Kelvin-Helmholtz growth rates) runs its Newton
iteration, the evaluation of its roots and its argument-principle audit on
the device too. Not ported yet: checkpointed sweeps (ROADMAP A12).
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
                     newton_complex, rectangle_path, refine_roots_f64,
                     search_rows, torch_dtype, winding_numbers)
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
    om, kk, _, md, fz = collect(pr, with_fuzz=True)
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
            device = pr.omega.device
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
    """Sweep one case on `device`. Returns (RootSet, SweepStats).

    timer: optional `utils.StageTimer`; accumulates the wall time of the
    three stages (ladders / device_pipeline / finalize). The device stage
    ends with a device synchronize, so its time includes the device work.

    A complex-omega case raises ValueError (the JAX package's run_case
    fails on its complex determinant): sweep it with `run_case_complex`."""
    if case.complex_omega:
        raise ValueError(f"run_case: case {case.name} has complex omega; "
                         f"sweep it with sweep.run_case_complex")
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
        # the slab's chain does not depend on the parity: with both
        # parities the scan shares each (omega, k) between them
        paired = case.geometry == Geometry.SLAB and tuple(modes) == (0, 1)
        disp_scan = make_dispersion_moded(case, scan_dt)
        disp_polish = (disp_scan if polish_dt == scan_dt
                       else make_dispersion_moded(case, polish_dt))

    stats = SweepStats()
    t0 = time.time()
    with timer.stage("device_pipeline"):
        def to_dev(a):
            return torch.from_numpy(a).to(device=device, dtype=scan_dt)

        pr = search_rows(disp_scan, disp_polish, to_dev(omegas_f),
                         to_dev(ks_f), search, modes=to_dev(modes_f),
                         paired=paired)
        synchronize(device)
    with timer.stage("finalize"):
        branches = finalize_branches(pr, modes, case, search,
                                     refine_f64=refine_f64, timer=timer)
    stats.n_roots = sum(len(b) for b in branches.values())
    stats.n_candidates = omegas_f.size
    stats.wall_s = time.time() - t0
    return RootSet(branches, case_name=case.name), stats


def run_case_complex(case: CaseConfig, modes=None, n_re: int = 12,
                     n_im: int = 10, newton_iters: int = 30,
                     accept_pct: float = 0.5, dtype=torch.float64,
                     check_completeness: bool = True, *, device
                     ) -> tuple[RootSet, SweepStats]:
    """Complex-omega sweep (Kelvin-Helmholtz growth rates) on `device`
    (port of `eigensolver_tpu.sweep.run_case_complex`, sweep.py:304-383).

    Seeds: a Re ladder x Im ladder per (k, band) cell, n_re x n_im, Re over
    [lo k, hi k], Im over [-imag_band, imag_band]; newton_iters damped
    Newton steps of every seed and one evaluation at the results
    (`search.newton_complex` with final_eval: one `slab_newton` launch on the
    card, the evaluation its last round); accepted where the % mismatch is
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
    through one dispersion call (one `slab_disp_complex` launch on the
    card), the winding numbers from a (cells, 512) view
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
