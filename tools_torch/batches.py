"""Candidate batches of the port's dispersion kernels, shared by
`chip_smoke.py`, the card tests and the timing tools: the sweep's ladder in
the order `run_case` scans it, random draws from it, and the row layouts
that the cylinder scan's row table meets.

Each builder imports `eigensolver_tpu_torch` when it is called, so that a
tool run with another checkout's package first on `sys.path`
(`--pkg-root`) builds that checkout's ladder.
"""
from __future__ import annotations

import numpy as np
import torch

# a row run's first candidate sits this far into its run: off the blocks
# of 256 and the warps
ROW_OFFSET = 13
# the row layouts whose runs of one (k, m) are at least a block long:
# every candidate takes its block's row table
LONG_RUNS = ("rows 1519", "rows 256", "through the continua")
# the row layout whose blocks hold both warps that take the row table and
# warps that form their own values
MIXED_RUNS = "rows 37"


def _tensors(arrays, dtype, device) -> list:
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                         dtype=dtype)
            for a in arrays]


def ladder_arrays(case, n_omega: int) -> tuple:
    """The sweep's ladder as run_case builds it, every mode's rows in turn:
    (rows, n_omega) omegas and the (rows,) k and mode columns, float64
    numpy."""
    from eigensolver_tpu_torch import sweep
    om, ks = sweep.build_ladders(case, n_omega)
    modes = [float(m) for m in case.modes]
    return (np.concatenate([om] * len(modes)),
            np.concatenate([ks] * len(modes)), np.repeat(modes, om.shape[0]))


def ladder_rows(case, n_omega: int, dtype, device="cuda") -> list:
    """ladder_arrays as tensors of dtype on device."""
    return _tensors(ladder_arrays(case, n_omega), dtype, device)


def flat_ladder(case, n_omega: int, dtype, device="cuda") -> list:
    """The sweep's scan candidates (omega, k, mode) in ladder order
    (search.ladder_scan's flattening): rows of n_omega candidates that
    share (k, m), every mode's rows in turn."""
    om, ks, md = ladder_arrays(case, n_omega)
    n = om.shape[1]
    return _tensors((om.reshape(-1), np.repeat(ks, n), np.repeat(md, n)),
                    dtype, device)


def ladder_draws(case, n: int, seed: int, dtype=torch.float64,
                 device="cuda") -> list:
    """n (omega, k, mode) candidates drawn at random from the case's
    n_omega = 256 ladder, the mode from 0 and 1."""
    from eigensolver_tpu_torch import sweep
    om, ks = sweep.build_ladders(case, 256)
    rng = np.random.default_rng(seed)
    row = rng.integers(0, om.shape[0], n)
    col = rng.integers(0, om.shape[1], n)
    m = rng.integers(0, 2, n).astype(np.float64)
    return _tensors((om[row, col], ks[row], m), dtype, device)


def row_runs(case, length: int, n_rows: int,
             offset: int = ROW_OFFSET) -> list:
    """n_rows runs of `length` candidates that share (k, m), each run's
    (k, m) another than the run before's: every 91st of the case's pairs,
    k major, so that the modes alternate (and where the case has fewer
    than 91 pairs, a run at m = 1 follows one of the same k at m = 0);
    its omegas spread over its k's ladder; from `offset` candidates into
    the first run. float64 numpy (omega, k, m)."""
    from eigensolver_tpu_torch import sweep
    om, ks = sweep.build_ladders(case, 256)
    pairs = [(k, float(m)) for k in np.unique(ks) for m in case.modes]
    runs = []
    for j in range(n_rows):
        k, m = pairs[(j * 91) % len(pairs)]
        w = om[ks == k].reshape(-1)
        w = w[np.linspace(0, w.size - 1, length).astype(int)]
        runs.append((w, np.full(length, k), np.full(length, m)))
    return [np.concatenate(x)[offset:] for x in zip(*runs)]


def pole_omegas(case, k: float, dtype, n_pts: int = 8) -> list:
    """Omegas at which the chain's shift^2 equals alpha^2 or cusp^2
    exactly at one of n_pts abscissae of the interior's r grid, in dtype
    (the plain chain's order): D = 0 there, and the shoot's values NaN and
    inf."""
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    from eigensolver_tpu_torch.profiles import div, sqrt
    eq = CylinderPhysics.from_case(case).eq
    g = case.grid
    one = torch.ones((), dtype=dtype)
    h = div(torch.tensor(g.axis_epsilon, dtype=dtype) - one, g.n_interior)
    kk = torch.tensor(k, dtype=dtype)
    out = []
    for i in np.linspace(0, g.n_interior - 1, n_pts).astype(int).tolist():
        r = one + i * h
        rho, ci, vA = eq.rho_i(r), eq.c_i(r), eq.vA_i(r)
        kU = kk * eq.U_i(r)
        alf = kk * eq.B_i(r) / sqrt(rho)
        cusp = alf * ci / sqrt(ci * ci + vA * vA)
        for speed in (alf, cusp):
            om = kU + speed
            if bool((om - kU) * (om - kU) == speed * speed):
                out.append(float(om))
    return out


def row_layout_batches(case, dtype, runs=((1519, 3), (256, 9), (37, 40),
                                          (1, 1000)),
                       n_continua: int = 1500, n_draws: int = 1000,
                       n_windows: int = 150, device="cuda",
                       offset: int = ROW_OFFSET) -> dict:
    """Batches (omega, k, mode) of dtype on device of the density/axial-
    flow scan's row layouts: for each (length, count) of `runs`, row_runs
    from `offset` (runs of 1519 and 256 candidates are at least a block:
    the block's row table covers every candidate; of 37 a block spans up
    to 8 runs, and the warps with a lane outside its first and last take
    the per-candidate path; of 1 every warp does); a run of the median k at
    m = 0 and one at m = 1 through every characteristic speed (n_continua
    points between the extreme speeds, the band edges exactly, and
    pole_omegas: NaN and inf); n_draws random ladder draws (ladder_draws);
    the refine windows' ends (10 a root, root after root) of n_windows
    ladder points."""
    from eigensolver_tpu_torch import search
    out = {f"rows {n}": _tensors(row_runs(case, n, r, offset), dtype,
                                 device)
           for n, r in runs}
    sp = np.asarray(case.sorted_speeds())
    k = float(np.median(case.k_grid()))
    w = np.union1d(k * np.linspace(sp[0], sp[-1], n_continua),
                   np.concatenate([k * sp, pole_omegas(case, k, dtype)]))
    out["through the continua"] = _tensors(
        (np.concatenate([w, w]), np.full(2 * w.size, k),
         np.repeat([0.0, 1.0], w.size)), dtype, device)
    out["random draws"] = ladder_draws(case, n_draws, 21, dtype, device)
    om, kk, md = ladder_rows(case, 256, dtype, device)
    rng = np.random.default_rng(12)
    pick = torch.from_numpy(rng.integers(0, om.shape[0], n_windows))
    pcol = torch.from_numpy(rng.integers(0, om.shape[1], n_windows))
    pick, pcol = pick.to(device), pcol.to(device)
    out["refine windows"] = list(search.refine_window_ends(
        om[pick, pcol], kk[pick], md[pick])[2])
    return out
