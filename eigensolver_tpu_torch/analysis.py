"""Mode-branch analysis (L4): phase-speed-window classification, branch
separation, and polynomial smoothing of dispersion branches (a copy of
`eigensolver_tpu.analysis`, host-side numpy).

Replicates the reference analysis scripts' behaviour
(`analysis_cylinder_coronal_09.py:495-538` window classification, `:703-744`
per-branch `numpy.polynomial.polynomial.polyfit`), generalised: windows are
data, branch separation is automatic (nearest-neighbour chaining in (k, v)
rather than hand-tuned per-file k ranges), and fit order is configurable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import numpy.polynomial.polynomial as poly

from .config import Regime
from .roots import RootBranch, RootSet


@dataclasses.dataclass(frozen=True)
class SpeedWindow:
    """One classification window in phase speed (v = omega/k)."""

    name: str
    v_lo: float
    v_hi: float

    def contains(self, v: np.ndarray) -> np.ndarray:
        return (v > self.v_lo) & (v < self.v_hi)


def standard_windows(rg: Regime, backward: bool = True) -> List[SpeedWindow]:
    """The reference's windows (`analysis_cylinder_coronal_09.py:495-538`):
    fast body (vA_i0, vA_e), slow body (cT_i0, c_i0), plus the backward
    mirror windows; anything else lands in 'other'."""
    w = [
        SpeedWindow("slow_body", min(rg.cT_i0, rg.c_i0), max(rg.cT_i0, rg.c_i0)),
        SpeedWindow("fast_body", min(rg.vA_i0, rg.vA_e), max(rg.vA_i0, rg.vA_e)),
    ]
    if backward:
        w += [
            SpeedWindow("slow_body_backward", -max(rg.cT_i0, rg.c_i0),
                        -min(rg.cT_i0, rg.c_i0)),
            SpeedWindow("fast_body_backward", -max(rg.vA_i0, rg.vA_e),
                        -min(rg.vA_i0, rg.vA_e)),
        ]
    return w


def classify(branch: RootBranch, windows: Sequence[SpeedWindow]
             ) -> Dict[str, RootBranch]:
    """Split one mode family's roots into named phase-speed windows; roots in
    no window land in 'other' (the reference's `new_modes_*`)."""
    v = branch.phase_speeds()
    out: Dict[str, RootBranch] = {}
    claimed = np.zeros(len(v), dtype=bool)
    for w in windows:
        sel = w.contains(v)
        out[w.name] = RootBranch(branch.omegas[sel], branch.ks[sel])
        claimed |= sel
    out["other"] = RootBranch(branch.omegas[~claimed], branch.ks[~claimed])
    return out


def separate_branches(branch: RootBranch, v_gap: float = 0.02,
                      k_gap: float = 0.6) -> List[RootBranch]:
    """Chain roots into individual dispersion branches.

    The reference separates branches manually per file (hard-coded k ranges,
    `analysis_cylinder_coronal_09.py:703-744`); here: sort by k, then greedily
    attach each root to the branch whose last point is nearest in phase speed
    (within v_gap, extrapolating the local slope) and within k_gap in k.
    """
    if len(branch) == 0:
        return []
    b = branch.sorted_by_k()
    v = b.phase_speeds()
    chains: List[List[int]] = []
    for i in range(len(b)):
        best, best_d = None, np.inf
        for ci, chain in enumerate(chains):
            j = chain[-1]
            if b.ks[i] - b.ks[j] > k_gap or b.ks[i] == b.ks[j]:
                continue
            # local slope extrapolation
            if len(chain) >= 2:
                j2 = chain[-2]
                dk = b.ks[j] - b.ks[j2]
                slope = (v[j] - v[j2]) / dk if dk > 0 else 0.0
            else:
                slope = 0.0
            v_pred = v[j] + slope * (b.ks[i] - b.ks[j])
            d = abs(v[i] - v_pred)
            if d < best_d:
                best, best_d = ci, d
        if best is not None and best_d < v_gap:
            chains[best].append(i)
        else:
            chains.append([i])
    return [RootBranch(b.omegas[c], b.ks[c]) for c in chains]


@dataclasses.dataclass
class BranchFit:
    branch: RootBranch
    coefs: np.ndarray
    k_range: Tuple[float, float]

    def __call__(self, k: np.ndarray) -> np.ndarray:
        """Fitted phase speed v(k)."""
        return poly.polyval(k, self.coefs)


def fit_branch(branch: RootBranch, order: Optional[int] = None) -> BranchFit:
    """Per-branch polynomial fit of phase speed vs k
    (`analysis_cylinder_coronal_09.py:703-744`, orders 1-18 there; here order
    defaults to min(6, npts-1))."""
    b = branch.sorted_by_k()
    vph = b.phase_speeds()
    if order is None:
        order = int(min(6, max(1, len(b) - 1)))
    coefs = poly.polyfit(b.ks, vph, order)
    return BranchFit(branch=b, coefs=coefs, k_range=(float(b.ks[0]), float(b.ks[-1])))


def analyse(rs: RootSet, rg: Regime, windows: Optional[Sequence[SpeedWindow]] = None,
            fit_order: Optional[int] = None
            ) -> Dict[str, Dict[str, List[BranchFit]]]:
    """Full L4 pipeline: classify -> separate -> fit, for every mode family."""
    windows = list(windows) if windows is not None else standard_windows(rg)
    out: Dict[str, Dict[str, List[BranchFit]]] = {}
    for mode_name, br in rs.branches.items():
        per_window: Dict[str, List[BranchFit]] = {}
        for wname, wbr in classify(br, windows).items():
            fits = [fit_branch(c, fit_order)
                    for c in separate_branches(wbr) if len(c) >= 2]
            per_window[wname] = fits
        out[mode_name] = per_window
    return out
