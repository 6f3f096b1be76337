"""Root-set container, dedup and reference-pickle persistence (PyTorch
port).

A copy of `eigensolver_tpu.roots` - host-side numpy, no framework - held
here because importing the JAX package loads jax. `save_pickle` /
`load_pickle` write and read the reference's plain-list layouts
(`[sol_omegas, sol_ks, sol_omegas_kink, sol_ks_kink]`, the 8-array complex
variant and the 2-array kink-only one); the port's file is byte-identical
to the JAX package's for the same RootSet.
"""
from __future__ import annotations

import dataclasses
import pickle
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class RootBranch:
    """Roots of one mode family (e.g. sausage or kink): parallel (omega, k)."""

    omegas: np.ndarray
    ks: np.ndarray
    omegas_imag: Optional[np.ndarray] = None  # KH growth rates (complex runs)

    def __len__(self):
        return len(self.omegas)

    def phase_speeds(self) -> np.ndarray:
        return self.omegas / self.ks

    def sorted_by_k(self) -> "RootBranch":
        order = np.argsort(self.ks, kind="stable")
        return RootBranch(
            omegas=self.omegas[order],
            ks=self.ks[order],
            omegas_imag=None if self.omegas_imag is None else self.omegas_imag[order],
        )


@dataclasses.dataclass
class RootSet:
    """All branches of one case sweep, keyed by mode name ('sausage'/'kink')."""

    branches: Dict[str, RootBranch]
    case_name: str = ""

    def __getitem__(self, name: str) -> RootBranch:
        return self.branches[name]

    def counts(self) -> Dict[str, int]:
        return {k: len(v) for k, v in self.branches.items()}


def dedup_roots(omegas: np.ndarray, ks: np.ndarray, rel_tol: float = 1e-4,
                extras: Optional[list] = None):
    """Collapse duplicate roots: same k (exact - k comes from a shared grid) and
    omega within rel_tol relative. Replaces the reference behaviour of letting
    duplicates from adjacent speed bands coexist (SURVEY.md P2)."""
    if len(omegas) == 0:
        return (omegas, ks) if extras is None else (omegas, ks, *[e for e in extras])
    order = np.lexsort((omegas, ks))
    om, kk = omegas[order], ks[order]
    keep = np.ones(len(om), dtype=bool)
    for i in range(1, len(om)):
        if kk[i] == kk[i - 1] and abs(om[i] - om[i - 1]) <= rel_tol * max(
            abs(om[i]), 1e-30
        ):
            keep[i] = False
    if extras is None:
        return om[keep], kk[keep]
    return (om[keep], kk[keep], *[np.asarray(e)[order][keep] for e in extras])


def merge_rootsets(a: RootSet, b: RootSet, rel_tol: float = 1e-6) -> RootSet:
    """Union of two sweeps' branches with duplicate removal (port of
    `eigensolver_tpu.roots.merge_rootsets`, roots.py:78-95): the second set
    is typically a needle pass (`sweep.run_needle_pass`), whose roots sit
    closer than the production dedup tolerance, so the default dedup is
    1e-6 relative. As in the JAX package: omegas_imag is not carried over,
    and near-duplicate pairs farther apart than rel_tol both stay
    (ROADMAP C, reference defects)."""
    branches = {}
    for bname in set(a.branches) | set(b.branches):
        parts = [s.branches[bname] for s in (a, b) if bname in s.branches]
        om = np.concatenate([p.omegas for p in parts])
        kk = np.concatenate([p.ks for p in parts])
        om, kk = dedup_roots(om, kk, rel_tol=rel_tol)
        branches[bname] = RootBranch(omegas=om, ks=kk).sorted_by_k()
    return RootSet(branches, case_name=a.case_name or b.case_name)


def dedup_complex_roots(omegas: np.ndarray, ks: np.ndarray,
                        rel_tol: float = 1e-4):
    """Dedup complex roots: same k, complex distance within rel_tol relative
    (roots.py:98-128).

    Greedy in sorted order, but vectorised per ANCHOR (a kept root): each
    anchor removes its whole duplicate window with one slice comparison, so
    the cost is O(n_unique * window) rather than a per-candidate Python loop
    - after a Newton sweep most of the batch collapses onto few roots."""
    if len(omegas) == 0:
        return omegas, ks
    order = np.lexsort((omegas.imag, omegas.real, ks))
    om, kk = omegas[order], ks[order]
    n = len(om)
    keep = np.ones(n, dtype=bool)
    i = 0
    while i < n:
        if not keep[i]:
            i += 1
            continue
        tol = rel_tol * max(abs(om[i]), 1e-30)
        # duplicate window: same k (kk is the primary sort key), then Re
        # within 4*tol (Re is sorted within each k group)
        k_end = i + 1 + int(np.searchsorted(kk[i + 1:], kk[i], side="right"))
        j_hi = i + 1 + int(np.searchsorted(om.real[i + 1:k_end],
                                           om[i].real + 4.0 * tol,
                                           side="right"))
        w = slice(i + 1, j_hi)
        keep[w] &= np.abs(om[w] - om[i]) > tol
        i += 1
    return om[keep], kk[keep]


# --- reference pickle formats (roots.py:133-169) -----------------------------

def save_pickle(path: str, rs: RootSet) -> None:
    """4-array format: [sausage_omegas, sausage_ks, kink_omegas, kink_ks];
    8-array when imaginary parts are present; 2-array when only 'kink'
    exists.

    As in the JAX package (ROADMAP C, reference defects): the 2-array
    layout is [omegas, ks] and drops omegas_imag, so a kink-only complex
    sweep (the Kelvin-Helmholtz case) loses its growth rates here; the
    checkpoint store (`native.store`) keeps them."""
    s = rs.branches.get("sausage")
    k = rs.branches.get("kink")
    with open(path, "wb") as f:
        if s is None and k is not None:
            pickle.dump([list(k.omegas), list(k.ks)], f)
        elif s is not None and k is not None:
            if s.omegas_imag is not None or k.omegas_imag is not None:
                si = s.omegas_imag if s.omegas_imag is not None else np.zeros_like(s.omegas)
                ki = k.omegas_imag if k.omegas_imag is not None else np.zeros_like(k.omegas)
                pickle.dump(
                    [list(s.omegas), list(s.ks), list(k.omegas), list(k.ks),
                     list(si), list(s.ks), list(ki), list(k.ks)], f)
            else:
                pickle.dump(
                    [list(s.omegas), list(s.ks), list(k.omegas), list(k.ks)], f)
        else:
            raise ValueError("RootSet must contain 'kink' or both branches")


def load_pickle(path: str, case_name: str = "") -> RootSet:
    """A RootSet from a 2-, 4- or 8-array reference pickle."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    arrs = [np.asarray(a, dtype=float) for a in data]
    if len(arrs) == 2:
        return RootSet({"kink": RootBranch(arrs[0], arrs[1])}, case_name)
    if len(arrs) == 4:
        return RootSet(
            {"sausage": RootBranch(arrs[0], arrs[1]),
             "kink": RootBranch(arrs[2], arrs[3])}, case_name)
    if len(arrs) == 8:
        return RootSet(
            {"sausage": RootBranch(arrs[0], arrs[1], omegas_imag=arrs[4]),
             "kink": RootBranch(arrs[2], arrs[3], omegas_imag=arrs[6])}, case_name)
    raise ValueError(f"unrecognised pickle layout with {len(arrs)} arrays")
