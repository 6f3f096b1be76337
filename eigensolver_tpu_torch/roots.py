"""Root-set container and dedup (PyTorch port).

A copy of `eigensolver_tpu.roots:RootBranch, RootSet, dedup_roots,
merge_rootsets, dedup_complex_roots` - host-side numpy, no framework - held
here because importing the JAX package loads jax. The reference-pickle
formats (A12) are not ported yet.
"""
from __future__ import annotations

import dataclasses
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
