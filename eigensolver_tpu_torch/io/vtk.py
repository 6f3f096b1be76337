"""Legacy binary VTK STRUCTURED_GRID export (a copy of
`eigensolver_tpu.io.vtk`).

Byte-compatible with the reference's hand-rolled writer `makeDumpVTK`
(`Cylinder/Non-uniform density/Coronal/Movies/Export_vtk.py:71-110`):
ASCII header + big-endian float32 points (x,y,z interleaved, k-major) +
per-variable SCALARS blocks. The reference packs one struct per float in a
quadruple Python loop; here the whole buffer is one numpy byteswap+tofile
(and an optional C++ fast path in `native.vtk_native`, used when built -
same bytes, ~10x less host time for movie-scale grids).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _points_block(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> bytes:
    """Interleave (x,y,z) per point in k-fastest... reference order: for k, j, i
    - i fastest in file order means Fortran-style flattening of (i,j,k) loops:
    index runs i inner, k outer."""
    # reference loops: for k: for j: for i: write x[i,j,k], y, z
    pts = np.stack([x, y, z], axis=-1)           # (ax, ay, az, 3)
    pts = np.transpose(pts, (2, 1, 0, 3))        # (az, ay, ax, 3) - k outermost
    return pts.astype(">f4").tobytes()


def _scalar_block(d: np.ndarray) -> bytes:
    return np.transpose(d, (2, 1, 0)).astype(">f4").tobytes()


def write_structured_grid(path: str, x: np.ndarray, y: np.ndarray,
                          z: np.ndarray, variables: Dict[str, np.ndarray]
                          ) -> None:
    """Write `path` (+'.vtk' appended if absent) with point coords (ax,ay,az)
    arrays and named scalar variables of the same shape."""
    if not path.endswith(".vtk"):
        path = path + ".vtk"
    ax, ay, az = x.shape
    n = ax * ay * az

    try:
        from ..native import vtk_native
        if vtk_native.available():
            vtk_native.write_structured_grid(path, x, y, z, variables)
            return
    except Exception:
        pass

    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0 \n")
        f.write(b"vtk output \n")
        f.write(b"BINARY \n")
        f.write(b"DATASET STRUCTURED_GRID \n")
        f.write(f"DIMENSIONS  {ax} {ay} {az}  \n".encode())
        f.write(f"POINTS {n} float  \n".encode())
        f.write(_points_block(x, y, z))
        f.write(f"\nPOINT_DATA {n}  ".encode())
        for name, data in variables.items():
            assert data.shape == x.shape, (name, data.shape, x.shape)
            f.write(f"\nSCALARS {name} float \n".encode())
            f.write(b"LOOKUP_TABLE default \n")
            f.write(_scalar_block(np.asarray(data)))


def export_field_series(prefix: str, fields: Dict[str, np.ndarray],
                        grid, components: Sequence[str]) -> list:
    """One VTK file per timestep (the reference's `Export_vtk.py` loop),
    on the cylindrical->Cartesian structured grid."""
    r, th, z = grid.r, grid.theta, grid.z
    R, TH, Z = np.meshgrid(r, th, z, indexing="ij")
    X = R * np.cos(TH)
    Y = R * np.sin(TH)
    paths = []
    n_t = next(iter(fields.values())).shape[0]
    for ti in range(n_t):
        vars_t = {c: np.ascontiguousarray(fields[c][ti]) for c in components
                  if c in fields}
        p = f"{prefix}_{ti:04d}.vtk"
        write_structured_grid(p, X, Y, Z, vars_t)
        paths.append(p)
    return paths
