"""Python face of the C++ VTK serializer (native/vtk_writer.cpp); a copy of
`eigensolver_tpu.native.vtk_native`."""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np

from ._lib import get_lib


def available() -> bool:
    return get_lib() is not None


def write_structured_grid(path: str, x: np.ndarray, y: np.ndarray,
                          z: np.ndarray, variables: Dict[str, np.ndarray]
                          ) -> None:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    ax, ay, az = x.shape
    arrs = [np.ascontiguousarray(a, dtype=np.float32) for a in (x, y, z)]
    var_arrs = [np.ascontiguousarray(v, dtype=np.float32)
                for v in variables.values()]
    names = (ctypes.c_char_p * len(variables))(
        *[n.encode() for n in variables.keys()])
    ptrs = (ctypes.POINTER(ctypes.c_float) * len(var_arrs))(
        *[v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for v in var_arrs])
    rc = lib.eig_write_structured_grid(
        path.encode(), ax, ay, az,
        arrs[0].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        arrs[1].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        arrs[2].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(var_arrs), names, ptrs)
    if rc != 0:
        raise IOError(f"native VTK write failed with code {rc}")
