"""Crash-safe sweep checkpoint store (Python face of native/result_store.cpp).

A copy of `eigensolver_tpu.native.store`. Each completed (k-block, mode) of
a checkpointed sweep appends fsync'd records; `resume_k_done` tells a
restarted sweep which k cells are already durable. Two writers of one
layout (a 16-byte header {'EIGR', version 1, 0}, then 32-byte records
{mode i32, flags u32, k f64, omega_re f64, omega_im f64}): the ctypes
library, and a pure-Python writer when the library does not load.
`ResultStore.backend` says which one a store writes with.
"""
from __future__ import annotations

import ctypes
import os
import struct
from typing import Optional, Tuple

import numpy as np

from ._lib import get_lib

_HEADER = struct.pack("<IIQ", 0x45494752, 1, 0)
_REC = struct.Struct("<iIddd")


class ResultStore:
    def __init__(self, path: str):
        self.path = path
        self._lib = get_lib()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.eig_store_open(path.encode())
        elif not os.path.exists(path) or os.path.getsize(path) == 0:
            with open(path, "wb") as f:
                f.write(_HEADER)

    @property
    def backend(self) -> str:
        """"native" (the ctypes library) or "python"."""
        return "native" if self._handle else "python"

    def append(self, mode: int, ks: np.ndarray, omegas: np.ndarray,
               omegas_imag: Optional[np.ndarray] = None) -> None:
        ks = np.ascontiguousarray(ks, dtype=np.float64)
        om = np.ascontiguousarray(omegas, dtype=np.float64)
        oi = (np.ascontiguousarray(omegas_imag, dtype=np.float64)
              if omegas_imag is not None else None)
        if self._handle:
            rc = self._lib.eig_store_append(
                self._handle, mode, len(ks),
                ks.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                om.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                oi.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) if oi is not None
                else None)
            if rc != 0:
                raise IOError(f"store append failed: {rc}")
        else:
            with open(self.path, "ab") as f:
                for i in range(len(ks)):
                    f.write(_REC.pack(mode, 0, ks[i], om[i],
                                      oi[i] if oi is not None else 0.0))
                f.flush()
                os.fsync(f.fileno())

    def close(self) -> None:
        if self._handle:
            self._lib.eig_store_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_all(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(modes, ks, omegas, omegas_imag) of every durable record."""
    lib = get_lib()
    if lib is not None:
        n = lib.eig_store_count(path.encode())
        if n < 0:
            raise IOError(f"bad store file {path} ({n})")
        modes = np.empty(n, np.int32)
        ks = np.empty(n, np.float64)
        om = np.empty(n, np.float64)
        oi = np.empty(n, np.float64)
        got = lib.eig_store_read(
            path.encode(), n,
            modes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ks.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            om.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            oi.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return modes[:got], ks[:got], om[:got], oi[:got]
    with open(path, "rb") as f:
        hdr = f.read(16)
        if len(hdr) < 16 or hdr[:4] != _HEADER[:4]:
            raise IOError(f"bad store file {path}")
        data = f.read()
    n = len(data) // _REC.size
    modes = np.empty(n, np.int32)
    ks = np.empty(n, np.float64)
    om = np.empty(n, np.float64)
    oi = np.empty(n, np.float64)
    for i in range(n):
        m, _, kk, o_r, o_i = _REC.unpack_from(data, i * _REC.size)
        modes[i], ks[i], om[i], oi[i] = m, kk, o_r, o_i
    return modes, ks, om, oi


def resume_k_done(path: str, mode: int) -> np.ndarray:
    """Unique k values already durable for `mode` (resume support)."""
    if not os.path.exists(path):
        return np.empty(0)
    modes, ks, _, _ = read_all(path)
    return np.unique(ks[modes == mode])
