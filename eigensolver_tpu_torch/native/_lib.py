"""ctypes loader for the C++ runtime library (native/libeig_native.so).

A copy of `eigensolver_tpu.native._lib`: from this directory the path
resolves to the same top-level `native/` of the repository, whose library
both packages share. Builds on demand with the in-tree Makefile when the
shared object is missing (plain C ABI + ctypes, g++ only); `get_lib()`
returns None when it can neither find nor build it.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO = os.path.join(_NATIVE_DIR, "libeig_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None

    lib.eig_write_structured_grid.restype = ctypes.c_int
    lib.eig_write_structured_grid.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
    ]
    lib.eig_store_open.restype = ctypes.c_void_p
    lib.eig_store_open.argtypes = [ctypes.c_char_p]
    lib.eig_store_append.restype = ctypes.c_int
    lib.eig_store_append.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double)]
    lib.eig_store_count.restype = ctypes.c_int64
    lib.eig_store_count.argtypes = [ctypes.c_char_p]
    lib.eig_store_read.restype = ctypes.c_int64
    lib.eig_store_read.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double)]
    lib.eig_store_close.restype = None
    lib.eig_store_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib
