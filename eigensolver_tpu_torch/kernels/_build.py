"""Build and load the port's CUDA kernels.

All of `csrc/*.cu` is compiled by nvcc into one shared library with a plain
C interface, loaded with ctypes (no `torch.utils.cpp_extension`, no PyTorch
headers: the build takes seconds). The library is built at first use into
`eigensolver_tpu_torch/_build/` (git-ignored), under a name hashed from the
sources and flags, so an edited source rebuilds. Nothing here runs when the
package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a: Hopper. --fmad=false keeps a*b+c as two roundings, as the JAX code
# and the plain PyTorch versions evaluate it (see csrc/cylinder_disp.cu).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: (argtypes, restype)
    "eigk_kve_ratio_f32": ((_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P),
                           ctypes.c_int),
    "eigk_kve_ratio_f64": ((_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P),
                           ctypes.c_int),
    "eigk_cylinder_disp_f32": ((_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P,
                                ctypes.c_int, _P), ctypes.c_int),
    "eigk_cylinder_disp_f64": ((_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P,
                                ctypes.c_int, _P), ctypes.c_int),
    "eigk_cylinder_params_size": ((), ctypes.c_longlong),
    "eigk_error_string": ((ctypes.c_int,), ctypes.c_char_p),
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libeigk_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of eigensolver_tpu_torch are built "
        "from eigensolver_tpu_torch/csrc with nvcc; put it on PATH or set "
        "CUDA_HOME")


def build() -> Path:
    """Compile the sources unless the library for them exists; return its
    path. The compiler's report (`-Xptxas -v`: registers, spills) is kept
    beside it as `<name>.log`."""
    so = library_path()
    if so.is_file():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in _sources() if p.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().eigk_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
