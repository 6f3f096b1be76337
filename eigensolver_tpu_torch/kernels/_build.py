"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by nvcc (one process each, in parallel) and
linked into one shared library with a plain C interface, loaded with ctypes
(no `torch.utils.cpp_extension`, no PyTorch headers: the build takes
seconds). The library is built at first use into
`eigensolver_tpu_torch/_build/` (git-ignored), under a name hashed from the
sources and flags, so an edited source rebuilds; processes that start
together (the ranks of a sharded sweep) take turns on a file lock there, so
one builds and the others load its library. Nothing here runs when the
package is imported.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a: Hopper. --fmad=false keeps a*b+c as two roundings, as the JAX code
# and the plain PyTorch versions evaluate it (see csrc/cylinder_disp.cu).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# (omega, k, m, det, mism, valid, n, B, P, C, S, min_blocks, params,
#  device, stream)
_EVAL_ARGS = ((_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I,
               _P, _I, _P), _I)
# (lo, hi, k, mode, root, mism, n, n_iter, final_eval, B, L, P, C, S,
#  min_blocks, params, device, stream)
_SPEC_ARGS = ((_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I,
               _I, _I, _I, _P, _I, _P), _I)
# complex omega as two real buffers: (om_re, om_im, k, parity, out_re,
#  out_im, n, det_re, det_im, mism, valid, n_iter, damping, final_eval, B,
#  C, S, params, device, stream)
_NEWTON_ARGS = ((_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P, _P, _P, _P,
                 _I, ctypes.c_double, _I, _I, _I, _I, _P, _I, _P), _I)
# the cylinder's: (om_re, om_im, k, m, out_re, out_im, n, det_re, det_im,
#  mism, valid, n_iter, damping, final_eval, params, device, stream)
_CYL_NEWTON_ARGS = ((_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P, _P, _P,
                     _P, _I, ctypes.c_double, _I, _P, _I, _P), _I)
_SIGNATURES = {
    # name: (argtypes, restype)
    "eigk_kve_ratio_f32": ((_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P),
                           ctypes.c_int),
    "eigk_kve_ratio_f64": ((_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P),
                           ctypes.c_int),
    # (omega, k, m, det, mism, valid, n, threads, chunk, params, device,
    #  stream)
    "eigk_cylinder_disp_f32": ((_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I,
                                _I, _P, _I, _P), _I),
    "eigk_cylinder_disp_f64": ((_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I,
                                _I, _P, _I, _P), _I),
    "eigk_cylinder_eval_f32": _EVAL_ARGS,
    "eigk_cylinder_eval_f64": _EVAL_ARGS,
    "eigk_cylinder_spec_f32": _SPEC_ARGS,
    "eigk_cylinder_spec_f64": _SPEC_ARGS,
    "eigk_cylinder_bisect_spec_f32": _SPEC_ARGS,
    "eigk_cylinder_bisect_spec_f64": _SPEC_ARGS,
    # (f64, kind, threads, min_blocks, smem, out[3])
    "eigk_cylinder_tw_attrs": ((_I, _I, _I, _I, ctypes.c_longlong, _P), _I),
    "eigk_cylinder_params_size": ((), ctypes.c_longlong),
    # (z_re, z_im, m, out_re, out_im, n, device, stream)
    "eigk_kve_ratio_complex_f32": ((_P, _P, _P, _P, _P, ctypes.c_longlong,
                                    _I, _P), _I),
    "eigk_kve_ratio_complex_f64": ((_P, _P, _P, _P, _P, ctypes.c_longlong,
                                    _I, _P), _I),
    "eigk_cylinder_newton_f32": _CYL_NEWTON_ARGS,
    "eigk_cylinder_newton_f64": _CYL_NEWTON_ARGS,
    # (device, out[2])
    "eigk_cylinder_scan_tabled": ((_I, _P), _I),
    # (f64, chunk)
    "eigk_cylinder_scan_smem": ((_I, _I), ctypes.c_longlong),
    # (omega, k, parity, det, mism, valid, n, threads, chunk, params,
    #  device, stream)
    "eigk_slab_disp_f32": ((_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I,
                            _I, _P, _I, _P), _I),
    "eigk_slab_disp_f64": ((_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I,
                            _I, _P, _I, _P), _I),
    # both parities of n (omega, k) pairs: (omega, k, null, det, mism,
    #  valid, n, threads, chunk, params, device, stream); 2 n results
    "eigk_slab_pairs_f32": ((_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I,
                             _I, _P, _I, _P), _I),
    "eigk_slab_pairs_f64": ((_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I,
                             _I, _P, _I, _P), _I),
    "eigk_slab_params_size": ((), ctypes.c_longlong),
    "eigk_slab_spec_f32": _SPEC_ARGS,
    "eigk_slab_spec_f64": _SPEC_ARGS,
    "eigk_slab_newton_f32": _NEWTON_ARGS,
    "eigk_slab_newton_f64": _NEWTON_ARGS,
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
    path. Each `.cu` is compiled by its own nvcc process, all started
    together, then linked into one shared library. The compilers' report
    (`-Xptxas -v`: registers, spills) is kept beside it as `<name>.log`."""
    so = library_path()
    if so.is_file():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # released when the file closes
        if not so.is_file():
            _compile(so)
    return so


def _compile(so: Path) -> None:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = [p for p in _sources() if p.suffix == ".cu"]
        objs = [str(Path(tmp) / f"{p.stem}.o") for p in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(srcs, objs)]
        log = "".join(p.communicate()[0] for p in procs)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        lib = str(Path(tmp) / so.name)
        link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", lib,
                               *objs], capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        so.with_suffix(".log").write_text(log)
        os.replace(lib, so)


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
