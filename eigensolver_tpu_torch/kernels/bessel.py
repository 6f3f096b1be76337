"""Batched K_m logarithmic derivative: wrapper of the CUDA kernel `kve_ratio`.

Counterpart of `eigensolver_tpu.kernels.bessel.kve_ratio_pallas` (the one
Pallas kernel of the JAX package, pl.pallas_call at bessel.py:125) and of its
dispatchers `kve_ratio_batch` / `kve_ratio_both_hot`. The kernel
(`csrc/kve_ratio.cu`) runs the device function of `csrc/kve_ratio.cuh`, the
same function that the cylinder dispersion kernel inlines for its exterior.

A CPU tensor goes to the plain version, `special.kve_ratio_both`; a CUDA
float32/float64 contiguous tensor goes to the kernel; anything else raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import special
from . import _build

# launches of the kernel since the last reset (one per kernel launch)
launches = 0

_ENTRY = {torch.float32: "eigk_kve_ratio_f32", torch.float64: "eigk_kve_ratio_f64"}


def kve_ratio_both(z: torch.Tensor):
    """(K_0'/K_0, K_1'/K_1) of real z > 0, elementwise."""
    global launches
    if z.device.type == "cpu":
        return special.kve_ratio_both(z)
    if z.device.type != "cuda":
        raise ValueError(f"kve_ratio_both: unsupported device {z.device}")
    if z.dtype not in _ENTRY:
        raise TypeError(f"kve_ratio_both kernel takes float32/float64, "
                        f"not {z.dtype}")
    if not z.is_contiguous():
        raise ValueError("kve_ratio_both kernel needs a contiguous tensor")
    r0 = torch.empty_like(z)
    r1 = torch.empty_like(z)
    n = z.numel()
    if n == 0:
        return r0, r1
    fn = getattr(_build.library(), _ENTRY[z.dtype])
    stream = torch.cuda.current_stream(z.device).cuda_stream
    code = fn(ctypes.c_void_p(z.data_ptr()), ctypes.c_void_p(r0.data_ptr()),
              ctypes.c_void_p(r1.data_ptr()), n, z.device.index,
              ctypes.c_void_p(stream))
    _build.check(code, "kve_ratio kernel")
    launches += 1
    return r0, r1
