"""Batched K_m logarithmic derivative: wrapper of the CUDA kernel `kve_ratio`.

Counterpart of `eigensolver_tpu.kernels.bessel.kve_ratio_pallas` (the one
Pallas kernel of the JAX package, pl.pallas_call at bessel.py:125) and of its
dispatchers `kve_ratio_batch` / `kve_ratio_both_hot`. The kernel
(`csrc/kve_ratio.cu`) runs the device function of `csrc/kve_ratio.cuh`, the
same function that the cylinder dispersion kernel inlines for its exterior.

A CPU tensor goes to the plain version, `special.kve_ratio_both`; a CUDA
float32/float64 contiguous tensor goes to the kernel; anything else raises.

`kve_ratio_complex` is the same ratio at complex z (Re z > 0), on complex
pairs (`cplx.C`): the device function of `csrc/kve_complex.cuh`, which the
complex-omega cylinder kernel (`csrc/cylinder_complex.cu`) inlines for its
exact exterior, launched alone (one thread an argument) for its own checks
and timing; its plain version is `special.kve_ratio_both_c`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import special
from . import _build

# launches of the kernels since the last reset (one per kernel launch): the
# real ratio, and the complex one alone
launches = 0
complex_launches = 0

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


_COMPLEX_ENTRY = {torch.float32: "eigk_kve_ratio_complex_f32",
                  torch.float64: "eigk_kve_ratio_complex_f64"}


def kve_ratio_complex(z, m: torch.Tensor):
    """K_m'/K_m at complex z (a `cplx.C` of two 1-D real tensors) for m of
    z's dtype and shape (K_0'/K_0 where m < 0.5, else K_1'/K_1), a
    `cplx.C`: on a CUDA tensor one launch of the device function of
    `csrc/kve_complex.cuh`, on a CPU tensor its plain version."""
    global complex_launches
    from ..cplx import C, where
    if z.re.device.type == "cpu":
        r0, r1 = special.kve_ratio_both_c(z)
        return where(m < 0.5, r0, r1)
    if z.re.dtype not in _COMPLEX_ENTRY:
        raise TypeError(f"kve_ratio_complex takes float32/float64, not "
                        f"{z.re.dtype}")
    for t in (z.im, m):
        if (t.device != z.re.device or t.dtype != z.re.dtype
                or t.shape != z.re.shape):
            raise ValueError("kve_ratio_complex: z.im and m must match z.re "
                             "in device, dtype and shape")
    if not all(t.is_contiguous() for t in (z.re, z.im, m)):
        raise ValueError("kve_ratio_complex kernel needs contiguous tensors")
    out = C(torch.empty_like(z.re), torch.empty_like(z.re))
    n = z.re.numel()
    if n == 0:
        return out
    stream = torch.cuda.current_stream(z.re.device).cuda_stream
    code = getattr(_build.library(), _COMPLEX_ENTRY[z.re.dtype])(
        *(ctypes.c_void_p(t.data_ptr())
          for t in (z.re, z.im, m, out.re, out.im)), n, z.re.device.index,
        ctypes.c_void_p(stream))
    _build.check(code, "kve_ratio_complex kernel")
    complex_launches += 1
    return out
