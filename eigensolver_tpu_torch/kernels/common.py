"""Host mirror of `csrc/common.cuh::ProfileParams`, shared by the kernel
wrappers, and the launch checks they share."""
from __future__ import annotations

import ctypes

import torch

from ..config import ProfileConfig, ProfileKind
from ..profiles import derivative_coefs
from . import _build

KIND_ID = {ProfileKind.UNIFORM: 0, ProfileKind.GAUSSIAN: 1,
           ProfileKind.EPSTEIN: 2, ProfileKind.POWER_LAW: 3}


class ProfileParams(ctypes.Structure):
    """Mirror of eigk::ProfileParams."""
    _fields_ = [("kind", ctypes.c_int),
                ("f0", ctypes.c_double), ("fe", ctypes.c_double),
                ("f0_minus_fe", ctypes.c_double),
                ("center", ctypes.c_double), ("width", ctypes.c_double),
                ("w2", ctypes.c_double),
                ("amplitude", ctypes.c_double), ("power", ctypes.c_double),
                ("d1", ctypes.c_double), ("d2", ctypes.c_double),
                ("d2_shift", ctypes.c_double),
                ("power_m1", ctypes.c_double), ("power_m2", ctypes.c_double)]


def profile_params(cfg: ProfileConfig, f0: float, fe: float) -> ProfileParams:
    # every value a Python float in profiles.make_profile and
    # profiles.make_profile_derivative, formed in double
    d1, d2, d2_shift = derivative_coefs(cfg, f0, fe)
    return ProfileParams(kind=KIND_ID[cfg.kind], f0=f0, fe=fe,
                         f0_minus_fe=f0 - fe, center=cfg.center,
                         width=cfg.width, w2=cfg.width ** 2,
                         amplitude=cfg.amplitude, power=cfg.power,
                         d1=d1, d2=d2, d2_shift=d2_shift,
                         power_m1=cfg.power - 1.0, power_m2=cfg.power - 2.0)


def launch_disp(name: str, entries: dict, size_fn: str, struct,
                omega: torch.Tensor, k: torch.Tensor, mode: torch.Tensor):
    """Check the candidate tensors of a dispersion kernel, allocate its
    outputs and launch it on the current stream (no launch for 0
    candidates): (det, mismatch, valid). `mode` is the per-candidate mode
    column (azimuthal order or parity)."""
    if omega.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {omega.device}")
    if omega.dtype not in entries:
        raise TypeError(f"{name} kernel takes float32/float64, "
                        f"not {omega.dtype}")
    for arg, t in (("k", k), ("mode", mode)):
        if (t.device != omega.device or t.dtype != omega.dtype
                or t.shape != omega.shape):
            raise ValueError(f"{name}: {arg} must match omega in "
                             f"device, dtype and shape")
    if omega.dim() != 1 or not all(t.is_contiguous() for t in (omega, k, mode)):
        raise ValueError(f"{name} kernel needs contiguous 1-D tensors")
    det = torch.empty_like(omega)
    mism = torch.empty_like(omega)
    valid = torch.empty(omega.shape, dtype=torch.bool, device=omega.device)
    n = omega.numel()
    if n:
        lib = _build.library()
        if getattr(lib, size_fn)() != ctypes.sizeof(struct):
            raise RuntimeError(f"{name}: parameter struct layout differs "
                               f"between Python and CUDA")
        stream = torch.cuda.current_stream(omega.device).cuda_stream
        code = getattr(lib, entries[omega.dtype])(
            ctypes.c_void_p(omega.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(mode.data_ptr()), ctypes.c_void_p(det.data_ptr()),
            ctypes.c_void_p(mism.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
            n, ctypes.byref(struct), omega.device.index,
            ctypes.c_void_p(stream))
        _build.check(code, f"{name} kernel")
    return det, mism, valid
