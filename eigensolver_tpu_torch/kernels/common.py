"""Host mirror of `csrc/common.cuh::ProfileParams`, shared by the kernel
wrappers, the launch checks they share, the launch shape of the scan
kernels (`cylinder_disp`, `slab_disp`) and the block shape of the fused
bisection kernels (`csrc/bisect.cuh`)."""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

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


def density_flow_params(kernel: str, case) -> tuple:
    """ProfileParams of a case's density and flow profiles. A power law
    raises: the kernels' `profile` (csrc/common.cuh) forms its power with
    `pow`, where the plain version's `profiles.power` writes some exponents
    out, so the two would not agree bit for bit. No case uses one."""
    if ProfileKind.POWER_LAW in (case.density_profile.kind,
                                 case.flow_profile.kind):
        raise NotImplementedError(
            f"{kernel}: power-law density or flow profiles")
    rg = case.regime
    return (profile_params(case.density_profile, rg.rho_i0, rg.rho_e),
            profile_params(case.flow_profile, rg.U_i0, rg.U_e))


def launch_disp(name: str, entries: dict, size_fn: str, struct,
                omega: torch.Tensor, k: torch.Tensor, mode: torch.Tensor,
                shape: tuple = ()):
    """Check the candidate tensors of a dispersion kernel, allocate its
    outputs and launch it on the current stream (no launch for 0
    candidates): (det, mismatch, valid). `mode` is the per-candidate mode
    column (azimuthal order or parity); `shape`, the kernel's integer launch
    arguments between the count and the parameters."""
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
            n, *shape, ctypes.byref(struct), omega.device.index,
            ctypes.c_void_p(stream))
        _build.check(code, f"{name} kernel")
    return det, mism, valid


class ScanShape(NamedTuple):
    """Launch shape of a scan kernel (`cylinder_disp`, `slab_disp`)."""
    threads: int     # candidates (threads) per block
    chunk: int       # RK4 steps per chunk of the shared-memory table


def check_scan_shape(name: str, shape: ScanShape, threads: tuple,
                     entry_bytes: int) -> None:
    """Raise unless the kernel is built for `shape.threads` (one of
    `threads`) and its table, 2 buffers x 3 chunk entries of `entry_bytes`,
    fits a block's shared memory."""
    n_threads, chunk = shape
    if not (n_threads in threads and chunk >= 1
            and 2 * 3 * chunk * entry_bytes <= MAX_SMEM):
        raise ValueError(f"{name}: unsupported launch shape {shape}")


class BisectShape(NamedTuple):
    """Block shape of a fused bisection launch (`csrc/bisect.cuh`)."""
    brackets: int    # B: brackets per block, one consumer lane each; divides 32
    producers: int   # P: producer warps, 1..15
    steps: int       # C: RK4 steps per ring stage
    stages: int      # S: ring stages, 1..6
    min_blocks: int  # register budget: 1 (128 a thread) or 2 (64) blocks of
                     # 512 threads per SM; 0: chosen at launch (bisect.cuh)


# SMs of an H100; the bracket batch is cut into at least two blocks per SM
# where it can be
_SMS = 132
# dynamic shared memory a block may use on Hopper
MAX_SMEM = 227 * 1024


def bisect_shape(n: int, dtype: torch.dtype) -> BisectShape:
    """The block shape for n brackets, from timings on an H100
    (`tools_torch/tune_bisect.py`, PERF.md section 6): the largest B <= 32
    that still gives two blocks per SM (B = 1 below 264 brackets); P = 15
    producer warps for B = 32, 7 for B = 8, 16, else B; 2 stages of C steps,
    the largest multiple of the producers' rows (32 P / B steps, so that no
    pass over a stage is partial) up to 64 that lets as many blocks share
    an SM's shared memory as 64 registers a thread allow; the register
    budget chosen at launch."""
    b = 32
    while b > 1 and -(-n // b) < 2 * _SMS:
        b //= 2
    p = 15 if b == 32 else 7 if b >= 8 else b
    blocks = min(32, 65536 // (64 * 32 * (p + 1)))
    rows = 32 * p // b
    c = rows * max(1, 64 // rows)
    while c > rows and blocks * bisect_smem(BisectShape(b, p, c, 2, 0),
                                            dtype) > MAX_SMEM:
        c -= rows
    return BisectShape(brackets=b, producers=p, steps=c, stages=2,
                       min_blocks=0)


def bisect_smem(shape: BisectShape, dtype: torch.dtype) -> int:
    """Bytes of dynamic shared memory of a block: 32 omegas and the ring of
    S stages of C steps x 6 coefficients x B brackets."""
    b, _, c, s, _ = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (32 + s * c * 6 * b) * itemsize


def _check_shape(name: str, shape: BisectShape, dtype: torch.dtype) -> None:
    b, p, c, s, min_blocks = shape
    if not (1 <= b <= 32 and 32 % b == 0 and 1 <= p <= 15 and c >= 1
            and 1 <= s <= 6 and min_blocks in (0, 1, 2)
            and bisect_smem(shape, dtype) <= MAX_SMEM):
        raise ValueError(f"{name}: unsupported block shape {shape}")


def launch_bisect(name: str, entries: dict, size_fn: str, struct,
                  lo: torch.Tensor, hi: torch.Tensor, k: torch.Tensor,
                  mode: torch.Tensor, n_iter: int, final_eval: bool,
                  shape: Optional[BisectShape] = None):
    """Check the bracket tensors of a fused bisection kernel, allocate its
    outputs and launch it on the current stream (no launch for 0
    brackets): (root, mismatch), mismatch None unless final_eval."""
    if lo.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {lo.device}")
    if lo.dtype not in entries:
        raise TypeError(f"{name} kernel takes float32/float64, not {lo.dtype}")
    for arg, t in (("hi", hi), ("k", k), ("mode", mode)):
        if t.device != lo.device or t.dtype != lo.dtype or t.shape != lo.shape:
            raise ValueError(f"{name}: {arg} must match lo in device, dtype "
                             f"and shape")
    if lo.dim() != 1 or not all(t.is_contiguous() for t in (lo, hi, k, mode)):
        raise ValueError(f"{name} kernel needs contiguous 1-D tensors")
    if n_iter < 0:
        raise ValueError(f"{name}: n_iter must be >= 0, not {n_iter}")
    n = lo.numel()
    shape = BisectShape(*(shape or bisect_shape(n, lo.dtype)))
    _check_shape(name, shape, lo.dtype)
    root = torch.empty_like(lo)
    mism = torch.empty_like(lo) if final_eval else None
    if n:
        lib = _build.library()
        if getattr(lib, size_fn)() != ctypes.sizeof(struct):
            raise RuntimeError(f"{name}: parameter struct layout differs "
                               f"between Python and CUDA")
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        code = getattr(lib, entries[lo.dtype])(
            *(ctypes.c_void_p(t.data_ptr()) for t in (lo, hi, k, mode, root)),
            ctypes.c_void_p(None if mism is None else mism.data_ptr()),
            n, n_iter, int(final_eval), *shape, ctypes.byref(struct),
            lo.device.index, ctypes.c_void_p(stream))
        _build.check(code, f"{name} kernel")
    return root, mism
