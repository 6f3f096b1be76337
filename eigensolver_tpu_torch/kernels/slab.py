"""Slab dispersion determinant and bisection: wrappers of the CUDA kernels
`slab_disp` and `slab_bisect`.

`slab_disp` (`csrc/slab_disp.cu`) is the port of the XLA-fused
`jit(vmap(disp))` of `eigensolver_tpu/physics/slab.py` (slab.py:285-406,
real omega, exact exterior): one thread per (omega, k, parity) candidate
carries the whole RK4 shoot from the slab centre to its edge in registers,
in the flux form (density cases) or the shear form (flow cases), reading
the chain's x-only values from a table that its block computes in shared
memory, chunk by chunk.
`slab_bisect` (same file, `csrc/bisect.cuh`) runs a whole fixed-count
bisection of a bracket batch over the same chain in one launch
(`eigensolver_tpu/search.py:142-169`, :468-522).

A CPU tensor goes to the plain version
(`physics.slab.SlabPhysics.make_dispersion_plain`, and `search.bisect_loop`
over it); CUDA float32/float64 contiguous tensors go to the kernels;
anything else raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ..config import CaseConfig, ProfileKind
from .common import (_SMS, BisectShape, ProfileParams, ScanShape,
                     check_scan_shape, density_flow_params, launch_bisect,
                     launch_disp)

# launches of the kernels since the last reset (one per kernel launch):
# slab_disp, and the fused bisection slab_bisect
launches = 0
bisect_launches = 0

_ENTRY = {torch.float32: "eigk_slab_disp_f32",
          torch.float64: "eigk_slab_disp_f64"}
_BISECT_ENTRY = {torch.float32: "eigk_slab_bisect_f32",
                 torch.float64: "eigk_slab_bisect_f64"}


class _SlabParams(ctypes.Structure):
    """Mirror of eigk::SlabDispParams."""
    _fields_ = [("rho", ProfileParams), ("flow", ProfileParams),
                ("uniform_density", ctypes.c_int), ("zero_flow", ctypes.c_int),
                ("vA_i0", ctypes.c_double), ("c_i0", ctypes.c_double),
                ("rho_i0", ctypes.c_double), ("c2_num", ctypes.c_double),
                ("half_g", ctypes.c_double), ("U_e", ctypes.c_double),
                ("vA_e2", ctypes.c_double), ("c_e2", ctypes.c_double),
                ("cT_e2", ctypes.c_double), ("vAc_e2", ctypes.c_double),
                ("pe_coef", ctypes.c_double),
                ("sc2", ctypes.c_double), ("sa2", ctypes.c_double),
                ("scT2", ctypes.c_double), ("sca", ctypes.c_double),
                ("n_interior", ctypes.c_int), ("shear", ctypes.c_int),
                ("legacy_D", ctypes.c_int), ("shear_pressure", ctypes.c_int)]


@dataclasses.dataclass(frozen=True)
class DispParams:
    """A case as the kernel reads it: the case and the shear-pressure switch
    (for the plain version) and its scalars, formed in double on the host as
    the JAX code forms them from Python floats."""
    case: CaseConfig
    include_shear_pressure: bool
    struct: _SlabParams


def disp_params(case: CaseConfig, include_shear_pressure: bool = False
                ) -> DispParams:
    rg = case.regime
    g = rg.gamma
    rho, flow = density_flow_params("slab_disp", case)
    zero_flow = (case.flow_profile.kind == ProfileKind.UNIFORM
                 and rg.U_i0 == rg.U_e == 0.0)
    c2, a2 = rg.c_i0 ** 2, rg.vA_i0 ** 2
    s = _SlabParams(
        rho=rho, flow=flow,
        uniform_density=int(case.density_profile.kind == ProfileKind.UNIFORM),
        zero_flow=int(zero_flow),
        vA_i0=rg.vA_i0, c_i0=rg.c_i0, rho_i0=rg.rho_i0,
        c2_num=rg.rho_e * (rg.c_e ** 2 + 0.5 * g * rg.vA_e ** 2),
        half_g=0.5 * g, U_e=rg.U_e,
        vA_e2=rg.vA_e ** 2, c_e2=rg.c_e ** 2, cT_e2=rg.cT_e ** 2,
        vAc_e2=rg.vA_e ** 2 + rg.c_e ** 2,
        pe_coef=rg.rho_e * (rg.vA_e ** 2 + rg.c_e ** 2),
        sc2=c2, sa2=a2, scT2=c2 * a2 / (c2 + a2), sca=c2 + a2,
        n_interior=case.grid.n_interior, shear=int(not zero_flow),
        legacy_D=int(case.shear_D_legacy),
        shear_pressure=int(include_shear_pressure))
    return DispParams(case=case, include_shear_pressure=include_shear_pressure,
                      struct=s)


# the sizes of FluxPoint<T> (5 values) and ShearPoint<T> (3) of
# csrc/slab_disp.cu, 16-byte aligned, by (shear form, dtype)
_ENTRY_BYTES = {(False, torch.float32): 32, (False, torch.float64): 48,
                (True, torch.float32): 16, (True, torch.float64): 32}
_THREADS = (32, 64, 128, 256, 512)

# The scan's launch shapes, from timings on an H100 (`tools_torch/tune_disp.py`,
# PERF.md section 6): 256 threads a block for the flux form's scans; 128 for
# the shear form (6% faster there), and for a batch that blocks of 256 would
# not spread over every SM (the refine stage's 1,530 window ends: 5% faster);
# chunks of 64 steps. Each within 5% of the fastest of 25 shapes.
SCAN_SHAPE = ScanShape(threads=256, chunk=64)
NARROW_SCAN_SHAPE = ScanShape(threads=128, chunk=64)


def scan_shape(n: int, shear: bool) -> ScanShape:
    """The default launch shape for n candidates in the shear or the flux
    form."""
    if shear or n < _SMS * SCAN_SHAPE.threads:
        return NARROW_SCAN_SHAPE
    return SCAN_SHAPE


def _check_scan_shape(shape: ScanShape, dtype: torch.dtype,
                      shear: bool) -> None:
    check_scan_shape("slab_disp", shape, _THREADS,
                     _ENTRY_BYTES[(bool(shear), dtype)])


def slab_disp(omega: torch.Tensor, k: torch.Tensor, parity: torch.Tensor,
              params: DispParams, shape: Optional[ScanShape] = None):
    """SlabInterface(det, mismatch_pct, valid) of 1-D candidate tensors
    (omega, k, parity) of one dtype and device; on the card with the launch
    shape `shape` (default `scan_shape`). A shape the kernel is not built
    for raises on any device."""
    global launches
    from ..physics.slab import SlabInterface
    shear = bool(params.struct.shear)
    shape = ScanShape(*(shape or scan_shape(omega.numel(), shear)))
    if omega.dtype in _ENTRY:     # launch_disp raises on the others
        _check_scan_shape(shape, omega.dtype, shear)
    if omega.device.type == "cpu":
        return _plain(params, omega.dtype)(omega, k, parity)
    det, mism, valid = launch_disp(
        "slab_disp", _ENTRY, "eigk_slab_params_size", params.struct,
        omega, k, parity, shape)
    launches += omega.numel() > 0
    return SlabInterface(det=det, mismatch_pct=mism, valid=valid)


def _plain(params: DispParams, dtype: torch.dtype):
    from ..physics.slab import SlabPhysics
    return SlabPhysics.from_case(params.case).make_dispersion_plain(
        parity=None, dtype=dtype,
        include_shear_pressure=params.include_shear_pressure)


def slab_bisect(lo: torch.Tensor, hi: torch.Tensor, k: torch.Tensor,
                parity: torch.Tensor, n_iter: int, params: DispParams,
                final_eval: bool = True, shape: Optional[BisectShape] = None):
    """Fixed-count bisection of the brackets [lo, hi] at (k, parity), 1-D
    tensors of one dtype and device: (root, mismatch at the root), mismatch
    None without final_eval. A CUDA tensor launches the fused kernel
    `slab_bisect` once (block shape `shape`, default
    `common.bisect_shape`); a CPU tensor runs `search.bisect_loop` over the
    plain dispersion."""
    global bisect_launches
    if lo.dtype not in _BISECT_ENTRY:
        raise TypeError(f"slab_bisect takes float32/float64, not {lo.dtype}")
    if lo.device.type == "cpu":
        from ..search import bisect_loop
        return bisect_loop(_plain(params, lo.dtype), lo, hi, k, parity,
                           n_iter, final_eval)
    out = launch_bisect("slab_bisect", _BISECT_ENTRY, "eigk_slab_params_size",
                        params.struct, lo, hi, k, parity, n_iter, final_eval,
                        shape)
    bisect_launches += lo.numel() > 0
    return out
