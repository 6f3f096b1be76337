"""Cylinder dispersion determinant and bisection: wrappers of the CUDA
kernels `cylinder_disp` and `cylinder_bisect`.

`cylinder_disp` (`csrc/cylinder_disp.cu`) is the port of the XLA-fused
`jit(vmap(disp))` of `eigensolver_tpu/physics/cylinder.py` (cylinder.py:
236-385, real omega, "bessel" exterior; the twisted chain is a compile-time
variant that the C entries pick from the parameters): one thread per
(omega, k, m) candidate carries the whole interior shoot, the axis tail, the
inlined K_m-ratio exterior (`csrc/kve_ratio.cuh`, the port of the Pallas
kernel `kernels/bessel.py::kve_ratio_pallas`) and the determinant in
registers, reading the chain's r-only values from a table that its block
computes in shared memory, chunk by chunk. `cylinder_bisect` (same file,
`csrc/bisect.cuh`) runs a whole fixed-count bisection of a bracket batch
over the same chain in one launch (`eigensolver_tpu/search.py:142-169`,
:468-522).

A CPU tensor goes to the plain version
(`physics.cylinder.CylinderPhysics.make_dispersion_plain`, and
`search.bisect_loop` over it); CUDA float32/float64 contiguous tensors go to
the kernels; anything else raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ..config import CaseConfig, ProfileConfig, ProfileKind
from .common import (BisectShape, ProfileParams, ScanShape,
                     check_scan_shape, density_flow_params, launch_bisect,
                     launch_disp, profile_params)

# launches of the kernels since the last reset (one per kernel launch):
# cylinder_disp, and the fused bisection cylinder_bisect
launches = 0
bisect_launches = 0

# C entries by dtype; each runs the chain that the parameters' `twisted`
# names
_ENTRY = {torch.float32: "eigk_cylinder_disp_f32",
          torch.float64: "eigk_cylinder_disp_f64"}
_BISECT_ENTRY = {torch.float32: "eigk_cylinder_bisect_f32",
                 torch.float64: "eigk_cylinder_bisect_f64"}


class _CylParams(ctypes.Structure):
    """Mirror of eigk::CylDispParams."""
    _fields_ = [("rho", ProfileParams), ("flow", ProfileParams),
                ("uniform_density", ctypes.c_int), ("zero_flow", ctypes.c_int),
                ("vA_i0", ctypes.c_double), ("c_i0", ctypes.c_double),
                ("rho_i0", ctypes.c_double), ("B_0", ctypes.c_double),
                ("c2_num", ctypes.c_double), ("half_g", ctypes.c_double),
                ("vA_e2", ctypes.c_double), ("c_e2", ctypes.c_double),
                ("cT_e2", ctypes.c_double), ("vAc_e2", ctypes.c_double),
                ("rho_e", ctypes.c_double), ("m_e_floor", ctypes.c_double),
                ("axis_eps", ctypes.c_double),
                ("axis_eps_final", ctypes.c_double),
                ("n_interior", ctypes.c_int), ("n_axis_log", ctypes.c_int),
                ("log_tail", ctypes.c_int),
                # the twisted chain (physics.cylinder.twisted_point_fn)
                ("twisted", ctypes.c_int),
                ("vphi", ProfileParams), ("bphi", ProfileParams),
                ("P_0", ctypes.c_double), ("gamma", ctypes.c_double),
                ("amp2", ctypes.c_double), ("pw2", ctypes.c_double),
                ("pw2_m1", ctypes.c_double), ("B0_sq", ctypes.c_double)]


@dataclasses.dataclass(frozen=True)
class DispParams:
    """A case as the kernel reads it: the case (for the plain version) and
    its scalars, formed in double on the host as the JAX code forms them
    from Python floats."""
    case: CaseConfig
    struct: _CylParams


def disp_params(case: CaseConfig) -> DispParams:
    from ..physics.cylinder import is_twisted, log_tail
    rg = case.regime
    g = rg.gamma
    gr = case.grid
    rho, flow = density_flow_params("cylinder_disp", case)
    zero_flow = (case.flow_profile.kind == ProfileKind.UNIFORM
                 and rg.U_i0 == rg.U_e == 0.0)
    twisted = is_twisted(case)
    uniform = ProfileConfig(kind=ProfileKind.UNIFORM)
    tp = case.twist_profile or uniform
    bp = case.b_twist_profile if twisted and case.b_twist_profile else uniform
    if {tp.kind, bp.kind} - {ProfileKind.POWER_LAW, ProfileKind.UNIFORM}:
        # the kernels' tw_profile (csrc/cylinder_disp.cu) evaluates these two
        raise NotImplementedError(
            "cylinder_disp: twist profiles other than power laws")
    s = _CylParams(
        rho=rho, flow=flow,
        uniform_density=int(case.density_profile.kind == ProfileKind.UNIFORM),
        zero_flow=int(zero_flow),
        vA_i0=rg.vA_i0, c_i0=rg.c_i0, rho_i0=rg.rho_i0, B_0=rg.B_0,
        c2_num=rg.rho_e * (rg.c_e ** 2 + 0.5 * g * rg.vA_e ** 2),
        half_g=0.5 * g,
        vA_e2=rg.vA_e ** 2, c_e2=rg.c_e ** 2, cT_e2=rg.cT_e ** 2,
        vAc_e2=rg.vA_e ** 2 + rg.c_e ** 2,
        rho_e=rg.rho_e, m_e_floor=1e-300,
        axis_eps=gr.axis_epsilon, axis_eps_final=gr.axis_epsilon_final,
        n_interior=gr.n_interior, n_axis_log=gr.n_axis_log,
        log_tail=int(log_tail(case)),
        twisted=int(twisted),
        vphi=profile_params(tp, 0.0, 0.0), bphi=profile_params(bp, 0.0, 0.0),
        P_0=rg.P_0, gamma=g, amp2=tp.amplitude ** 2, pw2=2.0 * tp.power,
        pw2_m1=2.0 * tp.power - 1.0, B0_sq=rg.B_0 ** 2)
    return DispParams(case=case, struct=s)


# the sizes of the scan's table entries (csrc/cylinder_disp.cu), 16-byte
# aligned: RPoint<T>, 9 values; twisted, RPointTw<T>, 19
_ENTRY_BYTES = {(torch.float32, False): 48, (torch.float64, False): 80,
                (torch.float32, True): 80, (torch.float64, True): 160}


# The scan's launch shape: within 1% of the fastest of 15 shapes at both
# types on an H100 at the cyl_co_09 sweep's 552,960 candidates
# (`tools_torch/tune_disp.py`, PERF.md section 6)
SCAN_SHAPE = ScanShape(threads=256, chunk=64)


def _check_scan_shape(shape: ScanShape, dtype: torch.dtype,
                      twisted: bool = False) -> None:
    check_scan_shape("cylinder_disp", shape, (128, 256, 512),
                     _ENTRY_BYTES[dtype, twisted])


def cylinder_disp(omega: torch.Tensor, k: torch.Tensor, m: torch.Tensor,
                  params: DispParams, shape: Optional[ScanShape] = None):
    """CylinderInterface(det, mismatch_pct, valid) of 1-D candidate tensors
    (omega, k, m) of one dtype and device; on the card with the launch
    shape `shape` (default `SCAN_SHAPE`)."""
    global launches
    if omega.device.type == "cpu":
        return _plain(params, omega.dtype)(omega, k, m)
    from ..physics.cylinder import CylinderInterface
    shape = ScanShape(*(shape or SCAN_SHAPE))
    if omega.dtype in _ENTRY:     # launch_disp raises on the others
        _check_scan_shape(shape, omega.dtype, bool(params.struct.twisted))
    det, mism, valid = launch_disp(
        "cylinder_disp", _ENTRY, "eigk_cylinder_params_size", params.struct,
        omega, k, m, shape)
    launches += omega.numel() > 0
    return CylinderInterface(det=det, mismatch_pct=mism, valid=valid)


def _plain(params: DispParams, dtype: torch.dtype):
    from ..physics.cylinder import CylinderPhysics
    return CylinderPhysics.from_case(params.case).make_dispersion_plain(
        m=None, dtype=dtype)


def cylinder_bisect(lo: torch.Tensor, hi: torch.Tensor, k: torch.Tensor,
                    m: torch.Tensor, n_iter: int, params: DispParams,
                    final_eval: bool = True,
                    shape: Optional[BisectShape] = None):
    """Fixed-count bisection of the brackets [lo, hi] at (k, m), 1-D
    tensors of one dtype and device: (root, mismatch at the root), mismatch
    None without final_eval. A CUDA tensor launches the fused kernel
    `cylinder_bisect` once (block shape `shape`, default
    `common.bisect_shape`); a CPU tensor runs `search.bisect_loop` over the
    plain dispersion."""
    global bisect_launches
    if lo.dtype not in _BISECT_ENTRY:
        raise TypeError(f"cylinder_bisect takes float32/float64, not "
                        f"{lo.dtype}")
    if lo.device.type == "cpu":
        from ..search import bisect_loop
        return bisect_loop(_plain(params, lo.dtype), lo, hi, k, m, n_iter,
                           final_eval)
    out = launch_bisect("cylinder_bisect", _BISECT_ENTRY,
                        "eigk_cylinder_params_size", params.struct, lo, hi, k,
                        m, n_iter, final_eval, shape)
    bisect_launches += lo.numel() > 0
    return out
