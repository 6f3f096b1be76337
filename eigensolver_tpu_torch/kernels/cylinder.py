"""Cylinder dispersion determinant and bisection: wrappers of the CUDA
kernels `cylinder_disp` and `cylinder_bisect`.

`cylinder_disp` (`csrc/cylinder_disp.cu`) is the port of the XLA-fused
`jit(vmap(disp))` of `eigensolver_tpu/physics/cylinder.py` (cylinder.py:
236-385, real omega): one thread per (omega, k, m) candidate carries the
whole interior shoot, the axis tail, the exterior (the inlined K_m ratio,
`csrc/kve_ratio.cuh`, the port of the Pallas kernel
`kernels/bessel.py::kve_ratio_pallas`; or, in a variant the parameters
pick, the numeric exterior of `ode.py:22-47`) and the determinant in
registers, reading the chain's r-only values, and the (k, m, r) values of
the (k, m) rows of its block's first and last candidates, from tables that
its block computes in shared memory, chunk by chunk (the numeric
exterior's exp(2 t) of those rows' k likewise); a candidate of another row
forms its own with the same operations (`scan_tabled` counts the
candidates that took the tables). `cylinder_bisect` (same file,
`csrc/bisect.cuh::spec_kernel`) runs a whole fixed-count bisection of a
bracket batch over the same chain in one launch
(`eigensolver_tpu/search.py:142-169`, :468-522), with either exterior: its
producer warps read the r-only values from a table as the scan does, and a
small batch speculates several levels a round.

The twisted chain has kernels of its own (`csrc/cylinder_twisted.cu`),
which the same wrappers pick from the parameters: the scan
(`TW_SCAN_SHAPE`), for a batch below `TW_EVAL_MAX` candidates the
fused kernel's evaluation mode (producer warps compute the chain, one
consumer lane a candidate), and the speculative fused bisection
(`common.spec_shape`: the loop's schedule for a batch that fills the card,
L levels a round on 2^L lanes a bracket for a smaller one).

At complex omega one more kernel (`csrc/cylinder_complex.cu`) serves two
wrappers: `cylinder_newton` (kernel B7 on the cylinder: every damped Newton
step of a seed batch in one launch, one thread a seed, each step a shoot on
duals in omega; with final_eval the roots' evaluation is its last round)
and `cylinder_disp_complex`, its evaluation mode, the shoot on complex
pairs (`cplx.C`): the non-twisted chain (B4-complex) or the twisted one
(B4-twisted at complex omega), with the K_m ratio at complex z (B1 at
complex z, `csrc/kve_complex.cuh`) or the numeric exterior (B6-complex),
as the parameters pick.

A CPU tensor goes to the plain version
(`physics.cylinder.CylinderPhysics.make_dispersion_plain`, and
`search.bisect_loop` over it); CUDA float32/float64 contiguous tensors go to
the kernels; anything else raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import torch

from ..config import CaseConfig, ProfileConfig, ProfileKind
from .common import (EXTERIOR_FIELDS, ProfileParams, ScanShape, SpecShape,
                     analytic_spec_shape, as_pair, check_scan_shape,
                     density_flow_params, exterior_params, launch_complex,
                     launch_disp, launch_spec, numeric_spec_shape,
                     profile_params)

# launches of the kernels since the last reset (one per kernel launch):
# cylinder_disp (of them, small_launches through the twisted fused
# evaluation), and the fused bisection cylinder_bisect
launches = 0
small_launches = 0
bisect_launches = 0
# complex omega: the Newton launches (cylinder_newton) and the evaluations
# (cylinder_disp_complex); of either, those of the twisted chain and those
# with the numeric exterior
newton_launches = 0
complex_launches = 0
complex_twisted_launches = 0
complex_numeric_launches = 0

# C entries by dtype; each runs the chain that the parameters' `twisted`
# names
_ENTRY = {torch.float32: "eigk_cylinder_disp_f32",
          torch.float64: "eigk_cylinder_disp_f64"}
# the twisted chain's fused evaluation and speculative fused bisection
_EVAL_ENTRY = {torch.float32: "eigk_cylinder_eval_f32",
               torch.float64: "eigk_cylinder_eval_f64"}
_SPEC_ENTRY = {torch.float32: "eigk_cylinder_spec_f32",
               torch.float64: "eigk_cylinder_spec_f64"}
# the density/axial-flow chain's fused bisection, with either exterior
_BISECT_SPEC_ENTRY = {torch.float32: "eigk_cylinder_bisect_spec_f32",
                      torch.float64: "eigk_cylinder_bisect_spec_f64"}
# complex omega, every chain and exterior: Newton rounds, the value round,
# or both
_NEWTON_ENTRY = {torch.float32: "eigk_cylinder_newton_f32",
                 torch.float64: "eigk_cylinder_newton_f64"}


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
                ("pw2_m1", ctypes.c_double), ("B0_sq", ctypes.c_double),
                *EXTERIOR_FIELDS]


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
        pw2_m1=2.0 * tp.power - 1.0, B0_sq=rg.B_0 ** 2,
        **exterior_params(case))
    return DispParams(case=case, struct=s)


# the sizes of the r-only table entries, 16-byte aligned: RPoint<T>, 9
# values (csrc/cylinder_disp.cu); twisted, RPointTw<T>, 21
# (csrc/cylinder_twisted.cu)
_ENTRY_BYTES = {(torch.float32, False): 48, (torch.float64, False): 80,
                (torch.float32, True): 96, (torch.float64, True): 176}
# the density/axial-flow scan's tables per abscissa: the r-only entry and
# the entries of its 2 rows, RowPoint<T>, 4 values (csrc/cylinder_disp.cu::
# scan_smem; cylinder_disp holds the two to each other on the card)
_SCAN_ENTRY_BYTES = {dtype: _ENTRY_BYTES[dtype, False] + 2 * 4 * size
                     for dtype, size in ((torch.float32, 4),
                                         (torch.float64, 8))}


# The scan's launch shape: within 1% of the fastest of 15 shapes at both
# types on an H100 at the cyl_co_09 sweep's 552,960 candidates; with the
# (k, m, r) row table, within 2% of the fastest of 15 at both types on
# the cyl_flow_1 parity scan's 3,007,620 with the numeric exterior
# (`tools_torch/tune_disp.py`, PERF.md section 6)
SCAN_SHAPE = ScanShape(threads=256, chunk=64)


# The twisted scan's launch shape at each type. Its kernel is built for
# 128 threads a block at the register budget of 5 blocks per SM
# (csrc/cylinder_twisted.cu::kTwScanThreads, kTwScanMinBlocks: 88 registers
# at float32, 96 and 64 spill bytes at float64), so twist_v01_p1's 76,800
# candidates run in one wave on an H100; within 1% of the fastest of 18
# (threads, budget, chunk) shapes at both types (PERF.md section 6)
TW_SCAN_THREADS = 128
TW_SCAN_SHAPE = {torch.float32: ScanShape(TW_SCAN_THREADS, 64),
                 torch.float64: ScanShape(TW_SCAN_THREADS, 32)}
# Below this many candidates the twisted chain goes through the fused
# evaluation (common.spec_shape(n, evaluate=True)): the scan's serial
# floor (one thread's 1,536-step chain, ~1.0 ms at float32 and 1.5 ms at
# float64 on an H100) is longer than the fused kernel's time there
# (`tools_torch/tune_disp.py`: the two cross near 28,000 and 14,500)
TW_EVAL_MAX = {torch.float32: 28672, torch.float64: 14336}


def _check_scan_shape(shape: ScanShape, dtype: torch.dtype,
                      twisted: bool = False, numeric: bool = False) -> None:
    # the numeric exterior's untwisted scan is built at SCAN_SHAPE's
    # threads only
    threads = ((TW_SCAN_THREADS,) if twisted else
               (SCAN_SHAPE.threads,) if numeric else (128, 256, 512))
    check_scan_shape("cylinder_disp", shape, threads,
                     _ENTRY_BYTES[dtype, True] if twisted
                     else _SCAN_ENTRY_BYTES[dtype])


def _check_scan_smem(dtype: torch.dtype, chunk: int) -> None:
    """Raise unless the density/axial-flow scan's tables take the bytes
    that _SCAN_ENTRY_BYTES gives (csrc/cylinder_disp.cu::scan_smem)."""
    from . import _build
    got = _build.library().eigk_cylinder_scan_smem(
        int(dtype == torch.float64), chunk)
    if got != 2 * 3 * chunk * _SCAN_ENTRY_BYTES[dtype]:
        raise RuntimeError(f"cylinder_disp: the scan's tables take {got} B "
                           f"in CUDA, not what _SCAN_ENTRY_BYTES gives")


def cylinder_disp(omega: torch.Tensor, k: torch.Tensor, m: torch.Tensor,
                  params: DispParams, shape=None):
    """CylinderInterface(det, mismatch_pct, valid) of 1-D candidate tensors
    (omega, k, m) of one dtype and device; on the card with the launch
    shape `shape`: a ScanShape (default `SCAN_SHAPE`), for the twisted
    chain a ScanShape (default `TW_SCAN_SHAPE`) or a common.SpecShape of
    levels 0, the fused evaluation (the default below `TW_EVAL_MAX`
    candidates)."""
    global launches, small_launches
    if omega.device.type == "cpu":
        return _plain(params, omega.dtype)(omega, k, m)
    from ..physics.cylinder import CylinderInterface
    if omega.dtype not in _ENTRY:
        raise TypeError(f"cylinder_disp kernel takes float32/float64, not "
                        f"{omega.dtype}")
    twisted = bool(params.struct.twisted)
    if twisted and (isinstance(shape, SpecShape) or (
            shape is None and omega.numel() < TW_EVAL_MAX[omega.dtype])):
        det, mism, valid = launch_spec(
            "cylinder_disp", _EVAL_ENTRY, "eigk_cylinder_params_size",
            params.struct, _ENTRY_BYTES[omega.dtype, True], omega, None, k,
            m, 0, True, shape)
        small_launches += omega.numel() > 0
    else:
        shape = ScanShape(*(shape or (TW_SCAN_SHAPE[omega.dtype] if twisted
                                      else SCAN_SHAPE)))
        _check_scan_shape(shape, omega.dtype, twisted,
                          bool(params.struct.exterior_numeric))
        if not twisted and omega.is_cuda and omega.numel():
            _check_scan_smem(omega.dtype, shape.chunk)
        det, mism, valid = launch_disp(
            "cylinder_disp", _ENTRY, "eigk_cylinder_params_size",
            params.struct, omega, k, m, shape)
    launches += omega.numel() > 0
    return CylinderInterface(det=det, mismatch_pct=mism, valid=valid)


def scan_tabled(device) -> tuple:
    """(rows, exterior): the candidates that the density/axial-flow scans
    on the CUDA `device` evaluated through their block's row table, and
    those whose numeric exterior read the block's table of exps, since the
    last call (each launch's candidates in their block's first or last
    row: the whole batch when its rows are at least a block long); zeroes
    both. Waits for the device's work."""
    from . import _build
    out = (ctypes.c_ulonglong * 2)()
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    _build.check(_build.library().eigk_cylinder_scan_tabled(index, out),
                 "cylinder_disp tabled counts")
    return int(out[0]), int(out[1])


def _plain(params: DispParams, dtype: torch.dtype):
    from ..physics.cylinder import CylinderPhysics
    return CylinderPhysics.from_case(params.case).make_dispersion_plain(
        m=None, dtype=dtype)


def cylinder_bisect(lo: torch.Tensor, hi: torch.Tensor, k: torch.Tensor,
                    m: torch.Tensor, n_iter: int, params: DispParams,
                    final_eval: bool = True, shape=None):
    """Fixed-count bisection of the brackets [lo, hi] at (k, m), 1-D
    tensors of one dtype and device: (root, mismatch at the root), mismatch
    None without final_eval. A CUDA tensor launches the fused kernel
    `cylinder_bisect` once (block shape `shape`, a common.SpecShape;
    default `common.analytic_spec_shape`, with the numeric exterior
    `common.numeric_spec_shape`, for the twisted chain
    `common.spec_shape`); a CPU tensor runs `search.bisect_loop` over the
    plain dispersion."""
    global bisect_launches
    if lo.dtype not in _SPEC_ENTRY:
        raise TypeError(f"cylinder_bisect takes float32/float64, not "
                        f"{lo.dtype}")
    if lo.device.type == "cpu":
        from ..search import bisect_loop
        return bisect_loop(_plain(params, lo.dtype), lo, hi, k, m, n_iter,
                           final_eval)
    twisted = bool(params.struct.twisted)
    eb = _ENTRY_BYTES[lo.dtype, twisted]
    if twisted:
        out = launch_spec("cylinder_bisect", _SPEC_ENTRY,
                          "eigk_cylinder_params_size", params.struct, eb, lo,
                          hi, k, m, n_iter, final_eval, shape)
    else:
        rule = (numeric_spec_shape if params.struct.exterior_numeric
                else analytic_spec_shape)
        out = launch_spec("cylinder_bisect", _BISECT_SPEC_ENTRY,
                          "eigk_cylinder_params_size", params.struct, eb, lo,
                          hi, k, m, n_iter, final_eval,
                          shape or rule(lo.numel(), lo.dtype, eb))
    bisect_launches += lo.numel() > 0
    return out


# -- complex omega ----------------------------------------------------------

def _launch_complex(name: str, omega, k, m, params: DispParams, n_iter,
                    damping: float, final_eval: bool):
    """One launch of the complex-omega kernel (`common.launch_complex`) in
    the case's chain and exterior."""
    global complex_twisted_launches, complex_numeric_launches
    from ..physics.cylinder import CylinderInterface
    out = launch_complex(name, _NEWTON_ENTRY, "eigk_cylinder_params_size",
                         params.struct, omega, k, m, n_iter, damping,
                         final_eval, (), CylinderInterface)
    if omega.re.numel():
        complex_twisted_launches += bool(params.struct.twisted)
        complex_numeric_launches += bool(params.struct.exterior_numeric)
    return out


def cylinder_disp_complex(omega, k: torch.Tensor, m: torch.Tensor,
                          params: DispParams):
    """CylinderInterface(det, mismatch_pct, valid) of 1-D candidate tensors
    at complex omega (a `cplx.C` of two real tensors, or a complex tensor;
    k, m of its real dtype and device), det a `cplx.C`: on the card one
    launch of the complex-omega kernel in its evaluation mode, on the CPU
    the plain version."""
    global complex_launches
    omega = as_pair(omega)
    if omega.re.device.type == "cpu":
        return _plain(params, omega.re.dtype)(omega, k, m)
    _, res = _launch_complex("cylinder_disp_complex", omega, k, m, params,
                             None, 1.0, True)
    complex_launches += omega.re.numel() > 0
    return res


def cylinder_newton(omega0, k: torch.Tensor, m: torch.Tensor, n_iter: int,
                    damping: float, params: DispParams,
                    final_eval: bool = False):
    """n_iter damped Newton steps in complex omega of every seed (omega0 a
    `cplx.C` or a complex tensor; k, m of its real dtype and device): the
    final omega, a `cplx.C`; with final_eval, (omega, the
    CylinderInterface of the value dispersion there). A CUDA tensor
    launches the complex-omega kernel once, the final evaluation its last
    round; a CPU tensor runs `search.newton_loop` over the plain dual
    shoot, then the plain value dispersion."""
    global newton_launches
    omega0 = as_pair(omega0)
    if omega0.re.device.type == "cpu":
        from ..physics.cylinder import CylinderPhysics
        from ..search import newton_loop
        dual = CylinderPhysics.from_case(
            params.case).make_dispersion_dual_plain(m=None,
                                                    dtype=omega0.re.dtype)
        om = newton_loop(dual, omega0, k, m, n_iter, damping)
        if not final_eval:
            return om
        return om, _plain(params, omega0.re.dtype)(om, k, m)
    out, res = _launch_complex("cylinder_newton", omega0, k, m, params,
                               n_iter, damping, final_eval)
    newton_launches += omega0.re.numel() > 0
    return (out, res) if final_eval else out
