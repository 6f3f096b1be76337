"""Slab dispersion determinant and bisection: wrappers of the CUDA kernels
`slab_disp` and `slab_bisect`.

`slab_disp` (`csrc/slab_disp.cu`) is the port of the XLA-fused
`jit(vmap(disp))` of `eigensolver_tpu/physics/slab.py` (slab.py:285-406,
real omega; the exact exterior, or the numeric one of `ode.py:75-110` in a
variant the parameters pick): one thread per (omega, k, parity) candidate
carries the whole RK4 shoot from the slab centre to its edge in registers,
in the flux form (density cases) or the shear form (flow cases), reading
the chain's x-only values from a table that its block computes in shared
memory, chunk by chunk; where n_interior is a power of two each step's
first chain is the step before's last, kept, not formed again.
`slab_disp_pairs` is its paired variant for a sweep's ladder, whose rows
repeat once per parity: one thread per (omega, k) carries both parities
through one chain and one exterior, parity 0's results first.
`slab_bisect` (same file, `csrc/bisect.cuh::spec_kernel`) runs a whole
fixed-count bisection of a bracket batch over the same chain in one launch
(`eigensolver_tpu/search.py:142-169`, :468-522), with either exterior: its
producer warps read the x-only values from a table as the scan does, and a
small batch speculates several levels a round.

At complex omega (the Kelvin-Helmholtz growth rates, and any slab case the
CLI's `sweep --complex` makes complex) one warp-specialised kernel
(`csrc/slab_complex.cu`) serves both wrappers: `slab_newton` (kernel B7)
runs every damped Newton step of a seed batch in one launch
(`eigensolver_tpu/search.py:581-603`), each step one pass of the shoot on
dual numbers in omega, and, if asked, the evaluation of its roots in the
same launch; `slab_disp_complex` is the kernel's evaluation mode, the same
shoot on complex pairs (`cplx.C`): the shear form (kernel B5-complex) or
the flux form (B2-complex), with the exact exterior or the numeric one
(B6-complex), as the parameters pick. Producer warps compute each RK4
step's coefficients, one consumer lane a seed runs the serial update (and
the numeric exterior). Their plain versions are
`SlabPhysics.make_dispersion_plain` at complex omega and
`search.newton_loop` over `make_dispersion_dual_plain`.

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
from . import _build
from .common import (_SMS, EXTERIOR_FIELDS, ComplexShape, ProfileParams,
                     ScanShape, analytic_spec_shape, as_pair,
                     check_complex_shape, check_scan_shape,
                     complex_spec_shape, density_flow_params,
                     exterior_params, launch_complex, launch_disp,
                     launch_spec, numeric_spec_shape)

# launches of the kernels since the last reset (one per kernel launch):
# slab_disp (either variant), the fused bisection slab_bisect, and at
# complex omega slab_disp_complex and slab_newton (every form and
# exterior), and of these the flux form's and the numeric exterior's; and
# the candidates that took the paired variant (2 per (omega, k))
launches = 0
paired = 0
bisect_launches = 0
complex_launches = 0
newton_launches = 0
complex_flux_launches = 0
complex_numeric_launches = 0

_ENTRY = {torch.float32: "eigk_slab_disp_f32",
          torch.float64: "eigk_slab_disp_f64"}
# both parities of each (omega, k)
_PAIRS_ENTRY = {torch.float32: "eigk_slab_pairs_f32",
                torch.float64: "eigk_slab_pairs_f64"}
# the fused bisection, with either exterior
_SPEC_ENTRY = {torch.float32: "eigk_slab_spec_f32",
               torch.float64: "eigk_slab_spec_f64"}
# the complex-omega kernel: Newton rounds, the value round, or both
_NEWTON_ENTRY = {torch.float32: "eigk_slab_newton_f32",
                 torch.float64: "eigk_slab_newton_f64"}


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
                ("legacy_D", ctypes.c_int), ("shear_pressure", ctypes.c_int),
                *EXTERIOR_FIELDS]


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
        shear_pressure=int(include_shear_pressure), **exterior_params(case))
    return DispParams(case=case, include_shear_pressure=include_shear_pressure,
                      struct=s)


# the sizes of FluxPoint<T> (5 values) and ShearPoint<T> (3) of
# csrc/slab_disp.cu, 16-byte aligned, by (shear form, dtype)
_ENTRY_BYTES = {(False, torch.float32): 32, (False, torch.float64): 48,
                (True, torch.float32): 16, (True, torch.float64): 32}
_THREADS = (32, 64, 128, 256, 512)
# the numeric exterior's scan is built only at the shapes scan_shape picks,
# by shear form
_NUM_THREADS = {False: (128, 256), True: (128,)}

# The scan's launch shapes, from timings on an H100 (`tools_torch/tune_disp.py`,
# PERF.md section 6): 256 threads a block for the flux form's scans; 128 for
# the shear form (6% faster there), and for a batch that blocks of 256 would
# not spread over every SM (the refine stage's 1,530 window ends: 5% faster);
# chunks of 128 steps. Each within 1% of the fastest of 25 shapes (numeric
# draws, flux: the fastest, 8% ahead of chunks of 64).
SCAN_SHAPE = ScanShape(threads=256, chunk=128)
NARROW_SCAN_SHAPE = ScanShape(threads=128, chunk=128)


def scan_shape(n: int, shear: bool) -> ScanShape:
    """The default launch shape for n candidates in the shear or the flux
    form."""
    if shear or n < _SMS * SCAN_SHAPE.threads:
        return NARROW_SCAN_SHAPE
    return SCAN_SHAPE


# The paired scan's launch shape (both parities of each (omega, k)) by
# shear form, the only block size it is built for, from timings on an H100
# (`tools_torch/tune_disp.py --kernel slab_paired`, PERF.md section 6): 128
# threads a block in the flux form (5-13% ahead of 256), 256 in the shear
# form (4-5% ahead of 128); chunks of 128 steps. Each within 0.5% of the
# fastest of its 10 built shapes on the sweeps' ladders.
PAIRS_SHAPE = {False: ScanShape(threads=128, chunk=128),
               True: ScanShape(threads=256, chunk=128)}


def _check_scan_shape(shape: ScanShape, dtype: torch.dtype,
                      shear: bool, numeric: bool = False,
                      pairs: bool = False) -> None:
    threads = ((PAIRS_SHAPE[bool(shear)].threads,) if pairs
               else _NUM_THREADS[bool(shear)] if numeric else _THREADS)
    check_scan_shape("slab_disp", shape, threads,
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
        _check_scan_shape(shape, omega.dtype, shear,
                          bool(params.struct.exterior_numeric))
    if omega.device.type == "cpu":
        return _plain(params, omega.dtype)(omega, k, parity)
    det, mism, valid = launch_disp(
        "slab_disp", _ENTRY, "eigk_slab_params_size", params.struct,
        omega, k, parity, shape)
    launches += omega.numel() > 0
    return SlabInterface(det=det, mismatch_pct=mism, valid=valid)


def slab_disp_pairs(omega: torch.Tensor, k: torch.Tensor,
                    params: DispParams, shape: Optional[ScanShape] = None):
    """SlabInterface(det, mismatch_pct, valid) of both parities of each
    (omega, k) of 1-D tensors of one dtype and device: 2 n entries, parity
    0's n results then parity 1's, as `slab_disp` gives them on (omega,
    k) repeated twice with the parity column (0 ... 0, 1 ... 1). On the card
    one launch of the paired scan (launch shape `shape`, default
    `PAIRS_SHAPE` of the form), on the CPU the plain version on that
    repeated batch. A shape the kernel is not built for raises on any
    device."""
    global launches, paired
    from ..physics.slab import SlabInterface
    shear = bool(params.struct.shear)
    shape = ScanShape(*(shape or PAIRS_SHAPE[shear]))
    if omega.dtype in _PAIRS_ENTRY:     # launch_disp raises on the others
        _check_scan_shape(shape, omega.dtype, shear, pairs=True)
    if omega.device.type == "cpu":
        par = torch.cat([torch.zeros_like(omega), torch.ones_like(omega)])
        return _plain(params, omega.dtype)(omega.repeat(2), k.repeat(2),
                                           par)
    det, mism, valid = launch_disp(
        "slab_disp_pairs", _PAIRS_ENTRY, "eigk_slab_params_size",
        params.struct, omega, k, None, shape)
    launches += omega.numel() > 0
    paired += 2 * omega.numel()
    return SlabInterface(det=det, mismatch_pct=mism, valid=valid)


def _plain(params: DispParams, dtype: torch.dtype):
    from ..physics.slab import SlabPhysics
    return SlabPhysics.from_case(params.case).make_dispersion_plain(
        parity=None, dtype=dtype,
        include_shear_pressure=params.include_shear_pressure)


def slab_bisect(lo: torch.Tensor, hi: torch.Tensor, k: torch.Tensor,
                parity: torch.Tensor, n_iter: int, params: DispParams,
                final_eval: bool = True, shape=None):
    """Fixed-count bisection of the brackets [lo, hi] at (k, parity), 1-D
    tensors of one dtype and device: (root, mismatch at the root), mismatch
    None without final_eval. A CUDA tensor launches the fused kernel
    `slab_bisect` once (block shape `shape`, a common.SpecShape; default
    `common.analytic_spec_shape`, with the numeric exterior
    `common.numeric_spec_shape`); a CPU tensor runs `search.bisect_loop`
    over the plain dispersion."""
    global bisect_launches
    if lo.dtype not in _SPEC_ENTRY:
        raise TypeError(f"slab_bisect takes float32/float64, not {lo.dtype}")
    if lo.device.type == "cpu":
        from ..search import bisect_loop
        return bisect_loop(_plain(params, lo.dtype), lo, hi, k, parity,
                           n_iter, final_eval)
    shear = bool(params.struct.shear)
    numeric = bool(params.struct.exterior_numeric)
    eb = _ENTRY_BYTES[(shear, lo.dtype)]
    shape = shape or (numeric_spec_shape(lo.numel(), lo.dtype, eb) if numeric
                      else analytic_spec_shape(lo.numel(), lo.dtype, eb,
                                               shear))
    out = launch_spec("slab_bisect", _SPEC_ENTRY, "eigk_slab_params_size",
                      params.struct, eb, lo, hi, k, parity, n_iter,
                      final_eval, shape)
    bisect_launches += lo.numel() > 0
    return out


def _launch_complex(name: str, omega, k, parity, params, n_iter,
                    damping: float, final_eval: bool, shape):
    """One launch of the complex-omega kernel (`common.launch_complex`) in
    the case's form and exterior, block shape `shape` (default
    `common.complex_spec_shape`)."""
    global complex_flux_launches, complex_numeric_launches
    from ..physics.slab import SlabInterface
    dtype = omega.re.dtype
    shear = bool(params.struct.shear)
    shape_args = ()
    if dtype in _NEWTON_ENTRY:
        shape = ComplexShape(*(shape or complex_spec_shape(dtype)))
        check_complex_shape(name, shape, dtype, shear)
        shape_args = tuple(shape)
    out = launch_complex(name, _NEWTON_ENTRY, "eigk_slab_params_size",
                         params.struct, omega, k, parity, n_iter, damping,
                         final_eval, shape_args, SlabInterface)
    if omega.re.numel():
        complex_flux_launches += not shear
        complex_numeric_launches += bool(params.struct.exterior_numeric)
    return out


def slab_disp_complex(omega, k: torch.Tensor, parity: torch.Tensor,
                      params: DispParams, shape=None):
    """SlabInterface(det (a `cplx.C`), mismatch_pct, valid) of 1-D candidate
    tensors at complex omega (a `cplx.C` of two real tensors, or a complex
    tensor, which is split), k and parity of omega's real dtype and device;
    on the card one launch of the complex-omega kernel in its evaluation
    mode (block shape `shape`, a common.ComplexShape; default
    `common.complex_spec_shape`)."""
    global complex_launches
    omega = as_pair(omega)
    if omega.re.device.type == "cpu":
        return _plain(params, omega.re.dtype)(omega, k, parity)
    _, res = _launch_complex("slab_disp_complex", omega, k, parity, params,
                             None, 1.0, True, shape)
    complex_launches += omega.re.numel() > 0
    return res


def slab_newton(omega0, k: torch.Tensor, parity: torch.Tensor, n_iter: int,
                damping: float, params: DispParams, final_eval: bool = False,
                shape=None):
    """n_iter damped Newton steps in complex omega of every seed (omega0 a
    `cplx.C` or a complex tensor; k, parity of its real dtype and device):
    the final omega, a `cplx.C`; with final_eval, (omega, the
    SlabInterface of the value dispersion there). A CUDA tensor launches
    the complex-omega kernel once, the final evaluation its last round
    (block shape `shape`, default `common.complex_spec_shape`); a CPU
    tensor runs `search.newton_loop` over the plain dual shoot, then the
    plain value dispersion."""
    global newton_launches
    omega0 = as_pair(omega0)
    if omega0.re.device.type == "cpu":
        from ..physics.slab import SlabPhysics
        from ..search import newton_loop
        dual = SlabPhysics.from_case(params.case).make_dispersion_dual_plain(
            parity=None, dtype=omega0.re.dtype,
            include_shear_pressure=params.include_shear_pressure)
        om = newton_loop(dual, omega0, k, parity, n_iter, damping)
        if not final_eval:
            return om
        return om, _plain(params, omega0.re.dtype)(om, k, parity)
    out, res = _launch_complex("slab_newton", omega0, k, parity, params,
                               n_iter, damping, final_eval, shape)
    newton_launches += omega0.re.numel() > 0
    return (out, res) if final_eval else out
