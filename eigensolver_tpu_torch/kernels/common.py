"""Host mirror of `csrc/common.cuh::ProfileParams`, shared by the kernel
wrappers, the launch checks they share, the launch shape of the scan
kernels (`cylinder_disp`, `slab_disp`), the block shapes of the fused
kernel (`csrc/bisect.cuh::spec_kernel`: the speculative bisection and
evaluation) and of the complex-omega kernel (`csrc/slab_complex.cu`)."""
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


# the fields that close each parameter struct (csrc/slab_disp.cu::
# SlabDispParams, csrc/cylinder.cuh::CylDispParams): the numeric exterior
EXTERIOR_FIELDS = [("exterior_wavelengths", ctypes.c_double),
                   ("exterior_numeric", ctypes.c_int),
                   ("n_exterior", ctypes.c_int)]


def exterior_params(case) -> dict:
    """The case's exterior as the kernels read it: with
    exterior_method="numeric", W of its span W 2 pi / k (the kernels form
    W 2 pi in double, as the Python code does) and its RK4 steps."""
    gr = case.grid
    return dict(exterior_wavelengths=gr.exterior_wavelengths,
                exterior_numeric=int(gr.exterior_method == "numeric"),
                n_exterior=gr.n_exterior)


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
                omega: torch.Tensor, k: torch.Tensor,
                mode: Optional[torch.Tensor], shape: tuple = ()):
    """Check the candidate tensors of a dispersion kernel, allocate its
    outputs and launch it on the current stream (no launch for 0
    candidates): (det, mismatch, valid). `mode` is the per-candidate mode
    column (azimuthal order or parity), or None for a kernel that writes
    both parities of each (omega, k), parity 0's results then parity 1's
    (2 n outputs); `shape`, the kernel's integer launch arguments between
    the count and the parameters."""
    if omega.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {omega.device}")
    if omega.dtype not in entries:
        raise TypeError(f"{name} kernel takes float32/float64, "
                        f"not {omega.dtype}")
    cols = {"k": k} if mode is None else {"k": k, "mode": mode}
    for arg, t in cols.items():
        if (t.device != omega.device or t.dtype != omega.dtype
                or t.shape != omega.shape):
            raise ValueError(f"{name}: {arg} must match omega in "
                             f"device, dtype and shape")
    if omega.dim() != 1 or not all(t.is_contiguous()
                                   for t in (omega, *cols.values())):
        raise ValueError(f"{name} kernel needs contiguous 1-D tensors")
    n = omega.numel()
    out_n = n if mode is not None else 2 * n
    det = omega.new_empty(out_n)
    mism = omega.new_empty(out_n)
    valid = torch.empty(out_n, dtype=torch.bool, device=omega.device)
    if n:
        lib = _build.library()
        if getattr(lib, size_fn)() != ctypes.sizeof(struct):
            raise RuntimeError(f"{name}: parameter struct layout differs "
                               f"between Python and CUDA")
        stream = torch.cuda.current_stream(omega.device).cuda_stream
        code = getattr(lib, entries[omega.dtype])(
            ctypes.c_void_p(omega.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(None if mode is None else mode.data_ptr()),
            ctypes.c_void_p(det.data_ptr()),
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


# SMs of an H100; the bracket batch is cut into at least two blocks per SM
# where it can be
_SMS = 132
# brackets (columns) from which the speculative kernel keeps the loop's
# schedule: two blocks of 8 per SM
_SPEC_COLUMNS = 2 * _SMS * 8
# dynamic shared memory a block may use on Hopper
MAX_SMEM = 227 * 1024


class SpecShape(NamedTuple):
    """Block shape of a speculative fused launch (`csrc/bisect.cuh::
    spec_kernel`): a bisection of `levels` levels a round (0: the loop's
    schedule, one level a round on one lane a bracket), or an evaluation
    (levels 0) of one candidate a column."""
    brackets: int    # B: brackets (candidates) a block
    levels: int      # L: levels a round, on 2^L lanes a bracket (B 2^L <= 32)
    producers: int   # P: producer warps, 1..15
    steps: int       # C: RK4 steps per ring stage
    stages: int      # S: ring stages, 1..6
    min_blocks: int  # register budget: 1 (128 a thread) or 2 (64) blocks of
                     # 512 threads per SM; 0: chosen at launch (bisect.cuh)


def spec_shape(n: int, dtype: torch.dtype, entry_bytes: int,
               evaluate: bool = False,
               levels: Optional[int] = None) -> SpecShape:
    """The block shape for n brackets (or, evaluating, n candidates). A
    bisection of at least `_SPEC_COLUMNS` brackets keeps the loop's
    schedule (L = 0: the producers set its pace, and speculation only adds
    work); a smaller one takes the fewest levels L >= 2 whose 2^L lanes a
    bracket give as many columns, up to L = 5, with B = 32 / 2^L brackets a
    block. L = 0 (and `levels`, if given) take the largest B <= 32 / 2^L
    that still gives two blocks per SM. P = 15 producer warps for 32
    columns (B 2^L), 7 for 8 or 16, else one a column; 2 ring stages of C
    steps, the largest multiple of the producers' rows (32 P / B 2^L steps,
    so that no pass over a stage is partial) up to 64 that lets as many
    blocks share an SM's shared memory (the ring and the table of entries
    of `entry_bytes`) as the register budget allows; at float64 the wide
    budget (128 a thread: the narrow one spills the chain), at float32 the
    budget chosen at launch. From timings on an H100
    (`tools_torch/tune_bisect.py`, `tune_disp.py`; PERF.md section 6)."""
    lv = 0 if evaluate else levels
    if lv is None and n < _SPEC_COLUMNS:
        lv = 2
        while lv < 5 and n << lv < _SPEC_COLUMNS:
            lv += 1
        b = 32 >> lv
    else:
        lv = lv or 0
        b = 32 >> lv
        while b > 1 and -(-n // b) < 2 * _SMS:
            b //= 2
    nc = b << lv
    p = 15 if nc == 32 else 7 if nc >= 8 else nc
    min_blocks = 1 if dtype == torch.float64 else 0
    return SpecShape(brackets=b, levels=lv, producers=p,
                     steps=_steps(b, lv, p, min_blocks, dtype, entry_bytes),
                     stages=2, min_blocks=min_blocks)


def _steps(b: int, lv: int, p: int, min_blocks: int, dtype: torch.dtype,
           entry_bytes: int, passes: int = 64) -> int:
    """C of a block of B 2^L columns and P producer warps: the largest
    multiple of the producers' rows (32 P / B 2^L steps a pass over a
    stage), at most `passes` passes and 64 steps, that lets as many 2-stage
    blocks share an SM's shared memory as the register budget allows (64
    registers a thread unless min_blocks is 1)."""
    regs = 128 if min_blocks == 1 else 64
    blocks = min(32, 65536 // (regs * 32 * (p + 1)))
    rows = 32 * p // (b << lv)
    c = rows * max(1, min(passes, 64 // rows))
    while c > rows and blocks * spec_smem(SpecShape(b, lv, p, c, 2, 0),
                                          dtype, entry_bytes) > MAX_SMEM:
        c -= rows
    return c


def numeric_spec_shape(n: int, dtype: torch.dtype,
                       entry_bytes: int) -> SpecShape:
    """The block shape of the numeric exterior's speculative bisection of n
    brackets over the slab or the cylinder chain: spec_shape's, except
    where that keeps the loop's schedule with 32 brackets a block; there 7
    producer warps, C = 32 steps a stage at float32 (16 at float64) and
    the register budget chosen at launch, the fastest of 54 shapes on the
    parity sweeps' 21,840 and 47,520 brackets at both types, 1.5x (f64
    cylinder) to 1.3x (f32 slab) faster than spec_shape's there, from
    timings on an H100 (`tools_torch/tune_bisect.py --numeric`, PERF.md
    section 6)."""
    shape = spec_shape(n, dtype, entry_bytes)
    if shape.levels or shape.brackets < 32:
        return shape
    return shape._replace(producers=7,
                          steps=32 if dtype == torch.float32 else 16,
                          min_blocks=0)


def analytic_spec_shape(n: int, dtype: torch.dtype, entry_bytes: int,
                        shear: bool = False) -> SpecShape:
    """The block shape of the exact exterior's speculative bisection of n
    brackets over the slab (the flux or the shear form) or the cylinder
    chain, from timings on an H100 (`tools_torch/tune_bisect.py`, then
    `--confirm`: medians of 3 rounds in turns; PERF.md section 6). Always
    7 producer warps (3 and 15 were slower on every batch) and C a whole
    number of their passes over a stage, fitted as spec_shape fits it. The
    float64 flux and cylinder chains are built at 128 registers only
    (csrc/slab_disp.cu, cylinder_disp.cu). A batch that spec_shape
    speculates on keeps its levels L and B = 32 / 2^L: slab_ph_09's f64
    refine stage (153 roots, L = 4) 1.27 ms, 3% from the fastest (4.28 at
    L = 0). A larger one keeps the loop's schedule:
      - float32: spec_shape's B (two blocks per SM), C 4 passes (28 steps
        at B = 32, 56 at 16), the budget chosen at launch (64 registers on
        these batches): within 0.3% of the fastest of 24 on slab_ph_09's
        5,040 brackets (2.51 ms), the Gaussian-flow slab's 5,600 (4.73)
        and cyl_co_09's 17,280 (17.5);
      - float64, flux and cylinder: B = 32, C = 28 at 128 registers (64
        spill the chain): the fastest on slab_ph_09 (4.09 ms; 5.55 at 64
        registers) and within 0.3% of it on cyl_co_09 (35.3);
      - float64, shear: B = 16, C = 28 at 64 registers: 8.43 ms on the
        Gaussian-flow slab, 2% from the fastest (C = 42, which fits 3
        blocks an SM, not 4) and 1.25x faster than the flux's shape: its
        heavier per-column chain pays for the spills."""
    shape = spec_shape(n, dtype, entry_bytes)
    if shape.levels:
        return shape._replace(producers=7, steps=_steps(
            shape.brackets, shape.levels, 7, shape.min_blocks, dtype,
            entry_bytes))
    if dtype == torch.float32:
        b, passes, min_blocks = shape.brackets, 4, 0
    elif shear:
        b, passes, min_blocks = 16, 2, 2
    else:
        b, passes, min_blocks = 32, 4, 1
    return SpecShape(b, 0, 7, _steps(b, 0, 7, min_blocks, dtype, entry_bytes,
                                     passes), 2, min_blocks)


class ComplexShape(NamedTuple):
    """Block shape of the complex-omega kernel (`csrc/slab_complex.cu::
    newton_kernel`: the Newton rounds and the value round); its producer
    warps are fixed by the type (COMPLEX_PRODUCERS)."""
    seeds: int       # B: seeds (candidates) a block, a power of two <= 32
    steps: int       # C: RK4 steps per ring stage
    stages: int      # S: ring stages, 1..6


# csrc/slab_complex.cu::kCxProducers: the producer warps the kernel is
# built with, at 2 blocks an SM (__launch_bounds__(32 (P + 1), 2)), which
# sets its register budget: up to 128 registers a thread at P = 7, 112 at 8
COMPLEX_PRODUCERS = {torch.float32: 8, torch.float64: 7}
# csrc/slab_complex.cu: reals a column and step in the ring (kCxValues),
# reals ahead of it (kCxHead: 32 omegas' re and im, and k), the bytes of a
# table entry (csrc/slab.cuh: ShearPoint, 3 values, in the shear form;
# FluxPoint, 5, in the flux form; 16-byte aligned) by form and dtype
_CX_VALUES = 24
_CX_HEAD = 3 * 32
_CX_ENTRY_BYTES = {(True, torch.float32): 16, (True, torch.float64): 32,
                   (False, torch.float32): 32, (False, torch.float64): 48}


def complex_smem(shape: ComplexShape, dtype: torch.dtype,
                 shear: bool = True) -> int:
    """Bytes of dynamic shared memory of a complex-omega block: the head
    and the ring of S stages of C steps x 24 values x B columns, then the
    x-only table of the shear or the flux form, 2 x 3 C entries at a
    16-byte boundary (csrc/slab_complex.cu::cx_table_offset)."""
    b, c, s = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    ring = (_CX_HEAD + s * c * _CX_VALUES * b) * itemsize
    return (-(-ring // 16) * 16
            + 2 * 3 * c * _CX_ENTRY_BYTES[(bool(shear), dtype)])


def complex_spec_shape(dtype: torch.dtype) -> ComplexShape:
    """The block shape of the complex-omega kernel, one for every batch:
    B = 32 seeds (or candidates) a block, so that the published KH sweep's
    7,200 seeds (225 blocks) are resident at once at 2 blocks an SM (a
    second wave would double the consumers' serial chains), and 2 ring
    stages of a whole pass of the producers (B C = 32 P): at float64 C = 7
    steps with P = 7 producer warps, at float32 C = 16 with P = 8. From
    timings on an H100 (PERF.md section 6) of the 216 shapes whose 2 blocks
    fit an SM (B 8-32, P 4, 6, 7, 8, C 2-32, S 2-4; `tools_torch/
    tune_bisect.py --complex` with the kernel built at those four P for
    that run, a build this tree does not hold: P is now fixed by the type
    and the tool tunes B, C and S): the fastest on the KH sweep's Newton
    launch (7,200 seeds x 30 steps with the final evaluation: 56.7 ms;
    P = 8, C = 8 63.2), 4% from the fastest on the audit's 30,720 contour
    points (3.52 ms; P = 8, C = 8 3.39) and 9% on its 7,200 roots (1.58
    ms; B = 16, C = 14 1.44); at float32 the fastest on 8,191 contour
    points (0.600 ms; P = 7, C = 7 0.686)."""
    if dtype == torch.float32:
        return ComplexShape(seeds=32, steps=16, stages=2)
    return ComplexShape(seeds=32, steps=7, stages=2)


def check_complex_shape(name: str, shape: ComplexShape, dtype: torch.dtype,
                        shear: bool = True) -> None:
    b, c, s = shape
    if not (1 <= b <= 32 and b & (b - 1) == 0 and c >= 1 and 1 <= s <= 6
            and complex_smem(shape, dtype, shear) <= MAX_SMEM):
        raise ValueError(f"{name}: unsupported block shape {shape}")


def spec_smem(shape: SpecShape, dtype: torch.dtype, entry_bytes: int) -> int:
    """Bytes of dynamic shared memory of a speculative block: 32 omegas and
    the ring of S stages of C steps x 6 coefficients x B 2^L columns, then
    the r-only table, 2 x 3 C entries at a 16-byte boundary
    (csrc/bisect.cuh::spec_table_offset)."""
    b, lv, _, c, s, _ = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    ring = (32 + s * c * 6 * (b << lv)) * itemsize
    return -(-ring // 16) * 16 + 2 * 3 * c * entry_bytes


def _check_spec_shape(name: str, shape: SpecShape, dtype: torch.dtype,
                      entry_bytes: int, evaluate: bool) -> None:
    b, lv, p, c, s, min_blocks = shape
    if not (1 <= b <= 32 and 32 % b == 0 and (lv == 0 if evaluate
                                               else 0 <= lv <= 5)
            and (b << lv) <= 32 and 1 <= p <= 15 and c >= 1 and 1 <= s <= 6
            and min_blocks in (0, 1, 2)
            and spec_smem(shape, dtype, entry_bytes) <= MAX_SMEM):
        raise ValueError(f"{name}: unsupported block shape {shape}")


def launch_spec(name: str, entries: dict, size_fn: str, struct,
                entry_bytes: int, lo: torch.Tensor, hi: Optional[torch.Tensor],
                k: torch.Tensor, mode: torch.Tensor, n_iter: int,
                final_eval: bool, shape: Optional[SpecShape] = None):
    """Check and launch a speculative fused kernel on the current stream (no
    launch for 0 brackets): with hi, the bisection of the brackets [lo, hi]
    -> (root, mismatch or None); with hi None, the evaluation of the
    candidates lo -> (det, mismatch, valid). A register budget the kernel
    is not built at (csrc/bisect.cuh::launch_spec's kNarrow) raises from
    the launch."""
    evaluate = hi is None
    if lo.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {lo.device}")
    if lo.dtype not in entries:
        raise TypeError(f"{name} kernel takes float32/float64, not {lo.dtype}")
    for arg, t in (("hi", hi), ("k", k), ("mode", mode)):
        if t is not None and (t.device != lo.device or t.dtype != lo.dtype
                              or t.shape != lo.shape):
            raise ValueError(f"{name}: {arg} must match lo in device, dtype "
                             f"and shape")
    if lo.dim() != 1 or not all(t.is_contiguous() for t in (lo, hi, k, mode)
                                if t is not None):
        raise ValueError(f"{name} kernel needs contiguous 1-D tensors")
    if n_iter < 0:
        raise ValueError(f"{name}: n_iter must be >= 0, not {n_iter}")
    n = lo.numel()
    shape = SpecShape(*(shape or spec_shape(n, lo.dtype, entry_bytes,
                                            evaluate)))
    _check_spec_shape(name, shape, lo.dtype, entry_bytes, evaluate)
    out0 = torch.empty_like(lo)
    out1 = torch.empty_like(lo) if final_eval or evaluate else None
    valid = (torch.empty(lo.shape, dtype=torch.bool, device=lo.device)
             if evaluate else None)
    if n:
        lib = _build.library()
        if getattr(lib, size_fn)() != ctypes.sizeof(struct):
            raise RuntimeError(f"{name}: parameter struct layout differs "
                               f"between Python and CUDA")
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        b, lv, p, c, s, min_blocks = shape
        ptr = [ctypes.c_void_p(None if t is None else t.data_ptr())
               for t in (lo, hi, k, mode, out0, out1, valid)]
        if evaluate:
            code = getattr(lib, entries[lo.dtype])(
                ptr[0], ptr[2], ptr[3], ptr[4], ptr[5], ptr[6], n, b, p, c, s,
                min_blocks, ctypes.byref(struct), lo.device.index,
                ctypes.c_void_p(stream))
        else:
            code = getattr(lib, entries[lo.dtype])(
                *ptr[:6], n, n_iter, int(final_eval), b, lv, p, c, s,
                min_blocks, ctypes.byref(struct), lo.device.index,
                ctypes.c_void_p(stream))
        _build.check(code, f"{name} kernel")
    return (out0, out1, valid) if evaluate else (out0, out1)


def as_pair(omega):
    """A complex tensor as a `cplx.C` (a `cplx.C` as it is)."""
    from ..cplx import C
    return omega if isinstance(omega, C) else C.of(omega)


def launch_complex(name: str, entries: dict, size_fn: str, struct, omega, k,
                   col, n_iter, damping: float, final_eval: bool,
                   shape_args: tuple, interface):
    """One launch of a complex-omega kernel (the slab's `slab_newton`
    entries, the cylinder's `cylinder_newton`) on the current stream, none
    for 0 seeds: n_iter Newton rounds (None: the evaluation mode), then
    with final_eval the value round. omega a `cplx.C` of two contiguous 1-D
    CUDA tensors of float32 or float64, k and col (the parity or m) alike;
    shape_args the kernel's launch-shape arguments after final_eval.
    Returns (the final omega, a `cplx.C`, or None; the value round's
    `interface` (det, mismatch_pct, valid) or None)."""
    from ..cplx import C
    re = omega.re
    if re.dtype not in entries:
        raise TypeError(f"{name} takes float32/float64 pairs, not {re.dtype}")
    for arg, t in (("omega.im", omega.im), ("k", k), ("the mode", col)):
        if t.device != re.device or t.dtype != re.dtype or t.shape != re.shape:
            raise ValueError(f"{name}: {arg} must match omega.re in device, "
                             f"dtype and shape")
    if re.dim() != 1 or not all(
            t.is_contiguous() for t in (re, omega.im, k, col)):
        raise ValueError(f"{name} kernel needs contiguous 1-D tensors")
    if n_iter is not None and n_iter < 0:
        raise ValueError(f"{name}: n_iter must be >= 0, not {n_iter}")
    lib = _build.library()
    if getattr(lib, size_fn)() != ctypes.sizeof(struct):
        raise RuntimeError(f"{name}: parameter struct layout differs between "
                           f"Python and CUDA")
    out = (None if n_iter is None
           else C(torch.empty_like(re), torch.empty_like(re)))
    res = (interface(det=C(torch.empty_like(re), torch.empty_like(re)),
                     mismatch_pct=torch.empty_like(re),
                     valid=torch.empty(re.shape, dtype=torch.bool,
                                       device=re.device))
           if final_eval else None)
    if re.numel():
        def ptr(t):
            return ctypes.c_void_p(None if t is None else t.data_ptr())
        o = (None, None) if out is None else (out.re, out.im)
        r = ((None,) * 4 if res is None else
             (res.det.re, res.det.im, res.mismatch_pct, res.valid))
        stream = torch.cuda.current_stream(re.device).cuda_stream
        code = getattr(lib, entries[re.dtype])(
            *map(ptr, (re, omega.im, k, col, *o)), re.numel(), *map(ptr, r),
            int(n_iter or 0), float(damping), int(final_eval), *shape_args,
            ctypes.byref(struct), re.device.index, ctypes.c_void_p(stream))
        _build.check(code, f"{name} kernel")
    return out, res
