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
producer warps read the r-only values, and the (k, m, r) values of up to
BISECT_ROWS rows of their block's brackets, from tables as the scan does,
keep a step's first chain where its abscissa is the step before's last,
and integrate the numeric exterior beside the consumer's interior, its
exps from a table of the block's k (`bisect_counts`); a small batch
speculates several levels a round.

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
as the parameters pick. Its blocks read the r-only values, and the (k, m,
r) values of their first and last seeds' rows, from tables in shared
memory, as the scan does, and keep a step's first chain where its abscissa
is the step before's last (`chain_kept`); each (type, chain) is built at
one launch shape (`NEWTON_SHAPE`; `newton_counts` reads what the launches
tabled and kept).

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
                     launch_disp, launch_spec, profile_params,
                     spec_shape)

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
    rho, flow = density_flow_params(case)
    zero_flow = (case.flow_profile.kind == ProfileKind.UNIFORM
                 and rg.U_i0 == rg.U_e == 0.0)
    twisted = is_twisted(case)
    uniform = ProfileConfig(kind=ProfileKind.UNIFORM)
    tp = case.twist_profile or uniform
    bp = case.b_twist_profile if twisted and case.b_twist_profile else uniform
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
# the density/axial-flow bisection's tables per abscissa of a stage
# (csrc/bisect.cuh::spec_smem over SpecChain): the r-only entry, the
# entries of its BISECT_ROWS rows (RowPoint<T>) and, with the numeric
# exterior, an exp of each of its rows' k; by (dtype, numeric exterior)
BISECT_ROWS = 4
_BISECT_ENTRY_BYTES = {
    (dtype, numeric): _ENTRY_BYTES[dtype, False]
    + BISECT_ROWS * (4 * size + (size if numeric else 0))
    for dtype, size in ((torch.float32, 4), (torch.float64, 8))
    for numeric in (False, True)}


def bisect_entry_bytes(dtype: torch.dtype, twisted: bool,
                       numeric: bool) -> int:
    """Bytes per abscissa of a stage of the fused bisection's tables
    (`common.spec_smem`'s entry_bytes): the twisted chain's r-only entry,
    or the density/axial-flow chain's entry, rows and exps."""
    if twisted:
        return _ENTRY_BYTES[dtype, True]
    return _BISECT_ENTRY_BYTES[dtype, bool(numeric)]


# The numeric exterior's density/axial-flow bisection at the loop's
# schedule (L = 0): (P producer warps, C steps a stage) by type, at 128
# registers a thread
_NUMERIC_BISECT = {torch.float32: (4, 24), torch.float64: (4, 16)}


def numeric_bisect_shape(n: int, dtype: torch.dtype) -> SpecShape:
    """The block shape of the numeric exterior's density/axial-flow
    bisection of n brackets (its producers' row, exps' and kept-chain
    tables): `common.spec_shape`'s L and B; at the loop's schedule 4
    producer warps, C = 24 steps a stage at float32 (16 at float64) at 128
    registers a thread (64 spill the chain: at float64 1.5x slower), the
    fastest of 150 shapes on cyl_flow_1 parity's 47,520 brackets at both
    types (31.5 ms; float64 58.5); where spec_shape speculates, 7 producer
    warps and C = 32: 4% from the fastest of 750 shapes on those brackets'
    first 600 at float32 (2.19 ms), the fastest at float64 (3.57 ms). From
    timings on an H100 (`tools_torch/tune_bisect.py --numeric`, PERF.md
    section 6)."""
    shape = spec_shape(n, dtype, _BISECT_ENTRY_BYTES[dtype, True])
    if shape.levels:
        return shape._replace(producers=7, steps=32)
    p, c = _NUMERIC_BISECT[dtype]
    return shape._replace(producers=p, steps=c, min_blocks=1)


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
# The complex-omega kernel's table entries by (dtype, twisted chain): the
# r-only entry (RPoint<T>, RPointTw<T>) and a row's entry (RowPoint<T>, 4
# values; RowPointTw<T>, 12 duals and a value), 16-byte aligned
# (csrc/cylinder_complex.cu::tab_smem: 2 x 3 chunk x (entry + 2 rows))
_NEWTON_ENTRY_BYTES = {(torch.float32, False): 48 + 2 * 16,
                       (torch.float64, False): 80 + 2 * 32,
                       (torch.float32, True): 96 + 2 * 112,
                       (torch.float64, True): 176 + 2 * 208}
# The complex-omega kernel's launch shape by (dtype, twisted chain; the
# numeric exterior's variant shares its chain's): threads a block, which
# the kernel is built for (csrc/cylinder_complex.cu::CxShape, with its
# register budget), and the table's chunk of RK4 steps. The fastest, or
# within 1.5% of it, of 12 (threads, budget, chunk) shapes timed in 3
# rounds on an H100 (`tools_torch/tune_disp.py --kernel cylinder_newton`,
# PERF.md section 6): cx_cyl_co_09's Newton launch 733.8 ms at float64
# (128:2:32 768.9), cx_twist_v01_p1's 670.1 (one wave at 192:2:16 675.6)
NEWTON_SHAPE = {(torch.float32, False): ScanShape(128, 32),
                (torch.float64, False): ScanShape(128, 32),
                (torch.float32, True): ScanShape(192, 32),
                (torch.float64, True): ScanShape(64, 16)}


def newton_smem(dtype: torch.dtype, twisted: bool, chunk: int) -> int:
    """Bytes of the complex-omega kernel's tables in a block's shared
    memory at `chunk` steps."""
    return 2 * 3 * chunk * _NEWTON_ENTRY_BYTES[dtype, bool(twisted)]


def check_newton_shape(shape: ScanShape, dtype: torch.dtype,
                       twisted: bool) -> None:
    """Raise unless the complex-omega kernel of (dtype, chain) is built
    for `shape.threads` (NEWTON_SHAPE's) and its tables at `shape.chunk`
    steps fit a block's shared memory."""
    check_scan_shape("cylinder_newton", shape,
                     (NEWTON_SHAPE[dtype, bool(twisted)].threads,),
                     _NEWTON_ENTRY_BYTES[dtype, bool(twisted)])


def newton_attrs(dtype: torch.dtype, twisted: bool, numeric: bool,
                 chunk: int = None) -> dict:
    """The complex-omega kernel's variant as the card runs it: registers,
    local (spill) bytes a thread, blocks an SM with its tables at `chunk`
    steps (default NEWTON_SHAPE's), and the shape it is built for; raises
    unless the tables take the bytes that newton_smem gives."""
    from . import _build
    chunk = chunk or NEWTON_SHAPE[dtype, bool(twisted)].chunk
    lib = _build.library()
    f64 = int(dtype == torch.float64)
    got = lib.eigk_cylinder_newton_smem(f64, int(twisted), chunk)
    if got != newton_smem(dtype, twisted, chunk):
        raise RuntimeError(f"cylinder_newton: the tables take {got} B in "
                           f"CUDA, not what _NEWTON_ENTRY_BYTES gives")
    out = (ctypes.c_int * 5)()
    _build.check(lib.eigk_cylinder_newton_attrs(f64, int(twisted),
                                                int(numeric), chunk, out),
                 "cylinder_newton attributes")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2],
                threads=out[3], min_blocks=out[4], chunk=chunk, smem=got)


def newton_counts(device) -> dict:
    """What the complex-omega launches on the CUDA `device` did since the
    last call: the seeds that read a tabled row (`rows`), those whose
    numeric exterior read the tabled exps (`exterior`), each launch's
    first Newton or value round counted; and, summed over the launches,
    the steps of a shoot (`steps`) and those whose first chain it kept
    (`kept`). Zeroes them; waits for the device's work."""
    from . import _build
    out = (ctypes.c_ulonglong * 4)()
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    _build.check(_build.library().eigk_cylinder_newton_counts(index, out),
                 "cylinder_newton counts")
    return dict(rows=int(out[0]), exterior=int(out[1]), kept=int(out[2]),
                steps=int(out[3]))


def chain_kept(case: CaseConfig, dtype: torch.dtype, device="cpu") -> tuple:
    """Per RK4 step of the complex-omega kernel's shoot, whether its first
    abscissa is the step before's last, bit for bit, so that the kernel
    keeps the chain it formed there (csrc/common.cuh::chain_reuse, on the
    grid as csrc/cylinder.cuh::Grid forms it): bool tensors (interior,
    log tail; the tail empty without one), the first step of each False
    (the join is not crossed). On a CUDA `device` the logs are the card's."""
    from ..physics.cylinder import log_tail
    from ..profiles import div
    gr = case.grid
    it = torch.int32 if dtype == torch.float32 else torch.int64

    def segment(x0, x1, n):
        h = div(x1 - x0, n)
        i = torch.arange(1, n, dtype=dtype, device=device)
        a = x0 + i * h
        b = (x0 + (i - 1) * h) + h
        kept = a.view(it) == b.view(it)
        return torch.cat([torch.zeros(min(n, 1), dtype=torch.bool,
                                      device=device), kept])

    def t(x):
        return torch.tensor(x, dtype=dtype, device=device)
    interior = segment(t(1.0), t(gr.axis_epsilon), gr.n_interior)
    tail = (segment(torch.log(t(gr.axis_epsilon)),
                    torch.log(t(gr.axis_epsilon_final)), gr.n_axis_log)
            if log_tail(case) else torch.zeros(0, dtype=torch.bool,
                                                device=device))
    return interior, tail


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


def bisect_counts(device) -> dict:
    """What the density/axial-flow fused bisections on the CUDA `device`
    did since the last call: the columns (brackets, 2^L a bracket where it
    speculates) that read their block's row table (`rows`: every column of
    a block whose brackets form at most BISECT_ROWS runs of one (k, m),
    such as rows of 8 or 24 brackets, or of a block's length or more) and
    those whose numeric exterior read the tabled exps (`exterior`); and,
    summed over the launches, block 0's steps in its first round
    (`steps`) and those whose first chain a producer kept (`kept`; see
    `bisect_chain_kept`). Zeroes them; waits for the device's work."""
    from . import _build
    out = (ctypes.c_ulonglong * 4)()
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    _build.check(_build.library().eigk_cylinder_bisect_counts(index, out),
                 "cylinder_bisect counts")
    return dict(rows=int(out[0]), exterior=int(out[1]), kept=int(out[2]),
                steps=int(out[3]))


def bisect_tabled_columns(k: torch.Tensor, m: torch.Tensor, shape) -> int:
    """The columns of one launch of the density/axial-flow fused bisection
    at block shape `shape` on brackets of the (k, m) columns `k`, `m` that
    read their block's row table (`bisect_counts`' `rows`): 2^L for each
    bracket of every block whose B brackets form at most BISECT_ROWS runs
    of one (k, m), compared bit for bit (csrc/bisect.cuh::find_rows)."""
    b, lv = shape[0], shape[1]
    n = k.numel()
    if n == 0:
        return 0
    it = torch.int32 if k.dtype == torch.float32 else torch.int64
    kb, mb = k.contiguous().view(it), m.contiguous().view(it)
    at = torch.arange(n, device=k.device)
    start = torch.zeros(n, dtype=torch.bool, device=k.device)
    start[1:] = (kb[1:] != kb[:-1]) | (mb[1:] != mb[:-1])
    block = at // b
    runs = 1 + torch.bincount(block, weights=(start & (at % b != 0)).double())
    size = torch.bincount(block)
    return int(size[runs <= BISECT_ROWS].sum()) << lv


def bisect_chain_kept(case: CaseConfig, dtype: torch.dtype, shape,
                      device="cpu") -> int:
    """The steps of one shoot of the density/axial-flow fused bisection
    at block shape `shape` whose first chain a producer keeps: a producer
    row group of the 32 P / (B 2^L) takes a run of ceil(C / groups)
    consecutive steps of a stage (csrc/bisect.cuh::spec_kernel) and keeps
    a step's first chain from the step before's where `chain_kept` says
    their abscissae have the same bits, except at its run's first step."""
    b, lv, p, c, _, _ = shape
    groups = 32 * p // (b << lv)
    spg = -(-c // groups)
    kept = torch.cat(chain_kept(case, dtype, device)).cpu()
    offset = torch.arange(kept.numel()) % c
    return int((kept & (offset % spg != 0)).sum())


def _check_bisect_smem(shape: SpecShape, dtype: torch.dtype,
                       numeric: bool) -> None:
    """Raise unless the density/axial-flow bisection's shared memory at
    `shape` is what `common.spec_smem` gives with _BISECT_ENTRY_BYTES
    (csrc/bisect.cuh::spec_smem)."""
    from . import _build
    from .common import spec_smem
    b, lv, _, c, s, _ = shape
    got = _build.library().eigk_cylinder_bisect_smem(
        int(dtype == torch.float64), int(numeric), b << lv, c, s)
    want = spec_smem(shape, dtype, _BISECT_ENTRY_BYTES[dtype, numeric])
    if got != want:
        raise RuntimeError(f"cylinder_bisect: its tables take {got} B in "
                           f"CUDA, not the {want} of _BISECT_ENTRY_BYTES")


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
    `numeric_bisect_shape`, for the twisted chain
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
    numeric = bool(params.struct.exterior_numeric)
    eb = bisect_entry_bytes(lo.dtype, twisted, numeric)
    if twisted:
        out = launch_spec("cylinder_bisect", _SPEC_ENTRY,
                          "eigk_cylinder_params_size", params.struct, eb, lo,
                          hi, k, m, n_iter, final_eval, shape)
    else:
        shape = SpecShape(*(shape or (
            numeric_bisect_shape(lo.numel(), lo.dtype) if numeric
            else analytic_spec_shape(lo.numel(), lo.dtype, eb))))
        if lo.is_cuda and lo.numel():
            _check_bisect_smem(shape, lo.dtype, numeric)
        out = launch_spec("cylinder_bisect", _BISECT_SPEC_ENTRY,
                          "eigk_cylinder_params_size", params.struct, eb, lo,
                          hi, k, m, n_iter, final_eval, shape)
    bisect_launches += lo.numel() > 0
    return out


# -- complex omega ----------------------------------------------------------

def _launch_complex(name: str, omega, k, m, params: DispParams, n_iter,
                    damping: float, final_eval: bool):
    """One launch of the complex-omega kernel (`common.launch_complex`) in
    the case's chain and exterior, at NEWTON_SHAPE's launch shape."""
    global complex_twisted_launches, complex_numeric_launches
    from ..physics.cylinder import CylinderInterface
    twisted = bool(params.struct.twisted)
    shape = NEWTON_SHAPE.get((omega.re.dtype, twisted))
    if shape is not None:
        check_newton_shape(shape, omega.re.dtype, twisted)
    out = launch_complex(name, _NEWTON_ENTRY, "eigk_cylinder_params_size",
                         params.struct, omega, k, m, n_iter, damping,
                         final_eval, tuple(shape or ()), CylinderInterface)
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
