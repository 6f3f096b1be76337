"""The complex-omega slab kernels' launch shapes, routing, kept chains and
operation counts, on the CPU (csrc/slab_complex.cu; the wrappers
`kernels.slab.slab_newton` and `slab_disp_complex`):

- the flux form's kernel of one thread a seed (`flux_kernel`): its launch
  shape `common.FLUX_NEWTON_SHAPE` is the one the source builds
  (`FluxShape`, the EIGK_CX_SLAB_* macros), its table fits a block's
  shared memory beside the blocks its register budget keeps on an SM, the
  Python byte count equals the source's, and `kernels.slab.flux_attrs`
  refuses a build of another shape;
- `_launch_complex` sends a flux-form case to the flux kernel's entry,
  with no shape argument, and a shear-form case to the producer/consumer
  kernel's with its block shape, and refuses a bad shape, or any shape for
  the flux form, before any launch;
- the rule by which the flux kernel keeps a step's first chain
  (`flux_chain_kept`, csrc/common.cuh::chain_reuse(n_steps)) against the
  abscissae the plain version (`physics/slab.py::_rk4_linear`) forms on
  cx_ph_09's grid, at a quarter of its depth and at a depth that is not a
  power of two, at float32 and float64;
- `tools_torch/count_ops.py`'s count of the flux kernel's update equal to
  `chip_smoke.py::OPS`, and `chip_smoke.cx_flux_kernel_ops` (the kernel's
  own count) equal to the bound's `cx_variant_ops` but for its tables;
- the rule by which csrc/complex.cuh::fast_div keeps a complex divisor's
  ratio off the slow path of division, mirrored here in float64, equal to
  IEEE division bit for bit on tiny, subnormal and zero numerators and on
  quotients at a midpoint of the subnormal grid; on the card (`gpu`) the
  device's fast_div itself on the same operands, against the device's
  division and numpy's.
"""
import dataclasses
import re
from pathlib import Path
from unittest import mock

import pytest
import torch

from eigensolver_tpu_torch import cases
from eigensolver_tpu_torch.cplx import C
from eigensolver_tpu_torch.kernels import common
from eigensolver_tpu_torch.kernels import slab as kslab
from eigensolver_tpu_torch.physics import slab as pslab
from tools_torch import cx_slab

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "eigensolver_tpu_torch" / "csrc" / "slab_complex.cu"
SM_SMEM = 228 * 1024            # shared memory of an H100 SM
SM_REGISTERS = 65536
DTYPES = [torch.float32, torch.float64]


def _load(path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(Path(path).stem,
                                                  ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def built_shape(dtype) -> common.FluxNewtonShape:
    """The flux kernel's shape as the source's FluxShape defaults give
    it."""
    text = SOURCE.read_text()
    t = "F32" if dtype == torch.float32 else "F64"

    def macro(what):
        return int(re.search(rf"#define EIGK_CX_SLAB_{t}_{what} (\d+)",
                             text).group(1))
    return common.FluxNewtonShape(threads=macro("THREADS"),
                                  chunk=macro("CHUNK"),
                                  min_blocks=macro("MIN_BLOCKS"))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_flux_shape_fits(dtype):
    """The default shape is the one the kernel is built for, whole warps;
    its table fits a block (227 KB) and as many blocks as its register
    budget keeps on an SM (228 KB), each block's registers within the
    SM's."""
    shape = common.FLUX_NEWTON_SHAPE[dtype]
    assert shape == built_shape(dtype)
    assert shape.threads % 32 == 0 and shape.min_blocks >= 1
    assert shape.chunk >= 1
    smem = common.flux_newton_smem(dtype, shape.chunk)
    assert smem <= common.MAX_SMEM
    assert shape.min_blocks * (smem + 1024) <= SM_SMEM
    assert shape.min_blocks * shape.threads * 32 <= SM_REGISTERS


@pytest.mark.parametrize("chunk", [1, 7, 32, 64])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_flux_smem_equals_source(dtype, chunk):
    """common.flux_newton_smem gives the bytes of the source's flux_smem
    at a chunk of FluxShape: 2 buffers of 3 chunk FluxPoint entries (5
    values, 16-byte aligned)."""
    body = re.search(r"size_t flux_smem\(\) \{\s*return (.*?);",
                     SOURCE.read_text(), re.S).group(1)
    item = torch.empty((), dtype=dtype).element_size()
    entry = -(-5 * item // 16) * 16
    expr = re.sub(r"static_cast<size_t>\(([\w<>:]+)\)", r"\1", body)
    expr = expr.replace("FluxShape<T>::chunk", "chunk").replace(
        "sizeof(FluxPoint<T>)", str(entry))
    assert eval(" ".join(expr.split()), {}, {"chunk": chunk}) == \
        common.flux_newton_smem(dtype, chunk)


class _FakeLib:
    """The flux entries of a library built at `shape` (attributes: 154
    registers, no spill, min_blocks blocks an SM)."""

    def __init__(self, dtype, shape):
        self.dtype, self.shape = dtype, shape

    def eigk_slab_newton_flux_attrs(self, f64, numeric, out):
        assert f64 == int(self.dtype == torch.float64)
        out[:6] = [154, 0, self.shape.min_blocks, self.shape.threads,
                   self.shape.min_blocks, self.shape.chunk]
        return 0

    def eigk_slab_newton_flux_smem(self, f64):
        return common.flux_newton_smem(self.dtype, self.shape.chunk)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_flux_attrs_holds_build_to_mirror(dtype):
    """flux_attrs reads the shape the library was built at and its table's
    bytes, and takes them where they are FLUX_NEWTON_SHAPE's; a build at
    another chunk, block or register budget is refused."""
    shape = common.FLUX_NEWTON_SHAPE[dtype]
    with mock.patch.object(kslab._build, "library",
                           lambda: _FakeLib(dtype, shape)):
        got = kslab.flux_attrs(dtype, True)
    assert got == dict(registers=154, local_bytes=0,
                       blocks_per_sm=shape.min_blocks, **shape._asdict(),
                       smem=common.flux_newton_smem(dtype, shape.chunk))
    for other in (shape._replace(chunk=shape.chunk // 2),
                  shape._replace(threads=shape.threads + 32),
                  shape._replace(min_blocks=shape.min_blocks + 1)):
        with mock.patch.object(kslab._build, "library",
                               lambda o=other: _FakeLib(dtype, o)):
            with pytest.raises(RuntimeError, match="FLUX_NEWTON_SHAPE"):
                kslab.flux_attrs(dtype, False)


def _case(name="cx_ph_09", **grid):
    case, kw = cx_slab.configure(name, cases)
    if grid:
        case = dataclasses.replace(case, grid=dataclasses.replace(
            case.grid, **grid))
    return case, kw


def _routed(case, dtype, shape=None):
    """(entries, shape arguments) of the launch `_launch_complex` makes for
    the case, the C entry's launch replaced by a recorder."""
    seen = {}

    def record(name, entries, size_fn, struct, omega, k, col, n_iter,
               damping, final_eval, shape_args, interface):
        seen.update(entries=entries, shape_args=shape_args)
        return None, None
    params = kslab.disp_params(case, True)
    om = C(torch.ones(3, dtype=dtype), torch.zeros(3, dtype=dtype))
    k = torch.ones(3, dtype=dtype)
    with mock.patch.object(kslab, "launch_complex", record):
        kslab._launch_complex("slab_newton", om, k, k, params, 2, 1.0, True,
                              shape)
    return seen["entries"], seen["shape_args"]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(cx_slab.CONFIGS))
def test_launch_routes_by_form(name, dtype):
    """A flux-form case (the density slab, either exterior) goes to the
    flux kernel's entry with no shape argument (its build fixes it); a
    shear-form case (the KH slab) to the producer/consumer kernel's with
    its block shape; the launch counters count the flux form's and the
    numeric exterior's launches as before."""
    case, _ = _case(name)
    shear = pslab.SlabPhysics.from_case(case).has_flow
    numeric = case.grid.exterior_method == "numeric"
    before = (kslab.complex_flux_launches, kslab.complex_numeric_launches)
    entries, args = _routed(case, dtype)
    if shear:
        assert entries is kslab._NEWTON_ENTRY
        assert args == tuple(common.complex_spec_shape(dtype))
    else:
        assert entries is kslab._FLUX_NEWTON_ENTRY
        assert args == ()
    assert (kslab.complex_flux_launches - before[0],
            kslab.complex_numeric_launches - before[1]) == \
        (int(not shear), int(numeric))


@pytest.mark.parametrize("bad", ["threads", "min_blocks", "chunk", "smem",
                                 "shear_seeds"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_bad_shape_refused(dtype, bad):
    """A shape given for the flux form, which its build fixes (another
    block size, register budget, chunk, a table past 227 KB, as the
    default's own), or a shear-form block of seeds that is not a power of
    two raise before any launch."""
    if bad == "shear_seeds":
        case, _ = _case("kh_w1e5_num")
        shape = common.complex_spec_shape(dtype)._replace(seeds=3)
    else:
        case, _ = _case()
        shape = common.FLUX_NEWTON_SHAPE[dtype]
        if bad == "threads":
            shape = shape._replace(threads=shape.threads + 32)
        elif bad == "min_blocks":
            shape = shape._replace(min_blocks=shape.min_blocks + 1)
        elif bad == "chunk":
            shape = shape._replace(chunk=0)
        else:
            per_step = common.flux_newton_smem(dtype, 1)
            shape = shape._replace(chunk=common.MAX_SMEM // per_step + 1)
    with pytest.raises(ValueError, match="slab_newton"):
        _routed(case, dtype, shape)
    if bad != "shear_seeds":
        with pytest.raises(ValueError, match="built in"):
            _routed(case, dtype, common.FLUX_NEWTON_SHAPE[dtype])


def plain_abscissae(case, dtype) -> torch.Tensor:
    """The abscissae (n, 3) of the interior shoot of the plain complex
    dispersion on one seed: its _rk4_linear call run with a coefficient
    function that records its argument (the shoot's values do not matter
    here)."""
    xs = []
    original = pslab._rk4_linear

    def spy(apply, coef, y0, x0, x1, n_steps):
        zero = torch.zeros((), dtype=dtype)

        def record(x):
            xs.append(torch.as_tensor(x).reshape(()).clone())
            return (zero, zero)
        original(lambda c, y: y, record, (zero, zero), x0, x1, n_steps)
        return y0
    ph = pslab.SlabPhysics.from_case(case)
    disp = ph.make_dispersion_plain(parity=None, dtype=dtype)
    k = torch.tensor([float(case.k_grid()[0])], dtype=dtype)
    om = C(k * 0.9, torch.full_like(k, 0.01))
    with mock.patch.object(pslab, "_rk4_linear", spy):
        disp(om, k, torch.ones_like(k))
    return torch.stack(xs).reshape(case.grid.n_interior, 3)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("n_interior", [2048, 512, 250])
def test_chain_kept_against_plain_abscissae(n_interior, dtype):
    """flux_chain_kept keeps a step's first chain only where the plain
    version forms its first abscissa bit-equal to the step before's last;
    on cx_ph_09's grid (2048 steps) and at a quarter of its depth (512)
    that is every step but the first, at 250 steps none (every step forms
    3 chains)."""
    case, _ = _case(n_interior=n_interior)
    xs = plain_abscissae(case, dtype)
    kept = kslab.flux_chain_kept(n_interior)
    it = torch.int32 if dtype == torch.float32 else torch.int64
    same = torch.cat([torch.zeros(1, dtype=torch.bool),
                      xs[1:, 0].view(it) == xs[:-1, 2].view(it)])
    assert kept.shape == (n_interior,) and not bool(kept[0])
    assert not bool((kept & ~same).any())
    if n_interior & (n_interior - 1) == 0:
        assert bool(same[1:].all()) and torch.equal(kept, same)
    else:
        assert not bool(kept.any())


def test_flux_kernel_op_counts():
    """count_ops' traced update of the flux kernel's step is OPS's, the
    step less its 3 chains; the kernel's own count of a shoot equals the
    bound's count (cx_variant_ops) at a power-of-two depth and at another,
    both exteriors, both passes, and its tables add the x-only values once
    per block and shoot, a small share at the main path's size."""
    count_ops = _load("tools_torch/count_ops.py")
    smoke = _load("chip_smoke.py")
    ops = smoke.OPS
    counts = count_ops.complex_flux_kernel_ops()
    assert len(counts) == 2
    assert {key: ops[key] for key in counts} == counts
    for d in ("", "dual_"):
        f = "slab_cx_flux_" + d
        assert ops[f + "update"] == ops[f + "step"] - 3 * ops[f + "chain"]
    for name in ("cx_ph_09", "cx_ph_09_num"):
        for n_interior in (2048, 250):
            case, kw = _case(name, n_interior=n_interior)
            n, n_iter = 37_800, kw["newton_iters"]
            for dual, it in ((True, n_iter), (False, 1)):
                assert smoke.cx_flux_kernel_ops(case, n, dual, it) == \
                    smoke.cx_variant_ops(case, n, dual, it)
            threads = common.FLUX_NEWTON_SHAPE[torch.float64].threads
            own = smoke.cx_flux_kernel_ops(case, n, True, n_iter, threads)
            bound = smoke.cx_variant_ops(case, n, True, n_iter)
            assert bound < own < 1.01 * bound


def _fast_div(num: float, den: float) -> float:
    """csrc/complex.cuh::fast_div at float64, step by step (the exact
    remainder fma(-q, den, num 2^600) as a fraction)."""
    import math
    from fractions import Fraction
    import numpy as np
    num, den = np.float64(num), np.float64(den)
    with np.errstate(all="ignore"):
        if not abs(num) < 2.0 ** -900:
            return num / den
        if num == 0:
            if den != 0 and den == den:
                return np.float64(-0.0 if math.copysign(1, num)
                                  * math.copysign(1, den) < 0 else 0.0)
            return num / den
        nn = num * np.float64(2.0 ** 600)
        q = nn / den
        aq = abs(q)
        if not 2.0 ** -700 <= aq < math.inf:
            return num / den
        if aq >= 2.0 ** -422:
            return q * np.float64(2.0 ** -600)
        s = aq * np.float64(2.0 ** 474)
        k = np.floor(s)
        if s - k != 0.5:
            return q * np.float64(2.0 ** -600)
        rem = Fraction(float(nn)) - Fraction(float(q)) * Fraction(float(den))
        if rem == 0:
            return q * np.float64(2.0 ** -600)
        up = ((rem > 0) == (den > 0)) == (q > 0)
        mag = (k + 1 if up else k) * np.float64(2.0 ** -1074)
        return -mag if q < 0 else mag


def _div_pairs(n: int = 6000) -> list:
    """Float64 operand pairs (num, den) for fast_div: n tiny numerators
    over ordinary divisors (normal and subnormal quotients), n / 3
    numerators whose quotient lies within an ulp of a midpoint of the
    subnormal grid, over divisors of either sign, and the special values
    (zeros of either sign, the smallest subnormal, 1e-300, 1e-310,
    ordinary numbers) over each other and inf."""
    import numpy as np
    rng = np.random.default_rng(18)
    num = rng.uniform(-1, 1, n) * 2.0 ** rng.integers(-1080, -880, n)
    den = rng.uniform(-1, 1, n) * 2.0 ** rng.integers(-5, 6, n)
    # numerators whose quotient by mid_den lies within an ulp of (k + 1/2)
    # 2^-1074, a midpoint of the subnormal grid (formed where every factor
    # is normal, so that only the product rounds)
    k = rng.integers(1, 2 ** 20, n // 3)
    mid_den = rng.uniform(1, 2, n // 3) * 2.0 ** rng.integers(40, 61, n // 3)
    mids = ((k + 0.5) * 2.0 ** -474 * mid_den) * 2.0 ** -600
    specials = [0.0, -0.0, 5e-324, -5e-324, 1e-300, 1e-310, 1.0, -3.0]
    return [*zip(num, den), *zip(mids, mid_den), *zip(mids, -mid_den),
            *((a, b) for a in specials for b in specials + [np.inf])]


def test_fast_div_rule_is_exact():
    """fast_div's rule gives the bits of IEEE division on tiny numerators
    (normal and subnormal quotients), zeros of either sign over divisors
    of either sign, quotients built onto a midpoint of the subnormal grid
    (whose side only the remainder decides), and ordinary operands."""
    import numpy as np
    n = 6000
    hits = ties = 0
    for a, b in _div_pairs(n):
        got = _fast_div(a, b)
        with np.errstate(all="ignore"):
            want = np.float64(a) / np.float64(b)
            q = np.float64(a) * 2.0 ** 600 / np.float64(b)
            s = abs(q) * 2.0 ** 474
        assert np.isnan(got) == np.isnan(want) and (
            np.isnan(want) or got.view(np.int64) == want.view(np.int64)), \
            (a, b, got, want)
        hits += 0 < abs(want) < 2.2250738585072014e-308
        ties += bool(abs(q) < 2.0 ** -422 and s - np.floor(s) == 0.5)
    assert hits > n // 3 and ties > n // 20


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_fast_div_device_bits():
    """On the card, complex.cuh::fast_div itself (eigk_fast_div_f64) gives
    the bits of the device's division on every operand pair of the rule's
    test, the midpoints of the subnormal grid included, and both give
    numpy's IEEE quotient (NaN where it is NaN)."""
    import ctypes
    import numpy as np
    from eigensolver_tpu_torch.kernels import _build
    num, den = (np.array(v, dtype=np.float64) for v in zip(*_div_pairs()))
    a = torch.from_numpy(num).cuda()
    b = torch.from_numpy(den).cuda()
    fast, plain = torch.empty_like(a), torch.empty_like(a)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _build.check(_build.library().eigk_fast_div_f64(
        ptr(a), ptr(b), ptr(fast), ptr(plain), a.numel(), a.device.index,
        ctypes.c_void_p(stream)), "fast_div")
    torch.cuda.synchronize()
    with np.errstate(all="ignore"):
        want = num / den
    for got in (fast.cpu().numpy(), plain.cpu().numpy()):
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan)
        assert np.array_equal(got[~nan].view(np.int64),
                              want[~nan].view(np.int64))
