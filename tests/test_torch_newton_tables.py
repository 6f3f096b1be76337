"""The complex-omega cylinder kernel's tables and kept chains, on the CPU
(csrc/cylinder_complex.cu::newton_kernel; its wrapper
`kernels.cylinder.cylinder_newton`):

- the launch shape: `NEWTON_SHAPE` names the block size each (type,
  chain) is built for (the source's `CxShape` defaults), its tables fit a
  block's shared memory beside the register budget's blocks, the twisted
  float64 variant keeps a budget of 255 registers, and `check_newton_shape`
  refuses another block size, an empty chunk and tables past 227 KB;
- the per-step rule by which the kernel keeps a step's first chain
  (`chain_kept`, csrc/common.cuh::chain_reuse) held against the abscissae
  that the plain version (`physics/cylinder.py::_rk4_linear2`, as the
  complex dispersion calls it) forms on each shipped complex cylinder grid
  at float32 and float64, and the shares of kept steps there.
"""
import re
from pathlib import Path

import pytest
import torch

from eigensolver_tpu_torch import cases
from eigensolver_tpu_torch.kernels import common
from eigensolver_tpu_torch.kernels import cylinder as kcyl
from eigensolver_tpu_torch.physics import cylinder as pcyl
from tools_torch import cx_cyl

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "eigensolver_tpu_torch" / "csrc" / "cylinder_complex.cu"
SMS = 132                       # SMs of an H100
SM_SMEM = 228 * 1024            # shared memory of an SM

# The shares of the steps (after the first) whose first abscissa is the
# step before's last, bit for bit, on the shipped sweeps' grids: interior
# (r from 1 to eps) and log tail (t = ln r from ln eps to ln eps_final)
KEPT_SHARES = {
    ("cx_cyl_co_09", torch.float64): (0.666, 0.756),
    ("cx_cyl_co_09", torch.float32): (0.607, 0.622),
    ("cx_twist_v01_p1", torch.float64): (0.310,),
    ("cx_twist_v01_p1", torch.float32): (0.267,),
}


def built_shapes() -> dict:
    """(threads, min_blocks) by (dtype, twisted) as the source's CxShape
    defaults give them."""
    text = SOURCE.read_text()
    out = {}
    for dtype, t in ((torch.float32, "F32"), (torch.float64, "F64")):
        for twisted, c in ((False, ""), (True, "TW_")):
            got = [int(re.search(rf"#define EIGK_CX_CYL_{c}{t}_{what} (\d+)",
                                 text).group(1))
                   for what in ("THREADS", "MIN_BLOCKS")]
            out[dtype, twisted] = tuple(got)
    return out


@pytest.mark.parametrize("twisted", [False, True], ids=["plain", "twisted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_newton_shape_fits(dtype, twisted):
    """The default shape is the one the kernel is built for, whole warps;
    its tables fit a block (227 KB) and as many blocks as its register
    budget keeps on an SM (228 KB); the wrapper's check takes it."""
    shape = kcyl.NEWTON_SHAPE[dtype, twisted]
    threads, min_blocks = built_shapes()[dtype, twisted]
    assert shape.threads == threads and threads % 32 == 0
    smem = kcyl.newton_smem(dtype, twisted, shape.chunk)
    assert smem <= common.MAX_SMEM
    assert min_blocks * (smem + 1024) <= SM_SMEM
    kcyl.check_newton_shape(shape, dtype, twisted)


def test_twisted_shape_keeps_its_registers():
    """The twisted float64 variant is built at a budget of 255 registers:
    at most 8 warps an SM (2 a sub-partition), since a ninth puts 3 on a
    sub-partition and caps a thread at 168 registers, where the nested
    duals spill; cx_twist_v01_p1's 36,000 seeds then take two waves of
    its blocks, not more."""
    case, kw = cx_cyl.configure("cx_twist_v01_p1", cases)
    n = case.n_k * (len(case.speeds) - 1) * kw["n_re"] * kw["n_im"]
    assert n == 36000
    threads, min_blocks = built_shapes()[torch.float64, True]
    assert threads * min_blocks <= 8 * 32
    resident = SMS * (8 * 32 // threads)
    assert resident < -(-n // threads) <= 2 * resident


@pytest.mark.parametrize("bad", ["threads", "chunk", "smem"])
@pytest.mark.parametrize("twisted", [False, True], ids=["plain", "twisted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_bad_newton_shape_refused(dtype, twisted, bad):
    """Another block size, an empty chunk, or tables past 227 KB raise
    before any launch."""
    shape = kcyl.NEWTON_SHAPE[dtype, twisted]
    if bad == "threads":
        shape = shape._replace(threads=shape.threads + 32)
    elif bad == "chunk":
        shape = shape._replace(chunk=0)
    else:
        per_step = kcyl.newton_smem(dtype, twisted, 1)
        shape = shape._replace(chunk=common.MAX_SMEM // per_step + 1)
        assert kcyl.newton_smem(dtype, twisted, shape.chunk) > \
            common.MAX_SMEM
    with pytest.raises(ValueError, match="cylinder_newton"):
        kcyl.check_newton_shape(shape, dtype, twisted)


def plain_abscissae(case, dtype) -> list:
    """The abscissae (n, 3) of each `_rk4_linear2` call of the plain
    complex dispersion on one seed: its own calls, with their ends and
    step counts, each run with a coefficient function that records its
    argument (the state is left as it came: the shoot's values do not
    matter here)."""
    from unittest import mock
    from eigensolver_tpu_torch.cplx import C
    calls = []
    original = pcyl._rk4_linear2

    def spy(coef, y0, x0, x1, n_steps):
        xs = []
        zero = torch.zeros((), dtype=dtype)

        def record(x):
            xs.append(x.reshape(()).clone())
            return zero, zero
        original(record, (zero,) * 4, x0, x1, n_steps)
        calls.append(torch.stack(xs).reshape(n_steps, 3))
        return y0
    ph = pcyl.CylinderPhysics.from_case(case)
    disp = ph.make_dispersion_plain(m=None, dtype=dtype)
    k = torch.tensor([float(case.k_grid()[0])], dtype=dtype)
    om = C(k * 0.9, torch.full_like(k, 0.01))
    with mock.patch.object(pcyl, "_rk4_linear2", spy):
        disp(om, k, torch.ones_like(k))
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(cx_cyl.CONFIGS))
def test_chain_kept_against_plain_abscissae(name, dtype):
    """chain_kept marks exactly the steps whose first abscissa the plain
    version forms bit-equal to the step before's last, segment by segment
    (the interior, then the log tail where the grid has one; never the
    first step of either), and the shares of kept steps are the ones
    KEPT_SHARES records, to 0.1%."""
    case, _ = cx_cyl.configure(name, cases)
    calls = plain_abscissae(case, dtype)
    kept = [s for s in kcyl.chain_kept(case, dtype) if s.numel()]
    assert len(calls) == len(kept) == len(KEPT_SHARES[name, dtype])
    it = torch.int32 if dtype == torch.float32 else torch.int64
    for xs, got, share in zip(calls, kept, KEPT_SHARES[name, dtype]):
        want = xs[1:, 0].view(it) == xs[:-1, 2].view(it)
        assert got.shape == (xs.shape[0],) and not bool(got[0])
        assert torch.equal(got[1:], want)
        assert abs(float(want.float().mean()) - share) <= 1e-3


def test_chain_kept_segments():
    """The twisted chain has no log tail; the density cylinder's tail has
    n_axis_log steps; a grid of one step keeps nothing."""
    import dataclasses
    twist, _ = cx_cyl.configure("cx_twist_v01_p1", cases)
    interior, tail = kcyl.chain_kept(twist, torch.float64)
    assert interior.numel() == twist.grid.n_interior and tail.numel() == 0
    density, _ = cx_cyl.configure("cx_cyl_co_09", cases)
    assert pcyl.log_tail(density)
    interior, tail = kcyl.chain_kept(density, torch.float64)
    assert tail.numel() == density.grid.n_axis_log
    one = dataclasses.replace(density, grid=dataclasses.replace(
        density.grid, n_interior=1, n_axis_log=1))
    assert [int(s.sum()) for s in kcyl.chain_kept(one, torch.float64)] == \
        [0, 0]


def _load(path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(Path(path).stem,
                                                  ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_table_op_counts_match_chip_smoke():
    """chip_smoke.py's tabled bounds count the chain and its (k, m, r)
    values as tools_torch/count_ops.py counts them from the plain versions;
    a step's 3 chains are most of it, its update the same in both chains,
    and the tabled count of a sweep's Newton launch below the untabled
    one."""
    count_ops = _load("tools_torch/count_ops.py")
    smoke = _load("chip_smoke.py")
    counts = count_ops.complex_cylinder_table_ops()
    assert len(counts) == 6
    assert {key: smoke.OPS[key] for key in counts} == counts
    ops = smoke.OPS
    for d in ("", "dual_"):
        updates = {f: ops[f + d + "step"] - 3 * ops[f + d + "chain"]
                   for f in ("cyl_cx_", "cyl_tw_cx_")}
        assert len(set(updates.values())) == 1
        for f in updates:
            assert 0 < ops[f + "row"] < ops[f + d + "chain"]
    for name in cx_cyl.CONFIGS:
        case, kw = cx_cyl.configure(name, cases)
        n = 600
        k = torch.tensor(case.k_grid()[:1], dtype=torch.float64).repeat(n)
        rows = smoke.block_rows(k, torch.ones_like(k), 128)
        assert rows == -(-n // 128)
        tabled = smoke.cx_cyl_ops_tabled(case, n, torch.float64, rows, True,
                                         kw["newton_iters"])
        assert 0.8 < tabled / smoke.cx_cyl_ops(case, n, True,
                                                kw["newton_iters"]) < 0.95
