"""The sharded sweep of the port (eigensolver_tpu_torch/parallel.py) on the
CPU: `run_case_sharded` over `make_mesh(8, "cpu")` gives `run_case`'s root
set bit for bit (the 5 x 3 rows of tests/test_parallel.py's small case at a
reduced depth; 9 rows over 8 devices, which pads; refine_f64; a reduced
parity configuration with its masks and fuzz records); at float64 it gives
the JAX package's `run_case_sharded` on conftest's 8 virtual devices, to
tests/test_torch_sweep.py's tolerance; two processes joined by
`init_distributed` (gloo) each hold the one-process root set; the
`dryrun_multichip` twin; on the card, one process over [cuda:0, cuda:0].
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from eigensolver_tpu_torch import cases  # noqa: E402
from eigensolver_tpu_torch.parallel import (dryrun_multichip,  # noqa: E402
                                            make_mesh, run_case_sharded)
from eigensolver_tpu_torch.search import SearchConfig  # noqa: E402
from eigensolver_tpu_torch.sweep import run_case  # noqa: E402

CFG = SearchConfig(n_omega=48, n_bisect=12)


def small_case(n_k=5, n_interior=32):
    """tests/test_parallel.py's small case at a reduced depth: 5 k x 3
    bands of slab_density_photospheric(1e5), both parities."""
    c = cases.slab_density_photospheric(width=1e5)
    return dataclasses.replace(
        c, n_k=n_k, k_min=1.0, k_max=3.0, speeds=(0.95, 1.05, 1.15, 1.29),
        grid=dataclasses.replace(c.grid, n_interior=n_interior))


def assert_same(got, want):
    (rs, st), (rs1, st1) = got, want
    assert rs.counts() == rs1.counts() and sum(rs.counts().values()) > 0
    assert st.n_candidates == st1.n_candidates
    for b in rs1.branches:
        np.testing.assert_array_equal(rs[b].omegas, rs1[b].omegas)
        np.testing.assert_array_equal(rs[b].ks, rs1[b].ks)


@pytest.mark.parametrize("n_k", [5, 3], ids=["5x3_rows", "9_rows_padded"])
def test_sharded_equals_run_case(n_k):
    case = small_case(n_k)
    assert_same(run_case_sharded(case, make_mesh(8, "cpu"), CFG,
                                 device="cpu"),
                run_case(case, CFG, device="cpu"))


def test_sharded_refine_f64_equals_run_case():
    case = small_case()
    cfg = dataclasses.replace(CFG, scan_dtype="float32",
                              polish_dtype="float32")
    assert_same(run_case_sharded(case, make_mesh(8, "cpu"), cfg,
                                 refine_f64=True, device="cpu"),
                run_case(case, cfg, refine_f64=True, device="cpu"))


def test_sharded_parity_configuration_equals_run_case():
    """slab_ph_09's parity configuration (tools_torch/parity.py: the
    numeric exterior, the genuine continua masked, fuzz acceptance; 13
    bands) at 2 k, reduced, over 3 devices: 26 rows, one padded."""
    from tools_torch import parity
    from eigensolver_tpu_torch import equilibrium
    case, cfg, _ = parity.configure("slab_ph_09", cases, SearchConfig,
                                    equilibrium.genuine_continua)
    case = dataclasses.replace(case, k_values=(0.5, 2.0),
                               grid=dataclasses.replace(
                                   case.grid, n_interior=32, n_exterior=32))
    cfg = dataclasses.replace(cfg, n_omega=32, n_bisect=10)
    assert cfg.exclude_v_ranges and cfg.fuzz_accept_pct
    got = run_case_sharded(case, make_mesh(3, "cpu"), cfg, device="cpu")
    assert_same(got, run_case(case, cfg, device="cpu"))


def test_sharded_equals_jax_sharded():
    """At float64 the JAX package's run_case_sharded on its 8 virtual CPU
    devices: the same counts, roots to rtol 1e-12."""
    import jax
    from eigensolver_tpu import cases as jcases
    from eigensolver_tpu.parallel import (make_mesh as jmesh,
                                          run_case_sharded as jsharded)
    from eigensolver_tpu.search import SearchConfig as JConfig
    from eigensolver_tpu_torch import config
    assert len(jax.devices()) == 8
    jc = jcases.slab_density_photospheric(width=1e5)
    jc = dataclasses.replace(
        jc, n_k=5, k_min=1.0, k_max=3.0, speeds=(0.95, 1.05, 1.15, 1.29),
        grid=dataclasses.replace(jc.grid, n_interior=32))
    want, _ = jsharded(jc, jmesh(8), JConfig(n_omega=48, n_bisect=12))
    got, _ = run_case_sharded(config.from_jax(jc), make_mesh(8, "cpu"), CFG,
                              device="cpu")
    assert got.counts() == want.counts() and sum(got.counts().values())
    for b in want.branches:
        np.testing.assert_allclose(got[b].omegas, want[b].omegas, rtol=1e-12)
        np.testing.assert_array_equal(got[b].ks, want[b].ks)


WORKER = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
from eigensolver_tpu_torch.parallel import (init_distributed, make_mesh,
                                            run_case_sharded,
                                            shutdown_distributed)
from eigensolver_tpu_torch.search import SearchConfig
from test_torch_parallel import small_case
import torch.distributed as dist
assert init_distributed(), "env not set"
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
rs, st = run_case_sharded(small_case(), make_mesh(2, "cpu"),
                          SearchConfig(n_omega=48, n_bisect=12),
                          device="cpu")
shutdown_distributed()
assert not dist.is_initialized()
out = {b: [br.omegas.tolist(), br.ks.tolist()] for b, br in rs.branches.items()}
print("RESULT " + json.dumps([st.n_candidates, out]), flush=True)
assert "jax" not in sys.modules
'''


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_processes_hold_the_one_process_root_set():
    """Two processes joined by init_distributed (the EIGENSOLVER_*
    variables, gloo), each over 2 CPU "devices" (4 global blocks): both
    hold the same root set, run_case's."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, EIGENSOLVER_COORDINATOR=f"127.0.0.1:{port}",
                   EIGENSOLVER_NUM_PROCESSES="2",
                   EIGENSOLVER_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(ROOT), str(ROOT / "tests")],
            env=env, cwd=str(ROOT / "tests"), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            assert line, out + err[-2000:]
            outs.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert outs[0] == outs[1]
    rs, st = run_case(small_case(), CFG, device="cpu")
    n_cand, branches = outs[0]
    assert n_cand == st.n_candidates
    assert {b: len(v[0]) for b, v in branches.items()} == rs.counts()
    for b, (oms, ks) in branches.items():
        np.testing.assert_array_equal(np.asarray(oms), rs[b].omegas)
        np.testing.assert_array_equal(np.asarray(ks), rs[b].ks)


def test_dryrun_multichip_cpu(capsys):
    n = dryrun_multichip(8, device="cpu")
    assert "8 devices, 16 sharded rows" in capsys.readouterr().out
    assert n > 0


def test_make_mesh():
    assert make_mesh(8, "cpu") == [torch.device("cpu")] * 8
    assert make_mesh(device="cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(2)
    with pytest.raises(ValueError, match="complex omega"):
        run_case_sharded(cases.slab_flow_complex_coronal(), device="cpu")


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_two_blocks_on_one_card_equal_run_case():
    """One process over [cuda:0, cuda:0]: the two blocks' launches on the
    one card, the root set run_case's, at float32 (and refined) and
    float64, the slab and the cylinder."""
    from eigensolver_tpu_torch.kernels import launch_counts
    mesh = [torch.device("cuda", 0)] * 2
    cyl = cases.cylinder_density_coronal(0.9)
    cyl = dataclasses.replace(cyl, n_k=6, grid=dataclasses.replace(
        cyl.grid, n_interior=256, n_axis_log=32))
    for case in (cases.slab_density_photospheric(0.9), cyl):
        for dt, refine in (("float32", False), ("float32", True),
                           ("float64", False)):
            cfg = SearchConfig(n_omega=64, n_bisect=18, scan_dtype=dt,
                               polish_dtype=dt)
            before = launch_counts()
            got = run_case_sharded(case, mesh, cfg, refine_f64=refine)
            n = {k: v - before[k] for k, v in launch_counts().items()}
            assert_same(got, run_case(case, cfg, refine_f64=refine,
                                      device="cuda"))
            scan = "slab_disp" if case is not cyl else "cylinder_disp"
            assert n[scan] == 2 + refine
