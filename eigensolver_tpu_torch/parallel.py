"""Multi-device and multi-process sharding of a sweep's ladder rows (port of
`eigensolver_tpu.parallel`).

The reference's only parallelism is one OS process per (k, speed-band) cell
with `multiprocessing.Queue` collection (SURVEY.md P1/P2). The JAX package
shards the fused ladder rows over a `jax.sharding.Mesh` and lets XLA SPMD
run the row-local scan, bracketing and bisection with no communication,
then gathers the candidate roots to the host once. Here a mesh is a list
of torch devices (`make_mesh`) and the sweep is `sweep.sweep_blocks`, whose
one-block case is `sweep.run_case`: the (omega, k) rows are cut into one
contiguous block per device (padded with NaN ladders), each device scans
and polishes its block for every mode (so that a slab's block keeps the
paired scan, which needs a row's parity-0 and parity-1 copies in one
batch), every device's launches are issued before any result is read
back, and the accepted entries are finalized on the host in `run_case`'s
order: the same root set as `sweep.run_case` on one device, bit for bit.

Multi-process: `init_distributed` joins a `torch.distributed` group (gloo);
each process runs its part of the global mesh (every process passes a mesh
of the same length) and one all-gather hands every process every device's
host arrays, so that each holds the full root set.
"""
from __future__ import annotations

import atexit
import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from .config import CaseConfig
from .roots import RootSet
from .search import SearchConfig, polish_rows, scan_rows
from .sweep import SweepStats, make_dispersion, sweep_blocks


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join a multi-process sweep: call once per process before
    `run_case_sharded`. The arguments default to the
    `EIGENSOLVER_COORDINATOR` ("host:port" of rank 0's rendezvous),
    `EIGENSOLVER_NUM_PROCESSES` and `EIGENSOLVER_PROCESS_ID` environment
    variables (eigensolver_tpu/parallel.py:31-67). Returns False when none
    of coordinator and process count is given (a one-process run), True
    once the group is up; the group is destroyed at exit
    (`shutdown_distributed`). Nothing on the machine tells a program of a
    cluster, so all three must be given.

    The group's backend is gloo, not NCCL: the one collective of a sweep
    is the all-gather of each device's accepted roots, a few hundred host
    values that `finalize_collected` reads on the host anyway (JAX's
    `process_allgather`, parallel.py:139-146), and gloo also runs where
    NCCL refuses: two processes on one card, and processes on the CPU.

    `make_mesh` takes every card that the process sees, so on a host with
    several cards the launcher gives each process its own cards
    (CUDA_VISIBLE_DEVICES): processes that see the same cards run their
    blocks on the same cards, with the same roots but no gain."""
    import torch.distributed as dist
    coordinator = coordinator or os.environ.get("EIGENSOLVER_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("EIGENSOLVER_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("EIGENSOLVER_PROCESS_ID")
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator, the process count and "
            "this process's id (EIGENSOLVER_COORDINATOR, "
            "EIGENSOLVER_NUM_PROCESSES, EIGENSOLVER_PROCESS_ID)")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    atexit.register(shutdown_distributed)
    return True


def shutdown_distributed() -> None:
    """Destroy the process group of `init_distributed`, if there is one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def _rank_world() -> tuple:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(n_devices: Optional[int] = None,
              device="cuda") -> List[torch.device]:
    """The devices of a sharded sweep: every visible card, or the first
    n_devices; with device "cpu", n_devices (default 1) entries of the CPU
    (the stand-in for a multi-card mesh in the tests). No card is an
    error, never a CPU mesh. A list such as [cuda:0, cuda:0] is a mesh as
    well: one card then runs each block in turn. With several processes
    each process's mesh is the cards it sees (see `init_distributed`)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    if dev.type != "cuda":
        raise ValueError(f"make_mesh: unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device here "
                           "(torch.cuda.is_available() is false)")
    count = torch.cuda.device_count()
    n = n_devices or count
    if n > count:
        raise ValueError(f"make_mesh: {n} devices asked, {count} visible")
    return [torch.device("cuda", i) for i in range(n)]


def gather_blocks(local: list) -> list:
    """Every process's list of per-block results, in rank order, as one
    list: one all-gather over the group of `init_distributed`."""
    import torch.distributed as dist
    parts: list = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (dist.get_rank(), len(local), local))
    if len({n for _, n, _ in parts}) != 1:
        raise ValueError("run_case_sharded: every process must pass a mesh "
                         "of the same length")
    return [r for _, _, loc in sorted(parts, key=lambda p: p[0])
            for r in loc]


def run_case_sharded(case: CaseConfig, mesh: Optional[Sequence] = None,
                     search: Optional[SearchConfig] = None, modes=None,
                     refine_f64: bool = False, *, device="cuda"
                     ) -> tuple[RootSet, SweepStats]:
    """`sweep.run_case` with the (omega, k) rows of the ladder grid split
    over the devices of `mesh` (default `make_mesh(device=device)`) and,
    after `init_distributed`, over the processes: the same RootSet, bit
    for bit (eigensolver_tpu/parallel.py:70-153). It is
    `sweep.sweep_blocks` with one block a device of the global mesh: each
    device sweeps its block for every mode (a slab's two parities through
    the paired scan), every device's launches go out before any result is
    read back, and the accepted entries are gathered to the host (across
    processes by one all-gather) and finalized there, in `run_case`'s
    order."""
    mesh = [torch.device(d) for d in
            (mesh if mesh is not None else make_mesh(device=device))]
    rank, world = _rank_world()
    return sweep_blocks(case, mesh, search, modes, refine_f64=refine_f64,
                        rank=rank, world=world)


def dryrun_multichip(n_devices: int, device="cuda") -> int:
    """The sharded search step at tiny shapes over n_devices mesh entries
    (the twin of the root `__graft_entry__.dryrun_multichip`):
    slab_density_photospheric(0.9) at n_interior=64, sausage, float32, 2
    rows a device of 32-point ladders at k = 1.5, 8 brackets a row. On
    "cuda" the entries take the visible cards in turn (8 entries on one
    card are 8 blocks on it); with no card that is an error. Prints one
    line and returns the accepted roots' count."""
    from . import cases
    dev = torch.device(device)
    if dev.type == "cuda":
        count = len(make_mesh(device=dev))
        mesh = [torch.device("cuda", i % count) for i in range(n_devices)]
    else:
        mesh = make_mesh(n_devices, dev)
    case = cases.slab_density_photospheric(width=0.9)
    case = dataclasses.replace(
        case, grid=dataclasses.replace(case.grid, n_interior=64))
    cfg = SearchConfig(n_omega=32, n_bisect=8, max_brackets_per_row=8,
                       scan_dtype="float32", polish_dtype="float32")
    disp = make_dispersion(case, 0, torch.float32)
    rows = 2 * n_devices
    ladder = np.linspace(0.9, 1.28, cfg.n_omega, dtype=np.float32)
    scanned = []
    for dev in mesh:
        ks = torch.full((2,), 1.5, dtype=torch.float32, device=dev)
        omegas = torch.from_numpy(np.stack([ladder * np.float32(1.5)] * 2)
                                  ).to(dev)
        scanned.append(scan_rows(disp, omegas, ks, cfg))
    polished = [polish_rows(disp, sc, cfg) for sc in scanned]
    n_entries = sum(pr.omega.numel() for pr in polished)
    if n_entries != rows * cfg.max_brackets_per_row:
        raise AssertionError(f"dryrun_multichip: {n_entries} entries")
    n_found = sum(int(pr.mask.sum()) for pr in polished)
    print(f"dryrun_multichip: {n_devices} devices, {rows} sharded rows, "
          f"{n_found} bracketed roots - OK")
    return n_found
