"""Multi-process data parallelism over torch.distributed (port of
sdm_tpu/parallel/multihost.py).

One process per device. `maybe_initialize` joins the process group that a
launcher describes; `spawn` starts the N processes of a one-command run
(--num-devices N) on one machine and joins each to a group of its own.
The backend is NCCL on CUDA and gloo when the caller asked for the CPU.

Launch contract, as in sdm_tpu (any one of):
  - explicit: env SDM_COORDINATOR_ADDRESS (host:port), SDM_NUM_PROCESSES
    and SDM_PROCESS_ID, used verbatim (rank 0 listens on that address);
  - config "multihost": true with no SDM_* env: torch's env:// (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT and LOCAL_RANK, as torchrun sets
    them), the counterpart of the argless jax.distributed.initialize();
  - one command: `spawn(fn, n, device)` (the trainers' and the
    distiller's --num-devices N > 1), a group rendezvousing through a file.

On CUDA each rank makes its own card current (`torch.cuda.set_device`)
before anything launches. The group has a timeout (TIMEOUT), so the peers
of a rank that died raise instead of waiting in a collective forever.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist

# Peers of a rank that died raise after this long in a collective. A
# checkpoint with a preview on rank 0 must finish well within it.
TIMEOUT = datetime.timedelta(minutes=10)


def world() -> int:
    """The process group's size, 1 outside of one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def _local_rank(global_rank: int) -> int:
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return int(local)
    return global_rank % max(torch.cuda.device_count(), 1)


def init_group(device, *, init_method: str, world_size: int,
               global_rank: int) -> None:
    """Join a group: NCCL on CUDA (this rank's card made current first),
    gloo on the CPU. A failed init raises; nothing falls back."""
    dev = torch.device(device)
    kwargs = {}
    if dev.type == "cuda":
        local = _local_rank(global_rank)
        if local >= torch.cuda.device_count():
            raise ValueError(
                f"rank {global_rank} needs CUDA device {local}; "
                f"{torch.cuda.device_count()} are visible")
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world_size,
                            rank=global_rank, timeout=TIMEOUT, **kwargs)


def wants_multihost(config_dict: Optional[dict] = None) -> bool:
    """Config "multihost": true, or the explicit SDM_* launch."""
    return (bool((config_dict or {}).get("multihost", False))
            or bool(os.environ.get("SDM_COORDINATOR_ADDRESS")))


def maybe_initialize(config_dict: Optional[dict] = None,
                     device="cuda") -> bool:
    """Join the group a multi-host launch describes, if asked. Returns True
    when running multi-process. Safe to call more than once: a group that
    exists is kept."""
    if dist.is_initialized() or not wants_multihost(config_dict):
        return world() > 1
    explicit = os.environ.get("SDM_COORDINATOR_ADDRESS")
    if explicit:
        init_group(device, init_method=f"tcp://{explicit}",
                   world_size=int(os.environ["SDM_NUM_PROCESSES"]),
                   global_rank=int(os.environ["SDM_PROCESS_ID"]))
    else:
        init_group(device, init_method="env://",
                   world_size=int(os.environ["WORLD_SIZE"]),
                   global_rank=int(os.environ["RANK"]))
    return world() > 1


def shard_indices(n: int, *, drop_remainder: bool = True,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None):
    """This process's dataset indices: strided split, truncated so every
    process sees the same count (the ranks run their steps in lockstep)."""
    pc = world() if num_processes is None else num_processes
    pi = rank() if process_id is None else process_id
    if pc == 1:
        return list(range(n))
    per = n // pc
    if per == 0:
        raise ValueError(f"dataset of {n} items cannot feed {pc} processes")
    idx = list(range(pi, n, pc))
    return idx[:per] if drop_remainder else idx


def replicate(tensors) -> None:
    """Every rank's `tensors` (an iterable) set to rank 0's, in place."""
    if world() > 1:
        for t in tensors:
            dist.broadcast(t.data, src=0)


def barrier(tag: str = "sdm") -> None:
    """Block until every process reaches this point."""
    if world() > 1:
        dist.barrier()


def build_kernels_once(device) -> None:
    """On CUDA in a group of several ranks: rank 0 builds every missing
    kernel library while the others wait, so the ranks of a first run do
    not all run nvcc on the same sources (and write the same build log)."""
    if torch.device(device).type != "cuda" or world() == 1:
        return
    if rank() == 0:
        from sdm_tpu_torch.kernels import _build
        _build.build()
    barrier("kernel-build")


def _spawned(local_rank: int, n: int, init_file: str, device: str,
             threads: int, fn: Callable, args: tuple, result_dir: str):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(threads)
    init_group(device, init_method=f"file://{init_file}", world_size=n,
               global_rank=local_rank)
    try:
        result = fn(*args)
        if local_rank == 0:
            torch.save(result, os.path.join(result_dir, "result.pt"))
        barrier("spawn-end")
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, device, *args):
    """Run `fn(*args)` in `n` new processes on this machine, rank r on CUDA
    device r (or the CPU, its threads split between the ranks), each in
    one group of n. SIGTERM and SIGINT sent to this process are passed on
    to the ranks (whose trainers checkpoint and stop together). Returns
    rank 0's result (torch.save-able); raises when any rank fails, after
    the others were stopped."""
    import signal
    import threading

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="sdm_spawn_") as tmp:
        threads = max(1, torch.get_num_threads() // n)
        ctx = mp.start_processes(
            _spawned, args=(n, os.path.join(tmp, "rendezvous"), str(device),
                            threads, fn, args, tmp),
            nprocs=n, join=False, start_method="spawn")

        def forward(signum, frame):
            for p in ctx.processes:
                if p.is_alive():
                    os.kill(p.pid, signum)

        prev = {}
        if threading.current_thread() is threading.main_thread():
            for s in (signal.SIGTERM, signal.SIGINT):
                prev[s] = signal.signal(s, forward)
        try:
            while not ctx.join():
                pass
        finally:
            for s, handler in prev.items():
                signal.signal(s, handler)
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)
