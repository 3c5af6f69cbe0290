"""Multi-process start-up: one process a rank, every rank running the
same program.

Counterpart of the JAX package's parallel/multihost.py. There
jax.distributed forms the global device set and every host calls the
same jitted program (multi-controller mode); here torch.distributed
forms the process group, one process drives one card (NCCL) or one CPU
(gloo), and every rank calls the same entry points with the same
arguments: the sharded modules' collectives are issued in the same order
on each rank. A ("dp", "tp") DeviceMesh over all ranks keeps tp inside a
host (consecutive ranks), so its collectives stay on NVLink and only dp
crosses hosts.
"""
from __future__ import annotations

import ctypes
import datetime
import os
import signal
import subprocess
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from asr2pass_tpu_torch.parallel.sharding import axis_size, make_mesh

_TIMEOUT_S: Optional[float] = None


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: str = "cuda", timeout_s: float = 300.0
                     ) -> bool:
    """Join the process group from the arguments or the environment
    (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID, as the JAX
    package reads them). Returns False, and does nothing, when no
    coordinator is named (one process). The coordinator is a
    "host:port" (a TCP rendezvous at rank 0) or an init_method URL
    ("tcp://...", "file://..."). The backend is NCCL for device "cuda"
    (each process then takes the card of its local rank,
    LOCAL_RANK or the rank modulo the visible cards) and gloo for
    "cpu". A collective that does not complete within timeout_s raises
    an error on its ranks."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator is None:
        return False
    num_processes = int(num_processes
                        or os.environ.get("NUM_PROCESSES", "1"))
    process_id = int(process_id if process_id is not None
                     else os.environ.get("PROCESS_ID", "0"))
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') without a "
                               "CUDA device; pass device='cpu' for gloo")
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group for device {device!r}")
    dist.init_process_group(
        backend, init_method=coordinator, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    global _TIMEOUT_S
    _TIMEOUT_S = float(timeout_s)
    return True


def group_timeout_s() -> Optional[float]:
    """The timeout_s this process joined its group with (None before
    init_distributed)."""
    return _TIMEOUT_S


def _die_with_parent():
    # Linux's PR_SET_PDEATHSIG (1): SIGTERM when the starting thread ends
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGTERM, 0, 0, 0)


def start_local_ranks(argv: Callable[[int], Sequence[str]], world: int,
                      env: Optional[dict] = None
                      ) -> List[subprocess.Popen]:
    """Start ranks 1..world-1 of this host as child processes, rank r
    running argv(r); this process is rank 0. Each child gets SIGTERM when
    the thread that started it ends, so no rank outlives its rank 0:
    start them from the main thread. Returns the handles, rank order."""
    return [subprocess.Popen(list(argv(r)), env=env,
                             preexec_fn=_die_with_parent)
            for r in range(1, world)]


def make_global_mesh(tp: Optional[int] = None):
    """("dp", "tp") DeviceMesh over every rank, tp over consecutive ranks
    (sharding.make_mesh, whose default tp it takes), which must lie
    within a host: tp divides the ranks of a host (LOCAL_WORLD_SIZE,
    default all)."""
    mesh = make_mesh(tp=tp)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    tp = axis_size(mesh, "tp")
    if local % tp:
        raise ValueError(f"tp={tp} does not divide the {local} ranks of a "
                         "host")
    return mesh


def local_batch_slice(global_batch: int) -> slice:
    """Which rows of the global batch this process owns (for data
    loading): the rank's equal share, in rank order."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch // n
    return slice(per * rank, per * rank + per)
