"""Process-group start-up for data-parallel fits.

Counterpart of ``gsmvi_tpu/parallel/distributed.py``.  JAX runs one
process per host that sees many devices; torch runs one process per
device, a rank of a ``torch.distributed`` process group.  So
``initialize_distributed`` wraps ``torch.distributed.init_process_group``:
JAX's ``coordinator_address`` is the group's ``init_method`` (a
``tcp://host:port`` or ``file:///path`` URL), ``num_processes`` its
``world_size`` and ``process_id`` this process's ``rank``.  The backend is
NCCL where a CUDA card is present and gloo otherwise, unless ``backend=``
says which.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

# torchrun's environment (``auto=True``).
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend() -> str:
    """NCCL on a machine with a CUDA card, gloo on the CPU."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           auto: bool = False, **init_kwargs) -> bool:
    """Start this process's rank of the process group; True when the group
    has more than one rank.

    Explicit arguments (any of the three not None, judged by ``is not
    None``: an empty address is explicit) start the group with
    ``init_method=coordinator_address``, ``world_size=num_processes`` and
    ``rank=process_id``, and a failure raises: a misconfigured cluster
    must not fall back to a single-process fit.  ``auto=True`` reads
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``; with NCCL the card is ``LOCAL_RANK``'s) and returns
    False when it is absent or the start fails, since auto mode
    legitimately runs single-process.  With neither, nothing starts and it
    returns False.  A second call, once the group is up, is a no-op.

    ``init_kwargs`` pass through to ``init_process_group`` (``backend``,
    ``timeout``, ``store``, ...)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = (coordinator_address is not None
                or num_processes is not None or process_id is not None)
    if not (auto or explicit):
        return False
    backend = init_kwargs.pop("backend", None) or default_backend()
    if explicit:
        dist.init_process_group(
            backend, init_method=coordinator_address,
            world_size=-1 if num_processes is None else int(num_processes),
            rank=-1 if process_id is None else int(process_id),
            **init_kwargs)
        return dist.get_world_size() > 1
    if any(k not in os.environ for k in _TORCHRUN_ENV):
        return False
    try:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, init_method="env://", **init_kwargs)
    except (RuntimeError, ValueError):
        return False
    return dist.get_world_size() > 1


def launch(fn: Callable, nprocs: int, *args,
           timeout: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes of this
    machine, ranks 0 .. nprocs - 1, and wait for them (at most ``timeout``
    seconds).  ``fn`` starts its own rank of the group
    (``initialize_distributed``), so ``args`` carry the group's address,
    e.g. a ``file://`` URL.  Raises if a process failed or the time ran
    out; every process has ended when this returns or raises."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    done = False
    try:
        while not done:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise TimeoutError(f"{nprocs} ranks did not finish in "
                                   f"{timeout} s")
            done = ctx.join(timeout=left)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
