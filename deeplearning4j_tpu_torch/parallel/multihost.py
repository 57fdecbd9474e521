"""Multi-process runtime — the counterpart of
``deeplearning4j_tpu/parallel/multihost.py`` over ``torch.distributed``.

One process drives one device; the processes form the default process
group, whose ranks are the mesh's devices (:mod:`.mesh`). The control
plane is ``torch.distributed``'s rendezvous; the data plane is NCCL on
the card (gloo on the host). There is no executable to cache: PyTorch
compiles nothing for a collective.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import default_device


def _init_method(address: Optional[str]) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``tcp://``,
    ``file://``, ``env://``) is taken as it is; None -> ``env://``."""
    if not address:
        return "env://"
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> bool:
    """Join the multi-process job. Arguments left None come from the
    environment as in the JAX package: ``COORDINATOR_ADDRESS`` (a
    ``host:port`` or a URL such as ``file:///path``), ``NUM_PROCESSES``
    (default 1) and ``PROCESS_ID`` (default 0). One process is a no-op
    returning False. Otherwise ``torch.distributed.init_process_group``
    runs with NCCL when ``device`` is CUDA (the default; the process
    binds ``torch.cuda.set_device`` to its local rank, ``LOCAL_RANK`` or
    its process id modulo the visible cards) and gloo when the caller
    passes ``device="cpu"``; returns True."""
    coordinator_address = coordinator_address \
        or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return False
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", "0"))
    dev = default_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend,
                            init_method=_init_method(coordinator_address),
                            world_size=num_processes, rank=process_id)
    return True


def global_device_count() -> int:
    """Devices in the job: the process group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device_count() -> int:
    """Devices this process drives: one."""
    return 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def barrier(name: str = "barrier") -> float:
    """Host-level barrier: an all-reduce of a one over every rank, on the
    card under NCCL. Blocks until every process takes part and returns
    the sum, the device count, as a float (as the JAX package's psum
    barrier does). ``name`` labels the call in a profiler trace."""
    if not dist.is_initialized():
        return 1.0
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    x = torch.ones(1, device=dev)
    with torch.profiler.record_function(f"multihost.barrier.{name}"):
        dist.all_reduce(x)
    return float(x.item())
