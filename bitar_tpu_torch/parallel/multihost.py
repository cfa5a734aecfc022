"""Multi-process topology.

Counterpart of ``bitar_tpu/parallel/multihost.py``.  The reference is
strictly single-process (survey §2); the JAX package runs one process per
host joined by ``jax.distributed``.  The port runs one process per device
(PyTorch's idiom), joined by ``torch.distributed``: the mesh spans all
ranks, and block batches are partitioned by process before the shuffle.

A launcher (``torchrun`` or one process per device started by hand) passes
the coordinator; in tests and single-process runs nothing is joined and the
topology degrades to one process.
"""

from __future__ import annotations

import ctypes
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..status import Status, StatusError
from ..utils.logging import get_logger

logger = get_logger("parallel.multihost")


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               timeout: float | None = None) -> dict:
    """Join the multi-process job (idempotent); returns :func:`describe`.

    ``coordinator_address`` is an ``init_method`` URL (``tcp://host:port``,
    ``file:///path``); without it the environment's ``MASTER_ADDR`` /
    ``MASTER_PORT`` are used (``env://``), and ``num_processes`` /
    ``process_id`` default to ``WORLD_SIZE`` / ``RANK``.  A single process
    given neither a coordinator nor a world size joins nothing, as in the
    JAX package.  ``backend`` is explicit: "nccl" (CUDA devices, the
    default when CUDA is present) or "gloo" (the CPU, or CUDA devices when
    asked for).  ``timeout`` (seconds; torch's default when None) bounds the
    rendezvous and every later collective of the group.

    Returns only once every rank has joined: a barrier ends the join, so no
    rank leaves (and closes its connections) while a peer is still
    connecting to it; without it gloo's ``connectFullMesh`` fails on the
    slower rank with "Connection closed by peer"."""
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if not dist.is_initialized() and (coordinator_address is not None
                                      or num_processes not in (None, 1)):
        if process_id is None:
            process_id = int(os.environ.get("RANK", "0"))
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend not in ("nccl", "gloo"):
            raise StatusError(Status.Invalid(f"backend {backend!r} not in (nccl, gloo)"))
        kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise StatusError(Status.Invalid(
                    "backend 'nccl' needs a CUDA device; torch.cuda.is_available() is false"))
            # One rank a card: the card is set before the group exists, and
            # device_id binds the communicator to it.
            local = process_id % torch.cuda.device_count()
            torch.cuda.set_device(local)
            kw["device_id"] = torch.device("cuda", local)
        dist.init_process_group(backend, init_method=coordinator_address or "env://",
                                world_size=num_processes or 1, rank=process_id, **kw)
        dist.barrier()
    topo = describe()
    logger.info("multihost topology: %s", topo)
    return topo


def cuda_contexts() -> list[int]:
    """The CUDA devices on which this process holds an active primary
    context (the CUDA driver's ``cuDevicePrimaryCtxGetState``, which creates
    none).  A rank of an NCCL world holds one, on its own card; [] without
    the CUDA driver."""
    try:
        cu = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return []
    count = ctypes.c_int()
    if cu.cuInit(0) != 0 or cu.cuDeviceGetCount(ctypes.byref(count)) != 0:
        return []
    active = []
    for i in range(count.value):
        dev, flags, on = ctypes.c_int(), ctypes.c_uint(), ctypes.c_int()
        if (cu.cuDeviceGet(ctypes.byref(dev), i) == 0
                and cu.cuDevicePrimaryCtxGetState(dev, ctypes.byref(flags),
                                                  ctypes.byref(on)) == 0 and on.value):
            active.append(i)
    return active


def describe() -> dict:
    """This process's place in the job: rank, world size, its local CUDA
    devices and the global device count.  With one rank per device,
    ``process_count == global_device_count``."""
    joined = dist.is_initialized()
    count = dist.get_world_size() if joined else 1
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": count,
        "backend": dist.get_backend() if joined else None,
        "local_device_count": torch.cuda.device_count(),
        "global_device_count": count,
    }


def partition_blocks(nblocks: int, process_count: int | None = None,
                     process_index: int | None = None) -> tuple[int, int]:
    """[start, stop) of the block range this process stages.

    Host-level split preceding the device-level shuffle: each process
    ingests and compresses its contiguous share, then the mesh-wide
    all-to-all redistributes compressed blocks."""
    pc = process_count if process_count is not None else describe()["process_count"]
    pi = process_index if process_index is not None else describe()["process_index"]
    if not (0 <= pi < pc):
        raise StatusError(Status.Invalid(f"process {pi} outside [0, {pc})"))
    per = -(-nblocks // pc)
    return min(pi * per, nblocks), min((pi + 1) * per, nblocks)


def process_spans(nblocks: int, process_count: int | None = None) -> np.ndarray:
    """All processes' [start, stop) spans as an [pc, 2] array."""
    pc = process_count if process_count is not None else describe()["process_count"]
    return np.array([partition_blocks(nblocks, pc, i) for i in range(pc)], dtype=np.int64)
