"""Multi-device sharding: block-parallel codec execution over a device mesh.

Counterpart of ``bitar_tpu/parallel/sharding.py``.  The reference's only
parallelism is data-parallel block streams (``demo_app.cc:577-596``,
``driver.cc:100-158``); the JAX package lifts it to a ``jax.sharding.Mesh``
whose *blocks* axis shards a batch of independent blocks across chips.
Here the same layout uses PyTorch's idiom: one process (rank) per device,
``torch.distributed`` for the collectives, and a
``torch.distributed.device_mesh.DeviceMesh`` with one *blocks* axis over
the initialized default group.  JAX's global sharded arrays become per-rank
tensors: every function here takes this rank's local shard and returns this
rank's rows.

Backends are explicit (``multihost.initialize``): NCCL on CUDA devices,
gloo on the CPU, or gloo on CUDA devices when the caller asks for it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.cpu.native import SEQUENCE_KEYS
from ..ops.decode_tables import decode_blocks, pad_tables
from ..status import Status, StatusError

BLOCKS_AXIS = "blocks"
_TABLE_KEYS = SEQUENCE_KEYS
LANES = 128


def make_mesh(num_devices: int | None = None, axis: str | None = None, config=None, *,
              device_type: str | None = None) -> DeviceMesh:
    """A 1-D mesh over ranks ``0..num_devices-1`` of the initialized default
    group (default: all ranks), one device per rank.

    ``config`` (a :class:`~bitar_tpu_torch.config.ShardingConfig`) supplies
    the axis name and an optional ``mesh_shape`` whose product selects the
    device count; explicit arguments win.  ``device_type`` defaults to
    "cuda", whatever the backend (a gloo group over CUDA devices decodes on
    the card); CPU callers pass "cpu".  Every rank of the world calls it.
    Raises StatusError(Invalid) when more devices are asked for than there
    are ranks, when no process group is initialized, or when the mesh is
    "cuda" and CUDA is not available."""
    if config is not None:
        if axis is None:
            axis = config.data_axis
        if num_devices is None and config.mesh_shape:
            num_devices = int(np.prod(config.mesh_shape))
    if axis is None:
        axis = BLOCKS_AXIS
    if not dist.is_initialized():
        raise StatusError(Status.Invalid(
            "make_mesh: no process group; call parallel.multihost.initialize first"))
    world = dist.get_world_size()
    if num_devices is None:
        num_devices = world
    if not 1 <= num_devices <= world:
        raise StatusError(Status.Invalid(
            f"requested {num_devices} devices, only {world} ranks joined"))
    if device_type is None:
        device_type = "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise StatusError(Status.Invalid(
            "make_mesh(device_type='cuda'): torch.cuda.is_available() is false; "
            "pass device_type='cpu' for a CPU mesh"))
    return DeviceMesh(device_type, torch.arange(num_devices), mesh_dim_names=(axis,))


def mesh_group(mesh: DeviceMesh):
    """The mesh's process group (its one axis)."""
    return mesh.get_group(mesh.mesh_dim_names[0])


def mesh_rank(mesh: DeviceMesh) -> int:
    """This rank's index on the mesh's axis."""
    return mesh.get_local_rank(mesh.mesh_dim_names[0])


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank decodes on: on a "cuda" mesh the card its
    process group is bound to (``multihost.initialize`` binds an NCCL group
    to the rank's card), else its current CUDA device; the CPU otherwise.
    The bound card does not depend on the calling thread's current device."""
    if mesh.device_type == "cuda":
        bound = dist.group.WORLD.bound_device_id
        return bound if bound is not None else torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_blocks(mesh: DeviceMesh, *arrays, device=None):
    """This rank's contiguous slice of each array's leading (block) axis, as
    a tensor on ``device`` (default: :func:`mesh_device`).  The leading dims
    must divide evenly (:func:`pad_block_count`).  A device tensor bound
    for the CPU is refused, not moved: no shard leaves the card to be
    decoded by a plain version."""
    d, me = mesh.size(), mesh_rank(mesh)
    device = torch.device(mesh_device(mesh) if device is None else device)
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor) and a.device.type != "cpu" and device.type == "cpu":
            raise StatusError(Status.Invalid(
                f"shard_blocks: a {a.device.type} tensor bound for a CPU mesh; "
                "make the mesh with device_type='cuda'"))
        n = a.shape[0]
        if n % d:
            raise StatusError(Status.Invalid(
                f"leading dim {n} does not divide over {d} devices; pad it first"))
        per = n // d
        t = a[me * per:(me + 1) * per]
        t = torch.as_tensor(np.ascontiguousarray(t)) if isinstance(t, np.ndarray) else t
        out.append(t.contiguous().to(device))
    return tuple(out)


def sharded_decode(comp, nseq, lit_ptr, lit_len, off, mlen, out_pos, *,
                   mesh: DeviceMesh, out_rows: int, block_size: int) -> torch.Tensor:
    """Decode this rank's shard of a block batch (kernel B2 on CUDA, its
    plain version on the CPU).  No communication: blocks are independent.

    ``comp``: [nb, slot] uint8 rows; the rest [nb] / [nb, S] int32, all on
    one device (:func:`shard_blocks` of :func:`prepare_sharded_batch`'s
    arrays).  Returns [nb, block_size] uint8."""
    del mesh                      # each rank decodes what it holds
    tables = dict(zip(_TABLE_KEYS, (lit_ptr, lit_len, off, mlen, out_pos), strict=True))
    planes = decode_blocks(comp, nseq, tables, out_rows=out_rows)
    return planes.reshape(planes.shape[0], -1)[:, :block_size]


def pad_block_count(n: int, num_devices: int) -> int:
    """Blocks per batch must divide evenly across the mesh; pad with idle
    blocks (nseq=0) to the next multiple."""
    return -(-n // num_devices) * num_devices


def prepare_sharded_batch(comps: list[np.ndarray], tables: list[dict[str, np.ndarray]],
                          block_size: int, slot_size: int, num_devices: int):
    """Host-side batch prep: uint8 slot rows (the port's B2 reads them as
    they are; no int32 planes, no guard rows) and padded tables, block count
    padded to the mesh width.  Returns (arrays dict, real_n, meta)."""
    real_n = len(comps)
    n = pad_block_count(real_n, num_devices)
    t, nseq = pad_tables(tables, _TABLE_KEYS)
    seq_cap = t["lit_ptr"].shape[1]
    rows = np.zeros((n, slot_size), dtype=np.uint8)
    for i, c in enumerate(comps):
        rows[i, :c.shape[0]] = c
    full = {
        "comp": rows,
        "nseq": np.zeros(n, np.int32),
        **{k: np.zeros((n, seq_cap), np.int32) for k in _TABLE_KEYS},
    }
    full["nseq"][:real_n] = nseq
    for k in _TABLE_KEYS:
        full[k][:real_n] = t[k]
    meta = dict(seq_cap=seq_cap, out_rows=-(-block_size // LANES), block_size=block_size)
    return full, real_n, meta
