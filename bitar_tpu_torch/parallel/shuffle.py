"""Distributed compressed-block shuffle with skew handling.

Counterpart of ``bitar_tpu/parallel/shuffle.py``: compressed blocks are
hash-partitioned across devices and exchanged with one all-to-all, so the
decode runs where the data is wanted (the reference's BASELINE config 5).
``hash_partition``, ``ShufflePlan`` and ``plan_shuffle`` are numpy copies of
the JAX package's (its plans and these are the same arrays);
``execute_shuffle`` is ``dist.all_to_all_single`` over the staged rows.

Skew handling: slots are fixed-size, so wire cost per block is uniform, but
naive hash partitioning still skews block *counts* per destination.
``plan_shuffle`` balances counts: the per-destination surplus beyond the
uniform quota is re-assigned to under-full destinations (deterministically,
recorded in the plan so the receiver can restore manifest order).  The
exchange moves ``rows_per_pair`` rows per (src, dst) pair, padded; the
plan's permutation carries the raggedness, not the collective.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..status import Status, StatusError
from ..utils import profiling
from .sharding import mesh_group, mesh_rank


def hash_partition(block_ids: np.ndarray, num_devices: int) -> np.ndarray:
    """Destination shard per block id (splitmix-style integer hash — the
    'hash-partitioned blocks' contract)."""
    x = block_ids.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(num_devices)).astype(np.int32)


@dataclass
class ShufflePlan:
    """Deterministic exchange plan for one block batch."""

    num_devices: int
    rows_per_pair: int            # padded row count per (src, dst) cell
    send_order: np.ndarray        # [D, rows_per_pair * D] block index (or -1)
    dest: np.ndarray              # [nblocks] final destination of each block
    recv_block: np.ndarray        # [D, D, rows_per_pair] global block id (or -1)

    @property
    def wire_rows(self) -> int:
        return self.num_devices * self.rows_per_pair

    def staging(self, rank: int, per_src: int) -> tuple[np.ndarray, np.ndarray]:
        """Source ``rank``'s staging metadata: (local row index [D * rpp]
        int64, validity [D * rpp] bool) of each wire row it sends."""
        order = self.send_order[rank]
        return (order % max(1, per_src)).astype(np.int64), order >= 0


def plan_shuffle(nblocks: int, num_devices: int, sizes: np.ndarray | None = None,
                 balance: bool = True, config=None) -> ShufflePlan:
    """Build the skew-balanced exchange plan.

    Blocks are assumed currently sharded contiguously: block ``i`` lives on
    source shard ``i // (nblocks / D)``.  Destinations come from
    ``hash_partition``; with ``balance`` the count skew is smoothed to the
    uniform quota.  ``sizes`` (compressed lengths) orders the balancing so
    the largest blocks move first to the emptiest destinations (greedy LPT),
    keeping per-destination *byte* skew bounded too.

    ``config`` (a ``ShardingConfig``): its ``skew_bucket_log`` coarsens the
    LPT ordering — sizes are bucketed by ``log2(size) >> skew_bucket_log``
    before the sort, so plans stay stable under small size jitter between
    otherwise-identical batches (deterministic re-planning across hosts).
    """
    if config is not None and sizes is not None and config.skew_bucket_log > 0:
        lg = np.zeros_like(sizes)
        nz = sizes > 0
        lg[nz] = np.ceil(np.log2(sizes[nz].astype(np.float64))).astype(sizes.dtype)
        sizes = (lg >> config.skew_bucket_log).astype(sizes.dtype)
    if nblocks % num_devices:
        raise StatusError(Status.Invalid(
            f"nblocks {nblocks} must be padded to a multiple of {num_devices}"))
    per_src = nblocks // num_devices
    ids = np.arange(nblocks)
    dest = hash_partition(ids, num_devices)

    if balance:
        quota = -(-nblocks // num_devices)
        counts = np.bincount(dest, minlength=num_devices)
        order = np.argsort(-(sizes if sizes is not None else np.ones(nblocks)), kind="stable")
        byte_load = np.zeros(num_devices, dtype=np.int64)
        for i in order:
            d = dest[i]
            if counts[d] > quota:
                # re-assign to the least-loaded under-quota destination
                cands = np.flatnonzero(counts < quota)
                d2 = cands[np.argmin(byte_load[cands])]
                counts[d] -= 1
                counts[d2] += 1
                dest[i] = d2
                d = d2
            byte_load[d] += int(sizes[i]) if sizes is not None else 1

    # Per (src, dst) cell membership, padded to the max cell size.
    cells: list[list[list[int]]] = [[[] for _ in range(num_devices)]
                                    for _ in range(num_devices)]
    for i in ids:
        src = i // per_src
        cells[src][int(dest[i])].append(int(i))
    rows_per_pair = max(1, max(len(c) for row in cells for c in row))

    send_order = np.full((num_devices, num_devices * rows_per_pair), -1, dtype=np.int32)
    recv_block = np.full((num_devices, num_devices, rows_per_pair), -1, dtype=np.int32)
    for s in range(num_devices):
        for d in range(num_devices):
            for j, b in enumerate(cells[s][d]):
                send_order[s, d * rows_per_pair + j] = b
                recv_block[d, s, j] = b
    return ShufflePlan(num_devices=num_devices, rows_per_pair=rows_per_pair,
                       send_order=send_order, dest=dest, recv_block=recv_block)


def stage_rows(rows: torch.Tensor, send_idx: torch.Tensor, valid: torch.Tensor
               ) -> torch.Tensor:
    """The wire rows a source sends: ``rows[send_idx]`` with invalid (idle)
    rows zeroed; [D * rpp, slot].  Traced, the span
    ``bitar.shuffle.stage_rows`` and the counter ``shuffle.staged_bytes``."""
    with profiling.annotate("bitar.shuffle.stage_rows"):
        staged = rows.index_select(0, send_idx.to(rows.device, torch.long))
        staged = staged * valid.to(rows.device).view(-1, 1).to(rows.dtype)
    profiling.count("shuffle.staged_bytes", staged.numel())
    return staged


def all_to_all_rows(staged: torch.Tensor, group) -> torch.Tensor:
    """One all-to-all of ``staged`` [D * rpp, slot]: chunk ``d`` goes to
    rank ``d``; returns the received chunks in source order.  Traced, the
    span ``bitar.shuffle.all_to_all_rows``."""
    with profiling.annotate("bitar.shuffle.all_to_all_rows"):
        recv = torch.empty_like(staged)
        dist.all_to_all_single(recv, staged, group=group)
    return recv


def execute_shuffle(mesh: DeviceMesh, plan: ShufflePlan, local_rows: torch.Tensor
                    ) -> torch.Tensor:
    """Run the all-to-all exchange of slot rows.

    ``local_rows``: this rank's [nblocks / D, slot] uint8 rows (source shard
    ``rank``).  Returns [D * rows_per_pair, slot]: the rows this rank
    receives, in ``plan.recv_block[rank]`` order (zero rows where the id is
    -1)."""
    me = mesh_rank(mesh)
    send_idx, valid = plan.staging(me, local_rows.shape[0])
    staged = stage_rows(local_rows, torch.from_numpy(send_idx), torch.from_numpy(valid))
    return all_to_all_rows(staged, mesh_group(mesh))
