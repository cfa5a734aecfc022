"""Multi-device / multi-process parallel execution layer (one rank per
device, ``torch.distributed``); the counterpart of ``bitar_tpu/parallel``."""

from . import multihost
from .pipeline import (
    distributed_step_flat,
    distributed_step_tables_fallback,
    prepare_distributed_step_tables_fallback,
    prepare_flat_wires_for_recv,
    prepare_ring_flat_wires_for_recv,
    reorder_tables_for_recv,
)
from .ring import distributed_step_ring_flat
from .sharding import (
    BLOCKS_AXIS,
    make_mesh,
    pad_block_count,
    prepare_sharded_batch,
    shard_blocks,
    sharded_decode,
)
from .shuffle import ShufflePlan, execute_shuffle, hash_partition, plan_shuffle

__all__ = [
    "BLOCKS_AXIS",
    "multihost",
    "ShufflePlan",
    "distributed_step_tables_fallback",
    "distributed_step_flat",
    "distributed_step_ring_flat",
    "execute_shuffle",
    "hash_partition",
    "make_mesh",
    "pad_block_count",
    "plan_shuffle",
    "prepare_distributed_step_tables_fallback",
    "prepare_flat_wires_for_recv",
    "prepare_ring_flat_wires_for_recv",
    "prepare_sharded_batch",
    "reorder_tables_for_recv",
    "shard_blocks",
    "sharded_decode",
]
