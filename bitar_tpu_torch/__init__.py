"""bitar-tpu on PyTorch and CUDA: the block compression engine's port.

The second package beside ``bitar_tpu`` (JAX, the reference).  It imports
torch and numpy, never JAX or ``bitar_tpu``, and builds its host codec
library from its own copy of the reference's C++ (``ops/cpu/*.cc``).  Its
device work runs hand-written CUDA kernels (``csrc/*.cu``: flat-plan and
sequence-table decode, the match kernels, the emitter) on a CUDA device,
and their plain PyTorch versions on the CPU.

Quick start::

    import bitar_tpu_torch as btt

    cfg = btt.EngineConfig(codec=btt.Codec.LZ4, commit="deferred")
    engine = btt.Engine(cfg, device="cuda").initialize()
    unit = engine.compress(data)             # blocks in the device arena
    out = engine.decompress(unit)            # bit-exact bytes
    engine.recycle(unit)                     # return arena slots
"""

from .config import (Checksum, Codec, DeviceCapabilities, EngineConfig, ShardingConfig,
                     capabilities_for_device, compress_bound)
from .engine.device import CompressedUnit, Engine, EngineState, EngineStats, prepare_batched_decode
from .engine.driver import Driver
from .engine.stream import (ASYNC_RETURN_OK, CompressParam, DecompressParam, Stream,
                            make_streams, wait_all)
from .manifest import BlockManifest, CompressedBuffers
from .memory.arena import ArenaStats, CompressedBlockRef, DeviceArena
from .memory.host_pool import HostMemoryPool, PoolBackend, get_memory_pool
from .status import Result, Status, StatusCode, StatusError

__all__ = [
    "ASYNC_RETURN_OK",
    "ArenaStats",
    "BlockManifest",
    "Checksum",
    "Codec",
    "CompressedBlockRef",
    "CompressedBuffers",
    "CompressedUnit",
    "CompressParam",
    "DecompressParam",
    "DeviceArena",
    "DeviceCapabilities",
    "Driver",
    "Engine",
    "EngineConfig",
    "EngineState",
    "EngineStats",
    "HostMemoryPool",
    "PoolBackend",
    "Result",
    "ShardingConfig",
    "Status",
    "StatusCode",
    "StatusError",
    "Stream",
    "capabilities_for_device",
    "compress_bound",
    "get_memory_pool",
    "make_streams",
    "prepare_batched_decode",
    "wait_all",
]
