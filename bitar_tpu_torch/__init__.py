"""bitar-tpu on PyTorch and CUDA: the block compression engine's port.

The second package beside ``bitar_tpu`` (JAX, the reference).  It imports
torch and numpy, never JAX or ``bitar_tpu``; the host codec library is the
same C++ (``bitar_tpu/ops/cpu/*.cc``), compiled by path.  Block decode runs
the hand-written CUDA kernel ``csrc/decode_flat.cu`` on a CUDA device, and
its plain PyTorch version on the CPU.

Quick start::

    import bitar_tpu_torch as btt

    cfg = btt.EngineConfig(codec=btt.Codec.LZ4, commit="deferred")
    engine = btt.Engine(cfg, device="cuda").initialize()
    unit = engine.compress(data)             # blocks in the device arena
    out = engine.decompress(unit)            # bit-exact bytes
    engine.recycle(unit)                     # return arena slots
"""

from .config import Checksum, Codec, DeviceCapabilities, EngineConfig, compress_bound
from .engine.device import CompressedUnit, Engine, EngineState, EngineStats
from .manifest import BlockManifest, CompressedBuffers
from .memory.arena import ArenaStats, CompressedBlockRef, DeviceArena
from .memory.host_pool import HostMemoryPool, PoolBackend, get_memory_pool
from .status import Result, Status, StatusCode, StatusError

__all__ = [
    "ArenaStats",
    "BlockManifest",
    "Checksum",
    "Codec",
    "CompressedBlockRef",
    "CompressedBuffers",
    "CompressedUnit",
    "DeviceArena",
    "DeviceCapabilities",
    "Engine",
    "EngineConfig",
    "EngineState",
    "EngineStats",
    "HostMemoryPool",
    "PoolBackend",
    "Result",
    "Status",
    "StatusCode",
    "StatusError",
    "compress_bound",
    "get_memory_pool",
]
