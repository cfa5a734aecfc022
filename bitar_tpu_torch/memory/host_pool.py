"""Host-side memory pools for staged ingest.

The analog of the reference's Arrow MemoryPool backends over DPDK memory
(``src/memory_pool.cc``): selectable backends via ``get_memory_pool``
(reference ``GetMemoryPool(System|Jemalloc|Mimalloc|Rtemalloc|Rtememzone)``,
``memory_pool.cc:321-350``), allocation statistics, and debug-build
boundary poisoning (``memory_pool.cc:190-194``).

On an accelerator host the DMA-able-memory distinction collapses: numpy
buffers are staged to device memory by the runtime regardless.  What survives is (a) *pooling* —
reusing page-aligned staging buffers across bursts instead of churning the
allocator, and (b) *accounting + poisoning* for debug.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass

import numpy as np

from ..status import Status, StatusError

POISON_BYTE = 0xA5  # reference poisons alloc boundaries in debug builds
ALIGNMENT = 4096    # page alignment (huge-page analog)


class PoolBackend(enum.Enum):
    SYSTEM = "system"      # plain numpy allocation, no pooling
    POOLED = "pooled"      # size-bucketed free lists (rte_malloc heap analog)
    ALIGNED = "aligned"    # page-aligned pooled buffers (rte_memzone analog)


@dataclass
class HostPoolStats:
    bytes_allocated: int = 0
    max_memory: int = 0
    num_allocations: int = 0
    num_reuses: int = 0


class HostBuffer:
    """A pooled, optionally aligned, byte buffer with explicit length."""

    __slots__ = ("array", "length", "_pool", "_bucket")

    def __init__(self, array: np.ndarray, length: int, pool, bucket: int):
        self.array = array
        self.length = length
        self._pool = pool
        self._bucket = bucket

    def view(self) -> np.ndarray:
        return self.array[:self.length]

    def free(self) -> None:
        if self._pool is not None:
            self._pool._release(self)
            self._pool = None


class HostMemoryPool:
    """Size-bucketed buffer pool with stats and debug poisoning."""

    def __init__(self, backend: PoolBackend = PoolBackend.POOLED,
                 debug_poison: bool = False):
        self.backend = backend
        self.debug_poison = debug_poison
        self.stats = HostPoolStats()
        self._lock = threading.Lock()
        self._free: dict[int, list[np.ndarray]] = {}

    @staticmethod
    def _bucket_of(n: int) -> int:
        # next power of two, min 4 KiB: keeps reuse rates high
        b = max(4096, n)
        return 1 << (b - 1).bit_length()

    def _alloc_raw(self, nbytes: int) -> np.ndarray:
        if self.backend == PoolBackend.ALIGNED:
            raw = np.empty(nbytes + ALIGNMENT, dtype=np.uint8)
            off = (-raw.ctypes.data) % ALIGNMENT
            return raw[off:off + nbytes]
        return np.empty(nbytes, dtype=np.uint8)

    def allocate(self, nbytes: int) -> HostBuffer:
        if nbytes < 0:
            raise StatusError(Status.Invalid("negative allocation"))
        bucket = self._bucket_of(nbytes)
        arr = None
        if self.backend != PoolBackend.SYSTEM:
            with self._lock:
                lst = self._free.get(bucket)
                if lst:
                    arr = lst.pop()
                    self.stats.num_reuses += 1
        if arr is None:
            arr = self._alloc_raw(bucket)
            with self._lock:
                self.stats.num_allocations += 1
                self.stats.bytes_allocated += bucket
                self.stats.max_memory = max(self.stats.max_memory,
                                            self.stats.bytes_allocated)
        if self.debug_poison:
            arr[:] = POISON_BYTE
        return HostBuffer(arr, nbytes, self, bucket)

    def _release(self, buf: HostBuffer) -> None:
        if self.debug_poison:
            buf.array[:] = POISON_BYTE
        if self.backend == PoolBackend.SYSTEM:
            with self._lock:
                self.stats.bytes_allocated -= buf._bucket
            return
        with self._lock:
            self._free.setdefault(buf._bucket, []).append(buf.array)


_pools: dict[PoolBackend, HostMemoryPool] = {}
_pools_lock = threading.Lock()


def get_memory_pool(backend: PoolBackend = PoolBackend.POOLED) -> HostMemoryPool:
    """Process-wide pool per backend (reference ``GetMemoryPool``,
    ``memory_pool.cc:321-350``)."""
    with _pools_lock:
        pool = _pools.get(backend)
        if pool is None:
            pool = _pools[backend] = HostMemoryPool(backend)
        return pool
