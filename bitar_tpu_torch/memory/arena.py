"""Device slot arena: preallocated compressed-block pool with take/put/recycle.

The counterpart of ``bitar_tpu/memory/arena.py``: one ``[max_slots,
slot_size]`` uint8 tensor on the engine's device, allocated once at engine
init, with one slot (row) per compressed block.  ``SlotPool`` is the same
host bookkeeping (free list, occupied set, critical-path growth up to
``max_slots``, double-put rejection).

Unlike the JAX arena, writes update the tensor in place (``index_copy_``)
rather than through a donated buffer.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import MIN_POOL_SLOTS
from ..status import Status, StatusError
from ..utils.logging import get_logger

logger = get_logger("memory.arena")


def named_device(device: torch.device | str | None, what: str) -> torch.device:
    """``device`` (None means "cuda") as a ``torch.device`` that names its
    card: "cuda" without an index becomes the current CUDA device, so that
    what ``what`` allocates later, on worker threads whose current device
    is cuda:0, stays on that card.  Raises StatusError for CUDA without
    CUDA: CPU callers pass "cpu"."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise StatusError(Status.Invalid(
                f"{what}(device={device}): torch.cuda.is_available() is false; "
                f"pass device='cpu' for the plain PyTorch path"))
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass
class ArenaStats:
    """Allocation statistics plus pool-pressure counters."""

    bytes_reserved: int = 0
    max_in_use: int = 0
    num_takes: int = 0
    num_puts: int = 0
    num_recycles: int = 0
    critical_growths: int = 0

    def snapshot(self) -> dict:
        return dict(self.__dict__)


@dataclass(frozen=True)
class CompressedBlockRef:
    """A handle to one compressed block living in an arena slot."""

    slot: int
    length: int
    codec_id: int = 0
    checksum: int = 0


class SlotPool:
    """Thread-safe free-list of slot indices with occupied-set checking
    (reference ``memory.cc:161-209``)."""

    _WARN_INTERVAL_S = 5.0

    def __init__(self, preallocated: int, max_slots: int, slot_size: int):
        if preallocated < MIN_POOL_SLOTS:
            raise StatusError(Status.Invalid(
                f"preallocated slots {preallocated} < minimum {MIN_POOL_SLOTS} "
                f"(reference kMinPreallocateMemzones)"))
        if max_slots < preallocated:
            raise StatusError(Status.Invalid(
                f"max_slots {max_slots} < preallocated {preallocated}"))
        self._lock = threading.Lock()
        self._free: list[int] = list(range(preallocated - 1, -1, -1))
        self._occupied: set[int] = set()
        self._high_water = preallocated   # slots ever made available
        self._max_slots = max_slots
        self._last_warn = 0.0
        self.stats = ArenaStats(bytes_reserved=preallocated * slot_size)
        self._slot_size = slot_size

    @property
    def capacity(self) -> int:
        return self._high_water

    @property
    def num_free(self) -> int:
        with self._lock:
            return len(self._free)

    def take(self, n: int = 1) -> list[int]:
        """Pop n slots, growing past the preallocation (with a rate-limited
        warning) up to max_slots; CapacityError beyond."""
        with self._lock:
            got: list[int] = []
            while len(got) < n and self._free:
                got.append(self._free.pop())
            grow = n - len(got)
            if grow > 0:
                if self._high_water + grow > self._max_slots:
                    self._free.extend(reversed(got))      # undo partial take
                    raise StatusError(Status.CapacityError(
                        f"arena exhausted: want {grow} more slots, "
                        f"high-water {self._high_water}, max {self._max_slots}"))
                now = time.monotonic()
                if now - self._last_warn > self._WARN_INTERVAL_S:
                    logger.warning(
                        "arena growing on the critical path: +%d slots "
                        "(high-water %d -> %d); consider a larger preallocation",
                        grow, self._high_water, self._high_water + grow)
                    self._last_warn = now
                got.extend(range(self._high_water, self._high_water + grow))
                self._high_water += grow
                self.stats.critical_growths += 1
                self.stats.bytes_reserved = self._high_water * self._slot_size
            self._occupied.update(got)
            self.stats.num_takes += n
            self.stats.max_in_use = max(self.stats.max_in_use, len(self._occupied))
            return got

    def put(self, slots: list[int] | int) -> None:
        if isinstance(slots, int):
            slots = [slots]
        with self._lock:
            for s in slots:
                if s not in self._occupied:
                    raise StatusError(Status.Invalid(
                        f"slot {s} returned to pool but not taken (double put?)"))
                self._occupied.remove(s)
                self._free.append(s)
            self.stats.num_puts += len(slots)

    def in_use(self) -> int:
        with self._lock:
            return len(self._occupied)


class DeviceArena:
    """The device-resident compressed-block pool for one engine.

    Holds one ``[max_slots, slot_size]`` uint8 tensor on ``device``
    (default: CUDA, as ``Engine``; StatusError without it, so CPU callers
    pass ``device="cpu"``), allocated once and never moved: :attr:`buffer`.
    ``write_burst`` stores a burst of compressed rows into taken slots and
    bumps their write generation.  On the card the engine's flat decode
    and its table decode of block picks read slots in place, through a
    table of slot indices over :attr:`buffer`; ``gather_burst`` copies slot
    rows out for host readout, the CPU path, Zstd units (whose literal
    planes replace rows) and the table decode of whole units.
    """

    def __init__(self, slot_size: int, preallocated: int, max_slots: int,
                 device: torch.device | str | None = None):
        self.slot_size = int(slot_size)
        self.device = named_device(device, "DeviceArena")
        self.pool = SlotPool(preallocated, max_slots, slot_size)
        # The whole ceiling at once: allocation stays off the critical path
        # (the reference preallocates its memzone budget, app_common.cc:92-100).
        self._buf = torch.zeros((max_slots, self.slot_size), dtype=torch.uint8,
                                device=self.device)
        self._tracker: dict[int, int] = {}  # id(ref) -> slot
        # Per-slot write generation, bumped by every write_burst: the table
        # decode's validator re-walks only slots written since it last looked.
        self._slot_gen = np.zeros(max_slots, np.int64)
        self._buf_lock = threading.Lock()

    def _index(self, slot_ids) -> torch.Tensor:
        if isinstance(slot_ids, torch.Tensor):
            return slot_ids.to(self.device)
        return torch.as_tensor(np.asarray(slot_ids, dtype=np.int64),
                               device=self.device)

    @property
    def buffer(self) -> torch.Tensor:
        """The ``[max_slots, slot_size]`` uint8 slot tensor itself, for a
        kernel that reads slots in place (row = slot).  Allocated at init
        and never reallocated, so a table of a unit's slots over it stays
        valid until the unit is recycled.  Write only through
        :meth:`write_burst`."""
        return self._buf

    # -- data plane ----------------------------------------------------
    def write_burst(self, slot_ids: list[int], rows) -> None:
        """Store ``rows[i]`` into slot ``slot_ids[i]``.

        ``rows`` (a uint8 numpy array or tensor, ``[n, w]``) may be
        narrower than ``slot_size``: the slot's tail past ``w`` is zeroed
        on the device, so only the used prefix crosses the host link."""
        rows = torch.as_tensor(rows)
        if rows.ndim != 2 or rows.shape[1] > self.slot_size or rows.dtype != torch.uint8:
            raise StatusError(Status.Invalid(
                f"write_burst rows {tuple(rows.shape)} {rows.dtype}: want "
                f"[n, <= {self.slot_size}] uint8"))
        if rows.shape[0] != len(slot_ids):
            raise StatusError(Status.Invalid(
                f"write_burst: {rows.shape[0]} rows for {len(slot_ids)} slots"))
        full = torch.zeros((rows.shape[0], self.slot_size), dtype=torch.uint8,
                           device=self.device)
        full[:, :rows.shape[1]].copy_(rows)
        idx = self._index(slot_ids)
        with self._buf_lock:
            self._slot_gen[np.asarray(slot_ids, dtype=np.int64)] += 1
            self._buf.index_copy_(0, idx, full)

    def slot_generations(self, slot_ids: list[int]) -> np.ndarray:
        """Each slot's write generation (a validation-cache key)."""
        with self._buf_lock:
            return self._slot_gen[np.asarray(slot_ids, dtype=np.int64)].copy()

    def gather_burst(self, slot_ids) -> torch.Tensor:
        """``[len(slot_ids), slot_size]`` uint8 copy of the slots, on device
        (``slot_ids``: ints, or an integer tensor of slots).  For host
        readout, the CPU path, Zstd units and the table decode of whole
        units; on the card the flat decode of a resident unit and the table
        decode of block picks read :attr:`buffer` in place."""
        idx = self._index(slot_ids)
        with self._buf_lock:
            return self._buf.index_select(0, idx)

    def read_host(self, ref: CompressedBlockRef) -> np.ndarray:
        with self._buf_lock:
            row = self._buf[ref.slot, :ref.length].cpu()
        return row.numpy()

    # -- control plane -------------------------------------------------
    def take_refs(self, lengths: list[int], codec_ids: list[int] | None = None
                  ) -> list[CompressedBlockRef]:
        slots = self.pool.take(len(lengths))
        refs = []
        for i, (s, ln) in enumerate(zip(slots, lengths, strict=True)):
            ref = CompressedBlockRef(
                slot=s, length=ln, codec_id=codec_ids[i] if codec_ids else 0)
            self._tracker[id(ref)] = s
            refs.append(ref)
        return refs

    def recycle(self, refs: list[CompressedBlockRef]) -> int:
        """Return compressed blocks to the pool; returns the count recycled
        (reference ``device.cc:321-327``)."""
        slots = []
        for ref in refs:
            slot = self._tracker.pop(id(ref), None)
            if slot is None:
                raise StatusError(Status.Invalid(
                    f"recycled ref (slot {ref.slot}) unknown to this arena"))
            slots.append(slot)
        self.pool.put(slots)
        self.pool.stats.num_recycles += len(slots)
        return len(slots)

    @property
    def stats(self) -> ArenaStats:
        return self.pool.stats
