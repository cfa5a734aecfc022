"""Engine: the per-device compression runtime.

Counterpart of ``bitar_tpu/engine/device.py`` on PyTorch.  One engine owns
one device (``torch.device``), validates its configuration against the
device's capabilities at ``initialize``, walks the state machine CREATED ->
STARTED -> RELEASED, runs ``compress``/``decompress`` and recycles units'
arena slots.

The paths, as in the reference package:

* ``compress`` runs the native host matcher (C++ threads) and stages the
  compressed blocks; with ``commit="deferred"`` they reach the device arena
  at first use (``_ensure_committed``), with ``"eager"`` during compress.
  ``compress_matcher="device"`` (LZ4) compresses on the device instead
  (``_compress_device_full``: detector, match kernel, emitter kernel) and
  writes the rows into the arena there.  ``"tpu"`` scores a static offset
  set on the device (kernel B3, ``ops/match.py``) and ``"tpu-sort"`` finds
  each position's last 4-byte repeat by a device sort (``ops/match_sort.py``);
  both bring the hints back and the native emitter writes LZ4 or Snappy.
* ``ensure_plans`` joins (or runs) the native batch planner, which turns
  every block into a flat decode plan (Zstd blocks: over their
  entropy-decoded literal planes).  The planner's arguments are the
  reference engine's, so both packages build the same plan.  A unit with no
  plannable block, or with blocks narrower than 128 rows, gets sequence
  tables instead (``_build_tables``).  The planner's host memory is
  process-wide, as in the reference engine: per-chunk scratch reused by
  every build, and the unit's plan wire in a grant from a free list that
  ``recycle`` refills; ``initialize`` prefaults both.
* ``decompress`` and ``decompress_device`` launch the flat decode kernel
  burst by burst (``ops/decode_flat.py``; blocks the planner rejected
  decode on the host meanwhile).  Every flat launch of an engine (bursts,
  block picks, ``prepare_device_decode``) takes its source from one method,
  ``Engine._flat_source``: on the card each block where it lies in its arena
  slot, through the unit's slot table (``CompressedUnit.slot_table``); on
  the CPU, and for Zstd units, whose literal planes replace rows, the
  blocks' slots gathered first (``Engine._unit_rows``).  Units with
  sequence tables gather and launch the sequence-table kernel
  (``ops/decode_tables.py``; the host re-walks the framing of slots written
  since it last looked, meanwhile).  Bursts are read back on a small thread
  pool and land in the output as each completes (``Engine._land_bursts``).
  A unit with neither decodes on the host.
* ``prepare_batched_decode`` merges several planned units into one flat
  decode launch over a copy of their rows.

On a CUDA device a kernel or build failure raises: nothing falls back to the
host or to a plain PyTorch version.  ``Engine(device="cpu")`` runs the plain
PyTorch versions on CPU tensors (the test path).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import enum
import os
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import (
    DEVICE_PARSE_SEG,
    Checksum,
    Codec,
    DeviceCapabilities,
    EngineConfig,
    capabilities_for_device,
)
from ..manifest import BlockManifest, CompressedBuffers, checksum_of, codec_from_id, codec_id
from ..memory.arena import CompressedBlockRef, DeviceArena, named_device
from ..memory.host_pool import PoolBackend, get_memory_pool
from ..ops import registry
from ..ops.cpu import native
from ..ops.cpu.native import SEQUENCE_KEYS
from ..ops.decode_flat import (
    CB,
    DCHUNK,
    KBAND,
    LANES,
    _S_QUANTUM,
    FlatLaunch,
    decode_blocks_flat,
    plan_tensors,
    prepare_flat_launch,
)
from ..ops.decode_tables import decode_blocks, pad_tables, table_tensors
from ..ops.device_compress import _emit, engine_width, match_parse_device
from ..ops.match import DEFAULT_OFFSETS, find_matches
from ..ops.match_sort import find_matches_sorted
from ..status import Status, StatusError
from ..utils import profiling
from ..utils.logging import get_logger

logger = get_logger("engine.device")

_RAW_ID = codec_id(Codec.RAW)
_ZSTD_ID = codec_id(Codec.ZSTD)
#: per-block entries of the plan wire (sliced per burst)
_BLOCK_KEYS = ("p_used", "p_off", "p0", "dense", "dq_idx")
#: the host parser of each codec the sequence tables take
_PARSERS = {Codec.LZ4: "lz4", Codec.SNAPPY: "snappy"}


def _reads_in_place(device: torch.device) -> bool:
    """Whether decode launches read resident blocks where they lie in the
    arena on ``device``: on the card.  The CPU gathers them first, under the
    gather's span and counters; its plain decode would select the rows
    anyway.  Read only by :meth:`Engine._in_place`."""
    return device.type == "cuda"


def _select(t: torch.Tensor, blocks: slice | torch.Tensor) -> torch.Tensor:
    """The rows of ``t`` for ``blocks``: a slice (a view), or an int64 index
    tensor on ``t``'s device (``index_select``)."""
    return t[blocks] if isinstance(blocks, slice) else t.index_select(0, blocks)


class EngineState(enum.Enum):
    """Reference device state machine (``device.h:64-68``)."""

    CREATED = "created"
    STARTED = "started"
    RELEASED = "released"


@dataclass
class EngineStats:
    """Counter surface (the reference's ``rte_compressdev_stats_get``)."""

    enqueued_blocks: int = 0
    dequeued_blocks: int = 0
    enqueue_err_blocks: int = 0
    dequeue_err_blocks: int = 0
    bytes_compressed: int = 0
    bytes_decompressed: int = 0
    device_decode_bursts: int = 0
    host_decode_bursts: int = 0


@dataclass
class CompressedUnit:
    """A compressed buffer set: manifest + device-resident arena slots +
    the decode sidecar once ``ensure_plans`` built it: a flat plan, or
    sequence tables when the unit cannot be planned.  Its device caches are
    built at first use and dropped together (:meth:`_drop_device_caches`)."""

    manifest: BlockManifest
    refs: list[CompressedBlockRef]
    engine: "Engine"
    #: Sequence tables (host numpy): lit_ptr/lit_len/off/mlen/out_pos
    #: [nblocks, S] int32, and nseq [nblocks].
    tables: dict[str, np.ndarray] | None = None
    nseq: np.ndarray | None = None
    #: Flat plan (host numpy): p_used/p_off/p0/dense/dq_idx [nblocks] int32,
    #: se [S, tiles, 128] int16, shift [S, tiles, 128] int32, dq
    #: [m, nrows, 128] int16, row_a [m, dcap, 128, tiles] int32, host_blocks
    #: (blocks the planner rejected; they decode on the host) and, for Zstd
    #: blocks, lit_planes {block: entropy-decoded literal plane}.  se, shift,
    #: dq and row_a are views of the pooled grant ``_pooled``, which
    #: ``recycle`` returns: no view may be used after it.
    plan_flat: dict[str, np.ndarray] | None = None
    plan_comp_rows: int = 0
    recycled: bool = field(default=False)
    _plan_dev: dict | None = field(default=None, repr=False)
    _table_dev: tuple | None = field(default=None, repr=False)
    #: ``lit_device_arrays()``: (planes, block -> row map), or () for a
    #: unit without literal planes.
    _lit_dev: tuple | None = field(default=None, repr=False)
    #: ``slot_table()``: the unit's arena slots as an int32 tensor on the
    #: engine's device, and its host copy (``host_slot_table()``).  Built at
    #: the unit's first decode.
    _slots_dev: torch.Tensor | None = field(default=None, repr=False)
    _slots_host: np.ndarray | None = field(default=None, repr=False)
    #: B1's launch record of each burst (:class:`FlatLaunch`), by its first
    #: block: built at the burst's first decode (``Engine._burst_launch``).
    _flat_launches: dict[int, FlatLaunch] = field(default_factory=dict, repr=False)
    #: True while the unit's sequence tables sit in the engine's table store.
    _in_table_store: bool = field(default=False, repr=False)
    #: Host copy of the staged slot rows (compress/import), dropped once
    #: plans exist.
    _staging: np.ndarray | None = field(default=None, repr=False)
    _staging_buf: object | None = field(default=None, repr=False)
    _planned: bool = field(default=False, repr=False)
    #: Pending background plan build (plan_build="background").
    _plan_future: object | None = field(default=None, repr=False)
    #: False while the compressed bytes live only in host staging.
    _committed: bool = field(default=True, repr=False)
    #: Table-path validation cache: per block, the slot's write generation
    #: and the status of the last framing walk.
    _val_gen: np.ndarray | None = field(default=None, repr=False)
    _val_status: np.ndarray | None = field(default=None, repr=False)

    def plan_device_arrays(self) -> dict[str, torch.Tensor]:
        """The unit's plan wire on the engine's device, uploaded once and
        shared by every decode launch of this unit."""
        if self._plan_dev is None:
            self._plan_dev = plan_tensors(self.plan_flat, self.engine.device)
        return self._plan_dev

    def table_device_arrays(self) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """(nseq, tables) on the engine's device, uploaded once."""
        if self._table_dev is None:
            self._table_dev = table_tensors(self.tables, self.nseq, self.engine.device)
        return self._table_dev

    def lit_device_arrays(self, width: int) -> tuple[torch.Tensor, torch.Tensor] | None:
        """The Zstd blocks' literal planes as ``[k, width]`` uint8 rows on
        the device (zero past each plane) and each block's row among them
        (int64 ``[nblocks]``, -1 for a block without one); they replace
        those blocks' comp rows in every gathered decode launch
        (``Engine._unit_rows``).  None for a unit without literal planes.
        Uploaded once, but never cached before plans exist: the planner
        makes them."""
        if self._lit_dev is None:
            if self.plan_flat is None:
                return None
            lit_planes = self.plan_flat.get("lit_planes")
            if not lit_planes:
                self._lit_dev = ()
            else:
                stack = np.zeros((len(lit_planes), width), np.uint8)
                at = np.full(self.nblocks, -1, np.int64)
                for k, (i, lit) in enumerate(sorted(lit_planes.items())):
                    stack[k, :lit.shape[0]] = lit
                    at[i] = k
                self._lit_dev = tuple(torch.from_numpy(a).to(self.engine.device)
                                      for a in (stack, at))
        return self._lit_dev or None

    def slot_table(self) -> torch.Tensor:
        """The unit's arena slots in block order, a contiguous int32 tensor
        on the engine's device: B1's source-row table over
        ``arena.buffer``, each slot checked to lie in it.  Built once and
        shared by every decode of the unit: the arena never moves, and the
        slots are the unit's until ``recycle``."""
        if self._slots_dev is None:
            slots = np.fromiter((r.slot for r in self.refs), np.int64, len(self.refs))
            rows = self.engine.arena.buffer.shape[0]
            if slots.size and not (0 <= int(slots.min()) and int(slots.max()) < rows):
                raise StatusError(Status.Invalid(
                    f"unit slots {int(slots.min())}..{int(slots.max())} outside the "
                    f"arena's {rows} rows"))
            self._slots_host = slots.astype(np.int32)
            self._slots_dev = torch.from_numpy(self._slots_host).to(self.engine.device)
        return self._slots_dev

    def host_slot_table(self) -> np.ndarray:
        """:meth:`slot_table` on the host (int32 numpy, not to be written),
        built with it: where block picks find their slots."""
        if self._slots_host is None:
            self.slot_table()
        return self._slots_host

    @property
    def nblocks(self) -> int:
        return self.manifest.nblocks

    def to_host(self) -> CompressedBuffers:
        """The packed compressed bytes on the host (from staging when
        present: a deferred-commit unit may not be in the arena yet)."""
        self._check_live()
        rows = self.engine._staging_rows(self)
        packed = np.concatenate([
            rows[i, :int(self.manifest.comp_len[i])] for i in range(self.nblocks)])
        return CompressedBuffers(manifest=self.manifest, packed=packed)

    def _drop_staging(self) -> None:
        self._staging = None
        if self._staging_buf is not None:
            self._staging_buf.free()
            self._staging_buf = None

    def _drop_device_caches(self) -> None:
        """Drop every cache built for decode launches: on the CPU the plan
        tensors alias the plan grant, and the slots become another unit's."""
        self._plan_dev = self._table_dev = self._lit_dev = None
        self._slots_dev = self._slots_host = None
        self._flat_launches = {}

    def _check_live(self) -> None:
        if self.recycled:
            raise StatusError(Status.Invalid("compressed unit already recycled"))


class Engine:
    """One device's compression/decompression runtime.

    ``device``: a ``torch.device`` or string; None means ``"cuda"``.  A CUDA
    device without CUDA raises StatusError here: pass ``device="cpu"`` for
    the plain PyTorch path.

    Whether a decode launch reads a unit's blocks in place or gathered is
    decided by :meth:`_in_place` alone; every flat launch takes its source
    from :meth:`_flat_source` and its plan rows from :meth:`_plan_rows`.

    The planner's host memory is process-wide, shared by every engine (the
    reference engine's discipline): ``_PLAN_CHUNK_SCRATCH`` holds each
    chunk's dense planes, keyed by (chunk index, chunk blocks, rows), reused
    dirty by every build; ``_PLAN_FREE`` is the free list of unit grants
    (the flat wire se/shift and the compact dq/row_a planes, 1-D capacity
    arrays), taken by best fit, grown on demand and returned by
    ``recycle``; ``_PLAN_LOCK`` serializes the builds that use them.  A
    unit's plan views must not be used after ``recycle``: on the CPU its
    plan tensors alias the grant, and a ``prepare_device_decode`` launch of
    it is dead.  On the card the plan's uploads are pageable copies that
    return once the host buffer is read, so a grant is free for reuse when
    ``recycle`` returns."""

    # Plan budget of the reference engine (160 passes per block), and its
    # chunking of a unit's plan build (bounds native plan scratch).
    _PLAN_MAX_PASSES = 160
    _PLAN_CHUNK_BLOCKS = 256
    _PLAN_PREWARM_CHUNKS = 4   # chunk-scratch sets faulted at initialize
    _PLAN_CHUNK_SCRATCH: dict[tuple[int, int, int], tuple[np.ndarray, np.ndarray]] = {}
    _PLAN_FREE: list[dict[str, np.ndarray]] = []
    _PLAN_LOCK = threading.Lock()

    def __init__(self, config: EngineConfig, device: torch.device | str | None = None):
        if config.block_size % LANES != 0:
            raise StatusError(Status.Invalid(
                f"block_size {config.block_size} must be a multiple of 128 "
                f"(plane row width)"))
        self.config = config
        self.device = named_device(device, "Engine")
        self.state = EngineState.CREATED
        self.caps: DeviceCapabilities | None = None
        self.arena: DeviceArena | None = None
        self.stats = EngineStats()
        # Plan builds run on ONE worker thread (compress submits,
        # ensure_plans joins); the process-wide lock covers the pools and
        # the synchronous path.
        self._plan_lock = Engine._PLAN_LOCK
        self._plan_executor: concurrent.futures.ThreadPoolExecutor | None = None
        #: The table store (:meth:`_table_store_enter`): (nseq [slots] int32,
        #: tables [5, slots, S] int32) on the device, one row an arena slot,
        #: and its five tables by key, as views.
        self._table_store: tuple[torch.Tensor, torch.Tensor] | None = None
        self._table_views: dict[str, torch.Tensor] | None = None
        #: The last call's table units, each one's first row in the host
        #: slots below, and their host slot tables laid end to end
        #: (:meth:`_pick_slot_map`); dropped by ``recycle``.
        self._pick_slots: tuple[list, np.ndarray, np.ndarray] | None = None

    # ------------------------------------------------------------------
    def initialize(self) -> "Engine":
        """Validate config against device capabilities and preallocate the
        arena (reference ``Initialize``, ``device.cc:115-154``).  With device
        kernels and ``plan_build="background"`` it also prefaults the
        planner's scratch (:meth:`_prewarm_plan_scratch`)."""
        if self.state != EngineState.CREATED:
            raise StatusError(Status.Invalid(
                f"initialize called in state {self.state.value}"))
        cfg = self.config
        self.caps = capabilities_for_device(self.device)
        cfg.validate(self.caps).with_context(
            f"Engine(device={self.device})").raise_if_error()
        self.arena = DeviceArena(
            slot_size=cfg.slot_size, preallocated=cfg.max_pool_slots,
            max_slots=cfg.max_pool_slots, device=self.device)
        self.state = EngineState.STARTED
        if cfg.use_tpu_kernels and cfg.plan_build == "background":
            # Synchronous: a prefault racing the first compress only moves
            # the page faults into it.
            self._prewarm_plan_scratch()
        logger.info("engine started on %s: codec=%s block=%d slot=%d pool=%d",
                    self.device, cfg.codec.value, cfg.block_size,
                    cfg.slot_size, cfg.max_pool_slots)
        return self

    def release(self) -> None:
        """Teardown by state (reference dtor, ``device.cc:330-343``)."""
        if self._plan_executor is not None:
            self._plan_executor.shutdown(wait=True, cancel_futures=True)
            self._plan_executor = None
        self.arena = None
        self._table_store = self._table_views = self._pick_slots = None
        self.state = EngineState.RELEASED

    def __enter__(self) -> "Engine":
        return self.initialize() if self.state == EngineState.CREATED else self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def _entry_guard(self) -> None:
        if self.state != EngineState.STARTED:
            raise StatusError(Status.Invalid(
                f"engine not started (state={self.state.value})"))

    # ------------------------------------------------------------------
    def compress(self, data, sizes=None) -> CompressedUnit:
        """Synchronous compress of one buffer into arena blocks.

        ``sizes``: optional explicit per-block split, each entry within
        ``block_size``, summing to ``len(data)``.  Default: uniform
        ``block_size`` split with a ragged tail."""
        self._entry_guard()
        raw = np.frombuffer(data, dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)) else np.ascontiguousarray(data, np.uint8)
        cfg = self.config
        if sizes is None:
            manifest = BlockManifest.plan(raw.shape[0], cfg.block_size)
        else:
            manifest = BlockManifest.plan_sizes(sizes, cfg.block_size)
            if manifest.total_raw != raw.shape[0]:
                raise StatusError(Status.Invalid(
                    f"sizes sum {manifest.total_raw} != data length {raw.shape[0]}"))
        manifest.checksum_kind = cfg.checksum
        n = manifest.nblocks
        slot = cfg.slot_size
        # BlockManifest.raw_off is a cumsum per access: read it once.
        raw_off = manifest.raw_off

        if cfg.compress_matcher == "device" and cfg.codec == Codec.LZ4:
            # Full offload: detect, match, parse and emit on the device;
            # the compressed rows land in the arena there, and only the
            # size vector crosses back.
            refs, manifest.comp_len, manifest.codec_ids = self._compress_device_full(
                raw, manifest)
            self._set_checksums(manifest, raw)
            self.stats.enqueued_blocks += n
            self.stats.dequeued_blocks += n
            self.stats.bytes_compressed += int(manifest.total_raw)
            return CompressedUnit(manifest=manifest, refs=refs, engine=self)

        # Pooled, page-aligned staging; no zero fill (every consumer
        # slices to per-block lengths).
        staging_buf = get_memory_pool(PoolBackend.ALIGNED).allocate(n * slot)
        staging = staging_buf.view().reshape(n, slot)
        dst_off = np.arange(n, dtype=np.int64) * slot
        caps = np.full(n, slot, dtype=np.int32)
        self.stats.enqueued_blocks += n
        codec_ids = np.full(n, codec_id(cfg.codec), dtype=np.int32)
        dst_len = np.zeros(n, np.int32)
        refs: list[CompressedBlockRef] = []
        # Used-prefix uploads, quantized to slot/8 (the arena zeroes tails).
        wstep = max(128, cfg.slot_size // 8)

        def _match(s: int, e: int):
            return registry.host_compress_batch(
                cfg.codec, cfg.level, raw, raw_off[s:e],
                manifest.raw_len[s:e], staging.reshape(-1),
                dst_off[s:e], caps[s:e], min_match=cfg.min_match)

        def _land(s: int, e: int, dl, st):
            """Status walk, incompressible -> RAW fallback, slot take,
            used-prefix upload (eager commit)."""
            bad = np.flatnonzero(st < 0)
            if bad.size:
                self.stats.enqueue_err_blocks += int(bad.size)
                raise StatusError(Status.from_int(
                    int(st[bad[0]]),
                    f"compress failed on blocks {(s + bad).tolist()[:8]}"))
            dst_len[s:e] = dl
            for j in np.flatnonzero(dl >= manifest.raw_len[s:e]):
                i = s + int(j)
                ln = int(manifest.raw_len[i])
                o = int(raw_off[i])
                staging[i, :ln] = raw[o:o + ln]
                dst_len[i] = ln
                codec_ids[i] = _RAW_ID
            chunk_refs = self.arena.take_refs(
                [int(x) for x in dst_len[s:e]], [int(c) for c in codec_ids[s:e]])
            refs.extend(chunk_refs)
            if cfg.commit == "deferred":
                return       # bytes stay in pool staging until first use
            w = int(dst_len[s:e].max(initial=1))
            w = min(cfg.slot_size, -(-w // wstep) * wstep)
            self.arena.write_burst([r.slot for r in chunk_refs], staging[s:e, :w])

        try:
            if cfg.compress_matcher in ("tpu", "tpu-sort"):
                _land(0, n, *self._compress_tpu_match(raw, manifest, staging))
            else:
                # The matcher chews chunk k+1 on its own threads (ctypes
                # drops the GIL) while this thread lands chunk k.
                step = min(cfg.burst_size, 64)
                with concurrent.futures.ThreadPoolExecutor(1) as ex:
                    fut = ex.submit(_match, 0, min(step, n))
                    for s in range(0, n, step):
                        e = min(s + step, n)
                        dl, st = fut.result()
                        if e < n:
                            fut = ex.submit(_match, e, min(e + step, n))
                        _land(s, e, dl, st)
        except Exception:
            if refs:
                self.arena.recycle(refs)
            staging_buf.free()
            raise

        manifest.comp_len = dst_len.astype(np.int32)
        manifest.codec_ids = codec_ids
        self._set_checksums(manifest, raw)
        self.stats.dequeued_blocks += n
        self.stats.bytes_compressed += int(manifest.total_raw)
        unit = CompressedUnit(manifest=manifest, refs=refs, engine=self,
                              _staging=staging, _staging_buf=staging_buf,
                              _committed=(cfg.commit == "eager"))
        if cfg.use_tpu_kernels and cfg.plan_build == "background":
            unit._plan_future = self._submit_plan_build(manifest, staging)
        return unit

    def _set_checksums(self, manifest: BlockManifest, raw: np.ndarray) -> None:
        if self.config.checksum == Checksum.NONE:
            return
        raw_off = manifest.raw_off
        for i in range(manifest.nblocks):
            o, ln = int(raw_off[i]), int(manifest.raw_len[i])
            manifest.checksums[i] = checksum_of(self.config.checksum, raw[o:o + ln])

    def _compress_device_full(self, raw: np.ndarray, manifest: BlockManifest):
        """Fully offloaded LZ4 compression (``ops/device_compress.py``): the
        raw planes go up once, the device matches, parses and emits, and
        the emitted rows are written into arena slots on the device.  Blocks
        the stream cannot shrink below their raw length store RAW from the
        same device planes.  Returns (refs, comp_len, codec_ids)."""
        cfg = self.config
        n, L = manifest.nblocks, cfg.block_size
        planes = np.zeros((n, L), np.uint8)
        raw_off = manifest.raw_off
        for i in range(n):
            o, ln = int(raw_off[i]), int(manifest.raw_len[i])
            planes[i, :ln] = raw[o:o + ln]
        dplanes = torch.from_numpy(planes).to(self.device)
        raw_len = manifest.raw_len.astype(np.int32)
        dlen = torch.from_numpy(raw_len).to(self.device)
        layout = match_parse_device(
            dplanes, dlen, seg=min(DEVICE_PARSE_SEG, L), min_match=cfg.min_match,
            offsets=tuple(cfg.match_offsets) or None, detect_fft=cfg.detect_fft,
            fft_k=cfg.fft_k)
        szs = layout["total"].cpu().numpy()
        fallback = szs >= raw_len
        dst_len = np.where(fallback, raw_len, szs).astype(np.int32)
        cids = np.where(fallback, _RAW_ID, codec_id(Codec.LZ4)).astype(np.int32)
        refs = self.arena.take_refs([int(x) for x in dst_len], [int(c) for c in cids])
        try:
            good = np.flatnonzero(~fallback)
            bad = np.flatnonzero(fallback)
            if good.size:
                width = engine_width(szs, raw_len, L)
                out = _emit(dplanes, layout, out_width=width, lengths=dlen)
                self._write_rows(refs, good, out)
            if bad.size:
                self._write_rows(refs, bad, dplanes)
        except Exception:
            self.arena.recycle(refs)
            raise
        return refs, dst_len, cids

    def _write_rows(self, refs, idx: np.ndarray, rows: torch.Tensor) -> None:
        """Write ``rows[idx]`` (on the device) into the slots of ``refs[idx]``,
        burst by burst."""
        sel = rows[torch.from_numpy(idx).to(rows.device)]
        for s in range(0, idx.size, self.config.burst_size):
            e = min(idx.size, s + self.config.burst_size)
            self.arena.write_burst([refs[int(i)].slot for i in idx[s:e]], sel[s:e])

    def _compress_tpu_match(self, raw: np.ndarray, manifest: BlockManifest,
                            staging: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Compress with device match hints: ``"tpu"`` scores the static
        offset set (kernel B3), ``"tpu-sort"`` finds each position's last
        4-byte repeat by a sort.  The hints (8 bytes per raw byte) come back
        to the host, whose emitter verifies and extends each one and writes
        the LZ4 or Snappy stream into ``staging``.  Returns (comp_len,
        status) per block."""
        cfg = self.config
        emit = (native.snappy_emit_sequences if cfg.codec == Codec.SNAPPY
                else native.lz4_emit_sequences)
        offsets = tuple(cfg.match_offsets) or DEFAULT_OFFSETS
        nrows = cfg.block_size // LANES
        n = manifest.nblocks
        planes = np.zeros((n, nrows, LANES), np.uint8)
        raw_off = manifest.raw_off
        for i in range(n):
            o, ln = int(raw_off[i]), int(manifest.raw_len[i])
            planes[i].reshape(-1)[:ln] = raw[o:o + ln]
        dplanes = torch.from_numpy(planes).to(self.device)
        if cfg.compress_matcher == "tpu-sort":
            oidx = find_matches_sorted(dplanes.reshape(n, -1),
                                       length=cfg.block_size).cpu().numpy()
            mlen = np.where(oidx > 0, 4, 0).astype(np.int32)
            offsets = None                # the hints carry offsets themselves
        else:
            mlen, oidx = find_matches(dplanes, offsets=offsets, nrows=nrows)
            mlen, oidx = mlen.cpu().numpy(), oidx.cpu().numpy()
        dst_len = np.zeros(n, np.int32)
        status = np.zeros(n, np.int32)
        native.set_emit_min_match(cfg.min_match)   # thread-local: the emits below
        for i in range(n):
            o, ln = int(raw_off[i]), int(manifest.raw_len[i])
            try:
                comp = emit(raw[o:o + ln], mlen[i].reshape(-1), oidx[i].reshape(-1),
                            offsets, dst_cap=staging.shape[1])
                staging[i, :comp.shape[0]] = comp
                dst_len[i] = comp.shape[0]
            except StatusError as e:
                status[i] = e.status.to_int()
        return dst_len, status

    def _ensure_committed(self, unit: CompressedUnit) -> None:
        """Upload a deferred-commit unit's compressed bytes to the arena
        before any device read."""
        if unit._committed:
            return
        if unit._staging is None:
            raise StatusError(Status.Invalid("uncommitted unit has no staging bytes"))
        m, cfg = unit.manifest, self.config
        wstep = max(128, cfg.slot_size // 8)
        with profiling.annotate("bitar.engine.commit_upload"):
            for s in range(0, m.nblocks, cfg.burst_size):
                e = min(m.nblocks, s + cfg.burst_size)
                w = int(m.comp_len[s:e].max(initial=1))
                w = min(cfg.slot_size, -(-w // wstep) * wstep)
                self.arena.write_burst([r.slot for r in unit.refs[s:e]],
                                       unit._staging[s:e, :w])
                profiling.count("engine.commit_bytes", (e - s) * w)
        unit._committed = True

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _plans_locked(self):
        """Hold ``_plan_lock``.  Traced, the wait for it is the span
        ``bitar.engine.plan_lock_wait``."""
        with profiling.annotate("bitar.engine.plan_lock_wait"):
            self._plan_lock.acquire()
        try:
            yield
        finally:
            self._plan_lock.release()

    def _pool_take(self, need_wire: int) -> dict[str, np.ndarray]:
        """The best-fitting grant of the free list whose wire holds
        ``need_wire`` cells, or a fresh one (caller holds ``_plan_lock``).
        A grant is 1-D capacity arrays: se/sh (flat wire) and dq/ra (compact
        dense planes, grown by :meth:`_pool_grow`)."""
        fits = [k for k, g in enumerate(self._PLAN_FREE) if g["se"].size >= need_wire]
        if fits:
            # Among equal fits, the grant returned last: its pages are warm.
            return self._PLAN_FREE.pop(
                min(reversed(fits), key=lambda k: self._PLAN_FREE[k]["se"].size))
        return {"se": np.empty(need_wire, np.int16), "sh": np.empty(need_wire, np.int32),
                "dq": np.empty(0, np.int16), "ra": np.empty(0, np.int32)}

    @staticmethod
    def _pool_grow(grant: dict[str, np.ndarray], need_dq: int, need_ra: int) -> None:
        """Ensure the grant's dense-plane capacities."""
        if grant["dq"].size < need_dq:
            grant["dq"] = np.empty(need_dq, np.int16)
        if grant["ra"].size < need_ra:
            grant["ra"] = np.empty(need_ra, np.int32)

    def _pool_put(self, plans: dict | None) -> None:
        """Return the grant of a plan dict to the free list."""
        grant = plans.pop("_pooled", None) if plans is not None else None
        if grant is not None:
            with self._plans_locked():
                self._PLAN_FREE.append(grant)

    def _prewarm_plan_scratch(self) -> None:
        """Fault the planner's full-chunk scratch and one unit grant in now,
        one thread per array (page faults scale across cores), so the first
        plan build does not pay them: the reference engine's four chunks of
        256 blocks and a grant for their 1024 blocks.  An arena of fewer
        slots skips them, since none of its units could fill them (a unit
        never has more blocks than the arena has slots).  Process-wide: what
        exists already is kept."""
        nrows = self.config.block_size // LANES
        nb = self._PLAN_CHUNK_BLOCKS
        nblk = nb * self._PLAN_PREWARM_CHUNKS
        if self.config.max_pool_slots < nblk:
            return
        with self._plans_locked():
            fresh = []
            for ci in range(self._PLAN_PREWARM_CHUNKS):
                key = (ci, nb, nrows)
                if key not in self._PLAN_CHUNK_SCRATCH:
                    bufs = (np.empty((nb, nrows, LANES), np.int16),
                            np.empty((nb, native.DENSE_PLANES, nrows), np.int32))
                    self._PLAN_CHUNK_SCRATCH[key] = bufs
                    fresh.extend(bufs)
            if not self._PLAN_FREE:
                # Capacities of the reference engine's grant: a wire of 4
                # passes a block at 1024 rows, dq for every block, and
                # anchors for 32 dense passes at 8 tiles.
                grant = {"se": np.empty(4 * nblk * 1024, np.int16),
                         "sh": np.empty(4 * nblk * 1024, np.int32),
                         "dq": np.empty(nblk * nrows * LANES, np.int16),
                         "ra": np.empty(nblk * 32 * LANES * 8, np.int32)}
                self._PLAN_FREE.append(grant)
                fresh.extend(grant.values())
            if fresh:
                with concurrent.futures.ThreadPoolExecutor(
                        min(len(fresh), os.cpu_count() or 1)) as pool:
                    list(pool.map(lambda b: b.fill(0), fresh))

    def _build_plans(self, manifest: BlockManifest, staging: np.ndarray):
        """Plan every block with the native batch planner (caller holds
        ``_plan_lock``).

        Returns (plans, comp_rows), or None when the blocks are narrower
        than 128 rows or the planner takes no block: the unit then decodes
        through its sequence tables.  Blocks the planner rejects keep
        ``p_used == 0`` (the kernel writes zeros for them) and are listed
        in ``plans["host_blocks"]`` for per-block host decode.  Zstd blocks
        plan over their entropy-decoded literal planes
        (``plans["lit_planes"]``).  The wire lives in a pooled grant
        (``plans["_pooled"]``)."""
        cfg = self.config
        nrows = cfg.block_size // LANES
        if nrows % LANES:
            return None
        n = manifest.nblocks
        slot = staging.shape[1]
        has_zstd = bool((manifest.codec_ids == _ZSTD_ID).any())
        lit_out = np.empty(n * cfg.block_size, np.uint8) if has_zstd else None
        # The reference engine schedules > 1024-row planes under its
        # banded-gather constraint; kept so the plans stay identical.
        band_rows = KBAND if (nrows % min(KBAND, nrows) == 0 and nrows > 1024) else 0
        chunk = self._PLAN_CHUNK_BLOCKS

        def chunk_bufs(ci: int, nb: int):
            """Chunk ci's dense-plane scratch (chunks coexist until the
            compaction below, so each has its own).  No zeroing, here or on
            reuse: the planner defines every plane of a block it reports
            dense (plan.cc Densify)."""
            key = (ci, nb, nrows)
            bufs = self._PLAN_CHUNK_SCRATCH.get(key)
            if bufs is None:
                bufs = (np.empty((nb, nrows, LANES), np.int16),
                        np.empty((nb, native.DENSE_PLANES, nrows), np.int32))
                self._PLAN_CHUNK_SCRATCH[key] = bufs
            return bufs

        def plan_one(s: int, e: int, brows: int, bufs):
            dq_buf, ra_buf = bufs
            lit = (lit_out[s * cfg.block_size:e * cfg.block_size]
                   if lit_out is not None else None)
            ctx, pu, p0c, st, lu, dq, ra, ds = native.plan_batch_begin(
                staging[s:e].reshape(-1),
                np.arange(e - s, dtype=np.int64) * slot,
                manifest.comp_len[s:e], manifest.raw_len[s:e],
                manifest.codec_ids[s:e], nrows, self._PLAN_MAX_PASSES, cb=CB,
                lit_out=lit, lit_stride=cfg.block_size,
                band_rows=brows, dq_buf=dq_buf, ra_buf=ra_buf)
            bad = st != 0
            pu[bad] = 0
            p0c[bad] = 0
            ds[bad] = 0
            return (ctx, s, e), pu, p0c, st, lu, dq, ra, ds

        def plan_all(brows: int):
            # Chunks plan concurrently: each is one native call that drops
            # the GIL and touches disjoint staging rows and buffers, handed
            # out here first.
            spans = [(s, min(n, s + chunk)) for s in range(0, n, chunk)]
            bufs = [chunk_bufs(ci, e - s) for ci, (s, e) in enumerate(spans)]
            with concurrent.futures.ThreadPoolExecutor(
                    min(len(spans), os.cpu_count() or 1)) as pool:
                parts = list(pool.map(lambda a: plan_one(*a[0], brows, a[1]),
                                      zip(spans, bufs)))
            return ([p[0] for p in parts],
                    *(np.concatenate([p[k] for p in parts]) for k in (1, 2, 3, 4)),
                    [p[5] for p in parts], [p[6] for p in parts],
                    np.concatenate([p[7] for p in parts]))

        def abort_all(ctxs):
            for ctx, _, _ in ctxs:
                native.plan_batch_abort(ctx)

        ctxs, p_used, p0, st, lit_used, dq_parts, ra_parts, dense = plan_all(band_rows)
        if band_rows and (st != 0).any():
            # Banding must never shrink device coverage: re-plan unbanded.
            abort_all(ctxs)
            band_rows = 0
            ctxs, p_used, p0, st, lit_used, dq_parts, ra_parts, dense = plan_all(0)
        ok = st == 0
        if not ok.any():
            abort_all(ctxs)
            return None

        # Flat wire: S quantized as in the reference, plus DCHUNK slack rows.
        p_off = np.zeros(n, np.int64)
        p_off[1:] = np.cumsum(p_used[:-1].astype(np.int64))
        S = int(p_used.astype(np.int64).sum())
        s_pad = -(-(S + DCHUNK) // _S_QUANTUM) * _S_QUANTUM
        tiles = nrows // LANES
        # The pack covers pass rows [0, S); only the tail of a reused
        # buffer needs zeros.
        need_wire = s_pad * tiles * LANES
        pooled = self._pool_take(need_wire)
        se = pooled["se"][:need_wire].reshape(s_pad, tiles, LANES)
        sh = pooled["sh"][:need_wire].reshape(s_pad, tiles, LANES)
        se[S:] = 0
        sh[S:] = 0
        for ctx, s, e in ctxs:
            native.plan_batch_pack(ctx, p_off[s:e], se, sh)
        # Dense comp-pass planes, compacted: only blocks with dense > 0
        # carry a wire row; dq_idx maps each block to its row
        # (forward-filled).  Anchor planes trim to a power-of-two dcap.
        dense = dense.astype(np.int32)
        nd = int((dense > 0).sum())
        dmax = max(1, int(dense.max(initial=0)))
        dcap = 1 << (dmax - 1).bit_length()
        if nd:
            need_dq, need_ra = nd * nrows * LANES, nd * dcap * nrows
            self._pool_grow(pooled, need_dq, need_ra)
            dq_c = pooled["dq"][:need_dq].reshape(nd, nrows, LANES)
            ra_c = pooled["ra"][:need_ra].reshape(nd, dcap, LANES, tiles)
            o = 0
            for (_, s, e), dqp, rap in zip(ctxs, dq_parts, ra_parts, strict=True):
                selc = np.flatnonzero(dense[s:e] > 0).astype(np.int64)
                if selc.size:
                    native.plan_dense_pack(
                        selc, dqp, dq_c[o:o + selc.size],
                        rap.reshape(e - s, -1, nrows),
                        ra_c[o:o + selc.size].reshape(selc.size, -1),
                        nrows, dcap, ndense=dense[s:e])
                    o += selc.size
        else:
            dq_c = np.zeros((1, nrows, LANES), np.int16)
            ra_c = np.zeros((1, dcap, LANES, tiles), np.int32)
        dq_idx = np.maximum(np.cumsum(dense > 0) - 1, 0).astype(np.int32)
        plans = {"p_used": p_used.astype(np.int32), "p_off": p_off.astype(np.int32),
                 "p0": p0.astype(np.int32), "se": se, "shift": sh,
                 "dq": dq_c, "row_a": ra_c, "dense": dense, "dq_idx": dq_idx,
                 "host_blocks": np.flatnonzero(~ok).astype(np.int32), "_pooled": pooled}
        # Source-plane bytes per block: the compressed stream, or a Zstd
        # block's literal plane.
        plane_bytes = manifest.comp_len.astype(np.int64).copy()
        if has_zstd:
            zmask = ok & (lit_used > 0)
            plane_bytes[zmask] = lit_used[zmask]
            plans["lit_planes"] = {
                int(i): lit_out[int(i) * cfg.block_size:
                                int(i) * cfg.block_size + int(lit_used[i])].copy()
                for i in np.flatnonzero(zmask)}

        def _round_rows(nbytes: int) -> int:
            r = max(128, -(-nbytes // 128))
            r = -(-r // 128) * 128
            if r > 128:
                r = -(-r // KBAND) * KBAND
            return r

        comp_rows = _round_rows(int(plane_bytes.max(initial=1)))
        return plans, comp_rows

    def _build_tables(self, manifest: BlockManifest, staging: np.ndarray
                      ) -> tuple[dict[str, np.ndarray] | None, np.ndarray | None]:
        """Parse every block's sequence table; a RAW block is one literal
        run of its stored bytes.  Returns (tables, nseq) padded to a
        power-of-two row count of at least 128, or (None, None) when a
        block is Zstd, malformed, or decodes to another size than its
        manifest says: the unit then decodes on the host."""
        per_block: list[dict[str, np.ndarray]] = []
        for i in range(manifest.nblocks):
            codec = codec_from_id(int(manifest.codec_ids[i]))
            ln = int(manifest.raw_len[i])
            if codec == Codec.RAW:
                per_block.append({"lit_ptr": np.zeros(1, np.int32),
                                  "lit_len": np.array([ln], np.int32),
                                  "off": np.zeros(1, np.int32),
                                  "mlen": np.zeros(1, np.int32),
                                  "out_pos": np.zeros(1, np.int32)})
                continue
            if codec not in _PARSERS:
                return None, None
            try:
                t = native.parse_sequences(staging[i, :int(manifest.comp_len[i])],
                                           _PARSERS[codec])
            except StatusError:
                return None, None
            ends = t["out_pos"] + t["lit_len"] + t["mlen"]
            total = int(ends[-1]) if ends.shape[0] else 0
            if total != ln or (ends.shape[0] and int(ends.max()) > self.config.block_size):
                logger.warning("block %d: parsed decode size %d != manifest raw_len %d; "
                               "the unit decodes on the host", i, total, ln)
                return None, None
            per_block.append(t)
        cap = max(t["lit_ptr"].shape[0] for t in per_block)
        cap = max(128, 1 << (cap - 1).bit_length())
        return pad_tables(per_block, SEQUENCE_KEYS, multiple=cap)

    def _submit_plan_build(self, manifest: BlockManifest, staging: np.ndarray):
        """Queue a plan build on the engine's single plan worker."""
        if self._plan_executor is None:
            self._plan_executor = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="btt-plan")

        def build():
            with self._plans_locked(), profiling.annotate("bitar.engine.plan_build"):
                return self._build_plans(manifest, staging)

        return self._plan_executor.submit(build)

    def _join_plan_build(self, unit: CompressedUnit, cancel: bool = False):
        """Resolve a unit's pending background plan build: the plans, or
        None when it was cancelled before it started.  A build that raised
        raises here."""
        fut = unit._plan_future
        unit._plan_future = None
        if cancel and fut.cancel():
            return None
        with profiling.annotate("bitar.engine.plan_join"):
            return fut.result()

    def ensure_plans(self, unit: CompressedUnit) -> None:
        """Build the unit's decode sidecar on demand (once).

        With ``plan_build="background"`` compress already started the plan
        build and this joins it; otherwise the plan builds here.  A unit
        that cannot be planned gets sequence tables instead.  A
        deferred-commit unit is uploaded here, before its staging copy is
        dropped."""
        self._entry_guard()
        unit._check_live()
        if unit._planned:
            return
        with profiling.annotate("bitar.engine.ensure_plans"):
            staging = self._staging_rows(unit)
            self._ensure_committed(unit)
            if unit._plan_future is not None:
                plans = self._join_plan_build(unit)
            else:
                with self._plans_locked(), profiling.annotate("bitar.engine.plan_build"):
                    plans = self._build_plans(unit.manifest, staging)
            if plans is not None:
                unit.plan_flat, unit.plan_comp_rows = plans
            elif unit.tables is None:
                unit.tables, unit.nseq = self._build_tables(unit.manifest, staging)
            unit._planned = True
            unit._drop_staging()

    def ensure_tables(self, unit: CompressedUnit) -> None:
        """Build the unit's sequence tables on demand, from its staging copy
        or its arena slots (for callers that want the table path of a unit
        that also has plans)."""
        self._entry_guard()
        unit._check_live()
        if unit.tables is None:
            unit.tables, unit.nseq = self._build_tables(
                unit.manifest, self._staging_rows(unit))

    # ------------------------------------------------------------------
    def decompress(self, unit: CompressedUnit, out: np.ndarray | None = None
                   ) -> np.ndarray:
        """Synchronous decompress of a unit back to raw bytes.

        ``out`` may be a caller buffer of at least ``total_raw`` bytes; the
        returned view is sized exactly.  Raises on any block failure,
        naming every failed block; :meth:`decompress_status` is the
        non-raising per-block form."""
        out, status = self.decompress_status(unit, out)
        bad = np.flatnonzero(status < 0)
        if bad.size:
            raise StatusError(Status.from_int(
                int(status[bad[0]]),
                f"decompress failed on {bad.size}/{status.shape[0]} blocks "
                f"{bad.tolist()[:16]} (statuses {status[bad].tolist()[:16]})"))
        return out

    def decompress_status(self, unit: CompressedUnit,
                          out: np.ndarray | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Decompress with per-block status (never raises for data errors).

        Returns ``(out_view, status)``; ``status[i]`` is 0 for a good block
        and a negative StatusCode for a failed one."""
        with profiling.annotate("bitar.engine.decompress"):
            self._entry_guard()
            unit._check_live()
            if unit.engine is not self:
                raise StatusError(Status.Invalid("unit was produced by a different engine"))
            m = unit.manifest
            if out is None:
                out = np.empty(m.total_raw, dtype=np.uint8)
            elif out.shape[0] < m.total_raw:
                raise StatusError(Status.CapacityError(
                    f"output buffer {out.shape[0]} < total_raw {m.total_raw}"))

            kernels = self.config.use_tpu_kernels
            if kernels:
                self.ensure_plans(unit)
            if kernels and unit.plan_flat is not None:
                status = self._decompress_gpu_planned(unit, out)
            elif kernels and unit.tables is not None:
                status = self._decompress_gpu_tables(unit, out)
            else:
                status = self._decompress_host(unit, out)

            if m.checksum_kind != Checksum.NONE:
                raw_off = m.raw_off
                for i in range(m.nblocks):
                    if status[i] < 0:
                        continue
                    o, ln = int(raw_off[i]), int(m.raw_len[i])
                    if checksum_of(m.checksum_kind, out[o:o + ln]) != int(m.checksums[i]):
                        status[i] = Status.IOError("").to_int()
            bad = int((status < 0).sum())
            if bad:
                self.stats.dequeue_err_blocks += bad
                logger.warning("decompress: %d/%d blocks failed (engine error count "
                               "now %d)", bad, m.nblocks, self.error_count())
            self.stats.bytes_decompressed += int(m.total_raw)
            return out[:m.total_raw], status

    def error_count(self) -> int:
        """Accumulated per-block error counters."""
        return self.stats.enqueue_err_blocks + self.stats.dequeue_err_blocks

    def decompress_device(self, unit: CompressedUnit, on_burst=None) -> list[torch.Tensor]:
        """Decompress on the device: per-burst ``[burst, nrows, 128]`` uint8
        tensors in block order, with no host readout (host-decoded blocks
        are zero planes here).  ``on_burst(k)``, when given, is called right
        after burst k's launch is queued (to record a CUDA event behind
        it)."""
        with profiling.annotate("bitar.engine.decompress_device"):
            self._entry_guard()
            unit._check_live()
            self.ensure_plans(unit)
            if unit.plan_flat is not None:
                results = [r for _, _, r in self._planned_bursts(unit, on_burst)]
            elif unit.tables is not None:
                results = [r for _, _, r in self._decode_bursts(unit, on_burst)]
            else:
                raise StatusError(Status.NotImplemented(
                    "device-resident decompress requires a device-decodable unit "
                    "(lz4/snappy/raw with sequence tables, or a plan)"))
            self.stats.device_decode_bursts += len(results)
            return results

    def decompress_blocks_device(self, units, unit_idx, block_idx) -> torch.Tensor:
        """Decompress chosen blocks of resident units on the device.

        Pick ``j`` is block ``block_idx[j]`` of ``units[unit_idx[j]]``
        (``unit_idx``, ``block_idx``: integer arrays of one length k; a block
        may be picked more than once).  Returns ``[k, nrows, 128]`` uint8
        planes in pick order, on the device, with no host readout; a block
        the planner left to the host is a zero plane, as in
        :meth:`decompress_device`.  The host's work grows with the units
        touched, not with k:

        * the picks of sequence-table units decode together, in ceil(picks /
          ``burst_size``) launches of the table kernel over their slots and
          the engine's table store (:meth:`_table_store_enter`), read in
          place on the card through one upload of the picks' slots, gathered
          on the CPU;
        * each planned unit touched is one launch of the flat kernel over
          its picks' plan entries, reading the picked slots in place on the
          card; the CPU and Zstd units (whose literal planes replace rows)
          gather them.

        Raises StatusError for picks that are not two integer arrays of one
        length, a unit or block index out of range, a recycled unit or one
        of another engine, and a unit that cannot decode on the device.
        Traced, the span ``bitar.engine.decompress_blocks_device`` and the
        counters ``engine.picked_blocks`` and ``engine.picked_units``."""
        with profiling.annotate("bitar.engine.decompress_blocks_device"):
            self._entry_guard()
            ui, bi = np.asarray(unit_idx), np.asarray(block_idx)
            k = ui.size
            if ui.ndim != 1 or ui.shape != bi.shape or (k and not (
                    ui.dtype.kind in "iu" and bi.dtype.kind in "iu")):
                raise StatusError(Status.Invalid(
                    f"picks: want two integer arrays of one length, got "
                    f"{ui.dtype} {list(ui.shape)} and {bi.dtype} {list(bi.shape)}"))
            nrows = self.config.block_size // LANES
            if not k:
                return torch.empty((0, nrows, LANES), dtype=torch.uint8, device=self.device)
            ui, bi = ui.astype(np.int64, copy=False), bi.astype(np.int64, copy=False)
            lo, hi = int(ui.min()), int(ui.max())
            if lo < 0 or hi >= len(units):
                raise StatusError(Status.Invalid(
                    f"unit index {lo}..{hi} outside the {len(units)} units given"))
            # The touched units, and each pick's index among them.
            counts = np.bincount(ui - lo)
            touched = np.flatnonzero(counts)
            of = (np.cumsum(counts > 0) - 1)[ui - lo]
            picked = [units[lo + u] for u in touched.tolist()]
            for unit in picked:
                unit._check_live()
                if unit.engine is not self:
                    raise StatusError(Status.Invalid("unit was produced by a different engine"))
                self.ensure_plans(unit)
                if unit.plan_flat is None and unit.tables is None:
                    raise StatusError(Status.NotImplemented(
                        "device-resident decompress requires a device-decodable unit "
                        "(lz4/snappy/raw with sequence tables, or a plan)"))
            nb = np.array([unit.nblocks for unit in picked])
            bad = np.flatnonzero((bi < 0) | (bi >= nb[of]))
            if bad.size:
                j = int(bad[0])
                raise StatusError(Status.Invalid(
                    f"block index {bi[j]} outside unit {ui[j]}'s {nb[of[j]]} blocks"))
            profiling.count("engine.picked_blocks", k)
            profiling.count("engine.picked_units", len(picked))
            table = np.array([unit.plan_flat is None for unit in picked])
            launches = self._table_picks(picked, table, of, bi, nrows) if table.any() else []
            if not table.all():
                order = np.argsort(of, kind="stable")       # each unit's picks, in pick order
                ends = np.cumsum(counts[touched])
                for j, unit in enumerate(picked):
                    if not table[j]:
                        pos = order[ends[j] - counts[touched[j]]:ends[j]]
                        launches.append(self._planned_picks(unit, pos, bi[pos], nrows))
            self.stats.device_decode_bursts += len(launches)
            self.stats.enqueued_blocks += k
            if len(launches) == 1:           # its positions are the picks, in order
                return launches[0][1]
            out = torch.empty((k, nrows, LANES), dtype=torch.uint8, device=self.device)
            for pos, planes in launches:
                out.index_copy_(0, torch.from_numpy(pos).to(self.device), planes)
            return out

    def _table_picks(self, picked: list, table: np.ndarray, of: np.ndarray, bi: np.ndarray,
                     nrows: int) -> list[tuple[np.ndarray, torch.Tensor]]:
        """Launch the table kernel over the picks of sequence-table units,
        ``burst_size`` picks a launch in pick order: [(pick positions,
        planes)].  ``picked``: the touched units, ``table``: which of them
        have sequence tables, ``of``: each pick's touched unit, ``bi``: its
        block.  Each pick's slot comes from the units' host slot tables
        (:meth:`_pick_slot_map`), uploaded once a call.  In place
        (:meth:`_in_place`: table units have no literal planes) each launch
        reads the picks' slots and table-store rows where they lie, through
        those slots (traced, the counter ``arena.inplace_blocks``);
        elsewhere it gathers both first."""
        every = table.all()
        units = picked if every else [unit for unit, t in zip(picked, table, strict=True) if t]
        for unit in units:
            self._table_store_enter(unit)
        starts, slots = self._pick_slot_map(units)
        if every:                       # the common case: no pick to leave out
            k = bi.size
            rows = starts[of] + bi
        else:
            pos = np.flatnonzero(table[of])
            k = pos.size
            rows = starts[(np.cumsum(table) - 1)[of[pos]]] + bi[pos]
        src = torch.from_numpy(slots[rows]).to(self.device)
        nseq, cols = self._table_store
        burst = self.config.burst_size

        def at(s: int) -> np.ndarray:
            """The pick positions of the launch from pick ``s`` on."""
            return np.arange(s, min(k, s + burst)) if every else pos[s:s + burst]

        if self._in_place(units[0]):
            profiling.count("arena.inplace_blocks", k)
            return [(at(s), decode_blocks(self.arena.buffer, nseq, self._table_views,
                                          out_rows=nrows, src_rows=src[s:s + burst]))
                    for s in range(0, k, burst)]

        def stored_bytes(span: slice) -> int:
            """The stored bytes of the picks ``span`` (asked while tracing)."""
            return int(np.concatenate([unit.manifest.comp_len for unit in units])[rows[span]].sum())

        launches = []
        for s in range(0, k, burst):
            sl = src[s:s + burst]
            comp = self._gather_slots(sl, lambda: stored_bytes(slice(s, s + burst)))
            tables = dict(zip(SEQUENCE_KEYS, cols.index_select(1, sl).unbind(0), strict=True))
            launches.append((at(s), decode_blocks(comp, nseq.index_select(0, sl), tables,
                                                  out_rows=nrows)))
        return launches

    def _pick_slot_map(self, units: list) -> tuple[np.ndarray, np.ndarray]:
        """The host slot tables of ``units`` laid end to end, and each
        unit's first row there: block ``b`` of ``units[i]`` lies in slot
        ``slots[starts[i] + b]``.  Kept for the next call that touches the
        same units (a MultiGet's batches touch the same SSTs), so such a
        call copies no unit's table; a call over other units builds it anew
        (about what looking each pick up in its own unit's table costs).
        It holds the units until then, ``recycle`` or ``release``."""
        kept = self._pick_slots
        if kept is None or len(kept[0]) != len(units) or any(
                a is not b for a, b in zip(kept[0], units)):
            tables = [unit.host_slot_table() for unit in units]
            nb = np.array([t.size for t in tables], np.int64)
            kept = self._pick_slots = (units, np.cumsum(nb) - nb, np.concatenate(tables))
        return kept[1], kept[2]

    def _planned_picks(self, unit: CompressedUnit, pos: np.ndarray, blocks: np.ndarray,
                       nrows: int) -> tuple[np.ndarray, torch.Tensor]:
        """One flat-kernel launch over a planned unit's picks ``blocks``:
        (pick positions, planes), its source from :meth:`_flat_source`."""
        idx = torch.from_numpy(blocks).to(self.device)
        comp, src = self._flat_source(unit, idx)
        return pos, decode_blocks_flat(comp, self._plan_rows(unit.plan_device_arrays(), idx),
                                       comp_rows=unit.plan_comp_rows, out_rows=nrows,
                                       src_rows=src)

    def _table_store_enter(self, unit: CompressedUnit) -> None:
        """Put a sequence-table unit's tables into the engine's table store,
        once: the store's row ``r`` holds the table of the block in arena
        slot ``r``, so the picks of any units index one store.  It is as
        wide as its widest unit (zero columns past a narrower table decode
        alike) and widens when a wider unit enters; :meth:`recycle` zeroes a
        unit's rows."""
        if unit._in_table_store:
            return
        tables = torch.from_numpy(np.stack([unit.tables[k] for k in SEQUENCE_KEYS]))
        width = tables.shape[2]
        if self._table_store is None or self._table_store[1].shape[2] < width:
            nslots = self.arena.buffer.shape[0]
            cols = torch.zeros((len(SEQUENCE_KEYS), nslots, width), dtype=torch.int32,
                               device=self.device)
            if self._table_store is None:
                nseq = torch.zeros(nslots, dtype=torch.int32, device=self.device)
            else:
                nseq, old = self._table_store
                cols[:, :, :old.shape[2]] = old
            self._table_store = (nseq, cols)
            self._table_views = dict(zip(SEQUENCE_KEYS, cols.unbind(0), strict=True))
        nseq, cols = self._table_store
        slots = unit.slot_table().long()
        tables = torch.nn.functional.pad(tables.to(self.device), (0, cols.shape[2] - width))
        cols.index_copy_(1, slots, tables)
        nseq.index_copy_(0, slots, torch.from_numpy(unit.nseq.astype(np.int32)).to(self.device))
        unit._in_table_store = True

    def _decode_bursts(self, unit: CompressedUnit, on_burst=None):
        """Launch the sequence-table decode kernel burst by burst
        (:meth:`_launch_bursts`) over gathered rows.  The tables upload
        once per unit."""
        nrows = self.config.block_size // LANES
        nseq, cols = unit.table_device_arrays()
        return self._launch_bursts(unit, on_burst, lambda blocks: decode_blocks(
            self._unit_rows(unit, blocks), nseq[blocks],
            {k: v[blocks] for k, v in cols.items()}, out_rows=nrows))

    def _launch_bursts(self, unit: CompressedUnit, on_burst, launch):
        """Queue ``launch(blocks)`` for each burst of ``unit`` (a slice of up
        to ``burst_size`` blocks) on the current stream, behind the unit's
        commit: [(start, stop, device result [stop - start, nrows, 128])].
        ``on_burst(k)``, when given, is called right after burst k's launch."""
        self._ensure_committed(unit)
        launches = []
        for start in range(0, unit.nblocks, self.config.burst_size):
            stop = min(unit.nblocks, start + self.config.burst_size)
            launches.append((start, stop, launch(slice(start, stop))))
            self.stats.enqueued_blocks += stop - start
            if on_burst is not None:
                on_burst(len(launches) - 1)
        return launches

    def _gather_slots(self, slots: torch.Tensor, stored_bytes) -> torch.Tensor:
        """The arena rows of ``slots`` (an integer tensor on the device),
        ``DeviceArena.gather_burst``.  Traced, the span
        ``bitar.arena.gather_burst`` and the counters ``arena.gather_bytes``
        (whole slots) and ``arena.gather_stored_bytes`` (the blocks' stored
        bytes: ``stored_bytes()``, asked only while tracing)."""
        with profiling.annotate("bitar.arena.gather_burst"):
            rows = self.arena.gather_burst(slots)
        if profiling.enabled():
            profiling.count("arena.gather_bytes", rows.numel())
            profiling.count("arena.gather_stored_bytes", stored_bytes())
        return rows

    def _in_place(self, unit: CompressedUnit) -> bool:
        """Whether decode launches read ``unit``'s blocks where they lie in
        the arena (:func:`_reads_in_place`: on the card) rather than
        gathered: not when Zstd literal planes replace some of its rows."""
        return _reads_in_place(self.device) and not (unit.plan_flat or {}).get("lit_planes")

    def _flat_source(self, unit: CompressedUnit, blocks: slice | torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """``(comp, src_rows)`` of a flat-kernel launch over ``blocks`` of
        ``unit`` (see :func:`_select`).  In place (:meth:`_in_place`): the
        arena's buffer and the blocks' rows of the unit's slot table (a view
        for a slice), traced as the counter ``arena.inplace_blocks``.
        Otherwise the gathered rows of :meth:`_unit_rows`, and None."""
        if self._in_place(unit):
            src = _select(unit.slot_table(), blocks)
            profiling.count("arena.inplace_blocks", src.shape[0])
            return self.arena.buffer, src
        return self._unit_rows(unit, blocks), None

    def _unit_rows(self, unit: CompressedUnit, blocks: slice | torch.Tensor) -> torch.Tensor:
        """The arena rows of ``blocks`` of ``unit`` (see :func:`_select`),
        gathered through its slot table (:meth:`_gather_slots`), with Zstd
        blocks' literal planes in place of their compressed bytes."""
        def stored_bytes() -> int:
            # A slice of comp_len: indexing it by a burst's ints instead
            # costs ~0.1 ms a 1024-block burst.
            at = blocks if isinstance(blocks, slice) else blocks.cpu().numpy()
            return int(unit.manifest.comp_len[at].sum())

        rows = self._gather_slots(_select(unit.slot_table(), blocks), stored_bytes)
        lit = unit.lit_device_arrays(rows.shape[1])
        if lit is None:
            return rows
        planes, at = lit[0], _select(lit[1], blocks)
        return torch.where((at >= 0)[:, None], planes.index_select(0, at.clamp(min=0)), rows)

    @staticmethod
    def _plan_rows(pt: dict[str, torch.Tensor], blocks: slice | torch.Tensor) -> dict:
        """A unit's plan wire ``pt`` narrowed to ``blocks`` (see :func:`_select`)."""
        plans = dict(pt)
        for key in _BLOCK_KEYS:
            plans[key] = _select(pt[key], blocks)
        return plans

    def _planned_bursts(self, unit: CompressedUnit, on_burst=None):
        """Launch the flat decode kernel burst by burst
        (:meth:`_launch_bursts`), each from its kept record
        (:meth:`_burst_launch`)."""
        return self._launch_bursts(unit, on_burst, lambda blocks: self._burst_launch(unit, blocks))

    def _burst_launch(self, unit: CompressedUnit, blocks: slice) -> torch.Tensor:
        """B1 over the burst ``blocks`` of ``unit`` from the burst's record
        (:class:`FlatLaunch`: its plan rows, checks and launch shape), built
        at the burst's first decode from :meth:`_flat_source` and kept on the
        unit until :meth:`recycle`.  In place it reads the arena through the
        burst's rows of the slot table, counted as ``arena.inplace_blocks``;
        otherwise every call gathers the burst's rows anew."""
        rec = unit._flat_launches.get(blocks.start)
        if rec is not None and rec.src_rows is not None:
            profiling.count("arena.inplace_blocks", rec.n)
            return rec.run()
        comp, src = self._flat_source(unit, blocks)
        if rec is None:
            rec = unit._flat_launches[blocks.start] = prepare_flat_launch(
                comp, self._plan_rows(unit.plan_device_arrays(), blocks),
                comp_rows=unit.plan_comp_rows, out_rows=self.config.block_size // LANES,
                src_rows=src)
        return rec.run(comp)

    def prepare_device_decode(self, unit: CompressedUnit):
        """Stage a fully-planned unit for repeated device-resident decode.

        Returns a zero-argument ``launch``: each call runs ONE whole-unit
        decode on inputs staged here and returns the [nblocks, nrows, 128]
        uint8 device tensor, with no host transfer.  Its source comes from
        :meth:`_flat_source`: in place, each launch reads the unit's slots
        in the arena as they are then; otherwise from rows gathered here."""
        self._entry_guard()
        unit._check_live()
        self.ensure_plans(unit)
        if unit.plan_flat is None or unit.plan_flat["host_blocks"].size:
            raise StatusError(Status.NotImplemented(
                "prepare_device_decode requires a fully-planned unit"))
        self._ensure_committed(unit)
        nrows = self.config.block_size // LANES
        comp_rows = unit.plan_comp_rows
        comp, src = self._flat_source(unit, slice(0, unit.nblocks))
        rec = prepare_flat_launch(comp, unit.plan_device_arrays(), comp_rows=comp_rows,
                                  out_rows=nrows, src_rows=src)
        return lambda: rec.run(comp)

    def _decompress_gpu_planned(self, unit: CompressedUnit, out: np.ndarray
                                ) -> np.ndarray:
        """Planned device decode; blocks the planner rejected decode on the
        host while the kernel launches run."""
        m = unit.manifest
        status = np.zeros(m.nblocks, np.int32)
        launches = self._planned_bursts(unit)
        self.stats.device_decode_bursts += len(launches)
        host_blocks = unit.plan_flat["host_blocks"]
        if host_blocks.size:
            self._decompress_host_subset(unit, out, host_blocks.astype(np.int64), status)
        self._land_bursts(unit, out, launches, skip=set(host_blocks.tolist()))
        return status

    def _decompress_gpu_tables(self, unit: CompressedUnit, out: np.ndarray) -> np.ndarray:
        """Sequence-table device decode.  While the launches run, the host
        re-walks the framing of every slot written since the last walk
        (``_validate_table_unit``), so the status stays real per block."""
        status = np.zeros(unit.nblocks, np.int32)
        launches = self._decode_bursts(unit)
        self.stats.device_decode_bursts += len(launches)
        self._land_bursts(unit, out, launches,
                          validate=lambda: self._validate_table_unit(unit, status))
        return status

    def _land_bursts(self, unit: CompressedUnit, out: np.ndarray, launches,
                     skip: set = frozenset(), validate=None) -> None:
        """Read the launched bursts back on a pool of two threads and land
        each in ``out`` as its readback completes (out of order, as the
        reference engine: the regions are disjoint), leaving the blocks in
        ``skip`` as they are.  ``validate``, when given, runs on a third
        thread meanwhile and is joined last.  Traced, the span
        ``bitar.engine.copy_out`` and the counter ``engine.copy_out_bytes``
        for each burst."""
        raw_off, raw_len = unit.manifest.raw_off, unit.manifest.raw_len
        with concurrent.futures.ThreadPoolExecutor(2 + (validate is not None)) as ex:
            vfut = ex.submit(validate) if validate is not None else None
            pending = self._read_bursts(ex, launches)
            for done in concurrent.futures.as_completed(pending):
                start, stop = pending[done]
                host = done.result().reshape(stop - start, -1)
                with profiling.annotate("bitar.engine.copy_out"):
                    for i in range(start, stop):
                        if i not in skip:
                            o, ln = int(raw_off[i]), int(raw_len[i])
                            out[o:o + ln] = host[i - start, :ln]
                if profiling.enabled():
                    skipped = sum(int(raw_len[i]) for i in skip if start <= i < stop)
                    profiling.count("engine.copy_out_bytes",
                                    int(raw_len[start:stop].sum()) - skipped)
                self.stats.dequeued_blocks += stop - start
            if vfut is not None:
                vfut.result()

    def _read_bursts(self, pool: concurrent.futures.Executor, launches
                     ) -> dict[concurrent.futures.Future, tuple[int, int]]:
        """Submit each launched burst's readback to ``pool``: {future:
        (start, stop)}.  On the card a readback runs on the caller's current
        stream, behind the burst's launch."""
        stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        return {pool.submit(self._readback, result, stream): (start, stop)
                for start, stop, result in launches}

    @staticmethod
    def _readback(result: torch.Tensor, stream) -> np.ndarray:
        """A burst's decoded planes on the host.  Traced, the span
        ``bitar.engine.readback`` (on the pool thread that runs it) and the
        counter ``engine.readback_bytes``."""
        with profiling.annotate("bitar.engine.readback"):
            if stream is None:
                host = result.numpy()
            else:
                with torch.cuda.stream(stream):
                    host = result.cpu().numpy()
        profiling.count("engine.readback_bytes", host.nbytes)
        return host

    def _validate_table_unit(self, unit: CompressedUnit, status: np.ndarray) -> None:
        """Re-parse the current slot bytes of every block whose slot was
        written since the last walk, and check its decoded extent against
        the manifest; failures land in ``status``.  The tables the kernel
        runs were parsed earlier, so a slot rewritten since would otherwise
        decode garbage silently.  Generations are read before the bytes, so
        a write racing the gather is walked again next time."""
        m = unit.manifest
        slots = [r.slot for r in unit.refs]
        gens = self.arena.slot_generations(slots)
        if unit._val_gen is None:
            stale = np.arange(m.nblocks)
            unit._val_status = np.zeros(m.nblocks, np.int32)
        else:
            stale = np.flatnonzero(gens != unit._val_gen)
        bad_io = Status.IOError("").to_int()
        for start in range(0, stale.shape[0], self.config.burst_size):
            idx = stale[start:start + self.config.burst_size]
            rows = self.arena.gather_burst([slots[int(i)] for i in idx]).cpu().numpy()
            for j, ii in enumerate(idx):
                i = int(ii)
                st = 0
                codec = codec_from_id(int(m.codec_ids[i]))
                if codec == Codec.RAW:
                    if int(m.comp_len[i]) != int(m.raw_len[i]):
                        st = bad_io
                else:
                    try:
                        t = native.parse_sequences(rows[j, :int(m.comp_len[i])],
                                                   _PARSERS[codec])
                        ends = t["out_pos"] + t["lit_len"] + t["mlen"]
                        if (int(ends[-1]) if ends.shape[0] else 0) != int(m.raw_len[i]):
                            st = bad_io
                    except StatusError as e:
                        st = e.status.to_int()
                unit._val_status[i] = st
        unit._val_gen = gens
        bad = unit._val_status < 0
        status[bad] = unit._val_status[bad]

    def _decompress_host_subset(self, unit: CompressedUnit, out: np.ndarray,
                                idx: np.ndarray, status: np.ndarray) -> None:
        """Host-decode a subset of blocks into ``out``; per-block status."""
        m = unit.manifest
        slots = [unit.refs[int(i)].slot for i in idx]
        rows = self.arena.gather_burst(slots).cpu().numpy()
        slot = rows.shape[1]
        dst_len, st = registry.host_decompress_batch(
            self.config.codec, rows.reshape(-1),
            np.arange(len(slots), dtype=np.int64) * slot,
            m.comp_len[idx], out, m.raw_off[idx],
            m.raw_len[idx].astype(np.int32), codec_ids=m.codec_ids[idx])
        st = st.copy()
        st[(st == 0) & (dst_len != m.raw_len[idx])] = Status.IOError("").to_int()
        status[idx] = st
        self.stats.host_decode_bursts += 1

    def _decompress_host(self, unit: CompressedUnit, out: np.ndarray) -> np.ndarray:
        m = unit.manifest
        comp = unit.to_host()
        dst_len, status = registry.host_decompress_batch(
            self.config.codec, comp.packed, m.comp_off, m.comp_len,
            out, m.raw_off, m.raw_len.astype(np.int32), codec_ids=m.codec_ids)
        status = status.copy()
        status[(status == 0) & (dst_len != m.raw_len)] = Status.IOError("").to_int()
        self.stats.host_decode_bursts += 1
        self.stats.enqueued_blocks += m.nblocks
        self.stats.dequeued_blocks += m.nblocks
        return status

    # ------------------------------------------------------------------
    def import_unit(self, cb: CompressedBuffers) -> CompressedUnit:
        """Stage foreign compressed data (standard LZ4/Snappy/Zstd blocks)
        into the arena."""
        self._entry_guard()
        m = cb.manifest
        if m.block_size != self.config.block_size:
            raise StatusError(Status.Invalid(
                f"container block_size {m.block_size} != engine block_size "
                f"{self.config.block_size}; create the engine with the "
                f"container's block size"))
        if int(m.comp_len.max(initial=0)) > self.config.slot_size:
            raise StatusError(Status.CapacityError(
                f"block of {int(m.comp_len.max())}B exceeds slot "
                f"{self.config.slot_size}B"))
        n = m.nblocks
        staging_buf = get_memory_pool(PoolBackend.ALIGNED).allocate(
            n * self.config.slot_size)
        staging = staging_buf.view().reshape(n, self.config.slot_size)
        comp_off = m.comp_off
        for i in range(n):
            o, ln = int(comp_off[i]), int(m.comp_len[i])
            staging[i, :ln] = cb.packed[o:o + ln]
            staging[i, ln:] = 0
        refs = self.arena.take_refs(
            [int(x) for x in m.comp_len], [int(c) for c in m.codec_ids])
        for start in range(0, n, self.config.burst_size):
            stop = min(n, start + self.config.burst_size)
            self.arena.write_burst([r.slot for r in refs[start:stop]],
                                   staging[start:stop])
        return CompressedUnit(manifest=m, refs=refs, engine=self,
                              _staging=staging, _staging_buf=staging_buf)

    def _staging_rows(self, unit: CompressedUnit) -> np.ndarray:
        """Host view of the unit's slot rows (cached copy or arena gather)."""
        if unit._staging is not None:
            return unit._staging
        return self.arena.gather_burst([r.slot for r in unit.refs]).cpu().numpy()

    def recycle(self, unit: CompressedUnit) -> int:
        """Return a unit's arena slots and its plan grant; returns the
        recycled count (reference ``Recycle``, ``device.cc:321-327``).  The
        unit's plan views must not be used after it (see :class:`Engine`)."""
        self._entry_guard()
        unit._check_live()
        # A running background build reads the staging this frees: join it,
        # and return the grant of a build that ran.
        if unit._plan_future is not None:
            try:
                built = self._join_plan_build(unit, cancel=True)
            except StatusError as e:
                logger.warning("discarding failed plan build of a recycled "
                               "unit: %s", e)
                built = None
            if built is not None:
                self._pool_put(built[0])
        count = self.arena.recycle(unit.refs)
        self._pool_put(unit.plan_flat)
        if unit._in_table_store:
            nseq, cols = self._table_store
            slots = unit.slot_table().long()
            nseq.index_fill_(0, slots, 0)
            cols.index_fill_(1, slots, 0)
            unit._in_table_store = False
        self._pick_slots = None
        unit._drop_device_caches()
        unit._drop_staging()
        unit.recycled = True
        return count


def prepare_batched_decode(items):
    """Merge several units' decodes into ONE flat-kernel launch.

    ``items``: ``(engine, unit)`` pairs, possibly of different engines
    (mixed codecs) on one device, with one ``block_size``; every unit must
    be fully planned.  Returns ``(launch, slices)``: ``launch()`` decodes
    every unit's blocks in one launch and returns ``[total_blocks, nrows,
    128]`` uint8 on the device; ``slices[i]`` is unit i's ``(start, stop)``
    row range.  The plan wires merge: ``p_off`` re-bases by the running pass
    count, ``dq_idx`` by the running dense rows, and ``row_a`` pads to the
    batch's largest ``dcap``."""
    if not items:
        raise StatusError(Status.Invalid("prepare_batched_decode: no units"))
    eng0 = items[0][0]
    block_size = eng0.config.block_size
    nrows = block_size // LANES
    plans_list = []
    for eng, unit in items:
        if eng.config.block_size != block_size:
            raise StatusError(Status.Invalid("prepare_batched_decode: mixed block sizes"))
        if eng.device != eng0.device:
            raise StatusError(Status.Invalid("prepare_batched_decode: mixed devices"))
        eng._entry_guard()
        unit._check_live()
        eng.ensure_plans(unit)
        p = unit.plan_flat
        if p is None or p["host_blocks"].size:
            raise StatusError(Status.NotImplemented(
                "prepare_batched_decode requires fully-planned units"))
        plans_list.append(p)

    comp_rows = max(u.plan_comp_rows for _, u in items)
    tiles = nrows // LANES
    S_total = sum(int(p["p_used"].astype(np.int64).sum()) for p in plans_list)
    s_pad = -(-(S_total + DCHUNK) // _S_QUANTUM) * _S_QUANTUM
    se = np.zeros((s_pad, tiles, LANES), np.int16)
    sh = np.zeros((s_pad, tiles, LANES), np.int32)
    dcap = max(p["row_a"].shape[1] for p in plans_list)
    parts = {k: [] for k in ("p_used", "p_off", "p0", "dense", "dq_idx", "dq", "row_a")}
    s_base = nd_base = 0
    for p in plans_list:
        S_i = int(p["p_used"].astype(np.int64).sum())
        se[s_base:s_base + S_i] = p["se"][:S_i]
        sh[s_base:s_base + S_i] = p["shift"][:S_i]
        parts["p_used"].append(p["p_used"])
        parts["p_off"].append(p["p_off"].astype(np.int64) + s_base)
        parts["p0"].append(p["p0"])
        parts["dense"].append(p["dense"])
        parts["dq_idx"].append(p["dq_idx"] + nd_base)
        parts["dq"].append(p["dq"])
        ra = p["row_a"]
        parts["row_a"].append(np.pad(ra, ((0, 0), (0, dcap - ra.shape[1]), (0, 0), (0, 0))))
        s_base += S_i
        nd_base += p["dq"].shape[0]
    merged = {k: np.concatenate(v) for k, v in parts.items()}
    merged["p_off"] = merged["p_off"].astype(np.int32)
    merged.update(se=se, shift=sh)
    pt = plan_tensors(merged, eng0.device)

    # Every unit's rows once, Zstd literal planes in place, padded to one
    # width: a copy, since the units may lie in several engines' arenas.
    row_parts, slices = [], []
    start = 0
    for eng, unit in items:
        row_parts.append(eng._unit_rows(unit, slice(0, unit.nblocks)))
        slices.append((start, start + unit.nblocks))
        start += unit.nblocks
    width = max(r.shape[1] for r in row_parts)
    rows = torch.cat([torch.nn.functional.pad(r, (0, width - r.shape[1]))
                      for r in row_parts])

    def launch() -> torch.Tensor:
        return decode_blocks_flat(rows, pt, comp_rows=comp_rows, out_rows=nrows)

    return launch, slices
