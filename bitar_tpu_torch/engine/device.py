"""Engine: the per-device compression runtime.

Counterpart of ``bitar_tpu/engine/device.py`` on PyTorch.  One engine owns
one device (``torch.device``), validates its configuration against the
device's capabilities at ``initialize``, walks the state machine CREATED ->
STARTED -> RELEASED, runs ``compress``/``decompress`` and recycles units'
arena slots.

The main path, as in the reference package:

* ``compress`` runs the native host matcher (C++ threads) and stages the
  compressed blocks; with ``commit="deferred"`` they reach the device arena
  at first use (``_ensure_committed``), with ``"eager"`` during compress.
* ``ensure_plans`` joins (or runs) the native batch planner, which turns
  every block into a flat decode plan.  The planner's arguments are the
  reference engine's, so both packages build the same plan.
* ``decompress`` gathers each burst's slots from the arena and launches the
  flat decode kernel (``ops/decode_flat.py``); blocks the planner rejected
  decode per block on the host while the kernel runs.  A well-formed unit
  with no plannable block raises NotImplemented: the reference decodes it
  through its sequence-table path, which is not ported yet.

On a CUDA device a kernel or build failure raises: nothing falls back to the
host or to the plain PyTorch decode.  ``Engine(device="cpu")`` runs the
plain PyTorch decode on CPU tensors (the test path).

Not ported yet: the sequence-table decode path, Zstd literal planes, the
tpu/tpu-sort/device compress matchers, streams and batched decode.
"""

from __future__ import annotations

import concurrent.futures
import enum
import os
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import Checksum, Codec, DeviceCapabilities, EngineConfig, capabilities_for_device
from ..manifest import BlockManifest, CompressedBuffers, checksum_of, codec_id
from ..memory.arena import CompressedBlockRef, DeviceArena
from ..memory.host_pool import PoolBackend, get_memory_pool
from ..ops import registry
from ..ops.cpu import native
from ..ops.decode_flat import CB, DCHUNK, KBAND, LANES, _S_QUANTUM, decode_blocks_flat, plan_tensors
from ..status import Status, StatusError
from ..utils.logging import get_logger

logger = get_logger("engine.device")

_RAW_ID = codec_id(Codec.RAW)
_ZSTD_ID = codec_id(Codec.ZSTD)
#: per-block entries of the plan wire (sliced per burst)
_BLOCK_KEYS = ("p_used", "p_off", "p0", "dense", "dq_idx")
#: smallest block the planned path takes: 128 rows of 128 bytes
_PLANNED_BLOCK_QUANTUM = 128 * LANES
#: planner status of a well-formed block over the pass budget (plan.cc
#: BT_ERR_CAPACITY); any other negative status means a malformed block
_PLAN_OVER_BUDGET = Status.CapacityError("").to_int()


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
    the flat decode plan once ``ensure_plans`` built it."""

    manifest: BlockManifest
    refs: list[CompressedBlockRef]
    engine: "Engine"
    #: Flat plan (host numpy): p_used/p_off/p0/dense/dq_idx [nblocks] int32,
    #: se [S, tiles, 128] int16, shift [S, tiles, 128] int32, dq
    #: [m, nrows, 128] int16, row_a [m, dcap, 128, tiles] int32, and
    #: host_blocks (blocks the planner rejected; they decode on the host).
    plan_flat: dict[str, np.ndarray] | None = None
    plan_comp_rows: int = 0
    recycled: bool = field(default=False)
    _plan_dev: dict | None = field(default=None, repr=False)
    #: Host copy of the staged slot rows (compress/import), dropped once
    #: plans exist.
    _staging: np.ndarray | None = field(default=None, repr=False)
    _staging_buf: object | None = field(default=None, repr=False)
    _planned: bool = field(default=False, repr=False)
    #: Pending background plan build (plan_build="background").
    _plan_future: object | None = field(default=None, repr=False)
    #: False while the compressed bytes live only in host staging.
    _committed: bool = field(default=True, repr=False)

    def plan_device_arrays(self) -> dict[str, torch.Tensor]:
        """The unit's plan wire on the engine's device, uploaded once and
        shared by every decode launch of this unit."""
        if self._plan_dev is None:
            self._plan_dev = plan_tensors(self.plan_flat, self.engine.device)
        return self._plan_dev

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

    def _check_live(self) -> None:
        if self.recycled:
            raise StatusError(Status.Invalid("compressed unit already recycled"))


def _no_device_zstd(manifest: BlockManifest) -> None:
    if bool((manifest.codec_ids == _ZSTD_ID).any()):
        raise StatusError(Status.NotImplemented(
            "device decode of zstd blocks needs the literal-plane override, "
            "which is not ported yet; use use_tpu_kernels=False"))


class Engine:
    """One device's compression/decompression runtime.

    ``device``: a ``torch.device`` or string; None means ``"cuda"``.  A CUDA
    device without CUDA raises StatusError here: pass ``device="cpu"`` for
    the plain PyTorch path."""

    # Plan budget of the reference engine (160 passes per block), and its
    # chunking of a unit's plan build (bounds native plan scratch).
    _PLAN_MAX_PASSES = 160
    _PLAN_CHUNK_BLOCKS = 256

    def __init__(self, config: EngineConfig, device: torch.device | str | None = None):
        if config.block_size % LANES != 0:
            raise StatusError(Status.Invalid(
                f"block_size {config.block_size} must be a multiple of 128 "
                f"(plane row width)"))
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise StatusError(Status.Invalid(
                f"Engine(device={device}): torch.cuda.is_available() is false; "
                f"pass device='cpu' for the plain PyTorch path"))
        self.config = config
        self.device = device
        self.state = EngineState.CREATED
        self.caps: DeviceCapabilities | None = None
        self.arena: DeviceArena | None = None
        self.stats = EngineStats()
        # Plan builds run on ONE worker thread (compress submits,
        # ensure_plans joins); the lock covers the synchronous path.
        self._plan_lock = threading.Lock()
        self._plan_executor: concurrent.futures.ThreadPoolExecutor | None = None

    # ------------------------------------------------------------------
    def initialize(self) -> "Engine":
        """Validate config against device capabilities and preallocate the
        arena (reference ``Initialize``, ``device.cc:115-154``)."""
        if self.state != EngineState.CREATED:
            raise StatusError(Status.Invalid(
                f"initialize called in state {self.state.value}"))
        cfg = self.config
        self.caps = capabilities_for_device(self.device)
        cfg.validate(self.caps).with_context(
            f"Engine(device={self.device})").raise_if_error()
        if cfg.compress_matcher != "host":
            raise StatusError(Status.NotImplemented(
                f"compress_matcher {cfg.compress_matcher!r} is not ported yet"))
        if cfg.use_tpu_kernels and cfg.block_size % _PLANNED_BLOCK_QUANTUM:
            raise StatusError(Status.NotImplemented(
                f"device decode needs block_size % {_PLANNED_BLOCK_QUANTUM} == 0 "
                f"(the planned path); the sequence-table path is not ported yet"))
        self.arena = DeviceArena(
            slot_size=cfg.slot_size, preallocated=cfg.max_pool_slots,
            max_slots=cfg.max_pool_slots, device=self.device)
        self.state = EngineState.STARTED
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
                cfg.codec, cfg.level, raw, manifest.raw_off[s:e],
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
                o = int(manifest.raw_off[i])
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
            # The matcher chews chunk k+1 on its own threads (ctypes drops
            # the GIL) while this thread lands chunk k.
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
        if cfg.checksum != Checksum.NONE:
            for i in range(n):
                o, ln = int(manifest.raw_off[i]), int(manifest.raw_len[i])
                manifest.checksums[i] = checksum_of(cfg.checksum, raw[o:o + ln])
        self.stats.dequeued_blocks += n
        self.stats.bytes_compressed += int(manifest.total_raw)
        unit = CompressedUnit(manifest=manifest, refs=refs, engine=self,
                              _staging=staging, _staging_buf=staging_buf,
                              _committed=(cfg.commit == "eager"))
        if (cfg.use_tpu_kernels and cfg.plan_build == "background"
                and not (codec_ids == _ZSTD_ID).any()):
            unit._plan_future = self._submit_plan_build(manifest, staging)
        return unit

    def _ensure_committed(self, unit: CompressedUnit) -> None:
        """Upload a deferred-commit unit's compressed bytes to the arena
        before any device read."""
        if unit._committed:
            return
        if unit._staging is None:
            raise StatusError(Status.Invalid("uncommitted unit has no staging bytes"))
        m, cfg = unit.manifest, self.config
        wstep = max(128, cfg.slot_size // 8)
        for s in range(0, m.nblocks, cfg.burst_size):
            e = min(m.nblocks, s + cfg.burst_size)
            w = int(m.comp_len[s:e].max(initial=1))
            w = min(cfg.slot_size, -(-w // wstep) * wstep)
            self.arena.write_burst([r.slot for r in unit.refs[s:e]],
                                   unit._staging[s:e, :w])
        unit._committed = True

    # ------------------------------------------------------------------
    def _build_plans(self, manifest: BlockManifest, staging: np.ndarray):
        """Plan every block with the native batch planner.

        Returns (plans, comp_rows).  Blocks the planner rejects keep
        ``p_used == 0`` (the kernel writes zeros for them) and are listed
        in ``plans["host_blocks"]`` for per-block host decode.  When it
        rejects every block and none as malformed, raises NotImplemented:
        the reference engine decodes such a unit on the device through
        its sequence-table path (kernel B2), not ported yet.  A unit with
        a malformed block and no plannable one decodes on the host, as in
        the reference (its sequence tables fail on the malformed block)."""
        _no_device_zstd(manifest)
        cfg = self.config
        nrows = cfg.block_size // LANES
        n = manifest.nblocks
        slot = staging.shape[1]
        # The reference engine schedules > 1024-row planes under its
        # banded-gather constraint; kept so the plans stay identical.
        band_rows = KBAND if (nrows % min(KBAND, nrows) == 0 and nrows > 1024) else 0
        chunk = self._PLAN_CHUNK_BLOCKS

        def plan_one(s: int, e: int, brows: int):
            # No zeroing needed: the planner defines every plane of a block
            # it reports dense (plan.cc Densify).
            dq_buf = np.empty((e - s, nrows, LANES), np.int16)
            ra_buf = np.empty((e - s, native.DENSE_PLANES, nrows), np.int32)
            ctx, pu, p0c, st, _, dq, ra, ds = native.plan_batch_begin(
                staging[s:e].reshape(-1),
                np.arange(e - s, dtype=np.int64) * slot,
                manifest.comp_len[s:e], manifest.raw_len[s:e],
                manifest.codec_ids[s:e], nrows, self._PLAN_MAX_PASSES, cb=CB,
                band_rows=brows, dq_buf=dq_buf, ra_buf=ra_buf)
            bad = st != 0
            pu[bad] = 0
            p0c[bad] = 0
            ds[bad] = 0
            return (ctx, s, e), pu, p0c, st, dq, ra, ds

        def plan_all(brows: int):
            # Chunks plan concurrently: each is one native call that drops
            # the GIL and touches disjoint staging rows and buffers.
            spans = [(s, min(n, s + chunk)) for s in range(0, n, chunk)]
            with concurrent.futures.ThreadPoolExecutor(
                    min(len(spans), os.cpu_count() or 1)) as pool:
                parts = list(pool.map(lambda se: plan_one(se[0], se[1], brows), spans))
            return ([p[0] for p in parts],
                    np.concatenate([p[1] for p in parts]),
                    np.concatenate([p[2] for p in parts]),
                    np.concatenate([p[3] for p in parts]),
                    [p[4] for p in parts], [p[5] for p in parts],
                    np.concatenate([p[6] for p in parts]))

        def abort_all(ctxs):
            for ctx, _, _ in ctxs:
                native.plan_batch_abort(ctx)

        ctxs, p_used, p0, st, dq_parts, ra_parts, dense = plan_all(band_rows)
        if band_rows and (st != 0).any():
            # Banding must never shrink device coverage: re-plan unbanded.
            abort_all(ctxs)
            band_rows = 0
            ctxs, p_used, p0, st, dq_parts, ra_parts, dense = plan_all(0)
        ok = st == 0
        if not ok.any() and (st == _PLAN_OVER_BUDGET).all():
            abort_all(ctxs)
            raise StatusError(Status.NotImplemented(
                f"all {n} blocks of this unit exceed the plan budget of "
                f"{self._PLAN_MAX_PASSES} passes; the reference decodes such a "
                f"unit through the sequence-table path (kernel B2), which is "
                f"not ported yet"))

        # Flat wire: S quantized as in the reference, plus DCHUNK slack rows.
        p_off = np.zeros(n, np.int64)
        p_off[1:] = np.cumsum(p_used[:-1].astype(np.int64))
        S = int(p_used.astype(np.int64).sum())
        s_pad = -(-(S + DCHUNK) // _S_QUANTUM) * _S_QUANTUM
        tiles = nrows // LANES
        se = np.empty((s_pad, tiles, LANES), np.int16)
        sh = np.empty((s_pad, tiles, LANES), np.int32)
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
            dq_c = np.empty((nd, nrows, LANES), np.int16)
            ra_c = np.empty((nd, dcap, LANES, tiles), np.int32)
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
                 "host_blocks": np.flatnonzero(~ok).astype(np.int32)}

        def _round_rows(nbytes: int) -> int:
            r = max(128, -(-nbytes // 128))
            r = -(-r // 128) * 128
            if r > 128:
                r = -(-r // KBAND) * KBAND
            return r

        comp_rows = _round_rows(int(manifest.comp_len.max(initial=1)))
        return plans, comp_rows

    def _submit_plan_build(self, manifest: BlockManifest, staging: np.ndarray):
        """Queue a plan build on the engine's single plan worker."""
        if self._plan_executor is None:
            self._plan_executor = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="btt-plan")

        def build():
            with self._plan_lock:
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
        return fut.result()

    def ensure_plans(self, unit: CompressedUnit) -> None:
        """Build the unit's decode plan on demand (once).

        With ``plan_build="background"`` compress already started the
        build and this joins it; otherwise the plan builds here.  A
        deferred-commit unit is uploaded here, before its staging copy is
        dropped."""
        self._entry_guard()
        unit._check_live()
        if unit._planned:
            return
        _no_device_zstd(unit.manifest)
        staging = self._staging_rows(unit)
        self._ensure_committed(unit)
        if unit._plan_future is not None:
            plans = self._join_plan_build(unit)
        else:
            with self._plan_lock:
                plans = self._build_plans(unit.manifest, staging)
        unit.plan_flat, unit.plan_comp_rows = plans
        unit._planned = True
        unit._drop_staging()

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

        if self.config.use_tpu_kernels:
            self.ensure_plans(unit)
            status = self._decompress_gpu_planned(unit, out)
        else:
            status = self._decompress_host(unit, out)

        if m.checksum_kind != Checksum.NONE:
            for i in range(m.nblocks):
                if status[i] < 0:
                    continue
                o, ln = int(m.raw_off[i]), int(m.raw_len[i])
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

    def decompress_device(self, unit: CompressedUnit) -> list[torch.Tensor]:
        """Decompress on the device: per-burst ``[burst, nrows, 128]`` uint8
        tensors in block order, with no host readout (host-decoded blocks
        are zero planes here)."""
        self._entry_guard()
        unit._check_live()
        self.ensure_plans(unit)
        results = [r for _, _, r in self._planned_bursts(unit)]
        self.stats.device_decode_bursts += len(results)
        return results

    def _planned_bursts(self, unit: CompressedUnit):
        """Launch the flat decode kernel burst by burst.

        Returns [(start, stop, device result [stop - start, nrows, 128])],
        launches already queued on the device.  The unit's plan uploads
        once; per burst only the arena gather runs before the launch."""
        cfg = self.config
        self._ensure_committed(unit)
        nrows = cfg.block_size // LANES
        pt = unit.plan_device_arrays()
        launches = []
        for start in range(0, unit.nblocks, cfg.burst_size):
            stop = min(unit.nblocks, start + cfg.burst_size)
            rows = self.arena.gather_burst([r.slot for r in unit.refs[start:stop]])
            burst = dict(pt)
            for k in _BLOCK_KEYS:
                burst[k] = pt[k][start:stop]
            result = decode_blocks_flat(rows, burst, comp_rows=unit.plan_comp_rows,
                                        out_rows=nrows)
            launches.append((start, stop, result))
            self.stats.enqueued_blocks += stop - start
        return launches

    def prepare_device_decode(self, unit: CompressedUnit):
        """Stage a fully-planned unit for repeated device-resident decode.

        Returns a zero-argument ``launch``: each call runs ONE whole-unit
        decode on inputs staged here and returns the [nblocks, nrows, 128]
        uint8 device tensor, with no host transfer."""
        self._entry_guard()
        unit._check_live()
        self.ensure_plans(unit)
        if unit.plan_flat["host_blocks"].size:
            raise StatusError(Status.NotImplemented(
                "prepare_device_decode requires a fully-planned unit"))
        self._ensure_committed(unit)
        nrows = self.config.block_size // LANES
        comp_rows = unit.plan_comp_rows
        rows = self.arena.gather_burst([r.slot for r in unit.refs])
        pt = unit.plan_device_arrays()

        def launch() -> torch.Tensor:
            return decode_blocks_flat(rows, pt, comp_rows=comp_rows, out_rows=nrows)

        return launch

    def _decompress_gpu_planned(self, unit: CompressedUnit, out: np.ndarray
                                ) -> np.ndarray:
        """Planned device decode; blocks the planner rejected decode on the
        host while the kernel launches run."""
        m = unit.manifest
        status = np.zeros(m.nblocks, np.int32)
        launches = self._planned_bursts(unit)
        self.stats.device_decode_bursts += len(launches)
        host_blocks = unit.plan_flat["host_blocks"]
        host_set = set(host_blocks.tolist())
        if host_set:
            self._decompress_host_subset(unit, out, host_blocks.astype(np.int64), status)
        raw_off, raw_len = m.raw_off, m.raw_len
        for start, stop, result in launches:
            host = result.cpu().numpy().reshape(stop - start, -1)
            for i in range(start, stop):
                if i in host_set:
                    continue
                o, ln = int(raw_off[i]), int(raw_len[i])
                out[o:o + ln] = host[i - start, :ln]
            self.stats.dequeued_blocks += stop - start
        return status

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
        for i in range(n):
            o, ln = int(m.comp_off[i]), int(m.comp_len[i])
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
        """Return a unit's arena slots; returns the recycled count
        (reference ``Recycle``, ``device.cc:321-327``)."""
        self._entry_guard()
        unit._check_live()
        # A running background build reads the staging this frees: join it.
        if unit._plan_future is not None:
            try:
                self._join_plan_build(unit, cancel=True)
            except StatusError as e:
                logger.warning("discarding failed plan build of a recycled "
                               "unit: %s", e)
        count = self.arena.recycle(unit.refs)
        unit._plan_dev = None
        unit._drop_staging()
        unit.recycled = True
        return count
