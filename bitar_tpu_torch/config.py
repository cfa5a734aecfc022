"""Engine configuration and capability validation.

The same ``EngineConfig`` as ``bitar_tpu/config.py`` (knobs, slot sizing
rule and ``validate``), so one config value means the same unit layout in
both packages.  What differs is the capability record: a CUDA device's is
read from ``torch.cuda.get_device_properties`` at engine initialization
(device memory, shared memory per block), not taken from a TPU constant.

TPU-only knobs (``interpret``, ``dense_q``, ``dense_sub``,
``pipeline_depth``) are accepted, range-checked as in the reference
package, and otherwise ignored: the CUDA decode kernel has no interpreter,
no MXU batching and no plan DMA pipeline.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass, field

from .status import Status


class Codec(enum.Enum):
    """Block codecs the engine speaks."""

    LZ4 = "lz4"          # LZ4 block format (raw, no frame)
    SNAPPY = "snappy"    # Snappy raw format
    ZSTD = "zstd"        # Zstandard frame
    RAW = "raw"          # stored/passthrough (incompressible fallback)


class Checksum(enum.Enum):
    """Optional integrity checksum recorded in the block manifest."""

    NONE = "none"
    CRC32 = "crc32"
    ADLER32 = "adler32"


def next_power_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def lz4_compress_bound(n: int) -> int:
    """Worst-case LZ4 block output for n input bytes (spec formula)."""
    return n + n // 255 + 16


def snappy_compress_bound(n: int) -> int:
    """Worst-case Snappy output (format max expansion)."""
    return 32 + n + n // 6


def zstd_compress_bound(n: int) -> int:
    """Worst-case Zstandard frame size (ZSTD_compressBound formula)."""
    margin = (n >> 8) + (64 if n < (128 << 10) else 0)
    return n + margin + 12 + 8  # + frame header/footer head-room


_COMPRESS_BOUNDS = {
    Codec.LZ4: lz4_compress_bound,
    Codec.SNAPPY: snappy_compress_bound,
    Codec.ZSTD: zstd_compress_bound,
    Codec.RAW: lambda n: n + 8,
}


def compress_bound(codec: Codec, n: int) -> int:
    return _COMPRESS_BOUNDS[codec](n)


@dataclass(frozen=True, slots=True)
class DeviceCapabilities:
    """What a device can do; checked at Engine.initialize."""

    name: str
    codecs: tuple[Codec, ...]
    min_block_size: int
    max_block_size: int
    max_burst_size: int
    max_inflight_bursts: int
    shared_mem_bytes: int        # per-block shared memory (opt-in maximum)
    hbm_budget_bytes: int        # arena ceiling


_ALL_CODECS = (Codec.LZ4, Codec.SNAPPY, Codec.ZSTD, Codec.RAW)

#: Rows of 128 bytes of the largest plane decode_flat's shared-memory route
#: holds: 1024 threads x 32 register words x 4 bytes (csrc/decode_flat.cu
#: kThreads * kMaxWords).  Taller planes take its device-memory route.
DECODE_FLAT_MAX_ROWS = 1024

CPU_REFERENCE = DeviceCapabilities(
    name="cpu-reference",
    codecs=_ALL_CODECS,
    min_block_size=64,
    max_block_size=1 << 20,
    max_burst_size=2048,
    max_inflight_bursts=16,
    shared_mem_bytes=0,
    hbm_budget_bytes=4 << 30,
)


def cuda_capabilities(name: str, total_memory: int,
                      shared_mem_per_block_optin: int) -> DeviceCapabilities:
    """Capability record of one CUDA device from its properties.

    Blocks go up to 1 MiB, as on the TPU, and ``EngineConfig.validate``
    takes every matcher at every block size as it does for
    ``bitar_tpu.config.TPU_V5E``: the decode kernels keep planes of up to
    128 KiB in shared memory and taller ones in device memory, and the match
    kernels and the emitter take planes up to 1 MiB.  The arena may take
    three quarters of device memory: the rest holds plans, gathered bursts
    and decoded planes."""
    return DeviceCapabilities(
        name=name,
        codecs=_ALL_CODECS,
        min_block_size=1 << 10,
        max_block_size=1 << 20,
        max_burst_size=2048,
        max_inflight_bursts=512,
        shared_mem_bytes=shared_mem_per_block_optin,
        hbm_budget_bytes=total_memory * 3 // 4,
    )


def capabilities_for_device(device) -> DeviceCapabilities:
    """Capability record of a ``torch.device``."""
    if device.type != "cuda":
        return CPU_REFERENCE
    import torch

    props = torch.cuda.get_device_properties(device)
    # Older torch builds lack the opt-in field; 48 KiB is the limit every
    # CUDA device grants without opting in.
    smem = getattr(props, "shared_memory_per_block_optin", 48 * 1024)
    return cuda_capabilities(props.name, int(props.total_memory), int(smem))


DEFAULT_BURST_SIZE = 32
DEFAULT_BLOCK_SIZE = 128 * 1024
MIN_POOL_SLOTS = 20              # reference kMinPreallocateMemzones (memory.h:51)

# Parse segment of the reference's device-offload matcher; kept so that
# ``validate`` accepts and rejects exactly what the reference does.
DEVICE_PARSE_SEG = 1024


def device_matcher_slots(block_size: int, min_match: int,
                         seg: int = DEVICE_PARSE_SEG, wcap: int = 8) -> int:
    """Sequence-slot count of the reference's device-offload layout."""
    seg = min(seg, block_size)
    nseg = -(-block_size // seg)
    nstep = min(wcap, seg // min_match + 1)
    return nseg * nstep + 1


@dataclass(frozen=True, slots=True)
class EngineConfig:
    """Tuning knobs for one engine instance (one device); the fields and
    defaults of ``bitar_tpu.config.EngineConfig``."""

    codec: Codec = Codec.LZ4
    block_size: int = DEFAULT_BLOCK_SIZE
    burst_size: int = DEFAULT_BURST_SIZE
    level: int = 1                      # codec effort (zstd level; lz4/snappy ignore)
    min_match: int = 6                  # smallest LZ4/Snappy match emitted
    window_log: int = 16                # match window log2; LZ4 format caps at 16
    checksum: Checksum = Checksum.NONE
    max_pool_slots: int = 4096          # arena slot budget
    pipeline_depth: int = 2             # TPU plan DMA depth: accepted, ignored
    dense_q: int = 4                    # TPU dense-pass batching: accepted, ignored
    dense_sub: int = 128                # TPU dense subtile rows: accepted, ignored
    use_tpu_kernels: bool = True        # False -> host (native C++) codec path;
                                        # True -> the device decode kernel
    interpret: bool = False             # Pallas interpreter: accepted, ignored
    compress_matcher: str = "host"      # "host", "tpu", "tpu-sort" or "device"
    match_offsets: tuple[int, ...] = ()
    detect_fft: bool | str = False
    fft_k: int = 6
    commit: str = "eager"               # "eager" or "deferred" arena upload
    plan_build: str = "background"      # "background" or "lazy" plan build

    # ------------------------------------------------------------------
    @property
    def slot_size(self) -> int:
        """Bytes per compressed-output arena slot (derived; the reference
        sizing rule, ``config.cc:60-73``)."""
        pow2 = next_power_of_two(2 * self.block_size)
        candidate = pow2 if pow2 <= 4 * self.block_size else math.ceil(1.1 * self.block_size)
        bound = compress_bound(self.codec, self.block_size)
        return _round_up(max(candidate, bound), 128)

    def validate(self, caps: DeviceCapabilities) -> Status:
        """Validate knobs against device capabilities (the checks of
        ``bitar_tpu.config.EngineConfig.validate``)."""
        if self.codec not in caps.codecs:
            return Status.Invalid(
                f"codec {self.codec.value} unsupported by device class {caps.name}")
        if not (caps.min_block_size <= self.block_size <= caps.max_block_size):
            return Status.Invalid(
                f"block_size {self.block_size} outside device range "
                f"[{caps.min_block_size}, {caps.max_block_size}]")
        if not (1 <= self.burst_size <= caps.max_burst_size):
            return Status.Invalid(
                f"burst_size {self.burst_size} outside [1, {caps.max_burst_size}]")
        if self.pipeline_depth < 1 or self.pipeline_depth > caps.max_inflight_bursts:
            return Status.Invalid(
                f"pipeline_depth {self.pipeline_depth} outside "
                f"[1, {caps.max_inflight_bursts}]")
        if not (1 <= self.dense_q <= 8):
            return Status.Invalid(f"dense_q {self.dense_q} outside [1, 8]")
        if self.dense_sub % 128 or self.dense_sub < 128:
            return Status.Invalid(
                f"dense_sub {self.dense_sub} must be a positive multiple of 128")
        if self.max_pool_slots < MIN_POOL_SLOTS:
            return Status.Invalid(
                f"max_pool_slots {self.max_pool_slots} < minimum {MIN_POOL_SLOTS} "
                f"(reference kMinPreallocateMemzones)")
        if self.max_pool_slots * self.slot_size > caps.hbm_budget_bytes:
            return Status.CapacityError(
                f"arena budget {self.max_pool_slots * self.slot_size} exceeds HBM "
                f"budget {caps.hbm_budget_bytes}")
        if self.codec == Codec.LZ4 and self.window_log > 16:
            return Status.Invalid("LZ4 window_log caps at 16 (64 KiB format window)")
        if not (8 <= self.window_log <= 27):
            return Status.Invalid(f"window_log {self.window_log} outside [8, 27]")
        if self.level < 0 or self.level > 22:
            return Status.Invalid(f"level {self.level} outside [0, 22]")
        if not (4 <= self.min_match <= 512):
            return Status.Invalid(f"min_match {self.min_match} outside [4, 512]")
        if self.compress_matcher not in ("host", "tpu", "tpu-sort", "device"):
            return Status.Invalid(
                f"compress_matcher {self.compress_matcher!r} not in "
                f"(host, tpu, tpu-sort, device)")
        if self.detect_fft not in (False, True, "sample"):
            return Status.Invalid(
                f"detect_fft {self.detect_fft!r} not in (False, True, 'sample')")
        if not (1 <= self.fft_k <= 16):
            return Status.Invalid(f"fft_k {self.fft_k} outside [1, 16]")
        if self.compress_matcher in ("tpu", "tpu-sort", "device"):
            if self.codec not in (Codec.LZ4, Codec.SNAPPY):
                return Status.Invalid(
                    "tpu/device matchers support LZ4 and Snappy")
            if self.block_size % (128 * 128) != 0:
                return Status.Invalid(
                    "tpu matcher needs block_size % 16384 == 0 (lane-tiled rows)")
            bad_off = [d for d in self.match_offsets if not (1 <= d <= 0xFFFF)]
            if bad_off:
                return Status.Invalid(
                    f"match_offsets {bad_off[:4]} outside [1, 65535]")
        if self.compress_matcher == "device":
            slots = device_matcher_slots(self.block_size, self.min_match)
            if slots >= (1 << 15):
                return Status.Invalid(
                    f"device matcher layout needs {slots} sequence slots "
                    f">= 2^15 (block_size {self.block_size} / min_match "
                    f"{self.min_match}); raise min_match or shrink blocks")
        if self.commit not in ("eager", "deferred"):
            return Status.Invalid(
                f"commit {self.commit!r} not in (eager, deferred)")
        if self.plan_build not in ("background", "lazy"):
            return Status.Invalid(
                f"plan_build {self.plan_build!r} not in (background, lazy)")
        return Status.OK()

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True, slots=True)
class ShardingConfig:
    """Multi-device / multi-host layout knobs (a copy of
    ``bitar_tpu.config.ShardingConfig``; no reference analog: the reference
    is single-process, its only topology being the queue-pair -> lcore
    round-robin map, ``driver.cc:100-158``)."""

    data_axis: str = "blocks"
    mesh_shape: tuple[int, ...] = field(default_factory=tuple)  # () -> all devices, 1D
    skew_bucket_log: int = 2      # blocks binned by ceil(log2(size)) / this for shuffle balance
