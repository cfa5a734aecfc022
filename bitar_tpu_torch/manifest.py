"""Block manifest: the explicit framing contract.

The reference has an *implicit* framing contract: the sizes and order of the
returned ``BufferVector`` are the only metadata; decompression assumes every
segment expands to exactly ``decompressed_seg_size`` bytes except the last
(reference ``src/device.cc:241-318``, survey §3.2).  This package makes
that contract explicit and device-friendly: a structure-of-arrays manifest
(int32/uint32 numpy columns) that

* uploads as-is to the device (the decode kernel's per-block scalars),
* serializes to a tiny container header so compressed data survives a file
  round-trip, and
* carries optional per-block checksums (reference ``config.h:169-177``).

A copy of ``bitar_tpu/manifest.py``: containers are byte-identical across
the two packages, in both directions.

One manifest describes one compressed *unit* (a file / buffer): ``nblocks``
blocks, block ``i`` holding ``raw_len[i]`` original bytes compressed to
``comp_len[i]`` bytes with ``codec_id[i]``.
"""

from __future__ import annotations

import io
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from .config import Checksum, Codec
from .status import Status, StatusError

MAGIC = b"BTPU"
VERSION = 1

_CODEC_IDS = {Codec.LZ4: 0, Codec.SNAPPY: 1, Codec.ZSTD: 2, Codec.RAW: 3}
_ID_CODECS = {v: k for k, v in _CODEC_IDS.items()}


def codec_id(codec: Codec) -> int:
    return _CODEC_IDS[codec]


def codec_from_id(cid: int) -> Codec:
    return _ID_CODECS[int(cid)]


def checksum_of(kind: Checksum, data) -> int:
    if kind == Checksum.CRC32:
        return zlib.crc32(data) & 0xFFFFFFFF
    if kind == Checksum.ADLER32:
        return zlib.adler32(data) & 0xFFFFFFFF
    return 0


@dataclass
class BlockManifest:
    """SoA description of a compressed unit.

    Columns (all length ``nblocks``):

    * ``raw_len``   — uncompressed bytes of each block (int32)
    * ``comp_len``  — compressed bytes of each block (int32)
    * ``codec_ids`` — per-block codec id (int32; RAW marks stored blocks)
    * ``checksums`` — per-block checksum of the *raw* bytes (uint32)
    * ``comp_off``  — exclusive prefix sum of comp_len: offset of each
                      block in the packed compressed byte stream (int64)
    * ``raw_off``   — exclusive prefix sum of raw_len (int64)
    """

    block_size: int
    total_raw: int
    raw_len: np.ndarray
    comp_len: np.ndarray
    codec_ids: np.ndarray
    checksums: np.ndarray
    checksum_kind: Checksum = Checksum.NONE
    #: Uniform units keep the reference's implicit framing shape (every block
    #: but the last is exactly ``block_size``, ``device.cc:241-318``);
    #: non-uniform units carry a skewed per-block size distribution
    #: (BASELINE config 4) where ``block_size`` is only the maximum.
    uniform: bool = True

    # ------------------------------------------------------------------
    @property
    def nblocks(self) -> int:
        return int(self.raw_len.shape[0])

    @property
    def comp_off(self) -> np.ndarray:
        out = np.zeros(self.nblocks, dtype=np.int64)
        np.cumsum(self.comp_len[:-1], out=out[1:])
        return out

    @property
    def raw_off(self) -> np.ndarray:
        out = np.zeros(self.nblocks, dtype=np.int64)
        np.cumsum(self.raw_len[:-1], out=out[1:])
        return out

    @property
    def total_comp(self) -> int:
        return int(self.comp_len.sum())

    def ratio(self) -> float:
        return self.total_raw / max(1, self.total_comp)

    # ------------------------------------------------------------------
    @staticmethod
    def plan(total_raw: int, block_size: int) -> "BlockManifest":
        """Split plan for an input: full blocks plus a ragged tail.

        The analog of the reference's slicing of the input buffer every
        ``decompressed_seg_size`` bytes (``memory.cc:380-399``).
        """
        if total_raw < 0:
            raise StatusError(Status.Invalid("negative input size"))
        if block_size <= 0:
            raise StatusError(Status.Invalid("block_size must be positive"))
        nblocks = max(1, -(-total_raw // block_size))
        raw_len = np.full(nblocks, block_size, dtype=np.int32)
        tail = total_raw - block_size * (nblocks - 1)
        raw_len[-1] = tail
        return BlockManifest(
            block_size=block_size,
            total_raw=total_raw,
            raw_len=raw_len,
            comp_len=np.zeros(nblocks, dtype=np.int32),
            codec_ids=np.zeros(nblocks, dtype=np.int32),
            checksums=np.zeros(nblocks, dtype=np.uint32),
        )

    @staticmethod
    def plan_sizes(sizes, block_size: int) -> "BlockManifest":
        """Split plan with an explicit (possibly skewed) size per block.

        ``block_size`` is the maximum (it sizes device slots/padding);
        every entry of ``sizes`` must be in ``[0, block_size]``.
        """
        raw_len = np.asarray(sizes, dtype=np.int32)
        if raw_len.ndim != 1 or raw_len.shape[0] == 0:
            raise StatusError(Status.Invalid("plan_sizes needs a 1-D non-empty size list"))
        if block_size <= 0:
            raise StatusError(Status.Invalid("block_size must be positive"))
        if (raw_len < 0).any() or (raw_len > block_size).any():
            raise StatusError(Status.Invalid("block sizes must be in [0, block_size]"))
        nblocks = raw_len.shape[0]
        return BlockManifest(
            block_size=block_size,
            total_raw=int(raw_len.sum()),
            raw_len=raw_len,
            comp_len=np.zeros(nblocks, dtype=np.int32),
            codec_ids=np.zeros(nblocks, dtype=np.int32),
            checksums=np.zeros(nblocks, dtype=np.uint32),
            uniform=bool((raw_len[:-1] == block_size).all()),
        )

    def validate(self) -> Status:
        n = self.nblocks
        for name in ("raw_len", "comp_len", "codec_ids", "checksums"):
            col = getattr(self, name)
            if col.shape != (n,):
                return Status.Invalid(f"manifest column {name} has shape {col.shape}, want ({n},)")
        if int(self.raw_len.sum()) != self.total_raw:
            return Status.Invalid(
                f"raw_len sum {int(self.raw_len.sum())} != total_raw {self.total_raw}")
        if not self.uniform and n > 1 and not (self.raw_len[:-1] <= self.block_size).all():
            return Status.Invalid("raw_len may not exceed block_size")
        if self.uniform and n > 1 and not (self.raw_len[:-1] == self.block_size).all():
            return Status.Invalid("all blocks but the last must equal block_size")
        if n >= 1 and int(self.raw_len[-1]) > self.block_size:
            return Status.Invalid("last block raw_len exceeds block_size")
        if (self.comp_len < 0).any() or (self.raw_len < 0).any():
            return Status.Invalid("negative lengths in manifest")
        if not np.isin(self.codec_ids, list(_ID_CODECS)).all():
            return Status.Invalid("unknown codec id in manifest")
        return Status.OK()

    # -- container serialization ---------------------------------------
    def to_bytes(self) -> bytes:
        """Serialize the manifest header (not the block payloads)."""
        buf = io.BytesIO()
        buf.write(MAGIC)
        cksum_kind = {Checksum.NONE: 0, Checksum.CRC32: 1, Checksum.ADLER32: 2}[self.checksum_kind]
        # High byte of the kind field carries flags (bit 0: non-uniform
        # block sizes); v1 writers always emitted 0 there.
        flags = 0 if self.uniform else 1
        buf.write(struct.pack("<HHIqq", VERSION, cksum_kind | (flags << 8),
                              self.nblocks, self.total_raw, self.block_size))
        for col, dt in ((self.raw_len, "<i4"), (self.comp_len, "<i4"),
                        (self.codec_ids, "<i4"), (self.checksums, "<u4")):
            buf.write(np.ascontiguousarray(col, dtype=dt).tobytes())
        raw = buf.getvalue()
        return raw + struct.pack("<I", zlib.crc32(raw) & 0xFFFFFFFF)

    @staticmethod
    def from_bytes(data: bytes) -> "BlockManifest":
        if len(data) < 4 + 24 + 4 or data[:4] != MAGIC:
            raise StatusError(Status.IOError("bad manifest magic"))
        body, (crc,) = data[:-4], struct.unpack("<I", data[-4:])
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise StatusError(Status.IOError("manifest header CRC mismatch"))
        version, kind_flags, nblocks, total_raw, block_size = struct.unpack(
            "<HHIqq", body[4:4 + 24])
        if version != VERSION:
            raise StatusError(Status.IOError(f"unsupported manifest version {version}"))
        cksum_kind = kind_flags & 0xFF
        flags = kind_flags >> 8
        if cksum_kind not in (0, 1, 2) or flags > 1:
            raise StatusError(Status.IOError("unknown manifest checksum kind/flags"))
        # Validate the declared block count against the actual body size
        # BEFORE allocating columns: a hostile 36-byte header with a huge
        # nblocks must not drive a multi-GiB np.frombuffer allocation.
        if len(body) != 4 + 24 + 16 * nblocks:
            raise StatusError(Status.IOError(
                f"manifest body {len(body)} bytes inconsistent with nblocks={nblocks}"))
        off = 4 + 24
        cols = []
        try:
            for dt in ("<i4", "<i4", "<i4", "<u4"):
                arr = np.frombuffer(body, dtype=dt, count=nblocks, offset=off).copy()
                off += 4 * nblocks
                cols.append(arr)
        except ValueError as exc:
            raise StatusError(Status.IOError(f"manifest columns truncated: {exc}")) from exc
        m = BlockManifest(
            block_size=block_size, total_raw=total_raw,
            raw_len=cols[0], comp_len=cols[1], codec_ids=cols[2],
            checksums=cols[3].astype(np.uint32),
            checksum_kind={0: Checksum.NONE, 1: Checksum.CRC32, 2: Checksum.ADLER32}[cksum_kind],
            uniform=not (flags & 1),
        )
        m.validate().raise_if_error()
        return m


@dataclass
class CompressedBuffers:
    """A compressed unit: manifest + packed payload bytes.

    The analog of the reference's ``BufferVector`` return value
    (``type_fwd.h:32``), with the implicit framing made explicit.  The
    payload may live on host (numpy uint8) or device (arena slots); ``packed`` is the canonical host form: all blocks concatenated
    at ``manifest.comp_off`` offsets.
    """

    manifest: BlockManifest
    packed: np.ndarray  # uint8, length manifest.total_comp

    def block(self, i: int) -> np.ndarray:
        off = int(self.manifest.comp_off[i])
        return self.packed[off:off + int(self.manifest.comp_len[i])]

    def to_bytes(self) -> bytes:
        header = self.manifest.to_bytes()
        payload = self.packed.tobytes()
        # Whole-payload CRC trailer: the manifest header is already
        # self-CRC'd, but without this a flipped bit inside a compressed
        # block can decode to silently-wrong bytes when the per-block raw
        # checksum knob is off (the default, matching the reference's
        # RTE_COMP_CHECKSUM_NONE).  Import always verifies it.
        crc = struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)
        return struct.pack("<I", len(header)) + header + payload + crc

    @staticmethod
    def from_bytes(data: bytes) -> "CompressedBuffers":
        if len(data) < 4:
            raise StatusError(Status.IOError("container truncated"))
        (hlen,) = struct.unpack("<I", data[:4])
        if len(data) < 4 + hlen:
            raise StatusError(Status.IOError("container header truncated"))
        manifest = BlockManifest.from_bytes(data[4:4 + hlen])
        body = len(data) - 4 - hlen
        if body == manifest.total_comp + 4:
            payload = np.frombuffer(data, dtype=np.uint8, offset=4 + hlen,
                                    count=manifest.total_comp).copy()
            (crc,) = struct.unpack("<I", data[-4:])
            if zlib.crc32(payload.tobytes()) & 0xFFFFFFFF != crc:
                raise StatusError(Status.IOError("payload CRC mismatch"))
        elif body == manifest.total_comp:   # legacy container, no trailer
            payload = np.frombuffer(data, dtype=np.uint8, offset=4 + hlen).copy()
        else:
            raise StatusError(Status.IOError(
                f"payload size {body} != manifest total_comp {manifest.total_comp}"))
        return CompressedBuffers(manifest=manifest, packed=payload)
