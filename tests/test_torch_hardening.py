"""Hostile-input hardening on the port, beside the JAX package: the
scenarios of ``tests/test_hardening.py`` run through both packages, which
must refuse (or report) the same malformed input the same way.  The host
library is the same C++ in both; the port's wrappers, manifest and engine
are its own."""

import struct
import zlib

import numpy as np
import pytest
import torch

import bitar_tpu as bt
import bitar_tpu_torch as btt
from bitar_tpu.manifest import BlockManifest as JManifest
from bitar_tpu.ops.cpu import native as jnative
from bitar_tpu_torch import manifest as tmanifest
from bitar_tpu_torch.manifest import BlockManifest, CompressedBuffers
from bitar_tpu_torch.ops import registry
from bitar_tpu_torch.ops.cpu import native

torch.set_num_threads(1)


def host_decode_status(codec: btt.Codec, comp: bytes, raw_len: int) -> int:
    """The port's host batch decode of one block: its status."""
    src = np.frombuffer(comp, np.uint8)
    dst = np.zeros(max(64, raw_len), np.uint8)
    _, st = registry.host_decompress_batch(
        codec, src, np.zeros(1, np.int64), np.array([len(comp)], np.int32), dst,
        np.zeros(1, np.int64), np.array([raw_len], np.int32))
    return int(st[0])


@pytest.mark.parametrize("evil", [bytes([10, 0xFC, 0x00, 0x00, 0x00, 0x80]),   # 2^31: negative
                                  bytes([10, 0xFC, 0xFF, 0xFF, 0xFF, 0x7F])])  # past the source
def test_snappy_bad_literal_lengths_rejected(evil):
    # tag 0xFC declares a 4-byte literal length; both packages refuse it,
    # in the parser and in the host decoder.
    with pytest.raises(bt.StatusError):
        jnative.snappy_decompress(evil, dst_cap=64)
    assert host_decode_status(btt.Codec.SNAPPY, evil, 64) < 0
    with pytest.raises(btt.StatusError):
        native.parse_sequences(evil, codec="snappy")
    with pytest.raises(bt.StatusError):
        jnative.parse_sequences(evil, codec="snappy")


def test_plan_rows_out_len_exceeding_rows_rejected():
    # out_len beyond nrows * 128 would index the schedule's row tables out
    # of bounds; both planners refuse it as Invalid.
    comp = native.lz4_compress(b"a" * 4096)
    with pytest.raises(btt.StatusError) as ei:
        native.plan_block(comp, out_len=10 * 128 * 128, nrows=10, max_passes=8, codec="lz4")
    with pytest.raises(bt.StatusError) as ej:
        jnative.plan_block(comp, out_len=10 * 128 * 128, nrows=10, max_passes=8, codec="lz4")
    assert ei.value.status.code.value == ej.value.status.code.value


def test_manifest_rejects_oversized_last_block():
    for cls in (BlockManifest, JManifest):
        m = cls.plan(1024, 512)
        m.raw_len[-1] = 4096     # lies: larger than block_size
        m.total_raw = int(m.raw_len.sum())
        assert not m.validate().ok()


def forged(blob: bytes) -> bytes:
    """``blob`` with its trailing CRC32 recomputed."""
    body = bytes(blob[:-4])
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def test_manifest_from_bytes_hostile_nblocks():
    # A header claiming a huge nblocks over a tiny body fails cleanly in
    # both packages, and the two headers are the same bytes.
    blob = bytearray(BlockManifest.plan(1024, 512).to_bytes())
    assert bytes(blob) == JManifest.plan(1024, 512).to_bytes()
    blob[8:12] = struct.pack("<I", 0x0FFFFFFF)
    evil = forged(bytes(blob))
    with pytest.raises(btt.StatusError):
        BlockManifest.from_bytes(evil)
    with pytest.raises(bt.StatusError):
        JManifest.from_bytes(evil)


def test_manifest_truncated_columns():
    blob = BlockManifest.plan(4096, 1024).to_bytes()
    cut = blob[: 4 + 24 + 4]          # drop most of the column data
    evil = cut + struct.pack("<I", zlib.crc32(cut) & 0xFFFFFFFF)
    with pytest.raises(btt.StatusError):
        BlockManifest.from_bytes(evil)
    with pytest.raises(bt.StatusError):
        JManifest.from_bytes(evil)


@pytest.mark.parametrize("kernels", [False, True])
def test_import_lying_manifest_raw_len(kernels):
    # A container whose manifest under-states raw_len: the planner and the
    # table parser must not crash; decompress raises in both packages,
    # with the same per-block status.
    data = bytes(np.random.default_rng(90).integers(97, 110, 4096, dtype=np.uint8))
    kw = dict(block_size=1024, burst_size=8, max_pool_slots=64)
    port = btt.Engine(btt.EngineConfig(codec=btt.Codec.LZ4, use_tpu_kernels=kernels, **kw),
                      device="cpu").initialize()
    ref = bt.Engine(bt.EngineConfig(codec=bt.Codec.LZ4, use_tpu_kernels=kernels,
                                    interpret=kernels, **kw)).initialize()
    unit = port.compress(data)
    cb = unit.to_host()
    port.recycle(unit)
    lying = BlockManifest(block_size=cb.manifest.block_size, total_raw=cb.manifest.total_raw - 1,
                          raw_len=cb.manifest.raw_len.copy(), comp_len=cb.manifest.comp_len,
                          codec_ids=cb.manifest.codec_ids, checksums=cb.manifest.checksums)
    lying.raw_len[-1] -= 1
    blob = CompressedBuffers(manifest=lying, packed=cb.packed).to_bytes()
    tu = port.import_unit(CompressedBuffers.from_bytes(blob))
    ju = ref.import_unit(bt.CompressedBuffers.from_bytes(blob))
    _, tst = port.decompress_status(tu)
    _, jst = ref.decompress_status(ju)
    np.testing.assert_array_equal(tst, jst)
    assert tst[-1] < 0
    with pytest.raises(btt.StatusError):
        port.decompress(tu)
    port.release()
    ref.release()


def test_manifest_magic_check():
    with pytest.raises(btt.StatusError):
        BlockManifest.from_bytes(b"NOPE" + b"\0" * 40)
    assert tmanifest.MAGIC == bt.manifest.MAGIC == b"BTPU"
