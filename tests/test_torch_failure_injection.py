"""Failure injection and per-block status on the port, beside the JAX
engine: the scenarios of ``tests/test_failure_injection.py`` on both
engines with the same config and data, comparing per-block status and
bytes; a corrupt block in a 1 MiB unit on the planned and the tables path;
containers with mutated payload bytes, host path against kernel path and
port against JAX; and the port's answer to a kernel failure, which is to
raise (the JAX engine falls back to the host there; the port never does).
Every test seeds its own generator; tolerance 0.
"""

from unittest.mock import patch

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitar_tpu as bt
import bitar_tpu_torch as btt
from bitar_tpu_torch.manifest import BlockManifest, CompressedBuffers, checksum_of, codec_id
from bitar_tpu_torch.ops.cpu import native
from bitar_tpu_torch.status import Status, StatusError
from bitar_tpu_torch.utils.corpus import make_text_corpus

torch.set_num_threads(1)

BLOCK = 2048


def kw(**over):
    base = dict(block_size=BLOCK, burst_size=8, max_pool_slots=64, use_tpu_kernels=False,
                checksum="crc32", codec="lz4")
    base.update(over)
    return base


def jax_engine(**over):
    """A JAX engine; its kernels run in interpret mode."""
    k = kw(**over)
    codec, checksum = k.pop("codec"), k.pop("checksum")
    return bt.Engine(bt.EngineConfig(codec=bt.Codec(codec), checksum=bt.Checksum(checksum),
                                     interpret=k["use_tpu_kernels"], **k)).initialize()


def port_engine(**over):
    """A port engine on the CPU (its kernels' plain versions)."""
    k = kw(**over)
    codec, checksum = k.pop("codec"), k.pop("checksum")
    return btt.Engine(btt.EngineConfig(codec=btt.Codec(codec), checksum=btt.Checksum(checksum),
                                       **k), device="cpu").initialize()


def pair(**over):
    """(JAX engine, port engine) with the same knobs."""
    return jax_engine(**over), port_engine(**over)


def container(data: bytes, **over) -> CompressedBuffers:
    k = kw(**over)
    codec, checksum = k.pop("codec"), k.pop("checksum")
    with btt.Engine(btt.EngineConfig(codec=btt.Codec(codec), checksum=btt.Checksum(checksum),
                                     **k), device="cpu") as eng:
        unit = eng.compress(data)
        cb = unit.to_host()
        eng.recycle(unit)
    return cb


def decode_both(ref, port, blob: bytes):
    """Import ``blob`` into both engines and decode with status: ((JAX out,
    status), (port out, status))."""
    ju = ref.import_unit(bt.CompressedBuffers.from_bytes(blob))
    tu = port.import_unit(CompressedBuffers.from_bytes(blob))
    res = ref.decompress_status(ju), port.decompress_status(tu)
    ref.recycle(ju)
    port.recycle(tu)
    return res


def assert_same(jres, tres, m, data=None):
    """Same status per block; the same bytes in every good block (and, with
    ``data``, those bytes are the input's)."""
    (jout, jst), (tout, tst) = jres, tres
    np.testing.assert_array_equal(tst, jst)
    for i in np.flatnonzero(tst == 0):
        o, ln = int(m.raw_off[i]), int(m.raw_len[i])
        assert tout[o:o + ln].tobytes() == jout[o:o + ln].tobytes(), f"block {i}"
        if data is not None:
            assert tout[o:o + ln].tobytes() == data[o:o + ln], f"block {i}"


@pytest.mark.parametrize("kernels", [False, True])
def test_corrupt_block_mid_unit_reports_all_bad_blocks(kernels):
    data = bytes(np.random.default_rng(101).integers(97, 110, 8 * BLOCK, dtype=np.uint8))
    cb = container(data)
    for k in (2, 5):                  # corrupt blocks 2 and 5 in the packed payload
        cb.packed[int(cb.manifest.comp_off[k]) + 3] ^= 0xA5
    ref, port = pair(use_tpu_kernels=kernels)
    jres, tres = decode_both(ref, port, cb.to_bytes())
    assert_same(jres, tres, cb.manifest, data)
    assert set(np.flatnonzero(tres[1] < 0).tolist()) == {2, 5}
    assert port.error_count() == ref.error_count() >= 2
    unit = port.import_unit(cb)
    with pytest.raises(StatusError) as ei:        # the raising API names every failed block
        port.decompress(unit)
    assert "[2, 5]" in str(ei.value)
    port.release()
    ref.release()


def test_corrupt_block_planned_path():
    # 16 KiB blocks: the flat-plan kernel's path; the corrupt block is
    # named, its neighbours decode, in both engines.
    data = bytes(np.random.default_rng(102).integers(97, 110, 4 * 16384, dtype=np.uint8))
    cb = container(data, block_size=16384)
    cb.packed[int(cb.manifest.comp_off[1]) + 2] ^= 0xFF
    ref, port = pair(use_tpu_kernels=True, block_size=16384)
    jres, tres = decode_both(ref, port, cb.to_bytes())
    assert_same(jres, tres, cb.manifest, data)
    assert tres[1][1] < 0 and (tres[1][np.arange(4) != 1] == 0).all()
    port.release()
    ref.release()


def corrupt_slot(eng, unit, i: int, jax: bool) -> None:
    row = np.asarray(eng.arena.gather_burst([unit.refs[i].slot]))[0].copy()
    row[0] ^= 0xFF                    # first token byte: breaks the framing
    eng.arena.write_burst([unit.refs[i].slot], jnp.asarray(row[None]) if jax else row[None])


def test_corrupt_slot_after_table_build_is_named():
    # The sequence-table path (2 KiB blocks do not plan) runs tables parsed
    # at build time; a slot corrupted after that build is still named, by
    # the decode-time framing walk, in both engines.
    data = ((b"table path payload %d " % 7) * (8 * BLOCK // 21))[:8 * BLOCK]
    ref, port = pair(use_tpu_kernels=True, checksum="none")
    ju, tu = ref.compress(data), port.compress(data)
    for eng, unit, jax in ((ref, ju, True), (port, tu, False)):
        eng.ensure_plans(unit)
        assert unit.plan_flat is None and unit.tables is not None
        assert int(unit.manifest.comp_len[3]) < BLOCK, "block 3 must be LZ4"
        corrupt_slot(eng, unit, 3, jax)
    jres, tres = ref.decompress_status(ju), port.decompress_status(tu)
    assert_same(jres, tres, tu.manifest, data)
    assert np.flatnonzero(tres[1] < 0).tolist() == [3]
    port.release()
    ref.release()


def test_table_path_validation_is_generation_cached(monkeypatch):
    # Repeat decompresses of untouched slots skip the framing walk; a slot
    # rewritten afterwards is walked again and named.
    data = ((b"cache the framing walk %d " % 3) * (8 * BLOCK // 26))[:8 * BLOCK]
    port = port_engine(use_tpu_kernels=True, checksum="none")
    unit = port.compress(data)
    port.ensure_plans(unit)
    assert unit.plan_flat is None and unit.tables is not None
    assert (port.decompress_status(unit)[1] == 0).all()
    calls = []
    real = native.parse_sequences

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(native, "parse_sequences", counting)
    assert (port.decompress_status(unit)[1] == 0).all()
    assert not calls, f"cached validation re-walked {len(calls)} blocks"
    corrupt_slot(port, unit, 2, jax=False)
    status = port.decompress_status(unit)[1]
    assert status[2] < 0 and (status[np.arange(8) != 2] == 0).all()
    assert len(calls) == 1
    port.release()


def test_mixed_codec_unit_splits_per_block():
    # LZ4 and Zstd blocks in ONE unit: every block rides the kernel path
    # (Zstd through its entropy-decoded literal plane), in both engines.
    zstandard = pytest.importorskip("zstandard")
    bs = 16384
    blocks = [((b"lz4 block %d " % i) * (bs // 12))[:bs] for i in range(3)]
    blocks.append((b"zstd block content " * (bs // 18))[:bs])
    comp = [np.asarray(native.lz4_compress(b)) for b in blocks[:3]]
    comp.append(np.frombuffer(zstandard.ZstdCompressor(level=3).compress(blocks[3]), np.uint8))
    m = BlockManifest.plan_sizes([len(b) for b in blocks], bs)
    m.comp_len = np.array([len(c) for c in comp], np.int32)
    m.codec_ids = np.array([codec_id(btt.Codec.LZ4)] * 3 + [codec_id(btt.Codec.ZSTD)], np.int32)
    m.checksum_kind = btt.Checksum.CRC32
    for i, b in enumerate(blocks):
        m.checksums[i] = checksum_of(btt.Checksum.CRC32, b)
    blob = CompressedBuffers(manifest=m, packed=np.concatenate(comp)).to_bytes()
    ref, port = pair(use_tpu_kernels=True, block_size=bs)
    unit = port.import_unit(CompressedBuffers.from_bytes(blob))
    assert port.decompress(unit).tobytes() == b"".join(blocks)
    assert unit.plan_flat["host_blocks"].tolist() == []
    assert 3 in unit.plan_flat["lit_planes"]
    assert port.stats.host_decode_bursts == 0
    port.recycle(unit)
    assert_same(*decode_both(ref, port, blob), m, b"".join(blocks))
    port.release()
    ref.release()


@pytest.mark.parametrize("kernels", [False, True])
def test_status_api_zero_on_clean_unit(kernels):
    data = bytes(np.random.default_rng(103).integers(97, 122, 3 * BLOCK + 77, dtype=np.uint8))
    ref, port = pair(use_tpu_kernels=kernels)
    jres, tres = decode_both(ref, port, container(data).to_bytes())
    assert (tres[1] == 0).all() and tres[0].tobytes() == data
    assert_same(jres, tres, container(data).manifest, data)
    assert port.error_count() == 0
    port.release()
    ref.release()


def test_container_mutation_fuzz():
    # Random byte mutations over a whole serialized container never crash,
    # hang or return wrong bytes silently: each is a clean StatusError at
    # import or a per-block status, and the two engines agree on which.
    rng = np.random.default_rng(104)
    data = ((b"fuzz me gently " * 4000)[:24 * BLOCK]
            + rng.integers(0, 256, 4 * BLOCK, np.uint8).tobytes())
    blob = bytes(container(data).to_bytes())
    ref, port = pair()
    for trial in range(40):
        bad = bytearray(blob)
        for _ in range(int(rng.integers(1, 4))):
            bad[int(rng.integers(0, len(bad)))] ^= int(rng.integers(1, 256))
        outcome = []
        for mod, eng in ((bt, ref), (btt, port)):
            try:
                unit = eng.import_unit(mod.CompressedBuffers.from_bytes(bytes(bad)))
            except (bt.StatusError, btt.StatusError) as e:
                outcome.append(("import", e.status.code.value))
                continue
            try:
                out, status = eng.decompress_status(unit)
                outcome.append(("status", status.tolist()))
                if (status == 0).all():
                    assert out.tobytes() == data, f"trial {trial}: silent corruption"
            except (bt.StatusError, btt.StatusError) as e:
                outcome.append(("decode", e.status.code.value))
            finally:
                eng.recycle(unit)
        assert outcome[0] == outcome[1], f"trial {trial}: {outcome}"
    port.release()
    ref.release()


def test_kernel_failure_raises():
    # A failed kernel launch (or build) on the planned path raises out of
    # decompress: the port never decodes on the host in its place.
    data = (b"no fallback payload " * 4000)[:12 * 16384]
    port = port_engine(use_tpu_kernels=True, block_size=16384)
    unit = port.compress(data)
    failure = StatusError(Status.IOError("decode_flat launch failed: CUDA error 700"))
    with patch("bitar_tpu_torch.ops.decode_flat.FlatLaunch.run", side_effect=failure):
        with pytest.raises(StatusError, match="CUDA error 700"):
            port.decompress(unit)
    assert port.stats.host_decode_bursts == 0
    assert port.decompress(unit).tobytes() == data
    port.release()


@pytest.mark.parametrize("path", ["planned", "tables"])
def test_corrupt_block_in_a_1mib_unit(path):
    # Three 1 MiB blocks of the text corpus.  Planned path (out passes): a
    # byte in the middle of block 1's stream flips before import.  Tables
    # path (a 2-pass plan budget plans no block): block 1's first token
    # flips in its slot after the tables were built, as the framing walk
    # finds it.  Either way block 1 is named and its neighbours decode,
    # and the JAX engine's host path gives the same status for the same
    # corrupt container.
    block = 1 << 20
    data = make_text_corpus(24)
    cb = container(data, block_size=block)
    bad = CompressedBuffers(manifest=cb.manifest, packed=cb.packed.copy())
    port = port_engine(use_tpu_kernels=True, block_size=block, max_pool_slots=20)
    if path == "planned":
        bad.packed[int(cb.manifest.comp_off[1]) + int(cb.manifest.comp_len[1]) // 2] ^= 0x5A
        unit = port.import_unit(CompressedBuffers.from_bytes(bad.to_bytes()))
        port.ensure_plans(unit)
        assert unit.plan_flat is not None and unit.plan_flat["host_blocks"].size == 0
        assert (unit.plan_flat["p_used"] > unit.plan_flat["p0"]).all()
    else:
        bad.packed[int(cb.manifest.comp_off[1])] ^= 0xFF
        port._PLAN_MAX_PASSES = 2
        unit = port.import_unit(CompressedBuffers.from_bytes(cb.to_bytes()))
        port.ensure_plans(unit)
        assert unit.plan_flat is None and unit.tables is not None
        corrupt_slot(port, unit, 1, jax=False)
    tres = port.decompress_status(unit)
    ref = jax_engine(block_size=block, max_pool_slots=20)
    jres = ref.decompress_status(ref.import_unit(bt.CompressedBuffers.from_bytes(bad.to_bytes())))
    assert_same(jres, tres, cb.manifest, data)
    assert np.flatnonzero(tres[1] < 0).tolist() == [1]
    assert port.stats.host_decode_bursts == 0
    port.release()
    ref.release()


def mutated(cb: CompressedBuffers, rng, n: int) -> list[bytes]:
    """``n`` containers, each with 1-3 payload bytes of ``cb`` flipped."""
    out = []
    for _ in range(n):
        packed = cb.packed.copy()
        for _ in range(int(rng.integers(1, 4))):
            packed[int(rng.integers(0, packed.size))] ^= int(rng.integers(1, 256))
        out.append(CompressedBuffers(manifest=cb.manifest, packed=packed).to_bytes())
    return out


def mutation_data(block: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return ((b"mutate the payload %d " % seed) * (3 * block // 20)
            + rng.integers(0, 12, 2 * block, np.uint8).tobytes())[:5 * block]


@pytest.mark.parametrize("block", [2048, 16384])
@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_payload_mutations_host_path_equals_kernel_path(codec, block):
    # No checksum, so a mutated literal decodes "cleanly" to other bytes:
    # the port's kernel path (plain versions; tables at 2 KiB, plans at
    # 16 KiB) must give the host path's status and bytes for every one.
    rng = np.random.default_rng(105 + block // 1024)
    cb = container(mutation_data(block, 106), codec=codec, block_size=block, checksum="none")
    engines = [btt.Engine(btt.EngineConfig(**dict(
        kw(use_tpu_kernels=k, block_size=block), codec=btt.Codec(codec),
        checksum=btt.Checksum.NONE)), device="cpu").initialize() for k in (False, True)]
    for blob in mutated(cb, rng, 24):
        res = []
        for eng in engines:
            unit = eng.import_unit(CompressedBuffers.from_bytes(blob))
            res.append(eng.decompress_status(unit))
            eng.recycle(unit)
        assert_same(res[0], res[1], cb.manifest)
    for eng in engines:
        eng.release()


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_payload_mutations_port_equals_jax(codec, kernels):
    # The same mutated containers through the JAX engine and the port, on
    # the host path, and on the kernel path at 16 KiB (the JAX engine's
    # Pallas kernels in interpret mode, so fewer containers).
    block = 16384 if kernels else 2048
    rng = np.random.default_rng(107 + kernels)
    cb = container(mutation_data(block, 108), codec=codec, block_size=block, checksum="none")
    ref, port = pair(codec=codec, block_size=block, checksum="none", use_tpu_kernels=kernels)
    for blob in mutated(cb, rng, 4 if kernels else 24):
        assert_same(*decode_both(ref, port, blob), cb.manifest)
    port.release()
    ref.release()
