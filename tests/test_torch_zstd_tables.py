"""Zstd units of 4 KiB blocks on the sequence-table path, on the CPU through
the plain PyTorch version of B2.

A Zstd block's table indexes its entropy-decoded literal plane, which the
unit keeps beside its tables (``CompressedUnit.lit_planes``); its picks and
bursts decode from the engine's literal store (one row an arena slot) and
table store through their slots.  The data is the MultiGet cell's: RocksDB
SSTs of YCSB records (``benchmark/reference/kv.py``), 2 SSTs x 40 blocks.
Everything is held to the raw blocks, to the plain Zstd decoder of the
benchmark (``benchmark/reference/zstd.py``) and to the JAX engine, which
decodes such units on the host: the same bytes and per-block statuses.
Tolerance 0.
"""

import threading
from concurrent.futures import ThreadPoolExecutor
from functools import cache

import numpy as np
import pytest
import torch

import bitar_tpu as bt
import bitar_tpu_torch as btt
from benchmark.reference import kv, zstd
from bitar_tpu_torch.engine import device as device_mod
from bitar_tpu_torch.manifest import codec_id
from bitar_tpu_torch.ops.cpu import native
from bitar_tpu_torch.utils import profiling

torch.set_num_threads(1)

BLOCK = 4096
SSTS, PER_SST = 2, 40


@cache
def table() -> kv.Table:
    return kv.make({"generator": "rocksdb_ycsb", "units": SSTS, "unit_blocks": PER_SST},
                   2**31 + 7, BLOCK)


def sst(u: int) -> tuple[bytes, list[int]]:
    """SST ``u``'s bytes and its block sizes."""
    t = table()
    off = np.concatenate([[0], np.cumsum(t.sizes)])
    b0, b1 = u * PER_SST, (u + 1) * PER_SST
    return t.raw[off[b0]:off[b1]].tobytes(), t.sizes[b0:b1].tolist()


def blocks_of(data: bytes, sizes: list[int]) -> list[bytes]:
    off = np.concatenate([[0], np.cumsum(sizes)])
    return [data[off[i]:off[i + 1]] for i in range(len(sizes))]


def engine(codec=btt.Codec.ZSTD, **kw) -> btt.Engine:
    kw = dict(block_size=BLOCK, burst_size=16, max_pool_slots=256, min_match=4,
              commit="deferred", plan_build="lazy") | kw
    return btt.Engine(btt.EngineConfig(codec=codec, **kw), device="cpu").initialize()


def zstd_units(eng, n: int = SSTS):
    """The SSTs compressed and planned: (units, each unit's raw blocks)."""
    units, raws = [], []
    for u in range(n):
        data, sizes = sst(u)
        unit = eng.compress(data, sizes=sizes)
        eng.ensure_plans(unit)
        units.append(unit)
        raws.append(blocks_of(data, sizes))
    return units, raws


def check_picks(eng, units, raws, ui, bi):
    got = eng.decompress_blocks_device(units, ui, bi)
    assert got.shape == (len(ui), BLOCK // 128, 128)
    for j, (u, b) in enumerate(zip(ui.tolist(), bi.tolist(), strict=True)):
        want = raws[u][b]
        assert got[j].reshape(-1)[:len(want)].numpy().tobytes() == want, (j, u, b)
    return got


def picks(units, k: int, seed: int):
    rng = np.random.default_rng(seed)
    ui = rng.integers(0, len(units), k)
    return ui, np.array([int(rng.integers(0, units[u].nblocks)) for u in ui.tolist()])


def release(eng, units):
    for u in units:
        eng.recycle(u)
    eng.release()


def test_ensure_plans_gives_tables_and_literal_planes():
    eng = engine()
    units, raws = zstd_units(eng, 1)
    unit, m = units[0], units[0].manifest
    assert unit.plan_flat is None and unit.tables is not None and unit.lit_planes is not None
    flat, lens = unit.lit_planes
    assert lens.shape == (unit.nblocks,) and int(lens.sum()) == flat.size
    assert (m.codec_ids == codec_id(btt.Codec.ZSTD)).all()
    stored = unit.to_host()
    off = np.concatenate([[0], np.cumsum(lens)])
    for i in range(unit.nblocks):
        frame = stored.packed[int(m.comp_off[i]):int(m.comp_off[i]) + int(m.comp_len[i])]
        t, lit = native.zstd_parse(frame)
        assert np.array_equal(flat[off[i]:off[i + 1]], lit), i
        n = int(unit.nseq[i])
        for k in native.SEQUENCE_KEYS:
            assert np.array_equal(unit.tables[k][i, :n], t[k]), (i, k)
        assert len(lit) < len(raws[0][i])              # literal planes, not whole blocks
    release(eng, units)


def test_every_stored_frame_decodes_with_the_plain_decoder():
    eng = engine()
    units, raws = zstd_units(eng)
    for unit, raw in zip(units, raws, strict=True):
        m, packed = unit.manifest, unit.to_host().packed
        for i in range(unit.nblocks):
            frame = packed[int(m.comp_off[i]):int(m.comp_off[i]) + int(m.comp_len[i])].tobytes()
            assert zstd.decode_stored(frame, int(m.codec_ids[i]), len(raw[i])).tobytes() == raw[i]
    release(eng, units)


@pytest.mark.parametrize("read", ["gathered", "in place"])
def test_picks_across_zstd_units_equal_raw_blocks(read, monkeypatch):
    if read == "in place":
        monkeypatch.setattr(device_mod, "_reads_in_place", lambda device: True)
    eng = engine()
    units, raws = zstd_units(eng)
    ui, bi = picks(units, 37, 3)                 # three launches of burst_size 16
    got = check_picks(eng, units, raws, ui, bi)
    whole = [torch.cat(eng.decompress_device(u)) for u in units]
    for j, (u, b) in enumerate(zip(ui.tolist(), bi.tolist(), strict=True)):
        assert torch.equal(got[j], whole[u][b])
    release(eng, units)


@pytest.mark.parametrize("read", ["gathered", "in place"])
def test_zstd_and_lz4_units_in_one_call(read, monkeypatch):
    # An LZ4 engine's own units beside imported Zstd ones: one call, one
    # group of launches over the arena and one over the literal store, from
    # one slot map over all four units, kept for the next call.
    if read == "in place":
        monkeypatch.setattr(device_mod, "_reads_in_place", lambda device: True)
    eng = engine(btt.Codec.LZ4)
    zeng = engine()
    zunits, zraws = zstd_units(zeng)
    lunits, lraws = zstd_units(eng)
    imported = [eng.import_unit(u.to_host()) for u in zunits]
    units = [lunits[0], imported[0], lunits[1], imported[1]]
    raws = [lraws[0], zraws[0], lraws[1], zraws[1]]
    ui, bi = picks(units, 45, 4)
    profiling.snapshot(reset=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        check_picks(eng, units, raws, ui, bi)
    assert [u.lit_planes is not None for u in units] == [False, True, False, True]
    kept = eng._pick_slots
    assert [id(u) for u in kept[0]] == [id(u) for u in units]
    names = [e.name for e in prof.events() if e.name.startswith("bitar.")]
    zpicks = int(np.isin(ui, [1, 3]).sum())
    burst = eng.config.burst_size
    assert names.count("bitar.ops.decode_tables") == (-(-(len(ui) - zpicks) // burst)
                                                     + -(-zpicks // burst))
    assert names.count("bitar.engine.lit_picks") == 1
    c = profiling.snapshot(reset=True)
    assert c["decode_tables.blocks"] == len(ui) and c["decode_tables.lit_blocks"] == zpicks
    if read == "in place":
        assert c["arena.inplace_blocks"] == len(ui) and "arena.gather_bytes" not in c
    else:
        assert c["arena.gather_bytes"] == (len(ui) - zpicks) * eng.config.slot_size
    check_picks(eng, units, raws, *picks(units, 30, 11))
    assert eng._pick_slots is kept                       # the same units: the map is kept
    release(zeng, zunits)
    release(eng, units)


@pytest.mark.parametrize("read", ["gathered", "in place"])
@pytest.mark.parametrize("codec", ["lz4", "zstd"])
def test_whole_table_units_decode_through_the_stores(codec, read, monkeypatch):
    # decompress_device of a table unit launches as its picks do: through
    # its slots over the table store, and over the arena (gathered on the
    # CPU) or the literal store.
    if read == "in place":
        monkeypatch.setattr(device_mod, "_reads_in_place", lambda device: True)
    eng = engine(btt.Codec(codec))
    units, raws = zstd_units(eng, 1)
    unit = units[0]
    profiling.snapshot(reset=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        planes = torch.cat(eng.decompress_device(unit)).reshape(unit.nblocks, -1).numpy()
    c = profiling.snapshot(reset=True)
    assert [planes[i, :len(r)].tobytes() for i, r in enumerate(raws[0])] == raws[0]
    assert unit._in_table_store and c["decode_tables.blocks"] == unit.nblocks
    if read == "in place":
        assert c["arena.inplace_blocks"] == unit.nblocks and "arena.gather_bytes" not in c
    elif codec == "lz4":
        assert c["arena.gather_bytes"] == unit.nblocks * eng.config.slot_size
    else:
        assert "arena.gather_bytes" not in c and "arena.inplace_blocks" not in c
    assert ("decode_tables.lit_blocks" in c) == (codec == "zstd")
    assert eng.decompress(unit).tobytes() == b"".join(raws[0])
    release(eng, units)


@pytest.mark.parametrize("codec", ["lz4", "zstd"])
def test_units_enter_the_stores_from_several_threads(codec):
    # Whole-unit decodes on several threads at once (as streams run them)
    # enter their units together: the first builds the stores, and no
    # unit's rows are lost to another's entry.  Each round a fresh engine.
    data = []
    for u in range(SSTS):                      # each SST's first 8 blocks
        whole, sizes = sst(u)
        data.append((whole[:sum(sizes[:8])], sizes[:8]))
    for _ in range(3):
        eng = engine(btt.Codec(codec))
        units = [eng.compress(data[i % SSTS][0], sizes=data[i % SSTS][1]) for i in range(6)]
        for unit in units:
            eng.ensure_plans(unit)
        assert all(u.tables is not None for u in units)
        start = threading.Barrier(len(units))

        def decode(unit):
            start.wait()
            return eng.decompress(unit).tobytes()

        with ThreadPoolExecutor(len(units)) as pool:
            got = list(pool.map(decode, units))
        assert got == [data[i % SSTS][0] for i in range(len(units))]
        release(eng, units)


def jax_engine():
    return bt.Engine(bt.EngineConfig(codec=bt.Codec.ZSTD, block_size=BLOCK, burst_size=16,
                                     max_pool_slots=256, commit="deferred",
                                     plan_build="lazy", interpret=True)).initialize()


def test_whole_unit_decodes_equal_raw_and_the_jax_engine():
    eng, jax_eng = engine(), jax_engine()
    units, raws = zstd_units(eng)
    for unit, raw in zip(units, raws, strict=True):
        planes = torch.cat(eng.decompress_device(unit)).reshape(unit.nblocks, -1).numpy()
        assert [planes[i, :len(r)].tobytes() for i, r in enumerate(raw)] == raw
        ju = jax_eng.import_unit(bt.CompressedBuffers.from_bytes(unit.to_host().to_bytes()))
        jout, jst = jax_eng.decompress_status(ju)
        tout, tst = eng.decompress_status(unit)
        np.testing.assert_array_equal(tst, jst)
        assert tout.tobytes() == jout.tobytes() == b"".join(raw)
        assert eng.decompress(unit).tobytes() == b"".join(raw)
        assert jax_eng.stats.host_decode_bursts > 0           # the JAX engine's route
        jax_eng.recycle(ju)
    assert eng.stats.host_decode_bursts == 0
    release(eng, units)
    jax_eng.release()


def test_foreign_zstd_container_decodes_through_the_tables():
    zstandard = pytest.importorskip("zstandard")
    data, sizes = sst(1)
    raw = blocks_of(data, sizes)
    frames = [zstandard.ZstdCompressor(level=3).compress(b) for b in raw]
    m = btt.BlockManifest.plan_sizes(sizes, BLOCK)
    m.comp_len = np.array([len(f) for f in frames], np.int32)
    m.codec_ids = np.full(len(frames), codec_id(btt.Codec.ZSTD), np.int32)
    cb = btt.CompressedBuffers(manifest=m, packed=np.frombuffer(b"".join(frames), np.uint8))
    eng, jax_eng = engine(), jax_engine()
    unit = eng.import_unit(cb)
    ui, bi = picks([unit], 21, 5)
    check_picks(eng, [unit], [raw], ui, bi)
    assert unit.tables is not None and unit.lit_planes is not None
    ju = jax_eng.import_unit(bt.CompressedBuffers.from_bytes(cb.to_bytes()))
    jout, jst = jax_eng.decompress_status(ju)
    tout, tst = eng.decompress_status(unit)
    np.testing.assert_array_equal(tst, jst)
    assert tout.tobytes() == jout.tobytes() == data
    release(eng, [unit])
    jax_eng.release()


def test_a_corrupt_frame_leaves_the_unit_host_only():
    eng, jax_eng = engine(), jax_engine()
    data, sizes = sst(0)
    cb = eng.compress(data, sizes=sizes).to_host()
    packed = cb.packed.copy()
    packed[int(cb.manifest.comp_off[3]) + 4:][:24] ^= 0x5A     # past frame 3's magic
    broken = btt.CompressedBuffers(manifest=cb.manifest, packed=packed)
    unit = eng.import_unit(broken)
    eng.ensure_plans(unit)
    assert unit.tables is None and unit.lit_planes is None and unit.plan_flat is None
    with pytest.raises(btt.StatusError) as ei:
        eng.decompress_blocks_device([unit], [0], [0])
    assert ei.value.status.code == btt.StatusCode.NOT_IMPLEMENTED
    ju = jax_eng.import_unit(bt.CompressedBuffers.from_bytes(broken.to_bytes()))
    jout, jst = jax_eng.decompress_status(ju)
    tout, tst = eng.decompress_status(unit)
    np.testing.assert_array_equal(tst, jst)
    assert tst[3] < 0 and (np.delete(tst, 3) == 0).all()
    good = np.repeat(tst == 0, sizes)
    want = np.frombuffer(data, np.uint8)[good].tobytes()
    assert tout[good].tobytes() == jout[good].tobytes() == want
    eng.release()
    jax_eng.release()


def test_raw_blocks_read_their_stored_bytes_from_the_store():
    # Random records stored as they came sit beside Zstd blocks; the store
    # widens when a unit with wider planes enters.
    rng = np.random.default_rng(9)
    eng = engine()
    narrow, raws = zstd_units(eng, 1)
    eng.decompress_blocks_device(narrow, [0], [0])
    width = eng._lit_store.shape[1]
    sizes = [BLOCK] * 3 + [1000]
    data = rng.integers(0, 256, sum(sizes), np.uint8).tobytes()
    wide = eng.compress(data, sizes=sizes)
    eng.ensure_plans(wide)
    assert (wide.manifest.codec_ids == codec_id(btt.Codec.RAW)).all()
    assert wide.lit_planes is None                  # no Zstd block: the arena's tables
    mixed_data = data[:BLOCK] + sst(1)[0][:3 * 1000]
    mixed = eng.compress(mixed_data, sizes=[BLOCK, 1000, 1000, 1000])
    eng.ensure_plans(mixed)
    assert mixed.manifest.codec_ids[0] == codec_id(btt.Codec.RAW)
    assert mixed.lit_planes[1][0] == BLOCK
    units = [narrow[0], mixed]
    ui, bi = picks(units, 19, 6)
    check_picks(eng, units, [raws[0], blocks_of(mixed_data, [BLOCK] + [1000] * 3)], ui, bi)
    assert eng._lit_store.shape[1] == BLOCK > width
    release(eng, units + [wide])


def test_recycle_zeroes_the_units_literal_store_rows():
    eng = engine()
    units, raws = zstd_units(eng)
    check_picks(eng, units, raws, *picks(units, 12, 7))
    store = eng._lit_store
    assert store.shape == (eng.arena.buffer.shape[0], store.shape[1])
    gone = units[0].slot_table().long()
    lens = torch.from_numpy(units[0].lit_planes[1].astype(np.int64))
    assert store[gone].any(1).all() and (lens <= store.shape[1]).all()
    eng.recycle(units[0])
    assert not store[gone].any()
    kept = units[1].slot_table().long()
    assert store[kept].any(1).all()
    check_picks(eng, units[1:], raws[1:], *picks(units[1:], 9, 8))
    eng.recycle(units[1])
    assert not eng._lit_store.any() and not eng._table_store[1].any()
    eng.release()


@pytest.fixture
def counters():
    profiling.snapshot(reset=True)
    yield
    profiling.snapshot(reset=True)


@pytest.mark.parametrize("read", ["gathered", "in place"])
def test_traced_spans_and_counters(read, monkeypatch, counters):
    if read == "in place":
        monkeypatch.setattr(device_mod, "_reads_in_place", lambda device: True)
    eng = engine()
    units, raws = zstd_units(eng)
    ui, bi = picks(units, 37, 10)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        check_picks(eng, units, raws, ui, bi)
    names = [e.name for e in prof.events() if e.name.startswith("bitar.")]
    launches = -(-len(ui) // eng.config.burst_size)
    assert {n: names.count(n) for n in set(names)} == {
        "bitar.engine.decompress_blocks_device": 1, "bitar.engine.lit_store_enter": 2,
        "bitar.engine.lit_picks": 1, "bitar.ops.decode_tables": launches}
    lit = sum(int(units[u].lit_planes[1][b]) for u, b in zip(ui, bi, strict=True))
    stored = sum(int(units[u].manifest.comp_len[b]) for u, b in zip(ui, bi, strict=True))
    want = {"engine.picked_blocks": len(ui), "engine.picked_units": 2,
            "decode_tables.blocks": len(ui), "decode_tables.lit_blocks": len(ui),
            "decode_tables.lit_bytes": lit, "decode_tables.lit_stored_bytes": stored,
            "engine.lit_store_bytes": sum(int(u.lit_planes[1].sum()) for u in units)}
    if read == "in place":
        want["arena.inplace_blocks"] = len(ui)
    assert profiling.snapshot(reset=True) == want
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.decompress_device(units[0])                # the stores are entered: no entry again
    c = profiling.snapshot(reset=True)
    assert c["decode_tables.lit_blocks"] == units[0].nblocks
    assert c["decode_tables.lit_bytes"] == int(units[0].lit_planes[1].sum())
    assert "engine.lit_store_bytes" not in c
    release(eng, units)
