"""Block-granular device decode across resident units
(``Engine.decompress_blocks_device``) on the CPU, through the plain PyTorch
versions of B1 and B2.

Picks spread over several units must equal the raw blocks and each unit's
whole-unit ``decompress_device`` planes at those rows: 4 KiB LZ4 units (the
sequence-table path, one table store for every unit), 16 KiB units (planned,
one flat launch a unit, read in place as on the card or gathered), a unit of
RAW and LZ4 blocks, Zstd units (literal planes), planned and table units in
one call, repeated picks and picks across ``burst_size`` boundaries; table
units gathered (the CPU's path) and read in place through the picks' slots
(the card's, run here through the plain version).  Also: the JAX engine's
whole-unit device decode at the picked rows, the errors, the table store's
life (a recycled unit's rows go, a wider unit widens it), and the spans and
counters, gathered and in place.  Tolerance 0.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import bitar_tpu as bt
import bitar_tpu_torch as btt
from bitar_tpu_torch.engine import device as device_mod
from bitar_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def unit_data(block: int, nblocks: int, seed: int, kinds: str = "tlrm") -> bytes:
    """``nblocks`` blocks of ``block`` bytes, their kinds in turn: t text
    (markdown), l low-entropy, r random (stored RAW), m RLE; a ragged tail."""
    rng = np.random.default_rng(seed)
    src = (ROOT / "SURVEY.md").read_bytes()
    parts = []
    for i in range(nblocks):
        kind = kinds[i % len(kinds)]
        if kind == "t":
            o = int(rng.integers(0, len(src) - block))
            parts.append(src[o:o + block])
        elif kind == "l":
            parts.append(rng.integers(0, 8, block, np.uint8).tobytes())
        elif kind == "r":
            parts.append(rng.integers(0, 256, block, np.uint8).tobytes())
        else:
            parts.append(bytes([i & 0xFF]) * block)
    return b"".join(parts) + b"tail %d " % seed * 9


def engine(block: int, codec=btt.Codec.LZ4, **kw) -> btt.Engine:
    kw = dict(block_size=block, burst_size=4, max_pool_slots=96, min_match=4,
              commit="deferred", plan_build="lazy") | kw
    return btt.Engine(btt.EngineConfig(codec=codec, **kw), device="cpu").initialize()


def raw_blocks(data: bytes, unit) -> list[bytes]:
    off = unit.manifest.raw_off
    return [data[int(off[i]):int(off[i]) + int(n)] for i, n in enumerate(unit.manifest.raw_len)]


def check_picks(eng, units, datas, ui, bi):
    """The picked planes equal the raw blocks over their lengths and each
    unit's whole-unit device decode at those rows."""
    got = eng.decompress_blocks_device(units, ui, bi)
    nrows = eng.config.block_size // 128
    assert got.shape == (len(ui), nrows, 128) and got.dtype == torch.uint8
    whole = [torch.cat(eng.decompress_device(u)) for u in units]
    raws = [raw_blocks(d, u) for d, u in zip(datas, units, strict=True)]
    for j, (u, b) in enumerate(zip(ui.tolist(), bi.tolist(), strict=True)):
        assert torch.equal(got[j], whole[u][b]), (j, u, b)
        n = len(raws[u][b])
        assert got[j].reshape(-1)[:n].numpy().tobytes() == raws[u][b], (j, u, b)
    return got


def spread_picks(units, k: int, seed: int):
    """``k`` picks over every unit and block, in a seeded order."""
    rng = np.random.default_rng(seed)
    ui = rng.integers(0, len(units), k)
    bi = np.array([int(rng.integers(0, units[u].nblocks)) for u in ui.tolist()])
    return ui, bi


CASES = {
    # name: (block, codec, kinds, picks, engine keywords)
    "lz4 4k tables": (4096, btt.Codec.LZ4, "tlrm", 24, {}),
    "planned 16k gathered": (16384, btt.Codec.LZ4, "tlrm", 12, {}),
    "planned 16k in place": (16384, btt.Codec.LZ4, "tlrm", 12, {}),
    "raw and lz4 unit": (4096, btt.Codec.LZ4, "rtrl", 16, {}),
    "zstd literal planes": (16384, btt.Codec.ZSTD, "tlrm", 12, {}),
    "duplicate picks": (4096, btt.Codec.LZ4, "tlrm", 0, {}),
    "across bursts": (4096, btt.Codec.LZ4, "tlm", 19, {"burst_size": 8}),
    "lz4 4k tables in place": (4096, btt.Codec.LZ4, "tlrm", 24, {}),
    "raw and lz4 unit in place": (4096, btt.Codec.LZ4, "rtrl", 16, {}),
    "across bursts in place": (4096, btt.Codec.LZ4, "tlm", 19, {"burst_size": 8}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_picks_equal_raw_blocks_and_whole_unit_decode(case, monkeypatch):
    block, codec, kinds, k, kw = CASES[case]
    if case.endswith("in place"):
        monkeypatch.setattr(device_mod, "_reads_in_place", lambda device: True)
    eng = engine(block, codec, **kw)
    datas = [unit_data(block, 6 + u, 100 * u + 7, kinds) for u in range(3)]
    units = [eng.compress(d) for d in datas]
    for u in units:
        eng.ensure_plans(u)
    planned = block % (128 * 128) == 0
    assert all((u.plan_flat is not None) == planned for u in units)
    if codec == btt.Codec.ZSTD:
        assert all(u.plan_flat["lit_planes"] for u in units)
    if case.startswith("raw and lz4 unit"):
        ids = units[0].manifest.codec_ids
        assert len(set(ids.tolist())) == 2
    if case == "duplicate picks":
        ui = np.array([2, 0, 2, 2, 1, 0, 0, 2])
        bi = np.array([3, 1, 3, 0, 5, 1, 1, 3])
    else:
        ui, bi = spread_picks(units, k, 5)
    if case.startswith("across bursts"):
        assert len(ui) > 2 * eng.config.burst_size
    check_picks(eng, units, datas, ui, bi)
    for u in units:
        eng.recycle(u)
    eng.release()


def test_planned_and_table_units_in_one_call():
    """A unit over the plan budget takes the table path beside planned ones:
    one call decodes both kinds, each in pick order."""
    eng = engine(16384)
    datas = [unit_data(16384, 5, 1), (ROOT / "SURVEY.md").read_bytes()[:3 * 16384],
             unit_data(16384, 5, 3)]
    units = [eng.compress(d) for d in datas]
    eng.ensure_plans(units[0])
    eng._PLAN_MAX_PASSES = 8                         # the markdown blocks' plans fail
    eng.ensure_plans(units[1])
    eng._PLAN_MAX_PASSES = btt.Engine._PLAN_MAX_PASSES
    eng.ensure_plans(units[2])
    assert units[1].plan_flat is None and units[1].tables is not None
    assert units[0].plan_flat is not None and units[2].plan_flat is not None
    ui, bi = spread_picks(units, 17, 9)
    check_picks(eng, units, datas, ui, bi)
    for u in units:
        eng.recycle(u)
    eng.release()


def test_picks_equal_the_jax_engines_device_decode():
    block = 4096
    data = unit_data(block, 10, 21)
    cfg = dict(block_size=block, burst_size=4, max_pool_slots=32, min_match=4,
               commit="deferred")
    jax_eng = bt.Engine(bt.EngineConfig(codec=bt.Codec.LZ4, interpret=True, **cfg)).initialize()
    port = btt.Engine(btt.EngineConfig(codec=btt.Codec.LZ4, **cfg), device="cpu").initialize()
    ju, tu = jax_eng.compress(data), port.compress(data)
    jax_eng.ensure_plans(ju)
    port.ensure_plans(tu)
    assert ju.plan_flat is None and tu.plan_flat is None
    want = np.concatenate([np.asarray(p).reshape(-1, block)
                           for p in jax_eng.decompress_device(ju)])
    bi = np.array([9, 0, 4, 4, 7, 1, 3, 10])
    got = port.decompress_blocks_device([tu], np.zeros(len(bi), np.int64), bi)
    np.testing.assert_array_equal(got.reshape(len(bi), -1).numpy(), want[bi])
    port.recycle(tu)
    jax_eng.release()
    port.release()


def test_errors_raise_status_error():
    eng, other = engine(4096), engine(4096)
    data = unit_data(4096, 4, 3)
    units = [eng.compress(data), eng.compress(data)]
    foreign = other.compress(data)
    # An imported container with a corrupt block has no sequence tables.
    cb = units[0].to_host()
    packed = cb.packed.copy()
    packed[int(cb.manifest.comp_off[1]):][:64] = 0xFF
    hunit = other.import_unit(btt.CompressedBuffers(manifest=cb.manifest, packed=packed))
    other.ensure_plans(hunit)
    assert hunit.plan_flat is None and hunit.tables is None
    nb = units[0].nblocks
    bad = {
        "recycled unit": (eng, [units[0], units[1]], [0, 1], [0, 0]),
        "another engine's unit": (eng, [units[0], foreign], [1, 0], [0, 0]),
        "block past the unit": (eng, units, [0, 1], [0, nb]),
        "negative block": (eng, units, [1], [-1]),
        "unit index past the units": (eng, units, [2], [0]),
        "lengths differ": (eng, units, [0, 1], [0]),
        "float picks": (eng, units, [0.0], [0.0]),
        "host-only unit": (other, [hunit], [0], [0]),
    }
    eng.recycle(units[1])
    for name, (e, us, ui, bi) in bad.items():
        with pytest.raises(btt.StatusError) as ei:
            e.decompress_blocks_device(us, np.array(ui), np.array(bi))
        want = (btt.StatusCode.NOT_IMPLEMENTED if name == "host-only unit"
                else btt.StatusCode.INVALID)
        assert ei.value.status.code == want, name
    empty = eng.decompress_blocks_device(units[:1], [], [])
    assert empty.shape == (0, 32, 128)
    for e, u in ((eng, units[0]), (other, foreign), (other, hunit)):
        e.recycle(u)
    for e in (eng, other):
        e.release()


def test_table_store_drops_recycled_rows_and_widens():
    eng = engine(4096)
    narrow = [eng.compress(unit_data(4096, 6, s, "rm")) for s in (1, 2)]
    for u in narrow:
        eng.ensure_plans(u)
    assert all(u.tables["lit_ptr"].shape[1] == 128 for u in narrow)
    eng.decompress_blocks_device(narrow, [0, 1], [0, 0])
    nseq, cols = eng._table_store
    assert cols.shape == (5, eng.arena.buffer.shape[0], 128)
    gone = torch.tensor([r.slot for r in narrow[0].refs])
    assert (nseq[gone] > 0).all()
    eng.recycle(narrow[0])
    assert (nseq[gone] == 0).all() and not cols[:, gone].any()
    wide_data = unit_data(4096, 6, 3, "t")
    wide = eng.compress(wide_data)
    eng.ensure_plans(wide)
    width = wide.tables["lit_ptr"].shape[1]
    assert width > 128
    units, datas = [narrow[1], wide], [unit_data(4096, 6, 2, "rm"), wide_data]
    ui, bi = spread_picks(units, 14, 3)
    check_picks(eng, units, datas, ui, bi)
    assert eng._table_store[1].shape == (5, eng.arena.buffer.shape[0], width)
    for u in units:
        eng.recycle(u)
    assert not eng._table_store[0].any() and not eng._table_store[1].any()
    eng.release()


@pytest.fixture
def counters():
    profiling.snapshot(reset=True)
    yield
    profiling.snapshot(reset=True)


def test_spans_and_counters_of_a_pick(counters):
    eng = engine(4096)
    units = [eng.compress(unit_data(4096, 6, s, "rm")) for s in (4, 5, 6)]
    ui = np.array([0, 2, 2, 0, 2, 0, 2, 2, 0, 0])
    bi = np.array([1, 0, 5, 1, 3, 2, 4, 1, 0, 5])
    eng.decompress_blocks_device(units, ui, bi)          # off: nothing counted
    assert profiling.snapshot() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.decompress_blocks_device(units, ui, bi)
    names = [e.name for e in prof.events() if e.name.startswith("bitar.")]
    launches = -(-len(ui) // eng.config.burst_size)
    assert {n: names.count(n) for n in set(names)} == {
        "bitar.engine.decompress_blocks_device": 1, "bitar.arena.gather_burst": launches,
        "bitar.ops.decode_tables": launches}
    stored = sum(int(units[u].manifest.comp_len[b]) for u, b in zip(ui, bi, strict=True))
    assert profiling.snapshot() == {
        "engine.picked_blocks": len(ui), "engine.picked_units": 2,
        "decode_tables.blocks": len(ui), "arena.gather_stored_bytes": stored,
        "arena.gather_bytes": len(ui) * eng.config.slot_size}
    for u in units:
        eng.recycle(u)
    eng.release()


def mixed_units(eng):
    """Two planned 16 KiB units and, between them, one over the plan budget
    (the table path): (units, their data)."""
    datas = [unit_data(16384, 5, 1), (ROOT / "SURVEY.md").read_bytes()[:3 * 16384],
             unit_data(16384, 5, 3)]
    units = [eng.compress(d) for d in datas]
    eng.ensure_plans(units[0])
    eng._PLAN_MAX_PASSES = 8                         # the markdown blocks' plans fail
    eng.ensure_plans(units[1])
    eng._PLAN_MAX_PASSES = btt.Engine._PLAN_MAX_PASSES
    eng.ensure_plans(units[2])
    assert units[1].plan_flat is None and units[1].tables is not None
    return units, datas


@pytest.mark.parametrize("kind", ["table units", "planned and table units"])
def test_picks_read_in_place_gather_nothing(kind, monkeypatch, counters):
    # As on the card: every pick, of a table unit or a planned one, decodes
    # where its slot lies (and a table unit's table where its store row
    # lies); traced, no gather span or counter, and arena.inplace_blocks
    # counts every pick.
    monkeypatch.setattr(device_mod, "_reads_in_place", lambda device: True)
    if kind == "table units":
        eng = engine(4096)
        datas = [unit_data(4096, 6 + u, 30 + u) for u in range(3)]
        units = [eng.compress(d) for d in datas]
    else:
        eng = engine(16384)
        units, datas = mixed_units(eng)
    ui, bi = spread_picks(units, 21, 11)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = eng.decompress_blocks_device(units, ui, bi)
    names = {e.name for e in prof.events() if e.name.startswith("bitar.")}
    counted = profiling.snapshot(reset=True)
    assert "bitar.arena.gather_burst" not in names
    assert counted["arena.inplace_blocks"] == len(ui) == counted["engine.picked_blocks"]
    assert not {"arena.gather_bytes", "arena.gather_stored_bytes"} & set(counted)
    assert torch.equal(got, check_picks(eng, units, datas, ui, bi))
    for u in units:
        eng.recycle(u)
    eng.release()


def test_pick_slots_are_kept_for_the_same_units_and_dropped_by_recycle(monkeypatch):
    # The host slot tables laid end to end are built once for a set of
    # table units, rebuilt for another set, dropped by recycle; each unit's
    # host slot table is its slot table's copy, dropped with it.
    monkeypatch.setattr(device_mod, "_reads_in_place", lambda device: True)
    eng = engine(4096)
    datas = [unit_data(4096, 5, 40 + u, "tlm") for u in range(3)]
    units = [eng.compress(d) for d in datas]
    check_picks(eng, units, datas, *spread_picks(units, 9, 1))
    kept = eng._pick_slots
    nb = [u.nblocks for u in units]
    assert all(a is b for a, b in zip(kept[0], units, strict=True))
    assert kept[1].tolist() == [0, nb[0], nb[0] + nb[1]]
    assert kept[2].tolist() == [r.slot for u in units for r in u.refs]
    for u in units:
        assert u.host_slot_table().tolist() == u.slot_table().tolist()
    check_picks(eng, units, datas, *spread_picks(units, 9, 2))
    assert eng._pick_slots is kept
    check_picks(eng, units[1:], datas[1:], *spread_picks(units[1:], 7, 3))
    assert eng._pick_slots is not kept
    assert all(a is b for a, b in zip(eng._pick_slots[0], units[1:], strict=True))
    eng.recycle(units[0])
    assert eng._pick_slots is None and units[0]._slots_host is None
    for u in units[1:]:
        eng.recycle(u)
    eng.release()


def test_picks_find_their_slots_as_the_units_touched_change(monkeypatch):
    # Picks find their slots whatever units a call touches: all of them, a
    # subset in another order (the kept map built anew), and a unit made
    # after another was recycled (in the slots that one left); each unit's
    # host slot table is its slot table's copy, and recycle drops it.
    monkeypatch.setattr(device_mod, "_reads_in_place", lambda device: True)
    eng = engine(4096)
    datas = [unit_data(4096, 5, 40 + u, "tlm") for u in range(3)]
    units = [eng.compress(d) for d in datas]
    check_picks(eng, units, datas, *spread_picks(units, 9, 1))
    for u in units:
        assert u.host_slot_table().tolist() == u.slot_table().tolist()
        assert u.host_slot_table().tolist() == [r.slot for r in u.refs]
    check_picks(eng, units[:0:-1], datas[:0:-1], *spread_picks(units[:0:-1], 7, 2))
    freed = set(units[0].host_slot_table().tolist())
    eng.recycle(units[0])
    assert units[0]._slots_host is None and units[0]._slots_dev is None
    datas[0] = unit_data(4096, 5, 50, "tml")
    units[0] = eng.compress(datas[0])
    assert set(units[0].host_slot_table().tolist()) & freed
    check_picks(eng, units, datas, *spread_picks(units, 11, 3))
    for u in units:
        eng.recycle(u)
    eng.release()
