"""B1's launch record (``ops.decode_flat.FlatLaunch``) on the CPU, through
the plain PyTorch version.

``prepare_flat_launch`` settles a launch once and ``FlatLaunch.run`` runs it:
it refuses what ``decode_blocks_flat`` refuses, with the same StatusError,
on the CPU too.  The engine keeps one record per burst of a resident
planned unit (``CompressedUnit._flat_launches``), built at the unit's first
decode and run by every later one, read in place as on the card (the seam
``engine.device._reads_in_place`` patched) or over rows gathered anew each
call (the CPU's path, and Zstd units whose literal planes replace rows).
The records' planes equal the one-shot ``decode_blocks_flat``'s byte for
byte; ``recycle`` drops them; traced, ``decode_flat.prepared_blocks``
counts the blocks of every run of a record after its first.  Tolerance 0.
"""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import bitar_tpu_torch as btt
from bitar_tpu_torch.engine import device as device_mod
from bitar_tpu_torch.ops import decode_flat as tflat
from bitar_tpu_torch.status import StatusError
from bitar_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
BLOCK = 16 * 1024


def unit_data(nblocks: int, seed: int) -> bytes:
    """``nblocks`` 16 KiB blocks, in turn markdown, low-entropy bytes,
    random bytes (stored RAW) and a run of one byte; a ragged tail."""
    rng = np.random.default_rng(seed)
    src = (ROOT / "SURVEY.md").read_bytes()
    parts = []
    for i in range(nblocks):
        o = int(rng.integers(0, len(src) - BLOCK))
        parts.append([src[o:o + BLOCK], rng.integers(0, 8, BLOCK, np.uint8).tobytes(),
                      rng.integers(0, 256, BLOCK, np.uint8).tobytes(),
                      bytes([i & 0xFF]) * BLOCK][i % 4])
    return b"".join(parts) + b"tail %d " % seed * 9


def engine(codec=btt.Codec.LZ4) -> btt.Engine:
    cfg = btt.EngineConfig(codec=codec, block_size=BLOCK, burst_size=4, max_pool_slots=64,
                           min_match=4, commit="deferred", plan_build="lazy")
    return btt.Engine(cfg, device="cpu").initialize()


@pytest.fixture
def counters():
    profiling.snapshot(reset=True)
    yield
    profiling.snapshot(reset=True)


def traced_decode(eng, unit) -> tuple[torch.Tensor, dict]:
    """One traced ``decompress_device``: (its planes, the counters it added)."""
    profiling.snapshot(reset=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        planes = torch.cat(eng.decompress_device(unit))
    return planes, profiling.snapshot(reset=True)


def one_shot_planes(eng, unit) -> torch.Tensor:
    """Each burst of ``unit`` through the one-shot ``decode_blocks_flat`` on
    its gathered rows (literal planes in place of Zstd blocks' rows)."""
    pt, nrows = unit.plan_device_arrays(), BLOCK // 128
    bursts = []
    for s in range(0, unit.nblocks, eng.config.burst_size):
        blocks = slice(s, min(unit.nblocks, s + eng.config.burst_size))
        bursts.append(tflat.decode_blocks_flat(
            eng._unit_rows(unit, blocks), eng._plan_rows(pt, blocks),
            comp_rows=unit.plan_comp_rows, out_rows=nrows))
    return torch.cat(bursts)


def check_raw(planes: torch.Tensor, unit, data: bytes) -> None:
    host = planes.reshape(unit.nblocks, -1).numpy()
    assert b"".join(host[i, :int(n)].tobytes()
                    for i, n in enumerate(unit.manifest.raw_len)) == data


@pytest.mark.parametrize("source", ["in place", "gathered", "zstd literal planes"])
def test_bursts_keep_their_records_and_count_them(source, monkeypatch, counters):
    # A resident unit of 11 blocks in bursts of 4: its first decode builds a
    # record a burst, every later one runs the same records, and each run
    # of a record after its first counts its blocks as prepared.  In place,
    # every block is counted as read in place and nothing is gathered;
    # otherwise every call gathers its rows anew.
    if source == "in place":
        monkeypatch.setattr(device_mod, "_reads_in_place", lambda device: True)
    codec = btt.Codec.ZSTD if source == "zstd literal planes" else btt.Codec.LZ4
    eng = engine(codec)
    data = unit_data(11, 5)
    unit = eng.compress(data)
    eng.ensure_plans(unit)
    n = unit.nblocks
    assert n == 12 and unit.plan_flat["host_blocks"].size == 0
    assert bool(unit.plan_flat.get("lit_planes")) == (codec == btt.Codec.ZSTD)
    assert unit._flat_launches == {}
    first, c1 = traced_decode(eng, unit)
    records = dict(unit._flat_launches)
    assert sorted(records) == [0, 4, 8] and all(r.runs == 1 for r in records.values())
    assert [r.n for r in records.values()] == [4, 4, 4]
    second, c2 = traced_decode(eng, unit)
    assert all(unit._flat_launches[k] is r and r.runs == 2 for k, r in records.items())
    assert c1["decode_flat.blocks"] == c2["decode_flat.blocks"] == n
    assert "decode_flat.prepared_blocks" not in c1 and c2["decode_flat.prepared_blocks"] == n
    if source == "in place":
        assert c1["arena.inplace_blocks"] == c2["arena.inplace_blocks"] == n
        assert not {"arena.gather_bytes", "arena.gather_stored_bytes"} & (set(c1) | set(c2))
        assert all(r.src_rows is not None and r.comp is eng.arena.buffer
                   for r in records.values())
    else:
        assert "arena.inplace_blocks" not in c1 and "arena.inplace_blocks" not in c2
        assert c1["arena.gather_bytes"] == c2["arena.gather_bytes"] == n * eng.config.slot_size
        assert all(r.src_rows is None and r.comp is None for r in records.values())
    assert torch.equal(first, second)
    assert torch.equal(second, one_shot_planes(eng, unit))
    check_raw(second, unit, data)
    assert eng.decompress(unit).tobytes() == data       # the planned readback runs them too
    assert all(r.runs == 3 for r in records.values())
    eng.recycle(unit)
    eng.release()


def test_recycle_drops_the_records(monkeypatch):
    monkeypatch.setattr(device_mod, "_reads_in_place", lambda device: True)
    eng = engine()
    data = unit_data(6, 7)
    unit = eng.compress(data)
    planes = torch.cat(eng.decompress_device(unit))
    assert len(unit._flat_launches) == 2
    eng.recycle(unit)
    assert unit._flat_launches == {}
    with pytest.raises(StatusError, match="recycled"):
        eng.decompress_device(unit)
    assert unit._flat_launches == {}
    again = eng.compress(data)                          # the slots are another unit's now
    assert torch.equal(torch.cat(eng.decompress_device(again)), planes)
    eng.recycle(again)
    eng.release()


def test_prepare_device_decode_runs_one_record(monkeypatch, counters):
    # prepare_device_decode's launch is one record over the whole unit:
    # its second call counts every block as prepared, in place.
    monkeypatch.setattr(device_mod, "_reads_in_place", lambda device: True)
    eng = engine()
    data = unit_data(9, 8)
    unit = eng.compress(data)
    launch = eng.prepare_device_decode(unit)
    want = launch()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = launch()
    counted = profiling.snapshot(reset=True)
    assert counted["decode_flat.prepared_blocks"] == counted["decode_flat.blocks"] == unit.nblocks
    assert torch.equal(got, want)
    assert torch.equal(got, one_shot_planes(eng, unit))
    check_raw(got, unit, data)
    eng.recycle(unit)
    eng.release()


def wire(n: int = 6, out_rows: int = 256):
    """A random plan wire on the CPU and comp rows for it: (comp, plans)."""
    comp, plans = tflat.random_wire(71, n, out_rows, out_rows, 4)
    return torch.from_numpy(comp), tflat.plan_tensors(plans, "cpu")


BAD_PLANS = {
    "p_used int64": lambda p: p | {"p_used": p["p_used"].long()},
    "p_off short": lambda p: p | {"p_off": p["p_off"][:-1]},
    "p0 strided": lambda p: p | {"p0": p["p0"].repeat(2)[::2]},
    "dense on meta": lambda p: p | {"dense": p["dense"].to("meta")},
    "dq_idx int16": lambda p: p | {"dq_idx": p["dq_idx"].short()},
    "se int32": lambda p: p | {"se": p["se"].int()},
    "shift int16": lambda p: p | {"shift": p["shift"].short()},
    "se tiles": lambda p: p | {"se": p["se"][:, :1].contiguous()},
    "shift rows": lambda p: p | {"shift": p["shift"][:-4].contiguous()},
    "dq int32": lambda p: p | {"dq": p["dq"].int()},
    "dq height": lambda p: p | {"dq": p["dq"][:, :128].contiguous()},
    "row_a strided": lambda p: p | {"row_a": p["row_a"].transpose(2, 3)},
    "row_a rows": lambda p: p | {"row_a": torch.cat([p["row_a"], p["row_a"][:1]])},
    "row_a 3-D": lambda p: p | {"row_a": p["row_a"][0]},
}


@pytest.mark.parametrize("bad", sorted(BAD_PLANS) + ["comp int16", "comp_rows 100",
                                                     "src_rows int64", "device meta"])
def test_prepare_refuses_what_decode_blocks_flat_refuses(bad):
    # Each malformed plan tensor, row buffer, source table and device:
    # prepare_flat_launch raises the StatusError decode_blocks_flat raises.
    comp, plans = wire()
    kw = dict(comp_rows=256, out_rows=256)
    if bad in BAD_PLANS:
        plans = BAD_PLANS[bad](plans)
    elif bad == "comp int16":
        comp = comp.short()
    elif bad == "comp_rows 100":
        kw["comp_rows"] = 100
    elif bad == "src_rows int64":
        kw["src_rows"] = torch.arange(comp.shape[0])
    else:
        comp, plans = comp.to("meta"), {k: v.to("meta") for k, v in plans.items()}
    with pytest.raises(StatusError) as want:
        tflat.decode_blocks_flat(comp, plans, **kw)
    with pytest.raises(StatusError) as got:
        tflat.prepare_flat_launch(comp, plans, **kw)
    assert str(got.value) == str(want.value)
    assert got.value.status.code == want.value.status.code


def test_a_record_runs_on_rows_laid_out_as_its_own():
    # A record over plain rows keeps none: each run is given rows laid out
    # as those it was prepared on, and decodes them; rows of another layout
    # are refused.  A record over a source-row table keeps its buffer.
    comp, plans = wire()
    rec = tflat.prepare_flat_launch(comp, plans, comp_rows=256, out_rows=256)
    assert rec.comp is None
    other = torch.flip(comp, [0]).contiguous()
    assert torch.equal(rec.run(comp), tflat.decode_flat_reference(comp, plans, 256, 256))
    got = rec.run(other)
    assert torch.equal(got, tflat.decode_flat_reference(other, plans, 256, 256))
    assert torch.equal(got, tflat.decode_blocks_flat(other, plans, comp_rows=256, out_rows=256))
    assert rec.runs == 2
    for wrong in (comp[:-1], comp[:, :-1], torch.zeros_like(comp).t().contiguous().t()):
        with pytest.raises(StatusError, match="laid out"):
            rec.run(wrong)
    with pytest.raises(StatusError, match="plain rows"):
        rec.run()
    table = torch.tensor([5, 0, 3, 3, 1, 2], dtype=torch.int32)
    kept = tflat.prepare_flat_launch(comp, plans, comp_rows=256, out_rows=256, src_rows=table)
    assert kept.comp is comp
    want = tflat.decode_flat_reference(comp.index_select(0, table), plans, 256, 256)
    assert torch.equal(kept.run(), want) and torch.equal(kept.run(comp), want)


def test_runs_count_blocks_and_prepared_blocks(counters):
    comp, plans = wire()
    rec = tflat.prepare_flat_launch(comp, plans, comp_rows=256, out_rows=256)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rec.run(comp)
        assert profiling.snapshot() == {"decode_flat.blocks": 6}
        rec.run(comp)
        rec.run(comp)
        tflat.decode_blocks_flat(comp, plans, comp_rows=256, out_rows=256)
    assert profiling.snapshot() == {"decode_flat.blocks": 24, "decode_flat.prepared_blocks": 12}
    names = [e.name for e in prof.events() if e.name.startswith("bitar.")]
    assert names == ["bitar.ops.decode_flat"] * 4
    rec.run(comp)                                       # off: nothing counted
    assert profiling.snapshot() == {"decode_flat.blocks": 24, "decode_flat.prepared_blocks": 12}


def test_threads_run_the_kept_records_at_once(monkeypatch):
    # Sixteen threads decode one resident unit at once through the records
    # its first decode built, the interpreter switching threads every
    # microsecond: every decode is right, no record is built again, and
    # every run is counted once.
    monkeypatch.setattr(device_mod, "_reads_in_place", lambda device: True)
    eng = engine()
    data = unit_data(8, 9)
    unit = eng.compress(data)
    want = torch.cat(eng.decompress_device(unit))
    records = dict(unit._flat_launches)
    threads, calls = 16, 5
    results, errors = [], []

    def work():
        try:
            for _ in range(calls):
                results.append(torch.cat(eng.decompress_device(unit)))
        except Exception as e:                          # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers) and not errors
    assert len(results) == threads * calls and all(torch.equal(r, want) for r in results)
    assert unit._flat_launches == records
    assert all(r.runs == 1 + threads * calls for r in records.values())
    eng.recycle(unit)
    eng.release()
