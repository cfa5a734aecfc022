"""Tests of the port that need a CUDA device: every kernel (flat decode B1,
table decode B2 on parser, random well-formed and malformed tables, and
through source rows over a permuted buffer and table store,
static-offset match B3, B5 match walk, B4 match scoring, B6 parse walk on
B4's planes and ``walk_edge_batch``, B7 dense-plan decode on planner,
random and pass-class plans, the emitter on parser layouts and
``edge_layouts``) against
its plain PyTorch version on the card, and the engine's
paths there (host and device compress, tables, Zstd planned and Zstd 4 KiB
tables over the literal store, the tpu matchers, batched decode) and the
multi-device dry run's.

Blocks of 256 KiB to 1 MiB take B1's and B2's cluster routes (a plane
spread over a thread-block cluster's shared memory): both against their
plain versions (bench and text corpora, class-pure batches, random wires
and tables at heights of 1152 to 8192 rows, out passes that gather across
slices, a skewed burst, RLE tables), one B1 launch whose output passes 2^31
bytes, the engine at 1 MiB, the CLI's skewed suite in LZ4, Snappy and Zstd,
``configs_bench`` config 2 at 1 GiB, ``multihost_bench --launch 2`` and the
headline bench (``cli.bench``) at 64 blocks.  The held timer
(``timing.kernel_time_ms``) must read B1 within 10% of its CUDA-event time,
and raise, within the hold's timeout, on a call that synchronizes.

Four tests need several cards and count them inside themselves, skipping
below the count: an NCCL world of four ranks, one card each, runs every
step bit-exactly with each rank's B1 and B2 on its own card; the Driver's
engine on each card (two or more) round-trips there; the demo's async
suite runs over four engines.  One more runs on any card: an NCCL world
of more ranks than cards raises.

They skip without CUDA.  The machine with the card has no JAX, and
``tests/conftest.py`` imports JAX, so on the card run this file alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Inputs are made from a numpy seed with the port's own host library and
corpus functions; tolerance 0 (byte and integer equality).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import bitar_tpu_torch as btt
from bitar_tpu_torch.ops import decode_flat as tflat
from bitar_tpu_torch.ops._build import block_queue, block_queues
from bitar_tpu_torch.ops import decode_tables as tdt
from bitar_tpu_torch.ops import match as tmatch
from bitar_tpu_torch.ops import device_compress as tdc
from bitar_tpu_torch.ops import emit as temit
from bitar_tpu_torch.ops import match_dyn as tmd
from bitar_tpu_torch.ops import registry
from bitar_tpu_torch.ops.cpu import native
from bitar_tpu_torch.ops.match_sort import find_matches_sorted
from bitar_tpu_torch.utils.corpus import make_corpus, make_text_corpus

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _plan(datas, block, min_match):
    comps = [native.lz4_compress(d, min_match=min_match) for d in datas]
    lens = np.array([len(c) for c in comps], np.int32)
    off = np.zeros(len(comps), np.int64)
    off[1:] = np.cumsum(lens[:-1])
    nrows = block // 128
    se, sh, pu, p0, st, _, dq, ra, dn = native.plan_batch_flat(
        np.concatenate(comps), off, lens, np.full(len(comps), block, np.int32),
        np.zeros(len(comps), np.int32), nrows, 160, cb=4)
    assert (st == 0).all(), st
    plans = tflat.attach_dense_planes(
        tflat.flatten_batch_plans(se, sh, pu, p0, nrows), dq, ra, dn)
    rows = -(-int(lens.max()) // 128)
    rows = -(-rows // 128) * 128
    comp_rows = -(-rows // 256) * 256 if rows > 128 else rows
    return comps, plans, comp_rows


def text_batch(rng, block=32 * 1024):
    src = (ROOT / "SURVEY.md").read_bytes()
    datas = [src[o:o + block] for o in rng.integers(0, len(src) - block, 3)]
    comps, plans, comp_rows = _plan(datas, block, 4)
    assert (plans["p_used"] > plans["p0"]).any(), "expected out passes"
    return datas, comps, plans, comp_rows, block


def mixed_batch(rng, block=16 * 1024):
    datas = [(b"mixed batch %d " % i * (block // 14 + 1))[:block] for i in range(2)]
    datas += [rng.integers(0, 8, block, np.uint8).tobytes(), b"\x33" * block]
    comps, plans, comp_rows = _plan(datas, block, 6)
    return datas, comps, plans, comp_rows, block


def raw_batch(rng, block=16 * 1024):
    """[RAW, text, RAW] with a compacted one-row dense wire."""
    raw = rng.integers(0, 256, block, np.uint8).tobytes()
    txt = (b"identity dense wire " * (block // 19 + 1))[:block]
    comps, plans, _ = _plan([txt], block, 6)
    batch = dict(plans)
    batch.update(p_used=np.array([0, plans["p_used"][0], 0], np.int32),
                 p_off=np.zeros(3, np.int32),
                 p0=np.array([0, plans["p0"][0], 0], np.int32),
                 dense=np.array([-1, plans["dense"][0], -1], np.int32),
                 dq_idx=np.zeros(3, np.int32))
    raw_u8 = np.frombuffer(raw, np.uint8)
    return [raw, txt, raw], [raw_u8, comps[0], raw_u8], batch, block // 128, block


BATCHES = {"text": text_batch, "mixed": mixed_batch, "raw": raw_batch}


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_kernel_matches_plain_version(batch, cuda_device):
    datas, comps, plans, comp_rows, block = BATCHES[batch](np.random.default_rng(51))
    nrows = block // 128
    rows = np.zeros((len(comps), comp_rows * 128 + 256), np.uint8)
    for i, c in enumerate(comps):
        rows[i, :len(c)] = c
    rows = torch.from_numpy(rows).to(cuda_device)
    pt = tflat.plan_tensors(plans, cuda_device)
    before = tflat.launches
    got = tflat.decode_blocks_flat(rows, pt, comp_rows=comp_rows, out_rows=nrows)
    torch.cuda.synchronize()
    assert tflat.launches == before + 1
    assert torch.equal(got, tflat.decode_flat_reference(rows, pt, comp_rows, nrows))
    host = got.cpu().numpy().reshape(len(datas), -1)
    for i, d in enumerate(datas):
        assert host[i, :len(d)].tobytes() == d, f"block {i}"


def test_kernel_rejects_oversized_plane(cuda_device):
    # Planes above 1024 rows take the cluster route; the kernel's limit is a
    # cluster of 8 slices, 8192 rows (1 MiB blocks), past which the launch
    # is refused.
    rows = torch.zeros((1, 256), dtype=torch.uint8, device=cuda_device)
    tiles = 8192 // 128 + 1
    plans = tflat.plan_tensors({
        "p_used": np.zeros(1, np.int32), "p_off": np.zeros(1, np.int32),
        "p0": np.zeros(1, np.int32),
        "se": np.zeros((4, tiles, 128), np.int16),
        "shift": np.zeros((4, tiles, 128), np.int32)}, cuda_device)
    with pytest.raises(btt.StatusError, match="CUDA error"):
        tflat.decode_blocks_flat(rows, plans, comp_rows=128, out_rows=tiles * 128)


@pytest.mark.parametrize("commit", ["eager", "deferred"])
@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_engine_main_path_on_card(codec, commit, cuda_device):
    block = 32 * 1024
    rng = np.random.default_rng(52)
    data = b"".join(text_batch(rng, block)[0]) + rng.integers(
        0, 256, block, np.uint8).tobytes() + b"\x07" * 1000
    cfg = btt.EngineConfig(codec=btt.Codec(codec), block_size=block, burst_size=2,
                           max_pool_slots=32, commit=commit, min_match=4)
    with btt.Engine(cfg, device=cuda_device) as eng:
        unit = eng.compress(data)
        before = tflat.launches
        assert eng.decompress(unit).tobytes() == data
        assert tflat.launches == before + 3          # 5 blocks, bursts of 2
        assert unit.plan_flat["host_blocks"].size == 0
        planes = torch.cat(eng.decompress_device(unit))
        assert torch.equal(eng.prepare_device_decode(unit)(), planes)
        assert eng.recycle(unit) == unit.nblocks


def test_unit_over_plan_budget_decodes_through_b2_on_card(cuda_device):
    # Every markdown block exceeds an 8-pass budget: the unit decodes from
    # its sequence tables (B2), with no block on the host.
    block = 16 * 1024
    data = (ROOT / "SURVEY.md").read_bytes()[:3 * block]
    cfg = btt.EngineConfig(block_size=block, burst_size=2, max_pool_slots=32,
                           commit="deferred", plan_build="lazy")
    with btt.Engine(cfg, device=cuda_device) as eng:
        eng._PLAN_MAX_PASSES = 8
        unit = eng.compress(data)
        before = tdt.launches
        assert eng.decompress(unit).tobytes() == data
        assert unit.plan_flat is None and tdt.launches == before + 2
        assert eng.stats.host_decode_bursts == 0
        assert eng.recycle(unit) == unit.nblocks


def sixteen_table_units(rng, block: int = 4096, nunits: int = 16, nblocks: int = 48):
    """The data of ``nunits`` units of ``nblocks`` 4 KiB blocks each (markdown,
    random, RLE and low-entropy blocks), and an engine configuration that
    holds them all: units the planner leaves to the table path."""
    src = (ROOT / "SURVEY.md").read_bytes()
    datas = []
    for u in range(nunits):
        parts = [src[o:o + block] for o in rng.integers(0, len(src) - block, nblocks // 2)]
        parts += [rng.integers(0, 256, block, np.uint8).tobytes(), bytes([u]) * block]
        parts += [rng.integers(0, 8, block, np.uint8).tobytes()] * (nblocks // 2 - 2)
        datas.append(b"".join(parts))
    return datas, dict(block_size=block, burst_size=64, max_pool_slots=nunits * nblocks + 64,
                       commit="deferred", min_match=4)


def test_picks_of_sixteen_table_units_match_the_plain_version(cuda_device):
    # Block-granular decode across resident 4 KiB LZ4 units (the table path):
    # picks over 16 units in bursts of 64, duplicates included, decode in
    # ceil(k / 64) B2 launches on the card and equal the CPU engine's plain
    # version of the same picks and the raw blocks.
    block, nunits, nblocks = 4096, 16, 48
    rng = np.random.default_rng(61)
    datas, kw = sixteen_table_units(rng, block, nunits, nblocks)
    ui = rng.integers(0, nunits, 300)
    bi = rng.integers(0, nblocks, 300)
    bi[-40:] = bi[:40]
    ui[-40:] = ui[:40]
    got = {}
    for dev in (cuda_device, "cpu"):
        with btt.Engine(btt.EngineConfig(**kw), device=dev) as eng:
            units = [eng.compress(d) for d in datas]
            for unit in units:
                eng.ensure_plans(unit)
            assert all(unit.plan_flat is None for unit in units)
            before = tdt.launches
            got[str(dev)] = eng.decompress_blocks_device(units, ui, bi).cpu()
            if dev != "cpu":
                assert tdt.launches == before + 5           # 300 picks, bursts of 64
            for unit in units:
                eng.recycle(unit)
    assert torch.equal(got[str(cuda_device)], got["cpu"])
    flat = got["cpu"].reshape(len(ui), -1).numpy()
    for j, (u, b) in enumerate(zip(ui.tolist(), bi.tolist(), strict=True)):
        assert flat[j].tobytes() == datas[u][b * block:(b + 1) * block], (j, u, b)


def test_traced_picks_of_sixteen_table_units_read_in_place(cuda_device):
    # Traced, a MultiGet-like call over 16 resident table units reads every
    # pick's slot and table-store row in place: no gather span or counter,
    # arena.inplace_blocks and decode_tables.blocks both the picks, and the
    # planes the raw blocks.
    from bitar_tpu_torch.utils import profiling

    block, nunits, nblocks = 4096, 16, 48
    rng = np.random.default_rng(62)
    datas, kw = sixteen_table_units(rng, block, nunits, nblocks)
    ui, bi = rng.integers(0, nunits, 200), rng.integers(0, nblocks, 200)
    with btt.Engine(btt.EngineConfig(**kw), device=cuda_device) as eng:
        units = [eng.compress(d) for d in datas]
        eng.decompress_blocks_device(units, ui[:20], bi[:20])          # builds the store
        profiling.snapshot(reset=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            got = eng.decompress_blocks_device(units, ui, bi)
            torch.cuda.synchronize()
        counted = profiling.snapshot(reset=True)
        names = {e.key for e in prof.key_averages()}
        assert "bitar.ops.decode_tables" in names and "bitar.arena.gather_burst" not in names
        assert counted["arena.inplace_blocks"] == counted["decode_tables.blocks"] == len(ui)
        assert not {"arena.gather_bytes", "arena.gather_stored_bytes"} & set(counted)
        host = got.reshape(len(ui), -1).cpu().numpy()
        for j, (u, b) in enumerate(zip(ui.tolist(), bi.tolist(), strict=True)):
            assert host[j].tobytes() == datas[u][b * block:(b + 1) * block], (j, u, b)
        for unit in units:
            eng.recycle(unit)


def test_zstd_table_units_read_the_literal_store(cuda_device):
    # 4 KiB Zstd units take the table path over the engine's literal store:
    # picks over 16 units in bursts of 64 and whole-unit decodes equal the
    # CPU engine's plain version and the raw blocks (random blocks stored
    # RAW among them); traced, every pick decodes in place from the store
    # (arena.inplace_blocks counts the picks), and no gather runs.
    from bitar_tpu_torch.utils import profiling

    block, nunits, nblocks = 4096, 16, 48
    rng = np.random.default_rng(63)
    datas, kw = sixteen_table_units(rng, block, nunits, nblocks)
    ui, bi = rng.integers(0, nunits, 300), rng.integers(0, nblocks, 300)
    got, whole = {}, {}
    for dev in (cuda_device, "cpu"):
        with btt.Engine(btt.EngineConfig(codec=btt.Codec.ZSTD, **kw), device=dev) as eng:
            units = [eng.compress(d) for d in datas]
            for unit in units:
                eng.ensure_plans(unit)
            assert all(u.plan_flat is None and u.lit_planes is not None for u in units)
            before = tdt.launches
            got[str(dev)] = eng.decompress_blocks_device(units, ui, bi).cpu()
            if dev != "cpu":
                assert tdt.launches == before + 5           # 300 picks, bursts of 64
                profiling.snapshot(reset=True)
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    again = eng.decompress_blocks_device(units, ui, bi)
                    torch.cuda.synchronize()
                counted = profiling.snapshot(reset=True)
                names = {e.key for e in prof.key_averages()}
                assert {"bitar.engine.lit_picks", "bitar.ops.decode_tables"} <= names
                assert not {n for n in names if "gather" in n or "indexSelect" in n}, names
                assert (counted["arena.inplace_blocks"] == counted["decode_tables.lit_blocks"]
                        == counted["decode_tables.blocks"] == len(ui))
                assert not {"arena.gather_bytes", "arena.gather_stored_bytes"} & set(counted)
                assert torch.equal(again.cpu(), got[str(dev)])
            whole[str(dev)] = [torch.cat(eng.decompress_device(u)).cpu() for u in units[:3]]
            for u, d in zip(units[:3], datas, strict=False):
                out, status = eng.decompress_status(u)
                assert out.tobytes() == d and not status.any()
            assert eng.stats.host_decode_bursts == 0
            for unit in units:
                eng.recycle(unit)
    assert torch.equal(got[str(cuda_device)], got["cpu"])
    for a, b in zip(whole[str(cuda_device)], whole["cpu"], strict=True):
        assert torch.equal(a, b)
    flat = got["cpu"].reshape(len(ui), -1).numpy()
    for j, (u, b) in enumerate(zip(ui.tolist(), bi.tolist(), strict=True)):
        assert flat[j].tobytes() == datas[u][b * block:(b + 1) * block], (j, u, b)


def test_whole_lz4_table_units_read_in_place_on_card(cuda_device):
    # decompress_device of a 4 KiB LZ4 table unit launches as its picks do:
    # B2 through the unit's slots over the arena and the table store, read
    # in place; traced, nothing gathered; the bytes equal the CPU engine's.
    from bitar_tpu_torch.utils import profiling

    rng = np.random.default_rng(64)
    datas, kw = sixteen_table_units(rng, nunits=3)
    whole = {}
    for dev in (cuda_device, "cpu"):
        with btt.Engine(btt.EngineConfig(codec=btt.Codec.LZ4, **kw), device=dev) as eng:
            units = [eng.compress(d) for d in datas]
            for unit in units:
                eng.ensure_plans(unit)
            assert all(u.plan_flat is None and u.tables is not None for u in units)
            profiling.snapshot(reset=True)
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts):
                whole[str(dev)] = [torch.cat(eng.decompress_device(u)).cpu() for u in units]
            counted = profiling.snapshot(reset=True)
            n = sum(u.nblocks for u in units)
            assert counted["decode_tables.blocks"] == n
            if dev != "cpu":
                assert counted["arena.inplace_blocks"] == n
                assert not {"arena.gather_bytes", "arena.gather_stored_bytes"} & set(counted)
            for u, d in zip(units, datas, strict=True):
                out, status = eng.decompress_status(u)
                assert out.tobytes() == d and not status.any()
                eng.recycle(u)
    for a, b in zip(whole[str(cuda_device)], whole["cpu"], strict=True):
        assert torch.equal(a, b)


def lz4_tables(datas, min_match=4):
    """Rows, nseq and padded tables of the LZ4 blocks of ``datas``."""
    comps = [native.lz4_compress(d, min_match=min_match) for d in datas]
    tables, nseq = tdt.pad_tables([native.parse_sequences(c) for c in comps],
                                  native.SEQUENCE_KEYS)
    w = 2 * max(len(d) for d in datas)
    rows = np.zeros((len(comps), w), np.uint8)
    for i, c in enumerate(comps):
        rows[i, :len(c)] = c
    return rows, tables, nseq


def rle_table_batch(block=1024):
    """Offsets 1..130 across the 128-byte row: d literals, one match of
    offset d, 5 final literals."""
    rng = np.random.default_rng(55)
    n = 130
    rows = rng.integers(0, 256, (n, 256), np.uint8)
    tables = {k: np.zeros((n, 128), np.int32) for k in native.SEQUENCE_KEYS}
    for i in range(n):
        d = i + 1
        tables["lit_len"][i, :2] = [d, 5]
        tables["off"][i, 0] = d
        tables["mlen"][i, 0] = block - d - 5
        tables["lit_ptr"][i, 1] = d
        tables["out_pos"][i, 1] = block - 5
    return rows, tables, np.full(n, 2, np.int32), block


def malformed_table_batch(block=4096):
    """Random tables: offsets 0 and past the plane start, positions before
    and past the plane, literals past the row, nseq past the table."""
    rng = np.random.default_rng(56)
    n, S = 16, 128
    rows = rng.integers(0, 256, (n, 512), np.uint8)
    tables = {"lit_ptr": rng.integers(-600, 800, (n, S)),
              "lit_len": rng.integers(-5, 700, (n, S)),
              "off": rng.integers(-2, 5000, (n, S)),
              "mlen": rng.integers(-5, 3000, (n, S)),
              "out_pos": rng.integers(-800, block + 800, (n, S))}
    tables = {k: v.astype(np.int32) for k, v in tables.items()}
    return rows, tables, rng.integers(-3, 200, n).astype(np.int32), block


def corpus_table_batch(block=4096):
    data = make_corpus(1)[:32 * block]
    return (*lz4_tables([data[i * block:(i + 1) * block] for i in range(32)]), block)


def deep_table_batch(block=128 * 1024):
    text = make_text_corpus(2)
    rows, tables, nseq = lz4_tables([text[:block], text[block:]])
    assert int(nseq.max()) > 2000
    return rows, tables, nseq, block


def ycsb_table_batch(block=4096):
    """RocksDB data blocks of YCSB records (the MultiGet cell's generator,
    ``benchmark/reference/kv.py``), parsed as the engine stores them."""
    from benchmark.reference import kv

    t = kv.make({"generator": "rocksdb_ycsb", "units": 2, "unit_blocks": 96}, 2**31 + 7, block)
    ends = np.concatenate([[0], np.cumsum(t.sizes)])
    datas = [t.raw[ends[i]:ends[i + 1]].tobytes() for i in range(t.sizes.size)]
    return (*tdt.parser_tables(datas, min_match=4)[:3], block)


def single_literal_batch(block=4096):
    """One literal run and no match a block (RAW blocks): aligned and
    unaligned lit_ptr, runs past the row and past the plane, a negative
    lit_ptr, an empty run."""
    rng = np.random.default_rng(58)
    n = 8
    rows = rng.integers(0, 256, (n, 3 * block), np.uint8)
    tables = {k: np.zeros((n, 128), np.int32) for k in native.SEQUENCE_KEYS}
    tables["lit_ptr"][:, 0] = [0, 3, 16, 3 * block - 100, -5, 0, 17, 2 * block]
    tables["lit_len"][:, 0] = [block, block, block - 9, block, 300, 0, 2 * block, block]
    return rows, tables, np.ones(n, np.int32), block


def cluster_text_batch(block=256 * 1024):
    text = make_text_corpus(12)
    return (*tdt.parser_tables([text[i * block:(i + 1) * block] for i in range(6)])[:3], block)


SOURCE_BATCHES = {
    "ycsb 4k": ycsb_table_batch,
    "ycsb 4k, rows past the buffer": ycsb_table_batch,
    "random well-formed": lambda: (*tdt.random_tables(71, 24, 640, 4096), 4096),
    "random malformed": lambda: (*tdt.random_tables(72, 24, 640, 4096, well_formed=False),
                                 4096),
    "single literal": single_literal_batch,
    "cluster 256 KiB text": cluster_text_batch,
}


@pytest.mark.parametrize("batch", sorted(SOURCE_BATCHES))
def test_decode_tables_through_source_rows_equals_gathered(batch, cuda_device):
    # B2 through a table of source rows, over a permuted buffer and table
    # store twice as tall, against B2 on the same rows and tables gathered
    # first, byte for byte and path for path: YCSB blocks (the MultiGet's),
    # random well-formed and malformed tables, single-literal blocks, and
    # the cluster route.  Entries past the buffer read the nearest row (the
    # plain version raises there).  Unclipped, both equal B2 on the blocks
    # where they were made.
    rows, tables, nseq, block = SOURCE_BATCHES[batch]()
    buf, ns, store, src = tdt.resident_layout(rows, tables, nseq, 74)
    N = buf.shape[0]
    buf, ns, store, src = (torch.from_numpy(a).to(cuda_device) for a in (buf, ns, store, src))
    views = dict(zip(native.SEQUENCE_KEYS, store.unbind(0), strict=True))
    clipped = batch.endswith("past the buffer")
    if clipped:
        src[:4] = torch.tensor([-1, -2**31, N, 2**31 - 1], dtype=torch.int32)
    at = src.clamp(0, N - 1)
    paths = torch.zeros((2, 2), dtype=torch.int32, device=cuda_device)
    out_rows = block // 128
    before = (tdt.launches, tdt.cluster_launches)
    got = tdt.decode_blocks(buf, ns, views, out_rows=out_rows, src_rows=src, path_counts=paths[0])
    want = tdt.decode_blocks(buf.index_select(0, at), ns.index_select(0, at),
                             {k: v.index_select(0, at) for k, v in views.items()},
                             out_rows=out_rows, path_counts=paths[1])
    torch.cuda.synchronize()
    tall = int(tdt.cluster_ctas(out_rows) > 1)
    assert (tdt.launches, tdt.cluster_launches) == (before[0] + 2, before[1] + 2 * tall)
    assert tall == (batch == "cluster 256 KiB text")
    assert torch.equal(got, want)
    assert paths[0].tolist() == paths[1].tolist()
    if not clipped:
        tn, tt = tdt.table_tensors(tables, nseq, cuda_device)
        made = tdt.decode_blocks(torch.from_numpy(rows).to(cuda_device), tn, tt,
                                 out_rows=out_rows)
        assert torch.equal(got, made)


TABLE_BATCHES = {"corpus 4k": corpus_table_batch, "rle": rle_table_batch,
                 "malformed": malformed_table_batch, "deep 128k": deep_table_batch}


@pytest.mark.parametrize("batch", sorted(TABLE_BATCHES))
def test_decode_tables_kernel_matches_plain(batch, cuda_device):
    rows, tables, nseq, block = TABLE_BATCHES[batch]()
    rows = torch.from_numpy(rows).to(cuda_device)
    tn, tt = tdt.table_tensors(tables, nseq, cuda_device)
    before = tdt.launches
    got = tdt.decode_blocks(rows, tn, tt, out_rows=block // 128)
    torch.cuda.synchronize()
    assert tdt.launches == before + 1
    assert torch.equal(got, tdt.decode_tables_reference(rows, tn, tt, block // 128))


@pytest.mark.parametrize("kind", ["well-formed", "malformed", "mixed"])
@pytest.mark.parametrize("S,block", [(640, 4096), (6, 4096), (2048, 128 * 1024), (48, 128 * 1024)])
def test_decode_tables_kernel_on_random_tables(S, block, kind, cuda_device):
    # Well-formed tables take the parallel paths (chains longer than a
    # window, offsets 1-130 across window edges, extents past the plane),
    # malformed ones the serial walk, both kinds in one launch for "mixed";
    # the kernel's per-path counts are the classifier's.
    n = 16
    good = tdt.random_tables(S + block, n, S, block)
    bad = tdt.random_tables(S + block + 1, n, S, block, well_formed=False)
    if kind == "mixed":
        keep = np.arange(n) % 3 == 0
        rows = np.where(keep[:, None], good[0], bad[0])
        tables = {k: np.where(keep[:, None], good[1][k], bad[1][k]) for k in good[1]}
        nseq = np.where(keep, good[2], bad[2])
    else:
        rows, tables, nseq = good if kind == "well-formed" else bad
    rows = torch.from_numpy(rows).to(cuda_device)
    tn, tt = tdt.table_tensors(tables, nseq, cuda_device)
    paths = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    got = tdt.decode_blocks(rows, tn, tt, out_rows=block // 128, path_counts=paths)
    torch.cuda.synchronize()
    assert torch.equal(got, tdt.decode_tables_reference(rows, tn, tt, block // 128))
    wf = int(tdt.well_formed(tn, tt).sum())
    assert paths.tolist() == [wf, n - wf]
    assert wf == {"well-formed": n, "malformed": 0, "mixed": int(keep.sum())
                  if kind == "mixed" else None}[kind]


def test_decode_tables_kernel_on_single_literal_blocks(cuda_device):
    # One literal run and no match (a RAW block) is copied straight to
    # device memory: aligned and unaligned lit_ptr, runs past the row and
    # past the plane, a negative lit_ptr, an empty run.
    rng = np.random.default_rng(58)
    block, n = 4096, 8
    rows = rng.integers(0, 256, (n, 3 * block), np.uint8)
    tables = {k: np.zeros((n, 128), np.int32) for k in native.SEQUENCE_KEYS}
    tables["lit_ptr"][:, 0] = [0, 3, 16, 3 * block - 100, -5, 0, 17, 2 * block]
    tables["lit_len"][:, 0] = [block, block, block - 9, block, 300, 0, 2 * block, block]
    # The second batch's odd row stride breaks 16-byte alignment.
    for r in (rows, np.ascontiguousarray(rows[:, :3 * block - 1])):
        r = torch.from_numpy(r).to(cuda_device)
        tn, tt = tdt.table_tensors(tables, np.ones(n, np.int32), cuda_device)
        got = tdt.decode_blocks(r, tn, tt, out_rows=block // 128)
        torch.cuda.synchronize()
        assert torch.equal(got, tdt.decode_tables_reference(r, tn, tt, block // 128))


def test_decode_tables_kernel_decodes_parser_tables_in_parallel(cuda_device):
    datas = [make_text_corpus(1)[:128 * 1024], make_corpus(1)[:64 * 1024]]
    blocks = [datas[0]] + [datas[1][i * 4096:(i + 1) * 4096] for i in range(16)]
    for group, block in ((blocks[:1], 128 * 1024), (blocks[1:], 4096)):
        rows, tables, nseq, _ = tdt.parser_tables(group)
        tn, tt = tdt.table_tensors(tables, nseq, cuda_device)
        paths = torch.zeros(2, dtype=torch.int32, device=cuda_device)
        got = tdt.decode_blocks(torch.from_numpy(rows).to(cuda_device), tn, tt,
                                out_rows=block // 128, path_counts=paths)
        assert paths.tolist() == [len(group), 0]
        assert [g.tobytes() for g in got.reshape(len(group), -1).cpu().numpy()] == group


TIES = (24, 12, 48, 12, 3, 6, 0, 17000)


@pytest.mark.parametrize("offsets,emit_values,max_match", [
    (tmatch.DEFAULT_OFFSETS, False, 64), (tmatch.DEFAULT_OFFSETS, True, 1024),
    (TIES, False, 100), (TIES, True, 256)])
def test_match_kernel_matches_plain(offsets, emit_values, max_match, cuda_device):
    planes, _ = corpus_planes(cuda_device, 128 * 1024)
    n = planes.shape[0]
    kw = dict(offsets=offsets, nrows=1024, max_match=max_match, emit_values=emit_values)
    before = tmatch.launches
    mlen, idx = tmatch.find_matches(planes.view(n, -1, 128), **kw)
    torch.cuda.synchronize()
    assert tmatch.launches == before + 1
    want = tmatch.match_reference(planes, offsets, max_match=max_match,
                                  emit_values=emit_values)
    assert torch.equal(mlen.view(n, -1), want[0])
    assert torch.equal(idx.view(n, -1), want[1])


def edge_offsets(L: int) -> tuple[int, ...]:
    """41 offsets (K > 32): short ones, offsets at and just past a tile's
    start, a duplicate, the plane length and past it, 0 last."""
    t = tmatch.TILE
    return (*range(1, 25), 47, 94, 1000, 4096, t - 1, t, t + 1, 2 * t, L - 1, L, L + 5,
            100, 12, 3, 30000, 2 * t + 1, 0)


@pytest.mark.parametrize("emit_values", [False, True])
@pytest.mark.parametrize("max_match", [1, 64, 100, 1024])
@pytest.mark.parametrize("block", [4 * 1024, 16 * 1024, 48 * 1024, 128 * 1024])
def test_match_kernel_edges(block, max_match, emit_values, cuda_device):
    planes, _ = corpus_planes(cuda_device, 128 * 1024)
    # Periodic rows make offsets at a tile's start match across the tile edge.
    planes[4] = planes[4, :8193].repeat(17)[:128 * 1024]
    planes = planes[:, :block].contiguous()
    n = planes.shape[0]
    offsets = edge_offsets(block)
    kw = dict(offsets=offsets, nrows=block // 128, max_match=max_match,
              emit_values=emit_values)
    mlen, idx = tmatch.find_matches(planes.view(n, -1, 128), **kw)
    torch.cuda.synchronize()
    want = tmatch.match_reference(planes, offsets, max_match=max_match,
                                  emit_values=emit_values)
    assert torch.equal(mlen.view(n, -1), want[0])
    assert torch.equal(idx.view(n, -1), want[1])


@pytest.mark.parametrize("emit_values", [False, True])
@pytest.mark.parametrize("block,far", [(128 * 1024, 70000), (256 * 1024, 65535),
                                       (256 * 1024, 70000), (256 * 1024, 240000),
                                       (1 << 20, 65535), (1 << 20, 70000), (1 << 20, 300000)])
def test_match_kernel_far_offset_windows(block, far, emit_values, cuda_device):
    # An offset past ~56 KiB makes every tile's window pass 64 KiB; past
    # ~220 KiB past what shared memory holds, and every tile reads the plane
    # from device memory (window 0).  A block of period `far` matches there.
    planes, _ = corpus_planes(cuda_device, block)
    planes[2] = planes[2, :far].repeat(block // far + 1)[:block]
    offsets = (3, far, 1, 64)
    tp = tmatch.tile_plan(block, offsets, 64)
    assert tp["tile"] == tmatch.TILE and (tp["window"] == 0) == (far + 8192 + 64 > 232448)
    n = planes.shape[0]
    kw = dict(offsets=offsets, nrows=block // 128, max_match=64, emit_values=emit_values)
    mlen, idx = tmatch.find_matches(planes.view(n, -1, 128), **kw)
    torch.cuda.synchronize()
    want = tmatch.match_reference(planes, offsets, max_match=64, emit_values=emit_values)
    assert torch.equal(mlen.view(n, -1), want[0])
    assert torch.equal(idx.view(n, -1), want[1])
    assert (want[0][2, far:] == 64).float().mean() > 0.9


def engine_batch(device, block: int, n: int):
    """n blocks of the bench corpus compressed (LZ4) and planned by an engine:
    (data, comp rows, plan tensors, comp_rows)."""
    data = make_corpus(-(-n * block // (128 * 1024)))[:n * block]
    cfg = btt.EngineConfig(codec=btt.Codec.LZ4, block_size=block, burst_size=n,
                           max_pool_slots=n + 32, commit="deferred")
    with btt.Engine(cfg, device=device) as eng:
        unit = eng.compress(data)
        eng.ensure_plans(unit)
        assert unit.plan_flat is not None and unit.plan_flat["host_blocks"].size == 0
        rows = eng.arena.gather_burst([r.slot for r in unit.refs])
        return data, rows, unit.plan_device_arrays(), unit.plan_comp_rows


@pytest.mark.parametrize("block,n", [(16 * 1024, 5), (16 * 1024, 300), (128 * 1024, 133),
                                     (128 * 1024, 40)])
def test_decode_flat_kernel_by_block_class(block, n, cuda_device):
    data, rows, pt, comp_rows = engine_batch(cuda_device, block, n)
    nrows = block // 128
    classes = tflat.block_classes(pt)
    assert sum(int(i.numel()) for i in classes.values()) == n
    for cls, idx in {"all": torch.arange(n, device=cuda_device), **classes}.items():
        if not idx.numel():
            continue
        r, p = tflat.select_blocks(rows, pt, idx)
        got = tflat.decode_blocks_flat(r, p, comp_rows=comp_rows, out_rows=nrows)
        torch.cuda.synchronize()
        assert torch.equal(got, tflat.decode_flat_reference(r, p, comp_rows, nrows)), cls
        host = got.reshape(idx.numel(), -1).cpu().numpy()
        for j, b in enumerate(idx.tolist()):
            assert host[j].tobytes() == data[b * block:(b + 1) * block], (cls, b)


@pytest.mark.parametrize("cut", [0, 8, 4 * 1024 + 3])
def test_decode_flat_kernel_on_odd_comp_rows(cut, cuda_device):
    # comp_width not a multiple of 16 and an odd row stride: RAW copies and
    # comp gathers take their unaligned paths; bytes past the width read 0.
    _, rows, pt, comp_rows = engine_batch(cuda_device, 16 * 1024, 24)
    assert (pt["dense"] < 0).any() and (pt["dense"] >= 0).any()
    width = rows.shape[1] - cut - 1
    stride = width + (2 if width % 2 else 1)
    buf = torch.zeros((rows.shape[0], stride), dtype=torch.uint8, device=cuda_device)
    buf[:, :width] = rows[:, :width]
    comp = buf[:, :width]
    assert comp.stride(0) % 2 == 1 and width % 16
    got = tflat.decode_blocks_flat(comp, pt, comp_rows=comp_rows, out_rows=128)
    torch.cuda.synchronize()
    assert torch.equal(got, tflat.decode_flat_reference(comp, pt, comp_rows, 128))


def test_decode_flat_kernel_queue_per_stream(cuda_device):
    # The block queue is reset by each launch's last CTA and kept per
    # stream: launches in turn on one stream, and on two streams at once,
    # all decode every block.
    _, rows, pt, comp_rows = engine_batch(cuda_device, 16 * 1024, 300)
    want = tflat.decode_flat_reference(rows, pt, comp_rows, 128)
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    outs = []
    for _ in range(3):
        for s in streams:
            s.wait_stream(torch.cuda.current_stream(cuda_device))
            with torch.cuda.stream(s):
                outs.append(tflat.decode_blocks_flat(rows, pt, comp_rows=comp_rows,
                                                     out_rows=128))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)
    assert all(int(q.abs().sum()) == 0 for q in block_queues.values())


def test_decode_flat_kernel_all_raw(cuda_device):
    rng = np.random.default_rng(57)
    n, block = 150, 128 * 1024
    rows = torch.from_numpy(rng.integers(0, 256, (n, block + 16), np.uint8)).to(cuda_device)
    z = np.zeros(n, np.int32)
    pt = tflat.plan_tensors({"p_used": z, "p_off": z, "p0": z, "dense": z - 1,
                             "dq": np.zeros((1, 1024, 128), np.int16),
                             "row_a": np.zeros((1, 1, 128, 8), np.int32),
                             "se": np.zeros((4, 8, 128), np.int16),
                             "shift": np.zeros((4, 8, 128), np.int32)}, cuda_device)
    got = tflat.decode_blocks_flat(rows, pt, comp_rows=1024, out_rows=1024)
    torch.cuda.synchronize()
    assert torch.equal(got.view(n, -1), rows[:, :block])


@pytest.mark.parametrize("out_rows,dcap,n,unaligned", [
    (128, 4, 150, False), (1024, 64, 140, False), (1024, 8, 7, False), (1024, 64, 20, True)])
def test_decode_flat_kernel_on_random_wires(out_rows, dcap, n, unaligned, cuda_device):
    # Every pass id, anchors off the plane and near the int32 limits, more
    # than 32 dense passes (a second anchor per lane), random pass ranges;
    # dq and row_a one element off 8- and 16-byte alignment (the wrapper
    # copies dq; anchors are then loaded one at a time).
    comp, plans = tflat.random_wire(58, n, out_rows, 256, dcap)
    rows = torch.from_numpy(comp).to(cuda_device)
    pt = tflat.plan_tensors(plans, cuda_device)
    if unaligned:
        for k in ("dq", "row_a"):
            buf = torch.empty(pt[k].numel() + 1, dtype=pt[k].dtype, device=cuda_device)
            buf[1:] = pt[k].flatten()
            pt[k] = buf[1:].view(pt[k].shape)
        assert pt["dq"].data_ptr() % 8 and pt["row_a"].data_ptr() % 16
    got = tflat.decode_blocks_flat(rows, pt, comp_rows=256, out_rows=out_rows)
    torch.cuda.synchronize()
    assert torch.equal(got, tflat.decode_flat_reference(rows, pt, 256, out_rows))


def test_sort_matcher_on_card(cuda_device):
    planes, _ = corpus_planes(cuda_device, 128 * 1024)
    got = find_matches_sorted(planes, length=128 * 1024)
    assert torch.equal(got.cpu(), find_matches_sorted(planes.cpu(), length=128 * 1024))


@pytest.mark.parametrize("kw", [dict(block_size=4096), dict(codec=btt.Codec.ZSTD),
                                dict(compress_matcher="tpu"),
                                dict(compress_matcher="tpu-sort", codec=btt.Codec.SNAPPY),
                                dict(compress_matcher="device", match_offsets=(1, 47, 64))])
def test_engine_paths_on_card(kw, cuda_device):
    data = make_corpus(2)[:2 * 128 * 1024 - 3000]
    base = dict(block_size=16 * 1024, burst_size=4, max_pool_slots=64, min_match=4)
    base.update(kw)
    with btt.Engine(btt.EngineConfig(**base), device=cuda_device) as eng:
        unit = eng.compress(data)
        assert eng.decompress(unit).tobytes() == data
        assert eng.stats.host_decode_bursts == 0
        assert eng.recycle(unit) == unit.nblocks


def test_batched_decode_on_card(cuda_device):
    items, datas = [], []
    for codec in ("lz4", "zstd", "snappy"):
        cfg = btt.EngineConfig(codec=btt.Codec(codec), block_size=16 * 1024, burst_size=16,
                               max_pool_slots=64)
        eng = btt.Engine(cfg, device=cuda_device).initialize()
        d = make_corpus(1)[:5 * 16 * 1024]
        items.append((eng, eng.compress(d)))
        datas.append(d)
    before = tflat.launches
    launch, slices = btt.prepare_batched_decode(items)
    out = launch().cpu().numpy()
    assert tflat.launches == before + 1
    for (lo, hi), d in zip(slices, datas, strict=True):
        assert out[lo:hi].reshape(-1).tobytes() == d
    for eng, unit in items:
        eng.recycle(unit)
        eng.release()


def test_arena_on_card(cuda_device):
    rng = np.random.default_rng(53)
    arena = btt.DeviceArena(slot_size=256, preallocated=20, max_slots=32, device=cuda_device)
    rows = rng.integers(0, 256, (4, 200), dtype=np.uint8)
    slots = arena.pool.take(4)
    arena.write_burst(slots, rows)
    got = arena.gather_burst(slots)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got[:, :200].cpu().numpy(), rows)
    assert not got[:, 200:].any()


def assert_rows_decode(codec: str, out, sizes, planes, lengths) -> int:
    """Every row that compresses (size < length, size <= width) decodes to
    its block through the host codec; returns how many there are."""
    out, sizes = out.cpu().numpy(), sizes.cpu().numpy()
    raw, lens = planes.cpu().numpy(), lengths.cpu().numpy()
    w, cap = out.shape[1], raw.shape[1]
    good = np.flatnonzero((sizes < lens) & (sizes <= w))
    dst = np.zeros(good.size * cap, np.uint8)
    dl, st = registry.host_decompress_batch(
        btt.Codec(codec), np.ascontiguousarray(out[good]).reshape(-1),
        np.arange(good.size, dtype=np.int64) * w, sizes[good].astype(np.int32), dst,
        np.arange(good.size, dtype=np.int64) * cap, lens[good].astype(np.int32))
    assert (st == 0).all() and (dl == lens[good]).all()
    for i, b in enumerate(good):
        assert dst[i * cap:i * cap + lens[b]].tobytes() == raw[b, :lens[b]].tobytes(), b
    return good.size


def corpus_planes(device, block=128 * 1024, n=8):
    """[n, block] planes of the bench corpus with two tail blocks, and lengths."""
    planes = np.frombuffer(make_corpus(n * max(1, block // (128 * 1024))), np.uint8)
    planes = planes.reshape(n, -1)[:, :block].copy()
    lengths = np.full(n, block, np.int32)
    lengths[[3, 6]] = [block - 1000, block - 37]
    for b, ln in enumerate(lengths):
        planes[b, ln:] = 0
    return (torch.from_numpy(planes).to(device),
            torch.from_numpy(lengths).to(device))


@pytest.mark.parametrize("block,seg,wcap", [(128 * 1024, 1024, 8), (48 * 1024, 1024, 8),
                                            (64 * 1024, 2048, 2)])
def test_match_walk_kernel_matches_plain(block, seg, wcap, cuda_device):
    planes, lengths = corpus_planes(cuda_device, block)
    n = planes.shape[0]
    offs, _ = tmd.detect_offsets(planes, k=4, max_off=min(0xFFFF, block - 128))
    offs = offs.contiguous()
    noff = (offs > 0).sum(dim=1).int()
    before = tmd.walk_launches
    got = tmd.find_matches_parse_dyn(planes.view(n, -1, 128), noff, offs, lengths,
                                     nrows=block // 128, seg=seg, min_match=6, wcap=wcap)
    torch.cuda.synchronize()
    assert tmd.walk_launches == before + 1
    rec = tmd.match_walk_reference(planes, noff, offs, lengths, seg=seg, min_match=6,
                                   wcap=wcap, max_match=1024)
    for i, g in enumerate(got[:3]):
        want = rec[:, i * wcap:(i + 1) * wcap].transpose(1, 2).reshape(n, -1)
        assert torch.equal(g, want), "PMO"[i]
    assert torch.equal(got[3], (rec[:, 3 * wcap] != 0).any(dim=1))


def hand_offsets_batch(device, L=32 * 1024):
    """Blocks with hand-set offsets where the choice between offsets
    matters: equal runs of several offsets, duplicates, a 0 inside the first
    noff, noff = 0, runs that reach the plane end; two tail lengths."""
    rng = np.random.default_rng(54)
    tail = rng.integers(0, 256, L, np.uint8)
    tail[L - 700:] = 0x41
    planes = np.stack([
        np.frombuffer((b"The quick brown fox jumps over the lazy dog 7. "
                       * (L // 47 + 1))[:L], np.uint8),
        np.full(L, 7, np.uint8),
        rng.integers(0, 256, L, np.uint8),
        rng.integers(0, 4, L, np.uint8),
        np.tile(rng.integers(32, 127, 1338, np.uint8), L // 1338 + 1)[:L],
        tail])
    offs = np.array([[94, 47, 141, 0], [1, 2, 3, 0], [5, 9, 0, 0], [3, 3, 2, 1],
                     [2676, 1338, 669, 0], [1, 0, 300, 0]], np.int32)
    noff = np.array([3, 3, 0, 4, 3, 3], np.int32)
    lengths = np.array([L, L, L, L - 1000, L - 37, L], np.int32)
    for b, ln in enumerate(lengths):
        planes[b, ln:] = 0
    return tuple(torch.from_numpy(a).to(device) for a in (planes, noff, offs, lengths))


def text_fft_batch(device):
    """4 x 128 KiB of the text corpus with the offsets of detect_fft=True,
    fft_k=6 (up to 10 per block)."""
    planes = torch.from_numpy(np.frombuffer(make_text_corpus(4), np.uint8)
                              .reshape(4, -1).copy()).to(device)
    noff, offs = tdc.candidate_offsets(planes, detect_fft=True, fft_k=6)
    assert (noff >= 2).all(), "the text blocks must carry several offsets"
    lengths = torch.full((4,), planes.shape[1], dtype=torch.int32, device=device)
    return planes, noff, offs, lengths


MULTI_OFFSET = {"hand": hand_offsets_batch, "text_fft": text_fft_batch}


@pytest.mark.parametrize("batch", sorted(MULTI_OFFSET))
def test_match_walk_kernel_chooses_among_offsets(batch, cuda_device):
    planes, noff, offs, lengths = MULTI_OFFSET[batch](cuda_device)
    n, L = planes.shape
    got = tmd.find_matches_parse_dyn(planes.view(n, -1, 128), noff, offs, lengths,
                                     nrows=L // 128, seg=1024, min_match=6)
    rec = tmd.match_walk_reference(planes, noff, offs, lengths, seg=1024, min_match=6,
                                   wcap=8, max_match=1024)
    for i, g in enumerate(got[:3]):
        want = rec[:, i * 8:(i + 1) * 8].transpose(1, 2).reshape(n, -1)
        assert torch.equal(g, want), "PMO"[i]
    assert torch.equal(got[3], (rec[:, 24] != 0).any(dim=1))


@pytest.mark.parametrize("batch", sorted(MULTI_OFFSET))
def test_match_dyn_kernel_chooses_among_offsets(batch, cuda_device):
    planes, noff, offs, _ = MULTI_OFFSET[batch](cuda_device)
    n, L = planes.shape
    mlen, moff = tmd.find_matches_dyn(planes.view(n, -1, 128), noff, offs,
                                      nrows=L // 128, max_match=256)
    want = tmd.match_dyn_reference(planes, noff, offs, max_match=256)
    assert torch.equal(mlen.view(n, -1), want[0])
    assert torch.equal(moff.view(n, -1), want[1])
    assert ((want[1] > 0) & (want[1] != offs[:, :1])).any(), "a later offset must win"


def short_rle_planes(device, block=128 * 1024, n=8):
    """Short RLE blocks (1-8 KiB, zero after) that fit a 128-byte row."""
    lengths = (1024 * (1 + np.arange(n) % 8)).astype(np.int32)
    planes = np.zeros((n, block), np.uint8)
    for b, ln in enumerate(lengths):
        planes[b, :ln] = 1 + b
    return torch.from_numpy(planes).to(device), torch.from_numpy(lengths).to(device)


@pytest.mark.parametrize("max_match", [256, 2047])
def test_match_dyn_kernel_matches_plain(max_match, cuda_device):
    planes, _ = corpus_planes(cuda_device, 64 * 1024)
    n = planes.shape[0]
    offs, _ = tmd.detect_offsets(planes, k=4, max_off=64 * 1024 - 128)
    offs = offs.contiguous()
    noff = (offs > 0).sum(dim=1).int()
    before = tmd.dyn_launches
    mlen, moff = tmd.find_matches_dyn(planes.view(n, -1, 128), noff, offs,
                                      nrows=512, max_match=max_match)
    torch.cuda.synchronize()
    assert tmd.dyn_launches == before + 1
    want = tmd.match_dyn_reference(planes, noff, offs, max_match=max_match)
    assert torch.equal(mlen.view(n, -1), want[0])
    assert torch.equal(moff.view(n, -1), want[1])


def edge_tensors(device, block, n=37, seed=0):
    """``match_dyn.edge_batch`` on the card (n below 132 and no multiple of
    it), with the ``noff`` of two blocks out of range (clamped to [0, K])."""
    planes, noff, offs, lengths = tmd.edge_batch(block, n, seed=seed)
    noff[7], noff[8] = offs.shape[1] + 3, -1
    return tuple(torch.from_numpy(a).to(device) for a in (planes, noff, offs, lengths))


def walk_equals_plain(planes, noff, offs, lengths, seg, max_match, wcap=8):
    n, L = planes.shape
    got = tmd.find_matches_parse_dyn(planes.view(n, -1, 128), noff, offs, lengths,
                                     nrows=L // 128, seg=seg, min_match=6, wcap=wcap,
                                     max_match=max_match)
    rec = tmd.match_walk_reference(planes, noff, offs, lengths, seg=seg, min_match=6,
                                   wcap=wcap, max_match=max_match)
    want = tmd._split_records(rec, wcap)
    for name, g, w in zip(("P", "M", "O", "overflow"), got, want):
        assert torch.equal(g, w), name
    return got


def dyn_equals_plain(planes, noff, offs, max_match):
    n, L = planes.shape
    mlen, moff = tmd.find_matches_dyn(planes.view(n, -1, 128), noff, offs, nrows=L // 128,
                                      max_match=max_match)
    want = tmd.match_dyn_reference(planes, noff, offs, max_match=max_match)
    assert torch.equal(mlen.view(n, -1), want[0])
    assert torch.equal(moff.view(n, -1), want[1])
    return moff.view(n, -1)


@pytest.mark.parametrize("block,seg,max_match", [
    (16 * 1024, 512, 1), (16 * 1024, 1024, 64), (16 * 1024, 2048, 2047),
    (48 * 1024, 512, 64), (48 * 1024, 1024, 1024), (48 * 1024, 2048, 2047),
    (128 * 1024, 1024, 1024), (128 * 1024, 1024, 1), (128 * 1024, 2048, 2047)])
def test_match_walk_kernel_on_edge_batches(block, seg, max_match, cuda_device):
    # Runs through tile and segment ends, noff = 0 beside live blocks, K =
    # 10 with d = 0, offsets up to L - 128, 37 blocks.
    batch = edge_tensors(cuda_device, block)
    before = tmd.walk_launches
    P, _, O, _ = walk_equals_plain(*batch, seg, max_match)
    assert tmd.walk_launches == before + 1
    assert (P[0] == -1).all()
    if max_match >= 1024:
        # The runs of 100 and 300 pass the end at L/2; slot 1's is longer.
        at = P[1] == block // 2 - 20
        assert at.sum() == 1 and int(O[1][at][0]) == 3536


@pytest.mark.parametrize("block", [16 * 1024, 48 * 1024, 128 * 1024])
@pytest.mark.parametrize("max_match", [1, 64, 1024, 2047])
def test_match_dyn_kernel_on_edge_batches(block, max_match, cuda_device):
    planes, noff, offs, _ = edge_tensors(cuda_device, block)
    before = tmd.dyn_launches
    moff = dyn_equals_plain(planes, noff, offs, max_match)
    assert tmd.dyn_launches == before + 1
    assert (moff[0] == 0).all()
    assert (moff[4] == block - 128).any() and (moff[4] == block // 2 + 64).any()


def test_match_kernels_on_two_streams(cuda_device):
    # B5 and B4 launched on two streams at once, on different batches.
    a = edge_tensors(cuda_device, 128 * 1024, seed=1)
    b = edge_tensors(cuda_device, 128 * 1024, seed=2)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(s1):
        walk = tmd.find_matches_parse_dyn(a[0].view(37, -1, 128), *a[1:], nrows=1024,
                                          seg=1024, min_match=6)
        dyn_a = tmd.find_matches_dyn(a[0].view(37, -1, 128), a[1], a[2], nrows=1024,
                                     max_match=256)
    with torch.cuda.stream(s2):
        dyn_b = tmd.find_matches_dyn(b[0].view(37, -1, 128), b[1], b[2], nrows=1024,
                                     max_match=256)
        walk_b = tmd.find_matches_parse_dyn(b[0].view(37, -1, 128), *b[1:], nrows=1024,
                                            seg=1024, min_match=6)
    torch.cuda.synchronize()
    for (pl, nf, of, ln), w, d in ((a, walk, dyn_a), (b, walk_b, dyn_b)):
        want = tmd._split_records(tmd.match_walk_reference(
            pl, nf, of, ln, seg=1024, min_match=6, wcap=8, max_match=1024), 8)
        assert all(torch.equal(g, x) for g, x in zip(w, want))
        want = tmd.match_dyn_reference(pl, nf, of, max_match=256)
        assert torch.equal(d[0].view(37, -1), want[0]) and torch.equal(d[1].view(37, -1), want[1])


@pytest.mark.parametrize("fmt,ow,fft", [("lz4", 128, False), ("lz4", 2048, False),
                                        ("lz4", 131712, False), ("lz4", 65536, True),
                                        ("snappy", 8192, False)])
def test_emit_kernel_matches_plain(fmt, ow, fft, cuda_device):
    block = 128 * 1024
    if fft:
        planes = torch.from_numpy(np.frombuffer(make_text_corpus(4), np.uint8)
                                  .reshape(4, block).copy()).to(cuda_device)
        lengths = torch.full((4,), block, dtype=torch.int32, device=cuda_device)
    elif ow == 128:                        # no 128 KiB block fits 128 bytes
        planes, lengths = short_rle_planes(cuda_device, block)
    else:
        planes, lengths = corpus_planes(cuda_device, block)
    layout = tdc.match_parse_device(planes, lengths, fmt=fmt, detect_fft=fft, fft_k=6)
    before = temit.launches
    got = temit.emit_blocks(planes, layout, out_width=ow, fmt=fmt, lengths=lengths)
    torch.cuda.synchronize()
    assert temit.launches == before + 1
    assert torch.equal(got, temit.emit_reference(planes, layout, out_width=ow, fmt=fmt,
                                                 lengths=lengths))
    assert assert_rows_decode(fmt, got, layout["total"], planes, lengths) > 0


@pytest.mark.parametrize("fmt,wcap,L", [("lz4", 8, 16384), ("lz4", None, 16384),
                                        ("lz4", 64, 32768), ("lz4", 8, 128 * 1024),
                                        ("lz4", None, 128 * 1024), ("snappy", 8, 16384),
                                        ("snappy", None, 128 * 1024)])
def test_emit_kernel_on_edge_layouts(fmt, wcap, L, cuda_device):
    # Whole rows equal the plain version's, garbage rows (total > width)
    # included, at widths that cut rows, that are not a multiple of 16, that
    # hold every row, and one wide enough for 512-byte tiles on a card of up
    # to 192 SMs (the kernel's literal path); and with no lengths (every raw
    # length L).
    planes, lengths, lay = (temit.edge_layouts(L, fmt=fmt, wcap=wcap))
    planes, lengths = (torch.from_numpy(a).to(cuda_device) for a in (planes, lengths))
    layout = {k: torch.from_numpy(v).to(cuda_device) for k, v in lay.items()}
    bound = tdc.lz4_bound(L)
    widths = ((256, 8192, 65408, 98304) if fmt == "snappy"
              else (128, 1000, 2051, 4096, bound, 98304))
    for ow in widths:
        for ln in (lengths, None):
            before = temit.launches
            got = temit.emit_blocks(planes, layout, out_width=ow, fmt=fmt, lengths=ln)
            torch.cuda.synchronize()
            assert temit.launches == before + 1
            want = temit.emit_reference(planes, layout, out_width=ow, fmt=fmt, lengths=ln)
            assert torch.equal(got, want), f"width {ow}, lengths {'given' if ln is not None else 'L'}"
    got = temit.emit_blocks(planes, layout, out_width=bound, fmt=fmt, lengths=lengths)
    assert assert_rows_decode(fmt, got, layout["total"], planes, lengths) > 0


@pytest.mark.parametrize("block", [128 * 1024, 48 * 1024])
def test_device_compress_engine_on_card(block, cuda_device):
    data = make_corpus(8)[:8 * block - 5000]
    cfg = btt.EngineConfig(codec=btt.Codec.LZ4, block_size=block, burst_size=4,
                           max_pool_slots=32, compress_matcher="device")
    with btt.Engine(cfg, device=cuda_device) as eng:
        walk, emitted, decoded = tmd.walk_launches, temit.launches, tflat.launches
        unit = eng.compress(data)
        assert tmd.walk_launches == walk + 1 and temit.launches == emitted + 1
        assert eng.decompress(unit).tobytes() == data
        assert tflat.launches > decoded
        assert unit.plan_flat["host_blocks"].size == 0
        assert unit.manifest.ratio() > 1.3
        assert eng.recycle(unit) == unit.nblocks


def test_compress_blocks_device_seg_256_on_card(cuda_device):
    planes, lengths = corpus_planes(cuda_device, 128 * 1024)
    before = tmd.dyn_launches
    out, sizes = tdc.compress_blocks_device(planes, lengths, seg=256)
    torch.cuda.synchronize()
    assert tmd.dyn_launches == before + 1
    assert assert_rows_decode("lz4", out, sizes, planes, lengths) > 0


# ---------------------------------------------------------------------------
# B6 (parse_walk) and B7 (decode_planned)


@pytest.mark.parametrize("block,seg", [(128 * 1024, 1024), (32 * 1024, 256), (64 * 1024, 512)])
def test_parse_walk_kernel_matches_plain_on_b4_planes(block, seg, cuda_device):
    # B4's planes walked by B6 equal the plain version, and B5's records
    # where the segment count is a power of two.
    planes, lengths = corpus_planes(cuda_device, block)
    n = planes.shape[0]
    offs, _ = tmd.detect_offsets(planes, k=4, max_off=min(0xFFFF, block - 128))
    offs = offs.contiguous()
    noff = (offs > 0).sum(dim=1).int()
    mlen, moff = tmd.find_matches_dyn(planes.view(n, -1, 128), noff, offs,
                                      nrows=block // 128, max_match=seg)
    mlen, moff = mlen.reshape(n, block), moff.reshape(n, block)
    before = tmd.parse_walk_launches
    got = tmd.parse_walk_dyn(mlen, moff, lengths, seg=seg, min_match=6, wcap=8)
    torch.cuda.synchronize()
    assert tmd.parse_walk_launches == before + 1
    want = tmd.parse_walk_reference(mlen, moff, lengths, seg=seg, min_match=6, wcap=8)
    b5 = tmd.find_matches_parse_dyn(planes.view(n, -1, 128), noff, offs, lengths,
                                    nrows=block // 128, seg=seg, min_match=6, wcap=8,
                                    max_match=seg)
    for g, w, f in zip(got, want, b5):
        assert torch.equal(g, w) and torch.equal(g, f)


@pytest.mark.parametrize("seg,min_match", [(256, 6), (512, 0), (1000, -2)])
def test_parse_walk_kernel_matches_plain_on_random_planes(seg, min_match, cuda_device):
    rng = np.random.default_rng(seg)
    n, L = 16, seg * 32
    on = rng.random((n, L)) < 0.5
    mlen = np.where(on, rng.integers(-4, 40, (n, L)), 0).astype(np.int32)
    moff = rng.integers(0, 3, (n, L)).astype(np.int32)
    moff[:, 100:900] = 0                                  # moff = 0 inside long runs
    lengths = rng.integers(0, L + 1, n).astype(np.int32)   # blen below L
    args = [torch.from_numpy(a).to(cuda_device) for a in (mlen, moff, lengths)]
    got = tmd.parse_walk_dyn(*args, seg=seg, min_match=min_match, wcap=8)
    torch.cuda.synchronize()
    want = tmd.parse_walk_reference(*args, seg=seg, min_match=min_match, wcap=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[3].any()), "some segments overflow wcap"


@pytest.mark.parametrize("wcap", [0, 1, 8, 40])
@pytest.mark.parametrize("seg", [128, 1024, 2048, 1000, 42])
def test_parse_walk_kernel_on_edge_batch(seg, wcap, cuda_device):
    # seg 42 takes four 4-byte loads a lane and chunk (seg % 4 != 0), the
    # others one 16-byte load.
    args = [torch.from_numpy(a).to(cuda_device) for a in tmd.walk_edge_batch(seg, 8)]
    before = tmd.parse_walk_launches
    got = tmd.parse_walk_dyn(*args, seg=seg, min_match=6, wcap=wcap)
    torch.cuda.synchronize()
    assert tmd.parse_walk_launches == before + 1
    want = tmd.parse_walk_reference(*args, seg=seg, min_match=6, wcap=wcap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seg", [128, 1024])
def test_parse_walk_kernel_on_unaligned_planes(seg, cuda_device):
    # Planes 4 bytes past a 16-byte boundary take four 4-byte loads a lane
    # and chunk at a seg that otherwise takes one 16-byte load.
    mlen, moff, lengths = (torch.from_numpy(a).to(cuda_device)
                           for a in tmd.walk_edge_batch(seg, 8))
    shifted = []
    for t in (mlen, moff):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        flat[1:] = t.reshape(-1)
        shifted.append(flat[1:].view(t.shape))
    assert shifted[0].data_ptr() % 16
    got = tmd.parse_walk_dyn(*shifted, lengths, seg=seg, min_match=6, wcap=8)
    want = tmd.parse_walk_reference(mlen, moff, lengths, seg=seg, min_match=6, wcap=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _emit_and_walk_batches(device):
    planes, lengths, lay = temit.edge_layouts(16384, wcap=8)
    emit_in = (torch.from_numpy(planes).to(device),
               {k: torch.from_numpy(v).to(device) for k, v in lay.items()},
               torch.from_numpy(lengths).to(device))
    return emit_in, [torch.from_numpy(a).to(device) for a in tmd.walk_edge_batch(1024, 8)]


def test_emit_and_parse_walk_on_a_device_not_current():
    # The wrappers enter no device context: the launch functions enter the
    # tensors' device, so a launch from another current device runs there,
    # on that device's stream, and leaves the current device as it was.
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    (planes, layout, lengths), walk = _emit_and_walk_batches(dev)
    with torch.cuda.device(0):
        got_e = temit.emit_blocks(planes, layout, out_width=4096, lengths=lengths)
        got_w = tmd.parse_walk_dyn(*walk, seg=1024, min_match=6, wcap=8)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev)
    assert got_e.device == dev and got_w[0].device == dev
    want_e = temit.emit_reference(planes.cpu(), {k: v.cpu() for k, v in layout.items()},
                                  out_width=4096, lengths=lengths.cpu())
    assert torch.equal(got_e.cpu(), want_e)
    want_w = tmd.parse_walk_reference(*(t.cpu() for t in walk), seg=1024, min_match=6, wcap=8)
    for g, w in zip(got_w, want_w):
        assert torch.equal(g.cpu(), w)


def test_emit_and_parse_walk_launchers_enter_the_given_device(cuda_device):
    # Each launch function launches on the device it is given, not the
    # current one: a device that does not exist fails the launch ("invalid
    # device ordinal") and leaves the current device as it was.
    (planes, layout, lengths), (mlen, moff, wlen) = _emit_and_walk_batches(cuda_device)
    current = torch.cuda.current_device()
    missing = torch.cuda.device_count()
    stream = torch._C._cuda_getCurrentRawStream(current)
    n, L = planes.shape
    S = layout["starts"].shape[1]
    out = torch.empty((n, 4096), dtype=torch.uint8, device=cuda_device)
    lib = temit.load_kernel()
    fields = [layout[k].data_ptr() for k in ("starts", "lit_len", "lit_start", "mv", "off")]
    for device, want in ((missing, "invalid device ordinal"), (current, "no error")):
        rc = lib.bt_emit_launch(planes.data_ptr(), L, *fields, S, layout["total"].data_ptr(),
                                lengths.data_ptr(), out.data_ptr(), n, 4096, 0, device, stream)
        assert lib.bt_error(rc).decode() == want
        assert torch.cuda.current_device() == current
    P, M, O = torch.empty((3, mlen.shape[0], 8 * 8), dtype=torch.int32, device=cuda_device)
    flags = torch.empty((mlen.shape[0], 8), dtype=torch.int32, device=cuda_device)
    wlib = tmd.load_parse_walk_kernel()
    for device, want in ((missing, "invalid device ordinal"), (current, "no error")):
        rc = wlib.bt_parse_walk_launch(mlen.data_ptr(), moff.data_ptr(), wlen.data_ptr(),
                                       P.data_ptr(), M.data_ptr(), O.data_ptr(),
                                       flags.data_ptr(), mlen.shape[0], mlen.shape[1], 1024, 6,
                                       8, device, stream)
        assert wlib.bt_error(rc).decode() == want
        assert torch.cuda.current_device() == current
    torch.cuda.synchronize()


@pytest.mark.parametrize("block", [16 * 1024, 128 * 1024])
def test_decode_planned_kernel_matches_plain(block, cuda_device):
    from bitar_tpu_torch.ops import decode_planned as tdp

    corpus = make_corpus(8)
    datas = [corpus[i * 131072:i * 131072 + block] for i in range(8)]
    datas.append((b"planned on the card " * (block // 20 + 1))[:block])
    wire = tdp.plan_blocks(datas, block, 64)
    fit = wire["fit"]
    assert len(fit) >= 6
    args = [torch.from_numpy(wire[k]).to(cuda_device) for k in ("comp", "p_used", "se", "shift")]
    kw = dict(passes=wire["passes"], comp_rows=wire["comp_rows"], out_rows=block // 128)
    before = tdp.launches
    got = tdp.decode_blocks_planned(*args, **kw)
    torch.cuda.synchronize()
    assert tdp.launches == before + 1
    assert torch.equal(got, tdp.decode_planned_reference(*args, **kw))
    host = got.cpu().numpy()
    for j, i in enumerate(fit):
        assert host[j].tobytes() == datas[i], i


@pytest.mark.parametrize("comp_rows,out_rows", [(64, 256), (1024, 1024), (2048, 512)])
def test_decode_planned_kernel_matches_plain_on_random_plans(comp_rows, out_rows, cuda_device):
    from bitar_tpu_torch.ops import decode_planned as tdp

    passes = 5
    args = [torch.from_numpy(a).to(cuda_device)
            for a in tdp.random_plans(comp_rows + out_rows, 6, passes, comp_rows, out_rows)]
    kw = dict(passes=passes, comp_rows=comp_rows, out_rows=out_rows)
    got = tdp.decode_blocks_planned(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, tdp.decode_planned_reference(*args, **kw))


@pytest.mark.parametrize("reads", ["cccccccc", "Pccccc", "cPccPPcP"])
@pytest.mark.parametrize("comp_rows,out_rows", [(32, 128), (2048, 512), (64, 1024), (512, 1024)])
def test_decode_planned_kernel_on_pass_classes(reads, comp_rows, out_rows, cuda_device):
    # Passes that read only comp rows (run without barriers), passes that
    # read the out plane, and the seams between them; p_used spread over
    # 0..passes, negative and past passes (the queue's order).
    from bitar_tpu_torch.ops import decode_planned as tdp

    flags = [c == "P" for c in reads]
    args = [torch.from_numpy(a).to(cuda_device)
            for a in tdp.class_plans(comp_rows + out_rows, 14, flags, comp_rows, out_rows)]
    kw = dict(passes=len(flags), comp_rows=comp_rows, out_rows=out_rows)
    got = tdp.decode_blocks_planned(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, tdp.decode_planned_reference(*args, **kw))


def test_decode_planned_kernel_in_any_block_order(cuda_device):
    # The kernel takes the blocks by descending p_used; each
    # block's output stays in its own row whatever order they come in, and
    # the shared block queue is back at zero after every launch.
    from bitar_tpu_torch.ops import decode_planned as tdp

    args = [torch.from_numpy(a).to(cuda_device) for a in tdp.random_plans(31, 40, 6, 256, 512)]
    kw = dict(passes=6, comp_rows=256, out_rows=512)
    want = tdp.decode_planned_reference(*args, **kw)
    for perm in (torch.arange(40), torch.argsort(args[1], descending=True),
                 torch.randperm(40, generator=torch.Generator().manual_seed(3))):
        perm = perm.to(cuda_device)
        got = tdp.decode_blocks_planned(*(a[perm] for a in args), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want[perm])
    assert all(int(q.abs().sum()) == 0 for q in block_queues.values())


def test_decode_planned_device_memory_route_past_the_shared_plane(cuda_device):
    # Planes of 1152 rows (one tile past the shared plane) and 5120 take the
    # tall route, their last slice partial, and decode equal to the plain
    # version; the slices stop where slice_stops says (the last one reads
    # the plane first, the others later), and the queue is back at zero.
    # The kernel takes up to 8192 rows.
    from bitar_tpu_torch.ops import decode_planned as tdp

    for rows in (1152, 5120):
        c = tdp.cluster_ctas(rows)
        plans = [torch.from_numpy(a).to(cuda_device) for a in tdp.class_plans(
            16, 5, [False, True, False, True, True], 64, rows,
            slices=[None, [c - 1], None, [0], None])]
        kw = dict(passes=5, comp_rows=64, out_rows=rows)
        stops = torch.full((5, c), -1, dtype=torch.int32, device=cuda_device)
        before = tdp.gmem_launches
        got = tdp.decode_blocks_planned(*plans, stops=stops, **kw)
        torch.cuda.synchronize()
        assert tdp.gmem_launches == before + 1
        assert torch.equal(got, tdp.decode_planned_reference(*plans, **kw))
        want = tdp.slice_stops(*plans[2:], plans[1], **kw)
        assert torch.equal(stops, want) and int(want[0, -1]) == 1 and int(want[0, 0]) == 3
        assert all(int(q.abs().sum()) == 0 for q in block_queues.values())
    with pytest.raises(btt.StatusError, match="8192 rows"):
        z = torch.zeros((1, 1, 65, 128), dtype=torch.int32, device=cuda_device)
        tdp.decode_blocks_planned(plans[0][:1], plans[1][:1], z, z, passes=1, comp_rows=64,
                                  out_rows=8320)


def test_dryrun_multichip_decodes_on_the_card(cuda_device):
    # The default world runs on the card: NCCL with a card per rank, else
    # gloo ranks sharing the cards; every rank launches B1 (a launch is
    # counted only on CUDA tensors).
    from bitar_tpu_torch.parallel import dryrun

    res = dryrun.dryrun_multichip(2, timeout=240.0)
    assert all(r["launches"]["decode_flat"] > 0 for r in res)
    assert sum(r["flat"]["live"] for r in res) == 4


# ---------------------------------------------------------------------------
# Blocks of 256 KiB to 1 MiB: the cluster routes of B1 and B2


def large_unit(device, data: bytes, block: int, codec=btt.Codec.LZ4, sizes=None,
               burst_size=1024, **kw):
    """An engine of ``block``-byte blocks and the planned (or tabled) unit
    of ``data`` (cut at ``sizes`` when given) on it."""
    n = len(sizes) if sizes is not None else -(-len(data) // block)
    cfg = btt.EngineConfig(codec=codec, block_size=block, burst_size=min(n, burst_size),
                           max_pool_slots=n + 32, commit="deferred", plan_build="lazy", **kw)
    eng = btt.Engine(cfg, device=device).initialize()
    unit = eng.compress(data, sizes=sizes)
    eng.ensure_plans(unit)
    return eng, unit


@pytest.mark.parametrize("corpus,block", [("bench", 256 * 1024), ("bench", 1 << 20),
                                          ("text", 256 * 1024), ("text", 1 << 20)])
def test_decode_flat_device_memory_route_matches_plain(corpus, block, cuda_device):
    data = {"bench": make_corpus, "text": make_text_corpus}[corpus](128)
    eng, unit = large_unit(cuda_device, data, block)
    assert unit.plan_flat is not None and unit.plan_flat["host_blocks"].size == 0
    rows = eng.arena.gather_burst([r.slot for r in unit.refs])
    pt, comp_rows, nrows = unit.plan_device_arrays(), unit.plan_comp_rows, block // 128
    n = unit.nblocks
    for cls, idx in {"all": torch.arange(n, device=cuda_device),
                     **tflat.block_classes(pt)}.items():
        if not idx.numel():
            continue
        r, p = tflat.select_blocks(rows, pt, idx)
        before = tflat.cluster_launches
        got = tflat.decode_blocks_flat(r, p, comp_rows=comp_rows, out_rows=nrows)
        torch.cuda.synchronize()
        assert tflat.cluster_launches == before + 1
        assert torch.equal(got, tflat.decode_flat_reference(r, p, comp_rows, nrows)), cls
        host = got.reshape(idx.numel(), -1).cpu().numpy()
        for j, b in enumerate(idx.tolist()):
            assert host[j].tobytes() == data[b * block:(b + 1) * block], (cls, b)
    if corpus == "text":
        assert tflat.block_classes(pt)["out passes"].numel() == n
    eng.release()


@pytest.mark.parametrize("out_rows,dcap,n", [(2048, 64, 40), (8192, 16, 12), (8192, 64, 133),
                                          (1152, 16, 21), (4096, 32, 17)])
def test_decode_flat_device_memory_route_on_random_wires(out_rows, dcap, n, cuda_device):
    # Malformed plans (every pass id, anchors out of range, RAW, dense,
    # comp and out passes with random ranges and shifts that cross slices
    # and clip at both plane ends) at heights of 1152 (a last slice of 128
    # rows) to 8192 rows.
    comp, plans = tflat.random_wire(59 + n, n, out_rows, 2 * out_rows, dcap)
    rows = torch.from_numpy(comp).to(cuda_device)
    pt = tflat.plan_tensors(plans, cuda_device)
    before = tflat.cluster_launches
    got = tflat.decode_blocks_flat(rows, pt, comp_rows=2 * out_rows, out_rows=out_rows)
    torch.cuda.synchronize()
    assert tflat.cluster_launches == before + 1
    assert torch.equal(got, tflat.decode_flat_reference(rows, pt, 2 * out_rows, out_rows))


@pytest.mark.parametrize("out_rows", [1152, 2048, 4096, 8192])
def test_decode_flat_cluster_route_gathers_across_slices(out_rows, cuda_device):
    comp, plans = tflat.slice_crossing_wire(out_rows, 64 + out_rows // 128)
    rows = torch.from_numpy(comp).to(cuda_device)
    pt = tflat.plan_tensors(plans, cuda_device)
    assert tflat.block_classes(pt)["out passes"].numel() == 4
    before = tflat.cluster_launches
    got = tflat.decode_blocks_flat(rows, pt, comp_rows=out_rows, out_rows=out_rows)
    torch.cuda.synchronize()
    assert tflat.cluster_launches == before + 1
    want = tflat.decode_flat_reference(rows, pt, out_rows, out_rows)
    assert torch.equal(got, want)
    assert not torch.equal(want.reshape(4, -1), rows)    # the out passes moved bytes


def test_decode_flat_cluster_route_on_a_skewed_burst(cuda_device):
    # The CLI's skewed suite (BASELINE config 4): 4 KiB to 1 MiB blocks of
    # three kinds, each on an 8192-row plane, every burst of 32 (RAW copies
    # and blocks of one or two dense passes, which the planner gives every
    # LZ4 block of the suite, in one launch) against the plain version.
    from bitar_tpu_torch.cli.demo import make_skewed_input

    block = 1 << 20
    data, sizes = make_skewed_input(block, 96)
    eng, unit = large_unit(cuda_device, data, block, sizes=sizes, burst_size=32)
    rows = eng.arena.gather_burst([r.slot for r in unit.refs])
    pt, comp_rows = unit.plan_device_arrays(), unit.plan_comp_rows
    classes = tflat.block_classes(pt)
    assert classes["raw"].numel() and classes["no out pass"].numel()
    ends = np.cumsum([0] + sizes)
    for start in range(0, 96, 32):
        idx = torch.arange(start, start + 32, device=cuda_device)
        r, p = tflat.select_blocks(rows, pt, idx)
        before = tflat.cluster_launches
        got = tflat.decode_blocks_flat(r, p, comp_rows=comp_rows, out_rows=block // 128)
        torch.cuda.synchronize()
        assert tflat.cluster_launches == before + 1
        assert torch.equal(got, tflat.decode_flat_reference(r, p, comp_rows, block // 128))
        host = got.reshape(32, -1).cpu().numpy()
        for j in range(32):
            b = start + j
            assert host[j, :sizes[b]].tobytes() == data[ends[b]:ends[b + 1]], b
    eng.release()


@pytest.mark.parametrize("shape", ["bench 1024 x 128 KiB", "bench permuted slots",
                                   "bench 128 x 1 MiB"])
def test_decode_flat_in_place_equals_gathered(shape, cuda_device):
    # B1 through a table of slots over the arena (the scan's launch) against
    # B1 on the same slots gathered into contiguous rows, byte for byte: the
    # engine's own slot order, slots scattered over a larger buffer in a
    # random order, and 1 MiB planes (the slice and cluster kernels).
    block = 1 << 20 if "1 MiB" in shape else 128 * 1024
    data = make_corpus(1024)[:(128 if "1 MiB" in shape else 1024) * block]
    eng, unit = large_unit(cuda_device, data, block)
    assert unit.plan_flat["host_blocks"].size == 0
    pt, comp_rows, nrows = unit.plan_device_arrays(), unit.plan_comp_rows, block // 128
    n = unit.nblocks
    table = unit.slot_table()
    buf = eng.arena.buffer
    assert not unit.plan_flat.get("lit_planes") and table.device == buf.device
    if shape == "bench permuted slots":
        g = torch.Generator().manual_seed(61)
        rows = torch.randperm(2 * n, generator=g)[:n].to(cuda_device)
        scattered = torch.zeros((2 * n, buf.shape[1]), dtype=torch.uint8, device=cuda_device)
        scattered[rows] = buf[table.long()]
        buf, table = scattered, rows.int()
    before = (tflat.launches, tflat.cluster_launches)
    got = tflat.decode_blocks_flat(buf, pt, comp_rows=comp_rows, out_rows=nrows, src_rows=table)
    want = tflat.decode_blocks_flat(buf.index_select(0, table), pt, comp_rows=comp_rows,
                                    out_rows=nrows)
    torch.cuda.synchronize()
    tall = int(nrows > 1024)
    assert (tflat.launches, tflat.cluster_launches) == (before[0] + 2, before[1] + 2 * tall)
    assert torch.equal(got, want)
    assert got.reshape(-1).cpu().numpy().tobytes() == data
    if shape != "bench permuted slots":          # the engine's own launch reads in place
        planes = torch.cat(eng.decompress_device(unit))
        assert torch.equal(planes, want)
    eng.recycle(unit)
    eng.release()


def test_decode_flat_source_rows_clip_to_the_buffer(cuda_device):
    # A table entry outside the buffer's rows reads the nearest row (the
    # plain version raises there): no launch reads past the buffer.
    comp, plans = tflat.random_wire(62, 40, 1024, 256, 8)
    rows = torch.from_numpy(comp).to(cuda_device)
    table = torch.randint(0, 40, (40,), dtype=torch.int32, device=cuda_device)
    table[:4] = torch.tensor([-1, -2**31, 40, 2**31 - 1], dtype=torch.int32)
    pt = tflat.plan_tensors(plans, cuda_device)
    got = tflat.decode_blocks_flat(rows, pt, comp_rows=256, out_rows=1024, src_rows=table)
    clipped = rows.index_select(0, table.clamp(0, 39))
    torch.cuda.synchronize()
    assert torch.equal(got, tflat.decode_flat_reference(clipped, pt, 256, 1024))


@pytest.mark.parametrize("codec", ["lz4", "zstd"])
def test_traced_decompress_device_reads_in_place_on_card(codec, cuda_device):
    # Traced, a resident LZ4 unit's decode counts every block read in place
    # and gathers nothing; a Zstd unit (literal planes replace its rows)
    # still gathers.
    from bitar_tpu_torch.utils import profiling

    data = make_corpus(5)[:40 * 16 * 1024]
    cfg = btt.EngineConfig(codec=btt.Codec(codec), block_size=16 * 1024, burst_size=16,
                           max_pool_slots=64)
    with btt.Engine(cfg, device=cuda_device) as eng:
        unit = eng.compress(data)
        eng.ensure_plans(unit)
        assert unit.plan_flat is not None
        profiling.snapshot(reset=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            planes = torch.cat(eng.decompress_device(unit))
            torch.cuda.synchronize()
        counted = profiling.snapshot(reset=True)
        host = planes.reshape(unit.nblocks, -1).cpu().numpy()
        assert b"".join(host[i, :int(n)].tobytes()
                        for i, n in enumerate(unit.manifest.raw_len)) == data
        assert counted["decode_flat.blocks"] == unit.nblocks
        if codec == "lz4":
            assert counted["arena.inplace_blocks"] == unit.nblocks
            assert "arena.gather_bytes" not in counted
        else:
            assert unit.plan_flat["lit_planes"] and "arena.inplace_blocks" not in counted
            assert counted["arena.gather_bytes"] == unit.nblocks * cfg.slot_size
        eng.recycle(unit)


def test_prepare_device_decode_reads_in_place_on_card(cuda_device):
    # prepare_device_decode takes its source where the bursts do: the
    # unit's slots in the arena, read in place; traced, nothing gathered.
    from bitar_tpu_torch.utils import profiling

    data = make_corpus(5)[:40 * 16 * 1024]
    cfg = btt.EngineConfig(codec=btt.Codec.LZ4, block_size=16 * 1024, burst_size=16,
                           max_pool_slots=64)
    with btt.Engine(cfg, device=cuda_device) as eng:
        unit = eng.compress(data)
        eng.ensure_plans(unit)
        assert unit.plan_flat["host_blocks"].size == 0
        profiling.snapshot(reset=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            planes = eng.prepare_device_decode(unit)()
            torch.cuda.synchronize()
        counted = profiling.snapshot(reset=True)
        assert counted["arena.inplace_blocks"] == counted["decode_flat.blocks"] == unit.nblocks
        assert not {"arena.gather_bytes", "arena.gather_stored_bytes"} & set(counted)
        assert torch.equal(planes, torch.cat(eng.decompress_device(unit)))
        host = planes.reshape(unit.nblocks, -1).cpu().numpy()
        assert b"".join(host[i, :int(n)].tobytes()
                        for i, n in enumerate(unit.manifest.raw_len)) == data
        eng.recycle(unit)


def one_shot_launch(buf, pt, comp_rows, out_rows, table):
    """B1 through the library's one-shot entry ``bt_decode_flat_launch``
    (its 24 arguments, on the current device and stream): the planes."""
    lib = tflat.load_kernel()
    n = table.numel()
    out = torch.empty((n, out_rows, 128), dtype=torch.uint8, device=buf.device)
    listed = torch.empty(n, dtype=torch.int32, device=buf.device)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    rc = lib.bt_decode_flat_launch(
        buf.data_ptr(), buf.stride(0), buf.shape[1], comp_rows,
        *(pt[k].data_ptr() for k in ("p_used", "p_off", "p0", "dense", "dq_idx", "se", "shift")),
        pt["se"].numel() // out_rows, pt["dq"].data_ptr(), pt["dq"].shape[0],
        pt["row_a"].data_ptr(), pt["row_a"].shape[1], out.data_ptr(), n, out_rows,
        block_queue(buf.device, stream).data_ptr(), listed.data_ptr(), table.data_ptr(),
        buf.shape[0], stream)
    assert rc == 0, lib.bt_error(rc)
    return out


@pytest.mark.parametrize("shape", ["bench 1024 x 128 KiB", "bench 128 x 1 MiB",
                                   "text 32 x 1 MiB", "skewed burst"])
def test_flat_launch_record_equals_the_one_shot_launch(shape, cuda_device):
    # A prepared record, run three times, gives the bytes of the library's
    # one-shot launch and of the plain version: the shared route, the tall
    # route's slice kernel (bench 1 MiB: no out pass) and cluster kernel
    # (text 1 MiB), and a skewed burst of 4 KiB to 1 MiB blocks.
    from bitar_tpu_torch.cli.demo import make_skewed_input

    block = 128 * 1024 if "128 KiB" in shape else 1 << 20
    sizes = None
    if shape == "skewed burst":
        data, sizes = make_skewed_input(block, 32)
    else:
        data = {"bench": make_corpus, "text": make_text_corpus}[shape.split()[0]](1024)
        data = data[:int(shape.split()[1]) * block]
    eng, unit = large_unit(cuda_device, data, block, sizes=sizes)
    pt, comp_rows, nrows = unit.plan_device_arrays(), unit.plan_comp_rows, block // 128
    buf, table = eng.arena.buffer, unit.slot_table()
    rec = tflat.prepare_flat_launch(buf, pt, comp_rows=comp_rows, out_rows=nrows, src_rows=table)
    before = (tflat.launches, tflat.cluster_launches)
    got = [rec.run() for _ in range(3)]
    tall = int(nrows > 1024)
    assert (tflat.launches, tflat.cluster_launches) == (before[0] + 3, before[1] + 3 * tall)
    assert rec.runs == 3
    want = one_shot_launch(buf, pt, comp_rows, nrows, table)
    torch.cuda.synchronize()
    assert all(torch.equal(g, want) for g in got)
    assert torch.equal(want, tflat.decode_flat_reference(buf.index_select(0, table), pt,
                                                         comp_rows, nrows))
    if shape == "text 32 x 1 MiB":
        assert tflat.block_classes(pt)["out passes"].numel() == unit.nblocks
    eng.recycle(unit)
    eng.release()


def test_flat_launch_record_on_a_second_stream(cuda_device):
    # One record run on the default stream and on two side streams at once:
    # each run takes its stream's block queue, every run decodes every
    # block, and every queue is 0 again after.
    _, rows, pt, comp_rows = engine_batch(cuda_device, 16 * 1024, 300)
    want = tflat.decode_flat_reference(rows, pt, comp_rows, 128)
    rec = tflat.prepare_flat_launch(rows, pt, comp_rows=comp_rows, out_rows=128)
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    outs = [rec.run(rows)]
    for _ in range(3):
        for s in streams:
            s.wait_stream(torch.cuda.current_stream(cuda_device))
            with torch.cuda.stream(s):
                outs.append(rec.run(rows))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)
    for s in [torch.cuda.current_stream(cuda_device), *streams]:
        assert (cuda_device.index or 0, s.cuda_stream) in block_queues
    assert all(int(q.abs().sum()) == 0 for q in block_queues.values())


@pytest.mark.parametrize("codec", ["lz4", "zstd"])
def test_resident_unit_keeps_its_burst_records_on_card(codec, cuda_device):
    # Repeated decodes of a resident unit run the records its first decode
    # built (in place for LZ4, gathered for Zstd's literal planes), traced
    # as decode_flat.prepared_blocks; prepare_device_decode and a planned
    # decompress round-trip beside them; recycle drops the records.
    from bitar_tpu_torch.utils import profiling

    data = make_corpus(5)[:40 * 16 * 1024]
    cfg = btt.EngineConfig(codec=btt.Codec(codec), block_size=16 * 1024, burst_size=16,
                           max_pool_slots=64)
    with btt.Engine(cfg, device=cuda_device) as eng:
        unit = eng.compress(data)
        first = torch.cat(eng.decompress_device(unit))
        records = dict(unit._flat_launches)
        assert sorted(records) == [0, 16, 32]
        profiling.snapshot(reset=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            again = torch.cat(eng.decompress_device(unit))
            torch.cuda.synchronize()
        counted = profiling.snapshot(reset=True)
        assert all(unit._flat_launches[k] is r for k, r in records.items())
        assert counted["decode_flat.prepared_blocks"] == counted["decode_flat.blocks"] == 40
        assert counted.get("arena.inplace_blocks", 0) == (40 if codec == "lz4" else 0)
        assert torch.equal(again, first)
        assert eng.decompress(unit).tobytes() == data
        assert torch.equal(eng.prepare_device_decode(unit)(), first)
        host = first.reshape(unit.nblocks, -1).cpu().numpy()
        assert b"".join(host[i, :int(n)].tobytes()
                        for i, n in enumerate(unit.manifest.raw_len)) == data
        eng.recycle(unit)
        assert unit._flat_launches == {}
        with pytest.raises(btt.StatusError):
            eng.decompress_device(unit)


def test_decode_flat_launch_past_2gib_of_output(cuda_device):
    # ~2100 x 1 MiB of RLE and RAW blocks in one launch: 2.2 GB of output,
    # so every block base past 2^31 bytes must be 64-bit.
    block, n = 1 << 20, 2100
    rng = np.random.default_rng(60)
    randoms = [rng.integers(0, 256, block, np.uint8).tobytes() for i in range(7)]
    data = b"".join(bytes([i & 0xFF]) * block if i % 3 == 0 else randoms[i % 7]
                    for i in range(n))
    eng, unit = large_unit(cuda_device, data, block)
    assert unit.plan_flat["host_blocks"].size == 0 and n * block > 2**31
    before = tflat.cluster_launches
    out = eng.prepare_device_decode(unit)()
    torch.cuda.synchronize()
    assert tflat.cluster_launches == before + 1
    want = torch.from_numpy(np.frombuffer(data, np.uint8)).to(cuda_device)
    assert torch.equal(out.view(-1), want)
    del out, want
    eng.release()


def test_decode_tables_device_memory_route_matches_plain(cuda_device):
    block = 1 << 20
    batches = {}
    for name, data in (("bench", make_corpus(64)), ("text", make_text_corpus(64))):
        datas = [data[i * block:(i + 1) * block] for i in range(8)]
        batches[name] = (*tdt.parser_tables(datas)[:3], b"".join(datas))
    # Malformed tables at S 64: their random literal runs (up to 256 KiB
    # each) cost the plain version ~1 G elements at S 4096.
    for kind, S in ((True, 4096), (False, 64)):
        batches[f"random {kind}"] = (*tdt.random_tables(61 + kind, 12, S, block,
                                                         well_formed=kind), None)
    for name, (r, tabs, ns, want_bytes) in batches.items():
        nseq, tt = tdt.table_tensors(tabs, ns, cuda_device)
        rows = torch.from_numpy(r).to(cuda_device)
        paths = torch.zeros(2, dtype=torch.int32, device=cuda_device)
        before = tdt.cluster_launches
        got = tdt.decode_blocks(rows, nseq, tt, out_rows=block // 128, path_counts=paths)
        torch.cuda.synchronize()
        assert tdt.cluster_launches == before + 1
        assert torch.equal(got, tdt.decode_tables_reference(rows, nseq, tt, block // 128)), name
        wf = int(tdt.well_formed(nseq, tt).sum())
        assert paths.tolist() == [wf, rows.shape[0] - wf], name
        if want_bytes is not None:
            assert got.cpu().numpy().tobytes() == want_bytes, name


@pytest.mark.parametrize("block", [160 * 1024, 256 * 1024])
def test_decode_tables_routes_meet_at_the_shared_limit(block, cuda_device):
    # 160 KiB is past the shared route (~150 KiB beside the windows);
    # both sizes decode the same through the cluster route (2 CTAs each).
    rows, tabs, ns = tdt.random_tables(62, 16, 1024, block, well_formed=True)
    nseq, tt = tdt.table_tensors(tabs, ns, cuda_device)
    r = torch.from_numpy(rows).to(cuda_device)
    before = tdt.cluster_launches
    got = tdt.decode_blocks(r, nseq, tt, out_rows=block // 128)
    torch.cuda.synchronize()
    assert tdt.cluster_launches == before + 1
    assert torch.equal(got, tdt.decode_tables_reference(r, nseq, tt, block // 128))


@pytest.mark.parametrize("out_rows", [1300, 2048, 4096, 8192])
def test_decode_tables_cluster_route_by_plane_height(out_rows, cuda_device):
    # Past the shared route (1224 rows) at heights that are and are not a
    # whole number of 128 KiB slices: the parser's tables of markdown and
    # random well-formed (chains, offsets 1-130, extents past the plane) and
    # malformed tables (the serial walk), in one launch each.
    block = out_rows * 128
    text = make_text_corpus(-(-6 * block // (128 * 1024)))
    parser = tdt.parser_tables([text[i * block:(i + 1) * block] for i in range(6)])[:3]
    batches = {"parser": parser,
               "well-formed": tdt.random_tables(65, 9, 1024, block, well_formed=True),
               "malformed": tdt.random_tables(66, 9, 64, block, well_formed=False)}
    for name, (r, tabs, ns) in batches.items():
        nseq, tt = tdt.table_tensors(tabs, ns, cuda_device)
        rows = torch.from_numpy(r).to(cuda_device)
        paths = torch.zeros(2, dtype=torch.int32, device=cuda_device)
        before = tdt.cluster_launches
        got = tdt.decode_blocks(rows, nseq, tt, out_rows=out_rows, path_counts=paths)
        torch.cuda.synchronize()
        assert tdt.cluster_launches == before + 1
        assert torch.equal(got, tdt.decode_tables_reference(rows, nseq, tt, out_rows)), name
        wf = int(tdt.well_formed(nseq, tt).sum())
        assert paths.tolist() == [wf, rows.shape[0] - wf], name
        assert (wf == rows.shape[0]) == (name != "malformed"), name


def test_decode_tables_cluster_route_on_rle_tables_at_1mib(cuda_device):
    # Runs of offsets 1-130 over a whole 1 MiB plane: d literal bytes, one
    # match of offset d to 5 bytes before the end, 5 literals; a block of
    # at most 8 sequences, each CTA sweeping the bytes it holds.
    block, n = 1 << 20, 12
    offs = [1, 2, 3, 4, 7, 16, 31, 64, 100, 127, 128, 130]
    rng = np.random.default_rng(67)
    rows = rng.integers(0, 256, (n, 256), np.uint8)
    tables = {k: np.zeros((n, 128), np.int32) for k in ("lit_ptr", "lit_len", "off", "mlen",
                                                         "out_pos")}
    for i, d in enumerate(offs):
        tables["lit_len"][i, :2] = [d, 5]
        tables["off"][i, 0] = d
        tables["mlen"][i, 0] = block - d - 5
        tables["lit_ptr"][i, 1] = d
        tables["out_pos"][i, 1] = block - 5
    nseq, tt = tdt.table_tensors(tables, np.full(n, 2, np.int32), cuda_device)
    r = torch.from_numpy(rows).to(cuda_device)
    before = tdt.cluster_launches
    got = tdt.decode_blocks(r, nseq, tt, out_rows=block // 128)
    torch.cuda.synchronize()
    assert tdt.cluster_launches == before + 1
    assert torch.equal(got, tdt.decode_tables_reference(r, nseq, tt, block // 128))
    host = got.reshape(n, -1).cpu().numpy()
    for i, d in enumerate(offs):
        want = np.concatenate([np.resize(rows[i, :d], block - 5), rows[i, d:d + 5]])
        assert host[i].tobytes() == want.tobytes(), d


def test_engine_at_1mib_decodes_every_block_through_b1(cuda_device):
    data = make_corpus(1024)                  # 128 x 1 MiB
    eng, unit = large_unit(cuda_device, data, 1 << 20)
    before = tflat.cluster_launches
    assert eng.decompress(unit).tobytes() == data
    assert unit.plan_flat["host_blocks"].size == 0 and eng.stats.host_decode_bursts == 0
    assert tflat.cluster_launches > before
    planes = eng.prepare_device_decode(unit)()
    assert planes.reshape(-1).cpu().numpy().tobytes() == data
    eng.release()


@pytest.mark.parametrize("codec", ["lz4", "snappy", "zstd"])
def test_cli_skewed_suite_at_1mib_on_card(codec, tmp_path, cuda_device):
    import json

    from bitar_tpu_torch.cli import demo

    out = tmp_path / "skewed.json"
    assert demo.main(["--mode", "skewed", "--block-size", str(1 << 20), "--blocks", "256",
                      "--codec", codec, "--output", str(out)]) == 0
    stats = json.loads(out.read_text())
    assert stats["blocks"] == 256 and stats["device_GBps"] > 0
    assert stats["lat_p50_ms"] <= stats["lat_p99_ms"]


def test_configs_bench_config2_at_1gib_on_card(tmp_path, cuda_device):
    import json

    from bitar_tpu_torch.cli import configs_bench

    out = tmp_path / "configs.json"
    assert configs_bench.main(["--configs", "2", "--gib", "1", "--out", str(out)]) == 0
    (run,) = json.loads(out.read_text())["runs"]
    assert run["bit_exact"] and run["decompress_GBps"] > 0


def test_bench_at_64_blocks_on_card(monkeypatch, capsys, cuda_device):
    import json
    import math

    from bitar_tpu_torch.cli import bench

    monkeypatch.setenv("BENCH_NBLOCKS", "64")
    monkeypatch.setenv("BENCH_REPS", "8")
    assert bench.main(["--device", "cuda"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tuple(line) == bench.KEYS
    for key, v in line.items():
        if key not in ("metric", "unit"):
            assert isinstance(v, (int, float)) and math.isfinite(v), (key, v)
            assert v > 0 or (v == 0 and key in bench.MAY_READ_ZERO), (key, v)


def test_multihost_bench_two_ranks_on_card(tmp_path, cuda_device):
    import json

    from bitar_tpu_torch.cli import multihost_bench

    out = tmp_path / "multihost.json"
    assert multihost_bench.main(["--launch", "2", "--blocks", "32", "--reps", "2",
                                 "--timeout", "300", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["multi"]["verified_blocks"] == 32 and art["single"]["verified_blocks"] == 16
    assert art["device"]["platform"] == "gpu"


def test_multihost_bench_phases_and_pinned_cores_on_card(tmp_path, cuda_device):
    import json

    from bitar_tpu_torch.cli import multihost_bench

    out = tmp_path / "multihost.json"
    assert multihost_bench.main(["--launch", "2", "--blocks", "32", "--reps", "2", "--phases",
                                 "--skew-bucket-log", "1", "--pin-cores", "--timeout", "300",
                                 "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["multi"]["verified_blocks"] == 32
    assert art["phase_attribution"]["multi_decode_ms"] > 0
    assert art["single"]["rank_cores"] == art["multi"]["rank_cores"][:1]


# ---------------------------------------------------------------------------
# The device matchers and B7 at 256 KiB to 1 MiB: B3 (any window), the
# emitter and the parse at 1 MiB, B4 / B5 / B6 through their own entry
# points, B7's device-memory route, and the engine's 1 MiB matcher paths.


@pytest.mark.parametrize("fmt,wcap,L,min_match", [("lz4", 8, 256 * 1024, 6),
                                                  ("lz4", None, 256 * 1024, 64),
                                                  ("lz4", 8, 1 << 20, 6),
                                                  ("lz4", None, 1 << 20, 64),
                                                  ("snappy", 8, 1 << 20, 6)])
def test_emit_kernel_on_large_edge_layouts(fmt, wcap, L, min_match, cuda_device):
    # Whole rows equal the plain version's at widths that cut rows, hold
    # every row, and the LZ4 bound of the block (the width the XLA emitter
    # of the reference stands for); the plain version a few rows at a time.
    planes, lengths, lay = temit.edge_layouts(L, fmt=fmt, wcap=wcap, min_match=min_match, n=8)
    planes, lengths = (torch.from_numpy(a).to(cuda_device) for a in (planes, lengths))
    layout = {k: torch.from_numpy(v).to(cuda_device) for k, v in lay.items()}
    widths = (256, 98304) if fmt == "snappy" else (128, 98304, -(-tdc.lz4_bound(L) // 128) * 128)
    for ow in widths:
        got = temit.emit_blocks(planes, layout, out_width=ow, fmt=fmt, lengths=lengths)
        torch.cuda.synchronize()
        for r in range(0, 8, 2):
            rows = {k: v[r:r + 2] for k, v in layout.items()}
            assert torch.equal(got[r:r + 2], temit.emit_reference(
                planes[r:r + 2], rows, out_width=ow, fmt=fmt, lengths=lengths[r:r + 2])), (ow, r)


def test_match_offsets_parse_and_emit_at_1mib(cuda_device):
    # The engine's match_offsets path at 1 MiB: B3 values at max_match 1024,
    # the parse with the worst-case budget (min_match 64: 17,409 slots) and
    # the emitter at the engine's width, against the plain versions.
    planes, lengths = corpus_planes(cuda_device, 1 << 20, n=16)
    offsets = tmatch.DEFAULT_OFFSETS
    layout = tdc.match_parse_device(planes, lengths, min_match=64, offsets=offsets)
    mlen, moff = tmatch.match_reference(planes, offsets, max_match=1024, emit_values=True)
    want = tdc.parse_and_size(mlen, moff, lengths, seg=1024, min_match=64, length=1 << 20,
                              wcap=None)
    for k in want:
        assert torch.equal(layout[k], want[k]), k
    sizes = layout["total"].cpu().numpy()
    ow = tdc.engine_width(sizes, lengths.cpu().numpy(), 1 << 20)
    got = temit.emit_blocks(planes, layout, out_width=ow, lengths=lengths)
    torch.cuda.synchronize()
    for r in range(0, 16, 4):
        rows = {k: v[r:r + 4] for k, v in layout.items()}
        assert torch.equal(got[r:r + 4], temit.emit_reference(planes[r:r + 4], rows,
                                                              out_width=ow, lengths=lengths[r:r + 4]))
    assert assert_rows_decode("lz4", got, layout["total"], planes, lengths) > 0


@pytest.mark.parametrize("max_match", [64, 2047])
def test_match_dyn_kernel_at_1mib(max_match, cuda_device):
    # Explicit offsets up to L - 128 (edge_batch's kinds at 1 MiB).
    planes, noff, offs, _ = edge_tensors(cuda_device, 1 << 20, n=12)
    moff = dyn_equals_plain(planes, noff, offs, max_match)
    assert (moff[4] == (1 << 20) - 128).any()


@pytest.mark.parametrize("seg,max_match", [(8192, 1024), (16384, 2047)])
def test_match_walk_kernel_at_1mib(seg, max_match, cuda_device):
    # nseg 128 and 64: the segment counts B5 takes at 1 MiB.
    batch = edge_tensors(cuda_device, 1 << 20, n=12)
    P = walk_equals_plain(*batch, seg, max_match)[0]
    assert (P[0] == -1).all() and (P[5] >= 0).any()


@pytest.mark.parametrize("wcap", [0, 8])
def test_parse_walk_kernel_at_1mib(wcap, cuda_device):
    wm, wo, wl = (torch.from_numpy(a).to(cuda_device) for a in tmd.walk_edge_batch(8192, 128))
    got = tmd.parse_walk_dyn(wm, wo, wl, seg=8192, min_match=6, wcap=wcap)
    torch.cuda.synchronize()
    want = tmd.parse_walk_reference(wm, wo, wl, seg=8192, min_match=6, wcap=wcap)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("corpus,block,max_passes", [("text", 256 * 1024, 256),
                                                     ("text", 1 << 20, 256),
                                                     ("bench", 1 << 20, 64),
                                                     ("text", 1152 * 128, 512),
                                                     ("bench", 5120 * 128, 64)])
def test_decode_planned_device_memory_route_on_planner_plans(corpus, block, max_passes,
                                                             cuda_device):
    # The tall route on planner plans: every block its raw bytes, the slices'
    # stops those of slice_stops (at least the planner's p0).
    from bitar_tpu_torch.ops import decode_planned as tdp

    data = (make_text_corpus if corpus == "text" else make_corpus)(-(-4 * block // (128 * 1024)))
    datas = [data[i * block:(i + 1) * block] for i in range(4)]
    wire = tdp.plan_blocks(datas, block, max_passes)
    assert wire["fit"] == [0, 1, 2, 3]
    args = [torch.from_numpy(wire[k]).to(cuda_device) for k in ("comp", "p_used", "se", "shift")]
    kw = dict(passes=wire["passes"], comp_rows=wire["comp_rows"], out_rows=block // 128)
    stops = torch.empty((4, tdp.cluster_ctas(block // 128)), dtype=torch.int32,
                        device=cuda_device)
    before = tdp.gmem_launches
    got = tdp.decode_blocks_planned(*args, stops=stops, **kw)
    torch.cuda.synchronize()
    assert tdp.gmem_launches == before + 1
    assert [g.tobytes() for g in got.reshape(4, -1).cpu().numpy()] == datas
    assert torch.equal(got, tdp.decode_planned_reference(*args, **kw))
    assert torch.equal(stops, tdp.slice_stops(*args[2:], args[1], **kw))
    assert (stops.min(1).values.cpu().numpy() >= wire["p0"]).all()


@pytest.mark.parametrize("out_rows", [1152, 2048, 5120, 8192])
def test_decode_planned_device_memory_route_on_random_and_class_plans(out_rows, cuda_device):
    # Random malformed plans, pass-class plans, and batches whose blocks are
    # all quiet (no plane-reading pass), all take a cluster, or both.
    from bitar_tpu_torch.ops import decode_planned as tdp

    def check(plans, passes, comp_rows, what):
        plans = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device) for a in plans]
        kw = dict(passes=passes, comp_rows=comp_rows, out_rows=out_rows)
        stops = torch.empty((plans[0].shape[0], tdp.cluster_ctas(out_rows)), dtype=torch.int32,
                            device=cuda_device)
        got = tdp.decode_blocks_planned(*plans, stops=stops, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, tdp.decode_planned_reference(*plans, **kw)), what
        assert torch.equal(stops, tdp.slice_stops(*plans[2:], plans[1], **kw)), what
        return stops.min(1).values.cpu() < plans[1].clamp(0, passes).cpu()

    check(tdp.random_plans(17, 8, 5, 1024, out_rows), 5, 1024, "random")
    for reads in ([False] * 4, [True, False, False], [False, True, False, True, True]):
        check(tdp.class_plans(18, 8, reads, 512, out_rows), len(reads), 512, reads)
    quiet = tdp.class_plans(19, 6, [False] * 4, 512, out_rows)
    busy = list(tdp.class_plans(20, 6, [False, True, False, True], 512, out_rows))
    busy[1] = np.full(6, 4, np.int32)
    assert not check(quiet, 4, 512, "quiet").any()
    assert check(busy, 4, 512, "every block a cluster").all()
    mixed = [np.concatenate([q, b])[[0, 6, 1, 7, 2, 8, 3, 9, 4, 10, 5, 11]]
             for q, b in zip(quiet, busy)]
    assert check(mixed, 4, 512, "mixed").tolist() == [False, True] * 6
    assert all(int(q.abs().sum()) == 0 for q in block_queues.values())


@pytest.mark.parametrize("kw", [dict(compress_matcher="tpu"),
                                dict(compress_matcher="tpu", codec=btt.Codec.SNAPPY),
                                dict(compress_matcher="tpu-sort"),
                                dict(compress_matcher="device",
                                     match_offsets=tmatch.DEFAULT_OFFSETS, min_match=64)],
                         ids=["tpu-lz4", "tpu-snappy", "tpu-sort", "device-match-offsets"])
def test_engine_matchers_at_1mib(kw, cuda_device):
    # 32 x 1 MiB of the bench corpus round trip with no block on the host,
    # and 4 blocks' containers equal the CPU engine's.
    block = 1 << 20
    data = make_corpus(256)
    cfg = btt.EngineConfig(block_size=block, burst_size=32, max_pool_slots=64,
                           commit="deferred", **kw)
    with btt.Engine(cfg, device=cuda_device) as eng:
        unit = eng.compress(data)
        assert eng.decompress(unit).tobytes() == data
        assert unit.plan_flat["host_blocks"].size == 0
        assert unit.manifest.ratio() > 1.2
        mine = eng.compress(data[:4 * block]).to_host().to_bytes()
    with btt.Engine(cfg, device="cpu") as ref:
        assert ref.compress(data[:4 * block]).to_host().to_bytes() == mine


def _b1_launch(cuda_device, nblocks: int):
    """The engine's whole-unit B1 launch over ``nblocks`` x 128 KiB of the
    text corpus (deep out-pass plans: the device, not the host, paces it)."""
    data = make_text_corpus(nblocks)
    cfg = btt.EngineConfig(block_size=128 * 1024, burst_size=nblocks,
                           max_pool_slots=nblocks + 32, commit="deferred")
    eng = btt.Engine(cfg, device=cuda_device).initialize()
    unit = eng.compress(data)
    launch = eng.prepare_device_decode(unit)
    assert launch().reshape(-1).cpu().numpy().tobytes() == data
    return eng, launch


def test_held_time_of_b1_agrees_with_its_event_time(cuda_device):
    # 200 launches back to back: the held time and the CUDA events over
    # them both time the device running B1, within 10%.
    from bitar_tpu_torch.utils import timing

    eng, launch = _b1_launch(cuda_device, 256)
    before = tflat.launches
    held = timing.kernel_time_ms(launch, 200, lambda: tflat.launches)
    assert tflat.launches - before == 201             # the warm-up call and 200 held
    events = timing.device_time_ms(launch, 200)
    assert abs(held - events) <= 0.1 * events, (held, events)
    eng.release()


def test_held_timer_raises_on_a_call_that_synchronizes(cuda_device):
    # A synchronize inside the held window waits on the hold, which gives
    # up after HOLD_TIMEOUT_S: the timer raises, naming the function, and
    # the next held reading works.
    import time

    from bitar_tpu_torch.utils import timing

    eng, launch = _b1_launch(cuda_device, 8)

    def synchronizing_launch():
        out = launch()
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    with pytest.raises(btt.StatusError, match="hold gave up.*synchronizing_launch"):
        timing.kernel_time_ms(synchronizing_launch, 4, lambda: tflat.launches)
    assert time.perf_counter() - t0 < timing.HOLD_TIMEOUT_S + 3.0
    assert timing.kernel_time_ms(launch, 4, lambda: tflat.launches) > 0
    eng.release()


# ---------------------------------------------------------------------------
# The multi-card path: an NCCL world of four ranks, one card each, and the
# Driver's engine on every card in one process.  Each test counts the cards
# it needs inside itself and skips below that count.


def need_cards(n: int) -> None:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        pytest.skip(f"needs {n} CUDA devices, one a rank or engine; {have} visible")


def test_nccl_world_of_four_runs_every_step_on_its_own_card():
    need_cards(4)
    from bitar_tpu_torch.parallel import dryrun

    res = dryrun.run_world(4, dryrun.steps_program,
                           {"corpus": "bench", "nblocks": 32, "block": 128 * 1024,
                            "steps": dryrun.ALL_STEPS, "overlap": True},
                           backend="nccl", timeout=240.0)
    for rank, r in enumerate(res):
        assert all(r[step]["exact"] for step in dryrun.ALL_STEPS), rank
        assert r["ring_equals_flat"] and r["backend"] == "nccl"
        assert r["device"] == f"cuda:{rank}" and r["contexts"] == [rank]
        assert set(r["device_launches"]["decode_flat"]) == {rank}
        assert set(r["device_launches"]["decode_tables"]) == {rank}
        timeline = r["ring"]["timeline"]
        assert len(timeline["decode_spans_ms"]) == 4 and timeline["exchange_ms"] > 0
    assert sum(r["flat"]["live"] for r in res) == 32


def test_nccl_world_refuses_more_ranks_than_cards(cuda_device):
    from bitar_tpu_torch.parallel import dryrun

    n = torch.cuda.device_count() + 1
    with pytest.raises(btt.StatusError, match=f"NCCL world of {n} needs {n} CUDA devices"):
        dryrun.run_world(n, dryrun.steps_program, {"nblocks": 2 * n, "block": 16 * 1024},
                         backend="nccl", timeout=60.0)


def test_an_engine_on_each_card_round_trips_on_it():
    # The Driver's engines, one a card; each compresses and decodes from a
    # stream's worker thread (whose current device is cuda:0), and its
    # arena, device decode and B1 launches stay on its card.  An engine
    # made with plain "cuda" under another current card stays on that card.
    need_cards(2)
    n = torch.cuda.device_count()
    cfg = btt.EngineConfig(codec=btt.Codec.LZ4, block_size=128 * 1024, burst_size=64,
                           max_pool_slots=96, commit="deferred")
    engines = btt.Driver.instance().get_engines(cfg)
    with torch.cuda.device(n - 1):
        engines.append(btt.Engine(cfg, device="cuda").initialize())
    assert [e.device.index for e in engines] == [*range(n), n - 1]
    data = make_corpus(16)
    for k, eng in enumerate(engines):
        before = tflat.device_launches.copy()
        (stream,) = btt.make_streams([eng], 1)
        units = {}

        def keep(s, result):
            units["unit"] = result.value_or_raise()
            return btt.ASYNC_RETURN_OK

        assert stream.compress_async(btt.CompressParam(eng, data, keep)).ok()
        assert stream.wait() == btt.ASYNC_RETURN_OK
        unit = units["unit"]
        eng.ensure_plans(unit)
        got = eng.prepare_device_decode(unit)()
        assert eng.arena._buf.device == eng.device and got.device == eng.device
        assert got.reshape(-1).cpu().numpy().tobytes() == data
        assert stream.decompress_async(btt.DecompressParam(eng, unit, result_callback=keep)).ok()
        assert stream.wait() == btt.ASYNC_RETURN_OK
        assert units["unit"].tobytes() == data
        assert set(tflat.device_launches - before) == {eng.device.index}, k
        assert eng.stats.host_decode_bursts == 0
        stream.close()
        eng.recycle(unit)
        eng.release()


def test_async_suite_over_four_engines(capsys):
    need_cards(4)
    from bitar_tpu_torch.cli import demo

    cfg = btt.EngineConfig(codec=btt.Codec.LZ4, block_size=128 * 1024, burst_size=64,
                           max_pool_slots=96, commit="deferred")
    engines = btt.Driver.instance().get_engines(cfg, device_ids=[0, 1, 2, 3])
    before = tflat.device_launches.copy()
    demo.evaluate_async(engines, make_corpus(64), 8)
    assert "async verify OK (8 segments bit-exact)" in capsys.readouterr().out
    assert set(tflat.device_launches - before) == {0, 1, 2, 3}
    assert all(e.stats.host_decode_bursts == 0 for e in engines)
    for e in engines:
        e.release()
