"""The port's Engine against the JAX engine, on the CPU.

Both engines get the same config and data (made from a numpy seed).  They
must produce the same compressed container bytes and the same flat plan or
sequence tables, key by key; the port must decode bit-exactly and report
the same per-block status as the reference after a slot is corrupted.  Also
here: Zstd units, batched decode, streams and the driver.  The JAX engine
runs its Pallas kernels in interpret mode; the port runs its plain PyTorch
versions on CPU tensors.  Tolerance 0 throughout.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitar_tpu as bt
import bitar_tpu_torch as btt
from bitar_tpu.engine.device import prepare_batched_decode as jax_batched
from bitar_tpu_torch.engine import device as device_mod
from bitar_tpu_torch.interop import SCRATCH_PLAN_KEYS, TPU_ONLY_PLAN_KEYS
from bitar_tpu_torch.ops.cpu.native import SEQUENCE_KEYS

# Test files run in several worker processes at once: a single intra-op
# thread keeps torch's CPU pool from oversubscribing the cores (the
# tensors here are small).
torch.set_num_threads(1)

BLOCK = 16 * 1024
ROOT = Path(__file__).resolve().parent.parent
CODECS = {"lz4": (bt.Codec.LZ4, btt.Codec.LZ4), "snappy": (bt.Codec.SNAPPY, btt.Codec.SNAPPY)}


def make_data(seed: int = 31) -> bytes:
    """Six blocks plus a ragged tail: text, low-entropy, random, RLE,
    markdown (scheduled out passes) and a repeated record stream."""
    rng = np.random.default_rng(seed)
    rec = np.zeros((BLOCK // 16 + 1, 16), np.uint8)
    rec[:, 0] = np.arange(rec.shape[0]) & 0xFF
    parts = [(b"engine parity payload " * (BLOCK // 22 + 1))[:BLOCK],
             rng.integers(0, 16, BLOCK, dtype=np.uint8).tobytes(),
             rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes(),
             b"\x5a" * BLOCK,
             (ROOT / "SURVEY.md").read_bytes()[:BLOCK],
             rec.tobytes()[:BLOCK],
             b"tail " * 150]
    return b"".join(parts)


def cfg_kw(**kw):
    base = dict(block_size=BLOCK, burst_size=4, max_pool_slots=32, min_match=4)
    base.update(kw)
    return base


def engines(codec: str, checksum: str = "none", **kw):
    """A JAX engine and a port engine with the same config (each package's
    own enums)."""
    jc, tc = CODECS[codec]
    jax_eng = bt.Engine(bt.EngineConfig(
        codec=jc, checksum=bt.Checksum(checksum), interpret=True, **cfg_kw(**kw))).initialize()
    port = btt.Engine(btt.EngineConfig(
        codec=tc, checksum=btt.Checksum(checksum), **cfg_kw(**kw)), device="cpu").initialize()
    return jax_eng, port


@pytest.mark.parametrize("commit", ["eager", "deferred"])
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_engine_parity(codec, commit):
    data = make_data()
    jax_eng, port = engines(codec, commit=commit)
    ju, tu = jax_eng.compress(data), port.compress(data)
    assert tu.to_host().to_bytes() == ju.to_host().to_bytes()
    jax_eng.ensure_plans(ju)
    port.ensure_plans(tu)
    assert tu.plan_comp_rows == ju.plan_comp_rows
    want = {k: v for k, v in ju.plan_flat.items()
            if k not in TPU_ONLY_PLAN_KEYS + SCRATCH_PLAN_KEYS}
    assert tu.plan_flat.keys() - set(SCRATCH_PLAN_KEYS) == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(tu.plan_flat[k], v, err_msg=k)
    assert (tu.plan_flat["p_used"] > tu.plan_flat["p0"]).any(), "expected out passes"
    assert (tu.plan_flat["dense"] < 0).any(), "expected RAW blocks"
    # The tables of a planned unit, built on request from its arena slots.
    jax_eng.ensure_tables(ju)
    port.ensure_tables(tu)
    assert_tables_equal(tu, ju)
    assert port.decompress(tu).tobytes() == data
    assert port.stats.device_decode_bursts == 2 and port.stats.host_decode_bursts == 0
    assert port.recycle(tu) == tu.nblocks
    jax_eng.recycle(ju)
    jax_eng.release()
    port.release()


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_status_parity_after_corrupting_a_slot(codec):
    # After plans exist, garbage lands in block 1's slot: both engines
    # decode the same bytes from it, and the CRC32 check fails exactly it.
    data = make_data(32)
    jax_eng, port = engines(codec, checksum="crc32")
    ju, tu = jax_eng.compress(data), port.compress(data)
    jax_eng.ensure_plans(ju)
    port.ensure_plans(tu)
    garbage = np.random.default_rng(33).integers(0, 256, (1, 4096), dtype=np.uint8)
    jax_eng.arena.write_burst([ju.refs[1].slot], jnp.asarray(garbage))
    port.arena.write_burst([tu.refs[1].slot], garbage)
    jout, jst = jax_eng.decompress_status(ju)
    tout, tst = port.decompress_status(tu)
    np.testing.assert_array_equal(tst, jst)
    assert np.flatnonzero(tst < 0).tolist() == [1]
    np.testing.assert_array_equal(tout, jout)
    assert port.error_count() == jax_eng.error_count() == 1
    jax_eng.release()
    port.release()


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_host_block_status_parity(codec):
    # Corrupt block 0's staged bytes before planning: the planner rejects
    # it, both engines decode it on the host and report the same status.
    data = make_data(34)
    jax_eng, port = engines(codec, commit="deferred", plan_build="lazy")
    ju, tu = jax_eng.compress(data), port.compress(data)
    for unit in (ju, tu):
        unit._staging[0, :32] = 0xFF
    jout, jst = jax_eng.decompress_status(ju)
    tout, tst = port.decompress_status(tu)
    np.testing.assert_array_equal(tu.plan_flat["host_blocks"], ju.plan_flat["host_blocks"])
    assert tu.plan_flat["host_blocks"].tolist() == [0]
    np.testing.assert_array_equal(tst, jst)
    assert tst[0] < 0 and (tst[1:] == 0).all()
    good = np.ones(len(data), bool)
    m = tu.manifest
    good[:int(m.raw_len[0])] = False
    assert tout[good].tobytes() == np.frombuffer(data, np.uint8)[good].tobytes()
    jax_eng.release()
    port.release()


def assert_tables_equal(tu, ju):
    assert tu.tables.keys() == ju.tables.keys() == set(SEQUENCE_KEYS)
    for k in SEQUENCE_KEYS:
        np.testing.assert_array_equal(tu.tables[k], ju.tables[k], err_msg=k)
    np.testing.assert_array_equal(tu.nseq, ju.nseq)


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_unit_over_plan_budget_is_not_implemented(codec):
    # Markdown blocks under an 8-pass budget: the planner rejects every
    # block as over budget, and both engines decode the unit on the device
    # through the sequence-table path (kernel B2).  Only
    # prepare_device_decode, which wants a plan, refuses it, in both.
    data = (ROOT / "SURVEY.md").read_bytes()[:3 * BLOCK]
    jax_eng, port = engines(codec, commit="deferred", plan_build="lazy")
    jax_eng._PLAN_MAX_PASSES = port._PLAN_MAX_PASSES = 8
    ju, tu = jax_eng.compress(data), port.compress(data)
    jax_eng.ensure_plans(ju)
    port.ensure_plans(tu)
    assert ju.plan_flat is None and tu.plan_flat is None
    assert_tables_equal(tu, ju)
    jout, jst = jax_eng.decompress_status(ju)
    tout, tst = port.decompress_status(tu)
    np.testing.assert_array_equal(tst, jst)
    assert tout.tobytes() == jout.tobytes() == data
    planes = torch.cat(port.decompress_device(tu)).reshape(tu.nblocks, -1)
    assert b"".join(planes[i, :int(n)].numpy().tobytes()
                    for i, n in enumerate(tu.manifest.raw_len)) == data
    for eng, unit in ((jax_eng, ju), (port, tu)):
        with pytest.raises((bt.StatusError, btt.StatusError)) as ei:
            eng.prepare_device_decode(unit)
        assert ei.value.status.code.value == btt.StatusCode.NOT_IMPLEMENTED.value
    assert port.stats.host_decode_bursts == 0 and port.stats.device_decode_bursts == 2
    assert port.recycle(tu) == tu.nblocks
    jax_eng.release()
    port.release()


def table_data(block: int, seed: int) -> bytes:
    """Markdown, low-entropy, random (stored RAW) and RLE blocks, a tail."""
    rng = np.random.default_rng(seed)
    src = (ROOT / "SURVEY.md").read_bytes()
    return (src[:2 * block] + rng.integers(0, 8, block, np.uint8).tobytes()
            + rng.integers(0, 256, block, np.uint8).tobytes() + b"\x33" * block
            + b"tail " * (block // 13))


@pytest.mark.parametrize("block", [1024, 4096])
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_table_path_parity(codec, block):
    # Blocks narrower than 128 rows never plan: both engines decode them on
    # the device from sequence tables.
    data = table_data(block, 41)
    jax_eng, port = engines(codec, block_size=block, commit="deferred")
    ju, tu = jax_eng.compress(data), port.compress(data)
    assert tu.to_host().to_bytes() == ju.to_host().to_bytes()
    jax_eng.ensure_plans(ju)
    port.ensure_plans(tu)
    assert tu.plan_flat is None and tu.plan_comp_rows == ju.plan_comp_rows
    assert_tables_equal(tu, ju)
    assert (tu.manifest.codec_ids == btt.manifest.codec_id(btt.Codec.RAW)).any()
    jout, jst = jax_eng.decompress_status(ju)
    tout, tst = port.decompress_status(tu)
    np.testing.assert_array_equal(tst, jst)
    assert tout.tobytes() == jout.tobytes() == data
    assert port.stats.device_decode_bursts == -(-tu.nblocks // 4)
    assert port.stats.host_decode_bursts == 0
    jax_eng.release()
    port.release()


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_table_status_after_rewriting_a_slot(codec):
    # The tables exist; then block 1's slot is rewritten with a block that
    # decodes to another size.  Both engines run the old tables over the new
    # bytes (the same bytes out) and their framing walks name block 1 only.
    # A second decompress walks no slot again: the generations are unchanged.
    block = 1024
    data = table_data(block, 42)
    jax_eng, port = engines(codec, block_size=block)
    ju, tu = jax_eng.compress(data), port.compress(data)
    jax_eng.ensure_plans(ju)
    port.ensure_plans(tu)
    jax_eng.decompress_status(ju)
    port.decompress_status(tu)
    other = ju.to_host()
    short = np.frombuffer(other.packed[:int(other.manifest.comp_len[0])], np.uint8).copy()
    short[:1] = 0x10                     # one literal, then the old block's bytes
    row = np.zeros((1, 256), np.uint8)
    row[0, :short.size] = short[:256]
    jax_eng.arena.write_burst([ju.refs[1].slot], jnp.asarray(row))
    port.arena.write_burst([tu.refs[1].slot], row)
    jout, jst = jax_eng.decompress_status(ju)
    tout, tst = port.decompress_status(tu)
    np.testing.assert_array_equal(tst, jst)
    assert np.flatnonzero(tst < 0).tolist() == [1]
    np.testing.assert_array_equal(tout, jout)
    gens = tu._val_gen.copy()
    _, again = port.decompress_status(tu)
    np.testing.assert_array_equal(again, tst)
    np.testing.assert_array_equal(tu._val_gen, gens)
    jax_eng.release()
    port.release()


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_malformed_unit_with_no_plannable_block_decodes_on_host(codec):
    # Every block's staged bytes are corrupted before planning: the JAX
    # engine's sequence tables fail too, so it decodes the unit on the
    # host; the port does the same and reports the same per-block status.
    data = (b"unplannable unit payload " * (3 * BLOCK // 25 + 1))[:3 * BLOCK]
    jax_eng, port = engines(codec, commit="deferred", plan_build="lazy")
    ju, tu = jax_eng.compress(data), port.compress(data)
    for unit in (ju, tu):
        unit._staging[:, :32] = 0xFF
    jout, jst = jax_eng.decompress_status(ju)
    assert ju.plan_flat is None and ju.tables is None
    tout, tst = port.decompress_status(tu)
    assert tu.plan_flat is None and tu.tables is None
    assert port.stats.host_decode_bursts == 1 and port.stats.device_decode_bursts == 0
    np.testing.assert_array_equal(tst, jst)
    assert (tst < 0).all()
    jax_eng.release()
    port.release()


def test_device_paths_on_cpu():
    data = make_data(35)
    with btt.Engine(btt.EngineConfig(**cfg_kw(commit="deferred")), device="cpu") as eng:
        unit = eng.compress(data)
        bursts = eng.decompress_device(unit)
        assert [b.shape[0] for b in bursts] == [4, 3]
        planes = torch.cat(bursts).reshape(unit.nblocks, -1)
        launch = eng.prepare_device_decode(unit)
        assert torch.equal(launch().reshape(unit.nblocks, -1), planes)
        got = b"".join(planes[i, :int(n)].numpy().tobytes()
                       for i, n in enumerate(unit.manifest.raw_len))
        assert got == data
        eng.recycle(unit)


def test_export_import_roundtrip():
    data = make_data(36)
    with btt.Engine(btt.EngineConfig(**cfg_kw()), device="cpu") as eng:
        unit = eng.compress(data)
        blob = unit.to_host().to_bytes()
        eng.recycle(unit)
        unit2 = eng.import_unit(btt.CompressedBuffers.from_bytes(blob))
        assert eng.decompress(unit2).tobytes() == data
        eng.recycle(unit2)


@pytest.mark.parametrize("codec", ["lz4", "snappy", "zstd", "raw"])
def test_host_codec_path(codec):
    rng = np.random.default_rng(37)
    data = (b"host path " * 300)[:3000] + rng.integers(0, 256, 2000, np.uint8).tobytes()
    cfg = btt.EngineConfig(codec=btt.Codec(codec), block_size=1024, burst_size=8,
                           max_pool_slots=64, use_tpu_kernels=False)
    with btt.Engine(cfg, device="cpu") as eng:
        unit = eng.compress(data)
        assert eng.decompress(unit).tobytes() == data
        eng.recycle(unit)


def test_zstd_device_decode_is_not_implemented():
    # Zstd units decode on the device: the planner entropy-decodes each Zstd
    # block's literals into a plane, and the flat kernel runs its sequences
    # from there.  The random block is stored RAW: a mixed Zstd/RAW unit.
    data = make_data(38)
    jc = bt.EngineConfig(**cfg_kw(), codec=bt.Codec.ZSTD, interpret=True)
    tc = btt.EngineConfig(**cfg_kw(), codec=btt.Codec.ZSTD)
    with bt.Engine(jc) as jax_eng, btt.Engine(tc, device="cpu") as port:
        ju, tu = jax_eng.compress(data), port.compress(data)
        assert tu.to_host().to_bytes() == ju.to_host().to_bytes()
        jax_eng.ensure_plans(ju)
        port.ensure_plans(tu)
        assert tu.plan_comp_rows == ju.plan_comp_rows
        want = {k: v for k, v in ju.plan_flat.items()
                if k not in TPU_ONLY_PLAN_KEYS + SCRATCH_PLAN_KEYS and k != "lit_planes"}
        for k, v in want.items():
            np.testing.assert_array_equal(tu.plan_flat[k], v, err_msg=k)
        jl, tl = ju.plan_flat["lit_planes"], tu.plan_flat["lit_planes"]
        assert sorted(tl) == sorted(jl) and len(tl) >= 4
        for i in jl:
            np.testing.assert_array_equal(tl[i], jl[i], err_msg=f"literal plane {i}")
        ids = tu.manifest.codec_ids
        assert (ids == btt.manifest.codec_id(btt.Codec.RAW)).any()
        assert (ids == btt.manifest.codec_id(btt.Codec.ZSTD)).any()
        jout, jst = jax_eng.decompress_status(ju)
        tout, tst = port.decompress_status(tu)
        np.testing.assert_array_equal(tst, jst)
        assert tout.tobytes() == jout.tobytes() == data
        assert port.stats.host_decode_bursts == 0
        launch = port.prepare_device_decode(tu)
        got = launch().reshape(tu.nblocks, -1)
        assert b"".join(got[i, :int(n)].numpy().tobytes()
                        for i, n in enumerate(tu.manifest.raw_len)) == data


def test_cuda_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the engine starts")
    with pytest.raises(btt.StatusError):
        btt.Engine(btt.EngineConfig(**cfg_kw()))
    with pytest.raises(btt.StatusError):
        btt.Engine(btt.EngineConfig(**cfg_kw()), device="cuda")


@pytest.mark.parametrize("kw", [dict(compress_matcher="tpu"), dict(block_size=4096)])
def test_unported_paths_are_named(kw):
    # Two configs the port once refused at initialize: both start now and
    # give the reference's container and bytes.
    data = make_data(40)[:5 * 4096]
    jax_eng, port = engines("lz4", **kw)
    ju, tu = jax_eng.compress(data), port.compress(data)
    assert tu.to_host().to_bytes() == ju.to_host().to_bytes()
    assert port.decompress(tu).tobytes() == jax_eng.decompress(ju).tobytes() == data
    assert port.stats.host_decode_bursts == 0
    jax_eng.release()
    port.release()


def batched_items(pkg, seed_base: int = 40):
    """The units of prepare_batched_decode's reference test: LZ4, Zstd and
    Snappy engines of one package, five 16 KiB blocks each."""
    items, datas = [], []
    for s_i, codec in enumerate(["lz4", "zstd", "snappy"]):
        extra = {"interpret": True} if pkg is bt else {}
        cfg = pkg.EngineConfig(codec=pkg.Codec(codec), block_size=BLOCK, burst_size=16,
                               max_pool_slots=64, commit="deferred", **extra)
        eng = pkg.Engine(cfg, device="cpu") if pkg is btt else pkg.Engine(cfg)
        eng.initialize()
        rng = np.random.default_rng(seed_base + s_i)
        parts = []
        for i in range(5):
            k = i % 3
            if k == 0:
                parts.append(((b"stream %d " % s_i) * (BLOCK // 9 + 1))[:BLOCK])
            elif k == 1:
                parts.append(rng.integers(0, 8, BLOCK, np.uint8).tobytes())
            else:
                parts.append(rng.integers(0, 256, BLOCK, np.uint8).tobytes())
        d = b"".join(parts)
        items.append((eng, eng.compress(d)))
        datas.append(d)
    return items, datas


def test_batched_decode_parity():
    nrows = BLOCK // 128
    port_items, datas = batched_items(btt)
    jax_items, _ = batched_items(bt)
    launch, slices = btt.prepare_batched_decode(port_items)
    jlaunch, jslices = jax_batched(jax_items)
    assert slices == jslices == [(0, 5), (5, 10), (10, 15)]
    out = launch()
    assert out.shape == (15, nrows, 128)
    jout = np.asarray(jlaunch())[:, :nrows]
    np.testing.assert_array_equal(out.numpy(), jout)
    for (lo, hi), d in zip(slices, datas, strict=True):
        assert out[lo:hi].numpy().reshape(-1).tobytes() == d
    for items in (port_items, jax_items):
        for eng, unit in items:
            eng.recycle(unit)
            eng.release()


def test_batched_decode_refuses_table_units():
    with btt.Engine(btt.EngineConfig(**cfg_kw(block_size=4096)), device="cpu") as eng:
        unit = eng.compress(make_data(43)[:3 * 4096])
        with pytest.raises(btt.StatusError) as ei:
            btt.prepare_batched_decode([(eng, unit)])
        assert ei.value.status.code == btt.StatusCode.NOT_IMPLEMENTED
        with pytest.raises(btt.StatusError):
            btt.prepare_batched_decode([])


def test_streams_round_trip_on_two_engines():
    drv = btt.Driver.instance()
    assert drv is btt.Driver.instance()
    assert drv.describe("cpu")["device_class"] == "cpu-reference"
    cfg = btt.EngineConfig(**cfg_kw(block_size=4096, max_pool_slots=64))
    engs = drv.get_engines(cfg, device_ids=[0, 0], device_type="cpu")
    try:
        streams = btt.make_streams(engs, 4)
        assert [s.engine for s in streams] == [engs[0], engs[1], engs[0], engs[1]]
        data = make_data(44)
        segs = [data[i * len(data) // 4:(i + 1) * len(data) // 4] for i in range(4)]
        units, outs = {}, {}

        def keep(store, i):
            def cb(stream, result):
                store[i] = result.value()
                return btt.ASYNC_RETURN_OK + i            # the callback's return is harvested
            return cb

        for i, s in enumerate(streams):
            assert s.compress_async(btt.CompressParam(s.engine, segs[i], keep(units, i))).ok()
        assert btt.wait_all(streams) == [btt.ASYNC_RETURN_OK + i for i in range(4)]
        for i, s in enumerate(streams):
            assert s.decompress_async(btt.DecompressParam(s.engine, units[i],
                                                          result_callback=keep(outs, i))).ok()
        btt.wait_all(streams)
        for i in range(4):
            assert outs[i].tobytes() == segs[i]
            assert units[i].engine.recycle(units[i]) == units[i].nblocks
        for s in streams:
            s.close()
    finally:
        for e in engs:
            e.release()


def test_busy_stream_is_invalid_and_errors_reach_the_callback():
    import threading

    with btt.Engine(btt.EngineConfig(**cfg_kw()), device="cpu") as eng:
        stream = btt.Stream(engine=eng, stream_id=3)
        assert stream.wait() == 0 and not stream.busy()
        gate = threading.Event()
        st = stream.compress_async(btt.CompressParam(
            eng, b"a" * 5000, lambda s, r: gate.wait(10) and btt.ASYNC_RETURN_OK))
        assert st.ok()
        busy = stream.compress_async(btt.CompressParam(eng, b"b" * 100))
        assert busy.code == btt.StatusCode.INVALID and "busy" in busy.message
        gate.set()
        assert stream.wait() == btt.ASYNC_RETURN_OK
        gone = eng.compress(b"x" * 100)
        eng.recycle(gone)
        assert stream.decompress_async(btt.DecompressParam(eng, gone)).ok()
        assert stream.wait() == btt.Status.Invalid("").to_int()
        stream.close()


def test_state_machine():
    eng = btt.Engine(btt.EngineConfig(**cfg_kw()), device="cpu")
    with pytest.raises(btt.StatusError):      # not started
        eng.compress(b"x" * 100)
    eng.initialize()
    with pytest.raises(btt.StatusError):      # double init
        eng.initialize()
    unit = eng.compress(b"y" * 100)
    eng.recycle(unit)
    eng.release()
    assert eng.state == btt.EngineState.RELEASED
    with pytest.raises(btt.StatusError):      # released
        eng.compress(b"z" * 100)


def test_double_recycle_and_decode_after_recycle_rejected():
    with btt.Engine(btt.EngineConfig(**cfg_kw()), device="cpu") as eng:
        unit = eng.compress(b"w" * 500)
        eng.recycle(unit)
        with pytest.raises(btt.StatusError):
            eng.recycle(unit)
        with pytest.raises(btt.StatusError):
            eng.decompress(unit)


def test_cross_engine_unit_and_small_buffer_rejected():
    cfg = btt.EngineConfig(**cfg_kw())
    with btt.Engine(cfg, device="cpu") as e1, btt.Engine(cfg, device="cpu") as e2:
        unit = e1.compress(b"q" * 3000)
        with pytest.raises(btt.StatusError):
            e2.decompress(unit)
        with pytest.raises(btt.StatusError) as ei:
            e1.decompress(unit, out=np.zeros(10, np.uint8))
        assert ei.value.status.code == btt.StatusCode.CAPACITY_ERROR
        big = np.zeros(5000, np.uint8)
        assert e1.decompress(unit, out=big).tobytes() == b"q" * 3000
        e1.recycle(unit)


def test_pool_exhaustion_is_capacity_error():
    cfg = btt.EngineConfig(**cfg_kw(max_pool_slots=20))
    with btt.Engine(cfg, device="cpu") as eng:
        data = np.random.default_rng(39).integers(0, 256, 21 * BLOCK, np.uint8).tobytes()
        with pytest.raises(btt.StatusError) as ei:
            eng.compress(data)
        assert ei.value.status.code == btt.StatusCode.CAPACITY_ERROR
        assert eng.arena.pool.in_use() == 0


# ---------------------------------------------------------------------------
# Resident units read in place: the unit's slot table, and B1 reading the
# arena through it.  The CPU gathers by default; ``read_in_place_on_cpu``
# runs the in-place path through the plain version.


def read_in_place_on_cpu(monkeypatch):
    """Let engines on the CPU read resident units in place, as on the card."""
    monkeypatch.setattr(device_mod, "_reads_in_place", lambda device: True)


def planes_bytes(bursts, unit) -> bytes:
    planes = torch.cat(bursts).reshape(unit.nblocks, -1)
    return b"".join(planes[i, :int(n)].numpy().tobytes()
                    for i, n in enumerate(unit.manifest.raw_len))


def traced_decode(eng, unit):
    """``decompress_device`` under a CPU profiler: (bursts, counters)."""
    from bitar_tpu_torch.utils import profiling

    profiling.snapshot(reset=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        bursts = eng.decompress_device(unit)
    return bursts, profiling.snapshot(reset=True)


def test_slot_table_is_built_once_and_dropped_by_recycle():
    with btt.Engine(btt.EngineConfig(**cfg_kw()), device="cpu") as eng:
        unit = eng.compress(make_data(40))
        eng.decompress_device(unit)
        table = unit.slot_table()
        assert table.dtype == torch.int32 and table.is_contiguous()
        assert table.tolist() == [r.slot for r in unit.refs]
        host = unit.host_slot_table()
        assert host.dtype == np.int32 and host.tolist() == table.tolist()
        eng.decompress_device(unit)
        assert unit.slot_table() is table and unit.host_slot_table() is host
        eng.recycle(unit)
        assert unit._slots_dev is None and unit._slots_host is None


@pytest.mark.parametrize("read", ["gathered", "in place"])
@pytest.mark.parametrize("case", ["recycled slots", "deferred first call", "bursts"])
def test_resident_units_decode_in_place_or_gathered(case, read, monkeypatch):
    kw = {"deferred first call": dict(commit="deferred"),
          "bursts": dict(burst_size=3)}.get(case, {})
    if read == "in place":
        read_in_place_on_cpu(monkeypatch)
    with btt.Engine(btt.EngineConfig(**cfg_kw(**kw)), device="cpu") as eng:
        data = make_data(41)
        if case == "recycled slots":            # a unit decoded, recycled, its slots retaken
            old = eng.compress(make_data(42)[::-1])
            eng.decompress_device(old)
            old_slots = {r.slot for r in old.refs}
            eng.recycle(old)
        unit = eng.compress(data)
        if case == "recycled slots":
            assert {r.slot for r in unit.refs} & old_slots
        bursts, counted = traced_decode(eng, unit)
        assert len(bursts) == -(-unit.nblocks // eng.config.burst_size) > 1
        assert planes_bytes(bursts, unit) == data
        assert counted["decode_flat.blocks"] == unit.nblocks
        if read == "in place":
            assert counted["arena.inplace_blocks"] == unit.nblocks
            assert "arena.gather_bytes" not in counted
        else:
            assert "arena.inplace_blocks" not in counted
            assert counted["arena.gather_bytes"] == unit.nblocks * eng.config.slot_size
        assert eng.decompress(unit).tobytes() == data
        eng.recycle(unit)


def test_zstd_unit_with_literal_planes_gathers_where_others_read_in_place(monkeypatch):
    data = make_data(43)
    with btt.Engine(btt.EngineConfig(**cfg_kw(), codec=btt.Codec.ZSTD), device="cpu") as zeng, \
            btt.Engine(btt.EngineConfig(**cfg_kw()), device="cpu") as leng:
        read_in_place_on_cpu(monkeypatch)
        rows_calls = []
        for eng in (zeng, leng):
            unit_rows = eng._unit_rows
            monkeypatch.setattr(eng, "_unit_rows", lambda u, idx, f=unit_rows: (
                rows_calls.append(u.engine), f(u, idx))[1])
        zu, lu = zeng.compress(data), leng.compress(data)
        zeng.ensure_plans(zu)
        assert zu.plan_flat["lit_planes"]
        bursts, counted = traced_decode(zeng, zu)
        assert planes_bytes(bursts, zu) == data
        assert rows_calls == [zeng] * len(bursts) and "arena.inplace_blocks" not in counted
        bursts, counted = traced_decode(leng, lu)
        assert planes_bytes(bursts, lu) == data
        assert rows_calls == [zeng] * len(bursts)                 # the LZ4 unit gathered nothing
        assert counted["arena.inplace_blocks"] == lu.nblocks
        zeng.recycle(zu)
        leng.recycle(lu)
