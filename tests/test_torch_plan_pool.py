"""The port engine's process-wide plan memory and out-of-order readback,
beside the JAX engine, on the CPU at 128 KiB blocks.

The planner's chunk scratch (``Engine._PLAN_CHUNK_SCRATCH``) and the free
list of unit grants (``Engine._PLAN_FREE``) are shared by every engine in the
process, as in the JAX package.  Each test here empties both (under
``Engine._PLAN_LOCK``) and restores them after, so it neither sees nor
leaves another test's buffers.  Plans built through reused, dirty buffers
must equal the JAX engine's key for key; grants must come back on
``recycle``, also from a background build still pending; ``initialize``
prefaults only for device kernels with background builds; bursts read back
out of order must give the JAX engine's bytes and per-block status.  The
JAX engine runs its Pallas kernels in interpret mode.  Tolerance 0.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitar_tpu as bt
import bitar_tpu_torch as btt
from bitar_tpu_torch.interop import SCRATCH_PLAN_KEYS, TPU_ONLY_PLAN_KEYS
from bitar_tpu_torch.utils.corpus import BLOCK, make_corpus, make_text_corpus

torch.set_num_threads(1)

NBLOCKS = 8
NROWS = BLOCK // 128
CODECS = {"lz4": (bt.Codec.LZ4, btt.Codec.LZ4), "snappy": (bt.Codec.SNAPPY, btt.Codec.SNAPPY),
          "zstd": (bt.Codec.ZSTD, btt.Codec.ZSTD)}
SMALL = 16 * 1024             # the prefault tests' blocks
WAIT_S = 30                   # the longest any thread here waits for another


@pytest.fixture
def pool():
    """The process-wide plan pools, empty for the test and restored after."""
    eng = btt.Engine
    with eng._PLAN_LOCK:
        free, scratch = list(eng._PLAN_FREE), dict(eng._PLAN_CHUNK_SCRATCH)
        eng._PLAN_FREE.clear()
        eng._PLAN_CHUNK_SCRATCH.clear()
    try:
        yield eng
    finally:
        with eng._PLAN_LOCK:
            eng._PLAN_FREE[:] = free
            eng._PLAN_CHUNK_SCRATCH.clear()
            eng._PLAN_CHUNK_SCRATCH.update(scratch)


def port_engine(codec="lz4", **kw):
    kw = dict(block_size=BLOCK, burst_size=4, max_pool_slots=32, plan_build="lazy") | kw
    return btt.Engine(btt.EngineConfig(codec=CODECS[codec][1], **kw), device="cpu").initialize()


def jax_engine(codec="lz4", **kw):
    kw = dict(block_size=BLOCK, burst_size=4, max_pool_slots=32, plan_build="lazy") | kw
    return bt.Engine(bt.EngineConfig(codec=CODECS[codec][0], interpret=True, **kw)).initialize()


def container(codec: str, data: bytes, corrupt: tuple[int, ...] = (), **kw) -> bytes:
    """``data`` compressed by the JAX engine; the first stored byte of each
    block in ``corrupt`` flipped (a Zstd frame's magic, an LZ4 block's first
    token: the planner rejects the block)."""
    eng = jax_engine(codec, **kw)
    unit = eng.compress(data)
    cb = unit.to_host()
    for i in corrupt:
        cb.packed[int(cb.manifest.comp_off[i])] ^= 0xFF
    eng.recycle(unit)
    eng.release()
    return cb.to_bytes()


def jax_plans(blob: bytes):
    """The JAX engine's plan of the unit in ``blob``, and its comp rows."""
    eng = jax_engine()
    unit = eng.import_unit(bt.CompressedBuffers.from_bytes(blob))
    eng.ensure_plans(unit)
    plans, rows = unit.plan_flat, unit.plan_comp_rows
    eng.release()
    return plans, rows


def assert_plans_equal(unit, want: dict, want_rows: int) -> None:
    got = unit.plan_flat
    assert unit.plan_comp_rows == want_rows
    skip = TPU_ONLY_PLAN_KEYS + SCRATCH_PLAN_KEYS
    assert got.keys() - set(SCRATCH_PLAN_KEYS) == want.keys() - set(skip)
    for k in want.keys() - set(skip) - {"lit_planes"}:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jl, tl = want.get("lit_planes", {}), got.get("lit_planes", {})
    assert sorted(tl) == sorted(jl)
    for i in jl:
        np.testing.assert_array_equal(tl[i], jl[i], err_msg=f"literal plane {i}")


def blocks_of(data: bytes, idx) -> bytes:
    return b"".join(data[i * BLOCK:(i + 1) * BLOCK] for i in idx)


def test_plans_through_reused_dirty_buffers_equal_the_jax_engines(pool):
    # One port engine plans four units in turn, recycling each: markdown LZ4
    # (out passes, every block dense), then LZ4 with fewer dense blocks and
    # no out pass, Snappy, and Zstd with a host block (block 0's frame
    # magic flipped).  Every unit after the first is planned into the first
    # unit's grant and chunk scratch, left dirty by the units before it.
    corpus = make_corpus(2 * NBLOCKS)
    units = [("lz4", make_text_corpus(NBLOCKS), ()),
             ("lz4", blocks_of(corpus, [0, 1, 2, 3, 5, 6, 9, 10]), ()),
             ("snappy", corpus[:NBLOCKS * BLOCK], ()),
             ("zstd", corpus[NBLOCKS * BLOCK:], (0,))]
    port = port_engine()
    grant = scratch = None
    dense = []
    for codec, data, corrupt in units:
        blob = container(codec, data, corrupt)
        want, want_rows = jax_plans(blob)
        unit = port.import_unit(btt.CompressedBuffers.from_bytes(blob))
        port.ensure_plans(unit)
        assert_plans_equal(unit, want, want_rows)
        pf = unit.plan_flat
        assert pf["host_blocks"].tolist() == list(corrupt)
        dense.append(int((pf["dense"] > 0).sum()))
        if grant is None:
            grant, scratch = pf["_pooled"], pool._PLAN_CHUNK_SCRATCH[(0, NBLOCKS, NROWS)]
            assert (pf["p_used"] > 0).all(), "expected out passes in the first unit"
        else:
            assert pf["_pooled"] is grant
            assert all(np.shares_memory(pf[k], grant[g]) for k, g in
                       (("se", "se"), ("shift", "sh"), ("dq", "dq"), ("row_a", "ra")))
            assert pool._PLAN_CHUNK_SCRATCH == {(0, NBLOCKS, NROWS): scratch}
        out, status = port.decompress_status(unit)
        assert (status < 0).tolist() == [i in corrupt for i in range(NBLOCKS)]
        for i in np.flatnonzero(status == 0):
            assert out[i * BLOCK:(i + 1) * BLOCK].tobytes() == data[i * BLOCK:(i + 1) * BLOCK]
        port.recycle(unit)
        assert pool._PLAN_FREE == [grant]
    assert dense[1] < dense[0], dense
    port.release()


def test_recycle_returns_the_grant_and_the_next_build_shares_it(pool):
    data = make_corpus(NBLOCKS)
    port = port_engine()
    first = port.compress(data)
    port.ensure_plans(first)
    grant = first.plan_flat["_pooled"]
    assert pool._PLAN_FREE == []
    assert port.recycle(first) == NBLOCKS
    assert pool._PLAN_FREE == [grant] and "_pooled" not in first.plan_flat
    second = port.compress(data)
    port.ensure_plans(second)
    assert second.plan_flat["_pooled"] is grant and pool._PLAN_FREE == []
    assert np.shares_memory(second.plan_flat["se"], grant["se"])
    assert port.decompress(second).tobytes() == data
    port.recycle(second)
    # A unit decoded from its sequence tables holds no grant.
    tables = port_engine(block_size=4096, max_pool_slots=NBLOCKS * 32)
    unit = tables.compress(data)
    tables.ensure_plans(unit)
    assert unit.plan_flat is None and unit.tables is not None
    tables.recycle(unit)
    assert pool._PLAN_FREE == [grant]
    port.release()
    tables.release()


@pytest.mark.parametrize("state", ["queued", "running", "finished"])
def test_recycle_of_a_pending_background_build_returns_its_grant(pool, state):
    # "queued": cancelled before it ran, so it took no grant; "running": the
    # recycle waits for the build, which waits for the planner lock the test
    # holds; "finished": built, never joined.
    data = make_corpus(NBLOCKS)
    port = port_engine(plan_build="background")
    assert pool._PLAN_FREE == []              # 32 slots: nothing prefaulted
    if state == "finished":
        unit = port.compress(data)
        grant = unit._plan_future.result(timeout=WAIT_S)[0]["_pooled"]
        port.recycle(unit)
        assert pool._PLAN_FREE == [grant]
    elif state == "running":
        done = threading.Event()
        with pool._PLAN_LOCK:
            unit = port.compress(data)
            fut = unit._plan_future
            for _ in range(WAIT_S * 100):
                if fut.running():
                    break
                done.wait(0.01)
            assert fut.running()
            threading.Thread(target=lambda: (port.recycle(unit), done.set()),
                             daemon=True).start()
            assert not done.wait(0.2), "recycle returned before the build ended"
        assert done.wait(WAIT_S)
        (grant,) = pool._PLAN_FREE
        assert grant["se"].size == 512 * NROWS and fut.result()[0].get("_pooled") is None
    else:
        with pool._PLAN_LOCK:
            busy = port.compress(data)
            unit = port.compress(data)        # queued behind busy's build
            port.recycle(unit)
            assert unit._plan_future is None
        port.ensure_plans(busy)
        assert pool._PLAN_FREE == []
        grant = busy.plan_flat["_pooled"]
        port.recycle(busy)
        assert pool._PLAN_FREE == [grant]
    assert unit.recycled and unit.plan_flat is None
    port.release()


@pytest.mark.parametrize("plan_build,kernels,slots", [
    ("lazy", True, 1056), ("background", False, 1056), ("background", True, 1023)])
def test_no_prefault_without_background_builds_or_a_full_arena(pool, plan_build, kernels,
                                                              slots):
    port_engine(plan_build=plan_build, use_tpu_kernels=kernels, max_pool_slots=slots,
                block_size=SMALL).release()
    assert pool._PLAN_FREE == [] and pool._PLAN_CHUNK_SCRATCH == {}


def test_initialize_prefaults_once_per_process(pool):
    # The JAX engine's sets (four chunks of 256 blocks, a grant for 1024
    # blocks), zero-filled, for an arena of 1024 slots or more; a second
    # engine finds them and allocates nothing.  At 16 KiB blocks: a quarter
    # GiB, where 128 KiB blocks would fault 0.9 GiB in the test worker.
    nrows = SMALL // 128
    first = port_engine(plan_build="background", max_pool_slots=1056, block_size=SMALL)
    scratch = dict(pool._PLAN_CHUNK_SCRATCH)
    assert sorted(scratch) == [(ci, 256, nrows) for ci in range(4)]
    for dq, ra in scratch.values():
        assert dq.shape == (256, nrows, 128) and ra.shape == (256, 64, nrows)
    (grant,) = pool._PLAN_FREE
    assert {k: v.size for k, v in grant.items()} == {
        "se": 4 * 1024 * 1024, "sh": 4 * 1024 * 1024, "dq": 1024 * nrows * 128,
        "ra": 1024 * 32 * 128 * 8}
    assert not any(a.any() for bufs in scratch.values() for a in bufs)
    assert not any(a.any() for a in grant.values())
    second = port_engine(plan_build="background", max_pool_slots=1056, block_size=SMALL)
    assert pool._PLAN_FREE == [grant] and pool._PLAN_FREE[0] is grant
    assert pool._PLAN_CHUNK_SCRATCH.keys() == scratch.keys()
    assert all(pool._PLAN_CHUNK_SCRATCH[k] is v for k, v in scratch.items())
    first.release()
    second.release()


def test_two_driver_engines_planning_from_two_threads_equal_the_jax_engine(pool):
    # Two engines of a CPU Driver, each in its own thread, compress and plan
    # (background builds, serialized by the process-wide lock), decode and
    # recycle three times: every plan equals the JAX engine's, every round
    # trip is bit-exact, and the grants pass between the engines.
    datas = [make_text_corpus(NBLOCKS), make_corpus(NBLOCKS)]
    wants = []
    for data in datas:
        eng = jax_engine()
        unit = eng.compress(data)
        eng.ensure_plans(unit)
        wants.append((unit.plan_flat, unit.plan_comp_rows))
        eng.release()
    cfg = btt.EngineConfig(codec=btt.Codec.LZ4, block_size=BLOCK, burst_size=4,
                           max_pool_slots=32)
    engines = btt.Driver.instance().get_engines(cfg, device_ids=[0, 0], device_type="cpu")
    start = threading.Barrier(2)
    errors, grants = [], set()

    def run(k: int) -> None:
        try:
            start.wait(WAIT_S)
            for _ in range(3):
                unit = engines[k].compress(datas[k])
                engines[k].ensure_plans(unit)
                assert_plans_equal(unit, *wants[k])
                grants.add(id(unit.plan_flat["_pooled"]))
                assert engines[k].decompress(unit).tobytes() == datas[k]
                engines[k].recycle(unit)
        except Exception as e:            # reported by the test thread below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,), daemon=True) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S * 4)
    assert not any(t.is_alive() for t in threads), "a planning thread did not finish"
    if errors:
        raise errors[0]
    assert len(pool._PLAN_FREE) == len(grants) <= 2
    for eng in engines:
        eng.release()


def corrupt_slot(eng, unit, i: int, jax: bool) -> None:
    """Flip the first byte of block i's arena slot (after its plans or
    tables were built)."""
    row = np.asarray(eng.arena.gather_burst([unit.refs[i].slot]))[0].copy()
    row[0] ^= 0xFF
    eng.arena.write_burst([unit.refs[i].slot], jnp.asarray(row[None]) if jax else row[None])


def delay_first_readback(monkeypatch, landed) -> list[int]:
    """Make the first burst readback wait until ``landed()`` (the other
    bursts are in the output).  Returns the order in which the readbacks
    return, by submission, and last whether the wait ended by ``landed``."""
    real = btt.Engine._readback
    lock, calls, order = threading.Lock(), [], []

    def readback(result, stream):
        with lock:
            k = len(calls)
            calls.append(k)
        waited = False
        if k == 0:
            for _ in range(WAIT_S * 100):
                if waited := landed():
                    break
                threading.Event().wait(0.01)
        host = real(result, stream)
        with lock:
            order.append(k)
            if k == 0:
                order.append(waited)
        return host

    monkeypatch.setattr(btt.Engine, "_readback", staticmethod(readback))
    return order


@pytest.mark.parametrize("path", ["planned", "tables"])
def test_out_of_order_readback_gives_the_jax_engines_bytes_and_status(monkeypatch, path):
    # 16 blocks in bursts of 4, burst 0's readback returning last, after the
    # other three bursts were copied into the output.  Planned path: block
    # 4's first token flipped before import (the planner rejects it: a host
    # block) and block 2's slot (RAW) corrupted after planning (the CRC32
    # names it).  Tables path: markdown and RLE blocks under a 2-pass plan
    # budget (no block plans), block 5's slot corrupted after the tables
    # were built (the framing walk names it).
    n = 16
    corpus = make_corpus(n)
    if path == "planned":
        data, corrupt, hit, budget = corpus, (4,), 2, 160
    else:
        data = blocks_of(make_text_corpus(n) + corpus, [0, 19, 1, 23, 2, 27, 3, 31, 4, 5,
                                                         6, 7, 8, 9, 10, 11])
        corrupt, hit, budget = (), 5, 2
    ref = jax_engine(checksum=bt.Checksum.CRC32)
    blob = container("lz4", data, corrupt, checksum=bt.Checksum.CRC32)
    port = port_engine(checksum=btt.Checksum.CRC32)
    ju = ref.import_unit(bt.CompressedBuffers.from_bytes(blob))
    tu = port.import_unit(btt.CompressedBuffers.from_bytes(blob))
    for eng, unit, jax in ((ref, ju, True), (port, tu, False)):
        eng._PLAN_MAX_PASSES = budget
        eng.ensure_plans(unit)
        corrupt_slot(eng, unit, hit, jax)
    if path == "planned":
        assert tu.plan_flat["host_blocks"].tolist() == [4]
    else:
        assert tu.plan_flat is None and tu.tables is not None
    order = delay_first_readback(monkeypatch, lambda: port.stats.dequeued_blocks == n - 4)
    jout, jst = ref.decompress_status(ju)
    tout, tst = port.decompress_status(tu)
    # Bursts 1-3 landed in the output while burst 0's readback waited.
    assert order == [1, 2, 3, 0, True], order
    np.testing.assert_array_equal(tst, jst)
    assert np.flatnonzero(tst < 0).tolist() == sorted((*corrupt, hit))
    for i in np.flatnonzero(tst == 0):
        o = i * BLOCK
        assert tout[o:o + BLOCK].tobytes() == jout[o:o + BLOCK].tobytes() == data[o:o + BLOCK]
    assert port.stats.device_decode_bursts == 4 and port.stats.dequeued_blocks == n
    port.release()
    ref.release()
