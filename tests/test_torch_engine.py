"""The port's Engine against the JAX engine, on the CPU.

Both engines get the same config and data (made from a numpy seed).  They
must produce the same compressed container bytes and the same flat plan,
key by key; the port must decode bit-exactly and report the same per-block
status as the reference after a slot is corrupted.  The JAX engine runs its
Pallas kernel in interpret mode; the port runs its plain PyTorch decode on
CPU tensors.  Tolerance 0 throughout.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitar_tpu as bt
import bitar_tpu_torch as btt
from bitar_tpu_torch.interop import TPU_ONLY_PLAN_KEYS

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
    want = {k: v for k, v in ju.plan_flat.items() if k not in TPU_ONLY_PLAN_KEYS}
    assert tu.plan_flat.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(tu.plan_flat[k], v, err_msg=k)
    assert (tu.plan_flat["p_used"] > tu.plan_flat["p0"]).any(), "expected out passes"
    assert (tu.plan_flat["dense"] < 0).any(), "expected RAW blocks"
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


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_unit_over_plan_budget_is_not_implemented(codec):
    # Markdown blocks under an 8-pass budget: the planner rejects every
    # block as over budget, and the JAX engine decodes the unit on the
    # device through its sequence-table path.  The port names that path
    # (kernel B2) as not ported instead of decoding the unit on the host.
    data = (ROOT / "SURVEY.md").read_bytes()[:3 * BLOCK]
    jax_eng, port = engines(codec, commit="deferred", plan_build="lazy")
    jax_eng._PLAN_MAX_PASSES = port._PLAN_MAX_PASSES = 8
    ju, tu = jax_eng.compress(data), port.compress(data)
    jax_eng.ensure_plans(ju)
    assert ju.plan_flat is None and ju.tables is not None
    for call in (port.decompress_status, port.decompress_device, port.prepare_device_decode):
        with pytest.raises(btt.StatusError) as ei:
            call(tu)
        assert ei.value.status.code == btt.StatusCode.NOT_IMPLEMENTED
        assert "B2" in str(ei.value)
    assert port.stats.host_decode_bursts == 0
    assert port.recycle(tu) == tu.nblocks
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
    assert tu.plan_flat["host_blocks"].tolist() == [0, 1, 2]
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
    cfg = btt.EngineConfig(**cfg_kw(), codec=btt.Codec.ZSTD)
    with btt.Engine(cfg, device="cpu") as eng:
        unit = eng.compress(make_data(38))
        with pytest.raises(btt.StatusError) as ei:
            eng.decompress(unit)
        assert ei.value.status.code == btt.StatusCode.NOT_IMPLEMENTED
        eng.recycle(unit)


def test_cuda_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the engine starts")
    with pytest.raises(btt.StatusError):
        btt.Engine(btt.EngineConfig(**cfg_kw()))
    with pytest.raises(btt.StatusError):
        btt.Engine(btt.EngineConfig(**cfg_kw()), device="cuda")


@pytest.mark.parametrize("kw", [dict(compress_matcher="tpu"), dict(block_size=4096)])
def test_unported_paths_are_named(kw):
    eng = btt.Engine(btt.EngineConfig(**cfg_kw(**kw)), device="cpu")
    with pytest.raises(btt.StatusError) as ei:
        eng.initialize()
    assert ei.value.status.code == btt.StatusCode.NOT_IMPLEMENTED


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
