"""State carried between the packages: containers both ways, and the JAX
engine's flat plan decoded by the port (tolerance 0)."""

import numpy as np
import pytest
import torch

import bitar_tpu as bt
import bitar_tpu_torch as btt
from bitar_tpu_torch.interop import plans_from_reference, unit_from_reference
from bitar_tpu_torch.ops import decode_flat as tflat

# Test files run in several worker processes at once: a single intra-op
# thread keeps torch's CPU pool from oversubscribing the cores (the
# tensors here are small).
torch.set_num_threads(1)

BLOCK = 16 * 1024


def make_data(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return (((b"interop %d " % seed) * (BLOCK // 9 + 1))[:BLOCK]
            + rng.integers(0, 32, BLOCK, dtype=np.uint8).tobytes()
            + rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes()
            + b"\x11" * 5000)


def jax_engine(codec="lz4", **kw):
    cfg = bt.EngineConfig(codec=bt.Codec(codec), block_size=BLOCK, burst_size=4,
                          max_pool_slots=32, interpret=True, **kw)
    return bt.Engine(cfg).initialize()


def port_engine(codec="lz4", **kw):
    cfg = btt.EngineConfig(codec=btt.Codec(codec), block_size=BLOCK, burst_size=4,
                           max_pool_slots=32, **kw)
    return btt.Engine(cfg, device="cpu").initialize()


@pytest.mark.parametrize("checksum", ["none", "crc32", "adler32"])
@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_jax_container_decodes_in_port(codec, checksum):
    data = make_data(41)
    je = jax_engine(codec, checksum=bt.Checksum(checksum))
    blob = je.compress(data).to_host().to_bytes()
    pe = port_engine(codec)
    unit = unit_from_reference(blob, pe)
    assert pe.decompress(unit).tobytes() == data
    assert unit.plan_flat["host_blocks"].size == 0
    assert unit.to_host().to_bytes() == blob
    je.release()
    pe.release()


@pytest.mark.parametrize("codec", ["lz4", "snappy", "zstd"])
def test_port_container_decodes_in_jax(codec):
    data = make_data(42)
    pe = port_engine(codec, checksum=btt.Checksum.CRC32)
    blob = pe.compress(data).to_host().to_bytes()
    je = jax_engine(codec, use_tpu_kernels=False)
    unit = je.import_unit(bt.CompressedBuffers.from_bytes(blob))
    assert je.decompress(unit).tobytes() == data
    assert unit.to_host().to_bytes() == blob
    je.release()
    pe.release()


def test_manifest_bytes_identical():
    data = make_data(43)
    m_jax = bt.BlockManifest.plan(len(data), BLOCK)
    m_port = btt.BlockManifest.plan(len(data), BLOCK)
    assert m_jax.to_bytes() == m_port.to_bytes()
    skew = [100, BLOCK, 7, 0, 999]
    assert (bt.BlockManifest.plan_sizes(skew, BLOCK).to_bytes()
            == btt.BlockManifest.plan_sizes(skew, BLOCK).to_bytes())
    back = btt.BlockManifest.from_bytes(m_jax.to_bytes())
    np.testing.assert_array_equal(back.raw_len, m_jax.raw_len)


def test_corrupt_container_rejected():
    blob = bytearray(port_engine().compress(make_data(44)).to_host().to_bytes())
    blob[len(blob) // 2] ^= 0x40
    with pytest.raises(btt.StatusError):
        unit_from_reference(bytes(blob), port_engine())


@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_jax_plan_decodes_in_port(codec):
    # The JAX engine's plan, carried over as tensors, drives the port's
    # decode over the same compressed rows.
    data = make_data(45)
    je = jax_engine(codec, min_match=4)
    ju = je.compress(data)
    je.ensure_plans(ju)
    rows = np.asarray(je.arena.gather_burst([r.slot for r in ju.refs]))
    pt = plans_from_reference(ju.plan_flat, "cpu")
    nrows = BLOCK // 128
    got = tflat.decode_blocks_flat(torch.from_numpy(rows.copy()), pt,
                                   comp_rows=ju.plan_comp_rows, out_rows=nrows)
    got = got.reshape(ju.nblocks, -1).numpy()
    m = ju.manifest
    assert b"".join(got[i, :int(m.raw_len[i])].tobytes()
                    for i in range(ju.nblocks)) == data
    je.release()


def _tiny_plan():
    tiles = 1
    return {"p_used": np.array([4], np.int32), "p_off": np.array([0], np.int32),
            "p0": np.array([4], np.int32),
            "se": np.zeros((8, tiles, 128), np.int16),
            "shift": np.zeros((8, tiles, 128), np.int32),
            "dq": np.zeros((1, 128, 128), np.int16),
            "row_a": np.zeros((1, 1, 128, tiles), np.int32),
            "dense": np.array([1], np.int32), "dq_idx": np.array([0], np.int32),
            "gather_rows": 128}


@pytest.mark.parametrize("bad", ["p_off", "dq_idx", "dense", "lit_planes"])
def test_plans_from_reference_refuses_bad_wire(bad):
    plan = _tiny_plan()
    plans_from_reference(plan, "cpu")              # the good plan passes
    if bad == "p_off":
        plan["p_off"] = np.array([6], np.int32)    # passes run past S = 8
    elif bad == "dq_idx":
        plan["dq_idx"] = np.array([3], np.int32)
    elif bad == "dense":
        plan["dense"] = np.array([2], np.int32)    # only 1 anchor plane
    else:
        plan["lit_planes"] = {0: np.zeros(10, np.uint8)}
    with pytest.raises(btt.StatusError):
        plans_from_reference(plan, "cpu")
