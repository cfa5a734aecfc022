"""Tests of the port that need a CUDA device: the decode kernel against its
plain PyTorch version on the card, and the engine's main path there.

They skip without CUDA.  The machine with the card has no JAX, and
``tests/conftest.py`` imports JAX, so on the card run this file alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Inputs are made from a numpy seed with the port's own host library;
tolerance 0 (byte equality on the whole decoded plane).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import bitar_tpu_torch as btt
from bitar_tpu_torch.ops import decode_flat as tflat
from bitar_tpu_torch.ops.cpu import native

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the decode kernel has no CPU mode)")
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
    rows = torch.zeros((1, 256), dtype=torch.uint8, device=cuda_device)
    plans = tflat.plan_tensors({
        "p_used": np.zeros(1, np.int32), "p_off": np.zeros(1, np.int32),
        "p0": np.zeros(1, np.int32),
        "se": np.zeros((4, 16, 128), np.int16),
        "shift": np.zeros((4, 16, 128), np.int32)}, cuda_device)
    with pytest.raises(btt.StatusError):        # 2048 rows: past one CTA's plane
        tflat.decode_blocks_flat(rows, plans, comp_rows=128, out_rows=2048)


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


def test_unit_over_plan_budget_is_not_implemented_on_card(cuda_device):
    # Every markdown block exceeds an 8-pass budget: the reference decodes
    # such a unit with its sequence-table kernel, which is not ported.
    block = 16 * 1024
    data = (ROOT / "SURVEY.md").read_bytes()[:3 * block]
    cfg = btt.EngineConfig(block_size=block, burst_size=2, max_pool_slots=32,
                           commit="deferred", plan_build="lazy")
    with btt.Engine(cfg, device=cuda_device) as eng:
        eng._PLAN_MAX_PASSES = 8
        unit = eng.compress(data)
        with pytest.raises(btt.StatusError) as ei:
            eng.decompress(unit)
        assert ei.value.status.code == btt.StatusCode.NOT_IMPLEMENTED
        assert eng.stats.host_decode_bursts == 0
        assert eng.recycle(unit) == unit.nblocks


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
