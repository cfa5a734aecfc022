"""The key-value cells' plain reference (``reference/kv.py``), the MultiGet
cell's check against broken decodes and its control, and its metric readers.

Run from the repository root: ``python -m pytest benchmark/``.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.conftest import ALL, tiny_config
from benchmark.loops.shuffle import compress_all
from benchmark.reference import kv, lz4
from bitar_tpu_torch.engine.device import Engine

CELL = "rocksdb-4k.multiget"
CONFIG = harness.resolve(CELL, spec=ALL)["config"]


def small(block: int) -> dict:
    """The configuration's data at a size the CPU holds: the tiny one at
    16 KiB, two SSTs of 40 blocks at the configuration's 4 KiB."""
    if block == CONFIG["engine"]["block_size"]:
        return dict(CONFIG["data"], units=2, unit_blocks=40)
    return tiny_config(CONFIG)["data"]


def blocks_of(t: kv.Table) -> list[bytes]:
    off = np.concatenate([[0], np.cumsum(t.sizes)])
    return [t.raw[off[g]:off[g + 1]].tobytes() for g in range(t.sizes.size)]


def test_tiny_config_is_the_16k_blocks():
    assert tiny_config(CONFIG)["engine"]["block_size"] == 16384


def test_generator_follows_the_seed():
    a, b = kv.make(small(4096), 2**31 + 3, 4096), kv.make(small(4096), 2**31 + 3, 4096)
    c = kv.make(small(4096), 2**31 + 4, 4096)
    for k in ("raw", "sizes", "sst", "block", "value_off", "keys", "values"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert np.array_equal(a.keys, c.keys)                     # the keys are YCSB's, the values drawn
    assert not np.array_equal(a.values, c.values)
    assert not np.array_equal(kv.key_stream(3, 500, 64, 0.99), kv.key_stream(4, 500, 64, 0.99))
    assert np.array_equal(kv.key_stream(3, 500, 64, 0.99), kv.key_stream(3, 500, 64, 0.99))


@pytest.mark.parametrize("block", [4096, 16384])
def test_every_key_is_found_with_its_value(block):
    cfg = small(block)
    t = kv.make(cfg, 2**32 + 9, block)
    blocks = blocks_of(t)
    assert len(blocks) == cfg["units"] * cfg["unit_blocks"]
    assert all(len(b) <= block for b in blocks)
    per_block = np.bincount(t.sst * cfg["unit_blocks"] + t.block)
    assert per_block.min() >= 1 and (block == 16384 or per_block.max() == 3)
    keys = [t.user_key(r) for r in range(t.sst.size)]
    assert keys == sorted(keys) and len(set(keys)) == len(keys)
    for r, key in enumerate(keys):
        g = int(t.sst[r]) * cfg["unit_blocks"] + int(t.block[r])
        value = kv.lookup(blocks[g], key)
        assert value == t.values[r].tobytes(), r
        o = int(t.value_off[r])
        assert blocks[g][o:o + int(t.value_len[r])] == value
        other = blocks[(g + 1) % len(blocks)]
        assert kv.lookup(other, key) is None
    assert kv.lookup(blocks[0], b"user") is None and kv.lookup(blocks[-1], b"user~") is None


def test_values_are_ycsb_records_of_half_repeated_fields():
    v = kv.record_values(np.random.default_rng(1), 50).reshape(50, kv.FIELDS, -1)
    assert v.shape[2] * kv.FIELDS == kv.VALUE_LEN == 1140
    assert v[0, 3, :14].tobytes() == (6).to_bytes(4, "big") + b"field3" + (100).to_bytes(4, "big")
    field = v[:, :, 14:]
    assert np.array_equal(field[:, :, :50], field[:, :, 50:])
    assert (field >= 32).all() and (field < 128).all() and len(np.unique(field)) == 64


def test_keys_are_ycsb_hashed_keys():
    def java_fnv(n: int) -> int:                    # Utils.fnvhash64, in Java's signed longs
        h = 0xCBF29CE484222325
        for _ in range(8):
            h = ((h ^ (n & 0xFF)) * 1099511628211) & (2**64 - 1)
            n >>= 8
        h = h - 2**64 if h >= 2**63 else h
        return abs(h)

    keys, klen = kv.user_keys(300)
    for r in (0, 1, 7, 299):
        want = b"user%d" % java_fnv(r) + kv.TRAILER
        assert keys[r, :klen[r]].tobytes() == want and not keys[r, klen[r]:].any()


def test_zipf_ranks_follow_ycsb():
    n, count = 1000, 400_000
    ranks = kv.zipf_ranks(np.random.default_rng(5), n, count, 0.99)
    assert ranks.min() == 0 and ranks.max() < n
    zetan = float(np.sum(1.0 / np.arange(1, n + 1) ** 0.99))
    share = np.bincount(ranks, minlength=n) / count
    assert math.isclose(share[0], 1 / zetan, rel_tol=0.02)
    assert math.isclose(share[1], 2 ** -0.99 / zetan, rel_tol=0.05)
    assert share[:10].sum() > share[10:100].sum() / 2


def _stale(self, units, unit_idx, block_idx):
    """Every step returns the planes of the step before it, cycled to its length."""
    prev = getattr(self, "_prev", None)
    self._prev = _decode(self, units, unit_idx, block_idx)
    if prev is None:
        return self._prev
    return prev[torch.arange(len(unit_idx)) % prev.shape[0]]


def _half(self, units, unit_idx, block_idx):
    out = _decode(self, units, unit_idx, block_idx)
    out[out.shape[0] // 2:] = 0
    return out


def _flip(self, units, unit_idx, block_idx):
    out = _decode(self, units, unit_idx, block_idx)
    out[:, 0, 40] ^= 1                # a byte of every block's first value
    return out


_decode = Engine.decompress_blocks_device


@pytest.mark.parametrize("fault", [_stale, _half, _flip], ids=lambda f: f.__name__)
def test_fault_makes_the_run_incorrect(monkeypatch, tiny, fault):
    spec, ctx = tiny(CELL, seconds=0.3)
    monkeypatch.setattr(Engine, "decompress_blocks_device", fault)
    _, line = harness.run_cell(spec, ctx)
    assert line["correct"] is False, line["checks"]


def control_reading(data_cfg: dict, block: int, min_match: int, seed: int) -> dict:
    """The check on the reference's lossy LZ4 decode (each block's last
    literal run left unwritten) in the program's place: bad bytes over every
    block, and the records whose key the lookup no longer finds."""
    t = kv.make(data_cfg, seed, block)
    comp, off, lens, cids = compress_all(t.raw, t.sizes, min_match)
    raw = blocks_of(t)
    bad, lossy = 0, []
    for g, want in enumerate(raw):
        got = lz4.decode_stored(comp[off[g]:off[g] + lens[g]].tobytes(), int(cids[g]),
                                len(want), lossy=True)
        bad += int((got != np.frombuffer(want, np.uint8)).sum())
        lossy.append(got.tobytes())
    missing = 0
    for r in range(t.sst.size):
        g = int(t.sst[r]) * data_cfg["unit_blocks"] + int(t.block[r])
        try:
            found = kv.lookup(lossy[g], t.user_key(r))
        except (IndexError, ValueError):
            found = None
        missing += found is None
        bad += found is not None and found != t.values[r].tobytes()
    return {"bad_bytes": bad, "missing_keys": missing}


@pytest.mark.parametrize("block", [4096, 16384])
def test_control_fails_the_check(block):
    for seed in (1, 2**31 + 5):
        r = control_reading(small(block), block, CONFIG["engine"]["min_match"], seed)
        assert r["bad_bytes"] > 0 and r["missing_keys"] > 0, r


def test_the_metric_readers(monkeypatch):
    read = {m["name"]: harness.metric_reader(harness.BENCH, m["name"])
            for m in harness.resolve(CELL)["per_layer"]}
    assert set(read) == {"b2_roofline.multiget", "device_idle.multiget",
                         "multiget_host_ms.multiget", "gather_useful.multiget"}
    span = "bitar.engine.decompress_blocks_device"
    r = {"events": [("decode_tables_kernel_shared(Args)", "kernel", 0.0, 100.0),
                    ("vectorized_gather_kernel", "kernel", 200.0, 50.0)],
         "annotations": [("multiget", 0.0, 900.0), (span, 5.0, 300.0), (span, 400.0, 500.0)],
         "counts": {"stored_bytes": 2_000_000, "raw_bytes": 6_000_000},
         "kind": "NVIDIA H100 80GB HBM3", "window_s": 1e-3}
    assert math.isclose(read["b2_roofline.multiget"]([r]), 100.0 * 8e6 / 3.35e12 / 100e-6)
    assert math.isclose(read["device_idle.multiget"]([r]), 85.0)
    assert math.isclose(read["multiget_host_ms.multiget"]([r]), 0.4)
    older = dict(r, annotations=[("multiget", 0.0, 900.0)], events=[])
    assert read["multiget_host_ms.multiget"]([older]) is None
    assert read["b2_roofline.multiget"]([older]) is None
    import benchmark.trace.program as prog
    monkeypatch.setattr(prog, "counters", lambda: {"arena.gather_bytes": 8192,
                                                   "arena.gather_stored_bytes": 2048})
    assert harness.metric_reader(harness.BENCH, "gather_useful.multiget")([r]) == 25.0
    monkeypatch.setattr(prog, "counters", lambda: None)
    assert harness.metric_reader(harness.BENCH, "gather_useful.multiget")([r]) is None
