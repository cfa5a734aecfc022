"""The ZSTD MultiGet cell (``rocksdb-zstd-4k.multiget``): its plain Zstd
decoder (``reference/zstd.py``) against the program's host decoder and
against libzstd's frames, its lossy control (on the blocks, and through the
cell's own check, ``control_zstd.py``), its check against broken decodes,
and its metric readers.

``conftest.tiny_config`` runs every cell at 16 KiB, where Zstd blocks take
B1's flat plan; these tests also run the configuration at its own 4 KiB,
where they take the sequence tables over the literal store (B2).

Run from the repository root: ``python -m pytest benchmark/``.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import pytest
import torch

from benchmark import control_zstd, harness
from benchmark.conftest import ALL, tiny_config
from benchmark.reference import kv, zstd
from bitar_tpu_torch.engine.device import Engine

torch.set_num_threads(1)       # the plain B2 of a 4 KiB step, beside other workers

CELL = "rocksdb-zstd-4k.multiget"
CONFIG = harness.resolve(CELL, spec=ALL)["config"]
BLOCK = CONFIG["engine"]["block_size"]
#: The MultiGet metrics both cells report, and the Zstd cell's own two.
NAMES = ("b2_roofline.multiget", "device_idle.multiget", "multiget_host_ms.multiget",
         "lit_bytes_ratio.zstd_multiget", "lit_picks_host_ms.zstd_multiget")


def small(block: int) -> dict:
    """The configuration at a size the CPU holds: the tiny one at 16 KiB,
    two SSTs of 40 blocks at the configuration's 4 KiB."""
    if block != BLOCK:
        return tiny_config(CONFIG)
    c = copy.deepcopy(CONFIG)
    c["engine"].update(burst_size=64, max_pool_slots=128)
    c["data"].update(units=2, unit_blocks=40)
    return c


def compress_zstd(t: kv.Table) -> tuple[list[bytes], np.ndarray]:
    """Every block of ``t`` as the cell stores it, by the program's host
    compressor: a Zstd frame, or the block as it came where the frame does
    not shrink it.  Returns (stored blocks, codec ids)."""
    from bitar_tpu_torch.config import Codec, compress_bound
    from bitar_tpu_torch.ops import registry

    n, sizes = t.sizes.size, t.sizes
    cap = compress_bound(Codec.ZSTD, int(sizes.max()))
    raw_off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    dst = np.empty(n * cap, np.uint8)
    lens, st = registry.host_compress_batch(
        Codec.ZSTD, 1, t.raw, raw_off[:-1], sizes.astype(np.int32), dst,
        np.arange(n, dtype=np.int64) * cap, np.full(n, cap, np.int32), min_match=4)
    assert (st == 0).all()
    stored, cids = [], np.full(n, zstd.ZSTD_ID, np.int32)
    for g in range(n):
        if lens[g] >= sizes[g]:
            stored.append(t.raw[raw_off[g]:raw_off[g + 1]].tobytes())
            cids[g] = zstd.RAW_ID
        else:
            stored.append(dst[g * cap:g * cap + lens[g]].tobytes())
    return stored, cids


def raw_blocks(t: kv.Table) -> list[bytes]:
    off = np.concatenate([[0], np.cumsum(t.sizes)])
    return [t.raw[off[g]:off[g + 1]].tobytes() for g in range(t.sizes.size)]


@pytest.mark.parametrize("block", [4096, 16384])
def test_plain_decoder_equals_the_programs_host_decoder(block):
    from bitar_tpu_torch.ops.cpu import native

    t = kv.make(small(block)["data"], 2**31 + 11, block)
    stored, cids = compress_zstd(t)
    assert (cids == zstd.ZSTD_ID).mean() > 0.9
    for g, want in enumerate(raw_blocks(t)):
        got = zstd.decode_stored(stored[g], int(cids[g]), len(want))
        assert got.tobytes() == want, g
        if cids[g] == zstd.ZSTD_ID:
            assert native.zstd_decompress(stored[g], len(want)).tobytes() == want, g


@pytest.mark.parametrize("block", [4096, 16384])
def test_plain_decoder_equals_libzstd_level_3(block):
    zstandard = pytest.importorskip("zstandard")
    t = kv.make(small(block)["data"], 2**31 + 12, block)
    cctx = zstandard.ZstdCompressor(level=3)
    for g, want in enumerate(raw_blocks(t)):
        frame = cctx.compress(want)
        assert zstd.decode(frame, len(want)).tobytes() == want, g
        assert zstandard.ZstdDecompressor().decompress(frame) == want


def test_plain_decoder_refuses_broken_frames():
    t = kv.make(small(BLOCK)["data"], 3, BLOCK)
    stored, cids = compress_zstd(t)
    frame, want = stored[0], raw_blocks(t)[0]
    with pytest.raises(zstd.FormatError):
        zstd.decode(frame, len(want) + 1)                  # another length than it holds
    with pytest.raises(zstd.FormatError):
        zstd.decode(b"\x00" + frame[1:], len(want))        # no magic
    with pytest.raises(zstd.FormatError):
        zstd.decode(frame[:len(frame) // 2], len(want))    # cut short


def control_reading(cfg: dict, block: int, seed: int) -> dict:
    """The check on the plain decoder's lossy form (each compressed block's
    final literal run left unwritten) in the program's place: bad bytes
    over every block, and the records whose key the lookup no longer finds
    (or finds with another value, counted as bad)."""
    t = kv.make(cfg["data"], seed, block)
    stored, cids = compress_zstd(t)
    bad, lossy = 0, []
    for g, want in enumerate(raw_blocks(t)):
        got = zstd.decode_stored(stored[g], int(cids[g]), len(want), lossy=True)
        bad += int((got != np.frombuffer(want, np.uint8)).sum())
        lossy.append(got.tobytes())
    missing = 0
    for r in range(t.sst.size):
        g = int(t.sst[r]) * cfg["data"]["unit_blocks"] + int(t.block[r])
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
        r = control_reading(small(block), block, seed)
        assert r["bad_bytes"] > 0 and r["missing_keys"] > 0, r


@pytest.mark.parametrize("block", [4096, 16384])
def test_control_fails_the_cells_own_check(block):
    # The lossy decode in the program's place, through the cell's loop and
    # check (``control_zstd.py``; on the card it runs at the full size).
    spec = harness.resolve(CELL, spec=ALL)
    spec["config"] = small(block)
    for seed in (1, 2**31 + 5):
        r = control_zstd.reading(spec, seed, 0.3, "cpu")
        assert r["correct"] is False and r["bad_bytes"] > 0 and r["steps"] > 0, r


def run_at(block: int, seconds: float, trace: bool, seed: int = 2**31 + 17):
    spec = harness.resolve(CELL, spec=ALL)
    spec["config"] = small(block)
    ctx = harness.Context(cell=spec["cell"], config=spec["config"], traffic=spec["traffic"],
                          seed=seed, seconds=seconds, trace=trace, device="cpu")
    return spec, ctx


def test_a_tiny_traced_4k_run_reads_the_literal_store():
    from bitar_tpu_torch.utils import profiling

    profiling.snapshot(reset=True)
    spec, ctx = run_at(BLOCK, 0.5, True)
    _, line = harness.run_cell(spec, ctx)
    assert line["correct"] is True, line["checks"]
    assert {c: line["checks"][c]["value"] for c in line["checks"]} == {
        "bad_bytes": 0, "missing_keys": 0, "unchecked_multigets": 0}
    metrics = line["metrics"]
    assert 1.0 < metrics["lit_bytes_ratio.zstd_multiget"]["value"] < 1.5
    assert metrics["lit_picks_host_ms.zstd_multiget"]["value"] > 0
    assert "b2_roofline.multiget" not in metrics               # nothing ran on a device
    c = profiling.snapshot(reset=True)
    assert c["decode_tables.lit_blocks"] == c["decode_tables.blocks"] > 0


_decode = Engine.decompress_blocks_device


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


@pytest.mark.parametrize("block", [4096, 16384])
@pytest.mark.parametrize("fault", [_stale, _half, _flip], ids=lambda f: f.__name__)
def test_fault_makes_the_run_incorrect(monkeypatch, fault, block):
    spec, ctx = run_at(block, 0.3, False)
    monkeypatch.setattr(Engine, "decompress_blocks_device", fault)
    _, line = harness.run_cell(spec, ctx)
    assert line["correct"] is False, line["checks"]


def test_the_metric_readers(monkeypatch):
    read = {m["name"]: harness.metric_reader(harness.BENCH, m["name"])
            for m in harness.resolve(CELL)["per_layer"]}
    assert set(read) == set(NAMES)
    span, picks = "bitar.engine.lit_picks", "bitar.engine.decompress_blocks_device"
    r = {"events": [("decode_tables_kernel_shared(SrcArgs)", "kernel", 0.0, 100.0),
                    ("vectorized_gather_kernel", "kernel", 200.0, 50.0)],
         "annotations": [("multiget", 0.0, 900.0), (picks, 0.0, 300.0), (span, 5.0, 200.0),
                         (picks, 390.0, 500.0), (span, 400.0, 400.0)],
         "counts": {"stored_bytes": 2_000_000, "raw_bytes": 6_000_000},
         "kind": "NVIDIA H100 80GB HBM3", "window_s": 1e-3}
    assert math.isclose(read["b2_roofline.multiget"]([r]), 100.0 * 8e6 / 3.35e12 / 100e-6)
    assert math.isclose(read["device_idle.multiget"]([r]), 85.0)
    assert math.isclose(read["multiget_host_ms.multiget"]([r]), 0.4)
    assert math.isclose(read["lit_picks_host_ms.zstd_multiget"]([r]), 0.3)
    older = dict(r, annotations=[("multiget", 0.0, 900.0)], events=[])
    assert read["lit_picks_host_ms.zstd_multiget"]([older]) is None
    assert read["multiget_host_ms.multiget"]([older]) is None
    assert read["b2_roofline.multiget"]([older]) is None
    import benchmark.trace.program as prog
    monkeypatch.setattr(prog, "counters", lambda: {"decode_tables.lit_bytes": 1083,
                                                   "decode_tables.lit_stored_bytes": 1000})
    ratio = harness.metric_reader(harness.BENCH, "lit_bytes_ratio.zstd_multiget")
    assert math.isclose(ratio([r]), 1.083)
    for none in ({"decode_tables.blocks": 5}, {}, None):
        monkeypatch.setattr(prog, "counters", lambda none=none: none)
        ratio = harness.metric_reader(harness.BENCH, "lit_bytes_ratio.zstd_multiget")
        assert ratio([r]) is None
