"""Skewed block-size distributions (BASELINE config 4) on the port's engine:
the three tests of ``tests/test_skewed.py``, with their own seeded
generators.  Non-uniform manifests end to end (compress with explicit
sizes, serialize, import, decode on the host path and on the kernel path's
plain versions), each container byte-equal to the JAX engine's."""

import numpy as np
import pytest
import torch

import bitar_tpu as bt
import bitar_tpu_torch as btt
from bitar_tpu_torch.manifest import BlockManifest, CompressedBuffers
from bitar_tpu_torch.status import StatusError

torch.set_num_threads(1)


def make_skewed(rng, nblocks, max_size, min_size=64):
    sizes = np.minimum(
        max_size,
        np.exp2(rng.uniform(np.log2(min_size), np.log2(max_size), nblocks)).astype(np.int64))
    parts = []
    for i, n in enumerate(sizes):
        k = i % 3
        n = int(n)
        if k == 0:
            parts.append(((b"skew %d " % i) * (n // 6 + 1))[:n])
        elif k == 1:
            parts.append(rng.integers(0, 64, n, dtype=np.uint8).tobytes())
        else:
            parts.append(bytes([i & 0xFF]) * n)
    return b"".join(parts), [int(s) for s in sizes]


@pytest.mark.parametrize("kernels", [False, True])
def test_skewed_roundtrip(kernels):
    block = 16384 if kernels else 2048
    data, sizes = make_skewed(np.random.default_rng(81 + kernels), 10, block)
    kw = dict(block_size=block, burst_size=4, max_pool_slots=64, use_tpu_kernels=kernels)
    cfg = btt.EngineConfig(codec=btt.Codec.LZ4, checksum=btt.Checksum.CRC32, **kw)
    with btt.Engine(cfg, device="cpu") as eng:
        unit = eng.compress(data, sizes=sizes)
        assert not unit.manifest.uniform
        assert unit.manifest.raw_len.tolist() == sizes
        out = eng.decompress(unit)
        assert out.tobytes() == data
        if kernels:
            assert eng.stats.host_decode_bursts == 0 and unit.plan_flat is not None
        blob = unit.to_host().to_bytes()
        eng.recycle(unit)
    with bt.Engine(bt.EngineConfig(codec=bt.Codec.LZ4, checksum=bt.Checksum.CRC32,
                                   **dict(kw, use_tpu_kernels=False))) as ref:
        assert ref.compress(data, sizes=sizes).to_host().to_bytes() == blob
    # container round-trip preserves the skewed framing
    cb = CompressedBuffers.from_bytes(blob)
    assert not cb.manifest.uniform
    assert cb.manifest.raw_len.tolist() == sizes
    with btt.Engine(cfg, device="cpu") as eng:
        unit = eng.import_unit(cb)
        out = eng.decompress(unit)
        assert out.tobytes() == data
        eng.recycle(unit)


def test_skewed_sizes_validation():
    with pytest.raises(StatusError):
        BlockManifest.plan_sizes([100, 5000], 2048)   # block over max
    with pytest.raises(StatusError):
        BlockManifest.plan_sizes([], 2048)
    m = BlockManifest.plan_sizes([2048, 2048, 100], 2048)
    assert m.uniform                                   # uniform-shaped input
    m2 = BlockManifest.plan_sizes([100, 2048, 50], 2048)
    assert not m2.uniform


def test_compress_sizes_must_sum():
    cfg = btt.EngineConfig(codec=btt.Codec.LZ4, block_size=2048, burst_size=4,
                           max_pool_slots=64, use_tpu_kernels=False)
    with btt.Engine(cfg, device="cpu") as eng:
        with pytest.raises(StatusError):
            eng.compress(b"x" * 1000, sizes=[512, 512, 512])
