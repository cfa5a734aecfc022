"""The plain reference: its generators and its LZ4 decoder, and the control."""

from __future__ import annotations

import ast
import numpy as np
import pytest

from benchmark import control, harness
from benchmark.conftest import ALL, tiny_config
from benchmark.loops.shuffle import compress_all
from benchmark.reference import data, lz4


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        assert not {x.split(".")[0] for x in names} & {"bitar_tpu", "bitar_tpu_torch", "jax",
                                                        "torch"}, path


@pytest.mark.parametrize("min_match", [4, 6, 12])
def test_decoder_reads_the_host_library_streams(min_match):
    raw, sizes = data.skewed_corpus(3, 40, 65536, 64)
    comp, off, lens, cids = compress_all(raw, sizes, min_match)
    assert (cids == 0).any() and (cids == lz4.RAW_ID).any()
    o = np.concatenate([[0], np.cumsum(sizes)])
    for b in range(len(sizes)):
        got = lz4.decode_stored(comp[off[b]:off[b] + lens[b]].tobytes(), int(cids[b]),
                                int(sizes[b]))
        assert got.tobytes() == raw[o[b]:o[b + 1]].tobytes(), b


@pytest.mark.parametrize("payload", [b"a" * 70000, bytes(range(256)) * 300,
                                     b"x" * 20 + bytes(range(200)) + b"abc" * 999, b"hello"])
def test_decoder_on_long_runs_and_overlaps(payload):
    from bitar_tpu_torch.ops.cpu import native

    src = native.lz4_compress(payload, min_match=4).tobytes()
    assert lz4.decode(src, len(payload)).tobytes() == payload
    lossy = lz4.decode(src, len(payload), lossy=True)
    assert lossy.tobytes() != payload


def test_decoder_refuses_malformed_streams():
    from bitar_tpu_torch.ops.cpu import native

    src = bytearray(native.lz4_compress(b"abcd" * 1000, min_match=4).tobytes())
    with pytest.raises(lz4.FormatError):
        lz4.decode(bytes(src[:-3]), 4000)
    with pytest.raises(lz4.FormatError):
        lz4.decode(bytes(src), 3999)
    bad = bytearray(src)
    bad[5:7] = b"\x00\x00"                     # the first match's offset: 0
    with pytest.raises(lz4.FormatError):
        lz4.decode(bytes(bad), 4000)


def test_generators_follow_the_seed():
    a, b = data.bench_corpus(9, 8, 4096), data.bench_corpus(9, 8, 4096)
    assert a.tobytes() == b.tobytes()
    assert data.bench_corpus(10, 8, 4096).tobytes() != a.tobytes()
    x, xs = data.skewed_corpus(1, 30, 65536, 1024)
    y, ys = data.skewed_corpus(2, 30, 65536, 1024)
    assert sorted(xs.tolist()) == sorted(ys.tolist())        # the same sizes, in another order
    assert xs.tolist() != ys.tolist() and x.size == xs.sum() == y.size


def test_bench_corpus_is_the_ports_corpus_with_its_seed():
    from bitar_tpu_torch.utils.corpus import BLOCK, make_corpus

    assert data.bench_corpus(2026, 8, BLOCK).tobytes() == make_corpus(8)


@pytest.mark.parametrize("workload", ["lz4-128k.scan", "lz4-skewed.read", "lz4-128k-x4.shuffle"])
def test_control_fails_the_check(workload):
    """The control's lossy decode reads bad bytes on every seed: limit 0 fails it."""
    config = tiny_config(harness.resolve(workload, spec=ALL)["config"])
    for seed in (1, 2, 2**31 + 5):
        r = control.reading(config, seed)
        assert r["bad_bytes"] > 0 and r["blocks"] == config["data"]["units"] * config["data"][
            "unit_blocks"]
