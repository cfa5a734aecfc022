"""The host codec library: the port's against the JAX package's.

Each package compiles its own copy of the C++ (``ops/cpu/*.cc``).  On a
corpus made from a numpy seed, the two libraries must code the same LZ4,
Snappy and Zstd streams, parse the same LZ4 and Snappy sequence tables and
give the same per-block planner status, and the port's plan wire must decode
(``decode_flat_reference``) to the raw bytes.  Tolerance 0.  Both libraries
are loaded in this one process: both export the same ``bt_*`` symbols, and
ctypes loads each ``RTLD_LOCAL``, so each binding resolves into its own
library.

The port builds its copy under a file lock (``bitar_tpu_torch/ops/_build.py``); the
JAX package runs cmake and ninja in its shared ``build/`` directory at first
use, guarded only by a thread lock.  Under ``pytest -n 6`` several worker
processes could reach that build together and leave a broken cmake cache
behind, which fails every later test that needs the library, the port's
parity tests among them.  This module builds the JAX package's library
while it is collected, under a file lock in that build directory: every
worker collects every module before it runs a test, so each finds the
library built.  A failed build is left for the tests that need the library
to report.
"""

import fcntl

import numpy as np
import pytest
import torch

from bitar_tpu.ops.cpu import native as jnative
from bitar_tpu_torch.ops import decode_flat as tflat
from bitar_tpu_torch.ops.cpu import native as tnative

BLOCK = 16 * 1024
CODEC_IDS = {"lz4": 0, "snappy": 1, "zstd": 2}


def _build_reference_library() -> None:
    jnative._BUILD_DIR.mkdir(exist_ok=True)
    with open(jnative._BUILD_DIR / "collect.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            jnative.load()
        except Exception:      # reported by the tests that load it
            pass


_build_reference_library()


@pytest.mark.parametrize("min_match", [4, 6])
def test_both_builds_code_the_same_bytes(min_match):
    rng = np.random.default_rng(5)
    data = np.repeat(rng.integers(0, 256, 4096, np.uint8), rng.integers(1, 9, 4096)).tobytes()
    got = tnative.lz4_compress(data, min_match=min_match)
    want = jnative.lz4_compress(data, min_match=min_match)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jnative.lz4_decompress(got, len(data)),
                                  np.frombuffer(data, np.uint8))


def corpus(seed: int = 9) -> list[bytes]:
    """Six 16 KiB blocks: words, records, low-entropy, random, RLE, runs."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), np.uint8)) for _ in range(64)]
    text = b" ".join(words[i] for i in rng.integers(0, 64, BLOCK))[:BLOCK]
    rec = np.zeros((BLOCK // 16, 16), np.uint8)
    rec[:, 0] = np.arange(BLOCK // 16) & 0xFF
    rec[:, 4:8] = rng.integers(0, 4, (BLOCK // 16, 4))
    runs = np.repeat(rng.integers(0, 256, BLOCK, np.uint8), rng.integers(1, 9, BLOCK))
    return [text, rec.tobytes(), rng.integers(0, 16, BLOCK, np.uint8).tobytes(),
            rng.integers(0, 256, BLOCK, np.uint8).tobytes(), b"\x5a" * BLOCK,
            runs[:BLOCK].tobytes()]


def packed(blocks: list) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    lens = np.array([len(b) for b in blocks], np.int32)
    off = np.zeros(len(blocks), np.int64)
    off[1:] = np.cumsum(lens[:-1])
    return np.frombuffer(b"".join(bytes(b) for b in blocks), np.uint8), off, lens


def compressed(lib, codec: str, datas: list[bytes]) -> list[np.ndarray]:
    """Each block compressed by ``lib``'s threaded batch engine."""
    src, off, lens = packed(datas)
    cap = np.full(len(datas), 2 * BLOCK + 64, np.int32)
    dst_off = np.arange(len(datas), dtype=np.int64) * cap[0]
    dst = np.zeros(int(cap.sum()), np.uint8)
    ids = np.full(len(datas), CODEC_IDS[codec], np.int32)
    if lib is tnative:
        dlen, status = lib.batch_run(True, src, off, lens, dst, dst_off, cap, ids)
    else:
        dlen, status = lib.batch_run(True, codec, src, off, lens, dst, dst_off, cap,
                                     codec_ids=ids)
    assert (status == 0).all(), status
    return [dst[o:o + n].copy() for o, n in zip(dst_off, dlen)]


@pytest.mark.parametrize("codec", ["lz4", "snappy", "zstd"])
def test_both_builds_compress_the_same_streams(codec):
    datas = corpus()
    got, want = compressed(tnative, codec, datas), compressed(jnative, codec, datas)
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"{codec} block {i}")
        back = {"lz4": lambda c: jnative.lz4_decompress(c, BLOCK),
                "snappy": jnative.snappy_decompress,
                "zstd": lambda c: jnative.zstd_decompress(c, BLOCK)}[codec](got[i])
        assert np.asarray(back).tobytes() == d, f"{codec} block {i}"


@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_both_builds_parse_the_same_tables(codec):
    for i, c in enumerate(compressed(jnative, codec, corpus())):
        got, want = tnative.parse_sequences(c, codec), jnative.parse_sequences(c, codec)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{codec} block {i} {k}")


@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_both_builds_plan_alike_and_the_port_wire_decodes(codec):
    datas = corpus()
    comps = compressed(jnative, codec, datas)
    src, off, lens = packed(comps)
    nrows = BLOCK // 128
    args = (src, off, lens, np.full(len(comps), BLOCK, np.int32),
            np.full(len(comps), CODEC_IDS[codec], np.int32), nrows, 160)
    se, sh, pu, p0, st, _, dq, ra, dn = tnative.plan_batch_flat(*args, cb=4)
    want_status = jnative.plan_batch_flat(*args, cb=4)[4]
    np.testing.assert_array_equal(st, want_status)
    assert (st == 0).all(), st
    plans = tflat.attach_dense_planes(tflat.flatten_batch_plans(se, sh, pu, p0, nrows),
                                      dq, ra, dn)
    comp_rows = -(-int(lens.max()) // 128)
    comp_rows = -(-comp_rows // 128) * 128
    comp_rows = -(-comp_rows // 256) * 256 if comp_rows > 128 else comp_rows
    rows = np.zeros((len(comps), comp_rows * 128), np.uint8)
    for i, c in enumerate(comps):
        rows[i, :len(c)] = c
    got = tflat.decode_flat_reference(torch.from_numpy(rows), tflat.plan_tensors(plans, "cpu"),
                                      comp_rows, nrows).numpy()
    for i, d in enumerate(datas):
        assert got[i].reshape(-1).tobytes() == d, f"{codec} block {i}"
