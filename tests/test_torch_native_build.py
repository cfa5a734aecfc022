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


def codes(fn, *args):
    """``fn(*args)``'s output, or the status code it raised."""
    try:
        return np.asarray(fn(*args))
    except Exception as e:               # both packages' StatusError
        if type(e).__name__ != "StatusError":
            raise
        return e.status.to_int()


def assert_same_result(got, want, what: str) -> None:
    if isinstance(want, int):
        assert got == want, f"{what}: status {got} != {want}"
    else:
        assert not isinstance(got, int), f"{what}: raised {got}"
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("codec", ["lz4", "snappy", "zstd"])
def test_single_block_codecs_match_the_jax_modules(codec):
    # Each block of the corpus (and an empty one) through both modules'
    # one-block compress and decompress: the same stream, the same bytes.
    for i, d in enumerate(corpus() + [b""]):
        comp = getattr(tnative, f"{codec}_compress")
        got, want = comp(d), getattr(jnative, f"{codec}_compress")(d)
        np.testing.assert_array_equal(got, want, err_msg=f"{codec} block {i}")
        args = (got,) if codec == "snappy" else (got, len(d) + 1)
        back = codes(getattr(tnative, f"{codec}_decompress"), *args)
        assert_same_result(back, codes(getattr(jnative, f"{codec}_decompress"), *args),
                           f"{codec} block {i}")
        assert back.tobytes() == d
    if codec != "zstd":
        d = corpus()[0]
        np.testing.assert_array_equal(getattr(tnative, f"{codec}_compress")(d, min_match=6),
                                      getattr(jnative, f"{codec}_compress")(d, min_match=6))


@pytest.mark.parametrize("fn,args", [
    ("lz4_decompress", (np.array([0xFF, 0xFF], np.uint8), 100)),
    ("lz4_decompress", (np.array([0x10, 0x41, 0xFF, 0x00], np.uint8), 100)),
    ("lz4_decompress", (jnative.lz4_compress(b"x" * 1000), 10)),
    ("snappy_decompress", (np.array([0xFF] * 6, np.uint8),)),
    ("snappy_decompress", (np.array([0x80], np.uint8),)),
    ("snappy_decompress", (jnative.snappy_compress(b"y" * 1000), 10)),
    ("zstd_decompress", (np.array([0x28, 0xB5, 0x2F, 0xFD, 0xFF], np.uint8), 100)),
    ("zstd_decompress", (jnative.zstd_compress(b"z" * 1000), 10)),
    ("zstd_parse", (np.array([1, 2, 3, 4, 5], np.uint8),)),
])
def test_malformed_and_short_inputs_raise_as_in_the_jax_module(fn, args):
    got, want = codes(getattr(tnative, fn), *args), codes(getattr(jnative, fn), *args)
    assert isinstance(want, int) and want < 0
    assert got == want


def test_zstd_parse_matches_the_jax_module():
    for i, d in enumerate(corpus()):
        c = jnative.zstd_compress(d)
        (got, glit), (want, wlit) = tnative.zstd_parse(c), jnative.zstd_parse(c)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"block {i} {k}")
        np.testing.assert_array_equal(glit, wlit, err_msg=f"block {i} literals")


@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_plan_frags_and_split_limit_match_the_jax_module(codec):
    # The fragment list at several split limits, and plan_block under the
    # thread-local split limit each module sets.
    try:
        for i, (d, c) in enumerate(zip(corpus(), compressed(jnative, codec, corpus()))):
            for limit in (1, 2, 8):
                got = tnative.plan_frags(c, len(d), codec, split_limit=limit)
                want = jnative.plan_frags(c, len(d), codec, split_limit=limit)
                assert got.keys() == want.keys()
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=f"{i} {limit} {k}")
                tnative.set_split_limit(limit)
                jnative.set_split_limit(limit)
                tp = tnative.plan_block(c, len(d), BLOCK // 128, 32, codec)
                jp = jnative.plan_block(c, len(d), BLOCK // 128, 32, codec)
                assert tp[:2] == jp[:2], f"block {i} split limit {limit}"
                if tp[2] is not None:
                    for k in jp[2]:
                        np.testing.assert_array_equal(tp[2][k], jp[2][k], err_msg=k)
    finally:
        tnative.set_split_limit(2)
        jnative.set_split_limit(2)


def test_plan_prof_reports_the_jax_modules_phases():
    comps = compressed(jnative, "lz4", corpus())
    src, off, lens = packed(comps)
    tnative.plan_prof(reset=True)
    tnative.plan_batch_flat(src, off, lens, np.full(len(comps), BLOCK, np.int32),
                            np.zeros(len(comps), np.int32), BLOCK // 128, 160, cb=4)
    prof = tnative.plan_prof(reset=True)
    assert list(prof) == list(jnative.plan_prof(reset=False))
    assert all(v >= 0 for v in prof.values()) and prof["parse"] > 0, prof
    assert not any(tnative.plan_prof(reset=False).values())
