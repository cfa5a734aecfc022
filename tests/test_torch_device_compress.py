"""The port's device compress path against the JAX package on the CPU:
layout and parse stages, ``compress_blocks_device`` end to end, the engine
with ``compress_matcher="device"``, containers between the packages, and
the reference's segment-lane fault at non-power-of-two segment counts, the
static-offset matcher (kernel B3) there, and the engine's tpu and tpu-sort
matchers.

Inputs are made from a numpy seed; the JAX Pallas kernels run in interpret
mode, the port's wrappers take their plain versions on CPU tensors.
Tolerance 0: sizes, layouts and wire bytes are integers.  A row whose size
exceeds the emission width is garbage by contract and is not compared.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bitar_tpu as bt
import bitar_tpu_torch as btt
from bitar_tpu.ops import device_compress as jdc
from bitar_tpu.ops.cpu import native
from bitar_tpu.ops.pallas import lz4_match_dyn as jmd
from bitar_tpu_torch.interop import unit_from_reference
from bitar_tpu_torch.ops import device_compress as tdc
from bitar_tpu_torch.utils import corpus

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def mixed_planes(L: int, seed: int = 7):
    """[6, L] blocks (text, RLE, random, low-entropy, markdown, a tiled
    pattern) and their lengths (two tail blocks), zero past each length."""
    rng = np.random.default_rng(seed)
    src = (ROOT / "SURVEY.md").read_bytes()
    o = int(rng.integers(0, len(src) - L))
    planes = np.stack([
        np.frombuffer((b"device compress parity %d " % seed * (L // 25 + 1))[:L], np.uint8),
        np.full(L, 3, np.uint8),
        rng.integers(0, 256, L, np.uint8),
        rng.integers(0, 4, L, np.uint8),
        np.frombuffer(src[o:o + L], np.uint8),
        np.tile(rng.integers(32, 127, 517, np.uint8), L // 517 + 1)[:L],
    ])
    lengths = np.array([L, L, L, L - 1000, L, L - 37], np.int32)
    for b, ln in enumerate(lengths):
        planes[b, ln:] = 0
    return planes, lengths


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def assert_layouts_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("fmt", ["lz4", "snappy"])
def test_layout_from_records_matches_jax(fmt):
    L = 16384
    planes, lengths = mixed_planes(L)
    offs, _ = jmd.detect_offsets(jnp.asarray(planes))
    noff = (offs > 0).sum(axis=1).astype(jnp.int32)
    rec = jmd.find_matches_parse_dyn(jnp.asarray(planes.reshape(6, -1, 128)), noff, offs,
                                     jnp.asarray(lengths), nrows=L // 128, seg=1024,
                                     min_match=6, interpret=True)
    want = jdc._layout_from_records(*rec, jnp.asarray(lengths), fmt=fmt)
    got = tdc._layout_from_records(*(t(x) for x in rec), t(lengths), fmt=fmt)
    assert_layouts_equal(got, want)
    assert int(got["nseq"].sum()) > 0


@pytest.mark.parametrize("fmt,wcap", [("lz4", 8), ("lz4", None), ("snappy", 2)])
def test_parse_and_size_matches_jax(fmt, wcap):
    L, seg = 8192, 256
    planes, lengths = mixed_planes(L)
    offs, _ = jmd.detect_offsets(jnp.asarray(planes))
    noff = (offs > 0).sum(axis=1).astype(jnp.int32)
    mlen, moff = jmd.find_matches_dyn(jnp.asarray(planes.reshape(6, -1, 128)), noff, offs,
                                      nrows=L // 128, max_match=seg, interpret=True)
    kw = dict(seg=seg, min_match=6, length=L, wcap=wcap, fmt=fmt)
    want = jdc.parse_and_size(mlen.reshape(6, L), moff.reshape(6, L), jnp.asarray(lengths), **kw)
    got = tdc.parse_and_size(t(mlen).reshape(6, L), t(moff).reshape(6, L), t(lengths), **kw)
    assert_layouts_equal(got, want)
    if wcap == 2:
        assert got["truncated"].any(), "a two-slot cap must truncate some block"


@pytest.mark.parametrize("seg,out_width,fmt,fft", [
    (1024, None, "lz4", False), (256, None, "lz4", False), (1024, 2048, "lz4", True),
    (1024, 128, "lz4", False), (1024, 40000, "lz4", False), (1024, 2048, "snappy", False),
    (256, 1024, "snappy", True), (1024, None, "lz4", "sample")])
def test_compress_blocks_device_matches_jax(seg, out_width, fmt, fft):
    L = 16384
    planes, lengths = mixed_planes(L, seed=8)
    kw = dict(seg=seg, out_width=out_width, fmt=fmt, detect_fft=fft, fft_k=2)
    jout, jsz = jdc.compress_blocks_device(planes, lengths, interpret=True, **kw)
    tout, tsz = tdc.compress_blocks_device(t(planes), t(lengths), **kw)
    jout, jsz, tout, tsz = np.asarray(jout), np.asarray(jsz), tout.numpy(), tsz.numpy()
    np.testing.assert_array_equal(tsz, jsz)
    assert tout.shape == jout.shape
    kept = np.flatnonzero(tsz <= tout.shape[1])
    np.testing.assert_array_equal(tout[kept], jout[kept])
    decode = native.lz4_decompress if fmt == "lz4" else native.snappy_decompress
    good = [b for b in kept if tsz[b] < lengths[b]]
    assert good, "some block must compress"
    for b in good:
        dec = np.asarray(decode(tout[b, :tsz[b]], int(lengths[b])))
        assert dec.tobytes() == planes[b, :lengths[b]].tobytes(), f"block {b}"


def test_static_offsets_name_kernel_b3():
    # offsets given: kernel B3 scores the static tuple (values out), and the
    # parse keeps the worst-case sequence budget; sizes and rows as the JAX's.
    planes, lengths = mixed_planes(4096)
    kw = dict(offsets=(64, 1, 517, 25), seg=1024)
    jout, jsz = jdc.compress_blocks_device(planes, lengths, interpret=True, **kw)
    tout, tsz = tdc.compress_blocks_device(t(planes), t(lengths), **kw)
    sz = tsz.numpy()
    np.testing.assert_array_equal(sz, np.asarray(jsz))
    kept = np.flatnonzero(sz <= tout.shape[1])
    np.testing.assert_array_equal(tout.numpy()[kept], np.asarray(jout)[kept])
    good = np.flatnonzero(sz < lengths)
    assert good.size >= 3
    for b in good:
        dec = np.asarray(native.lz4_decompress(tout.numpy()[b, :sz[b]], int(lengths[b])))
        assert dec.tobytes() == planes[b, :lengths[b]].tobytes(), f"block {b}"


@pytest.mark.parametrize("entry", [tdc.compress_blocks_device, tdc.match_parse_device])
def test_numpy_input_runs_on_the_card(entry, monkeypatch):
    # As jnp.asarray puts numpy input on the accelerator, the port's entry
    # points send numpy planes to CUDA: without it they raise, and only CPU
    # tensors take the plain versions.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    planes, lengths = mixed_planes(4096)
    with pytest.raises(btt.StatusError) as ei:
        entry(planes, lengths)
    assert ei.value.status.code == btt.StatusCode.INVALID
    assert "torch.cuda.is_available()" in ei.value.status.message
    got = entry(t(planes), t(lengths))
    sizes = got[1] if entry is tdc.compress_blocks_device else got["total"]
    assert sizes.device.type == "cpu"


def test_argument_errors_match_jax():
    planes, lengths = mixed_planes(4096)
    for kw in (dict(fmt="snappy", out_width=128), dict(max_match=4096),
               dict(max_match=2000, out_width=4096)):
        with pytest.raises(bt.StatusError) as je:
            jdc.compress_blocks_device(planes, lengths, interpret=True, **kw)
        with pytest.raises(btt.StatusError) as te:
            tdc.compress_blocks_device(t(planes), t(lengths), **kw)
        assert te.value.status.code.value == je.value.status.code.value, kw


# ---------------------------------------------------------------------------
# The reference's segment-lane fault


def lane_fault_block(L: int) -> np.ndarray:
    """Random bytes for the first third, then a third where each byte
    repeats the one 16384 + 640 before it, then a tail of period 640: the
    detector finds offsets 640 and 17024, which reach across segments."""
    rng = np.random.default_rng(48)
    x = np.zeros(L, np.uint8)
    a = L // 3
    x[:a] = rng.integers(0, 256, a, np.uint8)
    for p in range(a, 2 * a):
        x[p] = x[p - 16384 - 640] if p >= 16384 + 640 else x[p - 640]
    for p in range(2 * a, L):
        x[p] = x[p - 640]
    return x[None]


def test_reference_lane_fault_at_48k():
    # 48 KiB blocks have 48 segments of 1024 bytes.  The reference's B5
    # takes the source segment as (g - q) & 47, not mod 48, and emits a
    # stream that decodes to other bytes; the port reads x[p - d] and
    # decodes right.  Should the reference be fixed, this test flags it.
    L = 48 * 1024
    x = lane_fault_block(L)
    lens = np.array([L], np.int32)
    offs = np.asarray(jmd.detect_offsets(jnp.asarray(x), max_off=L - 128)[0])[0]
    assert 17024 in offs.tolist()
    jout, jsz = jdc.compress_blocks_device(x, lens, interpret=True)
    tout, tsz = tdc.compress_blocks_device(t(x), t(lens))
    jsz, tsz = int(np.asarray(jsz)[0]), int(tsz[0])
    assert jsz < L and tsz < L
    jdec = np.asarray(native.lz4_decompress(np.asarray(jout)[0, :jsz], L))
    tdec = np.asarray(native.lz4_decompress(tout.numpy()[0, :tsz], L))
    assert tdec.tobytes() == x[0].tobytes()
    assert jdec.tobytes() != x[0].tobytes(), "the reference decodes right: fault fixed?"


@pytest.mark.parametrize("kib", [16, 32, 64, 128])
def test_power_of_two_segment_counts_agree(kib):
    L = kib * 1024
    x = lane_fault_block(L)
    lens = np.array([L], np.int32)
    jout, jsz = jdc.compress_blocks_device(x, lens, interpret=True)
    tout, tsz = tdc.compress_blocks_device(t(x), t(lens))
    np.testing.assert_array_equal(tsz.numpy(), np.asarray(jsz))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    sz = int(tsz[0])
    assert sz < L
    assert np.asarray(native.lz4_decompress(tout.numpy()[0, :sz], L)).tobytes() == x[0].tobytes()


# ---------------------------------------------------------------------------
# The engine with compress_matcher="device"


def engine_data(block: int, seed: int = 3) -> bytes:
    rng = np.random.default_rng(seed)
    src = (ROOT / "SURVEY.md").read_bytes()
    return (((b"engine device matcher %d " % seed) * (block // 24 + 1))[:block]
            + bytes([3]) * block + rng.integers(0, 256, block, np.uint8).tobytes()
            + src[:block] + b"tail block " * 64)


def engines(codec: str, block: int, checksum: str = "none", **kw):
    kw = dict(block_size=block, burst_size=2, max_pool_slots=32, **kw)
    je = bt.Engine(bt.EngineConfig(codec=bt.Codec(codec), checksum=bt.Checksum(checksum),
                                   interpret=True, **kw)).initialize()
    te = btt.Engine(btt.EngineConfig(codec=btt.Codec(codec), checksum=btt.Checksum(checksum),
                                     **kw), device="cpu").initialize()
    return je, te


@pytest.mark.parametrize("block", [16 * 1024, 128 * 1024])
def test_engine_device_matcher_matches_jax(block):
    data = engine_data(block)
    je, te = engines("lz4", block, compress_matcher="device", checksum="crc32")
    ju, tu = je.compress(data), te.compress(data)
    np.testing.assert_array_equal(tu.manifest.comp_len, ju.manifest.comp_len)
    np.testing.assert_array_equal(tu.manifest.codec_ids, ju.manifest.codec_ids)
    assert tu.to_host().to_bytes() == ju.to_host().to_bytes()
    assert (tu.manifest.codec_ids == btt.manifest.codec_id(btt.Codec.LZ4)).any()
    assert te.decompress(tu).tobytes() == data
    assert te.recycle(tu) == tu.nblocks
    je.release()
    te.release()


def test_engine_snappy_device_takes_the_host_matcher():
    # As in the reference, the device path is LZ4-only: Snappy with
    # compress_matcher="device" compresses on the host.
    block = 16 * 1024
    data = engine_data(block, seed=4)
    je, te = engines("snappy", block, compress_matcher="device")
    ju, tu = je.compress(data), te.compress(data)
    assert tu.to_host().to_bytes() == ju.to_host().to_bytes()
    assert te.decompress(tu).tobytes() == data
    je.release()
    te.release()


def test_engine_match_offsets_name_kernel_b3():
    # The device matcher with match_offsets: B3, the parse and the emitter.
    block = 16 * 1024
    data = engine_data(block)
    je, te = engines("lz4", block, compress_matcher="device", match_offsets=(64, 1, 24))
    ju, tu = je.compress(data), te.compress(data)
    np.testing.assert_array_equal(tu.manifest.comp_len, ju.manifest.comp_len)
    assert tu.to_host().to_bytes() == ju.to_host().to_bytes()
    assert (tu.manifest.codec_ids == btt.manifest.codec_id(btt.Codec.LZ4)).any()
    assert te.decompress(tu).tobytes() == data
    assert te.recycle(tu) == tu.nblocks and te.arena.pool.in_use() == 0
    je.release()
    te.release()


@pytest.mark.parametrize("matcher", ["tpu", "tpu-sort"])
def test_engine_tpu_matchers_name_what_is_missing(matcher):
    # The tpu (B3 hints) and tpu-sort (sort hints) matchers, LZ4 and Snappy:
    # the host emitter writes the same containers as the reference's.
    block = 16 * 1024
    data = engine_data(block, seed=6)
    for codec in ("lz4", "snappy"):
        je, te = engines(codec, block, compress_matcher=matcher, min_match=4)
        ju, tu = je.compress(data), te.compress(data)
        assert tu.to_host().to_bytes() == ju.to_host().to_bytes(), codec
        assert tu.manifest.ratio() > 1.2
        assert te.decompress(tu).tobytes() == data
        je.release()
        te.release()


def test_device_compressed_units_cross_packages():
    block = 16 * 1024
    data = engine_data(block, seed=5)
    je, te = engines("lz4", block, compress_matcher="device")
    jblob = je.compress(data).to_host().to_bytes()
    tblob = te.compress(data).to_host().to_bytes()
    unit = unit_from_reference(jblob, te)
    assert te.decompress(unit).tobytes() == data
    ju = je.import_unit(bt.CompressedBuffers.from_bytes(tblob))
    assert je.decompress(ju).tobytes() == data
    je.release()
    te.release()


def test_corpus_functions_match_bench():
    assert corpus.make_corpus(8) == bench.make_corpus(8)
    assert corpus.make_text_corpus(4) == bench.make_text_corpus(4)
