"""The device matchers and the dense-plan decode (B7) at blocks of 256 KiB
to 1 MiB, in the port against the JAX package, on the CPU.

* the engines' containers at 256 KiB (``compress_matcher="tpu"``, LZ4 and
  Snappy; ``"tpu-sort"``, LZ4; ``"device"`` with ``match_offsets`` at
  ``min_match`` 9 and 64) are equal byte for byte, and both packages
  raise the same errors there: the worst-case sequence budget at
  ``min_match`` 6, and the detectors, which take no block above 128 KiB in
  either package;
* at 1 MiB, on two blocks: B3 (``find_matches``, offset 65,535),
  ``parse_and_size`` and the emitter against the JAX ``find_matches``
  (interpret mode), ``parse_and_size`` and its XLA ``materialize``;
* B7's plain version at 2048 rows against the JAX ``decode_blocks_planned``
  (interpret mode), and at 8192 rows against the planner's raw bytes;
* ``EngineConfig.validate`` on the H100 record against ``TPU_V5E`` over the
  matchers, block sizes of 16 KiB to 1 MiB and ``min_match``.

Inputs come from numpy seeds, ``SURVEY.md`` and the bench corpora; the
port's wrappers take their plain versions on CPU tensors.  Tolerance 0:
sizes, layouts, statuses and bytes are integers.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitar_tpu as bt
import bitar_tpu_torch as btt
from bitar_tpu.ops import device_compress as jdc
from bitar_tpu.ops.pallas import lz4_decode_planned as jdp
from bitar_tpu.ops.pallas import lz4_match as jmatch
from bitar_tpu_torch import config as tconfig
from bitar_tpu_torch.ops import decode_planned as tdp
from bitar_tpu_torch.ops import device_compress as tdc
from bitar_tpu_torch.ops import emit as temit
from bitar_tpu_torch.ops import match as tmatch
from bitar_tpu_torch.utils.corpus import make_corpus, make_text_corpus

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
KIB = 1024
MIB = 1 << 20
#: A static tuple whose last offset is the LZ4 format's largest.
FAR_OFFSETS = (64, 1, 24, 65535)


def engine_data(block: int, seed: int = 3) -> bytes:
    """Four blocks and a tail: a phrase of 24 bytes repeated, random bytes of
    period 65,535 (only the farthest offset matches), markdown, low-entropy
    bytes."""
    rng = np.random.default_rng(seed)
    src = (ROOT / "SURVEY.md").read_bytes()
    period = rng.integers(0, 256, 65535, np.uint8)
    return (((b"large blocks matcher %02d " % seed) * (block // 24 + 1))[:block]
            + np.resize(period, block).tobytes() + src[:block]
            + rng.integers(0, 6, block, np.uint8).tobytes() + b"tail block " * 64)


def engines(codec: str, block: int, **kw):
    kw = dict(block_size=block, burst_size=2, max_pool_slots=32, **kw)
    je = bt.Engine(bt.EngineConfig(codec=bt.Codec(codec), interpret=True, **kw)).initialize()
    te = btt.Engine(btt.EngineConfig(codec=btt.Codec(codec), **kw), device="cpu").initialize()
    return je, te


@pytest.mark.parametrize("codec,kw", [
    ("lz4", dict(compress_matcher="tpu")),
    ("snappy", dict(compress_matcher="tpu")),
    ("lz4", dict(compress_matcher="tpu-sort")),
    ("lz4", dict(compress_matcher="device", match_offsets=FAR_OFFSETS, min_match=9)),
    ("lz4", dict(compress_matcher="device", match_offsets=FAR_OFFSETS, min_match=64)),
], ids=["tpu-lz4", "tpu-snappy", "tpu-sort-lz4", "device-offsets-mm9", "device-offsets-mm64"])
def test_engine_containers_at_256k_match_jax(codec, kw):
    block = 256 * KIB
    data = engine_data(block)
    je, te = engines(codec, block, **kw)
    ju, tu = je.compress(data), te.compress(data)
    np.testing.assert_array_equal(tu.manifest.comp_len, ju.manifest.comp_len)
    assert tu.to_host().to_bytes() == ju.to_host().to_bytes()
    # The phrase compresses at offset 24; the period-65535 block only through
    # the farthest offset, which match_offsets list and the sort matcher
    # finds among all offsets of the window.
    assert tu.manifest.comp_len[0] < block // 8
    far = "match_offsets" in kw or kw["compress_matcher"] == "tpu-sort"
    assert (tu.manifest.comp_len[1] < block // 2) == far
    assert te.decompress(tu).tobytes() == data
    je.release()
    te.release()


def test_device_matcher_errors_match_jax_at_256k():
    block = 256 * KIB
    data = engine_data(block)
    # match_offsets keep the worst-case budget: 256 segments x (1024 // 6 + 1)
    # slots, past the 2^15 the emission packs.
    je, te = engines("lz4", block, compress_matcher="device", match_offsets=FAR_OFFSETS)
    with pytest.raises(bt.StatusError, match=r"too many sequence slots \(43777\)"):
        je.compress(data)
    with pytest.raises(btt.StatusError, match=r"too many sequence slots \(43777\)"):
        te.compress(data)
    assert te.arena.pool.in_use() == 0
    je.release()
    te.release()
    # The detectors sample every 64 bytes and index the samples in 11 bits:
    # neither package's takes a block above 128 KiB.
    je, te = engines("lz4", block, compress_matcher="device")
    with pytest.raises(AssertionError, match="sample index must fit 11 bits"):
        je.compress(data)
    with pytest.raises(ValueError, match="sample index must fit 11 bits"):
        te.compress(data)
    je.release()
    te.release()


@pytest.fixture(scope="module")
def mib_batch():
    """Two 1 MiB blocks (markdown, random bytes of period 65,535; the second
    37 bytes short), zero past each length, and the JAX B3 values of
    FAR_OFFSETS at max_match 1024 (interpret mode)."""
    rng = np.random.default_rng(11)
    x = np.stack([np.frombuffer(make_text_corpus(8)[:MIB], np.uint8),
                  np.resize(rng.integers(0, 256, 65535, np.uint8), MIB)])
    lengths = np.array([MIB, MIB - 37], np.int32)
    x[1, MIB - 37:] = 0
    planes = x.reshape(2, MIB // 128, 128)
    kw = dict(offsets=FAR_OFFSETS, nrows=MIB // 128, max_match=1024, emit_values=True)
    jl, jo = (np.array(a) for a in jmatch.find_matches(jnp.asarray(planes), interpret=True,
                                                         **kw))
    return x, lengths, jl.reshape(2, MIB), jo.reshape(2, MIB)


@pytest.mark.parametrize("max_match,emit_values", [(64, False), (1024, True)])
def test_find_matches_at_1mib_matches_jax(mib_batch, max_match, emit_values):
    x, _, jl, jo = mib_batch
    kw = dict(offsets=FAR_OFFSETS, nrows=MIB // 128, max_match=max_match,
              emit_values=emit_values)
    gl, go = tmatch.find_matches(torch.from_numpy(x).view(2, -1, 128), **kw)
    if max_match == 1024:
        wl, wo = jl, jo
    else:
        wl, wo = (np.asarray(a).reshape(2, MIB) for a in jmatch.find_matches(
            jnp.asarray(x.reshape(2, -1, 128)), interpret=True, **kw))
    np.testing.assert_array_equal(gl.reshape(2, MIB).numpy(), wl)
    np.testing.assert_array_equal(go.reshape(2, MIB).numpy(), wo)
    # The second block matches at the farthest offset almost everywhere.
    far = 65535 if emit_values else 3
    assert (wo[1, 65535:] == far).mean() > 0.99


def test_parse_and_emit_at_1mib_match_jax(mib_batch):
    # The engine's match_offsets path at 1 MiB: the parse with the
    # worst-case budget at min_match 64 (17,409 slots) and the emitter at the
    # width of the LZ4 bound, against the JAX parse and its XLA materialize.
    x, lengths, jl, jo = mib_batch
    kw = dict(seg=1024, min_match=64, length=MIB, wcap=None)
    want = jdc.parse_and_size(jnp.asarray(jl), jnp.asarray(jo), jnp.asarray(lengths), **kw)
    got = tdc.parse_and_size(torch.from_numpy(jl), torch.from_numpy(jo),
                             torch.from_numpy(lengths), **kw)
    assert sorted(got) == sorted(want) and got["starts"].shape == (2, 17409)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    ow = -(-tdc.lz4_bound(MIB) // 128) * 128
    assert ow == 1052800
    wout = np.asarray(jdc.materialize(jnp.asarray(x), want, out_width=ow))
    gout = temit.emit_blocks(torch.from_numpy(x), got, out_width=ow, lengths=torch.from_numpy(lengths))
    np.testing.assert_array_equal(gout.numpy(), wout)
    assert got["total"][1] < lengths[1] // 2


def test_decode_planned_at_2048_rows_matches_jax():
    L = 256 * KIB
    data = make_corpus(2)
    wire = tdp.plan_blocks([data[:L]], L, 256)
    assert wire["fit"] == [0]
    args = [wire[k] for k in ("comp", "p_used", "se", "shift")]
    kw = dict(passes=wire["passes"], comp_rows=wire["comp_rows"], out_rows=L // 128)
    want = np.asarray(jdp.decode_blocks_planned(*(jnp.asarray(a) for a in args),
                                                interpret=True, **kw))
    got = tdp.decode_blocks_planned(*(torch.from_numpy(a) for a in args), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tobytes() == data[:L]


def test_decode_planned_at_8192_rows_decodes_raw_bytes():
    # A text block of 1 MiB: comp-only passes and plane-reading ones.
    data = make_text_corpus(8)[:MIB]
    wire = tdp.plan_blocks([data], MIB, 256)
    assert wire["fit"] == [0] and wire["p_used"][0] > wire["p0"][0]
    got = tdp.decode_blocks_planned(*(torch.from_numpy(wire[k])
                                      for k in ("comp", "p_used", "se", "shift")),
                                    passes=wire["passes"], comp_rows=wire["comp_rows"],
                                    out_rows=MIB // 128)
    assert got.numpy().tobytes() == data


@pytest.mark.parametrize("matcher", ["host", "tpu", "tpu-sort", "device"])
def test_h100_validate_equals_tpu_v5e(matcher):
    # Every block size and min_match the H100 record takes or refuses, the
    # JAX package's TPU record takes or refuses with the same status code.
    caps = tconfig.cuda_capabilities("NVIDIA H100 80GB HBM3", 80 << 30, 232448)
    codes = set()
    for block in (16 * KIB, 24 * KIB, 100000, 128 * KIB, 144 * KIB, 256 * KIB, 512 * KIB,
                  768 * KIB, MIB):
        for min_match in (4, 6, 9, 33, 34, 64):
            for offsets in ((), (1, 65535), (3, 65536)):
                kw = dict(block_size=block, compress_matcher=matcher, min_match=min_match,
                          match_offsets=offsets)
                got = btt.EngineConfig(**kw).validate(caps)
                want = bt.EngineConfig(**kw).validate(bt.config.TPU_V5E)
                assert got.code.name == want.code.name, (kw, got, want)
                codes.add(got.code.name)
    assert "OK" in codes
    assert ("INVALID" in codes) == (matcher != "host")
