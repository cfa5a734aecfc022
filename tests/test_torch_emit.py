"""The port's emitter (plain version of ``csrc/emit.cu``) against the JAX
package's three emitters on the CPU: the packed Pallas kernel B8 (LZ4 and
Snappy), the compact + windowed pair B9 + B10 (LZ4, width 128) and the XLA
``materialize`` (LZ4, any width).

Every emitter gets the same layout, made by the JAX package's
``_match_parse`` from numpy-seeded blocks.  Tolerance 0 on every byte of a
row, zeros past its total included.  A row whose total exceeds the width is
garbage by contract (the caller stores that block RAW) and is not compared.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitar_tpu.ops import device_compress as jdc
from bitar_tpu.ops.cpu import native
from bitar_tpu.ops.pallas import lz4_emit as jemit
import bitar_tpu_torch as btt
from bitar_tpu_torch.ops import emit as temit

torch.set_num_threads(1)

L = 8192


def planes_and_lengths():
    """Blocks that give long literal runs (several length-extension bytes,
    Snappy's 1- and 2-byte literal lengths), long matches (several Snappy
    copy elements), many short sequences and tail blocks (the last one
    short enough to fit a 256-byte Snappy row)."""
    rng = np.random.default_rng(21)
    head = np.concatenate([rng.integers(0, 256, 700, np.uint8), np.full(L - 700, 9, np.uint8)])
    mixed = rng.integers(0, 256, L, np.uint8)
    mixed[3000:5000] = np.tile(mixed[1000:1100], 20)
    planes = np.stack([
        np.frombuffer((b"emitter parity ab " * (L // 18 + 1))[:L], np.uint8),
        head,
        rng.integers(0, 256, L, np.uint8),
        np.tile(rng.integers(32, 127, 517, np.uint8), L // 517 + 1)[:L],
        mixed,
        np.tile(rng.integers(0, 256, 70, np.uint8), L // 70 + 1)[:L],
        np.full(L, 0x2E, np.uint8),
    ])
    lengths = np.array([L, L, L, L - 100, L, L - 3000, 1500], np.int32)
    for b, ln in enumerate(lengths):
        planes[b, ln:] = 0
    return planes, lengths


@functools.cache
def layouts(fmt: str):
    planes, lengths = planes_and_lengths()
    lay = jdc._match_parse(jnp.asarray(planes), jnp.asarray(lengths), seg=1024, min_match=6,
                           mm=1024, detect_k=4, interpret=True, offsets=None,
                           detect_fft=True, fmt=fmt)
    tlay = {k: torch.from_numpy(np.array(v)) for k, v in lay.items()}
    return planes, lengths, lay, tlay


def reference_emit(route: str, planes, lay, ow: int, fmt: str, lengths):
    if route == "packed":
        return jemit.materialize_pallas_packed(jnp.asarray(planes), lay, out_width=ow,
                                               interpret=True, fmt=fmt,
                                               lengths=jnp.asarray(lengths))
    if route == "compact":
        return jemit.materialize_pallas(jnp.asarray(planes), lay, out_width=ow, interpret=True)
    return jdc.materialize(jnp.asarray(planes), lay, out_width=ow)


CASES = [("packed", "lz4", 256), ("packed", "lz4", 1024), ("packed", "lz4", 2048),
         ("packed", "snappy", 256), ("packed", "snappy", 1024), ("packed", "snappy", 2048),
         ("compact", "lz4", 128), ("xla", "lz4", jdc.lz4_bound(L))]


@pytest.mark.parametrize("route,fmt,ow", CASES)
def test_emit_plain_matches_jax(route, fmt, ow):
    planes, lengths, lay, tlay = layouts(fmt)
    want = np.asarray(reference_emit(route, planes, lay, ow, fmt, lengths))
    got = temit.emit_blocks(torch.from_numpy(planes), tlay, out_width=ow, fmt=fmt,
                            lengths=torch.from_numpy(lengths)).numpy()
    assert got.shape == want.shape == (len(planes), ow)
    total = np.asarray(lay["total"])
    kept = np.flatnonzero(total <= ow)
    assert kept.size, "no row fits this width"
    np.testing.assert_array_equal(got[kept], want[kept])
    decode = native.lz4_decompress if fmt == "lz4" else native.snappy_decompress
    for b in kept:
        dec = np.asarray(decode(got[b, :total[b]], int(lengths[b])))
        assert dec.tobytes() == planes[b, :lengths[b]].tobytes(), f"block {b}"


def test_layout_exercises_long_fields():
    # The blocks above reach the emitter's multi-byte branches.
    _, _, _, tlay = layouts("lz4")
    assert int(tlay["lit_len"].max()) >= 15 + 255       # two or more LZ4 extension bytes
    assert int(tlay["mv"].max()) >= 15 + 255
    assert int((tlay["mv"] >= 60).sum()) > 0            # several Snappy copy elements


# The shared edge layouts (``emit.edge_layouts``): empty slots before real
# ones, a literal across several warps' shares of the output, rows longer
# than the width, 1-, 2- and 3-byte Snappy varints, LZ4 widths that are not
# a multiple of 16, and the worst-case slot budget (wcap None).
EDGE_L = 16384
EDGE_CASES = [(fmt, wcap, route, ow) for wcap in (8, None) for fmt, route, ow in (
    ("lz4", "packed", 2048), ("lz4", "packed", 8192), ("lz4", "compact", 1000),
    ("lz4", "xla", 1001), ("lz4", "xla", jdc.lz4_bound(EDGE_L)),
    ("snappy", "packed", 256), ("snappy", "packed", 8192), ("snappy", "packed", 16512))]


@functools.cache
def edge(fmt: str, wcap):
    return temit.edge_layouts(EDGE_L, fmt=fmt, wcap=wcap, n=8)


@pytest.mark.parametrize("fmt,wcap,route,ow", EDGE_CASES)
def test_emit_plain_matches_jax_on_edge_layouts(fmt, wcap, route, ow):
    planes, lengths, lay = edge(fmt, wcap)
    want = np.asarray(reference_emit(route, planes, {k: jnp.asarray(v) for k, v in lay.items()},
                                     ow, fmt, lengths))
    got = temit.emit_blocks(torch.from_numpy(planes), {k: torch.from_numpy(v) for k, v in lay.items()},
                            out_width=ow, fmt=fmt, lengths=torch.from_numpy(lengths)).numpy()
    assert got.shape == want.shape == (len(planes), ow)
    total = lay["total"]
    kept = np.flatnonzero(total <= ow)
    assert kept.size, "no row fits this width"
    np.testing.assert_array_equal(got[kept], want[kept])
    decode = native.lz4_decompress if fmt == "lz4" else native.snappy_decompress
    for b in kept:
        dec = np.asarray(decode(got[b, :total[b]], int(lengths[b])))
        assert dec.tobytes() == planes[b, :lengths[b]].tobytes(), f"block {b}"


def test_edge_layouts_reach_their_edges():
    planes, lengths, lay = edge("snappy", None)
    starts = lay["starts"]
    assert starts.shape[1] == EDGE_L // 1024 * (1024 // 6 + 1) + 1    # the worst-case budget
    real = lay["taken"][:, :-1]
    assert (real[:, 1:] & ~real[:, :-1]).any(), "an empty slot before a real one"
    assert (lay["total"] > EDGE_L).any(), "a row longer than any width under L"
    vl = {1 + int(n >= 128) + int(n >= 16384) for n in lengths}
    assert vl == {1, 2, 3}, "Snappy varints of 1, 2 and 3 bytes"
    assert int(lay["lit_len"].max()) >= 3000 and int(lay["mv"].max()) >= 60


@pytest.mark.parametrize("case,match", [
    ("format", "emit format 'zstd' not in"),
    ("planes", r"planes: want \[N, L\] uint8, got \[2, 256\] torch.int32"),
    ("width", "out_width 0 must be positive"),
    ("device", "emit_blocks: no kernel for device meta")])
def test_emit_blocks_rejects_what_it_cannot_emit(case, match):
    # Each check raises StatusError with its message, built only on failure.
    planes = torch.zeros((2, 256), dtype=torch.uint8)
    kw = dict(out_width=128, fmt="lz4")
    if case == "format":
        kw["fmt"] = "zstd"
    elif case == "planes":
        planes = planes.int()
    elif case == "width":
        kw["out_width"] = 0
    else:
        planes = planes.to("meta")
    with pytest.raises(btt.StatusError, match=match):
        temit.emit_blocks(planes, {}, **kw)
