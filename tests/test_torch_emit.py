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
