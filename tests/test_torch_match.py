"""The static-offset matcher (B3) and the sort matcher of the port against
the JAX package, on the CPU.

Planes of 16 KiB blocks are made from SURVEY.md and a numpy seed; the JAX
``find_matches`` runs its Pallas kernel in interpret mode, the port's wrapper
its plain PyTorch version on CPU tensors.  Tolerance 0 (integer planes).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitar_tpu.ops.pallas import lz4_match as jmatch
from bitar_tpu.ops.pallas.lz4_match_sort import find_matches_sorted as jax_sorted
from bitar_tpu_torch.ops import match as tmatch
from bitar_tpu_torch.ops.match_sort import find_matches_sorted

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
L = 16 * 1024

#: Equal runs for several offsets (multiples of one period), duplicates, a 0
#: that matches everywhere, and an offset past the block.
TIES = (24, 12, 48, 12, 3, 6, 0, 17000)


def planes(seed: int) -> np.ndarray:
    """[3, 128, 128] uint8: markdown then a period-12 pattern; low-entropy
    bytes then a zero tail; RLE then random bytes."""
    rng = np.random.default_rng(seed)
    src = (ROOT / "SURVEY.md").read_bytes()
    o = int(rng.integers(0, len(src) - L // 2))
    a = np.concatenate([np.frombuffer(src[o:o + L // 2], np.uint8),
                        np.tile(rng.integers(0, 256, 12, np.uint8), L // 24 + 1)[:L // 2]])
    b = np.zeros(L, np.uint8)
    b[:L - 3000] = rng.integers(0, 4, L - 3000, np.uint8)
    c = np.concatenate([np.full(L // 2, 9, np.uint8), rng.integers(0, 256, L // 2, np.uint8)])
    return np.stack([a, b, c]).reshape(3, L // 128, 128)


@pytest.mark.parametrize("max_match", [64, 100, 256])
@pytest.mark.parametrize("emit_values", [False, True])
@pytest.mark.parametrize("offsets", ["default", "ties"])
def test_find_matches_matches_jax(offsets, emit_values, max_match):
    offs = jmatch.DEFAULT_OFFSETS if offsets == "default" else TIES
    x = planes(70 + max_match)
    kw = dict(offsets=offs, nrows=L // 128, max_match=max_match, emit_values=emit_values)
    wl, wi = (np.asarray(a) for a in jmatch.find_matches(jnp.asarray(x), interpret=True, **kw))
    gl, gi = tmatch.find_matches(torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(gl.numpy(), wl)
    np.testing.assert_array_equal(gi.numpy(), wi)
    assert int(wl.max()) == max_match
    if offsets == "ties":
        # A later offset wins somewhere, and at a tie the earlier one.
        first = TIES[0] if emit_values else 0
        assert ((wl > 0) & (wi != first)).any()


def test_constants_match_jax():
    assert tmatch.DEFAULT_OFFSETS == jmatch.DEFAULT_OFFSETS
    assert tmatch.MAX_MATCH == jmatch.MAX_MATCH


@pytest.mark.parametrize("seed", [71, 72])
def test_sort_matcher_matches_jax(seed):
    x = planes(seed).reshape(3, L)
    want = np.asarray(jax_sorted(jnp.asarray(x), length=L))
    got = find_matches_sorted(torch.from_numpy(x), length=L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.3


def tiled_scores(x: np.ndarray, offsets, max_match: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's tiling in numpy: each tile of ``tile_plan`` scores its
    positions from the bytes of its ``tile_windows`` window alone (runs read
    nothing outside it), keeping the first slot of the strictly longest run
    (capped at the doubling cap; offset 0 matches everywhere)."""
    n, L = x.shape
    tp = tmatch.tile_plan(L, offsets, max_match)
    cap = tp["cap"]
    mlen = np.zeros((n, L), np.int32)
    slot = np.zeros((n, L), np.int32)
    for t0, t1, lo, hi in tmatch.tile_windows(L, tp["tile"], tp["maxoff"], cap):
        assert tp["window"] == 0 or hi - lo <= tp["window"]   # 0: read from device memory
        win = x[:, lo:hi].astype(np.int32)
        p = np.arange(lo, hi)
        best = np.zeros((n, t1 - t0), np.int32)
        kbest = np.zeros((n, t1 - t0), np.int32)
        for k, d in enumerate(offsets):
            if d == 0:
                run = np.full((n, hi - lo), cap, np.int32)
            else:
                eq = np.zeros((n, hi - lo), bool)
                ok = p - d >= lo              # a byte before the window is never read
                eq[:, ok] = win[:, ok] == win[:, (p - d - lo)[ok]]
                # The run at i ends at the first mismatch at or after i.
                i = np.arange(hi - lo)
                stop = np.minimum.accumulate(np.where(eq, hi - lo, i)[:, ::-1], axis=1)[:, ::-1]
                run = np.minimum(stop - i, cap).astype(np.int32)
            r = run[:, t0 - lo:t1 - lo]
            better = r > best
            best = np.where(better, r, best)
            kbest = np.where(better, k, kbest)
        mlen[:, t0:t1] = np.minimum(best, max_match)
        slot[:, t0:t1] = kbest
    return mlen, slot


@pytest.mark.parametrize("case", [
    ("default, 32 KiB", 32 * 1024, None, 64),
    ("default, max_match 1024", 32 * 1024, None, 1024),
    ("offsets at and past a tile's start", 32 * 1024,
     (1, 8191, 8192, 8193, 16384, 3, 32768, 40000, 12), 100),
    ("K > 32, a duplicate, 0 last", 16 * 1024, tuple(range(1, 40)) + (7, 0), 1),
    ("a far offset, 38 KiB windows", 32 * 1024, (3, 30000, 1, 64), 64),
    ("a far offset, windows past 64 KiB", 128 * 1024, (3, 70000, 1, 64), 64),
    ("256 KiB, the largest LZ4 offset", 256 * 1024, (3, 65535, 1, 64), 64),
    ("256 KiB, windows past shared memory", 256 * 1024, (3, 230000, 70000, 1), 100),
])
def test_tile_windows_hold_every_byte_a_tile_reads(case):
    _, L, offsets, max_match = case
    offsets = offsets or tmatch.DEFAULT_OFFSETS
    rng = np.random.default_rng(L + max_match)
    x = np.concatenate([planes(73).reshape(3, -1)] * (L // (16 * 1024)), axis=1)
    # Period 8192 from byte 8000: runs at offsets 8192 that cross tile edges.
    span = x[1, 8000:24000]
    span[:] = np.resize(rng.integers(0, 256, 8192, np.uint8), span.size)
    got = tiled_scores(x, offsets, max_match)
    want = tmatch.match_reference(torch.from_numpy(x), offsets, max_match=max_match)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("L,offsets,max_match,want", [
    (128 * 1024, None, 64, dict(tile=8192, maxoff=8192, cap=64, warps=8)),
    (128 * 1024, None, 1024, dict(tile=8192, maxoff=8192, cap=1024, warps=8)),
    (128 * 1024, (3, 70000, 1, 64), 64, dict(tile=8192, maxoff=70000, window=78256, warps=8)),
    (1 << 20, (1, 65535), 64, dict(tile=8192, maxoff=65535, window=73792, warps=8)),
    (1 << 20, (1, 300000, 70000), 1024, dict(tile=8192, maxoff=300000, window=0, warps=8)),
    (16 * 1024, (3, 16384, 20000, 1), 100, dict(tile=8192, maxoff=3, cap=128, warps=8)),
    (4 * 1024, None, 64, dict(tile=4096, maxoff=2048, warps=4)),
    (8 * 1024, (0,), 1, dict(tile=8192, maxoff=0, cap=1, warps=8)),
])
def test_tile_plan(L, offsets, max_match, want):
    offsets = offsets or tmatch.DEFAULT_OFFSETS
    tp = tmatch.tile_plan(L, offsets, max_match)
    assert {k: tp[k] for k in want} == want
    wins = tmatch.tile_windows(L, tp["tile"], tp["maxoff"], tp["cap"])
    # A window that shared memory holds is staged; past it every tile reads
    # the plane from device memory (window 0).
    widest = max(hi - lo for _, _, lo, hi in wins)
    assert tp["window"] == (widest if widest <= tmatch.SMEM_MAX else 0)
    # The tiles cover the plane in order; every window is 16-aligned and
    # holds the bytes from maxoff before its tile to cap past it.
    assert [w[0] for w in wins] == list(range(0, L, tp["tile"])) and wins[-1][1] == L
    for t0, t1, lo, hi in wins:
        assert lo % 16 == 0 and (hi % 16 == 0 or hi == L)
        assert lo <= max(0, t0 - tp["maxoff"]) and hi >= min(L, t1 + tp["cap"])
