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
