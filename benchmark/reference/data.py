"""The inputs of every cell, made from the seed alone.

Plain NumPy: nothing here imports the program, so the bytes a run hands the
program and the bytes its output is judged against come from one place.

* :func:`bench_corpus` is the repository's bench corpus (text, low-entropy,
  random and RLE blocks in turn; ``bitar_tpu_torch/utils/corpus.py`` and the
  root ``bench.py`` build it with the fixed seed 2026), seeded by the run.
* :func:`skewed_corpus` is the CLI's skewed suite (``make_skewed_input``:
  log-uniform sizes from 4 KiB to the block size, text, 5-bit random and RLE
  payloads in turn).  Its sizes are drawn once from the CLI's own seed 11, so
  every run seed gets the same set of sizes and payload kinds; the run seed
  orders them and draws the random bytes.
"""

from __future__ import annotations

import numpy as np

SKEW_SIZE_SEED = 11    # make_skewed_input's default seed: the sizes all seeds share


def bench_corpus(seed: int, nblocks: int, block: int) -> np.ndarray:
    """``nblocks`` blocks of ``block`` bytes: block ``i`` is text (i % 4 == 0),
    4-bit random (1), 8-bit random (2) or the byte ``i & 0xFF`` repeated (3)."""
    rng = np.random.default_rng(seed)
    out = np.empty(nblocks * block, np.uint8)
    for i in range(nblocks):
        dst = out[i * block:(i + 1) * block]
        k = i % 4
        if k == 0:
            text = (b"The quick brown fox jumps over the lazy dog %d. " % i) * (block // 47 + 1)
            dst[:] = np.frombuffer(text, np.uint8, count=block)
        elif k == 1:
            dst[:] = rng.integers(0, 16, block, dtype=np.uint8)
        elif k == 2:
            dst[:] = rng.integers(0, 256, block, dtype=np.uint8)
        else:
            dst[:] = i & 0xFF
    return out


def skewed_sizes(nblocks: int, block: int, min_size: int) -> np.ndarray:
    """The shared block sizes: ``make_skewed_input``'s log-uniform draw."""
    rng = np.random.default_rng(SKEW_SIZE_SEED)
    lo, hi = np.log2(min(min_size, block)), np.log2(block)
    return np.minimum(block, np.exp2(rng.uniform(lo, hi, nblocks)).astype(np.int64))


def skewed_corpus(seed: int, nblocks: int, block: int, min_size: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(bytes, sizes [nblocks] int64): the shared (size, kind) pairs in an
    order drawn from ``seed``; kind 0 is text, 1 is 5-bit random, 2 is RLE."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(nblocks)
    sizes = skewed_sizes(nblocks, block, min_size)[order]
    kinds = (np.arange(nblocks) % 3)[order]
    out = np.empty(int(sizes.sum()), np.uint8)
    pos = 0
    for i, (n, k) in enumerate(zip(sizes.tolist(), kinds.tolist(), strict=True)):
        dst = out[pos:pos + n]
        if k == 0:
            dst[:] = np.frombuffer((b"skewed %d " % i) * (n // 8 + 1), np.uint8, count=n)
        elif k == 1:
            dst[:] = rng.integers(0, 32, n, dtype=np.uint8)
        else:
            dst[:] = i & 0xFF
        pos += n
    return out, sizes


def make(data_cfg: dict, seed: int, block: int) -> tuple[np.ndarray, np.ndarray]:
    """The bytes and block sizes a configuration's ``data`` section names."""
    gen = data_cfg["generator"]
    nblocks = data_cfg["units"] * data_cfg["unit_blocks"]
    if gen == "bench_corpus":
        return bench_corpus(seed, nblocks, block), np.full(nblocks, block, np.int64)
    if gen == "skewed":
        return skewed_corpus(seed, nblocks, block, data_cfg["min_size"])
    raise ValueError(f"unknown data generator {gen!r}")
