"""The bench corpora, byte for byte as the root ``bench.py`` builds them.

``bench.py`` belongs to the JAX side (it imports JAX to measure), so the
port keeps its own copy of the two corpus functions; a CPU test holds their
bytes equal to ``bench.make_corpus`` and ``bench.make_text_corpus``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

BLOCK = 128 * 1024
_SURVEY = Path(__file__).resolve().parents[2] / "SURVEY.md"


def make_corpus(nblocks: int) -> bytes:
    """Text, low-entropy, random and RLE blocks in turn (128 KiB each)."""
    rng = np.random.default_rng(2026)
    parts = []
    for i in range(nblocks):
        k = i % 4
        if k == 0:
            p = (b"The quick brown fox jumps over the lazy dog %d. " % i) * (BLOCK // 47 + 1)
        elif k == 1:
            p = rng.integers(0, 16, BLOCK, dtype=np.uint8).tobytes()
        elif k == 2:
            p = rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes()
        else:
            p = bytes([i & 0xFF]) * BLOCK
        parts.append(p[:BLOCK])
    return b"".join(parts)


def make_text_corpus(nblocks: int) -> bytes:
    """The repository's SURVEY.md tiled over ``nblocks`` blocks, each block
    tagged with its index so that no two blocks are identical."""
    base = _SURVEY.read_bytes()
    reps = -(-(nblocks * BLOCK) // len(base))
    buf = bytearray((base * reps)[:nblocks * BLOCK])
    for i in range(nblocks):
        tag = b"[[blk %06d]]" % i
        buf[i * BLOCK:i * BLOCK + len(tag)] = tag
    return bytes(buf)
