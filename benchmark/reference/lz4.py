"""A plain LZ4 block decoder (the LZ4 block format, no frame), frozen here.

It is the benchmark's own, written from the format's description and
independent of the program: a token's high nibble is the literal count and
its low nibble the match length less 4 (15 extends with bytes up to one
below 255), literals follow, then a two-byte little-endian offset; the last
sequence carries literals only.  ``lossy`` drops each block's final literal
run, the shortcut a decoder could be tempted into (the format guarantees at
least five literals there): the control that every correctness check has to
fail.
"""

from __future__ import annotations

import numpy as np

RAW_ID = 3      # the codec id the manifest gives a block stored as it came


class FormatError(ValueError):
    """The stream is not a valid LZ4 block of the stated length."""


def _length(src: bytes, i: int, n: int) -> tuple[int, int]:
    total = 0
    while True:
        if i >= len(src):
            raise FormatError("length runs past the end of the block")
        b = src[i]
        i += 1
        total += b
        if b != 255:
            return n + total, i


def decode(src: bytes, raw_len: int, lossy: bool = False) -> np.ndarray:
    """Decode one LZ4 block that holds ``raw_len`` bytes; raises FormatError."""
    out = np.zeros(raw_len, np.uint8)
    data = np.frombuffer(src, np.uint8)
    i = o = 0
    end = len(src)
    while i < end:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            lit, i = _length(src, i, lit)
        if i + lit > end or o + lit > raw_len:
            raise FormatError("literals run past the block")
        last = i + lit == end
        if not (last and lossy):
            out[o:o + lit] = data[i:i + lit]
        i += lit
        o += lit
        if last:
            break
        if i + 2 > end:
            raise FormatError("offset runs past the block")
        off = src[i] | (src[i + 1] << 8)
        i += 2
        mlen = token & 15
        if mlen == 15:
            mlen, i = _length(src, i, mlen)
        mlen += 4
        start = o - off
        if off == 0 or start < 0 or o + mlen > raw_len:
            raise FormatError(f"match at {o} (offset {off}, length {mlen}) is out of range")
        if off >= mlen:
            out[o:o + mlen] = out[start:start + mlen]
        else:
            out[o:o + mlen] = np.tile(out[start:o], -(-mlen // off))[:mlen]
        o += mlen
    if o != raw_len:
        raise FormatError(f"decoded {o} bytes, the block holds {raw_len}")
    return out


def decode_stored(src: bytes, codec_id: int, raw_len: int, lossy: bool = False) -> np.ndarray:
    """A block as the manifest records it: LZ4 (id 0) or stored (``RAW_ID``)."""
    if codec_id == RAW_ID:
        if len(src) != raw_len:
            raise FormatError(f"stored block of {len(src)} bytes, the block holds {raw_len}")
        out = np.frombuffer(src, np.uint8).copy()
        if lossy:
            out[-5:] = 0
        return out
    if codec_id != 0:
        raise FormatError(f"codec id {codec_id} is not LZ4")
    return decode(src, raw_len, lossy)
