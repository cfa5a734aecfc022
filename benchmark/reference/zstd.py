"""A plain Zstandard frame decoder (RFC 8878), frozen here.

It is the benchmark's own, written from the RFC and independent of the
program: NumPy and Python integers, nothing of ``bitar_tpu_torch``.  It takes
one frame (magic ``0xFD2FB528``, a frame header, blocks; the content
checksum, when present, is skipped, as the program skips it too) and handles

* Raw, RLE and Compressed blocks;
* literals sections that are Raw, RLE, Compressed or Treeless, their Huffman
  weights direct (4 bits each) or FSE-compressed, in 1 or 4 streams;
* sequences sections whose three tables are Predefined, RLE, FSE-compressed
  or Repeat, and the three repeat offsets;
* Huffman and FSE tables carried from block to block within the frame.

Dictionaries are refused.  ``lossy`` leaves each compressed block's final
literal run (the literals after its last sequence) unwritten: the shortcut
of ``lz4.decode(..., lossy=True)``, the control that every correctness check
has to fail.
"""

from __future__ import annotations

import numpy as np

MAGIC = 0xFD2FB528
RAW_ID = 3      # the codec id the manifest gives a block stored as it came
ZSTD_ID = 2     # the codec id of a Zstd frame

# RFC 8878 3.1.1.3.2.1.1: literals length codes, 3.1.1.3.2.1.1 match length
# codes (baseline, extra bits), and 3.1.1.3.2.2 the predefined distributions.
LL_BASE = [*range(16), 16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048,
           4096, 8192, 16384, 32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
ML_BASE = [*range(3, 35), 35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
           2051, 4099, 8195, 16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2]
              + [1] * 5 + [-1] * 4, 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
#: The largest symbol and accuracy log of each table: literals length,
#: offset, match length, and the Huffman weights.
LL_MAX, OF_MAX, ML_MAX = (35, 9), (31, 8), (52, 9)
WEIGHT_LOG_MAX = 6


class FormatError(ValueError):
    """The bytes are not a valid Zstandard frame of the stated length."""


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise FormatError(what)


# --- bit streams -----------------------------------------------------------------

class Forward:
    """Bits read from the least significant end up (an FSE table description)."""

    def __init__(self, data: bytes):
        self.value, self.pos, self.size = int.from_bytes(data, "little"), 0, 8 * len(data)

    def read(self, n: int) -> int:
        v = (self.value >> self.pos) & ((1 << n) - 1)
        self.pos += n
        return v

    def peek(self, n: int) -> int:
        return (self.value >> self.pos) & ((1 << n) - 1)


class Backward:
    """Bits read from the end of ``data`` down (Huffman and FSE streams): the
    highest set bit of the last byte marks where they start, and bits past
    the first byte read as zeros."""

    def __init__(self, data: bytes):
        _check(len(data) > 0 and data[-1] != 0, "a backward bit stream ends in a zero byte")
        self.value = int.from_bytes(data, "little")
        self.left = 8 * len(data) - 8 + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.left -= n
        if self.left >= 0:
            return (self.value >> self.left) & ((1 << n) - 1)
        return (self.value << -self.left) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        s = self.left - n
        return ((self.value >> s) if s >= 0 else (self.value << -s)) & ((1 << n) - 1)


# --- FSE -------------------------------------------------------------------------

class Fse:
    """A decoding table (RFC 8878 4.1.1): per state its symbol, the bits to
    read and the baseline of the next state."""

    def __init__(self, counts: list[int], log: int):
        size = 1 << log
        symbol = [0] * size
        high = size - 1
        nxt = []
        for s, c in enumerate(counts):             # "less than 1" symbols take the top cells
            if c == -1:
                symbol[high] = s
                high -= 1
                nxt.append(1)
            else:
                nxt.append(c)
        step, pos = (size >> 1) + (size >> 3) + 3, 0
        for s, c in enumerate(counts):
            for _ in range(max(c, 0)):
                symbol[pos] = s
                pos = (pos + step) & (size - 1)
                while pos > high:
                    pos = (pos + step) & (size - 1)
        _check(pos == 0, "FSE counts do not fill the table")
        self.log, self.symbol, self.bits, self.base = log, symbol, [0] * size, [0] * size
        for u in range(size):
            state = nxt[symbol[u]]
            nxt[symbol[u]] += 1
            self.bits[u] = log - (state.bit_length() - 1)
            self.base[u] = (state << self.bits[u]) - size

    @classmethod
    def rle(cls, symbol: int) -> "Fse":
        t = cls.__new__(cls)
        t.log, t.symbol, t.bits, t.base = 0, [symbol], [0], [0]
        return t


def read_counts(data: bytes, max_symbol: int, max_log: int) -> tuple[list[int], int, int]:
    """An FSE table description (RFC 8878 4.1.1): (counts, accuracy log,
    bytes it took)."""
    bits = Forward(data)
    log = bits.read(4) + 5
    _check(log <= max_log, f"FSE accuracy log {log} above {max_log}")
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    counts: list[int] = []
    while remaining > 1:
        _check(len(counts) <= max_symbol, "FSE counts past the largest symbol")
        big = 2 * threshold - 1 - remaining
        low = bits.peek(nbits - 1)
        if low < big:
            value = low
            bits.pos += nbits - 1
        else:
            value = bits.peek(nbits)
            if value >= threshold:
                value -= big
            bits.pos += nbits
        count = value - 1
        remaining -= abs(count)
        counts.append(count)
        if count == 0:                       # a run of zeros follows, 2 bits at a time
            while True:
                rep = bits.read(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    _check(remaining == 1 and len(counts) <= max_symbol + 1 and bits.pos <= bits.size,
           "FSE counts do not sum to the table")
    return counts, log, (bits.pos + 7) // 8


# --- Huffman ---------------------------------------------------------------------

class Huffman:
    """A decoding table from the symbols' weights (RFC 8878 4.2.1): each
    symbol holds 2^(weight - 1) entries of a table of 2^max_bits, in order
    of weight and then of symbol; its code has max_bits + 1 - weight bits."""

    def __init__(self, weights: list[int]):
        total = sum(1 << (w - 1) for w in weights if w)
        _check(total > 0, "Huffman weights are all zero")
        self.max_bits = total.bit_length()
        rest = (1 << self.max_bits) - total
        _check(rest & (rest - 1) == 0, "Huffman weights do not complete a tree")
        weights = weights + [rest.bit_length()]         # the last symbol's weight
        _check(self.max_bits <= 11, f"Huffman codes of {self.max_bits} bits")
        self.symbol, self.bits = [], []
        for w in range(1, self.max_bits + 1):
            for s, ws in enumerate(weights):
                if ws == w:
                    self.symbol += [s] * (1 << (w - 1))
                    self.bits += [self.max_bits + 1 - w] * (1 << (w - 1))

    def decode(self, stream: bytes, n: int) -> bytes:
        bits = Backward(stream)
        out = bytearray(n)
        for i in range(n):
            e = bits.peek(self.max_bits)
            out[i] = self.symbol[e]
            bits.left -= self.bits[e]
        _check(bits.left == 0, "a Huffman stream does not end where its literals do")
        return bytes(out)


def read_huffman(data: bytes) -> tuple[Huffman, int]:
    """A Huffman tree description: (table, bytes it took)."""
    head = data[0]
    if head >= 128:                           # direct: 4-bit weights, two a byte
        n = head - 127
        size = 1 + (n + 1) // 2
        _check(len(data) >= size, "Huffman weights run past the block")
        weights = [(data[1 + i // 2] >> (4 if i % 2 == 0 else 0)) & 15 for i in range(n)]
        return Huffman(weights), size
    _check(1 + head <= len(data), "Huffman weights run past the block")
    counts, log, used = read_counts(data[1:1 + head], 255, WEIGHT_LOG_MAX)
    table = Fse(counts, log)
    bits = Backward(data[1 + used:1 + head])
    states = [bits.read(log), bits.read(log)]
    weights, k = [], 0
    while True:                               # two interleaved states until the stream runs out
        s = states[k]
        weights.append(table.symbol[s])
        states[k] = table.base[s] + bits.read(table.bits[s])
        _check(len(weights) < 255, "too many Huffman weights")
        k ^= 1
        if bits.left < 0:
            weights.append(table.symbol[states[k]])
            break
    return Huffman(weights), 1 + head


# --- a frame ---------------------------------------------------------------------

class _Frame:
    """What a frame's blocks carry from one to the next."""

    def __init__(self):
        self.huffman: Huffman | None = None
        self.tables: list[Fse | None] = [None, None, None]     # LL, OF, ML
        self.rep = [1, 4, 8]


def _literals(block: bytes, fr: _Frame) -> tuple[bytes, int]:
    """The literals section: (literals, bytes it took)."""
    kind, fmt = block[0] & 3, (block[0] >> 2) & 3
    if kind in (0, 1):                                   # Raw, RLE
        if fmt in (0, 2):
            size, head = block[0] >> 3, 1
        elif fmt == 1:
            size, head = (block[0] >> 4) | (block[1] << 4), 2
        else:
            size, head = (block[0] >> 4) | (block[1] << 4) | (block[2] << 12), 3
        if kind == 0:
            _check(head + size <= len(block), "raw literals run past the block")
            return block[head:head + size], head + size
        _check(head < len(block), "RLE literals run past the block")
        return bytes([block[head]]) * size, head + 1
    b = block
    if fmt in (0, 1):
        streams, head = (1 if fmt == 0 else 4), 3
        size, comp = (b[0] >> 4) | ((b[1] & 0x3F) << 4), (b[1] >> 6) | (b[2] << 2)
    elif fmt == 2:
        streams, head = 4, 4
        size, comp = (b[0] >> 4) | (b[1] << 4) | ((b[2] & 3) << 12), (b[2] >> 2) | (b[3] << 6)
    else:
        streams, head = 4, 5
        size = (b[0] >> 4) | (b[1] << 4) | ((b[2] & 0x3F) << 12)
        comp = (b[2] >> 6) | (b[3] << 2) | (b[4] << 10)
    _check(head + comp <= len(block), "compressed literals run past the block")
    body = block[head:head + comp]
    if kind == 2:                                        # Compressed: a tree first
        fr.huffman, used = read_huffman(body)
        body = body[used:]
    _check(fr.huffman is not None, "treeless literals without an earlier tree")
    if streams == 1:
        return fr.huffman.decode(body, size), head + comp
    _check(len(body) >= 6, "a jump table runs past the literals")
    s1, s2, s3 = (int.from_bytes(body[i:i + 2], "little") for i in (0, 2, 4))
    ends = np.cumsum([6, s1, s2, s3])
    _check(ends[-1] < len(body), "literal streams run past the literals")
    each = (size + 3) // 4
    _check(3 * each <= size, "four literal streams of too few literals")
    parts = [body[ends[i]:ends[i + 1]] for i in range(3)] + [body[ends[3]:]]
    lens = [each, each, each, size - 3 * each]
    return b"".join(fr.huffman.decode(p, n) for p, n in zip(parts, lens)), head + comp


def _table(data: bytes, mode: int, default, limits, fr: _Frame, k: int) -> int:
    """Set up sequence table ``k`` (0 LL, 1 OF, 2 ML) for ``mode``; the
    bytes its description took."""
    if mode == 0:
        fr.tables[k] = Fse(*default)
        return 0
    if mode == 1:
        _check(len(data) >= 1 and data[0] <= limits[0], "an RLE table runs past the block")
        fr.tables[k] = Fse.rle(data[0])
        return 1
    if mode == 2:
        counts, log, used = read_counts(data, *limits)
        fr.tables[k] = Fse(counts, log)
        return used
    _check(fr.tables[k] is not None, "a repeated table without an earlier one")
    return 0


def _sequences(data: bytes, fr: _Frame) -> list[tuple[int, int, int]]:
    """The sequences section: [(literals length, offset, match length)]."""
    _check(len(data) >= 1, "no sequences section")
    n, p = data[0], 1
    if n == 0:
        return []
    if n >= 128:
        if n < 255:
            n, p = ((n - 128) << 8) + data[1], 2
        else:
            n, p = data[1] + (data[2] << 8) + 0x7F00, 3
    modes = data[p]
    _check(modes & 3 == 0, "reserved bits set in the symbol compression modes")
    p += 1
    for k, (shift, default, limits) in enumerate(((6, LL_DEFAULT, LL_MAX),
                                                  (4, OF_DEFAULT, OF_MAX),
                                                  (2, ML_DEFAULT, ML_MAX))):
        p += _table(data[p:], (modes >> shift) & 3, default, limits, fr, k)
    ll_t, of_t, ml_t = fr.tables
    bits = Backward(data[p:])
    ll_s, of_s, ml_s = bits.read(ll_t.log), bits.read(of_t.log), bits.read(ml_t.log)
    out = []
    for i in range(n):
        of_code, ll_code, ml_code = of_t.symbol[of_s], ll_t.symbol[ll_s], ml_t.symbol[ml_s]
        _check(of_code <= 31 and ll_code <= 35 and ml_code <= 52, "a code past its table")
        value = (1 << of_code) + bits.read(of_code)
        ml = ML_BASE[ml_code] + bits.read(ML_BITS[ml_code])
        ll = LL_BASE[ll_code] + bits.read(LL_BITS[ll_code])
        rep = fr.rep
        if value > 3:
            off = value - 3
            fr.rep = [off, rep[0], rep[1]]
        else:
            idx = value - 1 + (ll == 0)                # with no literals the index moves on
            if idx == 0:
                off = rep[0]
            elif idx == 3:
                off = rep[0] - 1
                _check(off > 0, "a repeat offset of 0")
                fr.rep = [off, rep[0], rep[1]]
            else:
                off = rep[idx]
                fr.rep = [off] + [r for j, r in enumerate(rep) if j != idx]
        out.append((ll, off, ml))
        if i + 1 < n:
            ll_s = ll_t.base[ll_s] + bits.read(ll_t.bits[ll_s])
            ml_s = ml_t.base[ml_s] + bits.read(ml_t.bits[ml_s])
            of_s = of_t.base[of_s] + bits.read(of_t.bits[of_s])
    _check(bits.left == 0, "the sequences' bit stream does not end with them")
    return out


def decode(src: bytes, raw_len: int, lossy: bool = False) -> np.ndarray:
    """Decode one frame that holds ``raw_len`` bytes; raises FormatError."""
    _check(len(src) >= 6 and int.from_bytes(src[:4], "little") == MAGIC, "not a Zstd frame")
    desc = src[4]
    fcs_flag, single, checksum, dict_flag = desc >> 6, (desc >> 5) & 1, (desc >> 2) & 1, desc & 3
    _check(desc & 8 == 0, "reserved bit set in the frame header")
    _check(dict_flag == 0, "frames with a dictionary are not taken")
    p = 5 + (not single)
    fcs_size = (1 if single else 0) if fcs_flag == 0 else (2, 4, 8)[fcs_flag - 1]
    if fcs_size:
        content = int.from_bytes(src[p:p + fcs_size], "little") + (256 if fcs_size == 2 else 0)
        _check(content == raw_len, f"the frame holds {content} bytes, the block {raw_len}")
    p += fcs_size
    out = np.zeros(raw_len, np.uint8)
    o, fr = 0, _Frame()
    while True:
        _check(p + 3 <= len(src), "a block header runs past the frame")
        head = int.from_bytes(src[p:p + 3], "little")
        p += 3
        last, kind, size = head & 1, (head >> 1) & 3, head >> 3
        if kind == 0:                                      # Raw
            _check(p + size <= len(src) and o + size <= raw_len, "a raw block runs past")
            out[o:o + size] = np.frombuffer(src[p:p + size], np.uint8)
            p, o = p + size, o + size
        elif kind == 1:                                    # RLE
            _check(p < len(src) and o + size <= raw_len, "an RLE block runs past")
            out[o:o + size] = src[p]
            p, o = p + 1, o + size
        elif kind == 2:                                    # Compressed
            _check(p + size <= len(src), "a compressed block runs past the frame")
            block = src[p:p + size]
            lits, used = _literals(block, fr)
            at = 0
            for ll, off, ml in _sequences(block[used:], fr):
                _check(at + ll <= len(lits) and o + ll + ml <= raw_len,
                       "a sequence runs past its literals or the block")
                out[o:o + ll] = np.frombuffer(lits[at:at + ll], np.uint8)
                at, o = at + ll, o + ll
                _check(1 <= off <= o, f"match at {o} (offset {off}) before the block")
                if off >= ml:
                    out[o:o + ml] = out[o - off:o - off + ml]
                else:
                    out[o:o + ml] = np.tile(out[o - off:o], -(-ml // off))[:ml]
                o += ml
            rest = len(lits) - at
            _check(o + rest <= raw_len, "the last literals run past the block")
            if not lossy:
                out[o:o + rest] = np.frombuffer(lits[at:], np.uint8)
            p, o = p + size, o + rest
        else:
            raise FormatError("a reserved block type")
        if last:
            break
    _check(p + 4 * checksum == len(src), "bytes past the frame's last block")
    _check(o == raw_len, f"decoded {o} bytes, the block holds {raw_len}")
    return out


def decode_stored(src: bytes, codec_id: int, raw_len: int, lossy: bool = False) -> np.ndarray:
    """A block as the manifest records it: a Zstd frame (``ZSTD_ID``) or
    stored (``RAW_ID``; lossy, its last five bytes left zero)."""
    if codec_id == RAW_ID:
        _check(len(src) == raw_len, f"stored block of {len(src)} bytes, the block holds {raw_len}")
        out = np.frombuffer(src, np.uint8).copy()
        if lossy:
            out[-5:] = 0
        return out
    _check(codec_id == ZSTD_ID, f"codec id {codec_id} is not Zstd")
    return decode(src, raw_len, lossy)
