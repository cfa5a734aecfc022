"""The key-value cells' data and their plain lookup: RocksDB SSTs of YCSB
records, made from the seed alone.

Plain NumPy: nothing here imports the program.

* :func:`make` builds ``units`` SSTs of ``unit_blocks`` data blocks in
  RocksDB's data-block format (``table/block_based/``).  An entry
  is ``varint32 shared, varint32 unshared, varint32 value_len``, the key's
  bytes past the prefix it shares with the entry before it, and the value;
  every :data:`RESTART_INTERVAL` entries a restart point (shared 0); the
  block ends with the restart points' offsets and their count, ``fixed32``
  each.  A block takes records, in key order, while it stays within the
  block size.
* Keys are YCSB's (``insertorder=hashed``): ``user`` and the decimal of
  ``fnvhash64`` of the record number, with RocksDB's 8-byte internal-key
  trailer (sequence 0 and kTypeValue, as a bottommost file holds them),
  sorted bytewise across the SSTs.
* Values are YCSB's records of :data:`FIELDS` fields as its RocksDB binding
  serializes them: per field a 4-byte big-endian name length, the name
  (``field0``...), a 4-byte big-endian value length and the value.  A
  field is :data:`FIELD_LEN` bytes, its first half drawn from YCSB's
  alphabet (``RandomByteIterator``: ``' ' + (r & 95)``) and repeated once,
  so LZ4 finds half of it (db_bench's ``--compression_ratio=0.5``).
* :func:`key_stream` draws YCSB's zipfian request distribution over the
  records, the ranks spread over them by a seeded permutation.
* :func:`lookup` finds a key's value in one raw block, RocksDB's way: a
  binary search over the restart points, then a scan that rebuilds each
  key from its shared prefix.  It reads the block alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FIELDS = 10
FIELD_LEN = 100
FIELD_NAME_LEN = len(b"field0")
VALUE_LEN = FIELDS * (4 + FIELD_NAME_LEN + 4 + FIELD_LEN)        # 1140
RESTART_INTERVAL = 16
TRAILER = bytes([1]) + bytes(7)       # PackSequenceAndType(0, kTypeValue), fixed64
DIGITS = 20                           # the longest decimal of a signed 64-bit integer
KEY_WIDTH = 4 + DIGITS + len(TRAILER)
FNV_OFFSET, FNV_PRIME = 0xCBF29CE484222325, 1099511628211


@dataclass
class Table:
    """The SSTs and the record table (the SST index blocks' role)."""

    raw: np.ndarray          # uint8: every block of every SST, in order
    sizes: np.ndarray        # int64 [units * unit_blocks]: each block's bytes
    sst: np.ndarray          # int64 [records]: the SST holding each record
    block: np.ndarray        # int64 [records]: its block within the SST
    value_off: np.ndarray    # int64 [records]: its value's offset in the block
    value_len: np.ndarray    # int64 [records]
    keys: np.ndarray         # uint8 [records, KEY_WIDTH]: internal keys, zero padded
    key_len: np.ndarray      # int64 [records]
    values: np.ndarray       # uint8 [records, VALUE_LEN]

    def user_key(self, r: int) -> bytes:
        return self.keys[r, :int(self.key_len[r]) - len(TRAILER)].tobytes()


def fnvhash64(x: np.ndarray) -> np.ndarray:
    """YCSB's ``Utils.fnvhash64`` of each non-negative integer: FNV-1a over
    its 8 little-endian bytes, then the absolute value as a signed 64-bit
    integer."""
    h = np.full(x.shape, FNV_OFFSET, np.uint64)
    v = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        for _ in range(8):
            h ^= v & np.uint64(0xFF)
            h *= np.uint64(FNV_PRIME)
            v >>= np.uint64(8)
    s = h.view(np.int64)
    if (s == np.iinfo(np.int64).min).any():        # Math.abs keeps it negative
        raise ValueError("a record hashes to -2**63")
    return np.abs(s)


def user_keys(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Records 0..n-1's internal keys ([n, KEY_WIDTH] uint8, zero padded)
    and their lengths."""
    v = fnvhash64(np.arange(n, dtype=np.int64)).astype(np.uint64)
    digits = np.empty((n, DIGITS), np.uint8)
    for i in range(DIGITS - 1, -1, -1):
        digits[:, i] = (v % np.uint64(10)).astype(np.uint8)
        v //= np.uint64(10)
    lead = np.argmax(digits != 0, axis=1)             # a zero hash keeps one digit
    lead = np.where((digits == 0).all(axis=1), DIGITS - 1, lead)
    nd = DIGITS - lead
    keys = np.zeros((n, KEY_WIDTH), np.uint8)
    keys[:, :4] = np.frombuffer(b"user", np.uint8)
    col = np.arange(DIGITS)
    src = np.minimum(lead[:, None] + col[None, :], DIGITS - 1)
    keys[:, 4:4 + DIGITS] = np.where(col[None, :] < nd[:, None],
                                     np.take_along_axis(digits, src, 1) + ord("0"), 0)
    trailer = np.frombuffer(TRAILER, np.uint8)
    rows = np.arange(n)[:, None]
    keys[rows, 4 + nd[:, None] + np.arange(len(TRAILER))[None, :]] = trailer
    return keys, (4 + nd + len(TRAILER)).astype(np.int64)


def record_values(rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` YCSB records serialized as the RocksDB binding does: [n, VALUE_LEN]."""
    head = np.zeros((FIELDS, 4 + FIELD_NAME_LEN + 4), np.uint8)
    for f in range(FIELDS):
        head[f] = np.frombuffer(FIELD_NAME_LEN.to_bytes(4, "big") + b"field%d" % f
                                + FIELD_LEN.to_bytes(4, "big"), np.uint8)
    vals = np.empty((n, FIELDS, head.shape[1] + FIELD_LEN), np.uint8)
    vals[:, :, :head.shape[1]] = head
    half = FIELD_LEN // 2
    drawn = (rng.integers(0, 256, (n, FIELDS, half), np.uint8) & 95) + ord(" ")
    vals[:, :, head.shape[1]:head.shape[1] + half] = drawn
    vals[:, :, head.shape[1] + half:] = drawn
    return vals.reshape(n, VALUE_LEN)


def varint_len(v: np.ndarray) -> np.ndarray:
    """Bytes of each value as a varint32."""
    return 1 + (v >= 1 << 7) + (v >= 1 << 14) + (v >= 1 << 21) + (v >= 1 << 28)


def varint_bytes(v: np.ndarray) -> np.ndarray:
    """Each value as a varint32, left-aligned in [n, 5] uint8."""
    out = np.zeros((v.size, 5), np.uint8)
    x = v.astype(np.int64).copy()
    n = varint_len(v)
    for i in range(5):
        out[:, i] = (x & 0x7F) | np.where(n > i + 1, 0x80, 0)
        x >>= 7
    return np.where(np.arange(5)[None, :] < n[:, None], out, 0)


def pack(first: np.ndarray, rest: np.ndarray, block: int, nblocks: int
         ) -> tuple[np.ndarray, np.ndarray]:
    """Greedy packing in key order: each record's block (-1 past the last)
    and its entry's index in the block.  ``first``/``rest``: a record's
    entry bytes at a restart point and after another entry."""
    where = np.full(first.size, -1, np.int64)
    index = np.zeros(first.size, np.int64)
    b = used = n_in = 0
    for i, (f, r) in enumerate(zip(first.tolist(), rest.tolist(), strict=True)):
        size = f if n_in % RESTART_INTERVAL == 0 else r
        if n_in and used + size + 4 * (n_in // RESTART_INTERVAL + 2) > block:
            b += 1
            if b == nblocks:
                break
            used = n_in = 0
            size = f
        if used + size + 8 > block:
            raise ValueError(f"a record of {size} bytes does not fit a {block}-byte block")
        where[i], index[i] = b, n_in
        used += size
        n_in += 1
    if b < nblocks - 1 or where[-1] >= 0:
        raise ValueError("too few records to fill every block")
    return where, index


def make(data_cfg: dict, seed: int, block: int) -> Table:
    """The SSTs a configuration's ``data`` section names (generator
    ``rocksdb_ycsb``: ``units`` SSTs of ``unit_blocks`` blocks)."""
    if data_cfg["generator"] != "rocksdb_ycsb":
        raise ValueError(f"unknown data generator {data_cfg['generator']!r}")
    nsst, per_sst = data_cfg["units"], data_cfg["unit_blocks"]
    nblocks = nsst * per_sst
    # At least one byte of key past any shared prefix, a header of 3 bytes.
    least = VALUE_LEN + 3 + len(TRAILER) + 1
    drawn = nblocks * max(1, (block - 8) // least) + 1
    keys, klen = user_keys(drawn)
    order = np.argsort(np.ascontiguousarray(keys[:, :4 + DIGITS]).view(f"S{4 + DIGITS}")[:, 0],
                       kind="stable")
    keys, klen = keys[order], klen[order]
    differ = keys[1:] != keys[:-1]
    shared = np.concatenate([[0], np.argmax(differ, axis=1)]).astype(np.int64)
    vlen = np.full(drawn, VALUE_LEN, np.int64)
    head = varint_len(vlen)
    first = varint_len(np.zeros(drawn, np.int64)) + varint_len(klen) + head + klen + vlen
    rest = varint_len(shared) + varint_len(klen - shared) + head + klen - shared + vlen
    where, index = pack(first, rest, block, nblocks)
    n = int((where >= 0).sum())
    keys, klen, shared, vlen, where, index = (a[:n] for a in (keys, klen, shared, vlen,
                                                               where, index))
    shared = np.where(index % RESTART_INTERVAL == 0, 0, shared)
    unshared = klen - shared
    hdr = np.concatenate([varint_bytes(shared), varint_bytes(unshared), varint_bytes(vlen)], 1)
    hdr_mask = np.concatenate([np.arange(5)[None, :] < varint_len(a)[:, None]
                               for a in (shared, unshared, vlen)], 1)
    esize = hdr_mask.sum(1) + unshared + vlen
    # Each entry's offset in its block; each block's restart offsets.
    start = np.concatenate([[0], np.cumsum(esize)[:-1]])
    bstart = np.zeros(nblocks, np.int64)
    firsts = np.flatnonzero(index == 0)
    bstart[where[firsts]] = start[firsts]
    eoff = start - bstart[where]
    count = np.bincount(where, minlength=nblocks)
    nres = -(-count // RESTART_INTERVAL)
    sizes = np.bincount(where, weights=esize, minlength=nblocks).astype(np.int64) + 4 * (nres + 1)
    # The last entry of each block carries the block's tail: its restart
    # offsets and their count, little-endian fixed32 each.
    last = np.concatenate([firsts[1:] - 1, [n - 1]])
    tail = np.zeros((n, int(nres.max()) + 1), "<u4")
    res = np.flatnonzero(index % RESTART_INTERVAL == 0)
    tail[last[where[res]], index[res] // RESTART_INTERVAL] = eoff[res]
    tail[last, nres] = nres
    tail = tail.view(np.uint8)
    tail_len = np.zeros(n, np.int64)
    tail_len[last] = 4 * (nres + 1)
    cols = np.arange(KEY_WIDTH)[None, :]
    delta = np.where(cols < unshared[:, None],
                     np.take_along_axis(keys, np.minimum(shared[:, None] + cols,
                                                         KEY_WIDTH - 1), 1), 0).astype(np.uint8)
    values = record_values(np.random.default_rng([seed, 0x59C5B]), n)
    key_mask = cols < unshared[:, None]
    tail_mask = np.arange(tail.shape[1])[None, :] < tail_len[:, None]
    # Entries row by row, each as [header | key delta | value | tail], the
    # unused bytes masked out: the selected bytes in row-major order are the
    # blocks.
    raw = np.empty(int(sizes.sum()), np.uint8)
    pos = 0
    for s in range(0, n, 1 << 16):
        e = min(n, s + (1 << 16))
        rows = np.concatenate([hdr[s:e], delta[s:e], values[s:e], tail[s:e]], 1)
        mask = np.concatenate([hdr_mask[s:e], key_mask[s:e], np.ones((e - s, VALUE_LEN), bool),
                               tail_mask[s:e]], 1)
        chunk = rows[mask]
        raw[pos:pos + chunk.size] = chunk
        pos += chunk.size
    return Table(raw=raw, sizes=sizes, sst=where // per_sst, block=where % per_sst,
                 value_off=eoff + hdr_mask.sum(1) + unshared, value_len=vlen,
                 keys=keys, key_len=klen, values=values)


def zipf_ranks(rng: np.random.Generator, n: int, count: int, theta: float) -> np.ndarray:
    """``count`` draws of YCSB's ``ZipfianGenerator`` over ranks 0..n-1."""
    zetan = float(np.sum(1.0 / np.arange(1, n + 1, dtype=np.float64) ** theta))
    zeta2 = 1.0 + 0.5 ** theta
    alpha = 1.0 / (1.0 - theta)
    eta = (1.0 - (2.0 / n) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)
    u = rng.random(count)
    uz = u * zetan
    ranks = (n * (eta * u - eta + 1.0) ** alpha).astype(np.int64)
    ranks = np.where(uz < 1.0 + 0.5 ** theta, 1, ranks)
    ranks = np.where(uz < 1.0, 0, ranks)
    return np.minimum(ranks, n - 1)


def key_stream(seed: int, n: int, count: int, theta: float) -> np.ndarray:
    """``count`` requested records: zipfian ranks, each mapped to a record
    by a seed-drawn permutation (hot records spread over the key space, as
    YCSB's scrambled zipfian spreads them)."""
    rng = np.random.default_rng([seed, 0x2195])
    perm = rng.permutation(n)
    return perm[zipf_ranks(rng, n, count, theta)]


def _varint(b: bytes, p: int) -> tuple[int, int]:
    v = shift = 0
    while True:
        c = b[p]
        p += 1
        v |= (c & 0x7F) << shift
        if c < 0x80:
            return v, p
        shift += 7


def _entry(b: bytes, p: int, key: bytes) -> tuple[bytes, int, int, int]:
    """The entry at ``p`` after ``key``: (its key, value offset, value
    length, next entry's offset)."""
    shared, p = _varint(b, p)
    unshared, p = _varint(b, p)
    vlen, p = _varint(b, p)
    key = key[:shared] + b[p:p + unshared]
    return key, p + unshared, vlen, p + unshared + vlen


def lookup(block: bytes, user_key: bytes) -> bytes | None:
    """``user_key``'s value in a raw data block, or None where it is absent."""
    n = len(block)
    nres = int.from_bytes(block[n - 4:], "little")
    end = n - 4 - 4 * nres
    restart = [int.from_bytes(block[end + 4 * i:end + 4 * i + 4], "little")
               for i in range(nres)]
    lo, hi = 0, nres - 1                  # the last restart whose key is not past the key
    while lo < hi:
        mid = (lo + hi + 1) // 2
        key = _entry(block, restart[mid], b"")[0]
        if key[:-len(TRAILER)] <= user_key:
            lo = mid
        else:
            hi = mid - 1
    p, key = restart[lo], b""
    while p < end:
        key, voff, vlen, p = _entry(block, p, key)
        uk = key[:-len(TRAILER)]
        if uk == user_key:
            return block[voff:voff + vlen]
        if uk > user_key:
            return None
    return None
