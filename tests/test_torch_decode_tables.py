"""The sequence-table decode (B2) of the port against the JAX package, on the
CPU.

The same compressed blocks (made from SURVEY.md and a numpy seed) are parsed
by both packages' bindings of the one host library and padded by both
``pad_tables``; the JAX ``decode_blocks`` runs its Pallas kernel in
interpret mode, the port's wrapper its plain PyTorch version on CPU tensors.
Tolerance 0.  The reference leaves the bytes past a block's decoded extent
undefined, so parity compares ``[:raw_len]``; the port's bytes past it are
zero.  The kernel's classifier (``well_formed``) is checked on the parser's
tables and on the random generators' (``random_tables``), and the plain
version against a byte-serial numpy oracle of the module docstring's rules.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitar_tpu.ops.cpu import native as jnative
from bitar_tpu.ops.pallas import layout as jlayout
from bitar_tpu.ops.pallas.lz4_decode import decode_blocks as jax_decode_blocks
from bitar_tpu_torch.ops import decode_tables as dt
from bitar_tpu_torch.ops.cpu import native
from bitar_tpu_torch.ops.cpu.native import SEQUENCE_KEYS
from bitar_tpu_torch.utils.corpus import make_corpus, make_text_corpus

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def blocks_of(block: int, seed: int) -> list[bytes]:
    """Four blocks: two of markdown, one of low-entropy bytes, one short
    block of text followed by a run."""
    rng = np.random.default_rng(seed)
    src = (ROOT / "SURVEY.md").read_bytes()
    o = int(rng.integers(0, len(src) - 2 * block))
    return [src[o:o + block], src[o + block:o + 2 * block],
            rng.integers(0, 6, block, np.uint8).tobytes(),
            (b"short block %d " % seed * 20)[:block // 2] + b"\x11" * (block // 4)]


def tables_of(comps: list[np.ndarray], codec: str):
    """Both packages' parse and padding of the same blocks; they must agree."""
    per_block = []
    for c in comps:
        t = native.parse_sequences(c, codec)
        want = jnative.parse_sequences(c, codec)
        for k in SEQUENCE_KEYS:
            np.testing.assert_array_equal(t[k], want[k], err_msg=k)
        per_block.append(t)
    tables, nseq = dt.pad_tables(per_block, SEQUENCE_KEYS)
    jt, jn = jlayout.pad_tables(per_block, SEQUENCE_KEYS)
    np.testing.assert_array_equal(nseq, jn)
    for k in SEQUENCE_KEYS:
        np.testing.assert_array_equal(tables[k], jt[k], err_msg=k)
    return tables, nseq


def rows_of(comps, width: int) -> np.ndarray:
    rows = np.zeros((len(comps), width), np.uint8)
    for i, c in enumerate(comps):
        rows[i, :len(c)] = c
    return rows


def decode_both(rows: np.ndarray, tables, nseq, block: int):
    """(JAX planes [N, block] uint8, port planes [N, block] uint8)."""
    n, w = rows.shape
    cr = w // 128
    planes = np.zeros((n, cr + jlayout.GUARD_ROWS, 128), np.int32)
    planes[:, :cr] = rows.reshape(n, cr, 128)
    S = tables["lit_ptr"].shape[1]
    want = jax_decode_blocks(
        jnp.asarray(planes), jnp.asarray(nseq), *(jnp.asarray(tables[k]) for k in SEQUENCE_KEYS),
        comp_rows=cr + jlayout.GUARD_ROWS, out_rows=block // 128 + jlayout.GUARD_ROWS, seq_cap=S,
        interpret=True)
    want = np.asarray(want)[:, :block // 128].astype(np.uint8).reshape(n, block)
    tn, tt = dt.table_tensors(tables, nseq, "cpu")
    got = dt.decode_blocks(torch.from_numpy(rows), tn, tt, out_rows=block // 128)
    return want, got.numpy().reshape(n, block)


@pytest.mark.parametrize("block", [1024, 4096])
@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_codec_tables_match_jax(codec, block):
    datas = blocks_of(block, seed=61 if codec == "lz4" else 62)
    compress = jnative.lz4_compress if codec == "lz4" else jnative.snappy_compress
    comps = [np.asarray(compress(d, min_match=4)) for d in datas]
    tables, nseq = tables_of(comps, codec)
    assert (tables["mlen"] > 0).any() and int(nseq.max()) > 20
    want, got = decode_both(rows_of(comps, 2 * block), tables, nseq, block)
    for i, d in enumerate(datas):
        assert want[i, :len(d)].tobytes() == d
        assert got[i, :len(d)].tobytes() == d, f"block {i}"
        assert not got[i, len(d):].any(), "bytes past the decoded extent are zero"


def rle_tables(block: int):
    """One block per offset d in 1..130, both sides of the 128-byte row: d
    literal bytes, one match of offset d up to 5 bytes before the end, then
    5 literal bytes (rows and tables of a standard LZ4 stream's shape)."""
    rng = np.random.default_rng(63)
    offsets = np.arange(1, 131)
    n = offsets.size
    rows = rng.integers(0, 256, (n, 256), np.uint8)
    tables = {k: np.zeros((n, 128), np.int32) for k in SEQUENCE_KEYS}
    for i, d in enumerate(offsets):
        m = block - d - 5
        tables["lit_len"][i, :2] = [d, 5]
        tables["off"][i, 0] = d
        tables["mlen"][i, 0] = m
        tables["lit_ptr"][i, 1] = d
        tables["out_pos"][i, 1] = d + m
    return rows, tables, np.full(n, 2, np.int32), offsets


def test_rle_offsets_across_the_row_match_jax():
    block = 1024
    rows, tables, nseq, offsets = rle_tables(block)
    want, got = decode_both(rows, tables, nseq, block)
    np.testing.assert_array_equal(got, want)
    for i, d in enumerate(offsets):
        period = np.tile(rows[i, :d], block // d + 1)[:block - 5]
        assert got[i, :block - 5].tobytes() == period.tobytes(), f"offset {d}"
        assert got[i, block - 5:].tobytes() == rows[i, d:d + 5].tobytes()


def test_raw_and_empty_tables_match_jax():
    # The engine's RAW table is one literal run of the whole stored block; a
    # block with nseq = 0 (a burst's idle row in the reference) decodes
    # nothing: the reference leaves it undefined, the port writes zeros.
    block = 4096
    rng = np.random.default_rng(64)
    rows = rng.integers(0, 256, (3, 2 * block), np.uint8)
    tables = {k: np.zeros((3, 128), np.int32) for k in SEQUENCE_KEYS}
    tables["lit_len"][0, 0] = block
    tables["lit_len"][1, 0] = block - 300
    nseq = np.array([1, 1, 0], np.int32)
    want, got = decode_both(rows, tables, nseq, block)
    np.testing.assert_array_equal(got[0], rows[0, :block])
    np.testing.assert_array_equal(got[:2, :block - 300], want[:2, :block - 300])
    assert not got[1, block - 300:].any() and not got[2].any()


def test_malformed_tables_stay_in_the_plane():
    # Offsets of 0 and past the block start, positions before and past the
    # plane, literals past the comp row, nseq past the table: the plain
    # version (the kernel's function) terminates and clips every index.
    rows = torch.arange(256, dtype=torch.int32).to(torch.uint8).reshape(1, 256).repeat(2, 1)
    t = {k: torch.zeros((2, 128), dtype=torch.int32) for k in SEQUENCE_KEYS}
    t["lit_len"][0, :4] = torch.tensor([10, 300, 4, 2 ** 30])
    t["lit_ptr"][0, :4] = torch.tensor([250, -7, 0, 0])
    t["out_pos"][0, :4] = torch.tensor([-4, 20, 1000, 1020])
    t["off"][0, :3] = torch.tensor([0, 5000, 3])
    t["mlen"][0, :3] = torch.tensor([9, 17, 2 ** 30])
    out = dt.decode_blocks(rows, torch.tensor([4, 500], dtype=torch.int32), t, out_rows=8)
    assert out.shape == (2, 8, 128)
    flat = out[0].reshape(-1)
    assert flat[:6].tolist() == [254, 255, 0, 0, 0, 0]        # comp bytes past 255 read 0
    assert not flat[6:15].any()                               # off 0: zeros
    assert not out[1].any()


def serial_oracle(rows: np.ndarray, tables, nseq, block: int) -> np.ndarray:
    """The module docstring's rules, byte by byte: literals in sequence
    order, then matches in sequence order; writes outside the plane
    dropped, comp bytes outside the row and sources before the plane (or
    off < 1) read 0."""
    n, w = rows.shape
    S = tables["lit_ptr"].shape[1]
    out = np.zeros((n, block), np.uint8)
    for b in range(n):
        ns = min(max(int(nseq[b]), 0), S)
        lp, ll, off, ml, op = (tables[k][b, :ns].astype(np.int64) for k in SEQUENCE_KEYS)
        for s in range(ns):
            for j in range(max(0, -op[s]), min(ll[s], block - op[s])):
                q = lp[s] + j
                out[b, op[s] + j] = rows[b, q] if 0 <= q < w else 0
        for s in range(ns):
            d = op[s] + ll[s]
            for j in range(max(0, -d), min(ml[s], block - d)):
                src = d - off[s] + j % off[s] if off[s] >= 1 else -1
                out[b, d + j] = out[b, src] if src >= 0 else 0
    return out


def as_tensors(rows, tables, nseq):
    tn, tt = dt.table_tensors(tables, nseq, "cpu")
    return torch.from_numpy(rows), tn, tt


CORPORA = {"bench": make_corpus, "text": make_text_corpus}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("block", [1024, 4096, 16384, 131072])
@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_parser_tables_are_well_formed(codec, block, corpus):
    # Every table the parser emits, RAW blocks' included, takes the
    # kernel's parallel path.
    src = CORPORA[corpus](2)
    datas = [src[i * block:(i + 1) * block] for i in range(min(32, len(src) // block))]
    datas.append(np.random.default_rng(block).integers(0, 256, block, np.uint8).tobytes())
    rows, tables, nseq, stored = dt.parser_tables(datas, codec)
    assert stored[-1] == block and int(nseq[-1]) == 1, "the random block is stored RAW"
    assert bool(dt.well_formed(*as_tensors(rows, tables, nseq)[1:]).all())
    if block <= 4096:
        got = dt.decode_blocks(*as_tensors(rows, tables, nseq), out_rows=block // 128)
        assert [g.tobytes() for g in got.reshape(len(datas), -1).numpy()] == datas


@pytest.mark.parametrize("S,block", [(640, 4096), (300, 1024), (2048, 16384)])
def test_random_tables_classify_as_asked(S, block):
    for wf in (True, False):
        rows, tables, nseq = dt.random_tables(S + block, 12, S, block, well_formed=wf)
        got = dt.well_formed(*as_tensors(rows, tables, nseq)[1:])
        assert got.tolist() == [wf] * 12


@pytest.mark.parametrize("well_formed", [True, False])
@pytest.mark.parametrize("S,block", [(640, 4096), (300, 1024)])
def test_plain_version_equals_byte_serial_oracle(S, block, well_formed):
    # The chains run through every sequence of a table, longer than any of
    # the kernel's windows; offsets 1-130 cross rows and window edges.
    rows, tables, nseq = dt.random_tables(7 * S, 8, S, block, well_formed=well_formed)
    got = dt.decode_blocks(*as_tensors(rows, tables, nseq), out_rows=block // 128)
    np.testing.assert_array_equal(got.reshape(8, -1).numpy(),
                                  serial_oracle(rows, tables, nseq, block))


def test_path_counts_on_the_cpu_follow_the_classifier():
    r1, t1, n1 = dt.random_tables(5, 6, 256, 1024)
    r2, t2, n2 = dt.random_tables(6, 4, 256, 1024, well_formed=False)
    rows = np.concatenate([r1, r2])
    tables = {k: np.concatenate([t1[k], t2[k]]) for k in t1}
    paths = torch.zeros(2, dtype=torch.int32)
    dt.decode_blocks(*as_tensors(rows, tables, np.concatenate([n1, n2])), out_rows=8,
                     path_counts=paths)
    assert paths.tolist() == [6, 4]
