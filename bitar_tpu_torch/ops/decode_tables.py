"""Sequence-table block decode (kernel B2): LZ4, Snappy and RAW blocks of any
size, and the engine's path for units the flat planner cannot take.

Counterpart of ``bitar_tpu/ops/pallas/lz4_decode.py``.  The host parser
(``native.parse_sequences``) turns a compressed block into a table of
sequences (``lit_ptr, lit_len, off, mlen, out_pos``); a RAW block is one
literal run.  This module holds

* ``pad_tables`` (a copy of ``bitar_tpu/ops/pallas/layout.py``'s) and
  ``table_tensors``, which pad per-block tables to one width and put them on
  a device;
* ``well_formed``: the kernel's classifier (the tables the parser emits
  take its parallel paths, any other table its serial walk), and the
  tables that hold the kernel to its plain version: ``parser_tables`` (the
  host codec's, as the engine stores them) and ``random_tables``, and
  ``resident_layout``, blocks scattered over a taller buffer and table
  store as the engine holds them;
* ``decode_tables_reference``: the plain PyTorch decode;
* ``decode_blocks``: the wrapper.  On CPU tensors it runs the plain version;
  on CUDA tensors it launches ``csrc/decode_tables.cu`` or raises.  The
  kernel keeps a plane in one CTA's shared memory where it fits beside its
  windows (up to ~150 KiB), else spread over the shared memory of a
  thread-block cluster (:func:`cluster_ctas`; planes of up to 1 MiB).

The function, per block ``b`` with ``ns = clamp(nseq[b], 0, S)`` sequences:

1. the output plane starts at zero;
2. every sequence ``s < ns`` copies its literals, in sequence order:
   ``out[out_pos + j] = comp[lit_ptr + j]`` for ``j < lit_len``;
3. then every sequence's match, in sequence order: with ``dst = out_pos +
   lit_len``, ``out[dst + j] = out[dst - off + (j mod off)]`` for ``j <
   mlen``.  That is LZ4's byte-serial overlap in closed form; it reads only
   bytes before ``dst``, so all bytes of one match are independent.

Writes outside the plane are dropped; a comp byte outside ``[0, W)`` and a
match source before the plane (or ``off < 1``) read 0.  So every table
terminates and stays in its plane.  For a table the parser accepts, this is
the reference's decode; the reference leaves the bytes past the decoded
extent undefined, where this writes zeros.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from ..config import Codec
from ..manifest import codec_id
from ..utils import profiling
from ._build import check_cuda, load_cuda_kernel, require
from .cpu import native
from .cpu.native import SEQUENCE_KEYS

LANES = 128

#: Kernel launches made by ``decode_blocks`` on CUDA tensors (one per call).
launches = 0
#: Those of them that took the cluster route (planes too tall to sit in one
#: CTA's shared memory beside the windows: blocks of ~150 KiB to 1 MiB).
cluster_launches = 0
#: ``launches`` again by CUDA device index: the card each launch ran on.
device_launches: collections.Counter = collections.Counter()

SMEM_MAX = 232448         # an H100 CTA's shared memory (the opt-in limit)
SLICE_BYTES = 128 * 1024  # plane bytes a CTA of the cluster route holds
MAX_CLUSTER = 8           # the portable cluster size: planes of up to 1 MiB


def cluster_ctas(out_rows: int) -> int:
    """CTAs of the kernel that decode one block of an ``out_rows``-row
    plane: 1 where the plane fits in shared memory beside the shared
    route's windows (up to 256 entries of 20 bytes, two of them) and its
    map (a byte a plane byte, at most 64 KiB), else the cluster route's
    least power of two of 128 KiB slices that holds the plane (2, 4 or 8:
    the plane is dealt to the CTAs in 1 KiB stripes); 0 past 1 MiB, which
    the kernel refuses.  ``csrc/decode_tables.cu`` computes the same
    (checked when it loads)."""
    if not 1 <= out_rows <= 1 << 16:
        return 0
    out_len = out_rows * LANES
    threads = min(1024, max(128, out_len // 32))
    if out_len + 2 * min(threads, 256) * 20 + min(out_len, 65536) <= SMEM_MAX:
        return 1
    ctas = 2
    while ctas < MAX_CLUSTER and ctas * SLICE_BYTES < out_len:
        ctas *= 2
    return ctas if ctas * SLICE_BYTES >= out_len else 0


def pad_tables(tables: list[dict[str, np.ndarray]], keys: tuple[str, ...],
               multiple: int = 128) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """Pad per-block SoA sequence tables to a common row count.

    Returns ({key: [N, S] int32}, nseq [N] int32).  S is the largest
    sequence count rounded up to ``multiple``.  The reference's table kernel
    also wants ``GUARD_ROWS`` spare rows past each plane; this module's
    kernel clips every index to its plane instead."""
    n = len(tables)
    nseq = np.array([t[keys[0]].shape[0] for t in tables], dtype=np.int32)
    s = int(max(1, -(-int(nseq.max(initial=1)) // multiple) * multiple))
    out = {k: np.zeros((n, s), dtype=np.int32) for k in keys}
    for i, t in enumerate(tables):
        m = int(nseq[i])
        for k in keys:
            out[k][i, :m] = t[k]
    return out, nseq


def table_tensors(tables: dict[str, np.ndarray], nseq: np.ndarray, device
                  ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """A padded host table set (:func:`pad_tables`) as tensors on
    ``device``: (nseq [N] int32, {key: [N, S] int32})."""
    cols = {k: torch.from_numpy(np.ascontiguousarray(tables[k], np.int32)).to(device)
            for k in SEQUENCE_KEYS}
    return torch.from_numpy(np.ascontiguousarray(nseq, np.int32)).to(device), cols


def parser_tables(datas: list[bytes], codec: str = "lz4", min_match: int = 6):
    """The parser's tables of ``datas`` compressed one block each by the
    host codec (LZ4 or Snappy) as the engine stores them: a block that does
    not shrink is stored RAW, its table one literal run.  Returns numpy
    (rows [N, W] uint8, padded tables, nseq, stored bytes per block); W is
    the longest stored block rounded up to 128 bytes."""
    lens = np.array([len(d) for d in datas], np.int32)
    cap = lens.astype(np.int64) + lens // 6 + 64
    src_off = np.concatenate([[0], np.cumsum(lens[:-1], dtype=np.int64)])
    dst_off = np.concatenate([[0], np.cumsum(cap[:-1])])
    dst = np.empty(int(cap.sum()), np.uint8)
    clen, st = native.batch_run(True, np.frombuffer(b"".join(datas), np.uint8), src_off, lens,
                                dst, dst_off, cap.astype(np.int32),
                                np.full(len(datas), codec_id(Codec(codec)), np.int32),
                                min_match=min_match)
    comps, per_block = [], []
    for i, d in enumerate(datas):
        if st[i] != 0 or clen[i] >= len(d):
            comps.append(np.frombuffer(d, np.uint8))
            per_block.append({k: np.array([len(d) if k == "lit_len" else 0], np.int32)
                              for k in SEQUENCE_KEYS})
        else:
            comps.append(dst[dst_off[i]:dst_off[i] + clen[i]])
            per_block.append(native.parse_sequences(comps[-1], codec))
    rows = np.zeros((len(comps), -(-max(len(c) for c in comps) // LANES) * LANES), np.uint8)
    for i, c in enumerate(comps):
        rows[i, :len(c)] = c
    return (rows, *pad_tables(per_block, SEQUENCE_KEYS),
            np.array([len(c) for c in comps], np.int64))


def well_formed(nseq: torch.Tensor, tables: dict[str, torch.Tensor]) -> torch.Tensor:
    """[N] bool: the kernel's classifier.  A block is well-formed when its
    ``ns`` sequences start at 0, have no negative length and each starts
    where the one before it ends (64-bit sums): the tables the parser
    emits.  Then no two sequences write one byte and every match byte's
    source lies before it, so each byte's value follows from the table and
    the comp row alone (the kernel decodes such blocks in parallel, others
    by the serial walk)."""
    ll, ml, op = (tables[k].long() for k in ("lit_len", "mlen", "out_pos"))
    S = ll.shape[1]
    live = torch.arange(S, device=ll.device)[None, :] < nseq.long().clamp(0, S)[:, None]
    lengths = ((ll >= 0) & (ml >= 0)) | ~live
    chained = (op[:, 1:] == (op + ll + ml)[:, :-1]) | ~live[:, 1:]
    return lengths.all(1) & chained.all(1) & ((op[:, 0] == 0) | ~live[:, 0])


def random_tables(seed: int, n: int, S: int, block: int, *, well_formed: bool = True):
    """Random tables to hold the kernel to its plain version; numpy (rows
    [n, block // 2] uint8, padded tables [n, S], nseq [n]).

    Well-formed tables (:func:`well_formed`) come in four kinds, block by
    block: mixed sequences with edge values (``lit_ptr`` before and past
    the row, ``off`` 0 and past ``dst``, ``mlen`` 0 mid-table), chains
    (every match copies the one before it, so a byte's sources form a chain
    as long as the table), offsets 1-130 (both sides of a 128-byte row and
    of a window's edge), and an extent past the plane; ``nseq`` is below
    ``S`` in every third block.  Malformed tables: every other block fully
    random (``off`` <= 0, positions outside the plane, overlapping and
    out-of-order writes, ``nseq`` past ``S``), the rest well-formed but for
    one broken field."""
    rng = np.random.default_rng(seed)
    width = max(LANES, block // 2)
    rows = rng.integers(0, 256, (n, width), np.uint8)
    cols = {k: np.zeros((n, S), np.int64) for k in SEQUENCE_KEYS}
    nseq = np.zeros(n, np.int64)
    for i in range(n):
        ns = S if i % 3 else int(rng.integers(1, S))
        kind = i % 4
        if not well_formed and i % 2 == 0:
            ns = int(rng.integers(1, S + 50))
            m = min(ns, S)
            cols["lit_ptr"][i, :m] = rng.integers(-width, 2 * width, m)
            cols["lit_len"][i, :m] = rng.integers(-5, block // 4, m)
            cols["off"][i, :m] = rng.integers(-2, 2 * block, m)
            cols["mlen"][i, :m] = rng.integers(-5, block // 2, m)
            cols["out_pos"][i, :m] = rng.integers(-block // 4, block + block // 4, m)
            cols["out_pos"][i, 0] = rng.integers(1, block)
            nseq[i] = ns
            continue
        if kind == 1:                  # chains: each match repeats the one before it
            period = max(1, block // ns)
            ll = np.zeros(ns, np.int64)
            ml = np.full(ns, period, np.int64)
            ll[0], ml[0] = period, 0
            off = np.full(ns, period, np.int64)
            lp = np.zeros(ns, np.int64)
        else:
            target = block * (1.5 if kind == 3 else 0.95)
            mean = max(2.0, target / ns)
            ll = rng.integers(0, max(2, int(mean / 3)), ns)
            ml = rng.integers(1, max(2, int(1.4 * mean)), ns)
            ml[rng.random(ns) < 0.1] = 0
            lp = rng.integers(0, width, ns)
            edge = rng.random(ns)
            lp[edge < 0.04] = width - ll[edge < 0.04] // 2          # runs past the row
            lp[(edge >= 0.04) & (edge < 0.06)] = -3
            off = rng.integers(1, 131, ns) if kind == 2 else None
        op = np.concatenate([[0], np.cumsum(ll + ml)[:-1]])
        if off is None:
            dst = op + ll
            off = 1 + (rng.random(ns) * np.maximum(dst, 1)).astype(np.int64)
            pick = rng.random(ns)
            off[pick < 0.05] = 0
            off[(pick >= 0.05) & (pick < 0.1)] = dst[(pick >= 0.05) & (pick < 0.1)] + 7
            off[(pick >= 0.1) & (pick < 0.4)] = rng.integers(1, 131, int(((pick >= 0.1)
                                                                           & (pick < 0.4)).sum()))
        for k, v in zip(SEQUENCE_KEYS, (lp, ll, off, ml, op)):
            cols[k][i, :ns] = v
        nseq[i] = ns
        if not well_formed:            # break one field of a well-formed table
            s = int(rng.integers(0, ns))
            broken = (i // 2) % 4
            if broken == 0 and ns > 1:
                s = max(1, s)
                cols["out_pos"][i, s] -= int(rng.integers(1, 9))     # overlaps the one before
            elif broken <= 1:
                cols["lit_len"][i, s] = -int(rng.integers(1, 9))
            elif broken == 2:
                cols["mlen"][i, s] = -int(rng.integers(1, 9))
            else:
                cols["out_pos"][i, 0] = int(rng.integers(1, 9))
    tables = {k: v.astype(np.int32) for k, v in cols.items()}
    return rows, tables, nseq.astype(np.int32)


def resident_layout(rows: np.ndarray, tables: dict[str, np.ndarray], nseq: np.ndarray,
                    seed: int, *, taller: int = 2):
    """Blocks as the engine holds them resident, to hold a launch through
    source rows to one on the blocks themselves: ``rows`` ([n, W] uint8),
    ``tables`` ([n, S] each) and ``nseq`` put at seeded random rows of a
    buffer and a table store ``taller`` times as tall; the other rows hold
    random bytes and random tables.  Returns numpy (buffer [N, W] uint8,
    nseq [N] int32, store [5, N, S] int32 in ``SEQUENCE_KEYS`` order, source
    rows [n] int32): block ``b`` lies at row ``src[b]``."""
    n, w = rows.shape
    S, N = tables[SEQUENCE_KEYS[0]].shape[1], taller * n
    rng = np.random.default_rng(seed)
    src = rng.permutation(N)[:n].astype(np.int32)
    buf = rng.integers(0, 256, (N, w), np.uint8)
    buf[src] = rows
    store = rng.integers(-2 * w, 2 * w, (len(SEQUENCE_KEYS), N, S)).astype(np.int32)
    for i, k in enumerate(SEQUENCE_KEYS):
        store[i, src] = tables[k]
    ns = rng.integers(0, S + 1, N).astype(np.int32)
    ns[src] = nseq
    return buf, ns, store, src


# ---------------------------------------------------------------------------
# Plain PyTorch decode


def _expand(lo: torch.Tensor, hi: torch.Tensor):
    """For spans ``[lo[i], hi[i])`` (empty where hi <= lo): (span index,
    position) of every element, span by span."""
    cnt = (hi - lo).clamp(min=0)
    idx = torch.repeat_interleave(torch.arange(cnt.numel(), device=cnt.device), cnt)
    start = torch.cumsum(cnt, 0) - cnt
    j = torch.arange(idx.numel(), device=cnt.device) - start[idx] + lo[idx]
    return idx, j


def decode_tables_reference(comp: torch.Tensor, nseq: torch.Tensor,
                            tables: dict[str, torch.Tensor], out_rows: int) -> torch.Tensor:
    """Decode N blocks from their sequence tables with plain tensor ops;
    returns [N, out_rows, 128] uint8 (see the module docstring)."""
    dev = comp.device
    n, w = comp.shape
    olen = out_rows * LANES
    S = tables["lit_ptr"].shape[1]
    lp, ll, off, ml, op = (tables[k].long() for k in SEQUENCE_KEYS)
    ns = nseq.long().clamp(0, S)
    out = torch.zeros(n * olen, dtype=torch.uint8, device=dev)
    cflat = comp.reshape(-1) if comp.is_contiguous() else comp.contiguous().reshape(-1)

    # Literals: a later sequence's write wins where two overlap.
    b, s = (torch.arange(S, device=dev)[None, :] < ns[:, None]).nonzero(as_tuple=True)
    pos = op[b, s]
    idx, j = _expand((-pos).clamp(min=0), torch.minimum(ll[b, s], olen - pos))
    bi, si = b[idx], s[idx]
    q = lp[b, s][idx] + j
    val = torch.where((q >= 0) & (q < w), cflat[bi * w + q.clamp(0, w - 1)], 0)
    t = bi * olen + pos[idx] + j
    last = torch.full((n * olen,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, t, si, "amax")
    keep = si == last[t]
    out[t[keep]] = val[keep].to(torch.uint8)

    # Matches, in sequence order; one match's bytes all read before its dst.
    dst = op + ll
    steps = int(ns.max()) if n else 0
    for k in range(steps):
        bb = ((k < ns) & (ml[:, k] > 0)).nonzero().squeeze(1)
        if bb.numel() == 0:
            continue
        d, o = dst[bb, k], off[bb, k]
        idx, j = _expand((-d).clamp(min=0), torch.minimum(ml[bb, k], olen - d))
        di, oi = d[idx], o[idx]
        q = torch.where(oi >= 1, di - oi + j % oi.clamp(min=1), -1)
        base = bb[idx] * olen
        val = torch.where(q >= 0, out[base + q.clamp(0, olen - 1)], 0)
        out[base + di + j] = val
    return out.reshape(n, out_rows, LANES)


# ---------------------------------------------------------------------------
# The CUDA kernel


def _bind(lib: ctypes.CDLL) -> None:
    vp, c_int, c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bt_decode_tables_launch.restype = c_int
    lib.bt_decode_tables_launch.argtypes = [
        vp, c_ll, c_int,                  # comp, row stride, width
        vp, vp, vp, vp, vp, vp, c_int,    # nseq, lit_ptr, lit_len, off, mlen, out_pos, S
        vp, c_int, c_int,                 # out, n, out_rows
        vp, c_ll,                         # source rows, rows they may name
        vp, c_int, vp]                    # paths, device, stream
    lib.bt_decode_tables_cluster_ctas.restype = c_int
    lib.bt_decode_tables_cluster_ctas.argtypes = [c_int]
    bad = [r for r in range(1, 8194) if lib.bt_decode_tables_cluster_ctas(r) != cluster_ctas(r)]
    require(not bad, lambda: f"decode_tables.cu's cluster sizes differ from cluster_ctas "
                             f"at {bad[:4]} rows")


def load_kernel() -> ctypes.CDLL:
    """Build (at first use, for sm_90a) and load ``csrc/decode_tables.cu``."""
    return load_cuda_kernel("decode_tables", _bind)


_launch_fn = None     # the library's bound launch function, once loaded


def _check_src_rows(comp: torch.Tensor, src_rows: torch.Tensor) -> int:
    """The number of blocks a source-row table names; StatusError unless it
    is a contiguous int32 ``[n]`` tensor on ``comp``'s device."""
    require(isinstance(src_rows, torch.Tensor) and src_rows.dtype == torch.int32
            and src_rows.ndim == 1 and src_rows.is_contiguous()
            and src_rows.device == comp.device,
            lambda: f"src_rows: want a contiguous int32 [n] tensor on {comp.device}")
    return src_rows.numel()


def _launch_kernel(comp: torch.Tensor, nseq: torch.Tensor, tables: dict,
                   out_rows: int, path_counts: torch.Tensor | None,
                   src_rows: torch.Tensor | None = None) -> torch.Tensor:
    global launches, cluster_launches, _launch_fn
    dev, rows = comp.device, comp.shape[0]
    n = rows if src_rows is None else src_rows.numel()
    cols = [tables[k] for k in SEQUENCE_KEYS]
    S = cols[0].shape[-1]
    # What the kernel reads: int32, contiguous, on comp's device, [rows] and
    # [rows, S] (rows: n, or through source rows the rows they name).
    for t in (nseq, *cols):
        require(t.device == dev and t.dtype == torch.int32 and t.is_contiguous(),
                lambda: f"nseq and tables: want contiguous int32 tensors on {dev}")
    require(nseq.shape == (rows,) and all(t.shape == (rows, S) for t in cols),
            lambda: f"nseq and tables: want [{rows}] and [{rows}, {S}]")
    paths = 0
    if path_counts is not None:
        require(path_counts.device == dev and path_counts.dtype == torch.int32
                and path_counts.shape == (2,) and path_counts.is_contiguous(),
                lambda: f"path_counts: want a contiguous int32 [2] on {dev}")
        paths = path_counts.data_ptr()
    out = torch.empty((n, out_rows, LANES), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    if _launch_fn is None:
        _launch_fn = load_kernel().bt_decode_tables_launch
    # The device's current stream as torch.cuda.current_stream(dev).cuda_stream
    # gives it, without building a Stream object (0.14 us a call against 5.4
    # on an H100 host).
    rc = _launch_fn(comp.data_ptr(), comp.stride(0), comp.shape[1], nseq.data_ptr(),
                    *(t.data_ptr() for t in cols), S, out.data_ptr(), n, out_rows,
                    None if src_rows is None else src_rows.data_ptr(), rows,
                    paths, dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        check_cuda(rc, "decode_tables launch", load_kernel())
    launches += 1
    device_launches[dev.index] += 1
    cluster_launches += cluster_ctas(out_rows) > 1
    return out


def decode_blocks(comp: torch.Tensor, nseq: torch.Tensor, tables: dict[str, torch.Tensor],
                  *, out_rows: int, path_counts: torch.Tensor | None = None,
                  src_rows: torch.Tensor | None = None) -> torch.Tensor:
    """Decode a batch of blocks from their sequence tables.

    ``comp``: [N, W] uint8 compressed rows (arena slots; the row stride may
    exceed W).  ``nseq`` [N] and ``tables`` {key: [N, S]} int32 on
    ``comp``'s device (:func:`table_tensors`).  Returns [N, out_rows, 128]
    uint8.  With ``src_rows`` (contiguous int32 ``[n]`` on ``comp``'s
    device), block ``b`` reads row ``src_rows[b]`` of ``comp``, ``nseq``
    and every table: they are then resident rows (the engine's whole arena
    and its table store, one row a slot) and the result is ``[n, out_rows,
    128]``.  Rows must lie in ``[0, N)``: the plain version raises past
    them, the kernel clips to them.  ``path_counts``, an int32 [2] tensor
    on the same device, gets the call's blocks added: [0] those decoded in
    parallel (:func:`well_formed` tables), [1] those walked serially.  A
    CPU ``comp`` runs :func:`decode_tables_reference` (on the rows the
    table selects); a CUDA one launches the kernel or raises StatusError.
    Traced, the span ``bitar.ops.decode_tables`` (to the launch) and the
    counter ``decode_tables.blocks``."""
    with profiling.annotate("bitar.ops.decode_tables"):
        require(comp.dtype == torch.uint8 and comp.ndim == 2 and comp.stride(1) == 1,
                lambda: f"comp: want [N, W] uint8 rows, got {tuple(comp.shape)} {comp.dtype}")
        require(out_rows >= 1, lambda: f"out_rows {out_rows} must be positive")
        n = comp.shape[0] if src_rows is None else _check_src_rows(comp, src_rows)
        profiling.count("decode_tables.blocks", n)
        if comp.device.type == "cpu":
            if src_rows is not None:      # the kernel's wrapper checks the rows on the card
                rows, cols = comp.shape[0], [tables[k] for k in SEQUENCE_KEYS]
                require(nseq.shape[:1] == (rows,) and all(t.shape[:1] == (rows,) for t in cols),
                        lambda: f"src_rows: nseq and the tables want comp's {rows} rows, got "
                                f"{nseq.shape[0]} and {[t.shape[0] for t in cols]}")
                comp, nseq = comp.index_select(0, src_rows), nseq.index_select(0, src_rows)
                tables = {k: t.index_select(0, src_rows) for k, t in zip(SEQUENCE_KEYS, cols)}
            if path_counts is not None:
                wf = well_formed(nseq, tables)
                path_counts += torch.stack([wf.sum(), (~wf).sum()]).to(path_counts.dtype)
            return decode_tables_reference(comp, nseq, tables, out_rows)
        require(comp.device.type == "cuda",
                lambda: f"decode_blocks: no kernel for device {comp.device}")
        return _launch_kernel(comp, nseq, tables, out_rows, path_counts, src_rows)
