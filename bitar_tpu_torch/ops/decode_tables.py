"""Sequence-table block decode (kernel B2): LZ4, Snappy and RAW blocks of any
size, and the engine's path for units the flat planner cannot take.

Counterpart of ``bitar_tpu/ops/pallas/lz4_decode.py``.  The host parser
(``native.parse_sequences``) turns a compressed block into a table of
sequences (``lit_ptr, lit_len, off, mlen, out_pos``); a RAW block is one
literal run.  This module holds

* ``pad_tables`` (a copy of ``bitar_tpu/ops/pallas/layout.py``'s) and
  ``table_tensors``, which pad per-block tables to one width and put them on
  a device;
* ``decode_tables_reference``: the plain PyTorch decode;
* ``decode_blocks``: the wrapper.  On CPU tensors it runs the plain version;
  on CUDA tensors it launches ``csrc/decode_tables.cu`` or raises.

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

import ctypes

import numpy as np
import torch

from ._build import check_cuda, load_cuda_kernel, require
from .cpu.native import SEQUENCE_KEYS

LANES = 128

#: Kernel launches made by ``decode_blocks`` on CUDA tensors (one per call).
launches = 0


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
        vp, c_int, c_int, vp]             # out, n, out_rows, stream


def load_kernel() -> ctypes.CDLL:
    """Build (at first use, for sm_90a) and load ``csrc/decode_tables.cu``."""
    return load_cuda_kernel("decode_tables", _bind)


def _launch_kernel(comp: torch.Tensor, nseq: torch.Tensor, tables: dict,
                   out_rows: int) -> torch.Tensor:
    global launches
    n = comp.shape[0]
    S = tables["lit_ptr"].shape[1]
    require(nseq.device == comp.device and nseq.dtype == torch.int32
            and nseq.is_contiguous() and nseq.shape == (n,),
            f"nseq: want contiguous int32 [{n}] on {comp.device}")
    for k in SEQUENCE_KEYS:
        t = tables[k]
        require(t.device == comp.device and t.dtype == torch.int32 and t.is_contiguous()
                and t.shape == (n, S),
                f"table {k}: want contiguous int32 [{n}, {S}] on {comp.device}")
    out = torch.empty((n, out_rows, LANES), dtype=torch.uint8, device=comp.device)
    if n == 0:
        return out
    lib = load_kernel()
    with torch.cuda.device(comp.device):
        stream = torch.cuda.current_stream(comp.device).cuda_stream
        rc = lib.bt_decode_tables_launch(
            comp.data_ptr(), comp.stride(0), comp.shape[1], nseq.data_ptr(),
            *(tables[k].data_ptr() for k in SEQUENCE_KEYS), S,
            out.data_ptr(), n, out_rows, stream)
    check_cuda(rc, "decode_tables launch", lib)
    launches += 1
    return out


def decode_blocks(comp: torch.Tensor, nseq: torch.Tensor, tables: dict[str, torch.Tensor],
                  *, out_rows: int) -> torch.Tensor:
    """Decode a batch of blocks from their sequence tables.

    ``comp``: [N, W] uint8 compressed rows (arena slots; the row stride may
    exceed W).  ``nseq`` [N] and ``tables`` {key: [N, S]} int32 on
    ``comp``'s device (:func:`table_tensors`).  Returns [N, out_rows, 128]
    uint8.  A CPU ``comp`` runs :func:`decode_tables_reference`; a CUDA one
    launches the kernel or raises StatusError."""
    require(comp.dtype == torch.uint8 and comp.ndim == 2 and comp.stride(1) == 1,
            f"comp: want [N, W] uint8 rows, got {tuple(comp.shape)} {comp.dtype}")
    require(out_rows >= 1, f"out_rows {out_rows} must be positive")
    if comp.device.type == "cpu":
        return decode_tables_reference(comp, nseq, tables, out_rows)
    require(comp.device.type == "cuda", f"decode_blocks: no kernel for device {comp.device}")
    return _launch_kernel(comp, nseq, tables, out_rows)
