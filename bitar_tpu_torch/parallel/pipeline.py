"""The fused distributed step: shuffle + decode.

Counterpart of ``bitar_tpu/parallel/pipeline.py``.  Each rank stages its
compressed slot rows, exchanges them with one all-to-all, and decodes what
it received on its device: kernel B1 (flat plans) in
``distributed_step_flat``, kernel B2 (sequence tables) in
``distributed_step_tables_fallback``.  This is bitar's "enqueue the next
burst while the device works on the previous one" loop (``device.cc:197-226``)
lifted to the mesh (BASELINE.json config 5).

The step functions take the JAX package's arguments, but as this rank's
tensors: ``slot_rows`` is this rank's [nblocks / D, slot] shard,
``send_idx``/``valid`` its row of the plan's staging metadata
(``ShufflePlan.staging``), and each wire array its destination's slice
(``wires[k][rank]``, see :func:`local_wires`).  Each returns this rank's
[D * rpp, block_size] uint8 rows, in ``plan.recv_block[rank]`` order.
The wire builders are numpy copies of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.decode_flat import DCHUNK, LANES, _S_QUANTUM, decode_blocks_flat, pack_row_a_planes
from ..ops.decode_tables import decode_blocks
from ..utils import profiling
from .sharding import _TABLE_KEYS, mesh_device, mesh_group, mesh_rank
from .shuffle import ShufflePlan, all_to_all_rows, stage_rows

#: Keys of a flat-plan wire, in the step functions' argument order.
WIRE_KEYS = ("p_used", "p_off", "p0", "dense", "dq_idx", "se", "shift", "dq", "row_a")


def reorder_tables_for_recv(plan: ShufflePlan, tables: dict[str, np.ndarray],
                            nseq: np.ndarray) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """Arrange per-block sequence tables in post-shuffle receive order.

    Wire position ``dst * (D * rpp) + src * rpp + j`` holds global block
    ``plan.recv_block[dst, src, j]`` (or an idle row, nseq=0).
    """
    d, rpp = plan.num_devices, plan.rows_per_pair
    n_wire = d * d * rpp
    seq_cap = tables[_TABLE_KEYS[0]].shape[1]
    out = {k: np.zeros((n_wire, seq_cap), np.int32) for k in _TABLE_KEYS}
    out_nseq = np.zeros(n_wire, np.int32)
    flat = plan.recv_block.reshape(-1)
    live = flat >= 0
    idx = flat[live]
    for k in _TABLE_KEYS:
        out[k][live] = tables[k][idx]
    out_nseq[live] = nseq[idx]
    return out, out_nseq


def local_wires(wires: dict[str, np.ndarray], rank: int, device) -> dict[str, torch.Tensor]:
    """Destination ``rank``'s slice of stacked wires (leading axis D), as
    tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(wires[k][rank])).to(device)
            for k in WIRE_KEYS}


def distributed_step_tables_fallback(slot_rows, send_idx, valid, nseq, lit_ptr, lit_len, off,
                                     mlen, out_pos, *, mesh: DeviceMesh, rows_per_pair: int,
                                     out_rows: int, block_size: int) -> torch.Tensor:
    """One shuffle + decode step — SEQUENCE-TABLE FALLBACK wire (B2).

    The pod-level decode is ``distributed_step_flat`` /
    ``distributed_step_ring_flat``; this variant is for units whose blocks
    fail flat planning.  ``nseq`` and the tables are this rank's [D * rpp]
    rows in receive order (:func:`reorder_tables_for_recv`)."""
    del rows_per_pair             # the staging metadata carries it
    staged = stage_rows(slot_rows, send_idx, valid)
    recv = all_to_all_rows(staged, mesh_group(mesh))
    tables = dict(zip(_TABLE_KEYS, (lit_ptr, lit_len, off, mlen, out_pos), strict=True))
    planes = decode_blocks(recv, nseq, tables, out_rows=out_rows)
    return planes.reshape(planes.shape[0], -1)[:, :block_size]


def prepare_distributed_step_tables_fallback(mesh: DeviceMesh, plan: ShufflePlan,
                                             slot_rows: np.ndarray,
                                             tables: dict[str, np.ndarray],
                                             nseq: np.ndarray, block_size: int, device=None):
    """Host-side prep for the sequence-table FALLBACK step: this rank's
    shard and staging metadata, and its receive-ordered tables.

    ``slot_rows`` [nblocks, slot] and ``tables`` are the whole batch (every
    rank holds them, as every JAX process holds the global arrays).  Returns
    (args tuple, kwargs dict) for ``distributed_step_tables_fallback``."""
    d, rpp = plan.num_devices, plan.rows_per_pair
    me = mesh_rank(mesh)
    device = mesh_device(mesh) if device is None else device
    per_src = slot_rows.shape[0] // d
    recv_tables, recv_nseq = reorder_tables_for_recv(plan, tables, nseq)
    send_idx, valid = plan.staging(me, per_src)
    mine = slice(me * d * rpp, (me + 1) * d * rpp)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    args = (dev(slot_rows[me * per_src:(me + 1) * per_src]), dev(send_idx), dev(valid),
            dev(recv_nseq[mine]), *(dev(recv_tables[k][mine]) for k in _TABLE_KEYS))
    kwargs = dict(mesh=mesh, rows_per_pair=rpp, out_rows=-(-block_size // LANES),
                  block_size=block_size)
    return args, kwargs


def _group_flat_wires(groups: list[np.ndarray], se: np.ndarray, sh: np.ndarray,
                      p_used: np.ndarray, p0: np.ndarray, dq: np.ndarray, row_a: np.ndarray,
                      dense: np.ndarray, nrows: int) -> dict[str, np.ndarray]:
    """Build one stacked flat wire per block GROUP (a [k] int array of
    global block ids, -1 = idle row), padded to common static sizes so the
    stacked shapes agree.  Shared by the per-destination (all-to-all) and
    per-(destination, source)-chunk (ring) preps."""
    tiles = nrows // LANES
    dmax = max(1, int(dense.max(initial=0)))
    dcap = 1 << (dmax - 1).bit_length()

    per = []
    for blocks in groups:
        nwire = blocks.shape[0]
        sel = np.maximum(blocks, 0)
        live = blocks >= 0
        pu = np.where(live, p_used[sel], 0).astype(np.int32)
        p0d = np.where(live, p0[sel], 0).astype(np.int32)
        dnd = np.where(live, dense[sel], 0).astype(np.int32)
        p_off = np.zeros(nwire, np.int32)
        p_off[1:] = np.cumsum(pu[:-1])
        s_used = int(pu.sum())
        se_w = np.zeros((s_used, tiles, LANES), np.int16)
        sh_w = np.zeros((s_used, tiles, LANES), np.int32)
        for j in np.flatnonzero(pu):
            b, o, pj = int(sel[j]), int(p_off[j]), int(pu[j])
            se_w[o:o + pj] = se[b, :pj].reshape(pj, tiles, LANES)
            sh_w[o:o + pj] = sh[b, :pj].reshape(pj, tiles, LANES)
        wsel = np.flatnonzero(dnd > 0)
        dq_w = dq[sel[wsel]] if wsel.size else np.zeros((0, nrows, 128), np.int16)
        ra_w = row_a[sel[wsel], :dcap] if wsel.size else np.zeros((0, dcap, nrows), np.int32)
        dq_idx = np.maximum(np.cumsum(dnd > 0) - 1, 0).astype(np.int32)
        per.append((pu, p_off, p0d, dnd, dq_idx, se_w, sh_w, dq_w, ra_w))

    g = len(groups)
    s_max = max(p[5].shape[0] for p in per)
    s_pad = -(-(s_max + DCHUNK) // _S_QUANTUM) * _S_QUANTUM
    nd_max = max(1, max(p[7].shape[0] for p in per))
    out = {
        "p_used": np.stack([p[0] for p in per]),
        "p_off": np.stack([p[1] for p in per]),
        "p0": np.stack([p[2] for p in per]),
        "dense": np.stack([p[3] for p in per]),
        "dq_idx": np.stack([p[4] for p in per]),
        "se": np.zeros((g, s_pad, tiles, LANES), np.int16),
        "shift": np.zeros((g, s_pad, tiles, LANES), np.int32),
        "dq": np.zeros((g, nd_max, nrows, 128), np.int16),
        "row_a": np.zeros((g, nd_max, dcap, LANES, tiles), np.int32),
    }
    for gi, p in enumerate(per):
        out["se"][gi, :p[5].shape[0]] = p[5]
        out["shift"][gi, :p[6].shape[0]] = p[6]
        out["dq"][gi, :p[7].shape[0]] = p[7]
        if p[8].shape[0]:
            out["row_a"][gi, :p[8].shape[0]] = pack_row_a_planes(p[8], dcap)
    return out


def prepare_flat_wires_for_recv(plan: ShufflePlan, se: np.ndarray, sh: np.ndarray,
                                p_used: np.ndarray, p0: np.ndarray, dq: np.ndarray,
                                row_a: np.ndarray, dense: np.ndarray,
                                nrows: int) -> dict[str, np.ndarray]:
    """Arrange per-block flat-plan buffers into PER-DESTINATION stacked
    wires for ``distributed_step_flat``.

    Inputs are ``bt_plan_batch``'s per-block buffers: se/sh [n, max_passes,
    nrows], dq [n, nrows, 128] int16, row_a [n, DENSE_PLANES, nrows] int32,
    dense [n] (0..63, or -1 identity).  Output arrays all have a leading
    [D] destination axis; rank d takes ``[d]`` (:func:`local_wires`)."""
    groups = [plan.recv_block[dst].reshape(-1) for dst in range(plan.num_devices)]
    return _group_flat_wires(groups, se, sh, p_used, p0, dq, row_a, dense, nrows)


def prepare_ring_flat_wires_for_recv(plan: ShufflePlan, se: np.ndarray, sh: np.ndarray,
                                     p_used: np.ndarray, p0: np.ndarray, dq: np.ndarray,
                                     row_a: np.ndarray, dense: np.ndarray,
                                     nrows: int) -> dict[str, np.ndarray]:
    """Per-(destination, source)-CHUNK stacked wires for
    ``distributed_step_ring_flat``: the ring decodes one source's chunk per
    round, so each chunk needs a self-contained flat wire.  Leading axes are
    [D_dst, D_src]; chunk wires share padded sizes."""
    d = plan.num_devices
    groups = [plan.recv_block[dst, src].reshape(-1) for dst in range(d) for src in range(d)]
    w = _group_flat_wires(groups, se, sh, p_used, p0, dq, row_a, dense, nrows)
    return {k: v.reshape((d, d) + v.shape[1:]) for k, v in w.items()}


def distributed_step_flat(slot_rows, send_idx, valid, p_used, p_off, p0, dense, dq_idx, se,
                          shift, dq, row_a, *, mesh: DeviceMesh, rows_per_pair: int,
                          comp_rows: int, block_size: int) -> torch.Tensor:
    """Fused shuffle + FLAT-PLAN decode: one all-to-all of the staged slot
    rows, then kernel B1 (``decode_blocks_flat``) on everything this rank
    received.  Wire arguments are this rank's slice of
    :func:`prepare_flat_wires_for_recv`'s arrays.  Traced, the span
    ``bitar.parallel.distributed_step_flat``."""
    del rows_per_pair             # the staging metadata carries it
    with profiling.annotate("bitar.parallel.distributed_step_flat"):
        staged = stage_rows(slot_rows, send_idx, valid)
        recv = all_to_all_rows(staged, mesh_group(mesh))
        plans = dict(zip(WIRE_KEYS, (p_used, p_off, p0, dense, dq_idx, se, shift, dq, row_a),
                         strict=True))
        out = decode_blocks_flat(recv, plans, comp_rows=comp_rows, out_rows=block_size // LANES)
        return out.reshape(recv.shape[0], block_size)
