"""Flat-plan block decode: the LZ4/Snappy/RAW decode of the main path.

Counterpart of ``bitar_tpu/ops/pallas/lz4_decode_flat.py``.  The host
planner (``plan.cc``) turns every compressed block into a schedule over its
``out_rows x 128`` output plane; this module holds

* ``plan_tensors``, which puts a plan wire on a device, and the wire
  builders that tests use (numpy, identical to the JAX module's),
* ``decode_flat_reference``: the plain PyTorch decode, with the semantics
  of the JAX module's numpy oracle ``decode_flat_numpy``,
* ``decode_blocks_flat``: the wrapper.  On CPU tensors it runs the plain
  version; on CUDA tensors it launches the hand-written kernel
  ``csrc/decode_flat.cu`` or raises.  It never falls back.  Planes of up to
  ``DECODE_FLAT_MAX_ROWS`` rows take the kernel's shared-memory route (one
  CTA a block), taller ones (blocks of 256 KiB to 1 MiB) its tall route: a
  kernel on every SM for the blocks without out passes, then a
  thread-block cluster for each block with out passes, each CTA holding
  1024 rows of its plane in shared memory (:func:`cluster_ctas`).  With a
  source-row table it reads each block's comp row where it lies in a
  larger buffer (the engine's slot arena), so a resident unit decodes with
  no gathered copy.
* ``prepare_flat_launch`` and ``FlatLaunch``: the wrapper split in two, its
  checks and the kernel's packed arguments and grid settled once, then run
  as often as wanted (the engine keeps one record a burst of a resident
  unit); ``decode_blocks_flat`` is one of each.

Plan wire, per block ``i`` (see ``decode_flat_reference`` for the order):

* ``dense[i] < 0``: RAW block, the output is the comp plane.
* ``dq`` int16 ``[m, out_rows, 128]``, row ``dq_idx[i]``: per output byte
  ``pid << 9 | drow << 7 | qlane``; dense pass ``pid`` (1-based, at most
  ``dense[i]``) writes ``comp[(row_a + drow) * 128 + qlane]``, with
  ``row_a`` int32 ``[m, dcap, 128, tiles]`` (row r at ``[.., r & 127, r >> 7]``).
* passes ``k < p_used[i]`` read wire row ``p_off[i] + k`` of ``se`` int16
  and ``shift`` int32 ``[S, tiles, 128]`` (row r at ``[.., r >> 7, r & 127]``):
  lanes ``[se >> 8 & 0x7F, se & 0xFF)`` of row r take ``src[p + shift]``,
  from the comp plane for ``k < p0[i]`` and from the output plane as it
  was before the pass otherwise.

Every source index clips to its plane; comp bytes past the row width read 0.
"""

from __future__ import annotations

import collections
import ctypes
import threading

import numpy as np
import torch

from ..config import DECODE_FLAT_MAX_ROWS
from ..utils import profiling
from ._build import block_queue, check_cuda, load_cuda_kernel, require

LANES = 128
CB = 4                # passes per planner batch (plans pad to CB multiples)
DCHUNK = CB           # slack plan rows past the last pass
_S_QUANTUM = 512      # plan-array length rounds up to this
KBAND = 256           # row quantum of comp planes taller than 128 rows

#: Kernel launches made by ``decode_blocks_flat`` on CUDA tensors (one per
#: call).  Read it to show that a run went through the kernel; reset it to
#: 0 before such a run.
launches = 0
#: Those of them that took the tall route, whose cluster kernel holds a
#: block's plane in a thread-block cluster (planes taller than
#: ``DECODE_FLAT_MAX_ROWS`` rows).
cluster_launches = 0
#: ``launches`` again by CUDA device index: the card each launch ran on.
device_launches: collections.Counter = collections.Counter()
MAX_CLUSTER = 8       # the portable cluster size: planes of up to 8192 rows


def cluster_ctas(out_rows: int) -> int:
    """CTAs of the kernel that decode one block of an ``out_rows``-row
    plane: 1 on the shared route (up to ``DECODE_FLAT_MAX_ROWS`` rows), else
    the cluster route's ``ceil(out_rows / DECODE_FLAT_MAX_ROWS)``, CTA r
    holding rows ``[1024 r, 1024 (r + 1))``; 0 past 8192 rows, which the
    kernel refuses.  ``csrc/decode_flat.cu`` computes the same (checked
    when it loads)."""
    if not 0 < out_rows <= MAX_CLUSTER * DECODE_FLAT_MAX_ROWS:
        return 0
    return -(-out_rows // DECODE_FLAT_MAX_ROWS)


# ---------------------------------------------------------------------------
# Plan-wire builders (numpy; byte-identical to the JAX module's).  Only tests
# call them: they build a wire from the one-shot planner
# (``native.plan_batch_flat``) or from per-block plans, to feed the kernel
# directly.  The engine packs its wire through the two-phase native planner
# (``native.plan_batch_pack``, ``native.plan_dense_pack``).


def pad_plan_counts(P: int, p0: int) -> tuple[int, int]:
    """Pad (total, comp) pass counts to CB multiples (empty passes)."""
    p0_pad = -(-p0 // CB) * CB
    total_pad = p0_pad + -(-(P - p0) // CB) * CB
    return max(total_pad, CB), p0_pad


def _pack_plan_flat(r_dstart, r_dend, r_shift, p0):
    """One block's planner tables -> padded flat wire rows
    (se [Ppad, nrows] int16, shift [Ppad, nrows] int32, Ppad, p0_pad)."""
    P, nrows = r_dstart.shape
    row_lo = np.arange(nrows, dtype=np.int32)[None, :] * LANES
    start = np.clip(r_dstart - row_lo, 0, LANES).astype(np.int32)
    end = np.clip(r_dend - row_lo, 0, LANES).astype(np.int32)
    se = ((start << 8) | end).astype(np.int16)    # start<=127 -> fits 15 bits
    Ppad, p0_pad = pad_plan_counts(P, p0)
    se_o = np.zeros((Ppad, nrows), np.int16)
    sh_o = np.zeros((Ppad, nrows), np.int32)
    se_o[:p0] = se[:p0]
    sh_o[:p0] = r_shift[:p0]
    nout = P - p0
    se_o[p0_pad:p0_pad + nout] = se[p0:P]
    sh_o[p0_pad:p0_pad + nout] = r_shift[p0:P]
    return se_o, sh_o, Ppad, p0_pad


def flatten_batch_plans(se, shift, p_used, p0, nrows):
    """Compact ``bt_plan_batch`` buffers ([n, max_passes, nrows], first
    ``p_used[i]`` passes populated) into the flat wire dict."""
    n, mp, _ = se.shape
    tiles = nrows // LANES
    p_used = p_used.astype(np.int32)
    p_off = np.zeros(n, np.int32)
    p_off[1:] = np.cumsum(p_used)[:-1]
    S = int(p_used.sum())
    sel = np.concatenate(
        [np.arange(i * mp, i * mp + int(p_used[i])) for i in range(n)]
    ) if n else np.zeros(0, np.int64)
    S_pad = -(-(S + DCHUNK) // _S_QUANTUM) * _S_QUANTUM
    se_flat = np.zeros((S_pad, tiles, LANES), np.int16)
    sh_flat = np.zeros((S_pad, tiles, LANES), np.int32)
    se_flat[:S] = se.reshape(n * mp, tiles, LANES)[sel]
    sh_flat[:S] = shift.reshape(n * mp, tiles, LANES)[sel]
    return {"p_used": p_used, "p_off": p_off, "p0": p0.astype(np.int32),
            "se": se_flat, "shift": sh_flat}


def pack_row_a_planes(row_a: np.ndarray, dcap: int) -> np.ndarray:
    """[m, D, nrows] pass-major anchors -> the kernel's [m, dcap, 128,
    tiles] column layout (trimmed or zero-padded to ``dcap`` planes)."""
    m, D, nrows = row_a.shape
    tiles = nrows // LANES
    ra = row_a[:, :dcap]
    if dcap > D:
        ra = np.pad(ra, ((0, 0), (0, dcap - D), (0, 0)))
    return np.ascontiguousarray(
        ra.reshape(m, dcap, tiles, LANES).transpose(0, 1, 3, 2))


def attach_dense_planes(plans: dict, dq: np.ndarray, row_a: np.ndarray,
                        dense: np.ndarray) -> dict:
    """Attach the planner's dense comp-pass planes (``dq`` [n, nrows, 128]
    int16, ``row_a`` [n, D, nrows] int32, ``dense`` [n]) to a flat-plan
    dict, with anchor planes trimmed to a power-of-two ``dcap``."""
    n, D, nrows = row_a.shape
    plans["dq"] = dq
    dmax = max(1, int(dense.max(initial=0)))
    dcap = min(D, 1 << (dmax - 1).bit_length())
    require(nrows % LANES == 0, "dense planes need lane-tiled rows")
    plans["row_a"] = pack_row_a_planes(row_a, dcap)
    plans["dense"] = dense.astype(np.int32)
    return plans


def concat_flat_plans(parts: list[dict]) -> dict:
    """Merge per-chunk ``flatten_batch_plans`` outputs into one wire (each
    part's slack/quantization padding stripped, one re-added)."""
    if len(parts) == 1:
        return parts[0]
    p_used = np.concatenate([p["p_used"] for p in parts])
    p0 = np.concatenate([p["p0"] for p in parts])
    sizes = [int(p["p_used"].sum()) for p in parts]
    S = sum(sizes)
    S_pad = -(-(S + DCHUNK) // _S_QUANTUM) * _S_QUANTUM
    tiles = parts[0]["se"].shape[1]
    se = np.zeros((S_pad, tiles, LANES), np.int16)
    sh = np.zeros((S_pad, tiles, LANES), np.int32)
    offs = []
    o = 0
    for p, sz in zip(parts, sizes, strict=True):
        se[o:o + sz] = p["se"][:sz]
        sh[o:o + sz] = p["shift"][:sz]
        offs.append(p["p_off"].astype(np.int64) + o)
        o += sz
    return {"p_used": p_used, "p_off": np.concatenate(offs).astype(np.int32),
            "p0": p0, "se": se, "shift": sh}


def build_flat_plans(per_block, nrows):
    """Assemble per-block ``plan_block``-shaped results ``(P, p0, cols)``
    into the flat wire dict (p_used, p_off, p0 [N] int32; se, shift
    [S, tiles, 128])."""
    tiles = nrows // LANES
    packed = [_pack_plan_flat(cols["r_dstart"][:P], cols["r_dend"][:P],
                              cols["r_shift"][:P], p0)
              for (P, p0, cols) in per_block]
    n = len(packed)
    p_used = np.array([p[2] for p in packed], np.int32)
    p0s = np.array([p[3] for p in packed], np.int32)
    p_off = np.zeros(n, np.int32)
    p_off[1:] = np.cumsum(p_used)[:-1]
    S = int(p_used.sum())
    S_pad = -(-(S + DCHUNK) // _S_QUANTUM) * _S_QUANTUM
    se = np.zeros((S_pad, tiles, LANES), np.int16)
    shift = np.zeros((S_pad, tiles, LANES), np.int32)
    for i, (se_i, sh_i, Ppad, _) in enumerate(packed):
        o = p_off[i]
        se[o:o + Ppad] = se_i.reshape(Ppad, tiles, LANES)
        shift[o:o + Ppad] = sh_i.reshape(Ppad, tiles, LANES)
    return {"p_used": p_used, "p_off": p_off, "p0": p0s, "se": se, "shift": shift}


def plan_tensors(plans: dict, device) -> dict[str, torch.Tensor]:
    """The decode wire of a host plan dict as tensors on ``device``:
    p_used, p_off, p0, dense, dq_idx (int32 [N]), se, shift, dq, row_a.
    Blocks without dense planes get ``dense = 0``; a plan without ``dq``
    gets one all-zero wire row."""
    n = plans["p_used"].shape[0]
    tiles = plans["se"].shape[1]
    nrows = tiles * LANES
    dq = plans.get("dq")
    if dq is None:
        dq = np.zeros((1, nrows, LANES), np.int16)
        row_a = np.zeros((1, 1, LANES, tiles), np.int32)
        dense = np.zeros(n, np.int32)
        dq_idx = np.zeros(n, np.int32)
    else:
        row_a, dense = plans["row_a"], plans["dense"]
        dq_idx = plans.get("dq_idx")
        if dq_idx is None:
            dq_idx = np.arange(n, dtype=np.int32)
    arrays = {"p_used": plans["p_used"], "p_off": plans["p_off"],
              "p0": plans["p0"], "dense": dense, "dq_idx": dq_idx,
              "se": plans["se"], "shift": plans["shift"], "dq": dq,
              "row_a": row_a}
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def block_classes(plans: dict) -> dict[str, torch.Tensor]:
    """The blocks of a plan wire by what the kernel does with them: "raw"
    (a copy), "no out pass" (dense and comp passes only, swept straight to
    device memory) and "out passes" (the shared-memory plane).  Index
    tensors on the plan's device; together they cover every block once."""
    dense, p_used, p0 = (plans[k].long() for k in ("dense", "p_used", "p0"))
    decoded = dense >= 0
    outs = decoded & (p0 < p_used)
    return {"raw": torch.nonzero(~decoded).flatten(),
            "no out pass": torch.nonzero(decoded & ~outs).flatten(),
            "out passes": torch.nonzero(outs).flatten()}


def select_blocks(comp: torch.Tensor, plans: dict, idx: torch.Tensor):
    """Blocks ``idx`` of a batch as a batch of their own: their comp rows and
    per-block plan fields; the shared wire (se, shift, dq, row_a) stays."""
    sub = dict(plans)
    for k in ("p_used", "p_off", "p0", "dense", "dq_idx"):
        sub[k] = plans[k][idx].contiguous()
    return comp[idx], sub


def random_wire(seed: int, n: int, out_rows: int, comp_rows: int, dcap: int) -> tuple:
    """A batch of random plan wires, to hold the kernel to its plain version
    (and the plain version to the JAX module's oracle) beyond what the
    planner emits: every dq entry (pass ids 0-63), anchors in and around the
    comp plane and near the int32 limits, ``dense`` from -1 (RAW) to
    ``dcap``, comp passes then out passes with random ranges and shifts.
    Returns numpy (comp [n, comp_rows * 128 + 16] uint8, wire dict)."""
    rng = np.random.default_rng(seed)
    tiles = out_rows // LANES
    m = max(1, n // 2)
    ra = rng.integers(-3, comp_rows + 3, (m, dcap, LANES, tiles))
    wide = rng.random(ra.shape) < 0.05
    ra[wide] = rng.integers(-2**31, 2**31 - 1, int(wide.sum()))
    p_used = rng.integers(0, 7, n).astype(np.int32)
    p_off = np.concatenate([[0], np.cumsum(p_used)[:-1]]).astype(np.int32)
    S = -(-(int(p_used.sum()) + DCHUNK) // _S_QUANTUM) * _S_QUANTUM
    se = (rng.integers(0, 128, (S, tiles, LANES)) << 8) | rng.integers(0, 129, (S, tiles, LANES))
    olen = out_rows * LANES
    plans = {"p_used": p_used, "p_off": p_off,
             "p0": rng.integers(0, p_used + 1).astype(np.int32),
             "se": se.astype(np.int16),
             "shift": rng.integers(-olen - 300, olen + 300, (S, tiles, LANES)).astype(np.int32),
             "dq": rng.integers(-2**15, 2**15, (m, out_rows, LANES)).astype(np.int16),
             "row_a": ra.astype(np.int32),
             "dense": rng.integers(-1, dcap + 1, n).astype(np.int32),
             "dq_idx": rng.integers(0, m, n).astype(np.int32)}
    comp = rng.integers(0, 256, (n, comp_rows * LANES + 16), dtype=np.uint8)
    return comp, plans


def slice_crossing_wire(out_rows: int, seed: int) -> tuple:
    """Four blocks whose comp pass fills the plane with the comp row's bytes
    and whose out passes gather across the cluster route's slices (1024
    rows each): whole rows shifted back and forth by a few bytes past every
    slice edge (the kernel's whole-word path), part rows a slice away (its
    byte path), rows at each edge from up to 4000 bytes back, and shifts
    that clip at the plane's first and last byte.  Returns numpy (comp [4,
    out_rows * 128] uint8, wire dict); comp_rows is out_rows."""
    rng = np.random.default_rng(seed)
    tiles, olen, edge = out_rows // LANES, out_rows * LANES, DECODE_FLAT_MAX_ROWS
    n, npass = 4, 8
    se = np.zeros((n * npass + _S_QUANTUM, out_rows), np.int16)
    sh = np.zeros(se.shape, np.int32)
    for b in range(n):
        base = b * npass
        se[base] = LANES                                 # comp pass: lanes [0, 128) everywhere
        for k, (lo, hi, shift, lanes) in enumerate([
                (0, out_rows, -(3 * LANES + 5 + b), (0, LANES)),    # back across every edge
                (0, out_rows, 7 * LANES + 3 + b, (0, LANES)),       # forward across every edge
                (0, 8, -olen, (0, LANES)),                          # clips at byte 0
                (out_rows - 8, out_rows, olen, (0, LANES)),         # clips at the last byte
                (0, out_rows, -edge * LANES + 1, (5 + b, 99)),      # a slice back, part rows
                (0, out_rows, edge * LANES - 2, (1, 127 - b))]):    # a slice on, part rows
            se[base + 2 + k, lo:hi] = (lanes[0] << 8) | lanes[1]
            sh[base + 2 + k, lo:hi] = shift
        for e in range(edge, out_rows, edge):            # a pass of the rows at each edge
            se[base + 1, e - 2:e + 2] = LANES
            sh[base + 1, e - 2:e + 2] = -int(rng.integers(1, 4000))
    plans = {"p_used": np.full(n, npass, np.int32),
             "p_off": (np.arange(n) * npass).astype(np.int32),
             "p0": np.ones(n, np.int32),
             "se": se.reshape(-1, tiles, 128), "shift": sh.reshape(-1, tiles, 128)}
    comp = rng.integers(0, 256, (n, olen), np.uint8)
    return comp, plans


# ---------------------------------------------------------------------------
# Plain PyTorch decode


def _comp_planes(comp: torch.Tensor, comp_rows: int) -> torch.Tensor:
    """[N, W] uint8 rows -> [N, comp_rows * 128] planes (cut, or zero past W)."""
    plane_len = comp_rows * LANES
    w = comp.shape[1]
    if w >= plane_len:
        return comp[:, :plane_len]
    return torch.nn.functional.pad(comp, (0, plane_len - w))


def decode_flat_reference(comp: torch.Tensor, plans: dict, comp_rows: int,
                          out_rows: int) -> torch.Tensor:
    """Decode N blocks with plain tensor ops; returns [N, out_rows, 128] uint8.

    ``comp``: [N, W] uint8 compressed rows (arena slots; W may differ from
    ``comp_rows * 128``).  ``plans``: the tensors of :func:`plan_tensors`
    on ``comp``'s device.  Per block, in order: a RAW block copies its comp
    plane; otherwise the output starts at zero, dense passes write their
    bytes, then every scheduled pass in order, each comp or out pass
    gathering from its plane as it stood before the pass."""
    dev = comp.device
    n = comp.shape[0]
    cplane = _comp_planes(comp, comp_rows).int()
    clen = comp_rows * LANES
    olen = out_rows * LANES
    out = torch.zeros((n, olen), dtype=torch.int32, device=dev)
    p = torch.arange(olen, device=dev)
    row = p >> 7
    lane = p & (LANES - 1)

    dense = plans["dense"].long()
    dq_rows = plans["dq"].shape[0]
    di = plans["dq_idx"].long()
    has_dq = (dense > 0) & (di >= 0) & (di < dq_rows)
    if bool(has_dq.any()):
        di = di.clamp(0, dq_rows - 1)
        dq = plans["dq"].reshape(dq_rows, olen)[di].long() & 0xFFFF
        pid = (dq >> 9) & 0x3F
        drow = (dq >> 7) & 3
        qlane = dq & (LANES - 1)
        ra = plans["row_a"]
        dcap = ra.shape[1]
        # [m, dcap, 128, tiles] -> [N, dcap * out_rows], row r at r
        ra = ra[di].transpose(2, 3).reshape(n, dcap * out_rows).long()
        j = (pid - 1).clamp(0, dcap - 1)
        anchor = ra.gather(1, j * out_rows + row)
        src = ((anchor + drow) * LANES + qlane).clamp(0, clen - 1)
        active = (has_dq[:, None] & (pid >= 1) & (pid <= dense[:, None])
                  & (pid <= dcap))
        out = torch.where(active, cplane.gather(1, src), out)

    se = plans["se"].reshape(-1, out_rows)
    shift = plans["shift"].reshape(-1, out_rows)
    s_rows = se.shape[0]
    p_off = plans["p_off"].long()
    npass = torch.minimum(plans["p_used"].long(), s_rows - p_off)
    npass = torch.where(p_off < 0, torch.zeros_like(npass), npass.clamp(min=0))
    ncomp = torch.minimum(plans["p0"].long().clamp(min=0), npass)
    for k in range(int(npass.max()) if n else 0):
        live = k < npass
        wire = (p_off + k).clamp(0, s_rows - 1)
        cell = (se[wire].long() & 0xFFFF)[:, row]            # [N, olen]
        start = (cell >> 8) & 0x7F
        end = cell & 0xFF
        active = live[:, None] & (lane >= start) & (lane < end)
        q = p + shift[wire].long()[:, row]
        from_comp = cplane.gather(1, q.clamp(0, clen - 1))
        from_out = out.gather(1, q.clamp(0, olen - 1))
        val = torch.where((k < ncomp)[:, None], from_comp, from_out)
        out = torch.where(active, val, out)

    raw = dense < 0
    if bool(raw.any()):
        w = min(olen, clen)
        ident = torch.zeros_like(out)
        ident[:, :w] = cplane[:, :w]
        out = torch.where(raw[:, None], ident, out)
    return out.to(torch.uint8).reshape(n, out_rows, LANES)


# ---------------------------------------------------------------------------
# The CUDA kernel


def _bind(lib: ctypes.CDLL) -> None:
    vp, c_int, c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bt_decode_flat_launch.restype = c_int
    lib.bt_decode_flat_launch.argtypes = [
        vp, c_ll, c_int, c_int,           # comp, row stride, width, comp_rows
        vp, vp, vp, vp, vp,               # p_used, p_off, p0, dense, dq_idx
        vp, vp, c_ll,                     # se, shift, wire rows
        vp, c_int, vp, c_int,             # dq, dq rows, row_a, dcap
        vp, c_int, c_int, vp,             # out, n, out_rows, queue
        vp, vp, c_ll,                     # list (tall route), source rows, comp rows
        vp]                               # stream
    lib.bt_decode_flat_launch_bytes.restype = c_int
    lib.bt_decode_flat_launch_bytes.argtypes = []
    lib.bt_decode_flat_prepare.restype = c_int
    lib.bt_decode_flat_prepare.argtypes = [
        vp,                               # the record
        vp, c_ll, c_int, c_int,           # comp, row stride, width, comp_rows
        vp, vp, vp, vp, vp,               # p_used, p_off, p0, dense, dq_idx
        vp, vp, c_ll,                     # se, shift, wire rows
        vp, c_int, vp, c_int,             # dq, dq rows, row_a, dcap
        c_int, c_int,                     # n, out_rows
        vp, c_ll, c_int]                  # source rows, comp rows, device
    lib.bt_decode_flat_run.restype = c_int
    lib.bt_decode_flat_run.argtypes = [
        vp, vp, vp, vp, vp, vp]           # record, comp, out, queue, list, stream
    lib.bt_decode_flat_resident_clusters.restype = c_int
    lib.bt_decode_flat_resident_clusters.argtypes = [c_int]
    lib.bt_decode_flat_cluster_ctas.restype = c_int
    lib.bt_decode_flat_cluster_ctas.argtypes = [c_int]
    bad = [r for r in range(LANES, 8193 + LANES, LANES)
           if lib.bt_decode_flat_cluster_ctas(r) != cluster_ctas(r)]
    require(not bad, lambda: f"decode_flat.cu's cluster sizes differ from cluster_ctas "
                             f"at {bad[:4]} rows")


def load_kernel() -> ctypes.CDLL:
    """Build (at first use, for sm_90a) and load ``csrc/decode_flat.cu``."""
    return load_cuda_kernel("decode_flat", _bind)


def resident_clusters(out_rows: int) -> int:
    """Clusters of the tall route's cluster kernel for ``out_rows``-row
    planes that the current CUDA device holds at once (its GPCs bound it,
    not its SM count).  Raises StatusError without CUDA or for a plane of
    the shared route."""
    lib = load_kernel()
    got = lib.bt_decode_flat_resident_clusters(out_rows)
    check_cuda(max(0, -got), "decode_flat resident clusters", lib)
    return got


def _check_src_rows(comp: torch.Tensor, plans: dict, src_rows: torch.Tensor) -> int:
    """The number of blocks a source-row table names; StatusError unless it
    is a contiguous int32 ``[n]`` tensor on ``comp``'s device and the plan's
    per-block fields have ``n`` entries."""
    require(isinstance(src_rows, torch.Tensor) and src_rows.dtype == torch.int32
            and src_rows.ndim == 1 and src_rows.is_contiguous()
            and src_rows.device == comp.device,
            lambda: f"src_rows: want a contiguous int32 [n] tensor on {comp.device}")
    n = src_rows.numel()
    require(tuple(plans["p_used"].shape) == (n,),
            lambda: f"src_rows names {n} blocks, the plan {tuple(plans['p_used'].shape)}")
    return n


def _check_plans(pt: dict, n: int, device: torch.device, out_rows: int) -> None:
    """StatusError unless ``pt`` holds the nine wire tensors of
    :func:`plan_tensors` for ``n`` blocks of ``out_rows``-row planes on
    ``device``, contiguous, in the kernel's dtypes and shapes."""
    for k in ("p_used", "p_off", "p0", "dense", "dq_idx"):
        t = pt[k]
        require(t.device == device and t.dtype == torch.int32
                and t.is_contiguous() and t.shape == (n,),
                lambda: f"plan {k}: want contiguous int32 [{n}] on {device}")
    for k, dt in (("se", torch.int16), ("shift", torch.int32),
                  ("dq", torch.int16), ("row_a", torch.int32)):
        t = pt[k]
        require(t.device == device and t.dtype == dt and t.is_contiguous(),
                lambda: f"plan {k}: want contiguous {dt} on {device}")
    tiles = out_rows // LANES
    require(pt["se"].shape[1:] == (tiles, LANES)
            and pt["shift"].shape == pt["se"].shape,
            lambda: f"se/shift: want [S, {tiles}, 128], got {tuple(pt['se'].shape)}")
    dq_rows = pt["dq"].shape[0]
    require(pt["dq"].shape == (dq_rows, out_rows, LANES),
            lambda: f"dq: want [m, {out_rows}, 128], got {tuple(pt['dq'].shape)}")
    ra = pt["row_a"]
    require(ra.ndim == 4 and ra.shape[0] == dq_rows
            and ra.shape[2:] == (LANES, tiles),
            lambda: f"row_a: want [{dq_rows}, dcap, 128, {tiles}], got {tuple(ra.shape)}")


class FlatLaunch:
    """One B1 launch settled but for its output: what
    :func:`decode_blocks_flat` would check and work out on every call, done
    once by :func:`prepare_flat_launch`, so that :meth:`run` only allocates
    the output, reads the current stream and launches.  A caller that decodes
    the same blocks of resident rows again (the engine's bursts of a unit)
    keeps the record and runs it as often as it likes, from any thread
    (each run on its thread's current stream); ``runs`` counts its runs.

    A record over a source-row table (``src_rows``) keeps the buffer of
    resident rows it reads (``comp``); one over plain rows keeps none, since
    such rows change from call to call: each :meth:`run` is given them, laid
    out as those it was prepared on."""

    __slots__ = ("comp", "plans", "src_rows", "n", "comp_rows", "out_rows", "device",
                 "runs", "_runs_lock", "_layout", "_out_shape", "_tall", "_record", "_addr")

    def run(self, comp: torch.Tensor | None = None) -> torch.Tensor:
        """The decoded planes, ``[n, out_rows, 128]`` uint8 on the record's
        device (on a CUDA device, queued on its current stream with that
        stream's block queue).  ``comp``: the rows to read, laid out as those
        the record was prepared on (dtype, shape, strides, device); by
        default the kept buffer of a record over a source-row table.  Traced,
        the span ``bitar.ops.decode_flat`` and the counters
        ``decode_flat.blocks`` and, from the second run on,
        ``decode_flat.prepared_blocks``."""
        with profiling.annotate("bitar.ops.decode_flat"):
            return self._launch(comp)

    def _launch(self, comp: torch.Tensor | None) -> torch.Tensor:
        global launches, cluster_launches
        if comp is None:
            require(self.comp is not None,
                    "a record over plain rows is given them on every run")
            comp = self.comp
        elif comp is not self.comp:
            require((comp.dtype, comp.device, comp.shape, comp.stride()) == self._layout,
                    lambda: f"comp: want rows laid out as {self._layout}, got "
                            f"{(comp.dtype, comp.device, comp.shape, comp.stride())}")
        n = self.n
        with self._runs_lock:
            self.runs += 1
            prepared = self.runs > 1
        profiling.count("decode_flat.blocks", n)
        if prepared:
            profiling.count("decode_flat.prepared_blocks", n)
        if self._record is None:                  # the CPU: the plain version
            if self.src_rows is not None:
                comp = comp.index_select(0, self.src_rows)
            return decode_flat_reference(comp, self.plans, self.comp_rows, self.out_rows)
        device = self.device
        out = torch.empty(self._out_shape, dtype=torch.uint8, device=device)
        if n == 0:
            return out
        stream = torch._C._cuda_getCurrentRawStream(device.index)
        # The tall route lists its blocks with out passes for its cluster
        # kernel; a list per run, as the queue is per stream.
        listed = torch.empty(n, dtype=torch.int32, device=device) if self._tall else None
        lib = load_kernel()
        rc = lib.bt_decode_flat_run(
            self._addr, None if comp is self.comp else comp.data_ptr(), out.data_ptr(),
            block_queue(device, stream).data_ptr(),
            None if listed is None else listed.data_ptr(), stream)
        check_cuda(rc, "decode_flat launch", lib)
        launches += 1
        device_launches[device.index] += 1
        cluster_launches += self._tall
        return out


def prepare_flat_launch(comp: torch.Tensor, plans: dict, *, comp_rows: int, out_rows: int,
                        src_rows: torch.Tensor | None = None) -> FlatLaunch:
    """Check and settle a B1 launch over ``comp`` (see
    :func:`decode_blocks_flat`) into a :class:`FlatLaunch`, for one run or
    many.  Raises the StatusError :func:`decode_blocks_flat` raises for
    malformed rows, plans or source rows, on the CPU too (where the runs take
    the plain version).  On a CUDA device the kernel's arguments and grids
    are packed once, its launch shape read from what the card told the
    kernel library earlier in the process."""
    require(comp.dtype == torch.uint8 and comp.ndim == 2 and comp.stride(1) == 1,
            lambda: f"comp: want [N, W] uint8 rows, got {tuple(comp.shape)} {comp.dtype}")
    require(out_rows % LANES == 0 and comp_rows % LANES == 0,
            "comp_rows and out_rows must be multiples of 128")
    n = comp.shape[0] if src_rows is None else _check_src_rows(comp, plans, src_rows)
    device = comp.device
    require(device.type in ("cpu", "cuda"),
            lambda: f"decode_blocks_flat: no kernel for device {device}")
    _check_plans(plans, n, device, out_rows)
    rec = FlatLaunch()
    rec.comp = None if src_rows is None else comp
    rec.plans, rec.src_rows, rec.n = plans, src_rows, n
    rec.comp_rows, rec.out_rows, rec.device, rec.runs = comp_rows, out_rows, device, 0
    rec._runs_lock = threading.Lock()
    rec._layout = (comp.dtype, device, comp.shape, comp.stride())
    rec._out_shape = (n, out_rows, LANES)
    rec._tall = cluster_ctas(out_rows) > 1
    rec._record = rec._addr = None
    if device.type == "cpu":
        return rec
    dq = plans["dq"]
    if dq.data_ptr() % 8:             # the kernel reads a word's 4 dq entries at once
        rec.plans = plans = {**plans, "dq": dq.clone()}
    lib = load_kernel()
    rec._record = (ctypes.c_int64 * -(-lib.bt_decode_flat_launch_bytes() // 8))()
    rec._addr = ctypes.addressof(rec._record)
    pt, ra = plans, plans["row_a"]
    rc = lib.bt_decode_flat_prepare(
        rec._addr, comp.data_ptr(), comp.stride(0), comp.shape[1], comp_rows,
        pt["p_used"].data_ptr(), pt["p_off"].data_ptr(), pt["p0"].data_ptr(),
        pt["dense"].data_ptr(), pt["dq_idx"].data_ptr(),
        pt["se"].data_ptr(), pt["shift"].data_ptr(), pt["se"].numel() // out_rows,
        pt["dq"].data_ptr(), pt["dq"].shape[0], ra.data_ptr(), ra.shape[1],
        n, out_rows, None if src_rows is None else src_rows.data_ptr(), comp.shape[0],
        device.index)
    check_cuda(rc, "decode_flat launch", lib)
    return rec


def decode_blocks_flat(comp: torch.Tensor, plans: dict, *, comp_rows: int,
                       out_rows: int, src_rows: torch.Tensor | None = None) -> torch.Tensor:
    """Decode a batch of blocks via flat scheduled plans.

    ``comp``: [N, W] uint8 compressed rows (row stride may exceed W).
    ``plans``: the wire tensors of :func:`plan_tensors`, on ``comp``'s
    device.  Returns [N, out_rows, 128] uint8 decoded planes.  With
    ``src_rows`` (contiguous int32 ``[n]`` on ``comp``'s device), block ``b``
    reads comp row ``src_rows[b]``: ``comp`` is then a buffer of resident
    rows (the engine's whole arena), ``plans`` describes the ``n`` blocks
    and the result is ``[n, out_rows, 128]``.  Rows must lie in ``[0, N)``:
    the plain version raises past them, the kernel clips to them.  A CPU
    ``comp`` runs :func:`decode_flat_reference` (on the rows the table
    selects); a CUDA one launches the kernel or raises StatusError.  One
    :func:`prepare_flat_launch` and one run of the record.  Traced, the span
    ``bitar.ops.decode_flat`` (to the launch) and the counter
    ``decode_flat.blocks``."""
    with profiling.annotate("bitar.ops.decode_flat"):
        return prepare_flat_launch(comp, plans, comp_rows=comp_rows, out_rows=out_rows,
                                   src_rows=src_rows)._launch(comp)
