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
  ``DECODE_FLAT_MAX_ROWS`` rows take the kernel's shared-memory route,
  taller ones (blocks of 256 KiB to 1 MiB) its device-memory route, with a
  scratch row per CTA that the wrapper allocates.

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

import ctypes

import numpy as np
import torch

from ..config import DECODE_FLAT_MAX_ROWS
from ._build import block_queue, check_cuda, load_cuda_kernel, require, sm_count

LANES = 128
CB = 4                # passes per planner batch (plans pad to CB multiples)
DCHUNK = CB           # slack plan rows past the last pass
_S_QUANTUM = 512      # plan-array length rounds up to this
KBAND = 256           # row quantum of comp planes taller than 128 rows

#: Kernel launches made by ``decode_blocks_flat`` on CUDA tensors (one per
#: call).  Read it to show that a run went through the kernel; reset it to
#: 0 before such a run.
launches = 0
#: Those of them that took the device-memory route (planes taller than
#: ``DECODE_FLAT_MAX_ROWS`` rows).
gmem_launches = 0


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
        vp, c_int, vp]                    # scratch, its CTA rows, stream
    lib.bt_decode_flat_shared_rows.restype = c_int
    lib.bt_decode_flat_shared_rows.argtypes = []
    require(lib.bt_decode_flat_shared_rows() == DECODE_FLAT_MAX_ROWS,
            lambda: f"decode_flat.cu's shared route holds {lib.bt_decode_flat_shared_rows()} "
                    f"rows, config.DECODE_FLAT_MAX_ROWS says {DECODE_FLAT_MAX_ROWS}")


def load_kernel() -> ctypes.CDLL:
    """Build (at first use, for sm_90a) and load ``csrc/decode_flat.cu``."""
    return load_cuda_kernel("decode_flat", _bind)


def _launch_kernel(comp: torch.Tensor, pt: dict, comp_rows: int,
                   out_rows: int) -> torch.Tensor:
    global launches, gmem_launches
    n = comp.shape[0]
    for k in ("p_used", "p_off", "p0", "dense", "dq_idx"):
        t = pt[k]
        require(t.device == comp.device and t.dtype == torch.int32
                and t.is_contiguous() and t.shape == (n,),
                lambda: f"plan {k}: want contiguous int32 [{n}] on {comp.device}")
    for k, dt in (("se", torch.int16), ("shift", torch.int32),
                  ("dq", torch.int16), ("row_a", torch.int32)):
        t = pt[k]
        require(t.device == comp.device and t.dtype == dt and t.is_contiguous(),
                lambda: f"plan {k}: want contiguous {dt} on {comp.device}")
    tiles = out_rows // LANES
    s_rows = pt["se"].numel() // out_rows
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
    out = torch.empty((n, out_rows, LANES), dtype=torch.uint8, device=comp.device)
    if n == 0:
        return out
    dq = pt["dq"]
    if dq.data_ptr() % 8:             # the kernel reads a word's 4 dq entries at once
        dq = dq.clone()
    lib = load_kernel()
    gmem = out_rows > DECODE_FLAT_MAX_ROWS
    with torch.cuda.device(comp.device):      # launch on the tensors' device
        stream = torch.cuda.current_stream(comp.device).cuda_stream
        queue = block_queue(comp.device, stream)
        scratch, ctas = None, 0
        if gmem:                              # a scratch plane per CTA
            ctas = min(n, sm_count(comp.device))
            scratch = torch.empty((ctas, out_rows * LANES), dtype=torch.uint8,
                                  device=comp.device)
        rc = lib.bt_decode_flat_launch(
            comp.data_ptr(), comp.stride(0), comp.shape[1], comp_rows,
            pt["p_used"].data_ptr(), pt["p_off"].data_ptr(), pt["p0"].data_ptr(),
            pt["dense"].data_ptr(), pt["dq_idx"].data_ptr(),
            pt["se"].data_ptr(), pt["shift"].data_ptr(), s_rows,
            dq.data_ptr(), dq_rows, ra.data_ptr(), ra.shape[1],
            out.data_ptr(), n, out_rows, queue.data_ptr(),
            None if scratch is None else scratch.data_ptr(), ctas, stream)
    check_cuda(rc, "decode_flat launch", lib)
    launches += 1
    gmem_launches += gmem
    return out


def decode_blocks_flat(comp: torch.Tensor, plans: dict, *, comp_rows: int,
                       out_rows: int) -> torch.Tensor:
    """Decode a batch of blocks via flat scheduled plans.

    ``comp``: [N, W] uint8 compressed rows (row stride may exceed W).
    ``plans``: the wire tensors of :func:`plan_tensors`, on ``comp``'s
    device.  Returns [N, out_rows, 128] uint8 decoded planes.  A CPU
    ``comp`` runs :func:`decode_flat_reference`; a CUDA one launches the
    kernel or raises StatusError."""
    require(comp.dtype == torch.uint8 and comp.ndim == 2 and comp.stride(1) == 1,
            lambda: f"comp: want [N, W] uint8 rows, got {tuple(comp.shape)} {comp.dtype}")
    require(out_rows % LANES == 0 and comp_rows % LANES == 0,
            "comp_rows and out_rows must be multiples of 128")
    if comp.device.type == "cpu":
        return decode_flat_reference(comp, plans, comp_rows, out_rows)
    require(comp.device.type == "cuda",
            lambda: f"decode_blocks_flat: no kernel for device {comp.device}")
    return _launch_kernel(comp, plans, comp_rows, out_rows)
