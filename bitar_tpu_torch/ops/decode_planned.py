"""Dense-plan block decode (kernel B7): scheduled fragment passes over the
stacked plane S = [comp | out].

Counterpart of ``bitar_tpu/ops/pallas/lz4_decode_planned.py``, the older
mesh decoder that ``decode_blocks_flat`` (B1) replaced on every decode path;
the reference has no caller of it, so ``decode_blocks_planned`` is its own
entry point.  The host planner (``native.plan_block``) turns a block into P
passes; :func:`pack_plan` packs them into the wire, and :func:`plan_blocks`
does both for a batch.  This module holds ``pack_plan`` (a copy of the
reference's), ``plan_blocks``, ``random_plans`` (malformed plans for the
kernel-vs-plain checks), ``class_plans`` and ``pass_reads_plane`` (the
kernel's two pass classes), ``decode_planned_reference``,
the plain PyTorch decode, and ``decode_blocks_planned``, the wrapper: on CPU
tensors it runs the plain version, on CUDA tensors it launches
``csrc/decode_planned.cu`` or raises.  Planes of up to ``SHARED_OUT_ROWS``
rows take the kernel's shared-memory route, taller ones (up to
``MAX_OUT_ROWS``, a 1 MiB block) its device-memory route, with a scratch
plane per CTA that the wrapper allocates.

The function, per block ``i``.  S has ``w_rows = ceil((comp_rows +
out_rows) / 1024) * 1024`` rows of 128 bytes: comp in rows
``[0, comp_rows)``, zeros above, the output region from row ``comp_rows``.
Each pass ``k < min(p_used[i], passes)``, in order, reads S as it stood
before the pass.  In output row ``r``, with ``start = se >>> 8``, ``end = se
& 0xFF`` (``se`` and ``shift`` the cell of pass k, row r), lane ``l`` is
active when ``start <= l < end``; it takes ``q = r*128 + l + shift`` (int32,
wrapping), ``qrow = q >>> 7`` (logical).  The row's anchor is ``row_a =
min(min over active lanes of qrow, w_rows - 2)``, and the lane's value is
``S[row_a][q & 127]`` if ``qrow == row_a``, else ``S[row_a + 1][q & 127]``.
So a malformed plan reads one of two rows, never ``S[q]`` itself.  Only
active lanes are written.  The output is the out region after the last pass.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import block_queue, check_cuda, load_cuda_kernel, require, sm_count
from .cpu import native

LANES = 128
KCHUNK = 1024          # S rows round up to this (the reference's MXU K chunk)
#: Output rows of the largest plane the kernel keeps in shared memory
#: (128 KiB), as B1 does; taller planes take its device-memory route.
SHARED_OUT_ROWS = 1024
#: Output rows a block may have on the card: 1 MiB, the largest block of
#: either package.
MAX_OUT_ROWS = 8192

#: Kernel launches made by ``decode_blocks_planned`` on CUDA tensors (one
#: per call).  Reset it to 0 before a run whose kernel use is to be shown.
launches = 0
#: Of those, launches on the device-memory route (planes above
#: ``SHARED_OUT_ROWS`` rows).
gmem_launches = 0


def pack_plan(r_dstart, r_dend, r_shift, p0, total_passes, comp_rows):
    """Host-side plan packing for one block.

    Takes the planner's [P, nrows] int32 tables (block-absolute dstart/dend,
    raw shifts, comp-pass count p0) and produces the kernel wire format:
    (se [total_passes, nrows], shift [total_passes, nrows]) with
    row-relative ranges and out-space shifts rebased into the stacked plane.
    """
    P = r_dstart.shape[0]
    nrows = r_dstart.shape[1]
    row_lo = np.arange(nrows, dtype=np.int32)[None, :] * LANES
    start = np.clip(r_dstart - row_lo, 0, LANES).astype(np.int32)
    end = np.clip(r_dend - row_lo, 0, LANES).astype(np.int32)
    # empty cells: dstart == dend == 0 -> start=end=0 -> inactive
    se = (start << 8) | end
    shift = r_shift.copy()
    shift[p0:P] += comp_rows * LANES
    out_se = np.zeros((total_passes, nrows), np.int32)
    out_shift = np.zeros((total_passes, nrows), np.int32)
    out_se[:P] = se
    out_shift[:P] = shift
    return out_se, out_shift


def plan_blocks(datas: list[bytes], block: int, max_passes: int) -> dict:
    """The B7 wire of a batch: each block of ``datas`` LZ4-compressed,
    planned by ``native.plan_block`` within ``max_passes`` passes and packed
    by :func:`pack_plan`.  Blocks whose plan does not fit are left out.

    Returns {"fit": indices of the planned blocks, "comp" [F, comp_rows,
    128] uint8, "p_used" and "p0" (the planner's comp-pass count) [F]
    int32, "se" and "shift" [F, passes, block / 16384, 128] int32,
    "passes" (the largest plan's), "comp_rows" (the largest comp in rows,
    rounded up to 32), "stored" (compressed bytes of the planned
    blocks)}."""
    nrows = block // LANES
    comps = [native.lz4_compress(d) for d in datas]
    plans = [native.plan_block(c, block, nrows, max_passes=max_passes) for c in comps]
    fit = [i for i, p in enumerate(plans) if p[0] is not None]
    passes = max((plans[i][0] for i in fit), default=1)
    comp_rows = -(-max((len(comps[i]) for i in fit), default=1) // LANES)
    comp_rows = -(-comp_rows // 32) * 32
    comp = np.zeros((len(fit), comp_rows, LANES), np.uint8)
    se = np.zeros((len(fit), passes, nrows // LANES, LANES), np.int32)
    shift = np.zeros_like(se)
    for j, i in enumerate(fit):
        P, p0, cols = plans[i]
        comp[j].reshape(-1)[:len(comps[i])] = comps[i]
        s, h = pack_plan(cols["r_dstart"][:P], cols["r_dend"][:P], cols["r_shift"][:P], p0,
                         passes, comp_rows)
        se[j], shift[j] = s.reshape(se.shape[1:]), h.reshape(se.shape[1:])
    return {"fit": fit, "comp": comp, "p_used": np.array([plans[i][0] for i in fit], np.int32),
            "p0": np.array([plans[i][1] for i in fit], np.int32),
            "se": se, "shift": shift, "passes": passes, "comp_rows": comp_rows,
            "stored": sum(len(comps[i]) for i in fit)}


def random_plans(seed: int, n: int, passes: int, comp_rows: int, out_rows: int) -> tuple:
    """A batch of malformed B7 plans, to hold the kernel to its plain
    version where a plan is not a decode: ranges past the row, start > end
    and whole int32 ``se`` words; shifts into the comp region, the out
    region, the zeros above, negative (a huge logical row) and near the
    int32 limits (``q`` wraps); ``p_used`` past ``passes``, 0 and negative.
    Returns numpy (comp, p_used, se, shift)."""
    rng = np.random.default_rng(seed)
    shape = (n, passes, out_rows // LANES, LANES)
    comp = rng.integers(0, 256, (n, comp_rows, LANES), dtype=np.uint8)
    se = ((rng.integers(0, 140, shape) << 8) | rng.integers(0, 256, shape)).astype(np.int32)
    se[..., ::17] = rng.integers(-2**31, 2**31 - 1, se[..., ::17].shape)
    kind = rng.integers(0, 5, shape)
    wide = rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int64)
    near = rng.integers(0, (comp_rows + out_rows + 300) * LANES, shape)
    shift = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                      [near - 300, near, -near, 2**31 - 1 - near % 4096], wide).astype(np.int32)
    p_used = np.resize(np.array([passes, passes + 4, 0, -1, 2, 1], np.int32), n)
    return comp, p_used, se, shift


def class_plans(seed: int, n: int, reads: list[bool], comp_rows: int, out_rows: int) -> tuple:
    """Random well-aimed plans whose pass ``k`` reads out rows when
    ``reads[k]`` (every active lane's source in the out region) and only
    comp rows or the zeros above otherwise, to hold the kernel's two pass
    classes and the seams between them to the plain version.  ``p_used``
    spreads over 0..passes, with values past ``passes`` and negative ones.
    Returns numpy (comp, p_used, se, shift)."""
    rng = np.random.default_rng(seed)
    passes, rows = len(reads), out_rows
    comp = rng.integers(0, 256, (n, comp_rows, LANES), dtype=np.uint8)
    start = rng.integers(0, 128, (n, passes, rows))
    end = np.minimum(start + rng.integers(0, 40, (n, passes, rows)), 128)
    end[rng.random((n, passes, rows)) < 0.3] = 0                   # idle rows
    r = np.arange(rows)[None, None, :]
    in_comp = rng.integers(0, max(1, (comp_rows - 2) * LANES), (n, passes, rows))
    in_zeros = ((comp_rows + out_rows) * LANES + rng.integers(0, 100 * LANES, (n, passes, rows)))
    target = np.where(rng.random((n, passes, rows)) < 0.9, in_comp, in_zeros)
    plane = comp_rows * LANES + rng.integers(0, (out_rows - 2) * LANES, (n, passes, rows))
    target = np.where(np.asarray(reads, bool)[None, :, None], plane, target)
    shift = (target - r * LANES).astype(np.int32)
    se = ((start << 8) | end).astype(np.int32)
    shape = (n, passes, rows // LANES, LANES)
    p_used = np.resize(np.array([passes, passes + 3, 0, -2, 1, max(1, passes // 2), passes - 1],
                                np.int32), n)
    return comp, p_used, se.reshape(shape), shift.reshape(shape)


def pass_reads_plane(se: torch.Tensor, shift: torch.Tensor, *, comp_rows: int,
                     out_rows: int) -> torch.Tensor:
    """[N, passes] bool: whether pass k of block i reads an out row under
    the anchor rule (some active lane's source row lies in ``[comp_rows,
    comp_rows + out_rows)``); the pass classes the kernel finds."""
    n, passes = se.shape[:2]
    w_rows = -(-(comp_rows + out_rows) // KCHUNK) * KCHUNK
    lane = torch.arange(LANES, device=se.device)
    r = torch.arange(out_rows, device=se.device)[:, None]
    res = torch.zeros((n, passes), dtype=torch.bool, device=se.device)
    for i in range(n):
        sek = se[i].reshape(passes, out_rows, 1).long() & 0xFFFFFFFF
        active = (lane >= (sek >> 8)) & (lane < (sek & 0xFF))
        q = _wrap32(r * LANES + lane + shift[i].reshape(passes, out_rows, 1).long())
        qrow = (q & 0xFFFFFFFF) >> 7
        row_a = torch.where(active, qrow, 1 << 29).min(dim=2, keepdim=True).values
        row_a = row_a.clamp(max=w_rows - 2)
        src = torch.where(qrow == row_a, row_a, row_a + 1)
        res[i] = (active & (src >= comp_rows) & (src < comp_rows + out_rows)).flatten(1).any(1)
    return res


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value it wraps to, kept in int64."""
    return torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)


def decode_planned_reference(comp: torch.Tensor, p_used: torch.Tensor, se: torch.Tensor,
                             shift: torch.Tensor, *, passes: int, comp_rows: int,
                             out_rows: int) -> torch.Tensor:
    """Decode N blocks with plain tensor ops; returns [N, out_rows, 128]
    uint8 (see the module docstring)."""
    dev = comp.device
    n = comp.shape[0]
    w_rows = -(-(comp_rows + out_rows) // KCHUNK) * KCHUNK
    olo, olen = comp_rows * LANES, out_rows * LANES
    S = torch.zeros((n, w_rows * LANES), dtype=torch.int64, device=dev)
    S[:, :olo] = comp.reshape(n, olo).long()
    p = torch.arange(olen, device=dev)
    lane = p & (LANES - 1)
    npass = p_used.long().clamp(min=0, max=passes)
    for k in range(int(npass.max()) if n else 0):
        live = (k < npass)[:, None]
        sek = se[:, k].reshape(n, out_rows).long() & 0xFFFFFFFF
        shk = shift[:, k].reshape(n, out_rows).long()
        start = (sek >> 8).repeat_interleave(LANES, dim=1)
        end = (sek & 0xFF).repeat_interleave(LANES, dim=1)
        active = live & (lane >= start) & (lane < end)
        q = _wrap32(p + shk.repeat_interleave(LANES, dim=1))
        qrow = (torch.where(active, q, 0) & 0xFFFFFFFF) >> 7
        masked = torch.where(active, qrow, 1 << 29).reshape(n, out_rows, LANES)
        row_a = masked.min(dim=2).values.clamp(max=w_rows - 2)
        row_a = row_a.repeat_interleave(LANES, dim=1)
        qlane = q & (LANES - 1)
        src_row = torch.where(qrow == row_a, row_a, row_a + 1)
        val = S.gather(1, src_row * LANES + qlane)
        cur = S[:, olo:olo + olen]
        S[:, olo:olo + olen] = torch.where(active, val, cur)
    return S[:, olo:olo + olen].to(torch.uint8).reshape(n, out_rows, LANES)


def _bind(lib: ctypes.CDLL) -> None:
    vp, c_int = ctypes.c_void_p, ctypes.c_int
    lib.bt_decode_planned_launch.restype = c_int
    lib.bt_decode_planned_launch.argtypes = [
        vp, c_int,                        # comp, comp_rows
        vp, vp, vp, c_int,                # p_used, se, shift, passes
        vp, vp, c_int, c_int,             # order, out, n, out_rows
        vp, vp, c_int,                    # queue, scratch, its CTA rows
        c_int, vp]                        # device, stream
    for fn in ("bt_decode_planned_shared_rows", "bt_decode_planned_max_rows"):
        getattr(lib, fn).restype = c_int
        getattr(lib, fn).argtypes = []
    got = (lib.bt_decode_planned_shared_rows(), lib.bt_decode_planned_max_rows())
    require(got == (SHARED_OUT_ROWS, MAX_OUT_ROWS),
            lambda: f"decode_planned.cu holds {got} rows (shared route, all), "
                    f"the wrapper says {(SHARED_OUT_ROWS, MAX_OUT_ROWS)}")


def load_kernel() -> ctypes.CDLL:
    """Build (at first use, for sm_90a) and load ``csrc/decode_planned.cu``."""
    return load_cuda_kernel("decode_planned", _bind)


def _launch_kernel(comp, p_used, se, shift, passes, comp_rows, out_rows) -> torch.Tensor:
    global launches, gmem_launches
    require(out_rows <= MAX_OUT_ROWS,
            lambda: f"decode_planned kernel takes at most {MAX_OUT_ROWS} rows per block "
                    f"(a 1 MiB block), got {out_rows}")
    n = comp.shape[0]
    tiles = out_rows // LANES
    require(comp.is_contiguous(), "comp: want a contiguous [N, comp_rows, 128] tensor")
    for name, t, shape in (("p_used", p_used, (n,)),
                           ("se", se, (n, passes, tiles, LANES)),
                           ("shift", shift, (n, passes, tiles, LANES))):
        require(t.device == comp.device and t.dtype == torch.int32 and t.is_contiguous()
                and tuple(t.shape) == shape,
                lambda: f"{name}: want contiguous int32 {list(shape)} on {comp.device}, "
                        f"got {t.dtype} {list(t.shape)} on {t.device}")
    out = torch.empty((n, out_rows, LANES), dtype=torch.uint8, device=comp.device)
    if n == 0:
        return out
    order = torch.empty(n, dtype=torch.int32, device=comp.device)
    lib = load_kernel()
    stream = torch.cuda.current_stream(comp.device).cuda_stream
    gmem = out_rows > SHARED_OUT_ROWS
    scratch, ctas = None, 0
    if gmem:                              # a scratch plane per CTA (one CTA an SM)
        ctas = min(n, sm_count(comp.device))
        scratch = torch.empty((ctas, out_rows * LANES), dtype=torch.uint8, device=comp.device)
    rc = lib.bt_decode_planned_launch(
        comp.data_ptr(), comp_rows, p_used.data_ptr(), se.data_ptr(), shift.data_ptr(),
        passes, order.data_ptr(), out.data_ptr(), n, out_rows,
        block_queue(comp.device, stream).data_ptr(),
        None if scratch is None else scratch.data_ptr(), ctas, comp.device.index, stream)
    check_cuda(rc, "decode_planned launch", lib)
    launches += 1
    gmem_launches += gmem
    return out


def decode_blocks_planned(comp: torch.Tensor, p_used: torch.Tensor, se: torch.Tensor,
                          shift: torch.Tensor, *, passes: int, comp_rows: int,
                          out_rows: int) -> torch.Tensor:
    """Decode a batch of blocks via their scheduled fragment plans.

    ``comp``: [N, comp_rows, 128] uint8 compressed planes; ``p_used`` [N]
    int32 pass counts; ``se``, ``shift``: [N, passes, out_rows / 128, 128]
    int32 (:func:`pack_plan`'s rows; row r at ``[.., r >> 7, r & 127]``).
    Returns [N, out_rows, 128] uint8.  Raises StatusError unless ``out_rows
    % 128 == 0`` and ``comp_rows % 32 == 0``, the reference's asserts.  A
    CPU ``comp`` runs :func:`decode_planned_reference`; a CUDA one launches
    the kernel or raises."""
    require(out_rows % LANES == 0, "planned kernel requires out_rows % 128 == 0")
    require(comp_rows % 32 == 0, "uint8 comp planes need 32-row tiling")
    require(comp.dtype == torch.uint8 and tuple(comp.shape[1:]) == (comp_rows, LANES),
            lambda: f"comp: want [N, {comp_rows}, 128] uint8, got {list(comp.shape)} {comp.dtype}")
    if comp.device.type == "cpu":
        return decode_planned_reference(comp, p_used, se, shift, passes=passes,
                                        comp_rows=comp_rows, out_rows=out_rows)
    require(comp.device.type == "cuda",
            lambda: f"decode_blocks_planned: no kernel for device {comp.device}")
    return _launch_kernel(comp, p_used, se, shift, passes, comp_rows, out_rows)
