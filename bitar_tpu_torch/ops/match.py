"""Static candidate-offset match scoring (kernel B3), for the ``"tpu"``
compress matcher and for device compression with ``match_offsets``.

Counterpart of ``bitar_tpu/ops/pallas/lz4_match.py``.  For every position
``p`` of a block's raw plane ``x[0, L)`` (the whole padded plane) and each
offset ``d`` of one tuple shared by all blocks, in order:

* ``eq[p] = x[p] == x[p - d] and p >= d``;
* ``run[p]`` is the number of consecutive ``eq`` positions from ``p``,
  capped at ``cap``, the power of two at or above ``max_match``: the
  reference doubles runs up to that cap over a cyclic plane, and its wrap
  lands on a position below ``d``, which never matches, so its run is this
  linear one.  ``d == 0`` matches everywhere, cyclically: every run is
  ``cap``;
* a position keeps the first offset whose run is strictly the longest.

The outputs are the best run capped at ``max_match`` and the offset's index
in the tuple (its value with ``emit_values``); 0 and 0 where nothing
matches.  The wrapper runs the plain version on CPU tensors and launches
``csrc/match.cu`` on CUDA tensors, or raises.

The kernel scores a block tile by tile; :func:`tile_plan` picks the tile and
whether a tile stages its window in shared memory or reads its sources from
device memory, and :func:`tile_windows` gives the bytes of the plane each
tile reads (the positions its comparisons read), so both can be checked
without a card.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check_cuda, load_cuda_kernel, require

LANES = 128

#: Dense short range (RLE, small periods), then power-of-two-ish strides.
DEFAULT_OFFSETS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16, 20, 24, 32, 48, 64,
                   96, 128, 192, 256, 384, 512, 1024, 2048, 4096, 8192)
#: Default run cap; the host emitter extends matches past it.
MAX_MATCH = 64
#: Largest ``max_match`` the kernel takes: its packed runs have 11 bits
#: (``csrc/match.cu``) and hold the doubling cap, at most 1024.
KERNEL_MAX_MATCH = 1024

#: Positions one CTA scores (8 warps, one 1024-position span each); a plane
#: of at most this many bytes is one tile.
TILE = 8192
#: Largest window a CTA stages: the shared memory a block of the card may
#: opt in to (``csrc/cuda_util.cuh`` kSmemMax).  A tile whose window is
#: larger (an offset above ~220 KiB) reads its sources from device memory.
SMEM_MAX = 232448

#: Kernel launches made by ``find_matches`` on CUDA tensors (one per call).
launches = 0


def tile_windows(L: int, tile: int, maxoff: int, cap: int) -> list[tuple[int, int, int, int]]:
    """(t0, t1, lo, hi) of every tile of an L-byte plane: tile [t0, t1) of
    positions reads bytes [lo, hi), the 16-aligned span from ``maxoff``
    before it (no offset of the tuple reaches further back) to ``cap`` past
    it (no run reads further ahead), clipped to the plane.  The kernel
    computes the same bounds."""
    out = []
    for t0 in range(0, L, tile):
        t1 = min(L, t0 + tile)
        out.append((t0, t1, max(0, t0 - maxoff) & ~15, min(L, (t1 + cap + 15) & ~15)))
    return out


def tile_plan(L: int, offsets: tuple[int, ...], max_match: int) -> dict:
    """How the kernel scores an L-byte plane: ``tile`` positions per CTA
    (:data:`TILE`, or the whole plane when it is smaller), ``maxoff`` (the
    largest offset below L; larger ones never match), ``window`` (the most
    bytes a CTA stages in shared memory; 0 when the largest tile window
    passes :data:`SMEM_MAX` and every CTA reads the plane from device memory
    instead) and ``warps`` per CTA."""
    cap = 1 << (max_match - 1).bit_length()   # the reference's doubling cap
    maxoff = max((d for d in offsets if d < L), default=0)
    tile = min(L, TILE)
    window = max(hi - lo for _, _, lo, hi in tile_windows(L, tile, maxoff, cap))
    return {"tile": tile, "maxoff": maxoff, "window": window if window <= SMEM_MAX else 0,
            "cap": cap, "warps": -(-tile // 1024)}


def match_reference(x: torch.Tensor, offsets: tuple[int, ...], *, max_match: int,
                    emit_values: bool = False):
    """Plain version: (mlen, index or value), each [N, L] int32, by the
    reference's cyclic log-doubling."""
    n, L = x.shape
    dev = x.device
    xi = x.int()
    p = torch.arange(L, device=dev)
    best_len = torch.zeros((n, L), dtype=torch.int32, device=dev)
    best_idx = torch.zeros_like(best_len)
    for di, d in enumerate(offsets):
        shifted = xi[:, torch.remainder(p - d, L)]
        run = ((xi == shifted) & (p >= d)).int()
        step = 1
        while step < max_match:
            run = torch.where(run == step, run + torch.roll(run, -step, dims=1), run)
            step *= 2
        better = run > best_len
        best_len = torch.where(better, run, best_len)
        best_idx = torch.where(better, d if emit_values else di, best_idx)
    return best_len.clamp(max=max_match), best_idx


def _bind(lib: ctypes.CDLL) -> None:
    vp, c_int = ctypes.c_void_p, ctypes.c_int
    lib.bt_match_launch.restype = c_int
    lib.bt_match_launch.argtypes = [vp, vp, c_int, vp, vp,   # planes, offs, K, mlen, idx
                                    c_int, c_int, c_int,     # n, L, max_match
                                    c_int, c_int, c_int,     # emit_values, tile, maxoff
                                    c_int, c_int, vp]        # window, warps, stream


def load_kernel() -> ctypes.CDLL:
    """Build (at first use, for sm_90a) and load ``csrc/match.cu``."""
    return load_cuda_kernel("match", _bind, ("match_tile.cuh",))


#: Offset tuples already on a device, so a launch copies nothing from the
#: host (a pageable copy would hold the host until the stream reaches it).
_offset_tensors: dict[tuple[tuple[int, ...], torch.device], torch.Tensor] = {}


def _offsets_on(offsets: tuple[int, ...], device: torch.device) -> torch.Tensor:
    key = (tuple(offsets), device)
    t = _offset_tensors.get(key)
    if t is None:
        t = _offset_tensors.setdefault(key, torch.tensor(key[0], dtype=torch.int32,
                                                         device=device))
    return t


def find_matches(comp: torch.Tensor, *, offsets: tuple[int, ...] = DEFAULT_OFFSETS,
                 nrows: int, max_match: int = MAX_MATCH, emit_values: bool = False):
    """Score candidate-offset matches for a batch of blocks.

    ``comp``: [N, nrows, 128] uint8 raw planes.  Returns (mlen, index or
    value), each [N, nrows, 128] int32 (see the module docstring)."""
    global launches
    n = comp.shape[0]
    L = nrows * LANES
    require(comp.dtype == torch.uint8 and comp.numel() == n * L,
            lambda: f"planes: want [N, {nrows}, 128] uint8, got {list(comp.shape)} {comp.dtype}")
    require(all(d >= 0 for d in offsets), lambda: f"offsets {offsets} must be >= 0")
    x = comp.reshape(n, L)
    if x.device.type == "cpu":
        mlen, idx = match_reference(x, offsets, max_match=max_match, emit_values=emit_values)
        return mlen.reshape(n, nrows, LANES), idx.reshape(n, nrows, LANES)
    require(x.device.type == "cuda", lambda: f"find_matches: no kernel for device {x.device}")
    require(1 <= max_match <= KERNEL_MAX_MATCH,
            lambda: f"max_match {max_match} outside the kernel's [1, {KERNEL_MAX_MATCH}]")
    require(len(offsets) >= 1 and max(offsets) < (1 << 20),
            "the kernel takes 1 or more offsets below 2^20")
    x = x.contiguous()
    if x.data_ptr() % 16:            # the kernel stages planes 16 bytes at a time
        x = x.clone()
    offs = _offsets_on(offsets, x.device)
    mlen = torch.empty((n, L), dtype=torch.int32, device=x.device)
    idx = torch.empty_like(mlen)
    if n:
        lib = load_kernel()
        tp = tile_plan(L, offsets, max_match)
        with torch.cuda.device(x.device):
            rc = lib.bt_match_launch(
                x.data_ptr(), offs.data_ptr(), len(offsets), mlen.data_ptr(),
                idx.data_ptr(), n, L, max_match, int(emit_values), tp["tile"],
                tp["maxoff"], tp["window"], tp["warps"],
                torch.cuda.current_stream(x.device).cuda_stream)
        check_cuda(rc, "match launch", lib)
        launches += 1
    return mlen.reshape(n, nrows, LANES), idx.reshape(n, nrows, LANES)
