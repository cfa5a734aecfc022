"""Device-side LZ4/Snappy block compression: detect -> match + parse -> emit.

Counterpart of ``bitar_tpu/ops/device_compress.py``.  For a batch of raw
planes ``[N, L]`` on one device:

1. ``detect_offsets`` (+ ``detect_offsets_fft`` with ``detect_fft``) picks
   each block's candidate match offsets (torch ops, ``ops/match_dyn.py``);
   with ``offsets`` given, kernel B3 (``ops/match.py``) scores that static
   tuple instead, and :func:`parse_and_size` parses with no sequence cap;
2. kernel B5 (``find_matches_parse_dyn``) scores the offsets and parses
   each ``seg``-byte segment greedily into at most ``wcap`` sequences;
   below ``seg = 1024`` kernel B4 (``find_matches_dyn``) scores and
   :func:`parse_and_size` parses (plain torch ops);
3. :func:`_layout_from_records` turns the sequences into the emission
   layout, whose ``total`` is each block's exact compressed size;
4. the emitter kernel (``ops/emit.py``) writes the wire bytes.

The stream is standard LZ4 (or Snappy): the last 5 bytes of a block are
literals and no match starts in its last 12 bytes.  Rows whose size is
``>= lengths[b]`` or above the emission width are the caller's to store RAW.
"""

from __future__ import annotations

import numpy as np
import torch

from ..status import Status, StatusError
from .emit import emit_blocks
from .emit import ext_bytes as _ext_bytes
from .emit import snappy_len_extra as _snappy_len_extra
from .match import find_matches
from .match_dyn import detect_offsets, detect_offsets_fft, find_matches_dyn, find_matches_parse_dyn


def lz4_bound(length: int) -> int:
    """LZ4 worst-case expansion of an ``length``-byte block (all literals)."""
    return length + length // 255 + 16


def _slot_sizes(taken, lit_len, mv, fmt: str):
    """Per-slot wire size of a (literals, match) sequence in ``fmt``."""
    if fmt == "lz4":
        return torch.where(taken, 1 + _ext_bytes(lit_len) + lit_len + 2 + _ext_bytes(mv), 0)
    lit_hdr = torch.where(lit_len > 0, 1 + _snappy_len_extra(lit_len - 1), 0)
    copies = (mv + 4 + 63) // 64
    return torch.where(taken, lit_hdr + lit_len + 3 * copies, 0)


def _final_size(final_lit, fmt: str):
    """Wire size of the trailing literals-only element."""
    if fmt == "lz4":
        return 1 + _ext_bytes(final_lit) + final_lit
    return torch.where(final_lit > 0, 1 + _snappy_len_extra(final_lit - 1) + final_lit, 0)


def _wire_base(lengths, fmt: str):
    """First slot's output offset: 0 for LZ4, the length varint for Snappy."""
    if fmt == "lz4":
        return torch.zeros_like(lengths)
    return 1 + (lengths >= (1 << 7)).int() + (lengths >= (1 << 14)).int()


def _layout_from_records(P, M, O, overflow, lengths, fmt: str = "lz4") -> dict:
    """Sequence records -> emission layout.

    P/M/O: [N, nslots] match position / truncated length / offset in
    position order (P = -1 empty); overflow [N] bool; lengths [N].  Every
    per-slot entry has the final literals-only sequence appended."""
    n = P.shape[0]
    dev = P.device
    lengths = lengths.int()
    taken = P >= 0
    ends = torch.where(taken, P + M, 0)
    cend = torch.cummax(ends, dim=1).values
    zero = torch.zeros((n, 1), dtype=torch.int32, device=dev)
    prev_end = torch.cat([zero, cend[:, :-1]], dim=1)
    lit_len = torch.where(taken, P - prev_end, 0)
    mv = torch.where(taken, M - 4, -1)
    sizes = _slot_sizes(taken, lit_len, mv, fmt)
    final_start = cend[:, -1]
    final_lit = lengths - final_start
    base = _wire_base(lengths, fmt)[:, None]
    csum = base + torch.cumsum(sizes, dim=1, dtype=torch.int32)
    i32 = torch.int32
    return dict(
        lit_len=torch.cat([lit_len, final_lit[:, None]], dim=1).to(i32),
        lit_start=torch.cat([prev_end, final_start[:, None]], dim=1).to(i32),
        mv=torch.cat([mv, zero - 1], dim=1).to(i32),
        off=torch.cat([O, zero], dim=1).to(i32),
        taken=torch.cat([taken, torch.ones((n, 1), dtype=torch.bool, device=dev)], dim=1),
        starts=torch.cat([base, csum], dim=1).to(i32),
        total=(csum[:, -1] + _final_size(final_lit, fmt)).to(i32),
        nseq=taken.sum(dim=1).to(i32),
        truncated=overflow,
    )


def parse_and_size(mlen, moff, lengths, *, seg: int, min_match: int, length: int,
                   wcap: int | None = 8, fmt: str = "lz4") -> dict:
    """Greedy-parse match hints into sequences and size the output.

    ``mlen``/``moff``: [N, L] int32 match length and offset per position
    (every prefix of a hinted match byte-true); ``lengths`` [N] int32.
    Matches truncate at ``seg`` boundaries, leave 5 trailing literals and
    start before ``lengths - 12``; each segment keeps at most ``wcap``
    sequences (None: the worst case ``seg // min_match + 1``) and emits the
    rest of its bytes as literals.  The walk jumps the cursor from match
    to match at 64-byte chunk granularity and stops once every segment is
    done.  Returns the layout dict of :func:`_layout_from_records`."""
    if min_match < 4:
        raise ValueError("LZ4 min_match must be >= 4")
    if seg % 64 or length % seg:
        raise ValueError("seg must be a multiple of 64 and divide length")
    L = length
    n = mlen.shape[0]
    dev = mlen.device
    nseg = L // seg
    lengths = lengths.int()
    i = torch.arange(L, dtype=torch.int32, device=dev)
    seg_end = (i // seg + 1) * seg
    lim = torch.minimum(seg_end[None, :], lengths[:, None] - 5)
    m = torch.minimum(mlen, lim - i[None, :])
    valid = (m >= min_match) & (i[None, :] < lengths[:, None] - 12) & (moff >= 1)
    mlen_t = torch.where(valid, m, 0)

    chunk = 64
    cpseg = seg // chunk
    cand = torch.where(valid, i[None, :], L)
    cmin = cand.reshape(n, L // chunk, chunk).min(dim=2).values
    cn3 = torch.flip(torch.cummin(torch.flip(cmin.reshape(n, nseg, cpseg), [2]), dim=2).values, [2])
    cn3 = torch.cat([cn3, torch.full((n, nseg, 1), L, dtype=cn3.dtype, device=dev)], dim=2)
    pk3 = (mlen_t | (moff.int() << 11)).reshape(n, nseg, seg)

    seg_base = (torch.arange(nseg, dtype=torch.int32, device=dev) * seg)[None, :]
    seg_ends = seg_base + seg
    worst = seg // min_match + 1
    nstep = worst if wcap is None else min(wcap, worst)
    P = torch.full((nstep, n, nseg), -1, dtype=torch.int32, device=dev)
    M = torch.zeros((nstep, n, nseg), dtype=torch.int32, device=dev)
    O = torch.zeros_like(M)
    pos = seg_base.expand(n, nseg).clone()
    for t in range(nstep):
        if not bool((pos < seg_ends).any()):
            break
        loc = pos - seg_base
        inseg = loc < seg
        pkj = pk3.gather(2, loc.clamp(0, seg - 1)[:, :, None].long())[..., 0]
        mm = torch.where(inseg, pkj & 0x7FF, 0)
        here = inseg & (mm > 0)
        nxt_c = cn3.gather(2, ((loc >> 6) + 1).clamp(0, cpseg)[:, :, None].long())[..., 0]
        jump = torch.where(inseg & (nxt_c < seg_ends), nxt_c, L)
        P[t] = torch.where(here, pos, -1)
        M[t] = torch.where(here, mm, 0)
        O[t] = torch.where(here, pkj >> 11, 0)
        pos = torch.where(here, pos + mm, jump).int()
    overflow = (pos < seg_ends).any(dim=1)
    P, M, O = (x.permute(1, 2, 0).reshape(n, nseg * nstep) for x in (P, M, O))
    return _layout_from_records(P, M, O, overflow, lengths, fmt=fmt)


def candidate_offsets(planes, *, detect_k: int = 4, detect_fft: bool | str = False,
                      fft_k: int = 2):
    """Each block's match offsets as the matcher kernels take them: (noff
    [N], offs [N, K]) int32, the nonzero offsets first."""
    n, L = planes.shape
    max_off = min(0xFFFF, L - 128)
    offs, _ = detect_offsets(planes, k=detect_k, max_off=max_off)
    if detect_fft:
        if detect_fft == "sample":
            # The FFT of 8 evenly spaced blocks; the union of their lags
            # (first occurrence of each) is every block's candidate set.
            step = max(1, n // 8)
            foffs_s, _ = detect_offsets_fft(planes[::step][:8], k=fft_k, max_off=max_off)
            cand = foffs_s.reshape(-1)
            eq = cand[None, :] == cand[:, None]
            first = eq.int().argmax(dim=0) == torch.arange(cand.shape[0], device=cand.device)
            cand = torch.where(first, cand, 0)
            foffs = cand[None, :].expand(n, cand.shape[0])
        else:
            foffs, _ = detect_offsets_fft(planes, k=fft_k, max_off=max_off)
        dup = (foffs[:, :, None] == offs[:, None, :]).any(dim=2)
        foffs = torch.where(dup, 0, foffs)
        offs = torch.cat([offs, foffs], dim=1)
        # Nonzero offsets to the front: the matcher scores the first noff.
        order = torch.sort((offs == 0).int(), dim=1, stable=True).indices
        offs = offs.gather(1, order)
    offs = offs.int().contiguous()
    return (offs > 0).sum(dim=1).int(), offs


def _match_parse(planes, lengths, *, seg, min_match, mm, detect_k, offsets, wcap=8,
                 detect_fft=False, fmt="lz4", fft_k=2) -> dict:
    """Detect, match and parse: the layout of every block."""
    n, L = planes.shape
    nrows = L // 128
    lengths = lengths.int().contiguous()
    if offsets is not None:
        # The static tuple keeps the worst-case sequence budget, as in the
        # reference.
        mlen, moff = find_matches(planes.reshape(n, nrows, 128), offsets=offsets, nrows=nrows,
                                  max_match=mm, emit_values=True)
        return parse_and_size(mlen.reshape(n, L), moff.reshape(n, L), lengths, seg=seg,
                              min_match=min_match, length=L, wcap=None, fmt=fmt)
    noff, offs = candidate_offsets(planes, detect_k=detect_k, detect_fft=detect_fft,
                                   fft_k=fft_k)
    if seg % 128 == 0 and L % seg == 0 and L // seg <= 128 and mm <= seg and seg >= 1024:
        P, M, O, overflow = find_matches_parse_dyn(
            planes.reshape(n, nrows, 128), noff, offs, lengths, nrows=nrows, seg=seg,
            min_match=min_match, wcap=wcap, max_match=mm)
        return _layout_from_records(P, M, O, overflow, lengths, fmt=fmt)
    mlen, moff = find_matches_dyn(planes.reshape(n, nrows, 128), noff, offs, nrows=nrows,
                                  max_match=mm)
    return parse_and_size(mlen.reshape(n, L), moff.reshape(n, L), lengths, seg=seg,
                          min_match=min_match, length=L, wcap=wcap, fmt=fmt)


def _emit(planes, layout, *, out_width: int, fmt: str = "lz4", lengths=None):
    """Emission through the one emitter kernel, with the reference's rules:
    Snappy only at lane-tiled widths in [256, 65536), and the wide-width
    slot-count limit of its XLA emitter."""
    L = planes.shape[1]
    lane_tiled = (out_width < (1 << 16) and L <= (1 << 17) and L % 128 == 0
                  and out_width % 128 == 0 and out_width >= 256)
    if fmt != "lz4" and not lane_tiled:
        raise StatusError(Status.Invalid(
            f"snappy device emission needs a lane-tiled out_width in "
            f"[256, 65536) (got {out_width})"))
    narrow = out_width < (1 << 16) and L <= (1 << 17) and L % 128 == 0 and out_width % 8 == 0
    nslots = layout["starts"].shape[1]
    if not (lane_tiled or narrow) and nslots >= (1 << 15):
        raise StatusError(Status.Invalid(
            f"too many sequence slots ({nslots}) to pack (>= 2^15); "
            f"raise min_match or shrink seg/block"))
    return emit_blocks(planes, layout, out_width=out_width, fmt=fmt, lengths=lengths)


def _validate_args(L, seg, mm, offsets):
    if L % 128:
        raise StatusError(Status.Invalid("plane width must be lane-aligned"))
    if mm > 2047:
        raise StatusError(Status.Invalid(
            f"max_match {mm} overflows the 11-bit emission field (> 2047)"))
    if offsets is not None:
        bad_off = [d for d in offsets if not (1 <= d <= 0xFFFF)]
        if bad_off:
            raise StatusError(Status.Invalid(
                f"match offsets {bad_off[:4]} outside [1, 65535] (16-bit "
                f"emission field / LZ4 distance)"))


def _tensors(planes, lengths):
    """A tensor stays on its device; a numpy array goes to the CUDA device,
    the package's default, and raises without one."""
    if not isinstance(planes, torch.Tensor):
        if not torch.cuda.is_available():
            raise StatusError(Status.Invalid(
                "numpy planes go to the CUDA device, and torch.cuda.is_available() "
                "is false; pass CPU tensors for the plain PyTorch path"))
        planes = torch.from_numpy(np.ascontiguousarray(planes, np.uint8)).to("cuda")
    if not isinstance(lengths, torch.Tensor):
        lengths = torch.from_numpy(np.asarray(lengths, np.int32))
    return planes, lengths.to(planes.device, torch.int32)


def match_parse_device(planes, lengths, *, seg: int = 1024, min_match: int = 6,
                       offsets: tuple[int, ...] | None = None,
                       max_match: int | None = None, detect_k: int = 4,
                       detect_fft: bool | str = False, fmt: str = "lz4",
                       fft_k: int = 2) -> dict:
    """Match + parse of full-offload compression (no emission): the layout
    dict, whose ``total`` is each block's exact compressed size."""
    planes, lengths = _tensors(planes, lengths)
    L = planes.shape[1]
    mm = max_match if max_match is not None else min(seg, 1024)
    _validate_args(L, seg, mm, offsets)
    return _match_parse(planes, lengths, seg=seg, min_match=min_match, mm=mm,
                        detect_k=detect_k, offsets=offsets, detect_fft=detect_fft,
                        fmt=fmt, fft_k=fft_k)


def adaptive_width(sizes: np.ndarray, lens: np.ndarray, L: int, mm: int) -> int:
    """The smallest lane-tiled power-of-two width covering every block that
    compresses (``sizes < lens``), at most the LZ4 bound of ``L``."""
    wmax = int(sizes[sizes < lens].max(initial=128))
    if mm > 1026:
        wmax = max(wmax, 8193)
    width = 128 << max(0, (-(-wmax // 128) - 1).bit_length())
    return min(width, -(-lz4_bound(L) // 128) * 128)


def engine_width(sizes: np.ndarray, lens: np.ndarray, L: int) -> int:
    """The engine's emission width: the largest compressible block's size
    (``sizes < lens``) to a power of two (3/4 steps above 16 KiB), at most
    the LZ4 bound of ``L``."""
    wmax = int(sizes[sizes < lens].max(initial=128))
    width = 128 << max(0, (-(-wmax // 128) - 1).bit_length())
    if width > 16384 and wmax <= (width // 4) * 3:
        width = (width // 4) * 3
    return min(width, -(-lz4_bound(L) // 128) * 128)


def compress_blocks_device(planes, lengths, *, seg: int = 1024, min_match: int = 6,
                           offsets: tuple[int, ...] | None = None,
                           max_match: int | None = None, out_width: int | None = None,
                           detect_k: int = 4, wcap: int = 8,
                           detect_fft: bool | str = False, fmt: str = "lz4",
                           fft_k: int = 2):
    """Full on-device compression of a batch of blocks.

    ``planes``: [N, L] uint8 raw planes, zero past each ``lengths[b]``: a
    tensor runs on its device (a CPU tensor takes the plain versions), a
    numpy array runs on the CUDA device.
    ``out_width``: the emission width; None reads back the sizes and emits
    at :func:`adaptive_width`.  Returns ``(out [N, W] uint8, sizes [N]
    int32)``; rows with ``sizes[b] >= lengths[b]`` or ``> W`` are the
    caller's to store RAW (their bytes are garbage)."""
    planes, lengths = _tensors(planes, lengths)
    L = planes.shape[1]
    mm = max_match if max_match is not None else min(seg, 1024)
    _validate_args(L, seg, mm, offsets)
    if out_width is not None and out_width <= 8192 and mm > 1026:
        raise StatusError(Status.Invalid(
            f"max_match {mm} overflows the compact emission wire "
            f"(requires out_width > 8192 or max_match <= 1026)"))
    layout = _match_parse(planes, lengths, seg=seg, min_match=min_match, mm=mm,
                          detect_k=detect_k, offsets=offsets, wcap=wcap,
                          detect_fft=detect_fft, fmt=fmt, fft_k=fft_k)
    if out_width is None:
        out_width = adaptive_width(layout["total"].cpu().numpy(), lengths.cpu().numpy(), L, mm)
    out = _emit(planes, layout, out_width=out_width, fmt=fmt, lengths=lengths)
    return out, layout["total"]
