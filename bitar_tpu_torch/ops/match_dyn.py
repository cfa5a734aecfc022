"""Per-block dynamic-offset matching: offset detectors, B5 and B4.

Counterpart of ``bitar_tpu/ops/pallas/lz4_match_dyn.py``.

* ``detect_offsets`` / ``detect_offsets_fft``: each block's candidate match
  offsets, from a sampled 4-byte sort (delta histogram, halving-refined) or
  from the FFT autocorrelation.  XLA in the reference, plain torch ops here.
* ``find_matches_parse_dyn``: scores every offset at every position and
  runs the greedy per-segment parse (kernel B5, ``csrc/match_walk.cu``).
* ``find_matches_dyn``: the same scoring, returning the per-position best
  run and offset planes (kernel B4, ``csrc/match_dyn.cu``).
* ``parse_walk_dyn``: B5's greedy walk alone, over precomputed match planes
  such as B4's (kernel B6, ``csrc/parse_walk.cu``).  B4 then B6 gives B5's
  records.  The reference has no caller of it; it is its own entry point.
* ``edge_batch``: blocks where B5's and B4's edges matter, and
  ``walk_edge_batch``: match planes where B6's do, for the smoke run and
  the tests.

Scoring, per block and per offset ``d`` in ``offs[b, :noff[b]]`` in order:
``run[p]`` is the number of consecutive positions ``p' >= p`` with
``x[p'] == x[p' - d]`` and ``p' >= d``, capped at ``max_match``; a position
keeps the first offset whose run is strictly the longest.  The reference
computes runs by log-doubling over a cyclic plane (``run[(p + s) mod L]``);
the plain versions here repeat that.  For ``d >= 1`` position 0 never
matches, so a run that reaches the plane end stops there and the cyclic
and the linear run agree: the kernels count linear runs.

The reference derives B5's source segment as ``(g - q) & (G - 1)``, which is
``mod G`` only for a power-of-two segment count ``G``; at other counts it
compares against the wrong segment (ROADMAP Queue C).  The port uses the
true source position ``p - d`` everywhere, which equals the reference
whenever ``G`` is a power of two.

Each wrapper runs its plain version for CPU tensors and launches its kernel
for CUDA tensors, or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import check_cuda, load_cuda_kernel, require

LANES = 128
#: offset slots per block of the sampled detector; unused slots carry 0
DEFAULT_K = 4
#: sampling stride of the detector (a multiple of 64 dividing the plane)
DEFAULT_STRIDE = 64

#: Kernel launches made by ``find_matches_parse_dyn`` (B5),
#: ``find_matches_dyn`` (B4) and ``parse_walk_dyn`` (B6) on CUDA tensors,
#: one per call.  Reset to 0 before a run whose kernel use is to be shown.
walk_launches = 0
dyn_launches = 0
parse_walk_launches = 0


# ---------------------------------------------------------------------------
# Offset detectors (torch ops)


def _hash32(v: torch.Tensor) -> torch.Tensor:
    """``v * 2654435761 mod 2**32`` for int64 ``v < 2**32``, without an int64
    overflow: the multiplier's high half only contributes its product's low
    16 bits."""
    c_lo, c_hi = 2654435761 & 0xFFFF, 2654435761 >> 16
    return (v * c_lo + (((v * c_hi) & 0xFFFF) << 16)) & 0xFFFFFFFF


def _topk_lowest_index(score: torch.Tensor, k: int):
    """Top ``k`` of each row, ties lowest index first (``lax.top_k``'s order)."""
    _, order = torch.sort(score, dim=1, descending=True, stable=True)
    ti = order[:, :k]
    return score.gather(1, ti), ti


def detect_offsets(planes: torch.Tensor, *, k: int = DEFAULT_K,
                   stride: int = DEFAULT_STRIDE, max_off: int = 0xFFFF,
                   min_hits: int = 4):
    """Top-k repeated-content offsets per block from strided samples.

    ``planes``: [N, L] uint8.  Returns (offs [N, k] int32, cnt [N, k] int32):
    offsets (0 = empty slot) most frequent first, each seen at least
    ``min_hits`` times among sample neighbours, in [1, max_off], each
    halving-refined toward the true period."""
    if stride % 64:
        raise ValueError("detector stride must be a multiple of 64")
    n, L = planes.shape
    s = L // stride
    if s > 2048:
        raise ValueError("sample index must fit 11 bits")
    dev = planes.device
    ps = planes.reshape(n, s, stride)[:, :, :4].long()
    v = ps[:, :, 0] | (ps[:, :, 1] << 8) | (ps[:, :, 2] << 16) | (ps[:, :, 3] << 24)
    # One sort of hash(21 bits) | sample index(11 bits).
    key = (_hash32(v) & 0xFFFFF800) | torch.arange(s, device=dev)
    sk = torch.sort(key, dim=1).values
    sp = sk & 0x7FF
    hv = sk >> 11
    false = torch.zeros((n, 1), dtype=torch.bool, device=dev)
    same = torch.cat([false, hv[:, 1:] == hv[:, :-1]], dim=1)
    prev = torch.cat([torch.zeros_like(sp[:, :1]), sp[:, :-1]], dim=1)
    delta = (sp - prev) * stride
    ok = same & (delta > 0) & (delta <= max_off)
    delta = torch.where(ok, delta, 0)
    # Frequency of each distinct delta from run boundaries of the sorted row.
    ds = torch.sort(delta, dim=1).values
    i = torch.arange(s, device=dev)
    diff = ds[:, 1:] != ds[:, :-1]
    new_run = torch.cat([~false, diff], dim=1)
    rstart = torch.cummax(torch.where(new_run, i, 0), dim=1).values
    run_len = i - rstart + 1
    last = torch.cat([diff, ~false], dim=1)
    score = torch.where(last & (ds > 0) & (run_len >= min_hits), run_len, 0)
    top, ti = _topk_lowest_index(score, k)
    offs = torch.where(top > 0, ds.gather(1, ti), 0)

    # Halving refinement: an exact 4-byte equality test at 8 positions of
    # the block's last 4 KiB for each of 8 halvings of every candidate.
    s2, halvings = 8, 8
    win = min(L, 4096)
    wb = planes[:, L - win:].long()
    w32 = (wb[:, 0:win - 3] | (wb[:, 1:win - 2] << 8)
           | (wb[:, 2:win - 1] << 16) | (wb[:, 3:win] << 24))
    step2 = max(1, (win - 8) // (2 * s2))
    p_i = win - 8 - torch.arange(s2, device=dev) * step2                 # [S2]
    cand = torch.clamp(offs[:, :, None] >> torch.arange(halvings, device=dev), min=1)
    src = p_i - cand[:, :, :, None]                                      # [N,K,H,S2]
    gat = w32.gather(1, src.clamp(0, win - 4).reshape(n, -1)).reshape(n, k, halvings, s2)
    base = w32[:, p_i]
    valid = ((gat == base[:, None, None, :]) & (src >= 0)).all(dim=3)
    valid = valid & (cand >= 1) & (offs[:, :, None] > 0)
    best = torch.where(valid, cand, 1 << 30).min(dim=2).values
    offs = torch.where(offs > 0, torch.minimum(best, offs), 0)
    return offs.int(), top.int()


def detect_offsets_fft(planes: torch.Tensor, *, k: int = 2, max_off: int = 0xFFFF):
    """Top-k match offsets by FFT autocorrelation, in float32.

    Returns (offs [N, k] int32 in [8, max_off], 0 where the peak is not
    positive; the peak scores [N, k] float32)."""
    n, L = planes.shape
    x = planes.float()
    x = x - x.mean(dim=1, keepdim=True)
    f = torch.fft.rfft(x, dim=1)
    ac = torch.fft.irfft(f * f.conj(), n=L, dim=1)
    ac[:, :8] = float("-inf")
    top, ti = _topk_lowest_index(ac[:, :min(max_off, L - 1) + 1], k)
    return torch.where(top > 0, ti, 0).int(), top


# ---------------------------------------------------------------------------
# Plain PyTorch scoring and walk


def _score_reference(x: torch.Tensor, noff: torch.Tensor, offs: torch.Tensor,
                     max_match: int):
    """(best run, its offset), both [N, L] int32, by the reference's cyclic
    log-doubling."""
    n, L = x.shape
    dev = x.device
    xi = x.int()
    p = torch.arange(L, device=dev)
    run_best = torch.zeros((n, L), dtype=torch.int32, device=dev)
    off_best = torch.zeros_like(run_best)
    noff = noff.long()
    for k in range(offs.shape[1]):
        live = k < noff
        if not bool(live.any()):
            continue
        d = offs[:, k].long()[:, None]
        shifted = xi.gather(1, torch.remainder(p - d, L))
        run = ((xi == shifted) & (p >= d)).int()
        step = 1
        while step < max_match:
            run = torch.where(run == step, run + torch.roll(run, -step, dims=1), run)
            step *= 2
        run = run.clamp(max=max_match)
        better = live[:, None] & (run > run_best)
        run_best = torch.where(better, run, run_best)
        off_best = torch.where(better, d.int(), off_best)
    return run_best, off_best


def match_walk_reference(comp: torch.Tensor, noff: torch.Tensor, offs: torch.Tensor,
                         lengths: torch.Tensor, *, seg: int, min_match: int,
                         wcap: int, max_match: int) -> torch.Tensor:
    """Plain version of B5: ``rec [N, 3*wcap + 1, nseg]`` int32, rows [0, W)
    match positions (-1 empty), [W, 2W) truncated lengths, [2W, 3W)
    offsets, row 3W the segment's overflow flag."""
    run, off = _score_reference(comp, noff, offs, max_match)
    return _walk_records(run, off, lengths, seg=seg, min_match=min_match, wcap=wcap)


def _walk_records(run: torch.Tensor, off: torch.Tensor, lengths: torch.Tensor, *,
                  seg: int, min_match: int, wcap: int) -> torch.Tensor:
    """The greedy segment walk over per-position match planes ``run``/``off``
    [N, L]: B5's walk half, and all of B6.  Returns B5's ``rec``."""
    n, L = run.shape
    G = L // seg
    dev = run.device
    run3, off3 = run.reshape(n, G, seg), off.reshape(n, G, seg)
    brow = torch.arange(seg, device=dev).view(1, 1, seg)
    g = torch.arange(G, device=dev).view(1, G, 1)
    blen = lengths.long().view(n, 1, 1)
    lim = torch.clamp(blen - 5 - g * seg, max=seg)
    m_t = torch.minimum(run3.long(), lim - brow)
    valid = (m_t >= min_match) & (g * seg + brow < blen - 12) & (off3 >= 1)
    inf = 2 * seg
    cand_base = torch.where(valid, brow, inf)
    pos = torch.zeros((n, G, 1), dtype=torch.long, device=dev)
    rec = torch.empty((n, 3 * wcap + 1, G), dtype=torch.int32, device=dev)
    for t in range(wcap):
        nxt = torch.where(brow >= pos, cand_base, inf).min(dim=2, keepdim=True).values
        took = nxt < seg
        idx = nxt.clamp(max=seg - 1)
        m_at = m_t.gather(2, idx)
        o_at = off3.gather(2, idx).long()
        rec[:, t] = torch.where(took, nxt + g * seg, -1)[:, :, 0]
        rec[:, wcap + t] = torch.where(took, m_at, 0)[:, :, 0]
        rec[:, 2 * wcap + t] = torch.where(took, o_at, 0)[:, :, 0]
        pos = torch.where(took, nxt + m_at, seg)
    left = torch.where(brow >= pos, cand_base, inf).min(dim=2).values
    rec[:, 3 * wcap] = (left < seg).int()
    return rec


def match_dyn_reference(comp: torch.Tensor, noff: torch.Tensor, offs: torch.Tensor,
                        *, max_match: int):
    """Plain version of B4: (mlen, moff), each [N, L] int32."""
    return _score_reference(comp, noff, offs, max_match)


#: Offset slots of :func:`edge_batch`'s blocks (as ``detect_fft=True,
#: fft_k=6`` gives them).
EDGE_K = 10


def edge_batch(L: int, n: int = 37, seed: int = 0):
    """Blocks where a tiled scorer's and walk's edges matter, as numpy
    (planes [n, L] uint8, noff [n], offs [n, EDGE_K], lengths [n] int32),
    kinds in turn:

    0. ``noff = 0`` with offsets in its slots, beside live blocks;
    1. two offsets (slots 0 and 1: 1536, 3536) whose runs start 20 bytes
       before L/2 (a segment end at seg 512-2048 and a tile end) and both
       pass it, slot 1's further (100 and 300 positions): the uncut
       look-ahead, not the truncated length, decides the offset;
    2. the same with runs of 1500 and 1900 positions;
    3. ten offsets with a 0 in slot 4, one above half the plane and one of
       L - 128 (the plane's last 128 bytes copy its first);
    4. those offsets with the 0 past ``noff = 7`` and a duplicate, so the
       large offsets win where they match;
    5. a period-47 text through every tile, length L - 37;
    6. RLE, whose runs reach the plane end, length L // 3 + 5.

    ``L`` must be a multiple of 128 and at least 8192."""
    if L % 128 or L < 8192:
        raise ValueError("edge_batch: L must be a multiple of 128 and >= 8192")
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 256, (n, L), np.uint8)
    offs = np.zeros((n, EDGE_K), np.int32)
    noff = np.zeros(n, np.int32)
    lengths = np.full(n, L, np.int32)
    half = L // 2 + 64
    wide = [7, L - 128, half, 3, 0, 9, 11, 13, 17, 19]
    text = np.frombuffer((b"The quick brown fox jumps over the lazy dog 7. "
                          * (L // 47 + 1))[:L], np.uint8)
    for b in range(n):
        x = planes[b]
        kind = b % 7
        if kind == 0:
            x[:] = rng.integers(0, 4, L, np.uint8)
            offs[b] = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
        elif kind in (1, 2):
            d1, d2 = 1536, 3536
            r1, r2 = (100, 300) if kind == 1 else (1500, 1900)
            p0 = L // 2 - 20
            x[p0 - d1:p0 - d1 + r1] = x[p0 - d2:p0 - d2 + r1]   # d1's source = d2's
            x[p0:p0 + r2] = x[p0 - d2:p0 - d2 + r2]
            x[p0 - d1 + r1] = x[p0 + r1 - d2] ^ 0x5A            # d1's run ends at p0 + r1
            x[p0 + r2] = x[p0 + r2 - d2] ^ 0x5A                 # d2's at p0 + r2
            offs[b, :2], noff[b] = (d1, d2), 2
        elif kind in (3, 4):
            x[L - 128:] = x[:128]
            x[half + 1000:half + 1600] = x[1000:1600]
            offs[b], noff[b] = wide, EDGE_K
            if kind == 4:
                offs[b, 4], offs[b, 7], noff[b] = 3, 0, 7
        elif kind == 5:
            x[:] = text
            offs[b, :2], noff[b], lengths[b] = (47, 94), 2, L - 37
        else:
            x[:] = 7
            offs[b, :3], noff[b], lengths[b] = (1, 2, 3), 3, L // 3 + 5
        x[lengths[b]:] = 0
    return planes, noff, offs, lengths


def walk_edge_batch(seg: int, nseg: int = 8, seed: int = 0):
    """Match planes where a chunked walk's edges matter, as numpy (mlen,
    moff [8, nseg * seg] int32, lengths [8] int32), for min_match 6; rows:

    0. matches that land the cursor on a 32- and a 128-position boundary
       and on the segment end, in every segment;
    1. positions 0 and 32 of every 128 mlen-valid with moff 0 (the first
       such position of a chunk, aligned to the segment or to the cursor's
       first chunk), a valid match 5 positions later;
    2. a block of 2.5 segments and 3 bytes: the later segments lie wholly
       past it, and segment 2 has valid lengths only from its scan end
       (blen - 12, not a multiple of 4) on;
    3. a block of 10 bytes: every segment lies past it;
    4. every position valid with length 7 (every segment overflows any wcap);
    5. sparse random hits (5%), some with moff 0, a block of 3 segments and 7 bytes;
    6. long runs (300) with moff 0 inside spans;
    7. nothing valid."""
    rng = np.random.default_rng(seed)
    n, L = 8, nseg * seg
    mlen = np.zeros((n, L), np.int32)
    moff = np.zeros((n, L), np.int32)
    lengths = np.full(n, L, np.int32)
    for g in range(nseg):
        base = g * seg
        for p, m in ((10, 22), (40, 88), (130, 126), (seg - 100, 100)):
            if 0 <= p and p + m <= seg:
                mlen[0, base + p], moff[0, base + p] = m, 3
    brow = np.arange(L) % seg
    for r in (0, 32):
        at = np.flatnonzero((brow % 128 == r) & (brow + 5 < seg))
        mlen[1, at], moff[1, at] = 20, 0
        mlen[1, at + 5], moff[1, at + 5] = 8, 2
    mlen[2], moff[2], lengths[2] = 9, 1, 2 * seg + seg // 2 + 3
    mlen[2, 2 * seg:2 * seg + seg // 2 - 9] = 0    # segment 2: valid only past the scan end
    mlen[3], moff[3], lengths[3] = 9, 1, 10
    mlen[4], moff[4] = 7, 1
    on = rng.random(L) < 0.05
    mlen[5] = np.where(on, rng.integers(1, 40, L), 0)
    moff[5] = np.where(on, rng.integers(0, 3, L), 0)
    lengths[5] = 3 * seg + 7
    mlen[6], moff[6] = 300, 5
    for lo in range(0, L, 700):
        moff[6, lo:lo + 150] = 0
    return mlen, moff, lengths


def _split_records(rec: torch.Tensor, wcap: int):
    """``rec [N, 3*wcap + 1, nseg]`` -> (P, M, O [N, nseg * wcap] in
    (segment, step) order, overflow [N] bool)."""
    n, _, nseg = rec.shape
    P, M, O = (rec[:, i * wcap:(i + 1) * wcap, :].transpose(1, 2).reshape(n, nseg * wcap)
               for i in range(3))
    return P, M, O, (rec[:, 3 * wcap, :] != 0).any(dim=1)


def parse_walk_reference(mlen: torch.Tensor, moff: torch.Tensor, lengths: torch.Tensor, *,
                         seg: int, min_match: int, wcap: int):
    """Plain version of B6: :func:`parse_walk_dyn`'s outputs from plain
    tensor ops.  ``mlen``/``moff`` values must keep ``brow + mlen`` inside
    int32 (the kernel adds in int32; this version in int64)."""
    rec = _walk_records(mlen.long(), moff.long(), lengths, seg=seg, min_match=min_match,
                        wcap=wcap)
    return _split_records(rec, wcap)


def walk_bound_bytes(mlen: torch.Tensor, moff: torch.Tensor, lengths: torch.Tensor,
                     P: torch.Tensor, M: torch.Tensor, *, seg: int, wcap: int,
                     min_match: int) -> int:
    """B6's least traffic on this data, in bytes: 4 bytes of mlen at every
    position its walk must examine (from each cursor to the match it takes,
    to the segment end where none is left, and the overflow scan), 4 bytes
    of moff only where such a position passes the length and position tests
    (the only places moff decides anything), the lengths, and the records
    and flags written.  ``P``/``M`` are the walk's own records."""
    n, L = mlen.shape
    G = L // seg
    dev = mlen.device
    brow = torch.arange(seg, device=dev)
    gbase = (torch.arange(G, device=dev) * seg).view(1, G, 1)
    blen = lengths.long().view(n, 1, 1)
    m_t = torch.minimum(mlen.view(n, G, seg).long(), (blen - 5 - gbase).clamp(max=seg) - brow)
    tested = (m_t >= min_match) & (gbase + brow < blen - 12)
    valid = tested & (moff.view(n, G, seg) >= 1)
    Pg = P.view(n, G, wcap).long() - gbase
    Mg = M.view(n, G, wcap).long()
    edges = torch.zeros((n, G, seg + 1), dtype=torch.long, device=dev)

    def examine(lo, hi):                      # mark [lo, hi) of every segment
        lo = lo.clamp(0, seg)
        hi = torch.maximum(hi.clamp(0, seg), lo)
        edges.scatter_add_(2, lo[:, :, None], torch.ones_like(lo)[:, :, None])
        edges.scatter_add_(2, hi[:, :, None], -torch.ones_like(hi)[:, :, None])

    pos = torch.zeros((n, G), dtype=torch.long, device=dev)
    for t in range(wcap):
        took = P.view(n, G, wcap)[:, :, t] >= 0
        examine(pos, torch.where(took, Pg[:, :, t] + 1, seg))
        pos = torch.where(took, Pg[:, :, t] + Mg[:, :, t], seg)
    left = torch.where(valid & (brow >= pos[:, :, None]), brow, seg).min(dim=2).values
    examine(pos, torch.where(left < seg, left + 1, seg))
    seen = edges.cumsum(dim=2)[:, :, :seg] > 0
    return (4 * int(seen.sum()) + 4 * int((seen & tested).sum()) + 4 * n
            + 3 * 4 * n * G * wcap + n)


# ---------------------------------------------------------------------------
# The CUDA kernels


_vp, _int = ctypes.c_void_p, ctypes.c_int
_WALK_ARGS = [_vp, _vp, _vp, _int, _vp,        # planes, noff, offs, K, lengths
              _vp, _vp, _vp, _vp,              # P, M, O, segment flags
              _int, _int, _int,                # n, L, seg
              _int, _int, _int, _int, _vp]     # min_match, wcap, max_match, device, stream
_DYN_ARGS = [_vp, _vp, _vp, _int, _vp, _vp,    # planes, noff, offs, K, mlen, moff
             _int, _int, _int, _int, _vp]      # n, L, max_match, device, stream
_PARSE_WALK_ARGS = [_vp, _vp, _vp,             # mlen, moff, lengths
                    _vp, _vp, _vp, _vp,        # P, M, O, segment flags
                    _int, _int, _int,          # n, L, seg
                    _int, _int, _int, _vp]     # min_match, wcap, device, stream


def _load(stem: str, argtypes: list) -> ctypes.CDLL:
    def bind(lib: ctypes.CDLL) -> None:
        fn = getattr(lib, f"bt_{stem}_launch")
        fn.restype = _int
        fn.argtypes = argtypes
    return load_cuda_kernel(stem, bind, ("match_tile.cuh",))


def load_walk_kernel() -> ctypes.CDLL:
    """Build (at first use, for sm_90a) and load ``csrc/match_walk.cu``."""
    return _load("match_walk", _WALK_ARGS)


def load_dyn_kernel() -> ctypes.CDLL:
    """Build (at first use, for sm_90a) and load ``csrc/match_dyn.cu``."""
    return _load("match_dyn", _DYN_ARGS)


def load_parse_walk_kernel() -> ctypes.CDLL:
    """Build (at first use, for sm_90a) and load ``csrc/parse_walk.cu``."""
    def bind(lib: ctypes.CDLL) -> None:
        lib.bt_parse_walk_launch.restype = _int
        lib.bt_parse_walk_launch.argtypes = _PARSE_WALK_ARGS
    return load_cuda_kernel("parse_walk", bind)


_walk_fn = None     # the libraries' bound launch functions, once loaded
_dyn_fn = None
_parse_walk_fn = None


def _kernel_inputs(x, noff, offs, lengths=None) -> torch.Tensor:
    """Checks what the kernels read (contiguous uint8 planes; int32 noff,
    offs and lengths on their device), building a message only on failure;
    returns the planes 16-byte aligned (the kernels load them 16 bytes at a
    time)."""
    n = x.shape[0]
    require(x.dtype == torch.uint8 and x.is_contiguous(),
            lambda: f"planes: want contiguous uint8, got {x.dtype}")
    named = [("noff", noff, (n,)), ("offs", offs, (n, offs.shape[-1]))]
    if lengths is not None:
        named.append(("lengths", lengths, (n,)))
    for name, t, shape in named:
        require(t.device == x.device and t.dtype == torch.int32 and t.is_contiguous()
                and t.shape == shape,
                lambda: f"{name}: want contiguous int32 {list(shape)} on {x.device}, "
                        f"got {t.dtype} {list(t.shape)} on {t.device}")
    return x.clone() if x.data_ptr() % 16 else x


def _as_planes(comp: torch.Tensor, nrows: int) -> torch.Tensor:
    n = comp.shape[0]
    require(comp.numel() == n * nrows * LANES,
            lambda: f"planes: want [N, {nrows}, 128] bytes, got {list(comp.shape)}")
    return comp.reshape(n, nrows * LANES)


def find_matches_parse_dyn(comp: torch.Tensor, noff: torch.Tensor, offs: torch.Tensor,
                           lengths: torch.Tensor, *, nrows: int, seg: int,
                           min_match: int, wcap: int = 8, max_match: int = 1024):
    """Fused dynamic-offset match + greedy segment parse (B5).

    ``comp``: [N, nrows, 128] uint8 raw planes; ``noff`` [N], ``offs``
    [N, K] and ``lengths`` [N] int32.  Returns (P, M, O [N, nseg * wcap]
    int32 in position order, P = -1 for an empty slot; overflow [N] bool).
    Requires seg % 128 == 0, nseg <= 128 and max_match <= seg.  A CPU
    tensor runs :func:`match_walk_reference`; a CUDA one launches
    ``csrc/match_walk.cu`` (max_match up to 2047) or raises StatusError."""
    global walk_launches, _walk_fn
    L = nrows * LANES
    if seg % LANES or L % seg:
        raise ValueError("seg must be lane-aligned and divide the plane")
    nseg = L // seg
    if nseg > 128:
        raise ValueError("find_matches_parse_dyn: nseg must fit one lane tile")
    if max_match > seg:
        raise ValueError("max_match must be <= seg (segment truncation)")
    x = _as_planes(comp, nrows)
    n = x.shape[0]
    if x.device.type == "cpu":
        rec = match_walk_reference(x, noff, offs, lengths, seg=seg, min_match=min_match,
                                   wcap=wcap, max_match=max_match)
        return _split_records(rec, wcap)
    require(x.device.type == "cuda",
            lambda: f"find_matches_parse_dyn: no kernel for device {x.device}")
    require(wcap >= 0, lambda: f"wcap {wcap} must not be negative")
    x = _kernel_inputs(x, noff, offs, lengths)
    dev = x.device
    P, M, O = torch.empty((3, n, nseg * wcap), dtype=torch.int32, device=dev)
    flags = torch.empty((n, nseg), dtype=torch.int32, device=dev)
    if n:
        if _walk_fn is None:
            _walk_fn = load_walk_kernel().bt_match_walk_launch
        # The device's current stream as torch.cuda.current_stream(dev)
        # gives it, without building a Stream object or entering the device.
        rc = _walk_fn(x.data_ptr(), noff.data_ptr(), offs.data_ptr(), offs.shape[1],
                      lengths.data_ptr(), P.data_ptr(), M.data_ptr(), O.data_ptr(),
                      flags.data_ptr(), n, L, seg, min_match, wcap, max_match, dev.index,
                      torch._C._cuda_getCurrentRawStream(dev.index))
        check_cuda(rc, "match_walk launch", load_walk_kernel())
        walk_launches += 1
    return P, M, O, flags.any(dim=1)


def parse_walk_dyn(mlen: torch.Tensor, moff: torch.Tensor, lengths: torch.Tensor, *,
                   seg: int, min_match: int, wcap: int):
    """Greedy per-segment parse of precomputed match planes (B6).

    ``mlen``/``moff``: [N, L] int32 per-position match length and offset
    (B4's output, flattened); ``lengths`` [N] int32.  Returns (P, M, O
    [N, nseg * wcap] int32 in (segment, step) order, P = -1 for an empty
    slot, M truncated lengths, O offsets; overflow [N] bool).  Raises
    ValueError unless ``seg`` divides L and ``nseg = L / seg <= 128``, as
    the reference does.  A CPU tensor runs :func:`parse_walk_reference`; a
    CUDA one launches ``csrc/parse_walk.cu`` or raises."""
    global parse_walk_launches, _parse_walk_fn
    n, L = mlen.shape
    if L % seg:
        raise ValueError("seg must divide L")
    nseg = L // seg
    if nseg > 128:
        raise ValueError("parse_walk_dyn: nseg must fit one lane tile")
    if mlen.device.type == "cpu":
        return parse_walk_reference(mlen, moff, lengths, seg=seg, min_match=min_match,
                                    wcap=wcap)
    require(mlen.device.type == "cuda",
            lambda: f"parse_walk_dyn: no kernel for device {mlen.device}")
    require(wcap >= 0, lambda: f"wcap {wcap} must not be negative")
    dev = mlen.device
    for name, t, shape in (("mlen", mlen, (n, L)), ("moff", moff, (n, L)),
                           ("lengths", lengths, (n,))):
        require(t.device == dev and t.dtype == torch.int32 and t.is_contiguous()
                and tuple(t.shape) == shape,
                lambda: f"{name}: want contiguous int32 {list(shape)} on {dev}, "
                        f"got {t.dtype} {list(t.shape)} on {t.device}")
    P, M, O = torch.empty((3, n, nseg * wcap), dtype=torch.int32, device=dev)
    flags = torch.empty((n, nseg), dtype=torch.int32, device=dev)   # the kernel writes each
    if n:
        if _parse_walk_fn is None:
            _parse_walk_fn = load_parse_walk_kernel().bt_parse_walk_launch
        rc = _parse_walk_fn(mlen.data_ptr(), moff.data_ptr(), lengths.data_ptr(), P.data_ptr(),
                            M.data_ptr(), O.data_ptr(), flags.data_ptr(), n, L, seg, min_match,
                            wcap, dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
        check_cuda(rc, "parse_walk launch", load_parse_walk_kernel())
        parse_walk_launches += 1
    return P, M, O, flags.any(dim=1)


def find_matches_dyn(comp: torch.Tensor, noff: torch.Tensor, offs: torch.Tensor, *,
                     nrows: int, max_match: int = 512):
    """Per-block dynamic-offset scoring (B4).

    Returns (mlen, moff), each [N, nrows, 128] int32: the best run at each
    position capped at ``max_match`` (every prefix byte-true) and its
    offset."""
    global dyn_launches, _dyn_fn
    x = _as_planes(comp, nrows)
    n, L = x.shape
    if x.device.type == "cpu":
        mlen, moff = match_dyn_reference(x, noff, offs, max_match=max_match)
        return mlen.reshape(n, nrows, LANES), moff.reshape(n, nrows, LANES)
    require(x.device.type == "cuda", lambda: f"find_matches_dyn: no kernel for device {x.device}")
    require(1 <= max_match <= 2047, lambda: f"max_match {max_match} outside [1, 2047]")
    x = _kernel_inputs(x, noff, offs)
    dev = x.device
    mlen, moff = torch.empty((2, n, L), dtype=torch.int32, device=dev)
    if n:
        if _dyn_fn is None:
            _dyn_fn = load_dyn_kernel().bt_match_dyn_launch
        rc = _dyn_fn(x.data_ptr(), noff.data_ptr(), offs.data_ptr(), offs.shape[1],
                     mlen.data_ptr(), moff.data_ptr(), n, L, max_match, dev.index,
                     torch._C._cuda_getCurrentRawStream(dev.index))
        check_cuda(rc, "match_dyn launch", load_dyn_kernel())
        dyn_launches += 1
    return mlen.reshape(n, nrows, LANES), moff.reshape(n, nrows, LANES)
