"""Byte emission of device-compressed blocks: one emitter for every width.

Counterpart of the reference's three emitters, which compute one function:
``materialize_pallas_packed`` (kernel B8, LZ4 and Snappy, lane-tiled widths
in [256, 65536)), ``materialize_pallas`` (kernels B9 + B10, LZ4, widths
% 8) and the XLA ``materialize`` (LZ4, any width); all in
``bitar_tpu/ops/pallas/lz4_emit.py`` and ``bitar_tpu/ops/device_compress.py``.

Output byte ``t < total[b]`` of block ``b`` belongs to the last slot whose
start is ``<= t`` (starts never decrease; an empty slot shares its start
with the next real one, so the last of equal starts is the real slot).  Its
value follows from that slot's ``(lit_len, lit_start, mv, off)``: token,
literal-length extensions, the literal byte from the raw plane, the two
offset bytes, match-length extensions (LZ4); or the literal tag and length
bytes, literals, and one 3-byte copy-2 element per <= 64-byte match chunk
after the uncompressed-length varint (Snappy).  Bytes past ``total`` are
0.  A row whose total exceeds ``out_width`` is garbage by contract (the
caller stores such a block RAW).

``emit_blocks`` runs the plain version for CPU tensors and launches the
kernel ``csrc/emit.cu`` for CUDA tensors, or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import check_cuda, load_cuda_kernel, require

_FIELDS = ("starts", "lit_len", "lit_start", "mv", "off")

#: Kernel launches made by ``emit_blocks`` on CUDA tensors, one per call.
launches = 0
#: Launches of the empty kernel of ``floor_kernel_ms``.
floor_launches = 0


def ext_bytes(v: torch.Tensor) -> torch.Tensor:
    """LZ4 length-extension bytes of a token field carrying ``v``."""
    return torch.where(v >= 15, (v - 15) // 255 + 1, 0)


def snappy_len_extra(n1: torch.Tensor) -> torch.Tensor:
    """Length bytes after a Snappy literal tag for a literal of ``n1 + 1``."""
    return torch.where(n1 < 60, 0, torch.where(n1 < 256, 1, torch.where(n1 < 65536, 2, 3)))


def emit_reference(planes: torch.Tensor, layout: dict, *, out_width: int,
                   fmt: str = "lz4", lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: [N, out_width] uint8 wire bytes of ``layout``."""
    n, L = planes.shape
    dev = planes.device
    starts = layout["starts"].long().contiguous()
    t = torch.arange(out_width, device=dev).expand(n, out_width).contiguous()
    k = torch.searchsorted(starts, t, right=True) - 1
    kc = k.clamp(min=0)

    def field(name):
        return layout[name].long().gather(1, kc)

    ll, ls, mv, off = field("lit_len"), field("lit_start"), field("mv"), field("off")
    d = t - starts.gather(1, kc)
    if fmt == "lz4":
        hdr = 1 + ext_bytes(ll)
    else:
        n1 = ll - 1
        extra = snappy_len_extra(n1)
        hdr = torch.where(ll > 0, 1 + extra, 0)
    lit_end = hdr + ll
    lit_byte = planes.gather(1, (ls + d - hdr).clamp(0, L - 1)).long()
    if fmt == "lz4":
        token = (ll.clamp(max=15) << 4) | torch.where(mv >= 0, mv.clamp(max=15), 0)
        lit_ext = (ll - 15 - 255 * (d - 1)).clamp(0, 255)
        off_byte = torch.where(d == lit_end, off & 0xFF, (off >> 8) & 0xFF)
        m_ext = (mv - 15 - 255 * (d - lit_end - 2)).clamp(0, 255)
        val = torch.where(d == 0, token, torch.where(
            d < hdr, lit_ext, torch.where(
                d < lit_end, lit_byte, torch.where(d < lit_end + 2, off_byte, m_ext))))
    else:
        tag_lit = torch.where(extra == 0, n1 << 2, (59 + extra) << 2)
        lit_ext = torch.where(d == 0, tag_lit, (n1 >> (8 * (d - 1)).clamp(0, 24)) & 0xFF)
        cd = d - lit_end
        ci = cd.clamp(min=0) // 3
        r3 = cd - 3 * ci
        clen = (mv + 4 - 64 * ci).clamp(1, 64)
        copy_byte = torch.where(r3 == 0, 2 | ((clen - 1) << 2),
                                torch.where(r3 == 1, off & 0xFF, (off >> 8) & 0xFF))
        val = torch.where(d < hdr, lit_ext, torch.where(d < lit_end, lit_byte, copy_byte))
        blen = (torch.full((n,), L, device=dev) if lengths is None
                else lengths.long())[:, None]
        pre = (blen >> (7 * t).clamp(0, 28)) & 0x7F
        more = (blen >> (7 * (t + 1)).clamp(0, 28)) > 0
        pre = torch.where(more, pre | 0x80, pre)
        vl = 1 + (blen >= (1 << 7)).long() + (blen >= (1 << 14)).long()
        val = torch.where(t < vl, pre, val)
    val = torch.where(t < layout["total"].long()[:, None], val, 0)
    return val.to(torch.uint8)


def bound_bytes(layout: dict, ow: int) -> int:
    """Bytes an LZ4 emission at width ``ow`` must move: the literal bytes of
    each row's first min(total, ow) output bytes and the five fields of the
    slots that start there read, the totals read, [N, ow] written."""
    lim = layout["total"].long().clamp(max=ow)[:, None]
    starts, ll = layout["starts"].long(), layout["lit_len"].long()
    lo = starts + 1 + ext_bytes(ll)
    lit = (torch.minimum(lo + ll, lim) - lo).clamp(min=0)
    slots = (starts < lim) & layout["taken"]
    n = starts.shape[0]
    return int(lit.sum()) + 20 * int(slots.sum()) + 4 * n + n * ow


def _row_matches(kind: int, rng, L: int, blen: int, seg: int) -> list:
    """Candidate (position, length, offset) matches of one edge row."""
    if kind == 0:                  # dense short matches
        return [(int(p), int(rng.integers(4, 21)), int(rng.integers(1, 600)))
                for p in np.sort(rng.choice(L, L // 24, replace=False))]
    if kind == 1:                  # a literal across several tiles, one starting mid-tile
        return [(100, 50, 7), (3150, 40, 3000), (3967, 30, 1000), (4200, 300, 64),
                (6000, 9, 5000)]
    if kind == 3:                  # long matches and long literals
        return [(300, min(1000, seg - 300), 17), (seg + 700, seg - 700, 1),
                (3 * seg + 500, min(400, seg - 500), 250)]
    if kind in (4, 5):             # short blocks: 1- and 2-byte Snappy varints
        return [(20, 10, 20), (40, 30, 5), (blen // 2, 40, 33)]
    if kind == 6:                  # RLE: matches of offset 1 to each segment end
        return [(g * seg + 1, seg - 1, 1) for g in range(L // seg)]
    out, p = [], 5                 # matches of 24-40 bytes back to back: 3-byte slots
    while p < L:
        m = int(rng.integers(24, 41))
        out.append((p, m, int(rng.integers(1, 6))))
        p += m
    return out


def edge_layouts(L: int = 32768, *, fmt: str = "lz4", wcap: int | None = 8, seg: int = 1024,
                 min_match: int = 6, n: int = 16, seed: int = 0):
    """Blocks and layouts where an emitter's edges matter, as numpy: (planes
    [n, L] uint8, lengths [n] int32, layout: ``_layout_from_records``'s dict
    of [n, S] and [n] arrays, S = L / seg * slots + 1 with ``wcap`` slots a
    segment, or the worst-case budget ``seg // min_match + 1`` for None).
    Each segment's matches sit in random slots among empty ones (runs of
    equal starts before a real slot).  Rows, kinds in turn:

    0. dense short matches (4-20 bytes);
    1. a literal of 3000 bytes across several of the kernel's 256- or
       512-byte output tiles, and one starting mid-tile, then a long match
       and a short one;
    2. random bytes, all literals: a total above any width under L;
    3. long matches and long literals (LZ4 extension bytes, Snappy 2-byte
       literal lengths and many copy elements);
    4. a block of 100 bytes (1-byte Snappy varint);
    5. a block of 5000 bytes (2-byte varint; full blocks take 3 at L >= 16 KiB);
    6. RLE, one match of offset 1 to each segment end;
    7. matches of 24-40 bytes back to back, no literals between (3-byte
       slots): a row whose output packs several segments' slots into a
       few hundred bytes (with the worst-case budget, more slots than a
       warp loads at once, a fifth of them real).

    Every match is byte-true, ends in its segment and 5 bytes before its
    block's end, and starts before the block's last 12 bytes, so every row
    decodes to its block."""
    from .device_compress import _layout_from_records

    if L % seg or L < 4 * seg:
        raise ValueError("edge_layouts: seg must divide L, and L hold 4 segments")
    rng = np.random.default_rng(seed)
    nseg = L // seg
    slots = seg // min_match + 1 if wcap is None else wcap
    text = np.frombuffer((b"Edge layouts of the one emitter, row %d. " * (L // 30 + 1))[:L],
                         np.uint8)
    planes = rng.integers(0, 256, (n, L), np.uint8)
    lengths = np.full(n, L, np.int32)
    P = np.full((n, nseg * slots), -1, np.int32)
    M = np.zeros_like(P)
    O = np.zeros_like(P)
    for b in range(n):
        kind = b % 8
        blen = {4: 100, 5: 5000}.get(kind, L)
        lengths[b] = blen
        x = planes[b]
        if kind in (0, 7):
            x[:] = text
        cursor, per_seg = 0, [[] for _ in range(nseg)]
        for p, m, o in _row_matches(kind, rng, L, blen, seg) if kind != 2 else ():
            g = p // seg
            if (p < cursor or m < 4 or o < 1 or o > p or p >= blen - 12
                    or p + m > min((g + 1) * seg, blen - 5) or len(per_seg[g]) >= slots):
                continue
            for i in range(m):            # byte by byte: overlapping copies repeat
                x[p + i] = x[p + i - o]
            per_seg[g].append((p, m, o))
            cursor = p + m
        x[blen:] = 0
        for g, ms in enumerate(per_seg):
            at = np.sort(rng.choice(slots, len(ms), replace=False)) + g * slots
            for k, (p, m, o) in zip(at, ms):
                P[b, k], M[b, k], O[b, k] = p, m, o
    lay = _layout_from_records(torch.from_numpy(P), torch.from_numpy(M), torch.from_numpy(O),
                               torch.zeros(n, dtype=torch.bool), torch.from_numpy(lengths),
                               fmt=fmt)
    return planes, lengths, {k: v.numpy() for k, v in lay.items()}


def _bind(lib: ctypes.CDLL) -> None:
    vp, c_int = ctypes.c_void_p, ctypes.c_int
    lib.bt_emit_launch.restype = c_int
    lib.bt_emit_launch.argtypes = [
        vp, c_int,                     # planes, L
        vp, vp, vp, vp, vp, c_int,     # starts, lit_len, lit_start, mv, off, S
        vp, vp,                        # total, lengths (null: L)
        vp, c_int, c_int, c_int,       # out, n, out_width, snappy
        c_int, vp]                     # device, stream
    lib.bt_emit_floor_launch.restype = c_int
    lib.bt_emit_floor_launch.argtypes = [c_int, c_int, c_int,   # n, S, out_width
                                         c_int, vp]             # device, stream


def load_kernel() -> ctypes.CDLL:
    """Build (at first use, for sm_90a) and load ``csrc/emit.cu``."""
    return load_cuda_kernel("emit", _bind)


_emit_fn = None     # the library's bound launch function, once loaded


def _int32_on(t: torch.Tensor, shape: tuple, dev: torch.device) -> bool:
    return (t.device == dev and t.dtype == torch.int32 and t.is_contiguous()
            and tuple(t.shape) == shape)


def emit_blocks(planes: torch.Tensor, layout: dict, *, out_width: int, fmt: str = "lz4",
                lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Emit the LZ4 or Snappy (``fmt``) stream of every block of ``layout``.

    ``planes``: [N, L] uint8 raw blocks; ``layout``: the dict of
    ``device_compress._layout_from_records`` on the same device (starts
    never decrease along a row);
    ``lengths``: [N] int32 raw lengths (Snappy's preamble; default L).
    Returns [N, out_width] uint8."""
    global launches, _emit_fn
    require(fmt in ("lz4", "snappy"), lambda: f"emit format {fmt!r} not in (lz4, snappy)")
    require(planes.dtype == torch.uint8 and planes.ndim == 2,
            lambda: f"planes: want [N, L] uint8, got {list(planes.shape)} {planes.dtype}")
    require(out_width >= 1, lambda: f"out_width {out_width} must be positive")
    if planes.device.type == "cpu":
        return emit_reference(planes, layout, out_width=out_width, fmt=fmt, lengths=lengths)
    require(planes.device.type == "cuda",
            lambda: f"emit_blocks: no kernel for device {planes.device}")
    n, L = planes.shape
    dev = planes.device
    planes = planes.contiguous()
    S = layout["starts"].shape[1]
    fields = []
    for name in _FIELDS:
        f = layout[name]
        require(_int32_on(f, (n, S), dev),
                lambda: f"layout {name}: want contiguous int32 [{n}, {S}] on {dev}, got "
                        f"{f.dtype} {list(f.shape)} on {f.device}")
        fields.append(f.clone() if f.data_ptr() % 16 else f)   # the kernel loads 16 bytes
    total = layout["total"]
    for name, f in (("total", total), ("lengths", lengths)):
        require(f is None or _int32_on(f, (n,), dev),
                lambda: f"{name}: want contiguous int32 [{n}] on {dev}, got "
                        f"{f.dtype} {list(f.shape)} on {f.device}")
    out = torch.empty((n, out_width), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    if _emit_fn is None:
        _emit_fn = load_kernel().bt_emit_launch
    # The device's current stream as torch.cuda.current_stream(dev) gives
    # it, without building a Stream object; the launch enters the device.
    rc = _emit_fn(planes.data_ptr(), L, *[f.data_ptr() for f in fields], S, total.data_ptr(),
                  None if lengths is None else lengths.data_ptr(), out.data_ptr(), n,
                  out_width, int(fmt == "snappy"), dev.index,
                  torch._C._cuda_getCurrentRawStream(dev.index))
    check_cuda(rc, "emit launch", load_kernel())
    launches += 1
    return out


def floor_kernel_ms(n: int, S: int, out_width: int, timing, reps: int) -> float:
    """Held ms (``timing.kernel_time_ms``) of an empty kernel on the grid
    ``emit_blocks`` launches for ``n`` rows of ``S`` slots at
    ``out_width``: the launch's own floor on the current CUDA device."""
    lib = load_kernel()
    dev = torch.cuda.current_device()

    def launch():
        global floor_launches
        rc = lib.bt_emit_floor_launch(n, S, out_width, dev,
                                      torch._C._cuda_getCurrentRawStream(dev))
        check_cuda(rc, "emit floor launch", lib)
        floor_launches += 1

    return timing.kernel_time_ms(launch, reps, lambda: floor_launches)
