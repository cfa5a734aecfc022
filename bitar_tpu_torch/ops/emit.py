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

import torch

from ._build import check_cuda, load_cuda_kernel, require

_FIELDS = ("starts", "lit_len", "lit_start", "mv", "off")

#: Kernel launches made by ``emit_blocks`` on CUDA tensors, one per call.
launches = 0


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


def _bind(lib: ctypes.CDLL) -> None:
    vp, c_int = ctypes.c_void_p, ctypes.c_int
    lib.bt_emit_launch.restype = c_int
    lib.bt_emit_launch.argtypes = [
        vp, c_int,                     # planes, L
        vp, vp, vp, vp, vp, c_int,     # starts, lit_len, lit_start, mv, off, S
        vp, vp,                        # total, lengths
        vp, c_int, c_int, c_int, vp]   # out, n, out_width, snappy, stream


def load_kernel() -> ctypes.CDLL:
    """Build (at first use, for sm_90a) and load ``csrc/emit.cu``."""
    return load_cuda_kernel("emit", _bind)


def emit_blocks(planes: torch.Tensor, layout: dict, *, out_width: int, fmt: str = "lz4",
                lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Emit the LZ4 or Snappy (``fmt``) stream of every block of ``layout``.

    ``planes``: [N, L] uint8 raw blocks; ``layout``: the dict of
    ``device_compress._layout_from_records`` on the same device;
    ``lengths``: [N] int32 raw lengths (Snappy's preamble; default L).
    Returns [N, out_width] uint8."""
    global launches
    require(fmt in ("lz4", "snappy"), f"emit format {fmt!r} not in (lz4, snappy)")
    require(planes.dtype == torch.uint8 and planes.ndim == 2,
            f"planes: want [N, L] uint8, got {list(planes.shape)} {planes.dtype}")
    require(out_width >= 1, f"out_width {out_width} must be positive")
    if planes.device.type == "cpu":
        return emit_reference(planes, layout, out_width=out_width, fmt=fmt, lengths=lengths)
    require(planes.device.type == "cuda", f"emit_blocks: no kernel for device {planes.device}")
    n, L = planes.shape
    planes = planes.contiguous()
    if lengths is None:
        lengths = torch.full((n,), L, dtype=torch.int32, device=planes.device)
    S = layout["starts"].shape[1]
    fields = [layout[k] for k in _FIELDS]
    for name, f in zip(_FIELDS, fields, strict=True):
        require(f.device == planes.device and f.dtype == torch.int32
                and f.is_contiguous() and tuple(f.shape) == (n, S),
                f"layout {name}: want contiguous int32 [{n}, {S}] on {planes.device}")
    for name, f in (("total", layout["total"]), ("lengths", lengths)):
        require(f.device == planes.device and f.dtype == torch.int32
                and f.is_contiguous() and tuple(f.shape) == (n,),
                f"{name}: want contiguous int32 [{n}] on {planes.device}")
    out = torch.empty((n, out_width), dtype=torch.uint8, device=planes.device)
    if n == 0:
        return out
    lib = load_kernel()
    with torch.cuda.device(planes.device):
        rc = lib.bt_emit_launch(
            planes.data_ptr(), L, *[f.data_ptr() for f in fields], S,
            layout["total"].data_ptr(), lengths.data_ptr(), out.data_ptr(), n,
            out_width, int(fmt == "snappy"),
            torch.cuda.current_stream(planes.device).cuda_stream)
    check_cuda(rc, "emit launch", lib)
    launches += 1
    return out
