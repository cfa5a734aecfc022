"""ctypes bindings to the host codec library, for the calls the port needs.

The library is the port's own C++, in this directory (``*.cc`` and
``bitar_host.h``: the LZ4/Snappy/Zstd codecs, the batch engine, the batch
planner ``bt_plan_batch*``, the sequence parsers and the hint-driven
emitters), compiled with g++ into the port's build directory at first use.
It began as a copy of the JAX package's library; parity tests hold the two
to the same streams, tables and plans.
"""


from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

from ...status import Status, StatusError
from .._build import build_library

SRC_DIR = Path(__file__).resolve().parent
_SOURCES = ["lz4.cc", "snappy.cc", "zstd.cc", "batch.cc", "plan.cc"]
_ABI_VERSION = 6
DENSE_PLANES = 64     # row_a anchor planes per block (plan.cc kDenseMax)
#: Columns of a sequence table, in the order the parsers write them.
SEQUENCE_KEYS = ("lit_ptr", "lit_len", "off", "mlen", "out_pos")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i16p = ctypes.POINTER(ctypes.c_int16)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def _command(out: Path) -> list[str]:
    return (["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
             "-o", str(out)] + [str(SRC_DIR / s) for s in _SOURCES])


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int = ctypes.c_int
    for name in ("bt_lz4_decompress", "bt_snappy_decompress", "bt_zstd_compress",
                 "bt_zstd_decompress"):
        fn = getattr(lib, name)
        fn.restype = c_int
        fn.argtypes = [_u8p, c_int, _u8p, c_int]
    for name in ("bt_lz4_compress_mm", "bt_snappy_compress_mm"):
        fn = getattr(lib, name)
        fn.restype = c_int
        fn.argtypes = [_u8p, c_int, _u8p, c_int, c_int]
    lib.bt_snappy_uncompressed_len.restype = c_int
    lib.bt_snappy_uncompressed_len.argtypes = [_u8p, c_int]
    lib.bt_zstd_parse.restype = c_int
    lib.bt_zstd_parse.argtypes = [_u8p, c_int, c_int, _u8p, c_int, _i32p] + [_i32p] * 5
    lib.bt_batch_compress.restype = None
    lib.bt_batch_compress.argtypes = [
        c_int, _i32p, c_int, c_int,
        _u8p, _i64p, _i32p, _u8p, _i64p, _i32p, _i32p, c_int]
    lib.bt_batch_decompress.restype = None
    lib.bt_batch_decompress.argtypes = [
        c_int, _i32p, c_int, c_int,
        _u8p, _i64p, _i32p, _u8p, _i64p, _i32p, _i32p]
    lib.bt_plan_batch.restype = None
    lib.bt_plan_batch.argtypes = [
        c_int, _i32p, c_int, c_int, _u8p, _i64p, _i32p, _i32p,
        c_int, c_int, c_int, c_int, c_int, c_int,
        _i16p, _i32p, _i32p, _i32p, _i32p,
        _u8p, ctypes.c_int64, _i32p, _i16p, _i32p, _i32p]
    lib.bt_plan_batch_begin.restype = ctypes.c_void_p
    lib.bt_plan_batch_begin.argtypes = [
        c_int, _i32p, c_int, c_int, _u8p, _i64p, _i32p, _i32p,
        c_int, c_int, c_int, c_int, c_int, c_int,
        _i32p, _i32p, _i32p,
        _u8p, ctypes.c_int64, _i32p, _i16p, _i32p, _i32p]
    lib.bt_plan_batch_pack.restype = None
    lib.bt_plan_batch_pack.argtypes = [ctypes.c_void_p, c_int, _i64p, _i16p, _i32p]
    lib.bt_plan_batch_abort.restype = None
    lib.bt_plan_batch_abort.argtypes = [ctypes.c_void_p]
    lib.bt_plan_block.restype = c_int
    lib.bt_plan_block.argtypes = [c_int, _u8p, c_int, c_int, c_int, c_int] + [_i32p] * 5
    lib.bt_plan_dense_pack.restype = None
    lib.bt_plan_dense_pack.argtypes = [
        c_int, c_int, _i64p, _i16p, _i16p, _i32p, _i32p, c_int, c_int, c_int, _i32p]
    for name in ("bt_lz4_parse", "bt_snappy_parse"):
        fn = getattr(lib, name)
        fn.restype = c_int
        fn.argtypes = [_u8p, c_int, c_int, _i32p, _i32p, _i32p, _i32p, _i32p]
    for name in ("bt_lz4_emit_sequences", "bt_snappy_emit_sequences"):
        fn = getattr(lib, name)
        fn.restype = c_int
        fn.argtypes = [_u8p, c_int, _i32p, _i32p, _i32p, c_int, _u8p, c_int]
    lib.bt_set_emit_min_match.restype = None
    lib.bt_set_emit_min_match.argtypes = [c_int]
    lib.bt_set_split_limit.restype = None
    lib.bt_set_split_limit.argtypes = [c_int]
    lib.bt_plan_frags.restype = c_int
    lib.bt_plan_frags.argtypes = [c_int, _u8p, c_int, c_int, c_int, c_int] + [_i32p] * 5
    lib.bt_plan_prof_get.restype = None
    lib.bt_plan_prof_get.argtypes = [_i64p, c_int]
    lib.bt_abi_version.restype = c_int
    lib.bt_abi_version.argtypes = []
    return lib


def sources() -> list[Path]:
    """The files the library's build hash covers: every source and, so that
    a header-only change rebuilds instead of loading a stale library, every
    header."""
    return [SRC_DIR / s for s in _SOURCES] + sorted(SRC_DIR.glob("*.h"))


def load() -> ctypes.CDLL:
    """Load (building if needed) the host library; thread-safe, idempotent."""
    global _lib
    with _lock:
        if _lib is None:
            path = build_library("bitar_host", sources(), _command)
            lib = _bind(ctypes.CDLL(str(path)))
            got = lib.bt_abi_version()
            if got != _ABI_VERSION:
                raise StatusError(Status.IOError(
                    f"native ABI version {got} != expected {_ABI_VERSION}"))
            _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# numpy-friendly wrappers


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _i16ptr(a: np.ndarray):
    return a.ctypes.data_as(_i16p)


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(_i32p)


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(_i64p)


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8)


def _check(rc: int, what: str) -> int:
    if rc < 0:
        raise StatusError(Status.from_int(rc, what))
    return rc


def _nthreads(n: int) -> int:
    return n if n > 0 else (os.cpu_count() or 1)


def lz4_compress(data, dst_cap: int | None = None, min_match: int = 4) -> np.ndarray:
    src = _as_u8(data)
    cap = dst_cap if dst_cap is not None else len(src) + len(src) // 255 + 16
    dst = np.empty(cap, dtype=np.uint8)
    rc = _check(load().bt_lz4_compress_mm(_u8ptr(src), len(src), _u8ptr(dst),
                                          cap, min_match), "lz4_compress")
    return dst[:rc]


def lz4_decompress(data, dst_cap: int) -> np.ndarray:
    src = _as_u8(data)
    dst = np.empty(dst_cap, dtype=np.uint8)
    rc = _check(load().bt_lz4_decompress(_u8ptr(src), len(src), _u8ptr(dst), dst_cap),
                "lz4_decompress")
    return dst[:rc]


def snappy_compress(data, dst_cap: int | None = None, min_match: int = 4) -> np.ndarray:
    src = _as_u8(data)
    cap = dst_cap if dst_cap is not None else 32 + len(src) + len(src) // 6
    dst = np.empty(cap, dtype=np.uint8)
    rc = _check(load().bt_snappy_compress_mm(_u8ptr(src), len(src), _u8ptr(dst),
                                             cap, min_match), "snappy_compress")
    return dst[:rc]


def snappy_decompress(data, dst_cap: int | None = None) -> np.ndarray:
    """``dst_cap`` None: the length the stream's preamble names."""
    src = _as_u8(data)
    if dst_cap is None:
        dst_cap = _check(load().bt_snappy_uncompressed_len(_u8ptr(src), len(src)),
                         "snappy_uncompressed_len")
    dst = np.empty(max(1, dst_cap), dtype=np.uint8)
    rc = _check(load().bt_snappy_decompress(_u8ptr(src), len(src), _u8ptr(dst), dst_cap),
                "snappy_decompress")
    return dst[:rc]


def zstd_compress(data, dst_cap: int | None = None) -> np.ndarray:
    """A zstd frame (``zstd.cc``: greedy matching with repeat offsets; the
    literals stored raw, as one RLE byte when uniform, or Huffman-coded
    with direct 4-bit weights when that is smaller; sequences under the
    predefined FSE tables; an incompressible block is stored raw)."""
    src = _as_u8(data)
    cap = dst_cap if dst_cap is not None else len(src) + len(src) // 255 + 64
    dst = np.empty(max(1, cap), dtype=np.uint8)
    rc = _check(load().bt_zstd_compress(_u8ptr(src), len(src), _u8ptr(dst), cap),
                "zstd_compress")
    return dst[:rc]


def zstd_decompress(data, dst_cap: int) -> np.ndarray:
    src = _as_u8(data)
    dst = np.empty(max(1, dst_cap), dtype=np.uint8)
    rc = _check(load().bt_zstd_decompress(_u8ptr(src), len(src), _u8ptr(dst), dst_cap),
                "zstd_decompress")
    return dst[:rc]


def zstd_parse(data, max_seq: int | None = None, lit_cap: int | None = None):
    """The sequence table of a zstd frame and its entropy-decoded literals:
    (columns as :func:`parse_sequences` gives them, literals uint8).  Here
    ``lit_ptr`` indexes the literals, not the compressed stream."""
    src = _as_u8(data)
    if max_seq is None:
        max_seq = max(16, len(src) * 2 + 16)
    if lit_cap is None:
        lit_cap = max(64, len(src) * 16 + 1024)
    cols = {k: np.zeros(max_seq, dtype=np.int32) for k in SEQUENCE_KEYS}
    lit_buf = np.empty(lit_cap, dtype=np.uint8)
    lit_used = np.zeros(1, dtype=np.int32)
    rc = _check(load().bt_zstd_parse(
        _u8ptr(src), len(src), max_seq, _u8ptr(lit_buf), lit_cap, _i32ptr(lit_used),
        *(_i32ptr(cols[k]) for k in SEQUENCE_KEYS)), "zstd_parse")
    return {k: v[:rc] for k, v in cols.items()}, lit_buf[:int(lit_used[0])]


def batch_run(compress: bool, src: np.ndarray, src_off: np.ndarray,
              src_len: np.ndarray, dst: np.ndarray, dst_off: np.ndarray,
              dst_cap: np.ndarray, codec_ids: np.ndarray, nthreads: int = 0,
              min_match: int = 4):
    """Multithreaded batch (de)compress over packed byte arrays, one codec
    id per block.  Returns (dst_len int32, status int32); per-block
    failures are in ``status``, never raised."""
    n = int(src_len.shape[0])
    dst_len = np.ascontiguousarray(dst_cap, dtype=np.int32).copy()
    status = np.zeros(n, dtype=np.int32)
    src_off = np.ascontiguousarray(src_off, dtype=np.int64)
    dst_off = np.ascontiguousarray(dst_off, dtype=np.int64)
    src_len = np.ascontiguousarray(src_len, dtype=np.int32)
    ids = np.ascontiguousarray(codec_ids, dtype=np.int32)
    args = (0, _i32ptr(ids), _nthreads(nthreads), n,
            _u8ptr(src), _i64ptr(src_off), _i32ptr(src_len),
            _u8ptr(dst), _i64ptr(dst_off), _i32ptr(dst_len), _i32ptr(status))
    if compress:
        load().bt_batch_compress(*args, min_match)
    else:
        load().bt_batch_decompress(*args)
    return dst_len, status


def _dense_bufs(n: int, nrows: int, dq_buf, ra_buf):
    if dq_buf is None:
        dq_buf = np.zeros((n, nrows, 128), np.int16)
    if ra_buf is None:
        ra_buf = np.zeros((n, DENSE_PLANES, nrows), np.int32)
    if dq_buf.shape != (n, nrows, 128) or dq_buf.dtype != np.int16:
        raise StatusError(Status.Invalid(f"dq_buf {dq_buf.shape} {dq_buf.dtype}"))
    if ra_buf.shape != (n, DENSE_PLANES, nrows) or ra_buf.dtype != np.int32:
        raise StatusError(Status.Invalid(f"ra_buf {ra_buf.shape} {ra_buf.dtype}"))
    return dq_buf, ra_buf


def plan_batch_flat(src: np.ndarray, src_off: np.ndarray, src_len: np.ndarray,
                    out_len: np.ndarray, codec_ids: np.ndarray, nrows: int,
                    max_passes: int, cb: int, split_limit: int = 128,
                    nthreads: int = 0, band_rows: int = 0, band_tile: int = 0):
    """Batched parse+plan into dense per-block wire buffers.

    Returns (se [n, max_passes, nrows] int16, shift int32, p_used [n], p0
    [n], status [n], lit_used [n], dq [n, nrows, 128] int16, row_a [n,
    DENSE_PLANES, nrows] int32, dense [n]); the same call and results as
    ``bitar_tpu.ops.cpu.native.plan_batch_flat`` without zstd literal
    planes.  Only tests call it; the engine plans through
    :func:`plan_batch_begin`."""
    n = int(src_len.shape[0])
    se = np.zeros((n, max_passes, nrows), np.int16)
    shift = np.zeros((n, max_passes, nrows), np.int32)
    p_used = np.zeros(n, np.int32)
    p0 = np.zeros(n, np.int32)
    status = np.zeros(n, np.int32)
    lit_used = np.zeros(n, np.int32)
    dq, row_a = _dense_bufs(n, nrows, None, None)
    dense = np.zeros(n, np.int32)
    load().bt_plan_batch(
        0, _i32ptr(np.ascontiguousarray(codec_ids, np.int32)), _nthreads(nthreads), n,
        _u8ptr(src), _i64ptr(np.ascontiguousarray(src_off, np.int64)),
        _i32ptr(np.ascontiguousarray(src_len, np.int32)),
        _i32ptr(np.ascontiguousarray(out_len, np.int32)),
        nrows, max_passes, split_limit, cb, band_rows, band_tile,
        _i16ptr(se), _i32ptr(shift), _i32ptr(p_used), _i32ptr(p0), _i32ptr(status),
        None, 0, _i32ptr(lit_used), _i16ptr(dq), _i32ptr(row_a), _i32ptr(dense))
    return se, shift, p_used, p0, status, lit_used, dq, row_a, dense


_CODEC_INT = {"lz4": 0, "snappy": 1, "zstd": 2, "raw": 3}


def plan_block(data, out_len: int, nrows: int, max_passes: int = 32, codec: str = "lz4"):
    """The scheduled decode plan of one LZ4 or Snappy block (``bt_plan_block``).

    Returns (P, p0, cols) where ``cols`` holds r_dstart/r_dend/r_shift of
    shape [max_passes, nrows] int32; passes [0, p0) read the comp plane and
    [p0, P) the output plane.  Returns (None, None, None) when the block
    exceeds the pass budget.  The same call and results as
    ``bitar_tpu.ops.cpu.native.plan_block``."""
    src = _as_u8(data)
    cols = {k: np.zeros((max_passes, nrows), dtype=np.int32)
            for k in ("r_dstart", "r_dend", "r_shift")}
    pass_space = np.zeros(max_passes, dtype=np.int32)
    p0 = np.zeros(1, dtype=np.int32)
    rc = load().bt_plan_block(
        _CODEC_INT[codec], _u8ptr(src), len(src), out_len, nrows, max_passes,
        _i32ptr(cols["r_dstart"]), _i32ptr(cols["r_dend"]), _i32ptr(cols["r_shift"]),
        _i32ptr(pass_space), _i32ptr(p0))
    if rc == -6:  # CAPACITY: pass budget exceeded
        return None, None, None
    _check(rc, "plan_block")
    return rc, int(p0[0]), cols


def plan_frags(data, out_len: int, codec: str = "lz4",
               split_limit: int = 2) -> dict[str, np.ndarray]:
    """The planner's fragment list of one block, for analysis: int32
    columns dst, len, shift, space (0 comp, 1 out, 2 row fill) and aux."""
    src = _as_u8(data)
    cap = out_len + 64
    names = ("dst", "len", "shift", "space", "aux")
    cols = {k: np.zeros(cap, np.int32) for k in names}
    n = _check(load().bt_plan_frags(_CODEC_INT[codec], _u8ptr(src), len(src), out_len,
                                    split_limit, cap, *(_i32ptr(cols[k]) for k in names)),
               "plan_frags")
    if n > cap:
        raise StatusError(Status.CapacityError(f"fragment count {n} > cap {cap}"))
    return {k: v[:n] for k, v in cols.items()}


def set_split_limit(v: int) -> None:
    """The planner's comp-resolution split limit (at least 1; default 2).
    Thread-local: it applies to the calling thread's later
    :func:`plan_block` calls; the batch planners take ``split_limit`` per
    call."""
    load().bt_set_split_limit(int(v))


#: The planner's phases, in the order ``bt_plan_prof_get`` writes them;
#: d_collect and d_write are parts of densify.
PLAN_PHASES = ("parse", "build", "densify", "schedule", "emit", "pack",
               "d_collect", "d_write")


def plan_prof(reset: bool = True) -> dict[str, float]:
    """The planner's time by phase in ms since the last reset, summed over
    its worker threads (so a phase may exceed the wall time)."""
    buf = np.zeros(len(PLAN_PHASES), np.int64)
    load().bt_plan_prof_get(_i64ptr(buf), 1 if reset else 0)
    return {k: int(v) / 1e6 for k, v in zip(PLAN_PHASES, buf, strict=True)}


def plan_batch_begin(src: np.ndarray, src_off: np.ndarray, src_len: np.ndarray,
                     out_len: np.ndarray, codec_ids: np.ndarray, nrows: int,
                     max_passes: int, cb: int, split_limit: int = 128,
                     nthreads: int = 0, lit_out: np.ndarray | None = None,
                     lit_stride: int = 0, band_rows: int = 0, band_tile: int = 0,
                     dq_buf: np.ndarray | None = None,
                     ra_buf: np.ndarray | None = None):
    """Phase 1 of the compact two-phase planner: plans every block into a
    native context.  Returns (ctx, p_used, p0, status, lit_used, dq, row_a,
    dense); pass ctx to :func:`plan_batch_pack` or :func:`plan_batch_abort`.
    ``lit_out`` (flat ``[n * lit_stride]`` uint8) receives each zstd
    block's entropy-decoded literal plane; ``lit_used[i] > 0`` marks a block
    whose plan reads that plane instead of its compressed bytes.
    ``dq_buf``/``ra_buf`` may be dirty: the planner defines every plane of
    a block it reports dense (plan.cc Densify)."""
    n = int(src_len.shape[0])
    p_used = np.zeros(n, np.int32)
    p0 = np.zeros(n, np.int32)
    status = np.zeros(n, np.int32)
    lit_used = np.zeros(n, np.int32)
    dq, row_a = _dense_bufs(n, nrows, dq_buf, ra_buf)
    dense = np.zeros(n, np.int32)
    ctx = load().bt_plan_batch_begin(
        0, _i32ptr(np.ascontiguousarray(codec_ids, np.int32)), _nthreads(nthreads), n,
        _u8ptr(src), _i64ptr(np.ascontiguousarray(src_off, np.int64)),
        _i32ptr(np.ascontiguousarray(src_len, np.int32)),
        _i32ptr(np.ascontiguousarray(out_len, np.int32)),
        nrows, max_passes, split_limit, cb, band_rows, band_tile,
        _i32ptr(p_used), _i32ptr(p0), _i32ptr(status),
        _u8ptr(lit_out) if lit_out is not None else None, lit_stride,
        _i32ptr(lit_used), _i16ptr(dq), _i32ptr(row_a), _i32ptr(dense))
    return ctx, p_used, p0, status, lit_used, dq, row_a, dense


def plan_batch_pack(ctx, p_off: np.ndarray, se: np.ndarray, shift: np.ndarray,
                    nthreads: int = 0) -> None:
    """Phase 2: copy each block's plan rows to pass-row offset ``p_off[i]``
    of the flat wire ``se``/``shift`` and free the context."""
    load().bt_plan_batch_pack(
        ctx, _nthreads(nthreads), _i64ptr(np.ascontiguousarray(p_off, np.int64)),
        _i16ptr(se), _i32ptr(shift))


def plan_batch_abort(ctx) -> None:
    """Free a :func:`plan_batch_begin` context without packing."""
    load().bt_plan_batch_abort(ctx)


def plan_dense_pack(sel: np.ndarray, dq_src: np.ndarray, dq_dst: np.ndarray,
                    ra_src: np.ndarray, ra_dst: np.ndarray, nrows: int,
                    dcap: int, ndense: np.ndarray, nthreads: int = 0) -> None:
    """Threaded compaction + re-layout of dense planes: dq_dst[j] =
    dq_src[sel[j]]; ra_dst[j] = block sel[j]'s first dcap anchor planes in
    the kernel's [dcap, 128, tiles] column layout."""
    load().bt_plan_dense_pack(
        _nthreads(nthreads), int(sel.shape[0]),
        _i64ptr(np.ascontiguousarray(sel, np.int64)),
        _i16ptr(dq_src), _i16ptr(dq_dst), _i32ptr(ra_src), _i32ptr(ra_dst),
        nrows, ra_src.shape[1], dcap,
        _i32ptr(np.ascontiguousarray(ndense, np.int32)))


def parse_sequences(data, codec: str = "lz4", max_seq: int | None = None
                    ) -> dict[str, np.ndarray]:
    """The sequence table of one LZ4 or Snappy block: int32 columns
    lit_ptr, lit_len, off, mlen, out_pos of length nseq (``bt_lz4_parse``
    / ``bt_snappy_parse``).  Raises StatusError on a malformed block."""
    src = _as_u8(data)
    if max_seq is None:
        max_seq = max(16, len(src) + 1)
    cols = {k: np.zeros(max_seq, dtype=np.int32) for k in SEQUENCE_KEYS}
    fn = load().bt_lz4_parse if codec == "lz4" else load().bt_snappy_parse
    rc = _check(fn(_u8ptr(src), len(src), max_seq,
                   *(_i32ptr(cols[k]) for k in SEQUENCE_KEYS)), f"{codec}_parse")
    return {k: v[:rc] for k, v in cols.items()}


def set_emit_min_match(v: int) -> None:
    """Minimum match length the hint-driven emitters accept (at least 4).
    Thread-local: it applies to the calling thread's later
    ``*_emit_sequences`` calls."""
    load().bt_set_emit_min_match(int(v))


def lz4_emit_sequences(data, mlen: np.ndarray, off_idx: np.ndarray, offsets,
                       dst_cap: int | None = None) -> np.ndarray:
    """An LZ4 block from device match hints, every hint verified on emit."""
    return _emit_sequences("lz4", data, mlen, off_idx, offsets, dst_cap)


def snappy_emit_sequences(data, mlen: np.ndarray, off_idx: np.ndarray, offsets,
                          dst_cap: int | None = None) -> np.ndarray:
    """A Snappy block from the same codec-agnostic hints."""
    return _emit_sequences("snappy", data, mlen, off_idx, offsets, dst_cap)


def _emit_sequences(codec: str, data, mlen, off_idx, offsets,
                    dst_cap: int | None) -> np.ndarray:
    """``offsets=None``: ``off_idx[i]`` is the offset itself; otherwise it
    indexes ``offsets``."""
    src = _as_u8(data)
    n = len(src)
    if dst_cap is None:
        dst_cap = n + n // 255 + 16
    dst = np.empty(dst_cap, dtype=np.uint8)
    mlen = np.ascontiguousarray(mlen[:n], dtype=np.int32)
    off_idx = np.ascontiguousarray(off_idx[:n], dtype=np.int32)
    if offsets is None:
        offs_ptr, noffs = None, 0
    else:
        offs = np.ascontiguousarray(offsets, dtype=np.int32)
        offs_ptr, noffs = _i32ptr(offs), len(offs)
    fn = load().bt_lz4_emit_sequences if codec == "lz4" else load().bt_snappy_emit_sequences
    rc = _check(fn(_u8ptr(src), n, _i32ptr(mlen), _i32ptr(off_idx), offs_ptr, noffs,
                   _u8ptr(dst), dst_cap), f"{codec}_emit_sequences")
    return dst[:rc]
