"""ctypes bindings to the host codec library, for the calls the port needs.

The library is the JAX package's own C++ (``bitar_tpu/ops/cpu/*.cc``: the
LZ4/Snappy/Zstd codecs, the batch engine and the batch planner
``bt_plan_batch*``), compiled by path with g++ into the port's build
directory.  The sources are shared, never forked, so both packages plan and
code the same bytes; nothing of the ``bitar_tpu`` Python package is
imported.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

from ...status import Status, StatusError
from .._build import build_library

SRC_DIR = Path(__file__).resolve().parents[3] / "bitar_tpu" / "ops" / "cpu"
_SOURCES = ["lz4.cc", "snappy.cc", "zstd.cc", "batch.cc", "plan.cc"]
_ABI_VERSION = 6
DENSE_PLANES = 64     # row_a anchor planes per block (plan.cc kDenseMax)

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
    lib.bt_lz4_compress_mm.restype = c_int
    lib.bt_lz4_compress_mm.argtypes = [_u8p, c_int, _u8p, c_int, c_int]
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
    lib.bt_plan_dense_pack.restype = None
    lib.bt_plan_dense_pack.argtypes = [
        c_int, c_int, _i64p, _i16p, _i16p, _i32p, _i32p, c_int, c_int, c_int, _i32p]
    lib.bt_abi_version.restype = c_int
    lib.bt_abi_version.argtypes = []
    return lib


def load() -> ctypes.CDLL:
    """Load (building if needed) the host library; thread-safe, idempotent."""
    global _lib
    with _lock:
        if _lib is None:
            # Every header joins the build hash, so a header-only change
            # rebuilds instead of loading a stale library.
            headers = sorted(SRC_DIR.glob("*.h"))
            path = build_library(
                "bitar_host", [SRC_DIR / s for s in _SOURCES] + headers, _command)
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
    ``bitar_tpu.ops.cpu.native.plan_batch_flat`` (zstd literal planes are
    not requested: the port does not decode zstd on the device yet).  Only
    tests call it; the engine plans through :func:`plan_batch_begin`."""
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


def plan_batch_begin(src: np.ndarray, src_off: np.ndarray, src_len: np.ndarray,
                     out_len: np.ndarray, codec_ids: np.ndarray, nrows: int,
                     max_passes: int, cb: int, split_limit: int = 128,
                     nthreads: int = 0, band_rows: int = 0, band_tile: int = 0,
                     dq_buf: np.ndarray | None = None,
                     ra_buf: np.ndarray | None = None):
    """Phase 1 of the compact two-phase planner: plans every block into a
    native context.  Returns (ctx, p_used, p0, status, lit_used, dq, row_a,
    dense); pass ctx to :func:`plan_batch_pack` or :func:`plan_batch_abort`.
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
        None, 0, _i32ptr(lit_used), _i16ptr(dq), _i32ptr(row_a), _i32ptr(dense))
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
