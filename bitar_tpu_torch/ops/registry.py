"""Host batch codec entry points (the native C++ batch engine).

Every codec, Zstd included, compresses and decompresses inside the
multithreaded C++ batch engine; each block carries its own codec id, so a
unit may mix codecs (RAW fallbacks among LZ4 blocks).
"""

from __future__ import annotations

import numpy as np

from ..config import Codec
from ..manifest import codec_id
from .cpu import native


def _ids(codec: Codec, n: int, codec_ids: np.ndarray | None) -> np.ndarray:
    if codec_ids is None:
        return np.full(n, codec_id(codec), dtype=np.int32)
    return codec_ids


def host_compress_batch(codec: Codec, level: int, src: np.ndarray,
                        src_off: np.ndarray, src_len: np.ndarray,
                        dst: np.ndarray, dst_off: np.ndarray,
                        dst_cap: np.ndarray, nthreads: int = 0,
                        codec_ids: np.ndarray | None = None,
                        min_match: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """Compress a batch of blocks on the host; returns (lengths, statuses).
    ``level`` is accepted for API parity: the native encoders have one
    strategy each."""
    del level
    return native.batch_run(
        True, src, src_off, src_len, dst, dst_off, dst_cap,
        _ids(codec, src_len.shape[0], codec_ids), nthreads=nthreads,
        min_match=min_match)


def host_decompress_batch(codec: Codec, src: np.ndarray, src_off: np.ndarray,
                          src_len: np.ndarray, dst: np.ndarray,
                          dst_off: np.ndarray, dst_cap: np.ndarray,
                          nthreads: int = 0,
                          codec_ids: np.ndarray | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Decompress a batch of blocks on the host; returns (lengths, statuses)."""
    return native.batch_run(
        False, src, src_off, src_len, dst, dst_off, dst_cap,
        _ids(codec, src_len.shape[0], codec_ids), nthreads=nthreads)
