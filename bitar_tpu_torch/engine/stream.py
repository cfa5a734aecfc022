"""Streams: the async dispatch layer.

Counterpart of ``bitar_tpu/engine/stream.py``.  A stream owns one worker
thread and runs one operation at a time on its engine:

* submitting to a busy stream fails at once with Invalid("... busy ...");
* the operation's ``Result`` goes to the caller's callback, and ``wait()``
  returns the callback's return value (``ASYNC_RETURN_OK`` without one, or
  the failure's status code).

The device work inside an operation is itself asynchronous (CUDA launches,
native codec threads), so several streams overlap host and device time.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..status import Result, Status, StatusError
from .device import CompressedUnit, Engine
from .driver import Driver

ASYNC_RETURN_OK = 2  # the value ``wait`` returns for a successful operation


@dataclass
class CompressParam:
    engine: Engine
    data: np.ndarray | bytes
    result_callback: Callable[["Stream", Result], int] | None = None


@dataclass
class DecompressParam:
    engine: Engine
    unit: CompressedUnit
    out: np.ndarray | None = None
    result_callback: Callable[["Stream", Result], int] | None = None


@dataclass
class Stream:
    """One async execution stream bound to an engine."""

    engine: Engine
    stream_id: int = 0
    _executor: ThreadPoolExecutor = field(default=None, repr=False)
    _pending: Future | None = field(default=None, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def __post_init__(self):
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"btt-stream-{self.stream_id}")

    def _submit(self, fn) -> Status:
        with self._lock:
            if self._pending is not None and not self._pending.done():
                return Status.Invalid(f"stream {self.stream_id} busy (outstanding operation)")
            self._pending = self._executor.submit(fn)
            return Status.OK()

    def _run(self, op, callback) -> int:
        try:
            result: Result = Result.ok(op())
        except StatusError as e:
            result = Result.error(e.status)
        if callback is not None:
            return callback(self, result)
        return ASYNC_RETURN_OK if result.is_ok() else result.status.to_int()

    def compress_async(self, param: CompressParam) -> Status:
        """Start ``param.engine.compress(param.data)`` on this stream."""
        return self._submit(lambda: self._run(
            lambda: param.engine.compress(param.data), param.result_callback))

    def decompress_async(self, param: DecompressParam) -> Status:
        """Start ``param.engine.decompress(param.unit, param.out)``."""
        return self._submit(lambda: self._run(
            lambda: param.engine.decompress(param.unit, param.out), param.result_callback))

    def wait(self) -> int:
        """Join the outstanding operation and return what its callback
        returned; 0 when the stream is idle."""
        with self._lock:
            fut = self._pending
        if fut is None:
            return 0
        rc = fut.result()
        with self._lock:
            if self._pending is fut:
                self._pending = None
        return rc

    def busy(self) -> bool:
        with self._lock:
            return self._pending is not None and not self._pending.done()

    def close(self) -> None:
        self._executor.shutdown(wait=True)


def make_streams(engines: list[Engine], num_streams: int) -> list[Stream]:
    """``num_streams`` streams round-robined over ``engines``."""
    placed = Driver.place_streams(num_streams, engines)
    return [Stream(engine=e, stream_id=i) for i, e in enumerate(placed)]


def wait_all(streams: list[Stream]) -> list[int]:
    """Join every stream; each one's ``wait()`` value."""
    return [s.wait() for s in streams]
