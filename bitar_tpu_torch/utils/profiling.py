"""Profiling hooks: the program's spans and counters, and a device trace.

Counterpart of ``bitar_tpu/utils/profiling.py``.  The reference has no
tracer, only per-phase timestamps (``demo_app.cc:82-89``); here the same
per-phase reporting (``utils.timing``) plus:

* :func:`annotate`, the program's one span primitive.  A span is on exactly
  while a ``torch.profiler`` records in this process (any profiler: a
  benchmark's traced stretch, :func:`device_trace`, an operator's own); off,
  it costs one check and allocates nothing.  On, it is
  ``torch.profiler.record_function``: a ``user_annotation`` in the
  profiler's trace, on the clock of the device records, whose calls and
  times ``prof.key_averages()`` sums by name.  Under
  ``torch.autograd.profiler.emit_nvtx()`` it is also an NVTX range.
* :func:`count`, a counter beside the spans, on under the same condition.
* :func:`snapshot`, the counters, for an operator or a benchmark to read.

The program's spans are named ``bitar.<module>.<step>``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

from .logging import get_logger

logger = get_logger("utils.profiling")

_LOCK = threading.Lock()
_COUNTERS: dict[str, int] = {}
_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """True while a ``torch.profiler`` records in this process: spans and
    counters are on.  A call site computes a counter's value only then."""
    return _autograd_profiler._is_profiler_enabled


def annotate(name: str):
    """A span named ``name`` around a ``with`` block (see the module
    docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        with _LOCK:
            _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def snapshot(reset: bool = False) -> dict[str, int]:
    """The counters, ``{name: n}``, summed over every traced stretch of this
    process (since the last ``reset``)."""
    with _LOCK:
        snap = dict(_COUNTERS)
        if reset:
            _COUNTERS.clear()
    return snap


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """Capture a ``torch.profiler`` trace around a region.

    Enabled by passing ``log_dir`` or setting ``BITAR_TPU_TRACE_DIR``;
    otherwise a no-op that yields None.  Records the CPU activity of every
    thread (the readback pool's spans too, where this PyTorch can), and the
    CUDA activity when CUDA is initialized; writes one Chrome trace
    (``trace-<pid>-<ns>.json``, for ``chrome://tracing`` or Perfetto) into
    the directory and yields the directory."""
    log_dir = log_dir or os.environ.get("BITAR_TPU_TRACE_DIR")
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    kw = {}
    try:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except TypeError:            # a PyTorch that profiles only the starting thread
        pass
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities, **kw) as prof:
        yield log_dir
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s", path)
