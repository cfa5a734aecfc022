"""Profiling hooks.

Counterpart of ``bitar_tpu/utils/profiling.py``.  The reference has no
tracer, only per-phase timestamps (``demo_app.cc:82-89``); here the same
per-phase reporting (``utils.timing``) plus ``torch.profiler`` traces for
device timelines, gated behind an argument or an environment variable so
that production paths pay nothing.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .logging import get_logger

logger = get_logger("utils.profiling")


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """Capture a ``torch.profiler`` trace around a region.

    Enabled by passing ``log_dir`` or setting ``BITAR_TPU_TRACE_DIR``;
    otherwise a no-op that yields None.  Records the CPU activity, and the
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
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the trace (``torch.profiler.record_function``, and an
    NVTX range when CUDA is available) plus a debug log of its wall time."""
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
    logger.debug("%s: %.3f ms", name, (time.perf_counter() - t0) * 1e3)
