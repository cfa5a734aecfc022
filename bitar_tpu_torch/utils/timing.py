"""Device timing with CUDA events.

PyTorch returns before the device finishes, so a host clock around CUDA
work measures the enqueue; ``device_time_ms`` times a run of launches with
CUDA events on the current stream instead.
"""

from __future__ import annotations

import torch

from ..status import Status, StatusError


def device_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` back-to-back
    calls, from CUDA events on the current stream (after ``warmup`` calls).
    Raises without CUDA: a device time is never taken on the CPU."""
    if not torch.cuda.is_available():
        raise StatusError(Status.Invalid("device_time_ms needs a CUDA device"))
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
