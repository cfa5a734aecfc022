"""Benchmark phase timing, device timing with CUDA events, with the profiler,
and the host's cost of a call.

``PhaseTiming`` and ``time_phase`` are the CLI's per-phase reporting (the
counterparts of ``bitar_tpu/utils/timing.py``): a host clock around each
run, ended by a synchronize of the device of the CUDA tensors a run
returns, as the reference ends its window at the callback
(``demo_app.cc:376``).

PyTorch returns before the device finishes, so a host clock around CUDA
work measures the enqueue; ``device_time_ms`` times a run of launches with
CUDA events on the current stream instead.  When a wrapper spends more host
time per call than its kernel takes, back-to-back launches leave the device
idle between them and the events time the host: ``kernel_time_ms`` reads
the kernel's own duration from ``torch.profiler`` (CUPTI), and
``host_us_per_call`` the host's time per call.  All three raise without
CUDA: a device time is never taken on the CPU.  ``bound_ms`` is the least
time the card could take for a given work, the bound every timing is held
against.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..status import Status, StatusError
from .logging import get_logger

logger = get_logger("utils.timing")

NUM_BENCH_RUNS = 3  # reference kNumTests (demo_app.h:45)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
INT32_OPS_PER_S = 33.5e12     # 132 SMs x 128 lanes x 1.98 GHz, one op per lane per cycle
PROFILE_PAD_S = 0.02          # idle host seconds at each end of a profiled window
#: Profiled windows before kernel_time_ms gives up: windows lose their
#: records for a cause not found, several running at times.
PROFILE_TRIES = 10
#: kernel_time_ms's profiled windows in this process, and how many of them
#: recorded none of the kernels asked for.
profiled_windows = {"windows": 0, "lost": 0}


@dataclass
class PhaseTiming:
    name: str
    bytes_processed: int
    seconds: list[float] = field(default_factory=list)

    @property
    def best(self) -> float:
        return min(self.seconds) if self.seconds else float("inf")

    @property
    def mean(self) -> float:
        return sum(self.seconds) / len(self.seconds) if self.seconds else float("inf")

    def gbps(self, which: str = "best") -> float:
        """Throughput in gigabytes/second (decimal GB, like the reference's
        Gbps print normalized to bytes)."""
        secs = self.best if which == "best" else self.mean
        if secs <= 0:
            return 0.0
        return self.bytes_processed / secs / 1e9

    def report(self) -> str:
        us = [f"{s * 1e6:,.0f}" for s in self.seconds]
        return (f"{self.name}: runs(us)=[{', '.join(us)}] best={self.best * 1e6:,.0f}us "
                f"throughput={self.gbps():.3f} GB/s over {self.bytes_processed:,} bytes")


def time_phase(name: str, bytes_processed: int, fn, runs: int = NUM_BENCH_RUNS,
               sync: bool = True) -> PhaseTiming:
    """Run ``fn`` ``runs`` times, timing each on the host clock (the first
    run may include kernel builds).  With ``sync``, each run's clock stops
    after ``torch.cuda.synchronize`` of the device of every CUDA tensor
    ``fn`` returned (a tensor, or a list or tuple of them); CPU outputs need
    none."""
    timing = PhaseTiming(name=name, bytes_processed=bytes_processed)
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        if sync and out is not None:
            for t in out if isinstance(out, (list, tuple)) else (out,):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    torch.cuda.synchronize(t.device)
        timing.seconds.append(time.perf_counter() - t0)
    return timing


def bound_ms(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    """Least ms on an H100 SXM for ``nbytes`` of device traffic and ``ops``
    int32 operations, and which of the two sets it (``"bytes"`` or
    ``"operations"``)."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"


def _need_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise StatusError(Status.Invalid(f"{what} needs a CUDA device"))


def device_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` back-to-back
    calls, from CUDA events on the current stream (after ``warmup`` calls).
    Raises without CUDA: a device time is never taken on the CPU."""
    _need_cuda("device_time_ms")
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


def kernel_time_ms(fn, reps: int, name: str, warmup: int = 1) -> float:
    """Device milliseconds of the kernels whose name contains ``name``, over
    ``reps`` calls of ``fn`` under ``torch.profiler`` (CUDA activity only):
    the mean duration of each such kernel, summed over the kernels of
    different names (a call that launches two kernels, as B1's tall route
    does, counts both), without the gaps that the host leaves between
    launches.

    The profiler keeps only device records that fall inside its window on
    the host's clock, and CUPTI's clock is converted to that one; so the
    window is padded with ``PROFILE_PAD_S`` of idle host time at each end.
    A window has been seen to keep no record of the kernels, several
    windows running at times, for a cause not found: not the profiler's
    ``acc_events`` warning (torch 2.11 gives it on the first window of every
    process, as it tests the profiler it has just made), and not the pad
    (windows padded 0.5 s lost theirs too).  Such a window is counted in
    ``profiled_windows``, logged with what it did record, and profiled
    again, up to ``PROFILE_TRIES`` windows.  Raises without CUDA, and when
    no window saw such a kernel."""
    _need_cuda("kernel_time_ms")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        mean_us, count = 0.0, 0
        profiled_windows["windows"] += 1
        averages = prof.key_averages()
        for e in averages:
            if name in e.key and e.count:
                t = getattr(e, "device_time_total", None)    # cuda_time_total before torch 2.4
                mean_us += float(t if t is not None else e.cuda_time_total) / e.count
                count += e.count
        if count:
            return mean_us / 1e3
        profiled_windows["lost"] += 1
        logger.warning("kernel_time_ms: no kernel named like %r in a window; it recorded %d "
                       "records of other names %s", name, sum(e.count for e in averages),
                       sorted(e.key[:40] for e in averages)[:4])
    raise StatusError(Status.IOError(
        f"kernel_time_ms: no kernel named like {name!r} ran under the profiler "
        f"in {PROFILE_TRIES} windows"))


def host_us_per_call(fn, calls: int, warmup: int = 1) -> float:
    """Host microseconds per call of ``fn``: a host clock over ``calls``
    back-to-back calls with no synchronize, divided by the count (the
    device is synchronized before the clock starts and after it stops).
    Raises without CUDA."""
    _need_cuda("host_us_per_call")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls
