"""Benchmark phase timing, device timing with CUDA events, held device
timing, and the host's cost of a call.

``PhaseTiming`` and ``time_phase`` are the CLI's per-phase reporting (the
counterparts of ``bitar_tpu/utils/timing.py``): a host clock around each
run, ended by a synchronize of the device of the CUDA tensors a run
returns, as the reference ends its window at the callback
(``demo_app.cc:376``).

PyTorch returns before the device finishes, so a host clock around CUDA
work measures the enqueue; ``device_time_ms`` times a run of launches with
CUDA events on the current stream instead.  When a wrapper spends more host
time per call than its kernel takes, back-to-back launches leave the device
idle between them and the events time the host: ``kernel_time_ms`` queues
the calls behind a hold kernel (``csrc/hold.cu``) and releases them at
once, so the events time the device running them back to back, and
``host_us_per_call`` times the host per call.  All three raise without
CUDA: a device time is never taken on the CPU.  ``bound_ms`` is the least
time the card could take for a given work, the bound every timing is held
against.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass, field

import torch

from ..ops._build import check_cuda, load_cuda_kernel
from ..status import Status, StatusError

NUM_BENCH_RUNS = 3  # reference kNumTests (demo_app.h:45)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
INT32_OPS_PER_S = 33.5e12     # 132 SMs x 128 lanes x 1.98 GHz, one op per lane per cycle
#: Launches of the timed kernel that kernel_time_ms queues behind one hold.
#: CUDA's queue of pending launches holds about a thousand entries; once it
#: is full the host blocks while the device waits on the host.  The cap
#: leaves room for the events and for what a wrapper enqueues beside its
#: kernel.
HELD_LAUNCHES = 128
HOLD_TIMEOUT_S = 2.0          # device seconds a hold waits for its release


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


def held_rounds(reps: int, launches_per_call: int) -> list[int]:
    """The calls of each held round of ``kernel_time_ms``: ``reps`` split
    into rounds of at most ``HELD_LAUNCHES`` launches, one call at least."""
    per_round = max(1, HELD_LAUNCHES // max(1, launches_per_call))
    return [min(per_round, reps - i) for i in range(0, reps, per_round)]


def load_hold_kernel() -> ctypes.CDLL:
    """Build (at first use, for sm_90a) and load ``csrc/hold.cu``."""
    def bind(lib: ctypes.CDLL) -> None:
        vp = ctypes.c_void_p
        lib.bt_hold_alloc.restype = ctypes.c_int
        lib.bt_hold_alloc.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(vp)]
        lib.bt_hold_arm.restype = lib.bt_hold_release.restype = None
        lib.bt_hold_arm.argtypes = lib.bt_hold_release.argtypes = [vp]
        lib.bt_hold_gave_up.restype = ctypes.c_int
        lib.bt_hold_gave_up.argtypes = [vp]
        lib.bt_hold_launch.restype = ctypes.c_int
        lib.bt_hold_launch.argtypes = [vp, ctypes.c_ulonglong, ctypes.c_int, vp]
    return load_cuda_kernel("hold", bind)


_hold: tuple[ctypes.CDLL, int, int] | None = None   # library, host and device flags


def _hold_flags() -> tuple[ctypes.CDLL, int, int]:
    global _hold
    if _hold is None:
        lib = load_hold_kernel()
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        check_cuda(lib.bt_hold_alloc(ctypes.byref(host), ctypes.byref(dev)), "hold flags", lib)
        _hold = (lib, host.value, dev.value)
    return _hold


def _name(fn) -> str:
    code = getattr(fn, "__code__", None)
    where = f" ({code.co_filename}:{code.co_firstlineno})" if code else ""
    return f"{getattr(fn, '__qualname__', repr(fn))}{where}"


def kernel_time_ms(fn, reps: int, launches, warmup: int = 1) -> float:
    """Device milliseconds per call of ``fn`` over ``reps`` calls that the
    device runs back to back, with no profiler.  Each round of calls
    (``held_rounds``) is queued on the current stream behind the hold
    kernel, between two CUDA events, and released once queued: the events
    then time device work without the host's gaps between launches.  Every
    kernel a call enqueues counts: a wrapper's own fills or gathers, and
    both kernels of B1's and B7's tall routes.

    ``launches()`` reads the launch counter of the kernel that ``fn``
    launches (its wrapper's count).  The warm-up calls must raise it, which
    checks that ``fn`` launched that kernel, and their launches a call size
    the rounds.  Raises without CUDA, when the warm-up calls launched no
    such kernel, and when a hold gave up waiting for its release after
    ``HOLD_TIMEOUT_S``: then ``fn`` waited on the host (a synchronize, an
    ``.item()``, a pageable copy) or its launches filled CUDA's queue, and
    the time would not be the device's."""
    _need_cuda("kernel_time_ms")
    if reps < 1:
        raise StatusError(Status.Invalid(f"kernel_time_ms: reps {reps} must be positive"))
    warmup = max(1, warmup)
    before = launches()
    for _ in range(warmup):
        fn()
    per_call = -(-(launches() - before) // warmup)
    if per_call <= 0:
        raise StatusError(Status.Invalid(
            f"kernel_time_ms: {_name(fn)} launched no kernel of its counter in "
            f"{warmup} warm-up calls"))
    lib, host, dev = _hold_flags()
    stream = torch.cuda.current_stream()
    torch.cuda.synchronize()
    total = 0.0
    for calls in held_rounds(reps, per_call):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        lib.bt_hold_arm(host)
        check_cuda(lib.bt_hold_launch(dev, int(HOLD_TIMEOUT_S * 1e9), stream.device.index,
                                      stream.cuda_stream), "hold launch", lib)
        try:
            start.record(stream)
            for _ in range(calls):
                fn()
            end.record(stream)
        finally:
            lib.bt_hold_release(host)
            stream.synchronize()
        if lib.bt_hold_gave_up(host):
            raise StatusError(Status.IOError(
                f"kernel_time_ms: the hold gave up after {HOLD_TIMEOUT_S} s, before its "
                f"release: {_name(fn)} waits on the host (a synchronize, .item(), a pageable "
                f"copy), or {calls} calls of {per_call} launches filled CUDA's queue"))
        total += start.elapsed_time(end)
    return total / reps


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
