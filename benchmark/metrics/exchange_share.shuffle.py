"""The exchange's share of a fused step, in %, on the rank where it is
largest: from each step's staging gather to the end of its NCCL kernel, over
the rank's profiled window.  Where a rank's profiler kept no NCCL kernel,
its exchange alone timed by CUDA events (``exchange_event_ms``) over its
mean step time instead."""

from benchmark.trace.device import exchange_s


def read(readings):
    shares = []
    for r in readings:
        if not r["steps"] or r["window_s"] <= 0:
            return None
        ex = exchange_s(r["events"])
        if ex is None:
            if "exchange_event_ms" not in r["extra"]:
                return None
            ex = r["extra"]["exchange_event_ms"] / 1e3 * r["steps"]
        shares.append(100.0 * ex / r["window_s"])
    return max(shares) if shares else None
