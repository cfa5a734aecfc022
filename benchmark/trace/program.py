"""What the metric readers of the program's own spans and counters share.

The port (``bitar_tpu_torch.utils.profiling``) opens a span named
``bitar.<module>.<step>`` at each of its layer boundaries while a profiler
records, so in a traced run its spans are annotations of the profiled
stretch beside the benchmark's own, on the clock of the device records; its
counters are summed in the process that ran them.  A program that records
neither (an older checkout) makes each of these read None, never raise.
"""

from __future__ import annotations


def annotation_mean_ms(reading: dict, name: str) -> float | None:
    """Mean ms of the annotations named ``name`` in one rank's stretch."""
    durs = [dur for n, _, dur in reading["annotations"] if n == name]
    return sum(durs) / len(durs) / 1e3 if durs else None


def counters() -> dict | None:
    """The program's counters in this process (``profiling.snapshot()``),
    or None where the program has none."""
    try:
        from bitar_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    return snapshot() if snapshot is not None else None
