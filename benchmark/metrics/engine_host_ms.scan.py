"""Host ms of a scan inside the program: the mean of its
``bitar.engine.decompress_device`` spans in the profiled stretch."""

from benchmark.trace.program import annotation_mean_ms


def read(readings):
    durs = [m for r in readings
            if (m := annotation_mean_ms(r, "bitar.engine.decompress_device")) is not None]
    return sum(durs) / len(durs) if durs else None
