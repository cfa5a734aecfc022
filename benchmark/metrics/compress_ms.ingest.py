"""Host ms of ``Engine.compress`` a unit: the benchmark's span around it, mean
over the window."""

from benchmark.trace.device import span_mean_ms


def read(readings):
    return span_mean_ms(readings, "compress")
