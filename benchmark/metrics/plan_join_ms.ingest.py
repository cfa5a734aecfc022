"""Host ms of ``Engine.ensure_plans`` a unit (the commit upload and the plan
join): the benchmark's span around it, mean over the window."""

from benchmark.trace.device import span_mean_ms


def read(readings):
    return span_mean_ms(readings, "ensure_plans")
