"""Host ms of a fused shuffle step inside the program: the mean of its
``bitar.parallel.distributed_step_flat`` spans in the profiled stretch, on
the rank where it is largest."""

from benchmark.trace.program import annotation_mean_ms


def read(readings):
    means = [m for r in readings
             if (m := annotation_mean_ms(r, "bitar.parallel.distributed_step_flat")) is not None]
    return max(means) if means else None
