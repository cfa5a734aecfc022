"""Host ms of a step's decode inside the program: the mean of its
``bitar.engine.decompress_blocks_device`` spans in the profiled stretch.  A
program without the span (one without block-granular decode) reads None."""

from benchmark.trace.program import annotation_mean_ms


def read(readings):
    durs = [m for r in readings
            if (m := annotation_mean_ms(r, "bitar.engine.decompress_blocks_device")) is not None]
    return sum(durs) / len(durs) if durs else None
