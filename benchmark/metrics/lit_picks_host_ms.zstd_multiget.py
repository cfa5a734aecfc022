"""Host ms of the Zstd picks inside a step's decode: the mean of the
program's ``bitar.engine.lit_picks`` spans in the profiled stretch (the
picks' slots, their upload and B2's wrapper over the literal store).  A
program without the span (one without a literal store) reads None."""

from benchmark.trace.program import annotation_mean_ms


def read(readings):
    durs = [m for r in readings
            if (m := annotation_mean_ms(r, "bitar.engine.lit_picks")) is not None]
    return sum(durs) / len(durs) if durs else None
