"""The useful share of the MultiGet's arena gather, in %: the stored bytes
of the picked blocks over the whole slots copied for the table decode (the
program's counters ``arena.gather_stored_bytes`` and ``arena.gather_bytes``,
summed over the traced stretches of the process that ran the cell)."""

from benchmark.trace.program import counters


def read(readings):
    c = counters()
    if not c or not c.get("arena.gather_bytes"):
        return None
    return 100.0 * c.get("arena.gather_stored_bytes", 0) / c["arena.gather_bytes"]
