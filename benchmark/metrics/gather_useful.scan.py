"""The useful share of the arena gather's bytes, in %: the stored bytes of
the blocks gathered over the whole slots copied (the program's counters
``arena.gather_stored_bytes`` and ``arena.gather_bytes``, summed over the
traced stretches of the process that ran the scan)."""

from benchmark.trace.program import counters


def read(readings):
    c = counters()
    if not c or not c.get("arena.gather_bytes"):
        return None
    return 100.0 * c.get("arena.gather_stored_bytes", 0) / c["arena.gather_bytes"]
