"""The share of the scan's decoded blocks that B1 launched from a launch
record an earlier launch built (the engine keeps one a burst of each
resident unit), in %: the program's counters ``decode_flat.prepared_blocks``
over ``decode_flat.blocks``, summed over the traced stretches of the process
that ran the scan.  A program that keeps no such record (an older checkout)
has no such counter: None."""

from benchmark.trace.program import counters


def read(readings):
    c = counters()
    if not c or "decode_flat.prepared_blocks" not in c or not c.get("decode_flat.blocks"):
        return None
    return 100.0 * c["decode_flat.prepared_blocks"] / c["decode_flat.blocks"]
