"""The literal-plane bytes B2 read from the engine's literal store for each
stored Zstd byte of the same blocks: the program's counters
``decode_tables.lit_bytes`` over ``decode_tables.lit_stored_bytes``, summed
over the traced stretches of the process that ran the cell.  A program
without a literal store (an older checkout) has no such counter: None."""

from benchmark.trace.program import counters


def read(readings):
    c = counters()
    if not c or not c.get("decode_tables.lit_stored_bytes"):
        return None
    return c.get("decode_tables.lit_bytes", 0) / c["decode_tables.lit_stored_bytes"]
