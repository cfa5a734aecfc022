"""The share of the scan's decoded blocks that B1 read where they lie in the
arena, in %: the program's counters ``arena.inplace_blocks`` over
``decode_flat.blocks``, summed over the traced stretches of the process that
ran the scan.  A program that reads no block in place (an older checkout,
which gathers every slot first) has no such counter: None."""

from benchmark.trace.program import counters


def read(readings):
    c = counters()
    if not c or "arena.inplace_blocks" not in c or not c.get("decode_flat.blocks"):
        return None
    return 100.0 * c["arena.inplace_blocks"] / c["decode_flat.blocks"]
