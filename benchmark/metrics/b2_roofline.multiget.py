"""B2's share of its roofline in the MultiGet: the decode's bytes (stored +
raw of the blocks decoded in the profiled stretch) at the card's peak over
the device time of ``decode_tables_kernel`` (``csrc/decode_tables.cu``), in %."""

from benchmark.trace.device import kernel_s
from benchmark.trace.roofline import decode_bytes, share_pct

B2 = "decode_tables_kernel"


def read(readings):
    r = readings[0]
    c = r["counts"]
    return share_pct(decode_bytes(c.get("stored_bytes", 0), c.get("raw_bytes", 0)),
                     kernel_s(r["events"], B2), r["kind"])
