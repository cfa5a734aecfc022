"""B1's share of its roofline in the scan: the decode's bytes (stored + raw
of the blocks decoded) at the card's peak over B1's device time, in %."""

from benchmark.trace.device import b1_roofline as read  # noqa: F401
