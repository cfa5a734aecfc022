"""B1's share of its roofline on the rows each rank received, on the slowest
rank: the decode's bytes (stored + raw of the blocks decoded) at the card's
peak over B1's device time, in %."""

from benchmark.trace.device import b1_roofline as read  # noqa: F401
