"""B1's share of its roofline in the read, both routes (the tall route's slice
and cluster kernels together): the decode's bytes (stored + raw of the blocks
decoded) at the card's peak over B1's device time, in %."""

from benchmark.trace.device import b1_roofline as read  # noqa: F401
