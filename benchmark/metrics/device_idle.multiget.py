"""The device's idle share of the MultiGet's profiled window, in %: one less
the union of its kernel, memcpy and memset intervals over the window."""

from benchmark.trace.device import idle_pct as read  # noqa: F401
