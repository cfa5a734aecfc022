"""Spans the benchmark records around its calls into the program.

A span is a name and a host-clock duration; in a traced run it is also a
``torch.profiler.record_function`` range, so the profiler's trace shows what
the host was doing while the device sat idle.  With tracing off a span
records nothing and costs one branch.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Spans:
    """Durations by span name, kept in memory until the run ends."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.seconds: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.seconds[name].append(time.perf_counter() - t0)
