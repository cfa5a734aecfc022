"""Fixtures of the benchmark's CPU tests: any cell at a size the CPU holds.

The tests run the cells' own loops through the port's plain PyTorch versions
(``device="cpu"``): 16 KiB blocks (the smallest a flat plan takes), three
units of eight blocks, two ranks of gloo for the shuffle.
"""

from __future__ import annotations

import copy
import json

import pytest
import torch

from benchmark import harness


#: BENCHMARK.json with the held-back cells: the CPU tests run every loop.
ALL = harness.with_held_back(json.loads((harness.ROOT / "BENCHMARK.json").read_text()))


def tiny_config(config: dict) -> dict:
    c = copy.deepcopy(config)
    c["engine"].update(block_size=16384)
    if "burst_size" in c["engine"]:
        c["engine"].update(burst_size=8, max_pool_slots=64)
    c["data"].update(units=3, unit_blocks=8)
    if c["data"]["generator"] == "skewed":
        c["data"]["min_size"] = 1024
    if "world" in c:
        c["world"] = 2
        c["data"].update(units=2, unit_blocks=8)
    return c


@pytest.fixture
def tiny():
    """``tiny(workload, seconds=1.0, trace=False, **ctx)`` -> (spec, Context)."""
    def make(workload: str, seconds: float = 1.0, trace: bool = False, **kw):
        spec = harness.resolve(workload, spec=ALL)
        spec["config"] = tiny_config(spec["config"])
        ctx = harness.Context(cell=spec["cell"], config=spec["config"], traffic=spec["traffic"],
                              seed=kw.pop("seed", 2**31 + 17), seconds=seconds, trace=trace,
                              device="cpu", **kw)
        return spec, ctx
    return make


@pytest.fixture
def card():
    """The number of CUDA cards; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.device_count()
