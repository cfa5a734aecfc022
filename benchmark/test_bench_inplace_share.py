"""The reader of ``inplace_share.scan``: the share of the scan's blocks B1
read in place, from the program's counters, and nothing where the program
counts none.

Run from the repository root: ``python -m pytest benchmark/``.
"""

from __future__ import annotations

import pytest

from benchmark import harness


@pytest.mark.parametrize("counters,want", [
    ({"arena.inplace_blocks": 8192, "decode_flat.blocks": 8192}, 100.0),
    ({"arena.inplace_blocks": 1024, "decode_flat.blocks": 4096}, 25.0),
    ({"decode_flat.blocks": 8192, "arena.gather_bytes": 1 << 31}, None),   # gathers: a parent
    ({"arena.inplace_blocks": 0, "decode_flat.blocks": 0}, None),
    ({}, None),
    (None, None),
])
def test_inplace_share_reads_the_programs_counters(monkeypatch, counters, want):
    import benchmark.trace.program as prog
    monkeypatch.setattr(prog, "counters", lambda: counters)
    reader = harness.metric_reader(harness.BENCH, "inplace_share.scan")   # binds the patch
    assert reader([]) == want


def test_inplace_share_is_a_scan_metric_of_the_arena_layer():
    spec = harness.resolve("lz4-128k.scan")
    (m,) = [m for m in spec["per_layer"] if m["name"] == "inplace_share.scan"]
    assert m["layer"] == "memory.arena (gather_burst)" and m["moves"] == "scan_GBps"
    assert m["source"] == "program_counter" and m["workloads"] == ["lz4-128k.scan"]
