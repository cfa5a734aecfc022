"""The reader of ``prepared_share.scan``: the share of the scan's blocks B1
launched from a kept launch record, from the program's counters, and
nothing where the program counts none.

Run from the repository root: ``python -m pytest benchmark/``.
"""

from __future__ import annotations

import pytest

from benchmark import harness


@pytest.mark.parametrize("counters,want", [
    ({"decode_flat.prepared_blocks": 8192, "decode_flat.blocks": 8192}, 100.0),
    ({"decode_flat.prepared_blocks": 7168, "decode_flat.blocks": 8192}, 87.5),
    ({"decode_flat.blocks": 8192, "arena.inplace_blocks": 8192}, None),     # no records: a parent
    ({"decode_flat.prepared_blocks": 0, "decode_flat.blocks": 0}, None),
    ({}, None),
    (None, None),
])
def test_prepared_share_reads_the_programs_counters(monkeypatch, counters, want):
    import benchmark.trace.program as prog
    monkeypatch.setattr(prog, "counters", lambda: counters)
    reader = harness.metric_reader(harness.BENCH, "prepared_share.scan")   # binds the patch
    assert reader([]) == want


def test_prepared_share_is_a_scan_metric_of_the_engine_layer():
    spec = harness.resolve("lz4-128k.scan")
    (m,) = [m for m in spec["per_layer"] if m["name"] == "prepared_share.scan"]
    assert m["layer"] == "engine.device (decompress_device host path)"
    assert m["moves"] == "scan_GBps" and m["unit"] == "%" and m["better"] == "higher"
    assert m["source"] == "program_counter" and m["workloads"] == ["lz4-128k.scan"]
