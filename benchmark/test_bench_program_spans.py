"""The readers of the program's own spans and counters, on synthetic readings
and on a tiny traced scan on the CPU.

Run from the repository root: ``python -m pytest benchmark/``.
"""

from __future__ import annotations

import math

import pytest

from benchmark import harness
from benchmark.trace import program

NAMES = ("engine_host_ms.scan", "gather_useful.scan", "step_host_ms.shuffle")
READ = {n: harness.metric_reader(harness.BENCH, n) for n in NAMES}
SCAN = "bitar.engine.decompress_device"
STEP = "bitar.parallel.distributed_step_flat"


def reading(annotations=(), events=(), window_s=100e-6):
    return {"annotations": list(annotations), "events": list(events), "window_s": window_s}


def test_span_means_and_their_absence():
    r = reading([("scan", 0.0, 900.0), (SCAN, 10.0, 200.0), (SCAN, 300.0, 400.0)])
    assert math.isclose(READ["engine_host_ms.scan"]([r]), 0.3)
    ranks = [reading([(STEP, 0.0, 1000.0)]), reading([(STEP, 0.0, 3000.0), (STEP, 5.0, 1000.0)])]
    assert math.isclose(READ["step_host_ms.shuffle"](ranks), 2.0)
    older = [reading([("scan", 0.0, 900.0), ("step", 0.0, 900.0)])]    # a program without spans
    assert READ["engine_host_ms.scan"](older) is None
    assert READ["step_host_ms.shuffle"](older) is None


@pytest.mark.parametrize("counters,want", [
    ({"arena.gather_bytes": 400, "arena.gather_stored_bytes": 100}, 25.0),
    ({"arena.gather_bytes": 0}, None),
    ({}, None),
    (None, None),
])
def test_gather_useful_reads_the_programs_counters(monkeypatch, counters, want):
    import benchmark.trace.program as prog
    monkeypatch.setattr(prog, "counters", lambda: counters)
    reader = harness.metric_reader(harness.BENCH, "gather_useful.scan")   # binds the patch
    assert reader([]) == want


def test_counters_of_a_program_without_a_store(monkeypatch):
    from bitar_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "snapshot")
    assert program.counters() is None


def test_a_tiny_traced_scan_reports_the_program_metrics(tiny):
    from bitar_tpu_torch.utils import profiling

    profiling.snapshot(reset=True)
    spec, ctx = tiny("lz4-128k.scan", seconds=0.5, trace=True)
    _, line = harness.run_cell(spec, ctx)
    assert line["correct"] is True
    metrics = line["metrics"]
    assert metrics["engine_host_ms.scan"]["value"] > 0
    c = profiling.snapshot(reset=True)
    want = 100.0 * c["arena.gather_stored_bytes"] / c["arena.gather_bytes"]
    useful = metrics["gather_useful.scan"]["value"]
    assert useful == pytest.approx(want) and 0 < useful <= 100
    device = {m["name"] for m in spec["per_layer"] if m["source"] == "device_trace"}
    assert not set(metrics) & device                         # nothing ran on a device
