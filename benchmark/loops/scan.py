"""Scan: one client decodes the resident units into device memory, in turn.

Set-up compresses the configuration's units, builds their plans and decodes
each once.  A step is ``Engine.decompress_device`` of the next unit, its
planes synchronized before the next is issued.  ``scan_GBps`` is the raw
bytes of every scan over the window's seconds.  A sample of the scans, drawn
from the seed, keeps its planes; after the window each is compared with the
raw input byte for byte.
"""

from __future__ import annotations

import numpy as np

from .. import harness


def run(ctx: harness.Context) -> dict:
    ph = harness.Phases(ctx.t0)
    eng = harness.engine(ctx)
    ph.mark("start_engine")
    raw, sizes = harness.make_data(ctx)
    ph.mark("make_data")
    spans = harness.unit_spans(sizes, ctx.config["data"]["unit_blocks"])
    units = harness.resident_units(eng, raw, sizes, spans)
    raw_bytes = [o1 - o0 for _, _, o0, o1 in spans]
    stored = [int(u.manifest.comp_len.sum()) for u in units]
    ph.mark("compress_and_plan")
    for u in units:                                   # uploads each unit's plan once
        eng.decompress_device(u)
    harness.sync(eng.device)
    ph.mark("warm")

    res = harness.Reservoir(int(ctx.traffic["sample_scans"]), ctx.seed)
    kept: list = [None] * res.size

    def step(i: int) -> dict:
        k = i % len(units)
        slot = res.slot()
        with ctx.spans.span("scan"):
            planes = eng.decompress_device(units[k])
            harness.sync(eng.device)
        if slot is not None:
            kept[slot] = (k, planes)
        return {"raw_bytes": raw_bytes[k], "stored_bytes": stored[k]}

    w = harness.drive(ctx, step)
    peak = harness.memory_peak(eng.device)
    readings = [harness.window_reading(ctx, w)] if ctx.trace else None
    bad = checked = 0
    for k, planes in filter(None, kept):
        b0, b1, o0, o1 = spans[k]
        bad += harness.bad_plane_bytes(planes, raw[o0:o1], sizes[b0:b1])
        checked += 1
    kept.clear()
    for u in units:
        eng.recycle(u)
    eng.release()
    return harness.outcome(
        ctx, w, e2e={"scan_GBps": w.counts["raw_bytes"] / w.seconds / 1e9},
        attempted=w.steps, failed=0, peak=peak, readings=readings,
        checks={"bad_bytes": (bad, 0), "unchecked_scans": (res.wanted() - checked, 0)},
        notes={"setup_phases_s": ph.seconds, "scans": w.steps, "window_s": w.seconds,
               "stored_ratio": float(np.sum(raw_bytes) / np.sum(stored))})
