"""Ingest: one client lands raw units in the card's compressed store.

Set-up compresses the configuration's units and builds their plans: the
resident set.  A step is ``Engine.compress`` and ``Engine.ensure_plans`` of
the next raw unit (in turn), after which the unit is decodable, and
``Engine.recycle`` of the oldest resident one, so the resident count stays
as set up.  ``ingest_GBps`` is the raw bytes of every unit made decodable
over the window's seconds.  A sample of the ingested units, drawn from the
seed, stays resident past its turn (the next oldest goes instead); after
the window those and every other unit ingested in the window and still
resident are checked: their stored streams, read back from the arena and
decoded by the reference's own LZ4 decoder, and their device decode, each
against the raw input byte for byte.
"""

from __future__ import annotations

from collections import deque

from .. import harness
from ..reference import lz4


def stored_bad_bytes(unit, raw) -> int:
    """Bytes the reference decodes wrongly from the unit's stored streams."""
    cb = unit.to_host()
    m = cb.manifest
    bad = 0
    for o, n, cid, ro, rl in zip(m.comp_off.tolist(), m.comp_len.tolist(),
                                 m.codec_ids.tolist(), m.raw_off.tolist(),
                                 m.raw_len.tolist(), strict=True):
        try:
            got = lz4.decode_stored(cb.packed[o:o + n].tobytes(), cid, rl)
            bad += int((got != raw[ro:ro + rl]).sum())
        except lz4.FormatError:
            bad += rl
    return bad


def run(ctx: harness.Context) -> dict:
    from bitar_tpu_torch.ops.cpu import native

    ph = harness.Phases(ctx.t0)
    eng = harness.engine(ctx)
    ph.mark("start_engine")
    raw, sizes = harness.make_data(ctx)
    ph.mark("make_data")
    spans = harness.unit_spans(sizes, ctx.config["data"]["unit_blocks"])
    raws = [(raw[o0:o1], sizes[b0:b1].tolist()) for b0, b1, o0, o1 in spans]
    # (unit index, unit, ingested in the window), oldest first
    fifo = deque((k, u, False) for k, u in enumerate(harness.resident_units(eng, raw, sizes,
                                                                             spans)))
    ph.mark("compress_and_plan")
    res = harness.Reservoir(int(ctx.traffic["sample_units"]), ctx.seed)
    kept: list = [None] * res.size
    native.plan_prof(reset=True)

    def step(i: int) -> dict:
        k = i % len(raws)
        with ctx.spans.span("compress"):
            u = eng.compress(raws[k][0], sizes=raws[k][1])
        with ctx.spans.span("ensure_plans"):
            eng.ensure_plans(u)
        slot = res.slot()
        if slot is None:
            fifo.append((k, u, True))
        else:
            if kept[slot] is not None:
                fifo.appendleft(kept[slot])
            kept[slot] = (k, u, True)
        with ctx.spans.span("recycle"):
            eng.recycle(fifo.popleft()[1])
        return {"raw_bytes": len(raws[k][0]), "stored_bytes": int(u.manifest.comp_len.sum()),
                "units": 1}

    w = harness.drive(ctx, step)
    densify_ms = native.plan_prof(reset=True)["densify"]
    peak = harness.memory_peak(eng.device)
    readings = ([harness.window_reading(ctx, w, {"densify_ms": densify_ms})]
                if ctx.trace else None)
    bad_stored = bad_device = checked = 0
    for k, u, in_window in [e for e in kept if e is not None] + list(fifo):
        if not in_window:
            continue
        b0, b1, o0, o1 = spans[k]
        bad_stored += stored_bad_bytes(u, raw[o0:o1])
        bad_device += harness.bad_plane_bytes(eng.decompress_device(u), raw[o0:o1],
                                              sizes[b0:b1])
        checked += 1
    for e in [e for e in kept if e is not None] + list(fifo):
        eng.recycle(e[1])
    eng.release()
    want = min(res.seen, len(raws))             # units ingested in the window, still resident
    return harness.outcome(
        ctx, w, e2e={"ingest_GBps": w.counts["raw_bytes"] / w.seconds / 1e9},
        attempted=w.steps, failed=0, peak=peak, readings=readings,
        checks={"bad_bytes_stored": (bad_stored, 0), "bad_bytes_device": (bad_device, 0),
                "unchecked_units": (want - checked, 0)},
        notes={"setup_phases_s": ph.seconds, "units": w.steps, "window_s": w.seconds,
               "stored_ratio": w.counts["raw_bytes"] / w.counts["stored_bytes"]})
