"""MultiGet: YCSB workload C point reads, batched as RocksDB's MultiGet, over
SSTs whose compressed data blocks are resident on the card.

Set-up makes the configuration's SSTs from the seed (``reference/kv.py``),
compresses each SST's blocks into a unit and builds their decode sidecar,
draws the key stream, and warms every unit's decode.  A step takes the
stream's next ``clients`` MultiGets of ``keys_per_multiget`` keys, maps each
key to its SST and block through the record table, keeps each MultiGet's
distinct blocks (RocksDB reads a block once a MultiGet), decodes them all in
one ``Engine.decompress_blocks_device`` call, gathers every key's value from
the planes into one ``[keys, value_len]`` device tensor and synchronizes.
``scan_GBps`` is the raw bytes of the blocks decoded in the window over its
seconds.  A seed-drawn sample of the window's MultiGets keeps their values
and their blocks' planes; after the window each kept value is compared
with the plain lookup of its key in the raw block, the lookup's value with
the generator's, and each kept plane with its raw block.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness
from ..reference import kv


def run(ctx: harness.Context) -> dict:
    ph = harness.Phases(ctx.t0)
    eng = harness.engine(ctx)
    decode = eng.decompress_blocks_device    # a program without it stops here
    ph.mark("start_engine")
    per_unit, block = ctx.config["data"]["unit_blocks"], ctx.config["engine"]["block_size"]
    data = kv.make(ctx.config["data"], ctx.seed, block)
    ph.mark("make_data")
    spans = harness.unit_spans(data.sizes, per_unit)
    units = harness.resident_units(eng, data.raw, data.sizes, spans)
    comp_len = np.concatenate([u.manifest.comp_len for u in units]).astype(np.int64)
    ph.mark("compress_and_plan")
    t = ctx.traffic
    clients, per_mg = int(t["clients"]), int(t["keys_per_multiget"])
    keys = clients * per_mg
    stream = kv.key_stream(ctx.seed, data.sst.size, int(t["drawn_keys"]), float(t["zipf"]))
    steps_drawn = stream.size // keys
    record_block = data.sst * per_unit + data.block
    nblocks = data.sizes.size
    mg_of = np.repeat(np.arange(clients, dtype=np.int64), per_mg)
    ph.mark("draw_keys")

    def multiget(i: int):
        recs = stream[(i % steps_drawn) * keys:][:keys]
        uniq, inv = np.unique(mg_of * nblocks + record_block[recs], return_inverse=True)
        blocks = uniq % nblocks
        # Each key's value: plane bytes from its block's row and the value's offset.
        at = torch.from_numpy(inv.reshape(-1) * block + data.value_off[recs]).to(eng.device)
        planes = decode(units, blocks // per_unit, blocks % per_unit)
        flat = planes.view(-1)
        values = flat.as_strided((flat.numel() - kv.VALUE_LEN + 1, kv.VALUE_LEN),
                                 (1, 1)).index_select(0, at)
        harness.sync(eng.device)
        return recs, uniq, planes, values

    decode(units, np.arange(len(units)), np.zeros(len(units), np.int64))
    for i in range(2):
        multiget(i)
    ph.mark("warm")

    # A uniform sample of the window's MultiGets (a reservoir, its draws
    # made a step at a time).
    sample = int(t["sample_multigets"])
    draws = np.random.default_rng([ctx.seed, 0x5EED])
    kept: list = [None] * sample
    step_s: list[float] = []

    def step(i: int) -> dict:
        t0 = time.perf_counter()
        with ctx.spans.span("multiget"):
            recs, uniq, planes, values = multiget(i)
        step_s.append(time.perf_counter() - t0)
        seen = np.arange(i * clients, (i + 1) * clients)
        slot = np.where(seen < sample, seen, draws.integers(0, seen + 1))
        for m in np.flatnonzero(slot < sample).tolist():
            kept[slot[m]] = (m, recs, uniq, planes, values)
        blocks = uniq % nblocks
        return {"raw_bytes": int(data.sizes[blocks].sum()),
                "stored_bytes": int(comp_len[blocks].sum()), "blocks": blocks.size}

    w = harness.drive(ctx, step)
    peak = harness.memory_peak(eng.device)
    readings = [harness.window_reading(ctx, w)] if ctx.trace else None
    raw_off = np.concatenate([[0], np.cumsum(data.sizes)])
    bad = missing = checked = 0
    for m, recs, uniq, planes, values in filter(None, kept):
        mine = np.flatnonzero(uniq // nblocks == m)
        host = planes[torch.from_numpy(mine).to(planes.device)].cpu().numpy()
        for row, g in zip(host.reshape(mine.size, -1), uniq[mine] % nblocks, strict=True):
            bad += int((row[:data.sizes[g]] != data.raw[raw_off[g]:raw_off[g + 1]]).sum())
        got = values[m * per_mg:(m + 1) * per_mg].cpu().numpy()
        for j, r in enumerate(recs[m * per_mg:(m + 1) * per_mg].tolist()):
            g = record_block[r]
            ref = kv.lookup(data.raw[raw_off[g]:raw_off[g + 1]].tobytes(), data.user_key(r))
            if ref is None:
                missing += 1
                continue
            ref = np.frombuffer(ref, np.uint8)
            bad += int((got[j] != ref).sum()) + int((ref != data.values[r]).sum())
        checked += 1
    kept.clear()
    for u in units:
        eng.recycle(u)
    eng.release()
    ms = 1e3 * np.array(step_s)
    return harness.outcome(
        ctx, w, e2e={"scan_GBps": w.counts["raw_bytes"] / w.seconds / 1e9},
        attempted=w.steps, failed=0, peak=peak, readings=readings,
        checks={"bad_bytes": (bad, 0), "missing_keys": (missing, 0),
                "unchecked_multigets": (min(sample, w.steps * clients) - checked, 0)},
        notes={"setup_phases_s": ph.seconds, "steps": w.steps, "window_s": w.seconds,
               "multigets_per_s": w.steps * clients / w.seconds,
               "keys_per_s": w.steps * keys / w.seconds,
               "blocks_per_step": w.counts["blocks"] / max(1, w.steps),
               "step_p50_ms": float(np.percentile(ms, 50)) if ms.size else None,
               "step_p99_ms": float(np.percentile(ms, 99)) if ms.size else None,
               "records": int(data.sst.size),
               "stored_ratio": float(data.sizes.sum() / comp_len.sum())})
