"""Read: one client reads resident units back to the host, popular ones often.

Set-up compresses the configuration's units, builds their plans and reads
each once.  A request is ``Engine.decompress(unit, out=<caller buffer>)`` of
a unit drawn by a Zipf law (``zipf``: its exponent) over units ranked in an
order drawn from the seed; its latency is the host clock from issue until
the call returns.  A request that raises has failed, and its latency exceeds
every limit.  A sample of the requests, drawn from the seed, reads into a
buffer of its own; after the window each is compared with the raw input.
"""

from __future__ import annotations

import time

import numpy as np

from .. import harness

FAILED_S = 1e9        # a failed request's latency: beyond every limit


def zipf_requests(seed: int, units: int, exponent: float, count: int) -> np.ndarray:
    """``count`` unit indices: ranks drawn with probability ~ 1 / rank^exponent,
    each rank mapped to a unit by a permutation drawn from ``seed``."""
    rng = np.random.default_rng([seed, 0x21BF])
    p = np.arange(1, units + 1, dtype=np.float64) ** -exponent
    return rng.permutation(units)[rng.choice(units, size=count, p=p / p.sum())]


def run(ctx: harness.Context) -> dict:
    from bitar_tpu_torch.status import StatusError

    ph = harness.Phases(ctx.t0)
    eng = harness.engine(ctx)
    ph.mark("start_engine")
    raw, sizes = harness.make_data(ctx)
    ph.mark("make_data")
    spans = harness.unit_spans(sizes, ctx.config["data"]["unit_blocks"])
    units = harness.resident_units(eng, raw, sizes, spans)
    raw_bytes = [o1 - o0 for _, _, o0, o1 in spans]
    stored = [int(u.manifest.comp_len.sum()) for u in units]
    width = max(raw_bytes)
    buf = np.ones(width, np.uint8)                     # the caller's buffer, faulted in
    res = harness.Reservoir(int(ctx.traffic["sample_requests"]), ctx.seed)
    samples = [np.ones(width, np.uint8) for _ in range(res.size)]
    ph.mark("compress_and_plan")
    # Each unit's plan uploads at its first decode: do that for all, and warm
    # the readback path once.
    for u in units:
        eng.decompress_device(u)
    eng.decompress(units[0], out=buf)
    ph.mark("warm")
    reqs = zipf_requests(ctx.seed, len(units), float(ctx.traffic["zipf"]),
                         int(ctx.traffic["drawn_requests"]))
    kept: list = [None] * res.size
    lat: list[float] = []
    issued: list[float] = []          # host clock at each request's issue
    failed = 0

    def step(i: int) -> dict:
        nonlocal failed
        k = want = int(reqs[i % len(reqs)])
        slot = res.slot()
        dst = buf if slot is None else samples[slot]
        t = time.perf_counter()
        issued.append(t)
        try:
            with ctx.spans.span("read"):
                eng.decompress(units[k], out=dst)
            lat.append(time.perf_counter() - t)
        except StatusError:
            failed += 1
            lat.append(FAILED_S)
            k = None
        if slot is not None:
            kept[slot] = k
        return {"raw_bytes": raw_bytes[want], "stored_bytes": stored[want], "requests": 1}

    w = harness.drive(ctx, step)
    peak = harness.memory_peak(eng.device)
    readings = [harness.window_reading(ctx, w)] if ctx.trace else None
    lat_ms = np.asarray(lat[:w.steps]) * 1e3
    p95 = float(np.percentile(lat_ms, 95))
    bad = checked = 0
    for slot, k in enumerate(kept):
        if k is not None:
            _, _, o0, o1 = spans[k]
            bad += int((samples[slot][:o1 - o0] != raw[o0:o1]).sum())
            checked += 1
    for u in units:
        eng.recycle(u)
    eng.release()
    done = lat_ms[lat_ms < FAILED_S * 1e3]
    quarter = np.minimum(3, ((np.asarray(issued[:w.steps]) - w.start) * 4 / w.seconds).astype(int))
    return harness.outcome(
        ctx, w, e2e={"read_p95_ms": p95},
        attempted=w.steps, failed=failed, peak=peak, readings=readings,
        checks={"bad_bytes": (bad, 0), "failed_requests": (failed, 0),
                "unchecked_requests": (res.wanted() - checked, 0)},
        notes={"setup_phases_s": ph.seconds, "requests": w.steps,
               "read_p50_ms": float(np.median(lat_ms)), "read_p95_ms": p95,
               "read_max_ms": float(done.max()) if done.size else 0.0,
               "read_quantiles_ms": {q: float(np.percentile(lat_ms, q)) for q in (5, 25, 75, 99)},
               "read_p50_by_quarter_ms": [float(np.median(lat_ms[quarter == j]))
                                          for j in range(4) if (quarter == j).any()],
               "read_GBps": w.counts["raw_bytes"] / w.seconds / 1e9,
               "units": len(units)})
