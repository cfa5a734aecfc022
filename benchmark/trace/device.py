"""The profiler window and the arithmetic that turns its trace into numbers.

A traced run profiles the last part of its window with ``torch.profiler``
(CPU and CUDA activity), exports the Chrome trace into ``TMPDIR``, keeps the
device records (kernels, memcpys, memsets) and the benchmark's span
annotations, and deletes the file.  Busy time is the union of the device
records' intervals, so work on two streams at once counts once; idle is the
rest of the window.  An idle gap is named by the innermost span the host
was in at its middle.

The metric readers (``benchmark/metrics/*.py``) call the functions here on
a run's readings: one dict per rank (see :func:`reading`).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from . import roofline

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"          # the annotation around a profiled stretch
B1 = "decode_flat_kernel"        # B1's kernels (csrc/decode_flat.cu): shared, slices, cluster
#: The copy kernels of ``index_select`` (the arena gather, the shuffle's staging);
#: PyTorch 2.11 on the card names them ``vectorized_gather_kernel``.
GATHER = ("gather_kernel", "indexSelect")
NCCL = "nccl"
TOP = 10                         # entries of each breakdown list


class ProfilerWindow:
    """One profiled stretch: ``start()``, the work, ``stop()`` -> reading."""

    def start(self) -> "ProfilerWindow":
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.mark = torch.profiler.record_function(WINDOW)
        self.mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    def stop(self) -> dict:
        """Device records, annotations and the window's host seconds."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        host_s = time.perf_counter() - self.t0
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(prefix="bench-trace-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        dev, ann = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                dev.append((e["name"], cat, float(e["ts"]), float(e.get("dur", 0.0))))
            elif cat == "user_annotation":
                ann.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
        window = [a for a in ann if a[0] == WINDOW]
        window_s = window[0][2] / 1e6 if window else host_s
        return {"events": dev, "annotations": ann, "window_s": window_s}


def union_us(intervals) -> list[tuple[float, float]]:
    """Merged [start, end) intervals of (start, duration) pairs, in µs."""
    merged: list[list[float]] = []
    for s, d in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s + d)
        else:
            merged.append([s, s + d])
    return [(a, b) for a, b in merged]


def busy_s(events) -> float:
    """Seconds in which any device record ran."""
    return sum(b - a for a, b in union_us((ts, dur) for _, _, ts, dur in events)) / 1e6


def kernel_s(events, part) -> float:
    """Seconds of the device records whose name holds ``part`` (a string, or
    a tuple of strings any of which may match)."""
    parts = (part,) if isinstance(part, str) else part
    return sum(dur for name, _, _, dur in events if any(p in name for p in parts)) / 1e6


def memcpy_s(events, direction: str) -> float:
    """Seconds of memcpys whose name holds ``direction`` (``DtoH``, ``HtoD``)."""
    return sum(dur for name, cat, _, dur in events
               if cat == "gpu_memcpy" and direction in name) / 1e6


def exchange_s(events) -> float | None:
    """Seconds of the shuffle's exchange: from each stage's gather kernel to
    the end of the NCCL kernel that sends what it staged; None without
    NCCL kernels."""
    total, staged, seen = 0.0, None, False
    for name, _, ts, dur in sorted(events, key=lambda e: e[2]):
        if any(p in name for p in GATHER) and staged is None:
            staged = ts
        elif NCCL in name.lower():
            seen = True
            total += ts + dur - (ts if staged is None else staged)
            staged = None
    return total / 1e6 if seen else None


def breakdown(events, annotations) -> dict:
    """The device records that took most time, and the longest idle gaps
    by the span the host was in: ``{"device_ops": [[name, s]], "idle_gaps":
    [[name, s]]}``, at most ``TOP`` entries each."""
    ops: dict[str, float] = defaultdict(float)
    for name, _, _, dur in events:
        ops[name[:160]] += dur / 1e6
    window = [(ts, ts + d) for n, ts, d in annotations if n == WINDOW]
    gaps: dict[str, float] = defaultdict(float)
    if window:
        lo, hi = window[0]
        prev = lo
        spans = [(ts, ts + d, n) for n, ts, d in annotations if n != WINDOW]
        for a, b in union_us((ts, dur) for _, _, ts, dur in events) + [(hi, hi)]:
            a, b = max(a, lo), min(b, hi)
            if a > prev:
                mid = (a + prev) / 2
                inner = [(e - s, n) for s, e, n in spans if s <= mid <= e]
                gaps[min(inner)[1] if inner else "between spans"] += (a - prev) / 1e6
            prev = max(prev, b)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def reading(prof: dict, kind: str, steps: int, counts: dict, all_steps: int,
            all_counts: dict, spans: dict, extra: dict | None = None) -> dict:
    """One rank's reading for the metric readers: the profiled stretch
    (``events``, ``annotations``, ``window_s``, ``steps``, ``counts``) and
    the whole window (``all_steps``, ``all_counts``, ``spans``: host
    seconds by span name), with the loop's ``extra`` numbers."""
    return dict(prof, kind=kind, steps=steps, counts=dict(counts), all_steps=all_steps,
                all_counts=dict(all_counts), spans={k: list(v) for k, v in spans.items()},
                extra=dict(extra or {}))


# --- what the metric readers share -------------------------------------------

def b1_roofline(readings: list[dict]) -> float | None:
    """B1's share of the roofline on the slowest rank, in %: the decode's
    bytes (stored + raw of the blocks decoded in the profiled stretch) at
    the card's peak over B1's device time there."""
    shares = []
    for r in readings:
        c = r["counts"]
        share = roofline.share_pct(
            roofline.decode_bytes(c.get("stored_bytes", 0), c.get("raw_bytes", 0)),
            kernel_s(r["events"], B1), r["kind"])
        if share is None:
            return None
        shares.append(share)
    return min(shares) if shares else None


def idle_pct(readings: list[dict]) -> float | None:
    """The device's idle share of the profiled window in %, mean over ranks."""
    vals = [100.0 * (1.0 - busy_s(r["events"]) / r["window_s"])
            for r in readings if r["events"] and r["window_s"] > 0]
    return sum(vals) / len(vals) if vals and len(vals) == len(readings) else None


def per_step_ms(readings: list[dict], seconds_of) -> float | None:
    """``seconds_of(events)`` per profiled step in ms, mean over ranks;
    None where a rank traced no device record or no step."""
    vals = []
    for r in readings:
        if not r["events"] or not r["steps"]:
            return None
        vals.append(1e3 * seconds_of(r["events"]) / r["steps"])
    return sum(vals) / len(vals) if vals else None


def span_mean_ms(readings: list[dict], name: str) -> float | None:
    """Mean host ms of span ``name`` over the whole window, rank 0."""
    s = readings[0]["spans"].get(name) if readings else None
    return 1e3 * sum(s) / len(s) if s else None
