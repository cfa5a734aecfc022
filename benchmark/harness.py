"""What every cell shares: finding its files by name, the closed-loop window,
the checks, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the engine's fields, the data and its scale, the chips) and a traffic mix
(``traffic/<name>.json``: parameters, among them the ``loop`` of
``loops/<loop>.py`` that drives it).  Each per-layer metric has its reader
in ``metrics/<name>.py``.  Nothing here names a cell: a later cell or
metric is new files and new entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .reference import data as ref_data
from .trace import device as trace
from .trace.spans import Spans

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: Top-level module names no run may hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "bitar_tpu")


# --- finding a cell's files ---------------------------------------------------

def resolve(workload: str, root: Path = ROOT, spec: dict | None = None) -> dict:
    """The cell, its configuration and traffic, and the metrics it reports,
    from ``BENCHMARK.json`` or from ``spec`` where given."""
    spec = spec or json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    bench = root / spec["paths"][0]
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"cell": cell, "config": json.loads((root / conf["file"]).read_text()),
            "traffic": json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text()),
            "end_to_end": e2e, "per_layer": per_layer, "bench": bench}


def with_held_back(spec: dict, root: Path = ROOT) -> dict:
    """``spec`` and the entries of ``held_back.json``: cells whose files are
    here and whose entries wait outside ``BENCHMARK.json`` (the CPU tests
    run them; a later benchmark adds them back as they are written)."""
    held = json.loads((root / spec["paths"][0] / "held_back.json").read_text())
    return {**spec, **{k: spec[k] + held.get(k, []) for k in
                       ("configs", "workloads", "end_to_end", "per_layer")}}


def loop_module(traffic: dict):
    """``loops/<traffic["loop"]>.py``, imported by name (a spawned rank
    imports it again the same way)."""
    return importlib.import_module(f"{__package__}.loops.{traffic['loop']}")


def metric_reader(bench: Path, name: str):
    """The ``read(readings)`` function of ``metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --- what a loop is given -----------------------------------------------------

@dataclass
class Context:
    """One run of one cell."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str                       # "cuda", or "cpu" for the plain versions (tests)
    t0: float = field(default_factory=time.perf_counter)      # process start, host clock
    t0_wall: float = field(default_factory=time.time)         # the same, wall clock
    spans: Spans = None
    hook: object = None               # a module-level callable each rank runs first (tests)

    def __post_init__(self):
        if self.spans is None:
            self.spans = Spans(self.trace)


def engine(ctx: Context):
    """The configuration's engine on the run's device, initialized."""
    from bitar_tpu_torch.config import Checksum, Codec, EngineConfig
    from bitar_tpu_torch.engine.device import Engine

    kw = dict(ctx.config["engine"])
    kw["codec"] = Codec(kw["codec"])
    if "checksum" in kw:
        kw["checksum"] = Checksum(kw["checksum"])
    if "match_offsets" in kw:
        kw["match_offsets"] = tuple(kw["match_offsets"])
    return Engine(EngineConfig(**kw), device=ctx.device).initialize()


def make_data(ctx: Context) -> tuple[np.ndarray, np.ndarray]:
    """The configuration's input from the seed, and its block sizes."""
    return ref_data.make(ctx.config["data"], ctx.seed, ctx.config["engine"]["block_size"])


def unit_spans(sizes: np.ndarray, unit_blocks: int) -> list[tuple[int, int, int, int]]:
    """(first block, stop block, first byte, stop byte) of each unit."""
    off = np.concatenate([[0], np.cumsum(sizes)])
    return [(b, min(b + unit_blocks, len(sizes)), int(off[b]),
             int(off[min(b + unit_blocks, len(sizes))]))
            for b in range(0, len(sizes), unit_blocks)]


def resident_units(eng, raw: np.ndarray, sizes: np.ndarray, spans: list) -> list:
    """Each unit of ``spans`` compressed and planned: the resident set."""
    units = []
    for b0, b1, o0, o1 in spans:
        u = eng.compress(raw[o0:o1], sizes=sizes[b0:b1].tolist())
        eng.ensure_plans(u)
        units.append(u)
    return units


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    d = torch.device(device)
    return int(torch.cuda.max_memory_allocated(d)) if d.type == "cuda" else 0


def device_kind(device) -> str:
    d = torch.device(device)
    return torch.cuda.get_device_name(d) if d.type == "cuda" else "cpu"


class Phases:
    """Host seconds of each set-up phase since the last mark (a note on stderr)."""

    def __init__(self, t0: float):
        self.t, self.seconds = t0, {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self.t, 3)
        self.t = now


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length,
    its choices drawn from the seed: :meth:`slot`, asked before each item,
    gives the slot the item takes, or None."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen = size, 0
        self.rng = np.random.default_rng([seed, 0x5EED])

    def slot(self) -> int | None:
        i, self.seen = self.seen, self.seen + 1
        if i < self.size:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.size else None

    def wanted(self) -> int:
        return min(self.size, self.seen)


def bad_plane_bytes(planes: list[torch.Tensor], raw: np.ndarray, sizes: np.ndarray) -> int:
    """Bytes of decoded planes ([blocks, rows, 128] per burst, in block
    order) that differ from ``raw``, block by block over its own length."""
    host = torch.cat([p.reshape(p.shape[0], -1) for p in planes]).cpu().numpy()
    if host.shape[0] != len(sizes):
        return int(sizes.sum())
    if (sizes == host.shape[1]).all():
        return int((host != raw.reshape(host.shape)).sum())
    bad, o = 0, 0
    for j, n in enumerate(sizes.tolist()):
        bad += int((host[j, :n] != raw[o:o + n]).sum())
        o += n
    return bad


# --- the window -----------------------------------------------------------------

@dataclass
class Window:
    start: float = 0.0                # host clock at the first timed operation
    seconds: float = 0.0
    steps: int = 0
    counts: dict = field(default_factory=dict)
    traced_steps: int = 0
    traced: dict = field(default_factory=dict)
    prof: dict | None = None

    def add(self, c: dict, traced: bool) -> None:
        self.steps += 1
        for k, v in c.items():
            self.counts[k] = self.counts.get(k, 0) + v
        if traced:
            self.traced_steps += 1
            for k, v in c.items():
                self.traced[k] = self.traced.get(k, 0) + v


def drive(ctx: Context, step, *, decide=None, agree=None, finish=None) -> Window:
    """Call ``step(i)`` (which returns its counts) until ``ctx.seconds`` have
    passed.  In a traced run the window's end is profiled, ``profile_s`` of
    the traffic file from the profiler's start (past the window's end where
    the profiler was slow to start); a stretch whose profiler kept no device
    record is run again (up to twice, as many steps) and read instead.

    ``decide(state)`` turns this process's state (0 stop, 1 go, 2 go
    profiled) into the one all ranks act on; ``agree(ok)`` is True where
    every rank's profile held device records; ``finish()`` runs before the
    window's clock stops.  The defaults are one process's."""
    decide = decide or (lambda s: s)
    agree = agree or (lambda ok: ok)
    prof_s = min(float(ctx.traffic.get("profile_s", 1.0)), ctx.seconds) if ctx.trace else 0.0
    w, prof, i = Window(), None, 0
    w.start = t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        if prof is None:
            state = (0 if now - t0 >= ctx.seconds
                     else 2 if ctx.trace and now - t0 >= ctx.seconds - prof_s else 1)
        else:        # a profiled stretch lasts profile_s from the profiler's start
            state = 0 if now - t0 >= ctx.seconds and now - prof.t0 >= prof_s else 2
        state = decide(state)
        if state == 0:
            break
        if state == 2 and prof is None:
            prof = trace.ProfilerWindow().start()
        w.add(step(i), traced=prof is not None)
        i += 1
    if finish is not None:
        finish()
    w.seconds = time.perf_counter() - t0
    if ctx.trace:
        if prof is None:                    # a window too short to reach its profiled part
            prof = trace.ProfilerWindow().start()
            w.add(step(i), traced=True)
            i += 1
        w.prof = prof.stop()
        want_device = torch.device(ctx.device).type == "cuda"
        for _ in range(2):
            if agree(bool(w.prof["events"]) or not want_device):
                break
            n, w.traced_steps, w.traced = max(1, w.traced_steps), 0, {}
            prof = trace.ProfilerWindow().start()
            for _ in range(n):
                w.add(step(i), traced=True)
                i += 1
            w.prof = prof.stop()
    return w


def window_reading(ctx: Context, w: Window, extra: dict | None = None) -> dict:
    return trace.reading(w.prof, device_kind(ctx.device), w.traced_steps, w.traced, w.steps,
                         w.counts, ctx.spans.seconds, extra)


# --- the result -------------------------------------------------------------------

def outcome(ctx: Context, w: Window, *, e2e: dict, attempted: int, failed: int,
            checks: dict, peak: int, readings: list | None = None, count: int = 1,
            setup_s: float | None = None, notes: dict | None = None) -> dict:
    """What a loop hands back: the end-to-end values, the compared numbers
    (``{name: (value, limit)}``, each held to value <= limit) and, traced,
    the readings the metric readers take."""
    return {"setup_s": w.start - ctx.t0 if setup_s is None else setup_s, "e2e": e2e,
            "attempted": attempted, "failed": failed, "checks": checks, "peak": peak,
            "readings": readings, "count": count, "notes": notes or {}}


def run_cell(spec: dict, ctx: Context) -> tuple[dict, dict]:
    """Run the cell's loop once: (what it handed back, the result line)."""
    out = loop_module(ctx.traffic).run(ctx)
    return out, result_line(spec, ctx, out)


def forbidden_modules() -> list[str]:
    """Modules of ``sys.modules`` whose whole top-level name is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def result_line(spec: dict, ctx: Context, out: dict) -> dict:
    """The run's JSON line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, traced ``breakdown``, and ``checks`` last."""
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    correct = out["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if ctx.trace:
        for m in spec["per_layer"]:
            value = metric_reader(spec["bench"], m["name"])(out["readings"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.device == "cuda" else "cpu", "kind": device_kind(ctx.device),
           "count": out["count"], "memory_peak_bytes": out["peak"]}
    line = {"correct": bool(correct), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if ctx.trace:
        rs = out["readings"]
        dev["busy_s"] = statistics.fmean(trace.busy_s(r["events"]) for r in rs)
        dev["window_s"] = rs[0]["window_s"]
        slowest = max(rs, key=lambda r: trace.busy_s(r["events"]))
        line["breakdown"] = trace.breakdown(slowest["events"], slowest["annotations"])
    line["checks"] = checks
    return line
