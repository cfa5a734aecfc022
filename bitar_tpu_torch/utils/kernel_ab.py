"""Time this checkout's B1 (``decode_flat``), B2 (``decode_tables``), B3
(``match``), B4 (``match_dyn``), B5 (``match_walk``), B6 (``parse_walk``),
B7 (``decode_planned``) and emitter (``emit``) kernels against another
checkout's on one card, in turns, on the same inputs.

    python -m bitar_tpu_torch.utils.kernel_ab --old DIR [--out FILE]
        [--only match|match_walk|match_dyn|parse_walk|emit|decode_flat|decode_tables|
                decode_planned|scan_host]
    python -m bitar_tpu_torch.utils.kernel_ab --only match_routes|flat_sources|tables_sources
        [--out FILE]

``DIR`` is the root of another checkout of the repo (for example a ``git
archive`` of the parent commit unpacked into a git-ignored directory).  Its
package is loaded beside this one under another name and builds its kernels
into its own ``_build/``.  Every shape is run old, new, new, old (CUDA
events, mean ms per launch) after the two outputs are checked equal; every
kernel is also timed held (``timing.kernel_time_ms``: the calls queued
behind a hold kernel, then run back to back; ``held_`` keys) and by the
host clock per call (``timing.host_us_per_call``), in the same turns.
B7 runs at the shapes of :func:`planned_shapes` (its shared route at the
bench's 128 KiB, its tall route at 256 KiB and 1 MiB), and a last line
times this checkout's two routes on the same 32 MiB.
B1 also runs at the shapes of its cluster route (:func:`large_flat_shapes`:
1 MiB and 256 KiB blocks, and a burst of the CLI's skewed suite on
8192-row planes), and B2 on 1 MiB and 256 KiB tables (:func:`table_shapes`).
B5 runs on 256 x 128 KiB of the bench corpus (seg 1024, max_match 1024)
and B4 on 64 x 128 KiB of it (max_match 256), each with the offsets the
device matcher detects, and both on 64 x 128 KiB of the text corpus with
those of ``detect_fft=True, fft_k=6`` (up to 10 a block).  B6 walks B4's
planes of those two batches (seg 1024, wcap 8), and the emitter runs at
every shape a main path launches it (:func:`emit_shapes`).  Each B6 and
emitter line carries its bound (``bound_ms``, device memory at 3.35 TB/s).
``--only match_routes`` needs no other checkout: it times B3's two routes
in this one, tiles that stage their window in shared memory ("old") against
tiles that read the plane from device memory ("new", ``tile_plan``'s
window 0), at the shapes the main paths launch (:func:`ab_match_routes`).
``--only flat_sources`` needs none either: it times B1 on a unit's slots
gathered into contiguous rows ("old") against B1 reading them in the arena
through the unit's slot table ("new", the scan's launch), and the gather
and B1 together against B1 in place (:func:`ab_flat_sources`).
``--only tables_sources`` does the same for B2 on a MultiGet's picks of
RocksDB blocks of YCSB records (the generator of ``benchmark/reference/kv.py``,
so it runs from the repository's root): the picks' slots and table-store
rows gathered, then B2, against B2 reading them in place
(:func:`ab_table_sources`).
``--only scan_host`` times the scan's host path instead of a kernel: each
checkout's ``Engine.decompress_device`` on one resident 1024 x 128 KiB unit,
call by call by the host clock, with no synchronize and with one after
each call, and this checkout's B1 launch record prepared and run apart
(:func:`ab_scan_host`).  The plain
versions are not timed here (``chip_smoke.py`` does that).  Prints one JSON
object per shape and the card's name and power limit.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BLOCK = 128 * 1024
REPS = 20
WALK_BLOCKS = 256             # B5's bench batch (the device matcher's)
DYN_BLOCKS = 64               # B4's bench batch (seg 256)
DYN_TEXT_BLOCKS = 64          # B5's and B4's text batch
LARGE = 1 << 20               # blocks of B1's and B2's cluster routes
MID = 256 * 1024
SKEWED_BLOCKS = 256           # the CLI's skewed suite (its default)
SKEWED_BURST = 32             # one burst of it (the CLI's default burst size)
SCAN_CALLS = 400              # calls a turn of --only scan_host


def load_package(root: Path, name: str):
    """Import ``root/bitar_tpu_torch`` as the package ``name``."""
    pkg = root / "bitar_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def planned_batch(btt, data: bytes, nblocks: int, block: int = BLOCK, sizes=None,
                  burst: int = 1024):
    """Comp rows, plan tensors and comp_rows of ``data`` compressed (LZ4) and
    planned by an engine of this checkout (``sizes``: the blocks' raw
    sizes, as ``Engine.compress`` takes them)."""
    cfg = btt.EngineConfig(codec=btt.Codec.LZ4, block_size=block, burst_size=min(nblocks, burst),
                           max_pool_slots=nblocks + 32, commit="deferred")
    eng = btt.Engine(cfg, device="cuda").initialize()
    unit = eng.compress(data, sizes=sizes)
    eng.ensure_plans(unit)
    rows = eng.arena.gather_burst([r.slot for r in unit.refs])
    batch = (rows, unit.plan_device_arrays(), unit.plan_comp_rows)
    eng.recycle(unit)
    eng.release()
    return batch


def counted(old_mod, new_mod, attr: str = "launches") -> dict:
    """The launch counter ``attr`` of the two checkouts' modules, as
    functions that read it (``timing.kernel_time_ms``'s ``launches``)."""
    return {"old": lambda: getattr(old_mod, attr), "new": lambda: getattr(new_mod, attr)}


def turns(timing, old, new, counters: dict | None = None, calls: int = 0) -> dict:
    """Old, new, new, old: mean CUDA-event ms per call of each; with
    ``counters`` (:func:`counted`), also the held ms, and with ``calls``,
    the host microseconds per call over that many calls."""
    res = {}
    for key, timer in (("", lambda side, fn: timing.device_time_ms(fn, REPS)),
                       ("held_", lambda side, fn: timing.kernel_time_ms(fn, REPS,
                                                                       counters[side])),
                       ("host_us_", lambda side, fn: timing.host_us_per_call(fn, calls))):
        if (key == "held_" and not counters) or (key == "host_us_" and not calls):
            continue
        ms = {"old": [], "new": []}
        for name, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
            ms[name].append(timer(name, fn))
        res |= {key + k: sum(v) / len(v) for k, v in ms.items()} | {key + "turns": ms}
    return res


def same(a, b) -> bool:
    torch.cuda.synchronize()
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))
    return torch.equal(a, b)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, help="root of the other checkout")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    ap.add_argument("--only", choices=("match", "match_walk", "match_dyn", "parse_walk", "emit",
                                       "decode_flat", "decode_tables", "decode_planned",
                                       "match_routes", "flat_sources", "tables_sources",
                                       "scan_host"),
                    help="time one kernel only")
    args = ap.parse_args()
    if args.old is None and args.only not in ("match_routes", "flat_sources", "tables_sources"):
        ap.error("--old is required")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import bitar_tpu_torch as btt
    from bitar_tpu_torch.ops import decode_flat as df
    from bitar_tpu_torch.ops import match as mt
    from bitar_tpu_torch.utils import timing
    from bitar_tpu_torch.utils.corpus import make_corpus, make_text_corpus

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    lines = []

    def emit(rec):
        rec["card"] = card
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    if args.only == "tables_sources":
        ab_table_sources(emit, timing)
        return finish(args, lines)
    corpus = make_corpus(1024)
    if args.only == "match_routes":
        ab_match_routes(emit, timing, mt, corpus)
        return finish(args, lines)
    if args.only == "flat_sources":
        ab_flat_sources(emit, timing, btt, df, corpus)
        return finish(args, lines)
    old = load_package(args.old.resolve(), "bitar_tpu_torch_old")
    from bitar_tpu_torch_old.ops import decode_flat as odf
    from bitar_tpu_torch_old.ops import match as omt

    if args.only == "scan_host":
        ab_scan_host(emit, old, corpus)
        return finish(args, lines)
    if args.only in (None, "decode_tables"):
        ab_tables(emit, timing, corpus, make_text_corpus(256))
    if args.only in (None, "decode_planned"):
        ab_planned(emit, timing, corpus, make_text_corpus(32))
    if args.only in (None, "match_walk", "match_dyn"):
        ab_match_dyn(emit, timing, corpus, make_text_corpus(DYN_TEXT_BLOCKS), args.only)
    if args.only in (None, "parse_walk"):
        ab_parse_walk(emit, timing, corpus, make_text_corpus(DYN_TEXT_BLOCKS))
    if args.only in (None, "emit"):
        ab_emit(emit, timing, corpus, make_text_corpus(DYN_TEXT_BLOCKS))
    if args.only in ("decode_tables", "decode_planned", "match_walk", "match_dyn",
                     "parse_walk", "emit"):
        return finish(args, lines)
    nrows = BLOCK // 128
    planes = torch.from_numpy(np.frombuffer(corpus, np.uint8).reshape(1024, nrows, 128)
                              .copy()).cuda()
    for n, mm, values in ((64, 64, False), (64, 1024, True), (1024, 64, False),
                          (1024, 1024, True)) if args.only != "decode_flat" else ():
        x = planes[:n]
        kw = dict(offsets=mt.DEFAULT_OFFSETS, nrows=nrows, max_match=mm, emit_values=values)
        equal = same(mt.find_matches(x, **kw), omt.find_matches(x, **kw))
        res = turns(timing, lambda x=x, kw=kw: omt.find_matches(x, **kw),
                    lambda x=x, kw=kw: mt.find_matches(x, **kw), counted(omt, mt), 100)
        emit({"kernel": "match", "shape": f"{n} x 128 KiB, 26 offsets, max_match {mm}, "
              f"{'values' if values else 'indices'}", "equal": equal, **res})

    if args.only == "match":
        return finish(args, lines)
    rng = np.random.default_rng(7)
    raw_heavy = b"".join(
        rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes() if i % 8 else
        (b"raw-heavy batch %d " % i) * (BLOCK // 18 + 1) for i in range(256))[:256 * BLOCK]
    batches = {"bench 1024": planned_batch(btt, corpus, 1024),
               "text 256": planned_batch(btt, make_text_corpus(256), 256),
               "raw-heavy 256": planned_batch(btt, raw_heavy, 256)}
    for whole in ("bench 1024", "text 256"):
        rows, pt, comp_rows = batches[whole]
        for cls, idx in df.block_classes(pt).items():
            if idx.numel():
                batches[f"{whole.split()[0]}, {cls} ({idx.numel()} blocks)"] = (
                    *df.select_blocks(rows, pt, idx), comp_rows)
    batches = {f"{k} x 128 KiB": (*v, nrows) for k, v in batches.items()}
    batches |= large_flat_shapes(btt, df, corpus, make_text_corpus(256))
    for name, (rows, pt, comp_rows, out_rows) in batches.items():
        def new(rows=rows, pt=pt, cr=comp_rows, nr=out_rows):
            return df.decode_blocks_flat(rows, pt, comp_rows=cr, out_rows=nr)

        def prev(rows=rows, pt=pt, cr=comp_rows, nr=out_rows):
            return odf.decode_blocks_flat(rows, pt, comp_rows=cr, out_rows=nr)

        equal = same(new(), prev())
        emit({"kernel": "decode_flat", "shape": name, "equal": equal,
              **turns(timing, prev, new, counted(odf, df), 100)})
    return finish(args, lines)


def large_flat_shapes(btt, df, corpus: bytes, text: bytes) -> dict:
    """B1's shapes above 1024 rows: the bench corpus as 128 x 1 MiB and 128 x
    256 KiB, the text corpus as 32 x 1 MiB and 64 x 256 KiB, and one burst
    of the CLI's skewed suite (its first 32 blocks of 4 KiB to 1 MiB, LZ4,
    each on an 8192-row plane: ``cli.demo.make_skewed_input``, BASELINE
    config 4).  Name -> (rows, plan tensors, comp_rows, out_rows)."""
    from bitar_tpu_torch.cli.demo import make_skewed_input

    shapes = {}
    for name, data, block in (("bench 128 x 1 MiB", corpus, LARGE),
                              ("text 32 x 1 MiB", text, LARGE),
                              ("bench 128 x 256 KiB", corpus[:128 * MID], MID),
                              ("text 64 x 256 KiB", text[:64 * MID], MID)):
        shapes[name] = (*planned_batch(btt, data, len(data) // block, block), block // 128)
    data, sizes = make_skewed_input(LARGE, SKEWED_BLOCKS)
    rows, pt, comp_rows = planned_batch(btt, data, SKEWED_BLOCKS, LARGE, sizes, SKEWED_BURST)
    idx = torch.arange(SKEWED_BURST, device=rows.device)
    shapes[f"skewed burst {SKEWED_BURST} blocks of {min(sizes[:SKEWED_BURST]):,}-"
           f"{max(sizes[:SKEWED_BURST]):,} B, 8192-row planes"] = (
        *df.select_blocks(rows, pt, idx), comp_rows, LARGE // 128)
    return shapes


def ab_match_routes(emit, timing, mt, corpus: bytes) -> None:
    """B3's staged route ("old") against its device-memory route ("new") on
    the bench corpus at the shapes the main paths launch: 1024 x 128 KiB and
    128 x 1 MiB, ``DEFAULT_OFFSETS``, indices at max_match 64 (the ``tpu``
    matcher) and values at 1024 (``match_offsets``).  The device-memory
    route is forced by a ``tile_plan`` that gives window 0."""
    plan = mt.tile_plan

    def routed(x, kw, staged: bool):
        mt.tile_plan = plan if staged else (lambda *a: plan(*a) | {"window": 0})
        try:
            return mt.find_matches(x, **kw)
        finally:
            mt.tile_plan = plan

    flat = torch.from_numpy(np.frombuffer(corpus, np.uint8).copy()).cuda()
    for block in (BLOCK, 8 * BLOCK):
        x = flat.view(-1, block // 128, 128)
        for mm, values in ((64, False), (1024, True)):
            kw = dict(offsets=mt.DEFAULT_OFFSETS, nrows=block // 128, max_match=mm,
                      emit_values=values)
            assert plan(block, mt.DEFAULT_OFFSETS, mm)["window"] > 0
            equal = same(routed(x, kw, True), routed(x, kw, False))
            res = turns(timing, lambda x=x, kw=kw: routed(x, kw, True),
                        lambda x=x, kw=kw: routed(x, kw, False), counted(mt, mt), 100)
            emit({"kernel": "match", "shape": f"{x.shape[0]} x {block >> 10} KiB, 26 offsets, "
                  f"max_match {mm}, {'values' if values else 'indices'}",
                  "routes": "old: staged window, new: device memory", "equal": equal, **res})


def ab_flat_sources(emit, timing, btt, df, corpus: bytes) -> None:
    """B1 on a resident unit's slots gathered into contiguous rows ("old")
    against B1 reading the same slots where they lie, through the unit's
    slot table over the arena ("new"): the bench corpus as 1024 x 128 KiB
    (the engine's slot order, and the slots scattered in a random order over
    a buffer twice as tall) and as 128 x 1 MiB (the slice kernel).  A last
    line per engine times the arena gather and B1 together against B1 in
    place (CUDA events and host clock): what a scan's copy cost the card."""
    for name, nblocks, block in (("bench 1024 x 128 KiB", 1024, BLOCK),
                                 ("bench 128 x 1 MiB", 128, LARGE)):
        cfg = btt.EngineConfig(codec=btt.Codec.LZ4, block_size=block, burst_size=nblocks,
                               max_pool_slots=nblocks + 32, commit="deferred")
        eng = btt.Engine(cfg, device="cuda").initialize()
        unit = eng.compress(corpus[:nblocks * block])
        eng.ensure_plans(unit)
        pt, cr, nr = unit.plan_device_arrays(), unit.plan_comp_rows, block // 128
        buf, table = eng.arena.buffer, unit.slot_table()
        sources = {name: (buf, table)}
        if block == BLOCK:
            g = torch.Generator().manual_seed(7)
            rows = torch.randperm(2 * nblocks, generator=g)[:nblocks].cuda()
            scattered = torch.zeros((2 * nblocks, buf.shape[1]), dtype=torch.uint8,
                                    device=buf.device)
            scattered[rows] = buf[table.long()]
            sources[f"{name}, slots permuted over {2 * nblocks} rows"] = (scattered, rows.int())
        for shape, (b, t) in sources.items():
            gathered = b.index_select(0, t)

            def prev(g=gathered):
                return df.decode_blocks_flat(g, pt, comp_rows=cr, out_rows=nr)

            def new(b=b, t=t):
                return df.decode_blocks_flat(b, pt, comp_rows=cr, out_rows=nr, src_rows=t)

            equal = same(new(), prev())
            emit({"kernel": "decode_flat", "shape": shape,
                  "routes": "old: gathered rows, new: slot table over the arena",
                  "equal": equal, **turns(timing, prev, new, counted(df, df), 100)})
            del gathered

        def gather_then_b1():
            return df.decode_blocks_flat(buf.index_select(0, table), pt, comp_rows=cr,
                                         out_rows=nr)

        def in_place():
            return df.decode_blocks_flat(buf, pt, comp_rows=cr, out_rows=nr, src_rows=table)

        equal = same(in_place(), gather_then_b1())
        emit({"kernel": "decode_flat", "shape": name,
              "routes": "old: arena gather then B1, new: B1 in place",
              "equal": equal, **turns(timing, gather_then_b1, in_place, calls=100)})
        eng.recycle(unit)
        eng.release()


def call_us(fn, calls: int, sync: bool) -> list[float]:
    """Host microseconds of each of ``calls`` calls of ``fn`` (with
    ``sync``, each call and a synchronize after it); the device is
    synchronized before the first and after the last."""
    torch.cuda.synchronize()
    got = []
    for _ in range(calls):
        t0 = time.perf_counter_ns()
        fn()
        if sync:
            torch.cuda.synchronize()
        got.append((time.perf_counter_ns() - t0) / 1e3)
    torch.cuda.synchronize()
    return got


def quartiles(us: list[float]) -> dict:
    q1, med, q3 = statistics.quantiles(us, n=4)
    return {"median": med, "q1": q1, "q3": q3, "min": min(us), "calls": len(us)}


def ab_scan_host(emit, old, corpus: bytes) -> None:
    """The scan's host path (the ``lz4-128k.scan`` cell's call), untraced:
    µs per ``Engine.decompress_device`` on one resident 1024 x 128 KiB unit
    of the bench corpus (one burst of 1024, deferred commit), an engine of
    each checkout in one process, in turns (old, new, new, old) of
    ``SCAN_CALLS`` calls, each call timed: with no synchronize (the host's
    time alone, the card working behind it) and with one after each call
    (a scan as the benchmark's loop runs it).  A last line times this
    checkout's B1 launch on the same unit apart: ``prepare_flat_launch``
    and ``FlatLaunch.run`` (no synchronize)."""
    import bitar_tpu_torch as btt
    from bitar_tpu_torch.ops import decode_flat as df

    sides = {}
    for name, pkg in (("old", old), ("new", btt)):
        cfg = pkg.EngineConfig(codec=pkg.Codec.LZ4, block_size=BLOCK, burst_size=1024,
                               max_pool_slots=1024 + 32, commit="deferred")
        eng = pkg.Engine(cfg, device="cuda").initialize()
        unit = eng.compress(corpus[:1024 * BLOCK])
        eng.ensure_plans(unit)
        sides[name] = (eng, unit)
    planes = {name: torch.cat(eng.decompress_device(unit)) for name, (eng, unit) in sides.items()}
    equal = same(planes["new"], planes["old"])
    shape = "scan host path: decompress_device of one resident 1024 x 128 KiB unit"
    for sync in (False, True):
        us, medians = {"old": [], "new": []}, {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            eng, unit = sides[name]
            got = call_us(lambda eng=eng, unit=unit: eng.decompress_device(unit), SCAN_CALLS, sync)
            us[name] += got
            medians[name].append(statistics.median(got))
        emit({"kernel": "decode_flat", "shape": shape, "sync": sync, "equal": equal,
              **{f"{k}_us": quartiles(v) for k, v in us.items()}, "turn_medians_us": medians})
    eng, unit = sides["new"]
    kw = dict(comp_rows=unit.plan_comp_rows, out_rows=BLOCK // 128, src_rows=unit.slot_table())
    buf, pt = eng.arena.buffer, unit.plan_device_arrays()
    prepare = call_us(lambda: df.prepare_flat_launch(buf, pt, **kw), SCAN_CALLS, False)
    rec = df.prepare_flat_launch(buf, pt, **kw)
    run = call_us(rec.run, SCAN_CALLS, False)
    emit({"kernel": "decode_flat", "shape": "the new B1 launch record on the same unit",
          "equal": same(rec.run(), planes["new"]), "prepare_us": quartiles(prepare),
          "run_us": quartiles(run)})
    for eng, unit in sides.values():
        eng.recycle(unit)
        eng.release()


def resident_picks(units: int = 16, unit_blocks: int = 1024, picks: int = 1884,
                   seed: int = 22) -> dict:
    """A MultiGet step's B2 picks as the engine holds them: ``units`` x
    ``unit_blocks`` RocksDB data blocks of YCSB records (4 KiB, LZ4, the
    ``rocksdb-4k`` cell's generator, so it runs from the repository's root)
    resident in 8 KiB slots scattered over an arena twice as tall, their
    tables in a store one row a slot, and ``picks`` distinct blocks picked
    at random (a step's ~1,884).  On the card: ``buf`` [N, 8192] uint8,
    ``nseq`` [N] and ``tables`` {key: [N, S]} int32 (views of ``store``
    [5, N, S]), ``src`` the picks' rows [picks] int32; on the host
    ``comp_len`` (the picks' stored bytes) and ``shape``, a label."""
    from benchmark.reference import kv
    from bitar_tpu_torch.ops import decode_tables as dt
    from bitar_tpu_torch.ops.cpu.native import SEQUENCE_KEYS

    block, slot = 4096, 8192
    t = kv.make({"generator": "rocksdb_ycsb", "units": units, "unit_blocks": unit_blocks},
                2**31 + seed, block)
    ends = np.concatenate([[0], np.cumsum(t.sizes)])
    rows, tables, nseq, lens = dt.parser_tables(
        [t.raw[ends[i]:ends[i + 1]].tobytes() for i in range(t.sizes.size)], min_match=4)
    slots = np.zeros((rows.shape[0], slot), np.uint8)
    slots[:, :rows.shape[1]] = rows
    buf, ns, store, at = dt.resident_layout(slots, tables, nseq, seed)
    pick = np.random.default_rng(seed).choice(at.size, picks, replace=False)
    buf, ns, store = (torch.from_numpy(a).cuda() for a in (buf, ns, store))
    return {"buf": buf, "nseq": ns, "store": store,
            "tables": dict(zip(SEQUENCE_KEYS, store.unbind(0), strict=True)),
            "src": torch.from_numpy(at[pick]).cuda(), "comp_len": np.asarray(lens)[pick],
            "sequences": int(nseq[pick].sum()), "max_per_block": int(nseq[pick].max()),
            "shape": f"{picks} YCSB 4 KiB picks of {units} x {unit_blocks} blocks, 8 KiB "
                     f"slots permuted over {buf.shape[0]} rows"}


def ab_table_sources(emit, timing) -> None:
    """B2 on a MultiGet step's picks as the engine holds them
    (:func:`resident_picks`).  First line: B2 on the picks' rows and tables
    gathered ("old") against B2 through the picks' slots ("new"), kernel
    only (events, held, host clock).  Second: the arena gather, the two
    table-store gathers and B2 against B2 in place, as
    ``Engine.decompress_blocks_device`` ran them before and now (events,
    host clock)."""
    from bitar_tpu_torch.ops import decode_tables as dt
    from bitar_tpu_torch.ops.cpu.native import SEQUENCE_KEYS

    r = resident_picks()
    buf, ns, store, views, src = r["buf"], r["nseq"], r["store"], r["tables"], r["src"]
    kw = dict(out_rows=4096 // 128)
    g_rows, g_ns = buf.index_select(0, src), ns.index_select(0, src)
    g_tables = {k: v.index_select(0, src) for k, v in views.items()}

    def gathered():
        return dt.decode_blocks(g_rows, g_ns, g_tables, **kw)

    def in_place():
        return dt.decode_blocks(buf, ns, views, src_rows=src, **kw)

    def gather_then_b2():
        cols = store.index_select(1, src)
        return dt.decode_blocks(buf.index_select(0, src), ns.index_select(0, src),
                                dict(zip(SEQUENCE_KEYS, cols.unbind(0), strict=True)), **kw)

    extra = {"sequences": r["sequences"], "max_per_block": r["max_per_block"]}
    equal = same(in_place(), gathered())
    emit({"kernel": "decode_tables", "shape": r["shape"], **extra,
          "routes": "old: gathered rows and tables, new: slot table over the arena and store",
          "equal": equal, **turns(timing, gathered, in_place, counted(dt, dt), 1000)})
    equal = same(in_place(), gather_then_b2())
    emit({"kernel": "decode_tables", "shape": r["shape"],
          "routes": "old: arena and table-store gathers then B2, new: B2 in place",
          "equal": equal, **turns(timing, gather_then_b2, in_place, calls=1000)})


def table_shapes(corpus: bytes, text: bytes) -> dict:
    """B2's shapes: the engine's 4 KiB burst and 8192 blocks of the bench
    corpus, 256 x 128 KiB of it (the parallel tables step's) and 256 x 128
    KiB of markdown (deep tables), and the cluster route's: 32 x 1 MiB of
    the bench corpus and of markdown, and 128 x 256 KiB of the bench corpus;
    numpy (rows, tables, nseq, block)."""
    from bitar_tpu_torch.ops import decode_tables as dt

    def tables(data: bytes, n: int, block: int):
        return (*dt.parser_tables([data[i * block:(i + 1) * block] for i in range(n)])[:3],
                block)

    small = 4096
    b4 = dt.parser_tables([corpus[i * small:(i + 1) * small] for i in range(8192)])[:3]
    return {"burst 1024 x 4 KiB": (b4[0][:1024], {k: v[:1024] for k, v in b4[1].items()},
                                   b4[2][:1024], small),
            "bench 8192 x 4 KiB": (*b4, small),
            "bench 256 x 128 KiB": tables(corpus, 256, BLOCK),
            "deep text 256 x 128 KiB": tables(text, 256, BLOCK),
            "bench 32 x 1 MiB": tables(corpus, 32, LARGE),
            "text 32 x 1 MiB": tables(text, 32, LARGE),
            "bench 128 x 256 KiB": tables(corpus, 128, MID)}


def ab_tables(emit, timing, corpus: bytes, text: bytes) -> None:
    from bitar_tpu_torch.ops import decode_tables as dt
    from bitar_tpu_torch_old.ops import decode_tables as odt

    for name, (rows, tables, nseq, block) in table_shapes(corpus, text).items():
        r = torch.from_numpy(rows).cuda()
        tn, tt = dt.table_tensors(tables, nseq, "cuda")
        kw = dict(out_rows=block // 128)

        def new(r=r, tn=tn, tt=tt, kw=kw):
            return dt.decode_blocks(r, tn, tt, **kw)

        def prev(r=r, tn=tn, tt=tt, kw=kw):
            return odt.decode_blocks(r, tn, tt, **kw)

        equal = same(new(), prev())
        emit({"kernel": "decode_tables", "shape": name, "sequences": int(nseq.sum()),
              "max_per_block": int(nseq.max()), "equal": equal,
              **turns(timing, prev, new, counted(odt, dt),
                      1000 if block <= 4096 else 100)})


def planned_shapes(dp, corpus: bytes, text: bytes) -> dict:
    """B7's shapes on the card: name -> ([comp, p_used, se, shift] on the
    card, keywords).  The shared route at the bench's 128 KiB shape, as
    planned and sorted by descending p_used; the tall route on 32 x 1 MiB of
    the bench corpus (64-pass budget, the same 32 MiB), the quiet blocks of
    that batch alone (no plane-reading pass: ``slice_stops``), text at 4 x 1
    MiB and 4 x 256 KiB (256 passes), pass-class plans at 8192 rows, and an
    all-quiet batch of pass-class plans at 8192 rows."""
    def planned(data: bytes, n: int, block: int, budget: int):
        wire = dp.plan_blocks([data[i * block:(i + 1) * block] for i in range(n)], block, budget)
        args = [torch.from_numpy(wire[k]).cuda() for k in ("comp", "p_used", "se", "shift")]
        return len(wire["fit"]), args, dict(passes=wire["passes"], comp_rows=wire["comp_rows"],
                                            out_rows=block // 128)

    def plans(arrays, comp_rows: int, out_rows: int):
        args = [torch.from_numpy(a).cuda() for a in arrays]
        return args, dict(passes=args[2].shape[1], comp_rows=comp_rows, out_rows=out_rows)

    shapes = {}
    n, args, kw = planned(corpus, 256, BLOCK, 64)
    order = torch.argsort(args[1], descending=True)
    shapes[f"bench {n} x 128 KiB, {kw['passes']} passes, as planned"] = (args, kw)
    shapes[f"bench {n} x 128 KiB, {kw['passes']} passes, sorted by descending p_used"] = (
        [t[order] for t in args], kw)
    n, args, kw = planned(corpus, 32, LARGE, 64)
    shapes[f"tall: bench {n} x 1 MiB, {kw['passes']} passes"] = (args, kw)
    stops = dp.slice_stops(*args[2:], args[1], **kw)
    quiet = (stops.min(1).values >= args[1].clamp(0, kw["passes"])).nonzero().flatten()
    if quiet.numel():
        shapes[f"tall: bench 1 MiB, its {quiet.numel()} quiet blocks"] = (
            [t[quiet] for t in args], kw)
    for block in (LARGE, MID):
        n, args, kw = planned(text, 4, block, 256)
        shapes[f"tall: text {n} x {block // 1024} KiB, {kw['passes']} passes"] = (args, kw)
    reads = [False] * 4 + [True, False] * 4
    shapes["tall: class plans 16 x 8192 rows, cccc(Pc)x4"] = plans(
        dp.class_plans(31, 16, reads, 512, 8192), 512, 8192)
    shapes["tall: class plans 32 x 8192 rows, 16 comp-only passes (all quiet)"] = plans(
        dp.class_plans(32, 32, [False] * 16, 512, 8192), 512, 8192)
    return shapes


def ab_planned(emit, timing, corpus: bytes, text: bytes) -> None:
    from bitar_tpu_torch.ops import decode_planned as dp
    from bitar_tpu_torch_old.ops import decode_planned as odp

    shapes = planned_shapes(dp, corpus, text)
    for name, (a, kw) in shapes.items():
        def new(a=a, kw=kw):
            return dp.decode_blocks_planned(*a, **kw)

        equal = same(new(), odp.decode_blocks_planned(*a, **kw))
        emit({"kernel": "decode_planned", "shape": name, "equal": equal,
              **turns(timing, lambda a=a, kw=kw: odp.decode_blocks_planned(*a, **kw), new,
                      counted(odp, dp), 100)})
    # This checkout's two routes on the same 32 MiB of the bench corpus:
    # "old" the shared route at 128 KiB blocks, "new" the tall route at 1 MiB.
    sa, skw = next(v for k, v in shapes.items() if k.endswith("as planned"))
    ta, tkw = next(v for k, v in shapes.items() if k.startswith("tall: bench")
                   and k.endswith("passes"))
    raw = {}
    for side, a, kw in (("old", sa, skw), ("new", ta, tkw)):
        out = dp.decode_blocks_planned(*a, **kw).reshape(-1).cpu().numpy().tobytes()
        raw[side] = out == corpus[:len(out)]
    emit({"kernel": "decode_planned", "shape": "routes on the same bytes: old = shared route, "
          f"bench {sa[0].shape[0]} x 128 KiB; new = tall route, bench {ta[0].shape[0]} x 1 MiB",
          "equal": all(raw.values()), "raw_bytes": {"old": sa[0].shape[0] * BLOCK,
                                                    "new": ta[0].shape[0] * LARGE},
          **turns(timing, lambda: dp.decode_blocks_planned(*sa, **skw),
                  lambda: dp.decode_blocks_planned(*ta, **tkw), counted(dp, dp), 100)})


def ab_match_dyn(emit, timing, corpus: bytes, text: bytes, only: str | None) -> None:
    from bitar_tpu_torch.ops import device_compress as dc
    from bitar_tpu_torch.ops import match_dyn as md
    from bitar_tpu_torch_old.ops import match_dyn as omd

    nrows = BLOCK // 128

    def batch(data: bytes, n: int, fft: bool):
        planes = torch.from_numpy(np.frombuffer(data[:n * BLOCK], np.uint8)
                                  .reshape(n, BLOCK).copy()).cuda()
        noff, offs = dc.candidate_offsets(planes, detect_fft=fft, fft_k=6)
        lengths = torch.full((n,), BLOCK, dtype=torch.int32, device=planes.device)
        return planes.view(n, nrows, 128), noff, offs, lengths

    walk_kw = dict(nrows=nrows, seg=1024, min_match=6, max_match=1024)
    for name, (x, noff, offs, lengths) in (
            ("bench", batch(corpus, WALK_BLOCKS, False)),
            ("text detect_fft", batch(text, DYN_TEXT_BLOCKS, True))):
        shape = (f"{name} {x.shape[0]} x 128 KiB, offsets a block {noff.float().mean():.2f} "
                 f"(K {offs.shape[1]})")
        if only in (None, "match_walk"):
            def new(a=(x, noff, offs, lengths)):
                return md.find_matches_parse_dyn(*a, **walk_kw)

            def prev(a=(x, noff, offs, lengths)):
                return omd.find_matches_parse_dyn(*a, **walk_kw)

            equal = same(new(), prev())
            emit({"kernel": "match_walk", "shape": f"{shape}, seg 1024, max_match 1024",
                  "equal": equal,
                  **turns(timing, prev, new, counted(omd, md, "walk_launches"), 100)})
        if only in (None, "match_dyn"):
            xd = x[:DYN_BLOCKS] if name == "bench" else x

            def new(a=(xd, noff[:xd.shape[0]], offs[:xd.shape[0]])):
                return md.find_matches_dyn(*a, nrows=nrows, max_match=256)

            def prev(a=(xd, noff[:xd.shape[0]], offs[:xd.shape[0]])):
                return omd.find_matches_dyn(*a, nrows=nrows, max_match=256)

            equal = same(new(), prev())
            emit({"kernel": "match_dyn", "shape": f"{name} {xd.shape[0]} x 128 KiB, "
                  f"max_match 256", "equal": equal,
                  **turns(timing, prev, new, counted(omd, md, "dyn_launches"), 100)})


def emit_shapes(corpus: bytes, text: bytes) -> dict:
    """The emitter's launches on the main paths, on the card: name ->
    (planes, layout, out_width, lengths or None).  ``corpus`` holds 1024
    blocks of the bench corpus, ``text`` 64 of the text corpus.

    - bench 256 x 128 KiB at width 2048 (the row the smoke timed first; no
      lengths, as the smoke always timed it);
    - the engine's device path: 1024 x 128 KiB through ``match_parse_device``
      (seg 1024, S 1025) at the engine's own width (``engine_width``);
    - ``match_offsets``: the same corpus through B3 with the worst-case
      sequence budget (S 21,889), at the same width rule;
    - text with ``detect_fft=True, fft_k=6``, 64 x 128 KiB at width 65536;
    - ``compress_blocks_device(seg=256)``: 64 x 128 KiB, S 4097, at
      ``adaptive_width``."""
    from bitar_tpu_torch.ops import device_compress as dc
    from bitar_tpu_torch.ops.match import DEFAULT_OFFSETS

    def planes_of(data: bytes, n: int):
        pl = torch.from_numpy(np.frombuffer(data[:n * BLOCK], np.uint8).reshape(n, BLOCK)
                              .copy()).cuda()
        return pl, torch.full((n,), BLOCK, dtype=torch.int32, device=pl.device)

    def widths(lay, ln, rule):
        return rule(lay["total"].cpu().numpy(), ln.cpu().numpy(), BLOCK)

    big, blen = planes_of(corpus, 1024)
    shapes = {}
    lay = dc.match_parse_device(big[:WALK_BLOCKS], blen[:WALK_BLOCKS])
    shapes[f"bench {WALK_BLOCKS} x 128 KiB, width 2048"] = (big[:WALK_BLOCKS], lay, 2048, None)
    for name, kw in (("engine device path", {}),
                     ("match_offsets", {"offsets": DEFAULT_OFFSETS})):
        lay = dc.match_parse_device(big, blen, **kw)
        ow = widths(lay, blen, dc.engine_width)
        shapes[f"{name} 1024 x 128 KiB, width {ow}"] = (big, lay, ow, blen)
    tpl, tlen = planes_of(text, DYN_TEXT_BLOCKS)
    lay = dc.match_parse_device(tpl, tlen, detect_fft=True, fft_k=6)
    shapes[f"text detect_fft {DYN_TEXT_BLOCKS} x 128 KiB, width 65536"] = (tpl, lay, 65536, tlen)
    spl, slen = big[:DYN_BLOCKS], blen[:DYN_BLOCKS]
    lay = dc.match_parse_device(spl, slen, seg=256)
    ow = widths(lay, slen, lambda s, ln, L: dc.adaptive_width(s, ln, L, 256))
    shapes[f"seg 256 {DYN_BLOCKS} x 128 KiB, width {ow}"] = (spl, lay, ow, slen)
    return shapes


def ab_emit(emit, timing, corpus: bytes, text: bytes) -> None:
    from bitar_tpu_torch.ops import emit as em
    from bitar_tpu_torch_old.ops import emit as oem

    for name, (pl, lay, ow, ln) in emit_shapes(corpus, text).items():
        def new(pl=pl, lay=lay, ow=ow, ln=ln):
            return em.emit_blocks(pl, lay, out_width=ow, lengths=ln)

        def prev(pl=pl, lay=lay, ow=ow, ln=ln):
            return oem.emit_blocks(pl, lay, out_width=ow, lengths=ln)

        equal = same(new(), prev())
        rec = {"kernel": "emit", "shape": name, "slots": lay["starts"].shape[1],
               "out_mib": pl.shape[0] * ow / 2**20,
               "bound_ms": timing.bound_ms(em.bound_bytes(lay, ow))[0], "equal": equal}
        rec["floor_kernel_ms"] = em.floor_kernel_ms(pl.shape[0], lay["starts"].shape[1], ow,
                                                    timing, REPS)
        emit(rec | turns(timing, prev, new, counted(oem, em), 200))


def ab_parse_walk(emit, timing, corpus: bytes, text: bytes) -> None:
    from bitar_tpu_torch.ops import device_compress as dc
    from bitar_tpu_torch.ops import match_dyn as md
    from bitar_tpu_torch_old.ops import match_dyn as omd

    nrows = BLOCK // 128
    for name, data, n, fft in (("bench B4 planes", corpus, WALK_BLOCKS, False),
                               ("text detect_fft B4 planes", text, DYN_TEXT_BLOCKS, True)):
        planes = torch.from_numpy(np.frombuffer(data[:n * BLOCK], np.uint8)
                                  .reshape(n, BLOCK).copy()).cuda()
        noff, offs = dc.candidate_offsets(planes, detect_fft=fft, fft_k=6)
        lengths = torch.full((n,), BLOCK, dtype=torch.int32, device=planes.device)
        mlen, moff = (t.reshape(n, BLOCK) for t in md.find_matches_dyn(
            planes.view(n, nrows, 128), noff, offs, nrows=nrows, max_match=1024))
        kw = dict(seg=1024, min_match=6, wcap=8)

        def new(a=(mlen, moff, lengths)):
            return md.parse_walk_dyn(*a, **kw)

        def prev(a=(mlen, moff, lengths)):
            return omd.parse_walk_dyn(*a, **kw)

        got = new()
        equal = same(got, prev())
        bound = md.walk_bound_bytes(mlen, moff, lengths, got[0], got[1], **kw)
        emit({"kernel": "parse_walk", "shape": f"{name}, {n} x 128 KiB, seg 1024, wcap 8",
              "sequences": int((got[0] >= 0).sum()),
              "bound_ms": timing.bound_ms(bound)[0], "equal": equal,
              **turns(timing, prev, new, counted(omd, md, "parse_walk_launches"), 200)})


def finish(args, lines: list[str]) -> int:
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    if not all(json.loads(line)["equal"] for line in lines):
        print("kernel_ab: the two checkouts' kernels disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
