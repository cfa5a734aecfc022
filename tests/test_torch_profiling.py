"""The port's spans and counters (``utils.profiling``) on the CPU.

A span or counter is on exactly while a ``torch.profiler`` records in the
process; off, nothing is recorded.  On, the engine's scan, read and plan
paths and the fused shuffle step record the spans named in their
docstrings as ``user_annotation``s of the profiler's Chrome trace, nested in
time as the calls nest (a readback on a pool thread inside its caller's
span, where the profiler records every thread), and sum the counters named
there.  Units: 8 blocks of 16 KiB (text, low-entropy, random and RLE,
twice) in bursts of 4 through the plain PyTorch versions.
"""

import json
import tempfile
import threading
import time
from pathlib import Path

import pytest
import torch

import bitar_tpu_torch as btt
from bitar_tpu_torch.parallel import dryrun
from bitar_tpu_torch.utils import profiling
from bitar_tpu_torch.utils.corpus import BLOCK as CORPUS_BLOCK
from bitar_tpu_torch.utils.corpus import make_corpus

torch.set_num_threads(1)

BLOCK = 16 * 1024
NBLOCKS = 8
BURST = 4
DELAY_S = 0.05                # a held plan lock


def data() -> bytes:
    corpus = make_corpus(4)
    kinds = [corpus[k * CORPUS_BLOCK:k * CORPUS_BLOCK + BLOCK] for k in range(4)]
    return b"".join(kinds * 2)


def engine(**kw) -> btt.Engine:
    kw = dict(block_size=BLOCK, burst_size=BURST, max_pool_slots=64, plan_build="lazy") | kw
    return btt.Engine(btt.EngineConfig(codec=btt.Codec.LZ4, **kw), device="cpu").initialize()


def cpu_profiler(all_threads: bool = False):
    kw = {}
    if all_threads:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], **kw)


def trace_annotations(prof) -> list[tuple[str, float, float, int]]:
    """The ``bitar.`` annotations of ``prof``'s Chrome trace: (name, ts, end, tid)."""
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        events = json.loads(Path(f.name).read_text())["traceEvents"]
    return annotations_of(events)


def annotations_of(events) -> list[tuple[str, float, float, int]]:
    return [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
            if e.get("cat") == "user_annotation" and e["name"].startswith("bitar.")]


def within(child, parents, same_thread: bool = True) -> bool:
    """``child`` lies inside one of ``parents`` in time (and on its thread)."""
    return any(p[1] <= child[1] and child[2] <= p[2] and (p[3] == child[3] or not same_thread)
               for p in parents)


def calls(ann) -> dict[str, int]:
    """Annotations by name: how many."""
    out: dict[str, int] = {}
    for a in ann:
        out[a[0]] = out.get(a[0], 0) + 1
    return out


@pytest.fixture
def store():
    """The process-wide counters, empty for the test."""
    profiling.snapshot(reset=True)
    yield
    profiling.snapshot(reset=True)


@pytest.fixture
def planned():
    """(engine, unit): the unit compressed and planned, tracing off."""
    eng = engine()
    unit = eng.compress(data())
    eng.ensure_plans(unit)
    yield eng, unit
    eng.recycle(unit)
    eng.release()


def test_off_records_nothing_and_allocates_no_span(store, planned):
    eng, unit = planned
    assert not profiling.enabled()
    assert profiling.annotate("bitar.a") is profiling.annotate("bitar.b")
    with profiling.annotate("bitar.test.off"):
        profiling.count("test.off", 5)
    eng.decompress_device(unit)
    eng.decompress(unit)
    assert profiling.snapshot() == {}


def test_decompress_device_spans_nest_and_gather_counts(store, planned):
    eng, unit = planned
    with cpu_profiler() as prof:
        assert profiling.enabled()
        planes = eng.decompress_device(unit)
    ann = trace_annotations(prof)
    assert calls(ann) == {"bitar.engine.decompress_device": 1,
                          "bitar.arena.gather_burst": NBLOCKS // BURST,
                          "bitar.ops.decode_flat": NBLOCKS // BURST}
    stored = int(unit.manifest.comp_len.sum())
    assert stored < NBLOCKS * eng.config.slot_size            # the slots hold more than the blocks
    assert profiling.snapshot() == {"arena.gather_bytes": NBLOCKS * eng.config.slot_size,
                                    "arena.gather_stored_bytes": stored,
                                    "decode_flat.blocks": NBLOCKS}
    assert b"".join(p.reshape(p.shape[0], -1).numpy().tobytes() for p in planes) == data()
    parents = [a for a in ann if a[0] == "bitar.engine.decompress_device"]
    children = [a for a in ann if a[0] != "bitar.engine.decompress_device"]
    assert len(parents) == 1 and len(children) == 2 * NBLOCKS // BURST
    assert all(within(c, parents) for c in children)


def test_decompress_counts_readback_and_copy_out_under_the_callers_span(store, planned):
    eng, unit = planned
    with cpu_profiler(all_threads=True) as prof:
        out = eng.decompress(unit)
    assert out.tobytes() == data()
    ann = trace_annotations(prof)
    n = calls(ann)
    assert n["bitar.engine.readback"] == n["bitar.engine.copy_out"] == NBLOCKS // BURST
    counters = profiling.snapshot()
    assert counters["engine.readback_bytes"] == NBLOCKS * BLOCK      # [burst, rows, 128] planes
    assert counters["engine.copy_out_bytes"] == unit.manifest.total_raw
    # The readbacks ran on pool threads, inside the caller's span in time.
    top = [a for a in ann if a[0] == "bitar.engine.decompress"]
    reads = [a for a in ann if a[0] == "bitar.engine.readback"]
    assert len(top) == 1 and all(r[3] != top[0][3] for r in reads)
    assert all(within(r, top, same_thread=False) for r in reads)
    copies = [a for a in ann if a[0] == "bitar.engine.copy_out"]
    assert all(within(c, top) for c in copies)


def test_ensure_plans_of_a_deferred_background_unit(store):
    eng = engine(commit="deferred", plan_build="background")
    held, submitted = threading.Event(), threading.Event()

    def hold_the_plan_lock():
        with btt.Engine._PLAN_LOCK:
            held.set()
            submitted.wait(10)
            time.sleep(DELAY_S)

    holder = threading.Thread(target=hold_the_plan_lock)
    with cpu_profiler(all_threads=True) as prof:
        holder.start()
        assert held.wait(10)
        unit = eng.compress(data())             # its background build waits for the lock
        submitted.set()
        eng.ensure_plans(unit)
    holder.join(10)
    assert not holder.is_alive()
    ann = trace_annotations(prof)
    assert {"bitar.engine.ensure_plans", "bitar.engine.commit_upload", "bitar.engine.plan_join",
            "bitar.engine.plan_build", "bitar.engine.plan_lock_wait"} <= set(calls(ann))
    # The background build waited out the holder's lock, on its own thread.
    waits = [a[2] - a[1] for a in ann if a[0] == "bitar.engine.plan_lock_wait"]
    assert max(waits) >= DELAY_S * 1e6 / 2                               # µs, less its start
    assert profiling.snapshot()["engine.commit_bytes"] >= int(unit.manifest.comp_len.sum())
    assert unit.plan_flat is not None
    assert eng.decompress(unit).tobytes() == data()
    eng.recycle(unit)
    eng.release()


def test_count_sums_and_snapshot_resets(store):
    with cpu_profiler():
        profiling.count("test.n", 2)
        profiling.count("test.n", 3)
    profiling.count("test.n", 100)             # off again
    assert profiling.snapshot(reset=True) == {"test.n": 5}
    assert profiling.snapshot() == {}


def test_key_averages_sum_the_spans_by_name(store):
    with cpu_profiler() as prof:
        for _ in range(3):
            with profiling.annotate("bitar.test.span"):
                with profiling.annotate("bitar.test.child"):
                    pass
    avg = {e.key: e for e in prof.key_averages() if e.key.startswith("bitar.")}
    assert set(avg) == {"bitar.test.span", "bitar.test.child"}
    assert avg["bitar.test.span"].count == avg["bitar.test.child"].count == 3
    assert avg["bitar.test.child"].cpu_time_total <= avg["bitar.test.span"].cpu_time_total


def test_the_chrome_trace_holds_the_stores_names(store, planned, tmp_path):
    eng, unit = planned
    with profiling.device_trace(str(tmp_path)):
        eng.decompress_device(unit)
        eng.decompress(unit)
    (path,) = tmp_path.glob("trace-*.json")
    names = {a[0] for a in annotations_of(json.loads(path.read_text())["traceEvents"])}
    assert names == {"bitar.engine.decompress_device", "bitar.arena.gather_burst",
                     "bitar.ops.decode_flat", "bitar.engine.decompress",
                     "bitar.engine.readback", "bitar.engine.copy_out"}
    # decompress runs the bursts' records that decompress_device built.
    assert set(profiling.snapshot()) == {"arena.gather_bytes", "arena.gather_stored_bytes",
                                         "decode_flat.blocks", "decode_flat.prepared_blocks",
                                         "engine.readback_bytes", "engine.copy_out_bytes"}


def traced_flat_step(mesh, spec: dict) -> dict:
    """One rank of a world: ``steps_program``'s fused flat step under a CPU
    profiler; the rank's ``bitar.`` annotations and counters."""
    profiling.snapshot(reset=True)
    with cpu_profiler() as prof:
        res = dryrun.steps_program(mesh, dict(spec, steps=("flat",)))
    return {"exact": res["flat"]["exact"], "annotations": trace_annotations(prof),
            "snapshot": profiling.snapshot()}


def test_a_gloo_step_nests_staging_exchange_and_decode():
    res = dryrun.run_world(2, traced_flat_step, {"nblocks": 4, "block": BLOCK},
                           device_type="cpu", timeout=240.0)
    for r in res:
        assert r["exact"]
        names = ("bitar.shuffle.stage_rows", "bitar.shuffle.all_to_all_rows",
                 "bitar.ops.decode_flat")
        assert calls(r["annotations"]) == dict.fromkeys(
            ("bitar.parallel.distributed_step_flat", *names), 1)
        steps = [a for a in r["annotations"] if a[0] == "bitar.parallel.distributed_step_flat"]
        assert len(steps) == 1
        for name in names:
            (child,) = [a for a in r["annotations"] if a[0] == name]
            assert within(child, steps), name
        c = r["snapshot"]
        assert c["shuffle.staged_bytes"] > 0 and c["decode_flat.blocks"] > 0
