"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: the quickest proof
that the port still starts on the card.

    python3 chip_smoke.py [--profile]

Phases (any failure raises, and the script exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the host codec library (g++) and the decode kernel (nvcc, sm_90a)
   from the sources in the checkout, timed;
3. kernel against its plain PyTorch version on the card, byte for byte, on
   the plans of the bench corpus (1024 x 128 KiB), of the markdown text
   corpus (256 x 128 KiB, the deepest out-pass schedules) and of a
   RAW-heavy batch;
4. the main path, LZ4 then Snappy, at the bench's size:
   ``Engine(EngineConfig(block_size=128 KiB, burst_size=1024,
   max_pool_slots=1056, commit="deferred"), device="cuda")`` ->
   ``compress`` -> ``ensure_plans`` -> ``decompress`` (bit-exact, no block
   decoded on the host) -> ``prepare_device_decode`` (same bytes) ->
   ``recycle``, with the kernel's launch count reset before and read after;
5. decode time with CUDA events, kernel and plain version in turns (plain,
   kernel, kernel, plain), at the bench shape and on the text corpus;
6. only with ``--profile``: where the time of the main path goes, for one
   warm LZ4 unit (a second unit on the same engine): each step on the host
   clock with a device sync after it, ``torch.profiler`` over its first
   ``decompress`` (``profile:`` lines, one per operator, by device time),
   and a second ``decompress`` unprofiled.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA the script
prints no result and exits 1.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

BLOCK = 128 * 1024
NBLOCKS = 1024
TEXT_BLOCKS = 256
RAW_BLOCKS = 256
TIMED_REPS = (3, 20)          # (plain, kernel) launches per timed turn


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def engine(btt, codec):
    cfg = btt.EngineConfig(codec=codec, block_size=BLOCK, burst_size=NBLOCKS,
                           max_pool_slots=NBLOCKS + 32, commit="deferred")
    return btt.Engine(cfg, device="cuda").initialize()


def planned_batch(btt, data: bytes):
    """Compress ``data`` through a fresh engine; return the unit's gathered
    comp rows, plan tensors and comp_rows (the kernel's real inputs)."""
    eng = engine(btt, btt.Codec.LZ4)
    unit = eng.compress(data)
    eng.ensure_plans(unit)
    pf = unit.plan_flat
    rows = eng.arena.gather_burst([r.slot for r in unit.refs])
    stats = (f"blocks={unit.nblocks} ratio={unit.manifest.ratio():.3f} "
             f"passes={int(pf['p_used'].sum())} "
             f"dense_passes={int(np.maximum(pf['dense'], 0).sum())} "
             f"raw_blocks={int((pf['dense'] < 0).sum())} "
             f"host_blocks={pf['host_blocks'].size}")
    batch = (rows, unit.plan_device_arrays(), unit.plan_comp_rows, stats)
    eng.recycle(unit)
    eng.release()
    return batch


def compare(df, rows, pt, comp_rows) -> int:
    """Kernel vs plain version on the same inputs; returns max |diff|."""
    got = df.decode_blocks_flat(rows, pt, comp_rows=comp_rows, out_rows=BLOCK // 128)
    torch.cuda.synchronize()
    want = df.decode_flat_reference(rows, pt, comp_rows, BLOCK // 128)
    err = int((got.int() - want.int()).abs().max())
    if err != 0 or not torch.equal(got, want):
        bad = int((got != want).reshape(got.shape[0], -1).any(1).sum())
        raise AssertionError(f"kernel != plain version on {bad} blocks (max |diff| {err})")
    return err


def main_path(btt, df, codec, data: bytes) -> None:
    eng = engine(btt, codec)
    t0 = time.perf_counter()
    unit = eng.compress(data)
    t1 = time.perf_counter()
    eng.ensure_plans(unit)
    t2 = time.perf_counter()
    out = eng.decompress(unit)
    t3 = time.perf_counter()
    if out.tobytes() != data:
        raise AssertionError(f"{codec.value}: round trip not bit-exact")
    host = unit.plan_flat["host_blocks"]
    if host.size:
        raise AssertionError(f"{codec.value}: {host.size} blocks decoded on the host")
    planes = eng.prepare_device_decode(unit)()
    got = planes.reshape(unit.nblocks, -1)[:, :BLOCK].cpu().numpy().tobytes()
    if got != data:
        raise AssertionError(f"{codec.value}: prepare_device_decode bytes differ")
    n = eng.recycle(unit)
    eng.release()
    if n != unit.nblocks:
        raise AssertionError(f"{codec.value}: recycled {n} of {unit.nblocks} slots")
    log(f"main path {codec.value}: {unit.nblocks} x {BLOCK} B bit-exact, "
        f"ratio {unit.manifest.ratio():.3f}, host-decoded blocks 0; "
        f"host clock: compress {1e3 * (t1 - t0):.1f} ms, plan join "
        f"{1e3 * (t2 - t1):.1f} ms, decompress incl. readback "
        f"{1e3 * (t3 - t2):.1f} ms")


def timed(timing, df, rows, pt, comp_rows, card: str, label: str):
    """Plain, kernel, kernel, plain: mean ms per launch of each."""
    nrows = BLOCK // 128

    def kernel():
        df.decode_blocks_flat(rows, pt, comp_rows=comp_rows, out_rows=nrows)

    def plain():
        df.decode_flat_reference(rows, pt, comp_rows, nrows)

    plain_reps, kernel_reps = TIMED_REPS
    turns = [("plain", plain, plain_reps), ("kernel", kernel, kernel_reps),
             ("kernel", kernel, kernel_reps), ("plain", plain, plain_reps)]
    ms = {"plain": [], "kernel": []}
    for name, fn, reps in turns:
        ms[name].append(timing.device_time_ms(fn, reps))
    raw = rows.shape[0] * BLOCK
    res = {k: sum(v) / len(v) for k, v in ms.items()}
    for k in ("kernel", "plain"):
        log(f"decode {label} [{card}] {k}: {res[k]:.4f} ms/launch "
            f"(turns {', '.join(f'{x:.4f}' for x in ms[k])}), "
            f"{raw / res[k] / 1e6:.3f} GB/s of raw bytes")
    return res["kernel"], res["plain"]


def profile_main_path(btt, data: bytes, card: str, top: int = 12) -> None:
    """Phase breakdown of one warm LZ4 unit through the main path."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities):
        torch.ones(1, device="cuda").add_(1)     # pays the tracer's start-up here
    eng = engine(btt, btt.Codec.LZ4)
    warm = eng.compress(data)
    eng.decompress(warm)
    eng.recycle(warm)
    clock = [("start", time.perf_counter())]

    def mark(phase: str) -> None:
        torch.cuda.synchronize()
        clock.append((phase, time.perf_counter()))

    unit = eng.compress(data)
    mark("compress (host matcher; plan build queued)")
    eng._ensure_committed(unit)       # the upload ensure_plans would start
    mark("commit upload (H2D + index_copy_)")
    eng.ensure_plans(unit)
    mark("plan join")
    with torch.profiler.profile(activities=activities) as prof:
        eng.decompress(unit)
        torch.cuda.synchronize()
    mark("first decompress, under torch.profiler (plan upload, readback)")
    eng.decompress(unit)
    mark("second decompress (plan already on the card; readback)")
    eng.recycle(unit)
    eng.release()
    for (_, t0), (phase, t1) in zip(clock, clock[1:]):
        log(f"profile phase [{card}] {phase}: {1e3 * (t1 - t0):.3f} ms")

    def device_us(e) -> float:
        t = getattr(e, "device_time_total", None)     # cuda_time_total before torch 2.4
        return float(t if t is not None else e.cuda_time_total)

    events = sorted(prof.key_averages(), key=device_us, reverse=True)
    for e in events[:top]:
        log(f"profile: {e.key} | calls {e.count} | device {device_us(e) / 1e3:.3f} ms "
            f"| host {e.cpu_time_total / 1e3:.3f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add the phase breakdown of one warm LZ4 unit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no result",
              file=sys.stderr)
        return 1
    import bench
    import bitar_tpu_torch as btt
    from bitar_tpu_torch.ops import decode_flat as df
    from bitar_tpu_torch.ops._build import BUILD_DIR
    from bitar_tpu_torch.ops.cpu import native
    from bitar_tpu_torch.utils import timing

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    native.load()
    t1 = time.perf_counter()
    df.load_kernel()
    t2 = time.perf_counter()
    log(f"build: host library (g++) {t1 - t0:.2f} s, decode_flat.cu "
        f"(nvcc sm_90a) {t2 - t1:.2f} s")
    for report in BUILD_DIR.glob("libdecode_flat-*.so.log"):
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas: {line.strip()}")

    corpus = bench.make_corpus(NBLOCKS)
    rng = np.random.default_rng(7)
    raw_heavy = b"".join(
        rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes() if i % 8 else
        (b"raw-heavy batch %d " % i) * (BLOCK // 18 + 1)
        for i in range(RAW_BLOCKS))[:RAW_BLOCKS * BLOCK]
    batches = {"bench": planned_batch(btt, corpus),
               "text": planned_batch(btt, bench.make_text_corpus(TEXT_BLOCKS)),
               "raw_heavy": planned_batch(btt, raw_heavy)}
    max_err = 0
    for name, (rows, pt, comp_rows, stats) in batches.items():
        max_err = max(max_err, compare(df, rows, pt, comp_rows))
        log(f"kernel == plain version, byte for byte: {name} ({stats})")

    df.launches = 0
    main_path(btt, df, btt.Codec.LZ4, corpus)
    main_path(btt, df, btt.Codec.SNAPPY, corpus)
    main_launches = df.launches
    if main_launches <= 0:
        raise AssertionError("the main path launched no decode_flat kernel")
    log(f"decode_flat launches on the main path: {main_launches}")

    ms, plain_ms = timed(timing, df, *batches["bench"][:3], card, "bench 1024 x 128 KiB")
    timed(timing, df, *batches["text"][:3], card, "text 256 x 128 KiB")
    if args.profile:
        profile_main_path(btt, corpus, card)

    log(json.dumps({"kernels": [{
        "name": "decode_flat", "route": "cuda",
        "source": "bitar_tpu_torch/csrc/decode_flat.cu",
        "replaces": "bitar_tpu/ops/pallas/lz4_decode_flat.py:101",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
