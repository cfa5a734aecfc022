"""Demo / benchmark CLI.

Counterpart of ``bitar_tpu/cli/demo.py``, the rebuild of the reference demo
app (``apps/demo_app.cc``): ingest a file (raw bytes, or Parquet/Feather
serialized to an Arrow IPC stream), run the synchronous and asynchronous
benchmark suites 3x each, print duration + GB/s per phase, and verify the
decompressed output memcmp-equal to the input (``demo_app.cc:487-546``
sync, ``:548-693`` async); or the skewed block-size suite (BASELINE config
4), or one-shot compress/decompress of a container file.

Config tiers mirror the reference's three (``README.md:80-82``): the
environment (``CUDA_VISIBLE_DEVICES``), this CLI's flags, and
``EngineConfig``.  ``--device cuda`` (the default) runs on the card and
exits non-zero where there is none; ``--device cpu`` runs the plain PyTorch
versions of the kernels (``--backend gpu``) or the host codecs
(``--backend host``).

Usage::

    python -m bitar_tpu_torch.cli.demo --file data.bin --codec lz4
    python -m bitar_tpu_torch.cli.demo --mode skewed --block-size 1048576
    python -m bitar_tpu_torch.cli.demo --file data.bin --mode sync --device cpu
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time

import numpy as np
import torch

from ..config import Checksum, Codec, EngineConfig
from ..engine.device import Engine
from ..engine.driver import Driver
from ..engine.stream import (
    ASYNC_RETURN_OK,
    CompressParam,
    DecompressParam,
    make_streams,
    wait_all,
)
from ..manifest import CompressedBuffers
from ..status import StatusError
from ..utils.logging import get_logger
from ..utils.timing import NUM_BENCH_RUNS, PhaseTiming, time_phase

logger = get_logger("cli.demo")


def cleanup_and_exit(code: int, message: str = "") -> None:
    """Fatal-path exit (reference ``CleanupAndExit`` -> ``rte_exit``,
    ``common.h:33-39``).  A plain ``sys.exit``: torch's interpreter teardown
    does not hang, so the JAX CLI's ``os._exit`` after release is not
    needed here."""
    if message:
        print(message, file=sys.stderr)
    sys.exit(code)


def install_signal_handlers() -> None:
    """SIGINT/SIGTERM -> orderly exit (reference ``app_common.cc:54-63``)."""

    def handler(signum, frame):
        cleanup_and_exit(128 + signum, f"caught signal {signum}, exiting")

    signal.signal(signal.SIGINT, handler)
    signal.signal(signal.SIGTERM, handler)


# ---------------------------------------------------------------------------
# Ingest (reference ReadData, demo_app.cc:297-330)


def read_data(path: str, nbytes: int | None = None) -> bytes:
    """Read benchmark input: Parquet/Feather -> Arrow IPC stream bytes
    (serialization timed 3x like the reference's SerializeTable,
    ``demo_app.cc:144-193``), anything else -> raw bytes."""
    lower = path.lower()
    if lower.endswith((".parquet", ".feather", ".arrow")):
        data = _read_arrow_table(path)
    else:
        with open(path, "rb") as f:
            data = f.read()
    if nbytes is not None:
        if nbytes > len(data):
            reps = -(-nbytes // max(1, len(data)))
            data = (data * reps)[:nbytes]
        else:
            data = data[:nbytes]
    return data


def _read_arrow_table(path: str) -> bytes:
    """An Arrow table file as IPC stream bytes; exits (never reads the file
    as raw bytes) where pyarrow is not installed."""
    try:
        import pyarrow as pa
        import pyarrow.ipc  # noqa: F401
    except ImportError:
        cleanup_and_exit(2, f"{path}: reading Parquet/Feather needs pyarrow, which is not "
                            "installed; pass a raw file instead")
    if path.lower().endswith(".parquet"):
        import pyarrow.parquet as pq
        table = pq.read_table(path)
    else:
        import pyarrow.feather as pf
        table = pf.read_table(path)

    out = None
    for run in range(NUM_BENCH_RUNS):
        t0 = time.perf_counter()
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, table.schema) as writer:
            writer.write_table(table)
        out = sink.getvalue()
        dt = time.perf_counter() - t0
        logger.info("serialize table run %d: %.0f us (%.3f GB/s)",
                    run, dt * 1e6, out.size / dt / 1e9)
    return out.to_pybytes()


# ---------------------------------------------------------------------------
# Sync benchmark (reference EvaluateSync, demo_app.cc:487-546)


def evaluate_sync(engine: Engine, data: bytes) -> list[PhaseTiming]:
    timings = []
    state = {}

    def compress_once():
        if "unit" in state:
            engine.recycle(state["unit"])
        state["unit"] = engine.compress(data)
        return None

    t = time_phase("sync compress", len(data), compress_once)
    timings.append(t)
    unit = state["unit"]
    print(t.report(), f" ratio={unit.manifest.ratio():.3f}")

    out_buf = np.empty(unit.manifest.total_raw, dtype=np.uint8)
    state_out = {}

    def decompress_once():
        state_out["out"] = engine.decompress(unit, out=out_buf)
        return None

    t = time_phase("sync decompress", len(data), decompress_once)
    timings.append(t)
    print(t.report())

    out = state_out["out"]
    if out.tobytes() != data:
        cleanup_and_exit(3, "VERIFY FAILED: sync round-trip not bit-exact")
    print(f"sync verify OK ({len(data):,} bytes bit-exact)")
    recycled = engine.recycle(unit)
    assert recycled == unit.nblocks, (recycled, unit.nblocks)
    return timings


# ---------------------------------------------------------------------------
# Async benchmark (reference EvaluateAsync, demo_app.cc:548-693)


def evaluate_async(engines: list[Engine], data: bytes, num_streams: int
                   ) -> list[PhaseTiming]:
    seg = len(data) // num_streams
    segments = [data[i * seg:(i + 1) * seg] for i in range(num_streams - 1)]
    segments.append(data[(num_streams - 1) * seg:])
    streams = make_streams(engines, num_streams)
    timings = []
    try:
        units: dict[int, object] = {}
        for run in range(NUM_BENCH_RUNS):
            for u in units.values():
                u.engine.recycle(u)
            units.clear()
            done_at = {}

            def make_cb(i):
                def cb(s, result):
                    units[i] = result.value()
                    done_at[i] = time.perf_counter()
                    return ASYNC_RETURN_OK
                return cb

            t0 = time.perf_counter()
            for i, s in enumerate(streams):
                st = s.compress_async(CompressParam(
                    engine=s.engine, data=segments[i],
                    result_callback=make_cb(i)))
                if not st.ok():
                    cleanup_and_exit(4, f"stream {i} submit failed: {st}")
            rcs = wait_all(streams)
            if rcs != [ASYNC_RETURN_OK] * num_streams:
                cleanup_and_exit(4, f"async compress rc={rcs}")
            t1 = max(done_at.values())
            timings.append(PhaseTiming(
                "async compress", len(data), [t1 - t0]))
            print(timings[-1].report(), f"(run {run}, {num_streams} streams)")

        outs: dict[int, np.ndarray] = {}
        for run in range(NUM_BENCH_RUNS):
            outs.clear()
            done_at = {}

            def make_dcb(i):
                def cb(s, result):
                    outs[i] = result.value()
                    done_at[i] = time.perf_counter()
                    return ASYNC_RETURN_OK
                return cb

            t0 = time.perf_counter()
            for i, s in enumerate(streams):
                st = s.decompress_async(DecompressParam(
                    engine=s.engine, unit=units[i],
                    result_callback=make_dcb(i)))
                if not st.ok():
                    cleanup_and_exit(4, f"stream {i} submit failed: {st}")
            rcs = wait_all(streams)
            if rcs != [ASYNC_RETURN_OK] * num_streams:
                cleanup_and_exit(4, f"async decompress rc={rcs}")
            t1 = max(done_at.values())
            timings.append(PhaseTiming(
                "async decompress", len(data), [t1 - t0]))
            print(timings[-1].report(), f"(run {run})")

        # Per-stream latency distribution (the p99 block-latency metric of
        # the skewed-size benchmark config).
        lats = sorted((done_at[i] - t0) * 1e3 for i in done_at)
        if lats:
            p50 = lats[len(lats) // 2]
            p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
            print(f"async stream latency: p50={p50:.1f}ms p99={p99:.1f}ms "
                  f"max={lats[-1]:.1f}ms")

        # Per-segment verification (demo_app.cc:666-691).
        total = sum(o.shape[0] for o in outs.values())
        if total != len(data):
            cleanup_and_exit(3, f"VERIFY FAILED: total {total} != {len(data)}")
        for i in range(num_streams):
            if outs[i].tobytes() != segments[i]:
                cleanup_and_exit(3, f"VERIFY FAILED: segment {i} differs")
        print(f"async verify OK ({num_streams} segments bit-exact)")
        for u in units.values():
            recycled = u.engine.recycle(u)
            assert recycled == u.nblocks
    finally:
        for s in streams:
            s.close()
    return timings


# ---------------------------------------------------------------------------
# Skewed block-size benchmark (BASELINE config 4): per-block latency
# distribution under a 4 KiB..block_size log-uniform size mix.


def make_skewed_input(block_size: int, nblocks: int, min_size: int = 4096,
                      seed: int = 11) -> tuple[bytes, list[int]]:
    """Log-uniform skewed sizes + mixed-entropy payloads (numpy only: the
    same sizes and bytes as the JAX CLI's for the same seed)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.log2(min(min_size, block_size)), np.log2(block_size)
    sizes = np.minimum(
        block_size,
        np.exp2(rng.uniform(lo, hi, nblocks)).astype(np.int64)).tolist()
    parts = []
    for i, n in enumerate(sizes):
        k = i % 3
        if k == 0:
            parts.append(((b"skewed %d " % i) * (n // 8 + 1))[:n])
        elif k == 1:
            parts.append(rng.integers(0, 32, n, dtype=np.uint8).tobytes())
        else:
            parts.append(bytes([i & 0xFF]) * n)
    return b"".join(parts), [int(s) for s in sizes]


def _burst_completions(engine: Engine, unit) -> list[float]:
    """Seconds from the first submit to each burst's completion, in burst
    order.  On a CUDA device: a timing event recorded on the engine's stream
    before the first launch and one after each burst's launch, synchronized
    in order (device clock, no host readback); on the CPU, where a launch
    runs to its end before it returns, the host clock after each burst."""
    if engine.device.type != "cuda":
        t0 = time.perf_counter()
        done = []
        engine.decompress_device(unit, on_burst=lambda k: done.append(time.perf_counter() - t0))
        return done
    stream = torch.cuda.current_stream(engine.device)
    start = torch.cuda.Event(enable_timing=True)
    events = []

    def record(k):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        events.append(ev)

    start.record(stream)
    engine.decompress_device(unit, on_burst=record)
    done = []
    for ev in events:
        ev.synchronize()
        done.append(start.elapsed_time(ev) / 1e3)
    return done


def _whole_decode_seconds(engine: Engine, unit) -> float:
    """Host clock around one whole device decode, ended by one sync."""
    t0 = time.perf_counter()
    engine.decompress_device(unit)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return time.perf_counter() - t0


def evaluate_skewed(engine: Engine, nblocks: int) -> dict:
    """Compress a skewed unit, decode burst-by-burst, and report the
    per-block latency distribution (latency := the block's burst completion
    relative to the first submit: the reference async suite's
    first-launch-to-callback window at block granularity,
    ``demo_app.cc:548-693``)."""
    data, sizes = make_skewed_input(engine.config.block_size, nblocks)
    unit = engine.compress(data, sizes=sizes)
    m = unit.manifest
    print(f"skewed: {nblocks} blocks, sizes {min(sizes):,}..{max(sizes):,} B, "
          f"ratio={m.ratio():.3f}")

    # Warm-up + verify (also builds the decode sidecar).
    out = engine.decompress(unit)
    if out.tobytes() != data:
        cleanup_and_exit(3, "VERIFY FAILED: skewed round-trip not bit-exact")

    done = _burst_completions(engine, unit)
    burst = engine.config.burst_size
    lat = np.zeros(m.nblocks)
    for k, t in enumerate(done):
        lat[k * burst:min((k + 1) * burst, m.nblocks)] = t
    total = done[-1]
    order = np.sort(lat * 1e3)

    def pct(q):
        return round(float(order[int(q * (len(order) - 1))]), 2)

    # Device throughput: the same launches, one sync a decode, best of 3.
    dev_best = min(_whole_decode_seconds(engine, unit) for _ in range(3))

    stats = {
        "blocks": int(m.nblocks),
        "bursts": len(done),
        "burst_size": int(burst),
        "bytes": len(data),
        "total_ms": round(total * 1e3, 2),
        "GBps": round(len(data) / total / 1e9, 3),
        "device_GBps": round(len(data) / dev_best / 1e9, 3),
        "lat_p10_ms": pct(0.10), "lat_p25_ms": pct(0.25),
        "lat_p50_ms": pct(0.50), "lat_p75_ms": pct(0.75),
        "lat_p90_ms": pct(0.90), "lat_p99_ms": pct(0.99),
        "lat_max_ms": round(float(order[-1]), 2),
        # per-burst completion samples (ms): the raw distribution
        "burst_lat_ms": [round(x * 1e3, 2) for x in done],
        # 0 when every block decoded on the device path
        "host_decode_bursts": int(engine.stats.host_decode_bursts),
    }
    print("skewed latency:", {k: v for k, v in stats.items()
                              if k != "burst_lat_ms"})
    engine.recycle(unit)
    return stats


# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bitar-tpu-torch-demo",
        description="GPU block compression benchmark (bitar demo_app rebuild)")
    p.add_argument("--file", default=None,
                   help="input file (raw/parquet/feather); optional for "
                        "--mode skewed")
    p.add_argument("--bytes", type=int, default=None,
                   help="truncate or repeat input to this many bytes")
    p.add_argument("--mode",
                   choices=["all", "sync", "async", "skewed",
                            "compress", "decompress"],
                   default="all",
                   help="benchmark suites (skewed = per-block latency "
                        "distribution over a 4KiB..block log-uniform size "
                        "mix, BASELINE config 4), or one-shot file "
                        "compress/decompress (container format)")
    p.add_argument("--blocks", type=int, default=256,
                   help="block count for --mode skewed")
    p.add_argument("--output", default=None,
                   help="output path for compress/decompress modes; the stats "
                        "JSON for --mode skewed")
    p.add_argument("--matcher",
                   choices=["host", "tpu", "tpu-sort", "device"],
                   default="host",
                   help="match finding: host hash matcher, the static-offset "
                        "match kernel (tpu), a device sort of 4-byte repeats "
                        "(tpu-sort), or the whole compress on the device")
    p.add_argument("--detect-fft", nargs="?", const=True, default=False,
                   choices=[True, "sample"],
                   help="device matcher: add FFT-autocorrelation period "
                        "candidates; 'sample' runs the rfft on 8 "
                        "representative blocks only")
    p.add_argument("--codec", choices=[c.value for c in Codec], default="lz4")
    p.add_argument("--block-size", type=int, default=128 * 1024)
    p.add_argument("--burst-size", type=int, default=32)
    p.add_argument("--streams", type=int, default=4)
    p.add_argument("--backend", choices=["gpu", "host"], default="gpu",
                   help="decompress path: the device kernels (their plain "
                        "PyTorch versions with --device cpu) or the native "
                        "host codecs")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the engines run (the EAL-flag tier of the "
                        "reference, README.md:80-82); cuda exits non-zero "
                        "where there is no card")
    p.add_argument("--checksum", choices=[c.value for c in Checksum],
                   default="none")
    p.add_argument("--min-match", type=int, default=6,
                   help="smallest LZ4/Snappy match emitted (4 = max ratio; "
                        "6 keeps barely-compressible blocks literal-only "
                        "for ~40x fewer device decode passes)")
    p.add_argument("--pool-slots", type=int, default=None,
                   help="arena slots (default: sized to input like the "
                        "reference, app_common.cc:92-100)")
    return p


def run_compress_file(engine: Engine, data: bytes, out_path: str) -> None:
    """One-shot: file -> .btpu container (manifest + packed blocks)."""
    unit = engine.compress(data)
    blob = unit.to_host().to_bytes()
    with open(out_path, "wb") as f:
        f.write(blob)
    print(f"compressed {len(data):,} -> {len(blob):,} bytes "
          f"(ratio {unit.manifest.ratio():.3f}, {unit.nblocks} blocks) "
          f"-> {out_path}")
    engine.recycle(unit)


def run_decompress_file(engine: Engine, raw: bytes, out_path: str) -> None:
    """One-shot: .btpu container -> original bytes (checksum-verified)."""
    cb = CompressedBuffers.from_bytes(raw)
    unit = engine.import_unit(cb)
    out = engine.decompress(unit)
    with open(out_path, "wb") as f:
        f.write(out.tobytes())
    print(f"decompressed {len(raw):,} -> {out.shape[0]:,} bytes -> {out_path}")
    engine.recycle(unit)


def main(argv: list[str] | None = None) -> int:
    install_signal_handlers()
    args = build_parser().parse_args(argv)
    if args.file is None and args.mode != "skewed":
        cleanup_and_exit(2, "--file is required for this mode")
    if args.mode == "skewed":
        data = b""
        nblocks = args.blocks
    elif args.mode == "decompress":
        with open(args.file, "rb") as f:
            data = f.read()
        # The container records its own block size; the engine must match.
        # Pool sizing comes from the manifest's block count: the container's
        # byte length underestimates it for well-compressed input.
        m = CompressedBuffers.from_bytes(data).manifest
        args.block_size = m.block_size
        nblocks = m.nblocks
    else:
        data = read_data(args.file, args.bytes)
        nblocks = -(-len(data) // args.block_size)
    print(f"input: {len(data):,} bytes, codec={args.codec}, "
          f"block={args.block_size}, mode={args.mode}, device={args.device}")

    pool = args.pool_slots or max(64, nblocks + args.burst_size)
    cfg = EngineConfig(
        codec=Codec(args.codec), block_size=args.block_size,
        burst_size=args.burst_size, checksum=Checksum(args.checksum),
        max_pool_slots=pool, use_tpu_kernels=(args.backend == "gpu"),
        compress_matcher=args.matcher, min_match=args.min_match,
        detect_fft=args.detect_fft)

    driver = Driver.instance()
    try:
        print("topology:", driver.describe(args.device))
        engines = driver.get_engines(cfg, device_type=args.device)
    except StatusError as e:
        cleanup_and_exit(1, f"FAILED: {e.status}")
    try:
        if args.mode == "compress":
            run_compress_file(engines[0], data,
                              args.output or args.file + ".btpu")
        elif args.mode == "decompress":
            out_path = args.output or (
                args.file[:-5] if args.file.endswith(".btpu")
                else args.file + ".out")
            run_decompress_file(engines[0], data, out_path)
        elif args.mode == "skewed":
            stats = evaluate_skewed(engines[0], args.blocks)
            if args.output:
                with open(args.output, "w") as f:
                    json.dump(stats, f, indent=1)
        else:
            if args.mode in ("all", "sync"):
                evaluate_sync(engines[0], data)
            if args.mode in ("all", "async"):
                evaluate_async(engines, data, args.streams)
    except StatusError as e:
        cleanup_and_exit(1, f"FAILED: {e.status}")
    finally:
        for e in engines:
            e.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
