"""BASELINE-config coverage harness: runs configs 1-3 on the port's engine
and records one artifact tying each of them to a runnable command and a
measured result (config 4 is ``cli.demo --mode skewed``, config 5
``cli.multihost_bench``).  Counterpart of ``bitar_tpu/cli/configs_bench.py``.

  1. 64 MiB Parquet file, synchronous LZ4 round-trip, bit-exact verify
     (reference: demo_app sync suite, ``demo_app.cc:487-546``).  Needs
     pyarrow; where it is not installed the artifact records config 1 as
     not run, with the reason, and no number.
  2. 1 GiB raw buffer in 128 KiB blocks, LZ4 compress+decompress on one
     device, burst-pipelined launches (``demo_app.cc:157-318`` hot loop).
  3. 8 concurrent streams, mixed LZ4+Zstd engines, one host, bit-exact
     per stream (reference async suite, ``demo_app.cc:548-693``).

Device decode times come from CUDA events on the engine's stream; with
``--device cpu`` the engines run the host codecs and the decode times are
host-clock times of ``decompress``.

Usage::

    python -m bitar_tpu_torch.cli.configs_bench [--out CONFIGS.json]
                                                [--gib 1.0] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import Codec, EngineConfig
from ..engine.device import Engine, prepare_batched_decode
from ..engine.stream import ASYNC_RETURN_OK, CompressParam, Stream

BLOCK = 128 * 1024


def _engine_knobs(device: str) -> dict:
    """Knobs by device: the CPU caps bursts at 64 and runs the native host
    codecs (the plain PyTorch kernels at these sizes are for tests, not
    benchmarks); the card runs the kernels at bursts of 256.
    ``commit="deferred"`` is the reference contract: compress ends when the
    output reaches pool memory (``device.cc:157-238``), and the arena upload
    lands in the decode's preparation."""
    cpu = device == "cpu"
    return dict(burst_size=64 if cpu else 256, use_tpu_kernels=not cpu, commit="deferred")


def _engine(device: str, codec: Codec, nbytes: int, **kw) -> Engine:
    knobs = dict(_engine_knobs(device), **kw)
    cfg = EngineConfig(codec=codec, block_size=BLOCK,
                       max_pool_slots=-(-nbytes // BLOCK) + 32, **knobs)
    return Engine(cfg, device=device).initialize()


def _mixed_buffer(nbytes: int, seed: int = 11) -> bytes:
    rng = np.random.default_rng(seed)
    parts = []
    chunk = 1 << 20
    kinds = 4
    for i in range(-(-nbytes // chunk)):
        k = i % kinds
        if k == 0:
            parts.append((b"config bench text %d " % i) * (chunk // 19 + 1))
        elif k == 1:
            parts.append(rng.integers(0, 16, chunk, np.uint8).tobytes())
        elif k == 2:
            parts.append(rng.integers(0, 256, chunk, np.uint8).tobytes())
        else:
            parts.append(bytes([i & 0xFF]) * chunk)
    return b"".join(p[:chunk] for p in parts)[:nbytes]


class _DeviceClock:
    """Seconds of the work queued on ``device``'s current stream inside the
    ``with`` block: timing events before and after, synchronized (CUDA); the
    host clock on the CPU, where the work has ended when the calls return."""

    def __init__(self, device: torch.device):
        self.device = device

    def __enter__(self):
        self.t0 = time.perf_counter()
        if self.device.type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            end.synchronize()
            self.seconds = self.start.elapsed_time(end) / 1e3
        return False


def _device_decode_time(eng: Engine, unit) -> float:
    """One whole device-resident decode of the unit (the production
    contract: decoded blocks feed further device compute; ``decompress``
    adds the host readout).  Host-codec engines time ``decompress``."""
    with _DeviceClock(eng.device) as clock:
        if eng.config.use_tpu_kernels:
            eng.decompress_device(unit)
        else:
            eng.decompress(unit)
    return clock.seconds


def config1_parquet_sync(tmpdir: str, device: str) -> dict:
    """64 MiB Parquet -> Arrow IPC bytes -> sync LZ4 round-trip."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError:
        return dict(config=1, input="64 MiB Parquet -> Arrow IPC stream", run=False,
                    reason="pyarrow is not installed: no Parquet file can be written or read")
    from .demo import read_data

    rng = np.random.default_rng(3)
    n = 2_000_000                     # ~64 MiB across mixed-type columns
    table = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "bucket": pa.array(rng.integers(0, 50, n, np.int32)),
        "value": pa.array(np.round(rng.normal(size=n), 3)),
        "tag": pa.array(np.char.add("tag-", rng.integers(0, 1000, n).astype(str))),
    })
    path = f"{tmpdir}/config1.parquet"
    pq.write_table(table, path)
    data = read_data(path)            # Parquet -> Arrow IPC stream bytes
    eng = _engine(device, Codec.LZ4, len(data))
    best_c = float("inf")
    unit = None
    for _ in range(3):
        if unit is not None:
            eng.recycle(unit)
        t0 = time.perf_counter()
        unit = eng.compress(data)
        best_c = min(best_c, time.perf_counter() - t0)
    ok = eng.decompress(unit).tobytes() == data   # bit-exact gate (untimed)
    best_d = min(_device_decode_time(eng, unit) for _ in range(3))
    ratio = round(unit.manifest.ratio(), 3)
    eng.recycle(unit)
    eng.release()
    return dict(
        config=1, input="64 MiB Parquet -> Arrow IPC stream", run=True,
        bytes=len(data), ratio=ratio,
        compress_GBps=round(len(data) / best_c / 1e9, 3),
        decompress_GBps=round(len(data) / best_d / 1e9, 3),
        bit_exact=bool(ok))


def config2_one_gib(gib: float, device: str) -> dict:
    """Large-buffer single-device pipeline at 128 KiB blocks."""
    nbytes = int(gib * (1 << 30))
    data = _mixed_buffer(nbytes)
    nblocks = -(-len(data) // BLOCK)
    eng = _engine(device, Codec.LZ4, nbytes)
    # Best of 3 like the reference (kNumTests=3, demo_app.h:45); the first
    # run also pays the host's first touch of fresh staging pages, so the
    # cold run is reported beside the best.
    t_cold = best_c = float("inf")
    unit = None
    for run in range(3):
        if unit is not None:
            eng.recycle(unit)
        t0 = time.perf_counter()
        unit = eng.compress(data)
        dt = time.perf_counter() - t0
        if run == 0:
            t_cold = dt
        best_c = min(best_c, dt)
    ok = eng.decompress(unit).tobytes() == data   # bit-exact gate (untimed)
    t_d = min(_device_decode_time(eng, unit) for _ in range(2))
    ratio = round(unit.manifest.ratio(), 3)
    eng.recycle(unit)
    eng.release()
    return dict(
        config=2, input=f"{gib} GiB mixed buffer, {nblocks} x 128 KiB",
        bytes=nbytes, ratio=ratio,
        compress_GBps=round(nbytes / best_c / 1e9, 3),
        compress_cold_GBps=round(nbytes / t_cold / 1e9, 3),
        decompress_GBps=round(nbytes / t_d / 1e9, 3),
        bit_exact=bool(ok))


def _run_streams(datas: list[bytes], codecs: list, device: str, reps: int = 2) -> float:
    """Round-trip ``len(datas)`` concurrent streams (one engine each);
    returns the best wall time.  Timed work per stream = compress + plan
    build + device-resident decode, ended by a sync of the engine's device;
    the full-output verify runs untimed afterwards."""
    engines = [_engine(device, codec, len(datas[s]), burst_size=64)
               for s, codec in enumerate(codecs)]
    best = float("inf")
    units: dict[int, object] = {}
    for _ in range(reps):
        for s, eng in enumerate(engines):
            if s in units:
                eng.recycle(units.pop(s))
        streams = []
        t0 = time.perf_counter()
        for s, eng in enumerate(engines):
            stream = Stream(engine=eng, stream_id=s)

            def cb(st, result, s=s, eng=eng):
                if not result.is_ok():
                    return result.status.to_int()
                unit = result.value()
                if eng.config.use_tpu_kernels:
                    eng.decompress_device(unit)
                    if eng.device.type == "cuda":
                        torch.cuda.synchronize(eng.device)
                else:
                    eng.decompress(unit)
                units[s] = unit
                return ASYNC_RETURN_OK

            stream.compress_async(CompressParam(
                engine=eng, data=datas[s], result_callback=cb)).raise_if_error()
            streams.append(stream)
        rcs = [s.wait() for s in streams]
        best = min(best, time.perf_counter() - t0)
        assert all(rc == ASYNC_RETURN_OK for rc in rcs), rcs
        for s in streams:
            s.close()
    ok = True
    for s, eng in enumerate(engines):
        if s in units:
            out = eng.decompress(units[s])     # untimed full verify
            ok = ok and out.tobytes() == datas[s]
            eng.recycle(units[s])
        eng.release()
    if not ok:
        raise AssertionError("stream round-trip not bit-exact")
    return best


def _decode_scaling(datas: list[bytes], codecs: list, device: str, reps: int = 3) -> float:
    """Device-resident decode time for N concurrent streams: units are
    compressed, committed and planned untimed; the timed region queues
    every stream's decode launches (they pipeline on the one device) and
    ends at the events behind the last of them."""
    engines, units = [], []
    for s, codec in enumerate(codecs):
        eng = _engine(device, codec, len(datas[s]), burst_size=64)
        unit = eng.compress(datas[s])
        eng.ensure_plans(unit)                 # commits + builds the wire
        assert eng.decompress(unit).tobytes() == datas[s]  # verify, warm
        engines.append(eng)
        units.append(unit)
    best = float("inf")
    for _ in range(reps):
        with _DeviceClock(engines[0].device) as clock:
            for eng, unit in zip(engines, units):
                if eng.config.use_tpu_kernels:
                    eng.decompress_device(unit)
                else:
                    eng.decompress(unit)
        best = min(best, clock.seconds)
    for eng, unit in zip(engines, units):
        eng.recycle(unit)
        eng.release()
    return best


def _decode_scaling_batched(datas: list[bytes], codecs: list, device: str,
                            reps: int = 3) -> float | None:
    """N streams' decodes merged into ONE launch
    (``prepare_batched_decode``).  Units compress and plan untimed; the
    timed region is the batched launch.  Output verified bit-exact per
    stream (untimed).  None for host-codec engines, which launch no kernel."""
    if not _engine_knobs(device)["use_tpu_kernels"]:
        return None
    engines, units = [], []
    for s, codec in enumerate(codecs):
        eng = _engine(device, codec, len(datas[s]), burst_size=64)
        engines.append(eng)
        units.append(eng.compress(datas[s]))
    launch, slices = prepare_batched_decode(list(zip(engines, units)))
    host = launch().reshape(sum(u.nblocks for u in units), -1).cpu().numpy()   # warm + verify
    for (lo, hi), d in zip(slices, datas):
        assert host[lo:hi].tobytes()[:len(d)] == d, "batched stream decode not bit-exact"
    best = float("inf")
    for _ in range(reps):
        with _DeviceClock(engines[0].device) as clock:
            launch()
        best = min(best, clock.seconds)
    for eng, unit in zip(engines, units):
        eng.recycle(unit)
        eng.release()
    return best


def config3_mixed_streams(device: str) -> dict:
    """8 concurrent streams (4 LZ4 + 4 Zstd engines) on one device:

    * ``decode_*``: device-resident decode only.  ``decode_stream_scaling``
      compares codec-matched arms: 8 concurrent mixed streams against the
      sum of one 32 MiB LZ4 run and one 32 MiB Zstd run over the same
      bytes; an all-LZ4 one-stream run is kept as ``decode_one_stream_GBps``.
    * ``round_trip_*``: compress + staging + decode.
    """
    per_stream = 8 * (1 << 20)
    datas = [_mixed_buffer(per_stream, seed=100 + s) for s in range(8)]
    total = 8 * per_stream
    codecs8 = [Codec.LZ4 if s % 2 == 0 else Codec.ZSTD for s in range(8)]

    dec8 = _decode_scaling(datas, codecs8, device)
    dec8b = _decode_scaling_batched(datas, codecs8, device)
    lz4_bytes = b"".join(datas[s] for s in range(8) if s % 2 == 0)
    zstd_bytes = b"".join(datas[s] for s in range(8) if s % 2 == 1)
    dec_lz4 = _decode_scaling([lz4_bytes], [Codec.LZ4], device)
    dec_zstd = _decode_scaling([zstd_bytes], [Codec.ZSTD], device)
    dec1 = _decode_scaling([b"".join(datas)], [Codec.LZ4], device)
    wall8 = _run_streams(datas, codecs8, device)
    wall1 = _run_streams([b"".join(datas)], [Codec.LZ4], device)
    return dict(
        config=3, input="8 streams x 8 MiB (4 LZ4 + 4 Zstd)",
        bytes=total,
        decode_GBps=round(total / dec8 / 1e9, 3),
        decode_batched_GBps=None if dec8b is None else round(total / dec8b / 1e9, 3),
        decode_one_stream_GBps=round(total / dec1 / 1e9, 3),
        decode_matched_serial_GBps=round(total / (dec_lz4 + dec_zstd) / 1e9, 3),
        decode_stream_scaling=round((dec_lz4 + dec_zstd) / dec8, 2),
        decode_batched_scaling=None if dec8b is None else round((dec_lz4 + dec_zstd) / dec8b, 2),
        round_trip_GBps=round(total / wall8 / 1e9, 3),
        round_trip_one_stream_GBps=round(total / wall1 / 1e9, 3),
        bit_exact=True)


def device_record(device: str) -> dict:
    """What ran the configs: the card's name and count, or the CPU."""
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bitar-tpu-torch-configs-bench")
    ap.add_argument("--out", default=None)
    ap.add_argument("--gib", type=float, default=1.0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cpu runs the host codecs (tests); cuda exits non-zero "
                         "where there is no card")
    ap.add_argument("--configs", default="1,2,3")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("configs_bench: --device cuda but torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1

    runs = []
    todo = {int(c) for c in args.configs.split(",")}
    if 1 in todo:
        with tempfile.TemporaryDirectory() as td:
            runs.append(config1_parquet_sync(td, args.device))
        print(json.dumps(runs[-1]), file=sys.stderr)
    if 2 in todo:
        runs.append(config2_one_gib(args.gib, args.device))
        print(json.dumps(runs[-1]), file=sys.stderr)
    if 3 in todo:
        runs.append(config3_mixed_streams(args.device))
        print(json.dumps(runs[-1]), file=sys.stderr)

    artifact = dict(
        note=("BASELINE.json configs 1-3 on the PyTorch/CUDA port; config 4 -> "
              "bitar_tpu_torch.cli.demo --mode skewed, config 5 -> "
              "bitar_tpu_torch.cli.multihost_bench"),
        device=device_record(args.device),
        runs=runs)
    blob = json.dumps(artifact, indent=1)
    print(blob)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
