"""The repository's headline measurement on the port: one JSON line.

Counterpart of the root ``bench.py``, phase for phase, on the same corpora
(``utils/corpus.py``), the same configuration and the same key names.  It
measures LZ4 block decompress and compress on one card (128 KiB blocks of the
mixed-entropy corpus: text, low-entropy, random and RLE in equal parts), with
a bit-exact engine round trip as the correctness gate, then the cold path, Zstd,
Snappy, the markdown corpus and the device-offload compress.

The headline (``value``) keeps the reference's definition: the best of three
runs of ``BENCH_REPS`` chained whole-unit decode launches
(``Engine.prepare_device_decode``) on device-resident inputs, each run ended by
one synchronize, on the host clock; a launch's time is the run's over the count.
Beside it, on stderr, the same launch's CUDA-event time
(``utils.timing.device_time_ms``) and its held time
(``utils.timing.kernel_time_ms``: launches queued behind a hold kernel, then
run back to back), so the launch wrapper's share shows.

``--device cuda`` (the default) runs on the card and exits non-zero where there
is none; ``--device cpu`` runs the kernels' plain PyTorch versions and leaves
out what only the card has (``nvidia-smi``, the event and held times).
A phase that fails raises: nothing is skipped.

``BENCH_NBLOCKS`` (default 1024) and ``BENCH_REPS`` (default 8) are read when
:func:`main` runs.  The last stdout line is the JSON record; every phase's
line goes to stderr.

Usage::

    python -m bitar_tpu_torch.cli.bench
    BENCH_NBLOCKS=4 BENCH_REPS=1 python -m bitar_tpu_torch.cli.bench --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import Codec, EngineConfig
from ..engine.device import CompressedUnit, Engine
from ..ops import decode_flat, registry
from ..ops.cpu import native
from ..ops.device_compress import compress_blocks_device
from ..status import Status, StatusError
from ..utils import timing
from ..utils.corpus import BLOCK, make_corpus, make_text_corpus
from ..utils.profiling import annotate, device_trace
from .demo import cleanup_and_exit

#: The BASELINE north star, 10 GB/s decompress (``bench.py:40``).
NORTH_STAR_GBPS = 10.0
H2D_BYTES = 64 * 1024 * 1024  # the cold phase's host-to-device probe
OFFLOAD_BLOCKS = 256          # planes of the device-offload phase
OFFLOAD_DEPTH = 32            # chained launches of its launch-amortized arm
#: compress_blocks_device arguments of the device-offload phase (``bench.py:410-491``).
OFFLOAD_LZ4 = dict(seg=1024, min_match=6, out_width=2048)
OFFLOAD_SNAPPY = dict(seg=1024, min_match=6, out_width=8192, fmt="snappy")
OFFLOAD_TEXT = dict(seg=1024, min_match=6, out_width=49152, detect_fft="sample", fft_k=6)
TEXT_CHUNK = 64               # planes a launch of the markdown offload
#: The keys of the reference's line (``bench.py:544-573``), in its order.
KEYS = ("metric", "value", "unit", "vs_baseline", "compress_GBps", "compress_eager_GBps",
        "combined_GBps", "decompress_cold_GBps", "plan_build_ms", "commit_upload_ms",
        "plan_join_cold_ms", "h2d_GBps", "zstd_decompress_GBps", "zstd_compress_GBps",
        "snappy_decompress_GBps", "snappy_compress_GBps", "text_decompress_GBps",
        "device_offload_compress_GBps", "device_offload_compress_depth32_GBps",
        "device_offload_ratio", "device_offload_text_ratio", "device_offload_text_GBps",
        "device_offload_snappy_GBps")
#: The plan join is what is left of the background plan build when the decode
#: first needs it: where the build ended during the commit upload, it reads
#: 0.0 at the reference's 0.1 ms.  Every other number of the line is above 0.
MAY_READ_ZERO = ("plan_build_ms",)


def say(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def say_split(what: str, split: dict[str, float]) -> None:
    """The planner's time by phase (``native.plan_prof``): ms summed over
    its worker threads, so a phase may exceed the wall time it ran in."""
    say(f"{what} split (planner ms, thread-summed): "
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))


def check(ok: bool, what: str) -> None:
    """Raise StatusError(IOError) unless ``ok``: a bit-exact gate."""
    if not ok:
        raise StatusError(Status.IOError(f"bench: {what}"))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_config(nblocks: int) -> EngineConfig:
    """The reference bench's engine (``bench.py:146-150``): deferred commit, so
    compress ends when its output reaches pool memory and the arena upload
    lands in the decode's preparation."""
    return EngineConfig(codec=Codec.LZ4, block_size=BLOCK, burst_size=nblocks,
                        max_pool_slots=max(64, nblocks + 32), commit="deferred")


def chained(fn, reps: int, region: str, runs: int = timing.NUM_BENCH_RUNS) -> list[float]:
    """Seconds a call of ``fn`` in each of ``runs`` runs of ``reps`` chained
    calls, each run ended by one synchronize of what the last call returned,
    on the host clock."""
    def run():
        with annotate(region):
            for _ in range(reps - 1):
                fn()
            return fn()

    return [s / reps for s in timing.time_phase(region, 0, run, runs).seconds]


def require_planned(unit: CompressedUnit, what: str) -> None:
    """Every block of ``unit`` decodes on the device: a plan exists and the
    planner left no block to the host."""
    pf = unit.plan_flat
    check(pf is not None and pf["host_blocks"].size == 0,
          f"{what}: the unit is not fully planned (a block would decode on the host)")


def round_trip(eng: Engine, unit: CompressedUnit, data: bytes, what: str) -> None:
    eng.ensure_plans(unit)
    require_planned(unit, what)
    check(eng.decompress(unit).tobytes() == data, f"{what} round trip not bit-exact")


# ---------------------------------------------------------------------------
# Phases, in the reference's order


def compress_phase(eng: Engine, data: bytes) -> tuple[CompressedUnit, float]:
    """Best of three ``Engine.compress`` runs (host matcher), host clock.
    Returns the last unit and the best seconds.  The planner's counters
    start from 0 at the last run's compress (its background build)."""
    best, unit = float("inf"), None
    for run in range(timing.NUM_BENCH_RUNS):
        if unit is not None:
            eng.recycle(unit)
        native.plan_prof(reset=True)
        with annotate("bench.compress"):
            t0 = time.perf_counter()
            unit = eng.compress(data)
            dt = time.perf_counter() - t0
        best = min(best, dt)
        say(f"compress run {run}: {dt * 1e3:.1f} ms ({len(data) / dt / 1e9:.3f} GB/s)")
    return unit, best


def commit_plan_phase(eng: Engine, unit: CompressedUnit) -> tuple[float, float]:
    """The deferred commit's upload timed alone, then the plan join.
    Returns (commit ms, plan ms)."""
    t0 = time.perf_counter()
    eng._ensure_committed(unit)
    commit_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    eng.ensure_plans(unit)
    plan_ms = (time.perf_counter() - t0) * 1e3
    # Where the background build ends during the upload the join reads 0:
    # the sum is the steady quantity.
    say(f"commit upload {commit_ms:.1f} ms; plan join {plan_ms:.1f} ms (background build); "
        f"together {commit_ms + plan_ms:.1f} ms")
    say_split("plan build", native.plan_prof())
    require_planned(unit, "lz4")
    pf = unit.plan_flat
    dn = pf["dense"]
    say(f"ratio={unit.manifest.ratio():.3f} blocks={unit.nblocks} planned=True "
        f"passes={int(pf['p_used'].sum())} dense={int(np.maximum(dn, 0).sum())} "
        f"identity={int((dn < 0).sum())} plan_build={plan_ms:.1f}ms")
    return commit_ms, plan_ms


def eager_compress_phase(cfg: EngineConfig, data: bytes, device: str) -> float:
    """Best of two compresses on a ``commit="eager"`` engine; GB/s."""
    eng = Engine(cfg.replace(commit="eager"), device=device).initialize()
    best, unit = float("inf"), None
    for _ in range(2):
        if unit is not None:
            eng.recycle(unit)
        t0 = time.perf_counter()
        unit = eng.compress(data)
        best = min(best, time.perf_counter() - t0)
    eng.recycle(unit)
    eng.release()
    gbps = len(data) / best / 1e9
    say(f"eager-commit compress {best * 1e3:.1f} ms ({gbps:.3f} GB/s)")
    return gbps


def headline_phase(eng: Engine, unit: CompressedUnit, data: bytes, reps: int) -> float:
    """The output of one ``prepare_device_decode`` launch checked against the
    corpus, then the best of three runs of ``reps`` chained launches.  Returns
    seconds a launch."""
    launch = eng.prepare_device_decode(unit)
    check(launch().cpu().numpy().tobytes() == data, "timed-path output mismatch")
    with device_trace():
        runs = chained(launch, reps, "bench.decompress")
    for run, dt in enumerate(runs):
        say(f"decompress run {run}: {dt * 1e3:.2f} ms/launch ({len(data) / dt / 1e9:.3f} GB/s)")
    if eng.device.type == "cuda":
        ev = timing.device_time_ms(launch, reps)
        k = timing.kernel_time_ms(launch, reps, lambda: decode_flat.launches)
        say(f"decompress launch: host clock {min(runs) * 1e3:.4f} ms, CUDA events "
            f"{ev:.4f} ms, held {k:.4f} ms (B1, the launch's only kernel)")
    return min(runs)


def cold_phase(cfg: EngineConfig, nblocks: int, device: str) -> tuple[float, float, float]:
    """A 64 MiB pageable host-to-device probe, then fresh data through a fresh
    engine: ``ensure_plans`` -> ``prepare_device_decode`` -> one launch ->
    synchronize.  Returns (h2d GB/s, plan join ms, cold decompress GB/s)."""
    dev = torch.device(device)
    probe = np.random.default_rng(7).integers(0, 256, H2D_BYTES, dtype=np.uint8)
    t0 = time.perf_counter()
    d = torch.from_numpy(probe).to(dev, copy=True)
    sync(dev)
    h2d = probe.nbytes / (time.perf_counter() - t0) / 1e9
    del d
    say(f"h2d bandwidth {h2d:.3f} GB/s (64 MiB probe)")
    cdata = make_corpus(nblocks + 1)[BLOCK:]
    eng = Engine(cfg, device=device).initialize()
    native.plan_prof(reset=True)
    unit = eng.compress(cdata)
    t0 = time.perf_counter()
    eng.ensure_plans(unit)
    plan_ms = (time.perf_counter() - t0) * 1e3
    say_split("cold plan build", native.plan_prof())
    eng.prepare_device_decode(unit)()
    sync(dev)
    dt = time.perf_counter() - t0
    gbps = len(cdata) / dt / 1e9
    say(f"COLD decompress {dt * 1e3:.1f} ms ({gbps:.3f} GB/s; plan_join={plan_ms:.1f}ms, "
        f"fresh data, warm kernels)")
    eng.recycle(unit)
    eng.release()
    return h2d, plan_ms, gbps


def codec_phase(cfg: EngineConfig, data: bytes, reps: int, device: str,
                what: str) -> tuple[float, float]:
    """One compress with ``cfg``, a bit-exact round trip and chained launches.
    Returns (compress GB/s, decompress GB/s)."""
    eng = Engine(cfg, device=device).initialize()
    t0 = time.perf_counter()
    unit = eng.compress(data)
    comp = len(data) / (time.perf_counter() - t0) / 1e9
    round_trip(eng, unit, data, what)
    launch = eng.prepare_device_decode(unit)
    launch()
    best = min(chained(launch, reps, f"bench.{what}"))
    dec = len(data) / best / 1e9
    say(f"{what} decompress {best * 1e3:.2f} ms/launch ({dec:.3f} GB/s, device path); "
        f"compress {comp:.3f} GB/s")
    eng.recycle(unit)
    eng.release()
    return comp, dec


def text_phase(cfg: EngineConfig, nblocks: int, reps: int, device: str) -> float:
    """The markdown corpus (the decode kernel's hardest class): a bit-exact
    round trip and chained launches.  Returns decompress GB/s."""
    tdata = make_text_corpus(nblocks)
    eng = Engine(cfg, device=device).initialize()
    unit = eng.compress(tdata)
    round_trip(eng, unit, tdata, "text")
    launch = eng.prepare_device_decode(unit)
    launch()
    best = min(chained(launch, reps, "bench.text"))
    gbps = len(tdata) / best / 1e9
    pf = unit.plan_flat
    say(f"text decompress {best * 1e3:.2f} ms/launch ({gbps:.3f} GB/s, ratio "
        f"{unit.manifest.ratio():.3f}, passes {int(pf['p_used'].sum())}, dense "
        f"{int(np.maximum(pf['dense'], 0).sum())})")
    eng.recycle(unit)
    eng.release()
    return gbps


def stored_bytes(sizes: np.ndarray, width: int) -> np.ndarray:
    """Bytes each full-length block stores under the RAW-fallback contract: a
    row of ``size >= BLOCK`` or ``size > width`` is stored RAW."""
    return np.where((sizes >= BLOCK) | (sizes > width), BLOCK, sizes)


def check_offload_rows(codec: Codec, out: torch.Tensor, sizes, planes: torch.Tensor,
                       lengths, what: str) -> int:
    """Decode every row the device compressed, a size below its block's
    length and within the width ``out`` has (the RAW-fallback contract
    stores the others), with the host codec, each bit-exact to its block.
    ``sizes`` and ``lengths`` are tensors or arrays.  Returns the count of
    such rows."""
    out_np, raw = out.cpu().numpy(), planes.cpu().numpy()
    sz, lens = (np.asarray(torch.as_tensor(a).cpu()) for a in (sizes, lengths))
    width, L = out_np.shape[1], raw.shape[1]
    rows = np.flatnonzero((sz < lens) & (sz <= width))
    at = np.arange(rows.size, dtype=np.int64)
    dst = np.zeros(rows.size * L, np.uint8)
    dl, st = registry.host_decompress_batch(
        codec, np.ascontiguousarray(out_np[rows]).reshape(-1), at * width,
        sz[rows].astype(np.int32), dst, at * L, lens[rows].astype(np.int32))
    check(bool((st == 0).all() and (dl == lens[rows]).all()) and all(
        np.array_equal(dst[i * L:i * L + lens[b]], raw[b, :lens[b]]) for i, b in enumerate(rows)),
        f"{what}: a device-compressed row does not decode to its block")
    return int(rows.size)


def text_chunks(planes: torch.Tensor, chunk: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``planes`` in launches of ``chunk`` rows, each with its own ``lengths``
    of its own row count (the reference's ``bench.py:502`` gives every chunk
    one of ``chunk`` rows)."""
    return [(p, torch.full((p.shape[0],), BLOCK, dtype=torch.int32, device=p.device))
            for p in planes.split(chunk)]


def offload_text(chunks) -> tuple[float, list[tuple[torch.Tensor, np.ndarray]]]:
    """The markdown offload over ``chunks`` after one warm launch: seconds of
    the device work and the size readback (host checks stay out of the
    clock), and each chunk's (out, sizes)."""
    compress_blocks_device(*chunks[0], **OFFLOAD_TEXT)[1].cpu()
    t0 = time.perf_counter()
    res = [(out, sizes.cpu().numpy())
           for out, sizes in (compress_blocks_device(p, ln, **OFFLOAD_TEXT) for p, ln in chunks)]
    return time.perf_counter() - t0, res


def device_offload_phase(data: bytes, nblocks: int, reps: int, device: str
                         ) -> tuple[dict, dict]:
    """``compress_blocks_device`` on ``min(256, nblocks)`` planes resident on
    the device: LZ4 at width 2048 (ratio, chained ``reps`` and depth 32),
    Snappy at 8192 (depth 32) and the markdown corpus at 49152 with
    ``detect_fft="sample"`` in chunks of 64.  Every device-compressed row is
    decoded on the host.  Returns the line's numbers and the sizes (``lz4``,
    ``snappy``, and ``text``: one array a chunk)."""
    dev = torch.device(device)
    nd = min(OFFLOAD_BLOCKS, nblocks)
    host_planes = np.frombuffer(data[:nd * BLOCK], np.uint8).reshape(nd, BLOCK)
    planes = torch.from_numpy(host_planes.copy()).to(dev)
    lens = torch.full((nd,), BLOCK, dtype=torch.int32, device=dev)
    nbytes = nd * BLOCK
    res = {}

    def lz4():
        return compress_blocks_device(planes, lens, **OFFLOAD_LZ4)

    out, sizes = lz4()
    szs = sizes.cpu().numpy()
    check_offload_rows(Codec.LZ4, out, szs, planes, lens, "offload lz4")
    res["device_offload_ratio"] = nbytes / int(stored_bytes(szs, OFFLOAD_LZ4["out_width"]).sum())
    best = min(chained(lz4, reps, "bench.offload"))
    res["device_offload_compress_GBps"] = nbytes / best / 1e9
    say(f"device-offload compress {best * 1e3:.2f} ms/launch "
        f"({res['device_offload_compress_GBps']:.3f} GB/s, {nd} blocks, ratio "
        f"{res['device_offload_ratio']:.3f}, detect + B5 + layout + emitter)")
    best32 = min(chained(lz4, OFFLOAD_DEPTH, "bench.offload", runs=2))
    res["device_offload_compress_depth32_GBps"] = nbytes / best32 / 1e9
    say(f"device-offload compress depth-32 {best32 * 1e3:.2f} ms/launch "
        f"({res['device_offload_compress_depth32_GBps']:.3f} GB/s)")

    def snappy():
        return compress_blocks_device(planes, lens, **OFFLOAD_SNAPPY)

    sout, ssizes = snappy()
    ssz = ssizes.cpu().numpy()
    check_offload_rows(Codec.SNAPPY, sout, ssz, planes, lens, "offload snappy")
    bests = min(chained(snappy, OFFLOAD_DEPTH, "bench.offload_snappy", runs=2))
    res["device_offload_snappy_GBps"] = nbytes / bests / 1e9
    say(f"device-offload SNAPPY {bests * 1e3:.2f} ms/launch "
        f"({res['device_offload_snappy_GBps']:.3f} GB/s depth-32, ratio "
        f"{nbytes / int(stored_bytes(ssz, OFFLOAD_SNAPPY['out_width']).sum()):.3f})")

    tplanes = torch.from_numpy(np.frombuffer(make_text_corpus(nd), np.uint8)
                               .reshape(nd, BLOCK).copy()).to(dev)
    chunks = text_chunks(tplanes, TEXT_CHUNK)
    t_text, touts = offload_text(chunks)
    tow = OFFLOAD_TEXT["out_width"]
    tdevn = sum(check_offload_rows(Codec.LZ4, o, s, p, ln, "offload text")
                for (p, ln), (o, s) in zip(chunks, touts))
    ttot = sum(int(stored_bytes(s, tow).sum()) for _, s in touts)
    res["device_offload_text_ratio"] = nbytes / ttot
    res["device_offload_text_GBps"] = nbytes / t_text / 1e9
    say(f"device-offload TEXT ratio {res['device_offload_text_ratio']:.3f} "
        f"({tdevn}/{nd} blocks device-compressed, {res['device_offload_text_GBps']:.2f} GB/s "
        f"warm device+size-readback; FFT offsets + partial parse)")
    return res, {"lz4": szs, "snappy": ssz, "text": [s for _, s in touts]}


def bench_line(n: int, dec: float, comp: float, nums: dict) -> dict:
    """The reference's record: ``n`` raw bytes, the best decode and compress
    seconds, and the other phases' numbers under their keys."""
    dec_gbps, comp_gbps = n / dec / 1e9, n / comp / 1e9
    line = {"metric": "lz4_decompress_GBps_per_chip_128KiB_blocks",
            "value": round(dec_gbps, 4), "unit": "GB/s",
            "vs_baseline": round(dec_gbps / NORTH_STAR_GBPS, 4),
            "compress_GBps": round(comp_gbps, 4),
            "combined_GBps": round(n / (dec + comp) / 1e9, 4)}
    for k, v in nums.items():
        line[k] = round(v, 1) if k.endswith("_ms") else round(v, 4)
    return {k: line[k] for k in KEYS}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bitar-tpu-torch-bench",
        description="the headline measurement: one JSON line (BENCH_NBLOCKS, BENCH_REPS)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (the card; exits non-zero where there is none) or cpu "
                        "(the kernels' plain PyTorch versions)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    nblocks = int(os.environ.get("BENCH_NBLOCKS", "1024"))
    reps = int(os.environ.get("BENCH_REPS", "8"))
    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        cleanup_and_exit(1, "bench: --device cuda: torch.cuda.is_available() is false")
    if device == "cuda":
        say(f"card: {card_line()}")
    data = make_corpus(nblocks)
    cfg = bench_config(nblocks)
    eng = Engine(cfg, device=device).initialize()
    say(f"device={eng.device}"
        + (f" ({torch.cuda.get_device_name(eng.device)})" if device == "cuda" else "")
        + f" bytes={len(data):,} blocks={nblocks} reps={reps}")

    unit, comp_s = compress_phase(eng, data)
    nums = {}
    nums["commit_upload_ms"], nums["plan_build_ms"] = commit_plan_phase(eng, unit)
    round_trip(eng, unit, data, "lz4")
    say("engine round trip verified bit-exact")
    nums["compress_eager_GBps"] = eager_compress_phase(cfg, data, device)
    dec_s = headline_phase(eng, unit, data, reps)
    eng.recycle(unit)
    eng.release()

    (nums["h2d_GBps"], nums["plan_join_cold_ms"],
     nums["decompress_cold_GBps"]) = cold_phase(cfg, nblocks, device)
    nums["zstd_compress_GBps"], nums["zstd_decompress_GBps"] = codec_phase(
        cfg.replace(codec=Codec.ZSTD, level=3), data, reps, device, "zstd")
    nums["snappy_compress_GBps"], nums["snappy_decompress_GBps"] = codec_phase(
        cfg.replace(codec=Codec.SNAPPY), data, reps, device, "snappy")
    nums["text_decompress_GBps"] = text_phase(cfg, nblocks, reps, device)
    nums.update(device_offload_phase(data, nblocks, reps, device)[0])

    print(json.dumps(bench_line(len(data), dec_s, comp_s, nums)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
