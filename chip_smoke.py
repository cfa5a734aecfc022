"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: the quickest proof
that the port still starts on the card.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --world 4      # four cards: the multi-card phase alone

Phases (any failure raises, and the script exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the host codec library (g++), the eight CUDA kernels and the
   timer's hold kernel (nvcc, sm_90a, one process per source, all started
   together), timed;
3. every kernel against its plain PyTorch version on the card, byte for
   byte, at the shapes its path gives it:
   - ``decode_flat`` (B1), on the planner's batches as the engine launches
     it on a resident unit: each block read in its arena slot through the
     unit's slot table (the plain version on the rows the table selects),
     on the plans of the bench corpus (1024 x 128 KiB),
     of the markdown text corpus (256 x 128 KiB) and of a RAW-heavy batch,
     and on the class-pure batches of the first two (``block_classes``: the
     RAW blocks, the blocks with no out pass, those with out passes); its
     tall route (planes of 2048 and 8192 rows: a kernel on every SM for the
     blocks without out passes, then a thread-block cluster a block with
     out passes) on the bench corpus in 256 KiB and 1 MiB blocks (128 of
     each), the text corpus in 256 KiB (64) and 1 MiB (32) blocks, and
     their class-pure batches, on ``slice_crossing_wire`` (out passes that
     gather across the cluster's 1024-row slices and clip at both plane
     ends) and ``random_wire`` at 1152, 2048, 4096 and 8192 rows, and on one
     burst of the CLI's skewed suite (32 blocks of 4 KiB-1 MiB, 8192-row
     planes); every launch above 1024 rows on the tall route;
   - ``match_walk`` (B5) on 256 x 128 KiB of the bench corpus, seg 1024;
   - ``match_dyn`` (B4) on 64 x 128 KiB of it with the offsets that
     ``compress_blocks_device(seg=256)`` detects;
   - both on inputs where the choice between offsets matters: 64 x 128 KiB
     of the text corpus with the offsets of ``detect_fft=True, fft_k=6``
     (B5 also on the headline bench's markdown offload: 256 x 128 KiB of it
     in its four chunks of 64, each with its own lengths and the offsets of
     ``detect_fft="sample", fft_k=6``),
     a batch with hand-set offsets (ties, duplicates, a 0 inside the
     first ``noff``, ``noff = 0``, runs that reach the plane end), and the
     edge batches of ``match_dyn.edge_batch`` (37 blocks at 16, 48 and 128
     KiB: ``noff = 0`` beside live blocks and out of range, two offsets
     running through a segment and tile end where the later runs further,
     ten offsets with a 0, offsets up to L - 128, runs through every tile),
     B5 at seg 512, 1024 and 2048, max_match 1 to 2047, B4 at max_match 1,
     64, 256 and 2047;
   - ``emit`` at widths 128, 2048 and the adaptive one: LZ4 on the bench
     corpus, on the text corpus with ``detect_fft=True`` and on short RLE
     blocks that fit 128 bytes, and Snappy at 8192 (every row decoded on
     the host); at every shape a main path launches it
     (``kernel_ab.emit_shapes``: the engine's device path and
     ``match_offsets`` at 1024 x 128 KiB and the engine's width, text
     ``detect_fft`` at 65536, ``seg=256``, and the bench row at 2048); on
     the headline bench's markdown offload (its four chunks of 64 at width
     49152, every compressed row decoded on the host); and
     on ``emit.edge_layouts`` (LZ4 and Snappy, wcap 8 and the worst-case
     budget) at widths that cut rows, are not a multiple of 16, hold
     every row, or take 512-byte tiles (the literal path); whole rows,
     garbage rows included;
   - ``decode_tables`` (B2) on the sequence tables of 4 KiB blocks of the
     bench corpus (8192 blocks), of the markdown text corpus at 128 KiB
     under an 8-pass plan budget (deep tables), of 256 x 128 KiB of the
     bench corpus (the parallel tables step's shape), of RLE blocks with
     offsets 1-130 (both sides of the 128-byte row) and on random
     well-formed, malformed and mixed tables at 4 and 128 KiB
     (``random_tables``), and on its cluster route: the bench corpus at 1
     MiB under a 4-pass plan budget and its parser tables at 256 KiB, the
     markdown's parser tables at 1 MiB (32 blocks), random well-formed and
     malformed tables at 1 MiB and at 1300 and 4096 rows,
     and RLE offsets 1-130 over 1 MiB planes; and as the engine launches it
     on a MultiGet's picks (``kernel_ab.resident_picks``: 1,884 YCSB 4 KiB
     blocks read through their slots over a permuted 8 KiB-slot arena and
     table store, the plain version on the rows and tables they select);
     each batch logs its blocks by path (parallel,
     serial walk), which must be the classifier's
     (``well_formed``): 0 serial blocks on every parser batch;
   - ``match`` (B3) on 64 and on 1024 x 128 KiB (the shape the main paths
     launch) of the bench corpus (indices, max_match 64; values, max_match
     1024) and on hand-set offsets that tie (values, max_match 1024);
   - ``parse_walk`` (B6) on B4's match planes of B5's bench batch (256 x
     128 KiB, seg 1024, wcap 8; B4 -> B6 must equal B5's records) and on
     hand-set planes at seg 256 and 512 (moff 0 inside runs, lengths below
     L, segments past wcap) and on ``match_dyn.walk_edge_batch`` at seg
     128, 1024, 2048 and 42, wcap 0, 1 and 8;
   - ``decode_planned`` (B7) on the ``plan_block`` + ``pack_plan`` plans of
     256 x 128 KiB LZ4 blocks of the bench corpus (every planned block
     decodes to its raw bytes), on random malformed plans (as made and
     sorted by descending ``p_used``) and on plans whose passes read comp
     rows only, the out plane first, or both in turn (``class_plans``);
   - at 256 KiB and 1 MiB: ``match`` (B3) on 8 blocks of each with offsets
     65,535, 70,000 and one whose tile window passes shared memory (240,000
     / 300,000: every tile reads device memory), each beside a block of that
     period, indices at max_match 64 and values at 1024, and at the tpu
     matcher's shape, 128 x 1 MiB; ``emit`` on 1 MiB edge layouts (LZ4 wcap
     8 and the worst-case budget at min_match 64, Snappy wcap 8) up to the
     LZ4 bound's width and at the engine's 1 MiB ``match_offsets`` shape
     (128 rows, 17,409 slots); ``match_walk``, ``match_dyn`` and
     ``parse_walk`` at 1 MiB through their own entry points (the edge batch,
     offsets up to L - 128, seg 8192; ``walk_edge_batch(8192, 128)``); and
     ``decode_planned``'s tall route on planner plans of text at 256 KiB
     and 1 MiB and of 32 x 1 MiB of the bench corpus (each block its raw
     bytes) and on random and pass-class plans at 1152, 2048, 5120 and 8192
     rows (batches all quiet, all taking a cluster, and both; slices that
     stop at different passes), each launch's slice stops equal to
     ``slice_stops``;
     the wide plain versions a few blocks at a time;
4. the main paths, each with every kernel's launch count set to 0 just
   before it and read just after:
   - host compress -> decode, LZ4 then Snappy, at the bench's size:
     ``Engine(EngineConfig(block_size=128 KiB, burst_size=1024,
     max_pool_slots=1056, commit="deferred"))`` (the planner's chunk
     scratch for 1024 rows present after ``initialize``) -> ``compress`` ->
     ``ensure_plans`` -> ``decompress`` (bit-exact, no block decoded on the
     host) -> ``prepare_device_decode`` (same bytes) -> ``recycle``, then a
     second unit (the data turned by a quarter) the same way, planned into
     the first unit's recycled grant; every plan join logged with the
     planner's split (``native.plan_prof``) and the engine's ``initialize``
     ms (the first 1024 x 128 KiB engine's, with the prefault, at the start
     of phase 3);
   - device compress: the same engine with ``compress_matcher="device"``
     (commit eager): ``compress`` of the bench corpus (B5 + emitter) ->
     ``decompress`` (B1, bit-exact) -> ``recycle``;
   - ``compress_blocks_device(seg=256)`` on 64 x 128 KiB (B4 + emitter),
     every compressed row decoded by the host codec, bit-exact;
   - the sequence-table path: ``EngineConfig(block_size=4096,
     burst_size=1024)`` over the bench corpus (32768 blocks; B2 only);
   - block picks: 1,884 blocks picked across four 4 KiB LZ4 units of the
     bench corpus (``decompress_blocks_device``, B2 only), each its raw
     block, traced: every pick read in place, no slot gathered; the call's
     host clock logged;
   - a Zstd unit of 1024 x 128 KiB (B1 over the literal planes);
   - ``compress_matcher="tpu"`` (B3 hints, host emitter), LZ4 and Snappy,
     and ``"tpu-sort"``, each decoded through B1;
   - ``compress_matcher="device", match_offsets=DEFAULT_OFFSETS`` (B3 +
     emitter, then B1);
   - ``prepare_batched_decode`` over an LZ4, a Zstd and a Snappy unit (one
     B1 launch);
   - four streams on one engine (``make_streams``/``wait_all``);
   - 1024 blocks in bursts of 128 (8 bursts, each read back on a worker and
     copied in as it lands) through the planned path at 128 KiB (B1) and
     the tables path at 4 KiB (B2);
   - 128 x 1 MiB of the bench corpus through the same host path (B1's
     tall route);
   - the CLI: ``cli.demo.main(["--mode", "skewed", "--block-size",
     "1048576", "--blocks", "256"])`` (BASELINE config 4, LZ4; its stats
     line logged) and its sync suite on 32 MiB of the corpus at 128 KiB;
   every one bit-exact with no block decoded on the host;
   - ``find_matches_dyn`` -> ``parse_walk_dyn`` (B4, B6) and
     ``decode_blocks_planned`` (B7), the two kernels' own entry points;
   - the device matchers at 1 MiB on 128 x 1 MiB of the bench corpus:
     ``compress_matcher="tpu"`` (LZ4 and Snappy), ``"tpu-sort"``, and
     ``"device"`` with ``match_offsets=DEFAULT_OFFSETS, min_match=64``,
     each decoded through B1's tall route with its host-clock
     phases logged, and 4 blocks' container equal to the port's CPU
     engine's; ``decode_blocks_planned`` on the 32 x 1 MiB bench plans (B7's
     tall route);
   - (a) an NCCL world of 1 in this process (``file://`` rendezvous):
     ``make_mesh(1)``, ``plan_shuffle``, ``execute_shuffle``, the fused flat
     step and the ring step over 1024 x 128 KiB (B1), then ``sharded_decode``
     and the tables-fallback step over 256 x 128 KiB (B2);
   - (b) four spawned ranks sharing the card, exchange on gloo (the ring's
     rounds host-staged), fused and ring steps over 256 x 128 KiB, B1 in
     every rank; every live row of (a) and (b) bit-exact;
5. times with CUDA events, kernel and plain version in turns (plain, kernel,
   kernel, plain), and for every kernel its held time (``timing.kernel_time_ms``:
   the calls queued behind the hold kernel, then run back to back; of the
   kernel alone for B1, B2 and B7, through their launch functions (B1: a
   prepared launch record's ``run``), of the wrapper's call for the others)
   and its wrapper's host time per call (``timing.host_us_per_call``): B1 in
   place at the bench shape (and its held time on the same rows gathered,
   beside it) and
   on the text corpus (and, the kernel alone, on each class-pure batch);
   B3 at 64 x 128 KiB and at 1024 x 128 KiB in both modes (the kernels
   line takes 1024, indices, max_match 64); B2 in place on the MultiGet's
   picks of phase 3 (the kernels line; its held time on the same rows
   gathered beside it), at 8192 x 4 KiB (the kernels line's
   ``bench_4k``), its 1024 x 4 KiB burst, 256 x 128 KiB of the bench
   corpus and the deep text tables; B5 and B4 on their bench batches and on
   the text ``detect_fft`` batch; the emitter at every main-path shape of
   phase 3 (with its bound and an empty kernel's time on the same grid;
   the kernels line takes the shape with the most held time over
   its bound and names it); B6 on the bench and text B4 planes; the tall
   routes: B1 on the bench (128 blocks) and text (32) batches at 1 MiB, the
   text batch at 256 KiB and the skewed suite's burst, B2 on the bench
   tables at 1 MiB and 256 KiB and the markdown's at 1 MiB (with their
   bounds; the kernels line carries them and B1's resident clusters under
   ``cluster_route``); B7 at the shape of phase 3 (the
   multi-device steps' host-clock times are logged in phase 4); the whole
   ``compress_blocks_device(seg=1024, out_width=2048)`` on 256 x 128 KiB;
   the host-clock phases of the tpu matcher's compress (plane packing,
   upload, B3, hint readback, host emission) at 1024 x 128 KiB and at 128 x
   1 MiB; and at the 1 MiB paths' shapes B3 (128 x 1 MiB, indices, max_match
   64), the emitter (the engine's ``match_offsets`` shape, with an empty
   kernel on its grid) and B7's tall route (32 x 1 MiB), each with its
   bound and its launches on the 1 MiB paths (the kernels line carries
   them under ``large_blocks`` and, for B7, ``tall_route``);
6. the headline bench, ``cli.bench.main(["--device", "cuda"])``, at 1024 x
   128 KiB in this process (B1, B5 and the emitter; each launched, counted
   from 0 just before): its JSON line logged (``bench line: ``) with the
   phase's host-clock seconds, its keys those of the root ``bench.py``'s
   line and every number finite and above 0 (the plan join may read 0.0:
   ``bench.MAY_READ_ZERO``);
7. only with ``--profile``: where the time of each engine main path (host
   compress, device compress) goes, for one warm LZ4 unit: host-clock
   phases and the ``torch.profiler`` rows with the most device time; and
   in phase 5, beside each held time, the profiler's kernel-only time of
   the same call (logged, or logged as lost; nothing gates on it).

The line before the last is one JSON object describing each kernel (its
event and held times, launches on the main paths and the least time
the card could take for its work); the last line is ``{"ok": true, "device": {...}}``.  Without
CUDA the script prints no result and exits 1.  It imports nothing of JAX.

``--world N`` builds the host library, B1 and B2, and runs only the
N-card phase (``world_main``): an NCCL world of N spawned ranks, one card
each, over the bench corpus in 128 KiB blocks: the shuffle, fused and ring
steps at 1024 blocks a rank (best of ``WORLD_REPS`` on the host clock,
device synchronized; the fused step's exchange alone and decode alone; the
ring's CUDA-event timeline of rounds and decodes), the fused step under a
skewed plan, and ``sharded_decode`` and the tables step at 256 blocks a
rank.  Every rank must decode every live row bit-exactly, match the ring
to the fused step, report NCCL, launch B1 and B2 on its own card only and
hold a CUDA context on no other card.  An NCCL world of 1 on the same
1024 blocks gives the weak-scaling efficiency of both steps.  The log
holds ``nvidia-smi topo -m`` and ``nvlink --status``, and the transport
and links NCCL names (``NCCL_DEBUG=INFO``, subsystems INIT and GRAPH).  Then the
Driver's engines, one a card, in this process: each round-trips its share
of 1024 blocks bit-exactly on its own card, and the demo's async suite
runs 8 streams round-robin over them.  The line before the last is
``{"world": {...}}``; with fewer than N cards the script prints no result
and exits 1.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time
import weakref

import numpy as np
import torch

from bitar_tpu_torch.utils.timing import bound_ms

BLOCK = 128 * 1024
NBLOCKS = 1024
TEXT_BLOCKS = 256
RAW_BLOCKS = 256
MATCH_BLOCKS = 256            # B5 / emitter / whole-pipeline batch (the bench's)
DYN_BLOCKS = 64               # B4 batch (seg 256); also B3's small batch
TABLE_BLOCK = 4096            # block size of the sequence-table path
TABLE_CHECK_BLOCKS = 8192     # B2 batch of phase 3 (32 MiB of the corpus)
BATCH_UNIT_BLOCKS = 256       # blocks of each unit of the batched decode
LARGE_BLOCK = 1 << 20         # blocks of B1's and B2's tall (cluster) routes
MID_BLOCK = 256 * 1024
SKEWED_BLOCKS = 256           # the CLI's skewed suite (its default)
SKEWED_BURST = 32             # one burst of it (the CLI's default burst size)
#: Plane heights of the tall routes' hand-made and random checks: a last
#: slice of 128 rows, 2, 4 and 8 slices.
TALL_ROWS = (1152, 2048, 4096, 8192)
MATCH_LARGE_BLOCKS = 128      # the 1 MiB matcher paths' unit: 128 MiB of the bench corpus
LARGE_CHECK_BLOCKS = 8        # blocks of each far-offset B3 batch at 256 KiB and 1 MiB
#: Offsets past 56 KiB (every tile window above 64 KiB), the LZ4 format's
#: largest, and one whose window passes shared memory (device-memory reads).
FAR_OFFSETS = {MID_BLOCK: (65535, 70000, 240000), LARGE_BLOCK: (65535, 70000, 300000)}
LARGE_EDGE_BLOCKS = 12        # blocks of the 1 MiB B5 / B4 / B6 edge batch
PLANNED_LARGE_BLOCKS = 32     # B7's 1 MiB bench batch (32 MiB, as at 128 KiB)
CLI_SYNC_BYTES = 32 << 20     # the CLI's sync suite input
#: Offsets that tie: multiples of one period, duplicates, a 0 that matches
#: everywhere, one past the block.
TIES = (94, 47, 141, 47, 3, 6, 0, 140000)
FFT_TEXT_BLOCKS = 64          # text batch of the B5 / B4 / emitter checks
EDGE_BLOCKS = 37              # blocks of the B5 / B4 edge batches (below 132, no multiple)
#: (block, seg, max_match) of B5's edge batches, and (block, max_match) of B4's
WALK_EDGES = ((BLOCK, 1024, 1024), (BLOCK, 2048, 2047), (48 * 1024, 1024, 64),
              (16 * 1024, 512, 1))
DYN_EDGES = ((BLOCK, 1), (BLOCK, 256), (BLOCK, 2047), (48 * 1024, 64))
SHORT_BLOCKS = 32             # short RLE blocks of the width-128 emitter check
PLANNED_MAX_PASSES = 64       # B7's plan budget per 128 KiB block
TABLE_STEP_BLOCKS = 256       # blocks of the multi-device B2 steps
RANKS = 4                     # gloo ranks sharing the one card (path b)
WORLD_TIMEOUT = 300.0         # seconds a spawned world may take
WORLD_REPS = 10               # --world: runs of each timed step; the best is kept
WORLD_SKEW = 2                # --world: skew_bucket_log of the skewed flat-step run
WORLD_ENGINE_STREAMS = 8      # --world: streams of the async suite over the Driver's engines
TIMED_REPS = (3, 20)          # (plain, kernel) launches per timed turn
HOST_CALLS = 200              # calls per host-clock reading of a wrapper
#: Rows whose held time is the kernel alone (their launch function); the
#: others time the wrapper's call.
HELD_ALONE = ("decode_flat", "decode_tables", "decode_planned")
PROFILE_PAD_S = 0.02          # --profile: idle host seconds at each end of a profiler window
PROFILE_KERNELS = False       # --profile: the profiler's kernel-only time beside each held time
MULTI_BURST = 128             # burst size of the multi-burst paths (8 bursts a unit)
#: Host-clock seconds of each smoke engine's ``initialize``, where the
#: planner's scratch is prefaulted; logged with its path's phases.
INITIALIZE_S: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def engine(btt, codec, block=BLOCK, nblocks=NBLOCKS, **kw):
    kw.setdefault("commit", "deferred")
    kw.setdefault("burst_size", min(nblocks, 1024))
    cfg = btt.EngineConfig(codec=codec, block_size=block, max_pool_slots=nblocks + 32, **kw)
    eng = btt.Engine(cfg, device="cuda")
    t0 = time.perf_counter()
    eng.initialize()
    INITIALIZE_S[eng] = time.perf_counter() - t0
    return eng


def split_text(split: dict) -> str:
    """The planner's split (``native.plan_prof``), ms summed over its threads."""
    return "planner ms, thread-summed: " + ", ".join(f"{k} {v:.1f}" for k, v in split.items())


def turns(timing, kernel, plain, plain_reps: int = TIMED_REPS[0]):
    """Plain, kernel, kernel, plain: mean ms per call of each, and the turns."""
    kernel_reps = TIMED_REPS[1]
    ms = {"plain": [], "kernel": []}
    for name, fn, reps in (("plain", plain, plain_reps), ("kernel", kernel, kernel_reps),
                           ("kernel", kernel, kernel_reps), ("plain", plain, plain_reps)):
        ms[name].append(timing.device_time_ms(fn, reps))
    return {k: sum(v) / len(v) for k, v in ms.items()}, ms


def launch_counter(stem: str):
    """The launch counter of ``stem``'s kernel, as a function that reads it."""
    from bitar_tpu_torch.ops import (decode_flat, decode_planned, decode_tables, emit, match,
                                     match_dyn)
    mod, attr = {"decode_flat": (decode_flat, "launches"),
                 "decode_tables": (decode_tables, "launches"),
                 "decode_planned": (decode_planned, "launches"),
                 "match": (match, "launches"), "emit": (emit, "launches"),
                 "match_walk": (match_dyn, "walk_launches"),
                 "match_dyn": (match_dyn, "dyn_launches"),
                 "parse_walk": (match_dyn, "parse_walk_launches")}[stem]
    return lambda: getattr(mod, attr)


def profiler_kernel_ms(fn, reps: int, name: str) -> float | None:
    """``--profile`` only: the kernel-only ms per call of the kernels named
    like ``name`` in one ``torch.profiler`` window (CUPTI), each kernel
    name's mean summed; None when the window kept no such record, which
    happens for a cause not found.  Nothing gates on it."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    us = [device_us(e) / e.count for e in prof.key_averages() if name in e.key and e.count]
    return sum(us) / 1e3 if us else None


def wrapper_times(timing, label: str, card: str, stem: str, call, alone=None) -> float:
    """The held time (``timing.kernel_time_ms``, counted by ``stem``'s launch
    counter) of ``alone``, the kernel alone (its module's launch function on
    inputs made outside the window), or else of ``call`` (the wrapper, and
    whatever else it enqueues), and the host time per call of ``call``; with
    ``--profile``, the profiler's kernel-only time beside them.  Logs them
    and returns the held ms per launch."""
    k = timing.kernel_time_ms(alone or call, TIMED_REPS[1], launch_counter(stem))
    h = timing.host_us_per_call(call, HOST_CALLS)
    msg = (f"{label} [{card}] held ({'kernel' if alone else 'call'}): {k:.4f} ms/launch "
           f"({TIMED_REPS[1]} launches back to back); wrapper host: {h:.1f} us/call "
           f"({HOST_CALLS} calls, no synchronize)")
    if PROFILE_KERNELS:
        p = profiler_kernel_ms(call, TIMED_REPS[1], f"{stem}_kernel")
        msg += (f"; torch.profiler kernel-only {p:.4f} ms" if p is not None
                else "; torch.profiler kept no kernel record")
    log(msg)
    return k


def report(label, card, res, ms, raw_bytes):
    for k in ("kernel", "plain"):
        log(f"{label} [{card}] {k}: {res[k]:.4f} ms/launch "
            f"(turns {', '.join(f'{x:.4f}' for x in ms[k])}), "
            f"{raw_bytes / res[k] / 1e6:.3f} GB/s of raw bytes")


# ---------------------------------------------------------------------------
# B1: flat-plan decode


def planned_batch(btt, data: bytes, block: int = BLOCK):
    """Compress ``data`` through a fresh engine; return the arena's slot
    buffer and the unit's slot table, plan tensors and comp_rows (the
    kernel's real inputs: the engine's decode reads each block in its slot,
    through the table)."""
    eng = engine(btt, btt.Codec.LZ4, block=block, nblocks=len(data) // block)
    unit = eng.compress(data)
    eng.ensure_plans(unit)
    pf = unit.plan_flat
    comp_len = unit.manifest.comp_len.astype(np.int64)
    stats = (f"blocks={unit.nblocks} ratio={unit.manifest.ratio():.3f} "
             f"passes={int(pf['p_used'].sum())} "
             f"dense_passes={int(np.maximum(pf['dense'], 0).sum())} "
             f"raw_blocks={int((pf['dense'] < 0).sum())} "
             f"host_blocks={pf['host_blocks'].size}")
    batch = (eng.arena.buffer, unit.slot_table(), unit.plan_device_arrays(),
             unit.plan_comp_rows, comp_len, stats)
    eng.recycle(unit)
    eng.release()
    return batch


def compare_decode(df, rows, table, pt, comp_rows, block: int = BLOCK) -> int:
    """Kernel vs plain version on the same inputs; returns max |diff|."""
    return compare_flat(df, rows, table, pt, comp_rows, block // 128)


def compare_flat(df, rows, table, pt, comp_rows, out_rows: int) -> int:
    """B1 against its plain version at any plane height; max |diff|.  With
    ``table`` the kernel reads block b at row ``table[b]`` of ``rows`` (the
    arena) and the plain version decodes the rows the table selects."""
    got = df.decode_blocks_flat(rows, pt, comp_rows=comp_rows, out_rows=out_rows,
                                src_rows=table)
    torch.cuda.synchronize()
    if table is not None:
        rows = rows.index_select(0, table)
    return check_equal("decode_flat", got, df.decode_flat_reference(rows, pt, comp_rows,
                                                                    out_rows))


def skewed_burst(btt, df):
    """One burst of the CLI's skewed suite (BASELINE config 4): the first
    SKEWED_BURST of its 256 LZ4 blocks of 4 KiB-1 MiB on 8192-row planes, as
    the engine launches B1 on them.  Returns (the arena's slot buffer, the
    burst's slot table, plan tensors, comp_rows, stored bytes a block,
    stats)."""
    from bitar_tpu_torch.cli.demo import make_skewed_input

    data, sizes = make_skewed_input(LARGE_BLOCK, SKEWED_BLOCKS)
    cfg = btt.EngineConfig(codec=btt.Codec.LZ4, block_size=LARGE_BLOCK, burst_size=SKEWED_BURST,
                           max_pool_slots=SKEWED_BLOCKS + 32, commit="deferred")
    eng = btt.Engine(cfg, device="cuda").initialize()
    unit = eng.compress(data, sizes=sizes)
    eng.ensure_plans(unit)
    pt = unit.plan_device_arrays()
    pt = {k: v[:SKEWED_BURST] if k in ("p_used", "p_off", "p0", "dense", "dq_idx") else v
          for k, v in pt.items()}
    comp_len = unit.manifest.comp_len[:SKEWED_BURST].astype(np.int64)
    stats = (f"{SKEWED_BURST} blocks of {min(sizes[:SKEWED_BURST]):,}-"
             f"{max(sizes[:SKEWED_BURST]):,} B, classes "
             + ", ".join(f"{k} {v.numel()}" for k, v in df.block_classes(pt).items()))
    batch = (eng.arena.buffer, unit.slot_table()[:SKEWED_BURST], pt, unit.plan_comp_rows,
             comp_len, stats)
    eng.recycle(unit)
    eng.release()
    return batch


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err != 0 or not torch.equal(got, want):
        bad = int((got != want).reshape(got.shape[0], -1).any(1).sum())
        raise AssertionError(f"{name}: kernel != plain version on {bad} rows "
                             f"(max |diff| {err})")
    return err


def decode_bound(pt, comp_len, block: int = BLOCK) -> tuple[float, str]:
    """Per block: its stored bytes read, its plane written, and the plan
    wire it uses read: its dq row and the anchor planes of its dense passes,
    its passes' se/shift rows and its five int32 fields."""
    nrows = block // 128
    dense, p_used = (pt[k].cpu().numpy().astype(np.int64) for k in ("dense", "p_used"))
    anchors = np.clip(np.minimum(dense, pt["row_a"].shape[1]), 0, None)
    wire = (dense > 0) * block * 2 + anchors * nrows * 4 + p_used * nrows * 6 + 20
    return bound_ms(int(comp_len.sum()) + len(comp_len) * block + int(wire.sum()))


def host_path(btt, codec, data: bytes, block: int = BLOCK) -> None:
    """compress -> ensure_plans -> decompress -> prepare_device_decode ->
    recycle, twice on one engine: the second unit (the data turned by a
    quarter) is compressed after the first was recycled and must be planned
    into the first unit's grant.  An arena that holds a prefault's unit must
    have the planner's chunk scratch for its rows after ``initialize``."""
    from bitar_tpu_torch.ops.cpu import native

    eng = engine(btt, codec, block=block, nblocks=len(data) // block)
    nb, sets = btt.Engine._PLAN_CHUNK_BLOCKS, btt.Engine._PLAN_PREWARM_CHUNKS
    if eng.config.max_pool_slots >= nb * sets:
        missing = [ci for ci in range(sets)
                   if (ci, nb, block // 128) not in btt.Engine._PLAN_CHUNK_SCRATCH]
        if missing:
            raise AssertionError(f"{codec.value}: no chunk scratch {missing} after initialize")
    q = len(data) // 4 // block * block
    grant = None
    for k, part in enumerate((data, data[q:] + data[:q])):
        native.plan_prof(reset=True)
        t0 = time.perf_counter()
        unit = eng.compress(part)
        t1 = time.perf_counter()
        eng.ensure_plans(unit)
        t2 = time.perf_counter()
        split = native.plan_prof()
        out = eng.decompress(unit)
        t3 = time.perf_counter()
        what = f"{codec.value} unit {k}"
        if out.tobytes() != part:
            raise AssertionError(f"{what}: round trip not bit-exact")
        host = unit.plan_flat["host_blocks"]
        if host.size:
            raise AssertionError(f"{what}: {host.size} blocks decoded on the host")
        if grant is not None and not np.shares_memory(unit.plan_flat["se"], grant["se"]):
            raise AssertionError(f"{what}: not planned into the recycled unit's grant")
        grant = unit.plan_flat["_pooled"]
        planes = eng.prepare_device_decode(unit)()
        got = planes.reshape(unit.nblocks, -1)[:, :block].cpu().numpy().tobytes()
        if got != part:
            raise AssertionError(f"{what}: prepare_device_decode bytes differ")
        n = eng.recycle(unit)
        if n != unit.nblocks:
            raise AssertionError(f"{what}: recycled {n} of {unit.nblocks} slots")
        log(f"main path host compress {codec.value}, unit {k}: {unit.nblocks} x {block} B "
            f"bit-exact, ratio {unit.manifest.ratio():.3f}, host-decoded blocks 0"
            + (", in unit 0's grant" if k else "") + "; host clock: "
            + (f"initialize {1e3 * INITIALIZE_S[eng]:.1f} ms, " if k == 0 else "")
            + f"compress {1e3 * (t1 - t0):.1f} ms, plan join {1e3 * (t2 - t1):.1f} ms "
            f"({split_text(split)}), decompress incl. readback {1e3 * (t3 - t2):.1f} ms")
    eng.release()


def device_path(btt, data: bytes) -> None:
    """The device-compress main path: compress on the card, decode on it."""
    eng = engine(btt, btt.Codec.LZ4, commit="eager", compress_matcher="device")
    t0 = time.perf_counter()
    unit = eng.compress(data)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = eng.decompress(unit)
    t2 = time.perf_counter()
    if out.tobytes() != data:
        raise AssertionError("device compress: round trip not bit-exact")
    if unit.plan_flat["host_blocks"].size:
        raise AssertionError("device compress: blocks decoded on the host")
    m = unit.manifest
    raw_blocks = int((m.codec_ids == btt.manifest.codec_id(btt.Codec.RAW)).sum())
    n = eng.recycle(unit)
    eng.release()
    if n != unit.nblocks:
        raise AssertionError(f"device compress: recycled {n} of {unit.nblocks} slots")
    log(f"main path device compress lz4: {unit.nblocks} x {BLOCK} B bit-exact, "
        f"ratio {m.ratio():.3f}, RAW blocks {raw_blocks}; host clock: compress "
        f"{1e3 * (t1 - t0):.1f} ms, decompress (plan build, decode, readback) "
        f"{1e3 * (t2 - t1):.1f} ms")


# ---------------------------------------------------------------------------
# B5, B4 and the emitter


def planes_of(data: bytes, n: int) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data[:n * BLOCK], np.uint8).reshape(n, BLOCK)
                            .copy()).cuda()


def detected(md, planes):
    """(noff, offs, lengths) that the pipeline's detector stage gives
    ``planes`` (full-length blocks)."""
    n = planes.shape[0]
    lens = torch.full((n,), BLOCK, dtype=torch.int32, device=planes.device)
    offs, _ = md.detect_offsets(planes, k=4, max_off=min(0xFFFF, BLOCK - 128))
    offs = offs.contiguous()
    return (offs > 0).sum(dim=1).int(), offs, lens


def split_rec(rec: torch.Tensor, wcap: int = 8):
    """B5's record tensor -> (P, M, O, overflow), as its wrapper slices it."""
    n = rec.shape[0]
    return (*(rec[:, i * wcap:(i + 1) * wcap].transpose(1, 2).reshape(n, -1)
              for i in range(3)), (rec[:, 3 * wcap] != 0).any(dim=1))


def hand_batch():
    """Blocks with hand-set offsets where the choice between offsets
    matters: equal runs of several offsets (the first strictly longest
    wins), duplicates, a 0 inside the first ``noff``, ``noff = 0``, runs that
    reach the plane end, two tail lengths.  (planes, noff, offs, lengths)."""
    rng = np.random.default_rng(11)
    tail = rng.integers(0, 256, BLOCK, np.uint8)
    tail[BLOCK - 700:] = 0x41
    planes = np.stack([
        np.frombuffer((b"The quick brown fox jumps over the lazy dog 7. "
                       * (BLOCK // 47 + 1))[:BLOCK], np.uint8),
        np.full(BLOCK, 7, np.uint8),
        rng.integers(0, 256, BLOCK, np.uint8),
        rng.integers(0, 4, BLOCK, np.uint8),
        np.tile(rng.integers(32, 127, 1338, np.uint8), BLOCK // 1338 + 1)[:BLOCK],
        tail])
    offs = np.array([[94, 47, 141, 0],          # equal runs from position 141 on
                     [1, 2, 3, 0],              # every run reaches the plane end
                     [5, 9, 0, 0],              # noff = 0
                     [3, 3, 2, 1],              # duplicates
                     [2676, 1338, 669, 0],
                     [1, 0, 300, 0]], np.int32)  # a 0 inside the first noff
    noff = np.array([3, 3, 0, 4, 3, 3], np.int32)
    lengths = np.array([BLOCK, BLOCK, BLOCK, BLOCK - 1000, BLOCK - 37, BLOCK], np.int32)
    for b, ln in enumerate(lengths):
        planes[b, ln:] = 0
    return tuple(torch.from_numpy(a).cuda() for a in (planes, noff, offs, lengths))


def short_batch():
    """Short RLE blocks (1-12 KiB of one byte, zero after) that compress to
    fewer than 128 bytes: rows a width-128 emission really emits."""
    lengths = (1024 + 512 * (np.arange(SHORT_BLOCKS) % 23)).astype(np.int32)
    planes = np.zeros((SHORT_BLOCKS, BLOCK), np.uint8)
    for b, ln in enumerate(lengths):
        planes[b, :ln] = 1 + b
    return torch.from_numpy(planes).cuda(), torch.from_numpy(lengths).cuda()


def compare_walk(md, planes, noff, offs, lens, what: str, seg: int = 1024,
                 max_match: int = 1024):
    """B5 against its plain version; returns (max |diff|, P/M/O/overflow)."""
    n, L = planes.shape
    got = md.find_matches_parse_dyn(planes.view(n, -1, 128), noff, offs, lens,
                                    nrows=L // 128, seg=seg, min_match=6, max_match=max_match)
    torch.cuda.synchronize()
    want = split_rec(md.match_walk_reference(planes, noff, offs, lens, seg=seg, min_match=6,
                                             wcap=8, max_match=max_match))
    return max(check_equal(f"match_walk {what} {k}", g, w)
               for k, g, w in zip("PMOo", got, want)), got


def compare_dyn(md, planes, noff, offs, what: str, max_match: int = 256):
    """B4 against its plain version; returns (max |diff|, the positions whose
    best offset is not the block's first)."""
    n, L = planes.shape
    got = md.find_matches_dyn(planes.view(n, -1, 128), noff, offs, nrows=L // 128,
                              max_match=max_match)
    torch.cuda.synchronize()
    want = md.match_dyn_reference(planes, noff, offs, max_match=max_match)
    err = max(check_equal(f"match_dyn {what} mlen", got[0].view(n, -1), want[0]),
              check_equal(f"match_dyn {what} moff", got[1].view(n, -1), want[1]))
    return err, int(((want[1] > 0) & (want[1] != offs[:, :1])).sum())


def edge_batch(md, block: int, n: int = EDGE_BLOCKS):
    """``match_dyn.edge_batch`` on the card, with the noff of two blocks out
    of range (clamped to [0, K] by the kernels): (planes, noff, offs, lengths)."""
    planes, noff, offs, lengths = md.edge_batch(block, n)
    noff[7], noff[8] = offs.shape[1] + 3, -1
    return tuple(torch.from_numpy(a).cuda() for a in (planes, noff, offs, lengths))


def score_bound(planes, noff, out_bytes: int) -> tuple[float, str]:
    """B5's or B4's least time: the plane of each block with an offset and
    its noff, offsets and lengths read, ``out_bytes`` written; two int32
    operations per position and offset (the equality, the comparison with
    the best), as ``match_bound`` counts B3's."""
    n, L = planes.shape
    live = noff.clamp(min=0)
    return bound_ms(int((live > 0).sum()) * L + 12 * n + out_bytes, 2.0 * float(live.sum()) * L)


def emit_bound(em, lay, ow: int) -> tuple[float, str]:
    """The emitter's least time at width ``ow`` (``emit.bound_bytes``)."""
    return bound_ms(em.bound_bytes(lay, ow))


# ---------------------------------------------------------------------------
# B2: sequence-table decode; B3: static-offset match


def table_batch(btt, data: bytes, block: int, max_passes: int | None = None):
    """Compress ``data`` through an engine whose units decode from sequence
    tables (blocks of fewer than 128 rows, or a plan budget no block meets);
    return the unit's gathered rows, table tensors, stored bytes per block
    and stats."""
    n = -(-len(data) // block)
    eng = engine(btt, btt.Codec.LZ4, block=block, nblocks=n, plan_build="lazy")
    if max_passes is not None:
        eng._PLAN_MAX_PASSES = max_passes
    unit = eng.compress(data)
    eng.ensure_plans(unit)
    if unit.plan_flat is not None or unit.tables is None:
        raise AssertionError(f"{n} x {block} B: the unit did not take the table path")
    rows = eng.arena.gather_burst([r.slot for r in unit.refs])
    nseq, tables = unit.table_device_arrays()
    stats = (f"{n} x {block} B, ratio {unit.manifest.ratio():.3f}, sequences "
             f"{int(unit.nseq.sum())} (max {int(unit.nseq.max())} per block, S "
             f"{unit.tables['lit_ptr'].shape[1]})")
    batch = (rows, nseq, tables, block, unit.manifest.comp_len.copy(), stats)
    eng.recycle(unit)
    eng.release()
    return batch


def rle_table_batch(dt, block: int = TABLE_BLOCK, step: int = 1):
    """Offsets 1..130 (every ``step``-th), both sides of the 128-byte row: d
    literal bytes, one match of offset d, 5 final literals; blocks of
    ``block`` bytes."""
    rng = np.random.default_rng(12)
    n = -(-130 // step)
    rows = rng.integers(0, 256, (n, 256), np.uint8)
    tables = {k: np.zeros((n, 128), np.int32) for k in ("lit_ptr", "lit_len", "off", "mlen",
                                                         "out_pos")}
    offs = [1 + i * step for i in range(n)]
    for i, d in enumerate(offs):
        tables["lit_len"][i, :2] = [d, 5]
        tables["off"][i, 0] = d
        tables["mlen"][i, 0] = block - d - 5
        tables["lit_ptr"][i, 1] = d
        tables["out_pos"][i, 1] = block - 5
    nseq, tt = dt.table_tensors(tables, np.full(n, 2, np.int32), "cuda")
    want = np.stack([np.concatenate([np.tile(rows[i, :d], block // d + 1)[:block - 5],
                                     rows[i, d:d + 5]]) for i, d in enumerate(offs)])
    return torch.from_numpy(rows).cuda(), nseq, tt, block, np.full(n, 256), want


def compare_tables(dt, rows, nseq, tables, block: int,
                   src_rows=None) -> tuple[int, torch.Tensor, list]:
    """B2 against its plain version; also the blocks the kernel decoded in
    parallel and serially, which must be the classifier's counts.  With
    ``src_rows``, B2 through them, and the plain version on the rows and
    tables they select."""
    paths = torch.zeros(2, dtype=torch.int32, device=rows.device)
    got = dt.decode_blocks(rows, nseq, tables, out_rows=block // 128, path_counts=paths,
                           src_rows=src_rows)
    torch.cuda.synchronize()
    if src_rows is not None:
        rows, nseq = rows.index_select(0, src_rows), nseq.index_select(0, src_rows)
        tables = {k: v.index_select(0, src_rows) for k, v in tables.items()}
    want = dt.decode_tables_reference(rows, nseq, tables, block // 128)
    wf = int(dt.well_formed(nseq, tables).sum())
    paths = paths.tolist()
    if paths != [wf, rows.shape[0] - wf]:
        raise AssertionError(f"decode_tables: blocks by path {paths}, classifier {wf} well-formed "
                             f"of {rows.shape[0]}")
    return check_equal("decode_tables", got, want), got, paths


def tables_bound(rows, nseq, comp_len, block: int) -> tuple[float, str]:
    """Stored bytes read, 20 bytes of table per sequence, the planes written."""
    return bound_ms(int(comp_len.sum()) + 20 * int(nseq.sum()) + rows.shape[0] * block)


def compare_match(mt, planes, offsets, max_match: int, emit_values: bool, what: str):
    n = planes.shape[0]
    got = mt.find_matches(planes.view(n, -1, 128), offsets=offsets, nrows=BLOCK // 128,
                          max_match=max_match, emit_values=emit_values)
    torch.cuda.synchronize()
    want = mt.match_reference(planes, offsets, max_match=max_match, emit_values=emit_values)
    err = max(check_equal(f"match {what} mlen", got[0].view(n, -1), want[0]),
              check_equal(f"match {what} idx", got[1].view(n, -1), want[1]))
    first = offsets[0] if emit_values else 0
    later = int(((want[0] > 0) & (want[1] != first)).sum())
    return err, later, float((want[0] > 0).float().mean())


def match_bound(n: int, nk: int, block: int = BLOCK) -> tuple[float, str]:
    """The planes read, 8 bytes per position written; two int32 operations
    per position and offset (the equality, the comparison with the best)."""
    return bound_ms(n * block * 9, 2.0 * n * block * nk)


# ---------------------------------------------------------------------------
# B6: parse walk over match planes; B7: dense-plan decode


def walk_hand_batch(seg: int):
    """[8, seg * 128] match planes where the walk's edges matter: moff = 0
    inside long runs, every segment past wcap, random sparse hits, and
    lengths below L.  (mlen, moff, lengths) on the card."""
    rng = np.random.default_rng(seg)
    n, L = 8, seg * 128
    mlen = np.zeros((n, L), np.int32)
    moff = np.zeros((n, L), np.int32)
    mlen[0], moff[0] = 300, 7
    for lo in range(0, L, 900):
        moff[0, lo:lo + 200] = 0                   # moff = 0 inside long runs
    mlen[1], moff[1] = 7, 1                        # every segment overflows wcap
    on = rng.random((n - 2, L)) < 0.4
    mlen[2:] = np.where(on, rng.integers(1, 64, (n - 2, L)), 0)
    moff[2:] = np.where(on, rng.integers(0, 4, (n - 2, L)), 0)
    lengths = np.array([L, L, L - 1, L // 2 + 5, L - seg - 3, 13, L, 3 * seg], np.int32)
    return tuple(torch.from_numpy(a).cuda() for a in (mlen, moff, lengths))


def compare_parse_walk(md, mlen, moff, lengths, seg: int, what: str):
    """B6 against its plain version (wcap 8, min_match 6); returns
    (max |diff|, P/M/O/overflow)."""
    got = md.parse_walk_dyn(mlen, moff, lengths, seg=seg, min_match=6, wcap=8)
    torch.cuda.synchronize()
    want = md.parse_walk_reference(mlen, moff, lengths, seg=seg, min_match=6, wcap=8)
    return max(check_equal(f"parse_walk {what} {k}", g, w)
               for k, g, w in zip("PMOo", got, want)), got


def walk_bound(md, mlen, moff, lengths, P, M, seg: int, wcap: int, min_match: int = 6):
    """B6's least time on this data (``match_dyn.walk_bound_bytes``)."""
    return bound_ms(md.walk_bound_bytes(mlen, moff, lengths, P, M, seg=seg, wcap=wcap,
                                        min_match=min_match))


def planned_bound(p_used, stored: int, passes: int, block: int = BLOCK) -> tuple[float, str]:
    """B7's least traffic: the stored bytes, 8 bytes of plan per pass used
    and output row, the planes written."""
    used = int(p_used.clamp(min=0, max=passes).sum())
    return bound_ms(stored + 8 * used * (block // 128) + p_used.shape[0] * block)


# ---------------------------------------------------------------------------
# The multi-device paths


def check_steps(result: dict, what: str) -> None:
    for step, r in result.items():
        if isinstance(r, dict) and "exact" in r and not r["exact"]:
            raise AssertionError(f"{what}: {step} rows not bit-exact")
    if result.get("ring_equals_flat") is False:
        raise AssertionError(f"{what}: ring != fused step")


def log_steps(what: str, result: dict, card: str) -> None:
    log(f"main path {what}: " + ", ".join(
        f"{step} {r['live']} live rows bit-exact, {1e3 * r['seconds']:.1f} ms"
        for step, r in result.items() if isinstance(r, dict) and "exact" in r)
        + f" (host clock, device synchronized) [{card}]")


def world_refusal(n: int) -> str | None:
    """Why ``--world n`` cannot run on this machine, or None: it needs CUDA
    and ``n`` cards, one a rank (NCCL puts no two ranks on one card)."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < n:
        return (f"--world {n} needs {n} CUDA devices, one a rank; "
                f"{torch.cuda.device_count()} visible")
    return None


def world_specs(n: int) -> list[dict]:
    """The runs of the ``n``-card phase, in one world of ``n`` ranks: the
    shuffle, fused and ring steps at NBLOCKS blocks a rank (timed, with the
    fused step's phases and the ring's CUDA-event timeline), the fused step
    under a skewed plan, and the sharded and tables steps at
    TABLE_STEP_BLOCKS a rank; all of the bench corpus in 128 KiB blocks."""
    return [{"corpus": "bench", "nblocks": n * NBLOCKS, "block": BLOCK,
             "steps": ("shuffle", "flat", "ring"), "reps": WORLD_REPS, "phases": True,
             "overlap": True},
            {"corpus": "bench", "nblocks": n * NBLOCKS, "block": BLOCK, "steps": ("flat",),
             "skew_bucket_log": WORLD_SKEW},
            {"corpus": "bench", "nblocks": n * TABLE_STEP_BLOCKS, "block": BLOCK,
             "steps": ("sharded", "tables")}]


def check_world(res: list, kernels: tuple[str, ...] = ("decode_flat", "decode_tables")
                ) -> None:
    """Every rank of an NCCL world (``res[rank]``: its runs' results): each
    run's rows bit-exact, the ring equal to the fused step, the backend
    NCCL, the rank's device its own card, each of ``kernels`` launched on
    that card and nowhere else, and a CUDA context on no other card."""
    for rank, runs in enumerate(res):
        for i, r in enumerate(runs):
            check_steps(r, f"rank {rank}, run {i}")
            if r["backend"] != "nccl" or r["device"] != f"cuda:{rank}":
                raise AssertionError(f"rank {rank}: backend {r['backend']}, device {r['device']}")
            if r["contexts"] != [rank]:
                raise AssertionError(f"rank {rank}: CUDA contexts on cards {r['contexts']}")
        for k in kernels:
            cards: dict = {}
            for r in runs:
                for c, count in r["device_launches"][k].items():
                    cards[c] = cards.get(c, 0) + count
            if set(cards) != {rank}:
                raise AssertionError(f"rank {rank}: {k} launched on cards {cards}")


def nccl_transports(log_dir: str) -> tuple[dict, list[str]]:
    """The transports that NCCL's INFO lines in ``log_dir`` name for its
    connections ("via P2P/CUMEM", "via SHM", "via NET/..."), each with its
    count of lines over every rank; and one rank's first few such lines, of
    the links NCCL's topology search found (its GRAPH lines: "NVL" for
    NVLink, "PCI") and of the patterns it chose."""
    import glob
    import re

    counts: dict[str, int] = {}
    lines: dict[str, list] = {"via": [], "link": [], "pattern": []}
    for i, path in enumerate(sorted(glob.glob(os.path.join(log_dir, "nccl.*")))):
        with open(path, errors="replace") as f:
            for line in f:
                m = re.search(r" via (\S+)", line)
                kind = ("via" if m else "link" if re.search(r"NVL\[|PCI\[|NVS/", line)
                        else "pattern" if "Pattern" in line else None)
                if m:
                    counts[m.group(1)] = counts.get(m.group(1), 0) + 1
                if kind and i == 0 and len(lines[kind]) < 6:
                    lines[kind].append(line.strip())
    return counts, [x for v in lines.values() for x in v]


@contextlib.contextmanager
def environ(**env):
    """``os.environ`` with ``env`` set inside the block (spawned children
    inherit it), as it was after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def world_phase(n: int, card: str) -> dict:
    """``--world n``: an NCCL world of ``n`` spawned ranks, one card each
    (``world_specs``, held to ``check_world``), then an NCCL world of 1 on
    NBLOCKS blocks, the weak-scaling baseline of the fused and ring steps.
    Logs the topology, NCCL's transport, every rank's times and the ring's
    timeline; returns the numbers of the world line."""
    import tempfile

    from bitar_tpu_torch.cli.multihost_bench import weak_scaling_efficiency
    from bitar_tpu_torch.parallel import dryrun, multihost

    for cmd in (["topo", "-m"], ["nvlink", "--status", "-i", "0"]):
        out = subprocess.run(["nvidia-smi", *cmd], capture_output=True, text=True)
        for line in (out.stdout + out.stderr).strip().splitlines()[:24]:
            log(f"nvidia-smi {' '.join(cmd)}: {line}")
    log(f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}; this process's CUDA "
        f"contexts before the world: {multihost.cuda_contexts()}")
    specs = world_specs(n)
    with tempfile.TemporaryDirectory(prefix="bitar-nccl-") as logs:
        t0 = time.perf_counter()
        with environ(NCCL_DEBUG="INFO", NCCL_DEBUG_SUBSYS="INIT,GRAPH",
                     NCCL_DEBUG_FILE=os.path.join(logs, "nccl.%h.%p.log")):
            res = dryrun.run_world(n, dryrun.steps_in_turn, specs, backend="nccl",
                                   timeout=WORLD_TIMEOUT)
        wall = time.perf_counter() - t0
        transports, lines = nccl_transports(logs)
    check_world(res)
    log(f"world of {n}: NCCL on cards {[runs[0]['device'] for runs in res]}, every run's "
        f"rows bit-exact, ring == fused step, B1 and B2 on each rank's own card only, "
        f"CUDA contexts by rank {[runs[0]['contexts'] for runs in res]}; wall clock "
        f"incl. spawn and batch builds {wall:.1f} s")
    for line in lines:
        log(f"NCCL_DEBUG=INFO: {line}")
    log(f"NCCL transports (connection lines by kind): {transports or 'no via line in the log'}")
    for rank, runs in enumerate(res):
        for what, r in zip(("steps", "skewed plan", "tables"), runs, strict=True):
            log_steps(f"world of {n}, rank {rank}, {what}", r, card)
        flat, ring = runs[0]["flat"], runs[0]["ring"]
        log(f"world of {n}, rank {rank}: fused step {1e3 * flat['seconds']:.4f} ms; exchange "
            f"alone {1e3 * flat['exchange_seconds']:.4f} ms, decode alone "
            f"{1e3 * flat['decode_seconds']:.4f} ms; ring {1e3 * ring['seconds']:.4f} ms "
            f"(best of {WORLD_REPS}, host clock, device synchronized) [{card}]")
        log(f"world of {n}, rank {rank}: ring timeline (CUDA events, ms after the rounds are "
            f"posted) {json.dumps(ring['timeline'])} [{card}]")
    t0 = time.perf_counter()
    (base,) = dryrun.run_world(1, dryrun.steps_in_turn,
                               [dict(specs[0], nblocks=NBLOCKS, steps=("flat", "ring"))],
                               backend="nccl", timeout=WORLD_TIMEOUT)
    check_world([base], ("decode_flat",))
    log_steps(f"NCCL world of 1 (spawned), {NBLOCKS} x 128 KiB", base[0], card)
    log(f"NCCL world of 1: {time.perf_counter() - t0:.1f} s wall clock")

    def worst(run: int, step: str, key: str = "seconds") -> float:
        return 1e3 * max(runs[run][step][key] for runs in res)

    line = {"ranks": n, "blocks_per_rank": NBLOCKS, "block": BLOCK, "backend": "nccl",
            "card": card, "transports": transports,
            "flat_ms": worst(0, "flat"), "ring_ms": worst(0, "ring"),
            "exchange_ms": worst(0, "flat", "exchange_seconds"),
            "decode_ms": worst(0, "flat", "decode_seconds"),
            "base_flat_ms": 1e3 * base[0]["flat"]["seconds"],
            "base_ring_ms": 1e3 * base[0]["ring"]["seconds"],
            "skew_flat_ms": worst(1, "flat"), "sharded_ms": worst(2, "sharded"),
            "tables_ms": worst(2, "tables"),
            "ring_overlap_ms": [runs[0]["ring"]["timeline"]["overlap_ms"] for runs in res],
            "launches_by_rank": {k: [sum(r["launches"][k] for r in runs) for runs in res]
                                 for k in ("decode_flat", "decode_tables")}}
    for step in ("flat", "ring"):
        line[f"{step}_efficiency"] = weak_scaling_efficiency(
            n, n * NBLOCKS, line[f"{step}_ms"], NBLOCKS, line[f"base_{step}_ms"])
    log(f"weak scaling, {n} cards against 1 at {NBLOCKS} x 128 KiB a card: fused step "
        f"{line['flat_efficiency']:.4f} ({line['base_flat_ms']:.4f} -> {line['flat_ms']:.4f} "
        f"ms), ring step {line['ring_efficiency']:.4f} ({line['base_ring_ms']:.4f} -> "
        f"{line['ring_ms']:.4f} ms), slowest rank [{card}]")
    return line


def engines_on_every_card(btt, df, data: bytes, card: str) -> dict:
    """``--world``: the Driver's engines, one a card, in this process.  Each
    round-trips its share of ``data`` (compress -> ensure_plans ->
    decompress, bit-exact, no block decoded on the host) with its arena,
    its device decode and its B1 launches on its own card; then the demo's
    async suite runs WORLD_ENGINE_STREAMS streams round-robin over them,
    every stream bit-exact.  Returns B1's launches by card in the suite."""
    from bitar_tpu_torch.cli import demo

    n = torch.cuda.device_count()
    cfg = btt.EngineConfig(codec=btt.Codec.LZ4, block_size=BLOCK, burst_size=1024,
                           max_pool_slots=NBLOCKS + 32, commit="deferred")
    engines = btt.Driver.instance().get_engines(cfg)
    if [e.device for e in engines] != [torch.device("cuda", k) for k in range(n)]:
        raise AssertionError(f"Driver engines on {[str(e.device) for e in engines]}")
    share = len(data) // n
    for k, eng in enumerate(engines):
        part = data[k * share:(k + 1) * share]
        before = df.device_launches.copy()
        unit, phases = roundtrip(eng, part, f"engine on cuda:{k}")
        got = eng.prepare_device_decode(unit)()
        if eng.arena._buf.device != eng.device or got.device != eng.device:
            raise AssertionError(f"engine on cuda:{k}: arena on {eng.arena._buf.device}, "
                                 f"device decode on {got.device}")
        if got.reshape(-1).cpu().numpy().tobytes() != part:
            raise AssertionError(f"engine on cuda:{k}: device decode not bit-exact")
        cards = dict(df.device_launches - before)
        if set(cards) != {k}:
            raise AssertionError(f"engine on cuda:{k}: decode_flat launched on cards {cards}")
        log_path(f"Driver engine on cuda:{k}", unit, card, phases,
                 f", decode_flat launches by card {cards}")
        eng.recycle(unit)
    before = df.device_launches.copy()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        demo.evaluate_async(engines, data, WORLD_ENGINE_STREAMS)
    wall = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        log(f"async suite over {n} engines: {line}")
    cards = dict(df.device_launches - before)
    if f"async verify OK ({WORLD_ENGINE_STREAMS} segments bit-exact)" not in out.getvalue():
        raise AssertionError(f"async suite over {n} engines: not verified")
    if set(cards) != set(range(n)) or any(e.stats.host_decode_bursts for e in engines):
        raise AssertionError(f"async suite over {n} engines: decode_flat on cards {cards}, "
                             "or blocks decoded on the host")
    for eng in engines:
        eng.release()
    log(f"async suite: {WORLD_ENGINE_STREAMS} streams round-robin over {n} engines, "
        f"{len(data)} B, every stream bit-exact, decode_flat launches by card {cards}, "
        f"{wall:.1f} s wall clock [{card}]")
    return cards


def world_main(n: int) -> int:
    """``--world n``: the build of the host library, B1 and B2, then the
    ``n``-card phase alone; no result on a machine with fewer cards."""
    refusal = world_refusal(n)
    if refusal:
        print(f"chip_smoke --world {n}: {refusal}; no result", file=sys.stderr)
        return 1
    import bitar_tpu_torch as btt
    from bitar_tpu_torch.ops import decode_flat as df
    from bitar_tpu_torch.ops import decode_tables as dt
    from bitar_tpu_torch.ops.cpu import native
    from bitar_tpu_torch.utils.corpus import make_corpus

    t_start = time.perf_counter()
    card = card_line()
    for line in subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.splitlines():
        log(f"card {line}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.device_count()} "
        f"devices")
    builds = {"host library (g++)": native.load, "decode_flat.cu": df.load_kernel,
              "decode_tables.cu": dt.load_kernel}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as ex:
        futs = {name: ex.submit(lambda f=f: (f(), time.perf_counter())[1])
                for name, f in builds.items()}
        done = {name: fut.result() - t0 for name, fut in futs.items()}
    log("build (all started together): " + ", ".join(
        f"{name} {s:.2f} s" for name, s in done.items()))
    line = world_phase(n, card)
    line["engines_decode_flat_by_card"] = engines_on_every_card(btt, df, make_corpus(NBLOCKS),
                                                                card)
    log(f"smoke --world {n} wall clock {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"world": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

def nccl_world_of_one(df, dt, card: str, counts: dict) -> None:
    """Path (a): an NCCL world of 1 in this process, ``file://`` rendezvous:
    make_mesh(1) -> plan_shuffle -> execute_shuffle, distributed_step_flat,
    distributed_step_ring_flat over 1024 x 128 KiB of the bench corpus (B1);
    then sharded_decode and distributed_step_tables_fallback over 256 x
    128 KiB (B2)."""
    import tempfile

    import torch.distributed as dist

    from bitar_tpu_torch.parallel import dryrun, make_mesh, multihost

    with tempfile.TemporaryDirectory(prefix="bitar-rdv-") as tmp:
        multihost.initialize(f"file://{tmp}/rendezvous", 1, 0, backend="nccl")
        try:
            mesh = make_mesh(1)
            df.launches = 0
            flat = dryrun.steps_program(mesh, {"corpus": "bench", "nblocks": NBLOCKS,
                                               "block": BLOCK,
                                               "steps": ("shuffle", "flat", "ring")})
            counts["NCCL world of 1: fused and ring steps"] = {"decode_flat": df.launches}
            dt.launches = 0
            tab = dryrun.steps_program(mesh, {"corpus": "bench", "nblocks": TABLE_STEP_BLOCKS,
                                              "block": BLOCK, "steps": ("sharded", "tables")})
            counts["NCCL world of 1: sharded and tables steps"] = {"decode_tables": dt.launches}
        finally:
            dist.destroy_process_group()
    for what, r in (("NCCL world of 1, 1024 x 128 KiB", flat),
                    ("NCCL world of 1, 256 x 128 KiB", tab)):
        check_steps(r, what)
        log_steps(what, r, card)


def gloo_ranks_on_one_card(card: str, counts: dict) -> None:
    """Path (b): RANKS spawned ranks on the one card, exchange on gloo
    (all-to-all on CUDA tensors; the ring's point-to-point rounds
    host-staged through pinned buffers), B1 on cuda:0 in every rank; fused
    and ring steps over 256 x 128 KiB."""
    from bitar_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    res = dryrun.run_world(RANKS, dryrun.steps_program,
                           {"corpus": "bench", "nblocks": MATCH_BLOCKS, "block": BLOCK,
                            "steps": ("flat", "ring")},
                           backend="gloo", device_type="cuda", timeout=WORLD_TIMEOUT)
    wall = time.perf_counter() - t0
    for rank, r in enumerate(res):
        check_steps(r, f"gloo rank {rank}")
        if r["launches"]["decode_flat"] <= 0:
            raise AssertionError(f"gloo rank {rank} launched no decode_flat kernel")
        log_steps(f"{RANKS} gloo ranks on one card, rank {rank}, {MATCH_BLOCKS} x 128 KiB",
                  r, card)
    log(f"{RANKS} gloo ranks: exchange gloo all_to_all on CUDA tensors, ring rounds gloo "
        f"(host-staged); world wall clock incl. spawn and batch build {wall:.1f} s; "
        f"decode_flat launches per rank {[r['launches']['decode_flat'] for r in res]}")
    counts[f"{RANKS} gloo ranks on one card"] = {
        "decode_flat": sum(r["launches"]["decode_flat"] for r in res)}


# ---------------------------------------------------------------------------
# The main paths added with B2 and B3


def roundtrip(eng, data: bytes, what: str):
    """compress -> ensure_plans -> decompress on ``eng``: bit-exact, no
    block decoded on the host.  Returns the unit and its phases: the
    engine's ``initialize`` where ``engine`` made it, the host clock of each
    step, and the planner's split of the plan join."""
    from bitar_tpu_torch.ops.cpu import native

    native.plan_prof(reset=True)
    t0 = time.perf_counter()
    unit = eng.compress(data)
    torch.cuda.synchronize(eng.device)
    t1 = time.perf_counter()
    eng.ensure_plans(unit)
    t2 = time.perf_counter()
    split = native.plan_prof()
    out = eng.decompress(unit)
    t3 = time.perf_counter()
    if out.tobytes() != data:
        raise AssertionError(f"{what}: round trip not bit-exact")
    if eng.stats.host_decode_bursts or (
            unit.plan_flat is not None and unit.plan_flat["host_blocks"].size):
        raise AssertionError(f"{what}: blocks decoded on the host")
    phases = {"initialize": INITIALIZE_S[eng]} if eng in INITIALIZE_S else {}
    return unit, phases | {"compress": t1 - t0, "ensure_plans": t2 - t1, "planner": split,
                           "decompress": t3 - t2}


def log_path(what: str, unit, card: str, phases: dict, extra: str = "") -> None:
    """One line: the unit, then its phases (a dict phase, the planner's
    split, in brackets after the phase before it)."""
    parts = []
    for k, v in phases.items():
        if isinstance(v, dict):
            parts[-1] += f" ({split_text(v)})"
        else:
            parts.append(f"{k} {1e3 * v:.1f} ms")
    log(f"main path {what}: {unit.nblocks} x {unit.manifest.block_size} B bit-exact, ratio "
        f"{unit.manifest.ratio():.3f}, host-decoded blocks 0{extra}; host clock [{card}]: "
        + ", ".join(parts))


def multi_burst_paths(btt, df, dt, data: bytes, card: str, counts: dict) -> None:
    """Units of NBLOCKS blocks in bursts of MULTI_BURST, each burst read back
    on a worker thread and copied into the output as it lands: the planned
    path at 128 KiB (B1) and the tables path at 4 KiB (B2), bit-exact."""
    for what, block, kernel, name in (("planned", BLOCK, df, "decode_flat"),
                                      ("tables", TABLE_BLOCK, dt, "decode_tables")):
        eng = engine(btt, btt.Codec.LZ4, block=block, burst_size=MULTI_BURST)
        df.launches = dt.launches = 0
        unit, phases = roundtrip(eng, data[:NBLOCKS * block], f"{what}, bursts of {MULTI_BURST}")
        counts[f"multi-burst {what} path"] = {name: kernel.launches}
        bursts = eng.stats.device_decode_bursts
        if bursts != NBLOCKS // MULTI_BURST or (unit.tables is not None) != (what == "tables"):
            raise AssertionError(f"multi-burst {what}: {bursts} bursts, tables "
                                 f"{unit.tables is not None}")
        log_path(f"{what}, {bursts} bursts of {MULTI_BURST} read back out of order", unit, card,
                 phases)
        eng.recycle(unit)
        eng.release()


def tables_path(btt, data: bytes, card: str) -> None:
    n = len(data) // TABLE_BLOCK
    eng = engine(btt, btt.Codec.LZ4, block=TABLE_BLOCK, nblocks=n)
    unit, phases = roundtrip(eng, data, "tables")
    if unit.tables is None or unit.plan_flat is not None:
        raise AssertionError("tables path: the unit did not decode from its tables")
    t0 = time.perf_counter()
    again = eng.decompress(unit)
    phases["second decompress (no slot re-walked)"] = time.perf_counter() - t0
    if again.tobytes() != data:
        raise AssertionError("tables path: second decompress differs")
    log_path("sequence tables lz4", unit, card, phases,
             f", sequences {int(unit.nseq.sum())}")
    eng.recycle(unit)
    eng.release()


def block_picks_path(btt, data: bytes, card: str, units: int = 4, picks: int = 1884) -> None:
    """Blocks picked across ``units`` 4 KiB LZ4 units of ``data``
    (``Engine.decompress_blocks_device``, the MultiGet's call): each plane
    its raw block; traced, every pick read in place and no slot gathered."""
    from bitar_tpu_torch.utils import profiling

    per = len(data) // units // TABLE_BLOCK * TABLE_BLOCK
    eng = engine(btt, btt.Codec.LZ4, block=TABLE_BLOCK, nblocks=units * per // TABLE_BLOCK)
    us = [eng.compress(data[i * per:(i + 1) * per]) for i in range(units)]
    rng = np.random.default_rng(11)
    ui = rng.integers(0, units, picks)
    bi = rng.integers(0, per // TABLE_BLOCK, picks)
    profiling.snapshot(reset=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = eng.decompress_blocks_device(us, ui, bi)
    counted = profiling.snapshot(reset=True)
    if any(u.tables is None or u.plan_flat is not None for u in us):
        raise AssertionError("block picks path: a unit did not decode from its tables")
    if counted.get("arena.inplace_blocks") != picks or counted.get("arena.gather_bytes"):
        raise AssertionError(f"block picks path: counters {counted}")
    want = np.frombuffer(data, np.uint8)[:units * per].reshape(units, -1, TABLE_BLOCK)[ui, bi]
    if not np.array_equal(got.reshape(picks, -1).cpu().numpy(), want):
        raise AssertionError("block picks path: picks differ from their raw blocks")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        eng.decompress_blocks_device(us, ui, bi)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    log(f"main path block picks: {picks} of {units} x {per // TABLE_BLOCK} x {TABLE_BLOCK} B "
        f"bit-exact, all read in place; host clock [{card}]: "
        f"{1e6 * (t1 - t0) / HOST_CALLS:.1f} us/call ({HOST_CALLS} calls, no synchronize)")
    for u in us:
        eng.recycle(u)
    eng.release()


def zstd_path(btt, data: bytes, card: str) -> None:
    eng = engine(btt, btt.Codec.ZSTD)
    unit, phases = roundtrip(eng, data, "zstd")
    got = eng.prepare_device_decode(unit)().reshape(unit.nblocks, -1).cpu().numpy()
    if got.tobytes() != data:
        raise AssertionError("zstd: prepare_device_decode bytes differ")
    log_path("zstd", unit, card, phases,
             f", literal planes {len(unit.plan_flat['lit_planes'])}")
    eng.recycle(unit)
    eng.release()


def matcher_path(btt, data: bytes, card: str, codec, **kw) -> None:
    eng = engine(btt, codec, **kw)
    unit, phases = roundtrip(eng, data, f"{kw} {codec.value}")
    log_path(f"{kw} {codec.value}", unit, card, phases)
    eng.recycle(unit)
    eng.release()


def batched_path(btt, data: bytes, df) -> None:
    items = []
    part = data[:BATCH_UNIT_BLOCKS * BLOCK]
    for codec in (btt.Codec.LZ4, btt.Codec.ZSTD, btt.Codec.SNAPPY):
        eng = engine(btt, codec, nblocks=BATCH_UNIT_BLOCKS)
        items.append((eng, eng.compress(part)))
    before = df.launches
    launch, slices = btt.prepare_batched_decode(items)
    out = launch().reshape(3 * BATCH_UNIT_BLOCKS, -1).cpu().numpy()
    if df.launches != before + 1:
        raise AssertionError("batched decode: not one decode_flat launch")
    for lo, hi in slices:
        if out[lo:hi].tobytes() != part:
            raise AssertionError(f"batched decode: rows {lo}:{hi} differ")
    for eng, unit in items:
        eng.recycle(unit)
        eng.release()
    log(f"main path prepare_batched_decode: lz4 + zstd + snappy units of "
        f"{BATCH_UNIT_BLOCKS} x {BLOCK} B in one decode_flat launch, bit-exact")


def streams_path(btt, data: bytes) -> None:
    eng = engine(btt, btt.Codec.LZ4)
    streams = btt.make_streams([eng], 4)
    q = len(data) // 4
    segs = [data[i * q:(i + 1) * q] for i in range(4)]
    units, outs = {}, {}

    def keep(store, i):
        def cb(stream, result):
            store[i] = result.value_or_raise()
            return btt.ASYNC_RETURN_OK
        return cb

    for i, st in enumerate(streams):
        if not st.compress_async(btt.CompressParam(eng, segs[i], keep(units, i))).ok():
            raise AssertionError(f"stream {i}: compress refused")
    if btt.wait_all(streams) != [btt.ASYNC_RETURN_OK] * 4:
        raise AssertionError("streams: compress failed")
    for i, st in enumerate(streams):
        if not st.decompress_async(btt.DecompressParam(eng, units[i],
                                                       result_callback=keep(outs, i))).ok():
            raise AssertionError(f"stream {i}: decompress refused")
    if btt.wait_all(streams) != [btt.ASYNC_RETURN_OK] * 4:
        raise AssertionError("streams: decompress failed")
    for i in range(4):
        if outs[i].tobytes() != segs[i] or eng.recycle(units[i]) != units[i].nblocks:
            raise AssertionError(f"stream {i}: not bit-exact")
    for st in streams:
        st.close()
    if eng.stats.host_decode_bursts:
        raise AssertionError("streams: blocks decoded on the host")
    eng.release()
    log(f"main path streams: 4 streams on one engine, {len(data)} B, bit-exact")


def large_tables_path(btt, data: bytes, card: str) -> None:
    """A unit of 1 MiB blocks the planner takes no block of (a 2-pass plan
    budget on the text corpus): decoded by B2's cluster route."""
    eng = engine(btt, btt.Codec.LZ4, block=LARGE_BLOCK, nblocks=len(data) // LARGE_BLOCK)
    eng._PLAN_MAX_PASSES = 2
    unit, phases = roundtrip(eng, data, "1 MiB tables")
    if unit.tables is None or unit.plan_flat is not None:
        raise AssertionError("1 MiB tables path: the unit did not decode from its tables")
    log_path("sequence tables lz4, 1 MiB blocks", unit, card, phases,
             f", sequences {int(unit.nseq.sum())}")
    eng.recycle(unit)
    eng.release()


def cli_skewed(card: str) -> dict:
    """BASELINE config 4 through the CLI as a user runs it: the skewed
    suite at 1 MiB blocks on the card (LZ4).  Returns its stats."""
    import tempfile

    from bitar_tpu_torch.cli import demo

    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/skewed.json"
        rc = demo.main(["--mode", "skewed", "--block-size", str(LARGE_BLOCK),
                        "--blocks", str(SKEWED_BLOCKS), "--output", out])
        with open(out) as f:
            stats = json.load(f)
    if rc != 0 or stats["blocks"] != SKEWED_BLOCKS:
        raise AssertionError(f"CLI skewed suite: rc {rc}, stats {stats}")
    if stats["host_decode_bursts"]:
        raise AssertionError("CLI skewed suite: blocks decoded on the host")
    log(f"main path CLI skewed suite [{card}]: " + json.dumps(
        {k: v for k, v in stats.items() if k != "burst_lat_ms"}))
    return stats


def cli_sync(data: bytes, card: str) -> None:
    """The CLI's sync suite on a file of the corpus at its default 128 KiB
    blocks (bit-exact, or the CLI exits non-zero)."""
    import tempfile

    from bitar_tpu_torch.cli import demo

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/corpus.bin"
        with open(path, "wb") as f:
            f.write(data)
        rc = demo.main(["--file", path, "--mode", "sync"])
    if rc != 0:
        raise AssertionError(f"CLI sync suite: rc {rc}")
    log(f"main path CLI sync suite: {len(data)} B at 128 KiB blocks bit-exact [{card}]")


def tpu_phases(btt, mt, native_mod, data: bytes, card: str, block: int = BLOCK) -> None:
    """Host-clock phases of the tpu matcher's compress, as
    ``Engine._compress_tpu_match`` runs them, each ended by a sync."""
    n = len(data) // block
    clock = PhaseClock(card, f"tpu matcher compress, {n} x {block // 1024} KiB")
    planes = np.frombuffer(data, np.uint8).reshape(n, block // 128, 128).copy()
    clock.mark("plane packing (numpy)")
    dplanes = torch.from_numpy(planes).cuda()
    clock.mark("upload (pageable H2D)")
    mlen, oidx = mt.find_matches(dplanes, offsets=mt.DEFAULT_OFFSETS, nrows=block // 128)
    clock.mark("match kernel (B3)")
    mlen, oidx = mlen.cpu().numpy(), oidx.cpu().numpy()
    clock.mark(f"hint readback ({2 * mlen.nbytes >> 20} MiB, D2H)")
    native_mod.set_emit_min_match(6)
    raw = np.frombuffer(data, np.uint8)
    for i in range(n):
        native_mod.lz4_emit_sequences(raw[i * block:(i + 1) * block], mlen[i].reshape(-1),
                                      oidx[i].reshape(-1), mt.DEFAULT_OFFSETS)
    clock.mark("host emission (one thread)")
    clock.log()


# ---------------------------------------------------------------------------
# The device matchers and B7 at 256 KiB to 1 MiB


def large_planes(data: bytes, block: int, n: int) -> torch.Tensor:
    """[n, block] planes of ``data`` on the card."""
    return torch.from_numpy(np.frombuffer(data[:n * block], np.uint8).reshape(n, block)
                            .copy()).cuda()


def compare_match_chunked(mt, planes, offsets, max_match: int, values: bool, what: str,
                          chunk: int = 4) -> int:
    """B3 on the whole batch against its plain version ``chunk`` blocks at a
    time; returns max |diff|."""
    n, L = planes.shape
    got = mt.find_matches(planes.view(n, -1, 128), offsets=offsets, nrows=L // 128,
                          max_match=max_match, emit_values=values)
    torch.cuda.synchronize()
    err = 0
    for r in range(0, n, chunk):
        want = mt.match_reference(planes[r:r + chunk], offsets, max_match=max_match,
                                  emit_values=values)
        for k, g, w in zip(("mlen", "idx"), got, want):
            err = max(err, check_equal(f"match {what} {k} blocks {r}+",
                                       g[r:r + chunk].reshape(-1, L), w))
    return err


def large_match_checks(mt, corpus: bytes, lplanes: torch.Tensor) -> int:
    """B3 at 256 KiB and 1 MiB: far offsets (past 56 KiB, every tile window
    above 64 KiB; the LZ4 format's largest; one whose window passes shared
    memory, so every tile reads device memory), each with a block of that
    period, indices at max_match 64 and values at max_match 1024; and the
    tpu matcher's launched shape, 128 x 1 MiB, ``DEFAULT_OFFSETS``."""
    err = 0
    for block, fars in FAR_OFFSETS.items():
        planes = large_planes(corpus, block, LARGE_CHECK_BLOCKS)
        for b, far in enumerate(fars, start=1):
            planes[b] = planes[b, :far].repeat(block // far + 1)[:block]
        for far in fars:
            offsets = (3, far, 1, 64)
            window = mt.tile_plan(block, offsets, 64)["window"]
            for mm, values in ((64, False), (1024, True)):
                err = max(err, compare_match_chunked(mt, planes, offsets, mm, values,
                                                     f"{block // 1024} KiB far {far}"))
            log(f"match == plain version (mlen/idx): {LARGE_CHECK_BLOCKS} x {block} B, offsets "
                f"{offsets}, indices max_match 64 and values max_match 1024; "
                + (f"tile window {window} B staged" if window else
                   "tile windows past shared memory: sources read from device memory"))
    err = max(err, compare_match_chunked(mt, lplanes, mt.DEFAULT_OFFSETS, 64, False,
                                         "tpu shape 1 MiB", chunk=16))
    log(f"match == plain version (mlen/idx): bench, the tpu matcher's shape {lplanes.shape[0]} "
        f"x {LARGE_BLOCK} B, 26 offsets, indices, max_match 64")
    return err


def large_emit_checks(em, dc, mt, lplanes, llens) -> tuple[int, dict, int]:
    """The emitter on 1 MiB edge layouts and at the engine's 1 MiB
    ``match_offsets`` shape (the parse with the worst-case budget at
    min_match 64, the engine's width), a few rows of the plain version at a
    time; returns (max |diff|, that layout, its width)."""
    err = 0
    for fmt, wcap, mm in (("lz4", 8, 6), ("lz4", None, 64), ("snappy", 8, 6)):
        epl, eln, elay = em.edge_layouts(LARGE_BLOCK, fmt=fmt, wcap=wcap, min_match=mm, n=8)
        epl, eln = torch.from_numpy(epl).cuda(), torch.from_numpy(eln).cuda()
        elay = {k: torch.from_numpy(v).cuda() for k, v in elay.items()}
        widths = ((256, 98304) if fmt == "snappy"
                  else (128, 98304, -(-dc.lz4_bound(LARGE_BLOCK) // 128) * 128))
        for ow in widths:
            got = em.emit_blocks(epl, elay, out_width=ow, fmt=fmt, lengths=eln)
            torch.cuda.synchronize()
            for r in range(0, 8, 2):
                rows = {k: v[r:r + 2] for k, v in elay.items()}
                err = max(err, check_equal(f"emit 1 MiB edge {fmt} wcap {wcap} ow {ow}",
                                           got[r:r + 2], em.emit_reference(
                                               epl[r:r + 2], rows, out_width=ow, fmt=fmt,
                                               lengths=eln[r:r + 2])))
        log(f"emit == plain version, whole rows: 1 MiB edge layouts {fmt}, wcap {wcap}, "
            f"slots a row {elay['starts'].shape[1]}, widths {widths}")
    lay = dc.match_parse_device(lplanes, llens, min_match=64, offsets=mt.DEFAULT_OFFSETS)
    ow = dc.engine_width(lay["total"].cpu().numpy(), llens.cpu().numpy(), LARGE_BLOCK)
    got = em.emit_blocks(lplanes, lay, out_width=ow, lengths=llens)
    torch.cuda.synchronize()
    for r in range(0, lplanes.shape[0], 16):
        rows = {k: v[r:r + 16] for k, v in lay.items()}
        err = max(err, check_equal(f"emit 1 MiB engine shape rows {r}+", got[r:r + 16],
                                   em.emit_reference(lplanes[r:r + 16], rows, out_width=ow,
                                                     lengths=llens[r:r + 16])))
    log(f"emit == plain version, whole rows: the engine's match_offsets shape, "
        f"{lplanes.shape[0]} x 1 MiB, min_match 64, slots a row {lay['starts'].shape[1]}, "
        f"width {ow}")
    return err, lay, ow


def large_dyn_checks(md) -> tuple[int, int, int]:
    """B5, B4 and B6 at 1 MiB through their own entry points: the edge batch
    (offsets up to L - 128) at seg 8192 (nseg 128), B6 on B4's planes of it
    and on ``walk_edge_batch(8192, 128)``; returns their max |diff|."""
    pl, nf, of, ln = edge_batch(md, LARGE_BLOCK, LARGE_EDGE_BLOCKS)
    e5, _ = compare_walk(md, pl, nf, of, ln, "edge 1 MiB", 8192, 1024)
    e4, _ = compare_dyn(md, pl, nf, of, "edge 1 MiB", 2047)
    mlen4, moff4 = (t.reshape(pl.shape[0], -1) for t in md.find_matches_dyn(
        pl.view(pl.shape[0], -1, 128), nf, of, nrows=LARGE_BLOCK // 128, max_match=1024))
    e6, _ = compare_parse_walk(md, mlen4, moff4, ln, 8192, "edge 1 MiB B4 planes")
    wm, wo, wl = (torch.from_numpy(a).cuda() for a in md.walk_edge_batch(8192, 128))
    for wcap in (0, 8):
        got = md.parse_walk_dyn(wm, wo, wl, seg=8192, min_match=6, wcap=wcap)
        torch.cuda.synchronize()
        want = md.parse_walk_reference(wm, wo, wl, seg=8192, min_match=6, wcap=wcap)
        e6 = max(e6, max(check_equal(f"parse_walk 1 MiB edge wcap {wcap} {k}", g, w)
                         for k, g, w in zip("PMOo", got, want)))
    log(f"match_walk, match_dyn, parse_walk == plain versions at 1 MiB: edge batch "
        f"{LARGE_EDGE_BLOCKS} x 1 MiB (offsets up to L - 128), seg 8192, max_match 1024 (B5) "
        f"and 2047 (B4), B6 on B4's planes and on walk_edge_batch(8192, 128), wcap 0 and 8")
    return e5, e4, e6


def large_planned_checks(dp, corpus: bytes, text: bytes) -> tuple[int, dict]:
    """B7's tall route: planner plans of text at 256 KiB and 1 MiB and of
    the bench corpus at 1 MiB (each block decodes to its raw bytes), random
    malformed plans and pass-class plans at 1152, 2048, 5120 and 8192 rows
    (batches all quiet, all taking a cluster, both, and slices that stop at
    different passes); every launch's slice stops are ``slice_stops``'s.
    Returns (max |diff|, the bench batch for phases 4 and 5)."""
    err, gmem, calls = 0, dp.gmem_launches, 0

    def check(what, plans, **kw):
        nonlocal err, calls
        plans = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in plans]
        stops = torch.empty((plans[0].shape[0], dp.cluster_ctas(kw["out_rows"])),
                            dtype=torch.int32, device="cuda")
        got = dp.decode_blocks_planned(*plans, stops=stops, **kw)
        torch.cuda.synchronize()
        calls += 1
        for r in range(0, got.shape[0], 8):
            err = max(err, check_equal(f"decode_planned {what} blocks {r}+", got[r:r + 8],
                                       dp.decode_planned_reference(
                                           *(a[r:r + 8] for a in plans), **kw)))
        if not torch.equal(stops, dp.slice_stops(*plans[2:], plans[1], **kw)):
            raise AssertionError(f"decode_planned {what}: slice stops differ from slice_stops")
        return got, stops

    bench = None
    for name, data, block, n, passes in (
            ("text", text, MID_BLOCK, 4, 256), ("text", text, LARGE_BLOCK, 4, 256),
            ("bench", corpus, LARGE_BLOCK, PLANNED_LARGE_BLOCKS, PLANNED_MAX_PASSES)):
        datas = [data[i * block:(i + 1) * block] for i in range(n)]
        wire = dp.plan_blocks(datas, block, passes)
        args = [wire[k] for k in ("comp", "p_used", "se", "shift")]
        kw = dict(passes=wire["passes"], comp_rows=wire["comp_rows"], out_rows=block // 128)
        got, stops = check(f"{name} {block}", args, **kw)
        host = got.reshape(len(wire["fit"]), -1).cpu().numpy()
        if any(host[j].tobytes() != datas[i] for j, i in enumerate(wire["fit"])):
            raise AssertionError(f"decode_planned {name} {block}: blocks differ from raw bytes")
        quiet = int((stops.min(1).values.cpu().numpy() >= wire["p_used"]).sum())
        log(f"decode_planned == plain version, byte for byte (tall route): {name}, "
            f"{len(wire['fit'])} of {n} x {block} B planned within {passes} passes, passes "
            f"{wire['passes']} (mean {float(wire['p_used'].mean()):.1f}), comp_rows "
            f"{wire['comp_rows']}; every block its raw bytes; {quiet} blocks quiet (no "
            f"plane-reading pass), the others in clusters of {dp.cluster_ctas(block // 128)}")
        if name == "bench":
            bench = (wire, datas, [torch.from_numpy(a).cuda() for a in args], kw)
    for rows in (1152, 2048, 5120, 8192):
        c = dp.cluster_ctas(rows)
        check(f"random {rows}", dp.random_plans(19, 8, 5, 1024, rows),
              passes=5, comp_rows=1024, out_rows=rows)
        for reads in ([False] * 4, [True, False, False], [False, True, False, True, True]):
            check(f"class {rows}", dp.class_plans(20, 8, reads, 512, rows),
                  passes=len(reads), comp_rows=512, out_rows=rows)
        check(f"staggered {rows}", dp.class_plans(
            21, 8, [False, True, False, True, True], 64, rows,
            slices=[None, [c - 1], None, [0], None]), passes=5, comp_rows=64, out_rows=rows)
        quiet = dp.class_plans(22, 4, [False] * 4, 512, rows)
        busy = list(dp.class_plans(23, 4, [False, True, False, True], 512, rows))
        busy[1] = np.full(4, 4, np.int32)
        check(f"mixed {rows}", [np.concatenate(x) for x in zip(quiet, busy)],
              passes=4, comp_rows=512, out_rows=rows)
        log(f"decode_planned == plain version, byte for byte (tall route): random malformed "
            f"plans, pass-class plans (c, Pcc, cPcPP), slices stopping at different passes, "
            f"a batch half quiet, {rows} rows")
    if dp.gmem_launches - gmem != calls:
        raise AssertionError("decode_planned: a launch above 1024 rows missed the tall route")
    return err, bench


def large_matcher_path(btt, data: bytes, card: str, codec, counts: dict, mods: dict,
                       name: str, **kw) -> None:
    """A 1 MiB matcher path, the launch counts of ``mods`` (name -> kernel
    module) reset just before it: compress -> decode through B1's tall
    (cluster) route, bit-exact, no block on the host, host-clock phases
    logged; then 4 blocks' container equal to the port's CPU engine's (which
    the CPU tests hold to the JAX engine's)."""
    df = mods["decode_flat"]
    for mod in mods.values():
        mod.launches = 0
    df.cluster_launches = 0
    eng = engine(btt, codec, block=LARGE_BLOCK, nblocks=len(data) // LARGE_BLOCK, **kw)
    unit, phases = roundtrip(eng, data, name)
    log_path(name, unit, card, phases)
    eng.recycle(unit)
    counts[name] = {k: mod.launches for k, mod in mods.items()}
    if df.cluster_launches != df.launches:
        raise AssertionError(f"{name}: {df.cluster_launches} of {df.launches} decode_flat "
                             f"launches on the tall (cluster) route")
    mine = eng.compress(data[:4 * LARGE_BLOCK]).to_host().to_bytes()
    eng.release()
    cfg = btt.EngineConfig(codec=codec, block_size=LARGE_BLOCK, burst_size=4,
                           max_pool_slots=36, **kw)
    with btt.Engine(cfg, device="cpu") as ref:
        if ref.compress(data[:4 * LARGE_BLOCK]).to_host().to_bytes() != mine:
            raise AssertionError(f"{name}: container differs from the CPU engine's")
    log(f"main path {name}: 4 x 1 MiB container equal to the port's CPU engine's")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add the phase breakdown of one warm LZ4 unit per main path, and "
                         "the profiler's kernel-only time beside each held time")
    ap.add_argument("--world", type=int, default=0, metavar="N",
                    help="build B1 and B2, then run only the N-card phase: an NCCL world "
                         "of N ranks, one card each, and the Driver's engine on every card")
    args = ap.parse_args()
    if args.world:
        return world_main(args.world)
    global PROFILE_KERNELS
    PROFILE_KERNELS = args.profile
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no result",
              file=sys.stderr)
        return 1
    import bitar_tpu_torch as btt
    from bitar_tpu_torch.cli import bench
    from bitar_tpu_torch.ops import decode_flat as df
    from bitar_tpu_torch.ops import decode_planned as dp
    from bitar_tpu_torch.ops import decode_tables as dt
    from bitar_tpu_torch.ops import device_compress as dc
    from bitar_tpu_torch.ops import emit as em
    from bitar_tpu_torch.ops import match as mt
    from bitar_tpu_torch.ops import match_dyn as md
    from bitar_tpu_torch.ops._build import BUILD_DIR
    from bitar_tpu_torch.ops.cpu import native
    from bitar_tpu_torch.utils import timing
    from bitar_tpu_torch.utils.corpus import make_corpus, make_text_corpus
    from bitar_tpu_torch.utils.kernel_ab import emit_shapes, resident_picks

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    builds = {"host library (g++)": native.load, "decode_flat.cu": df.load_kernel,
              "match_walk.cu": md.load_walk_kernel, "match_dyn.cu": md.load_dyn_kernel,
              "emit.cu": em.load_kernel, "decode_tables.cu": dt.load_kernel,
              "match.cu": mt.load_kernel, "parse_walk.cu": md.load_parse_walk_kernel,
              "decode_planned.cu": dp.load_kernel, "hold.cu": timing.load_hold_kernel}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as ex:
        futs = {name: ex.submit(lambda f=f: (f(), time.perf_counter())[1])
                for name, f in builds.items()}
        done = {name: fut.result() - t0 for name, fut in futs.items()}
    log("build (all started together): " + ", ".join(
        f"{name} {s:.2f} s" for name, s in done.items()))
    for stem in ("decode_flat", "match_walk", "match_dyn", "emit", "decode_tables", "match",
                 "parse_walk", "decode_planned", "hold"):
        for report_file in BUILD_DIR.glob(f"lib{stem}-*.so.log"):
            for line in report_file.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"ptxas {stem}: {line.strip()}")

    corpus = make_corpus(NBLOCKS)
    text = make_text_corpus(TEXT_BLOCKS)
    rng = np.random.default_rng(7)
    raw_heavy = b"".join(
        rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes() if i % 8 else
        (b"raw-heavy batch %d " % i) * (BLOCK // 18 + 1)
        for i in range(RAW_BLOCKS))[:RAW_BLOCKS * BLOCK]
    kernels = {}

    # -- phase 3: every kernel against its plain version -------------------
    log(f"phase 3 starts at {time.perf_counter() - t_start:.1f} s")
    first = engine(btt, btt.Codec.LZ4)
    log(f"Engine.initialize of this process's first {NBLOCKS} x {BLOCK} B engine (the "
        f"planner's prefault): {1e3 * INITIALIZE_S[first]:.1f} ms host clock [{card}]")
    first.release()
    batches = {"bench": planned_batch(btt, corpus), "text": planned_batch(btt, text),
               "raw_heavy": planned_batch(btt, raw_heavy)}
    err = 0
    for name, (rows, table, pt, comp_rows, _, stats) in batches.items():
        err = max(err, compare_decode(df, rows, table, pt, comp_rows))
        log(f"decode_flat == plain version, byte for byte: {name} ({stats}; in place through "
            "the slot table)")
    # Class-pure batches: each class of block (RAW copy, no out pass, out
    # passes) of the bench and text batches as a batch of its own (the
    # class's entries of the slot table).
    class_batches = {}
    for whole in ("bench", "text"):
        rows, table, pt, comp_rows, comp_len, _ = batches[whole]
        for cls, idx in df.block_classes(pt).items():
            if idx.numel():
                class_batches[f"{whole}, {cls}"] = (rows, *df.select_blocks(table, pt, idx),
                                                    comp_rows, comp_len[idx.cpu().numpy()])
    for name, (rows, table, pt, comp_rows, _) in class_batches.items():
        err = max(err, compare_decode(df, rows, table, pt, comp_rows))
        log(f"decode_flat == plain version, byte for byte: {name}, {table.numel()} blocks")
    # The tall route: planes of 2048 and 8192 rows, whole batches and their
    # class-pure batches.
    large = {("bench", MID_BLOCK): corpus[:128 * MID_BLOCK], ("bench", LARGE_BLOCK): corpus,
             ("text", MID_BLOCK): text[:64 * MID_BLOCK], ("text", LARGE_BLOCK): text}
    large_batches = {}
    df.launches = df.cluster_launches = 0
    for (name, block), data in large.items():
        rows, table, pt, comp_rows, comp_len, stats = planned_batch(btt, data, block)
        large_batches[(name, block)] = (rows, table, pt, comp_rows, comp_len)
        err = max(err, compare_decode(df, rows, table, pt, comp_rows, block))
        for cls, idx in df.block_classes(pt).items():
            if idx.numel():
                st, sp = df.select_blocks(table, pt, idx)
                err = max(err, compare_decode(df, rows, st, sp, comp_rows, block))
                log(f"decode_flat == plain version, byte for byte: {name} {block // 1024} KiB, "
                    f"{cls}, {idx.numel()} blocks")
        log(f"decode_flat == plain version, byte for byte: {name}, {block // 1024} KiB blocks "
            f"({block // 128} rows, tall route; {stats})")
    # The tall route on out passes that gather across its 1024-row slices
    # (whole and part rows, shifts that clip at both plane ends), on
    # malformed random wires, and on one burst of the CLI's skewed suite.
    for out_rows in TALL_ROWS:
        comp, plans = df.slice_crossing_wire(out_rows, 64 + out_rows // 128)
        err = max(err, compare_flat(df, torch.from_numpy(comp).cuda(), None,
                                    df.plan_tensors(plans, "cuda"), out_rows, out_rows))
        comp, plans = df.random_wire(59 + out_rows // 128, 16, out_rows, 2 * out_rows, 16)
        err = max(err, compare_flat(df, torch.from_numpy(comp).cuda(), None,
                                    df.plan_tensors(plans, "cuda"), 2 * out_rows, out_rows))
        log(f"decode_flat == plain version, byte for byte: {out_rows} rows, out passes across "
            "slices and clipped at both ends; random malformed wires (16 blocks)")
    skewed = skewed_burst(btt, df)
    err = max(err, compare_flat(df, *skewed[:4], LARGE_BLOCK // 128))
    log(f"decode_flat == plain version, byte for byte: skewed suite burst ({skewed[5]})")
    if df.cluster_launches != df.launches:
        raise AssertionError(f"decode_flat: {df.cluster_launches} of {df.launches} launches above "
                             "1024 rows took the tall route")
    log(f"decode_flat resident clusters [{card}]: " + ", ".join(
        f"{r} rows {df.resident_clusters(r)} of {df.cluster_ctas(r)} CTAs" for r in TALL_ROWS))
    kernels["decode_flat"] = {"max_abs_err": err}

    mplanes = planes_of(corpus, MATCH_BLOCKS)
    nrows = BLOCK // 128
    noff, offs, mlens = detected(md, mplanes)
    tplanes = planes_of(text, FFT_TEXT_BLOCKS)
    tnoff, toffs = dc.candidate_offsets(tplanes, detect_fft=True, fft_k=6)
    tlens = mlens[:FFT_TEXT_BLOCKS]
    hplanes, hnoff, hoffs, hlens = hand_batch()
    # The headline bench's markdown offload (cli.bench): its chunks of 64
    # rows, each with its own lengths, and the parse arguments it gives
    # compress_blocks_device (detect_fft="sample" picks a chunk's offsets
    # from the chunk's own rows).
    ochunks = bench.text_chunks(planes_of(text, bench.OFFLOAD_BLOCKS), bench.TEXT_CHUNK)
    oparse = {k: v for k, v in bench.OFFLOAD_TEXT.items() if k != "out_width"}

    def walk_kernel():
        return md.find_matches_parse_dyn(mplanes.view(-1, nrows, 128), noff, offs, mlens,
                                         nrows=nrows, seg=1024, min_match=6, max_match=1024)

    err = 0
    walk_batches = {"bench": (mplanes, noff, offs, mlens, 1024, 1024),
                    "text detect_fft": (tplanes, tnoff, toffs, tlens, 1024, 1024),
                    "hand-set offsets": (hplanes, hnoff, hoffs, hlens, 1024, 1024)}
    for block, seg, mm in WALK_EDGES:
        walk_batches[f"edge {block // 1024} KiB"] = (*edge_batch(md, block), seg, mm)
    for i, (pl, ln) in enumerate(ochunks):
        walk_batches[f"bench text offload chunk {i} (detect_fft='sample')"] = (
            pl, *dc.candidate_offsets(pl, detect_fft=oparse["detect_fft"],
                                      fft_k=oparse["fft_k"]), ln, oparse["seg"], 1024)
    for what, (pl, nf, of, ln, seg, mm) in walk_batches.items():
        e, got = compare_walk(md, pl, nf, of, ln, what, seg, mm)
        err = max(err, e)
        log(f"match_walk == plain version (P/M/O/overflow): {what}, {pl.shape[0]} x "
            f"{pl.shape[1]} B, seg {seg}, max_match {mm}, offsets per block "
            f"{nf.clamp(0, of.shape[1]).float().mean():.2f} (K {of.shape[1]}), "
            f"sequences {int((got[0] >= 0).sum())}, overflowing blocks {int(got[3].sum())}")
    kernels["match_walk"] = {"max_abs_err": err}

    dplanes = planes_of(corpus, DYN_BLOCKS)
    dnoff, doffs, _ = detected(md, dplanes)

    err = 0
    dyn_batches = {"bench": (dplanes, dnoff, doffs, 256),
                   "text detect_fft": (tplanes, tnoff, toffs, 256),
                   "hand-set offsets": (hplanes, hnoff, hoffs, 256)}
    for block, mm in DYN_EDGES:
        dyn_batches[f"edge {block // 1024} KiB"] = (*edge_batch(md, block)[:3], mm)
    for what, (pl, nf, of, mm) in dyn_batches.items():
        e, later = compare_dyn(md, pl, nf, of, what, mm)
        err = max(err, e)
        log(f"match_dyn == plain version (mlen/moff): {what}, {pl.shape[0]} x {pl.shape[1]} B, "
            f"max_match {mm}, positions whose best offset is not the first: {later}")
    kernels["match_dyn"] = {"max_abs_err": err}

    splanes, slens = short_batch()
    layouts = {
        "bench lz4": (mplanes, mlens, dc.match_parse_device(mplanes, mlens)),
        "text lz4 detect_fft": (tplanes, tlens, dc.match_parse_device(
            tplanes, tlens, detect_fft=True, fft_k=6)),
        "short RLE lz4": (splanes, slens, dc.match_parse_device(splanes, slens)),
        "bench snappy": (mplanes, mlens, dc.match_parse_device(mplanes, mlens, fmt="snappy")),
    }
    err = 0
    for name, (pl, ln, lay) in layouts.items():
        fmt = "snappy" if "snappy" in name else "lz4"
        n = pl.shape[0]
        adaptive = dc.adaptive_width(lay["total"].cpu().numpy(), ln.cpu().numpy(), BLOCK, 1024)
        widths = (8192,) if fmt == "snappy" else (128, 2048, adaptive)
        for ow in widths:
            got = em.emit_blocks(pl, lay, out_width=ow, fmt=fmt, lengths=ln)
            torch.cuda.synchronize()
            want = em.emit_reference(pl, lay, out_width=ow, fmt=fmt, lengths=ln)
            err = max(err, check_equal(f"emit {name} ow {ow}", got, want))
            codec = btt.Codec.SNAPPY if fmt == "snappy" else btt.Codec.LZ4
            rows = bench.check_offload_rows(codec, got, lay["total"], pl, ln, f"emit {name}")
            if name == "short RLE lz4" and rows == 0:
                raise AssertionError(f"emit {name} ow {ow}: no row fits the width")
            log(f"emit == plain version: {name}, {n} x {BLOCK} B, out_width {ow}; "
                f"{rows} compressed rows decode bit-exact on the host")
    ow = bench.OFFLOAD_TEXT["out_width"]
    for i, (pl, ln) in enumerate(ochunks):
        lay = dc.match_parse_device(pl, ln, **oparse)
        got = em.emit_blocks(pl, lay, out_width=ow, lengths=ln)
        torch.cuda.synchronize()
        err = max(err, check_equal(f"emit bench text offload chunk {i}", got,
                                   em.emit_reference(pl, lay, out_width=ow, lengths=ln)))
        rows = bench.check_offload_rows(btt.Codec.LZ4, got, lay["total"], pl, ln,
                                        f"emit bench text offload chunk {i}")
        log(f"emit == plain version: bench text offload chunk {i}, {pl.shape[0]} x {BLOCK} B "
            f"(detect_fft='sample'), out_width {ow}; {rows} compressed rows decode bit-exact "
            "on the host")
    # The shapes the main paths launch the emitter at (kernel_ab.emit_shapes),
    # whole rows against the plain version, a block of rows at a time.
    emit_at = emit_shapes(corpus, text)
    for name, (pl, lay, ow, ln) in emit_at.items():
        got = em.emit_blocks(pl, lay, out_width=ow, lengths=ln)
        torch.cuda.synchronize()
        for r in range(0, pl.shape[0], 256):
            rows = {k: v[r:r + 256] for k, v in lay.items()}
            err = max(err, check_equal(f"emit {name} rows {r}+", got[r:r + 256], em.emit_reference(
                pl[r:r + 256], rows, out_width=ow, lengths=None if ln is None else ln[r:r + 256])))
        log(f"emit == plain version, whole rows: {name}, slots a row {lay['starts'].shape[1]}")
    for fmt, wcap, L in (("lz4", 8, BLOCK), ("lz4", 64, BLOCK), ("lz4", None, BLOCK),
                         ("snappy", 8, 16384), ("snappy", None, BLOCK)):
        epl, eln, elay = (em.edge_layouts(L, fmt=fmt, wcap=wcap))
        epl, eln = torch.from_numpy(epl).cuda(), torch.from_numpy(eln).cuda()
        elay = {k: torch.from_numpy(v).cuda() for k, v in elay.items()}
        widths = ((256, 8192, 65408, 98304) if fmt == "snappy"
                  else (128, 1000, 2051, 65536, 98304, dc.lz4_bound(L)))
        for ow in widths:
            got = em.emit_blocks(epl, elay, out_width=ow, fmt=fmt, lengths=eln)
            torch.cuda.synchronize()
            err = max(err, check_equal(f"emit edge {fmt} wcap {wcap} ow {ow}", got,
                                       em.emit_reference(epl, elay, out_width=ow, fmt=fmt,
                                                         lengths=eln)))
        log(f"emit == plain version, whole rows: edge layouts {fmt}, wcap {wcap}, "
            f"{epl.shape[0]} x {L} B, slots a row {elay['starts'].shape[1]}, widths {widths}")
    kernels["emit"] = {"max_abs_err": err}

    tbatches = {"bench 4 KiB": table_batch(btt, corpus[:TABLE_CHECK_BLOCKS * TABLE_BLOCK],
                                           TABLE_BLOCK),
                "text 128 KiB, 8-pass plan budget": table_batch(btt, text, BLOCK, max_passes=8)}
    brows, btabs, bnseq, blens = dt.parser_tables([corpus[i * BLOCK:(i + 1) * BLOCK]
                                                   for i in range(TABLE_STEP_BLOCKS)])
    tbatches["bench 128 KiB, the parallel tables step's shape"] = (
        torch.from_numpy(brows).cuda(), *dt.table_tensors(btabs, bnseq, "cuda"), BLOCK, blens,
        f"{TABLE_STEP_BLOCKS} x {BLOCK} B, sequences {int(bnseq.sum())} "
        f"(max {int(bnseq.max())} per block)")
    err = 0
    for name, (rows, nseq, tables, block, _, stats) in tbatches.items():
        e, _, paths = compare_tables(dt, rows, nseq, tables, block)
        err = max(err, e)
        if paths[1]:
            raise AssertionError(f"decode_tables {name}: {paths[1]} parser blocks walked serially")
        log(f"decode_tables == plain version, byte for byte: {name} ({stats}); blocks by "
            f"path: parallel {paths[0]}, serial {paths[1]}")
    rrows, rnseq, rtables, rblock, _, rwant = rle_table_batch(dt)
    e, got, paths = compare_tables(dt, rrows, rnseq, rtables, rblock)
    if got.reshape(rwant.shape[0], -1).cpu().numpy().tobytes() != rwant.tobytes():
        raise AssertionError("decode_tables: RLE offsets 1-130 decode wrong")
    err = max(err, e)
    log("decode_tables == plain version, byte for byte: RLE offsets 1-130, 4 KiB blocks, "
        f"each the expected period; blocks by path: parallel {paths[0]}, serial {paths[1]}")
    for what, (seed, n, S, block) in {"4 KiB": (21, 64, 640, TABLE_BLOCK),
                                      "128 KiB": (22, 16, 2048, BLOCK)}.items():
        rand = {wf: dt.random_tables(seed, n, S, block, well_formed=wf) for wf in (True, False)}
        rand["mixed"] = tuple(
            {k: np.concatenate([a[k][: n // 2], b[k][n // 2:]]) for k in a}
            if isinstance(a, dict) else np.concatenate([a[: n // 2], b[n // 2:]])
            for a, b in zip(rand[True], rand[False]))
        for kind, (r, tabs, ns) in rand.items():
            tn, tt = dt.table_tensors(tabs, ns, "cuda")
            e, _, paths = compare_tables(dt, torch.from_numpy(r).cuda(), tn, tt, block)
            err = max(err, e)
            log(f"decode_tables == plain version, byte for byte: random tables, "
                f"{'well-formed' if kind is True else 'malformed' if kind is False else kind}, "
                f"{n} x {block} B, S {S}; blocks by path: parallel {paths[0]}, serial {paths[1]}")
    # The cluster route at 1 MiB: the tables of a bench unit under a small
    # plan budget, and random well-formed and malformed tables.
    dt.cluster_launches = 0
    large_tables = {
        "bench 1 MiB, 4-pass plan budget": table_batch(btt, corpus[:32 * LARGE_BLOCK],
                                                       LARGE_BLOCK, max_passes=4)}
    # (Malformed tables at S 64: their random literal runs, up to 256 KiB
    # each, cost the plain version ~1 G elements at S 4096.)
    for wf, S in ((True, 4096), (False, 64)):
        r, tabs, ns = dt.random_tables(23 + wf, 12, S, LARGE_BLOCK, well_formed=wf)
        large_tables[f"random {'well-formed' if wf else 'malformed'} 1 MiB"] = (
            torch.from_numpy(r).cuda(), *dt.table_tensors(tabs, ns, "cuda"), LARGE_BLOCK, None,
            f"12 x {LARGE_BLOCK} B, S {S}")
    # 256 KiB parser tables of the bench corpus (2 CTAs), random tables at
    # 1300 and 4096 rows (2 and 4 CTAs), and runs of offsets 1-130 over
    # whole 1 MiB planes.
    mrows, mtabs, mnseq, mid_lens = dt.parser_tables(
        [corpus[i * MID_BLOCK:(i + 1) * MID_BLOCK] for i in range(128)])
    large_tables["bench 256 KiB"] = (torch.from_numpy(mrows).cuda(),
                                     *dt.table_tensors(mtabs, mnseq, "cuda"), MID_BLOCK, mid_lens,
                                     f"128 x {MID_BLOCK} B, sequences {int(mnseq.sum())}")
    # 32 x 1 MiB of markdown: deep parser tables.
    xrows, xtabs, xnseq, xlens = dt.parser_tables(
        [text[i * LARGE_BLOCK:(i + 1) * LARGE_BLOCK] for i in range(32)])
    large_tables["text 1 MiB"] = (torch.from_numpy(xrows).cuda(),
                                  *dt.table_tensors(xtabs, xnseq, "cuda"), LARGE_BLOCK, xlens,
                                  f"32 x {LARGE_BLOCK} B, sequences {int(xnseq.sum())}")
    for out_rows in (1300, 4096):
        for wf, S in ((True, 1024), (False, 64)):
            r, tabs, ns = dt.random_tables(65 + wf + out_rows, 9, S, out_rows * 128,
                                           well_formed=wf)
            large_tables[f"random {'well-formed' if wf else 'malformed'} {out_rows} rows"] = (
                torch.from_numpy(r).cuda(), *dt.table_tensors(tabs, ns, "cuda"),
                out_rows * 128, None, f"9 x {out_rows * 128} B, S {S}")
    for name, (rows, nseq, tables, block, _, stats) in large_tables.items():
        e, _, paths = compare_tables(dt, rows, nseq, tables, block)
        err = max(err, e)
        if ("plan budget" in name or "bench" in name or "text" in name) and paths[1]:
            raise AssertionError(f"decode_tables {name}: {paths[1]} parser blocks walked serially")
        log(f"decode_tables == plain version, byte for byte: {name} (cluster route; "
            f"{stats}); blocks by path: parallel {paths[0]}, serial {paths[1]}")
    rrows, rnseq, rtables, rblock, _, rwant = rle_table_batch(dt, LARGE_BLOCK, 12)
    e, got, paths = compare_tables(dt, rrows, rnseq, rtables, rblock)
    if got.reshape(rwant.shape[0], -1).cpu().numpy().tobytes() != rwant.tobytes():
        raise AssertionError("decode_tables: RLE offsets 1-130 at 1 MiB decode wrong")
    err = max(err, e)
    log("decode_tables == plain version, byte for byte: RLE offsets 1-130, 1 MiB blocks "
        "(cluster route), each the expected period")
    if dt.cluster_launches != len(large_tables) + 1:
        raise AssertionError(f"decode_tables: {dt.cluster_launches} of {len(large_tables) + 1} "
                             "launches above 1224 rows took the cluster route")
    # B2 as the engine launches it on a MultiGet's picks: through the
    # picks' slots over the arena and the table store, against the plain
    # version on the rows and tables those slots select.
    picks = resident_picks()
    e, got, paths = compare_tables(dt, picks["buf"], picks["nseq"], picks["tables"], TABLE_BLOCK,
                                   src_rows=picks["src"])
    err = max(err, e)
    if paths[1]:
        raise AssertionError(f"decode_tables in place: {paths[1]} parser blocks walked serially")
    log(f"decode_tables == plain version, byte for byte: in place, {picks['shape']} "
        f"(sequences {picks['sequences']}, max {picks['max_per_block']} per block); blocks by "
        f"path: parallel {paths[0]}, serial {paths[1]}")
    kernels["decode_tables"] = {"max_abs_err": err}

    err = 0
    lplanes = planes_of(corpus, NBLOCKS)          # the main paths' B3 shape
    for what, (pl, offsets, mm, values) in {
            "bench, indices, max_match 64": (dplanes, mt.DEFAULT_OFFSETS, 64, False),
            "bench, values, max_match 1024": (dplanes, mt.DEFAULT_OFFSETS, 1024, True),
            "bench, launched shape, indices, max_match 64": (lplanes, mt.DEFAULT_OFFSETS, 64,
                                                             False),
            "bench, launched shape, values, max_match 1024": (lplanes, mt.DEFAULT_OFFSETS,
                                                              1024, True),
            "hand-set batch, offsets that tie, values, max_match 1024": (hplanes, TIES, 1024,
                                                                         True)}.items():
        e, later, share = compare_match(mt, pl, offsets, mm, values, what)
        err = max(err, e)
        log(f"match == plain version (mlen/idx): {what}, {pl.shape[0]} x {BLOCK} B, "
            f"{len(offsets)} offsets; positions with a match {share:.4f}, whose offset is "
            f"not the first: {later}")
    kernels["match"] = {"max_abs_err": err}

    # B6 on B4's planes of the bench batch (the offsets B5 saw); B4 -> B6 == B5.
    mlen4, moff4 = (t.reshape(MATCH_BLOCKS, BLOCK) for t in md.find_matches_dyn(
        mplanes.view(-1, nrows, 128), noff, offs, nrows=nrows, max_match=1024))
    err, got = compare_parse_walk(md, mlen4, moff4, mlens, 1024, "bench B4 planes")
    b5 = walk_kernel()
    for k, g, w in zip("PMOo", got, b5):
        check_equal(f"B4 -> B6 vs B5 {k}", g, w)
    log(f"parse_walk == plain version (P/M/O/overflow): bench, {MATCH_BLOCKS} x {BLOCK} B, "
        f"seg 1024, wcap 8, on match_dyn's planes; B4 -> B6 == B5 records; sequences "
        f"{int((got[0] >= 0).sum())}")
    for seg in (256, 512):
        e, got = compare_parse_walk(md, *walk_hand_batch(seg), seg, f"hand-set seg {seg}")
        err = max(err, e)
        log(f"parse_walk == plain version: hand-set batch, 8 x {seg * 128} B, seg {seg} "
            f"(moff 0 inside runs, lengths below L), overflowing blocks {int(got[3].sum())}")
    for seg in (128, 1024, 2048, 42):
        for wcap in (0, 1, 8):
            wm, wo, wl = (torch.from_numpy(a).cuda() for a in md.walk_edge_batch(seg))
            got = md.parse_walk_dyn(wm, wo, wl, seg=seg, min_match=6, wcap=wcap)
            torch.cuda.synchronize()
            want = md.parse_walk_reference(wm, wo, wl, seg=seg, min_match=6, wcap=wcap)
            err = max(err, max(check_equal(f"parse_walk edge seg {seg} wcap {wcap} {k}", g, w)
                               for k, g, w in zip("PMOo", got, want)))
    log("parse_walk == plain version (P/M/O/overflow): walk_edge_batch at seg 128, 1024, "
        "2048 and 42 (4-byte loads), wcap 0, 1 and 8")
    kernels["parse_walk"] = {"max_abs_err": err}

    wire = dp.plan_blocks([corpus[i * BLOCK:(i + 1) * BLOCK] for i in range(MATCH_BLOCKS)],
                          BLOCK, PLANNED_MAX_PASSES)
    pfit, ppasses, pcomp_rows, pstored = (wire[k] for k in ("fit", "passes", "comp_rows",
                                                            "stored"))
    pdatas = [corpus[i * BLOCK:(i + 1) * BLOCK] for i in pfit]
    pcomp, pused, pse, psh = (torch.from_numpy(wire[k]).cuda()
                              for k in ("comp", "p_used", "se", "shift"))
    pkw = dict(passes=ppasses, comp_rows=pcomp_rows, out_rows=nrows)
    got = dp.decode_blocks_planned(pcomp, pused, pse, psh, **pkw)
    torch.cuda.synchronize()
    err = check_equal("decode_planned bench", got,
                      dp.decode_planned_reference(pcomp, pused, pse, psh, **pkw))
    log(f"decode_planned == plain version, byte for byte: bench, {len(pfit)} of "
        f"{MATCH_BLOCKS} x {BLOCK} B planned within {PLANNED_MAX_PASSES} passes, comp_rows "
        f"{pcomp_rows}, passes {ppasses} (mean {float(pused.float().mean()):.1f})")
    rplans = [torch.from_numpy(a).cuda() for a in dp.random_plans(14, 16, 6, 1024, 1024)]
    order = torch.argsort(rplans[1], descending=True)
    for what, plans in {"": rplans,
                        ", sorted by descending p_used": [t[order] for t in rplans]}.items():
        got = dp.decode_blocks_planned(*plans, passes=6, comp_rows=1024, out_rows=1024)
        torch.cuda.synchronize()
        err = max(err, check_equal(f"decode_planned random plans{what}", got,
                                   dp.decode_planned_reference(*plans, passes=6, comp_rows=1024,
                                                               out_rows=1024)))
        log(f"decode_planned == plain version, byte for byte: 16 random malformed plans{what}, "
            f"6 passes, comp_rows 1024, p_used {plans[1].tolist()}")
    for reads in ([False] * 8, [True] + [False] * 7, [False, True, False, False, True, True]):
        plans = [torch.from_numpy(a).cuda() for a in dp.class_plans(15, 12, reads, 512, 1024)]
        kw = dict(passes=len(reads), comp_rows=512, out_rows=1024)
        got = dp.decode_blocks_planned(*plans, **kw)
        torch.cuda.synchronize()
        err = max(err, check_equal("decode_planned class plans", got,
                                   dp.decode_planned_reference(*plans, **kw)))
        log("decode_planned == plain version, byte for byte: 12 plans whose passes read the "
            f"out plane: {''.join('P' if x else 'c' for x in reads)} (P: reads out rows, c: "
            "comp rows only), comp_rows 512")
    kernels["decode_planned"] = {"max_abs_err": err}

    # The device matchers and B7 at 256 KiB to 1 MiB.
    mlplanes = large_planes(corpus, LARGE_BLOCK, MATCH_LARGE_BLOCKS)   # the 1 MiB paths' B3 shape
    mllens = torch.full((MATCH_LARGE_BLOCKS,), LARGE_BLOCK, dtype=torch.int32, device="cuda")
    errs = {"match": large_match_checks(mt, corpus, mlplanes)}
    errs["emit"], large_lay, large_ow = large_emit_checks(em, dc, mt, mlplanes, mllens)
    errs["match_walk"], errs["match_dyn"], errs["parse_walk"] = large_dyn_checks(md)
    errs["decode_planned"], large_planned = large_planned_checks(dp, corpus, text)
    for name, e in errs.items():
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], e)

    # -- phase 4: the main paths, launch counts reset just before each -------
    log(f"phase 4 starts at {time.perf_counter() - t_start:.1f} s")
    counts = {}
    df.launches = 0
    host_path(btt, btt.Codec.LZ4, corpus)
    host_path(btt, btt.Codec.SNAPPY, corpus)
    counts["host path"] = {"decode_flat": df.launches}

    df.launches, md.walk_launches, md.dyn_launches, em.launches = 0, 0, 0, 0
    device_path(btt, corpus)
    counts["device path"] = {"decode_flat": df.launches, "match_walk": md.walk_launches,
                             "emit": em.launches}
    if md.dyn_launches:
        raise AssertionError("the device path (seg 1024) launched match_dyn")

    md.walk_launches, md.dyn_launches, em.launches = 0, 0, 0
    out, sizes = dc.compress_blocks_device(dplanes, mlens[:DYN_BLOCKS], seg=256)
    torch.cuda.synchronize()
    rows = bench.check_offload_rows(btt.Codec.LZ4, out, sizes, dplanes, mlens[:DYN_BLOCKS],
                                    "compress_blocks_device(seg=256)")
    counts["compress_blocks_device seg 256"] = {"match_dyn": md.dyn_launches,
                                                "emit": em.launches}
    log(f"main path compress_blocks_device(seg=256): {DYN_BLOCKS} x {BLOCK} B, width "
        f"{out.shape[1]}, {rows} compressed rows decode bit-exact on the host")

    df.launches, dt.launches = 0, 0
    tables_path(btt, corpus, card)
    counts["tables path"] = {"decode_tables": dt.launches}
    if df.launches:
        raise AssertionError("the tables path launched decode_flat")

    df.launches, dt.launches = 0, 0
    block_picks_path(btt, corpus, card)
    counts["block picks path"] = {"decode_tables": dt.launches}
    if df.launches:
        raise AssertionError("the block picks path launched decode_flat")

    df.launches = 0
    zstd_path(btt, corpus, card)
    counts["zstd path"] = {"decode_flat": df.launches}

    for codec in (btt.Codec.LZ4, btt.Codec.SNAPPY):
        df.launches, mt.launches = 0, 0
        matcher_path(btt, corpus, card, codec, compress_matcher="tpu")
        counts[f"tpu matcher {codec.value} path"] = {"match": mt.launches,
                                                     "decode_flat": df.launches}
    df.launches, mt.launches = 0, 0
    matcher_path(btt, corpus, card, btt.Codec.LZ4, compress_matcher="tpu-sort")
    counts["tpu-sort matcher path"] = {"decode_flat": df.launches}
    if mt.launches:
        raise AssertionError("the tpu-sort path launched the match kernel")

    df.launches, mt.launches, em.launches, md.walk_launches = 0, 0, 0, 0
    matcher_path(btt, corpus, card, btt.Codec.LZ4, compress_matcher="device",
                 match_offsets=mt.DEFAULT_OFFSETS)
    counts["device match_offsets path"] = {"match": mt.launches, "emit": em.launches,
                                           "decode_flat": df.launches}
    if md.walk_launches:
        raise AssertionError("the match_offsets path launched match_walk")

    df.launches = 0
    batched_path(btt, corpus, df)
    counts["batched decode"] = {"decode_flat": df.launches}

    df.launches = 0
    streams_path(btt, corpus)
    counts["streams path"] = {"decode_flat": df.launches}

    multi_burst_paths(btt, df, dt, corpus, card, counts)

    # The paths of blocks up to 1 MiB: each decode launch must take the
    # tall (cluster) route.
    tall = {}
    for what, run, kernel in (
            ("1 MiB host path", lambda: host_path(btt, btt.Codec.LZ4, corpus, LARGE_BLOCK), df),
            ("CLI skewed suite, 1 MiB", lambda: cli_skewed(card), df),
            ("1 MiB tables path", lambda: large_tables_path(btt, text, card), dt)):
        df.launches = df.cluster_launches = dt.launches = dt.cluster_launches = 0
        run()
        name = "decode_flat" if kernel is df else "decode_tables"
        counts[what] = {name: kernel.launches}
        tall[what] = kernel.cluster_launches
        if kernel.cluster_launches != kernel.launches or (df.launches if kernel is dt
                                                          else dt.launches):
            raise AssertionError(f"{what}: {kernel.cluster_launches} of {kernel.launches} {name} "
                                 f"launches on the cluster route; other kernel launched")
    df.launches = 0
    cli_sync(corpus[:CLI_SYNC_BYTES], card)
    counts["CLI sync suite, 128 KiB"] = {"decode_flat": df.launches}

    md.dyn_launches, md.parse_walk_launches = 0, 0
    mlen4, moff4 = (t.reshape(MATCH_BLOCKS, BLOCK) for t in md.find_matches_dyn(
        mplanes.view(-1, nrows, 128), noff, offs, nrows=nrows, max_match=1024))
    got = md.parse_walk_dyn(mlen4, moff4, mlens, seg=1024, min_match=6, wcap=8)
    torch.cuda.synchronize()
    counts["find_matches_dyn -> parse_walk_dyn"] = {"match_dyn": md.dyn_launches,
                                                    "parse_walk": md.parse_walk_launches}
    if not all(torch.equal(g, w) for g, w in zip(got, b5)):
        raise AssertionError("find_matches_dyn -> parse_walk_dyn != find_matches_parse_dyn")
    log(f"main path find_matches_dyn -> parse_walk_dyn: {MATCH_BLOCKS} x {BLOCK} B, "
        "records equal find_matches_parse_dyn's")

    dp.launches = 0
    got = dp.decode_blocks_planned(pcomp, pused, pse, psh, **pkw)
    host = got.reshape(len(pfit), -1).cpu().numpy()
    counts["decode_blocks_planned"] = {"decode_planned": dp.launches}
    if any(host[j].tobytes() != d for j, d in enumerate(pdatas)):
        raise AssertionError("decode_blocks_planned: blocks differ from their raw bytes")
    log(f"main path decode_blocks_planned: {len(pfit)} x {BLOCK} B bit-exact")

    # The device matchers at 1 MiB (128 MiB of the bench corpus), and B7's
    # tall route through its own entry point.
    large_paths = []
    for name, codec, kw, expect in (
            ("tpu matcher lz4, 1 MiB", btt.Codec.LZ4, dict(compress_matcher="tpu"),
             ("match", "decode_flat")),
            ("tpu matcher snappy, 1 MiB", btt.Codec.SNAPPY, dict(compress_matcher="tpu"),
             ("match", "decode_flat")),
            ("tpu-sort matcher lz4, 1 MiB", btt.Codec.LZ4, dict(compress_matcher="tpu-sort"),
             ("decode_flat",)),
            ("device match_offsets lz4, 1 MiB, min_match 64", btt.Codec.LZ4,
             dict(compress_matcher="device", match_offsets=mt.DEFAULT_OFFSETS, min_match=64),
             ("match", "emit", "decode_flat"))):
        md.walk_launches = 0
        large_matcher_path(btt, corpus, card, codec, counts,
                           {"match": mt, "emit": em, "decode_flat": df}, name, **kw)
        extra = [k for k, v in counts[name].items() if v and k not in expect]
        if extra or md.walk_launches:
            raise AssertionError(f"{name} launched {extra or 'match_walk'}")
        counts[name] = {k: counts[name][k] for k in expect}
        large_paths.append(name)
    wire, pdatas_l, pargs_l, pkw_l = large_planned
    dp.launches = dp.gmem_launches = 0
    got = dp.decode_blocks_planned(*pargs_l, **pkw_l)
    host = got.reshape(len(wire["fit"]), -1).cpu().numpy()
    counts["decode_blocks_planned, 1 MiB"] = {"decode_planned": dp.launches}
    if dp.gmem_launches != 1 or any(host[j].tobytes() != pdatas_l[i]
                                    for j, i in enumerate(wire["fit"])):
        raise AssertionError("decode_blocks_planned 1 MiB: not the tall route, or "
                             "blocks differ from their raw bytes")
    log(f"main path decode_blocks_planned: {len(wire['fit'])} x 1 MiB bit-exact "
        "(tall route)")
    large_launches = {k: sum(counts[p].get(k, 0) for p in large_paths) for k in ("match", "emit")}
    large_launches["decode_planned"] = dp.gmem_launches

    nccl_world_of_one(df, dt, card, counts)
    gloo_ranks_on_one_card(card, counts)

    for path, c in counts.items():
        log(f"launches on the {path}: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    for name in kernels:
        total = sum(c.get(name, 0) for c in counts.values())
        if total <= 0:
            raise AssertionError(f"the main paths launched no {name} kernel")
        kernels[name]["launches"] = total
    for path, c in counts.items():
        for name, v in c.items():
            if v <= 0:
                raise AssertionError(f"the {path} launched no {name} kernel")

    # -- phase 5: times ----------------------------------------------------
    log(f"phase 5 starts at {time.perf_counter() - t_start:.1f} s")
    # B1 as the engine launches it on a resident unit: in place, through
    # the slot table over the arena; the plain version on the rows the table
    # selects, gathered outside its window.  The held time of the launch on
    # those gathered rows (as the shuffle's and prepare_batched_decode's)
    # beside it.
    rows, table, pt, comp_rows, comp_len, _ = batches["bench"]
    nblk = table.numel()
    gathered = rows.index_select(0, table)
    res, ms = turns(timing, lambda: df.decode_blocks_flat(rows, pt, comp_rows=comp_rows,
                                                          out_rows=nrows, src_rows=table),
                    lambda: df.decode_flat_reference(gathered, pt, comp_rows, nrows))
    report(f"decode_flat bench {nblk} x 128 KiB, in place", card, res, ms, nblk * BLOCK)
    kernels["decode_flat"].update(ms=res["kernel"], plain_ms=res["plain"], held_ms=wrapper_times(
        timing, f"decode_flat bench {nblk} x 128 KiB, in place", card, "decode_flat",
        lambda: df.decode_blocks_flat(rows, pt, comp_rows=comp_rows, out_rows=nrows,
                                      src_rows=table),
        df.prepare_flat_launch(rows, pt, comp_rows=comp_rows, out_rows=nrows,
                               src_rows=table).run))
    kernels["decode_flat"]["gathered_held_ms"] = wrapper_times(
        timing, f"decode_flat bench {nblk} x 128 KiB, gathered rows", card, "decode_flat",
        lambda: df.decode_blocks_flat(gathered, pt, comp_rows=comp_rows, out_rows=nrows),
        lambda rec=df.prepare_flat_launch(gathered, pt, comp_rows=comp_rows, out_rows=nrows):
            rec.run(gathered))
    del gathered
    kernels["decode_flat"]["bound"] = decode_bound(pt, comp_len)
    trows, ttable, tpt, tcomp, tlen, _ = batches["text"]
    tgathered = trows.index_select(0, ttable)
    res, ms = turns(timing, lambda: df.decode_blocks_flat(trows, tpt, comp_rows=tcomp,
                                                          out_rows=nrows, src_rows=ttable),
                    lambda: df.decode_flat_reference(tgathered, tpt, tcomp, nrows))
    report(f"decode_flat text {ttable.numel()} x 128 KiB, in place", card, res, ms,
           ttable.numel() * BLOCK)
    del tgathered
    log(f"decode_flat text {ttable.numel()} x 128 KiB: bound {decode_bound(tpt, tlen)}")
    for name, (crows, ctable, cpt, ccomp, clen) in class_batches.items():
        turns_ms = [timing.device_time_ms(lambda: df.decode_blocks_flat(
            crows, cpt, comp_rows=ccomp, out_rows=nrows, src_rows=ctable), TIMED_REPS[1])
            for _ in range(2)]
        log(f"decode_flat {name} {ctable.numel()} x 128 KiB [{card}] kernel: "
            f"{sum(turns_ms) / 2:.4f} ms/launch (turns {', '.join(f'{x:.4f}' for x in turns_ms)}); "
            f"stored bytes a block {clen.mean():.1f} (at most {clen.max()}); "
            f"bound {decode_bound(cpt, clen)}")

    # The tall routes: B1 on the bench batch at 1 MiB (no out pass: the
    # slice kernel only), the text batch at 1 MiB and 256 KiB (out passes:
    # the cluster kernel), and one burst of the CLI's skewed suite; B2 on
    # the 1 MiB bench tables and the 256 KiB bench tables.
    def timed_route(label, kernel, alone, plain, stem, raw_bytes, bound, shape,
                    plain_reps=TIMED_REPS[0]):
        res, ms = turns(timing, kernel, plain, plain_reps)
        report(label, card, res, ms, raw_bytes)
        k_ms = wrapper_times(timing, label, card, stem, kernel, alone)
        log(f"{label}: bound {bound}")
        return {"shape": shape, "ms": res["kernel"], "plain_ms": res["plain"], "held_ms": k_ms,
                "bound_ms": bound[0], "bound_by": bound[1]}

    flat_shapes = {f"{name} {t.numel()} x {block >> 10} KiB": (rows, t, pt, cr, clen, block)
                   for (name, block), (rows, t, pt, cr, clen) in large_batches.items()
                   if (name, block) != ("bench", MID_BLOCK)}
    flat_shapes[f"skewed burst {SKEWED_BURST} x 4 KiB-1 MiB"] = (*skewed[:5], LARGE_BLOCK)
    timed = []
    for shape, (rows, t, pt, cr, clen, block) in flat_shapes.items():
        nr = block // 128
        g = rows.index_select(0, t)              # the plain version's input
        timed.append(timed_route(
            f"decode_flat tall route {shape}, in place",
            lambda rows=rows, t=t, pt=pt, cr=cr, nr=nr: df.decode_blocks_flat(
                rows, pt, comp_rows=cr, out_rows=nr, src_rows=t),
            df.prepare_flat_launch(rows, pt, comp_rows=cr, out_rows=nr, src_rows=t).run,
            lambda g=g, pt=pt, cr=cr, nr=nr: df.decode_flat_reference(g, pt, cr, nr),
            "decode_flat", t.numel() * block, decode_bound(pt, clen, block), shape))
        del g
    kernels["decode_flat"]["cluster_route"] = {
        "launches": sum(v for k, v in tall.items() if counts[k].get("decode_flat")),
        "resident_clusters": {str(r): df.resident_clusters(r) for r in TALL_ROWS},
        "timed": timed}
    timed = []
    for name in ("bench 1 MiB, 4-pass plan budget", "bench 256 KiB", "text 1 MiB"):
        lrows, lnseq, ltables, lblock, lcomp, _ = large_tables[name]
        shape = f"{name.split()[0]} {lrows.shape[0]} x {lblock >> 10} KiB tables"
        timed.append(timed_route(
            f"decode_tables cluster route {shape}",
            lambda r=lrows, n=lnseq, t=ltables, b=lblock: dt.decode_blocks(r, n, t,
                                                                          out_rows=b // 128),
            lambda r=lrows, n=lnseq, t=ltables, b=lblock: dt._launch_kernel(r, n, t, b // 128,
                                                                           None),
            lambda r=lrows, n=lnseq, t=ltables, b=lblock: dt.decode_tables_reference(
                r, n, t, b // 128),
            "decode_tables", lrows.shape[0] * lblock, tables_bound(lrows, lnseq, lcomp, lblock),
            shape, 1 if name == "text 1 MiB" else TIMED_REPS[0]))   # its plain call takes ~15 s
    kernels["decode_tables"]["cluster_route"] = {"launches": tall["1 MiB tables path"],
                                                 "timed": timed}

    # B5 and B4 on the bench batches (the kernels line) and on the text
    # batch with detect_fft's offsets.  A block with noff = 0 needs no plane
    # byte: its output is all empty.
    for what, (pl, nf, of, ln) in {"bench": (mplanes, noff, offs, mlens),
                                   "text detect_fft": (tplanes, tnoff, toffs, tlens)}.items():
        def kernel(pl=pl, nf=nf, of=of, ln=ln):
            return md.find_matches_parse_dyn(pl.view(-1, nrows, 128), nf, of, ln, nrows=nrows,
                                             seg=1024, min_match=6, max_match=1024)

        def plain(pl=pl, nf=nf, of=of, ln=ln):
            return md.match_walk_reference(pl, nf, of, ln, seg=1024, min_match=6, wcap=8,
                                           max_match=1024)

        label = f"match_walk {what} {pl.shape[0]} x 128 KiB seg 1024"
        res, ms = turns(timing, kernel, plain)
        report(label, card, res, ms, pl.shape[0] * BLOCK)
        k_ms = wrapper_times(timing, label, card, "match_walk", kernel)
        bound = score_bound(pl, nf, pl.shape[0] * (BLOCK // 1024) * 25 * 4)
        log(f"{label}: bound {bound}")
        if what == "bench":
            kernels["match_walk"].update(ms=res["kernel"], plain_ms=res["plain"],
                                         held_ms=k_ms, bound=bound)

    for what, (pl, nf, of) in {"bench": (dplanes, dnoff, doffs),
                               "text detect_fft": (tplanes, tnoff, toffs)}.items():
        def kernel(pl=pl, nf=nf, of=of):
            return md.find_matches_dyn(pl.view(-1, nrows, 128), nf, of, nrows=nrows,
                                       max_match=256)

        def plain(pl=pl, nf=nf, of=of):
            return md.match_dyn_reference(pl, nf, of, max_match=256)

        label = f"match_dyn {what} {pl.shape[0]} x 128 KiB max_match 256"
        res, ms = turns(timing, kernel, plain)
        report(label, card, res, ms, pl.shape[0] * BLOCK)
        k_ms = wrapper_times(timing, label, card, "match_dyn", kernel)
        bound = score_bound(pl, nf, pl.shape[0] * BLOCK * 8)
        log(f"{label}: bound {bound}")
        if what == "bench":
            kernels["match_dyn"].update(ms=res["kernel"], plain_ms=res["plain"], held_ms=k_ms,
                                        bound=bound)

    # The emitter at every shape a main path launches it; the kernels line
    # takes the main-path shape with the most held time over its bound.
    worst = None
    for name, (pl, lay, ow, ln) in emit_at.items():
        def kernel(pl=pl, lay=lay, ow=ow, ln=ln):
            return em.emit_blocks(pl, lay, out_width=ow, lengths=ln)

        def plain(pl=pl, lay=lay, ow=ow, ln=ln):
            return em.emit_reference(pl, lay, out_width=ow, lengths=ln)

        label = f"emit {name}"
        res, ms = turns(timing, kernel, plain)
        report(label, card, res, ms, pl.shape[0] * BLOCK)
        k_ms = wrapper_times(timing, label, card, "emit", kernel)
        bound = emit_bound(em, lay, ow)
        floor = em.floor_kernel_ms(pl.shape[0], lay["starts"].shape[1], ow, timing, TIMED_REPS[1])
        log(f"{label}: bound {bound}; empty kernel on the same grid {floor:.4f} ms held "
            f"[{card}]")
        if not name.startswith("bench") and (worst is None or k_ms - bound[0] > worst[0]):
            worst = (k_ms - bound[0], name, dict(ms=res["kernel"], plain_ms=res["plain"],
                                                 held_ms=k_ms, bound=bound))
    kernels["emit"].update(worst[2], shape=worst[1])

    # B2 as the engine launches it on a MultiGet's picks (the kernels
    # line's row): in place, through the picks' slots over the arena and
    # the table store; the plain version on the rows and tables they
    # select, gathered outside its window.  The held time of the launch on
    # those gathered rows (as the tables path's) beside it.
    prow, pns, ptab, psrc = (picks[k] for k in ("buf", "nseq", "tables", "src"))
    grow, gns = prow.index_select(0, psrc), pns.index_select(0, psrc)
    gtab = {k: v.index_select(0, psrc) for k, v in ptab.items()}
    pout = TABLE_BLOCK // 128
    res, ms = turns(timing, lambda: dt.decode_blocks(prow, pns, ptab, out_rows=pout,
                                                     src_rows=psrc),
                    lambda: dt.decode_tables_reference(grow, gns, gtab, pout))
    report(f"decode_tables {picks['shape']}, in place", card, res, ms, psrc.numel() * TABLE_BLOCK)
    kernels["decode_tables"].update(shape=f"{picks['shape']}, in place", ms=res["kernel"],
                                    plain_ms=res["plain"], held_ms=wrapper_times(
        timing, f"decode_tables {psrc.numel()} YCSB picks, in place", card, "decode_tables",
        lambda: dt.decode_blocks(prow, pns, ptab, out_rows=pout, src_rows=psrc),
        lambda: dt._launch_kernel(prow, pns, ptab, pout, None, psrc)))
    kernels["decode_tables"]["gathered_held_ms"] = wrapper_times(
        timing, f"decode_tables {psrc.numel()} YCSB picks, gathered rows", card, "decode_tables",
        lambda: dt.decode_blocks(grow, gns, gtab, out_rows=pout),
        lambda: dt._launch_kernel(grow, gns, gtab, pout, None))
    kernels["decode_tables"]["bound"] = tables_bound(grow, gns, picks["comp_len"], TABLE_BLOCK)
    del picks, prow, pns, ptab, grow, gns, gtab
    brows, bnseq, btables, bblock, bcomp, _ = tbatches["bench 4 KiB"]
    res, ms = turns(timing, lambda: dt.decode_blocks(brows, bnseq, btables, out_rows=bblock // 128),
                    lambda: dt.decode_tables_reference(brows, bnseq, btables, bblock // 128))
    report(f"decode_tables bench {brows.shape[0]} x 4 KiB", card, res, ms,
           brows.shape[0] * bblock)
    kernels["decode_tables"]["bench_4k"] = dict(
        ms=res["kernel"], plain_ms=res["plain"], held_ms=wrapper_times(
            timing, f"decode_tables bench {brows.shape[0]} x 4 KiB", card, "decode_tables",
            lambda: dt.decode_blocks(brows, bnseq, btables, out_rows=bblock // 128),
            lambda: dt._launch_kernel(brows, bnseq, btables, bblock // 128, None)),
        bound=tables_bound(brows, bnseq, bcomp, bblock))
    # One burst of the tables path as the engine launches it (1024 x 4 KiB),
    # and 256 x 128 KiB of the bench corpus, the parallel tables step's shape.
    for what, (trows, tnseq, ttables, tblock, tcomp) in {
            "bench burst 1024 x 4 KiB": (brows[:1024], bnseq[:1024],
                                         {k: v[:1024] for k, v in btables.items()}, bblock,
                                         bcomp[:1024]),
            f"bench {TABLE_STEP_BLOCKS} x 128 KiB": tbatches[
                "bench 128 KiB, the parallel tables step's shape"][:5]}.items():
        def call(r=trows, n=tnseq, t=ttables, b=tblock):
            return dt.decode_blocks(r, n, t, out_rows=b // 128)

        turns_ms = [timing.device_time_ms(call, TIMED_REPS[1]) for _ in range(2)]
        log(f"decode_tables {what} [{card}] kernel: {sum(turns_ms) / 2:.4f} ms/launch (turns "
            f"{', '.join(f'{x:.4f}' for x in turns_ms)}); bound "
            f"{tables_bound(trows, tnseq, tcomp, tblock)}")
        wrapper_times(timing, f"decode_tables {what}", card, "decode_tables", call,
                      lambda r=trows, n=tnseq, t=ttables, b=tblock: dt._launch_kernel(
                          r, n, t, b // 128, None))
    drows, dnseq, dtables, dblock, dcomp, _ = tbatches["text 128 KiB, 8-pass plan budget"]
    res, ms = turns(timing, lambda: dt.decode_blocks(drows, dnseq, dtables, out_rows=dblock // 128),
                    lambda: dt.decode_tables_reference(drows, dnseq, dtables, dblock // 128))
    report(f"decode_tables text {drows.shape[0]} x 128 KiB (deep tables)", card, res, ms,
           drows.shape[0] * dblock)
    log(f"decode_tables text bound [{card}]: {tables_bound(drows, dnseq, dcomp, dblock)}")
    wrapper_times(timing, f"decode_tables text {drows.shape[0]} x 128 KiB (deep tables)", card,
                  "decode_tables",
                  lambda: dt.decode_blocks(drows, dnseq, dtables, out_rows=dblock // 128),
                  lambda: dt._launch_kernel(drows, dnseq, dtables, dblock // 128, None))

    # B3 at the phase-3 batch and at the shape the main paths launch: one
    # whole unit, indices at max_match 64 (the tpu matcher; the kernels
    # line's row) and values at max_match 1024 (match_offsets).
    for pl, mm, values in ((dplanes, 64, False), (lplanes, 1024, True), (lplanes, 64, False)):
        res, ms = turns(
            timing, lambda pl=pl, mm=mm, v=values: mt.find_matches(
                pl.view(-1, nrows, 128), nrows=nrows, max_match=mm, emit_values=v),
            lambda pl=pl, mm=mm, v=values: mt.match_reference(
                pl, mt.DEFAULT_OFFSETS, max_match=mm, emit_values=v))
        what = (f"match bench {pl.shape[0]} x 128 KiB, 26 offsets, max_match {mm}, "
                f"{'values' if values else 'indices'}")
        report(what, card, res, ms, pl.shape[0] * BLOCK)
        log(f"match bound [{card}]: {match_bound(pl.shape[0], len(mt.DEFAULT_OFFSETS))}")
        held_ms = wrapper_times(timing, what, card, "match", lambda pl=pl, mm=mm, v=values: (
            mt.find_matches(pl.view(-1, nrows, 128), nrows=nrows, max_match=mm, emit_values=v)))
    kernels["match"].update(ms=res["kernel"], plain_ms=res["plain"], held_ms=held_ms)
    kernels["match"]["bound"] = match_bound(NBLOCKS, len(mt.DEFAULT_OFFSETS))

    res, ms = turns(timing, lambda: md.parse_walk_dyn(mlen4, moff4, mlens, seg=1024,
                                                      min_match=6, wcap=8),
                    lambda: md.parse_walk_reference(mlen4, moff4, mlens, seg=1024,
                                                    min_match=6, wcap=8))
    report(f"parse_walk bench {MATCH_BLOCKS} x 128 KiB seg 1024 wcap 8", card, res, ms,
           MATCH_BLOCKS * BLOCK)
    kernels["parse_walk"].update(ms=res["kernel"], plain_ms=res["plain"], held_ms=wrapper_times(
        timing, f"parse_walk bench {MATCH_BLOCKS} x 128 KiB seg 1024 wcap 8", card, "parse_walk",
        lambda: md.parse_walk_dyn(mlen4, moff4, mlens, seg=1024, min_match=6, wcap=8)))
    pw = md.parse_walk_dyn(mlen4, moff4, mlens, seg=1024, min_match=6, wcap=8)
    kernels["parse_walk"]["bound"] = walk_bound(md, mlen4, moff4, mlens, pw[0], pw[1], 1024, 8)
    log(f"parse_walk bound [{card}]: {kernels['parse_walk']['bound']} (positions the walk "
        f"examines; both planes whole would be {bound_ms(2 * mlen4.numel() * 4)[0]:.4f} ms)")
    # B6 on the text batch's B4 planes (detect_fft's offsets), the kernel alone.
    tm4, to4 = (t.reshape(FFT_TEXT_BLOCKS, BLOCK) for t in md.find_matches_dyn(
        tplanes.view(-1, nrows, 128), tnoff, toffs, nrows=nrows, max_match=1024))
    label = f"parse_walk text detect_fft {FFT_TEXT_BLOCKS} x 128 KiB seg 1024 wcap 8"
    wrapper_times(timing, label, card, "parse_walk", lambda: md.parse_walk_dyn(
        tm4, to4, tlens, seg=1024, min_match=6, wcap=8))
    pw = md.parse_walk_dyn(tm4, to4, tlens, seg=1024, min_match=6, wcap=8)
    log(f"{label}: bound {walk_bound(md, tm4, to4, tlens, pw[0], pw[1], 1024, 8)}")

    res, ms = turns(timing, lambda: dp.decode_blocks_planned(pcomp, pused, pse, psh, **pkw),
                    lambda: dp.decode_planned_reference(pcomp, pused, pse, psh, **pkw))
    report(f"decode_planned bench {len(pfit)} x 128 KiB, {ppasses} passes", card, res, ms,
           len(pfit) * BLOCK)
    kernels["decode_planned"].update(
        ms=res["kernel"], plain_ms=res["plain"], held_ms=wrapper_times(
        timing, f"decode_planned bench {len(pfit)} x 128 KiB, {ppasses} passes", card,
        "decode_planned", lambda: dp.decode_blocks_planned(pcomp, pused, pse, psh, **pkw),
        lambda: dp._launch_kernel(pcomp, pused, pse, psh, pkw["passes"], pkw["comp_rows"],
                                  pkw["out_rows"], None)))
    kernels["decode_planned"]["bound"] = planned_bound(pused, pstored, ppasses)
    tpu_phases(btt, mt, native, corpus, card)

    # B3, the emitter and B7's tall route at the 1 MiB paths' shapes.
    def timed_large(name, label, kernel, plain, stem, bound, shape, nbytes, alone=None):
        res, ms = turns(timing, kernel, plain)
        report(label, card, res, ms, nbytes)
        k_ms = wrapper_times(timing, label, card, stem, kernel, alone)
        log(f"{label}: bound {bound}")
        return {"shape": shape, "launches": large_launches[name], "ms": res["kernel"],
                "plain_ms": res["plain"], "held_ms": k_ms, "bound_ms": bound[0],
                "bound_by": bound[1]}

    kernels["match"]["large_blocks"] = timed_large(
        "match", f"match bench {MATCH_LARGE_BLOCKS} x 1 MiB, 26 offsets, max_match 64, indices",
        lambda: mt.find_matches(mlplanes.view(MATCH_LARGE_BLOCKS, -1, 128),
                                nrows=LARGE_BLOCK // 128),
        lambda: mt.match_reference(mlplanes, mt.DEFAULT_OFFSETS, max_match=64), "match",
        match_bound(MATCH_LARGE_BLOCKS, len(mt.DEFAULT_OFFSETS), LARGE_BLOCK),
        f"bench {MATCH_LARGE_BLOCKS} x 1 MiB, indices, max_match 64 (the tpu matcher's)",
        MATCH_LARGE_BLOCKS * LARGE_BLOCK)
    label = (f"emit match_offsets {MATCH_LARGE_BLOCKS} x 1 MiB, min_match 64, width "
             f"{large_ow}, slots a row {large_lay['starts'].shape[1]}")
    kernels["emit"]["large_blocks"] = timed_large(
        "emit", label,
        lambda: em.emit_blocks(mlplanes, large_lay, out_width=large_ow, lengths=mllens),
        lambda: em.emit_reference(mlplanes, large_lay, out_width=large_ow, lengths=mllens),
        "emit", emit_bound(em, large_lay, large_ow),
        f"match_offsets {MATCH_LARGE_BLOCKS} x 1 MiB, width {large_ow} (the engine's)",
        MATCH_LARGE_BLOCKS * LARGE_BLOCK)
    floor = em.floor_kernel_ms(MATCH_LARGE_BLOCKS, large_lay["starts"].shape[1], large_ow,
                               timing, TIMED_REPS[1])
    log(f"{label}: empty kernel on the same grid {floor:.4f} ms held [{card}]")
    nfit = len(wire["fit"])
    kernels["decode_planned"]["tall_route"] = timed_large(
        "decode_planned", f"decode_planned tall route bench {nfit} x 1 MiB, "
        f"{pkw_l['passes']} passes",
        lambda: dp.decode_blocks_planned(*pargs_l, **pkw_l),
        lambda: dp.decode_planned_reference(*pargs_l, **pkw_l), "decode_planned",
        planned_bound(pargs_l[1], wire["stored"], pkw_l["passes"], LARGE_BLOCK),
        f"bench {nfit} x 1 MiB, {pkw_l['passes']} passes", nfit * LARGE_BLOCK,
        lambda: dp._launch_kernel(*pargs_l, pkw_l["passes"], pkw_l["comp_rows"],
                                  pkw_l["out_rows"], None))
    tpu_phases(btt, mt, native, corpus, card, LARGE_BLOCK)

    def pipeline():
        return dc.compress_blocks_device(mplanes, mlens, seg=1024, out_width=2048)

    def pipeline_plain():
        # The same stages with the plain versions of B5 and the emitter.
        pn, po, _ = detected(md, mplanes)
        rec = md.match_walk_reference(mplanes, pn, po, mlens, seg=1024, min_match=6,
                                      wcap=8, max_match=1024)
        lay = dc._layout_from_records(*split_rec(rec), mlens)
        return em.emit_reference(mplanes, lay, out_width=2048), lay["total"]

    if not all(torch.equal(a, b) for a, b in zip(pipeline(), pipeline_plain())):
        raise AssertionError("compress_blocks_device: kernels != plain versions")
    res, ms = turns(timing, pipeline, pipeline_plain)
    report(f"compress_blocks_device(seg=1024, out_width=2048) {MATCH_BLOCKS} x 128 KiB "
           f"(detector, B5, layout, emitter)", card, res, ms, MATCH_BLOCKS * BLOCK)

    # -- phase 6: the headline bench --------------------------------------
    log(f"phase 6 starts at {time.perf_counter() - t_start:.1f} s")
    run_bench(bench, df, md, em)

    if args.profile:
        profile_main_path(btt, corpus, card)
        profile_device_path(btt, corpus, card)

    sources = {
        "decode_flat": ("bitar_tpu_torch/csrc/decode_flat.cu",
                        "bitar_tpu/ops/pallas/lz4_decode_flat.py:101"),
        "match_walk": ("bitar_tpu_torch/csrc/match_walk.cu",
                       "bitar_tpu/ops/pallas/lz4_match_dyn.py:270"),
        "match_dyn": ("bitar_tpu_torch/csrc/match_dyn.cu",
                      "bitar_tpu/ops/pallas/lz4_match_dyn.py:199"),
        "emit": ("bitar_tpu_torch/csrc/emit.cu",
                 "bitar_tpu/ops/pallas/lz4_emit.py:338 (B8), lz4_emit.py:84 (B9), "
                 "lz4_emit.py:101 (B10), bitar_tpu/ops/device_compress.py:317 (XLA)"),
        "decode_tables": ("bitar_tpu_torch/csrc/decode_tables.cu",
                          "bitar_tpu/ops/pallas/lz4_decode.py:37"),
        "match": ("bitar_tpu_torch/csrc/match.cu", "bitar_tpu/ops/pallas/lz4_match.py:84"),
        "parse_walk": ("bitar_tpu_torch/csrc/parse_walk.cu",
                       "bitar_tpu/ops/pallas/lz4_match_dyn.py:424"),
        "decode_planned": ("bitar_tpu_torch/csrc/decode_planned.cu",
                           "bitar_tpu/ops/pallas/lz4_decode_planned.py:62"),
    }
    log(f"smoke wall clock {time.perf_counter() - t_start:.1f} s")
    line = []
    for name, k in kernels.items():
        b_ms, b_by = k["bound"]
        line.append({"name": name, "route": "cuda", "source": sources[name][0],
                     "replaces": sources[name][1], "launches": k["launches"],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"], "held_ms": k["held_ms"],
                     "held_of": "kernel" if name in HELD_ALONE else "call",
                     "plain_ms": k["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None} | ({"shape": k["shape"]} if "shape" in k else {})
                    | {key: k[key] for key in ("cluster_route", "tall_route", "gathered_held_ms",
                                              "bench_4k") if key in k}
                    | ({"large_blocks": k["large_blocks"]} if "large_blocks" in k else {}))
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_bench(bench, df, md, em) -> None:
    """Phase 6: ``cli.bench.main(["--device", "cuda"])`` at 1024 blocks in this
    process, B1's, B5's and the emitter's launch counts set to 0 just before
    and read just after; its line logged, its keys the reference's
    (``bench.KEYS``) and every number in it finite and above 0, but the plan
    join's, which may read 0.0 (``bench.MAY_READ_ZERO``)."""
    os.environ.update(BENCH_NBLOCKS=str(NBLOCKS), BENCH_REPS="8")
    out = io.StringIO()
    df.launches, md.walk_launches, em.launches = 0, 0, 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--device", "cuda"])
    secs = time.perf_counter() - t0
    launches = {"decode_flat": df.launches, "match_walk": md.walk_launches,
                "emit": em.launches}
    last = out.getvalue().strip().splitlines()[-1]
    log(f"bench line: {last}")
    log(f"phase 6: cli.bench at {NBLOCKS} x 128 KiB took {secs:.1f} s (host clock); "
        f"launches {launches}")
    line = json.loads(last)
    if rc != 0 or set(line) != set(bench.KEYS):
        raise AssertionError(f"cli.bench: rc {rc}, keys {sorted(line)}")
    bad = {k: v for k, v in line.items() if k not in ("metric", "unit")
           and not (isinstance(v, (int, float)) and math.isfinite(v)
                    and (v > 0 or (v == 0 and k in bench.MAY_READ_ZERO)))}
    if bad:
        raise AssertionError(f"cli.bench: values not finite and above 0: {bad}")
    for name, v in launches.items():
        if v <= 0:
            raise AssertionError(f"cli.bench launched no {name} kernel")


ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def device_us(e) -> float:
    t = getattr(e, "device_time_total", None)     # cuda_time_total before torch 2.4
    return float(t if t is not None else e.cuda_time_total)


def log_profile(prof, what: str, top: int) -> None:
    """The ``top`` rows of a ``torch.profiler`` run by device time."""
    events = sorted(prof.key_averages(), key=device_us, reverse=True)
    for e in events[:top]:
        log(f"profile {what}: {e.key} | calls {e.count} | device {device_us(e) / 1e3:.3f} ms "
            f"| host {e.cpu_time_total / 1e3:.3f} ms")


class PhaseClock:
    """Host-clock phases, each ended by a device sync."""

    def __init__(self, card: str, path: str):
        self.card, self.path = card, path
        self.marks = [("start", time.perf_counter())]

    def mark(self, phase: str) -> None:
        torch.cuda.synchronize()
        self.marks.append((phase, time.perf_counter()))

    def log(self) -> None:
        for (_, t0), (phase, t1) in zip(self.marks, self.marks[1:]):
            log(f"profile phase [{self.card}] {self.path}: {phase}: {1e3 * (t1 - t0):.3f} ms")


def warm_engine(btt, **kw):
    with torch.profiler.profile(activities=ACTIVITIES):
        torch.ones(1, device="cuda").add_(1)     # pays the tracer's start-up here
    return engine(btt, btt.Codec.LZ4, **kw)


def profile_main_path(btt, data: bytes, card: str, top: int = 12) -> None:
    """Phase breakdown of one warm LZ4 unit through the host-compress path."""
    eng = warm_engine(btt)
    warm = eng.compress(data)
    eng.decompress(warm)
    eng.recycle(warm)
    clock = PhaseClock(card, "host compress")
    unit = eng.compress(data)
    clock.mark("compress (host matcher; plan build queued)")
    eng._ensure_committed(unit)       # the upload ensure_plans would start
    clock.mark("commit upload (H2D + index_copy_)")
    eng.ensure_plans(unit)
    clock.mark("plan join")
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        eng.decompress(unit)
        torch.cuda.synchronize()
    clock.mark("first decompress, under torch.profiler (plan upload, readback)")
    eng.decompress(unit)
    clock.mark("second decompress (plan already on the card; readback)")
    eng.recycle(unit)
    eng.release()
    clock.log()
    log_profile(prof, "host compress, first decompress", top)


def profile_device_path(btt, data: bytes, card: str, top: int = 12) -> None:
    """Phase breakdown of one warm LZ4 unit through the device-compress path."""
    eng = warm_engine(btt, commit="eager", compress_matcher="device")
    warm = eng.compress(data)
    eng.decompress(warm)
    eng.recycle(warm)
    clock = PhaseClock(card, "device compress")
    with torch.profiler.profile(activities=ACTIVITIES) as prof_c:
        unit = eng.compress(data)
        torch.cuda.synchronize()
    clock.mark("compress, under torch.profiler (planes, upload, detect, B5, emit, arena)")
    eng.ensure_plans(unit)
    clock.mark("ensure_plans (arena gather to the host + planner)")
    with torch.profiler.profile(activities=ACTIVITIES) as prof_d:
        eng.decompress(unit)
        torch.cuda.synchronize()
    clock.mark("first decompress, under torch.profiler (plan upload, readback)")
    eng.decompress(unit)
    clock.mark("second decompress (plan already on the card; readback)")
    eng.recycle(unit)
    eng.release()
    clock.log()
    log_profile(prof_c, "device compress", top)
    log_profile(prof_d, "device compress, first decompress", top)


if __name__ == "__main__":
    sys.exit(main())
