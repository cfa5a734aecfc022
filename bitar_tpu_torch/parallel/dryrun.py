"""Multi-process dry run of the distributed steps, and the harness under it.

The port's analog of ``__graft_entry__.dryrun_multichip``:
:func:`dryrun_multichip` spawns ``n_devices`` ranks (one process per
device, ``torch.multiprocessing`` with the ``spawn`` start method, a
``file://`` rendezvous in a fresh temporary directory) and runs the fused
flat step and the ring step on 16 KiB blocks; every live row must be the
block's raw bytes, and the ring must equal the fused step.

* :func:`make_batch` builds a block batch from a seed (or from given data):
  compressed slot rows, flat plans and sequence tables; every rank builds
  the same batch, so nothing large crosses a process boundary;
* :func:`steps_program` runs the chosen steps on one rank's mesh, checks
  every live row against the raw bytes, and reports rows, checks, host-clock
  times and kernel launches;
* :func:`run_world` spawns a world, runs a program on every rank and
  returns each rank's result.  Every wait has a time limit; a rank that
  fails or hangs fails the world, and every child is killed on the way out.
"""

from __future__ import annotations

import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import ShardingConfig
from ..ops import decode_flat, decode_tables
from ..ops.cpu import native
from ..status import Status, StatusError
from ..utils.logging import get_logger
from . import multihost
from .pipeline import (
    WIRE_KEYS,
    distributed_step_flat,
    distributed_step_tables_fallback,
    local_wires,
    prepare_distributed_step_tables_fallback,
    prepare_flat_wires_for_recv,
    prepare_ring_flat_wires_for_recv,
)
from .ring import distributed_step_ring_flat, ring_timeline
from .sharding import (
    _TABLE_KEYS,
    make_mesh,
    mesh_device,
    mesh_group,
    mesh_rank,
    prepare_sharded_batch,
    shard_blocks,
    sharded_decode,
)
from .shuffle import all_to_all_rows, execute_shuffle, plan_shuffle, stage_rows

logger = get_logger("parallel.dryrun")

LANES = 128
RAW_CODEC = 3               # the host library's codec id of a stored block
ALL_STEPS = ("shuffle", "flat", "ring", "sharded", "tables")


def make_batch(nblocks: int, block: int, seed: int = 42, data: bytes | None = None) -> dict:
    """A block batch: ``data`` cut into blocks, or by default a mix of
    text, low-entropy, RLE and random blocks from ``seed``.  Each block is
    LZ4 (min_match 6) or, where that does not shrink it, stored RAW.

    Returns datas (raw bytes per block), comps, codec ids, slot ``rows``
    [nblocks, comp_rows * 128] uint8, ``comp_rows`` (a multiple of 128),
    the flat plans (``plan_batch_flat``'s se, sh, p_used, p0, dq, row_a,
    dense) and one sequence table per block (a RAW block is one literal
    run)."""
    if data is None:
        rng = np.random.default_rng(seed)
        datas = []
        for i in range(nblocks):
            k = i % 4
            if k == 0:
                datas.append(((b"dry run %d " % i) * (block // 10 + 1))[:block])
            elif k == 1:
                datas.append(rng.integers(0, 6, block, dtype=np.uint8).tobytes())
            elif k == 2:
                datas.append(bytes([i & 0xFF]) * block)
            else:
                datas.append(rng.integers(0, 256, block, dtype=np.uint8).tobytes())
    else:
        datas = [data[i * block:(i + 1) * block] for i in range(nblocks)]
    comps, cids, tables = [], [], []
    for x in datas:
        c = native.lz4_compress(x, min_match=6)
        if len(c) >= block:
            c = np.frombuffer(x, np.uint8)
            cids.append(RAW_CODEC)
            tables.append({"lit_ptr": np.zeros(1, np.int32), "lit_len": np.full(1, block, np.int32),
                           "off": np.zeros(1, np.int32), "mlen": np.zeros(1, np.int32),
                           "out_pos": np.zeros(1, np.int32)})
        else:
            cids.append(0)
            tables.append(native.parse_sequences(c, "lz4"))
        comps.append(c)
    lens = np.array([len(c) for c in comps], np.int32)
    off = np.zeros(nblocks, np.int64)
    off[1:] = np.cumsum(lens[:-1].astype(np.int64))
    nrows = block // LANES
    se, sh, pu, p0, st, _, dq, ra, dn = native.plan_batch_flat(
        np.concatenate(comps), off, lens, np.full(nblocks, block, np.int32),
        np.asarray(cids, np.int32), nrows, 160, cb=4)
    if (st != 0).any():
        raise StatusError(Status.Invalid(f"flat planning failed: {st[st != 0][:8]}"))
    comp_rows = -(-max(LANES, int(lens.max())) // LANES)
    comp_rows = -(-comp_rows // LANES) * LANES
    rows = np.zeros((nblocks, comp_rows * LANES), np.uint8)
    for i, c in enumerate(comps):
        rows[i, :len(c)] = c
    return {"datas": datas, "comps": comps, "cids": np.asarray(cids, np.int32), "rows": rows,
            "lens": lens, "comp_rows": comp_rows, "block": block,
            "plan": (se, sh, pu, p0, dq, ra, dn), "tables": tables}


def _timed(device: torch.device, group, fn, reps: int = 1):
    """(fn(), best host-clock seconds of ``reps`` runs) with the device
    synchronized on both ends of each run.  Each run starts after a barrier
    of ``group``, so that no rank's time holds a wait for a peer that
    arrived later (ranks drift apart between runs, as their hosts do)."""
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier(group=group)
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return out, best


def steps_program(mesh, spec: dict) -> dict:
    """Run ``spec["steps"]`` (of :data:`ALL_STEPS`) on this rank.

    ``spec``: ``nblocks``, ``block``, ``seed`` for :func:`make_batch` (or
    ``corpus``: "bench" for ``utils.corpus.make_corpus``, or a module-level
    function of ``nblocks`` that returns the bytes to cut), optional
    ``return_rows``, ``reps`` (runs of the flat and ring steps; their
    "seconds" is the best), ``skew_bucket_log`` (above 0, the shuffle plan's
    ``ShardingConfig.skew_bucket_log``), ``phases`` (the flat step's
    exchange alone and its decode alone, best of ``reps`` each, as
    "exchange_seconds" and "decode_seconds") and ``overlap`` (on NCCL, one
    more ring step with CUDA events: its "timeline", ``ring.ring_timeline``).
    Every live row is checked against its raw (or, for "shuffle", stored)
    bytes.  Returns {step: {"live", "exact", "seconds", "rows" (if asked)},
    "ring_equals_flat", "launches": {kernel: count}, "device_launches":
    {kernel: {card index: count}}, "backend", "device" (this rank's),
    "contexts" (``multihost.cuda_contexts()``)}."""
    d, me = mesh.size(), mesh_rank(mesh)
    device, group = mesh_device(mesh), mesh_group(mesh)
    data = None
    if spec.get("corpus") == "bench":
        from ..utils.corpus import make_corpus
        data = make_corpus(spec["nblocks"])
    elif callable(spec.get("corpus")):
        data = spec["corpus"](spec["nblocks"])
    batch = make_batch(spec["nblocks"], spec["block"], spec.get("seed", 42), data)
    block, comp_rows, rows = batch["block"], batch["comp_rows"], batch["rows"]
    nrows = block // LANES
    skew = spec.get("skew_bucket_log", 0)
    splan = plan_shuffle(len(batch["datas"]), d, sizes=batch["lens"].astype(np.int64),
                         config=ShardingConfig(skew_bucket_log=skew) if skew > 0 else None)
    per_src = rows.shape[0] // d
    send_idx, valid = (torch.from_numpy(a).to(device) for a in splan.staging(me, per_src))
    (local_rows,) = shard_blocks(mesh, rows, device=device)
    recv_ids = splan.recv_block[me].reshape(-1)
    kw = dict(mesh=mesh, rows_per_pair=splan.rows_per_pair, comp_rows=comp_rows,
              block_size=block)
    result: dict = {"launches": {}}
    kernels = {"decode_flat": decode_flat, "decode_tables": decode_tables}
    before = {k: (m.launches, m.device_launches.copy()) for k, m in kernels.items()}

    def record(step, out, seconds, ids, want):
        host = out.cpu().numpy()
        live = np.flatnonzero(ids >= 0)
        exact = all(host[j].tobytes() == want(int(ids[j])) for j in live)
        result[step] = {"live": int(live.size), "exact": bool(exact), "seconds": seconds}
        if spec.get("return_rows"):
            result[step]["rows"] = host
        return host

    raw = batch["datas"]
    steps = spec.get("steps", ALL_STEPS)
    if "shuffle" in steps:
        out, s = _timed(device, group, lambda: execute_shuffle(mesh, splan, local_rows))
        record("shuffle", out, s, recv_ids, lambda b: rows[b].tobytes())
    flat = ring = None
    if "flat" in steps:
        wires = local_wires(prepare_flat_wires_for_recv(splan, *batch["plan"], nrows), me,
                            device)
        out, s = _timed(device, group, lambda: distributed_step_flat(
            local_rows, send_idx, valid, *(wires[k] for k in WIRE_KEYS), **kw),
            spec.get("reps", 1))
        flat = record("flat", out, s, recv_ids, lambda b: raw[b])
        if spec.get("phases"):
            # The fused step's two phases alone: stage + all-to-all, then B1
            # on the rows received.
            recv, s = _timed(device, group, lambda: all_to_all_rows(
                stage_rows(local_rows, send_idx, valid), group), spec.get("reps", 1))
            plans = dict(zip(WIRE_KEYS, (wires[k] for k in WIRE_KEYS), strict=True))
            _, s_dec = _timed(device, group, lambda: decode_flat.decode_blocks_flat(
                recv, plans, comp_rows=comp_rows, out_rows=nrows), spec.get("reps", 1))
            result["flat"].update(exchange_seconds=s, decode_seconds=s_dec)
    if "ring" in steps:
        wires = local_wires(prepare_ring_flat_wires_for_recv(splan, *batch["plan"], nrows), me,
                            device)
        out, s = _timed(device, group, lambda: distributed_step_ring_flat(
            local_rows, send_idx, valid, *(wires[k] for k in WIRE_KEYS), **kw),
            spec.get("reps", 1))
        ring = record("ring", out, s, recv_ids, lambda b: raw[b])
        if spec.get("overlap") and device.type == "cuda":
            events: dict = {}
            dist.barrier(group=group)
            distributed_step_ring_flat(local_rows, send_idx, valid,
                                       *(wires[k] for k in WIRE_KEYS), **kw, events=events)
            torch.cuda.synchronize(device)
            if events:                               # NCCL only
                result["ring"]["timeline"] = ring_timeline(events)
    if flat is not None and ring is not None:
        live = recv_ids >= 0
        result["ring_equals_flat"] = bool((flat[live] == ring[live]).all())

    nt = len(raw)
    if "sharded" in steps:
        full, real_n, meta = prepare_sharded_batch(batch["comps"], batch["tables"], block,
                                                   rows.shape[1], d)
        args = shard_blocks(mesh, full["comp"], full["nseq"],
                            *(full[k] for k in _TABLE_KEYS), device=device)
        out, s = _timed(device, group, lambda: sharded_decode(
            *args, mesh=mesh, out_rows=meta["out_rows"], block_size=block))
        ids = np.arange(me * (nt // d), (me + 1) * (nt // d))
        record("sharded", out, s, np.where(ids < real_n, ids, -1), lambda b: raw[b])
    if "tables" in steps:
        padded, nseq = decode_tables.pad_tables(batch["tables"], _TABLE_KEYS)
        args, tkw = prepare_distributed_step_tables_fallback(
            mesh, splan, rows, padded, nseq, block, device=device)
        out, s = _timed(device, group, lambda: distributed_step_tables_fallback(*args, **tkw))
        record("tables", out, s, recv_ids, lambda b: raw[b])
    result["launches"] = {k: m.launches - before[k][0] for k, m in kernels.items()}
    result["device_launches"] = {k: dict(m.device_launches - before[k][1])
                                 for k, m in kernels.items()}
    result.update(backend=dist.get_backend(group), device=str(device),
                  contexts=multihost.cuda_contexts())
    return result


def steps_in_turn(mesh, specs: list) -> list:
    """:func:`steps_program` for each spec in turn, in one world."""
    return [steps_program(mesh, spec) for spec in specs]


def _rank_main(rank: int, world: int, init: str, backend: str, device_type: str, program,
               payload, out: mp.Queue, timeout: float) -> None:
    try:
        torch.set_num_threads(1)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        multihost.initialize(init, world, rank, backend=backend, timeout=timeout)
        mesh = make_mesh(world, device_type=device_type)
        out.put((rank, True, program(mesh, payload)))
    except BaseException:                        # reported to the parent, which fails
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def default_backend(n_ranks: int, device_type: str) -> str:
    """NCCL when every rank has a CUDA device of its own, else gloo (the
    CPU, or ranks sharing cards: NCCL cannot put two ranks on one card).
    Raises StatusError for "cuda" without CUDA: nothing falls back to the
    CPU."""
    if device_type not in ("cuda", "cpu"):
        raise StatusError(Status.Invalid(f"device_type {device_type!r} not in (cuda, cpu)"))
    if device_type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise StatusError(Status.Invalid(
            "device_type 'cuda' but CUDA is not available; pass device_type='cpu'"))
    return "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"


def run_world(n_ranks: int, program, payload, *, backend: str | None = None,
              device_type: str = "cuda", timeout: float = 300.0) -> list:
    """Spawn ``n_ranks`` processes joined by ``backend`` (default:
    :func:`default_backend`) through a ``file://`` rendezvous in a fresh
    temporary directory; each runs ``program(mesh, payload)`` (a
    module-level function) on a 1-D mesh of ``device_type`` over the world.
    Returns each rank's result in rank order.  Raises StatusError when a
    rank fails, dies or the world outlives ``timeout`` seconds (also each
    rank's group timeout), and before spawning when ``backend="nccl"`` has
    fewer cards than ranks; every child is killed before it returns."""
    default = default_backend(n_ranks, device_type)      # refuses "cuda" without CUDA
    backend = default if backend is None else backend
    if backend == "nccl" and (device_type != "cuda" or torch.cuda.device_count() < n_ranks):
        # NCCL puts one rank on a card; it never turns into gloo here.
        raise StatusError(Status.Invalid(
            f"an NCCL world of {n_ranks} needs {n_ranks} CUDA devices, one a rank; "
            f"device_type {device_type!r}, {torch.cuda.device_count()} visible"))
    ctx = mp.get_context("spawn")
    results: dict = {}
    with tempfile.TemporaryDirectory(prefix="bitar-rdv-") as tmp:
        q = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n_ranks, f"file://{tmp}/rendezvous", backend,
                                   device_type, program, payload, q, timeout))
                 for r in range(n_ranks)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while len(results) < n_ranks:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise StatusError(Status.IOError(
                        f"world of {n_ranks}: ranks {sorted(set(range(n_ranks)) - set(results))}"
                        f" did not finish within {timeout:.0f} s"))
                try:
                    rank, ok, value = q.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode not in (None, 0)]
                    if dead:
                        raise StatusError(Status.IOError(
                            f"world of {n_ranks}: rank {dead[0]} died "
                            f"(exit code {procs[dead[0]].exitcode})")) from None
                    continue
                if not ok:
                    raise StatusError(Status.IOError(f"rank {rank} of {n_ranks} failed:\n{value}"))
                results[rank] = value
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
            q.close()
    return [results[r] for r in range(n_ranks)]


def dryrun_multichip(n_devices: int, device_type: str = "cuda", backend: str | None = None,
                     timeout: float = 300.0) -> list:
    """Spawn ``n_devices`` ranks and run the fused flat step and the ring
    step on 2 * n_devices blocks of 16 KiB; raise unless every live row is
    bit-exact and the ring equals the fused step on every rank.  Runs on
    the card unless the caller asks for ``device_type="cpu"``; ``backend``
    defaults to :func:`default_backend` (NCCL with a card per rank, else
    gloo, ranks sharing the cards)."""
    backend = default_backend(n_devices, device_type) if backend is None else backend
    spec = {"nblocks": 2 * n_devices, "block": 16 * 1024, "seed": 42, "steps": ("flat", "ring")}
    res = run_world(n_devices, steps_program, spec, backend=backend, device_type=device_type,
                    timeout=timeout)
    for rank, r in enumerate(res):
        for step in ("flat", "ring"):
            if not r[step]["exact"]:
                raise StatusError(Status.IOError(f"dryrun rank {rank}: {step} rows not bit-exact"))
        if not r["ring_equals_flat"]:
            raise StatusError(Status.IOError(f"dryrun rank {rank}: ring != fused step"))
    live = sum(r["flat"]["live"] for r in res)
    logger.info("dryrun_multichip(%d, %s, %s): fused flat step decoded %d blocks bit-exactly; "
                "ring step matches it", n_devices, device_type, backend, live)
    return res
