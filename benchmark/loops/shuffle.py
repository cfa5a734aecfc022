"""Shuffle: fused shuffle-and-decode steps over a world of ranks, a card each.

The parent spawns the configuration's ``world`` ranks through the program's
``parallel.dryrun.run_world`` (NCCL with a card a rank; gloo on the CPU).
Every rank makes the whole input from the seed and compresses it with the
engine's host matcher; the exchange plan is ``parallel.shuffle.plan_shuffle``
(blocks hash-partitioned by id, counts balanced).  A rank holds its
contiguous share of the stored blocks on its card and plans the blocks it
will receive.  A step is ``parallel.pipeline.distributed_step_flat``: stage,
one all-to-all, B1 on what arrived, the card synchronized.  Rank 0's clock
decides each step for all (a broadcast); a barrier closes the window.
``shuffle_GBps`` is the raw bytes all ranks decoded over rank 0's window.

Checked after the window: each rank's decoded rows of a sample of steps,
drawn from the seed, against the raw bytes of the blocks it received; its
rows received by the exchange alone against the stored blocks; and that the
ranks together received every block exactly once.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from .. import harness

RAW_ID = 3             # the host library's codec id of a block stored as it came
MAX_PASSES = 160       # the engine's plan budget a block
CB = 4                 # the planner's chunk blocks, as the program's batch helpers use


def compress_all(raw: np.ndarray, sizes: np.ndarray, min_match: int):
    """Every block with the engine's host matcher, stored as it came where
    LZ4 does not shrink it: (bytes, offsets, lengths, codec ids)."""
    from bitar_tpu_torch.config import Codec, compress_bound
    from bitar_tpu_torch.ops import registry

    n = len(sizes)
    cap = compress_bound(Codec.LZ4, int(sizes.max()))
    raw_off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    dst = np.empty(n * cap, np.uint8)
    dst_off = np.arange(n, dtype=np.int64) * cap
    lens, st = registry.host_compress_batch(Codec.LZ4, 1, raw, raw_off, sizes.astype(np.int32),
                                            dst, dst_off, np.full(n, cap, np.int32),
                                            min_match=min_match)
    if (st < 0).any():
        raise RuntimeError(f"host compress failed on blocks {np.flatnonzero(st < 0)[:8]}")
    lens = lens.astype(np.int64)
    cids = np.zeros(n, np.int32)
    for i in np.flatnonzero(lens >= sizes):
        dst[dst_off[i]:dst_off[i] + sizes[i]] = raw[raw_off[i]:raw_off[i] + sizes[i]]
        lens[i], cids[i] = sizes[i], RAW_ID
    return dst, dst_off, lens, cids


def rank_program(mesh, p: dict) -> dict:
    """One rank: set up, run the window with the others, check, report."""
    if p.get("hook") is not None:
        p["hook"]()
    from bitar_tpu_torch.ops.cpu import native
    from bitar_tpu_torch.parallel.pipeline import (
        WIRE_KEYS,
        distributed_step_flat,
        local_wires,
        prepare_flat_wires_for_recv,
    )
    from bitar_tpu_torch.parallel.sharding import mesh_device, mesh_group, mesh_rank
    from bitar_tpu_torch.parallel.shuffle import (
        ShufflePlan,
        all_to_all_rows,
        plan_shuffle,
        stage_rows,
    )

    d, me = mesh.size(), mesh_rank(mesh)
    device, group = mesh_device(mesh), mesh_group(mesh)
    ctx = harness.Context(cell=p["cell"], config=p["config"], traffic=p["traffic"],
                          seed=p["seed"], seconds=p["seconds"], trace=p["trace"],
                          device=str(device))
    ph = harness.Phases(time.perf_counter())
    block = ctx.config["engine"]["block_size"]
    raw, sizes = harness.make_data(ctx)
    ph.mark("make_data")
    n = len(sizes)
    comp, comp_off, lens, cids = compress_all(raw, sizes, ctx.config["engine"]["min_match"])
    ph.mark("compress")
    comp_rows = -(-max(128, int(lens.max())) // 128)
    comp_rows = -(-comp_rows // 128) * 128
    splan = plan_shuffle(n, d, sizes=lens)
    per_src = n // d

    raw_off = np.concatenate([[0], np.cumsum(sizes)])

    def raw_of(ids: np.ndarray) -> np.ndarray:
        return np.concatenate([raw[raw_off[b]:raw_off[b + 1]] for b in ids.tolist()])

    def stored_rows(ids: np.ndarray) -> np.ndarray:
        rows = np.zeros((len(ids), comp_rows * 128), np.uint8)
        for j, b in enumerate(ids.tolist()):
            rows[j, :lens[b]] = comp[comp_off[b]:comp_off[b] + lens[b]]
        return rows

    local_rows = torch.from_numpy(stored_rows(np.arange(me * per_src, (me + 1) * per_src))
                                  ).to(device)
    send_idx, valid = (torch.from_numpy(a).to(device) for a in splan.staging(me, per_src))
    recv = splan.recv_block[me].reshape(-1)
    live = np.flatnonzero(recv >= 0)
    ids = recv[live]
    src = np.concatenate([comp[comp_off[b]:comp_off[b] + lens[b]] for b in ids.tolist()])
    off = np.concatenate([[0], np.cumsum(lens[ids])[:-1]]).astype(np.int64)
    se, sh, pu, p0, st, _, dq, ra, dn = native.plan_batch_flat(
        src, off, lens[ids].astype(np.int32), sizes[ids].astype(np.int32), cids[ids],
        block // 128, MAX_PASSES, cb=CB)
    if (st != 0).any():
        raise RuntimeError(f"rank {me}: the planner rejected blocks {ids[st != 0][:8]}")
    # The plan's receive order with this rank's blocks numbered as planned here.
    mine = np.full_like(splan.recv_block, -1)
    mine[me].reshape(-1)[live] = np.arange(len(ids))      # a view: writes into mine
    wires = local_wires(prepare_flat_wires_for_recv(
        ShufflePlan(d, splan.rows_per_pair, splan.send_order, splan.dest, mine),
        se, sh, pu, p0, dq, ra, dn, block // 128), me, device)
    del se, sh, dq, ra
    ph.mark("plan_and_wires")
    args = (local_rows, send_idx, valid, *(wires[k] for k in WIRE_KEYS))
    kw = dict(mesh=mesh, rows_per_pair=splan.rows_per_pair, comp_rows=comp_rows,
              block_size=block)
    for _ in range(int(ctx.traffic["warm_steps"])):   # NCCL connects the cards on the first
        distributed_step_flat(*args, **kw)
    harness.sync(device)
    dist.barrier(group=group)
    ph.mark("warm")

    res = harness.Reservoir(int(ctx.traffic["sample_steps"]), ctx.seed)
    kept: list = [None] * res.size
    raw_step, stored_step = int(sizes[ids].sum()), int(lens[ids].sum())
    flag = torch.zeros(1, dtype=torch.int32, device=device)

    def decide(state: int) -> int:
        flag.fill_(state)
        dist.broadcast(flag, src=0, group=group)
        return int(flag.item())

    def agree(ok: bool) -> bool:
        t = torch.tensor([int(ok)], dtype=torch.int32, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
        return bool(t.item())

    def step(i: int) -> dict:
        slot = res.slot()
        with ctx.spans.span("step"):
            out = distributed_step_flat(*args, **kw)
            harness.sync(device)
        if slot is not None:
            kept[slot] = out
        return {"raw_bytes": raw_step, "stored_bytes": stored_step}

    w = harness.drive(ctx, step, decide=decide, agree=agree,
                      finish=lambda: dist.barrier(group=group))
    start_wall = time.time() - (time.perf_counter() - w.start)
    peak = harness.memory_peak(device)
    extra = {}
    if ctx.trace and device.type == "cuda":
        # The exchange alone on CUDA events: read where the profiler kept no NCCL kernel.
        reps = 10
        dist.barrier(group=group)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            all_to_all_rows(stage_rows(local_rows, send_idx, valid), group)
        e1.record()
        e1.synchronize()
        extra["exchange_event_ms"] = e0.elapsed_time(e1) / reps
    reading = harness.window_reading(ctx, w, extra) if ctx.trace else None

    bad = checked = 0
    for out in [o for o in kept if o is not None]:
        bad += harness.bad_plane_bytes([out[torch.from_numpy(live).to(device)]], raw_of(ids),
                                       sizes[ids])
        checked += 1
    kept.clear()
    got = all_to_all_rows(stage_rows(local_rows, send_idx, valid), group).cpu().numpy()[live]
    bad_rows = int((got != stored_rows(ids)).any(axis=1).sum())
    return {"rank": me, "start_wall": start_wall, "window_s": w.seconds, "steps": w.steps,
            "raw_bytes": w.counts.get("raw_bytes", 0), "ids": ids, "nblocks": n,
            "bad_bytes": bad, "bad_rows": bad_rows, "unchecked": res.wanted() - checked,
            "peak": peak, "reading": reading, "forbidden": harness.forbidden_modules(),
            "phases": ph.seconds}


def run(ctx: harness.Context) -> dict:
    from bitar_tpu_torch.parallel import dryrun

    world = int(ctx.config["world"])
    payload = {"cell": ctx.cell, "config": ctx.config, "traffic": ctx.traffic, "seed": ctx.seed,
               "seconds": ctx.seconds, "trace": ctx.trace, "hook": ctx.hook}
    rs = dryrun.run_world(world, rank_program, payload, device_type=ctx.device,
                          timeout=float(ctx.traffic["world_timeout_s"]))
    bad = sorted({m for r in rs for m in r["forbidden"]})
    if bad:
        raise RuntimeError(f"a rank loaded forbidden modules: {bad}")
    ids = np.concatenate([r["ids"] for r in rs])
    counts = np.bincount(ids, minlength=rs[0]["nblocks"])
    r0 = rs[0]
    w = harness.Window(start=ctx.t0, seconds=r0["window_s"], steps=r0["steps"])
    return harness.outcome(
        ctx, w, e2e={"shuffle_GBps": sum(r["raw_bytes"] for r in rs) / r0["window_s"] / 1e9},
        attempted=r0["steps"], failed=0, peak=max(r["peak"] for r in rs),
        readings=[r["reading"] for r in rs] if ctx.trace else None, count=world,
        setup_s=r0["start_wall"] - ctx.t0_wall,
        checks={"bad_bytes": (sum(r["bad_bytes"] for r in rs), 0),
                "bad_rows": (sum(r["bad_rows"] for r in rs), 0),
                "blocks_not_once": (int((counts != 1).sum()), 0),
                "unchecked_steps": (sum(r["unchecked"] for r in rs), 0)},
        notes={"setup_phases_s": [r["phases"] for r in rs], "steps": r0["steps"],
               "window_s": r0["window_s"], "rank_window_s": [r["window_s"] for r in rs]})
