"""Multi-process scaling benchmark of the fused shuffle+decode step
(BASELINE config 5).

Counterpart of ``bitar_tpu/cli/multihost_bench.py`` on ``torch.distributed``.
The reference's topology ceiling is one process with lcores sharing an
address space (``driver.cc:100-158``); the port runs one process per device
joined by ``torch.distributed``, a 1-D mesh over the ranks, and the block
shuffle on the mesh's collectives.  This harness runs that shape: N ranks
on one host (``parallel.multihost.initialize`` with a ``file://``
rendezvous, as ``parallel.dryrun.run_world`` spawns them), each building
the same batch from its seed, staging its share of the blocks, and driving
``distributed_step_flat`` (or the ring step) over the mesh; it measures
blocks/s, the scaling-efficiency number of config 5.  With a card a rank
they exchange over NCCL (``--launch 4`` on four cards); with fewer cards
than ranks they share the cards and exchange over gloo.

Efficiency is weak scaling: the 1-process baseline runs ``blocks / N``
blocks on its own, so each rank in both arms decodes the same share and the
ratio isolates the cross-process exchange and coordination cost.

Launch (spawns the ranks, then the baseline, and writes the artifact)::

    python -m bitar_tpu_torch.cli.multihost_bench --launch 2 --out MULTIHOST.json

``--phases`` adds the flat step's exchange alone and its decode alone to
each rank's result and the artifact's ``phase_attribution``;
``--skew-bucket-log K`` coarsens the shuffle plan's balance order
(``ShardingConfig.skew_bucket_log``); ``--pin-cores`` keeps every rank on
a disjoint, equal share of the cores the launcher may use and the baseline
on rank 0's share (the affinity ``taskset`` sets, set inside each rank).
One rank runs per device, so the JAX harness's ``--devices-per-process``
has no counterpart.

One rank of a job started by hand (every rank with the same arguments)::

    python -m bitar_tpu_torch.cli.multihost_bench --processes 2 --process-id 0 \\
        --coordinator file:///tmp/rendezvous
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from ..parallel import dryrun, multihost
from ..parallel.multihost import partition_blocks
from ..parallel.sharding import make_mesh, mesh_rank

BLOCK = 16 * 1024
STEPS = {"flat": "flat", "ring-flat": "ring"}    # --step -> the dry run's step name


def make_datas(nblocks: int) -> bytes:
    """The harness's corpus, the JAX harness's four kinds in turn (text,
    low-entropy, RLE, random) from seed 7, ``nblocks`` x 16 KiB."""
    rng = np.random.default_rng(7)
    datas = []
    for i in range(nblocks):
        k = i % 4
        if k == 0:
            datas.append(((b"multihost block %d " % i) * (BLOCK // 17 + 1))[:BLOCK])
        elif k == 1:
            datas.append(rng.integers(0, 8, BLOCK, dtype=np.uint8).tobytes())
        elif k == 2:
            datas.append(bytes([i & 0xFF]) * BLOCK)
        else:
            datas.append(rng.integers(0, 256, BLOCK, np.uint8).tobytes())
    return b"".join(datas)


def bench_program(mesh, spec: dict) -> dict:
    """One rank: the step ``spec["step"]`` over ``spec["blocks"]`` blocks,
    best of ``spec["reps"]`` runs, every received row checked bit-exact;
    with ``spec["phases"]`` (flat step) also its exchange and its decode
    alone."""
    step = STEPS[spec["step"]]
    if spec.get("cores"):
        pin_to(spec["cores"][mesh_rank(mesh)])
    res = dryrun.steps_program(mesh, {"nblocks": spec["blocks"], "block": BLOCK,
                                      "corpus": make_datas, "steps": (step,),
                                      "reps": spec["reps"],
                                      "skew_bucket_log": spec.get("skew_bucket_log", 0),
                                      "phases": spec.get("phases", False)})
    r = res[step]
    if not r["exact"]:
        raise AssertionError(f"rank {mesh_rank(mesh)}: received rows not bit-exact")
    lo, hi = partition_blocks(spec["blocks"], mesh.size(), mesh_rank(mesh))
    out = dict(processes=mesh.size(), devices=mesh.size(), blocks=spec["blocks"],
               step_ms=round(r["seconds"] * 1e3, 2), verified_blocks=r["live"],
               staged_blocks=[lo, hi], launches=res["launches"],
               device_launches=res["device_launches"], backend=res["backend"],
               device=res["device"], cores=len(os.sched_getaffinity(0)))
    if "exchange_seconds" in r:
        out.update(exchange_ms=round(r["exchange_seconds"] * 1e3, 2),
                   decode_ms=round(r["decode_seconds"] * 1e3, 2))
    return out


def _arm(ranks: list[dict]) -> dict:
    """One arm's result: the slowest rank's step bounds the step (and each
    phase, where timed)."""
    worst = max(ranks, key=lambda r: r["step_ms"])
    arm = dict(processes=worst["processes"], devices=worst["devices"],
               blocks=worst["blocks"], step_ms=worst["step_ms"],
               blocks_per_s=round(worst["blocks"] / (worst["step_ms"] / 1e3), 1),
               verified_blocks=sum(r["verified_blocks"] for r in ranks),
               backend=worst["backend"],
               rank_step_ms=[r["step_ms"] for r in ranks],
               rank_devices=[r["device"] for r in ranks],
               rank_device_launches=[r["device_launches"] for r in ranks],
               rank_cores=[r["cores"] for r in ranks])
    for k in ("exchange_ms", "decode_ms"):
        if k in worst:
            arm[k] = max(r[k] for r in ranks)
    return arm


def weak_scaling_efficiency(world: int, blocks: int, seconds: float, base_blocks: int,
                            base_seconds: float) -> float:
    """Weak-scaling efficiency of ``world`` ranks that decoded ``blocks`` in
    ``seconds`` against one rank that decoded ``base_blocks`` in
    ``base_seconds``: (blocks / seconds) / (base_blocks / base_seconds) /
    world.  With ``blocks == world * base_blocks`` it is ``base_seconds /
    seconds``: 1.0 when the world's step takes as long as one rank's."""
    return (blocks / seconds) / (base_blocks / base_seconds) / world


def core_shares(n: int) -> list[list[int]]:
    """``n`` disjoint, equal shares of the cores this process may use, as
    the JAX harness's ``taskset`` prefixes give its processes."""
    cores = sorted(os.sched_getaffinity(0))
    per = max(1, len(cores) // n)
    return [cores[(r * per) % len(cores):][:per] for r in range(n)]


def pin_to(cores: list[int]) -> None:
    """Move every thread of this process onto ``cores`` (what ``taskset``
    does for a process it starts; threads started later inherit the mask)
    and size torch's intra-op pool to them."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cores)
        except ProcessLookupError:      # the thread ended meanwhile
            pass
    torch.set_num_threads(len(cores))


def launch(args) -> int:
    """Spawn the ranks, then the 1-process baseline; compute the scaling
    efficiency and write the artifact."""
    # With --pin-cores each rank, and the baseline on rank 0's share, keeps
    # to one of --launch disjoint, equal core shares.
    shares = core_shares(args.launch) if args.pin_cores else None
    spec = {"blocks": args.blocks, "reps": args.reps, "step": args.step,
            "skew_bucket_log": args.skew_bucket_log, "phases": args.phases, "cores": shares}
    base_spec = dict(spec, blocks=max(1, args.blocks // args.launch),
                     cores=shares[:1] if shares else None)

    def world(n: int, s: dict) -> dict:
        return _arm(dryrun.run_world(n, bench_program, s, device_type=args.device,
                                     timeout=args.timeout))

    # Interleaved rounds: each arm runs --rounds times in turn and the
    # artifact keeps each arm's fastest, with every round's efficiency so
    # that the spread is visible.
    multi = base = None
    round_eff = []
    for _ in range(max(1, args.rounds)):
        m, b = world(args.launch, spec), world(1, base_spec)
        round_eff.append(round(weak_scaling_efficiency(
            args.launch, m["blocks"], m["step_ms"], b["blocks"], b["step_ms"]), 3))
        multi = m if multi is None or m["step_ms"] < multi["step_ms"] else multi
        base = b if base is None or b["step_ms"] < base["step_ms"] else base
    efficiency = weak_scaling_efficiency(args.launch, multi["blocks"], multi["step_ms"],
                                         base["blocks"], base["step_ms"])
    backend = multi["backend"]
    artifact = dict(
        config="BASELINE config 5: multi-process fused shuffle+decode",
        multi=multi, single=base,
        scaling_efficiency=round(efficiency, 3),
        round_efficiencies=round_eff,
        scaling_mode="weak (baseline runs blocks/N in one process: each rank decodes "
                     "the same share in both arms)",
        device=_device_record(args.device),
        skew_bucket_log=args.skew_bucket_log, pinned_cores=args.pin_cores,
        note=(f"{args.launch} ranks, one process each, {backend} exchange, step "
              f"{args.step}, {BLOCK // 1024} KiB blocks; decode on "
              f"{'the card(s)' if args.device == 'cuda' else 'the CPU (plain versions)'}"))
    if "exchange_ms" in multi and "exchange_ms" in base:
        artifact["phase_attribution"] = dict(
            multi_exchange_ms=multi["exchange_ms"], multi_decode_ms=multi["decode_ms"],
            single_exchange_ms=base["exchange_ms"], single_decode_ms=base["decode_ms"],
            exchange_ratio=round(multi["exchange_ms"] / max(base["exchange_ms"], 1e-9), 3),
            decode_ratio=round(multi["decode_ms"] / max(base["decode_ms"], 1e-9), 3))
    blob = json.dumps(artifact, indent=1)
    print(blob)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob + "\n")
    return 0


def _device_record(device: str) -> dict:
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def worker(args) -> int:
    """One rank of a job whose ranks were started by hand (a single process
    joins a world of one through a rendezvous file of its own)."""
    backend = dryrun.default_backend(args.processes, args.device)
    if args.device == "cuda":
        torch.cuda.set_device(args.process_id % torch.cuda.device_count())
    with tempfile.TemporaryDirectory(prefix="bitar-rdv-") as tmp:
        multihost.initialize(args.coordinator or f"file://{tmp}/rendezvous", args.processes,
                             args.process_id, backend=backend, timeout=args.timeout)
        try:
            mesh = make_mesh(args.processes, device_type=args.device)
            result = bench_program(mesh, {"blocks": args.blocks, "reps": args.reps,
                                          "step": args.step,
                                          "skew_bucket_log": args.skew_bucket_log,
                                          "phases": args.phases})
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="bitar-tpu-torch-multihost-bench",
        epilog="One rank runs per device, so the JAX harness's --devices-per-process "
               "has no counterpart here.")
    p.add_argument("--launch", type=int, default=0,
                   help="spawn N ranks and report scaling")
    p.add_argument("--processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--coordinator", default=None,
                   help="init_method URL of a job started by hand (file:// or tcp://)")
    p.add_argument("--blocks", type=int, default=32)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--step", choices=sorted(STEPS), default="flat",
                   help="flat = the fused exchange + flat decode (one all_to_all); "
                        "ring-flat = the same decode under the per-peer ring")
    p.add_argument("--rounds", type=int, default=1,
                   help="interleave N (multi, single) measurement rounds; the "
                        "artifact keeps each arm's fastest and every round's "
                        "efficiency")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds a world (or a rank's collectives) may take")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--pin-cores", action="store_true",
                   help="keep each rank on a disjoint, equal share of the cores this "
                        "process may use, and the baseline on rank 0's share")
    p.add_argument("--phases", action="store_true",
                   help="also time the flat step's exchange alone and its decode alone "
                        "(phase_attribution): locates a scaling loss in the collective or "
                        "in the decode")
    p.add_argument("--skew-bucket-log", type=int, default=0,
                   help="coarsen the shuffle plan's balance order: bucket block sizes by "
                        "log2(size) >> K before the sort (ShardingConfig.skew_bucket_log); "
                        "0 = exact sizes")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("multihost_bench: --device cuda but torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if args.launch:
        return launch(args)
    if args.processes > 1 and args.coordinator is None:
        p.error("--processes > 1 needs --coordinator")
    return worker(args)


if __name__ == "__main__":
    sys.exit(main())
