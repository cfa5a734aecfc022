"""Time the engine's host plan path in this checkout against another
checkout's on one card, each side in fresh processes, in turns.

    python -m bitar_tpu_torch.utils.plan_ab --old DIR [--turns N] [--out FILE]

``DIR`` is the root of another checkout of the repo (for example a ``git
archive`` of the parent commit unpacked into a git-ignored directory).  A
side first builds its host library and the kernels the probe and the bench
launch, in a process of its own.  Then each turn (old, new, new, old,
repeated ``--turns`` times) runs, with that checkout's package:

* a probe process: the CUDA context made first, then ``Engine.initialize``
  of the bench's engine (1024 x 128 KiB LZ4, deferred commit, background
  plan build), then three units of the bench corpus (each turned by a
  block) in turn through compress, the commit upload, the plan join and a
  first decompress, each recycled before the next, with the planner's
  split of each plan join (``bt_plan_prof_get``, read through ctypes so
  that a checkout without ``native.plan_prof`` reads it too); then the
  tables path: 32768 x 4 KiB of the corpus through compress, the table
  build and two decompresses (32 bursts each);
* ``python -m bitar_tpu_torch.cli.bench``: its JSON line, and the stderr
  lines of its plan phases.

Each probe and bench prints one JSON object to stdout (and to ``--out``),
with the card's name and power limit.  Host-clock times, as the engine's
callers see them.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

NEW = Path(__file__).resolve().parents[2]
PROCESS_TIMEOUT_S = 900

BUILD = """
from bitar_tpu_torch.ops import decode_flat, decode_tables, emit, match_dyn
from bitar_tpu_torch.ops.cpu import native
from bitar_tpu_torch.utils import timing
for load in (native.load, decode_flat.load_kernel, decode_tables.load_kernel,
             emit.load_kernel, match_dyn.load_walk_kernel, timing.load_hold_kernel):
    load()
"""

PROBE = """
import ctypes, json, time
import torch
from bitar_tpu_torch import Codec, Engine, EngineConfig
from bitar_tpu_torch.cli.bench import bench_config
from bitar_tpu_torch.ops.cpu import native
from bitar_tpu_torch.utils.corpus import BLOCK, make_corpus

PHASES = ("parse", "build", "densify", "schedule", "emit", "pack", "d_collect", "d_write")
lib = native.load()
lib.bt_plan_prof_get.argtypes = [ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
lib.bt_plan_prof_get.restype = None


def split():
    buf = (ctypes.c_int64 * len(PHASES))()
    lib.bt_plan_prof_get(buf, 1)
    return {k: buf[i] / 1e6 for i, k in enumerate(PHASES)}


def ms(t0):
    return (time.perf_counter() - t0) * 1e3


torch.zeros(1, device="cuda")
torch.cuda.synchronize()
res = {}
t0 = time.perf_counter()
eng = Engine(bench_config(1024), device="cuda").initialize()
res["initialize_ms"] = ms(t0)
data = make_corpus(1024)
units = []
for k in range(3):
    part = data[k * BLOCK:] + data[:k * BLOCK]
    split()
    t0 = time.perf_counter()
    unit = eng.compress(part)
    row = {"compress_ms": ms(t0)}
    t0 = time.perf_counter()
    eng._ensure_committed(unit)
    row["commit_upload_ms"] = ms(t0)
    t0 = time.perf_counter()
    eng.ensure_plans(unit)
    row["plan_join_ms"] = ms(t0)
    row["planner_ms"] = split()
    t0 = time.perf_counter()
    out = eng.decompress(unit)
    row["first_decompress_ms"] = ms(t0)
    if out.tobytes() != part:
        raise AssertionError("round trip not bit-exact")
    eng.recycle(unit)
    units.append(row)
res["units"] = units
eng.release()
teng = Engine(EngineConfig(codec=Codec.LZ4, block_size=4096, burst_size=1024,
                           max_pool_slots=32768 + 32), device="cuda")
t0 = time.perf_counter()
teng.initialize()
tables = {"initialize_ms": ms(t0)}
t0 = time.perf_counter()
unit = teng.compress(data)
tables["compress_ms"] = ms(t0)
t0 = time.perf_counter()
teng.ensure_plans(unit)
tables["table_build_ms"] = ms(t0)
if unit.tables is None or unit.plan_flat is not None:
    raise AssertionError("the 4 KiB unit did not take the tables path")
for key in ("first_decompress_ms", "second_decompress_ms"):
    t0 = time.perf_counter()
    out = teng.decompress(unit)
    tables[key] = ms(t0)
    if out.tobytes() != data:
        raise AssertionError("tables round trip not bit-exact")
tables["bursts"] = teng.stats.device_decode_bursts
res["tables"] = tables
print(json.dumps(res))
"""


def run(root: Path, args: list[str]) -> subprocess.CompletedProcess:
    """``python args`` with ``root``'s package first on the path, from ``root``."""
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, *args], cwd=root, env=env, capture_output=True,
                          text=True, timeout=PROCESS_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: {' '.join(args)[:60]} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return proc


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True, help="root of the other checkout")
    ap.add_argument("--turns", type=int, default=1, help="rounds of old, new, new, old")
    ap.add_argument("--out", type=Path, help="also append each JSON line here")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    sides = {"old": args.old.resolve(), "new": NEW}
    for side, root in sides.items():
        run(root, ["-c", BUILD])

    def emit(line: dict) -> None:
        text = json.dumps(line | {"card": card})
        print(text, flush=True)
        if args.out is not None:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    for turn in range(args.turns):
        for side in ("old", "new", "new", "old"):
            root = sides[side]
            probe = json.loads(run(root, ["-c", PROBE]).stdout.strip().splitlines()[-1])
            emit({"side": side, "turn": turn, "probe": probe})
            bench = run(root, ["-m", "bitar_tpu_torch.cli.bench"])
            emit({"side": side, "turn": turn,
                  "bench": json.loads(bench.stdout.strip().splitlines()[-1]),
                  "plan_lines": [ln for ln in bench.stderr.splitlines()
                                 if "plan" in ln or "COLD" in ln]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
