"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the repository root.  The run makes its data from the seed, sets up the
cell, runs its closed loop for ``--seconds`` and prints one JSON line last on
stdout (``--trace 0``: the end-to-end metrics; ``--trace 1``: the per-layer
metrics, from spans and a profiled stretch at the window's end).  Each
number the correctness check compared goes, with its limit, on the last
lines of stderr and under ``checks``, the line's last key.  Without CUDA, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded,
it prints no result and exits non-zero.
"""

import time

T0, T0_WALL = time.perf_counter(), time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Run as a script, this folder heads sys.path, where its trace/ would shadow
# the standard library's trace module: import from the root instead.
sys.path[:] = [str(ROOT)] + [q for q in sys.path
                             if Path(q or ".").resolve() not in (ROOT, ROOT / "benchmark")]


def say(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness

    spec = harness.resolve(args.workload)
    chips = spec["cell"]["chips"]
    import torch

    if not torch.cuda.is_available():
        say("no CUDA device: torch.cuda.is_available() is false")
        return 2
    if torch.cuda.device_count() < chips:
        say(f"the cell asks for {chips} cards, {torch.cuda.device_count()} visible")
        return 2
    ctx = harness.Context(cell=spec["cell"], config=spec["config"], traffic=spec["traffic"],
                          seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                          device="cuda", t0=T0, t0_wall=T0_WALL)
    out, line = harness.run_cell(spec, ctx)
    bad = harness.forbidden_modules()
    if bad:
        say(f"forbidden modules loaded: {bad}")
        return 3
    for k, v in out["notes"].items():
        say(f"{k}: {v}")
    for k, c in line["checks"].items():
        say(f"check {k} {c['value']} limit {c['limit']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
