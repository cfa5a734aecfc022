"""The correctness control: the reference's lossy decode in the program's place.

Every cell's check compares decoded bytes with the input, byte for byte, and
its limit is 0 bad bytes.  The control shows that comparison fails a decode
that breaks the configuration's one guarantee (lossless) in the least way a
decoder might be tempted to: each block's final literal run left unwritten
(``reference.lz4.decode(..., lossy=True)``).  It runs on the cell's own data
at the cell's size: every block of the configuration, stored by the
program's host matcher as the cell stores it, and decoded by the control.

    python3 benchmark/control.py --workload lz4-128k.scan --seeds 11 12 13

prints one JSON line a seed, ``{"workload", "seed", "blocks", "bad_bytes"}``.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    # As in run.py: import from the root, never with this folder heading sys.path.
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[:] = [str(ROOT)] + [q for q in sys.path
                                 if Path(q or ".").resolve() not in (ROOT, ROOT / "benchmark")]

from benchmark import harness  # noqa: E402
from benchmark.reference import lz4  # noqa: E402


def reading(config: dict, seed: int) -> dict:
    """The control's bad bytes over every block of the configuration's data."""
    from benchmark.loops.shuffle import compress_all

    block = config["engine"]["block_size"]
    raw, sizes = harness.ref_data.make(config["data"], seed, block)
    comp, off, lens, cids = compress_all(raw, sizes, config["engine"]["min_match"])
    raw_off = np.concatenate([[0], np.cumsum(sizes)])
    bad = 0
    for b in range(len(sizes)):
        got = lz4.decode_stored(comp[off[b]:off[b] + lens[b]].tobytes(), int(cids[b]),
                                int(sizes[b]), lossy=True)
        bad += int((got != raw[raw_off[b]:raw_off[b + 1]]).sum())
    return {"seed": seed, "blocks": len(sizes), "bad_bytes": bad}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    spec = harness.with_held_back(json.loads((harness.ROOT / "BENCHMARK.json").read_text()))
    config = harness.resolve(args.workload, spec=spec)["config"]
    for seed in args.seeds:
        print(json.dumps(dict(reading(config, seed), workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
