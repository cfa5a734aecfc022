"""The ZSTD MultiGet cell's correctness control, through the cell's own check.

``rocksdb-zstd-4k.multiget`` compares each kept value with the plain lookup
in its raw block and each kept plane with its raw block, limits 0 bad bytes
and 0 missing keys.  This control runs the cell through ``harness.run_cell``
(set-up, warm-up, window and check as the benchmark runs them) with the plain
Zstd decoder's lossy form in the program's place: each picked block's stored
frame, read from its arena slot, decoded by ``reference.zstd.decode(...,
lossy=True)`` (each compressed block's final literal run left unwritten).
The program still compresses the blocks and builds their tables; only the
decode of the picks is replaced.  ``control.py`` is the LZ4 cells' control:
it decodes with ``reference.lz4`` and is no control for this cell.

    python3 benchmark/control_zstd.py --seeds 11 12 --seconds 10

prints one JSON line a seed: ``{"workload", "seed", "correct", "steps"}`` and
each check's value.  It needs CUDA at the configuration's size (``--device
cpu`` runs the plain versions, for small configurations in tests).  The
benchmark's own runs never run it.
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
from benchmark.reference import zstd  # noqa: E402

CELL = "rocksdb-zstd-4k.multiget"


def lossy_picks():
    """A stand-in for ``Engine.decompress_blocks_device``: the lossy planes
    of the picked blocks, ``[k, nrows, 128]`` uint8 on the engine's device.
    Each block decodes once (kept by its unit and index)."""
    import torch

    done: dict[tuple[int, int], np.ndarray] = {}

    def decode(eng, units, unit_idx, block_idx):
        picks = list(zip(np.asarray(unit_idx).tolist(), np.asarray(block_idx).tolist(),
                         strict=True))
        new = sorted({(u, b) for u, b in picks if (id(units[u]), b) not in done})
        if new:
            slots = [int(units[u].host_slot_table()[b]) for u, b in new]
            rows = eng.arena.gather_burst(slots).cpu().numpy()
            for (u, b), row in zip(new, rows, strict=True):
                m = units[u].manifest
                done[id(units[u]), b] = zstd.decode_stored(
                    row[:int(m.comp_len[b])].tobytes(), int(m.codec_ids[b]),
                    int(m.raw_len[b]), lossy=True)
        width = eng.config.block_size
        out = np.zeros((len(picks), width), np.uint8)
        for j, (u, b) in enumerate(picks):
            got = done[id(units[u]), b]
            out[j, :got.size] = got
        return torch.from_numpy(out).to(eng.device).view(len(picks), width // 128, 128)

    return decode


def reading(spec: dict, seed: int, seconds: float, device: str) -> dict:
    """One run of the cell with the lossy decode in the program's place:
    ``correct`` and each check's value."""
    from bitar_tpu_torch.engine.device import Engine

    ctx = harness.Context(cell=spec["cell"], config=spec["config"], traffic=spec["traffic"],
                          seed=seed, seconds=seconds, trace=False, device=device)
    program = Engine.decompress_blocks_device
    Engine.decompress_blocks_device = lossy_picks()
    try:
        out, line = harness.run_cell(spec, ctx)
    finally:
        Engine.decompress_blocks_device = program
    return {"seed": seed, "correct": line["correct"], "steps": out["notes"]["steps"],
            **{k: c["value"] for k, c in line["checks"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    spec = harness.resolve(CELL)
    for seed in args.seeds:
        print(json.dumps(dict(reading(spec, seed, args.seconds, args.device), workload=CELL)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
