"""Time this checkout's B1 (``decode_flat``), B2 (``decode_tables``), B3
(``match``), B4 (``match_dyn``), B5 (``match_walk``), B6 (``parse_walk``),
B7 (``decode_planned``) and emitter (``emit``) kernels against another
checkout's on one card, in turns, on the same inputs.

    python -m bitar_tpu_torch.utils.kernel_ab --old DIR [--out FILE]
        [--only match|match_walk|match_dyn|parse_walk|emit|decode_flat|decode_tables|
                decode_planned]
    python -m bitar_tpu_torch.utils.kernel_ab --only match_routes [--out FILE]

``DIR`` is the root of another checkout of the repo (for example a ``git
archive`` of the parent commit unpacked into a git-ignored directory).  Its
package is loaded beside this one under another name and builds its kernels
into its own ``_build/``.  Every shape is run old, new, new, old (CUDA
events, mean ms per launch) after the two outputs are checked equal; B1,
B2, B3, B4, B5 and B7 are also timed kernel-only (``timing.kernel_time_ms``)
and by the host clock per call (``timing.host_us_per_call``), in the same
turns.
B5 runs on 256 x 128 KiB of the bench corpus (seg 1024, max_match 1024)
and B4 on 64 x 128 KiB of it (max_match 256), each with the offsets the
device matcher detects, and both on 64 x 128 KiB of the text corpus with
those of ``detect_fft=True, fft_k=6`` (up to 10 a block).  B6 walks B4's
planes of those two batches (seg 1024, wcap 8), and the emitter runs at
every shape a main path launches it (:func:`emit_shapes`).  Each B6 and
emitter line carries its bound (``bound_ms``, device memory at 3.35 TB/s).
``--only match_routes`` needs no other checkout: it times B3's two routes
in this one, tiles that stage their window in shared memory ("old") against
tiles that read the plane from device memory ("new", ``tile_plan``'s
window 0), at the shapes the main paths launch (:func:`ab_match_routes`).
The plain
versions are not timed here (``chip_smoke.py`` does that).  Prints one JSON
object per shape and the card's name and power limit.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

BLOCK = 128 * 1024
REPS = 20
WALK_BLOCKS = 256             # B5's bench batch (the device matcher's)
DYN_BLOCKS = 64               # B4's bench batch (seg 256)
DYN_TEXT_BLOCKS = 64          # B5's and B4's text batch


def load_package(root: Path, name: str):
    """Import ``root/bitar_tpu_torch`` as the package ``name``."""
    pkg = root / "bitar_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def planned_batch(btt, data: bytes, nblocks: int):
    """Comp rows, plan tensors and comp_rows of ``data`` compressed (LZ4) and
    planned by an engine of this checkout."""
    cfg = btt.EngineConfig(codec=btt.Codec.LZ4, block_size=BLOCK, burst_size=min(nblocks, 1024),
                           max_pool_slots=nblocks + 32, commit="deferred")
    eng = btt.Engine(cfg, device="cuda").initialize()
    unit = eng.compress(data)
    eng.ensure_plans(unit)
    rows = eng.arena.gather_burst([r.slot for r in unit.refs])
    batch = (rows, unit.plan_device_arrays(), unit.plan_comp_rows)
    eng.recycle(unit)
    eng.release()
    return batch


def turns(timing, old, new, kernel: str | None = None, calls: int = 0) -> dict:
    """Old, new, new, old: mean CUDA-event ms per call of each; with
    ``kernel``, also the kernel-only ms of the kernels so named, and with
    ``calls``, the host microseconds per call over that many calls."""
    res = {}
    for key, timer in (("", lambda fn: timing.device_time_ms(fn, REPS)),
                       ("kernel_", lambda fn: timing.kernel_time_ms(fn, REPS, kernel)),
                       ("host_us_", lambda fn: timing.host_us_per_call(fn, calls))):
        if (key == "kernel_" and not kernel) or (key == "host_us_" and not calls):
            continue
        ms = {"old": [], "new": []}
        for name, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
            ms[name].append(timer(fn))
        res |= {key + k: sum(v) / len(v) for k, v in ms.items()} | {key + "turns": ms}
    return res


def same(a, b) -> bool:
    torch.cuda.synchronize()
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))
    return torch.equal(a, b)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, help="root of the other checkout")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    ap.add_argument("--only", choices=("match", "match_walk", "match_dyn", "parse_walk", "emit",
                                       "decode_flat", "decode_tables", "decode_planned",
                                       "match_routes"),
                    help="time one kernel only")
    args = ap.parse_args()
    if args.old is None and args.only != "match_routes":
        ap.error("--old is required")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import bitar_tpu_torch as btt
    from bitar_tpu_torch.ops import decode_flat as df
    from bitar_tpu_torch.ops import match as mt
    from bitar_tpu_torch.utils import timing
    from bitar_tpu_torch.utils.corpus import make_corpus, make_text_corpus

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    lines = []

    def emit(rec):
        rec["card"] = card
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    corpus = make_corpus(1024)
    if args.only == "match_routes":
        ab_match_routes(emit, timing, mt, corpus)
        return finish(args, lines)
    old = load_package(args.old.resolve(), "bitar_tpu_torch_old")
    from bitar_tpu_torch_old.ops import decode_flat as odf
    from bitar_tpu_torch_old.ops import match as omt

    if args.only in (None, "decode_tables"):
        ab_tables(emit, timing, corpus, make_text_corpus(256))
    if args.only in (None, "decode_planned"):
        ab_planned(emit, timing, corpus)
    if args.only in (None, "match_walk", "match_dyn"):
        ab_match_dyn(emit, timing, corpus, make_text_corpus(DYN_TEXT_BLOCKS), args.only)
    if args.only in (None, "parse_walk"):
        ab_parse_walk(emit, timing, corpus, make_text_corpus(DYN_TEXT_BLOCKS))
    if args.only in (None, "emit"):
        ab_emit(emit, timing, corpus, make_text_corpus(DYN_TEXT_BLOCKS))
    if args.only in ("decode_tables", "decode_planned", "match_walk", "match_dyn",
                     "parse_walk", "emit"):
        return finish(args, lines)
    nrows = BLOCK // 128
    planes = torch.from_numpy(np.frombuffer(corpus, np.uint8).reshape(1024, nrows, 128)
                              .copy()).cuda()
    for n, mm, values in ((64, 64, False), (64, 1024, True), (1024, 64, False),
                          (1024, 1024, True)) if args.only != "decode_flat" else ():
        x = planes[:n]
        kw = dict(offsets=mt.DEFAULT_OFFSETS, nrows=nrows, max_match=mm, emit_values=values)
        equal = same(mt.find_matches(x, **kw), omt.find_matches(x, **kw))
        res = turns(timing, lambda x=x, kw=kw: omt.find_matches(x, **kw),
                    lambda x=x, kw=kw: mt.find_matches(x, **kw), "match_kernel", 100)
        emit({"kernel": "match", "shape": f"{n} x 128 KiB, 26 offsets, max_match {mm}, "
              f"{'values' if values else 'indices'}", "equal": equal, **res})

    if args.only == "match":
        return finish(args, lines)
    rng = np.random.default_rng(7)
    raw_heavy = b"".join(
        rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes() if i % 8 else
        (b"raw-heavy batch %d " % i) * (BLOCK // 18 + 1) for i in range(256))[:256 * BLOCK]
    batches = {"bench 1024": planned_batch(btt, corpus, 1024),
               "text 256": planned_batch(btt, make_text_corpus(256), 256),
               "raw-heavy 256": planned_batch(btt, raw_heavy, 256)}
    for whole in ("bench 1024", "text 256"):
        rows, pt, comp_rows = batches[whole]
        for cls, idx in df.block_classes(pt).items():
            if idx.numel():
                batches[f"{whole.split()[0]}, {cls} ({idx.numel()} blocks)"] = (
                    *df.select_blocks(rows, pt, idx), comp_rows)
    for name, (rows, pt, comp_rows) in batches.items():
        def new(rows=rows, pt=pt, cr=comp_rows):
            return df.decode_blocks_flat(rows, pt, comp_rows=cr, out_rows=nrows)

        def prev(rows=rows, pt=pt, cr=comp_rows):
            return odf.decode_blocks_flat(rows, pt, comp_rows=cr, out_rows=nrows)

        equal = same(new(), prev())
        emit({"kernel": "decode_flat", "shape": f"{name} x 128 KiB", "equal": equal,
              **turns(timing, prev, new, "decode_flat_kernel", 100)})
    return finish(args, lines)


def ab_match_routes(emit, timing, mt, corpus: bytes) -> None:
    """B3's staged route ("old") against its device-memory route ("new") on
    the bench corpus at the shapes the main paths launch: 1024 x 128 KiB and
    128 x 1 MiB, ``DEFAULT_OFFSETS``, indices at max_match 64 (the ``tpu``
    matcher) and values at 1024 (``match_offsets``).  The device-memory
    route is forced by a ``tile_plan`` that gives window 0."""
    plan = mt.tile_plan

    def routed(x, kw, staged: bool):
        mt.tile_plan = plan if staged else (lambda *a: plan(*a) | {"window": 0})
        try:
            return mt.find_matches(x, **kw)
        finally:
            mt.tile_plan = plan

    flat = torch.from_numpy(np.frombuffer(corpus, np.uint8).copy()).cuda()
    for block in (BLOCK, 8 * BLOCK):
        x = flat.view(-1, block // 128, 128)
        for mm, values in ((64, False), (1024, True)):
            kw = dict(offsets=mt.DEFAULT_OFFSETS, nrows=block // 128, max_match=mm,
                      emit_values=values)
            assert plan(block, mt.DEFAULT_OFFSETS, mm)["window"] > 0
            equal = same(routed(x, kw, True), routed(x, kw, False))
            res = turns(timing, lambda x=x, kw=kw: routed(x, kw, True),
                        lambda x=x, kw=kw: routed(x, kw, False), "match_kernel", 100)
            emit({"kernel": "match", "shape": f"{x.shape[0]} x {block >> 10} KiB, 26 offsets, "
                  f"max_match {mm}, {'values' if values else 'indices'}",
                  "routes": "old: staged window, new: device memory", "equal": equal, **res})


def table_shapes(corpus: bytes, text: bytes) -> dict:
    """B2's shapes: the engine's 4 KiB burst and 8192 blocks of the bench
    corpus, 256 x 128 KiB of it (the parallel tables step's) and 256 x 128
    KiB of markdown (deep tables); numpy (rows, tables, nseq, block)."""
    from bitar_tpu_torch.ops import decode_tables as dt

    small = 4096
    b4 = dt.parser_tables([corpus[i * small:(i + 1) * small] for i in range(8192)])[:3]
    return {"burst 1024 x 4 KiB": (b4[0][:1024], {k: v[:1024] for k, v in b4[1].items()},
                                   b4[2][:1024], small),
            "bench 8192 x 4 KiB": (*b4, small),
            "bench 256 x 128 KiB": (*dt.parser_tables(
                [corpus[i * BLOCK:(i + 1) * BLOCK] for i in range(256)])[:3], BLOCK),
            "deep text 256 x 128 KiB": (*dt.parser_tables(
                [text[i * BLOCK:(i + 1) * BLOCK] for i in range(256)])[:3], BLOCK)}


def ab_tables(emit, timing, corpus: bytes, text: bytes) -> None:
    from bitar_tpu_torch.ops import decode_tables as dt
    from bitar_tpu_torch_old.ops import decode_tables as odt

    for name, (rows, tables, nseq, block) in table_shapes(corpus, text).items():
        r = torch.from_numpy(rows).cuda()
        tn, tt = dt.table_tensors(tables, nseq, "cuda")
        kw = dict(out_rows=block // 128)

        def new(r=r, tn=tn, tt=tt, kw=kw):
            return dt.decode_blocks(r, tn, tt, **kw)

        def prev(r=r, tn=tn, tt=tt, kw=kw):
            return odt.decode_blocks(r, tn, tt, **kw)

        equal = same(new(), prev())
        emit({"kernel": "decode_tables", "shape": name, "sequences": int(nseq.sum()),
              "max_per_block": int(nseq.max()), "equal": equal,
              **turns(timing, prev, new, "decode_tables_kernel",
                      1000 if block <= 4096 else 100)})


def ab_planned(emit, timing, corpus: bytes) -> None:
    from bitar_tpu_torch.ops import decode_planned as dp
    from bitar_tpu_torch_old.ops import decode_planned as odp

    wire = dp.plan_blocks([corpus[i * BLOCK:(i + 1) * BLOCK] for i in range(256)], BLOCK, 64)
    args = [torch.from_numpy(wire[k]).cuda() for k in ("comp", "p_used", "se", "shift")]
    kw = dict(passes=wire["passes"], comp_rows=wire["comp_rows"], out_rows=BLOCK // 128)
    for order, a in (("as planned", args),
                     ("sorted by descending p_used", [t[torch.argsort(args[1], descending=True)]
                                                      for t in args])):
        equal = same(dp.decode_blocks_planned(*a, **kw), odp.decode_blocks_planned(*a, **kw))
        emit({"kernel": "decode_planned", "shape": f"bench {len(wire['fit'])} x 128 KiB, "
              f"{wire['passes']} passes, {order}", "equal": equal,
              **turns(timing, lambda a=a: odp.decode_blocks_planned(*a, **kw),
                      lambda a=a: dp.decode_blocks_planned(*a, **kw),
                      "decode_planned_kernel", 100)})


def ab_match_dyn(emit, timing, corpus: bytes, text: bytes, only: str | None) -> None:
    from bitar_tpu_torch.ops import device_compress as dc
    from bitar_tpu_torch.ops import match_dyn as md
    from bitar_tpu_torch_old.ops import match_dyn as omd

    nrows = BLOCK // 128

    def batch(data: bytes, n: int, fft: bool):
        planes = torch.from_numpy(np.frombuffer(data[:n * BLOCK], np.uint8)
                                  .reshape(n, BLOCK).copy()).cuda()
        noff, offs = dc.candidate_offsets(planes, detect_fft=fft, fft_k=6)
        lengths = torch.full((n,), BLOCK, dtype=torch.int32, device=planes.device)
        return planes.view(n, nrows, 128), noff, offs, lengths

    walk_kw = dict(nrows=nrows, seg=1024, min_match=6, max_match=1024)
    for name, (x, noff, offs, lengths) in (
            ("bench", batch(corpus, WALK_BLOCKS, False)),
            ("text detect_fft", batch(text, DYN_TEXT_BLOCKS, True))):
        shape = (f"{name} {x.shape[0]} x 128 KiB, offsets a block {noff.float().mean():.2f} "
                 f"(K {offs.shape[1]})")
        if only in (None, "match_walk"):
            def new(a=(x, noff, offs, lengths)):
                return md.find_matches_parse_dyn(*a, **walk_kw)

            def prev(a=(x, noff, offs, lengths)):
                return omd.find_matches_parse_dyn(*a, **walk_kw)

            equal = same(new(), prev())
            emit({"kernel": "match_walk", "shape": f"{shape}, seg 1024, max_match 1024",
                  "equal": equal, **turns(timing, prev, new, "match_walk_kernel", 100)})
        if only in (None, "match_dyn"):
            xd = x[:DYN_BLOCKS] if name == "bench" else x

            def new(a=(xd, noff[:xd.shape[0]], offs[:xd.shape[0]])):
                return md.find_matches_dyn(*a, nrows=nrows, max_match=256)

            def prev(a=(xd, noff[:xd.shape[0]], offs[:xd.shape[0]])):
                return omd.find_matches_dyn(*a, nrows=nrows, max_match=256)

            equal = same(new(), prev())
            emit({"kernel": "match_dyn", "shape": f"{name} {xd.shape[0]} x 128 KiB, "
                  f"max_match 256", "equal": equal,
                  **turns(timing, prev, new, "match_dyn_kernel", 100)})


def emit_shapes(corpus: bytes, text: bytes) -> dict:
    """The emitter's launches on the main paths, on the card: name ->
    (planes, layout, out_width, lengths or None).  ``corpus`` holds 1024
    blocks of the bench corpus, ``text`` 64 of the text corpus.

    - bench 256 x 128 KiB at width 2048 (the row the smoke timed first; no
      lengths, as the smoke always timed it);
    - the engine's device path: 1024 x 128 KiB through ``match_parse_device``
      (seg 1024, S 1025) at the engine's own width (``engine_width``);
    - ``match_offsets``: the same corpus through B3 with the worst-case
      sequence budget (S 21,889), at the same width rule;
    - text with ``detect_fft=True, fft_k=6``, 64 x 128 KiB at width 65536;
    - ``compress_blocks_device(seg=256)``: 64 x 128 KiB, S 4097, at
      ``adaptive_width``."""
    from bitar_tpu_torch.ops import device_compress as dc
    from bitar_tpu_torch.ops.match import DEFAULT_OFFSETS

    def planes_of(data: bytes, n: int):
        pl = torch.from_numpy(np.frombuffer(data[:n * BLOCK], np.uint8).reshape(n, BLOCK)
                              .copy()).cuda()
        return pl, torch.full((n,), BLOCK, dtype=torch.int32, device=pl.device)

    def widths(lay, ln, rule):
        return rule(lay["total"].cpu().numpy(), ln.cpu().numpy(), BLOCK)

    big, blen = planes_of(corpus, 1024)
    shapes = {}
    lay = dc.match_parse_device(big[:WALK_BLOCKS], blen[:WALK_BLOCKS])
    shapes[f"bench {WALK_BLOCKS} x 128 KiB, width 2048"] = (big[:WALK_BLOCKS], lay, 2048, None)
    for name, kw in (("engine device path", {}),
                     ("match_offsets", {"offsets": DEFAULT_OFFSETS})):
        lay = dc.match_parse_device(big, blen, **kw)
        ow = widths(lay, blen, dc.engine_width)
        shapes[f"{name} 1024 x 128 KiB, width {ow}"] = (big, lay, ow, blen)
    tpl, tlen = planes_of(text, DYN_TEXT_BLOCKS)
    lay = dc.match_parse_device(tpl, tlen, detect_fft=True, fft_k=6)
    shapes[f"text detect_fft {DYN_TEXT_BLOCKS} x 128 KiB, width 65536"] = (tpl, lay, 65536, tlen)
    spl, slen = big[:DYN_BLOCKS], blen[:DYN_BLOCKS]
    lay = dc.match_parse_device(spl, slen, seg=256)
    ow = widths(lay, slen, lambda s, ln, L: dc.adaptive_width(s, ln, L, 256))
    shapes[f"seg 256 {DYN_BLOCKS} x 128 KiB, width {ow}"] = (spl, lay, ow, slen)
    return shapes


def ab_emit(emit, timing, corpus: bytes, text: bytes) -> None:
    from bitar_tpu_torch.ops import emit as em
    from bitar_tpu_torch_old.ops import emit as oem

    for name, (pl, lay, ow, ln) in emit_shapes(corpus, text).items():
        def new(pl=pl, lay=lay, ow=ow, ln=ln):
            return em.emit_blocks(pl, lay, out_width=ow, lengths=ln)

        def prev(pl=pl, lay=lay, ow=ow, ln=ln):
            return oem.emit_blocks(pl, lay, out_width=ow, lengths=ln)

        equal = same(new(), prev())
        rec = {"kernel": "emit", "shape": name, "slots": lay["starts"].shape[1],
               "out_mib": pl.shape[0] * ow / 2**20,
               "bound_ms": timing.bound_ms(em.bound_bytes(lay, ow))[0], "equal": equal}
        rec["floor_kernel_ms"] = em.floor_kernel_ms(pl.shape[0], lay["starts"].shape[1], ow,
                                                    timing, REPS)
        emit(rec | turns(timing, prev, new, "emit_kernel", 200))


def ab_parse_walk(emit, timing, corpus: bytes, text: bytes) -> None:
    from bitar_tpu_torch.ops import device_compress as dc
    from bitar_tpu_torch.ops import match_dyn as md
    from bitar_tpu_torch_old.ops import match_dyn as omd

    nrows = BLOCK // 128
    for name, data, n, fft in (("bench B4 planes", corpus, WALK_BLOCKS, False),
                               ("text detect_fft B4 planes", text, DYN_TEXT_BLOCKS, True)):
        planes = torch.from_numpy(np.frombuffer(data[:n * BLOCK], np.uint8)
                                  .reshape(n, BLOCK).copy()).cuda()
        noff, offs = dc.candidate_offsets(planes, detect_fft=fft, fft_k=6)
        lengths = torch.full((n,), BLOCK, dtype=torch.int32, device=planes.device)
        mlen, moff = (t.reshape(n, BLOCK) for t in md.find_matches_dyn(
            planes.view(n, nrows, 128), noff, offs, nrows=nrows, max_match=1024))
        kw = dict(seg=1024, min_match=6, wcap=8)

        def new(a=(mlen, moff, lengths)):
            return md.parse_walk_dyn(*a, **kw)

        def prev(a=(mlen, moff, lengths)):
            return omd.parse_walk_dyn(*a, **kw)

        got = new()
        equal = same(got, prev())
        bound = md.walk_bound_bytes(mlen, moff, lengths, got[0], got[1], **kw)
        emit({"kernel": "parse_walk", "shape": f"{name}, {n} x 128 KiB, seg 1024, wcap 8",
              "sequences": int((got[0] >= 0).sum()),
              "bound_ms": timing.bound_ms(bound)[0], "equal": equal,
              **turns(timing, prev, new, "parse_walk_kernel", 200)})


def finish(args, lines: list[str]) -> int:
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    if not all(json.loads(line)["equal"] for line in lines):
        print("kernel_ab: the two checkouts' kernels disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
