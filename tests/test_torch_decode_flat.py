"""The port's flat-plan decode against the JAX package's.

Same inputs, made from a numpy seed, go through the JAX module's numpy
oracle ``decode_flat_numpy``, its Pallas kernel in interpret mode, and the
port's ``decode_flat_reference`` / ``decode_blocks_flat``.  Tolerance 0: the
decoded planes must be equal byte for byte, on the whole plane.  The corpora
are those of ``tests/test_planned_decode.py``: scheduled comp and out
passes, an identity (RAW) batch with a compacted dense wire, multi-anchor
dense passes, and markdown text; blocks of 16-32 KiB, at most 4 per batch.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitar_tpu.ops.cpu import native as jnative
from bitar_tpu.ops.pallas import lz4_decode_flat as jflat
from bitar_tpu_torch.ops import decode_flat as tflat
from bitar_tpu_torch.ops.cpu import native as tnative
from bitar_tpu_torch.status import StatusError

# Test files run in several worker processes at once: a single intra-op
# thread keeps torch's CPU pool from oversubscribing the cores (the
# tensors here are small).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _round_comp_rows(nbytes: int) -> int:
    rows = -(-nbytes // 128)
    rows = -(-rows // 128) * 128
    return -(-rows // 256) * 256 if rows > 128 else rows


def _batch_plans(comps, block):
    """Plan compressed blocks with the port's batch planner (wire dict)."""
    nrows = block // 128
    lens = np.array([len(c) for c in comps], np.int32)
    off = np.zeros(len(comps), np.int64)
    off[1:] = np.cumsum(lens[:-1])
    se, sh, pu, p0, st, _, dq, ra, dn = tnative.plan_batch_flat(
        np.concatenate(comps), off, lens, np.full(len(comps), block, np.int32),
        np.zeros(len(comps), np.int32), nrows, 160, cb=4)
    assert (st == 0).all(), st
    return tflat.attach_dense_planes(
        tflat.flatten_batch_plans(se, sh, pu, p0, nrows), dq, ra, dn)


def scheduled(rng):
    """Scheduled comp and out passes, no dense wire (test_planned_decode:131)."""
    block = 16 * 1024
    nrows = block // 128
    datas = [(b"flat wire " * (block // 9 + 1))[:block],
             rng.integers(0, 8, block, dtype=np.uint8).tobytes(),
             b"\x77" * block]
    comps = [np.asarray(jnative.lz4_compress(d)) for d in datas]
    per_block = [jnative.plan_block(c, block, nrows, max_passes=96, codec="lz4")
                 for c in comps]
    plans = tflat.build_flat_plans(per_block, nrows)
    return datas, comps, plans, _round_comp_rows(max(len(c) for c in comps)), nrows


def identity_compacted(rng):
    """[RAW, text, RAW] with a one-row compacted dense wire (:418)."""
    block = 16 * 1024
    nrows = block // 128
    raw_blk = rng.integers(0, 256, block, np.uint8).tobytes()
    txt_blk = (b"identity dense wire " * (block // 19 + 1))[:block]
    comp_txt = np.asarray(jnative.lz4_compress(txt_blk, min_match=6))
    plans = _batch_plans([comp_txt], block)
    assert plans["dense"][0] > 0
    pu, p0, dn = plans["p_used"], plans["p0"], plans["dense"]
    batch = {"p_used": np.array([0, pu[0], 0], np.int32),
             "p_off": np.zeros(3, np.int32),
             "p0": np.array([0, p0[0], 0], np.int32),
             "se": plans["se"], "shift": plans["shift"],
             "dq": plans["dq"], "row_a": plans["row_a"],
             "dense": np.array([-1, dn[0], -1], np.int32),
             "dq_idx": np.zeros(3, np.int32)}
    comps = [np.frombuffer(raw_blk, np.uint8), comp_txt, np.frombuffer(raw_blk, np.uint8)]
    return [raw_blk, txt_blk, raw_blk], comps, batch, nrows, nrows


def multi_anchor(rng):
    """Rows stitched from far-apart literal chunks: >= 2 dense anchors (:500)."""
    block = 32 * 1024
    chunks = [rng.integers(0, 256, 48, np.uint8).tobytes() for _ in range(64)]
    pre = b"".join(chunks[i] + rng.integers(0, 256, 80, np.uint8).tobytes()
                   for i in range(64))
    body = b"".join(chunks[(7 * k) % 64] for k in range(200))
    raw = (pre + body)[:block].ljust(block, b"\x00")
    comp = np.asarray(jnative.lz4_compress(raw))
    plans = _batch_plans([comp], block)
    assert int(plans["dense"][0]) >= 2
    return [raw], [comp], plans, _round_comp_rows(len(comp)), block // 128


def text(rng):
    """Markdown text with min_match 4: dense passes plus out passes."""
    block = 32 * 1024
    src = (ROOT / "SURVEY.md").read_bytes()
    offs = rng.integers(0, len(src) - block, 2)
    datas = [src[o:o + block] for o in offs]
    comps = [np.asarray(jnative.lz4_compress(d, min_match=4)) for d in datas]
    plans = _batch_plans(comps, block)
    assert (plans["p_used"] > plans["p0"]).any(), "expected out passes"
    return datas, comps, plans, _round_comp_rows(max(len(c) for c in comps)), block // 128


CORPORA = {"scheduled": scheduled, "identity_compacted": identity_compacted,
           "multi_anchor": multi_anchor, "text": text}


def _comp_rows_u8(comps, width):
    rows = np.zeros((len(comps), width), np.uint8)
    for i, c in enumerate(comps):
        rows[i, :len(c)] = c
    return rows


def _jax_kernel(comps, plans, comp_rows, nrows):
    cp = _comp_rows_u8(comps, comp_rows * 128).reshape(len(comps), comp_rows, 128)
    cp_i8 = (cp.astype(np.int32) - 128).astype(np.int8)
    dense = [jnp.asarray(plans[k]) if k in plans else None
             for k in ("dq", "row_a", "dense", "dq_idx")]
    return np.asarray(jflat.decode_blocks_flat(
        jnp.asarray(cp_i8), jnp.asarray(plans["p_used"]), jnp.asarray(plans["p_off"]),
        jnp.asarray(plans["p0"]), jnp.asarray(plans["se"]), jnp.asarray(plans["shift"]),
        None, *dense, comp_rows=comp_rows, out_rows=nrows, interpret=True))


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_reference_matches_numpy_oracle(corpus):
    datas, comps, plans, comp_rows, nrows = CORPORA[corpus](np.random.default_rng(11))
    oracle = jflat.decode_flat_numpy(comps, plans, comp_rows, nrows)
    rows = torch.from_numpy(_comp_rows_u8(comps, comp_rows * 128))
    got = tflat.decode_flat_reference(rows, tflat.plan_tensors(plans, "cpu"),
                                      comp_rows, nrows).numpy()
    np.testing.assert_array_equal(got, oracle)
    for i, d in enumerate(datas):
        assert got[i].reshape(-1)[:len(d)].tobytes() == d, f"block {i}"


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_wrapper_matches_pallas_interpret(corpus):
    # comp rows wider than the plane, as arena slots are: the tail is zero.
    datas, comps, plans, comp_rows, nrows = CORPORA[corpus](np.random.default_rng(12))
    want = _jax_kernel(comps, plans, comp_rows, nrows)
    rows = torch.from_numpy(_comp_rows_u8(comps, comp_rows * 128 + 384))
    before = tflat.launches
    got = tflat.decode_blocks_flat(rows, tflat.plan_tensors(plans, "cpu"),
                                   comp_rows=comp_rows, out_rows=nrows)
    assert tflat.launches == before, "CPU tensors must not count kernel launches"
    np.testing.assert_array_equal(got.numpy(), want)


def test_reference_clips_narrow_rows():
    # Rows narrower than the comp plane read zero past their width, as the
    # oracle's zero-padded plane does.
    datas, comps, plans, comp_rows, nrows = scheduled(np.random.default_rng(13))
    width = max(len(c) for c in comps)
    oracle = jflat.decode_flat_numpy(comps, plans, comp_rows, nrows)
    rows = torch.from_numpy(_comp_rows_u8(comps, width))
    got = tflat.decode_flat_reference(rows, tflat.plan_tensors(plans, "cpu"),
                                      comp_rows, nrows)
    np.testing.assert_array_equal(got.numpy(), oracle)


def _wire_parity_cases():
    rng = np.random.default_rng(14)
    block = 16 * 1024
    nrows = block // 128
    datas = [((b"wire helpers %d " % i) * (block // 15 + 1))[:block] for i in range(2)]
    datas += [(ROOT / "SURVEY.md").read_bytes()[:block],
              rng.integers(0, 8, block, np.uint8).tobytes()]
    comps = [np.asarray(jnative.lz4_compress(d, min_match=4)) for d in datas]
    lens = np.array([len(c) for c in comps], np.int32)
    off = np.zeros(4, np.int64)
    off[1:] = np.cumsum(lens[:-1])
    args = (np.concatenate(comps), off, lens, np.full(4, block, np.int32),
            np.zeros(4, np.int32), nrows, 160)
    return args, comps, block, nrows


def test_batch_planner_matches_reference_binding():
    # One C++ planner, two bindings: identical plans.  Pass rows past
    # p_used are scratch (the JAX binding reuses them unzeroed).
    args, _, _, _ = _wire_parity_cases()
    se, sh, pu, *rest = tnative.plan_batch_flat(*args, cb=4)
    jse, jsh, jpu, *jrest = jnative.plan_batch_flat(*args, cb=4)
    np.testing.assert_array_equal(pu, jpu)
    assert pu.any(), "expected scheduled passes"
    for i, p in enumerate(pu):
        np.testing.assert_array_equal(se[i, :p], jse[i, :p])
        np.testing.assert_array_equal(sh[i, :p], jsh[i, :p])
    for g, w in zip(rest, jrest, strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("helper", ["flatten_attach", "concat", "build_flat",
                                    "pad_counts", "row_a_layout"])
def test_wire_helpers_match_jax(helper):
    args, comps, block, nrows = _wire_parity_cases()
    se, sh, pu, p0, _, _, dq, ra, dn = jnative.plan_batch_flat(*args, cb=4)
    if helper == "flatten_attach":
        got = tflat.attach_dense_planes(tflat.flatten_batch_plans(se, sh, pu, p0, nrows),
                                        dq, ra, dn)
        want = jflat.attach_dense_planes(jflat.flatten_batch_plans(se, sh, pu, p0, nrows),
                                         dq, ra, dn)
    elif helper == "concat":
        parts = [(se[:2], sh[:2], pu[:2], p0[:2]), (se[2:], sh[2:], pu[2:], p0[2:])]
        got = tflat.concat_flat_plans([tflat.flatten_batch_plans(*p, nrows) for p in parts])
        want = jflat.concat_flat_plans([jflat.flatten_batch_plans(*p, nrows) for p in parts])
    elif helper == "build_flat":
        per_block = [jnative.plan_block(c, block, nrows, max_passes=96) for c in comps]
        got = tflat.build_flat_plans(per_block, nrows)
        want = jflat.build_flat_plans(per_block, 0, nrows)
    elif helper == "pad_counts":
        got = {str(k): tflat.pad_plan_counts(*k) for k in [(0, 0), (1, 1), (5, 2), (9, 9)]}
        want = {str(k): jflat.pad_plan_counts(*k) for k in [(0, 0), (1, 1), (5, 2), (9, 9)]}
    else:
        got = {"ra": tflat.pack_row_a_planes(ra, 4)}
        want = {"ra": jflat.pack_row_a_planes(ra, 4)}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_device_without_kernel_raises_not_falls_back():
    # A device with no kernel raises; it does not run the plain version.
    datas, comps, plans, comp_rows, nrows = scheduled(np.random.default_rng(15))
    rows = torch.from_numpy(_comp_rows_u8(comps, comp_rows * 128)).to("meta")
    with pytest.raises(StatusError):
        tflat.decode_blocks_flat(rows, tflat.plan_tensors(plans, "meta"),
                                 comp_rows=comp_rows, out_rows=nrows)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_block_classes_cover_the_batch_once(corpus):
    _, _, plans, _, _ = CORPORA[corpus](np.random.default_rng(16))
    pt = tflat.plan_tensors(plans, "cpu")
    classes = tflat.block_classes(pt)
    n = pt["dense"].shape[0]
    every = torch.sort(torch.cat(list(classes.values()))).values
    assert torch.equal(every, torch.arange(n)), classes
    dense, p0, pu = (pt[k].numpy() for k in ("dense", "p0", "p_used"))
    assert classes["raw"].tolist() == np.flatnonzero(dense < 0).tolist()
    assert classes["out passes"].tolist() == np.flatnonzero((dense >= 0) & (p0 < pu)).tolist()
    assert classes["no out pass"].tolist() == np.flatnonzero((dense >= 0) & (p0 >= pu)).tolist()


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_selected_blocks_decode_as_in_the_whole_batch(corpus):
    # A class's blocks as a batch of their own (their comp rows and plan
    # fields, the shared wire kept) decode to the whole batch's planes.
    datas, comps, plans, comp_rows, nrows = CORPORA[corpus](np.random.default_rng(17))
    rows = torch.from_numpy(_comp_rows_u8(comps, comp_rows * 128))
    pt = tflat.plan_tensors(plans, "cpu")
    whole = tflat.decode_blocks_flat(rows, pt, comp_rows=comp_rows, out_rows=nrows)
    for cls, idx in tflat.block_classes(pt).items():
        sub_rows, sub_pt = tflat.select_blocks(rows, pt, idx)
        got = tflat.decode_blocks_flat(sub_rows, sub_pt, comp_rows=comp_rows, out_rows=nrows)
        assert torch.equal(got, whole[idx]), cls
        for j, b in enumerate(idx.tolist()):
            assert got[j].reshape(-1)[:len(datas[b])].numpy().tobytes() == datas[b], (cls, b)


@pytest.mark.parametrize("out_rows,dcap", [(128, 4), (256, 64)])
def test_reference_matches_numpy_oracle_on_random_wires(out_rows, dcap):
    # Wires the planner does not emit (every pass id, anchors off the plane
    # and near the int32 limits, random pass ranges and shifts): the plain
    # version clips as the JAX module's oracle does.
    comp_rows = 256
    comp, plans = tflat.random_wire(18, 6, out_rows, comp_rows, dcap)
    assert (plans["dense"] > 32).any() or dcap <= 32
    oracle = jflat.decode_flat_numpy([c[:comp_rows * 128] for c in comp], plans,
                                     comp_rows, out_rows)
    got = tflat.decode_flat_reference(torch.from_numpy(comp), tflat.plan_tensors(plans, "cpu"),
                                      comp_rows, out_rows)
    np.testing.assert_array_equal(got.numpy(), oracle)


def _arena_case(case: str):
    """(comp rows [n, W] uint8 numpy, wire dict, comp_rows, out_rows, table
    [n] of arena rows, arena rows, burst (start, stop)) for the source-row
    cases: a table over an arena of resident rows."""
    rng = np.random.default_rng(19)
    if case == "tall":                       # the slices and cluster route's planes
        comp, plans = tflat.slice_crossing_wire(1152, 19)
        comp_rows = out_rows = 1152
    elif case == "burst slice":
        comp_rows, out_rows = 256, 128
        comp, plans = tflat.random_wire(19, 6, out_rows, comp_rows, 4)
    else:
        datas, comps, plans, comp_rows, out_rows = text(rng)
        comp = _comp_rows_u8(comps, comp_rows * 128 + 256)
    n = comp.shape[0]
    if case == "identity":
        rows, table = n, np.arange(n)
    elif case == "permutation":
        rows, table = n, np.arange(n)[::-1].copy()
    else:                                    # slots with gaps between them
        rows = 3 * n + 5
        table = np.sort(rng.choice(np.arange(0, rows, 2), n, replace=False))
    burst = (2, 5) if case == "burst slice" else (0, n)
    return comp, plans, comp_rows, out_rows, table, rows, burst


@pytest.mark.parametrize("case", ["identity", "permutation", "gaps", "burst slice", "tall"])
def test_source_rows_read_blocks_where_they_lie(case):
    # B1 through a table of rows over a buffer of resident rows (the
    # engine's arena: other rows hold other bytes) decodes what it decodes
    # on the gathered rows, and what it decodes on the blocks' own rows.
    comp, plans, comp_rows, out_rows, table, rows, (s, e) = _arena_case(case)
    rng = np.random.default_rng(20)
    arena = torch.from_numpy(rng.integers(0, 256, (rows, comp.shape[1]), np.uint8))
    arena[torch.from_numpy(table)] = torch.from_numpy(comp)
    t = torch.from_numpy(table.astype(np.int32))[s:e]
    pt = tflat.plan_tensors(plans, "cpu")
    burst = dict(pt)
    for k in ("p_used", "p_off", "p0", "dense", "dq_idx"):
        burst[k] = pt[k][s:e]
    got = tflat.decode_blocks_flat(arena, burst, comp_rows=comp_rows, out_rows=out_rows,
                                   src_rows=t)
    gathered = tflat.decode_blocks_flat(arena.index_select(0, t), burst, comp_rows=comp_rows,
                                        out_rows=out_rows)
    own = tflat.decode_blocks_flat(torch.from_numpy(comp), pt, comp_rows=comp_rows,
                                   out_rows=out_rows)
    assert got.shape == (e - s, out_rows, 128)
    assert torch.equal(got, gathered)
    assert torch.equal(got, own[s:e])


@pytest.mark.parametrize("bad", ["int64", "device", "length", "2-D"])
def test_malformed_source_rows_are_refused(bad):
    comp, plans, comp_rows, out_rows, table, rows, _ = _arena_case("gaps")
    arena = torch.zeros((rows, comp.shape[1]), dtype=torch.uint8)
    t = torch.from_numpy(table.astype(np.int32))
    t = {"int64": t.long(), "device": t.to("meta"), "length": torch.cat([t, t[:1]]),
         "2-D": t[None]}[bad]
    with pytest.raises(StatusError, match="src_rows"):
        tflat.decode_blocks_flat(arena, tflat.plan_tensors(plans, "cpu"), comp_rows=comp_rows,
                                 out_rows=out_rows, src_rows=t)
