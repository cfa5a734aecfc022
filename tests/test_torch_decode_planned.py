"""The port's dense-plan decode (kernel B7, ``decode_blocks_planned``)
against the JAX package's on the CPU.

The host planner is the same C++ in both packages (``plan_block``); plans
are packed by each package's ``pack_plan`` and decoded by the JAX Pallas
kernel in interpret mode and by the port's plain version.  Tolerance 0:
these are bytes.  Random malformed plans pin the anchor-row rule (a lane
reads row ``row_a`` or ``row_a + 1``, never ``S[q]`` itself).  The pass
classes the kernel relies on (a comp-only pass reads no out row) are
checked on planner plans and on ``class_plans``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitar_tpu_torch as btt
from bitar_tpu.ops.cpu import native as jnative
from bitar_tpu.ops.pallas import lz4_decode_planned as jdp
from bitar_tpu_torch.ops import decode_planned as tdp
from bitar_tpu_torch.ops.cpu import native
from bitar_tpu_torch.utils.corpus import make_corpus, make_text_corpus

torch.set_num_threads(1)

BLOCK = 16 * 1024
NROWS = BLOCK // 128


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def jax_decode(comp, p_used, se, shift, *, passes, comp_rows, out_rows):
    return np.asarray(jdp.decode_blocks_planned(
        jnp.asarray(comp), jnp.asarray(p_used), jnp.asarray(se), jnp.asarray(shift),
        passes=passes, comp_rows=comp_rows, out_rows=out_rows, interpret=True))


def port_decode(comp, p_used, se, shift, *, passes, comp_rows, out_rows):
    return tdp.decode_blocks_planned(t(comp), t(p_used), t(se), t(shift), passes=passes,
                                     comp_rows=comp_rows, out_rows=out_rows).numpy()


def corpus(rng, n=BLOCK):
    return [
        (b"plan me please! " * (n // 14 + 2))[:n],
        rng.integers(0, 8, n, dtype=np.uint8).tobytes(),
        b"\x37" * n,
        (b"abcdefgh" * (n // 8 + 1))[:n],
        np.repeat(np.arange(n // 16 + 1, dtype=np.uint8), 16).tobytes()[:n],
        rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
    ]


def planned_batch(datas, block=BLOCK, max_passes=96):
    """``tdp.plan_blocks`` of ``datas``, every block planned; returns the
    comp planes, p_used, se, shift, passes and comp_rows."""
    wire = tdp.plan_blocks(datas, block, max_passes)
    assert wire["fit"] == list(range(len(datas)))
    return tuple(wire[k] for k in ("comp", "p_used", "se", "shift", "passes", "comp_rows"))


def test_plan_block_matches_jax():
    rng = np.random.default_rng(2)
    for d in corpus(rng, 5000):
        c = native.lz4_compress(d)
        nr = -(-len(d) // 128)
        got = native.plan_block(c, len(d), nr, max_passes=96)
        want = jnative.plan_block(np.asarray(c), len(d), nr, max_passes=96)
        assert got[:2] == want[:2]
        for k in ("r_dstart", "r_dend", "r_shift"):
            np.testing.assert_array_equal(got[2][k], want[2][k])
    assert native.plan_block(native.lz4_compress(b"x" * 999), 999, 8, max_passes=1)[0] is None


def test_pack_plan_matches_jax():
    rng = np.random.default_rng(4)
    P, nrows = 7, 256
    dstart = rng.integers(0, nrows * 128, (P, nrows)).astype(np.int32)
    dend = dstart + rng.integers(0, 300, (P, nrows)).astype(np.int32)
    shift = rng.integers(-5000, 5000, (P, nrows)).astype(np.int32)
    for got, want in zip(tdp.pack_plan(dstart, dend, shift, 3, 10, 96),
                         jdp.pack_plan(dstart, dend, shift, 3, 10, 96)):
        np.testing.assert_array_equal(got, want)


def test_planner_plans_decode_to_raw_bytes():
    rng = np.random.default_rng(9)
    datas = corpus(rng)
    comp, p_used, se, shift, passes, comp_rows = planned_batch(datas)
    kw = dict(passes=passes, comp_rows=comp_rows, out_rows=NROWS)
    got = port_decode(comp, p_used, se, shift, **kw)
    np.testing.assert_array_equal(got, jax_decode(comp, p_used, se, shift, **kw))
    for i, d in enumerate(datas):
        assert got[i].tobytes() == d, f"block {i}"
    assert (p_used > 1).any()


def test_plan_blocks_leaves_out_plans_past_the_budget():
    rng = np.random.default_rng(11)
    datas = corpus(rng)
    full = tdp.plan_blocks(datas, BLOCK, 96)
    budget = int(np.median(full["p_used"]))
    wire = tdp.plan_blocks(datas, BLOCK, budget)
    assert wire["fit"] == [i for i, p in enumerate(full["p_used"]) if p <= budget]
    assert 0 < len(wire["fit"]) < len(datas) and wire["passes"] <= budget
    assert wire["stored"] == sum(len(native.lz4_compress(datas[i])) for i in wire["fit"])
    kw = dict(passes=wire["passes"], comp_rows=wire["comp_rows"], out_rows=NROWS)
    got = port_decode(*(wire[k] for k in ("comp", "p_used", "se", "shift")), **kw)
    for j, i in enumerate(wire["fit"]):
        assert got[j].tobytes() == datas[i]


def test_p_used_past_passes_and_zero():
    # p_used above ``passes`` runs ``passes`` passes; 0 and negative run none.
    rng = np.random.default_rng(10)
    comp, p_used, se, shift, passes, comp_rows = planned_batch(corpus(rng)[:4])
    p_used = np.array([passes + 5, 0, -2, max(1, int(p_used[3]) - 1)], np.int32)
    kw = dict(passes=passes, comp_rows=comp_rows, out_rows=NROWS)
    got = port_decode(comp, p_used, se, shift, **kw)
    np.testing.assert_array_equal(got, jax_decode(comp, p_used, se, shift, **kw))
    assert not got[1].any() and not got[2].any()


@pytest.mark.parametrize("seed,comp_rows,out_rows", [(0, 64, 256), (1, 32, 128),
                                                     (2, 960, 128)])
def test_random_plans_pin_the_anchor_rule(seed, comp_rows, out_rows):
    # Malformed plans (tdp.random_plans): ranges past the row and start >
    # end; shifts into the comp region, the out region, the zeros above,
    # negative (a huge logical qrow) and near the int32 limits (q wraps);
    # p_used past passes, 0 and negative.
    passes = 5
    comp, p_used, se, shift = tdp.random_plans(seed, 6, passes, comp_rows, out_rows)
    kw = dict(passes=passes, comp_rows=comp_rows, out_rows=out_rows)
    got = port_decode(comp, p_used, se, shift, **kw)
    np.testing.assert_array_equal(got, jax_decode(comp, p_used, se, shift, **kw))
    assert got[0].any()


def test_reference_asserts_are_status_errors():
    comp = np.zeros((1, 32, 128), np.uint8)
    z = np.zeros((1, 1, 1, 128), np.int32)
    one = np.ones(1, np.int32)
    with pytest.raises(AssertionError):
        jax_decode(comp, one, z, z, passes=1, comp_rows=32, out_rows=100)
    with pytest.raises(btt.StatusError):
        port_decode(comp, one, z, z, passes=1, comp_rows=32, out_rows=100)
    comp = np.zeros((1, 40, 128), np.uint8)
    with pytest.raises(AssertionError):
        jax_decode(comp, one, z, z, passes=1, comp_rows=40, out_rows=128)
    with pytest.raises(btt.StatusError):
        port_decode(comp, one, z, z, passes=1, comp_rows=40, out_rows=128)


def test_refuses_a_device_without_kernel():
    comp = torch.zeros((1, 32, 128), dtype=torch.uint8, device="meta")
    z = torch.zeros((1, 1, 1, 128), dtype=torch.int32, device="meta")
    with pytest.raises(btt.StatusError):
        tdp.decode_blocks_planned(comp, torch.ones(1, dtype=torch.int32, device="meta"), z, z,
                                  passes=1, comp_rows=32, out_rows=128)


@pytest.mark.parametrize("block", [16 * 1024, 128 * 1024])
@pytest.mark.parametrize("corpus", ["bench", "text"])
def test_planner_comp_passes_read_no_out_row(corpus, block):
    # pack_plan rebases only passes >= p0 into the out region, so under the
    # anchor rule the first p0 passes of every block read comp rows only:
    # the kernel runs them without barriers.
    src = (make_corpus if corpus == "bench" else make_text_corpus)(4)
    datas = [src[i * block:(i + 1) * block] for i in range(min(8, len(src) // block))]
    wire = tdp.plan_blocks(datas, block, 160)
    reads = tdp.pass_reads_plane(t(wire["se"]), t(wire["shift"]), comp_rows=wire["comp_rows"],
                                 out_rows=block // 128)
    for j, (p0, pu) in enumerate(zip(wire["p0"], wire["p_used"])):
        assert not reads[j, :p0].any(), f"block {j}: a comp pass reads the out plane"
    assert (wire["p0"] > 0).all() and any(reads[j, p0:pu].any()
                                          for j, (p0, pu) in enumerate(zip(wire["p0"],
                                                                           wire["p_used"])))


@pytest.mark.parametrize("reads", ["cccccc", "Pccccc", "cPccPPc"])
def test_class_plans_have_the_classes_asked_for(reads):
    flags = [c == "P" for c in reads]
    for comp_rows, out_rows in ((32, 128), (2048, 512), (64, 1024)):
        comp, p_used, se, shift = tdp.class_plans(3, 7, flags, comp_rows, out_rows)
        got = tdp.pass_reads_plane(t(se), t(shift), comp_rows=comp_rows, out_rows=out_rows)
        assert got.tolist() == [flags] * 7
        assert {int(p) for p in p_used} >= {-2, 0, 1, len(flags), len(flags) + 3}
        kw = dict(passes=len(flags), comp_rows=comp_rows, out_rows=out_rows)
        np.testing.assert_array_equal(port_decode(comp, p_used, se, shift, **kw),
                                      jax_decode(comp, p_used, se, shift, **kw))


# The tall route's host-side rules (planes above 1024 rows): the slices a
# plane is cut into, and each slice's stop, the first pass at which one of
# its rows reads an out row.  ``slice_stops`` computes the stops in closed
# form, as the kernel classes a cell; here they are held to the lane-by-lane
# definition, ``pass_reads_plane`` on the plan with every other slice's
# cells emptied, one pass at a time (so the lane tensors stay small).

def stops_by_definition(se, shift, p_used, *, passes, comp_rows, out_rows):
    n, c = se.shape[0], tdp.cluster_ctas(out_rows)
    rows = se.reshape(n, passes, out_rows)
    nk = np.minimum(np.clip(p_used, 0, passes), tdp.MAX_CLASSED)
    want = np.zeros((n, c), np.int32)
    for sl in range(c):
        mine = np.zeros_like(rows)
        mine[..., sl * 1024:(sl + 1) * 1024] = rows[..., sl * 1024:(sl + 1) * 1024]
        mine = mine.reshape(se.shape)
        reads = np.concatenate([tdp.pass_reads_plane(
            t(mine[:, k:k + 1]), t(shift[:, k:k + 1]), comp_rows=comp_rows,
            out_rows=out_rows).numpy() for k in range(passes)], axis=1)
        for i in range(n):
            hit = np.flatnonzero(reads[i, :nk[i]])
            want[i, sl] = hit[0] if hit.size else nk[i]
    return want


def staggered(seed, n, comp_rows, out_rows):
    """``class_plans`` whose plane-reading passes have cells in some slices
    only: slices stop at different passes, and the last one (partial below
    a multiple of 1024 rows) reads the plane first."""
    c = tdp.cluster_ctas(out_rows)
    reads = [False, True, False, True, True, False]
    slices = [None, [c - 1], None, [0], None, None]
    return tdp.class_plans(seed, n, reads, comp_rows, out_rows, slices=slices), len(reads)


@pytest.mark.parametrize("out_rows", [1152, 2048, 8192])
@pytest.mark.parametrize("kind", ["random", "class", "staggered"])
def test_slice_stops_hold_to_pass_reads_plane(kind, out_rows):
    n = 3 if out_rows == 8192 else 6
    if kind == "random":
        passes, comp_rows = 5, 1024
        comp, p_used, se, shift = tdp.random_plans(21, n, passes, comp_rows, out_rows)
    elif kind == "class":
        reads, comp_rows = [False, False, True, False, True], 512
        comp, p_used, se, shift = tdp.class_plans(22, n, reads, comp_rows, out_rows)
        passes = len(reads)
    else:
        comp_rows = 256
        (comp, p_used, se, shift), passes = staggered(23, n, comp_rows, out_rows)
    kw = dict(passes=passes, comp_rows=comp_rows, out_rows=out_rows)
    got = tdp.slice_stops(t(se), t(shift), t(p_used), **kw).numpy()
    want = stops_by_definition(se, shift, p_used, **kw)
    np.testing.assert_array_equal(got, want)
    # A block's least stop is its leading comp-only run: no pass before it
    # reads an out row, and the pass at it does unless it is the last.
    reads = tdp.pass_reads_plane(t(se), t(shift), comp_rows=comp_rows, out_rows=out_rows).numpy()
    npass = np.clip(p_used, 0, passes)
    for i, first in enumerate(got.min(1)):
        assert not reads[i, :first].any()
        assert first == npass[i] or reads[i, first]
    if kind == "staggered":
        live = npass >= 4
        assert (got[live, -1] == 1).all() and (got[live, 0] == 3).all()
        if tdp.cluster_ctas(out_rows) > 2:
            assert (got[live, 1:-1] == 4).all()


@pytest.mark.parametrize("corpus", ["bench", "text"])
def test_slice_stops_on_planner_plans(corpus):
    # 1152-row planes (blocks of 144 KiB): two slices, the second partial.
    # The leading comp-only run is at least the planner's p0 (its first p0
    # passes read comp rows only), and text has blocks past it.
    block = 1152 * 128
    src = (make_corpus if corpus == "bench" else make_text_corpus)(3)
    datas = [src[i * block:(i + 1) * block] for i in range(2)]
    wire = tdp.plan_blocks(datas, block, 256)
    assert wire["fit"] == [0, 1]
    args = [wire[k] for k in ("comp", "p_used", "se", "shift")]
    kw = dict(passes=wire["passes"], comp_rows=wire["comp_rows"], out_rows=1152)
    got = tdp.slice_stops(t(args[2]), t(args[3]), t(args[1]), **kw).numpy()
    np.testing.assert_array_equal(got, stops_by_definition(*args[2:], args[1], **kw))
    assert (got.min(1) >= wire["p0"]).all()
    if corpus == "text":
        assert (got.min(1) < wire["p_used"]).any()
    stops = torch.zeros(got.shape, dtype=torch.int32)
    out = tdp.decode_blocks_planned(*(t(a) for a in args), stops=stops, **kw)
    assert torch.equal(stops, t(got))
    assert [out[j].numpy().tobytes() for j in range(2)] == datas


def test_tall_route_plans_at_1152_rows_match_jax():
    # The last slice of a 1152-row plane holds 128 rows; its plane-reading
    # passes come first (``staggered``).
    (comp, p_used, se, shift), passes = staggered(24, 4, 64, 1152)
    kw = dict(passes=passes, comp_rows=64, out_rows=1152)
    got = port_decode(comp, p_used, se, shift, **kw)
    np.testing.assert_array_equal(got, jax_decode(comp, p_used, se, shift, **kw))
    assert got.any()


def test_cluster_ctas_by_plane_height():
    assert [tdp.cluster_ctas(r) for r in (0, 128, 1024, 1152, 2048, 2176, 5120, 8192, 8320)] \
        == [0, 1, 1, 2, 2, 3, 5, 8, 0]


def test_stops_are_taken_for_tall_planes_only():
    comp, p_used, se, shift = tdp.random_plans(25, 2, 3, 32, 1024)
    with pytest.raises(btt.StatusError, match="stops"):
        tdp.decode_blocks_planned(t(comp), t(p_used), t(se), t(shift), passes=3, comp_rows=32,
                                  out_rows=1024, stops=torch.zeros((2, 1), dtype=torch.int32))
    comp, p_used, se, shift = tdp.random_plans(25, 2, 3, 32, 2048)
    with pytest.raises(btt.StatusError, match="stops"):
        tdp.decode_blocks_planned(t(comp), t(p_used), t(se), t(shift), passes=3, comp_rows=32,
                                  out_rows=2048, stops=torch.zeros((2, 3), dtype=torch.int32))


def test_slice_stops_with_no_pass():
    z = torch.zeros((2, 0, 9, 128), dtype=torch.int32)
    stops = tdp.slice_stops(z, z, t([3, 0]).int(), passes=0, comp_rows=32, out_rows=1152)
    assert stops.tolist() == [[0, 0], [0, 0]]
