"""The port's offset detectors and the plain versions of kernels B5 and B4
against the JAX package on the CPU.

Inputs are made from a numpy seed and handed to both packages as numpy
arrays; the JAX Pallas kernels run in interpret mode.  Tolerance 0: offsets,
run lengths and parse records are integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import bitar_tpu_torch as btt
from bitar_tpu.ops.pallas import lz4_match_dyn as jmd
from bitar_tpu_torch.ops import match_dyn as tmd

# Test files run in several worker processes at once: a single intra-op
# thread keeps torch's CPU pool from oversubscribing the cores.
torch.set_num_threads(1)


def blocks(L: int, seed: int = 5) -> np.ndarray:
    """[6, L] uint8: periodic text, RLE, random, low-entropy, a tiled
    1338-byte pattern, and random bytes ending in a run that reaches the
    plane end."""
    rng = np.random.default_rng(seed)
    tail = rng.integers(0, 256, L, np.uint8)
    tail[L - 700:] = 0x41
    return np.stack([
        np.frombuffer((b"The quick brown fox jumps over the lazy dog 7. "
                       * (L // 47 + 1))[:L], np.uint8),
        np.full(L, 7, np.uint8),
        rng.integers(0, 256, L, np.uint8),
        rng.integers(0, 4, L, np.uint8),
        np.tile(rng.integers(32, 127, 1338, np.uint8), L // 1338 + 1)[:L],
        tail,
    ])


def hand_offsets(planes: np.ndarray):
    """(noff, offs [N, 4]): the detector's offsets, edited so that the batch
    has a block with noff = 0, one with duplicate offsets, one with an
    offset 0 among its first noff, and one whose runs all reach the end."""
    offs = np.asarray(jmd.detect_offsets(jnp.asarray(planes))[0]).copy()
    offs[1] = [1, 2, 3, 0]             # RLE: every run reaches the plane end
    offs[2] = 0                        # random: noff = 0
    offs[3] = [offs[3, 0] or 5, offs[3, 0] or 5, 2, 0]     # duplicates
    offs[5] = [1, 0, 300, 0]           # a 0 inside the first noff
    noff = np.array([(offs[0] > 0).sum(), 3, 0, 3, (offs[4] > 0).sum(), 3], np.int32)
    return noff, offs.astype(np.int32)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("L", [4096, 16384])
def test_detect_offsets_matches_jax(L):
    planes = blocks(L)
    jo, jc = jmd.detect_offsets(jnp.asarray(planes))
    to, tc = tmd.detect_offsets(t(planes))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (to.numpy()[[0, 4]] > 0).any(), "periodic blocks detect an offset"


def test_detect_offsets_tied_scores_keep_lowest_delta_first():
    # Periods of 3 and 5 samples over 127 and 129 samples: both deltas
    # (192 and 320) are seen 124 times.  lax.top_k puts the lower index of
    # the sorted delta row first; so must the port.
    rng = np.random.default_rng(9)
    a = np.tile(rng.integers(0, 256, 192, np.uint8), 43)[:127 * 64]
    b = np.tile(rng.integers(0, 256, 320, np.uint8), 26)[:129 * 64]
    planes = np.concatenate([a, b])[None]
    jo, jc = jmd.detect_offsets(jnp.asarray(planes), k=2)
    to, tc = tmd.detect_offsets(t(planes), k=2)
    assert np.asarray(jc)[0, 0] == np.asarray(jc)[0, 1] > 0, "the scores must tie"
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert to.numpy()[0].tolist() == [192, 320]


def test_topk_tie_order_matches_lax():
    score = np.random.default_rng(3).integers(0, 4, (16, 64)).astype(np.int32)
    jv, ji = lax.top_k(jnp.asarray(score), 6)
    tv, ti = tmd._topk_lowest_index(t(score), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_detect_offsets_fft_separated_peaks():
    # A pattern tiled over the first 12000 bytes of random data: the
    # autocorrelation peaks at p, 2p, 3p fall by ~p/12000 each, far more
    # than float32 rounding, so both FFTs must pick the same two lags.
    # (The circular autocorrelation is symmetric, ac[p] == ac[L - p]: a
    # window below L/2 keeps the mirror peaks out.)
    L = 16384
    rng = np.random.default_rng(11)
    planes = rng.integers(0, 256, (4, L), np.uint8)
    for b, p in enumerate((1338, 517, 3001, 47)):
        planes[b, :12000] = np.tile(rng.integers(0, 256, p, np.uint8), 12000 // p + 1)[:12000]
    _, js = jmd.detect_offsets_fft(jnp.asarray(planes), k=3, max_off=8000)
    js = np.asarray(js)
    assert (np.diff(-js, axis=1) / js[:, :1] > 1e-3).all(), "peaks must stand apart"
    jo, js = jmd.detect_offsets_fft(jnp.asarray(planes), k=2, max_off=8000)
    to, ts = tmd.detect_offsets_fft(t(planes), k=2, max_off=8000)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert to.numpy()[:3, 0].tolist() == [1338, 517, 3001]
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4)   # float32 FFTs


def linear_best(x: np.ndarray, noff: np.ndarray, offs: np.ndarray, max_match: int):
    """The kernels' definition, written out: the linear run of x[p] ==
    x[p - d] (p >= d) from each p, capped; the first strictly longest wins;
    d = 0 matches everywhere."""
    n, L = x.shape
    run_best = np.zeros((n, L), np.int64)
    off_best = np.zeros((n, L), np.int64)
    for b in range(n):
        for k in range(noff[b]):
            d = int(offs[b, k])
            run = np.zeros(L + 1, np.int64)
            for p in range(L - 1, -1, -1):
                if d == 0 or (p >= d and x[b, p] == x[b, p - d]):
                    run[p] = run[p + 1] + 1
            run = np.minimum(run[:L], max_match) if d else np.full(L, max_match)
            better = run > run_best[b]
            run_best[b] = np.where(better, run, run_best[b])
            off_best[b] = np.where(better, d, off_best[b])
    return run_best, off_best


def test_cyclic_doubling_equals_linear_runs():
    # The reference doubles runs over a cyclic plane; the CUDA kernels count
    # linear runs.  Position 0 never matches for d >= 1, so a run that
    # reaches the plane end stops there in both, and the chosen offsets
    # agree too (blocks 1 and 5 end in runs that reach the end).
    L = 2048
    planes = blocks(L)
    noff, offs = hand_offsets(planes)
    for mm in (64, 1024):
        run, off = tmd.match_dyn_reference(t(planes), t(noff), t(offs), max_match=mm)
        want_run, want_off = linear_best(planes, noff, offs, mm)
        np.testing.assert_array_equal(run.numpy(), want_run)
        np.testing.assert_array_equal(off.numpy(), want_off)


def hand_batch(L: int):
    """(planes, noff, offs, lengths) of :func:`blocks` with :func:`hand_offsets`."""
    planes = blocks(L)
    noff, offs = hand_offsets(planes)
    return planes, noff, offs, np.array([L, L, L, L - 1000, L - 37, L], np.int32)


def edge_batch(L: int):
    """One block of each kind of ``edge_batch``: ``noff = 0`` among live
    blocks, two offsets running through a segment end where the later one
    runs further (short and long runs), ten offsets with a 0 and offsets
    above half the plane up to L - 128, text through every tile, RLE."""
    return tmd.edge_batch(L, 7, seed=L)


BATCHES = {"hand": hand_batch, "edge": edge_batch}


def walk_case(L, seg, wcap, mm, batch):
    case = (L, seg, wcap, mm, batch)
    return pytest.param(*case, id="-".join(map(str, case if batch == "edge" else case[:4])))


@pytest.mark.parametrize("L,seg,wcap,mm,batch", [
    walk_case(16384, 1024, 8, 1024, "hand"), walk_case(4096, 1024, 2, 16, "hand"),
    walk_case(8192, 512, 8, 512, "hand"), walk_case(16384, 1024, 8, 1024, "edge"),
    walk_case(16384, 2048, 8, 64, "edge"), walk_case(8192, 512, 2, 512, "edge")])
def test_walk_plain_matches_jax(L, seg, wcap, mm, batch):
    planes, noff, offs, lens = BATCHES[batch](L)
    n = planes.shape[0]
    kw = dict(nrows=L // 128, seg=seg, min_match=6, wcap=wcap, max_match=mm)
    want = jmd.find_matches_parse_dyn(jnp.asarray(planes.reshape(n, -1, 128)),
                                      jnp.asarray(noff), jnp.asarray(offs),
                                      jnp.asarray(lens), interpret=True, **kw)
    got = tmd.find_matches_parse_dyn(t(planes.reshape(n, -1, 128)), t(noff), t(offs),
                                     t(lens), **kw)
    for name, g, w in zip("PMO", got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert (got[0].numpy() >= 0).any()
    if wcap == 2 and batch == "hand":
        assert got[3].numpy().any(), "a two-slot cap must overflow somewhere"
    if batch == "edge":
        P, O = got[0].numpy(), got[2].numpy()
        assert (P[0] == -1).all(), "a block with noff = 0 records nothing"
        if mm > 300:
            # Both runs pass the segment end at L/2, truncated to the same
            # length there; the later slot's longer run decides the offset.
            at = P[1] == L // 2 - 20
            assert at.sum() == 1 and O[1][at][0] == 3536


@pytest.mark.parametrize("max_match,batch", [
    pytest.param(64, "hand", id="64"), pytest.param(256, "hand", id="256"),
    pytest.param(256, "edge", id="edge-256"), pytest.param(2047, "edge", id="edge-2047")])
def test_dyn_plain_matches_jax(max_match, batch):
    L = 8192
    planes, noff, offs, _ = BATCHES[batch](L)
    n = planes.shape[0]
    want = jmd.find_matches_dyn(jnp.asarray(planes.reshape(n, -1, 128)), jnp.asarray(noff),
                                jnp.asarray(offs), nrows=L // 128, max_match=max_match,
                                interpret=True)
    got = tmd.find_matches_dyn(t(planes.reshape(n, -1, 128)), t(noff), t(offs),
                               nrows=L // 128, max_match=max_match)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if batch == "edge":
        moff = got[1].numpy().reshape(n, L)
        assert (moff[0] == 0).all(), "a block with noff = 0 scores nothing"
        assert (moff[4] == L - 128).sum() == 128, "the offset L - 128 wins at the plane's end"
        assert (moff[4] == L // 2 + 64).any(), "an offset above half the plane wins"
        assert moff[1, L // 2 - 20] == 3536, "the longer run past the tile end decides"


def test_wrappers_refuse_a_device_without_kernel():
    # Only CPU tensors take the plain version; any other device launches
    # the kernel or raises, never falls back.
    x = torch.zeros((1, 8, 128), dtype=torch.uint8, device="meta")
    z = torch.zeros(1, dtype=torch.int32, device="meta")
    o = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(btt.StatusError):
        tmd.find_matches_parse_dyn(x, z, o, z, nrows=8, seg=1024, min_match=6)
    with pytest.raises(btt.StatusError):
        tmd.find_matches_dyn(x, z, o, nrows=8)
