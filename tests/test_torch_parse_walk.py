"""The port's greedy segment parse over precomputed match planes (kernel B6,
``parse_walk_dyn``) against the JAX package's on the CPU.

Inputs are made from a numpy seed and handed to both packages as numpy
arrays; the JAX Pallas kernel runs in interpret mode.  Tolerance 0: the
records are integers.  B4 followed by B6 must give B5's records, in the
port's plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitar_tpu.ops.pallas import lz4_match_dyn as jmd
from bitar_tpu_torch.ops import match_dyn as tmd
from bitar_tpu_torch.status import StatusError

torch.set_num_threads(1)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def check_same(mlen, moff, lengths, *, seg, min_match, wcap):
    want = jmd.parse_walk_dyn(jnp.asarray(mlen), jnp.asarray(moff), jnp.asarray(lengths),
                              seg=seg, min_match=min_match, wcap=wcap, interpret=True)
    got = tmd.parse_walk_dyn(t(mlen), t(moff), t(lengths), seg=seg, min_match=min_match,
                             wcap=wcap)
    for name, g, w in zip("PMO", got[:3], want[:3]):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    return got


def random_planes(rng, n, L, hit=0.2, max_len=48):
    """Sparse random matches: ~``hit`` of positions carry a run up to
    ``max_len`` and an offset in 0..3 (0 is invalid)."""
    on = rng.random((n, L)) < hit
    mlen = np.where(on, rng.integers(1, max_len, (n, L)), 0).astype(np.int32)
    moff = np.where(on, rng.integers(0, 4, (n, L)), 0).astype(np.int32)
    return mlen, moff


@pytest.mark.parametrize("L,seg,wcap", [(2048, 128, 8), (4096, 256, 4), (16384, 1024, 8),
                                        (3072, 256, 3)])
def test_random_planes_match_jax(L, seg, wcap):
    rng = np.random.default_rng(L + seg)
    n = 5
    mlen, moff = random_planes(rng, n, L, hit=0.5, max_len=12)
    lengths = np.array([L, L - 1, L // 2 + 77, 40, 11], np.int32)   # blen below L
    P, _, _, overflow = check_same(mlen, moff, lengths, seg=seg, min_match=6, wcap=wcap)
    assert (P.numpy() >= 0).any(), "some matches are taken"
    assert overflow[0], "dense hits overflow wcap"


def test_overflow_and_moff_zero_in_long_runs():
    # Long runs (every position matches 200 bytes on) whose offsets are 0
    # inside spans; one block so dense with short matches that every segment
    # overflows wcap; one whose only hits lie past blen - 12.
    L, seg = 4096, 256
    n = 3
    mlen = np.zeros((n, L), np.int32)
    moff = np.zeros((n, L), np.int32)
    mlen[0] = 200
    moff[0] = 9
    for lo in range(0, L, 700):
        moff[0, lo:lo + 150] = 0
    mlen[1] = 7
    moff[1] = 1
    mlen[2, L - 40:] = 30
    moff[2, L - 40:] = 5
    lengths = np.array([L, L, L - 20], np.int32)
    P, M, O, overflow = check_same(mlen, moff, lengths, seg=seg, min_match=6, wcap=4)
    assert overflow[1] and not overflow[2]
    assert (O.numpy()[0][P.numpy()[0] >= 0] == 9).all()


@pytest.mark.parametrize("min_match", [0, -3])
def test_lengths_at_most_zero_follow_the_same_rule(min_match):
    # With min_match <= 0 a step may take M <= 0 and move the cursor back.
    rng = np.random.default_rng(31 - min_match)
    n, L, seg = 4, 2048, 128
    mlen = rng.integers(-6, 12, (n, L)).astype(np.int32)
    moff = rng.integers(0, 3, (n, L)).astype(np.int32)
    lengths = np.array([L, 1500, 300, 17], np.int32)
    _, M, _, _ = check_same(mlen, moff, lengths, seg=seg, min_match=min_match, wcap=6)
    assert (M.numpy() <= 0).any()


def test_plain_version_of_b4_then_b6_is_b5():
    # 16 KiB and 128 KiB planes: the detector's offsets, B4's planes walked
    # by B6, against B5's records (seg 1024: power-of-two segment counts).
    rng = np.random.default_rng(3)
    for L in (16384, 131072):
        text = np.frombuffer((b"parse walk equals match walk %d. " % L * (L // 30 + 1))[:L],
                             np.uint8)
        planes = np.stack([text, rng.integers(0, 4, L, np.uint8), np.full(L, 3, np.uint8),
                           rng.integers(0, 256, L, np.uint8)])
        x = t(planes)
        offs, _ = tmd.detect_offsets(x, k=4, max_off=min(0xFFFF, L - 128))
        offs = offs.contiguous()
        noff = (offs > 0).sum(dim=1).int()
        lengths = t(np.array([L, L - 100, L, L // 3], np.int32))
        nrows = L // 128
        mlen, moff = tmd.find_matches_dyn(x.view(4, nrows, 128), noff, offs, nrows=nrows,
                                          max_match=1024)
        b6 = tmd.parse_walk_dyn(mlen.reshape(4, L), moff.reshape(4, L), lengths, seg=1024,
                                min_match=6, wcap=8)
        b5 = tmd.find_matches_parse_dyn(x.view(4, nrows, 128), noff, offs, lengths,
                                        nrows=nrows, seg=1024, min_match=6, wcap=8,
                                        max_match=1024)
        for g, w in zip(b6, b5):
            assert torch.equal(g, w)
        assert (b5[0] >= 0).sum() > 0


@pytest.mark.parametrize("L,seg", [(4096, 300), (131072 * 2, 1024)])
def test_rejects_what_jax_rejects(L, seg):
    mlen = np.zeros((1, L), np.int32)
    lengths = np.array([L], np.int32)
    with pytest.raises(ValueError):
        jmd.parse_walk_dyn(jnp.asarray(mlen), jnp.asarray(mlen), jnp.asarray(lengths),
                           seg=seg, min_match=6, wcap=8, interpret=True)
    with pytest.raises(ValueError):
        tmd.parse_walk_dyn(t(mlen), t(mlen), t(lengths), seg=seg, min_match=6, wcap=8)


def test_refuses_a_device_without_kernel():
    import bitar_tpu_torch as btt

    z = torch.zeros((1, 256), dtype=torch.int32, device="meta")
    with pytest.raises(btt.StatusError):
        tmd.parse_walk_dyn(z, z, torch.zeros(1, dtype=torch.int32, device="meta"), seg=128,
                           min_match=6, wcap=2)


@pytest.mark.parametrize("wcap", [0, 1, 8])
@pytest.mark.parametrize("seg", [128, 1024, 2048])
def test_walk_edge_batch_matches_jax(seg, wcap):
    # ``match_dyn.walk_edge_batch``: cursors landing on 32- and 128-position
    # boundaries and on seg, moff 0 at the first mlen-valid position of a
    # chunk, segments wholly past the block, a scan end inside a 16-byte load.
    mlen, moff, lengths = tmd.walk_edge_batch(seg)
    P, _, _, overflow = check_same(mlen, moff, lengths, seg=seg, min_match=6, wcap=wcap)
    if wcap:
        assert (P.numpy()[0] >= 0).sum() >= 8, "row 0's matches are taken"
    assert bool(overflow[4]) and not bool(overflow[3]) and not bool(overflow[7])


@pytest.mark.parametrize("wcap", [-1, 2])
def test_parse_walk_dyn_has_no_kernel_for_other_devices(wcap):
    # The device check comes first and builds its message only on failure.
    z = torch.zeros((2, 256), dtype=torch.int32, device="meta")
    lengths = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(StatusError, match="parse_walk_dyn: no kernel for device meta"):
        tmd.parse_walk_dyn(z, z, lengths, seg=128, min_match=6, wcap=wcap)
