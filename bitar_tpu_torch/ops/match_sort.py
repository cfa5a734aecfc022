"""Arbitrary-offset match hints by a sort, for the ``"tpu-sort"`` matcher.

Counterpart of ``bitar_tpu/ops/pallas/lz4_match_sort.py``, which is XLA
(``lax.sort``), not a Pallas kernel: here it is ``torch.sort``.  Every
position's 4-byte prefix, with the block's bytes rolled so that the prefix
wraps at the block end as the reference's ``jnp.roll`` does, is sorted with
its position as one int64 key; a position's left neighbour with the same
prefix is its most recent earlier occurrence.  The host emitter verifies
and extends every hint, so a hint across the wrap cannot corrupt a stream.
"""

from __future__ import annotations

import torch


def find_matches_sorted(blocks: torch.Tensor, *, length: int) -> torch.Tensor:
    """Most recent earlier 4-byte match offset per position.

    ``blocks``: [N, length] uint8.  Returns [N, length] int32: ``p - q`` for
    the largest ``q < p`` whose 4-byte prefix equals position ``p``'s, 0 where
    there is none."""
    n = blocks.shape[0]
    b = blocks.reshape(n, length).long()
    v = (b | (torch.roll(b, -1, dims=1) << 8) | (torch.roll(b, -2, dims=1) << 16)
         | (torch.roll(b, -3, dims=1) << 24))
    pos = torch.arange(length, device=blocks.device)
    # (prefix - 2^31) keeps the prefix's unsigned order in the signed key.
    key = ((v - (1 << 31)) << 32) | pos
    sk = torch.sort(key, dim=1).values
    sv, sp = sk >> 32, sk & 0xFFFFFFFF
    off = torch.zeros_like(sp)
    off[:, 1:] = torch.where(sv[:, 1:] == sv[:, :-1], sp[:, 1:] - sp[:, :-1], 0)
    return torch.zeros((n, length), dtype=torch.int32, device=blocks.device).scatter_(
        1, sp, off.int())
