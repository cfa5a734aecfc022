"""The card's peak rates and the roofline count of the decode.

The count is the work whatever implements it: the stored bytes of the
blocks decoded, read once, plus the raw bytes they decode to, written once.
It leaves out the plan wire, slot padding and full output planes, which
are the implementation's choices (``chip_smoke.py``'s ``decode_bound``
counts them, so its bound is larger than this one).
"""

from __future__ import annotations

#: Device-memory bytes a second, by a substring of ``torch.cuda.get_device_name()``.
#: NVIDIA's data sheet for the H100 SXM (HBM3) at its 700 W limit.
HBM_PEAKS = (("H100 80GB HBM3", 3.35e12),)


def hbm_peak(kind: str) -> float | None:
    """The card's memory rate, or None for a card the table lacks."""
    for name, rate in HBM_PEAKS:
        if name in kind:
            return rate
    return None


def decode_bytes(stored_bytes: int, raw_bytes: int) -> int:
    """Bytes the decode of blocks must move at least: read stored, write raw."""
    return stored_bytes + raw_bytes


def share_pct(nbytes: float, seconds: float, kind: str) -> float | None:
    """The least time ``nbytes`` take at the card's peak, as a share of
    ``seconds`` in %; None where nothing was timed or the card is unknown."""
    peak = hbm_peak(kind)
    if peak is None or seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / peak / seconds
