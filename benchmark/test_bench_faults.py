"""Each cell's check catches the faults its timed path can have.

A run of the cell's loop on the CPU, the card's look skipped, with the
program broken underneath: a step that returns its state unchanged, half of
the batch left out, the exchange between ranks left out, an answer altered
where it is produced.  Each must come out ``correct`` false.  The shuffle's
faults go into each spawned rank through the context's ``hook``; its input is
the same every step, so a step returning its last state is no fault there.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness
from bitar_tpu_torch.engine.device import Engine

_decompress_device = Engine.decompress_device
_decompress = Engine.decompress
_compress = Engine.compress


def _stale_device(self, unit, on_burst=None):
    """Every scan returns the planes of the first unit it decoded."""
    if not hasattr(self, "_stale"):
        self._stale = _decompress_device(self, unit, on_burst)
    return self._stale


def _half_device(self, unit, on_burst=None):
    out = _decompress_device(self, unit, on_burst)
    for p in out:
        p[p.shape[0] // 2:] = 0
    return out


def _flip_device(self, unit, on_burst=None):
    out = _decompress_device(self, unit, on_burst)
    out[0][0, 0, 0] ^= 1
    return out


def _stale_read(self, unit, out=None):
    """The caller's buffer comes back as it was."""
    return out[:unit.manifest.total_raw]


def _half_read(self, unit, out=None):
    got = _decompress(self, unit, out)
    got[int(unit.manifest.raw_off[unit.nblocks // 2]):] = 0
    return got


def _flip_read(self, unit, out=None):
    got = _decompress(self, unit, out)
    got[0] ^= 1
    return got


def _stale_compress(self, data, sizes=None):
    """Every ingest stores the first unit it was given."""
    if not hasattr(self, "_first"):
        self._first = np.array(data, copy=True)
    return _compress(self, self._first, sizes)


def _half_compress(self, data, sizes=None):
    d = np.array(data, copy=True)
    d[d.size // 2:] = 0
    return _compress(self, d, sizes)


def _flip_compress(self, data, sizes=None):
    d = np.array(data, copy=True)
    d[0] ^= 1
    return _compress(self, d, sizes)


FAULTS = {
    "lz4-128k.scan": {"decompress_device": (_stale_device, _half_device, _flip_device)},
    "lz4-skewed.read": {"decompress": (_stale_read, _half_read, _flip_read)},
    "lz4-128k.ingest": {"compress": (_stale_compress, _half_compress, _flip_compress)},
}


@pytest.mark.parametrize("workload,method,fault", [
    (w, m, f) for w, by in FAULTS.items() for m, fs in by.items() for f in fs],
    ids=lambda v: getattr(v, "__name__", str(v)))
def test_fault_makes_the_run_incorrect(monkeypatch, tiny, workload, method, fault):
    spec, ctx = tiny(workload, seconds=0.5)
    monkeypatch.setattr(Engine, method, fault)
    _, line = harness.run_cell(spec, ctx)
    assert line["correct"] is False, line["checks"]


# --- the shuffle's faults, applied in each rank -------------------------------

def no_exchange():
    """The all-to-all leaves every rank with what it staged."""
    from bitar_tpu_torch.parallel import pipeline

    pipeline.all_to_all_rows = lambda staged, group: staged.clone()


def half_decoded():
    from bitar_tpu_torch.parallel import pipeline

    real = pipeline.decode_blocks_flat

    def half(recv, plans, **kw):
        out = real(recv, plans, **kw)
        out[out.shape[0] // 2:] = 0
        return out

    pipeline.decode_blocks_flat = half


def flipped_byte():
    from bitar_tpu_torch.parallel import pipeline

    real = pipeline.decode_blocks_flat

    def flip(recv, plans, **kw):
        out = real(recv, plans, **kw)
        out.view(torch.uint8).reshape(-1)[0] ^= 1
        return out

    pipeline.decode_blocks_flat = flip


@pytest.mark.parametrize("hook", [no_exchange, half_decoded, flipped_byte],
                         ids=lambda f: f.__name__)
def test_shuffle_fault_makes_the_run_incorrect(tiny, hook):
    spec, ctx = tiny("lz4-128k-x4.shuffle", seconds=0.5, hook=hook)
    _, line = harness.run_cell(spec, ctx)
    assert line["correct"] is False, line["checks"]
