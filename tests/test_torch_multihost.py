"""The port's multi-process topology (``bitar_tpu_torch.parallel.multihost``):
two real processes join one gloo world through a ``file://`` rendezvous and
report ``initialize``, ``describe``, ``partition_blocks`` and
``process_spans``, checked against the JAX package's numpy results."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from bitar_tpu.parallel import multihost as jmh
from bitar_tpu_torch.parallel import multihost as tmh

ROOT = Path(__file__).resolve().parent.parent
#: Seconds a child may take to join its world (its group's timeout).
JOIN_TIMEOUT = 60
#: Seconds the test waits for all its children together: longer than a
#: child's join, so a stuck rendezvous ends in the child with its own error.
WAIT = 100

_WORKER = r"""
import json, sys
import torch.distributed as dist
from bitar_tpu_torch.parallel import multihost
init, world, rank, timeout = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4])
topo = multihost.initialize(init, world, rank, backend="gloo", timeout=timeout)
again = multihost.initialize(init, world, rank, backend="gloo", timeout=timeout)
print(json.dumps({"topo": topo, "again": again,
                  "mine": list(multihost.partition_blocks(1001)),
                  "spans": multihost.process_spans(1001).tolist()}))
dist.destroy_process_group()
"""


def run_ranks(tmp_path, world: int, ranks, timeout: float = JOIN_TIMEOUT) -> list:
    """Start ``_WORKER`` for each of ``ranks`` of a gloo world of ``world``
    (a fresh ``file://`` rendezvous) and wait for all of them within
    :data:`WAIT` seconds; returns (returncode, stdout, stderr) per rank.
    Every child is killed before it returns."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    init = f"file://{tmp_path}/rendezvous"
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, init, str(world), str(r),
                               str(timeout)], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in ranks]
    deadline = time.monotonic() + WAIT
    res = []
    try:
        for p in procs:
            try:
                so, se = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                so, se = p.communicate()
                se += f"\n[killed: the ranks did not end within {WAIT} s]"
            res.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(5)
    return res


def report(res) -> str:
    return "\n".join(f"--- rank {r}: exit {rc}\n{se[-2000:]}" for r, (rc, _, se) in enumerate(res))


def test_two_processes_join_one_world(tmp_path):
    res = run_ranks(tmp_path, 2, range(2))
    assert all(rc == 0 for rc, _, _ in res), report(res)
    outs = [json.loads(so.strip().splitlines()[-1]) for _, so, _ in res]
    want_spans = jmh.process_spans(1001, 2)
    for rank, o in enumerate(outs):
        topo = o["topo"]
        assert topo == o["again"]
        assert (topo["process_index"], topo["process_count"], topo["global_device_count"],
                topo["backend"]) == (rank, 2, 2, "gloo")
        assert tuple(o["mine"]) == jmh.partition_blocks(1001, 2, rank)
        np.testing.assert_array_equal(np.array(o["spans"]), want_spans)


def test_a_rank_whose_peer_never_joins_fails_within_its_timeout(tmp_path):
    # Rank 0 of a world of 2 alone: the join ends with the group's timeout.
    t0 = time.monotonic()
    (rc, _, se), = run_ranks(tmp_path, 2, [0], timeout=3)
    assert rc != 0, se[-2000:]
    assert time.monotonic() - t0 < WAIT, se[-2000:]
    assert "timeout" in se.lower() or "timed out" in se.lower(), se[-2000:]


def test_single_process_joins_nothing(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    topo = tmh.initialize()
    assert (topo["process_index"], topo["process_count"], topo["backend"]) == (0, 1, None)
    assert tmh.partition_blocks(10) == jmh.partition_blocks(10, 1, 0) == (0, 10)


@pytest.mark.parametrize("nblocks,pc", [(0, 3), (7, 3), (1024, 8), (5, 8)])
def test_spans_match_jax(nblocks, pc):
    np.testing.assert_array_equal(tmh.process_spans(nblocks, pc), jmh.process_spans(nblocks, pc))
    for i in range(pc):
        assert tmh.partition_blocks(nblocks, pc, i) == jmh.partition_blocks(nblocks, pc, i)


def test_partition_rejects_a_process_outside_the_world():
    import bitar_tpu_torch as btt

    with pytest.raises(btt.StatusError):
        tmh.partition_blocks(10, 2, 2)
    with pytest.raises(btt.StatusError):
        tmh.initialize(f"file:///nonexistent/{os.getpid()}", 2, 0, backend="mpi")
