"""The port's multi-process topology (``bitar_tpu_torch.parallel.multihost``):
two real processes join one gloo world through a ``file://`` rendezvous and
report ``initialize``, ``describe``, ``partition_blocks`` and
``process_spans``, checked against the JAX package's numpy results."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bitar_tpu.parallel import multihost as jmh
from bitar_tpu_torch.parallel import multihost as tmh

ROOT = Path(__file__).resolve().parent.parent

_WORKER = r"""
import json, sys
import torch.distributed as dist
from bitar_tpu_torch.parallel import multihost
init, rank = sys.argv[1], int(sys.argv[2])
topo = multihost.initialize(init, 2, rank, backend="gloo")
again = multihost.initialize(init, 2, rank, backend="gloo")
print(json.dumps({"topo": topo, "again": again,
                  "mine": list(multihost.partition_blocks(1001)),
                  "spans": multihost.process_spans(1001).tolist()}))
dist.destroy_process_group()
"""


def test_two_processes_join_one_world(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    init = f"file://{tmp_path}/rendezvous"
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, init, str(r)], cwd=str(ROOT),
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=120)
            assert p.returncode == 0, se[-2000:]
            outs.append(json.loads(so.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(5)
    want_spans = jmh.process_spans(1001, 2)
    for rank, o in enumerate(outs):
        topo = o["topo"]
        assert topo == o["again"]
        assert (topo["process_index"], topo["process_count"], topo["global_device_count"],
                topo["backend"]) == (rank, 2, 2, "gloo")
        assert tuple(o["mine"]) == jmh.partition_blocks(1001, 2, rank)
        np.testing.assert_array_equal(np.array(o["spans"]), want_spans)


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
