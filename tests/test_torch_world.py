"""The port's multi-card path as far as the CPU can show it: the public
names against the JAX package's, the refusals of an NCCL world or of
``chip_smoke.py --world N`` on too few cards, the weak-scaling and
ring-timeline arithmetic, and the checks the smoke holds a world's ranks
to.  The steps themselves at the four-card phase's block shape run in
``test_torch_parallel.py``; on the cards, in ``test_torch_cuda.py``."""

import dataclasses

import pytest
import torch

import bitar_tpu
import bitar_tpu_torch as btt
import chip_smoke
from bitar_tpu import config as jconfig
from bitar_tpu_torch.cli import multihost_bench
from bitar_tpu_torch.memory.arena import named_device
from bitar_tpu_torch.parallel import dryrun, multihost
from bitar_tpu_torch.parallel.ring import timeline_summary

#: Names the port exports in place of the JAX package's: the capability
#: record is read from a torch.device, not from a JAX platform string.
RENAMED = {"capabilities_for_platform": "capabilities_for_device"}


def test_public_names_match_the_jax_package():
    want = sorted(RENAMED.get(name, name) for name in bitar_tpu.__all__)
    assert sorted(btt.__all__) == want
    for name in btt.__all__:
        assert hasattr(btt, name), name


def test_sharding_config_is_exported_with_the_jax_fields():
    assert dataclasses.asdict(btt.ShardingConfig()) == dataclasses.asdict(
        jconfig.ShardingConfig())
    assert btt.capabilities_for_device(torch.device("cpu")).name == "cpu-reference"


@pytest.mark.parametrize("visible,count,refused", [
    (False, 0, "is_available() is false"),
    (True, 1, "needs 4 CUDA devices, one a rank; 1 visible"),
    (True, 3, "needs 4 CUDA devices, one a rank; 3 visible"),
    (True, 4, None),
    (True, 8, None)])
def test_world_smoke_refuses_fewer_cards_than_ranks(monkeypatch, visible, count, refused):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: visible)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    got = chip_smoke.world_refusal(4)
    assert got == refused if refused is None else refused in got


@pytest.mark.parametrize("count", [0, 1, 3])
def test_world_smoke_prints_no_result_on_too_few_cards(monkeypatch, capsys, count):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr("sys.argv", ["chip_smoke.py", "--world", "4"])
    assert chip_smoke.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "no result" in out.err


def test_world_specs_are_the_bench_shapes():
    steps, skew, tables = chip_smoke.world_specs(4)
    assert steps["nblocks"] == 4 * 1024 and steps["block"] == 128 * 1024
    assert steps["steps"] == ("shuffle", "flat", "ring") and steps["overlap"]
    assert skew["skew_bucket_log"] > 0 and skew["nblocks"] == 4 * 1024
    assert tables["nblocks"] == 4 * chip_smoke.TABLE_STEP_BLOCKS
    assert {s for spec in (steps, skew, tables) for s in spec["steps"]} == set(dryrun.ALL_STEPS)


def fake_rank(rank: int, **over) -> dict:
    r = {"flat": {"live": 4, "exact": True, "seconds": 1e-3},
         "ring": {"live": 4, "exact": True, "seconds": 1e-3}, "ring_equals_flat": True,
         "backend": "nccl", "device": f"cuda:{rank}", "contexts": [rank],
         "device_launches": {"decode_flat": {rank: 2}, "decode_tables": {rank: 1}}}
    r.update(over)
    return r


@pytest.mark.parametrize("fault,message", [
    (None, None),
    ({"backend": "gloo"}, "backend gloo"),
    ({"device": "cuda:0"}, "device cuda:0"),
    ({"contexts": [0, 2]}, "CUDA contexts on cards"),
    ({"ring_equals_flat": False}, "ring != fused step"),
    ({"flat": {"live": 4, "exact": False, "seconds": 1e-3}}, "not bit-exact"),
    ({"device_launches": {"decode_flat": {2: 2, 0: 1}, "decode_tables": {2: 1}}},
     "decode_flat launched on cards"),
    ({"device_launches": {"decode_flat": {2: 2}, "decode_tables": {}}},
     "decode_tables launched on cards")])
def test_world_check_holds_each_rank_to_its_own_card(fault, message):
    res = [[fake_rank(r)] for r in range(4)]
    if fault is None:
        chip_smoke.check_world(res)
        return
    res[2][0].update(fault)
    with pytest.raises(AssertionError, match=message):
        chip_smoke.check_world(res)


@pytest.mark.parametrize("args,want", [
    ((4, 4096, 2.0, 1024, 2.0), 1.0),          # the world's step as long as one rank's
    ((4, 4096, 4.0, 1024, 2.0), 0.5),
    ((4, 4096, 1.0, 1024, 2.0), 2.0),
    ((2, 10, 1.0, 4, 1.0), 1.25),              # shares that differ
    ((1, 8, 3.0, 8, 3.0), 1.0)])
def test_weak_scaling_efficiency(args, want):
    assert multihost_bench.weak_scaling_efficiency(*args) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("exchange_end,spans,decode,overlap,step", [
    (5.0, [(0.0, 1.0), (4.0, 6.0), (6.0, 7.0)], 4.0, 2.0, 7.0),   # round 0 and part of 1 inside
    (0.5, [(1.0, 2.0), (2.0, 3.0)], 2.0, 0.0, 3.0),                # every decode after the rounds
    (0.0, [(0.0, 0.25)], 0.25, 0.0, 0.25),                         # a world of 1: no rounds
    (9.0, [(1.0, 2.0), (3.0, 4.0)], 2.0, 2.0, 4.0)])               # all inside the exchange
def test_ring_timeline_summary(exchange_end, spans, decode, overlap, step):
    got = timeline_summary(exchange_end, spans)
    assert got["exchange_ms"] == exchange_end and got["decode_spans_ms"] == [list(s) for s in spans]
    assert got["decode_ms"] == pytest.approx(decode) and got["overlap_ms"] == pytest.approx(overlap)
    assert got["step_ms"] == step


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
def test_an_nccl_world_refuses_fewer_cards_than_ranks(monkeypatch, device_type):
    # Refused before any rank is spawned; never run on gloo instead.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    spawned = []
    monkeypatch.setattr(dryrun.mp, "get_context", lambda *a: spawned.append(a))
    with pytest.raises(btt.StatusError, match="NCCL world of 4 needs 4 CUDA devices"):
        dryrun.run_world(4, dryrun.steps_program, {}, backend="nccl", device_type=device_type)
    assert spawned == []
    assert dryrun.default_backend(4, "cuda") == "gloo"      # only for callers who name none


def test_nccl_join_refuses_a_machine_without_cuda(tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(btt.StatusError, match="'nccl' needs a CUDA device"):
        multihost.initialize(f"file://{tmp_path}/rendezvous", 1, 0, backend="nccl")
    assert not torch.distributed.is_initialized()


def test_no_cuda_context_without_the_cuda_driver():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the card tests check the contexts there")
    assert multihost.cuda_contexts() == []


def test_a_cuda_device_without_an_index_names_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert named_device(None, "Engine") == torch.device("cuda", 2)
    assert named_device("cuda", "Engine") == torch.device("cuda", 2)
    assert named_device("cuda:1", "Engine") == torch.device("cuda", 1)
    assert named_device("cpu", "Engine") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(btt.StatusError, match="device='cpu'"):
        named_device("cuda", "DeviceArena")


def test_runs_in_turn_in_one_world_report_backend_device_and_launches():
    specs = [{"nblocks": 4, "block": 16 * 1024, "seed": 3, "steps": ("flat", "ring")},
             {"nblocks": 4, "block": 16 * 1024, "seed": 4, "steps": ("sharded", "tables")}]
    res = dryrun.run_world(2, dryrun.steps_in_turn, specs, device_type="cpu", timeout=240.0)
    for runs in res:
        assert len(runs) == 2
        assert runs[0]["ring_equals_flat"] and runs[1]["tables"]["exact"]
        for r in runs:
            assert (r["backend"], r["device"], r["contexts"]) == ("gloo", "cpu", [])
            # The plain versions run on the CPU: no kernel launched anywhere.
            assert r["device_launches"] == {"decode_flat": {}, "decode_tables": {}}
            assert r["launches"] == {"decode_flat": 0, "decode_tables": 0}


def test_nccl_transports_are_read_from_its_debug_files(tmp_path):
    rank0 = ["host:1:1 [0] NCCL INFO Channel 00/0 : 0[0] -> 1[1] via P2P/CUMEM",
             "host:1:1 [0] NCCL INFO Channel 01/0 : 0[0] -> 2[2] via P2P/CUMEM",
             "host:1:1 [0] NCCL INFO   GPU/0 (0) : GPU/1 (1) NVL[40.0] - NVS/0",
             "host:1:1 [0] NCCL INFO Pattern 4, crossNic 0, nChannels 16, bw 40.0, type NVL/PIX",
             "host:1:1 [0] NCCL INFO comm 0x1 rank 0 nRanks 4 - Init COMPLETE"]
    rank1 = ["host:2:2 [1] NCCL INFO Channel 00/0 : 1[1] -> 0[0] via SHM/direct/direct"]
    (tmp_path / "nccl.host.1.log").write_text("\n".join(rank0) + "\n")
    (tmp_path / "nccl.host.2.log").write_text("\n".join(rank1) + "\n")
    counts, lines = chip_smoke.nccl_transports(str(tmp_path))
    assert counts == {"P2P/CUMEM": 2, "SHM/direct/direct": 1}
    assert lines == rank0[:4]                       # one rank's: connections, links, patterns
    assert chip_smoke.nccl_transports(str(tmp_path / "none")) == ({}, [])
