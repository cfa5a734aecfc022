"""The port's multi-device layer (``bitar_tpu_torch.parallel``) against the
JAX package's ``bitar_tpu.parallel`` on the CPU.

The numpy parts (hash partition, shuffle plans, wire and table preps) must
give the JAX package's arrays.  The steps run in gloo worlds of 1, 2 and 4
spawned ranks (``file://`` rendezvous in a temporary directory, a time limit
on every wait, children killed on failure); every live row must equal the
JAX step's at the same D on the virtual CPU mesh (Pallas in interpret mode)
and the raw bytes.  Tolerance 0: these are bytes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitar_tpu_torch as btt
from bitar_tpu import config as jconfig
from bitar_tpu.ops.pallas import layout
from bitar_tpu.parallel import pipeline as jpipe
from bitar_tpu.parallel import ring as jring
from bitar_tpu.parallel import sharding as jshd
from bitar_tpu.parallel import shuffle as jshf
from bitar_tpu_torch import config as tconfig
from bitar_tpu_torch import parallel as tpar
from bitar_tpu_torch.ops import decode_tables as tdt
from bitar_tpu_torch.parallel import dryrun, multihost
from bitar_tpu_torch.parallel import pipeline as tpipe
from bitar_tpu_torch.utils.corpus import make_corpus

torch.set_num_threads(1)

BLOCK = 16 * 1024
NROWS = BLOCK // 128
WORLD_TIMEOUT = 240.0


def test_public_names_match_jax():
    import bitar_tpu.parallel as jpar

    assert sorted(tpar.__all__) == sorted(jpar.__all__)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_hash_partition_matches_jax(d):
    ids = np.arange(5000)
    np.testing.assert_array_equal(tpar.hash_partition(ids, d), jshf.hash_partition(ids, d))


@pytest.mark.parametrize("case", ["no sizes", "sizes", "skew buckets", "no balance"])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_plan_shuffle_matches_jax(case, d):
    rng = np.random.default_rng(d)
    n = 24 * d
    sizes = rng.integers(1, 1 << 17, n).astype(np.int64)
    kw = {"no sizes": {}, "sizes": {"sizes": sizes}, "no balance": {"balance": False},
          "skew buckets": {"sizes": sizes}}[case]
    tkw, jkw = dict(kw), dict(kw)
    if case == "skew buckets":
        tkw["config"] = tconfig.ShardingConfig(skew_bucket_log=1)
        jkw["config"] = jconfig.ShardingConfig(skew_bucket_log=1)
    got, want = tpar.plan_shuffle(n, d, **tkw), jshf.plan_shuffle(n, d, **jkw)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), f.name)
    assert got.wire_rows == want.wire_rows


def test_plan_shuffle_refuses_unpadded_counts():
    with pytest.raises(btt.StatusError):
        tpar.plan_shuffle(7, 2)
    assert tpar.pad_block_count(7, 2) == jshd.pad_block_count(7, 2) == 8


def test_sharding_config_matches_jax():
    assert dataclasses.asdict(tconfig.ShardingConfig()) == \
        dataclasses.asdict(jconfig.ShardingConfig())


@pytest.fixture(scope="module")
def batch8():
    return dryrun.make_batch(8, BLOCK, seed=1)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_wire_preps_match_jax(batch8, d):
    plan = tpar.plan_shuffle(8, d, sizes=batch8["lens"].astype(np.int64))
    for prep, jprep in ((tpar.prepare_flat_wires_for_recv, jpipe.prepare_flat_wires_for_recv),
                        (tpar.prepare_ring_flat_wires_for_recv,
                         jpipe.prepare_ring_flat_wires_for_recv)):
        got = prep(plan, *batch8["plan"], NROWS)
        want = jprep(plan, *batch8["plan"], NROWS)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], k)
    padded, nseq = tdt.pad_tables(batch8["tables"], tpipe._TABLE_KEYS)
    got = tpar.reorder_tables_for_recv(plan, padded, nseq)
    want = jpipe.reorder_tables_for_recv(plan, padded, nseq)
    np.testing.assert_array_equal(got[1], want[1])
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k], k)


def test_prepare_sharded_batch_keeps_the_jax_bytes(batch8):
    slot = batch8["rows"].shape[1]
    got, real_n, meta = tpar.prepare_sharded_batch(batch8["comps"], batch8["tables"], BLOCK,
                                                   slot, 3)
    want, jreal_n, jmeta = jshd.prepare_sharded_batch(batch8["comps"], batch8["tables"], BLOCK,
                                                      slot, 3)
    assert real_n == jreal_n and got["comp"].shape == (9, slot)
    assert got["comp"].dtype == np.uint8
    np.testing.assert_array_equal(got["comp"],
                                  want["comp"][:, :slot // 128].reshape(9, slot))
    for k in ("nseq", *tpipe._TABLE_KEYS):
        np.testing.assert_array_equal(got[k], want[k], k)
    assert meta["seq_cap"] == jmeta["seq_cap"] and meta["out_rows"] == NROWS


def jax_steps(batch, d, block=BLOCK):
    """The JAX package's steps at D = d on the virtual CPU mesh: global
    [D * D*rpp, ...] outputs by destination."""
    nrows = block // 128
    mesh = jshd.make_mesh(d)
    rows, comp_rows, n = batch["rows"], batch["comp_rows"], len(batch["datas"])
    plan = jshf.plan_shuffle(n, d, sizes=batch["lens"].astype(np.int64))
    per_src = n // d
    common = (jnp.asarray(rows),
              jnp.asarray((plan.send_order % per_src).reshape(d, 1, -1).astype(np.int32)),
              jnp.asarray((plan.send_order >= 0).reshape(d, 1, -1)))
    kw = dict(mesh=mesh, rows_per_pair=plan.rows_per_pair, comp_rows=comp_rows,
              block_size=block, interpret=True)
    out = {"shuffle": np.asarray(jshf.execute_shuffle(mesh, plan, jnp.asarray(rows)))}
    w = jpipe.prepare_flat_wires_for_recv(plan, *batch["plan"], nrows)
    out["flat"] = np.asarray(jpipe.distributed_step_flat(
        *common, *(jnp.asarray(w[k]) for k in tpipe.WIRE_KEYS), **kw))
    w = jpipe.prepare_ring_flat_wires_for_recv(plan, *batch["plan"], nrows)
    out["ring"] = np.asarray(jring.distributed_step_ring_flat(
        *common, *(jnp.asarray(w[k]) for k in tpipe.WIRE_KEYS), **kw))
    full, _, meta = jshd.prepare_sharded_batch(batch["comps"], batch["tables"], block,
                                               rows.shape[1], d)
    out["sharded"] = np.asarray(jshd.sharded_decode(
        full["comp"], full["nseq"], *(full[k] for k in tpipe._TABLE_KEYS), mesh=mesh,
        comp_rows=meta["comp_rows"], out_rows=meta["out_rows"], seq_cap=meta["seq_cap"],
        block_size=block, interpret=True))
    padded, nseq = layout.pad_tables(batch["tables"], tpipe._TABLE_KEYS)
    args, tkw = jpipe.prepare_distributed_step_tables_fallback(mesh, plan, rows, padded, nseq,
                                                               block)
    out["tables"] = np.asarray(jpipe.distributed_step_tables_fallback(*args, **tkw,
                                                                      interpret=True))
    return plan, out


def world_held_to_jax(batch, d: int, spec: dict) -> list:
    """Run every step of ``spec`` (the batch's) in a gloo world of ``d``
    and hold each live row to the JAX step's at the same D and to the raw
    bytes; returns each rank's result."""
    block = spec["block"]
    plan, want = jax_steps(batch, d, block)
    res = dryrun.run_world(d, dryrun.steps_program, dict(spec, return_rows=True),
                           device_type="cpu", timeout=WORLD_TIMEOUT)
    live = plan.recv_block.reshape(-1) >= 0
    for step in dryrun.ALL_STEPS:
        assert all(r[step]["exact"] for r in res), step
        got = np.concatenate([r[step]["rows"] for r in res])
        if step == "shuffle":
            np.testing.assert_array_equal(got, want[step])
        elif step == "sharded":
            np.testing.assert_array_equal(got, want[step][:, :block])
            assert got.tobytes() == b"".join(batch["datas"])
        else:
            np.testing.assert_array_equal(got[live], want[step][live], step)
            for pos in np.flatnonzero(live):
                assert got[pos].tobytes() == batch["datas"][plan.recv_block.reshape(-1)[pos]]
    assert all(r["ring_equals_flat"] for r in res)
    assert sum(r["flat"]["live"] for r in res) == len(batch["datas"])
    return res


@pytest.mark.parametrize("d", [1, 2, 4])
def test_steps_in_a_gloo_world_match_jax(batch8, d):
    world_held_to_jax(batch8, d, {"nblocks": 8, "block": BLOCK, "seed": 1})


def test_steps_at_the_bench_block_in_a_gloo_world_of_4_match_jax():
    # The four-card phase's block shape: the bench corpus in 128 KiB blocks
    # (8 here), four ranks; each reports its backend and device.
    block = 128 * 1024
    batch = dryrun.make_batch(8, block, data=make_corpus(8))
    res = world_held_to_jax(batch, 4, {"corpus": "bench", "nblocks": 8, "block": block})
    assert [(r["backend"], r["device"], r["contexts"]) for r in res] == [("gloo", "cpu", [])] * 4


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    res = dryrun.dryrun_multichip(n, device_type="cpu", timeout=WORLD_TIMEOUT)
    assert len(res) == n
    assert sum(r["flat"]["live"] for r in res) == 2 * n


def test_make_mesh_checks_the_world(tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(btt.StatusError):
        tpar.make_mesh(1)                       # no process group yet
    multihost.initialize(f"file://{tmp_path}/rendezvous", 1, 0, backend="gloo")
    try:
        mesh = tpar.make_mesh(config=tconfig.ShardingConfig(mesh_shape=(1,)), device_type="cpu")
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("blocks",)
        with pytest.raises(btt.StatusError):
            tpar.make_mesh(2, device_type="cpu")
        assert multihost.initialize(f"file://{tmp_path}/other", 1, 0)["process_count"] == 1
        (rows,) = tpar.shard_blocks(mesh, np.arange(6, dtype=np.int32).reshape(3, 2))
        assert rows.device.type == "cpu" and rows.shape == (3, 2)
        with pytest.raises(btt.StatusError, match="CPU mesh"):
            tpar.shard_blocks(mesh, torch.empty(3, 2, device="meta"))   # never moved off a device
    finally:
        torch.distributed.destroy_process_group()


def test_make_mesh_defaults_to_the_card(tmp_path, monkeypatch):
    # No device_type means CUDA; without CUDA make_mesh raises rather than
    # quietly building a CPU mesh.
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.initialize(f"file://{tmp_path}/rendezvous", 1, 0, backend="gloo")
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(btt.StatusError, match="device_type='cpu'"):
            tpar.make_mesh(1)
        assert tpar.make_mesh(1, device_type="cpu").device_type == "cpu"
    finally:
        torch.distributed.destroy_process_group()


def test_a_failing_rank_fails_the_world():
    with pytest.raises(btt.StatusError, match="rank"):
        dryrun.run_world(2, dryrun.steps_program, {"nblocks": 3, "block": BLOCK},
                         device_type="cpu", timeout=WORLD_TIMEOUT)


@pytest.mark.parametrize("entry", ["run_world", "dryrun_multichip"])
def test_worlds_run_on_the_card_unless_asked_for_the_cpu(entry, monkeypatch):
    assert dryrun.default_backend(4, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"run_world": lambda: dryrun.run_world(2, dryrun.steps_program, {}),
            "dryrun_multichip": lambda: dryrun.dryrun_multichip(2)}[entry]
    with pytest.raises(btt.StatusError, match="CUDA is not available"):
        call()
