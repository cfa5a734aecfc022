"""The port's CLI tools on the CPU, against the JAX package's: the demo's
suites and file modes (``--device cpu``, host codecs and the plain PyTorch
kernels), containers byte-equal to the JAX CLI's and decodable by it (and
the other way round), the skewed input, the scaling harness and the
configs harness at small sizes, and the profiling hooks.  Every input is
made from a numpy seed; tolerance 0 (bytes, sizes, exit codes)."""

import os

import numpy as np
import pytest
import torch

from bitar_tpu.cli import demo as jdemo
from bitar_tpu.parallel import multihost as jmultihost
from bitar_tpu_torch.cli import configs_bench, demo, multihost_bench
from bitar_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture
def input_file(tmp_path):
    rng = np.random.default_rng(41)
    data = (b"cli test payload! " * 400
            + bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
            + b"\x00" * 2000)
    p = tmp_path / "input.bin"
    p.write_bytes(data)
    return p, data


def run_cli(args):
    return demo.main([str(a) for a in args])


def run_jax_cli(args):
    return jdemo.main([str(a) for a in args])


@pytest.mark.parametrize("backend", ["host", "gpu"])
def test_cli_sync_suite(input_file, capsys, backend):
    path, _ = input_file
    rc = run_cli(["--file", path, "--mode", "sync", "--codec", "lz4", "--block-size", "1024",
                  "--backend", backend, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "sync verify OK" in out
    assert "ratio=" in out


@pytest.mark.parametrize("backend", ["host", "gpu"])
def test_cli_async_suite(input_file, capsys, backend):
    path, _ = input_file
    rc = run_cli(["--file", path, "--mode", "async", "--codec", "snappy",
                  "--block-size", "1024", "--backend", backend, "--device", "cpu",
                  "--streams", "3"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "async verify OK" in out


@pytest.mark.parametrize("backend", ["host", "gpu"])
def test_cli_compress_decompress_files(input_file, tmp_path, capsys, backend):
    path, data = input_file
    comp_path = tmp_path / "out.btpu"
    rc = run_cli(["--file", path, "--mode", "compress", "--codec", "lz4",
                  "--block-size", "16384", "--backend", backend, "--device", "cpu",
                  "--checksum", "crc32", "--output", comp_path])
    assert rc == 0
    assert comp_path.stat().st_size < len(data)
    out_path = tmp_path / "restored.bin"
    rc = run_cli(["--file", comp_path, "--mode", "decompress", "--backend", backend,
                  "--device", "cpu", "--output", out_path])
    assert rc == 0
    assert out_path.read_bytes() == data


@pytest.mark.parametrize("codec", ["lz4", "snappy", "zstd"])
def test_containers_equal_the_jax_clis(input_file, tmp_path, codec):
    # The same file through both CLIs: byte-equal containers, and each CLI
    # decodes the other's.
    path, data = input_file
    mine, theirs = tmp_path / "port.btpu", tmp_path / "jax.btpu"
    assert run_cli(["--file", path, "--mode", "compress", "--codec", codec,
                    "--block-size", "4096", "--checksum", "crc32", "--backend", "host",
                    "--device", "cpu", "--output", mine]) == 0
    assert run_jax_cli(["--file", path, "--mode", "compress", "--codec", codec,
                        "--block-size", "4096", "--checksum", "crc32", "--backend", "host",
                        "--platform", "cpu", "--output", theirs]) == 0
    assert mine.read_bytes() == theirs.read_bytes()
    by_jax, by_port = tmp_path / "by_jax.bin", tmp_path / "by_port.bin"
    assert run_jax_cli(["--file", mine, "--mode", "decompress", "--backend", "host",
                        "--platform", "cpu", "--output", by_jax]) == 0
    assert run_cli(["--file", theirs, "--mode", "decompress", "--backend", "gpu",
                    "--device", "cpu", "--output", by_port]) == 0
    assert by_jax.read_bytes() == by_port.read_bytes() == data


def test_cli_parquet_ingest(tmp_path, capsys):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    table = pa.table({"x": np.arange(20_000), "y": np.arange(20_000) % 7})
    p = tmp_path / "t.parquet"
    pq.write_table(table, p)
    rc = run_cli(["--file", p, "--mode", "sync", "--block-size", "4096", "--backend", "host",
                  "--device", "cpu"])
    assert rc == 0
    assert "sync verify OK" in capsys.readouterr().out


def test_cli_parquet_without_pyarrow_exits(tmp_path, monkeypatch, capsys):
    # Where pyarrow is missing (the card's machine) an Arrow file exits
    # with a clear error; it is never read as raw bytes.
    import builtins

    real = builtins.__import__

    def no_pyarrow(name, *a, **kw):
        if name == "pyarrow" or name.startswith("pyarrow."):
            raise ImportError(name)
        return real(name, *a, **kw)

    p = tmp_path / "t.parquet"
    p.write_bytes(b"PAR1 not really parquet")
    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    with pytest.raises(SystemExit) as ei:
        run_cli(["--file", p, "--mode", "sync", "--backend", "host", "--device", "cpu"])
    assert ei.value.code == 2
    assert "needs pyarrow" in capsys.readouterr().err


@pytest.mark.parametrize("codec,backend", [("lz4", "gpu"), ("snappy", "host")])
def test_cli_skewed_suite(tmp_path, capsys, codec, backend):
    stats_path = tmp_path / "skewed.json"
    rc = run_cli(["--mode", "skewed", "--codec", codec, "--block-size", "16384",
                  "--blocks", "12", "--burst-size", "4", "--backend", backend,
                  "--device", "cpu", "--output", stats_path])
    assert rc == 0
    import json
    stats = json.loads(stats_path.read_text())
    assert stats["blocks"] == 12 and stats["bursts"] == 3 and stats["burst_size"] == 4
    assert len(stats["burst_lat_ms"]) == 3
    assert stats["lat_p50_ms"] <= stats["lat_p99_ms"] <= stats["lat_max_ms"]
    assert "skewed latency:" in capsys.readouterr().out


def test_cli_rejects_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        run_cli(["--file", tmp_path / "nope.bin", "--mode", "sync", "--backend", "host",
                 "--device", "cpu"])


def test_cli_cuda_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit) as ei:
        run_cli(["--mode", "skewed", "--blocks", "4", "--device", "cuda"])
    assert ei.value.code == 1
    assert "no cuda devices" in capsys.readouterr().err


@pytest.mark.parametrize("block,nblocks,seed", [(16384, 40, 11), (1 << 20, 6, 3)])
def test_make_skewed_input_equals_the_jax_clis(block, nblocks, seed):
    assert demo.make_skewed_input(block, nblocks, seed=seed) == \
        jdemo.make_skewed_input(block, nblocks, seed=seed)


@pytest.mark.parametrize("nblocks,pc", [(100, 1), (100, 4), (10, 3), (1001, 2), (5, 8)])
def test_partition_blocks_equals_the_jax_packages(nblocks, pc):
    for i in range(pc):
        assert multihost_bench.partition_blocks(nblocks, pc, i) == \
            jmultihost.partition_blocks(nblocks, pc, i)


def test_multihost_bench_two_ranks_on_the_cpu(tmp_path):
    # Two spawned ranks (gloo, file:// rendezvous) and the 1-process
    # baseline; every received block is checked bit-exact in its rank.
    out = tmp_path / "multihost.json"
    rc = multihost_bench.main(["--launch", "2", "--device", "cpu", "--blocks", "8",
                               "--reps", "1", "--timeout", "120", "--out", str(out)])
    assert rc == 0
    import json
    art = json.loads(out.read_text())
    assert art["multi"]["processes"] == 2 and art["single"]["processes"] == 1
    assert art["multi"]["verified_blocks"] == 8 and art["single"]["verified_blocks"] == 4
    assert art["scaling_efficiency"] > 0 and len(art["round_efficiencies"]) == 1
    assert art["device"]["platform"] == "cpu"


def test_configs_bench_config2_on_the_cpu(tmp_path):
    out = tmp_path / "configs.json"
    assert configs_bench.main(["--device", "cpu", "--configs", "2", "--gib", str(3 / 1024),
                               "--out", str(out)]) == 0
    import json
    (run,) = json.loads(out.read_text())["runs"]
    assert run["config"] == 2 and run["bit_exact"] and run["bytes"] == 3 << 20
    assert run["compress_GBps"] > 0 and run["decompress_GBps"] > 0


def test_configs_bench_config1_without_pyarrow_is_not_run(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pyarrow(name, *a, **kw):
        if name == "pyarrow" or name.startswith("pyarrow."):
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    run = configs_bench.config1_parquet_sync(str(tmp_path), "cpu")
    assert run["config"] == 1 and run["run"] is False and "pyarrow" in run["reason"]
    assert not any(k.endswith("GBps") for k in run)


def test_profiling_noop_and_annotation(tmp_path, monkeypatch):
    monkeypatch.delenv("BITAR_TPU_TRACE_DIR", raising=False)
    with profiling.device_trace(None) as d:
        assert d is None
    with profiling.annotate("unit-test-region"):
        pass
    with profiling.device_trace(str(tmp_path)) as d:
        with profiling.annotate("traced-region"):
            torch.ones(8).sum()
    assert d == str(tmp_path)
    (trace,) = tmp_path.glob("trace-*.json")
    assert "traced-region" in trace.read_text()


def test_multihost_bench_phases_skew_and_pinned_cores_on_the_cpu(tmp_path):
    # --pin-cores keeps each rank on half the cores and the baseline on
    # rank 0's half; --phases times the flat step's exchange and decode alone, and
    # --skew-bucket-log reaches the shuffle plan.
    out = tmp_path / "multihost.json"
    rc = multihost_bench.main(["--launch", "2", "--device", "cpu", "--blocks", "8",
                               "--reps", "1", "--timeout", "120", "--phases",
                               "--skew-bucket-log", "1", "--pin-cores", "--out", str(out)])
    assert rc == 0
    import json
    art = json.loads(out.read_text())
    assert art["multi"]["verified_blocks"] == 8 and art["single"]["verified_blocks"] == 4
    assert art["skew_bucket_log"] == 1 and art["pinned_cores"] is True
    share = max(1, len(os.sched_getaffinity(0)) // 2)
    assert art["multi"]["rank_cores"] == [share, share]
    assert art["single"]["rank_cores"] == [share]
    pa = art["phase_attribution"]
    for k in ("multi_exchange_ms", "multi_decode_ms", "single_exchange_ms", "single_decode_ms"):
        assert pa[k] > 0, k
    assert pa["decode_ratio"] == round(pa["multi_decode_ms"] / pa["single_decode_ms"], 3)

