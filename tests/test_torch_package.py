"""The port as a package: no JAX at run time, the same config semantics as
the JAX package, and a capability record that names its limits."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import bitar_tpu as bt
import bitar_tpu_torch as btt
from bitar_tpu_torch import config as tconfig

ROOT = Path(__file__).resolve().parent.parent


def test_import_leaves_jax_out():
    code = ("import sys, bitar_tpu_torch, bitar_tpu_torch.interop, "
            "bitar_tpu_torch.utils.timing, bitar_tpu_torch.utils.corpus, "
            "bitar_tpu_torch.ops.device_compress, bitar_tpu_torch.ops.emit, "
            "bitar_tpu_torch.ops.match_dyn, bitar_tpu_torch.ops.decode_tables, "
            "bitar_tpu_torch.ops.match, bitar_tpu_torch.ops.match_sort, "
            "bitar_tpu_torch.engine.stream, bitar_tpu_torch.engine.driver, "
            "bitar_tpu_torch.ops.decode_planned, bitar_tpu_torch.parallel, "
            "bitar_tpu_torch.parallel.sharding, bitar_tpu_torch.parallel.shuffle, "
            "bitar_tpu_torch.parallel.pipeline, bitar_tpu_torch.parallel.ring, "
            "bitar_tpu_torch.parallel.multihost, bitar_tpu_torch.parallel.dryrun, "
            "bitar_tpu_torch.cli.demo, bitar_tpu_torch.cli.configs_bench, "
            "bitar_tpu_torch.cli.multihost_bench, bitar_tpu_torch.utils.profiling, chip_smoke; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'bitar_tpu' or m.startswith('bitar_tpu.')); print(bad)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_import_no_jax():
    # Nor the root bench.py, which belongs to the JAX side.
    pat = re.compile(r"^\s*(import|from)\s+(jax|bitar_tpu|bench)(\.|\s|$)", re.M)
    files = sorted((ROOT / "bitar_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert offenders == []


@pytest.mark.parametrize("codec", ["lz4", "snappy", "zstd", "raw"])
@pytest.mark.parametrize("block", [1024, 16 * 1024, 128 * 1024, 1 << 20])
def test_slot_size_matches_jax(codec, block):
    jc = bt.EngineConfig(codec=bt.Codec(codec), block_size=block)
    tc = btt.EngineConfig(codec=btt.Codec(codec), block_size=block)
    assert tc.slot_size == jc.slot_size


@pytest.mark.parametrize("kw", [
    {}, {"burst_size": 0}, {"burst_size": 65}, {"dense_q": 9}, {"dense_sub": 100},
    {"max_pool_slots": 5}, {"window_log": 17}, {"level": 23}, {"min_match": 3},
    {"compress_matcher": "gpu"}, {"commit": "later"}, {"plan_build": "never"},
    {"block_size": 32}, {"fft_k": 0}, {"pipeline_depth": 0},
])
def test_validate_matches_jax_cpu(kw):
    # Against the JAX package's CPU capability record, knob for knob: the
    # port's CPU record differs only in its burst ceiling.
    jcaps = bt.config.CPU_INTERPRET
    tcaps = dataclasses.replace(tconfig.CPU_REFERENCE,
                                max_burst_size=jcaps.max_burst_size)
    want = bt.EngineConfig(**kw).validate(jcaps)
    got = btt.EngineConfig(**kw).validate(tcaps)
    assert got.code.value == want.code.value, (got, want)


def test_h100_capabilities_name_the_block_limit():
    # Blocks up to 1 MiB, as on the TPU (the decode kernels keep taller
    # planes in device memory); 2 MiB is outside the range; the device
    # matchers take every block size up to 1 MiB, as on the TPU.
    caps = tconfig.cuda_capabilities("NVIDIA H100 80GB HBM3", 80 << 30, 232448)
    assert caps.max_block_size == 1 << 20
    for block in (128 * 1024, 256 * 1024, 1 << 20):
        ok = btt.EngineConfig(block_size=block, burst_size=1024, max_pool_slots=1056)
        assert ok.validate(caps).ok(), block
    st = btt.EngineConfig(block_size=2 << 20).validate(caps)
    assert not st.ok() and "outside device range" in st.message
    for matcher in ("tpu", "device"):
        for block in (128 * 1024, 256 * 1024, 1 << 20):
            cfg = btt.EngineConfig(block_size=block, compress_matcher=matcher, min_match=64,
                                   match_offsets=(1, 65535))
            assert cfg.validate(caps).ok(), (matcher, block)
    assert caps.hbm_budget_bytes == 60 << 30


def test_cpu_capabilities_for_cpu_device():
    import torch

    assert tconfig.capabilities_for_device(torch.device("cpu")) is tconfig.CPU_REFERENCE


def test_device_timer_refuses_cpu():
    import torch

    from bitar_tpu_torch.utils.timing import device_time_ms

    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the timer runs")
    with pytest.raises(btt.StatusError):
        device_time_ms(lambda: None, reps=1)


@pytest.mark.parametrize("timer", ["kernel_time_ms", "host_us_per_call"])
def test_kernel_and_host_timers_refuse_cpu(timer, monkeypatch):
    # Like device_time_ms: without CUDA they raise before calling anything.
    import torch

    from bitar_tpu_torch.utils import timing

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    fn = {"kernel_time_ms": lambda: timing.kernel_time_ms(lambda: calls.append(1), 3, "k"),
          "host_us_per_call": lambda: timing.host_us_per_call(lambda: calls.append(1), 3)}[timer]
    with pytest.raises(btt.StatusError, match="needs a CUDA device"):
        fn()
    assert calls == []


@pytest.mark.parametrize("empty_windows", [1, 3])
def test_kernel_time_ms_profiles_again_after_a_window_without_the_kernel(
        empty_windows, monkeypatch):
    # A profiled window whose device records were all dropped is profiled
    # again; after PROFILE_TRIES such windows the timer raises.
    import torch

    from bitar_tpu_torch.utils import timing

    class Average:
        key, device_time_total, count = "void walk_kernel(Args)", 30.0, 3

    windows = []

    class Profile:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            windows.append(1)
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [] if len(windows) <= empty_windows else [Average()]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(timing, "PROFILE_PAD_S", 0.0)
    if empty_windows < timing.PROFILE_TRIES:
        assert timing.kernel_time_ms(lambda: None, 3, "walk_kernel") == pytest.approx(0.01)
        assert len(windows) == empty_windows + 1
    else:
        with pytest.raises(btt.StatusError, match="no kernel named like 'walk_kernel'"):
            timing.kernel_time_ms(lambda: None, 3, "walk_kernel")
        assert len(windows) == timing.PROFILE_TRIES


def test_require_builds_its_message_only_on_failure():
    from bitar_tpu_torch.ops._build import require

    built = []

    def message():
        built.append(1)
        return "built on failure"

    require(True, message)
    assert built == []
    with pytest.raises(btt.StatusError, match="built on failure"):
        require(False, message)
    assert built == [1]
    with pytest.raises(btt.StatusError, match="a plain message"):
        require(False, "a plain message")
