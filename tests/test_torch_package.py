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
            "bitar_tpu_torch.utils.timing; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'bitar_tpu' or m.startswith('bitar_tpu.')); print(bad)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|bitar_tpu)(\.|\s|$)", re.M)
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
    caps = tconfig.cuda_capabilities("NVIDIA H100 80GB HBM3", 80 << 30, 232448)
    assert caps.max_block_size == 128 * 1024
    ok = btt.EngineConfig(block_size=128 * 1024, burst_size=1024, max_pool_slots=1056)
    assert ok.validate(caps).ok()
    st = btt.EngineConfig(block_size=256 * 1024).validate(caps)
    assert not st.ok() and "shared memory" in st.message
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
