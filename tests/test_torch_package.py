"""The port as a package: no JAX at run time, a copy of it that runs with no
JAX package beside it, the same config semantics as the JAX package, a
capability record that names its limits, and timers that refuse the CPU."""

import dataclasses
import os
import re
import shutil
import subprocess
import sys
import textwrap
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
            "bitar_tpu_torch.cli.multihost_bench, bitar_tpu_torch.cli.bench, "
            "bitar_tpu_torch.utils.profiling, chip_smoke; "
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


STANDALONE = textwrap.dedent("""
    import importlib.util, sys
    from pathlib import Path
    assert importlib.util.find_spec("bitar_tpu") is None, "the JAX package is importable"
    assert not any(Path(p or ".").resolve() == Path(REPO) for p in sys.path), sys.path
    import numpy as np
    import bitar_tpu_torch as btt
    from bitar_tpu_torch.ops.cpu import native
    assert Path(native.load()._name).is_relative_to(Path(native.__file__).parents[2])
    rng = np.random.default_rng(3)
    block = 16 * 1024
    data = b"".join([(b"standalone port " * 1025)[:block],
                     rng.integers(0, 16, block, np.uint8).tobytes(),
                     rng.integers(0, 256, block, np.uint8).tobytes(),
                     b"\\x5a" * block, b"tail " * 300])
    for codec in (btt.Codec.LZ4, btt.Codec.SNAPPY, btt.Codec.ZSTD):
        cfg = btt.EngineConfig(codec=codec, block_size=block, burst_size=4,
                               max_pool_slots=32, commit="deferred")
        with btt.Engine(cfg, device="cpu") as eng:
            unit = eng.compress(data)
            eng.ensure_plans(unit)
            assert unit.plan_flat is not None and not unit.plan_flat["host_blocks"].size
            assert eng.decompress(unit).tobytes() == data, codec
            assert eng.stats.device_decode_bursts > 0 and eng.stats.host_decode_bursts == 0
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "bitar_tpu"))
    print(bad)
""")


def test_a_copy_of_the_port_alone_builds_and_round_trips(tmp_path):
    # The package copied without its build directory, run with no JAX
    # package and no repo on the path: it builds its own host library and
    # round-trips LZ4, Snappy and Zstd units through the planned decode.
    shutil.copytree(ROOT / "bitar_tpu_torch", tmp_path / "bitar_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    env["PYTHONPATH"] = str(tmp_path)
    code = f"REPO = {str(ROOT)!r}\n" + STANDALONE
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip() == "[]"
    assert list((tmp_path / "bitar_tpu_torch" / "_build").glob("libbitar_host-*.so"))


def test_host_library_sources_are_the_ports_own():
    from bitar_tpu_torch.ops.cpu import native

    pkg = (ROOT / "bitar_tpu_torch").resolve()
    assert native.SRC_DIR.resolve().is_relative_to(pkg)
    srcs = native.sources()
    assert {p.name for p in srcs} >= {"bitar_host.h", "lz4.cc", "snappy.cc", "zstd.cc",
                                      "batch.cc", "plan.cc"}
    for p in srcs:
        assert p.resolve().is_relative_to(native.SRC_DIR.resolve()), p
    # No string of the port builds a path into the JAX package, and no
    # library is loaded so that its symbols could serve the other's.
    files = sorted((ROOT / "bitar_tpu_torch").rglob("*.py"))
    pat = re.compile(r"[\"']bitar_tpu[\"']|RTLD_GLOBAL")
    assert [str(f) for f in files if pat.search(f.read_text())] == []


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
    fn = {"kernel_time_ms": lambda: timing.kernel_time_ms(lambda: calls.append(1), 3,
                                                          lambda: len(calls)),
          "host_us_per_call": lambda: timing.host_us_per_call(lambda: calls.append(1), 3)}[timer]
    with pytest.raises(btt.StatusError, match="needs a CUDA device"):
        fn()
    assert calls == []


@pytest.mark.parametrize("reps,per_call,want", [
    (20, 1, [20]), (200, 1, [128, 72]), (256, 2, [64] * 4), (5, 300, [1] * 5),
    (129, 128, [1] * 129), (0, 1, [])])
def test_held_rounds_split_reps_under_the_pending_launch_cap(reps, per_call, want):
    from bitar_tpu_torch.utils import timing

    got = timing.held_rounds(reps, per_call)
    assert got == want
    assert sum(got) == reps
    assert all(c * per_call <= timing.HELD_LAUNCHES or c == 1 for c in got)


class _FakeHold:
    """The hold library's calls, recorded; ``gave_up`` is what the hold
    reports after each round."""

    def __init__(self, gave_up=0):
        self.calls, self.gave_up = [], gave_up

    def bt_hold_arm(self, host):
        self.calls.append("arm")

    def bt_hold_launch(self, dev, timeout_ns, device, stream):
        self.calls.append(("launch", timeout_ns))
        return 0

    def bt_hold_release(self, host):
        self.calls.append("release")

    def bt_hold_gave_up(self, host):
        return self.gave_up


def _fake_card(monkeypatch, hold, event_ms=3.0):
    # kernel_time_ms's control flow on the CPU: a fake hold library, stream
    # and events (each round's events read event_ms).
    import torch

    from bitar_tpu_torch.utils import timing

    class Stream:
        device, cuda_stream = torch.device("cuda", 0), 0

        def synchronize(self):
            hold.calls.append("sync")

    class Event:
        def __init__(self, **kw):
            pass

        def record(self, stream=None):
            hold.calls.append("event")

        def elapsed_time(self, end):
            return event_ms

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(timing, "_hold_flags", lambda: (hold, 1, 2))
    return timing


@pytest.mark.parametrize("per_call", [1, 2])
def test_kernel_time_ms_queues_held_rounds_behind_the_hold(per_call, monkeypatch):
    hold = _FakeHold()
    timing = _fake_card(monkeypatch, hold)
    count = [0]

    def fn():
        hold.calls.append("call")
        count[0] += per_call

    reps = 300
    got = timing.kernel_time_ms(fn, reps, lambda: count[0])
    rounds = timing.held_rounds(reps, per_call)
    assert got == pytest.approx(3.0 * len(rounds) / reps)
    want = ["call"]                                  # the warm-up call
    for calls in rounds:
        want += ["arm", ("launch", int(timing.HOLD_TIMEOUT_S * 1e9)), "event"]
        want += ["call"] * calls + ["event", "release", "sync"]
    assert hold.calls == want


def test_kernel_time_ms_raises_when_the_hold_gave_up(monkeypatch):
    # fn waited on the host (or filled the queue): the hold timed out.
    hold = _FakeHold(gave_up=1)
    timing = _fake_card(monkeypatch, hold)
    count = [0]

    def waits_on_the_host():
        count[0] += 1

    with pytest.raises(btt.StatusError, match="hold gave up.*waits_on_the_host"):
        timing.kernel_time_ms(waits_on_the_host, 4, lambda: count[0])
    assert hold.calls.count("release") == 1


def test_kernel_time_ms_refuses_a_call_that_launched_nothing(monkeypatch):
    # The launch counter is the name check: a call that launched no kernel
    # of the counter is refused before anything is held.
    hold = _FakeHold()
    timing = _fake_card(monkeypatch, hold)
    with pytest.raises(btt.StatusError, match="launched no kernel"):
        timing.kernel_time_ms(lambda: None, 4, lambda: 7)
    assert hold.calls == []


def test_kernel_time_ms_releases_the_hold_when_the_call_raises(monkeypatch):
    hold = _FakeHold()
    timing = _fake_card(monkeypatch, hold)
    count = [0]

    def fn():
        count[0] += 1
        if count[0] > 1:
            raise RuntimeError("launch failed")

    with pytest.raises(RuntimeError, match="launch failed"):
        timing.kernel_time_ms(fn, 4, lambda: count[0])
    assert hold.calls[-2:] == ["release", "sync"]


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
