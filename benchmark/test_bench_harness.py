"""BENCHMARK.json against the contract, the files it names, and each loop on the CPU.

Run from the repository root: ``python -m pytest benchmark/``.
"""

from __future__ import annotations

import hashlib
import json
import math
import re
import shutil
import sys
import types

import pytest

from benchmark import harness
from benchmark.trace import device as trace
from benchmark.trace import roofline

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
ALL = harness.with_held_back(SPEC)            # and the held-back cells, as they would go back
ALL_CELLS = [w["name"] for w in ALL["workloads"]]
SPECS = {"benchmark": SPEC, "with_held_back": ALL}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                                 for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(TEXT.match(w) for w in SPEC["command"])
    files = [w for w in SPEC["command"] if w.endswith(".py")]
    assert all(any(f.startswith(p + "/") for p in SPEC["paths"]) for f in files)
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])


@pytest.mark.parametrize("which", sorted(SPECS))
@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_names_and_units(section, which):
    entries = SPECS[which][section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert TEXT.match(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and e["chips"] in (1, 4)
        if section == "configs":
            assert len(e["reduced"]) <= 16 and all(NAME.match(k) for k in e["reduced"])
            assert e["file"].startswith(SPEC["paths"][0] + "/")


@pytest.mark.parametrize("which", sorted(SPECS))
def test_metrics_and_cells_fit_together(which):
    spec = SPECS[which]
    cells = [w["name"] for w in spec["workloads"]]
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(cells)
        assert all(c in e2e[m["moves"]].get("workloads", cells) for c in m["workloads"])
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in cells:
        found = harness.resolve(c, spec=spec)
        assert {m["name"] for m in found["end_to_end"]} > {"setup_s"}
        assert found["per_layer"]
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in spec["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_cell_files_resolve_by_name(cell):
    spec = harness.resolve(cell, spec=ALL)
    conf = {c["name"]: c for c in ALL["configs"]}[spec["cell"]["config"]]
    assert spec["config"]["reduced"] == conf["reduced"]
    assert spec["config"]["chips"] == spec["cell"]["chips"]
    assert TEXT.match(spec["config"]["source"])
    assert hasattr(harness.loop_module(spec["traffic"]), "run")
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(spec["bench"], m["name"]))


@pytest.mark.parametrize("trace_on", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", ALL_CELLS)
def test_loop_runs_a_tiny_window_on_the_cpu(tiny, cell, trace_on):
    spec, ctx = tiny(cell, seconds=0.5, trace=trace_on)
    _, line = harness.run_cell(spec, ctx)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu" and line["device"]["memory_peak_bytes"] == 0
    device_metrics = {m["name"] for m in spec["per_layer"] if m["source"] == "device_trace"}
    if trace_on:
        assert not set(line["metrics"]) & device_metrics       # nothing ran on a device
        assert line["device"]["busy_s"] == 0.0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]}
        assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("planted,caught", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True),
    ("bitar_tpu", True), ("bitar_tpu.engine", True),
    ("bitar_tpu_torch_extra", False), ("jaxtyping", False), ("bitar_tpu2", False)])
def test_forbidden_modules_compare_whole_top_level_names(monkeypatch, planted, caught):
    import bitar_tpu_torch  # noqa: F401  the port itself passes
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, planted, types.ModuleType(planted))
    assert (harness.forbidden_modules() == [planted.split(".")[0]]) is caught


def test_roofline_counts_stored_and_raw_bytes_only():
    kind = "NVIDIA H100 80GB HBM3"
    counts = {"stored_bytes": 67_000_000, "raw_bytes": 134_217_728,
              "plan_bytes": 10**12, "slot_bytes": 10**12}
    r = {"events": [("decode_flat_kernel_shared(Args)", "kernel", 0.0, 150.0),
                    ("other_kernel", "kernel", 200.0, 999.0)],
         "counts": counts, "kind": kind}
    want = 100.0 * (67_000_000 + 134_217_728) / 3.35e12 / 150e-6
    assert math.isclose(trace.b1_roofline([r]), want)
    assert roofline.decode_bytes(3, 5) == 8
    assert roofline.share_pct(1e9, 1.0, "an unknown card") is None


def test_busy_time_is_a_union_and_gaps_are_named():
    events = [("k1", "kernel", 0.0, 10.0), ("k2", "kernel", 5.0, 10.0),
              ("m", "gpu_memcpy", 30.0, 10.0)]
    assert math.isclose(trace.busy_s(events), 25e-6)
    ann = [(trace.WINDOW, 0.0, 50.0), ("scan", 14.0, 20.0)]
    bd = trace.breakdown(events, ann)
    assert dict(bd["idle_gaps"]) == pytest.approx({"scan": 15e-6, "between spans": 10e-6})


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_traffic_and_metric_are_added_by_new_files(tmp_path, tiny):
    """A dummy configuration, traffic mix and metric in a copy: new files and
    new entries, and no file that was there changes."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path)
    b = tmp_path / "benchmark"
    conf = json.loads((b / "configs" / "lz4-128k.json").read_text())
    conf["name"] = "dummy-cfg"
    (b / "configs" / "dummy-cfg.json").write_text(json.dumps(conf))
    (b / "traffic" / "dummy-mix.json").write_text(
        json.dumps({"loop": "scan", "sample_scans": 3, "profile_s": 0.2}))
    (b / "metrics" / "dummy_steps.dummy-cfg.py").write_text(
        "def read(readings):\n    return float(readings[0]['all_steps'])\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy-cfg", "source": "a test", "reduced": [],
                            "file": "benchmark/configs/dummy-cfg.json", "why": "a test"})
    spec["workloads"].append({"name": "dummy-cfg.dummy-mix", "config": "dummy-cfg",
                              "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("dummy-cfg.dummy-mix")
    spec["per_layer"].append({"name": "dummy_steps.dummy-cfg", "unit": "steps",
                              "better": "higher", "source": "program_counter",
                              "layer": "device", "moves": spec["end_to_end"][0]["name"],
                              "workloads": ["dummy-cfg.dummy-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before and k.name != "BENCHMARK.json"} \
        == {k: v for k, v in before.items() if k.name != "BENCHMARK.json"}
    found = harness.resolve("dummy-cfg.dummy-mix", root=tmp_path)
    assert found["traffic"]["sample_scans"] == 3 and found["config"]["name"] == "dummy-cfg"
    assert [m["name"] for m in found["per_layer"]] == ["dummy_steps.dummy-cfg"]
    found["config"] = tiny("lz4-128k.scan")[0]["config"]
    ctx = harness.Context(cell=found["cell"], config=found["config"],
                          traffic=found["traffic"], seed=5, seconds=0.3, trace=True,
                          device="cpu")
    _, line = harness.run_cell(found, ctx)
    assert line["correct"] and line["metrics"]["dummy_steps.dummy-cfg"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c in CELLS if harness.resolve(c)["cell"]["chips"] == 1])
def test_cell_on_the_card(card, cell):
    """A short window of each one-card cell on the card, correct."""
    del card
    spec = harness.resolve(cell)
    ctx = harness.Context(cell=spec["cell"], config=spec["config"], traffic=spec["traffic"],
                          seed=2**31 + 3, seconds=2.0, trace=False, device="cuda")
    _, line = harness.run_cell(spec, ctx)
    assert line["correct"], line["checks"]

