"""BENCHMARK.json against the benchmark's contract, and the result line's
schema from a tiny run on the CPU."""

import json
import os
import re

import pytest

from mpcbench import harness, traffic
from mpcbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec()


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "mpcbench/run.py"]
    assert spec["paths"] == ["mpcbench"]
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    assert len(json.dumps(spec)) < 64 * 1024


def test_configs_cells_and_files(spec):
    names = [c["name"] for c in spec["configs"]]
    assert len(set(names)) == len(names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("mpcbench/")
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert all(v is not None for v in cfg["limits"].values())
        assert cfg["work"]["lane_iterations"] is not None
    used = {w["config"] for w in spec["workloads"]}
    assert used == set(names)
    pairs = {(w["config"], w["traffic"]) for w in spec["workloads"]}
    assert len(pairs) == len(spec["workloads"])
    four = [w for w in spec["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(spec["workloads"]) // 4)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        mix = traffic.load(harness.HERE, w["traffic"])
        assert mix["ranks"] <= w["chips"]


def test_metrics(spec):
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(names)) == len(names)
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.isfile(os.path.join(harness.HERE, "metrics", f"{m['name']}.py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_result_line_schema():
    code, line, err = tiny.run("qtp-h500-riccati.fleet-B1024")
    assert code == 0
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"solves_per_s", "batch_p95_ms", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for name, text in zip(line["checks"], tail):
        assert text.startswith(f"check {name} ") and " limit " in text


def test_traced_result_line():
    code, line, _ = tiny.run("qtp-h100-condensed.fleet-B4096", trace=True,
                             cut=lambda s, c, cfg, mix: cfg["work"].update(lane_iterations=None))
    assert code == 0 and line["correct"] is True
    assert "design_s" in line["metrics"] and "device.idle_share" in line["metrics"]
    assert "k1.launches_per_batch" not in line["metrics"]  # no kernel runs on the CPU
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    assert len(line["breakdown"]["device_ops"]) <= 10
