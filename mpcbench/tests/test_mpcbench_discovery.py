"""Configurations, mixes and per-layer metrics are found by name; a new
one is added as files and entries alone, without editing a file."""

import io
import json
import os
import shutil
import time

from mpcbench import harness, traffic
from mpcbench.tests import tiny

HOLD = '''"""The hold kind: one batch drawn from the seed, solved again back to back."""
import numpy as np
import torch

from mpcbench import harness

KEYS = ("level", "sample_lanes")


def check(mix, name):
    if not 0.2 < mix["level"] < 1.3:
        raise ValueError(name)


class Source:
    def __init__(self, mix, seed, nx, device):
        g = torch.Generator(device=device)
        g.manual_seed(int(seed) % 2 ** 63)
        self.mix = mix
        self.x0 = mix["level"] + 0.05 * torch.rand((mix["lanes"], nx), generator=g, device=device)

    def next(self):
        return self.x0

    def sample(self, batch, rows):
        return np.arange(min(self.mix["sample_lanes"], rows))


def warm_up(session, source):
    session.solve(source.next())


def run_window(session, source, seconds, stop=None, keep=True):
    stop = stop or (lambda elapsed: elapsed >= seconds)
    w = harness.Window(session)
    while True:
        w.batch(source.next(), source, keep)
        if stop(w.seconds):
            return w.close()
'''


def snapshot(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def copy_bench(tmp_path):
    bench = tmp_path / "mpcbench"
    shutil.copytree(harness.HERE, bench, ignore=shutil.ignore_patterns("__pycache__"))
    return bench, snapshot(bench)


def run_added(tmp_path, bench, spec, name, cut=None):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    spec2 = harness.load_spec(str(tmp_path))
    cell = harness.find_cell(spec2, name)
    cfg = harness.load_config(str(bench), cell["config"])
    cfg["horizon"] = tiny.HORIZONS[cfg["engine"]]
    cfg["work"]["lane_iterations"] = None
    mix = traffic.load(str(bench), cell["traffic"])
    out, err = io.StringIO(), io.StringIO()
    code = harness.run_single(spec2, cell, cfg, mix, 5, 0.2, True, time.perf_counter(), "cpu",
                              out=out, err=err, bench_dir=str(bench))
    return code, json.loads(out.getvalue().strip().splitlines()[-1]), mix


def test_every_name_resolves():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        cfg = harness.load_config(harness.HERE, w["config"])
        assert cfg["name"] == w["config"]
        assert traffic.load(harness.HERE, w["traffic"])["lanes"] > 0
    for m in spec["per_layer"]:
        assert callable(harness.load_reader(harness.HERE, m["name"]))


def test_cell_metrics_follow_workloads_keys():
    spec = harness.load_spec()
    names = {m["name"] for m in harness.cell_metrics(spec, "qtp-h100-condensed.fleet-B4096",
                                                     "per_layer")}
    assert {"k1_roofline", "k1.launches_per_batch", "design_s", "device.idle_share"} <= names
    assert not {"k3_roofline", "sharded.overhead_ms"} & names


def test_added_from_a_temporary_directory(tmp_path):
    """A copy of the benchmark's folder gains a configuration, a mix and a
    per-layer metric as new files, and its BENCHMARK.json a cell and a
    metric as new entries; the harness runs the new cell and reports the
    new metric, and no file it had was edited."""
    bench, before = copy_bench(tmp_path)
    cfg = harness.load_config(str(bench), "qtp-h500-riccati")
    cfg.update(name="qtp-h500-riccati-r1", R=1.0)
    (bench / "configs" / "qtp-h500-riccati-r1.json").write_text(json.dumps(cfg))
    mix = traffic.load(str(bench), "fleet-B1024")
    (bench / "traffic" / "fleet-B8.json").write_text(json.dumps(dict(mix, lanes=8)))
    (bench / "metrics" / "lanes_per_batch.py").write_text(
        "def read(ctx):\n    return float(ctx['mix']['lanes'])\n")
    spec = harness.load_spec()
    spec["configs"].append(dict(name="qtp-h500-riccati-r1", source="added", reduced=[], why="x",
                                file="mpcbench/configs/qtp-h500-riccati-r1.json"))
    spec["workloads"].append(dict(name="qtp-h500-riccati-r1.fleet-B8", config="qtp-h500-riccati-r1",
                                  traffic="fleet-B8", chips=1, why="added"))
    spec["per_layer"].append(dict(name="lanes_per_batch", unit="lanes", better="higher",
                                  source="program_counter", layer="batch / parallel",
                                  moves="solves_per_s", workloads=["qtp-h500-riccati-r1.fleet-B8"]))
    code, line, _ = run_added(tmp_path, bench, spec, "qtp-h500-riccati-r1.fleet-B8")
    assert code == 0 and line["correct"] is True
    assert line["metrics"]["lanes_per_batch"]["value"] == 8.0
    assert line["attempted"] % 8 == 0
    after = snapshot(bench)
    assert all(after[p] == data for p, data in before.items())


def test_traffic_kind_added_from_a_temporary_directory(tmp_path):
    """A traffic kind that is not a fleet (one batch drawn once and solved
    again back to back, with its own window loop) is added as one new file
    under ``kinds/``, a mix of it as data, and a cell as an entry; the
    harness runs it on both engines through the new kind's loop, and no file
    it had was edited."""
    bench, before = copy_bench(tmp_path)
    (bench / "kinds" / "hold.py").write_text(HOLD)
    (bench / "traffic" / "hold-B8.json").write_text(json.dumps(
        dict(kind="hold", lanes=8, ranks=1, level=0.6, sample_lanes=3,
             who="a test: one set of initial states solved again and again")))
    spec = harness.load_spec()
    for config in ("qtp-h500-riccati", "qtp-h100-condensed"):
        spec["workloads"].append(dict(name=f"{config}.hold-B8", config=config, traffic="hold-B8",
                                      chips=1, why="added"))
    for config in ("qtp-h500-riccati", "qtp-h100-condensed"):
        code, line, mix = run_added(tmp_path, bench, spec, f"{config}.hold-B8")
        assert mix["kind"] == "hold"
        assert code == 0 and line["correct"] is True, line["checks"]
        assert line["attempted"] % 8 == 0 and line["attempted"] > 0
    assert traffic.generator(str(bench), "hold").Source is not \
        traffic.generator(harness.HERE, "fleet").Source
    after = snapshot(bench)
    assert all(after[p] == data for p, data in before.items())
