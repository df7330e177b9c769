"""Tiny cells for the CPU tests: the benchmark's own configurations and
mixes at a short horizon and a few lanes, run on the port's plain versions."""

from __future__ import annotations

import io
import json
import time

from mpcbench import harness, traffic

HORIZONS = {"riccati": 12, "condensed": 10}


def cell(name: str, lanes: int = 16, ranks: int = 1):
    """(spec, cell, cfg, mix) of BENCHMARK.json's cell ``name`` cut to a
    tiny size."""
    spec = harness.load_spec()
    c = harness.find_cell(spec, name)
    cfg = harness.load_config(harness.HERE, c["config"])
    cfg["horizon"] = HORIZONS[cfg["engine"]]
    mix = dict(traffic.load(harness.HERE, c["traffic"]), lanes=lanes, ranks=ranks)
    return spec, c, cfg, mix


def run(name: str, seed: int = 2 ** 31 + 7, seconds: float = 0.3, trace: bool = False,
        patch=None, cut=None, bench_dir: str = harness.HERE):
    """Run a tiny cell on the CPU; returns (exit code, result line or None,
    standard error). ``cut(spec, cell, cfg, mix)`` may change the cell."""
    spec, c, cfg, mix = cell(name)
    if cut is not None:
        cut(spec, c, cfg, mix)
    out, err = io.StringIO(), io.StringIO()
    code = harness.run_single(spec, c, cfg, mix, seed, seconds, trace, time.perf_counter(),
                              "cpu", out=out, err=err, patch=patch, bench_dir=bench_dir)
    lines = out.getvalue().strip().splitlines()
    return code, (json.loads(lines[-1]) if lines else None), err.getvalue()
