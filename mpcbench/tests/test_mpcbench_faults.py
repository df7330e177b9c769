"""A run with its timed path broken underneath comes out not correct, once
for each fault a cell can have; the look for a chip is skipped (CPU)."""

import io
import json
import time

import pytest

from mpcbench import sharded
from mpcbench.tests import faults, tiny

CELLS = ["qtp-h500-riccati.fleet-B1024", "qtp-h100-condensed.fleet-B4096"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [faults.stuck_state, faults.half_batch, faults.altered_answer])
def test_fault_is_not_correct(cell, fault):
    code, line, err = tiny.run(cell, patch=fault)
    assert code == 0 and line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", [None, faults.exchange_left_out])
def test_sharded_exchange_left_out(fault):
    """Two gloo ranks on the CPU: sound, then with the diagnostics'
    exchange left out."""
    spec, cell, cfg, mix = tiny.cell("qtp-h500-riccati.sharded-4x1024", lanes=16, ranks=2)
    out, err = io.StringIO(), io.StringIO()
    code = sharded.launch(spec, cell, cfg, mix, 2 ** 31 + 3, 0.3, False, time.perf_counter(),
                          device_type="cpu", out=out, err=err, patch=fault)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert code == 0 and line["device"]["count"] == 2
    assert line["correct"] is (fault is None), line["checks"]
    if fault is not None:
        assert line["checks"]["diag_mismatch"]["value"] > 0
