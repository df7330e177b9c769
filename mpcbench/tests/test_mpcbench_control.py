"""The control, the reference or the program in the precision below the
one the configuration states, comes out not correct by the harness's own
comparison, where the program comes out correct (a tiny size on the CPU; on the chip at the cells' own
size: ``readings.py``)."""

import pytest

from mpcbench import harness, readings
from mpcbench.tests import tiny

CELLS = ["qtp-h500-riccati.fleet-B1024", "qtp-h100-condensed.fleet-B4096"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    _, _, cfg, mix = tiny.cell(name)
    limits = cfg["limits"]
    session = harness.Session(cfg, mix, "cpu")
    sound = readings.window_reading(session, cfg, mix, 11, 0.2, "cpu")
    assert sound["correct"] is True, sound["checks"]
    assert all(sound["checks"][k] <= limits[k] for k in limits), sound["checks"]
    ctl = cfg["control"]
    if ctl["kind"] == "reference":
        got = readings.reference_control(cfg, mix, 11, "cpu", batches=1)
    else:
        bad = harness.Session(cfg, mix, "cpu", overrides=ctl["solver"])
        got = readings.window_reading(bad, cfg, mix, 11, 0.2, "cpu")
    assert got["correct"] is False, got["checks"]
    assert any(got["checks"][k] > limits[k] for k in limits), got["checks"]
    keys = [k for k, _ in harness.program_design(session.ctrl)]
    assert readings.design_control(cfg, keys) > limits["design_gap"]
