"""On the card: one short run of each one-card cell through the command the
driver runs, correct against the reference. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from mpcbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["qtp-h500-riccati.fleet-B1024", "qtp-h100-condensed.fleet-B4096"])
def test_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, os.path.join("mpcbench", "run.py"), "--workload", cell,
                           "--seed", "2147483711", "--seconds", "2", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
