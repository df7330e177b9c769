"""The traffic generator repeats exactly from a seed."""

import os

import numpy as np
import pytest
import torch

from mpcbench import harness, traffic


def fleet(mix, seed):
    return traffic.generator(harness.HERE, "fleet").Source(mix, seed, 4, "cpu")


@pytest.mark.parametrize("mix_name", ["fleet-B1024", "fleet-B4096", "sharded-4x1024"])
def test_draws_repeat_from_a_seed(mix_name):
    mix = traffic.load(harness.HERE, mix_name)
    seed = 2 ** 31 + 12345  # beyond 32 signed bits
    a, b = fleet(mix, seed), fleet(mix, seed)
    for _ in range(3):
        xa, xb = a.next(), b.next()
        assert xa.dtype == torch.float32 and xa.shape == (mix["lanes"], 4)
        assert torch.equal(xa, xb)
        assert float(xa.min()) >= mix["x0_lo"] and float(xa.max()) <= mix["x0_hi"]
    assert not torch.equal(fleet(mix, seed + 1).next(), fleet(mix, seed).next())
    rows = mix["lanes"] // mix["ranks"]
    assert np.array_equal(a.sample(7, rows), b.sample(7, rows))
    assert len(a.sample(7, rows)) == mix["sample_lanes"]


def test_draw_statistics():
    mix = traffic.load(harness.HERE, "fleet-B4096")
    x = fleet(mix, 0).next()
    assert abs(float(x.mean()) - mix["x0_mean"]) < 0.01
    assert abs(float(x.std()) - mix["x0_std"]) < 0.01


@pytest.mark.parametrize("change", [dict(lanes=4098), dict(kind="unknown"), dict(x0_std=None),
                                    dict(x0_mean=2.0)])
def test_refuses_a_mix_that_cannot_run(tmp_path, change):
    """A mix whose lanes do not split over its ranks, whose kind has no
    generator, that lacks a parameter of its kind, or that its kind's
    check refuses."""
    import json
    import shutil

    shutil.copytree(os.path.join(harness.HERE, "kinds"), tmp_path / "kinds")
    (tmp_path / "traffic").mkdir()
    mix = dict(traffic.load(harness.HERE, "sharded-4x1024"), **change)
    mix = {k: v for k, v in mix.items() if v is not None}
    (tmp_path / "traffic" / "odd.json").write_text(json.dumps(mix))
    with pytest.raises(ValueError):
        traffic.load(str(tmp_path), "odd")
