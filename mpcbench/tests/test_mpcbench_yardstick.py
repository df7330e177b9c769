"""The frozen yardstick, pinned to numbers written here."""

import pytest

from mpcbench import harness
from mpcbench.yardstick import models, peaks, stats


def test_k3_h500_chunk_bound():
    b, t_bytes, t_ops = models.k3_chunk(500, 4, 2, 1024, 25)
    assert b == pytest.approx(0.0321, abs=5e-5) and t_ops > t_bytes


def test_k1_stream_h100_chunk_bound():
    b, t_bytes, t_ops = models.k1_chunk(200, 4096, 5, 1, 25)
    assert b == pytest.approx(0.3668, abs=5e-5) and t_ops > t_bytes


@pytest.mark.parametrize("name,kernel,per_chunk", [
    ("qtp-h500-riccati", "K3", 0.0321), ("qtp-h100-condensed", "K1", 0.3668)])
def test_batch_work_scales_the_chunk(name, kernel, per_chunk):
    cfg = harness.load_config(harness.HERE, name)
    lanes = 1024 if kernel == "K3" else 4096
    w = models.batch_work(cfg, lanes)
    assert w["kernel"] == kernel
    scale = cfg["work"]["lane_iterations"] / 25
    assert w["bound_ms"] == pytest.approx(per_chunk * scale, rel=2e-3)
    assert w["ops_ms"] <= w["bound_ms"]


def test_peaks_refuse_another_device():
    peaks.require_h100("NVIDIA H100 80GB HBM3")
    for kind in ("cpu", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(ValueError):
            peaks.require_h100(kind)


@pytest.mark.parametrize("metric", ["k3_roofline", "k1_roofline", "solve_mfu"])
def test_shares_refuse_another_device(metric):
    cfg = harness.load_config(harness.HERE, "qtp-h500-riccati" if metric == "k3_roofline"
                              else "qtp-h100-condensed")
    ctx = dict(work=models.batch_work(cfg, 1024), batch_ms=[60.0], device_kind="cpu",
               trace=dict(kernels={"riccati_admm_chunk_kernel<4, 2>": 0.25,
                                   "admm_stream_kernel<0>": 0.5}), trace_batches=5)
    read = harness.load_reader(harness.HERE, metric)
    with pytest.raises(ValueError):
        read(ctx)
    ctx["device_kind"] = "NVIDIA H100 80GB HBM3"
    assert 0 < read(ctx) < 100


def test_percentile_and_spread():
    assert stats.percentile([1, 2, 3, 4, 5], 95) == pytest.approx(4.8)
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx((4.5 - 1.5) / 3)
