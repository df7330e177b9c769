"""The port's fused path against the frozen f64 goldens
(tests/golden/qtp_golden.npz): the box-only configs, whose QP the
diagonal-A kernel K1 takes. On the CPU the fused path runs K1's plain
version; the bar is the JAX package's own for its fused kernels, 2e-4
(tests/test_golden_parity.py)."""

import json
import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks load in the test process)

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import parallel
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp
from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
_GOLDEN = np.load(os.path.join(GOLDEN_DIR, "qtp_golden.npz"))
with open(os.path.join(GOLDEN_DIR, "qtp_golden_meta.json")) as f:
    _META = {c["key"]: c for c in json.load(f)["configs"]}

BOX_ONLY = ["h5_none_sc0_R0.1", "h5_none_sc0_R0.001", "h5_none_sc0_R0.0001", "h20_none_sc0_R0.1"]
_ADMM = AdmmConfig(max_iter=20000, refine_steps=2)


@pytest.mark.parametrize("key", BOX_ONLY)
def test_fused_path_matches_frozen_golden(key):
    cfg = _META[key]
    assert cfg["status"] == 0 and cfg["terminal"] == "none" and not cfg["state_constraint"]
    c = tmpc.proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control",
        cfg["horizon"], 5.0, [0.65] * 4, [1.2] * 2,
        mpc_R=cfg["R"], admm_config=_ADMM, device="cpu",
    )
    assert c.engine.op.diag_a  # box-only: the K1 shape
    x0 = torch.tensor([cfg.get("x0", [0.6] * 4)], dtype=torch.float32)
    sol, _, _, diag = parallel.solve_batch_fused(c, x0)
    assert int(sol.status[0]) == 0 and int(diag.n_converged) == 1
    np.testing.assert_allclose(
        sol.u[0].numpy().T, _GOLDEN[key + "__u"], atol=2e-4,
        err_msg=f"{key}: fused path drifted off the frozen golden",
    )
    np.testing.assert_allclose(sol.x[0].numpy().T, _GOLDEN[key + "__x"], atol=5e-4)
