"""The port's fused path against the frozen f64 goldens
(tests/golden/qtp_golden.npz): the box-only configs, whose QP the
diagonal-A kernel K1 takes, the configs with state or terminal rows with
those rows moved first (a dense operator: K4 or K5), and the Riccati
engine's rows on K3. On the CPU the fused path runs the kernels' plain
versions; the bar is the JAX package's own for its fused kernels, 2e-4
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
from automationlabsmodelpredictivecontrol_jl_torch.design import LinearEngine
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig, build_operator
from automationlabsmodelpredictivecontrol_jl_torch.ops.riccati import RiccatiConfig

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


# every feasible config with state or terminal rows (the kernels take no
# contractive ball, and the golden matrix has none)
ROWS = [k for k, c in _META.items() if c["status"] == 0 and (
    c["state_constraint"] or c["terminal"] != "none"
)]


def _rows_first(c):
    """The controller's QP with its state and terminal rows above the
    input-box rows, on an operator built for that order."""
    qp = c.engine.qp
    m, n = qp.A.shape
    perm = np.r_[np.arange(n, m), np.arange(n)]
    qp = qp.replace(**{k: getattr(qp, k)[perm] for k in ("A", "l_const", "u_const", "b_x0")})
    l, u = qp.l_const.numpy(), qp.u_const.numpy()
    eq = np.isfinite(l) & np.isfinite(u) & (l == u)
    op = build_operator(qp.P.numpy(), qp.A.numpy(), eq, 0, c.engine.config)
    return c.replace(engine=LinearEngine(qp=qp, op=op, soft_mu=None, config=c.engine.config))


@pytest.mark.parametrize("key", ROWS)
def test_dense_fused_path_matches_frozen_golden(key):
    """The row-permuted QP of each config with state or terminal rows on the
    dense kernels' plain versions, batch of one, at the fused bar."""
    cfg = _META[key]
    c = _rows_first(tmpc.proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control",
        cfg["horizon"], 5.0, [0.65] * 4, [1.2] * 2, mpc_terminal_ingredient=cfg["terminal"],
        mpc_R=cfg["R"], admm_config=_ADMM, device="cpu",
        **({"mpc_state_constraint": True} if cfg["state_constraint"] else {}),
    ))
    assert c.engine.op.dense_a and parallel.fused_supported(c)
    calls = dict(admm_fused.PLAIN_CALLS)
    x0 = torch.tensor([cfg.get("x0", [0.6] * 4)], dtype=torch.float32)
    sol, _, _, diag = parallel.solve_batch_fused(c, x0)
    assert admm_fused.PLAIN_CALLS["K4"] + admm_fused.PLAIN_CALLS["K5"] > calls["K4"] + calls["K5"]
    assert int(sol.status[0]) == 0 and int(diag.n_converged) == 1
    np.testing.assert_allclose(
        sol.u[0].numpy().T, _GOLDEN[key + "__u"], atol=2e-4,
        err_msg=f"{key}: the dense fused path drifted off the frozen golden",
    )
    np.testing.assert_allclose(sol.x[0].numpy().T, _GOLDEN[key + "__x"], atol=5e-4)


# the rows the JAX package holds its Riccati engine to (tests/
# test_golden_parity.py, _RICCATI_OK): h5 with no terminal, and the
# equality terminal at R=0.1 near the reference
_RICCATI_OK = [
    k for k, c in _META.items() if c["status"] == 0 and c["horizon"] == 5 and (
        c["terminal"] == "none" or (c["terminal"] == "equality" and c["R"] == 0.1)
    )
]
_RICC = RiccatiConfig(max_iter=20000, eps_abs=1e-6, eps_rel=1e-6)


@pytest.mark.parametrize("key", _RICCATI_OK)
def test_riccati_fused_path_matches_frozen_golden(key):
    """The Riccati engine through the port's fused path (K3's plain version
    on the CPU), batch of one, at the fused bar."""
    cfg = _META[key]
    c = tmpc.proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control",
        cfg["horizon"], 5.0, [0.65] * 4, [1.2] * 2, engine="riccati",
        mpc_terminal_ingredient=cfg["terminal"], mpc_R=cfg["R"], riccati_config=_RICC,
        device="cpu", **({"mpc_state_constraint": True} if cfg["state_constraint"] else {}),
    )
    assert isinstance(c.engine, tmpc.RiccatiEngine)
    x0 = torch.tensor([cfg.get("x0", [0.6] * 4)], dtype=torch.float32)
    sol, _, _, diag = parallel.solve_batch_fused(c, x0)
    assert int(sol.status[0]) == 0 and int(diag.n_converged) == 1
    np.testing.assert_allclose(
        sol.u[0].numpy().T, _GOLDEN[key + "__u"], atol=2e-4,
        err_msg=f"{key}: the fused Riccati path drifted off the frozen golden",
    )
    np.testing.assert_allclose(sol.x[0].numpy().T, _GOLDEN[key + "__x"], atol=5e-4)
