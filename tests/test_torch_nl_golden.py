"""The port's learned-plant controllers against the frozen NL goldens
and the JAX package, on the CPU: ``step`` on the four frozen SQP configs
of tests/golden/qtp_nl_golden.npz for both transcriptions (u and x within
1e-3, the JAX test's bar), the wide linear plant (nx 16, nu 8) at 1e-4 of
its f64 oracle, and the golden fnn linearized at the reference on K1's
plain version against the JAX package's fused path."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu import parallel as jpar
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.models import zoo as jzoo
from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig as JAdmm

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import interop
from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big as tbig
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.models import zoo as tzoo
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig as TAdmm

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
_GOLDEN = np.load(os.path.join(GOLDEN_DIR, "qtp_nl_golden.npz"))
with open(os.path.join(GOLDEN_DIR, "qtp_nl_golden_meta.json")) as f:
    _META = json.load(f)
X_REF, U_REF = [0.65] * 4, [1.2] * 2


def _close(t, j, rel):
    t = np.asarray(t, np.float64)
    j = np.asarray(j, np.float64)
    assert t.shape == j.shape, (t.shape, j.shape)
    err = np.max(np.abs(t - j)) / max(1.0, np.max(np.abs(j)))
    assert err <= rel, err


@pytest.fixture(scope="module")
def plants():
    """The golden fnn in both packages, the same 160 floats."""
    flat = _GOLDEN["fnn_params"]
    japply, p0 = jzoo.init_model("fnn", jax.random.PRNGKey(0), 4, 2, hidden=8, depth=1)
    _, unravel = ravel_pytree(p0)
    js = jmpc.NeuralDiscreteSystem(
        apply_fn=japply, family="fnn", nx=4, nu=2,
        params=unravel(jnp.asarray(flat, jnp.float32)), X=jqtp.X_BOX, U=jqtp.U_BOX,
    )
    tapply, act = tzoo.make_apply("fnn")
    ts = tmpc.NeuralDiscreteSystem(
        apply_fn=tapply, family="fnn", nx=4, nu=2,
        params=interop.unravel_params("fnn", 4, 2, 8, 1, flat),
        X=tqtp.x_box(), U=tqtp.u_box(), activation=act,
    )
    return js, ts


def _x0s(n, seed=0, spread=0.05):
    """Suite config 3's states: clip(0.65 + spread N(0, 1), 0.3, 1.3)."""
    rng = np.random.default_rng(seed)
    return np.clip(0.65 + spread * rng.standard_normal((n, 4)), 0.3, 1.3).astype(np.float32)


def _golden_controller(ts, cfg, shooting):
    kw = dict(sqp_config=tmpc.SqpConfig(shooting=shooting, max_sqp_iter=80))
    if cfg["soft"] is not None:
        kw["mpc_soft_state_constraint"] = cfg["soft"]
    elif cfg["state_constraint"]:
        kw["mpc_state_constraint"] = True
    return tmpc.proceed_controller(ts, "model_predictive_control", cfg["horizon"], 5.0,
                                   X_REF, U_REF, device="cpu", **kw)


@pytest.mark.parametrize("shooting", ["single", "multiple"])
@pytest.mark.parametrize("cfg", _META["nl_configs"], ids=[c["key"] for c in _META["nl_configs"]])
def test_step_matches_frozen_nl_golden(plants, cfg, shooting):
    """``step`` at B = 1 against the frozen u and x (1e-3, the JAX test's
    bar) and objective (rel 1e-3)."""
    _, ts = plants
    c = _golden_controller(ts, cfg, shooting)
    x0 = torch.tensor(cfg.get("x0", _META["x0"]), dtype=torch.float32)
    c, sol = tmpc.step(c, x0)
    assert int(sol.status) == 0
    key = f"{cfg['key']}__{shooting}"
    np.testing.assert_allclose(sol.u.numpy().T, _GOLDEN[key + "__u"], atol=1e-3)
    np.testing.assert_allclose(sol.x.numpy().T, _GOLDEN[key + "__x"], atol=1e-3)
    np.testing.assert_allclose(float(sol.objective), cfg["objective"][shooting], rtol=1e-3)


def test_wide_linear_matches_frozen_oracle():
    """The wide plant (nx 16, nu 8, benchmarks/big.py) with state boxes,
    ``step`` on the general engine, against the f64 oracle at 1e-4."""
    w = _META["wide"]
    sys = tbig.random_stable_system(w["nx"], w["nu"], seed=w["seed"])
    c = tmpc.proceed_controller(sys, "model_predictive_control", w["horizon"], 1.0,
                                np.zeros(w["nx"]), np.zeros(w["nu"]),
                                mpc_state_constraint=True, device="cpu")
    c, sol = tmpc.step(c, torch.tensor(w["x0"], dtype=torch.float32))
    assert int(sol.status) == 0
    np.testing.assert_allclose(sol.u.numpy().T, _GOLDEN["wide__u"], atol=1e-4)
    np.testing.assert_allclose(sol.x.numpy().T, _GOLDEN["wide__x"], atol=1e-4)


# ------------------------------------------------------- the learned-linear path


def test_linearized_fnn_on_k1_matches_jax(plants):
    """programming_type "linear" on the fnn: linearized at the first
    reference, the h20 box-only QP on K1's plain version through
    solve_batch_auto, against the JAX package's fused path. The designed
    QP within 1e-5. At bench.py's tier-1 config u within 5e-4 (the JAX
    package's fused-vs-engine bar) on the lanes converged in both; the
    statuses lane by lane at eps 1e-4 with checks every 5 iterations,
    where every decision sits above the fp32 floor of the residuals
    (tests/test_torch_slice.py's ABOVE_FLOOR: at 1e-6 a lane's last check
    follows each package's roundoff)."""
    js, ts = plants
    tier1 = dict(max_iter=75, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0)
    above = dict(tier1, max_iter=10, eps_abs=1e-4, eps_rel=1e-4, check_interval=5,
                 adapt_interval=5)
    x0 = _x0s(32, seed=7, spread=0.15)
    sols = []
    for cfg in (tier1, above):
        jc = jmpc.proceed_controller(js, "model_predictive_control", 20, 5.0, np.asarray(X_REF),
                                     np.asarray(U_REF), mpc_programming_type="linear",
                                     admm_config=JAdmm(**cfg))
        tc = tmpc.proceed_controller(ts, "model_predictive_control", 20, 5.0, X_REF, U_REF,
                                     mpc_programming_type="linear", admm_config=TAdmm(**cfg),
                                     device="cpu")
        assert isinstance(tc.engine, tmpc.LinearEngine) and tc.engine.op.diag_a
        assert tpar.fused_supported(tc)
        for f in ("P", "A", "q_x0", "G_flat"):
            _close(getattr(tc.engine.qp, f), getattr(jc.engine.qp, f), 1e-5)
        admm_fused.reset_counts()
        tsol, _, _, _ = tpar.solve_batch_auto(tc, torch.from_numpy(x0))
        assert admm_fused.PLAIN_CALLS["K1"] > 0
        jsol, _, _, _ = jpar.solve_batch_auto(jc, jnp.asarray(x0))
        sols.append((tsol, jsol))
    (tsol, jsol), (tsol2, jsol2) = sols
    both = (tsol.status.numpy() == 0) & (np.asarray(jsol.status) == 0)
    assert both.mean() >= 0.9
    np.testing.assert_allclose(tsol.u.numpy()[both], np.asarray(jsol.u)[both], atol=5e-4)
    np.testing.assert_array_equal(tsol2.status.numpy(), np.asarray(jsol2.status))
    np.testing.assert_allclose(tsol2.u.numpy(), np.asarray(jsol2.u), atol=5e-4)


