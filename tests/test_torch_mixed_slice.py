"""The mixed-A slice, port vs JAX: the suite's terminal-ingredient config
(QTP h20, equality and neighborhood terminals, benchmarks_suite.py config
2) through the entry points and solve_batch_auto, the x0-box status of a
state-constrained controller, and the tiered escalated solve of a starved
state-constrained controller. The JAX side runs its Pallas kernel in
interpret mode on the CPU; initial states are made with numpy from a
seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu import parallel as jpar
from automationlabsmodelpredictivecontrol_jl_tpu import runtime as jrt
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig as JConfig

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import STATUS_PRIMAL_INFEASIBLE
from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig as TConfig

torch.set_num_threads(1)

TOL = 5e-4  # the JAX package's fused-vs-engine bar
SUITE = dict(max_iter=1000)  # benchmarks_suite.py config 2
TIER2 = dict(rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250, refine_steps=2)
# a starved tier 1, its decisions two decades above the f32 noise floor so
# that both tiers and the bucket overflow are reproducible lane by lane
STARVED = dict(max_iter=10, eps_abs=1e-4, eps_rel=1e-4, check_interval=5, adapt_interval=5)


def _pair(horizon, cfg, **kw):
    jc = jmpc.proceed_controller(
        jqtp.linearized_discrete_system(), "model_predictive_control", horizon, 5.0,
        np.full(4, 0.65, np.float32), np.full(2, 1.2, np.float32),
        admm_config=JConfig(**cfg), **kw,
    )
    tc = tmpc.proceed_controller(
        tqtp.linearized_discrete_system(), "model_predictive_control", horizon, 5.0,
        [0.65] * 4, [1.2] * 2, admm_config=TConfig(**cfg), device="cpu", **kw,
    )
    return jc, tc


def suite_x0s(B):
    """benchmarks_suite.py config 2's initial states: default_rng(0),
    0.65 + 0.002 N(0, 1) in float32, shape (2048, 4); the first B."""
    rng = np.random.default_rng(0)
    return (0.65 + 0.002 * rng.standard_normal((2048, 4)).astype(np.float32))[:B]


@pytest.mark.parametrize("kind", ["equality", "neighborhood"])
def test_suite_terminal_config_matches_jax(kind):
    jc, tc = _pair(20, SUITE, mpc_terminal_ingredient=kind)
    assert tc.engine.op.mixed_a and tpar.fused_supported(tc)
    x0 = suite_x0s(64)
    js, _, _, jd = jpar.solve_batch_fused(jc, jnp.asarray(x0))
    calls = dict(admm_fused.PLAIN_CALLS)
    ts, wz, wy, td = tpar.solve_batch_auto(tc, torch.from_numpy(x0))
    assert admm_fused.PLAIN_CALLS["K2"] > calls["K2"]
    assert admm_fused.PLAIN_CALLS["K1"] == calls["K1"]
    assert int(td.n_converged) == int(jd.n_converged) == 64
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    for f in ("u", "x", "objective"):
        np.testing.assert_allclose(
            getattr(ts, f).numpy(), np.asarray(getattr(js, f)), atol=TOL, err_msg=f
        )
    # iteration counts are roundoff-decided at eps 1e-6. The port's fp64
    # sums certify a lane at most one check interval later than XLA's fp32
    # dot; on the equality terminal they certify nearly every lane one
    # check earlier (mean 25.4 against 50.4 iterations here)
    assert float(td.mean_iterations) <= float(jd.mean_iterations) + 25.0
    m = tc.engine.op.A_s.shape[0]
    assert ts.u.shape == (64, 2, 20) and ts.x.shape == (64, 4, 21)
    assert wz.shape == (64, 40) and wy.shape == (64, m)
    if kind == "equality":
        # the terminal state is pinned to the reference
        np.testing.assert_allclose(ts.e_x.numpy()[:, :, -1], 0.0, atol=1e-4)


def test_state_box_status_matches_runtime():
    """A lane whose x0 lies outside the state box is primal infeasible, as
    the JAX package's runtime reports it; the lanes inside are solved."""
    jc, tc = _pair(10, SUITE, mpc_state_constraint=True)
    x0 = np.full((3, 4), 0.65, np.float32)
    x0[1, 0] = 1.40  # above X.hi = 1.36
    x0[2, 3] = 0.15  # below X.lo = 0.2
    ts, _, _, td = tpar.solve_batch_fused(tc, torch.from_numpy(x0))
    for k in range(3):
        jwz, jwy = jc.warm_z, jc.warm_y
        jsol, _, _ = jrt.solve_once(jc, jnp.asarray(x0[k]), jwz, jwy)
        assert int(ts.status[k]) == int(jsol.status), k
    assert ts.status.tolist() == [0, STATUS_PRIMAL_INFEASIBLE, STATUS_PRIMAL_INFEASIBLE]
    assert int(td.n_infeasible) == 2


def test_escalated_state_constrained_matches_jax():
    """Tier 1 starved on K2, the stragglers bucketed into tier 2 on K2 with
    a wider grid and refinement, the overflow on the host f64 oracle, on
    the widest rows (state box and neighborhood terminal), lane by lane.
    (With the state box alone, one of these 16 lanes ends tier 2 after 115
    iterations in the port and 185 in the JAX package, converged in both:
    a hard lane's count stays roundoff-decided even at eps 1e-4.)"""
    B, bucket = 16, 8
    jc, tc = _pair(
        10, STARVED, mpc_state_constraint=True, mpc_terminal_ingredient="neighborhood"
    )
    jfb = jpar.escalation_controller(jc, **TIER2)
    tfb = tpar.escalation_controller(tc, **TIER2)
    assert tfb.engine.op.mixed_a and tpar.fused_supported(tfb)
    rng = np.random.default_rng(3)
    x0 = np.clip(0.65 + 0.1 * rng.standard_normal((B, 4)), 0.3, 1.3).astype(np.float32)

    jwz, jwy = jpar.init_warm_batch(jc, B)
    js, _, _, _ = jpar.solve_batch_escalated(jc, jfb, jnp.asarray(x0), jwz, jwy, bucket=bucket)
    twz, twy = tpar.init_warm_batch(tc, B)
    ts, _, _, _ = tpar.solve_batch_escalated(tc, tfb, torch.from_numpy(x0), twz, twy, bucket=bucket)
    st = ts.status.numpy()
    assert (st == 1).sum() > 0  # the bucket overflows
    np.testing.assert_array_equal(st, np.asarray(js.status))
    np.testing.assert_array_equal(ts.iterations.numpy(), np.asarray(js.iterations))
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), atol=TOL)

    sol, _, _, diag = tpar.make_escalated_solver(tc, fallback=tfb, min_bucket=bucket)(
        torch.from_numpy(x0)
    )
    jsol, _, _, _ = jpar.make_escalated_solver(jc, fallback=jfb, min_bucket=bucket)(
        jnp.asarray(x0)
    )
    assert int(diag.n_converged) == B
    np.testing.assert_array_equal(sol.status.numpy(), np.asarray(jsol.status))
    np.testing.assert_allclose(sol.u.numpy(), np.asarray(jsol.u), atol=TOL)
    done = st == 0
    np.testing.assert_array_equal(sol.u.numpy()[done], ts.u.numpy()[done])
