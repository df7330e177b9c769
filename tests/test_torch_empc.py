"""Economic MPC (``solvers/empc.py``): the properties of the JAX package's
``tests/test_empc.py`` on the port, and the port against the JAX package on
the same inputs.

The stage costs are the same functions written once in torch and once in
jax.numpy; learned plants carry the JAX package's weights
(``interop.params_from_numpy``). u is held within 1e-3 of the JAX
package's with equal statuses; iteration counts only at a fixed budget
(after a few iterations the line search's merits tie at fp32 noise, as in
the SQP).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu import parallel as jpar
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import interop
from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.models import zoo as tzoo
from automationlabsmodelpredictivecontrol_jl_torch.solvers.empc import EmpcEngine

torch.set_num_threads(1)

X_REF = np.full(4, 0.65, np.float32)
U_REF = np.full(2, 1.2, np.float32)
X0 = np.full(4, 0.6, np.float32)
U_TOL = 1e-3


def _tracking(Q=100.0, R=0.1, xr=X_REF, ur=U_REF):
    """The tracking stage cost in torch and in jax.numpy."""
    txr, tur = torch.from_numpy(np.asarray(xr)), torch.from_numpy(np.asarray(ur))
    jxr, jur = jnp.asarray(xr), jnp.asarray(ur)
    t = lambda x, u: Q * (x - txr) @ (x - txr) + R * (u - tur) @ (u - tur)
    j = lambda x, u: Q * (x - jxr) @ (x - jxr) + R * (u - jur) @ (u - jur)
    return t, j


def _bench_cost():
    """The extra benchmarks' economic row: an input-weighted operating
    cost with a soft tracking pull."""
    txr, jxr = torch.from_numpy(X_REF), jnp.asarray(X_REF)
    t = lambda x, u: 10.0 * (u @ u) + 50.0 * (x - txr) @ (x - txr)
    j = lambda x, u: 10.0 * (u @ u) + 50.0 * (x - jxr) @ (x - jxr)
    return t, j


def _fnn(seed, hidden):
    """A random fnn QTP model with the JAX package's weights in both."""
    japply, jp = jmpc.init_model("fnn", jax.random.PRNGKey(seed), 4, 2, hidden=hidden,
                                 depth=1, sample_time=5.0)
    js = jmpc.NeuralDiscreteSystem(apply_fn=japply, family="fnn", nx=4, nu=2, params=jp,
                                   X=jqtp.X_BOX, U=jqtp.U_BOX)
    tapply, act = tzoo.make_apply("fnn")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    ts = tmpc.NeuralDiscreteSystem(apply_fn=tapply, family="fnn", nx=4, nu=2,
                                   params=interop.params_from_numpy("fnn", tree),
                                   X=tqtp.x_box(), U=tqtp.u_box(), activation=act)
    return js, ts


def _pair(jsys, tsys, N, costs, cfg=None, xr=X_REF, ur=U_REF, **kw):
    tcost, jcost = costs
    jc = jmpc.proceed_controller(
        jsys, "economic_model_predictive_control", N, 5.0, xr, ur, mpc_cost_function=jcost,
        empc_config=None if cfg is None else jmpc.EmpcConfig(**cfg), **kw)
    tc = tmpc.proceed_controller(
        tsys, "economic_model_predictive_control", N, 5.0, xr, ur, mpc_cost_function=tcost,
        empc_config=None if cfg is None else tmpc.EmpcConfig(**cfg), device="cpu", **kw)
    return jc, tc


def _linear():
    return jqtp.linearized_discrete_system(), tqtp.linearized_discrete_system()


def _step_pair(jc, tc, x0):
    _, js = jmpc.step(jc, jnp.asarray(x0))
    _, ts = tmpc.step(tc, torch.from_numpy(x0))
    assert int(ts.status) == int(js.status)
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), atol=U_TOL)
    return ts


def test_requires_cost_function():
    sys = tqtp.linearized_discrete_system()
    with pytest.raises(ValueError, match="mpc_cost_function"):
        tmpc.proceed_controller(sys, "economic_model_predictive_control", 5, 5.0, X_REF, U_REF,
                                device="cpu")
    with pytest.raises(ValueError, match="only accepted"):
        tmpc.proceed_controller(sys, "model_predictive_control", 5, 5.0, X_REF, U_REF,
                                mpc_cost_function=_tracking()[0], device="cpu")


def test_quadratic_economic_matches_tracking_linear():
    """With the tracking stage cost and an equilibrium reference the
    economic engine lands on the tracking QP's solution, and on the JAX
    package's economic solution."""
    jsys, tsys = _linear()
    A, B = tsys.A.double().numpy(), tsys.B.double().numpy()
    u_eq = U_REF.astype(np.float64)
    x_eq = np.linalg.solve(np.eye(4) - A, B @ u_eq).astype(np.float32)
    u_eq = u_eq.astype(np.float32)
    cfg = dict(max_sqp_iter=25, tol_du=1e-7)
    jc, tc = _pair(jsys, tsys, 10, _tracking(xr=x_eq, ur=u_eq), cfg, xr=x_eq, ur=u_eq)
    assert isinstance(tc.engine, EmpcEngine)
    c_lin = tmpc.proceed_controller(tsys, "model_predictive_control", 10, 5.0, x_eq, u_eq,
                                    device="cpu")
    ts = _step_pair(jc, tc, x_eq - 0.05)
    _, sol_lin = tmpc.step(c_lin, torch.from_numpy(x_eq - 0.05))
    assert int(sol_lin.status) == 0 and int(ts.status) in (0, 1)
    np.testing.assert_allclose(ts.u.numpy(), sol_lin.u.numpy(), atol=5e-3)


def test_quadratic_economic_matches_tracking_at_nonequilibrium_ref():
    """The linear deviation model's affine drift: at the QTP's own
    (non-equilibrium) reference the economic engine with the tracking cost
    matches the tracking QP, and its closed loop contracts toward x_ref."""
    jsys, tsys = _linear()
    jc, tc = _pair(jsys, tsys, 10, _tracking(), dict(max_sqp_iter=25, tol_du=1e-7))
    c_lin = tmpc.proceed_controller(tsys, "model_predictive_control", 10, 5.0, X_REF, U_REF,
                                    device="cpu")
    ts = _step_pair(jc, tc, X0)
    _, sol_lin = tmpc.step(c_lin, torch.from_numpy(X0))
    np.testing.assert_allclose(ts.u.numpy(), sol_lin.u.numpy(), atol=5e-3)
    x = torch.from_numpy(X0)
    xr, ur = torch.from_numpy(X_REF), torch.from_numpy(U_REF)
    e0 = float((x - xr).abs().max())
    for _ in range(8):
        tc, sol = tmpc.step(tc, x)
        x = xr + tsys.A @ (x - xr) + tsys.B @ (sol.u[:, 0] - ur)
    assert float((x - xr).abs().max()) < 0.6 * e0


def test_quadratic_economic_matches_sqp_neural():
    """On a learned plant the economic engine with the tracking cost
    reproduces the tracking SQP, and the JAX package's economic solve."""
    js, ts = _fnn(2, 6)
    jc, tc = _pair(js, ts, 6, _tracking(), dict(max_sqp_iter=25, tol_du=1e-7))
    sol_e = _step_pair(jc, tc, X0)
    c_sqp = tmpc.proceed_controller(ts, "model_predictive_control", 6, 5.0, X_REF, U_REF,
                                    device="cpu")
    _, sol_s = tmpc.step(c_sqp, torch.from_numpy(X0))
    np.testing.assert_allclose(sol_e.u.numpy(), sol_s.u.numpy(), atol=1e-2)
    np.testing.assert_allclose(float(sol_e.objective), float(sol_s.objective), rtol=1e-3,
                               atol=1e-4)


def test_input_price_reduces_consumption():
    """A pump-energy price over mild tracking spends less input than the
    tracking controller, inside the input box."""
    jsys, tsys = _linear()
    txr, jxr = torch.from_numpy(X_REF), jnp.asarray(X_REF)
    costs = (lambda x, u: 10.0 * (x - txr) @ (x - txr) + 50.0 * u.sum(),
             lambda x, u: 10.0 * (x - jxr) @ (x - jxr) + 50.0 * jnp.sum(u))
    jc, tc = _pair(jsys, tsys, 8, costs)
    c_track = tmpc.proceed_controller(tsys, "model_predictive_control", 8, 5.0, X_REF, U_REF,
                                      mpc_Q=10.0, mpc_R=0.0, device="cpu")
    sol_e = _step_pair(jc, tc, X0)
    _, sol_t = tmpc.step(c_track, torch.from_numpy(X0))
    assert float(sol_e.u.sum()) < float(sol_t.u.sum()) - 1e-3
    assert bool((sol_e.u >= tsys.U.lo[:, None] - 1e-5).all())
    assert bool((sol_e.u <= tsys.U.hi[:, None] + 1e-5).all())


@pytest.mark.parametrize("terminal", ["none", "equality", "contractive", "neighborhood"])
def test_neural_state_boxes_and_terminals(terminal):
    """A learned plant with hard state boxes and each terminal kind: the
    full constraint surface of the NLP route (the Jacobians' rows), as the
    JAX package solves it."""
    js, ts = _fnn(0, 8)
    jc, tc = _pair(js, ts, 5, _tracking(Q=10.0, R=1.0), mpc_state_constraint=True,
                   mpc_terminal_ingredient=terminal)
    sol = _step_pair(jc, tc, X0)
    assert int(sol.status) in (0, 1) and bool(torch.isfinite(sol.u).all())


def test_custom_terminal_cost_batch():
    """A custom Vf over a scenario batch: parallel.solve_batch runs every
    lane at once, as the JAX package's vmapped solve_once does."""
    jsys, tsys = _linear()
    txr, jxr = torch.from_numpy(X_REF), jnp.asarray(X_REF)
    costs = (lambda x, u: 100.0 * (x - txr) @ (x - txr) + 0.1 * u @ u,
             lambda x, u: 100.0 * (x - jxr) @ (x - jxr) + 0.1 * u @ u)
    vf_t = lambda x: 500.0 * (x - txr) @ (x - txr)
    vf_j = lambda x: 500.0 * (x - jxr) @ (x - jxr)
    jc = jmpc.proceed_controller(jsys, "economic_model_predictive_control", 6, 5.0, X_REF, U_REF,
                                 mpc_cost_function=costs[1], mpc_terminal_cost_function=vf_j,
                                 empc_config=jmpc.EmpcConfig(max_sqp_iter=10))
    tc = tmpc.proceed_controller(tsys, "economic_model_predictive_control", 6, 5.0, X_REF, U_REF,
                                 mpc_cost_function=costs[0], mpc_terminal_cost_function=vf_t,
                                 empc_config=tmpc.EmpcConfig(max_sqp_iter=10), device="cpu")
    assert tc.engine.terminal_cost_fn is vf_t
    x0s = (0.6 + 0.02 * np.random.default_rng(0).standard_normal((4, 4))).astype(np.float32)
    ts, twz, _, _ = tpar.solve_batch(tc, torch.from_numpy(x0s))
    js, _, _, _ = jpar.solve_batch(jc, jnp.asarray(x0s))
    assert tuple(ts.u.shape) == (4, 2, 6) and bool(torch.isfinite(ts.u).all())
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), atol=U_TOL)
    # the next warm input is the plan shifted one step
    torch.testing.assert_close(twz.reshape(4, 6, 2)[:, :-1], ts.u.transpose(1, 2)[:, 1:])


def test_warm_start_carry_closed_loop():
    """A receding-horizon loop with the shifted warm input settles near the
    reference, trading tracking against the economic term."""
    _, tsys = _linear()
    txr = torch.from_numpy(X_REF)
    c = tmpc.proceed_controller(tsys, "economic_model_predictive_control", 8, 5.0, X_REF, U_REF,
                                mpc_cost_function=lambda x, u: 100.0 * (x - txr) @ (x - txr)
                                + u.sum(), device="cpu")
    x = torch.from_numpy(X0)
    for _ in range(6):
        c, sol = tmpc.step(c, x)
        x = tsys.step(x, sol.u[:, 0])
    assert bool(((x - 0.65).abs() < 0.05).all())


def _bench_pair(cfg):
    jsys, tsys = _linear()
    return _pair(jsys, tsys, 10, _bench_cost(), cfg)


def test_bench_fleet_matches_jax():
    """The benchmark's economic row (h10, EmpcConfig(max_sqp_iter=15)) on 8
    lanes through parallel.solve_batch: statuses and u as the JAX
    package's."""
    jc, tc = _bench_pair(dict(max_sqp_iter=15))
    x0s = np.clip(0.65 + 0.1 * np.random.default_rng(0).standard_normal((8, 4)), 0.3,
                  1.3).astype(np.float32)
    ts, _, _, td = tpar.solve_batch(tc, torch.from_numpy(x0s))
    js, _, _, jd = jpar.solve_batch(jc, jnp.asarray(x0s))
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    assert int(td.n_converged) == int(jd.n_converged) == 8
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), atol=U_TOL)
    np.testing.assert_allclose(ts.objective.numpy(), np.asarray(js.objective), rtol=1e-5)


def test_bench_fixed_budget_counts():
    """At a fixed budget (three SQP iterations on every lane) the counts,
    statuses and u are the JAX package's."""
    jc, tc = _bench_pair(dict(max_sqp_iter=3, tol_du=0.0))
    x0s = np.clip(0.65 + 0.1 * np.random.default_rng(1).standard_normal((6, 4)), 0.3,
                  1.3).astype(np.float32)
    ts, _, _, _ = tpar.solve_batch(tc, torch.from_numpy(x0s))
    js, _, _, _ = jpar.solve_batch(jc, jnp.asarray(x0s))
    np.testing.assert_array_equal(ts.iterations.numpy(), np.asarray(js.iterations))
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), atol=U_TOL)


def test_update_references_keeps_costs():
    """update_references re-designs with the cost callables and the
    EmpcConfig, as the JAX package's does."""
    jsys, tsys = _linear()
    jc, tc = _bench_pair(dict(max_sqp_iter=15))
    tn = tmpc.update_references(tc, np.full(4, 0.7, np.float32), U_REF)
    assert isinstance(tn.engine, EmpcEngine)
    assert tn.engine.cost_fn is tc.engine.cost_fn and tn.engine.config == tc.engine.config
    assert float(tn.tuning.references.x[0, 0]) == pytest.approx(0.7)
