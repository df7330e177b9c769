"""The port's SQP (single and multiple shooting) and the runtime over an
SQP engine against the JAX package, on the CPU.

The plant is the golden's frozen fnn (tests/golden/qtp_nl_golden.npz,
160 raveled floats), carried across by ``interop.unravel_params``; the
states are suite config 3's, made with numpy from a seed. The SQP u within
1e-3 of the JAX package's with equal statuses.

Iteration counts: after the first SQP iteration (u equal to ~5e-6) the
line-search merits of the candidates differ by ~1e-5 relative, the fp32
noise of a rollout's objective, so which step wins, and so the iteration
at which a lane's step falls under tol_du = 1e-5, follows each package's
roundoff. The JAX package does not reproduce its own counts either: its
eager and jitted solve_batch differ by up to 0.75 in the mean count over
8 lanes and by 6.4e-4 in u (scripts/sqp_count_roundoff.py). The counts are held
equal at a fixed budget and, at convergence, in their mean to 1.5
iterations of the jitted JAX solve's."""

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
from automationlabsmodelpredictivecontrol_jl_tpu.solvers.sqp import SqpConfig as JSqp

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import interop
from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
from automationlabsmodelpredictivecontrol_jl_torch import runtime as trt
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.models import zoo as tzoo

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
_GOLDEN = np.load(os.path.join(GOLDEN_DIR, "qtp_nl_golden.npz"))
with open(os.path.join(GOLDEN_DIR, "qtp_nl_golden_meta.json")) as f:
    _META = json.load(f)
X_REF, U_REF = [0.65] * 4, [1.2] * 2
B = 8


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




# ---------------------------------------------------------------- the SQP


def _jax_fleet(jc, x0):
    """The JAX package's solve_batch, jitted (quicker than its eager form)."""
    return jax.jit(lambda x: jpar.solve_batch(jc, x))(jnp.asarray(x0))


SQP_CASES = [
    ("single", 5, {}),
    ("single", 10, {"mpc_state_constraint": True}),
    ("multiple", 5, {}),
    ("multiple", 10, {"mpc_terminal_ingredient": "contractive"}),
]


@pytest.mark.parametrize("shooting,N,kw", SQP_CASES,
                         ids=[f"{s}-h{n}-{'-'.join(k) or 'box'}" for s, n, k in SQP_CASES])
def test_sqp_fleet_matches_jax(plants, shooting, N, kw):
    """solve_batch over 8 lanes of suite config 3's states (max_sqp_iter 8
    single, 12 multiple): u within 1e-3, statuses equal, every lane
    converged, mean iterations within 1.5 (module docstring)."""
    js, ts = plants
    it = 8 if shooting == "single" else 12
    jc = jmpc.proceed_controller(js, "model_predictive_control", N, 5.0, np.asarray(X_REF),
                                 np.asarray(U_REF), sqp_config=JSqp(shooting=shooting, max_sqp_iter=it), **kw)
    tc = tmpc.proceed_controller(ts, "model_predictive_control", N, 5.0, X_REF, U_REF,
                                 sqp_config=tmpc.SqpConfig(shooting=shooting, max_sqp_iter=it),
                                 device="cpu", **kw)
    assert isinstance(tc.engine, tmpc.SqpEngine) and tc.tuning.programming_type == "non_linear"
    assert not tpar.fused_supported(tc)
    x0 = _x0s(B, seed=N)
    jsol, _, _, _ = _jax_fleet(jc, x0)
    tsol, _, _, td = tpar.solve_batch(tc, torch.from_numpy(x0))
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), atol=1e-3)
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x), atol=1e-3)
    np.testing.assert_array_equal(tsol.status.numpy(), np.asarray(jsol.status))
    assert int(td.n_converged) == B
    ti, ji = tsol.iterations.numpy(), np.asarray(jsol.iterations)
    assert abs(ti.mean() - ji.mean()) <= 1.5 and 1 <= ti.min() and ti.max() <= it


def test_sqp_fixed_budget_iterations_match_jax(plants):
    """At a budget the lanes cannot meet (one SQP iteration), every count
    equals the budget in both packages and u agrees to 2e-5."""
    js, ts = plants
    jc = jmpc.proceed_controller(js, "model_predictive_control", 10, 5.0, np.asarray(X_REF),
                                 np.asarray(U_REF), sqp_config=JSqp(max_sqp_iter=1))
    tc = tmpc.proceed_controller(ts, "model_predictive_control", 10, 5.0, X_REF, U_REF,
                                 sqp_config=tmpc.SqpConfig(max_sqp_iter=1), device="cpu")
    x0 = _x0s(B, seed=3)
    jsol, jwz, _, _ = _jax_fleet(jc, x0)
    tsol, twz, _, _ = tpar.solve_batch(tc, torch.from_numpy(x0))
    np.testing.assert_array_equal(tsol.iterations.numpy(), np.asarray(jsol.iterations))
    np.testing.assert_array_equal(tsol.status.numpy(), np.asarray(jsol.status))
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), atol=2e-5)
    np.testing.assert_allclose(twz.numpy(), np.asarray(jwz), atol=2e-5)


# ---------------------------------------------------------------- runtime


def test_runtime_over_sqp_engine(plants):
    """solve_once, step, update_references, closed_loop_batch and
    init_warm_batch on an SQP engine: shapes, the shifted warm carry,
    update_references against the JAX package's re-design (soft boxes and
    the SqpConfig kept), and a 3-step closed loop of the learned plant."""
    js, ts = plants
    cfg = tmpc.SqpConfig(max_sqp_iter=8)
    c = tmpc.proceed_controller(ts, "model_predictive_control", 10, 5.0, X_REF, U_REF,
                                sqp_config=cfg, mpc_soft_state_constraint=10.0, device="cpu")
    assert c.engine.soft_boxes and c.engine.config.soft_state_penalty == 10.0
    x0 = torch.full((4,), 0.6)
    sol, wz, wy = trt.solve_once(c, x0, c.warm_z, c.warm_y)
    assert sol.u.shape == (2, 10) and sol.x.shape == (4, 11) and int(sol.status) == 0
    torch.testing.assert_close(wz.reshape(10, 2)[:-1], sol.u.T[1:], rtol=0, atol=0)
    c2, sol2 = tmpc.step(c, x0)
    torch.testing.assert_close(sol2.u, sol.u, rtol=0, atol=0)
    assert torch.equal(c2.warm_z, wz)

    c3 = tmpc.update_references(c2, [0.7] * 4, [1.3] * 2)
    assert c3.engine == c.engine and torch.equal(c3.warm_z, c2.warm_z)
    jc = jmpc.proceed_controller(js, "model_predictive_control", 10, 5.0, np.asarray(X_REF),
                                 np.asarray(U_REF), sqp_config=JSqp(max_sqp_iter=8),
                                 mpc_soft_state_constraint=10.0)
    jc3 = jmpc.update_references(jc, jnp.full(4, 0.7), jnp.full(2, 1.3))
    _close(c3.tuning.terminal.P, jc3.tuning.terminal.P, 1e-5)
    _close(c3.tuning.references.x, jc3.tuning.references.x, 0)

    ms = tmpc.proceed_controller(ts, "model_predictive_control", 5, 5.0, X_REF, U_REF,
                                 sqp_config=tmpc.SqpConfig(shooting="multiple"), device="cpu")
    assert ms.warm_z.shape == (5 * 2 + 6 * 4,) and ms.warm_y.shape == (6 * 4 + 5 * 2,)
    wz_b, wy_b = tpar.init_warm_batch(ms, 3)
    assert wz_b.shape == (3, 34) and wy_b.shape == (3, 34)
    x0s = torch.from_numpy(_x0s(3, seed=11))
    xs, us, st = tpar.closed_loop_batch(ms, ts.step, x0s, 3)
    assert xs.shape == (4, 3, 4) and us.shape == (3, 3, 2) and st.shape == (3, 3)
    assert bool((st == 0).all()) and bool(torch.isfinite(xs).all())
    torch.testing.assert_close(xs[1], ts.step(x0s, us[0]), rtol=0, atol=0)


def test_sqp_design_guards(plants):
    _, ts = plants
    with pytest.raises(ValueError):
        tmpc.proceed_controller(ts, "model_predictive_control", 5, 5.0, X_REF, U_REF,
                                sqp_config=tmpc.SqpConfig(shooting="multiple"),
                                mpc_terminal_ingredient="neighborhood", device="cpu")
    with pytest.raises(ValueError):
        tmpc.proceed_controller(ts, "model_predictive_control", 5, 5.0, X_REF, U_REF,
                                sqp_config=tmpc.SqpConfig(shooting="multiple"), mpc_S=0.1,
                                device="cpu")
    with pytest.raises(ValueError):
        tmpc.proceed_controller(ts, "model_predictive_control", 5, 5.0, X_REF, U_REF,
                                sqp_config=tmpc.SqpConfig(shooting="triple"), device="cpu")
    # as in the JAX package: an EmpcConfig without a cost function leaves
    # the tracking SQP, and mixed_linear on the (relu) fnn designs the MILP
    # engine with the same search dimension
    js, _ = plants
    c = tmpc.proceed_controller(ts, "model_predictive_control", 5, 5.0, X_REF, U_REF,
                                empc_config=object(), device="cpu")
    assert isinstance(c.engine, tmpc.SqpEngine)
    c = tmpc.proceed_controller(ts, "model_predictive_control", 5, 5.0, X_REF, U_REF,
                                mpc_programming_type="mixed_linear", device="cpu")
    jc = jmpc.proceed_controller(js, "model_predictive_control", 5, 5.0, np.asarray(X_REF),
                                 np.asarray(U_REF), mpc_programming_type="mixed_linear")
    assert type(c.engine).__name__ == type(jc.engine).__name__ == "MilpEngine"
    assert c.engine.n_binary == jc.engine.n_binary


def test_learned_entry_points_default_to_the_card(plants, tmp_path):
    """Without ``device=`` a learned plant's controllers (SQP and
    linearized), a checkpoint load and the training data ask for the card,
    and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import training

    _, ts = plants
    for kw in ({}, {"mpc_programming_type": "linear"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmpc.proceed_controller(ts, "model_predictive_control", 5, 5.0, X_REF, U_REF, **kw)
    c = tmpc.proceed_controller(ts, "model_predictive_control", 5, 5.0, X_REF, U_REF,
                                device="cpu")
    path = str(tmp_path / "c.npz")
    tmpc.save_controller(path, c)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmpc.load_controller(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        training.generate_qtp_dataset(n_traj=2, n_steps=2)
