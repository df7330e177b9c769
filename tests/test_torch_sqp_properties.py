"""The port's SQP on the properties the JAX package's own tests hold
(tests/test_multiple_shooting.py, tests/test_sqp_status.py), on the same
plants: the JAX package's initial fnn weights carried across by
``interop.params_from_numpy``, and the same open-loop-unstable user
function (spectral radius 1.8), on the CPU.

- multiple shooting agrees with single shooting (1e-2, the JAX test's
  bar) and closes the dynamics (defects under feas_tol);
- on the unstable plant at h30 multiple shooting stabilizes a 10-step
  closed loop (final |x| < 0.05) where single shooting does not (> 1), and
  its open-loop plan at h20 ends at the origin (1e-4);
- the status gate: an unreachable terminal equality reports a non-
  converged status with its violation (> 1e-3) as the primal residual; a
  feasible problem converges with a residual under 1e-4."""

import jax
import numpy as np
import pytest
import torch

from automationlabsmodelpredictivecontrol_jl_tpu.models import zoo as jzoo

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import interop
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp
from automationlabsmodelpredictivecontrol_jl_torch.models import zoo
from automationlabsmodelpredictivecontrol_jl_torch.types import STATUS_CONVERGED, Box, f32

torch.set_num_threads(1)

X_REF, U_REF = [0.65] * 4, [1.2] * 2


def _fnn(seed, hidden, depth, sample_time=1.0):
    """The JAX package's initial fnn of PRNGKey(seed) as a port plant."""
    _, params = jzoo.init_model("fnn", jax.random.PRNGKey(seed), 4, 2, hidden=hidden,
                                depth=depth, sample_time=sample_time)
    apply_fn, act = zoo.make_apply("fnn")
    tree = jax.tree_util.tree_map(np.asarray, params)
    return tmpc.NeuralDiscreteSystem(
        apply_fn=apply_fn, family="fnn", nx=4, nu=2,
        params=interop.params_from_numpy("fnn", tree), X=qtp.x_box(), U=qtp.u_box(),
        activation=act,
    )


@pytest.fixture(scope="module")
def unstable():
    """x+ = A x + B u + 0.05 tanh(x), A = [[1.8, 0.3], [0, 1.5]]: a single-
    shooting rollout amplifies ~1.8^N."""
    A = f32([[1.8, 0.3], [0.0, 1.5]])
    B = f32([[0.0], [1.0]])

    def f(x, u):
        return x @ A.T + u @ B.T + 0.05 * torch.tanh(x)

    box = lambda v, n: Box(lo=f32([-v] * n), hi=f32([v] * n))
    return tmpc.user_function_system(f, 2, 1, box(50.0, 2), box(40.0, 1)), f


def test_ms_matches_single_shooting():
    plant = _fnn(0, 16, 2)
    x0 = torch.full((4,), 0.6)
    sols = {}
    for shooting in ("single", "multiple"):
        c = tmpc.proceed_controller(plant, "model_predictive_control", 10, 5.0, X_REF, U_REF,
                                    sqp_config=tmpc.SqpConfig(shooting=shooting), device="cpu")
        _, sols[shooting] = tmpc.step(c, x0)
    assert int(sols["single"].status) == 0 and int(sols["multiple"].status) == 0
    np.testing.assert_allclose(sols["multiple"].u.numpy(), sols["single"].u.numpy(), atol=1e-2)
    assert float(sols["multiple"].primal_residual) < 1e-4


def test_ms_stabilizes_unstable_plant_where_single_fails(unstable):
    system, f = unstable
    x0 = torch.tensor([1.0, -0.5])

    def closed_loop(shooting, steps=10):
        c = tmpc.proceed_controller(
            system, "model_predictive_control", 30, 1.0, [0.0, 0.0], [0.0],
            mpc_programming_type="non_linear", device="cpu",
            sqp_config=tmpc.SqpConfig(shooting=shooting, max_sqp_iter=20),
        )
        x = x0
        for _ in range(steps):
            c, s = tmpc.step(c, x)
            x = f(x, s.u[:, 0])
        return float(x.abs().max()), s

    final_ms, s_ms = closed_loop("multiple")
    final_ss, _ = closed_loop("single")
    assert float(s_ms.primal_residual) < 1e-4
    assert final_ms < 0.05
    assert final_ss > 1.0


def test_ms_open_loop_plan_reaches_origin(unstable):
    system, _ = unstable
    c = tmpc.proceed_controller(
        system, "model_predictive_control", 20, 1.0, [0.0, 0.0], [0.0],
        mpc_programming_type="non_linear", device="cpu",
        sqp_config=tmpc.SqpConfig(shooting="multiple", max_sqp_iter=20),
    )
    _, s = tmpc.step(c, torch.tensor([1.0, -0.5]))
    assert int(s.status) == 0
    assert float(s.x[:, -1].abs().max()) < 1e-4


def test_stalled_violating_sqp_reports_nonconverged_nonzero_residual():
    plant = _fnn(7, 6, 1, sample_time=5.0)
    c = tmpc.proceed_controller(plant, "model_predictive_control", 3, 5.0, X_REF, U_REF,
                                mpc_programming_type="non_linear",
                                mpc_terminal_ingredient="equality", device="cpu")
    _, sol = tmpc.step(c, torch.tensor([0.25, 0.25, 1.25, 1.25]))
    assert int(sol.status) != STATUS_CONVERGED
    assert float(sol.primal_residual) > 1e-3


def test_feasible_sqp_still_converges_with_small_residual():
    plant = _fnn(7, 6, 1, sample_time=5.0)
    c = tmpc.proceed_controller(plant, "model_predictive_control", 5, 5.0, X_REF, U_REF,
                                mpc_programming_type="non_linear", device="cpu")
    _, sol = tmpc.step(c, torch.full((4,), 0.6))
    assert int(sol.status) == STATUS_CONVERGED
    assert float(sol.primal_residual) <= 1e-4
