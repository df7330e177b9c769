"""Takagi-Sugeno fuzzy MPC (``mpc_programming_type="fuzzy_linear"``), port
against the JAX package.

Both packages blend the same two local QTP linearizations (levels 0.4 and
0.9, the JAX package's ``tests/test_fuzzy.py`` and its extra benchmarks'
fuzzy row) and solve them with the SQP. After its second iteration the SQP's
line search picks among candidates whose merits tie at ~1e-5 relative, so
the iterate a lane stops at follows fp32 roundoff: on 8 lanes at h10 the
JAX package's own eager and jitted solves differ by up to 1.6e-3 in u at
equal objectives (``scripts/sqp_count_roundoff.py``). The tests hold u
within 1e-3 where that cannot happen (a single step at h5, a fixed budget of
two iterations), and statuses with the objective elsewhere.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu import parallel as jpar
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.solvers.sqp import SqpConfig as JSqp

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp

torch.set_num_threads(1)

X_REF = np.full(4, 0.65, np.float32)
U_REF = np.full(2, 1.2, np.float32)
U_TOL = 1e-3
B = 8


def _ts_arrays():
    lo = jqtp.linearized_discrete_system(x_op=np.full(4, 0.4))
    hi = jqtp.linearized_discrete_system(x_op=np.full(4, 0.9))
    return dict(
        As=np.stack([np.asarray(lo.A), np.asarray(hi.A)]),
        Bs=np.stack([np.asarray(lo.B), np.asarray(hi.B)]),
        centers=np.array([[0.4] * 4, [0.9] * 4], np.float32),
        widths=np.array([0.25, 0.25], np.float32),
    )


@pytest.fixture(scope="module")
def plants():
    a = _ts_arrays()
    js = jmpc.takagi_sugeno_system(**{k: jnp.asarray(v) for k, v in a.items()},
                                   X=jqtp.X_BOX, U=jqtp.U_BOX)
    ts = tmpc.takagi_sugeno_system(**a, X=tqtp.x_box(), U=tqtp.u_box())
    return js, ts


def _pair(plants, N, sqp=None, **kw):
    js, ts = plants
    jc = jmpc.proceed_controller(js, "model_predictive_control", N, 5.0, X_REF, U_REF,
                                 mpc_programming_type="fuzzy_linear",
                                 sqp_config=None if sqp is None else JSqp(**sqp), **kw)
    tc = tmpc.proceed_controller(ts, "model_predictive_control", N, 5.0, X_REF, U_REF,
                                 mpc_programming_type="fuzzy_linear",
                                 sqp_config=None if sqp is None else tmpc.SqpConfig(**sqp),
                                 device="cpu", **kw)
    return jc, tc


def _x0s(seed, n=B):
    rng = np.random.default_rng(seed)
    return np.clip(0.65 + 0.1 * rng.standard_normal((n, 4)), 0.3, 1.3).astype(np.float32)


def test_membership_blend(plants):
    """Near a center the blend is that local model; everywhere it is the
    JAX package's, batched over leading axes, with scalar or per-state
    widths."""
    js, ts = plants
    a = _ts_arrays()
    u = np.array([1.2, 1.2], np.float32)
    for i, level in enumerate((0.4, 0.9)):
        x = np.full(4, level, np.float32)
        want = a["As"][i] @ x + a["Bs"][i] @ u
        np.testing.assert_allclose(ts.step(torch.from_numpy(x), torch.from_numpy(u)).numpy(),
                                   want, atol=1e-3)
    rng = np.random.default_rng(0)
    x = rng.uniform(0.2, 1.2, (3, 5, 4)).astype(np.float32)
    uu = rng.uniform(0.0, 3.0, (3, 5, 2)).astype(np.float32)
    got = ts.step(torch.from_numpy(x), torch.from_numpy(uu)).numpy()
    assert got.shape == (3, 5, 4)
    want = np.stack([np.asarray(js.step(jnp.asarray(x[i, j]), jnp.asarray(uu[i, j])))
                     for i in range(3) for j in range(5)]).reshape(3, 5, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    a["widths"] = np.array([[0.2, 0.3, 0.25, 0.35], [0.3, 0.2, 0.4, 0.25]], np.float32)
    js2 = jmpc.takagi_sugeno_system(**{k: jnp.asarray(v) for k, v in a.items()},
                                    X=jqtp.X_BOX, U=jqtp.U_BOX)
    ts2 = tmpc.takagi_sugeno_system(**a, X=tqtp.x_box(), U=tqtp.u_box())
    np.testing.assert_allclose(
        ts2.step(torch.from_numpy(x[0, 0]), torch.from_numpy(uu[0, 0])).numpy(),
        np.asarray(js2.step(jnp.asarray(x[0, 0]), jnp.asarray(uu[0, 0]))), rtol=1e-5, atol=1e-6)
    assert ts.family == "takagi_sugeno" and (ts.nx, ts.nu) == (4, 2)


def test_design_and_step(plants):
    """fuzzy_linear designs the SQP (solver name ipopt), and a step at h5
    agrees with the JAX package's."""
    jc, tc = _pair(plants, 5)
    assert isinstance(tc.engine, tmpc.SqpEngine)
    assert tc.tuning.programming_type == "fuzzy_linear" and tc.tuning.solver_name == "ipopt"
    x = np.full(4, 0.6, np.float32)
    tc, ts = tmpc.step(tc, torch.from_numpy(x))
    jc, js = jmpc.step(jc, jnp.asarray(x))
    assert int(ts.status) == int(js.status) == 0
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), atol=U_TOL)
    assert int(ts.iterations) == int(js.iterations)


def test_closed_loop_tracks(plants):
    """Eight steps at h8 on the true plant bring the levels toward the
    reference (the JAX package's test), every step converged."""
    _, tc = _pair(plants, 8)
    x = torch.tensor([0.5, 0.5, 0.7, 0.7])
    err0 = float((x - 0.65).abs().max())
    for _ in range(8):
        tc, sol = tmpc.step(tc, x)
        assert int(sol.status) == 0
        x = tqtp.qtp_discrete_step(x, sol.u[:, 0])
    assert float((x - 0.65).abs().max()) < err0


def test_fleet_fixed_budget(plants):
    """solve_batch at h10 with two SQP iterations on every lane (no early
    stop): u, counts and statuses as the JAX package's."""
    jc, tc = _pair(plants, 10, sqp=dict(max_sqp_iter=2, tol_du=0.0))
    x0 = _x0s(1)
    ts, _, _, _ = tpar.solve_batch(tc, torch.from_numpy(x0))
    js, _, _, _ = jpar.solve_batch(jc, jnp.asarray(x0))
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_array_equal(ts.iterations.numpy(), np.asarray(js.iterations))
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), atol=U_TOL)


def test_fleet_converges_as_jax(plants):
    """solve_batch at h10 with the default SqpConfig (the benchmark's row):
    every lane converged in both, objectives within 1e-5 relative, the mean
    count within 1.5 (the line search's merit ties decide the counts)."""
    jc, tc = _pair(plants, 10)
    x0 = _x0s(0)
    ts, twz, twy, td = tpar.solve_batch(tc, torch.from_numpy(x0))
    js, _, _, jd = jpar.solve_batch(jc, jnp.asarray(x0))
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    assert int(td.n_converged) == B
    np.testing.assert_allclose(ts.objective.numpy(), np.asarray(js.objective), rtol=1e-5)
    assert abs(float(td.mean_iterations) - float(jd.mean_iterations)) <= 1.5
    assert twz.shape == (B, 20) and bool(torch.isfinite(twy).all())


def test_closed_loop_batch(plants):
    """parallel.closed_loop_batch over the fuzzy model itself as the plant
    (its step takes the batch)."""
    _, tc = _pair(plants, 5)
    _, ts = plants
    xs, us, st = tpar.closed_loop_batch(tc, ts.step, torch.from_numpy(_x0s(2, 4)), 3)
    assert tuple(xs.shape) == (4, 4, 4) and tuple(us.shape) == (3, 4, 2)
    assert bool(torch.isfinite(xs).all()) and bool((st == 0).all())
