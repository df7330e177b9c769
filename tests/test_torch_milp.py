"""The exact-ReLU MILP engine (``solvers/milp.py``) and the native branch
and bound bindings (``native_qp``), port against the JAX package.

The models carry the JAX package's weights (``interop.params_from_numpy``).
Both packages transcribe them in float64 numpy and solve on the same C++
source (``native/qpref/qpref.cpp``), the port's library built with its own
g++ flags (no ``-march=native``), so results may differ at roundoff:
statuses are held equal, objectives within 1e-6 relative, u within 1e-5;
node counts are held equal (none differed on these problems).
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu import io as jio
from automationlabsmodelpredictivecontrol_jl_tpu import native_qp as jnative
from automationlabsmodelpredictivecontrol_jl_tpu import parallel as jpar
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.solvers import milp as jmilp

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import interop
from automationlabsmodelpredictivecontrol_jl_torch import io as tio
from automationlabsmodelpredictivecontrol_jl_torch import native_qp as tnative
from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.models import zoo as tzoo
from automationlabsmodelpredictivecontrol_jl_torch.solvers import milp as tmilp
from automationlabsmodelpredictivecontrol_jl_torch.types import STATUS_PRIMAL_INFEASIBLE

torch.set_num_threads(1)

X_REF = np.full(4, 0.65, np.float32)
U_REF = np.full(2, 1.2, np.float32)
X0 = np.full(4, 0.6, np.float32)
OBJ_REL, U_TOL = 1e-6, 1e-5


def _systems(family, hidden=3, depth=1, seed=1):
    """A zoo model with the JAX package's random weights, in both."""
    japply, jp = jmpc.init_model(family, jax.random.PRNGKey(seed), 4, 2, hidden=hidden,
                                 depth=depth, sample_time=5.0)
    js = jmpc.NeuralDiscreteSystem(apply_fn=japply, family=family, nx=4, nu=2, params=jp,
                                   X=jqtp.X_BOX, U=jqtp.U_BOX)
    tapply, act = tzoo.make_apply(family)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    ts = tmpc.NeuralDiscreteSystem(apply_fn=tapply, family=family, nx=4, nu=2,
                                   params=interop.params_from_numpy(family, tree),
                                   X=tqtp.x_box(), U=tqtp.u_box(), activation=act)
    return js, ts


def _pair(family, N=2, sys_kw=None, **kw):
    js, ts = _systems(family, **(sys_kw or {}))
    jc = jmpc.proceed_controller(js, "model_predictive_control", N, 5.0, X_REF, U_REF,
                                 mpc_programming_type="mixed_linear", **kw)
    tc = tmpc.proceed_controller(ts, "model_predictive_control", N, 5.0, X_REF, U_REF,
                                 mpc_programming_type="mixed_linear", device="cpu", **kw)
    return jc, tc


def _same(tsol, jsol):
    np.testing.assert_array_equal(np.asarray(tsol.status), np.asarray(jsol.status))
    np.testing.assert_array_equal(np.asarray(tsol.iterations), np.asarray(jsol.iterations))
    np.testing.assert_allclose(tsol.objective.numpy(), np.asarray(jsol.objective), rtol=OBJ_REL)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), atol=U_TOL)


@pytest.mark.parametrize("family", tmilp.MILP_FAMILIES)
def test_transcription_matches_apply_fn(family):
    """The affine/ReLU trace of one step reproduces the port's apply_fn,
    and it is the JAX package's trace."""
    js, ts = _systems(family, hidden=4, depth=2)
    tr, out = tmilp._transcribe_step(family, ts.params, 4, 2)
    jtr, jout = jmilp._transcribe_step(family, js.params, 4, 2)
    assert len(tr.units) == len(jtr.units)
    for a, b in zip(tr.units + [out], jtr.units + [jout]):
        np.testing.assert_allclose(a.M, b.M, rtol=1e-7, atol=1e-7)
        np.testing.assert_allclose(a.c, b.c, rtol=1e-7, atol=1e-7)
    rng = np.random.default_rng(3)
    for _ in range(8):
        x, u = rng.standard_normal(4), rng.standard_normal(2)
        want = ts.step(torch.from_numpy(x.astype(np.float32)),
                       torch.from_numpy(u.astype(np.float32))).numpy()
        np.testing.assert_allclose(tmilp._eval_transcription(tr, out, x, u), want, atol=1e-4)


def test_design_routing():
    jc, tc = _pair("fnn")
    assert isinstance(tc.engine, tmilp.MilpEngine)
    assert tc.tuning.solver_name == "scip" and tc.tuning.programming_type == "mixed_linear"
    assert tc.engine.n_binary == jc.engine.n_binary > 0
    np.testing.assert_allclose(tc.engine.A, jc.engine.A, rtol=1e-7, atol=1e-9)
    assert tc.warm_z.shape == (tc.engine.n,) and tc.warm_y.shape == (tc.engine.m,)


def test_rejections():
    """A linear plant, a family without a ReLU transcription (rbf) and a
    contractive terminal (quadratic) are refused, as in the JAX package."""
    with pytest.raises(ValueError, match="ReLU-network"):
        tmpc.proceed_controller(tqtp.linearized_discrete_system(), "model_predictive_control",
                                2, 5.0, X_REF, U_REF, mpc_programming_type="mixed_linear",
                                device="cpu")
    _, ts = _systems("rbf")
    with pytest.raises(ValueError):
        tmpc.proceed_controller(ts, "model_predictive_control", 2, 5.0, X_REF, U_REF,
                                mpc_programming_type="mixed_linear", device="cpu")
    _, ts = _systems("fnn")
    with pytest.raises(ValueError, match="contractive"):
        tmpc.proceed_controller(ts, "model_predictive_control", 2, 5.0, X_REF, U_REF,
                                mpc_programming_type="mixed_linear",
                                mpc_terminal_ingredient="contractive", device="cpu")


def test_exact_dynamics_and_feasible():
    """The global optimum follows the true network and keeps the input box;
    status, nodes, objective and u as the JAX package's."""
    jc, tc = _pair("fnn")
    _, sol = tmpc.step(tc, torch.from_numpy(X0))
    _, jsol = jmpc.step(jc, jnp.asarray(X0))
    assert int(sol.status) == 0
    _same(sol, jsol)
    x, u = sol.x, sol.u
    for k in range(2):
        torch.testing.assert_close(x[:, k + 1], tc.system.step(x[:, k], u[:, k]), rtol=0,
                                   atol=1e-5)
    assert bool((u.T <= tqtp.u_box().hi + 1e-7).all() and (u.T >= tqtp.u_box().lo - 1e-7).all())


def test_global_at_least_as_good_as_sqp():
    _, ts = _systems("fnn")
    _, tc = _pair("fnn")
    _, sol_bb = tmpc.step(tc, torch.from_numpy(X0))
    c_nl = tmpc.proceed_controller(ts, "model_predictive_control", 2, 5.0, X_REF, U_REF,
                                   device="cpu")
    _, sol_nl = tmpc.step(c_nl, torch.from_numpy(X0))
    assert int(sol_bb.status) == 0
    assert float(sol_bb.objective) <= float(sol_nl.objective) * (1 + 1e-4) + 1e-3


def test_infeasible_detection():
    """A random net cannot keep the QTP levels in their box: the status says
    so, as the JAX package's does."""
    jc, tc = _pair("fnn", mpc_state_constraint=True)
    _, sol = tmpc.step(tc, torch.from_numpy(X0))
    _, jsol = jmpc.step(jc, jnp.asarray(X0))
    assert int(sol.status) == int(jsol.status) == STATUS_PRIMAL_INFEASIBLE


@pytest.mark.parametrize("family,kw", [("densenet", dict(mpc_S=0.05)),
                                       ("resnet", dict(mpc_terminal_ingredient="equality")),
                                       ("icnn", {}), ("polynet", {})])
def test_families_and_rows_match_jax(family, kw):
    """The input-rate weight, the terminal equality and the other families
    flow through the condensed assembly as in the JAX package."""
    jc, tc = _pair(family, **kw)
    _, sol = tmpc.step(tc, torch.from_numpy(X0))
    _, jsol = jmpc.step(jc, jnp.asarray(X0))
    assert int(sol.status) in (0, 1, 2)
    np.testing.assert_array_equal(int(sol.status), int(jsol.status))
    if int(sol.status) != STATUS_PRIMAL_INFEASIBLE:
        _same(sol, jsol)


def test_time_limit_returns_promptly():
    """mpc_max_time bounds the search: a tiny budget returns at once with
    the optimal or the limit status."""
    _, tc = _pair("densenet", N=4, sys_kw=dict(hidden=6, depth=2, seed=7), mpc_max_time=1e-9)
    t0 = time.monotonic()
    _, sol = tmpc.step(tc, torch.from_numpy(X0))
    assert time.monotonic() - t0 < 20.0
    assert int(sol.status) in (0, 1)


def test_batch_matches_single_lanes_and_jax():
    """parallel.solve_batch runs the lanes in threads: each lane is its
    single solve, and the fleet is the JAX package's; the warm pair comes
    back as it went in."""
    jc, tc = _pair("fnn", N=3, sys_kw=dict(seed=2))
    rng = np.random.default_rng(5)
    x0s = np.clip(0.65 + 0.05 * rng.standard_normal((4, 4)), 0.3, 1.3).astype(np.float32)
    sol, wz, wy, d = tpar.solve_batch(tc, torch.from_numpy(x0s))
    assert int(d.n_total) == 4 and tuple(sol.u.shape) == (4, 2, 3)
    assert torch.equal(wz[0], tc.warm_z) and torch.equal(wy[0], tc.warm_y)
    for k in range(4):
        s1, _, _ = tmpc.solve_once(tc, torch.from_numpy(x0s[k]), tc.warm_z, tc.warm_y)
        torch.testing.assert_close(sol.u[k], s1.u, rtol=0, atol=1e-6)
        assert int(sol.status[k]) == int(s1.status)
    jsol, _, _, _ = jpar.solve_batch(jc, jnp.asarray(x0s))
    _same(sol, jsol)


def test_closed_loop_batch_refuses():
    """The closed loop refuses the host branch and bound, as the JAX
    package's traced loop does."""
    _, tc = _pair("fnn")
    with pytest.raises(TypeError, match="MILP"):
        tpar.closed_loop_batch(tc, tc.system.step, torch.from_numpy(X0[None]), 2)


def test_checkpoint_round_trip(tmp_path):
    """A MILP controller saves and loads by re-design in either package."""
    _, tc = _pair("fnn")
    path = str(tmp_path / "milp.npz")
    tio.save_controller(path, tc)
    c2 = tio.load_controller(path, device="cpu")
    assert isinstance(c2.engine, tmilp.MilpEngine)
    np.testing.assert_array_equal(c2.engine.A, tc.engine.A)
    jc = jio.load_controller(path)
    assert type(jc.engine).__name__ == "MilpEngine" and jc.engine.n_binary == tc.engine.n_binary
    tn = tmpc.update_references(tc, np.full(4, 0.7, np.float32), U_REF)
    assert isinstance(tn.engine, tmilp.MilpEngine)


def _random_qp(seed, n=8, m=12):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    P = M @ M.T + 0.1 * np.eye(n)
    A = rng.normal(size=(m, n))
    Az = A @ rng.normal(size=n)
    slack = rng.uniform(0.1, 1.0, size=m)
    return P, rng.normal(size=n), A, Az - slack, Az + slack


def test_native_ipm_and_batch_match_jax():
    """solve_qp_ipm and solve_qp_batch against the JAX package's bindings
    on the same QPs."""
    P, q, A, l, u = _random_qp(0)
    t = tnative.solve_qp_ipm(P, q, A, l, u)
    j = jnative.solve_qp_ipm(P, q, A, l, u)
    assert t[2] == j[2] == 0
    obj = lambda z: 0.5 * z @ P @ z + q @ z
    np.testing.assert_allclose(obj(t[0]), obj(j[0]), rtol=OBJ_REL)
    np.testing.assert_allclose(t[0], j[0], atol=1e-7)
    rng = np.random.default_rng(1)
    qs = q[None] + 0.05 * rng.normal(size=(6, q.size))
    ls, us = np.tile(l, (6, 1)), np.tile(u, (6, 1))
    tz, _, tst, tit = tnative.solve_qp_batch(P, qs, A, ls, us)
    jz, _, jst, jit = jnative.solve_qp_batch(P, qs, A, ls, us)
    np.testing.assert_array_equal(tst, jst)
    assert (tst == 0).all()
    np.testing.assert_allclose(tz, jz, atol=1e-7)
    np.testing.assert_array_equal(tit, jit)
    with pytest.raises(ValueError):
        tnative.solve_qp_ipm(P, q[:-1], A, l, u)


def test_native_miqp_matches_jax():
    """The generic binary MIQP front end: the JAX package's own case, and a
    random one with four binaries."""
    P, q, A = 2 * np.eye(2), np.array([-1.2, -0.6]), np.eye(2)
    t = tnative.solve_miqp(P, q, A, np.zeros(2), np.ones(2), np.array([0, 1]), np.array([0, 1]))
    j = jnative.solve_miqp(P, q, A, np.zeros(2), np.ones(2), np.array([0, 1]), np.array([0, 1]))
    assert t[2] == j[2] == tnative.MIQP_OPTIMAL
    np.testing.assert_allclose(t[0], [1.0, 0.0], atol=1e-6)
    P, q, A, l, u = _random_qp(4, n=6, m=6)
    A = np.vstack([np.eye(6)[:4], A])
    l = np.concatenate([np.zeros(4), l - 1.0])
    u = np.concatenate([np.ones(4), u + 1.0])
    bins = np.arange(4)
    t = tnative.solve_miqp(P, q, A, l, u, bins, bins)
    j = jnative.solve_miqp(P, q, A, l, u, bins, bins)
    assert t[2] == j[2] and t[3] == j[3]
    np.testing.assert_allclose(t[4], j[4], rtol=OBJ_REL)
    np.testing.assert_allclose(t[0][:4], np.round(t[0][:4]), atol=1e-5)


def test_native_relu_bb_matches_jax(monkeypatch):
    """solve_relu_bb on the problem the MILP engine poses at its root (the
    arguments of the port's own call, captured), through both bindings."""
    _, tc = _pair("fnn", N=3, sys_kw=dict(seed=2))
    calls = []
    real = tnative.solve_relu_bb

    def capture(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(tnative, "solve_relu_bb", capture)
    tmpc.step(tc, torch.from_numpy(X0))
    (args, kw), = calls
    kw = {k: v for k, v in kw.items() if k != "time_limit"}
    t = real(*args, **kw)
    j = jnative.solve_relu_bb(*args, **kw)
    assert t[2] == j[2] in (tnative.MIQP_OPTIMAL, tnative.MIQP_OPTIMAL_TOL)
    assert t[3] == j[3]
    np.testing.assert_allclose(t[4], j[4], rtol=OBJ_REL)
    np.testing.assert_allclose(t[0], j[0], atol=1e-7)
    assert (tnative.MIQP_OPTIMAL, tnative.MIQP_NODE_LIMIT, tnative.MIQP_INFEASIBLE,
            tnative.MIQP_OPTIMAL_TOL) == (jnative.MIQP_OPTIMAL, jnative.MIQP_NODE_LIMIT,
                                          jnative.MIQP_INFEASIBLE, jnative.MIQP_OPTIMAL_TOL)


def test_native_argtypes_match_jax():
    """Every binding declares the JAX package's ctypes signature."""
    tl, jl = tnative._load(), jnative._load()
    for name in ("qpref_solve", "qpref_solve_ipm", "qpref_solve_batch", "qpref_solve_miqp",
                 "qpref_solve_relu_bb"):
        assert getattr(tl, name).argtypes == getattr(jl, name).argtypes, name
        assert getattr(tl, name).restype == getattr(jl, name).restype
    assert os.path.dirname(tnative.LIB_PATH) != os.path.dirname(jnative._LIB_PATH)
