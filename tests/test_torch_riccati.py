"""Port vs JAX: the Riccati engine's design half and the fused driver's
helpers. The factorization is the same numpy f64 code in both packages, so
the stored f32 factors agree bit for bit; the rollout and the projection are
held against the JAX functions, vmapped over lanes, on inputs made with
numpy from a seed."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu import design as jdesign
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops import riccati as jric

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import design as tdesign
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati as tric

torch.set_num_threads(1)

X_REF = [0.65] * 4
U_REF = [1.2] * 2
KINDS = {
    "none": dict(),
    "equality": dict(mpc_terminal_ingredient="equality"),
    "contractive": dict(mpc_terminal_ingredient="contractive"),
    "state": dict(mpc_state_constraint=True),
}
FLAGS = ("N", "nx", "nu", "split_interior", "split_terminal", "terminal_ball", "term_rho_scale")
BOUNDS = ("Q", "P_term", "R_in", "x_lo", "x_hi", "xN_lo", "xN_hi", "u_lo", "u_hi")


def _pair(horizon, engine="riccati", **kw):
    jc = jmpc.proceed_controller(
        jqtp.linearized_discrete_system(), "model_predictive_control", horizon, 5.0,
        np.asarray(X_REF), np.asarray(U_REF), engine=engine, **kw,
    )
    tc = tmpc.proceed_controller(
        tqtp.linearized_discrete_system(), "model_predictive_control", horizon, 5.0,
        X_REF, U_REF, engine=engine, device="cpu", **kw,
    )
    return jc, tc


@pytest.fixture(scope="module")
def designs():
    return {}


def _design(designs, horizon, kind):
    if (horizon, kind) not in designs:
        designs[(horizon, kind)] = _pair(horizon, **KINDS[kind])
    return designs[(horizon, kind)]


def _bits_equal(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32, name
    assert np.array_equal(a.view(np.int32), b.view(np.int32)), name


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("horizon", [5, 12, 500])
def test_operator_matches_jax_bitwise(designs, horizon, kind):
    jc, tc = _design(designs, horizon, kind)
    assert isinstance(jc.engine, jdesign.RiccatiEngine)
    assert isinstance(tc.engine, tdesign.RiccatiEngine)
    jo, to = jc.engine.op, tc.engine.op
    for name in ("K", "G", "AmBK", "A", "B"):
        _bits_equal(getattr(jo.factors, name), getattr(to.factors, name), name)
    for name in BOUNDS:
        _bits_equal(getattr(jo, name), getattr(to, name), name)
    for name in FLAGS:
        assert getattr(jo, name) == getattr(to, name), name
    assert to.rho_grid == jo.rho_grid and to.rho0 == jo.rho0
    assert to.factors.K.shape == (4, horizon, 2, 4)
    assert tc.engine.config == tric.RiccatiConfig(**dataclasses.asdict(jc.engine.config))
    # the warm state: U (N nu,) and the duals ((N+1) nx + N nu,)
    assert tc.warm_z.shape == jc.warm_z.shape == (horizon * 2,)
    assert tc.warm_y.shape == jc.warm_y.shape == ((horizon + 1) * 4 + horizon * 2,)
    # the kernel's per-entry constants: f32 of rho, 1/rho, rho_t, 1/rho_t
    # computed in f64 from the grid, as the JAX kernel rounds them
    for r, rho in enumerate(to.rho_grid):
        rho_t = min(to.term_rho_scale * rho, 1e3)
        want = np.asarray([rho, 1.0 / rho, rho_t, 1.0 / rho_t], np.float32)
        np.testing.assert_array_equal(to.rho_tab[:, r].numpy(), want)


def test_auto_engine_follows_the_horizon():
    """engine="auto" designs the Riccati engine from RICCATI_AUTO_HORIZON on
    and the condensed one below, in both packages."""
    assert tdesign.RICCATI_AUTO_HORIZON == jdesign.RICCATI_AUTO_HORIZON == 500
    jc, tc = _pair(500, engine="auto")
    assert isinstance(jc.engine, jdesign.RiccatiEngine)
    assert isinstance(tc.engine, tdesign.RiccatiEngine)
    _bits_equal(jc.engine.op.factors.K, tc.engine.op.factors.K, "K")
    jc, tc = _pair(20, engine="auto")
    assert isinstance(jc.engine, jdesign.LinearEngine)
    assert isinstance(tc.engine, tdesign.LinearEngine)
    assert tc.engine.op.diag_a


@pytest.mark.parametrize(
    "kw",
    [dict(mpc_terminal_ingredient="neighborhood"), dict(mpc_S=0.1),
     dict(mpc_soft_state_constraint=10.0)],
    ids=["neighborhood", "S", "soft"],
)
def test_unsupported_riccati_configs_raise(kw):
    with pytest.raises(ValueError, match="riccati engine requires"):
        jmpc.proceed_controller(
            jqtp.linearized_discrete_system(), "model_predictive_control", 6, 5.0,
            np.asarray(X_REF), np.asarray(U_REF), engine="riccati", **kw,
        )
    with pytest.raises(ValueError, match="riccati engine requires"):
        tmpc.proceed_controller(
            tqtp.linearized_discrete_system(), "model_predictive_control", 6, 5.0,
            X_REF, U_REF, engine="riccati", device="cpu", **kw,
        )


def test_feature_gate_and_config_resolution_match():
    for args in [("none", 0.0, None), ("equality", 0.0, None), ("contractive", 0.0, None),
                 ("neighborhood", 0.0, None), ("none", np.eye(2) * 0.1, None),
                 ("none", 0.0, 5.0)]:
        assert tdesign.riccati_supported(*args) == jdesign.riccati_supported(*args), args
    R = np.eye(2, dtype=np.float32) * 0.1
    for cfg in [dict(), dict(rho=3.0), dict(rho_grid=(1.0, 2.0)), dict(rho=0.5, rho_grid=(0.1, 1.0))]:
        a = jric.resolve_config(jric.RiccatiConfig(**cfg), R)
        b = tric.resolve_config(tric.RiccatiConfig(**cfg), R)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), cfg
    with pytest.raises(ValueError, match="does not support terminal kind"):
        tric.build_riccati_operator(
            np.eye(4), np.ones((4, 2)), np.eye(4), R, np.eye(4), 3,
            -np.ones(4), np.ones(4), -np.ones(2), np.ones(2), False, "neighborhood",
        )


def _lane_inputs(N, B, seed):
    rng = np.random.default_rng(seed)
    e0 = (0.1 * rng.standard_normal((B, 4))).astype(np.float32)
    U = (0.2 * rng.standard_normal((B, N, 2))).astype(np.float32)
    V = (0.3 * rng.standard_normal((B, N + 1, 4))).astype(np.float32)
    return e0, U, V


@pytest.mark.parametrize("kind", list(KINDS))
def test_rollout_and_projection_match_jax(designs, kind):
    """rollout_warm (fp64 sums) within fp32 roundoff of JAX's scan;
    project_X equal but for the ball's norm, summed in another order."""
    jc, tc = _design(designs, 12, kind)
    jo, to = jc.engine.op, tc.engine.op
    e0, U, V = _lane_inputs(12, 8, seed=len(kind))
    Xj = jax.vmap(lambda e, u: jric.rollout_warm(jo, e, u))(jnp.asarray(e0), jnp.asarray(U))
    Xt = tric.rollout_warm(to, torch.from_numpy(e0.T.copy()), torch.from_numpy(U.transpose(1, 2, 0).copy()))
    Xj = np.asarray(Xj).transpose(1, 2, 0)
    np.testing.assert_allclose(Xt.numpy(), Xj, rtol=0, atol=1e-6 * max(1.0, np.abs(Xj).max()))
    np.testing.assert_array_equal(Xt[0].numpy(), e0.T)

    e0T = torch.from_numpy(e0.T.copy())
    ballr = tric.ball_radius(to, e0T)
    rj = (jnp.sqrt(0.9) * jnp.linalg.norm(jnp.asarray(e0), axis=1)) if to.terminal_ball else jnp.zeros(8)
    np.testing.assert_allclose(ballr.numpy(), np.asarray(rj), rtol=1e-6)
    Pj = jax.vmap(lambda v, r: jric._project_X(jo, v, r))(jnp.asarray(V), jnp.asarray(ballr.numpy()))
    Pt = tric.project_X(to, torch.from_numpy(V.transpose(1, 2, 0).copy()), ballr)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj).transpose(1, 2, 0), rtol=1e-6, atol=0)
    if to.terminal_ball:  # the ball binds on these wide states
        nrm = np.linalg.norm(Pt[-1].numpy(), axis=0)
        assert np.all(nrm <= ballr.numpy() * (1 + 1e-6))


def test_box_support_matches_jax():
    rng = np.random.default_rng(5)
    d = rng.standard_normal((6, 4, 8)).astype(np.float32)
    d[2] = 0.0
    # lanes 0-3 point away from the infinite rays: finite support
    d[:, 1, :4] = np.abs(d[:, 1, :4])
    d[:, 2, :4] = -np.abs(d[:, 2, :4])
    lo =np.asarray([-1.0, -np.inf, -0.5, -2.0], np.float32)
    hi = np.asarray([1.0, 2.0, np.inf, 0.5], np.float32)
    want = jax.vmap(lambda dd: jric._box_support(dd, jnp.asarray(lo), jnp.asarray(hi)), in_axes=-1)(
        jnp.asarray(d)
    )
    got = tric.box_support(torch.from_numpy(d), torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert np.isinf(got.numpy()).any() and np.isfinite(got.numpy()).any()
