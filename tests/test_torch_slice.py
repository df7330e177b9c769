"""The whole main-path slice, port vs JAX: proceed_controller at h20, the
tiered escalated solve (tier 1 on the fused diag kernel, stragglers
gathered into a bucket for tier 2, the host f64 oracle for tier 3) and the
batched closed loop. The JAX side runs its Pallas kernel in interpret mode
on the CPU; initial states are made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu import parallel as jpar
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig as JConfig
from automationlabsmodelpredictivecontrol_jl_tpu.parallel import scenarios as jscen

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig as TConfig
from automationlabsmodelpredictivecontrol_jl_torch.parallel import scenarios as tscen

torch.set_num_threads(1)

B, BUCKET = 32, 16
TIER1 = dict(max_iter=75, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0)
TIER2 = dict(rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250, refine_steps=2)
# At the main path's eps 1e-6 a lane's convergence is decided on residuals
# at the f32 noise floor of its iterates, so its status at a tier boundary
# and its iteration count follow each package's roundoff (the port sums its
# K-solves in fp64, XLA's CPU dot in fp32 partial sums). With eps 1e-4,
# checks every 5 iterations and a 10-iteration tier 1, every decision sits
# two decades above that floor and both tiers (and the bucket overflow)
# are reproducible lane by lane.
ABOVE_FLOOR = dict(TIER1, max_iter=10, eps_abs=1e-4, eps_rel=1e-4,
                   check_interval=5, adapt_interval=5)
TOL = 5e-4  # the JAX package's fused-vs-engine bar


def _x0s(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(0.65 + 0.15 * rng.standard_normal((n, 4)), 0.25, 1.3).astype(np.float32)


def _controllers(cfg):
    jc = jmpc.proceed_controller(
        jqtp.linearized_discrete_system(), "model_predictive_control", 20, 5.0,
        np.full(4, 0.65, np.float32), np.full(2, 1.2, np.float32),
        admm_config=JConfig(**cfg),
    )
    tc = tmpc.proceed_controller(
        tqtp.linearized_discrete_system(), "model_predictive_control", 20, 5.0,
        [0.65] * 4, [1.2] * 2, admm_config=TConfig(**cfg), device="cpu",
    )
    return jc, jpar.escalation_controller(jc, **TIER2), tc, tpar.escalation_controller(tc, **TIER2)


def _escalated(cfg, x0):
    jc, jfb, tc, tfb = _controllers(cfg)
    jwz, jwy = jpar.init_warm_batch(jc, x0.shape[0])
    js, _, _, jd = jpar.solve_batch_escalated(jc, jfb, jnp.asarray(x0), jwz, jwy, bucket=BUCKET)
    twz, twy = tpar.init_warm_batch(tc, x0.shape[0])
    ts, _, _, td = tpar.solve_batch_escalated(tc, tfb, torch.from_numpy(x0), twz, twy, bucket=BUCKET)
    return (js, jd), (ts, td)


def _assert_solutions_close(js, ts):
    for f in ("u", "x", "e_u", "objective"):
        np.testing.assert_allclose(
            getattr(ts, f).numpy(), np.asarray(getattr(js, f)), atol=TOL, err_msg=f
        )


def test_escalated_slice_at_main_path_config():
    x0 = _x0s(B)
    (js, jd), (ts, td) = _escalated(TIER1, x0)
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    assert int(td.n_converged) == int(jd.n_converged) == B
    _assert_solutions_close(js, ts)
    # iteration counts are roundoff-decided here (see ABOVE_FLOOR): the
    # fleet mean may move, by less than one 25-iteration check interval
    assert abs(float(td.mean_iterations) - float(jd.mean_iterations)) < 25.0


@pytest.fixture(scope="module")
def above_floor():
    x0 = _x0s(B, seed=1)
    return x0, _escalated(ABOVE_FLOOR, x0)


def test_escalated_slice_lane_by_lane_above_noise_floor(above_floor):
    _, ((js, jd), (ts, td)) = above_floor
    st = ts.status.numpy()
    assert (st == 0).sum() == BUCKET and (st == 1).sum() == B - BUCKET  # overflow
    np.testing.assert_array_equal(st, np.asarray(js.status))
    np.testing.assert_array_equal(ts.iterations.numpy(), np.asarray(js.iterations))
    assert int(td.n_converged) == int(jd.n_converged)
    assert float(td.mean_iterations) == float(jd.mean_iterations)
    _assert_solutions_close(js, ts)


def test_three_tier_solver_closes_bucket_overflow(above_floor):
    """Lanes beyond the bucket end on the host f64 oracle, continuing from
    the tier-2 iterate; the tiers above stay as solve_batch_escalated left
    them."""
    x0, (_, (ts, _)) = above_floor
    jc, jfb, tc, tfb = _controllers(ABOVE_FLOOR)
    sol, wz, wy, diag = tpar.make_escalated_solver(tc, fallback=tfb, min_bucket=BUCKET)(
        torch.from_numpy(x0)
    )
    assert int(diag.n_converged) == B
    left = ts.status.numpy() != 0
    np.testing.assert_array_equal(sol.u.numpy()[~left], ts.u.numpy()[~left])
    jsol, _, _, _ = jpar.make_escalated_solver(jc, fallback=jfb, min_bucket=BUCKET)(
        jnp.asarray(x0)
    )
    np.testing.assert_array_equal(sol.status.numpy(), np.asarray(jsol.status))
    np.testing.assert_allclose(sol.u.numpy(), np.asarray(jsol.u), atol=TOL)
    assert wz.shape == (B, 40) and wy.shape == (B, 40)


def test_native_lane_solve_matches_jax():
    jc, _, tc, _ = _controllers(TIER1)
    x0 = _x0s(1, seed=3)[0]
    rng = np.random.default_rng(4)
    wz = (0.1 * rng.standard_normal(40)).astype(np.float32)
    wy = (0.1 * rng.standard_normal(40)).astype(np.float32)
    jl, jwz, jwy = jscen._native_lane_solve(jc, jnp.asarray(x0), jnp.asarray(wz), jnp.asarray(wy))
    tl, twz, twy = tscen._native_lane_solve(tc, x0, wz, wy)
    assert tl["status"] == jl["status"] == 0
    for key in ("x", "e_x", "u", "e_u", "primal_residual", "dual_residual"):
        np.testing.assert_allclose(tl[key], jl[key], rtol=0, atol=1e-9, err_msg=key)
    np.testing.assert_allclose(twz, jwz, atol=1e-9)
    np.testing.assert_allclose(twy, jwy, atol=1e-9)
    # the objective is a float32 einsum in both packages
    np.testing.assert_allclose(tl["objective"], jl["objective"], rtol=1e-6)


def test_closed_loop_matches_jax():
    jc, _, tc, _ = _controllers(TIER1)
    x0 = _x0s(8, seed=6)
    jxs, jus, _ = jpar.closed_loop_batch(jc, jqtp.qtp_discrete_step, jnp.asarray(x0), 3)
    calls = admm_fused.PLAIN_CALLS["K1"]
    txs, tus, tst = tpar.closed_loop_batch(tc, tqtp.qtp_discrete_step, torch.from_numpy(x0), 3)
    assert admm_fused.PLAIN_CALLS["K1"] > calls
    assert txs.shape == (4, 8, 4) and tus.shape == (3, 8, 2) and tst.shape == (3, 8)
    np.testing.assert_allclose(txs.numpy(), np.asarray(jxs), atol=1e-4)
    np.testing.assert_allclose(tus.numpy(), np.asarray(jus), atol=TOL)


def test_plant_step_matches_jax():
    x0 = _x0s(8, seed=7)
    u = np.random.default_rng(8).uniform(0.0, 3.0, (8, 2)).astype(np.float32)
    import jax

    j = jax.vmap(jqtp.qtp_discrete_step)(jnp.asarray(x0), jnp.asarray(u))
    t = tqtp.qtp_discrete_step(torch.from_numpy(x0), torch.from_numpy(u))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
