"""A Riccati controller on a plant wider than K3 takes (40 states, 20
inputs): K3W, port against the JAX package.

The plant is ``big.random_stable_system(40, 20, seed=0)`` at h10 with
``engine="riccati"`` (Q 10, R 0.1, as the wide row of the JAX package's
extra benchmarks). Past K3's (32, 16) the drivers run K3W, whose plain
version on the CPU is K3's (it sums in fp64 where XLA sums in fp32), and
the wide rollout and certificate, so solutions are held within 1e-4
(``tests/test_torch_riccati_engine.py``'s TOL) and statuses lane by lane.
Every entry point solves the plant, where each raised ValueError before.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu import parallel as jpar
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import big as jbig
from automationlabsmodelpredictivecontrol_jl_tpu.ops import riccati as jric

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big as tbig
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused, riccati_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati as tric

torch.set_num_threads(1)

TOL = 1e-4
NX, NU, H = 40, 20, 10
B = 4
WIDE_KEYS = ("K3W", "rollout-wide", "certificate-wide")


@pytest.fixture(scope="module")
def wider():
    cfg = dict(max_iter=1000)
    jc = jmpc.proceed_controller(
        jbig.random_stable_system(NX, NU, seed=0), "model_predictive_control", H, 1.0,
        np.zeros(NX, np.float32), np.zeros(NU, np.float32), mpc_Q=10.0, mpc_R=0.1,
        engine="riccati", riccati_config=jric.RiccatiConfig(**cfg),
    )
    tc = tmpc.proceed_controller(
        tbig.random_stable_system(NX, NU, seed=0), "model_predictive_control", H, 1.0,
        np.zeros(NX, np.float32), np.zeros(NU, np.float32), mpc_Q=10.0, mpc_R=0.1,
        engine="riccati", riccati_config=tric.RiccatiConfig(**cfg), device="cpu",
    )
    return jc, tc


def _x0s(seed, n=B):
    rng = np.random.default_rng(seed)
    return np.clip(0.4 * rng.standard_normal((n, NX)), -0.95, 0.95).astype(np.float32)


def _ran_wide_only():
    """The path ran K3W's plain version and the wide recurrences', and
    never K3's or a kernel."""
    plain = admm_fused.PLAIN_CALLS
    assert all(plain[k] > 0 for k in WIDE_KEYS), plain
    assert plain["K3"] == plain["rollout"] == plain["certificate"] == 0, plain
    assert not any(admm_fused.LAUNCHES.values())


def test_solve_batch_and_auto_match_jax(wider):
    """The per-lane engine (solve_batch) and the fused driver
    (solve_batch_auto) solve the plant on K3W, as the JAX package's
    solve_batch and solve_batch_auto do: statuses equal, u within 1e-4,
    and the per-lane engine's iteration counts JAX's."""
    jc, tc = wider
    assert not riccati_fused.k3_fits(tc.engine.op) and tpar.fused_supported(tc)
    x0 = _x0s(1)
    for solve, jsolve in ((tpar.solve_batch, jpar.solve_batch),
                          (tpar.solve_batch_auto, jpar.solve_batch_auto)):
        admm_fused.reset_counts()
        ts, twz, _, td = solve(tc, torch.from_numpy(x0))
        _ran_wide_only()
        js, _, _, jd = jsolve(jc, jnp.asarray(x0))
        np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
        assert int(td.n_converged) == int(jd.n_converged) == B
        np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), atol=TOL)
        assert twz.shape == (B, H * NU)
        if solve is tpar.solve_batch:
            np.testing.assert_array_equal(ts.iterations.numpy(), np.asarray(js.iterations))


def test_step_and_escalated(wider):
    """step at B = 1 on the plant, held to the JAX package's step; and
    solve_batch_escalated (the fused driver, stragglers restarted on the
    per-lane engine) solves every lane."""
    jc, tc = wider
    plant = tbig.random_stable_system(NX, NU, seed=0)
    x = _x0s(3, 1)[0]
    for _ in range(2):
        tc, tsol = tmpc.step(tc, torch.from_numpy(x))
        jc, jsol = jmpc.step(jc, jnp.asarray(x))
        assert int(tsol.status) == int(jsol.status) == 0
        np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), atol=TOL)
        x = plant.step(torch.from_numpy(x), tsol.u[:, 0]).numpy()
    x0 = torch.from_numpy(_x0s(4))
    wz, wy = tpar.init_warm_batch(tc, B)
    admm_fused.reset_counts()
    sol, _, _, d = tpar.solve_batch_escalated(tc, tc, x0, wz, wy, bucket=2)
    _ran_wide_only()
    assert int(d.n_converged) == B


def test_riccati_chunk_fn_routes_by_width_and_flag(wider):
    """K3 up to (32, 16), K3W past it; the per-lane engine takes K3W's
    doubling form under parallel_sweeps, the fused driver never does.
    K3's own plan still refuses the wide plant."""
    _, tc = wider
    op, cfg = tc.engine.op, tc.engine.config
    fits = dataclasses.replace(op, nx=32, nu=16)
    flagged = dataclasses.replace(cfg, parallel_sweeps=True)
    fn = riccati_fused.riccati_chunk_fn
    assert fn(fits, cfg, "per-lane") is riccati_fused.iterate_chunk_riccati
    assert fn(fits, cfg, "fused") is riccati_fused.iterate_chunk_riccati
    assert fn(op, cfg, "per-lane") is riccati_fused.iterate_chunk_riccati_wide
    assert fn(op, cfg, "fused") is riccati_fused.iterate_chunk_riccati_wide
    for o in (fits, op):
        assert fn(o, flagged, "per-lane") is riccati_fused.iterate_chunk_riccati_doubling
    assert fn(fits, flagged, "fused") is riccati_fused.iterate_chunk_riccati
    assert fn(op, flagged, "fused") is riccati_fused.iterate_chunk_riccati_wide
    with pytest.raises(ValueError, match="unknown Riccati driver"):
        fn(op, cfg, "vmapped")
    with pytest.raises(ValueError, match="nx <= 32 and nu <= 16"):
        riccati_fused.k3_plan(op, 1)


def _wide_bytes(op, plan, doubling):
    """The lane scratch csrc/riccati_wide.cu lays out (wide_lane_floats)."""
    N, nx, nu = op.N, op.nx, op.nu
    xrows = N if op.split_interior else int(op.split_terminal or op.terminal_ball)
    n = 2 * N * nu + 2 * xrows * nx + 2 * nx
    n += 2 * N * nu + 2 * N * nx if doubling else 2 * N * nu + N * nx + 3 * nx + 3 * nu
    return 4 * (-(-n // 4) * 4)


@pytest.mark.parametrize("doubling", [False, True])
@pytest.mark.parametrize("N,nx,nu,B", [(10, 40, 20, 8), (30, 64, 32, 1024), (500, 4, 2, 1024),
                                        (500, 4, 2, 1), (24, 4, 2, 1000), (500, 64, 32, 1024)])
def test_k3w_plan(wider, doubling, N, nx, nu, B):
    """Every shape gets a layout whose blocks cover the batch, with the
    kernel's bytes: the lanes' scratch in shared memory where it fits,
    else in device memory (h500 at nx = 64: a lane's rows alone are
    ~0.5 MB)."""
    op0 = wider[1].engine.op
    for split in (False, True):
        op = dataclasses.replace(op0, N=N, nx=nx, nu=nu, split_interior=split,
                                 split_terminal=split)
        plan = riccati_fused.k3w_plan(op, B, doubling)
        assert plan.blocks * plan.lanes >= B > (plan.blocks - 1) * plan.lanes
        assert plan.lane_threads % 32 == 0 and plan.lanes * plan.lane_threads <= 256
        assert 4 * plan.lane_floats == _wide_bytes(op, plan, doubling)
        if plan.route == "shared":
            assert plan.smem_bytes == plan.lanes * 4 * plan.lane_floats <= 232448
        else:
            assert plan.smem_bytes == 0 and 4 * plan.lane_floats > 232448
        if (N, nx) == (500, 64):
            assert plan.route == "device"
            with pytest.raises(ValueError, match="shared route does not fit"):
                riccati_fused.k3w_plan(op, B, doubling, "shared")
        assert riccati_fused.k3w_plan(op, B, doubling, "device").route == "device"
