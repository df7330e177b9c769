"""A Riccati controller on a wide plant (nx 32, nu 16), K3's widest
register tier, port against the JAX package.

The plant is ``big.random_stable_system(32, 16, seed=0)``, the wide row of
the JAX package's extra benchmarks (h30 there; h8-h10 here), designed with
``engine="riccati"``. The drivers run its chunk on the kernel
``riccati_fused.CHUNK_ROUTES`` picks for the tier, K3W at every batch (K3
and K3W share one plain version, counted under the kernel's name), and its
rollout and certificate on the ones ``riccati_fused.RECURRENCE_ROUTES``
picks, the wide ones. On the
CPU the port runs that plain version, which
sums in fp64 where XLA sums in fp32, so solutions are held within 1e-4
(``tests/test_torch_riccati_engine.py``'s TOL) and statuses lane by lane.
The fused driver adapts rho for the whole batch where the JAX engine it is
compared with adapts it per lane, so counts are compared on the per-lane
engine only. The layout cases check that every shape of the new tier gets
a route of K3's plan with the bytes the kernel lays out.
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
NX, NU = 32, 16
B = 4


def _pair(horizon, **kw):
    cfg = dict(max_iter=1000)
    jc = jmpc.proceed_controller(
        jbig.random_stable_system(NX, NU, seed=0), "model_predictive_control", horizon, 1.0,
        np.zeros(NX, np.float32), np.zeros(NU, np.float32), mpc_Q=10.0, mpc_R=0.1,
        engine="riccati", riccati_config=jric.RiccatiConfig(**cfg), **kw,
    )
    tc = tmpc.proceed_controller(
        tbig.random_stable_system(NX, NU, seed=0), "model_predictive_control", horizon, 1.0,
        np.zeros(NX, np.float32), np.zeros(NU, np.float32), mpc_Q=10.0, mpc_R=0.1,
        engine="riccati", riccati_config=tric.RiccatiConfig(**cfg), device="cpu", **kw,
    )
    return jc, tc


@pytest.fixture(scope="module")
def wide():
    return {
        "h8": _pair(8),
        "h10": _pair(10),
        "h8-state": _pair(8, mpc_state_constraint=True),
    }


def _x0s(seed, n=B):
    rng = np.random.default_rng(seed)
    return np.clip(0.4 * rng.standard_normal((n, NX)), -0.95, 0.95).astype(np.float32)


@pytest.mark.parametrize("cell", ["h8", "h10", "h8-state"])
def test_solve_batch_auto_on_k3(wide, cell):
    """solve_batch_auto takes the wide plant on the chunk the routing table
    picks for the (32, 16) tier at this batch, K3W (its plain version
    here; never K3's), with the rollout and certificate the recurrence
    table picks for it (the wide ones; never the others), and agrees with
    the JAX package's solve_batch_auto."""
    jc, tc = wide[cell]
    assert tpar.fused_supported(tc)
    assert riccati_fused.chunk_kernel(tc.engine.op) == "K3W"
    x0 = _x0s(1)
    admm_fused.reset_counts()
    ts, twz, _, td = tpar.solve_batch_auto(tc, torch.from_numpy(x0))
    plain = admm_fused.PLAIN_CALLS
    assert plain["K3W"] > 0 and plain["K3"] == 0, plain
    routed = riccati_fused.recurrence_kernel(tc.engine.op)
    keys, others = ("rollout", "certificate"), ("rollout-wide", "certificate-wide")
    if routed == "wide":
        keys, others = others, keys
    assert all(plain[k] > 0 for k in keys) and not any(plain[k] for k in others), plain
    js, _, _, jd = jpar.solve_batch_auto(jc, jnp.asarray(x0))
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    assert int(td.n_converged) == int(jd.n_converged) == B
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), atol=TOL)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=TOL)
    assert twz.shape == (B, tc.tuning.horizon * NU)


def test_solve_batch_per_lane(wide):
    """parallel.solve_batch: the per-lane engine on the routed chunk (K3W)
    against the JAX package's vmapped engine, counts included."""
    jc, tc = wide["h8"]
    x0 = _x0s(2)
    ts, _, _, _ = tpar.solve_batch(tc, torch.from_numpy(x0))
    js, _, _, _ = jpar.solve_batch(jc, jnp.asarray(x0))
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_array_equal(ts.iterations.numpy(), np.asarray(js.iterations))
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), atol=TOL)


def test_step_closed_loop(wide):
    """step at B = 1 in a short loop on the plant, each step held to the
    JAX package's step."""
    jc, tc = wide["h10"]
    plant = tbig.random_stable_system(NX, NU, seed=0)
    x = _x0s(3, 1)[0]
    for _ in range(3):
        tc, tsol = tmpc.step(tc, torch.from_numpy(x))
        jc, jsol = jmpc.step(jc, jnp.asarray(x))
        assert int(tsol.status) == int(jsol.status) == 0
        np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), atol=TOL)
        x = plant.step(torch.from_numpy(x), tsol.u[:, 0]).numpy()


def _k3_bytes(op, plan):
    """The shared memory csrc/riccati_chunk.cuh lays out at the (32, 16)
    tier: padded fp64 factors, or fp32 ones, beside the lanes' rows."""
    N, nx, nu = op.N, op.nx, op.nu
    fac = {0: 8 * (N * (16 * 32 + 16 * 16 + 32 * 32) + 32 * 32 + 32 * 16),
           1: (4 * (N * (nu * nx + nu * nu + nx * nx) + nx * nx + nx * nu) + 15) // 16 * 16,
           2: 0}[plan.fac_mode]
    xrows = N if op.split_interior else int(op.split_terminal or op.terminal_ball)
    rows = 4 * plan.lanes * (3 * N * nu + 2 * xrows * nx) if plan.rows_shared else 0
    return fac + rows


@pytest.mark.parametrize("nx,nu", [(32, 16), (17, 9), (20, 4), (3, 16)])
@pytest.mark.parametrize("N", [8, 15, 16, 30, 100, 500])
def test_k3_plan_new_tier(wide, nx, nu, N):
    """Every shape of the (32, 16) tier gets a route within shared memory
    whose blocks cover the batch, with the kernel's bytes; the fp64 factors
    (14,336 B a horizon step) fit up to h15 only."""
    op0 = wide["h8-state"][1].engine.op
    for split in (False, True):
        op = dataclasses.replace(op0, N=N, nx=nx, nu=nu, split_interior=split,
                                 split_terminal=split)
        assert riccati_fused.k3_fits(op)
        for Bt in (1, 256, 2048):
            plan = riccati_fused.k3_plan(op, Bt)
            assert plan.route in riccati_fused.K3_ROUTES
            assert plan.blocks * plan.lanes >= Bt > (plan.blocks - 1) * plan.lanes
            assert 0 <= plan.smem_bytes <= 232448
            assert plan.smem_bytes == _k3_bytes(op, plan)
            if N > 15:
                assert plan.route != "shared-fp64"
        lanes, tile, smem = riccati_fused.certificate_plan(op, 2048)
        assert 1 <= tile <= N and smem == 8 * 32 * 48 + 4 * tile * lanes * (2 * nx + nu)


def test_k3_plan_card_cell(wide):
    """The card's wide cell, h30 at 2048 lanes: fp32 factors read through
    L1/L2 beside 16 lanes' rows a block, 128 blocks; past (32, 16) the same
    ValueError as before."""
    op = dataclasses.replace(wide["h8"][1].engine.op, N=30)
    p = riccati_fused.k3_plan(op, 2048)
    assert (p.route, p.lanes, p.blocks, p.smem_bytes) == ("shared-l2", 16, 128, 92160)
    assert riccati_fused.k3_plan(op, 2048, "shared-fp32").lanes == 1
    with pytest.raises(ValueError, match="nx <= 32 and nu <= 16"):
        riccati_fused.k3_plan(dataclasses.replace(op, nu=17), 1)
