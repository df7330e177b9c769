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
    """The sequential chunk of each of K3's register tiers goes where the
    routing table (riccati_fused.CHUNK_ROUTES, the A/B on the card) puts it:
    K3 at (4, 2), (8, 4) and (16, 8), K3W at (32, 16), whatever the batch;
    K3W past K3's tiers. The per-lane engine takes K3W's doubling form under
    parallel_sweeps, the fused driver never does. K3's own plan still
    refuses the wide plant."""
    _, tc = wider
    op, cfg = tc.engine.op, tc.engine.config
    flagged = dataclasses.replace(cfg, parallel_sweeps=True)
    fn = riccati_fused.riccati_chunk_fn
    picks = {(4, 2): "K3", (3, 1): "K3", (8, 4): "K3", (16, 8): "K3", (9, 5): "K3",
             (32, 16): "K3W", (17, 9): "K3W", (3, 16): "K3W", (40, 20): "K3W"}
    chunk = {"K3": riccati_fused.iterate_chunk_riccati,
             "K3W": riccati_fused.iterate_chunk_riccati_wide}
    for (nx, nu), kernel in picks.items():
        o = dataclasses.replace(op, nx=nx, nu=nu)
        assert riccati_fused.chunk_kernel(o) == kernel, (nx, nu)
        for driver in ("per-lane", "fused"):
            assert fn(o, cfg, driver) is chunk[kernel], (nx, nu, driver)
        assert fn(o, flagged, "per-lane") is riccati_fused.iterate_chunk_riccati_doubling
        assert fn(o, flagged, "fused") is chunk[kernel]
    with pytest.raises(ValueError, match="unknown Riccati driver"):
        fn(op, cfg, "vmapped")
    with pytest.raises(ValueError, match="nx <= 32 and nu <= 16"):
        riccati_fused.k3_plan(op, 1)


def _wide_bytes(op):
    """The lane scratch csrc/riccati_wide.cu lays out for the doubling form
    (wide_lane_floats)."""
    N, nx, nu = op.N, op.nx, op.nu
    xrows = N if op.split_interior else int(op.split_terminal or op.terminal_ball)
    n = 2 * N * nu + 2 * xrows * nx + 2 * nx + 2 * N * nu + 2 * N * nx
    return 4 * (-(-n // 4) * 4)


def _seq_bytes(op, plan):
    """The shared memory csrc/riccati_wide_seq.cu lays out for a sequential
    plan (seq_layout): the step's vectors, the ring, the plant, the lanes'
    state; nothing on the "global" route."""
    N, nx, nu, L = op.N, op.nx, op.nu, plan.lanes
    xrows = N if op.split_interior else int(op.split_terminal or op.terminal_ball)
    p4 = lambda n: -(-n // 4) * 4
    work = L * (4 * nx + 4 * nu + 4 * nx + 2 * nu + 2 * nu + 2 * nu + nx + nx + 1)
    total = work + plan.ring * (p4(nu * nx) + p4(max(nx * nx, nu * nu)))
    total += (p4(nx * nu) + p4(nx * nx) + p4(nu * nx)) if plan.plant_shared else 0
    total += (3 * N * nu + 2 * xrows * nx) * L if plan.route == "shared" else 0
    return (0, plan.blocks * work) if plan.route == "global" else (4 * total, 0)


# the doubling form's plans, frozen at their values before the sequential
# form's redesign: (N, nx, nu, B, split) -> (lanes, lane_threads,
# lane_floats, route, smem_bytes, blocks)
DOUBLING_PLANS = {
    (10, 40, 20, 8, False): (1, 64, 1680, "shared", 6720, 8),
    (10, 40, 20, 8, True): (1, 64, 2480, "shared", 9920, 8),
    (30, 64, 32, 1024, False): (1, 128, 7808, "shared", 31232, 1024),
    (30, 64, 32, 1024, True): (1, 128, 11648, "shared", 46592, 1024),
    (500, 4, 2, 1024, False): (1, 128, 8008, "shared", 32032, 1024),
    (500, 4, 2, 1024, True): (1, 128, 12008, "shared", 48032, 1024),
    (500, 4, 2, 1, False): (1, 128, 8008, "shared", 32032, 1),
    (500, 4, 2, 1, True): (1, 128, 12008, "shared", 48032, 1),
    (24, 4, 2, 1000, False): (4, 32, 392, "shared", 6272, 250),
    (24, 4, 2, 1000, True): (4, 32, 584, "shared", 9344, 250),
    (500, 64, 32, 1024, False): (1, 256, 128128, "device", 0, 1024),
    (500, 64, 32, 1024, True): (1, 256, 192128, "device", 0, 1024),
    (30, 32, 16, 2048, False): (2, 64, 3904, "shared", 31232, 1024),
    (30, 32, 16, 2048, True): (2, 64, 5824, "shared", 46592, 1024),
    (30, 32, 16, 256, False): (2, 64, 3904, "shared", 31232, 128),
    (30, 32, 16, 256, True): (2, 64, 5824, "shared", 46592, 128),
    (30, 32, 16, 1, False): (1, 64, 3904, "shared", 15616, 1),
    (30, 32, 16, 1, True): (1, 64, 5824, "shared", 23296, 1),
}


@pytest.mark.parametrize("doubling", [False, True])
@pytest.mark.parametrize("N,nx,nu,B", [(10, 40, 20, 8), (30, 64, 32, 1024), (500, 4, 2, 1024),
                                        (500, 4, 2, 1), (24, 4, 2, 1000), (500, 64, 32, 1024),
                                        (30, 32, 16, 2048), (30, 32, 16, 256), (30, 32, 16, 1)])
def test_k3w_plan(wider, doubling, N, nx, nu, B):
    """Every shape gets a layout whose blocks cover the batch, with the
    kernel's bytes. The doubling form's plans are frozen: the lanes'
    scratch in shared memory where it fits, else in device memory (h500 at
    nx = 64: a lane's rows alone are ~0.5 MB). The sequential form's
    blocks take 4, 8, 16 or 32 lanes, the fewest that spread the batch over
    the 132 SMs, a ring of 3 steps, the lanes' state in shared memory where it fits
    beside it, else in device memory (h500 at nx = 64 still gets a layout);
    every forced route and ring that fits is honoured."""
    op0 = wider[1].engine.op
    for split in (False, True):
        op = dataclasses.replace(op0, N=N, nx=nx, nu=nu, split_interior=split,
                                 split_terminal=split)
        plan = riccati_fused.k3w_plan(op, B, doubling)
        assert plan.blocks * plan.lanes >= B > (plan.blocks - 1) * plan.lanes
        if doubling:
            assert tuple(plan) == DOUBLING_PLANS[(N, nx, nu, B, split)]
            assert plan.lane_threads % 32 == 0 and plan.lanes * plan.lane_threads <= 256
            assert 4 * plan.lane_floats == _wide_bytes(op)
            if plan.route == "shared":
                assert plan.smem_bytes == plan.lanes * 4 * plan.lane_floats <= 232448
            else:
                assert plan.smem_bytes == 0 and 4 * plan.lane_floats > 232448
            if (N, nx) == (500, 64):
                with pytest.raises(ValueError, match="shared route does not fit"):
                    riccati_fused.k3w_plan(op, B, doubling, "shared")
            assert riccati_fused.k3w_plan(op, B, doubling, "device").route == "device"
            continue
        want = next((n for n in (4, 8, 16, 32) if n >= -(-B // 132)), 32)
        assert plan.lanes == want and plan.ring == 3 and plan.plant_shared
        assert plan.threads % 32 == 0 and plan.threads <= 256
        assert plan.threads >= min((nx + nu) * plan.lanes // 4, 256)
        assert (plan.smem_bytes, plan.scratch_floats) == _seq_bytes(op, plan)
        assert plan.smem_bytes <= 232448
        if plan.route == "device":  # only where the state fits beside no ring
            with pytest.raises(ValueError, match="does not fit"):
                riccati_fused.k3w_plan(op, B, doubling, "shared")
        if (N, nx) == (500, 64):
            assert plan.route == "device"
        if (N, nx, nu, B) in ((30, 64, 32, 1024), (30, 32, 16, 2048)):
            assert plan.route == ("device" if split else "shared")
        for route, ring in (("device", 2), ("device", 0), ("global", 0), ("shared", 2)):
            try:
                forced = riccati_fused.k3w_plan(op, B, doubling, route, ring=ring)
            except ValueError:
                assert route == "shared"
                continue
            assert (forced.route, forced.ring) == (route, ring)
            assert (forced.smem_bytes, forced.scratch_floats) == _seq_bytes(op, forced)
        for lanes in (2, 6, 12, 64):
            with pytest.raises(ValueError, match="lanes a block"):
                riccati_fused.k3w_plan(op, B, doubling, lanes=lanes)
