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


def _wide_bytes(op, plan):
    """(shared-memory bytes, device-scratch floats) that csrc/riccati_wide.cu
    lays out for a doubling plan (dbl_layout): the ring, the plant's B, the
    work area (two horizon buffers and ff, s where nu > 4, each N steps at
    a padded stride; lin_xN, e0, the ball's scale) in shared memory or in
    the scratch, the lanes' state on the "shared" route."""
    N, nx, nu, L, lt = op.N, op.nx, op.nu, plan.lanes, plan.lanes_per_thread
    xrows = N if op.split_interior else int(op.split_terminal or op.terminal_ball)
    p4 = lambda n: -(-n // 4) * 4
    stride = lambda rows: rows * L + (min(lt, 4) if (rows * L // min(lt, 4)) % 2 == 0 else 0)
    work = p4(2 * N * stride(nx) + N * stride(nu) * (2 if nu > 4 else 1) + 2 * nx * L + L)
    total = plan.ring * plan.panel + p4(nx * nu)
    total += work if plan.route != "global" else 0
    total += (2 * N * nu + 2 * xrows * nx) * L if plan.route == "shared" else 0
    return 4 * total, plan.blocks * work if plan.route == "global" else 0


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


# the doubling form's plans, frozen at their values after its redesign for
# the card: (N, nx, nu, B, split) -> (lanes, threads, lanes_per_thread,
# ring, panel, route, smem_bytes, blocks, scratch_floats)
DOUBLING_PLANS = {
    (10, 40, 20, 8, False): (1, 128, 1, 3, 16012, "shared", 202240, 8, 0),
    (10, 40, 20, 8, True): (1, 128, 1, 3, 16012, "shared", 205440, 8, 0),
    (30, 64, 32, 1024, False): (8, 256, 8, 0, 0, "device", 198560, 128, 0),
    (30, 64, 32, 1024, True): (8, 256, 8, 0, 0, "device", 198560, 128, 0),
    (500, 4, 2, 1024, False): (8, 256, 8, 0, 0, "device", 184320, 128, 0),
    (500, 4, 2, 1024, True): (8, 256, 8, 0, 0, "device", 184320, 128, 0),
    (500, 4, 2, 1, False): (1, 512, 1, 0, 0, "shared", 34080, 1, 0),
    (500, 4, 2, 1, True): (1, 512, 1, 0, 0, "shared", 50080, 1, 0),
    (24, 4, 2, 1000, False): (8, 96, 2, 0, 0, "shared", 11648, 125, 0),
    (24, 4, 2, 1000, True): (8, 96, 2, 0, 0, "shared", 17792, 125, 0),
    (500, 64, 32, 1024, False): (8, 256, 8, 3, 18688, "global", 232448, 128, 99460096),
    (500, 64, 32, 1024, True): (8, 256, 8, 3, 18688, "global", 232448, 128, 99460096),
    (30, 32, 16, 2048, False): (16, 256, 8, 2, 5000, "device", 232448, 128, 0),
    (30, 32, 16, 2048, True): (16, 256, 8, 2, 5000, "device", 232448, 128, 0),
    (30, 32, 16, 256, False): (2, 256, 2, 3, 16516, "shared", 232448, 128, 0),
    (30, 32, 16, 256, True): (2, 256, 2, 3, 15236, "shared", 232448, 128, 0),
    (30, 32, 16, 1, False): (1, 256, 1, 3, 17856, "shared", 232432, 1, 0),
    (30, 32, 16, 1, True): (1, 256, 1, 3, 17216, "shared", 232432, 1, 0),
}


@pytest.mark.parametrize("doubling", [False, True])
@pytest.mark.parametrize("N,nx,nu,B", [(10, 40, 20, 8), (30, 64, 32, 1024), (500, 4, 2, 1024),
                                        (500, 4, 2, 1), (24, 4, 2, 1000), (500, 64, 32, 1024),
                                        (30, 32, 16, 2048), (30, 32, 16, 256), (30, 32, 16, 1)])
def test_k3w_plan(wider, doubling, N, nx, nu, B):
    """Every shape gets a layout whose blocks cover the batch, with the
    kernel's bytes. The doubling form's plans are frozen: a block takes the
    lanes that spread the batch over the 132 SMs, its work area and the
    lanes' state in shared memory where they fit beside a ring of operator
    panels, else the state in device memory, else the work area too (h500
    at nx = 64: a lane's rows alone are ~0.5 MB). The sequential form's
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
            assert plan.threads % 32 == 0 and plan.lanes <= plan.threads
            assert plan.threads <= riccati_fused.k3w_dbl_max_threads(plan.lanes_per_thread)
            assert (plan.smem_bytes, plan.scratch_floats) == _wide_bytes(op, plan)
            assert plan.smem_bytes <= 232448 and plan.panel % 4 == 0
            if plan.ring:  # a slot holds 4 steps of the widest stream, or all of it
                assert plan.panel >= min(4 * riccati_fused.k3w_dbl_step(nx, nu),
                                         N * riccati_fused.k3w_dbl_step(nx, nu))
            else:  # the QTP's width, operators that fit L1, or the work area kept in
                # shared memory where a ring would push it out
                assert plan.panel == 0 and plan.route != "global"
            if (N, nx) == (500, 64):
                with pytest.raises(ValueError, match="does not fit"):
                    riccati_fused.k3w_plan(op, B, doubling, "shared")
                with pytest.raises(ValueError, match="does not fit"):
                    riccati_fused.k3w_plan(op, B, doubling, "device")
            assert riccati_fused.k3w_plan(op, B, doubling, "global").route == "global"
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


# forced doubling layouts: (route, ring, lanes, lanes_per_thread, threads,
# panel); None leaves that part to the plan
DOUBLING_FORCED = [
    ("shared", 3, None, None, None, None), ("shared", 2, 1, 1, 512, 68),
    ("device", 2, 4, 4, 128, None), ("device", 3, 32, 2, 64, 1024),
    ("global", 3, 16, 8, 256, None), ("global", 2, 2, 2, 64, 4100),
    (None, None, 8, 1, 416, None), (None, 3, None, None, None, 40000),
    ("shared", 0, None, None, None, None), ("global", 0, 4, 4, 128, None),
    (None, 0, 2, 2, 64, 20),
]


@pytest.mark.parametrize("forced", DOUBLING_FORCED)
@pytest.mark.parametrize("N,nx,nu,B", [(500, 4, 2, 1024), (500, 4, 2, 1), (24, 4, 2, 77),
                                        (10, 40, 20, 8), (1, 4, 2, 5), (7, 3, 7, 33)])
def test_k3w_doubling_forced_layouts(wider, forced, N, nx, nu, B):
    """A forced doubling layout is honoured in every part it names, its
    blocks cover the batch and its bytes are the kernel's; or it is refused
    with ValueError, and then it does not fit: the panel holds no step of
    the widest operator, or the shared memory passes the card's 227 KB."""
    route, ring, lanes, lt, threads, panel = forced
    op = dataclasses.replace(wider[1].engine.op, N=N, nx=nx, nu=nu, split_interior=True,
                             split_terminal=True)
    try:
        plan = riccati_fused.k3w_plan(op, B, True, route, lanes=lanes, ring=ring,
                                      threads=threads, lanes_per_thread=lt, panel=panel)
    except ValueError as err:
        assert "does not fit" in str(err)
        lanes = lanes or next(n for n in (1, 2, 4, 8, 16, 32) if n >= -(-B // 132) or n == 32)
        lt = lt or next((t for t in (8, 4, 2) if t <= lanes
                         and N * -(-nx // 4) * (lanes // t) >= 256), 1)
        step = -(-riccati_fused.k3w_dbl_step(nx, nu) // 4) * 4
        for where, depth in riccati_fused.K3W_DBL_L1_LAYOUTS + riccati_fused.K3W_DBL_LAYOUTS:
            if route not in (None, where) or ring not in (None, depth):
                continue
            _, fixed = riccati_fused.k3w_dbl_floats(N, nx, nu, N, lanes, lt, depth, 0, where)
            if depth == 0:  # no ring: no panel
                assert panel not in (None, 0) or 4 * fixed > 232448, where
                continue
            pan = step if panel is None else panel
            assert pan < step or 4 * (fixed + depth * pan) > 232448, (where, depth)
        return
    for name, want in zip(("route", "ring", "lanes", "lanes_per_thread", "threads", "panel"),
                          forced):
        assert want is None or getattr(plan, name) == want, name
    assert plan.blocks * plan.lanes >= B > (plan.blocks - 1) * plan.lanes
    assert (plan.smem_bytes, plan.scratch_floats) == _wide_bytes(op, plan)
    assert plan.smem_bytes <= 232448
    assert plan.panel >= riccati_fused.k3w_dbl_step(nx, nu) if plan.ring else plan.panel == 0


@pytest.mark.parametrize("kwargs,match", [
    (dict(lanes=3), "lanes a block"), (dict(lanes=64), "lanes a block"),
    (dict(lanes=4, lanes_per_thread=8), "tile"), (dict(lanes_per_thread=3), "tile"),
    (dict(threads=48), "threads"), (dict(threads=1024), "threads"),
    (dict(lanes=8, lanes_per_thread=8, threads=512), "threads"),
    (dict(lanes=32, threads=0), "threads"), (dict(route="bogus"), "unknown K3W route"),
    (dict(ring=4), "does not fit"), (dict(panel=42), "does not fit"),
    (dict(panel=12), "does not fit"),
])
def test_k3w_doubling_refuses_layouts_the_kernel_does_not_take(wider, kwargs, match):
    """Lanes, tiles, threads, routes, rings and panels the kernel has no
    code for are refused with ValueError before any launch; the sequential
    form takes no forced threads, tile or panel."""
    op = dataclasses.replace(wider[1].engine.op, N=50, nx=4, nu=2)
    with pytest.raises(ValueError, match=match):
        riccati_fused.k3w_plan(op, 1024, True, **kwargs)
    if set(kwargs) & {"threads", "lanes_per_thread", "panel"}:
        with pytest.raises(ValueError, match="sequential form takes no forced"):
            riccati_fused.k3w_plan(op, 1024, False, **kwargs)
