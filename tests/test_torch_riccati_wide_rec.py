"""The drivers' wide rollout and certificate (csrc/riccati_wide_rec.cu) on
the CPU: their plans, the routing of K3's tiers between K3's recurrences
and the wide ones, and the wrappers' plain versions against the JAX
package's rollout.

``riccati_fused.wide_recurrence_plan`` lays out a launch from the shape
alone; these tests freeze its plans at the shapes the drivers launch (the
riccati-wide-nx64 and -nx32 cells, the (40, 20) state box), check where
A and B sit by width (fp64 in shared memory, fp32 there, through L1/L2),
that the blocks cover the batch with a partial last one where the lanes do
not divide it, and that the bytes are ``wide_rec_bytes``'s (which
``tests/test_torch_build.py`` holds to the C source).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from automationlabsmodelpredictivecontrol_jl_tpu.ops import riccati as jric

from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused, riccati, riccati_fused

torch.set_num_threads(1)

SMEM_LIMIT = 232448


@pytest.fixture(scope="module")
def small_op():
    """A (4, 2) operator at h6 with every split row; plans read N, nx, nu."""
    rng = np.random.default_rng(0)
    A = 0.3 * rng.standard_normal((4, 4))
    return riccati.build_riccati_operator(
        A, rng.standard_normal((4, 2)), np.eye(4), np.eye(2), 2.0 * np.eye(4), 6,
        -np.ones(4), np.ones(4), -np.ones(2), np.ones(2), state_constraint=True)


def _shape(op, N, nx, nu):
    return dataclasses.replace(op, N=N, nx=nx, nu=nu)


# (kernel, N, nx, nu, B) -> (lanes, threads, rows_per_thread,
# lanes_per_thread, place, route, smem_bytes, blocks, scratch_floats)
PLANS = {
    ("rollout", 30, 64, 32, 1024): (8, 128, 2, 2, "fp64", "shared", 61440, 128, 0),
    ("rollout", 30, 64, 32, 1): (1, 64, 1, 1, "fp64", "shared", 50688, 1, 0),
    ("rollout", 30, 32, 16, 2048): (16, 128, 2, 2, "fp64", "shared", 24576, 128, 0),
    ("rollout", 30, 32, 16, 256): (2, 64, 1, 1, "fp64", "shared", 13824, 128, 0),
    ("rollout", 30, 32, 16, 1): (1, 32, 1, 1, "fp64", "shared", 13056, 1, 0),
    ("rollout", 10, 40, 20, 77): (1, 64, 1, 1, "fp64", "shared", 20160, 77, 0),
    ("rollout", 30, 160, 80, 1024): (8, 320, 2, 2, "fp32", "shared", 184320, 128, 0),
    ("rollout", 5, 6000, 3, 8): (1, 512, 1, 1, "global", "shared", 120032, 8, 0),
    ("rollout", 5, 20000, 10, 2): (1, 512, 1, 1, "global", "device", 0, 2, 200040),
    ("certificate", 30, 64, 32, 1024): (8, 192, 2, 2, "fp64", "shared", 59264, 128, 0),
    ("certificate", 30, 64, 32, 1): (1, 96, 1, 1, "fp64", "shared", 50304, 1, 0),
    ("certificate", 30, 32, 16, 2048): (16, 192, 2, 2, "fp64", "shared", 24320, 128, 0),
    ("certificate", 30, 32, 16, 256): (2, 96, 1, 1, "fp64", "shared", 13552, 128, 0),
    ("certificate", 30, 32, 16, 1): (1, 64, 1, 1, "fp64", "shared", 12880, 1, 0),
    ("certificate", 10, 40, 20, 77): (1, 64, 1, 1, "fp64", "shared", 19920, 77, 0),
    ("certificate", 30, 160, 80, 1024): (8, 480, 2, 2, "fp32", "shared", 178880, 128, 0),
    ("certificate", 5, 6000, 3, 8): (1, 512, 1, 1, "global", "shared", 96640, 8, 0),
}


@pytest.mark.parametrize("key", list(PLANS), ids=lambda k: "-".join(map(str, k)))
def test_wide_recurrence_plan(small_op, key):
    """Frozen plans: a block takes the fewest lanes that spread the batch
    over the 132 SMs; a thread the first tile that leaves the block 128
    threads (two rows of two lanes wherever a block has two lanes), else
    one row of one lane (at B = 1 a lane's rows spread over the threads);
    A and B widened to fp64 in shared memory where they fit
    ((64, 32): 48 KB), fp32 past it ((160, 80): A alone 200 KB in fp64), else
    through L1/L2; the lane buffers in a device scratch where not even one
    lane's fit (its floats a block times the blocks)."""
    kernel, N, nx, nu, B = key
    op = _shape(small_op, N, nx, nu)
    plan = riccati_fused.wide_recurrence_plan(op, B, kernel)
    assert plan.kernel == kernel
    assert tuple(plan)[1:] == PLANS[key]
    assert plan.blocks * plan.lanes >= B > (plan.blocks - 1) * plan.lanes
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= riccati_fused.WIDE_REC_MAX_THREADS
    lane, smem = riccati_fused.wide_rec_bytes(kernel, nx, nu, plan.lanes, plan.rows_per_thread,
                                             plan.threads, plan.place, plan.route)
    assert plan.smem_bytes == smem <= SMEM_LIMIT
    assert plan.scratch_floats == (plan.blocks * lane // 4 if plan.route == "device" else 0)


@pytest.mark.parametrize("kernel", riccati_fused.WIDE_REC_KERNELS)
def test_wide_recurrence_placement_by_width(small_op, kernel):
    """A and B sit where the plan says by width, at every batch the drivers
    launch: widened to fp64 while they fit beside a block's lane buffers,
    then fp32, then read through L1/L2; the placements are tried in that
    order, so a wider plant never takes an earlier one."""
    order = riccati_fused.WIDE_REC_PLACES
    for B in (1, 77, 1024, 4096):
        last = 0
        for nx in (4, 32, 64, 100, 120, 160, 200, 230, 400, 1200):
            nu = nx // 2
            plan = riccati_fused.wide_recurrence_plan(_shape(small_op, 30, nx, nu), B, kernel)
            at = order.index(plan.place)
            assert at >= last, (B, nx, plan)
            last = at
            width = {"fp64": 8, "fp32": 4, "global": 0}[plan.place]
            cols = nx + nu if kernel == "certificate" else nx + nu
            if plan.place != "global":
                assert width * cols * nx <= plan.smem_bytes
            if plan.place != "fp64":  # fp64 does not fit at any lanes the plan would take
                with pytest.raises(ValueError, match="does not fit"):
                    riccati_fused.wide_recurrence_plan(
                        _shape(small_op, 30, nx, nu), B, kernel, place="fp64",
                        lanes=plan.lanes)
        assert last == 2  # the widest plant reads A and B through L1/L2


@pytest.mark.parametrize("kernel", riccati_fused.WIDE_REC_KERNELS)
@pytest.mark.parametrize("B", [33, 77, 1000])
@pytest.mark.parametrize("force", [
    dict(lanes=8), dict(lanes=16, rows_per_thread=1, lanes_per_thread=1),
    dict(lanes=32, rows_per_thread=2, lanes_per_thread=2), dict(place="fp32", lanes=4),
    dict(place="global", lanes=32), dict(route="device"),
])
def test_wide_recurrence_forced_layouts_and_partial_blocks(small_op, kernel, B, force):
    """A forced layout is honoured in every part it names; its blocks cover
    the batch, the last one partial where the lanes do not divide it; its
    bytes are the kernel's."""
    op = _shape(small_op, 30, 64, 32)
    plan = riccati_fused.wide_recurrence_plan(op, B, kernel, **force)
    for name, want in force.items():
        assert getattr(plan, name) == want, name
    assert plan.blocks == -(-B // plan.lanes)
    if B % plan.lanes:
        assert (plan.blocks - 1) * plan.lanes < B < plan.blocks * plan.lanes
    if plan.route == "device":
        assert (plan.lanes, plan.rows_per_thread, plan.lanes_per_thread, plan.place) == (
            1, 1, 1, "global")
    lane, smem = riccati_fused.wide_rec_bytes(kernel, 64, 32, plan.lanes, plan.rows_per_thread,
                                             plan.threads, plan.place, plan.route)
    assert plan.smem_bytes == smem <= SMEM_LIMIT


@pytest.mark.parametrize("kwargs,match", [
    (dict(kernel="adjoint"), "unknown wide recurrence"), (dict(lanes=3), "lanes a block"),
    (dict(lanes=64), "lanes a block"), (dict(place="bf16"), "unknown placement"),
    (dict(route="host"), "unknown route"), (dict(rows_per_thread=8), "tile"),
    (dict(rows_per_thread=2, lanes_per_thread=1), "tile"), (dict(threads=48), "threads"),
    (dict(threads=1024), "threads"), (dict(lanes=1, lanes_per_thread=2), "does not fit"),
    (dict(rows_per_thread=4, lanes_per_thread=4), "tile"),
    (dict(route="device", lanes=2), "does not fit"),
    (dict(route="device", place="fp64"), "does not fit"),
])
def test_wide_recurrence_plan_refuses_layouts_the_kernels_do_not_take(small_op, kwargs, match):
    """Kernels, lanes, placements, routes, tiles and threads the kernels
    have no code for are refused with ValueError before any launch."""
    kernel = kwargs.pop("kernel", "rollout")
    with pytest.raises(ValueError, match=match):
        riccati_fused.wide_recurrence_plan(_shape(small_op, 30, 64, 32), 1024, kernel, **kwargs)


def test_wide_recurrences_take_every_width(small_op):
    """No width is refused: past what shared memory holds at one lane the
    lane buffers go to a device scratch, whose floats grow with the width."""
    for nx, nu in ((1, 1), (3, 40), (500, 250), (5000, 100), (40000, 20), (100000, 50)):
        for kernel in riccati_fused.WIDE_REC_KERNELS:
            plan = riccati_fused.wide_recurrence_plan(_shape(small_op, 3, nx, nu), 5, kernel)
            assert plan.smem_bytes <= SMEM_LIMIT
            if nx >= 40000:
                assert plan.route == "device" and plan.scratch_floats >= 5 * 4 * nx


def test_recurrence_routes_by_tier(small_op):
    """The drivers' rollout and certificate of each of K3's register tiers go
    where RECURRENCE_ROUTES (the A/B on the card) puts them; past K3's tiers
    the wide ones run. _start and _check follow the table: on the CPU each
    runs the plain version counted under the routed kernel's name."""
    tiers = {(4, 2): (4, 2), (3, 1): (4, 2), (8, 4): (8, 4), (16, 8): (16, 8), (9, 5): (16, 8),
             (32, 16): (32, 16), (17, 9): (32, 16)}
    for (nx, nu), tier in tiers.items():
        op = _shape(small_op, 6, nx, nu)
        assert riccati_fused.recurrence_kernel(op) == riccati_fused.RECURRENCE_ROUTES[tier]
    for nx, nu in ((33, 16), (32, 17), (40, 20), (64, 32)):
        assert riccati_fused.recurrence_kernel(_shape(small_op, 6, nx, nu)) == "wide"
    assert set(riccati_fused.RECURRENCE_ROUTES) == {(4, 2), (8, 4), (16, 8), (32, 16)}
    assert set(riccati_fused.RECURRENCE_ROUTES.values()) <= {"K3", "wide"}
    # the drivers' start and check on the QTP's tier, counted by name
    op = small_op
    names = (("rollout", "certificate") if riccati_fused.recurrence_kernel(op) == "K3"
             else ("rollout-wide", "certificate-wide"))
    before = dict(admm_fused.PLAIN_CALLS)
    e0s = torch.from_numpy(np.random.default_rng(1).standard_normal((5, 4)).astype(np.float32))
    e0T, ballr, Xbar, state = riccati_fused._start(op, 0.1 * e0s, None, None)
    riccati_fused._check(op, riccati.RiccatiConfig(), state, state, torch.full((5,), 1.0),
                         torch.ones(1), Xbar, ballr)
    assert admm_fused.PLAIN_CALLS[names[0]] == before[names[0]] + 2
    assert admm_fused.PLAIN_CALLS[names[1]] == before[names[1]] + 1


def test_wide_rollout_and_certificate_on_cpu_match_jax(small_op):
    """On CPU tensors the wide wrappers run their plain versions (counted,
    no launch): the rollout within fp32 roundoff of the JAX package's
    rollout_warm, the certificate's terms equal to the K3 wrapper's (one
    plain version) on the same deltas."""
    op = small_op
    rng = np.random.default_rng(3)
    B = 7
    e0 = (0.5 * rng.standard_normal((B, 4))).astype(np.float32)
    U = (0.5 * rng.standard_normal((B, op.N, 2))).astype(np.float32)
    before = dict(admm_fused.PLAIN_CALLS)
    launches = dict(admm_fused.LAUNCHES)
    X = riccati_fused.rollout_wide(op, torch.from_numpy(e0.T.copy()),
                                   torch.from_numpy(U.transpose(1, 2, 0).copy()))
    jo = jric.build_riccati_operator(
        np.asarray(op.factors.A), np.asarray(op.factors.B), np.eye(4), np.eye(2),
        2.0 * np.eye(4), op.N, -np.ones(4), np.ones(4), -np.ones(2), np.ones(2),
        state_constraint=True)
    Xj = np.stack([np.asarray(jric.rollout_warm(jo, jnp.asarray(e0[b]), jnp.asarray(U[b])))
                   for b in range(B)], axis=-1)
    np.testing.assert_allclose(X.numpy(), Xj, rtol=0, atol=1e-6 * max(1.0, np.abs(Xj).max()))
    t = lambda *shape: torch.from_numpy((0.1 * rng.standard_normal(shape)).astype(np.float32))
    lamX = [t(op.N + 1, 4, B) for _ in range(2)]
    lamU = [t(op.N, 2, B) for _ in range(2)]
    ballr = torch.zeros(B)
    args = (op, lamX[0], lamX[1], lamU[0], lamU[1], X, ballr)
    wide = riccati_fused.certificate_terms_wide(*args)
    k3 = riccati_fused.certificate_terms(*args)
    assert torch.equal(wide, k3) and wide.shape == (3, B)
    assert admm_fused.PLAIN_CALLS["rollout-wide"] == before["rollout-wide"] + 1
    assert admm_fused.PLAIN_CALLS["certificate-wide"] == before["certificate-wide"] + 1
    assert admm_fused.LAUNCHES == launches
