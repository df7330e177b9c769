"""K3's plain version, the driver's recurrences and the fused Riccati path,
port vs JAX.

The JAX side runs ops/riccati_pallas in interpret mode on the CPU, as the
JAX package's own tests do. Both drivers adapt one rho for the whole batch,
so the port's fused path is held against JAX's fused path (and against the
per-lane engine only through the JAX package's own tests). Inputs are made
with numpy from a seed and handed to both packages."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu import parallel as jpar
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops import riccati_pallas
from automationlabsmodelpredictivecontrol_jl_tpu.ops.riccati import RiccatiConfig as JConfig

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import STATUS_PRIMAL_INFEASIBLE, interop
from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused, riccati_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops.riccati import RiccatiConfig as TConfig

torch.set_num_threads(1)

BRANCHES = {
    "none": dict(),
    "state": dict(mpc_state_constraint=True),  # split_interior
    "contractive": dict(mpc_terminal_ingredient="contractive"),  # terminal_ball
    "equality": dict(mpc_terminal_ingredient="equality"),  # term_rho_scale 100
}
# plain chunk vs the JAX kernel: both form each product in a different
# fp32 order (XLA's f32 dot, the port's fp64 sums), so they differ by fp32
# roundoff, relative to each array's largest entry
CHUNK_RTOL = 1e-5
TOL, TOL_WIDE = 5e-5, 2e-4  # tests/test_riccati_pallas.py's bars
CFG = dict(max_iter=4000, eps_abs=1e-6, eps_rel=1e-6)


def _pair(horizon, cfg=None, **kw):
    jc = jmpc.proceed_controller(
        jqtp.linearized_discrete_system(), "model_predictive_control", horizon, 5.0,
        np.full(4, 0.65), np.full(2, 1.2), engine="riccati",
        riccati_config=None if cfg is None else JConfig(**cfg), **kw,
    )
    tc = tmpc.proceed_controller(
        tqtp.linearized_discrete_system(), "model_predictive_control", horizon, 5.0,
        [0.65] * 4, [1.2] * 2, engine="riccati",
        riccati_config=None if cfg is None else TConfig(**cfg), device="cpu", **kw,
    )
    return jc, tc


@pytest.fixture(scope="module")
def branch_ops():
    return {k: _pair(12, **kw) for k, kw in BRANCHES.items()}


def _chunk_inputs(N, B, seed):
    rng = np.random.default_rng(seed)
    e0 = (0.1 * rng.standard_normal((4, B))).astype(np.float32)
    ballr = (np.sqrt(0.9) * np.linalg.norm(e0, axis=0)).astype(np.float32)
    noise = lambda *shape: (0.05 * rng.standard_normal(shape)).astype(np.float32)
    return e0, ballr, noise(N + 1, 4, B), noise(N, 2, B), noise(N + 1, 4, B), noise(N, 2, B)


@pytest.mark.parametrize("chunk", [1, 25])
@pytest.mark.parametrize("ridx", [1, 3])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_plain_chunk_matches_jax_interpret(branch_ops, branch, ridx, chunk):
    jc, tc = branch_ops[branch]
    jo, to = jc.engine.op, tc.engine.op
    e0, ballr, vX, vU, lamX, lamU = _chunk_inputs(12, 8, seed=ridx + len(branch))
    out_j = riccati_pallas._run_chunk(
        jo, ridx, jnp.asarray(e0), jnp.asarray(ballr[None]),
        *(jnp.asarray(a) for a in (vX, vU, lamX, lamU)), chunk, True,
    )
    calls = dict(admm_fused.PLAIN_CALLS)
    out_t = riccati_fused.iterate_chunk_riccati(
        to, torch.tensor([ridx], dtype=torch.int32), torch.from_numpy(e0),
        torch.from_numpy(ballr), *(torch.from_numpy(a) for a in (vX, vU, lamX, lamU)), chunk,
    )
    # CPU tensors take K3's plain version
    assert admm_fused.PLAIN_CALLS == dict(calls, K3=calls["K3"] + 1)
    for name, a, b in zip(("X", "U", "vX", "vU", "lamX", "lamU"), out_t, out_j):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        bar = CHUNK_RTOL * max(1.0, np.abs(b).max())
        assert np.abs(a.numpy() - b).max() <= bar, (name, np.abs(a.numpy() - b).max())


def _cert_f64(op, dlx, dlu, Xbar, ballr):
    """The certificate's terms in numpy f64, per lane."""
    f = lambda t: np.asarray(t, np.float64)
    A, Bm = f(op.factors.A), f(op.factors.B)
    g = dlx[-1]
    ortho = np.zeros(dlx.shape[-1])
    for k in range(op.N - 1, -1, -1):
        ortho = np.maximum(ortho, np.abs(Bm.T @ g + dlu[k]).max(0))
        g = A.T @ g + dlx[k]

    def sup(d, lo, hi):
        lo, hi = f(lo)[:, None], f(hi)[:, None]
        pos = np.where(d > 0, np.where(np.isfinite(hi), hi * d, np.inf), 0.0)
        neg = np.where(d < 0, np.where(np.isfinite(lo), lo * d, np.inf), 0.0)
        return (pos + neg).sum(axis=(0, 1))

    s = sup(dlu, op.u_lo, op.u_hi)
    if op.split_interior:
        s = s + sup(dlx[1:-1], op.x_lo, op.x_hi)
    if op.terminal_ball:
        s = s + ballr * np.linalg.norm(dlx[-1], axis=0)
    elif op.split_terminal:
        s = s + sup(dlx[-1:], op.xN_lo, op.xN_hi)
    support = s - (dlx * Xbar).sum(axis=(0, 1))
    dnorm = np.maximum(np.abs(dlx).max(axis=(0, 1)), np.abs(dlu).max(axis=(0, 1)))
    return np.stack([ortho, support, dnorm])


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_recurrences_plain_versions(branch_ops, branch):
    """The rollout and the certificate's terms on CPU tensors: their plain
    versions, against JAX's rollout and an f64 evaluation of the
    certificate (the state branch's x box is finite: its support is)."""
    _, tc = branch_ops[branch]
    op = tc.engine.op
    e0, ballr, lamX_old, lamU_old, lamX_new, lamU_new = _chunk_inputs(12, 8, seed=11)
    U = torch.from_numpy(lamU_new)
    calls = dict(admm_fused.PLAIN_CALLS)
    X = riccati_fused.rollout(op, torch.from_numpy(e0), U)
    terms = riccati_fused.certificate_terms(
        op, *(torch.from_numpy(a) for a in (lamX_new, lamX_old, lamU_new, lamU_old)), X,
        torch.from_numpy(ballr),
    )
    assert admm_fused.PLAIN_CALLS == dict(
        calls, rollout=calls["rollout"] + 1, certificate=calls["certificate"] + 1
    )
    want = _cert_f64(
        op, np.float64(lamX_new) - lamX_old, np.float64(lamU_new) - lamU_old,
        X.numpy().astype(np.float64), np.float64(ballr),
    )
    assert terms.shape == (3, 8)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(terms.numpy()), finite)
    np.testing.assert_allclose(terms.numpy()[finite], want[finite], rtol=1e-5, atol=1e-6)


def _e0s(B, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    return np.clip(scale * rng.standard_normal((B, 4)), -0.3, 0.3).astype(np.float32)


def _solve_pair(jc, tc, e0s, cfg, **warm):
    out_j = riccati_pallas.solve_sparse_fused(
        jc.engine.op, jnp.asarray(e0s), config=JConfig(**cfg), interpret=True,
    )
    out_t = riccati_fused.solve_sparse_fused(
        tc.engine.op, torch.from_numpy(e0s), config=TConfig(**cfg), **warm
    )
    return out_t, out_j


# the four cases of tests/test_riccati_pallas.py, port-fused vs JAX-fused
CASES = {
    "h12-none": (12, dict(), dict(B=8), CFG, TOL),
    "h12-state": (12, dict(mpc_state_constraint=True), dict(B=8), CFG, TOL),
    "h12-state-contractive": (
        12, dict(mpc_state_constraint=True, mpc_terminal_ingredient="contractive"),
        dict(B=8), CFG, TOL,
    ),
    "h3-ball-binds": (
        3, dict(mpc_terminal_ingredient="contractive"), dict(B=8, seed=3, scale=0.25),
        dict(CFG, max_iter=20000), TOL_WIDE,
    ),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_solve_matches_jax_fused(case):
    N, kw, x0, cfg, tol = CASES[case]
    jc, tc = _pair(N, **kw)
    e0s = _e0s(**x0)
    (Xt, Ut, st, it, _, _, _), (Xj, Uj, sj, ij, _, _, _) = _solve_pair(jc, tc, e0s, cfg)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (st.numpy() == 0).all()
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), atol=tol)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=tol)
    # batch-global rho: the whole batch takes the same walk in both drivers
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    if tc.engine.op.terminal_ball:
        r = np.sqrt(0.9) * np.linalg.norm(e0s, axis=1)
        assert np.all(np.linalg.norm(Xt.numpy()[:, -1], axis=1) <= r + 1e-3)


def test_fused_equality_boost_and_certificate():
    """The boosted equality terminal certifies near the reference as JAX's
    fused path does; an unreachable equality from a wide e0 is primal
    infeasible by the certificate in both."""
    cfg = dict(CFG, max_iter=20000)
    jc, tc = _pair(5, mpc_terminal_ingredient="equality")
    assert tc.engine.op.term_rho_scale == 100.0
    e0s = np.asarray([[0.002, -0.002, 0.001, -0.001], [0.001, 0.002, -0.001, 0.0]], np.float32)
    (Xt, Ut, st, it, _, _, _), (Xj, Uj, sj, ij, _, _, _) = _solve_pair(jc, tc, e0s, cfg)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (st.numpy() == 0).all()
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), atol=TOL_WIDE)
    assert float(np.abs(Xt.numpy()[:, -1]).max()) < 1e-4
    # each lane's count is roundoff-decided over thousands of iterations
    assert np.abs(it.numpy() - np.asarray(ij)).max() <= 50

    jc, tc = _pair(3, mpc_terminal_ingredient="equality")
    e0 = np.full((1, 4), 0.3, np.float32)
    (_, _, st, it, _, _, _), (_, _, sj, ij, _, _, _) = _solve_pair(jc, tc, e0, dict(max_iter=4000))
    assert int(st[0]) == int(sj[0]) == STATUS_PRIMAL_INFEASIBLE
    assert int(it[0]) == int(ij[0])


def test_warm_start_does_not_raise_iterations():
    jc, tc = _pair(12, mpc_state_constraint=True)
    e0s = _e0s(8, seed=1)
    _, U1, st1, it1, _, _, lam1 = riccati_fused.solve_sparse_fused(
        tc.engine.op, torch.from_numpy(e0s), config=TConfig(**CFG)
    )
    _, _, st2, it2, _, _, _ = riccati_fused.solve_sparse_fused(
        tc.engine.op, torch.from_numpy(e0s), warm_U=U1, warm_lam=lam1, config=TConfig(**CFG)
    )
    assert (st1.numpy() == 0).all() and (st2.numpy() == 0).all()
    assert float(it2.float().mean()) <= float(it1.float().mean())


def test_slice_matches_jax_through_entry_points():
    """proceed_controller(engine="riccati") -> solve_batch_auto (the port
    routes to K3) against the JAX package's solve_batch_fused: statuses,
    solutions, objective, the shifted warm carry and the x0-box status; a
    second solve from the carried warm pair in both packages."""
    cfg = dict(max_iter=1000)
    jc, tc = _pair(12, cfg, mpc_state_constraint=True)
    assert tpar.fused_supported(tc)
    rng = np.random.default_rng(4)
    x0 = np.clip(0.65 + 0.1 * rng.standard_normal((6, 4)), 0.3, 1.3).astype(np.float32)
    x0[5, 0] = 1.40  # above X.hi = 1.36: infeasible before any iteration
    js, jwz, jwy, jd = jpar.solve_batch_fused(jc, jnp.asarray(x0))
    calls = dict(admm_fused.PLAIN_CALLS)
    ts, twz, twy, td = tpar.solve_batch_auto(tc, torch.from_numpy(x0))
    assert admm_fused.PLAIN_CALLS["K3"] > calls["K3"]
    assert admm_fused.PLAIN_CALLS["K1"] == calls["K1"] and admm_fused.PLAIN_CALLS["K2"] == calls["K2"]
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    assert int(ts.status[5]) == STATUS_PRIMAL_INFEASIBLE and int(td.n_infeasible) == 1
    assert ts.u.shape == (6, 2, 12) and ts.x.shape == (6, 4, 13)
    assert twz.shape == (6, 24) and twy.shape == (6, 13 * 4 + 12 * 2)
    for name, a, b in (("u", ts.u, js.u), ("x", ts.x, js.x), ("objective", ts.objective, js.objective),
                       ("wz", twz, jwz), ("wy", twy, jwy)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_WIDE, err_msg=name)
    js2, _, _, jd2 = jpar.solve_batch_fused(jc, jnp.asarray(x0), jwz, jwy)
    ts2, _, _, td2 = tpar.solve_batch_fused(tc, torch.from_numpy(x0), twz, twy)
    np.testing.assert_array_equal(ts2.status.numpy(), np.asarray(js2.status))
    np.testing.assert_allclose(ts2.u.numpy(), np.asarray(js2.u), atol=TOL_WIDE)
    assert float(td2.mean_iterations) <= float(td.mean_iterations)

    # the receding-horizon loop carries the same warm pair; escalation keeps
    # the controller and restarts stragglers on the per-lane engine (none
    # here: the statuses and solutions are tier 1's, as in JAX)
    xs, us, sts = tpar.closed_loop_batch(tc, tqtp.qtp_discrete_step, torch.from_numpy(x0[:4]), 2)
    assert xs.shape == (3, 4, 4) and bool(torch.isfinite(xs).all())
    np.testing.assert_allclose(us[0].numpy(), ts.u[:4, :, 0].numpy(), atol=0)
    assert tpar.escalation_controller(tc) is tc
    te, _, _, _ = tpar.solve_batch_escalated(tc, tc, torch.from_numpy(x0), twz, twy)
    je, _, _, _ = jpar.solve_batch_escalated(jc, jc, jnp.asarray(x0), jwz, jwy)
    np.testing.assert_array_equal(te.status.numpy(), np.asarray(je.status))
    np.testing.assert_array_equal(te.status.numpy(), ts2.status.numpy())
    np.testing.assert_allclose(te.u.numpy(), np.asarray(je.u), atol=TOL_WIDE)


def _export(jc):
    """The JAX Riccati controller's designed arrays as numpy, for interop."""
    op, t = jc.engine.op, jc.tuning
    as_np = lambda v: v if isinstance(v, (bool, int, float, tuple)) or v is None else np.asarray(v)
    ops = {f.name: as_np(getattr(op, f.name)) for f in dataclasses.fields(op) if f.name != "factors"}
    ops["factors"] = {f.name: np.asarray(getattr(op.factors, f.name)) for f in dataclasses.fields(op.factors)}
    return dict(
        op=ops,
        references={"x": np.asarray(t.references.x), "u": np.asarray(t.references.u)},
        weights={k: np.asarray(getattr(t.weights, k)) for k in ("Q", "R", "S")},
        terminal_P=np.asarray(t.terminal.P),
        config=dataclasses.asdict(jc.engine.config),
        tuning=dict(
            horizon=t.horizon, sample_time=t.sample_time, max_time=t.max_time,
            programming_type=t.programming_type, solver_name=t.solver_name,
            state_constraint=t.state_constraint, terminal_kind=t.terminal.kind,
        ),
    )


def test_interop_carries_a_jax_riccati_controller():
    jc, tc = _pair(12, dict(max_iter=1000), mpc_terminal_ingredient="contractive")
    rc = interop.controller_from_numpy(**_export(jc), device="cpu")
    assert rc.engine.config == tc.engine.config
    ro, to = rc.engine.op, tc.engine.op
    for f in dataclasses.fields(to):
        a, b = getattr(ro, f.name), getattr(to, f.name)
        if f.name == "factors":
            for g in dataclasses.fields(b):
                assert torch.equal(getattr(a, g.name), getattr(b, g.name)), g.name
        elif isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    assert rc.warm_z.shape == tc.warm_z.shape and rc.warm_y.shape == tc.warm_y.shape
    x0 = torch.from_numpy(np.clip(0.65 + 0.05 * np.random.default_rng(2).standard_normal((4, 4)),
                                  0.3, 1.3).astype(np.float32))
    sr, _, _, _ = tpar.solve_batch_fused(rc, x0)
    st, _, _, _ = tpar.solve_batch_fused(tc, x0)
    assert torch.equal(sr.u, st.u) and torch.equal(sr.status, st.status)


def test_k3_fits_and_wrapper_guards(branch_ops):
    _, tc = branch_ops["none"]
    op = tc.engine.op
    assert riccati_fused.k3_fits(op)
    assert riccati_fused.k3_fits(dataclasses.replace(op, nx=32, nu=16))
    wide = dataclasses.replace(op, nx=riccati_fused.MAX_NX + 1)
    assert not riccati_fused.k3_fits(wide)
    # fused past K3 too: K3W takes plants of any width
    assert tpar.fused_supported(tc.replace(engine=tc.engine.replace(op=wide)))
    with pytest.raises(ValueError, match="runs on CUDA"):
        riccati_fused.iterate_chunk_riccati(
            op, torch.zeros(1, dtype=torch.int32, device="meta"), *([None] * 6), 25
        )


def _shape(op, N, nx=4, nu=2, branch="none"):
    """The operator's shape as k3_plan reads it, at another horizon, width
    and branch (the plan reads no tensor)."""
    return dataclasses.replace(
        op, N=N, nx=nx, nu=nu,
        split_interior=branch == "state",
        split_terminal=branch != "none",
        terminal_ball=branch == "contractive",
    )


def _k3_bytes(op, plan):
    """The shared memory csrc/riccati_chunk.cuh lays out for a plan (its
    launch_chunk refuses a launch whose bytes differ)."""
    mx, mu = next(t for t in ((4, 2), (8, 4), (16, 8), (32, 16)) if op.nx <= t[0] and op.nu <= t[1])
    N, nx, nu = op.N, op.nx, op.nu
    fac = {0: 8 * (N * (mu * mx + mu * mu + mx * mx) + mx * mx + mx * mu),
           1: (4 * (N * (nu * nx + nu * nu + nx * nx) + nx * nx + nx * nu) + 15) // 16 * 16,
           2: 0}[plan.fac_mode]
    xrows = N if op.split_interior else int(op.split_terminal or op.terminal_ball)
    rows = 4 * plan.lanes * (3 * N * nu + 2 * xrows * nx) if plan.rows_shared else 0
    return fac + rows


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("N", [50, 100, 200, 500, 800])
def test_k3_plan_gives_every_suite_shape_a_route(branch_ops, N, branch):
    """Every horizon of the suite's Riccati sweep, on every branch, register
    tier and batch size: a route within shared memory whose blocks cover
    the batch, with the bytes the kernel's layout takes."""
    op0 = branch_ops["none"][1].engine.op
    for nx, nu in ((4, 2), (8, 4), (16, 8), (3, 1)):
        for B in (1, 33, 1000, 1024, 4096):
            op = _shape(op0, N, nx, nu, branch)
            assert riccati_fused.k3_fits(op)
            plan = riccati_fused.k3_plan(op, B)
            assert plan.route in riccati_fused.K3_ROUTES
            assert 1 <= plan.lanes <= plan.threads == 128
            assert plan.blocks * plan.lanes >= B > (plan.blocks - 1) * plan.lanes
            assert 0 <= plan.smem_bytes <= 232448
            assert plan.smem_bytes == _k3_bytes(op, plan)
            assert (plan.rows_shared, plan.fac_mode) == riccati_fused.K3_ROUTES[plan.route][:2]
            # no more lanes in a block than spread the batch over the card
            assert plan.lanes <= max(1, -(-B // riccati_fused.SM_COUNT))


def test_k3_plan_routes_by_shape(branch_ops):
    op0 = branch_ops["none"][1].engine.op
    plan = riccati_fused.k3_plan
    # the h500 cell: eight lanes beside the fp64 factors, 128 blocks
    p = plan(_shape(op0, 500), 1024)
    assert (p.route, p.lanes, p.blocks, p.smem_bytes) == ("shared-fp64", 8, 128, 208192)
    # the h50 cell fills the card with one warp of lanes per block
    p = plan(_shape(op0, 50), 4096)
    assert (p.route, p.lanes, p.blocks) == ("shared-fp64", 32, 128)
    # state rows at h500: 28 KB a lane, fewer lanes or lighter factors
    p = plan(_shape(op0, 500, branch="state"), 1024)
    assert p.rows_shared and 1 <= p.lanes < 8 or p.fac_mode != 0
    # a horizon whose rows outgrow shared memory streams them
    p = plan(_shape(op0, 5000, branch="state"), 1024)
    assert (p.route, p.smem_bytes, p.rows_shared) == ("stream", 0, False)
    assert plan(_shape(op0, 1200, 16, 8, "state"), 64).route == "stream"
    # a forced route is taken where it fits and refused where it does not
    for route in riccati_fused.K3_ROUTES:
        assert plan(_shape(op0, 50), 77, route).route == route
    with pytest.raises(ValueError, match="does not fit"):
        plan(_shape(op0, 5000, branch="state"), 1024, "shared-l2")
    with pytest.raises(ValueError, match="unknown K3 route"):
        plan(_shape(op0, 50), 77, "registers")
    with pytest.raises(ValueError, match="nx <= 32"):
        plan(_shape(op0, 50, nx=33), 77)


@pytest.mark.parametrize("N,nx,nu,B", [(500, 4, 2, 1024), (50, 4, 2, 4096), (800, 16, 8, 1),
                                        (20000, 4, 2, 33), (12, 3, 1, 100000)])
def test_certificate_plan_fits(branch_ops, N, nx, nu, B):
    op = _shape(branch_ops["none"][1].engine.op, N, nx, nu, "state")
    lanes, tile, smem = riccati_fused.certificate_plan(op, B)
    assert 1 <= lanes <= 128 and 1 <= tile <= N and smem <= 232448
    mx, mu = next(t for t in ((4, 2), (8, 4), (16, 8), (32, 16)) if nx <= t[0] and nu <= t[1])
    assert smem == 8 * mx * (mx + mu) + 4 * tile * lanes * (2 * nx + nu)
    if (N, B) == (500, 1024):  # the h500 cell: the whole horizon in one tile
        assert (lanes, tile) == (8, 500)
