"""K4 and K5, the dense-A kernels, and the fused driver on dense operators,
port vs JAX.

A dense operator is any QP whose rows are not box-first. The QPs here are
the designer's own condensed QTP QPs with their state or terminal rows
moved above the input-box rows (OSQP's convention: coupling rows first,
variable bounds last). Permuting the rows leaves the QP and its optimum as
they were, so the dense path is also held to the mixed path (K2) on the
same QP. The JAX side runs ops/admm_pallas in interpret mode on the CPU, as
the JAX package's own tests do; inputs are made with numpy from a seed.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops import admm as jadmm
from automationlabsmodelpredictivecontrol_jl_tpu.ops import admm_pallas
from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig as JConfig

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import interop
from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.design import LinearEngine
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm as tadmm
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig as TConfig
from automationlabsmodelpredictivecontrol_jl_torch.ops.condense import (
    runtime_qp_vectors_batch,
)

torch.set_num_threads(1)

# the h20 QPs of the dense cells: the equality terminal (n=40, m=44) at the
# suite's R=5/refine 1 runs K4 with refinement; the state box (m=120) at
# tier 1's grid (1, 10) without refinement runs K4 without it, and at R=5/
# refine 1 runs K5
SHAPES = {
    "eq": (dict(mpc_terminal_ingredient="equality"), dict(max_iter=1000)),
    "sc-t1": (
        dict(mpc_state_constraint=True),
        dict(max_iter=1000, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0),
    ),
    "sc": (dict(mpc_state_constraint=True), dict(max_iter=1000)),
}
KERNEL = {"eq": "K4", "sc-t1": "K4", "sc": "K5"}
# two more QPs on K4, held to the JAX body at its chunk: the neighborhood
# terminal (m = 52, the shape K4's stream route takes) and the equality
# terminal at tier 2's grid (R = 4, 2 refinements)
K4_MORE = {
    "nb": (dict(mpc_terminal_ingredient="neighborhood"), dict(max_iter=1000)),
    "eq-t2": (
        dict(mpc_terminal_ingredient="equality"),
        dict(max_iter=250, rho_grid=(0.1, 1.0, 10.0, 100.0), refine_steps=2),
    ),
}
# K2's bars (tests/test_torch_admm_mixed.py)
RTOL, ATOL = 1e-4, 1e-5
EPS_ABOVE_FLOOR = dict(eps_abs=1e-4, eps_rel=1e-4, check_interval=5, adapt_interval=5)
TOL = 5e-4  # the JAX package's fused-vs-engine bar
Z_TOL = 2e-4  # the fused path's golden bar, at eps 1e-6


def _eq_mask(l, u):
    """Equality rows, as the designer marks them (design.py)."""
    return np.isfinite(l) & np.isfinite(u) & (l == u)


def dense_pair(horizon, rows, cfg):
    """The designed JAX and port controllers, and each package's dense
    controller for the same QP with its state/terminal rows first: the
    condensed QP's rows permuted, and each package's own build_operator on
    A[perm] and the permuted equality mask. Returns (jc, tc, jd, td, perm)."""
    jc = jmpc.proceed_controller(
        jqtp.linearized_discrete_system(), "model_predictive_control", horizon, 5.0,
        np.full(4, 0.65), np.full(2, 1.2), admm_config=JConfig(**cfg), **rows,
    )
    tc = tmpc.proceed_controller(
        tqtp.linearized_discrete_system(), "model_predictive_control", horizon, 5.0,
        [0.65] * 4, [1.2] * 2, admm_config=TConfig(**cfg), device="cpu", **rows,
    )
    m, n = tc.engine.qp.A.shape
    perm = np.r_[np.arange(n, m), np.arange(n)]

    jqp = jc.engine.qp
    jqp_d = dataclasses.replace(
        jqp, **{k: jnp.asarray(np.asarray(getattr(jqp, k))[perm])
                for k in ("A", "l_const", "u_const", "b_x0")}
    )
    jop = jadmm.build_operator(
        np.asarray(jqp_d.P), np.asarray(jqp_d.A),
        _eq_mask(np.asarray(jqp_d.l_const), np.asarray(jqp_d.u_const)), 0, jc.engine.config,
    )
    jd = dataclasses.replace(jc, engine=dataclasses.replace(jc.engine, qp=jqp_d, op=jop))

    tqp = tc.engine.qp
    tqp_d = tqp.replace(**{k: getattr(tqp, k)[perm] for k in ("A", "l_const", "u_const", "b_x0")})
    top = tadmm.build_operator(
        tqp_d.P.numpy(), tqp_d.A.numpy(),
        _eq_mask(tqp_d.l_const.numpy(), tqp_d.u_const.numpy()), 0, tc.engine.config,
    )
    td = tc.replace(
        engine=LinearEngine(qp=tqp_d, op=top, soft_mu=None, config=tc.engine.config)
    )
    return jc, tc, jd, td, perm


@pytest.fixture(scope="module")
def designs():
    return {k: dense_pair(20, rows, cfg) for k, (rows, cfg) in SHAPES.items()}


def _x0s(B, seed, spread=0.002):
    rng = np.random.default_rng(seed)
    return (0.65 + spread * rng.standard_normal((B, 4))).astype(np.float32)


def _qp_vectors(td, x0s):
    e0s = torch.from_numpy(x0s) - td.tuning.references.x[:, 0]
    q, l, u, _, _ = runtime_qp_vectors_batch(td.engine.qp, e0s)
    return q, l, u


def _chunk_inputs(td, B, seed):
    """Scaled lane-last QP vectors from real initial states, and a state
    near the driver's cold start with a small seeded perturbation."""
    op = td.engine.op
    R = op.rho_grid.shape[0]
    q, l, u = _qp_vectors(td, _x0s(B, seed))
    qT = ((op.c * op.D)[:, None] * q.T).numpy()
    lT = (op.E[:, None] * l.T).numpy()
    uT = (op.E[:, None] * u.T).numpy()
    n, m = qT.shape[0], lT.shape[0]
    rng = np.random.default_rng(seed + 1)
    x = (0.05 * rng.standard_normal((n, B))).astype(np.float32)
    y, ax = ((0.05 * rng.standard_normal((m, B))).astype(np.float32) for _ in range(2))
    s = np.clip(ax, lT, uT)
    idx = rng.integers(0, R, size=B).astype(np.int32)
    return [qT, lT, uT, idx, x, s, y, ax]


def _chunk_f64(op, cfg, qT, lT, uT, idx, x, s, y, ax, chunk):
    """The same chunk in numpy f64 on the stored operator (K4's and K5's
    math agree in exact arithmetic: rhs K^-1 A' = A xt)."""
    f64 = lambda t: np.asarray(t, np.float64)
    A = f64(op.A_s)
    Ki = f64(op.K_invs)[idx]  # (B, n, n), each lane's own
    K = f64(op.Ks)[idx]
    rho, rho_inv = f64(op.rho_vecs)[idx].T, f64(op.rho_invs)[idx].T
    row_times = lambda M, v: np.einsum("bji,jb->ib", M, v)  # v' M per lane
    x, s, y, ax = (f64(a) for a in (x, s, y, ax))
    a = float(cfg.alpha)
    for _ in range(chunk):
        rhs = cfg.sigma * x - qT - A.T @ y + A.T @ (rho * s)
        xt = row_times(Ki, rhs)
        for _ in range(cfg.refine_steps):
            xt = xt + row_times(Ki, rhs - row_times(K, xt))
        st = A @ xt
        x_new = a * xt + (1 - a) * x
        v = a * st + (1 - a) * s
        s_new = np.clip(v + rho_inv * y, lT, uT)
        y = y + rho * (v - s_new)
        ax = a * st + (1 - a) * ax
        x, s = x_new, s_new
    return x, s, y, ax


def test_dense_operators_match_jax(designs):
    """Each package's build_operator on the permuted QP: a dense operator
    (neither diagonal nor mixed), the same f32 arrays, and K4's kia."""
    for key, (_, _, jd, td, _) in designs.items():
        jop, top = jd.engine.op, td.engine.op
        assert top.dense_a and not (jop.diag_a or jop.mixed_a), key
        for name in ("A_s", "Ks", "K_invs", "rho_vecs", "rho_invs", "D", "E"):
            np.testing.assert_array_equal(
                getattr(top, name).numpy(), np.asarray(getattr(jop, name)), err_msg=name
            )
        assert top.kia.shape == (top.rho_grid.shape[0],) + tuple(top.A_s.T.shape)


@pytest.mark.parametrize("key", list(SHAPES))
def test_packed_operators_match_jax(designs, key):
    """rhs1, kcat and wrow as the JAX package packs them (within 1e-6
    relative: its K^-1 A' is an fp32 product, the port's an fp64 sum
    rounded once); wrow's blocks are wcat's diagonal blocks."""
    _, _, jd, td, _ = designs[key]
    jrhs1, jwcat, jkcat, jwrow = (np.asarray(a) for a in admm_pallas.packed_operators(jd.engine.op))
    rhs1, kcat, wrow = (a.numpy() for a in admm_fused.packed_operators(td.engine.op))
    for name, a, b in (("rhs1", rhs1, jrhs1), ("kcat", kcat, jkcat), ("wrow", wrow, jwrow)):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max(), err_msg=name)
    np.testing.assert_array_equal(rhs1, jrhs1)  # fl(rho A), exactly
    np.testing.assert_array_equal(kcat, jkcat)
    R, n = td.engine.op.K_invs.shape[:2]
    w = wrow.shape[1] // R
    for r in range(R):
        np.testing.assert_array_equal(
            jwcat[r * n:(r + 1) * n, r * w:(r + 1) * w], jwrow[:, r * w:(r + 1) * w]
        )


@pytest.mark.parametrize("chunk", [1, 25])
@pytest.mark.parametrize("B", [16, 8])
@pytest.mark.parametrize("key", list(SHAPES))
def test_plain_chunk_matches_jax_interpret(designs, key, B, chunk):
    """One iteration agrees with the JAX kernel at K2's bar. Over 25
    iterations the port's distance from exact arithmetic is held to the JAX
    kernel's own, within the same bar. CPU tensors take the plain version
    of the kernel that both packages' variant rule picks."""
    _, _, jd, td, _ = designs[key]
    _hold_plain_to_jax(jd, td, KERNEL[key], B, chunk, seed=B + len(key))


@pytest.fixture(scope="module")
def more_designs():
    return {k: dense_pair(20, rows, cfg) for k, (rows, cfg) in K4_MORE.items()}


@pytest.mark.parametrize("chunk", [1, 25])
@pytest.mark.parametrize("key", list(K4_MORE))
def test_plain_k4_matches_jax_interpret_on_more_qps(more_designs, key, chunk):
    """The plain K4 against the JAX body, as above, on the neighborhood QP
    with its rows first (m = 52) and on the equality QP at tier 2's grid
    (R = 4, refine 2)."""
    _, _, jd, td, _ = more_designs[key]
    assert td.engine.op.A_s.shape[0] == (52 if key == "nb" else 44)
    _hold_plain_to_jax(jd, td, "K4", 8, chunk, seed=30 + len(key))


def _hold_plain_to_jax(jd, td, want, B, chunk, seed):
    op, cfg = td.engine.op, td.engine.config
    args = _chunk_inputs(td, B, seed=seed)
    m, n = op.A_s.shape
    R = int(op.rho_grid.shape[0])
    packed = want == "K4"
    assert admm_fused.use_packed(n, m, R, cfg.refine_steps) is packed
    assert admm_pallas._use_packed(n, m, R, cfg.refine_steps) is packed
    calls = dict(admm_fused.PLAIN_CALLS)
    out_t = admm_fused.chunk_fn_for(op, config=cfg)(
        op, *[torch.from_numpy(a) for a in args], chunk, cfg
    )
    assert admm_fused.PLAIN_CALLS == dict(calls, **{want: calls[want] + 1})
    qT, lT, uT, idx, x, s, y, ax = args
    out_j = admm_pallas._iterate_chunk(
        jd.engine.op, *(jnp.asarray(a.T) for a in (qT, lT, uT)), jnp.asarray(idx),
        *(jnp.asarray(a.T) for a in (x, s, y, ax)), chunk, jd.engine.config, interpret=True,
    )
    exact = _chunk_f64(op, cfg, *args, chunk)
    for name, a, b, e in zip(("x", "s", "y", "ax"), out_t, out_j, exact):
        a, b = a.numpy(), np.asarray(b).T
        assert a.shape == b.shape == e.shape, name
        bar = RTOL * np.abs(b).max() + ATOL
        if chunk == 1:
            assert np.abs(a - b).max() <= bar, (name, np.abs(a - b).max())
        else:
            err_t, err_j = np.abs(a - e).max(), np.abs(b - e).max()
            assert err_t <= err_j + bar, (name, err_t, err_j)


def _solve_pair(jd, td, x0s):
    q, l, u = _qp_vectors(td, x0s)
    out_t = admm_fused.solve_batch_fused(td.engine.op, q, l, u, config=td.engine.config)
    out_j = admm_pallas.solve_batch_fused(
        jd.engine.op, *(jnp.asarray(v.numpy()) for v in (q, l, u)),
        config=jd.engine.config, interpret=True,
    )
    return out_t, out_j


@pytest.mark.parametrize("key", list(SHAPES))
def test_fused_solve_lane_by_lane_above_noise_floor(key):
    """At eps 1e-4 every decision sits two decades above the f32 noise
    floor: statuses and iteration counts agree lane by lane."""
    rows, cfg = SHAPES[key]
    _, _, jd, td, _ = dense_pair(20, rows, dict(cfg, max_iter=200, **EPS_ABOVE_FLOOR))
    (zt, _, _, st, it, _, _), (zj, _, _, sj, ij, _, _) = _solve_pair(jd, td, _x0s(13, seed=5))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert (st.numpy() == 0).all()
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=TOL)


@pytest.mark.parametrize("key", ["eq", "sc"])
def test_fused_solve_at_main_tolerance(designs, key):
    """At eps 1e-6 iteration counts follow each package's roundoff: equal
    statuses and z within the fused path's golden bar."""
    _, _, jd, td, _ = designs[key]
    (zt, _, _, st, _, _, _), (zj, _, _, sj, _, _, _) = _solve_pair(jd, td, _x0s(12, seed=7))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (st.numpy() == 0).all()
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=Z_TOL)


@pytest.mark.parametrize("key", list(SHAPES))
def test_dense_solve_agrees_with_mixed(designs, key):
    """The row-permuted controller through parallel.solve_batch_fused runs
    K4's or K5's plain version (never K2's) and reproduces the mixed (K2)
    solve of the same QP: statuses, and u within the fused bar."""
    _, tc, _, td, _ = designs[key]
    assert tc.engine.op.mixed_a and td.engine.op.dense_a
    assert tpar.fused_supported(td)
    x0 = torch.from_numpy(_x0s(16, seed=11))
    calls = dict(admm_fused.PLAIN_CALLS)
    sd, wz, wy, dd = tpar.solve_batch_fused(td, x0)
    ran = {k: admm_fused.PLAIN_CALLS[k] - calls[k] for k in calls}
    assert ran[KERNEL[key]] > 0
    assert all(v == 0 for k, v in ran.items() if k != KERNEL[key])
    sm, _, _, dm = tpar.solve_batch_fused(tc, x0)
    np.testing.assert_array_equal(sd.status.numpy(), sm.status.numpy())
    np.testing.assert_allclose(sd.u.numpy(), sm.u.numpy(), atol=TOL)
    assert wz.shape == (16, 40) and wy.shape == (16, td.engine.op.A_s.shape[0])
    # tier 1's grid without refinement leaves the state-constrained tail
    # unconverged in 1000 iterations, on K2 as on K4
    assert int(dd.n_converged) == int(dm.n_converged) == (8 if key == "sc-t1" else 16)


def test_interop_carries_a_dense_engine(designs):
    """controller_from_numpy takes the JAX dense engine with its permuted
    QP: the same operator as the port's own build, kia formed on the way."""
    jc, _, jd, td, _ = designs["eq"]
    as_np = lambda rec: {
        f.name: (getattr(rec, f.name) if isinstance(getattr(rec, f.name), (int, float, bool, str))
                 else np.asarray(getattr(rec, f.name)))
        for f in dataclasses.fields(rec)
    }
    t = jd.tuning
    rc = interop.controller_from_numpy(
        qp=as_np(jd.engine.qp), op=as_np(jd.engine.op), references=as_np(t.references),
        weights=as_np(t.weights), terminal_P=np.asarray(t.terminal.P),
        config=dataclasses.asdict(jd.engine.config),
        tuning=dict(
            horizon=t.horizon, sample_time=t.sample_time, max_time=t.max_time,
            programming_type=t.programming_type, solver_name=t.solver_name,
            state_constraint=t.state_constraint, terminal_kind=t.terminal.kind,
        ),
        device="cpu",
    )
    rop, top = rc.engine.op, td.engine.op
    assert rop.dense_a and tpar.fused_supported(rc)
    for f in dataclasses.fields(top):
        a, b = getattr(rop, f.name), getattr(top, f.name)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    for name in ("A", "l_const", "u_const", "b_x0"):
        assert torch.equal(getattr(rc.engine.qp, name), getattr(td.engine.qp, name)), name


@pytest.mark.parametrize("refine_steps", [0, 1, 2])
@pytest.mark.parametrize("R", [1, 2, 4, 5, 8])
def test_use_packed_matches_jax(R, refine_steps):
    for n in (4, 10, 20, 40, 64, 100, 128, 200):
        for m in (n + 1, n + 4, 2 * n, 3 * n, 300, 600, 2000):
            assert admm_fused.use_packed(n, m, R, refine_steps) == admm_pallas._use_packed(
                n, m, R, refine_steps
            ), (n, m)


def test_k4_takes_every_packed_shape_within_its_rows():
    """K4 takes every shape that use_packed sends it with n <= 128 and at
    most 4096 rows (past 512 on its wide route); the packed shapes it
    refuses all have more rows (with no refinement, the packed variant wins
    at any row count below its size cap)."""
    refused, wide = set(), set()
    rows = lambda n: [*range(n + 1, 2200, 13), *range(2200, 4400, 97)]
    for R in range(1, 9):
        for rs in range(0, 4):
            for n in range(1, 129):
                for m in rows(n):
                    if not admm_fused.use_packed(n, m, R, rs):
                        continue
                    if m <= admm_fused.MAX_WIDE_ROWS:
                        assert admm_fused.k4_fits(n, m, R), (n, m, R, rs)
                        if m > admm_fused.MAX_DENSE_ROWS:
                            wide.add(rs)
                    else:
                        assert not admm_fused.k4_fits(n, m, R)
                        refused.add(rs)
    assert refused == {0} and wide == {0}


def test_dense_shapes_and_routing(designs):
    """The four shapes of the dense cells fit; where the operators sit; the
    routing and its refusals; the unported precisions."""
    for n, m, R, rs in ((40, 44, 5, 1), (40, 120, 2, 0), (40, 120, 5, 1), (100, 300, 5, 1)):
        assert admm_fused.k4_fits(n, m, R) and admm_fused.k5_fits(n, m, R)
    # K4's operators in shared memory in fp64 at its two cell shapes: K^-1,
    # K and kia at (40, 44, 5, 1) fill all but 760 B of a block's
    p = admm_fused.k4_plan(40, 44, 5, 1, 2048)
    assert (p.route, p.lanes, p.groups, p.smem_bytes) == ("shared", 16, 14, 231688)
    assert admm_fused.k4_plan(40, 120, 2, 0, 2048).route == "shared"
    assert admm_fused.k5_plan(40, 120, 5, 1, 2048).route == "shared"
    assert admm_fused.k5_plan(100, 300, 5, 1, 2048).route == "stream"  # 1.3 MB of fp64
    # past n = 128 or 512 rows the wide route, past 1024 or 4096 no route
    assert admm_fused.k5_fits(129, 300, 5) and admm_fused.k5_plan(129, 300, 5, 1, 2048).route == "wide"
    assert admm_fused.k5_fits(100, admm_fused.MAX_DENSE_ROWS + 1, 5)
    assert not admm_fused.k5_fits(admm_fused.MAX_WIDE_N + 1, 300, 5)
    assert not admm_fused.k5_fits(100, admm_fused.MAX_WIDE_ROWS + 1, 5)

    _, _, _, td, _ = designs["sc"]
    op, cfg = td.engine.op, td.engine.config
    assert admm_fused.chunk_fn_for(op, config=cfg) is admm_fused.iterate_chunk_dense_perr_T
    assert (admm_fused.chunk_fn_for(op, plain=True, config=cfg)
            is admm_fused.iterate_chunk_dense_perr_T_plain)
    t1 = designs["sc-t1"][3].engine
    assert admm_fused.chunk_fn_for(t1.op, config=t1.config) is admm_fused.iterate_chunk_dense_packed_T
    with pytest.raises(ValueError, match="refine_steps"):
        admm_fused.chunk_fn_for(op)
    # a dense operator too wide for either kernel: no fallback
    wide = op.replace(A_s=torch.zeros((admm_fused.MAX_WIDE_ROWS + 8, 40)))
    with pytest.raises(ValueError, match="no kernel takes"):
        admm_fused.chunk_fn_for(wide, config=cfg)
    with pytest.raises(ValueError, match="kia"):
        admm_fused.packed_operators(op.replace(kia=None))
    m, n = op.A_s.shape
    for mode in ("bf16x3", "default", "hybrid", "tf32"):  # K5 takes every precision
        solve = lambda: admm_fused.solve_batch_fused(
            op, torch.zeros((2, n)), torch.zeros((2, m)), torch.zeros((2, m)),
            config=dataclasses.replace(cfg, kernel_precision=mode, max_iter=50),
        )
        if mode == "tf32":
            with pytest.raises(ValueError):
                solve()
        else:
            assert bool(torch.isfinite(solve()[0]).all())


K5_NS = (1, 7, 40, 64, 100, 128)
K5_MS = (1, 13, 44, 120, 300, 512)
K5_BS = (1, 33, 77, 512, 1000, 2048, 16384)


@pytest.mark.parametrize("refine_steps", [0, 1, 2])
@pytest.mark.parametrize("R", list(range(1, 9)))
def test_k5_plan_covers_every_shape_k5_takes(R, refine_steps):
    """Every shape k5_fits takes (n <= 1024, 1 <= m <= 4096, which includes
    every shape K4 takes) gets a route at every
    batch size from 1 to 16384, within one block's shared memory: the
    shared route where a layout of it fits, else the stream route up to
    n = 128 and 512 rows, else the wide route. A plan covers the lanes and
    the rows with an instantiation, whole warps, no more threads than it allows, and its bytes are
    the layout's (k5_smem_bytes, k5_stream_smem_bytes, wide_smem_bytes:
    the C entries' formulas; the wide route: register tiles of its own
    and a layout for every product)."""
    _assert_plans_cover(False, R, refine_steps)


@pytest.mark.parametrize("refine_steps", [0, 1, 2])
@pytest.mark.parametrize("R", list(range(1, 9)))
def test_k4_plan_covers_every_shape_k4_takes(R, refine_steps):
    """The same for K4 (k4_fits: every packed shape with n <= 1024 and at
    most 4096 rows, and the other shapes of that range): a route at every
    batch size, a layout of its own instantiations (K4_INSTANCES,
    K4_STREAM_INSTANCES) or of the wide route within one block's shared
    memory, its bytes the C entries' (k5_smem_bytes with packed,
    k5_stream_smem_bytes, wide_smem_bytes with packed)."""
    _assert_plans_cover(True, R, refine_steps)


def _assert_plans_cover(packed, R, refine_steps):
    fits_fn, plan_fn = ((admm_fused.k4_fits, admm_fused.k4_plan) if packed
                        else (admm_fused.k5_fits, admm_fused.k5_plan))
    shared_table, stream_table = (
        (admm_fused.K4_INSTANCES, admm_fused.K4_STREAM_INSTANCES) if packed
        else (admm_fused.K5_INSTANCES, admm_fused.K5_STREAM_INSTANCES))
    for n in K5_NS + (0, 129, admm_fused.MAX_WIDE_N + 1):
        for m in K5_MS + (0, 513, admm_fused.MAX_WIDE_ROWS + 1):
            fits = 1 <= n <= admm_fused.MAX_WIDE_N and 1 <= m <= admm_fused.MAX_WIDE_ROWS
            assert fits_fn(n, m, R) == fits
            assert fits or not admm_fused.k4_fits(n, m, R)
            if not fits:
                with pytest.raises(ValueError):
                    plan_fn(n, m, R, refine_steps, 64)
                continue
            if n > 128 or m > 512:  # the wide route
                assert admm_fused._wide_layouts(n, m, refine_steps, packed)
                for B in K5_BS:
                    p = plan_fn(n, m, R, refine_steps, B)
                    assert p.route == "wide", (n, m, B)
                    assert p.blocks == p.cluster * (-(-B // p.lanes) + R)
                    assert p.lanes in admm_fused.WIDE_LANES
                    assert (p.rt_pass, p.lt_pass) in admm_fused.WIDE_TILES
                    assert (p.rt, p.lt) in admm_fused.WIDE_TILES
                    assert p.smem_bytes == admm_fused.wide_smem_bytes(
                        n, p.lanes, p.panel, p.depth) <= admm_fused.SMEM_LIMIT
                    assert p.per_sm == admm_fused.blocks_per_sm(
                        admm_fused.WIDE_THREADS, p.smem_bytes, admm_fused.WIDE_REGISTERS) >= 1
                    assert admm_fused.wide_layout(n, m, refine_steps, p.lanes, p.tiles, p.panel,
                                                  packed, p.cluster) is not None
                continue
            shared = bool(admm_fused._shared_layouts(n, m, R, refine_steps, packed))
            assert shared or admm_fused._stream_layouts(n, m, refine_steps, packed)
            for B in K5_BS:
                p = plan_fn(n, m, R, refine_steps, B)
                assert p.smem_bytes <= admm_fused.SMEM_LIMIT and p.per_sm >= 1
                assert p.route == ("shared" if shared else "stream"), (n, m, B)
                spare = R if p.route == "stream" else 0
                assert p.blocks - spare == -(-B // p.lanes)
                table = shared_table if p.route == "shared" else stream_table
                threads, *registers = table[(p.rpt_n, p.rpt_m)]
                assert p.groups * p.rpt_n >= n and p.groups * p.rpt_m >= m
                assert (p.lanes * p.groups) % 32 == 0 and p.lanes * p.groups <= threads
                assert p.lanes in admm_fused.LANES
                if p.route == "shared":
                    assert p.panel == 0
                    assert p.smem_bytes == admm_fused.k5_smem_bytes(
                        n, m, R, refine_steps, p.lanes, p.groups, p.rpt_n, p.rpt_m, packed)
                else:
                    assert p.panel >= max(4 * (n + (n & 1)), 2 * (n + m if packed else max(n, m)))
                    assert p.smem_bytes == admm_fused.k5_stream_smem_bytes(
                        m, p.lanes, p.groups, p.rpt_n, p.rpt_m, p.panel)
                assert p.per_sm == admm_fused.blocks_per_sm(
                    p.lanes * p.groups, p.smem_bytes, registers[1 if refine_steps else 0])


@pytest.mark.parametrize("B,R,refine_steps,lanes", [
    (2048, 5, 1, 16),  # the dense-sc-h20 cell: 128 blocks of 16 lanes
    (512, 4, 2, 4),    # its tier-2 bucket: 128 blocks of 4
    (1000, 5, 1, 8),
    (77, 5, 1, 4),
])
def test_k5_plan_fills_the_sms(B, R, refine_steps, lanes):
    """At the h20 state box the fp64 operators fit shared memory and the
    lanes per block spread the batch over the card's 132 SMs (32 lanes a
    block would fill 64 of them at B = 2048); the h50 state box
    (n = 100, m = 300) takes the stream route, its blocks one rho index
    each, with room for each index's partial last block; forced layouts
    and routes that do not fit raise."""
    p = admm_fused.k5_plan(40, 120, R, refine_steps, B)
    assert p.route == "shared" and p.lanes == lanes
    assert p.blocks <= admm_fused.SM_COUNT
    h50 = admm_fused.k5_plan(100, 300, 5, 1, B)
    assert h50.route == "stream" and h50.blocks == -(-B // h50.lanes) + 5
    assert admm_fused.k5_plan(40, 120, R, refine_steps, B, route="stream").route == "stream"
    with pytest.raises(ValueError):
        admm_fused.k5_plan(100, 300, 5, 1, B, route="shared")
    with pytest.raises(ValueError):
        admm_fused.k5_plan(40, 120, R, refine_steps, B, lanes=32, groups=4)  # 10 rows a thread
    with pytest.raises(ValueError):
        admm_fused.k5_plan(40, 120, R, refine_steps, 0)


@pytest.mark.parametrize("n,m,R,refine_steps,B,lanes", [
    (40, 44, 5, 1, 2048, 16),  # the dense-eq-h20 cell: 128 blocks of 16 lanes
    (40, 44, 4, 2, 512, 4),    # its tier-2 bucket: 128 blocks of 4
    (40, 44, 5, 1, 77, 4),
    (40, 120, 2, 0, 2048, 16),  # the state box at tier 1's grid
])
def test_k4_plan_fills_the_sms(n, m, R, refine_steps, B, lanes):
    """K4's fp64 operators fit shared memory at the dense cells' shapes and
    the lanes per block spread the batch over the card's 132 SMs (the old
    kernel's 32 lanes a block filled 64 of them at B = 2048); the
    neighborhood terminal with its rows first (m = 52) takes the stream
    route, one rho index a block; forced layouts that do not fit raise."""
    p = admm_fused.k4_plan(n, m, R, refine_steps, B)
    assert p.route == "shared" and p.lanes == lanes
    assert p.blocks <= admm_fused.SM_COUNT
    nb = admm_fused.k4_plan(40, 52, 5, 1, B)
    assert nb.route == "stream" and nb.blocks == -(-B // nb.lanes) + 5
    assert not admm_fused._shared_layouts(40, 52, 5, 1, True)
    # one rho's operators (75 KB in fp64) stay whole in the two panels
    assert admm_fused.k4_resident(40, 52, 1, nb.panel)
    assert not admm_fused.k4_resident(40, 52, 1, nb.panel // 2)
    assert not admm_fused.k4_resident(100, 301, 1, admm_fused.k4_plan(100, 301, 5, 1, B).panel)
    assert admm_fused.k4_plan(n, m, R, refine_steps, B, route="stream").route == "stream"
    with pytest.raises(ValueError):
        admm_fused.k4_plan(n, m, R, refine_steps, B, lanes=32, groups=4)  # 10 rows a thread
    with pytest.raises(ValueError):
        admm_fused.k4_plan(n, m, R, refine_steps, 0)


def _grouped_blocks(order, starts, lanes):
    """The lanes each block of a K5 launch on the stream route takes, as
    the kernel's prologue finds them (csrc/admm_perr.cu): block k walks the
    rho indices' ceil(count / lanes) blocks in order; a block past them is
    spare."""
    R, B = starts.numel() - 1, order.numel()
    out = []
    for k in range(-(-B // lanes) + R):
        first, lanes_k = 0, None
        for r in range(R):
            seg, cnt = int(starts[r]), int(starts[r + 1] - starts[r])
            nb = -(-cnt // lanes)
            if k < first + nb:
                off = (k - first) * lanes
                lanes_k = (r, [int(order[seg + o]) for o in range(off, min(off + lanes, cnt))])
                break
            first += nb
        out.append(lanes_k)
    return out


@pytest.mark.parametrize("lanes", [4, 16, 32])
@pytest.mark.parametrize("R", [1, 4, 5])
@pytest.mark.parametrize("B,single", [(1, False), (3, False), (77, False), (2048, False),
                                      (2048, True), (13, True)])
def test_rho_order_covers_every_lane_once(B, single, R, lanes):
    """rho_order, run on the device before a launch on K5's stream route:
    its blocks take every lane exactly once, each block lanes of one rho
    index only, in lane order, for random and single indices and for
    B < L."""
    rng = np.random.default_rng(B + R)
    idx = rng.integers(0, R, size=B).astype(np.int32)
    if single:
        idx[:] = R // 2
    order, starts = admm_fused.rho_order(torch.from_numpy(idx), R)
    assert order.dtype == starts.dtype == torch.int32
    assert starts.shape == (R + 1,) and int(starts[0]) == 0 and int(starts[-1]) == B
    seen = []
    for block in _grouped_blocks(order, starts, lanes):
        if block is None:
            continue
        r, lane_ids = block
        assert 1 <= len(lane_ids) <= lanes
        assert all(idx[i] == r for i in lane_ids) and lane_ids == sorted(lane_ids)
        seen += lane_ids
    assert sorted(seen) == list(range(B))
