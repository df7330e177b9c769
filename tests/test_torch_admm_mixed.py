"""K2's plain PyTorch version and the fused driver on mixed-A QPs (state-box
and terminal rows) vs the JAX kernel.

The JAX side runs ops/admm_pallas in interpret mode on the CPU, as the JAX
package's own tests do. Inputs are made with numpy from a seed and handed
to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu import parallel as jpar
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops import admm_pallas
from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig as JConfig

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig as TConfig
from automationlabsmodelpredictivecontrol_jl_torch.ops.condense import (
    runtime_qp_vectors_batch,
)

torch.set_num_threads(1)

ROWS = {
    "equality": dict(mpc_terminal_ingredient="equality"),
    "neighborhood": dict(mpc_terminal_ingredient="neighborhood"),
    "state": dict(mpc_state_constraint=True),
}
# the suite's config (R=5, one refinement step) and tier 2's (R=4, two)
CONFIGS = {
    "R5": dict(max_iter=1000),
    "R4": dict(max_iter=250, rho=1.0, rho_grid=(0.1, 1.0, 10.0, 100.0), refine_steps=2),
}
# K1's bar (tests/test_torch_admm_fused.py), normwise relative to each
# array's largest entry
RTOL, ATOL = 1e-4, 1e-5
EPS_ABOVE_FLOOR = dict(eps_abs=1e-4, eps_rel=1e-4, check_interval=5, adapt_interval=5)
TOL = 5e-4  # the JAX package's fused-vs-engine bar
# initial-state spread of the solve tests: the QTP linearization is weakly
# reachable, so an exact terminal equality is feasible only near the
# reference (the suite's 0.002, benchmarks_suite.py config 2)
SPREAD = {"equality": 0.002, "neighborhood": 0.05, "state": 0.05}


def _pair(horizon, rows, cfg):
    jc = jmpc.proceed_controller(
        jqtp.linearized_discrete_system(), "model_predictive_control", horizon,
        5.0, np.full(4, 0.65), np.full(2, 1.2), admm_config=JConfig(**cfg), **ROWS[rows],
    )
    tc = tmpc.proceed_controller(
        tqtp.linearized_discrete_system(), "model_predictive_control", horizon,
        5.0, [0.65] * 4, [1.2] * 2, admm_config=TConfig(**cfg), device="cpu", **ROWS[rows],
    )
    return jc, tc


@pytest.fixture(scope="module")
def designs():
    return {(r, k): _pair(10, r, c) for r in ROWS for k, c in CONFIGS.items()}


def _x0s(B, seed, spread=0.15):
    rng = np.random.default_rng(seed)
    return np.clip(0.65 + spread * rng.standard_normal((B, 4)), 0.25, 1.3).astype(np.float32)


def _chunk_inputs(tc, B, seed):
    """Scaled lane-last QP vectors from real initial states, and a state
    near the driver's cold start with a small seeded perturbation."""
    op = tc.engine.op
    R = op.rho_grid.shape[0]
    x0s = torch.from_numpy(_x0s(B, seed))
    q, l, u, _, _ = runtime_qp_vectors_batch(tc.engine.qp, x0s - tc.tuning.references.x[:, 0])
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
    """The same chunk in numpy f64 on the stored operator: exact arithmetic
    up to f64 roundoff, to measure each package's fp32 roundoff against."""
    n = qT.shape[0]
    f64 = lambda t: np.asarray(t, np.float64)
    A = f64(op.A_s)
    d = np.diag(A[:n, :n])[:, None]
    A2 = A[n:]
    Ki = f64(op.K_invs)[idx]  # (B, n, n), each lane's own
    K = f64(op.Ks)[idx]
    rho, rho_inv = f64(op.rho_vecs)[idx].T, f64(op.rho_invs)[idx].T
    lane = lambda M, v: np.einsum("bij,jb->ib", M, v)
    x, s, y, ax = (f64(a) for a in (x, s, y, ax))
    a = float(cfg.alpha)
    for _ in range(chunk):
        rs = rho * s
        rhs = cfg.sigma * x - qT - (d * y[:n] + A2.T @ y[n:]) + (d * rs[:n] + A2.T @ rs[n:])
        xt = lane(Ki, rhs)
        for _ in range(cfg.refine_steps):
            xt = xt + lane(Ki, rhs - lane(K, xt))
        st = np.concatenate([d * xt, A2 @ xt])
        x_new = a * xt + (1 - a) * x
        v = a * st + (1 - a) * s
        s_new = np.clip(v + rho_inv * y, lT, uT)
        y = y + rho * (v - s_new)
        ax = a * st + (1 - a) * ax
        x, s = x_new, s_new
    return x, s, y, ax


@pytest.mark.parametrize("chunk", [1, 25])
@pytest.mark.parametrize("B", [16, 13])
@pytest.mark.parametrize("key", ["R5", "R4"])
@pytest.mark.parametrize("rows", list(ROWS))
def test_plain_chunk_matches_jax_interpret(designs, rows, key, B, chunk):
    """One iteration agrees with the JAX kernel at K1's bar. Over the
    driver's 25-iteration chunk, fp32 roundoff of the rhs grows through
    the K-solve (conditioned by rho up to 1e3 on equality rows) in both
    packages alike: there the port's distance from exact arithmetic is held
    to the JAX kernel's own, within the same bar."""
    jc, tc = designs[(rows, key)]
    args = _chunk_inputs(tc, B, seed=B + len(rows))
    n, m = args[0].shape[0], args[1].shape[0]
    assert tc.engine.op.mixed_a and m > n == 20
    calls = dict(admm_fused.PLAIN_CALLS)
    out_t = admm_fused.iterate_chunk_mixed_T(
        tc.engine.op, *[torch.from_numpy(a) for a in args], chunk, tc.engine.config
    )
    # CPU tensors take K2's plain version
    assert admm_fused.PLAIN_CALLS == dict(calls, K2=calls["K2"] + 1)
    out_j = admm_pallas._iterate_chunk_mixed_T(
        jc.engine.op, *[jnp.asarray(a) for a in args], chunk, jc.engine.config,
        interpret=True,
    )
    exact = _chunk_f64(tc.engine.op, tc.engine.config, *args, chunk)
    for name, a, b, e in zip(("x", "s", "y", "ax"), out_t, out_j, exact):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape == e.shape, name
        bar = RTOL * np.abs(b).max() + ATOL
        if chunk == 1:
            assert np.abs(a - b).max() <= bar, (name, np.abs(a - b).max())
        else:
            err_t, err_j = np.abs(a - e).max(), np.abs(b - e).max()
            assert err_t <= err_j + bar, (name, err_t, err_j)


def _solve_pair(jc, tc, x0s):
    e0s = torch.from_numpy(x0s) - tc.tuning.references.x[:, 0]
    q, l, u, _, _ = runtime_qp_vectors_batch(tc.engine.qp, e0s)
    out_t = admm_fused.solve_batch_fused(tc.engine.op, q, l, u, config=tc.engine.config)
    out_j = admm_pallas.solve_batch_fused(
        jc.engine.op, *(jnp.asarray(v.numpy()) for v in (q, l, u)),
        config=jc.engine.config, interpret=True,
    )
    return out_t, out_j


@pytest.mark.parametrize("rows", list(ROWS))
def test_fused_solve_lane_by_lane_above_noise_floor(rows):
    """At eps 1e-4 every convergence decision sits two decades above the
    f32 noise floor: statuses and iteration counts agree lane by lane."""
    jc, tc = _pair(10, rows, dict(CONFIGS["R5"], max_iter=200, **EPS_ABOVE_FLOOR))
    (zt, yt, _, st, it, _, _), (zj, yj, _, sj, ij, _, _) = _solve_pair(
        jc, tc, _x0s(13, seed=5, spread=SPREAD[rows])
    )
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert (st.numpy() == 0).all()
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=TOL)


@pytest.mark.parametrize("rows", list(ROWS))
def test_fused_solve_at_main_tolerance(designs, rows):
    """At eps 1e-6 a lane's iteration count follows each package's
    roundoff: equal final statuses, u/x/objective within 5e-4, and the
    mean iteration count within one check interval."""
    jc, tc = designs[(rows, "R5")]
    x0s = _x0s(12, seed=7, spread=SPREAD[rows])
    js, _, _, jd = jpar.solve_batch_fused(jc, jnp.asarray(x0s))
    calls = dict(admm_fused.PLAIN_CALLS)
    ts, _, _, td = tpar.solve_batch_fused(tc, torch.from_numpy(x0s))
    assert admm_fused.PLAIN_CALLS["K2"] > calls["K2"] and admm_fused.PLAIN_CALLS["K1"] == calls["K1"]
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    for f in ("u", "x", "objective"):
        np.testing.assert_allclose(
            getattr(ts, f).numpy(), np.asarray(getattr(js, f)), atol=TOL, err_msg=f
        )
    assert abs(float(td.mean_iterations) - float(jd.mean_iterations)) < 25.0


def test_k2_shapes_and_precisions(designs):
    _, tc = designs[("state", "R5")]
    op = tc.engine.op
    m, n = op.A_s.shape
    q = torch.zeros((2, n))
    lu = torch.zeros((2, m))
    for mode in ("bf16x3", "default", "hybrid"):  # K2 takes every precision
        cfg = TConfig(**CONFIGS["R5"], kernel_precision=mode)
        z, *_ = admm_fused.solve_batch_fused(op, q, lu, lu, config=cfg)
        assert bool(torch.isfinite(z).all())
    with pytest.raises(ValueError):
        admm_fused.solve_batch_fused(op, q, lu, lu,
                                     config=TConfig(**CONFIGS["R5"], kernel_precision="tf32"))
    # the slice's shapes (n = 40; m = 44, 52, 120, 132 at R=5/refine 1;
    # m = 120 at tier 2's R=4/refine 2) fit one block's shared memory
    for m2 in (44, 52, 120, 132):
        assert admm_fused.k2_fits(40, m2, 5, 1)
    assert admm_fused.k2_fits(40, 120, 4, 2)
    # state + neighborhood at B=2048: 16 lanes a block, the plan's bytes
    plan = admm_fused.k2_plan(40, 132, 5, 1, 2048)
    assert plan.smem_bytes == admm_fused.k2_smem_bytes(
        40, 132, 5, 1, plan.lanes, plan.groups, plan.rpt_n, plan.rpt_t
    ) <= admm_fused.SMEM_LIMIT
    assert not admm_fused.k2_fits(40, 40, 5, 1)  # no dense tail: K1's shape
    # a tail past 128 rows and the h50 state rows (400 KB) fit no shared
    # layout: the stream route takes them, and nothing takes a longer tail
    for n, m, R, rs in ((40, 40 + 129, 1, 0), (100, 300, 5, 1)):
        assert admm_fused.k2_fits(n, m, R, rs) and not any(admm_fused._k2_layouts(n, m, R, rs))
        assert admm_fused.k2_plan(n, m, R, rs, 64).route == "stream"
    assert not admm_fused.k2_fits(40, 40 + admm_fused.MAX_STREAM_TAIL + 1, 1, 0)
    assert admm_fused.chunk_fn_for(op) is admm_fused.iterate_chunk_mixed_T
    assert admm_fused.chunk_fn_for(op, plain=True) is admm_fused.iterate_chunk_mixed_T_plain


def _k2_fit_before_plans(n, m, R, refine_steps):
    """K2's shape test before its layout was planned: 32 lanes a block,
    operators at their natural strides, fp32 (R, m) rho tables."""
    stacks = 2 if refine_steps > 0 else 1
    ms = m - n
    nbytes = (stacks * R * n * n + ms * n + 2 * (n + ms) * 32) * 8 + 2 * R * m * 4
    return n <= 128 and 1 <= ms <= 128 and nbytes <= admm_fused.SMEM_LIMIT


@pytest.mark.parametrize("refine_steps", [0, 1, 2])
@pytest.mark.parametrize("R", [2, 4, 5])
@pytest.mark.parametrize("m", [41, 44, 52, 120, 132, 168])
def test_k2_plan_covers_batch_and_rows(m, R, refine_steps):
    """Every shape K2 took before still gets a plan, at every batch size;
    each plan covers the lanes and the rows with instantiated row counts,
    whole warps and a block within shared memory."""
    n = 40
    fits = admm_fused.k2_fits(n, m, R, refine_steps)
    assert fits or not _k2_fit_before_plans(n, m, R, refine_steps)
    for B in (1, 33, 77, 512, 1000, 2048, 16384):
        if not fits:
            with pytest.raises(ValueError):
                admm_fused.k2_plan(n, m, R, refine_steps, B)
            continue
        p = admm_fused.k2_plan(n, m, R, refine_steps, B)
        if p.route == "stream":  # no shared layout: the stream route's plan
            assert not any(admm_fused._k2_layouts(n, m, R, refine_steps))
            assert p.blocks == -(-B // p.lanes) + R
            assert p.smem_bytes == admm_fused.k12_stream_smem_bytes(
                n, m - n, p.lanes, p.panel) <= admm_fused.SMEM_LIMIT
            continue
        assert p.smem_bytes == admm_fused.k2_smem_bytes(
            n, m, R, refine_steps, p.lanes, p.groups, p.rpt_n, p.rpt_t
        )
        assert p.smem_bytes <= admm_fused.SMEM_LIMIT
        assert p.blocks * p.lanes >= B > (p.blocks - 1) * p.lanes
        assert p.groups * p.rpt_n >= n and p.groups * p.rpt_t >= m - n
        assert p.rpt_n in admm_fused.K2_RPT_N and p.rpt_t in admm_fused.K2_RPT_T
        assert p.lanes in admm_fused.LANES
        assert (p.lanes * p.groups) % 32 == 0
        assert p.lanes * p.groups <= admm_fused.k2_max_threads(p.rpt_n, p.rpt_t)


@pytest.mark.parametrize("B,lanes", [(2048, 16), (512, 4), (1000, 8), (77, 4), (1, 4)])
def test_k2_plan_fills_the_sms(B, lanes):
    """The lanes per block spread the batch over the card's 132 SMs: 128
    blocks at the state-constrained cell's B=2048 and at tier 2's B=512."""
    for m, R, rs in ((120, 5, 1), (120, 4, 2), (44, 5, 1), (132, 5, 1)):
        p = admm_fused.k2_plan(40, m, R, rs, B)
        assert p.lanes == lanes and p.blocks <= admm_fused.SM_COUNT
    with pytest.raises(ValueError):
        admm_fused.k2_plan(40, 120, 5, 1, 2048, lanes=32, groups=7)  # 6 box rows a thread
    with pytest.raises(ValueError):
        admm_fused.k2_plan(40, 120, 5, 1, 0)


@pytest.mark.parametrize("lanes", [32, 16, 8, 4])
def test_k2_row_stride_is_conflict_free(lanes):
    """The rows a warp reads (32 / lanes consecutive ones) of up to
    8 lanes / 32 rho copies start in distinct 16-byte bank groups, for
    every width n K2 takes; rows are 16-byte aligned."""
    g = 32 // lanes
    for n in range(1, admm_fused.MAX_N + 1):
        ld, sk = admm_fused.row_strides(n, lanes)
        assert ld >= n and ld % 2 == 0 and ld - n < 16
        copies = max(1, 8 // g)
        starts = {(r * sk // 2 + row * ld // 2) % 8 for r in range(copies) for row in range(g)}
        assert len(starts) == min(8, g * copies), (n, lanes)
