"""K1's plain PyTorch version and the fused driver vs the JAX kernel.

The JAX side runs ops/admm_pallas in interpret mode on the CPU, as the JAX
package's own tests do. Inputs are made with numpy from a seed and handed
to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops import admm_pallas
from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig as JConfig

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig as TConfig
from automationlabsmodelpredictivecontrol_jl_torch.ops.condense import (
    runtime_qp_vectors_batch,
)

torch.set_num_threads(1)

# the two main-path configs: tier 1 (R=2, no refinement) and tier 2 (R=4,
# two refinement steps)
CONFIGS = {
    "R2": dict(max_iter=75, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0),
    "R4": dict(max_iter=250, rho=1.0, rho_grid=(0.1, 1.0, 10.0, 100.0), refine_steps=2),
}
HORIZONS = {20: 10, 40: 20}  # n -> horizon (n = 2 * horizon)

# 25 iterations of fp32 arithmetic whose sums run in another order in the
# two packages (XLA's CPU dot splits each sum into interleaved partial
# sums, torch's runs it in order): agreement to the last bits is not
# expected. The bar is normwise, relative to each array's largest entry:
# the dual update y += rho (v - s) multiplies the roundoff of v - s by rho,
# up to 100 on the tier-2 grid, so a small entry of y can carry the
# absolute error of the largest
RTOL, ATOL = 1e-4, 1e-5

# Convergence is decided against eps 1e-6 on residuals that sit at the f32
# noise floor of the iterates, so at the main-path tolerance a lane's
# status and iteration count follow the roundoff of either package. With
# eps 1e-4 the decisions sit two decades above that floor and are
# reproducible lane by lane.
EPS_ABOVE_FLOOR = dict(eps_abs=1e-4, eps_rel=1e-4)


def _pair(horizon, cfg):
    """The JAX controller and the port's, designed alike."""
    jc = jmpc.proceed_controller(
        jqtp.linearized_discrete_system(), "model_predictive_control", horizon,
        5.0, np.full(4, 0.65), np.full(2, 1.2), admm_config=JConfig(**cfg),
    )
    tc = tmpc.proceed_controller(
        tqtp.linearized_discrete_system(), "model_predictive_control", horizon,
        5.0, [0.65] * 4, [1.2] * 2, admm_config=TConfig(**cfg), device="cpu",
    )
    return jc, tc


@pytest.fixture(scope="module")
def designs():
    return {
        (n, key): _pair(h, cfg)
        for n, h in HORIZONS.items()
        for key, cfg in CONFIGS.items()
    }


def _x0s(B, seed):
    rng = np.random.default_rng(seed)
    return np.clip(0.65 + 0.15 * rng.standard_normal((B, 4)), 0.25, 1.3).astype(np.float32)


def _chunk_inputs(tc, B, seed):
    """Scaled lane-last QP vectors from real initial states, and a state
    near the driver's cold start (x = y = ax = 0, s = clip(0, l, u)) with a
    small seeded perturbation, as numpy."""
    op = tc.engine.op
    R = op.rho_grid.shape[0]
    x0s = torch.from_numpy(_x0s(B, seed))
    q, l, u, _, _ = runtime_qp_vectors_batch(tc.engine.qp, x0s - tc.tuning.references.x[:, 0])
    qT = ((op.c * op.D)[:, None] * q.T).numpy()
    lT = (op.E[:, None] * l.T).numpy()
    uT = (op.E[:, None] * u.T).numpy()
    n = qT.shape[0]
    rng = np.random.default_rng(seed + 1)
    x, y, ax = ((0.05 * rng.standard_normal((n, B))).astype(np.float32) for _ in range(3))
    s = np.clip(ax, lT, uT)
    idx = rng.integers(0, R, size=B).astype(np.int32)
    return [qT, lT, uT, idx, x, s, y, ax]


@pytest.mark.parametrize("B", [16, 13])
@pytest.mark.parametrize("key", ["R2", "R4"])
@pytest.mark.parametrize("n", [20, 40])
def test_plain_chunk_matches_jax_interpret(designs, n, key, B):
    jc, tc = designs[(n, key)]
    args = _chunk_inputs(tc, B, seed=n + B)
    calls = admm_fused.PLAIN_CALLS["K1"]
    out_t = admm_fused.iterate_chunk_diag_T(
        tc.engine.op, *[torch.from_numpy(a) for a in args], 25, tc.engine.config
    )
    assert admm_fused.PLAIN_CALLS["K1"] == calls + 1  # CPU tensors take the plain version
    out_j = admm_pallas._iterate_chunk_diag_T(
        jc.engine.op, *[jnp.asarray(a) for a in args], 25, jc.engine.config,
        interpret=True,
    )
    for name, a, b in zip(("x", "s", "y", "ax"), out_t, out_j):
        a, b = a.numpy(), np.asarray(b)
        err = np.abs(a - b).max()
        assert err <= RTOL * np.abs(b).max() + ATOL, (name, err)


@pytest.mark.parametrize("key", ["R2", "R4"])
def test_fused_solve_matches_jax_interpret(key):
    cfg = dict(CONFIGS[key], check_interval=5, adapt_interval=5, **EPS_ABOVE_FLOOR)
    jc, tc = _pair(20, cfg)
    B = 13
    x0s = _x0s(B, seed=5)
    e0s = torch.from_numpy(x0s) - tc.tuning.references.x[:, 0]
    q, l, u, _, _ = runtime_qp_vectors_batch(tc.engine.qp, e0s)
    zt, yt, _, st, it, _, _ = admm_fused.solve_batch_fused(
        tc.engine.op, q, l, u, config=tc.engine.config
    )
    zj, yj, _, sj, ij, _, _ = admm_pallas.solve_batch_fused(
        jc.engine.op, jnp.asarray(q.numpy()), jnp.asarray(l.numpy()),
        jnp.asarray(u.numpy()), config=jc.engine.config, interpret=True,
    )
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # the bar of the JAX package's own fused-vs-engine parity tests
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=5e-4)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=5e-4)


def test_wrapper_rejects_other_precisions_and_shapes(designs):
    _, tc = designs[(40, "R2")]
    op = tc.engine.op
    q = torch.zeros((2, 40))
    # every precision solves (tests/test_torch_admm_precision.py holds them
    # to JAX); "hybrid" is the driver's schedule, refused by a chunk
    hybrid = TConfig(**CONFIGS["R2"], kernel_precision="hybrid")
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="hybrid"):
        admm_fused.iterate_chunk_diag_T(op, q.T, q.T, q.T, idx, q.T, q.T, q.T, q.T, 1, hybrid)
    with pytest.raises(ValueError):
        admm_fused.solve_batch_fused(
            op, q, q, q, config=TConfig(**CONFIGS["R2"], kernel_precision="tf32")
        )
    assert admm_fused.k1_fits(40, 4, 2) and admm_fused.k1_fits(40, 2, 0)
    # an 800 KB stack (n = 200, R = 5) and n = 130 fit no shared layout: the
    # stream route takes them, and nothing takes n past its widest
    for n, R, rs in ((200, 5, 1), (130, 1, 0)):
        assert admm_fused.k1_fits(n, R, rs) and not any(admm_fused._k1_layouts(n, R, rs))
        assert admm_fused.k1_plan(n, R, rs, 64).route == "stream"
    assert not admm_fused.k1_fits(admm_fused.MAX_STREAM_N + 1, 1, 0)


def _k1_fit_before_plans(n, R, refine_steps):
    """K1's shape test before its layout was planned: 32 lanes a block,
    operators at their natural strides."""
    stacks = 2 if refine_steps > 0 else 1
    return n <= 128 and (stacks * R * n * n + 2 * n * 32) * 8 <= admm_fused.SMEM_LIMIT


@pytest.mark.parametrize("R,refine_steps", [(2, 0), (4, 2), (5, 1)])
@pytest.mark.parametrize("n", [20, 40, 41, 100, 128])
def test_k1_plan_covers_batch_and_rows(n, R, refine_steps):
    """Every shape K1 took before still gets a plan, at every batch size
    from 1 to 16384; each plan covers the lanes and the rows (the fewest
    rows per thread for its row-groups) with an instantiated row count,
    whole warps, no more threads than the instantiation allows and a block
    within shared memory, and counts the blocks an SM holds at once."""
    fits = admm_fused.k1_fits(n, R, refine_steps)
    assert fits or not _k1_fit_before_plans(n, R, refine_steps)
    for B in (1, 33, 77, 512, 1000, 2048, 4096, 16384):
        if not fits:
            with pytest.raises(ValueError):
                admm_fused.k1_plan(n, R, refine_steps, B)
            continue
        p = admm_fused.k1_plan(n, R, refine_steps, B)
        if p.route == "stream":  # no shared layout: the stream route's plan
            assert not any(admm_fused._k1_layouts(n, R, refine_steps))
            assert p.blocks == -(-B // p.lanes) + R
            assert p.rpt in admm_fused.k12_rows_options(p.lanes, False)
            assert p.smem_bytes == admm_fused.k12_stream_smem_bytes(
                n, 0, p.lanes, p.panel) <= admm_fused.SMEM_LIMIT
            threads = p.lanes // admm_fused.k12_lanes_per_thread(p.lanes) * p.groups
            assert threads % 32 == 0 and threads <= admm_fused.K12_STREAM_THREADS
            continue
        assert p.blocks * p.lanes >= B > (p.blocks - 1) * p.lanes
        assert p.groups * p.rpt >= n > p.groups * (p.rpt - 1)
        assert p.rpt in admm_fused.K1_INSTANCES and p.lanes in admm_fused.LANES
        threads = admm_fused.K1_INSTANCES[p.rpt][0]
        registers = admm_fused.K1_INSTANCES[p.rpt][2 if refine_steps else 1]
        assert (p.lanes * p.groups) % 32 == 0 and p.lanes * p.groups <= threads
        assert p.smem_bytes == admm_fused.k1_smem_bytes(
            n, R, refine_steps, p.lanes, p.groups, p.rpt) <= admm_fused.SMEM_LIMIT
        assert p.per_sm == admm_fused.blocks_per_sm(p.lanes * p.groups, p.smem_bytes, registers)
        assert p.per_sm >= 1


@pytest.mark.parametrize("R,refine_steps,B,lanes", [
    (4, 2, 512, 4),     # tier 2's bucket: 128 blocks of 4 lanes
    (2, 0, 4096, 32),   # the closed loop at tier 1: 128 blocks of 32
    (2, 0, 16384, 32),  # the headline's tier 1: 512 blocks, 2 an SM at once
])
def test_k1_plan_fills_the_sms(R, refine_steps, B, lanes):
    """The lanes per block spread the batch over the card's 132 SMs (the
    parent kernel's 32 lanes a block filled 16 of them at B=512), and at
    tier 1 several blocks share an SM: its 25 KB of operators let the plan
    count more than one block resident, which a one-block-per-SM model
    (K2's) would not."""
    p = admm_fused.k1_plan(40, R, refine_steps, B)
    assert p.lanes == lanes
    assert 0.96 * admm_fused.SM_COUNT <= min(p.blocks, admm_fused.SM_COUNT * p.per_sm)
    if B == 16384:
        assert p.per_sm >= 2 and p.blocks > admm_fused.SM_COUNT
    with pytest.raises(ValueError):
        admm_fused.k1_plan(40, R, refine_steps, B, lanes=32, groups=4)  # 10 rows a thread
    with pytest.raises(ValueError):
        admm_fused.k1_plan(40, R, refine_steps, 0)


@pytest.mark.parametrize("lanes", [32, 16, 8, 4])
def test_k1_row_stride_is_conflict_free(lanes):
    """At K1's strides (row_strides, shared with K2), the operator entries
    a warp reads at once, 32 / lanes consecutive rows of up to 5 rho
    copies, spread over the 8 16-byte bank groups as evenly as their count
    allows, for every width n K1 takes: lanes at mixed rho indices cost no
    more wavefronts than distinct addresses need."""
    from collections import Counter

    rows = 32 // lanes
    for n in range(1, admm_fused.MAX_N + 1):
        ld, sk = admm_fused.row_strides(n, lanes)
        assert sk % 4 == 2  # copies at an odd stride in 16-byte units
        for R in range(1, 6):
            copies = min(R, lanes)
            groups = Counter((r * sk // 2 + row * ld // 2) % 8
                             for r in range(copies) for row in range(rows))
            assert max(groups.values()) == -(-rows * copies // 8), (n, lanes, R)
