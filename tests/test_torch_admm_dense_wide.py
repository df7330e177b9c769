"""K4's and K5's wide route (csrc/admm_perr_wide.cu) on the CPU: the dense
shapes the kernels take against the JAX package's, their plans, and the
port's chunk and fused solve at two shapes past the older routes against
the JAX package's; and the record of K1's stuck lanes on the (16, 8) plant.

The kernel itself runs only on the card (tests/test_torch_cuda.py holds it
to the plain versions bit for bit); here the wrappers run the plain
versions. The JAX side runs ops/admm_pallas in interpret mode, as the JAX
package's own tests do; inputs are made with numpy from a seed. A dense
operator is a designed QP with its state or terminal rows moved above the
input-box rows (tests/test_torch_admm_dense.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import big as jbig
from automationlabsmodelpredictivecontrol_jl_tpu.ops import admm as jadmm
from automationlabsmodelpredictivecontrol_jl_tpu.ops import admm_pallas
from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig as JConfig

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import parallel
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big as tbig
from automationlabsmodelpredictivecontrol_jl_torch.design import LinearEngine
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm as tadmm
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig as TConfig
from automationlabsmodelpredictivecontrol_jl_torch.ops.condense import runtime_qp_vectors_batch
from automationlabsmodelpredictivecontrol_jl_torch.types import STATUS_MAX_ITER

from test_torch_admm_dense import (
    ATOL, EPS_ABOVE_FLOOR, RTOL, _chunk_f64, _eq_mask, dense_pair,
)

torch.set_num_threads(1)

# (rho grid size R, refine_steps): R = 1, tier 1, tier 2 of the escalated
# solve, the default AdmmConfig, and a wide grid with three refinements
CONFIGS = [(1, 0), (2, 0), (4, 2), (5, 1), (8, 3)]


@pytest.mark.parametrize("R,refine_steps", CONFIGS)
def test_dense_kernels_take_every_shape_the_pallas_bodies_take(R, refine_steps):
    """Wherever the JAX package's fused_fits admits a dense operator (n up
    to 600, m from n + 1 to 4000) and _use_packed picks K4 (K5), k4_fits
    (k5_fits) holds: at every n with m = n + 1, at n = 1 with every row
    count from 3000 up, and on a grid between."""
    shapes = [(n, n + 1) for n in range(1, 601)]
    shapes += [(1, m) for m in range(3000, 4001)]
    shapes += [(n, m) for n in range(2, 601, 9) for m in range(n + 2, 4001, 47)]
    widest, most, fused = 0, 0, {True: 0, False: 0}
    for n, m in shapes:
        if not admm_pallas.fused_fits(n, m, R, refine_steps):
            continue
        packed = admm_pallas._use_packed(n, m, R, refine_steps)
        assert admm_fused.use_packed(n, m, R, refine_steps) is packed, (n, m)
        assert (admm_fused.k4_fits if packed else admm_fused.k5_fits)(n, m, R), (n, m, packed)
        widest, most = max(widest, n), max(most, m)
        fused[packed] += 1
    # the widest n (at m = n + 1) and the most rows (at n = 1) the JAX
    # package fuses
    assert (widest, most) == {1: (582, 3839), 2: (457, 3519), 4: (347, 3456), 5: (313, 3456),
                              8: (255, 3328)}[R]
    assert fused[False] > 0


# the plans of every K4 and K5 row of PERF.md's kernel table, frozen from
# the parent tree (before the wide route): (shape, precision) -> plan
K4_FROZEN = {
    (40, 44, 5, 1, 2048, "highest"): ("shared", 16, 14, 3, 4, 128, 231688, 1, 0),
    (40, 44, 4, 2, 512, "highest"): ("shared", 4, 40, 1, 2, 128, 182304, 1, 0),
    (40, 44, 5, 1, 77, "highest"): ("shared", 4, 40, 1, 2, 20, 224200, 1, 0),
    (40, 120, 2, 0, 2048, "highest"): ("shared", 16, 20, 2, 6, 128, 163600, 1, 0),
    (40, 52, 5, 1, 2048, "highest"): ("stream", 16, 14, 3, 4, 133, 103136, 2, 4852),
    (40, 44, 5, 1, 2048, "bf16x3"): ("shared", 16, 14, 3, 4, 128, 231688, 1, 0),
    (40, 44, 5, 1, 2048, "default"): ("shared", 16, 14, 3, 4, 128, 231688, 1, 0),
    (40, 52, 5, 1, 2048, "bf16x3"): ("stream", 16, 14, 3, 4, 133, 103136, 1, 4852),
    (40, 52, 5, 1, 2048, "default"): ("stream", 16, 14, 3, 4, 133, 103136, 2, 4852),
}
K5_FROZEN = {
    (40, 120, 5, 1, 2048, "highest"): ("shared", 16, 14, 3, 9, 128, 231208, 1, 0),
    (40, 120, 4, 2, 512, "highest"): ("shared", 4, 40, 1, 3, 128, 179360, 1, 0),
    (40, 120, 5, 1, 1, "highest"): ("shared", 4, 40, 1, 3, 1, 206760, 1, 0),
    (40, 120, 5, 1, 33, "highest"): ("shared", 4, 40, 1, 3, 9, 206760, 1, 0),
    (40, 120, 5, 1, 77, "highest"): ("shared", 4, 40, 1, 3, 20, 206760, 1, 0),
    (40, 120, 5, 1, 1000, "highest"): ("shared", 8, 40, 1, 3, 125, 225320, 1, 0),
    (100, 300, 5, 1, 2048, "highest"): ("stream", 16, 30, 4, 10, 133, 232448, 1, 7658),
    (40, 120, 5, 1, 2048, "bf16x3"): ("shared", 16, 14, 3, 9, 128, 231208, 1, 0),
    (40, 120, 5, 1, 2048, "default"): ("shared", 16, 14, 3, 9, 128, 231208, 1, 0),
    (100, 300, 5, 1, 2048, "bf16x3"): ("stream", 16, 30, 4, 10, 133, 232448, 1, 7658),
    (100, 300, 5, 1, 2048, "default"): ("stream", 16, 30, 4, 10, 133, 232448, 1, 7658),
}


def test_older_plans_are_unchanged():
    """At every shape of PERF.md's K4 and K5 rows the plan is the parent's,
    on the shared or the stream route: the wide route changes nothing where
    the kernels worked before."""
    for (n, m, R, rs, B, mode), want in K4_FROZEN.items():
        assert tuple(admm_fused.k4_plan(n, m, R, rs, B, mode=mode)) == want
    for (n, m, R, rs, B, mode), want in K5_FROZEN.items():
        assert tuple(admm_fused.k5_plan(n, m, R, rs, B, mode=mode)) == want


WIDE_SHAPES = [(n, m) for n in (129, 200, 308, 456, 582, 1024) for m in (n + 1, 3 * n)]
WIDE_SHAPES += [(n, m) for n in (1, 20, 64, 128) for m in (513, 660, 1000, 3839, 4096)]
WIDE_SHAPES += [(1024, 4096), (1024, 1), (129, 1)]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("R,refine_steps", CONFIGS)
def test_wide_plans_cover_the_batch_within_shared_memory(R, refine_steps, packed):
    """Past n = 128 or 512 rows the wide route is planned (neither other
    route has a layout there); its blocks cover B with room for each rho
    index's partial last cluster, the grid a whole number of clusters of 1
    or 2 blocks, 1 to 64 lanes, each product's register tile one of the
    kernel's and its threads within the block's, its shared memory the C
    entry's formula within the card's, a panel of at least 4 columns of
    every product's tile, tiles that cover each block's span of a
    product's rows (the cluster's spans cover the rows) with fewer than rt
    padded rows each. Past 1024 or 4096
    no route takes the shape."""
    plan_fn = admm_fused.k4_plan if packed else admm_fused.k5_plan
    fits = admm_fused.k4_fits if packed else admm_fused.k5_fits
    for n, m in WIDE_SHAPES:
        if m > admm_fused.MAX_WIDE_ROWS:
            continue
        assert fits(n, m, R), (n, m)
        assert not admm_fused._stream_layouts(n, m, refine_steps, packed)
        assert not admm_fused._shared_layouts(n, m, R, refine_steps, packed)
        for B in (1, 33, 512, 1024, 2048, 16384):
            p = plan_fn(n, m, R, refine_steps, B)
            assert p.route == "wide", (n, m, B)
            assert p.cluster in admm_fused.WIDE_CLUSTERS and p.cluster <= min(n, m)
            clusters = p.blocks // p.cluster
            assert p.blocks % p.cluster == 0 and clusters == -(-B // p.lanes) + R
            assert (clusters - R) * p.lanes >= B
            assert p.lanes in admm_fused.WIDE_LANES and p.depth in admm_fused.WIDE_DEPTHS
            assert (p.rt_pass, p.lt_pass) in admm_fused.WIDE_TILES
            assert (p.rt, p.lt) in admm_fused.WIDE_TILES
            assert p.smem_bytes == admm_fused.wide_smem_bytes(
                n, p.lanes, p.panel, p.depth) <= admm_fused.SMEM_LIMIT
            assert p.panel % 8 == 0 and p.per_sm == admm_fused.blocks_per_sm(
                admm_fused.WIDE_THREADS, p.smem_bytes, admm_fused.WIDE_REGISTERS) == 1
            lay = admm_fused.wide_layout(n, m, refine_steps, p.lanes, p.tiles, p.panel,
                                         packed, p.cluster)
            assert lay is not None
            for g in lay.products:
                if g is None:
                    continue
                assert g.lg * g.lt == p.lanes and g.lg * g.G <= admm_fused.WIDE_THREADS
                assert g.span * p.cluster >= g.rows > g.span * (p.cluster - 1)
                assert g.tiles * g.H >= g.span > (g.tiles - 1) * g.H
                assert 0 <= g.padded_rows < g.rt * g.tiles
                assert g.pk >= 4 and g.pk % 4 == 0 and g.np == -(-g.cols // g.pk)
                assert g.ops * g.H * (g.pk + 2) + g.vecs * g.pk * p.lanes <= p.panel
                assert (g.ops * g.H + g.vecs * p.lanes) * g.pk <= p.panel  # a ring slot
    for n, m in ((admm_fused.MAX_WIDE_N + 1, 2000), (10, admm_fused.MAX_WIDE_ROWS + 1), (10, 0)):
        assert not fits(n, m, R)
        with pytest.raises(ValueError, match="no K"):
            plan_fn(n, m, R, refine_steps, 64)


def test_wide_route_is_forced_and_checked():
    """``route="wide"`` forces the wide route at a shape the older routes
    take (the card tests hold it to the plain version there); a forced layout of another route never falls to it, and a
    wide shape refuses the other routes. y and s no longer sit in shared
    memory, so 32 and 64 lanes a block fit at (200, 600) and (308, 924);
    the tiles, depth and cluster are the wide route's alone."""
    p = admm_fused.k5_plan(40, 120, 5, 1, 2048, route="wide")
    assert p.route == "wide" and p.blocks == 2048 // p.lanes + 5
    assert admm_fused.k4_plan(40, 44, 5, 1, 2048, route="wide").route == "wide"
    assert admm_fused.k5_plan(200, 600, 5, 1, 2048, lanes=1).lanes == 1
    with pytest.raises(ValueError):
        admm_fused.k5_plan(40, 120, 5, 1, 2048, lanes=32, groups=4)  # 10 rows a thread
    with pytest.raises(ValueError):
        admm_fused.k5_plan(200, 600, 5, 1, 2048, route="stream")
    with pytest.raises(ValueError):
        admm_fused.k4_plan(20, 660, 2, 0, 2048, route="shared")
    for n, m, R, rs, B in ((200, 600, 5, 1, 2048), (308, 924, 2, 0, 1024)):
        for lanes in (32, 64):
            assert admm_fused.k5_plan(n, m, R, rs, B, lanes=lanes).lanes == lanes
    forced = admm_fused.k4_plan(20, 660, 2, 0, 2048, tiles=((4, 4), (4, 2)), depth=4, cluster=2)
    assert (forced.tiles, forced.depth, forced.cluster) == (((4, 4), (4, 2)), 4, 2)
    assert forced.blocks == 2 * (-(-2048 // forced.lanes) + 2)
    with pytest.raises(ValueError):
        admm_fused.k5_plan(1, 3839, 1, 0, 64, cluster=2)  # one row: no span for the second
    with pytest.raises(ValueError):
        admm_fused.k5_plan(200, 600, 5, 1, 2048, groups=4)  # the tiles set the row-groups
    with pytest.raises(ValueError):
        admm_fused.k5_plan(40, 120, 5, 1, 2048, depth=3)  # the shared route has no ring
    with pytest.raises(ValueError):
        admm_fused.k5_plan(200, 600, 5, 1, 2048, tiles=((8, 4), (8, 4)))  # no such pass tile
    with pytest.raises(ValueError):
        admm_fused.k5_plan(40, 120, 5, 1, 2048, route="tiled")


def _earlier_l2_bytes(n, m, R, rs, B, lanes, packed, chunk=25):
    """The operator bytes a chunk read from L2 on the earlier wide route (a
    lane a thread, 8-byte entries) at ``lanes`` lanes a block (its plans: 8 x 52 at (200, 600, 5, 1), 16 x 12
    at (20, 660, 2, 0), B = 2048, both streamed): 8-byte entries, rows
    padded to even, every operator once an iteration (the pass's two, the
    solves', K' a refinement, K5's A), over the blocks the lanes fill."""
    ldn, ldm = n + (n & 1), m + (m & 1)
    entries = 2 * n * ldm + (1 + rs) * (n + m if packed else n) * ldn + rs * n * ldn
    entries += 0 if packed else m * ldn
    return 8 * entries * chunk * admm_fused.k12_blocks_used(R, B, lanes)


@pytest.mark.parametrize("packed,n,m,R,rs,old_lanes", [(False, 200, 600, 5, 1, 8),
                                                      (True, 20, 660, 2, 0, 16)])
def test_wide_plans_read_a_quarter_of_the_l2_bytes(packed, n, m, R, rs, old_lanes):
    """At the state box of dense-sc-h100-B2048 (K5) and of
    dense-sc32x1-h20-B2048 (K4) the plan's operators cost at most a
    quarter of the L2 bytes a chunk that the earlier wide route's plan of
    the same shape read (4-byte entries, and 32 lanes or more sharing each
    panel: K4's clusters of two blocks, which its cost ranks within
    WIDE_COST_TIE of 16 lanes a block, on half the bytes); a lane of any
    plan pays no more than half the earlier one's."""
    plan = (admm_fused.k4_plan if packed else admm_fused.k5_plan)(n, m, R, rs, 2048)
    new = admm_fused.wide_l2_bytes(n, m, R, rs, 2048, plan, 25, packed)
    old = _earlier_l2_bytes(n, m, R, rs, 2048, old_lanes, packed)
    assert new * 4 <= old, (plan, new, old)
    if packed:
        assert (plan.lanes, plan.cluster) == (32, 2), plan
    streamed = admm_fused.k5_plan(40, 120, 5, 1, 2048, route="wide", lanes=1, cluster=1)
    assert admm_fused.wide_l2_bytes(40, 120, 5, 1, 2048, streamed, 25) * 2 == _earlier_l2_bytes(
        40, 120, 5, 1, 2048, 1, False)


# the wide shapes chip_smoke.py times (wide_phase): (packed, n, m, R,
# refine_steps, B) at every precision
TIMED = [(False, 200, 600, 5, 1, 2048), (False, 200, 204, 5, 1, 2048),
         (False, 308, 924, 2, 0, 1024), (False, 456, 460, 2, 0, 1024),
         (True, 20, 660, 2, 0, 2048)]


@pytest.mark.parametrize("packed,n,m,R,rs,B", TIMED)
def test_wide_tiles_pad_at_most_a_quarter(packed, n, m, R, rs, B):
    """At the shapes the script times, padded rows take at most a quarter
    of any product's multiply-adds (K4's 20-row pass is not padded to a
    tile of 48), and every product holds more than one lane's sums a
    thread."""
    for mode in admm_fused.PRECISIONS:
        p = (admm_fused.k4_plan if packed else admm_fused.k5_plan)(n, m, R, rs, B, mode=mode)
        lay = admm_fused.wide_layout(n, m, rs, p.lanes, p.tiles, p.panel, packed, p.cluster)
        for g in lay.products:
            if g is not None:
                assert 4 * g.padded_rows <= g.tiles * g.H, (p, g)
                assert g.rt * g.lt > 1 and g.lt > 1, (p, g)
    if packed:
        assert lay.products[0].padded_rows == 0


def _plant_pair(nx, nu, horizon, cfg, **rows):
    """The JAX and port controllers for big.random_stable_system(nx, nu)
    at the origin, and each package's dense controller for the same QP with
    its state and terminal rows first (as dense_pair builds the QTP's)."""
    jc = jmpc.proceed_controller(
        jbig.random_stable_system(nx, nu, seed=0), "model_predictive_control", horizon, 5.0,
        np.zeros(nx), np.zeros(nu), admm_config=JConfig(**cfg), **rows)
    tc = tmpc.proceed_controller(
        tbig.random_stable_system(nx, nu, seed=0), "model_predictive_control", horizon, 5.0,
        [0.0] * nx, [0.0] * nu, admm_config=TConfig(**cfg), device="cpu", **rows)
    m, n = tc.engine.qp.A.shape
    perm = np.r_[np.arange(n, m), np.arange(n)]
    jqp = jc.engine.qp
    jqp_d = dataclasses.replace(jqp, **{k: jnp.asarray(np.asarray(getattr(jqp, k))[perm])
                                        for k in ("A", "l_const", "u_const", "b_x0")})
    jop = jadmm.build_operator(
        np.asarray(jqp_d.P), np.asarray(jqp_d.A),
        _eq_mask(np.asarray(jqp_d.l_const), np.asarray(jqp_d.u_const)), 0, jc.engine.config)
    jd = dataclasses.replace(jc, engine=dataclasses.replace(jc.engine, qp=jqp_d, op=jop))
    tqp = tc.engine.qp
    tqp_d = tqp.replace(**{k: getattr(tqp, k)[perm] for k in ("A", "l_const", "u_const", "b_x0")})
    top = tadmm.build_operator(
        tqp_d.P.numpy(), tqp_d.A.numpy(),
        _eq_mask(tqp_d.l_const.numpy(), tqp_d.u_const.numpy()), 0, tc.engine.config)
    td = tc.replace(engine=LinearEngine(qp=tqp_d, op=top, soft_mu=None, config=tc.engine.config))
    return jc, tc, jd, td


TIER1 = dict(rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0)
# the two shapes past the older routes: the QTP's equality terminal at h65
# on the default config (n = 130, m = 134: K5 past n = 128) and the (32, 1)
# plant's h20 state box at tier 1's grid (n = 20, m = 660: K4 past 512
# rows)
WIDE = {
    "eq-h65": ("K5", (130, 134)),
    "sc-32x1-h20": ("K4", (20, 660)),
}


def _design(key, cfg):
    if key == "eq-h65":
        jd, td = dense_pair(65, dict(mpc_terminal_ingredient="equality"), cfg)[2:4]
    else:
        jd, td = _plant_pair(32, 1, 20, dict(cfg, **TIER1), mpc_state_constraint=True)[2:]
    return jd, td


@pytest.fixture(scope="module")
def wide_designs():
    # the (32, 1) plant's lanes converge in 455-610 iterations at tier 1's
    # grid without refinement
    cfg = dict(max_iter=1000, **EPS_ABOVE_FLOOR)
    return {key: _design(key, cfg) for key in WIDE}


def _x0s(td, B, seed):
    """B initial states about the controller's reference: 0.05 N(0, 1) for
    the QTP, 0.02 N(0, 1) for the (32, 1) plant (its unit state box)."""
    rng = np.random.default_rng(seed)
    ref = td.tuning.references.x[:, 0].numpy()
    spread = 0.05 if ref.shape[0] == 4 else 0.02
    return (ref + spread * rng.standard_normal((B, ref.shape[0]))).astype(np.float32)


def _qp_vectors(td, x0s):
    e0s = torch.from_numpy(x0s) - td.tuning.references.x[:, 0]
    q, l, u, _, _ = runtime_qp_vectors_batch(td.engine.qp, e0s)
    return q, l, u


@pytest.mark.parametrize("chunk", [1, 25])
@pytest.mark.parametrize("key", list(WIDE))
def test_wide_chunk_matches_jax_interpret(wide_designs, key, chunk):
    """One chunk of the plain version that both packages' variant rule
    picks against the JAX body in interpret mode, 8 lanes at random rho
    indices: after one iteration within test_torch_admm_dense's bar; after
    25 the port's distance from exact arithmetic within the JAX kernel's
    own plus that bar."""
    jd, td = wide_designs[key]
    want, shape = WIDE[key]
    op, cfg = td.engine.op, td.engine.config
    m, n = (int(d) for d in op.A_s.shape)
    R = int(op.rho_grid.shape[0])
    assert (n, m) == shape and op.dense_a
    packed = want == "K4"
    assert admm_fused.use_packed(n, m, R, cfg.refine_steps) is packed
    assert admm_pallas._use_packed(n, m, R, cfg.refine_steps) is packed
    assert (admm_fused.k4_plan if packed else admm_fused.k5_plan)(
        n, m, R, cfg.refine_steps, 8).route == "wide"
    B = 8
    q, l, u = _qp_vectors(td, _x0s(td, B, seed=n))
    qT = ((op.c * op.D)[:, None] * q.T).numpy()
    lT = (op.E[:, None] * l.T).numpy()
    uT = (op.E[:, None] * u.T).numpy()
    rng = np.random.default_rng(n + 1)
    x = (0.05 * rng.standard_normal((n, B))).astype(np.float32)
    y, ax = ((0.05 * rng.standard_normal((m, B))).astype(np.float32) for _ in range(2))
    s = np.clip(ax, lT, uT)
    idx = rng.integers(0, R, size=B).astype(np.int32)
    args = [qT, lT, uT, idx, x, s, y, ax]
    calls = dict(admm_fused.PLAIN_CALLS)
    out_t = admm_fused.chunk_fn_for(op, config=cfg)(
        op, *[torch.from_numpy(a) for a in args], chunk, cfg)
    assert admm_fused.PLAIN_CALLS == dict(calls, **{want: calls[want] + 1})
    out_j = admm_pallas._iterate_chunk(
        jd.engine.op, *(jnp.asarray(a.T) for a in (qT, lT, uT)), jnp.asarray(idx),
        *(jnp.asarray(a.T) for a in (x, s, y, ax)), chunk, jd.engine.config, interpret=True)
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


@pytest.mark.parametrize("key", list(WIDE))
def test_wide_fused_solve_matches_jax_interpret(wide_designs, key):
    """The port's fused solve (the plain version of K5 or K4 here, where it
    raised ValueError before the wide route) against the JAX package's in
    interpret mode, 8 lanes, at eps 1e-4 (decisions above the fp32 noise
    floor): statuses equal, z within test_torch_admm_dense's bar, iteration
    counts within one check on the QTP; on the (32, 1) plant, whose lanes
    approach the bar slowly (455-610 iterations), within 10%, as each
    package's fp32 roundoff decides the check at which a lane crosses
    it."""
    jd, td = wide_designs[key]
    want = WIDE[key][0]
    B = 8
    q, l, u = _qp_vectors(td, _x0s(td, B, seed=11))
    calls = admm_fused.PLAIN_CALLS[want]
    zt, _, _, st, it, _, _ = admm_fused.solve_batch_fused(
        td.engine.op, q, l, u, config=td.engine.config)
    assert admm_fused.PLAIN_CALLS[want] > calls
    zj, _, _, sj, ij, _, _ = admm_pallas.solve_batch_fused(
        jd.engine.op, *(jnp.asarray(v.numpy()) for v in (q, l, u)),
        config=jd.engine.config, interpret=True)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (st == 0).all()
    it, ij = it.numpy(), np.asarray(ij)
    if want == "K5":
        assert np.abs(it - ij).max() <= td.engine.config.check_interval
    else:
        assert (np.abs(it - ij) <= 0.1 * ij).all(), (it, ij)
    zj = np.asarray(zj)
    assert np.abs(zt.numpy() - zj).max() <= RTOL * np.abs(zj).max() + ATOL


@pytest.mark.parametrize("key", list(WIDE))
def test_wide_dense_controllers_route_fused(wide_designs, key, monkeypatch):
    """solve_batch_auto takes both dense controllers to the fused path (the
    plain K5 or K4 here, the wide route on the card): the general engine
    never runs."""
    _, td = wide_designs[key]
    want = WIDE[key][0]
    op, cfg = td.engine.op, td.engine.config
    assert parallel.fused_supported(td)
    wrapper = (admm_fused.iterate_chunk_dense_packed_T if want == "K4"
               else admm_fused.iterate_chunk_dense_perr_T)
    assert admm_fused.chunk_fn_for(op, config=cfg) is wrapper
    monkeypatch.setattr(parallel.scenarios, "solve_batch", lambda *a, **k: pytest.fail(
        "the general engine ran"))
    td = td.replace(engine=td.engine.replace(config=dataclasses.replace(cfg, max_iter=25)))
    calls = dict(admm_fused.PLAIN_CALLS)
    sol, _, _, _ = parallel.solve_batch_auto(td, torch.from_numpy(_x0s(td, 8, seed=3)))
    ran = {k: admm_fused.PLAIN_CALLS[k] - calls[k] for k in calls}
    assert ran[want] > 0 and all(v == 0 for k, v in ran.items() if k != want)
    assert bool(torch.isfinite(sol.u).all())


# the (16, 8) plant's lanes that K1's fused solve leaves at the iteration
# limit on the routing audit's config (chip_smoke.wide16_x0s(4096): ROADMAP
# Queue 3, "Divergences on record")
STUCK_LANES = [53, 688, 1079, 1089, 1198, 2035, 2083]


@pytest.fixture(scope="module")
def stuck():
    c = tmpc.proceed_controller(
        tbig.random_stable_system(16, 8, seed=0), "model_predictive_control", 30, 5.0,
        [0.0] * 16, [0.0] * 8, admm_config=TConfig(max_iter=1000), device="cpu")
    rng = np.random.default_rng(0)
    x0s = (0.5 * rng.standard_normal((4096, 16)).clip(-1, 1)).astype(np.float32)
    return c, torch.from_numpy(x0s[STUCK_LANES])


def test_k1_stuck_lanes_sit_at_a_fixed_point(stuck):
    """wide16x8-h30 (n = 240, the default grid, eps 1e-6): K1's fused solve
    (its plain version, which the kernel equals bit for bit) leaves these 7
    lanes at the iteration limit, stuck from iteration 50 on: r_prim 0 and
    r_dual the same to the last bit at budgets of 50 and 100. The status is
    decided by roundoff at the fp32 floor of the stored K, so K1's sums
    stay as they are."""
    c, x0s = stuck
    op = c.engine.op
    assert admm_fused.k1_plan(240, 5, 1, 7).route == "stream"
    q, l, u, _, _ = runtime_qp_vectors_batch(c.engine.qp, x0s - c.tuning.references.x[:, 0])
    out = {}
    for budget in (50, 100):
        cfg = dataclasses.replace(c.engine.config, max_iter=budget)
        out[budget] = admm_fused.solve_batch_fused(op, q, l, u, config=cfg)
    for budget, (_, _, _, status, _, rp, rd) in out.items():
        assert (status == STATUS_MAX_ITER).all(), (budget, status)
        assert (rp == 0).all(), (budget, rp)
    rd50, rd100 = out[50][6], out[100][6]
    assert torch.equal(rd50.view(torch.int32), rd100.view(torch.int32))
    assert float(rd100.min()) > 2e-4 and float(rd100.max()) < 1.2e-3


def test_k1_stuck_lanes_converge_on_tier_2(stuck):
    """The escalated solve (tier 1 cut to 100 iterations, since the lanes
    are stuck by 50; tier 2 at the grid (0.1, 1, 10, 100) with 2
    refinements and 250 iterations, K1 on its stream route) converges all
    7 lanes, with no host oracle behind it."""
    c, x0s = stuck
    t1 = c.replace(engine=c.engine.replace(config=dataclasses.replace(
        c.engine.config, max_iter=100)))
    fb = parallel.escalation_controller(c, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250,
                                        refine_steps=2)
    assert parallel.fused_supported(fb)
    sol, _, _, d = parallel.make_escalated_solver(t1, fallback=fb, min_bucket=8,
                                                  native_tier=False)(x0s)
    assert int(d.n_converged) == 7 and (sol.status == 0).all()
    assert int(sol.iterations.max()) <= 100 + 250
