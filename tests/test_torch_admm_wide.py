"""K1's and K2's stream route (csrc/admm_diag_stream.cu) on the CPU: the
shapes it takes against the JAX package's, its plans, and the port's fused
solve at those widths against the JAX package's.

The kernel itself runs only on the card (tests/test_torch_cuda.py holds it
to the plain versions bit for bit); here the wrappers run the plain
versions. The JAX side runs ops/admm_pallas in interpret mode, as the JAX
package's own tests do; inputs are made with numpy from a seed.
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
from automationlabsmodelpredictivecontrol_jl_torch import parallel
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig as TConfig
from automationlabsmodelpredictivecontrol_jl_torch.ops.condense import runtime_qp_vectors_batch

from test_torch_admm_fused import ATOL, EPS_ABOVE_FLOOR, RTOL

torch.set_num_threads(1)

# (rho grid size R, refine_steps): tier 1, tier 2 of the escalated solve,
# and the default AdmmConfig
CONFIGS = [(2, 0), (4, 2), (5, 1)]


@pytest.mark.parametrize("R,refine_steps", CONFIGS)
def test_k1_takes_every_width_the_pallas_body_takes(R, refine_steps):
    """k1_fits holds at every n from 1 to 600 where the JAX package's
    fused_fits(diag_a=True) does (n <= 528 at tier 1, 280 at tier 2, 288 at
    the default config), on the shared route up to its own widths and on
    the stream route past them."""
    widest = 0
    for n in range(1, 601):
        if admm_pallas.fused_fits(n, n, R, refine_steps, diag_a=True):
            widest = n
            assert admm_fused.k1_fits(n, R, refine_steps), n
    assert widest >= 280


@pytest.mark.parametrize("tail", ["one", "half", "n", "2n"])
@pytest.mark.parametrize("R,refine_steps", CONFIGS)
def test_k2_takes_every_width_the_pallas_body_takes(R, refine_steps, tail):
    """k2_fits holds at every n from 1 to 600 and a tail of 1, n / 2, n or
    2 n rows (the QTP's state box has m = 3 n) where the JAX package's
    fused_fits(mixed_a=True) does."""
    rows = {"one": lambda n: 1, "half": lambda n: n // 2, "n": lambda n: n,
            "2n": lambda n: 2 * n}[tail]
    widest = 0
    for n in range(1, 601):
        ms = rows(n)
        if ms >= 1 and admm_pallas.fused_fits(n, n + ms, R, refine_steps, mixed_a=True):
            widest = n
            assert admm_fused.k2_fits(n, n + ms, R, refine_steps), (n, ms)
    assert widest >= 189


# the plans of every K1 and K2 row of PERF.md's kernel table, frozen from
# the parent tree (before the stream route): (shape, precision) -> plan
K1_FROZEN = {
    (40, 2, 0, 16384, "highest"): (32, 8, 5, 512, 46112, 2),
    (40, 4, 2, 512, "highest"): (4, 40, 1, 128, 110208, 2),
    (40, 2, 0, 4096, "highest"): (32, 8, 5, 128, 46112, 2),
    (40, 4, 2, 1, "highest"): (4, 40, 1, 1, 110208, 2),
    (40, 4, 2, 33, "highest"): (4, 40, 1, 9, 110208, 2),
    (40, 4, 2, 77, "highest"): (4, 40, 1, 20, 110208, 2),
    (40, 4, 2, 1000, "highest"): (8, 40, 1, 125, 117888, 1),
    (40, 5, 1, 4096, "highest"): (32, 8, 5, 128, 148640, 1),
    (100, 2, 0, 2048, "highest"): (16, 14, 8, 128, 195104, 1),
    (40, 2, 0, 16384, "bf16x3"): (32, 5, 8, 512, 46112, 2),
    (40, 2, 0, 16384, "default"): (32, 5, 8, 512, 46112, 2),
    (40, 4, 2, 512, "bf16x3"): (4, 40, 1, 128, 110208, 2),
    (40, 4, 2, 512, "default"): (4, 40, 1, 128, 110208, 2),
}
K2_FROZEN = {
    (40, 120, 5, 1, 2048, "highest"): (16, 14, 3, 6, 128, 186016),
    (40, 44, 5, 1, 2048, "highest"): (16, 14, 3, 1, 128, 143776),
    (40, 52, 5, 1, 2048, "highest"): (16, 14, 3, 1, 128, 146336),
    (40, 132, 5, 1, 2048, "highest"): (16, 16, 3, 6, 128, 194464),
    (40, 120, 4, 2, 512, "highest"): (4, 40, 1, 2, 128, 142208),
    (40, 120, 5, 1, 1, "highest"): (4, 40, 1, 2, 1, 169120),
    (40, 120, 5, 1, 33, "highest"): (4, 40, 1, 2, 9, 169120),
    (40, 120, 5, 1, 77, "highest"): (4, 40, 1, 2, 20, 169120),
    (40, 120, 5, 1, 1000, "highest"): (8, 28, 2, 3, 125, 187040),
    (40, 120, 5, 1, 2048, "bf16x3"): (16, 14, 3, 6, 128, 186016),
    (40, 120, 5, 1, 2048, "default"): (16, 14, 3, 6, 128, 186016),
}


def test_shared_plans_are_unchanged():
    """At every shape of PERF.md's K1 and K2 rows the plan is the parent's,
    on the shared route: the stream route changes nothing where the
    kernels worked before."""
    for (n, R, rs, B, mode), want in K1_FROZEN.items():
        assert admm_fused.k1_plan(n, R, rs, B, mode=mode) == want + ("shared", 0)
    for (n, m, R, rs, B, mode), want in K2_FROZEN.items():
        assert admm_fused.k2_plan(n, m, R, rs, B, mode=mode) == want + ("shared", 0)


@pytest.mark.parametrize("R,refine_steps", CONFIGS)
def test_stream_plans_cover_the_batch_within_shared_memory(R, refine_steps):
    """The stream route is planned only where the shared route has no
    layout; its blocks cover B with room for each rho index's partial last
    block, whole warps of at most 256 threads (1, 2 or 4 lanes a thread,
    4 rows, or 8 in K1's blocks of 4 lanes a thread), its shared memory is
    the C entry's formula within the card's,
    and a panel holds at least 8 columns of a tile (or whole rows), no
    more than its threads stage, or every operator of one rho whole."""
    shapes = [(n, 0) for n in (41, 53, 59, 60, 100, 129, 200, 240, 288, 333, 528)]
    shapes += [(n, ms) for n in (7, 40, 48, 100, 195, 275) for ms in (1, 129, 2 * n)]
    for n, ms in shapes:
        shared = (any(admm_fused._k2_layouts(n, n + ms, R, refine_steps)) if ms
                  else any(admm_fused._k1_layouts(n, R, refine_steps)))
        for B in (1, 33, 512, 2048, 4096, 16384):
            if ms:
                p = admm_fused.k2_plan(n, n + ms, R, refine_steps, B)
            else:
                p = admm_fused.k1_plan(n, R, refine_steps, B)
            assert p.route == ("shared" if shared else "stream"), (n, ms, B)
            if shared:
                continue
            assert p.blocks == -(-B // p.lanes) + R and (p.blocks - R) * p.lanes >= B
            assert admm_fused.k12_blocks_used(R, B, p.lanes) <= p.blocks
            lanes_a_thread = admm_fused.k12_lanes_per_thread(p.lanes)
            threads = p.lanes // lanes_a_thread * p.groups
            assert p.lanes in admm_fused.K12_STREAM_LANES and threads % 32 == 0
            assert threads <= admm_fused.K12_STREAM_THREADS
            assert lanes_a_thread == (4 if p.lanes >= 32 else 2 if p.lanes == 16 else 1)
            rows = p.rpt_n if ms else p.rpt
            assert rows in admm_fused.k12_rows_options(p.lanes, ms > 0)
            assert rows == 4 or (rows == 8 and lanes_a_thread == 4 and not ms)
            assert p.smem_bytes == admm_fused.k12_stream_smem_bytes(
                n, ms, p.lanes, p.panel) <= admm_fused.SMEM_LIMIT
            lay = admm_fused.k12_stream_layout(n, ms, refine_steps, p.lanes, p.groups, rows,
                                               p.panel)
            assert lay is not None and lay.sn % 4 == 2  # odd in 16-byte units
            if lay.resident:
                assert lay.pn == (n + 3) // 4 * 4 and lay.sn >= lay.pn
                continue
            # a panel's chunks of 4 columns fit the threads' staging
            chunks = admm_fused.K12_STREAM_STAGE * threads
            for cols, pk, sp, rt in ((n, lay.pn, lay.sn, rows),
                                     (ms, lay.pt, lay.st, admm_fused.K12_PASS_ROWS))[:2 if ms else 1]:
                H = rt * p.groups
                assert pk % 4 == 0 and min(8, (cols + 3) // 4 * 4) <= pk and H * pk // 4 <= chunks
                assert pk + 2 <= sp and H * sp <= p.panel


@pytest.mark.parametrize("R,refine_steps", CONFIGS)
def test_stream_route_takes_every_width_up_to_1024(R, refine_steps):
    """The stream route has a layout at every n up to 1024 and every tail
    of 0 to 1024 rows (k1_fits and k2_fits hold wherever the shared route
    does not), and at none past them."""
    for n in (1, 2, 3, 5, 64, 129, 255, 256, 511, 600, 777, 1000, 1023, 1024):
        assert admm_fused._k12_stream_layouts(n, 0, refine_steps), n
        assert admm_fused.k1_fits(n, R, refine_steps)
        for ms in (1, 2, 3, 7, 128, 129, 550, 1024):
            assert admm_fused._k12_stream_layouts(n, ms, refine_steps), (n, ms)
            assert admm_fused.k2_fits(n, n + ms, R, refine_steps)
    assert not admm_fused.k1_fits(1025, R, refine_steps)
    assert not admm_fused.k2_fits(100, 100 + 1025, R, refine_steps)


def test_stream_plan_reads_a_quarter_of_the_l2_bytes():
    """At the (16, 8) plant's h30 shape (n = 240, R = 5, one refinement,
    B = 4096) the plan's blocks read at most a quarter of the operator
    bytes from L2 in a chunk that the 16-lane plan of fp64 entries read
    (every block one rho's K^-1, K and K^-1 each iteration: 8.99 GB at 25
    iterations), and no more than 2.25 GB."""
    n, R, rs, B, chunk = 240, 5, 1, 4096, 25
    p = admm_fused.k1_plan(n, R, rs, B)
    assert p.route == "stream" and p.lanes >= 32
    new = admm_fused.k12_stream_l2_bytes(n, 0, R, rs, B, p.lanes, p.groups, p.rpt, p.panel,
                                         chunk)
    old = 8 * 3 * n * n * chunk * R * -(-B // (R * 16))
    assert old == 8985600000 and new * 4 <= old and new <= 2.25e9


def test_routes_are_forced_and_checked():
    """``route`` forces the stream route at a shape the shared route takes
    (the card tests hold both to the plain version there), and a forced
    layout of the shared route never falls to the stream route; the
    stream route's lanes and row-groups are forced likewise, and a layout
    it does not have raises."""
    p = admm_fused.k1_plan(40, 2, 0, 2048, route="stream")
    assert p.route == "stream" and p.rpt in admm_fused.k12_rows_options(p.lanes, False)
    assert admm_fused.k2_plan(40, 120, 5, 1, 2048, route="stream").route == "stream"
    for lanes, groups in ((64, 14), (32, 12), (16, 8), (8, 8), (4, 16)):
        p = admm_fused.k1_plan(100, 5, 1, 512, lanes=lanes, groups=groups)
        assert p.route == "stream" and (p.lanes, p.groups) == (lanes, groups)
    with pytest.raises(ValueError):
        admm_fused.k1_plan(40, 2, 0, 2048, route="tiled")
    with pytest.raises(ValueError):
        admm_fused.k1_plan(200, 5, 1, 2048, route="shared")
    with pytest.raises(ValueError):
        admm_fused.k1_plan(40, 2, 0, 2048, lanes=32, groups=4)  # 10 rows a thread
    with pytest.raises(ValueError):
        admm_fused.k1_plan(100, 5, 1, 512, lanes=64, groups=32)  # 512 threads
    with pytest.raises(ValueError):
        admm_fused.k1_plan(100, 5, 1, 512, lanes=16, groups=2)  # not whole warps
    with pytest.raises(ValueError):
        admm_fused.k2_plan(100, 300, 5, 1, 2048, route="shared")
    with pytest.raises(ValueError):
        admm_fused.k1_plan(admm_fused.MAX_STREAM_N + 1, 1, 0, 64)


def _pair(horizon, cfg, **kw):
    """The JAX controller and the port's, designed alike."""
    jc = jmpc.proceed_controller(
        jqtp.linearized_discrete_system(), "model_predictive_control", horizon, 5.0,
        np.full(4, 0.65), np.full(2, 1.2), admm_config=JConfig(**cfg), **kw)
    tc = tmpc.proceed_controller(
        tqtp.linearized_discrete_system(), "model_predictive_control", horizon, 5.0,
        [0.65] * 4, [1.2] * 2, admm_config=TConfig(**cfg), device="cpu", **kw)
    return jc, tc


def _x0s(B, seed):
    rng = np.random.default_rng(seed)
    return np.clip(0.65 + 0.15 * rng.standard_normal((B, 4)), 0.25, 1.3).astype(np.float32)


# the two shapes past the shared routes: the default config's QTP at h30
# (n = 60; its shared K1 stops at 52) and its h24 state box (n = 48,
# m = 144; its shared K2 stops at h23)
WIDE = {
    "h30-default": (30, {}),
    "h24-state-box": (24, dict(mpc_state_constraint=True)),
}


@pytest.fixture(scope="module")
def wide_pairs():
    cfg = dict(max_iter=200, **EPS_ABOVE_FLOOR)
    return {key: _pair(h, cfg, **kw) for key, (h, kw) in WIDE.items()}


@pytest.mark.parametrize("key", list(WIDE))
def test_wide_shapes_take_the_stream_route(wide_pairs, key):
    _, tc = wide_pairs[key]
    op = tc.engine.op
    m, n = (int(d) for d in op.A_s.shape)
    if op.diag_a:
        assert admm_fused.k1_plan(n, 5, 1, 8).route == "stream"
    else:
        assert op.mixed_a and admm_fused.k2_plan(n, m, 5, 1, 8).route == "stream"
    assert parallel.fused_supported(tc)


@pytest.mark.parametrize("key", list(WIDE))
def test_wide_chunk_matches_jax_interpret(wide_pairs, key):
    """One 25-iteration chunk of the plain version against the Pallas body
    in interpret mode, at the default config (R = 5, one refinement), lanes
    at random rho indices, within test_torch_admm_fused's bar."""
    jc, tc = wide_pairs[key]
    op = tc.engine.op
    m, n = (int(d) for d in op.A_s.shape)
    B = 8
    x0s = torch.from_numpy(_x0s(B, seed=n))
    q, l, u, _, _ = runtime_qp_vectors_batch(tc.engine.qp, x0s - tc.tuning.references.x[:, 0])
    qT = ((op.c * op.D)[:, None] * q.T).numpy()
    lT = (op.E[:, None] * l.T).numpy()
    uT = (op.E[:, None] * u.T).numpy()
    rng = np.random.default_rng(n + 1)
    x = (0.05 * rng.standard_normal((n, B))).astype(np.float32)
    y, ax = ((0.05 * rng.standard_normal((m, B))).astype(np.float32) for _ in range(2))
    s = np.clip(ax, lT, uT)
    idx = rng.integers(0, 5, size=B).astype(np.int32)
    args = [qT, lT, uT, idx, x, s, y, ax]
    kernel = "K1" if op.diag_a else "K2"
    calls = admm_fused.PLAIN_CALLS[kernel]
    fn = admm_fused.chunk_fn_for(op, config=tc.engine.config)
    out_t = fn(op, *[torch.from_numpy(a) for a in args], 25, tc.engine.config)
    assert admm_fused.PLAIN_CALLS[kernel] == calls + 1
    jfn = admm_pallas._iterate_chunk_diag_T if op.diag_a else admm_pallas._iterate_chunk_mixed_T
    out_j = jfn(jc.engine.op, *[jnp.asarray(a) for a in args], 25, jc.engine.config,
                interpret=True)
    for name, a, b in zip(("x", "s", "y", "ax"), out_t, out_j):
        a, b = a.numpy(), np.asarray(b)
        err = np.abs(a - b).max()
        assert err <= RTOL * np.abs(b).max() + ATOL, (name, err)


@pytest.mark.parametrize("key", list(WIDE))
def test_wide_fused_solve_matches_jax_interpret(wide_pairs, key):
    """The port's fused solve (the plain version of K1 or K2 here) against
    the JAX package's in interpret mode, at eps 1e-4 (decisions above the
    fp32 noise floor): statuses equal, iteration counts within one check
    (at h30 one lane's primal residual after 25 iterations is 2.19e-4 here
    and 2.23e-4 in JAX, against a bar of about 2.2e-4: the two packages'
    fp32 sums differ in order, so a lane that close to its bar may stop a
    check apart), z within the JAX package's fused-vs-engine bar."""
    jc, tc = wide_pairs[key]
    B = 8
    e0s = torch.from_numpy(_x0s(B, seed=11)) - tc.tuning.references.x[:, 0]
    q, l, u, _, _ = runtime_qp_vectors_batch(tc.engine.qp, e0s)
    zt, yt, _, st, it, _, _ = admm_fused.solve_batch_fused(
        tc.engine.op, q, l, u, config=tc.engine.config)
    zj, yj, _, sj, ij, _, _ = admm_pallas.solve_batch_fused(
        jc.engine.op, jnp.asarray(q.numpy()), jnp.asarray(l.numpy()), jnp.asarray(u.numpy()),
        config=jc.engine.config, interpret=True)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    check = tc.engine.config.check_interval
    assert np.abs(it.numpy() - np.asarray(ij)).max() <= check
    assert int((it.numpy() == np.asarray(ij)).sum()) >= B - 1
    assert int((st == 0).sum()) >= B // 2
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=5e-4)


def test_wide_controllers_route_fused(wide_pairs, monkeypatch):
    """solve_batch_auto takes the h30 default controller to the fused path
    (K1's plain version here, its stream route on the card), and the
    escalated solve's tier 2 at n = 60 (R = 4, two refinements: the shared
    K1 stops at n = 58) stays fused: the general engine never runs."""
    _, tc = wide_pairs["h30-default"]
    monkeypatch.setattr(parallel.scenarios, "solve_batch", lambda *a, **k: pytest.fail(
        "the general engine ran"))
    x0s = torch.from_numpy(_x0s(8, seed=3))
    calls = admm_fused.PLAIN_CALLS["K1"]
    parallel.solve_batch_auto(tc, x0s)
    assert admm_fused.PLAIN_CALLS["K1"] > calls
    t1 = tc.replace(engine=tc.engine.replace(config=TConfig(**dict(
        max_iter=25, **EPS_ABOVE_FLOOR))))
    fb = parallel.escalation_controller(tc, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=50,
                                        refine_steps=2)
    assert admm_fused.k1_plan(60, 4, 2, 8).route == "stream" and parallel.fused_supported(fb)
    wz, wy = parallel.init_warm_batch(tc, 8)
    sol1, _, _, _ = parallel.solve_batch_auto(t1, x0s, wz, wy)
    assert int((sol1.status != 0).sum()) > 0  # stragglers for tier 2
    calls = admm_fused.PLAIN_CALLS["K1"]
    parallel.solve_batch_escalated(t1, fb, x0s, wz, wy, bucket=8)
    assert admm_fused.PLAIN_CALLS["K1"] > calls + 1  # tier 1's chunk, then tier 2's
