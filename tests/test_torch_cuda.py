"""K1, K2, K3, K3W, K4 and K5 on the card: each CUDA kernel against its plain
PyTorch version (K1, K2, K4 and K5 at each kernel precision).

Marked ``cuda``; each test decides in a fixture whether a card is present
and skips otherwise. Needs no JAX, so on a machine with a card and without
JAX it runs as

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from automationlabsmodelpredictivecontrol_jl_torch import parallel, proceed_controller
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp
from automationlabsmodelpredictivecontrol_jl_torch.design import LinearEngine
from automationlabsmodelpredictivecontrol_jl_torch.ops import _build, admm_fused, riccati, riccati_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import (
    AdmmConfig, build_operator, start_rho_index,
)
from automationlabsmodelpredictivecontrol_jl_torch.ops.condense import runtime_qp_vectors_batch

pytestmark = pytest.mark.cuda

TIER1 = AdmmConfig(max_iter=75, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0)
# the precisions of K1, K2, K4 and K5 (AdmmConfig.kernel_precision)
MODES = admm_fused.PRECISIONS


def _in_mode(args, mode):
    """A chunk's arguments with the config's kernel_precision set."""
    return args[:-1] + (dataclasses.replace(args[-1], kernel_precision=mode),)


def _key(kernel, mode):
    """The launch and plain-call count of a kernel at a precision."""
    return kernel if mode == "highest" else f"{kernel}-{mode}"


def _assert_equal_bits(out_k, out_p, what=""):
    for name, a, b in zip(("x", "s", "y", "ax"), out_k, out_p):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), (name, what)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (name, what)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def controllers(card):
    c = proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control", 20, 5.0,
        [0.65] * 4, [1.2] * 2, admm_config=TIER1, device=card,
    )
    fb = parallel.escalation_controller(
        c, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250, refine_steps=2
    )
    return c, fb


def _x0s(B, seed):
    rng = np.random.default_rng(seed)
    return np.clip(0.65 + 0.15 * rng.standard_normal((B, 4)), 0.25, 1.3).astype(np.float32)


def _chunk_args(ctrl, B, seed, single_index=False):
    """One chunk's inputs on the card; the lanes' rho indices random, or
    all at the config's start index."""
    dev = ctrl.device
    op = ctrl.engine.op
    R = op.rho_vecs.shape[0]
    m, n = op.A_s.shape
    x0s = torch.from_numpy(_x0s(B, seed)).to(dev)
    q, l, u, _, _ = runtime_qp_vectors_batch(ctrl.engine.qp, x0s - ctrl.tuning.references.x[:, 0])
    qT = ((op.c * op.D)[:, None] * q.T).contiguous()
    lT = (op.E[:, None] * l.T).contiguous()
    uT = (op.E[:, None] * u.T).contiguous()
    rng = np.random.default_rng(seed + 1)
    x, y, ax = (
        torch.from_numpy((0.05 * rng.standard_normal((rows, B))).astype(np.float32)).to(dev)
        for rows in (n, m, m)
    )
    s = torch.clamp(ax, lT, uT).contiguous()
    idx = rng.integers(0, R, size=B).astype(np.int32)
    if single_index:
        idx[:] = start_rho_index(ctrl.engine.config) if R > 1 else 0
    idx = torch.from_numpy(idx).to(dev)
    return (op, qT, lT, uT, idx, x, s, y, ax, 25, ctrl.engine.config)


@pytest.mark.parametrize("which,B,single,layout", [
    ("tier1", 16384, False, None), ("tier1", 16384, True, None), ("tier1", 4096, False, None),
    ("tier1", 1000, False, None), ("tier2", 512, False, None), ("tier2", 512, True, None),
    ("tier2", 77, False, None), ("tier2", 33, False, None), ("tier2", 1, False, None),
    ("tier1", 1000, False, (16, 10)), ("tier2", 77, True, (8, 24)),
])
@pytest.mark.parametrize("mode", MODES)
def test_k1_matches_plain_version(controllers, which, B, single, layout, mode):
    """K1 as k1_plan lays it out (32 lanes a block at tier 1, 4 at tier 2's
    bucket, 8 at B=1000), or in a forced layout, against its plain version,
    with random rho indices or one index for all lanes, at each precision;
    ragged batches reach every barrier with a partial last block."""
    ctrl = controllers[0] if which == "tier1" else controllers[1]
    args = _in_mode(_chunk_args(ctrl, B, seed=B, single_index=single), mode)
    key = _key("K1", mode)
    launches, plain = admm_fused.LAUNCHES[key], admm_fused.PLAIN_CALLS[key]
    if layout is None:
        out_k = admm_fused.iterate_chunk_diag_T(*args)
    else:
        op, cfg = args[0], args[-1]
        plan = admm_fused.k1_plan(40, int(op.rho_grid.shape[0]), int(cfg.refine_steps), B,
                                  lanes=layout[0], groups=layout[1], mode=mode)
        out_k = admm_fused._launch_k1(*args, plan=plan)
    torch.cuda.synchronize()
    assert admm_fused.LAUNCHES[key] == launches + 1
    assert admm_fused.PLAIN_CALLS[key] == plain
    out_p = admm_fused.iterate_chunk_diag_T_plain(*args)
    if mode != "highest":  # fp32 sums in the plain version's order
        _assert_equal_bits(out_k, out_p, mode)
        return
    for name, a, b in zip(("x", "s", "y", "ax"), out_k, out_p):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        # both sum the K-solve in fp64 and round once; the fp64 sums run in
        # another order, so an entry may round to a neighbouring float
        err = float((a - b).abs().max())
        assert err <= 1e-4 * max(1.0, float(b.abs().max())), (name, err)


def test_k1_refuses_a_layout_it_does_not_have(controllers):
    """The C entry refuses shared-memory bytes that differ from its own
    layout (cudaError_t 1) rather than run on a wrong one."""
    args = _chunk_args(controllers[1], 64, seed=6)
    plan = admm_fused.k1_plan(40, 4, 2, 64)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        admm_fused._launch_k1(*args, plan=plan._replace(smem_bytes=plan.smem_bytes + 16))


@pytest.fixture(scope="module")
def mixed_controllers(card):
    """The state-constrained h20 controller at the suite's config (m = 120,
    R = 5, refine 1) and its tier-2 fallback (R = 4, refine 2), the suite's
    neighborhood-terminal controller (m = 52), its equality-terminal one
    (m = 44) and the state + neighborhood one (m = 132)."""
    design = lambda **kw: proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control", 20, 5.0,
        [0.65] * 4, [1.2] * 2, admm_config=AdmmConfig(max_iter=1000), device=card, **kw,
    )
    sc = design(mpc_state_constraint=True)
    fb = parallel.escalation_controller(
        sc, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250, refine_steps=2
    )
    return {
        "suite": sc, "tier2": fb, "m52": design(mpc_terminal_ingredient="neighborhood"),
        "m44": design(mpc_terminal_ingredient="equality"),
        "m132": design(mpc_state_constraint=True, mpc_terminal_ingredient="neighborhood"),
    }


def _k2_held_to_plain(args, plan=None):
    key = _key("K2", args[-1].kernel_precision)
    launches, plain = admm_fused.LAUNCHES[key], admm_fused.PLAIN_CALLS[key]
    if plan is None:
        out_k = admm_fused.iterate_chunk_mixed_T(*args)
    else:
        out_k = admm_fused._launch_k2(*args, plan=plan)
    torch.cuda.synchronize()
    assert admm_fused.LAUNCHES[key] == launches + 1
    assert admm_fused.PLAIN_CALLS[key] == plain
    out_p = admm_fused.iterate_chunk_mixed_T_plain(*args)
    if key != "K2":  # fp32 sums in the plain version's order
        _assert_equal_bits(out_k, out_p, key)
        return
    for name, a, b in zip(("x", "s", "y", "ax"), out_k, out_p):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        # fp64 sums in another order than the plain version's matmuls
        err = float((a - b).abs().max())
        assert err <= 1e-4 * max(1.0, float(b.abs().max())), (name, err)


@pytest.mark.parametrize("which,B", [
    ("suite", 2048), ("suite", 1000), ("tier2", 512), ("tier2", 77), ("m44", 2048),
    ("m52", 2048), ("m132", 2048), ("suite", 1), ("suite", 33), ("suite", 77),
])
@pytest.mark.parametrize("mode", MODES)
def test_k2_matches_plain_version(mixed_controllers, which, B, mode):
    """K2 as k2_plan lays it out (4, 8 and 16 lanes a block among these
    shapes, and the row-groups of each tail) against its plain version, at
    each precision."""
    ctrl = mixed_controllers[which]
    m = {"suite": 120, "tier2": 120, "m44": 44, "m52": 52, "m132": 132}[which]
    assert ctrl.engine.op.mixed_a and ctrl.engine.op.A_s.shape == (m, 40)
    _k2_held_to_plain(_in_mode(_chunk_args(ctrl, B, seed=B), mode))


@pytest.mark.parametrize("which,lanes", [("suite", 16), ("suite", 8), ("suite", 4), ("m44", 32)])
@pytest.mark.parametrize("mode", MODES)
def test_k2_forced_layouts_match_plain_version(mixed_controllers, which, lanes, mode):
    """Every lanes-per-block K2 takes, at a ragged batch and each
    precision: a partial last block reaches every barrier (32 lanes fit
    only the short tail)."""
    ctrl = mixed_controllers[which]
    m = int(ctrl.engine.op.A_s.shape[0])
    args = _in_mode(_chunk_args(ctrl, 1000, seed=5), mode)
    plan = admm_fused.k2_plan(40, m, 5, 1, 1000, lanes=lanes, mode=mode)
    _k2_held_to_plain(args, plan)


def test_k2_refuses_a_layout_it_does_not_have(mixed_controllers):
    """The C entry refuses shared-memory bytes that differ from its own
    layout (cudaError_t 1) rather than run on a wrong one."""
    args = _chunk_args(mixed_controllers["suite"], 64, seed=6)
    plan = admm_fused.k2_plan(40, 120, 5, 1, 64)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        admm_fused._launch_k2(*args, plan=plan._replace(smem_bytes=plan.smem_bytes + 16))


def test_mixed_solve_auto_launches_k2(mixed_controllers):
    """The suite's neighborhood controller through solve_batch_auto: K2
    launches, no plain version runs, every lane converges, and the result
    agrees with the same solve on the CPU."""
    ctrl = mixed_controllers["m52"]
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(0.65 + 0.002 * rng.standard_normal((256, 4)).astype(np.float32))
    launches, plain = admm_fused.LAUNCHES["K2"], dict(admm_fused.PLAIN_CALLS)
    s_gpu, _, _, d_gpu = parallel.solve_batch_auto(ctrl, x0.to(ctrl.device))
    torch.cuda.synchronize()
    assert admm_fused.LAUNCHES["K2"] > launches
    assert admm_fused.PLAIN_CALLS == plain
    assert int(d_gpu.n_converged) == 256
    s_cpu, _, _, _ = parallel.solve_batch_auto(ctrl.to("cpu"), x0)
    np.testing.assert_allclose(s_gpu.u.cpu().numpy(), s_cpu.u.numpy(), atol=5e-4)


@pytest.fixture(scope="module")
def wide_controllers(card):
    """Condensed controllers whose operators K1's and K2's shared routes do
    not hold, so that their stream route (csrc/admm_diag_stream.cu) takes
    them: the QTP at h50 box-only at the default config (n = 100) and its
    tier 2 (R = 4, refine 2), at h30 (n = 60), its h50 state box (n = 100,
    m = 300), and the (16, 8) plant of the routing audit at h30 (n = 240)."""
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big

    cfg = AdmmConfig(max_iter=1000)
    design = lambda N, plant=None, **kw: proceed_controller(
        plant or qtp.linearized_discrete_system(), "model_predictive_control", N, 5.0,
        [0.0] * 16 if plant else [0.65] * 4, [0.0] * 8 if plant else [1.2] * 2,
        admm_config=cfg, device=card, **kw)
    h50 = design(50)
    return {
        "h50": h50, "h30": design(30), "h50-sc": design(50, mpc_state_constraint=True),
        "h50-tier2": parallel.escalation_controller(
            h50, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250, refine_steps=2),
        "wide16x8": design(30, big.random_stable_system(16, 8, seed=0)),
    }


def _lane_args(op, cfg, B, seed, single_index=False):
    """One chunk's inputs for an operator on its device: seeded q, boxes
    around 0 and a state of scale 0.05; rho indices random or all at the
    config's start index."""
    dev = op.A_s.device
    m, n = (int(d) for d in op.A_s.shape)
    R = int(op.rho_grid.shape[0])
    rng = np.random.default_rng(seed)
    f32 = lambda *shape, scale=0.05: torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)
    qT = f32(n, B, scale=1.0)
    lT = -f32(m, B, scale=0.5).abs() - 0.1
    uT = f32(m, B, scale=0.5).abs() + 0.1
    idx = rng.integers(0, R, size=B).astype(np.int32)
    if single_index:
        idx[:] = start_rho_index(cfg) if R > 1 else 0
    x, y, ax = f32(n, B), f32(m, B), f32(m, B)
    s = torch.clamp(ax, lT, uT).contiguous()
    return (op, qT, lT, uT, torch.from_numpy(idx).to(dev), x, s, y, ax, 25, cfg)


def _synthetic_box_op(base, n, ms, R, refine_steps, seed):
    """A diagonal (ms = 0) or mixed operator of any shape, made as
    build_operator makes one from P = I and A = [diag(d); A2] with a random
    A2 (no scaling): K_r = P + sigma I + A' diag(rho_r) A over R rho
    values, K_r^-1 in fp64; every array fp32 on base's device."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.5, 1.5, n)
    A = np.vstack([np.diag(d), rng.standard_normal((ms, n)) / np.sqrt(n)])
    m = n + ms
    grid = np.logspace(-1, 1, R)
    rho = grid[:, None] * np.where(np.arange(m) % 7 == 3, 100.0, 1.0)[None]
    K = np.eye(n) * (1 + 1e-6) + np.einsum("mi,rm,mj->rij", A, rho, A)
    dev = base.A_s.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    return base.replace(
        P_s=t(np.eye(n)), A_s=t(A), Ks=t(K), K_invs=t(np.linalg.inv(K)), rho_vecs=t(rho),
        rho_invs=t(1.0 / rho), rho_grid=t(grid), D=t(np.ones(n)), E=t(np.ones(m)),
        diag_a=ms == 0, mixed_a=ms > 0, kia=None,
    )


def _stream_held_to_plain(args, plan=None):
    """A chunk of K1 or K2 (as the operator says) on the stream route,
    against its plain version: one launch counted, no plain call, equal to
    the last bit."""
    op, cfg = args[0], args[-1]
    m, n = (int(d) for d in op.A_s.shape)
    R, rs = int(op.rho_grid.shape[0]), int(cfg.refine_steps)
    B = int(args[1].shape[1])
    mode = cfg.kernel_precision
    kernel = "K2" if op.mixed_a else "K1"
    if plan is None:
        plan = (admm_fused.k2_plan(n, m, R, rs, B, mode=mode) if op.mixed_a
                else admm_fused.k1_plan(n, R, rs, B, mode=mode))
    assert plan.route == "stream"
    key = _key(kernel, mode)
    launches, plain = admm_fused.LAUNCHES[key], admm_fused.PLAIN_CALLS[key]
    launch = admm_fused._launch_k2 if op.mixed_a else admm_fused._launch_k1
    out_k = launch(*args, plan=plan)
    torch.cuda.synchronize()
    assert admm_fused.LAUNCHES[key] == launches + 1
    assert admm_fused.PLAIN_CALLS[key] == plain
    plain_fn = (admm_fused.iterate_chunk_mixed_T_plain if op.mixed_a
                else admm_fused.iterate_chunk_diag_T_plain)
    _assert_equal_bits(out_k, plain_fn(*args), (kernel, mode, plan))


@pytest.mark.parametrize("which,B,single", [
    ("h50", 4096, False), ("h50", 4096, True), ("h50", 77, False), ("h50-tier2", 512, False),
    ("h30", 1000, False), ("wide16x8", 4096, False), ("wide16x8", 33, True),
    ("h50-sc", 2048, False), ("h50-sc", 77, True), ("h50-sc", 1, False),
])
@pytest.mark.parametrize("mode", MODES)
def test_stream_route_matches_plain_version(wide_controllers, which, B, single, mode):
    """K1 and K2 on their stream route at the controllers' shapes, as
    k1_plan and k2_plan lay them out, against their plain versions bit for
    bit at each precision: random rho indices (every block one index's
    lanes) or one index, ragged batches (each index's partial last block)."""
    ctrl = wide_controllers[which]
    cfg = dataclasses.replace(ctrl.engine.config, kernel_precision=mode)
    _stream_held_to_plain(_lane_args(ctrl.engine.op, cfg, B, seed=B + 7, single_index=single))


@pytest.mark.parametrize("n,ms,R,refine_steps,B,panel", [
    (61, 0, 3, 2, 100, None), (61, 0, 3, 2, 100, "narrow"), (129, 0, 1, 0, 33, None),
    (129, 0, 1, 0, 33, "narrow"), (528, 0, 2, 0, 300, None), (280, 0, 4, 2, 64, None),
    (7, 5, 2, 1, 50, None), (7, 5, 2, 1, 50, "narrow"), (61, 7, 3, 0, 100, "narrow"),
    (33, 1, 2, 1, 64, None), (100, 200, 5, 1, 300, "narrow"), (275, 550, 2, 0, 128, None),
    (480, 1, 2, 0, 40, None), (40, 80, 5, 1, 77, None),
])
@pytest.mark.parametrize("mode", MODES)
def test_stream_route_odd_shapes_match_plain_version(controllers, n, ms, R, refine_steps, B,
                                                    panel, mode):
    """The stream route at shapes the QTP cells never give it: odd n and
    tails (each pair loop's last row, a padded operator column), one tail
    row, one rho and four, no refinement and two, the widest K1 the JAX
    package fuses (n = 528), K2's widest state box (275, 550), a shape the
    shared route also takes (forced), and with ``narrow`` panels of 4 to 8
    columns (every product streamed over several tiles and column
    panels); equal to the plain version bit for bit at each precision."""
    op = _synthetic_box_op(controllers[0].engine.op, n, ms, R, refine_steps, seed=n + ms)
    cfg = AdmmConfig(refine_steps=refine_steps, kernel_precision=mode)
    plan = (admm_fused.k2_plan(n, n + ms, R, refine_steps, B, mode=mode, route="stream") if ms
            else admm_fused.k1_plan(n, R, refine_steps, B, mode=mode, route="stream"))
    if panel == "narrow":
        plan = _narrow(plan, n, ms, refine_steps)
    _stream_held_to_plain(_lane_args(op, cfg, B, seed=B), plan)


def _narrow(plan, n, ms, refine_steps):
    """The stream route's plan with panels of 4 to 8 columns of a tile
    (fewer where that would hold one rho's operators whole): every product
    streamed over several tiles and column panels."""
    whole = admm_fused._k12_resident_doubles(n, ms, refine_steps)
    doubles = min(12 * admm_fused.K12_PASS_ROWS * plan.groups, (whole - 1) // 2 & ~1)
    rows = plan.rpt_n if ms else plan.rpt
    lay = admm_fused.k12_stream_layout(n, ms, refine_steps, plan.lanes, plan.groups, rows, doubles)
    assert not lay.resident and 4 <= lay.pn <= 8 and lay.pt <= 8
    return plan._replace(panel=doubles, smem_bytes=admm_fused.k12_stream_smem_bytes(
        n, ms, plan.lanes, doubles))


@pytest.mark.parametrize("which,B,lanes,groups,rows,narrow", [
    ("h50", 300, 64, 14, 8, False), ("h50", 77, 64, 14, 4, True), ("h50", 300, 32, 16, 8, True),
    ("h50", 4096, 32, 28, 4, False), ("h50", 33, 16, 8, 4, False), ("h50", 1, 8, 8, 4, True),
    ("h50", 77, 4, 16, 4, False), ("h50-sc", 300, 32, 28, 4, False),
    ("h50-sc", 77, 32, 8, 4, True), ("h50-sc", 33, 16, 16, 4, False),
    ("h50-sc", 77, 8, 24, 4, True), ("h50-sc", 5, 4, 48, 4, False),
    ("wide16x8", 200, 32, 20, 8, False), ("wide16x8", 200, 32, 32, 4, True),
    ("wide16x8", 77, 16, 32, 4, True), ("h50-tier2", 100, 8, 16, 4, True),
    ("h50-tier2", 100, 64, 14, 8, False),
])
@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_stream_route_forced_layouts_match_plain_version(wide_controllers, which, B, lanes,
                                                         groups, rows, narrow, single, mode):
    """The stream route at every block width it has (64 and 32 lanes, 4 a
    thread, 4 or 8 rows; 16 lanes, 2 a thread; 8 and 4, 1 a thread),
    forced, resident and streamed, narrow panels, on ragged batches (each
    rho index's partial last block) with random and single rho indices:
    equal to the plain version bit for bit at each precision."""
    ctrl = wide_controllers[which]
    cfg = dataclasses.replace(ctrl.engine.config, kernel_precision=mode)
    op = ctrl.engine.op
    m, n = (int(d) for d in op.A_s.shape)
    R, rs = int(op.rho_grid.shape[0]), int(cfg.refine_steps)
    if op.mixed_a:
        plan = admm_fused.k2_plan(n, m, R, rs, B, lanes, groups, mode)
        plan = plan._replace(rpt_n=rows, rpt_t=rows)
    else:
        plan = admm_fused.k1_plan(n, R, rs, B, lanes, groups, mode)._replace(rpt=rows)
    assert (plan.route, plan.lanes, plan.groups) == ("stream", lanes, groups)
    if narrow:
        plan = _narrow(plan, n, m - n, rs)
    _stream_held_to_plain(_lane_args(op, cfg, B, seed=B + lanes, single_index=single), plan)


def test_stream_route_refuses_a_layout_it_does_not_have(wide_controllers):
    """The stream route's C entries refuse (cudaError_t 1) rather than run
    on a wrong layout: shared-memory bytes that differ from their own, a
    lane count they have no instantiation for, more than 256 threads a
    block, rows a thread they have no instantiation for (K2 at 8, any at
    6), a streamed panel of fewer than 4 columns of a tile."""
    for which, launch in (("h50", admm_fused._launch_k1), ("h50-sc", admm_fused._launch_k2)):
        op, cfg = wide_controllers[which].engine.op, wide_controllers[which].engine.config
        args = _lane_args(op, cfg, 64, seed=6)
        m, n = (int(d) for d in op.A_s.shape)
        plan = (admm_fused.k2_plan(n, m, 5, 1, 64) if op.mixed_a
                else admm_fused.k1_plan(n, 5, 1, 64))
        bytes_of = lambda lanes, panel: admm_fused.k12_stream_smem_bytes(n, m - n, lanes, panel)
        thin = 4 * admm_fused.K12_PASS_ROWS * plan.groups
        rows = (lambda r: dict(rpt_n=r, rpt_t=r)) if op.mixed_a else (lambda r: dict(rpt=r))
        for wrong in (dict(smem_bytes=plan.smem_bytes + 16),
                      dict(lanes=12, smem_bytes=bytes_of(12, plan.panel)),
                      dict(lanes=8, groups=128, smem_bytes=bytes_of(8, plan.panel)),
                      rows(6), *([rows(8)] if op.mixed_a else []),
                      dict(panel=thin, smem_bytes=bytes_of(plan.lanes, thin))):
            with pytest.raises(RuntimeError, match="cudaError_t 1"):
                launch(*args, plan=plan._replace(**wrong))


def test_wide_solves_launch_the_stream_route(wide_controllers):
    """parallel.solve_batch_fused on the h50 default and state-box
    controllers raises no ValueError on the card: it launches K1 and K2
    (the stream route), no plain version, and agrees with the same solve
    on the CPU: about as many lanes converged (at eps 1e-6 some end at the
    iteration limit, which of them following the drivers' fp32 roundoff),
    u within 5e-4 where both converged."""
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(np.clip(0.65 + 0.1 * rng.standard_normal((128, 4)), 0.3, 1.3)
                          .astype(np.float32))
    for which, kernel in (("h50", "K1"), ("h50-sc", "K2")):
        ctrl = wide_controllers[which]
        launches, plain = admm_fused.LAUNCHES[kernel], dict(admm_fused.PLAIN_CALLS)
        s_gpu, _, _, d_gpu = parallel.solve_batch_fused(ctrl, x0.to(ctrl.device))
        torch.cuda.synchronize()
        assert admm_fused.LAUNCHES[kernel] > launches
        assert admm_fused.PLAIN_CALLS == plain
        s_cpu, _, _, d_cpu = parallel.solve_batch_fused(ctrl.to("cpu"), x0)
        assert abs(int(d_gpu.n_converged) - int(d_cpu.n_converged)) <= x0.shape[0] // 10
        both = (s_gpu.status.cpu() == 0) & (s_cpu.status == 0)
        assert int(both.sum()) >= 32
        np.testing.assert_allclose(s_gpu.u.cpu()[both].numpy(), s_cpu.u[both].numpy(), atol=5e-4)


@pytest.mark.parametrize("mode", MODES + ("hybrid",))
def test_fused_solve_on_card_matches_cpu(controllers, mode):
    """Tier 1's solve on the card against the CPU at each precision and the
    hybrid schedule (which launches bf16x3 and highest chunks)."""
    ctrl, _ = controllers
    ctrl = ctrl.replace(engine=dataclasses.replace(ctrl.engine, config=dataclasses.replace(
        ctrl.engine.config, kernel_precision=mode)))
    x0 = torch.from_numpy(_x0s(300, seed=9))
    launches = dict(admm_fused.LAUNCHES)
    s_gpu, _, _, d_gpu = parallel.solve_batch_fused(ctrl, x0.to(ctrl.device))
    ran = {k for k in launches if admm_fused.LAUNCHES[k] > launches[k]}
    assert _key("K1", "bf16x3" if mode == "hybrid" else mode) in ran
    cpu = ctrl.to("cpu")
    s_cpu, _, _, d_cpu = parallel.solve_batch_fused(cpu, x0)
    np.testing.assert_allclose(s_gpu.u.cpu().numpy(), s_cpu.u.numpy(), atol=5e-4)
    assert abs(int(d_gpu.n_converged) - int(d_cpu.n_converged)) <= 3


def test_cuda_tensor_raises_without_library(controllers, tmp_path, monkeypatch):
    """No fallback: with a broken kernel library a CUDA tensor raises and the
    plain version is not called."""
    bad = tmp_path / "libmpc_kernels.so"
    bad.write_bytes(b"not a shared library")
    # newer than every source and header, so that nothing rebuilds over it
    headers = glob.glob(os.path.join(_build.CSRC_DIR, "*.cuh"))
    future = max(os.path.getmtime(s) for s in _build._sources() + headers) + 60
    os.utime(bad, (future, future))
    monkeypatch.setattr(_build, "LIB_PATH", str(bad))
    monkeypatch.setattr(_build, "_lib", None)
    args = _chunk_args(controllers[0], 64, seed=3)
    launches, plain = admm_fused.LAUNCHES["K1"], admm_fused.PLAIN_CALLS["K1"]
    with pytest.raises(OSError):
        admm_fused.iterate_chunk_diag_T(*args)
    assert admm_fused.LAUNCHES["K1"] == launches and admm_fused.PLAIN_CALLS["K1"] == plain


def test_wrapper_checks_inputs(controllers):
    args = list(_chunk_args(controllers[0], 64, seed=4))
    args[5] = args[5].T.contiguous().T  # non-contiguous x
    with pytest.raises(ValueError):
        admm_fused.iterate_chunk_diag_T(*args)
    args = list(_chunk_args(controllers[0], 64, seed=4))
    args[4] = args[4].long()  # idx must be int32
    with pytest.raises(ValueError):
        admm_fused.iterate_chunk_diag_T(*args)


def _rows_first(c):
    """The controller's QP with its state and terminal rows above the
    input-box rows, on an operator built for that order (a dense A)."""
    dev = c.device
    c = c.to("cpu")
    qp = c.engine.qp
    m, n = qp.A.shape
    perm = np.r_[np.arange(n, m), np.arange(n)]
    qp = qp.replace(**{k: getattr(qp, k)[perm] for k in ("A", "l_const", "u_const", "b_x0")})
    l, u = qp.l_const.numpy(), qp.u_const.numpy()
    eq = np.isfinite(l) & np.isfinite(u) & (l == u)
    op = build_operator(qp.P.numpy(), qp.A.numpy(), eq, 0, c.engine.config)
    return c.replace(engine=LinearEngine(qp=qp, op=op, soft_mu=None, config=c.engine.config)).to(dev)


@pytest.fixture(scope="module")
def dense_controllers(card):
    """The dense cells' controllers: h20 equality terminal (K4, refine 1),
    h20 state box at tier 1's grid (K4, no refinement) and at the suite's
    (K5), and h50 state box (K5, its stream route)."""
    design = lambda N, cfg, **kw: _rows_first(proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control", N, 5.0,
        [0.65] * 4, [1.2] * 2, admm_config=cfg, device=card, **kw,
    ))
    suite = AdmmConfig(max_iter=1000)
    t1 = AdmmConfig(max_iter=1000, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0)
    return {
        "K4-eq-h20": design(20, suite, mpc_terminal_ingredient="equality"),
        "K4-sc-h20": design(20, t1, mpc_state_constraint=True),
        "K5-sc-h20": design(20, suite, mpc_state_constraint=True),
        "K5-sc-h50": design(50, suite, mpc_state_constraint=True),
    }


@pytest.mark.parametrize("B", [2048, 77])
@pytest.mark.parametrize("which", ["K4-eq-h20", "K4-sc-h20", "K5-sc-h20", "K5-sc-h50"])
def test_dense_kernels_match_plain_versions(dense_controllers, which, B):
    """K4 and K5 sum every product in the plain versions' order: equal to
    the last bit."""
    ctrl = dense_controllers[which]
    kernel = which[:2]
    cfg = ctrl.engine.config
    fn = admm_fused.chunk_fn_for(ctrl.engine.op, config=cfg)
    plain_fn = admm_fused.chunk_fn_for(ctrl.engine.op, plain=True, config=cfg)
    assert fn.__name__.startswith("iterate_chunk_dense_" + ("packed" if kernel == "K4" else "perr"))
    args = _chunk_args(ctrl, B, seed=B + len(which))
    launches, plain = admm_fused.LAUNCHES[kernel], admm_fused.PLAIN_CALLS[kernel]
    out_k = fn(*args)
    torch.cuda.synchronize()
    assert admm_fused.LAUNCHES[kernel] == launches + 1
    assert admm_fused.PLAIN_CALLS[kernel] == plain
    out_p = plain_fn(*args)
    for name, a, b in zip(("x", "s", "y", "ax"), out_k, out_p):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        assert float((a - b).abs().max()) == 0.0, name


@pytest.fixture(scope="module")
def k5_controllers(dense_controllers):
    """K5's controllers: the h20 state box (the shared route), its tier-2
    escalation (R = 4, refine 2) and the h50 state box (the stream
    route)."""
    h20 = dense_controllers["K5-sc-h20"]
    return {
        "h20": h20,
        "tier2": parallel.escalation_controller(
            h20, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250, refine_steps=2),
        "h50": dense_controllers["K5-sc-h50"],
    }


# (controller, B, one rho index for all lanes, forced k5_plan arguments):
# every shape of k3_ab.py's K5_SHAPES, random and single rho indices,
# ragged batches, and forced layouts and routes
K5_CASES = [
    ("h20", 2048, False, None), ("h20", 2048, True, None), ("h20", 1, False, None),
    ("h20", 33, False, None), ("h20", 77, False, None), ("h20", 1000, False, None),
    ("tier2", 512, False, None), ("tier2", 512, True, None),
    ("h50", 2048, False, None), ("h50", 2048, True, None),
    ("h50", 77, False, None), ("h50", 1, True, None),
    ("h20", 2048, False, dict(lanes=16, groups=20)), ("h20", 2048, True, dict(lanes=8, groups=40)),
    ("h20", 2048, False, dict(route="stream")), ("h20", 2048, True, dict(route="stream")),
    ("h20", 77, False, dict(route="stream")), ("h20", 1, False, dict(route="stream")),
    ("h20", 33, True, dict(route="stream")), ("tier2", 512, False, dict(route="stream")),
    ("h50", 2048, False, dict(lanes=8, groups=40)), ("h50", 1000, True, dict(lanes=4)),
    ("h50", 2048, True, dict(lanes=8, groups=32)), ("h50", 77, False, dict(lanes=8, groups=40)),
    ("h20", 1000, False, dict(route="stream")),
]


@pytest.mark.parametrize("which,B,single,force", K5_CASES)
@pytest.mark.parametrize("mode", MODES)
def test_k5_matches_plain_version(k5_controllers, which, B, single, force, mode):
    """K5 on the route and layout k5_plan picks (the shared route at h20,
    the stream route at h50), or a forced one, equals its plain version bit
    for bit at each precision; ragged batches reach every barrier."""
    ctrl = k5_controllers[which]
    args = _in_mode(_chunk_args(ctrl, B, seed=B + len(which), single_index=single), mode)
    op, cfg = args[0], args[-1]
    m, n = op.A_s.shape
    plan = admm_fused.k5_plan(n, m, int(op.rho_grid.shape[0]), int(cfg.refine_steps), B,
                              mode=mode, **(force or {}))
    assert plan.route == (force or {}).get("route", "stream" if which == "h50" else "shared")
    key = _key("K5", mode)
    launches, plain = admm_fused.LAUNCHES[key], admm_fused.PLAIN_CALLS[key]
    if force is None:
        out_k = admm_fused.iterate_chunk_dense_perr_T(*args)
    else:
        out_k = admm_fused._launch_k5(*args, plan=plan)
    torch.cuda.synchronize()
    assert admm_fused.LAUNCHES[key] == launches + 1
    assert admm_fused.PLAIN_CALLS[key] == plain
    out_p = admm_fused.iterate_chunk_dense_perr_T_plain(*args)
    for name, a, b in zip(("x", "s", "y", "ax"), out_k, out_p):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


def _synthetic_dense_op(base, n, m, R, seed):
    """A dense operator of any shape, made as build_operator makes one from
    P = I and a random A (no scaling): K_r = P + sigma I + A' diag(rho_r) A
    over R rho values, one row in four an equality row at 100 rho, K_r^-1
    in fp64; every array fp32 on base's device."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    grid = np.logspace(-1, 1, R)
    rho = grid[:, None] * np.where(np.arange(m) % 4 == 0, 100.0, 1.0)[None]
    A64 = A.astype(np.float64)
    K = np.eye(n) * (1 + 1e-6) + np.einsum("mi,rm,mj->rij", A64, rho, A64)
    dev = base.A_s.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    return base.replace(
        P_s=t(np.eye(n)), A_s=t(A), Ks=t(K), K_invs=t(np.linalg.inv(K)), rho_vecs=t(rho),
        rho_invs=t(1.0 / rho), rho_grid=t(grid), D=t(np.ones(n)), E=t(np.ones(m)), kia=None,
    )


@pytest.mark.parametrize("n,m,R,refine_steps,B,route", [
    (41, 77, 3, 2, 100, None), (41, 77, 3, 2, 100, "stream"),
    (7, 13, 1, 0, 33, None), (7, 13, 1, 0, 33, "stream"),
    (33, 120, 8, 0, 2048, None), (1, 1, 2, 1, 5, None), (1, 1, 2, 1, 5, "stream"),
    (127, 3, 4, 2, 64, None), (100, 301, 5, 1, 1000, None), (128, 512, 8, 1, 300, None),
])
@pytest.mark.parametrize("mode", MODES)
def test_k5_odd_shapes_match_plain_version(k5_controllers, n, m, R, refine_steps, B, route,
                                           mode):
    """K5 at shapes the QTP cells never give it, on both routes: odd n (the
    stream route's padded operator rows) and odd m (the tail row of each
    pair loop), one rho and eight, no refinement and two, a single
    variable and constraint row, and the widest shape k5_fits takes; equal
    to the plain version bit for bit at each precision."""
    op = _synthetic_dense_op(k5_controllers["h20"].engine.op, n, m, R, seed=n + m)
    dev = op.A_s.device
    rng = np.random.default_rng(B)
    f32 = lambda *shape, scale=0.05: torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)
    qT = f32(n, B, scale=1.0)
    lT = -f32(m, B, scale=0.5).abs() - 0.1
    uT = f32(m, B, scale=0.5).abs() + 0.1
    idx = torch.from_numpy(rng.integers(0, R, size=B).astype(np.int32)).to(dev)
    x, y, ax = f32(n, B), f32(m, B), f32(m, B)
    s = torch.clamp(ax, lT, uT).contiguous()
    cfg = AdmmConfig(refine_steps=refine_steps, kernel_precision=mode)
    args = (op, qT, lT, uT, idx, x, s, y, ax, 25, cfg)
    plan = admm_fused.k5_plan(n, m, R, refine_steps, B, route=route, mode=mode)
    out_k = admm_fused._launch_k5(*args, plan=plan)
    torch.cuda.synchronize()
    out_p = admm_fused.iterate_chunk_dense_perr_T_plain(*args)
    for name, a, b in zip(("x", "s", "y", "ax"), out_k, out_p):
        assert bool(torch.isfinite(b).all()), name
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (name, plan)


def test_k5_refuses_a_layout_it_does_not_have(k5_controllers):
    """The shared route's C entry refuses shared-memory bytes that differ
    from its own layout (cudaError_t 1) rather than run on a wrong one."""
    args = _chunk_args(k5_controllers["h20"], 64, seed=7)
    plan = admm_fused.k5_plan(40, 120, 5, 1, 64)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        admm_fused._launch_k5(*args, plan=plan._replace(smem_bytes=plan.smem_bytes + 16))


@pytest.fixture(scope="module")
def k4_controllers(card, dense_controllers):
    """K4's controllers: the h20 equality terminal (the shared route), its
    tier-2 escalation (R = 4, refine 2), the state box at tier 1's grid (no
    refinement) and the neighborhood terminal (m = 52, the stream route),
    each with its rows first."""
    eq = dense_controllers["K4-eq-h20"]
    return {
        "eq": eq,
        "tier2": parallel.escalation_controller(
            eq, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250, refine_steps=2),
        "sc-t1": dense_controllers["K4-sc-h20"],
        "nb": _rows_first(proceed_controller(
            qtp.linearized_discrete_system(), "model_predictive_control", 20, 5.0,
            [0.65] * 4, [1.2] * 2, admm_config=AdmmConfig(max_iter=1000), device=card,
            mpc_terminal_ingredient="neighborhood")),
    }


# (controller, B, one rho index for all lanes, forced k4_plan arguments):
# every shape of k3_ab.py's K4_SHAPES, random and single rho indices,
# ragged batches, and forced layouts and routes
K4_CASES = [
    ("eq", 2048, False, None), ("eq", 2048, True, None), ("eq", 1, False, None),
    ("eq", 33, False, None), ("eq", 77, False, None), ("eq", 77, True, None),
    ("eq", 1000, False, None), ("tier2", 512, False, None), ("tier2", 512, True, None),
    ("tier2", 33, False, None), ("sc-t1", 2048, False, None), ("sc-t1", 2048, True, None),
    ("sc-t1", 77, False, None), ("nb", 2048, False, None), ("nb", 2048, True, None),
    ("nb", 77, False, None), ("nb", 1, True, None), ("nb", 1000, False, None),
    ("eq", 2048, False, dict(lanes=16, groups=20)), ("eq", 2048, True, dict(lanes=4, groups=40)),
    ("sc-t1", 2048, False, dict(lanes=16, groups=20)), ("sc-t1", 1000, True, dict(lanes=4, groups=40)),
    ("eq", 2048, False, dict(route="stream")), ("eq", 77, True, dict(route="stream")),
    ("eq", 1, False, dict(route="stream")), ("tier2", 512, False, dict(route="stream")),
    ("sc-t1", 2048, False, dict(route="stream")), ("sc-t1", 33, True, dict(route="stream")),
    ("nb", 2048, False, dict(lanes=8, groups=20)), ("nb", 1000, True, dict(lanes=4)),
    ("nb", 2048, False, dict(panel=1000)), ("nb", 77, True, dict(panel=2000)),
    ("eq", 512, False, dict(route="stream", panel=800)),
]


@pytest.mark.parametrize("which,B,single,force", K4_CASES)
@pytest.mark.parametrize("mode", MODES)
def test_k4_matches_plain_version(k4_controllers, which, B, single, force, mode):
    """K4 on the route and layout k4_plan picks (the shared route at the
    equality terminal, its tier 2 and the state box at tier 1's grid, the
    stream route at the neighborhood terminal), or a forced one, equals its
    plain version bit for bit at each precision; ragged batches reach every
    barrier."""
    ctrl = k4_controllers[which]
    args = _in_mode(_chunk_args(ctrl, B, seed=B + len(which), single_index=single), mode)
    op, cfg = args[0], args[-1]
    m, n = op.A_s.shape
    R, rs = int(op.rho_grid.shape[0]), int(cfg.refine_steps)
    assert admm_fused.use_packed(n, m, R, rs)
    force = dict(force or {})
    panel = force.pop("panel", None)
    plan = admm_fused.k4_plan(n, m, R, rs, B, mode=mode, **force)
    assert plan.route == force.get("route", "stream" if which == "nb" else "shared")
    if panel is not None:  # operators streamed, not resident
        plan = plan._replace(panel=panel, smem_bytes=admm_fused.k5_stream_smem_bytes(
            m, plan.lanes, plan.groups, plan.rpt_n, plan.rpt_m, panel))
        assert not admm_fused.k4_resident(n, m, rs, panel)
    elif plan.route == "stream":
        assert admm_fused.k4_resident(n, m, rs, plan.panel)
    key = _key("K4", mode)
    launches, plain = admm_fused.LAUNCHES[key], admm_fused.PLAIN_CALLS[key]
    if not force and panel is None:
        out_k = admm_fused.iterate_chunk_dense_packed_T(*args)
    else:
        out_k = admm_fused._launch_k4(*args, plan=plan)
    torch.cuda.synchronize()
    assert admm_fused.LAUNCHES[key] == launches + 1
    assert admm_fused.PLAIN_CALLS[key] == plain
    out_p = admm_fused.iterate_chunk_dense_packed_T_plain(*args)
    for name, a, b in zip(("x", "s", "y", "ax"), out_k, out_p):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


@pytest.mark.parametrize("n,m,R,refine_steps,B,route", [
    (41, 77, 3, 2, 100, None), (41, 77, 3, 2, 100, "stream"),
    (7, 13, 1, 0, 33, None), (7, 13, 1, 0, 33, "stream"),
    (33, 120, 8, 0, 2048, None), (1, 1, 2, 1, 5, None), (1, 1, 2, 1, 5, "stream"),
    (127, 3, 4, 2, 64, None), (100, 301, 5, 1, 1000, None), (128, 512, 8, 1, 300, None),
])
@pytest.mark.parametrize("mode", MODES)
def test_k4_odd_shapes_match_plain_version(k5_controllers, n, m, R, refine_steps, B, route,
                                           mode):
    """K4 at shapes the QTP cells never give it, on both routes (as K5's
    odd shapes), with its packed image kia built as build_operator builds
    it; equal to the plain version bit for bit at each precision."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import packed_kia

    op = _synthetic_dense_op(k5_controllers["h20"].engine.op, n, m, R, seed=n + m)
    op = op.replace(kia=packed_kia(op.K_invs, op.A_s))
    dev = op.A_s.device
    rng = np.random.default_rng(B + 1)
    f32 = lambda *shape, scale=0.05: torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)
    qT = f32(n, B, scale=1.0)
    lT = -f32(m, B, scale=0.5).abs() - 0.1
    uT = f32(m, B, scale=0.5).abs() + 0.1
    idx = torch.from_numpy(rng.integers(0, R, size=B).astype(np.int32)).to(dev)
    x, y, ax = f32(n, B), f32(m, B), f32(m, B)
    s = torch.clamp(ax, lT, uT).contiguous()
    cfg = AdmmConfig(refine_steps=refine_steps, kernel_precision=mode)
    args = (op, qT, lT, uT, idx, x, s, y, ax, 25, cfg)
    plan = admm_fused.k4_plan(n, m, R, refine_steps, B, route=route, mode=mode)
    out_k = admm_fused._launch_k4(*args, plan=plan)
    torch.cuda.synchronize()
    out_p = admm_fused.iterate_chunk_dense_packed_T_plain(*args)
    for name, a, b in zip(("x", "s", "y", "ax"), out_k, out_p):
        assert bool(torch.isfinite(b).all()), name
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (name, plan)


def test_k4_refuses_a_layout_it_does_not_have(k4_controllers):
    """K4's C entries refuse shared-memory bytes that differ from their own
    layout (cudaError_t 1) rather than run on a wrong one."""
    args = _chunk_args(k4_controllers["eq"], 64, seed=7)
    for route in admm_fused.DENSE_ROUTES:
        plan = admm_fused.k4_plan(40, 44, 5, 1, 64, route=route)
        with pytest.raises(RuntimeError, match="cudaError_t 1"):
            admm_fused._launch_k4(*args, plan=plan._replace(smem_bytes=plan.smem_bytes + 16))


def test_dense_solve_auto_launches_k4(dense_controllers):
    """The dense h20 equality controller through solve_batch_auto: K4
    launches, no plain version runs, every lane converges, and the result
    agrees with the same solve on the CPU."""
    ctrl = dense_controllers["K4-eq-h20"]
    assert parallel.fused_supported(ctrl)
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(0.65 + 0.002 * rng.standard_normal((256, 4)).astype(np.float32))
    launches, plain = admm_fused.LAUNCHES["K4"], dict(admm_fused.PLAIN_CALLS)
    s_gpu, _, _, d_gpu = parallel.solve_batch_auto(ctrl, x0.to(ctrl.device))
    torch.cuda.synchronize()
    assert admm_fused.LAUNCHES["K4"] > launches
    assert admm_fused.PLAIN_CALLS == plain
    assert int(d_gpu.n_converged) == 256
    s_cpu, _, _, _ = parallel.solve_batch_auto(ctrl.to("cpu"), x0)
    assert torch.equal(s_gpu.status.cpu(), s_cpu.status)
    np.testing.assert_allclose(s_gpu.u.cpu().numpy(), s_cpu.u.numpy(), atol=5e-4)


# K4's and K5's wide route (csrc/admm_perr_wide.cu): (kernel, n, m, R,
# refine_steps, B, forced k4_plan / k5_plan arguments; "panel" a narrow
# panel of 4 columns of every product's tile, so that every product streams
# over several column panels). The QTP's equality terminal at h65 and its
# state box at h100 on the default config, the widest state box and
# equality terminal the JAX package fuses at tier 1's grid (h154, h228),
# the widest n (582) and the most rows (3839) it fuses, the (32, 1) plant's
# h20 state box on K4 (660 rows) and K4 with refinement and its image
# past 512 rows; odd n and m, one row, shapes the stream route takes
# forced onto the wide route; every lanes a block (1 to 64), every pass
# and product tile, every depth, clusters of 1 and 2 blocks (odd rows, a partial last cluster), one rho
# index for every lane ("single").
WIDE_CASES = [
    ("K5", 130, 134, 5, 1, 64, None), ("K5", 200, 600, 5, 1, 256, None),
    ("K5", 308, 924, 2, 0, 128, None), ("K5", 456, 460, 2, 0, 64, None),
    ("K5", 582, 583, 1, 0, 33, None), ("K5", 1, 3839, 1, 0, 40, None),
    ("K5", 129, 513, 3, 2, 77, None), ("K5", 41, 77, 3, 2, 100, dict(route="wide")),
    ("K5", 7, 13, 1, 0, 33, dict(route="wide")), ("K5", 1, 1, 2, 1, 5, dict(route="wide")),
    ("K5", 41, 77, 3, 2, 100, dict(route="wide", panel=True)),
    ("K5", 200, 204, 5, 1, 100, dict(lanes=1)), ("K5", 131, 700, 2, 1, 50, dict(lanes=2)),
    ("K5", 200, 600, 5, 1, 300, dict(lanes=32)), ("K5", 130, 134, 5, 1, 200, dict(lanes=64)),
    ("K5", 200, 204, 3, 1, 130, dict(lanes=4, depth=4, tiles=((2, 4), (2, 2)))),
    ("K5", 150, 300, 2, 2, 90, dict(lanes=8, depth=2, tiles=((4, 2), (4, 2)))),
    ("K5", 150, 300, 2, 1, 90, dict(lanes=8, tiles=((2, 2), (4, 2)), depth=3)),
    ("K5", 130, 200, 2, 1, 70, dict(lanes=16, tiles=((4, 1), (2, 4)), panel=True)),
    ("K5", 60, 100, 2, 1, 70, dict(route="wide", lanes=16, tiles=((2, 1), (4, 1)))),
    ("K5", 200, 600, 5, 1, 300, dict(lanes=32, cluster=2)),
    ("K5", 200, 600, 5, 1, 300, dict(lanes=16, cluster=1, single=True)),
    ("K5", 308, 924, 2, 0, 99, dict(cluster=2, single=True)),
    ("K5", 7, 13, 1, 0, 33, dict(route="wide", cluster=2)),
    ("K5", 41, 77, 3, 2, 100, dict(route="wide", cluster=2, panel=True)),
    ("K4", 20, 660, 2, 0, 2048, None), ("K4", 20, 660, 2, 1, 77, None),
    ("K4", 64, 3000, 1, 0, 64, None), ("K4", 3, 4000, 1, 2, 33, None),
    ("K4", 41, 77, 3, 2, 100, dict(route="wide")), ("K4", 7, 13, 1, 0, 33, dict(route="wide")),
    ("K4", 41, 77, 3, 2, 100, dict(route="wide", panel=True)),
    ("K4", 19, 801, 2, 0, 50, dict(lanes=1)),
    ("K4", 20, 660, 2, 0, 300, dict(lanes=16, cluster=1, depth=3)),
    ("K4", 20, 660, 2, 0, 300, dict(lanes=16, depth=4)),
    ("K4", 20, 660, 2, 1, 300, dict(lanes=32, tiles=((4, 4), (4, 4)))),
    ("K4", 40, 600, 3, 2, 99, dict(lanes=8, tiles=((2, 1), (4, 1)), depth=2)),
    ("K4", 20, 660, 2, 0, 77, dict(cluster=2)),
    ("K4", 20, 660, 2, 0, 2048, dict(cluster=2, single=True)),
    ("K4", 3, 4000, 1, 2, 33, dict(cluster=2)),
]


def _narrow_panel(plan, n, m, refine_steps, packed):
    """The plan with the narrowest fp64 panel its tiles allow: 4 columns of
    the tallest product's tile (and of the pass's, with y and s), a
    multiple of 8 doubles."""
    lay = admm_fused.wide_layout(n, m, refine_steps, plan.lanes, plan.tiles, plan.panel,
                                 packed, plan.cluster)
    need = max(g.ops * g.H * 6 + g.vecs * 4 * plan.lanes for g in lay.products if g)
    panel = -(-need // 8) * 8
    return plan._replace(panel=panel, smem_bytes=admm_fused.wide_smem_bytes(
        n, plan.lanes, panel, plan.depth))


def _wide_args(base, kernel, n, m, R, refine_steps, B, mode, seed, single_index=False):
    op = _synthetic_dense_op(base, n, m, R, seed=seed)
    if kernel == "K4":
        from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import packed_kia

        op = op.replace(kia=packed_kia(op.K_invs, op.A_s))
    cfg = AdmmConfig(refine_steps=refine_steps, kernel_precision=mode)
    return _lane_args(op, cfg, B, seed=seed + 1, single_index=single_index)


def _wide_held_to_plain(kernel, args, plan):
    """A chunk of K4 or K5 on the wide route against its plain version: one
    launch counted, no plain call, equal to the last bit."""
    assert plan.route == "wide"
    mode = args[-1].kernel_precision
    key = _key(kernel, mode)
    launches, plain = admm_fused.LAUNCHES[key], admm_fused.PLAIN_CALLS[key]
    launch = admm_fused._launch_k4 if kernel == "K4" else admm_fused._launch_k5
    out_k = launch(*args, plan=plan)
    torch.cuda.synchronize()
    assert admm_fused.LAUNCHES[key] == launches + 1
    assert admm_fused.PLAIN_CALLS[key] == plain
    plain_fn = (admm_fused.iterate_chunk_dense_packed_T_plain if kernel == "K4"
                else admm_fused.iterate_chunk_dense_perr_T_plain)
    _assert_equal_bits(out_k, plain_fn(*args), (kernel, mode, plan))


@pytest.mark.parametrize("kernel,n,m,R,refine_steps,B,force", WIDE_CASES)
@pytest.mark.parametrize("mode", MODES)
def test_wide_route_matches_plain_version(k5_controllers, kernel, n, m, R, refine_steps, B,
                                          force, mode):
    """K5 and K4 on the wide route, as k5_plan and k4_plan lay it out past
    the other routes' shapes (or forced onto it), against their plain
    versions bit for bit at each precision, with and without refinement,
    random rho indices (every block one index's lanes) and ragged
    batches."""
    force = dict(force or {})
    narrow = force.pop("panel", False)
    args = _wide_args(k5_controllers["h20"].engine.op, kernel, n, m, R, refine_steps, B, mode,
                      seed=n + m, single_index=force.pop("single", False))
    packed = kernel == "K4"
    plan = (admm_fused.k4_plan if packed else admm_fused.k5_plan)(
        n, m, R, refine_steps, B, mode=mode, **force)
    for key in ("lanes", "depth", "tiles", "cluster"):
        assert key not in force or getattr(plan, key) == force[key]
    if narrow:
        plan = _narrow_panel(plan, n, m, refine_steps, packed)
        lay = admm_fused.wide_layout(n, m, refine_steps, plan.lanes, plan.tiles, plan.panel,
                                     packed, plan.cluster)
        assert lay is not None and all(g.np > 1 for g in lay.products if g and g.cols > 4)
    _wide_held_to_plain(kernel, args, plan)


def test_wide_route_refuses_a_layout_it_does_not_have(k5_controllers):
    """The wide route's C entries refuse shared-memory bytes that differ
    from their own layout and shapes past their limits (cudaError_t 1)
    rather than run on a wrong one."""
    for kernel, launch in (("K5", admm_fused._launch_k5), ("K4", admm_fused._launch_k4)):
        args = _wide_args(k5_controllers["h20"].engine.op, kernel, 130, 600, 2, 1, 64,
                          "highest", seed=5)
        plan = (admm_fused.k4_plan if kernel == "K4" else admm_fused.k5_plan)(130, 600, 2, 1, 64)
        for wrong in (dict(smem_bytes=plan.smem_bytes + 16), dict(lanes=3), dict(lanes=128),
                      dict(rt_pass=8), dict(lt_pass=3), dict(rt=8), dict(lt=8), dict(depth=1),
                      dict(depth=5), dict(panel=0), dict(panel=plan.panel + 4),
                      dict(cluster=3), dict(cluster=0)):
            with pytest.raises(RuntimeError, match="cudaError_t 1"):
                launch(*args, plan=plan._replace(**wrong))


@pytest.fixture(scope="module")
def wide_dense_controllers(card):
    """The two dense controllers past the stream route's shapes, each with
    its rows first: the QTP's equality terminal at h65 on the default
    config (n = 130, m = 134: K5) and the (32, 1) plant's h20 state box at
    tier 1's grid (n = 20, m = 660: K4)."""
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big

    eq = _rows_first(proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control", 65, 5.0, [0.65] * 4,
        [1.2] * 2, admm_config=AdmmConfig(max_iter=1000), device=card,
        mpc_terminal_ingredient="equality"))
    plant = big.random_stable_system(32, 1, seed=0)
    sc = _rows_first(proceed_controller(
        plant, "model_predictive_control", 20, 5.0, [0.0] * 32, [0.0],
        admm_config=AdmmConfig(max_iter=1000, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0),
        device=card, mpc_state_constraint=True))
    return {"K5": eq, "K4": sc}


@pytest.mark.parametrize("kernel", ["K5", "K4"])
def test_wide_solves_launch_the_wide_route(wide_dense_controllers, kernel):
    """parallel.solve_batch_auto on the two controllers goes fused on the
    card (where solve_batch_fused raised ValueError before the wide route):
    it launches the kernel, no plain version, and equals the same solve
    with the plain version on the card (the two chunks are equal to the
    last bit, and so is every other step of the driver)."""
    ctrl = wide_dense_controllers[kernel]
    op = ctrl.engine.op
    m, n = (int(d) for d in op.A_s.shape)
    R, rs = int(op.rho_grid.shape[0]), int(ctrl.engine.config.refine_steps)
    assert admm_fused.use_packed(n, m, R, rs) is (kernel == "K4")
    assert (admm_fused.k4_plan if kernel == "K4" else admm_fused.k5_plan)(
        n, m, R, rs, 64).route == "wide"
    assert parallel.fused_supported(ctrl)
    nx = int(ctrl.tuning.references.x.shape[0])
    rng = np.random.default_rng(0)
    base = 0.65 if nx == 4 else 0.0
    x0 = torch.from_numpy((base + 0.01 * rng.standard_normal((64, nx))).astype(np.float32))
    x0 = x0.to(ctrl.device)
    launches, plain = admm_fused.LAUNCHES[kernel], dict(admm_fused.PLAIN_CALLS)
    s_k, _, _, _ = parallel.solve_batch_auto(ctrl, x0)
    torch.cuda.synchronize()
    assert admm_fused.LAUNCHES[kernel] > launches
    assert admm_fused.PLAIN_CALLS == plain
    assert bool(torch.isfinite(s_k.u).all())
    plain_fn = admm_fused.chunk_fn_for(op, plain=True, config=ctrl.engine.config)
    s_p, _, _, _ = parallel.solve_batch_fused(ctrl, x0, chunk_fn=plain_fn)
    assert torch.equal(s_k.status, s_p.status)
    assert torch.equal(s_k.u, s_p.u)


RICCATI_BRANCHES = {
    "none": dict(),
    "state": dict(mpc_state_constraint=True),
    "contractive": dict(mpc_terminal_ingredient="contractive"),
    "equality": dict(mpc_terminal_ingredient="equality"),
}


@pytest.fixture(scope="module")
def riccati_controllers(card):
    """h12 Riccati controllers on the card, one per branch of K3."""
    return {
        k: proceed_controller(
            qtp.linearized_discrete_system(), "model_predictive_control", 12, 5.0,
            [0.65] * 4, [1.2] * 2, engine="riccati", device=card, **kw,
        )
        for k, kw in RICCATI_BRANCHES.items()
    }


def _riccati_args(ctrl, B, seed):
    return _op_args(ctrl.engine.op, ctrl.device, B, seed)


def _op_args(op, dev, B, seed):
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy((0.05 * rng.standard_normal(shape)).astype(np.float32)).to(dev)
    N, nx, nu = op.N, op.nx, op.nu
    e0T = 2.0 * t(nx, B)
    ridx = torch.tensor([int(rng.integers(0, len(op.rho_grid)))], dtype=torch.int32, device=dev)
    ballr = riccati.ball_radius(op, e0T)
    return op, ridx, e0T, ballr, t(N + 1, nx, B), t(N, nu, B), t(N + 1, nx, B), t(N, nu, B)


def _synthetic_op(N, nx, nu, branch, dev, seed=0):
    """A Riccati operator of a seeded stable plant (nx, nu) at horizon N, on
    one branch of K3: any horizon and width, with no controller design."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nx, nx))
    A *= 0.95 / np.abs(np.linalg.eigvals(A)).max()
    kind = branch if branch in ("contractive", "equality") else "none"
    op = riccati.build_riccati_operator(
        A, 0.5 * rng.standard_normal((nx, nu)), np.eye(nx), 0.5 * np.eye(nu), 2.0 * np.eye(nx),
        N, -np.ones(nx), np.ones(nx), -0.5 * np.ones(nu), 0.5 * np.ones(nu),
        state_constraint=branch == "state", terminal_kind=kind,
    )
    return op.to(dev)


def _assert_k3_equals_plain(args, route=None):
    """One K3 launch (on ``route``, or as the plan lays it out) against the
    plain version: equal to the last bit."""
    launches, plain = admm_fused.LAUNCHES["K3"], admm_fused.PLAIN_CALLS["K3"]
    out_k = riccati_fused._launch_k3(*args, route=route)
    torch.cuda.synchronize()
    assert admm_fused.LAUNCHES["K3"] == launches + 1
    assert admm_fused.PLAIN_CALLS["K3"] == plain
    out_p = riccati_fused.iterate_chunk_riccati_plain(*args)
    for name, a, b in zip(("X", "U", "vX", "vU", "lamX", "lamU"), out_k, out_p):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


@pytest.mark.parametrize("branch", list(RICCATI_BRANCHES))
@pytest.mark.parametrize("B", [1024, 77])
def test_k3_matches_plain_version(riccati_controllers, branch, B):
    """K3 and its plain version form the same fp64 sums in the same order
    and round the same way: equal to the last bit."""
    op, ridx, e0T, ballr, vX, vU, lamX, lamU = _riccati_args(riccati_controllers[branch], B, B)
    args = (op, ridx, e0T, ballr, vX, vU, lamX, lamU, 25)
    launches, plain = admm_fused.LAUNCHES["K3"], admm_fused.PLAIN_CALLS["K3"]
    out_k = riccati_fused.iterate_chunk_riccati(*args)
    torch.cuda.synchronize()
    assert admm_fused.LAUNCHES["K3"] == launches + 1
    assert admm_fused.PLAIN_CALLS["K3"] == plain
    out_p = riccati_fused.iterate_chunk_riccati_plain(*args)
    for name, a, b in zip(("X", "U", "vX", "vU", "lamX", "lamU"), out_k, out_p):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        assert float((a - b).abs().max()) == 0.0, name


@pytest.mark.parametrize("branch", list(RICCATI_BRANCHES))
@pytest.mark.parametrize("route", list(riccati_fused.K3_ROUTES))
def test_k3_routes_match_plain_version(riccati_controllers, route, branch):
    """Every route of the plan, forced at a shape all of them take, with a
    partial last block (33 lanes)."""
    args = _riccati_args(riccati_controllers[branch], 33, 7) + (25,)
    assert riccati_fused.k3_plan(args[0], 33, route).route == route
    _assert_k3_equals_plain(args, route)


@pytest.mark.parametrize("branch", list(RICCATI_BRANCHES))
@pytest.mark.parametrize("B", [1, 33, 1000])
@pytest.mark.parametrize("N", [1, 2, 50])
def test_k3_short_horizons_and_ragged_batches(card, N, B, branch):
    op = _synthetic_op(N, 4, 2, branch, card, seed=N)
    _assert_k3_equals_plain(_op_args(op, card, B, N + B) + (3 if N == 50 else 25,))


@pytest.mark.parametrize("route", list(riccati_fused.K3_ROUTES))
@pytest.mark.parametrize("nx,nu", [(8, 4), (16, 8), (3, 1), (7, 3), (32, 16), (20, 9)])
def test_k3_wider_plants_match_plain_version(card, nx, nu, route):
    """The (8, 4), (16, 8) and (32, 16) register tiers, and plants narrower
    than their tier (padded factors), on every route."""
    op = _synthetic_op(12, nx, nu, "state", card, seed=nx)
    _assert_k3_equals_plain(_op_args(op, card, 77, nx + nu) + (5,), route)


def _assert_certificate_equals_plain(op, dev, B, seed, tile=None):
    _, _, e0T, ballr, lamX0, lamU0, lamX1, lamU1 = _op_args(op, dev, B, seed)
    X = riccati.rollout_warm(op, e0T, lamU1)
    args = (op, lamX1, lamX0, lamU1, lamU0, X, ballr)
    terms = riccati_fused._launch_certificate(*args, tile=tile)
    torch.cuda.synchronize()
    want = riccati_fused.certificate_terms_plain(*args)
    # the adjoint and max|dlam| in the same order; the support's long
    # fp64 sums in another order, each rounded once
    assert torch.equal(terms[0], want[0]) and torch.equal(terms[2], want[2])
    finite = torch.isfinite(want[1])
    assert torch.equal(torch.isfinite(terms[1]), finite)
    err = (terms[1][finite] - want[1][finite]).abs()
    assert bool((err <= 1e-6 * want[1][finite].abs().clamp_min(1.0)).all())


@pytest.mark.parametrize("branch", list(RICCATI_BRANCHES))
@pytest.mark.parametrize("N,B,tile", [(1, 1, None), (2, 33, 1), (50, 1000, None), (50, 33, 7)])
def test_certificate_horizons_batches_and_tiles(card, N, B, tile, branch):
    """The certificate kernel at short horizons, ragged batches and tiles
    that do not divide the horizon."""
    _assert_certificate_equals_plain(_synthetic_op(N, 4, 2, branch, card, seed=N), card, B, N + B, tile)


@pytest.mark.parametrize("nx,nu", [(8, 4), (16, 8), (3, 1), (32, 16), (20, 9)])
def test_certificate_wider_plants(card, nx, nu):
    _assert_certificate_equals_plain(_synthetic_op(12, nx, nu, "state", card, seed=nx), card, 77, nx, tile=5)


def test_recurrence_kernels_match_plain_versions(riccati_controllers):
    for branch, ctrl in riccati_controllers.items():
        op, _, e0T, ballr, lamX0, lamU0, lamX1, lamU1 = _riccati_args(ctrl, 300, 5)
        X = riccati_fused.rollout(op, e0T, lamU1)
        torch.cuda.synchronize()
        assert torch.equal(X, riccati.rollout_warm(op, e0T, lamU1)), branch
        terms = riccati_fused.certificate_terms(op, lamX1, lamX0, lamU1, lamU0, X, ballr)
        want = riccati_fused.certificate_terms_plain(op, lamX1, lamX0, lamU1, lamU0, X, ballr)
        # the adjoint and max|dlam| in the same order; the support's long
        # fp64 sums in another order, each rounded once
        assert torch.equal(terms[0], want[0]) and torch.equal(terms[2], want[2]), branch
        finite = torch.isfinite(want[1])
        assert torch.equal(torch.isfinite(terms[1]), finite), branch
        err = (terms[1][finite] - want[1][finite]).abs()
        assert bool((err <= 1e-6 * want[1][finite].abs().clamp_min(1.0)).all()), branch


def test_riccati_solve_auto_launches_k3(riccati_controllers):
    """A Riccati controller through solve_batch_auto: K3 and both
    recurrence kernels launch, no plain version runs, and the result
    agrees with the same solve on the CPU."""
    ctrl = riccati_controllers["state"]
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(np.clip(0.65 + 0.1 * rng.standard_normal((256, 4)), 0.3, 1.3).astype(np.float32))
    launches, plain = dict(admm_fused.LAUNCHES), dict(admm_fused.PLAIN_CALLS)
    s_gpu, _, _, d_gpu = parallel.solve_batch_auto(ctrl, x0.to(ctrl.device))
    torch.cuda.synchronize()
    for key in ("K3", "rollout", "certificate"):
        assert admm_fused.LAUNCHES[key] > launches[key], key
    assert admm_fused.PLAIN_CALLS == plain
    s_cpu, _, _, d_cpu = parallel.solve_batch_auto(ctrl.to("cpu"), x0)
    assert torch.equal(s_gpu.status.cpu(), s_cpu.status)
    np.testing.assert_allclose(s_gpu.u.cpu().numpy(), s_cpu.u.numpy(), atol=5e-4)


def test_per_lane_riccati_engine_on_k3_equals_its_plain_version(card):
    """The per-lane Riccati engine at h50 (state box, the rho rule at every
    check, so that lanes split over the grid): its K3 launches, one per rho
    with open lanes a check, against the same engine with K3's plain
    version on the card. K3 equals its plain version bit for bit and the
    rest of the two runs is the same code, so the solves are equal."""
    ctrl = proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control", 50, 5.0,
        [0.65] * 4, [1.2] * 2, engine="riccati", mpc_state_constraint=True, device=card,
        riccati_config=riccati.RiccatiConfig(max_iter=1000, adapt_interval=25),
    )
    op, cfg = ctrl.engine.op, ctrl.engine.config
    rng = np.random.default_rng(7)
    x0 = np.clip(0.65 + 0.15 * rng.standard_normal((200, 4)), 0.3, 1.3)
    e0s = torch.from_numpy((x0 - 0.65).astype(np.float32)).to(card)
    groups = []

    def k3(op, ridx, e0T, *rest):
        groups.append(int(e0T.shape[1]))
        return riccati_fused.iterate_chunk_riccati(op, ridx, e0T, *rest)

    launches, plain = dict(admm_fused.LAUNCHES), dict(admm_fused.PLAIN_CALLS)
    out_k = riccati_fused.solve_sparse(op, e0s, config=cfg, chunk_fn=k3)
    torch.cuda.synchronize()
    assert admm_fused.LAUNCHES["K3"] - launches["K3"] == len(groups)
    assert admm_fused.PLAIN_CALLS == plain
    assert min(groups) < 200  # lanes on more than one rho in some check
    out_p = riccati_fused.solve_sparse(op, e0s, config=cfg,
                                       chunk_fn=riccati_fused.iterate_chunk_riccati_plain)
    assert bool((out_k[2] == 0).all())
    for name, a, b in zip(("X", "U", "status", "iterations"), out_k[:4], out_p[:4]):
        assert torch.equal(a, b), name


# ------------------------------------------------ learned plants and the SQP


def _golden_fnn(dev):
    """The frozen golden fnn (tests/golden/qtp_nl_golden.npz) on ``dev``."""
    from automationlabsmodelpredictivecontrol_jl_torch import interop
    from automationlabsmodelpredictivecontrol_jl_torch.models import zoo
    from automationlabsmodelpredictivecontrol_jl_torch.systems import NeuralDiscreteSystem

    flat = np.load(os.path.join(os.path.dirname(__file__), "golden", "qtp_nl_golden.npz"))["fnn_params"]
    apply_fn, act = zoo.make_apply("fnn")
    return NeuralDiscreteSystem(
        apply_fn=apply_fn, family="fnn", nx=4, nu=2,
        params=interop.unravel_params("fnn", 4, 2, 8, 1, flat),
        X=qtp.x_box(), U=qtp.u_box(), activation=act,
    ).to(dev)


@pytest.mark.parametrize("shooting", ["single", "multiple"])
def test_sqp_fleet_on_the_card_matches_the_cpu(card, shooting):
    """The SQP over 16 lanes of suite config 3's states on the card and on
    the CPU: statuses equal on at least 15 lanes, u within 1e-3 where both
    converged (the line search's ties follow each device's roundoff)."""
    from automationlabsmodelpredictivecontrol_jl_torch import SqpConfig

    plant = _golden_fnn("cpu")
    it = 8 if shooting == "single" else 12
    c = proceed_controller(plant, "model_predictive_control", 10, 5.0, [0.65] * 4, [1.2] * 2,
                           sqp_config=SqpConfig(shooting=shooting, max_sqp_iter=it), device=card)
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(np.clip(0.65 + 0.05 * rng.standard_normal((16, 4)), 0.3, 1.3)
                          .astype(np.float32))
    s_card, _, _, d = parallel.solve_batch(c, x0.to(card))
    s_cpu, _, _, _ = parallel.solve_batch(c.to("cpu"), x0)
    assert s_card.u.is_cuda and int(d.n_converged) == 16
    st_card, st_cpu = s_card.status.cpu(), s_cpu.status
    assert int((st_card == st_cpu).sum()) >= 15
    both = (st_card == 0) & (st_cpu == 0)
    assert float((s_card.u.cpu() - s_cpu.u).abs()[both].max()) <= 1e-3


@pytest.mark.parametrize("family", ["fnn", "icnn", "resnet", "densenet", "rbf", "polynet",
                                    "neuralode", "rknn1", "rknn2", "rknn4", "rnn", "gru", "lstm"])
def test_zoo_forward_and_jacobian_on_the_card(card, family):
    """Each family's forward and jacfwd linearization on the card against
    the CPU, in IEEE fp32 (1e-5 of max(1, |CPU|))."""
    from automationlabsmodelpredictivecontrol_jl_torch import systems
    from automationlabsmodelpredictivecontrol_jl_torch.models import zoo

    sys_cpu = zoo.make_system(family, 3, 4, 2, qtp.x_box(), qtp.u_box(), hidden=8, depth=2,
                              sample_time=0.5)
    sys_card = sys_cpu.to(card)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0.2, 1.2, (64, 4)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(0.0, 3.0, (64, 2)).astype(np.float32))
    ref = sys_cpu.step(x, u)
    out = sys_card.step(x.to(card), u.to(card)).cpu()
    assert float((out - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))
    for a, b in zip(systems.linearize(sys_card, x[0].to(card), u[0].to(card)),
                    systems.linearize(sys_cpu, x[0], u[0])):
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("B", [1, 256])
def test_wide_riccati_plant_on_k3(card, B):
    """A Riccati controller on an (nx 32, nu 16) plant, K3's widest tier:
    solve_batch_auto launches the chunk the routing table picks for the
    tier at this batch (K3W; never K3) and the two recurrence kernels the
    recurrence table picks (the wide ones; never K3's), runs no plain
    version, and agrees with the same solve on the CPU; K3's rollout, still
    built at the tier, equals its plain version there."""
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big

    design = lambda dev: proceed_controller(
        big.random_stable_system(32, 16, seed=0), "model_predictive_control", 10, 1.0,
        np.zeros(32, np.float32), np.zeros(16, np.float32), mpc_Q=10.0, mpc_R=0.1,
        engine="riccati", riccati_config=riccati.RiccatiConfig(max_iter=1000), device=dev)
    ctrl, ctrl_cpu = design(card), design("cpu")
    rng = np.random.default_rng(B)
    x0 = torch.from_numpy(np.clip(0.4 * rng.standard_normal((B, 32)), -0.95, 0.95).astype(np.float32))
    assert riccati_fused.chunk_kernel(ctrl.engine.op) == "K3W"
    launches, plain = dict(admm_fused.LAUNCHES), dict(admm_fused.PLAIN_CALLS)
    s_gpu, _, _, d_gpu = parallel.solve_batch_auto(ctrl, x0.to(card))
    torch.cuda.synchronize()
    keys, others = ("rollout", "certificate"), ("rollout-wide", "certificate-wide")
    if riccati_fused.recurrence_kernel(ctrl.engine.op) == "wide":
        keys, others = others, keys
    for key in ("K3W", *keys):
        assert admm_fused.LAUNCHES[key] > launches[key], key
    for key in ("K3", *others):
        assert admm_fused.LAUNCHES[key] == launches[key], key
    assert admm_fused.PLAIN_CALLS == plain
    s_cpu, _, _, d_cpu = parallel.solve_batch_auto(ctrl_cpu, x0)
    assert int(d_gpu.n_converged) == int(d_cpu.n_converged) == B
    assert torch.equal(s_gpu.status.cpu(), s_cpu.status)
    assert float((s_gpu.u.cpu() - s_cpu.u).abs().max()) <= 1e-4
    op = ctrl.engine.op
    e0T = (x0.to(card) - ctrl.tuning.references.x[:, 0]).T.contiguous()
    U = torch.from_numpy((0.05 * rng.standard_normal((op.N, 16, B))).astype(np.float32)).to(card)
    assert torch.equal(riccati_fused.rollout(op, e0T, U), riccati.rollout_warm(op, e0T, U))


# ------------------------------- K3W: plants of any width, the doubling sweeps


def _assert_k3w_equals_plain(args, doubling, route=None):
    """One K3W launch (sequential or doubling, on ``route`` or as
    k3w_plan lays it out) against its plain version: equal to the last
    bit."""
    key = "K3W-doubling" if doubling else "K3W"
    launches, plain = admm_fused.LAUNCHES[key], admm_fused.PLAIN_CALLS[key]
    out_k = riccati_fused._launch_k3w(*args, doubling=doubling, route=route)
    torch.cuda.synchronize()
    assert admm_fused.LAUNCHES[key] == launches + 1
    assert admm_fused.PLAIN_CALLS[key] == plain
    plain_fn = (riccati_fused.iterate_chunk_riccati_doubling_plain if doubling
                else riccati_fused.iterate_chunk_riccati_plain)
    out_p = plain_fn(*args)
    for name, a, b in zip(("X", "U", "vX", "vU", "lamX", "lamU"), out_k, out_p):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


@pytest.mark.parametrize("route", ["shared", "device", "global"])
@pytest.mark.parametrize("N,nx,nu,B,chunk", [(1, 4, 2, 1, 25), (2, 4, 2, 33, 25), (5, 4, 2, 77, 25),
                                              (24, 4, 2, 130, 5), (10, 40, 20, 8, 3),
                                              (6, 64, 32, 3, 2)])
@pytest.mark.parametrize("branch", list(RICCATI_BRANCHES))
@pytest.mark.parametrize("doubling", [False, True])
def test_k3w_matches_plain_version(card, doubling, branch, N, nx, nu, B, chunk, route):
    """K3W in both forms on every branch, at horizons that are not powers
    of two and N = 1 (the backward levels run in reversed time), ragged
    batches and plants past K3's (32, 16), on each route: the lanes' state
    in shared memory, in device memory, and with the work area (the
    sequential form's step vectors, the doubling form's horizon buffers)
    in device memory too."""
    op = _synthetic_op(N, nx, nu, branch, card, seed=N + nx)
    _assert_k3w_equals_plain(_op_args(op, card, B, N + B) + (chunk,), doubling, route)


# layouts of K3W's doubling form: (route, ring, lanes a block, lanes a
# thread): every lane count, tile, ring and route
K3W_DBL_FORCED = [("shared", 3, 1, 1), ("shared", 2, 2, 2), ("device", 3, 4, 4),
                  ("device", 2, 8, 8), ("global", 3, 16, 8), ("global", 2, 32, 4),
                  ("shared", 3, 8, 1), ("device", 3, 32, 2), ("shared", 0, 1, 1),
                  ("device", 0, 8, 8), ("global", 0, 4, 2)]


@pytest.mark.parametrize("route,ring,lanes,lt", K3W_DBL_FORCED)
@pytest.mark.parametrize("N,nx,nu,B", [(1, 4, 2, 5), (5, 4, 2, 33), (24, 4, 2, 130), (9, 4, 1, 17), (7, 5, 3, 77),
                                        (12, 40, 20, 33), (6, 64, 32, 9), (3, 3, 7, 33)])
@pytest.mark.parametrize("branch", list(RICCATI_BRANCHES))
def test_k3w_doubling_layouts_match_plain_version(card, branch, N, nx, nu, B, route, ring, lanes,
                                                  lt):
    """K3W's doubling form on every layout k3w_plan can choose (the work
    area and the lanes' state in shared memory, the state in device memory,
    both in device memory; rings of 2 and 3 panels, and none (the operators
    read where they lie); 1 to 32 lanes a block,
    tiles of 1 to 8 lanes; partial last blocks), at widths whose rows are
    not a multiple of the tile's 4 and nu > 4 (s in its own buffer), on
    every branch, and with a panel of one step (the ring refilled every
    step): equal to its plain version to the last bit. (4, 2) takes the
    kernel's QTP instantiation (bulk copies), the other widths the general
    one."""
    op = _synthetic_op(N, nx, nu, branch, card, seed=N + nx + nu + lanes)
    args = _op_args(op, card, B, N + B + lanes) + (3,)
    try:
        plan = riccati_fused.k3w_plan(op, B, True, route, lanes=lanes, ring=ring,
                                      lanes_per_thread=lt)
    except ValueError:
        pytest.skip(f"the layout does not fit N={N}, nx={nx}, nu={nu}")
    step = -(-riccati_fused.k3w_dbl_step(nx, nu) // 4) * 4  # one step of the widest stream
    plans = [plan]
    if ring:  # and a panel of one step
        plans.append(riccati_fused.k3w_plan(op, B, True, route, lanes=lanes, ring=ring,
                                            lanes_per_thread=lt, panel=step))
    for p in plans:
        launches = admm_fused.LAUNCHES["K3W-doubling"]
        out_k = riccati_fused._launch_k3w(*args, doubling=True, plan=p)
        torch.cuda.synchronize()
        assert admm_fused.LAUNCHES["K3W-doubling"] == launches + 1
        out_p = riccati_fused.iterate_chunk_riccati_doubling_plain(*args)
        for name, a, b in zip(("X", "U", "vX", "vU", "lamX", "lamU"), out_k, out_p):
            assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (name, p)


@pytest.mark.parametrize("branch", list(RICCATI_BRANCHES))
@pytest.mark.parametrize("B", [1024, 1])
def test_k3w_doubling_at_h500_matches_plain_version(card, B, branch):
    """K3W's doubling form at the QTP's width and h500 (9 combine levels a
    sweep, several panels a level at B = 1024) as k3w_plan lays it out for
    the riccati-h500-B1024-doubling cell and for the runtime's step, on
    every branch: equal to its plain version to the last bit."""
    op = _synthetic_op(500, 4, 2, branch, card, seed=500 + B)
    _assert_k3w_equals_plain(_op_args(op, card, B, B) + (25,), True)


# every layout of K3W's sequential form: (route, ring, lanes a block)
K3W_SEQ_FORCED = [("shared", 3, None), ("shared", 2, 8), ("device", 3, None), ("device", 2, 4),
                  ("device", 0, 32), ("global", 0, None), ("global", 0, 16)]


@pytest.mark.parametrize("route,ring,lanes", K3W_SEQ_FORCED)
@pytest.mark.parametrize("N,nx,nu,B", [(1, 4, 2, 5), (7, 5, 3, 77), (12, 32, 16, 130),
                                        (6, 64, 32, 9), (3, 3, 7, 33)])
@pytest.mark.parametrize("branch", list(RICCATI_BRANCHES))
def test_k3w_sequential_layouts_match_plain_version(card, branch, N, nx, nu, B, route, ring,
                                                    lanes):
    """K3W's sequential form on every layout k3w_plan has (the lanes' state
    in shared memory, in the outputs, or with the step's vectors in a
    device scratch; rings of 3, 2 and no steps; the plant in and out of
    shared memory), forced lanes a block and partial last blocks, at widths
    whose rows are not multiples of 4 (4-byte copies) and nu > nx, on every
    branch: equal to its plain version to the last bit."""
    op = _synthetic_op(N, nx, nu, branch, card, seed=N + nx + nu)
    args = _op_args(op, card, B, N + B + nu) + (3,)
    try:
        plan = riccati_fused.k3w_plan(op, B, False, route, lanes=lanes, ring=ring)
    except ValueError:
        pytest.skip(f"the layout does not fit N={N}, nx={nx}, nu={nu}")
    assert plan.route == route and plan.ring == ring
    launches = admm_fused.LAUNCHES["K3W"]
    out_k = riccati_fused._launch_k3w(*args, plan=plan)
    torch.cuda.synchronize()
    assert admm_fused.LAUNCHES["K3W"] == launches + 1
    out_p = riccati_fused.iterate_chunk_riccati_plain(*args)
    for name, a, b in zip(("X", "U", "vX", "vU", "lamX", "lamU"), out_k, out_p):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


@pytest.mark.parametrize("B", [2048, 256, 1])
def test_k3w_at_its_plans_matches_plain_version_and_k3(card, B):
    """K3W's sequential form at the (32, 16) plant's h30 shape as k3w_plan
    lays it out for the riccati-wide-nx32 cell's B = 2048, 256 and 1: equal
    to its plain version and to K3 on the same inputs, bit for bit; and at
    (64, 32) h30, B = 1024 (the nx64 cell) to its plain version."""
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big

    c = proceed_controller(
        big.random_stable_system(32, 16, seed=0), "model_predictive_control", 30, 1.0,
        np.zeros(32, np.float32), np.zeros(16, np.float32), mpc_Q=10.0, mpc_R=0.1,
        engine="riccati", device=card)
    args = _op_args(c.engine.op, card, B, B) + (25,)
    out_w = riccati_fused._launch_k3w(*args)
    out_3 = riccati_fused._launch_k3(*args)
    out_p = riccati_fused.iterate_chunk_riccati_plain(*args)
    torch.cuda.synchronize()
    for name, w, k3, p in zip(("X", "U", "vX", "vU", "lamX", "lamU"), out_w, out_3, out_p):
        assert bool(torch.isfinite(w).all()), name
        assert torch.equal(w.view(torch.int32), p.view(torch.int32)), name
        assert torch.equal(w.view(torch.int32), k3.view(torch.int32)), name
    if B == 256:
        op = _synthetic_op(30, 64, 32, "none", card, seed=64)
        _assert_k3w_equals_plain(_op_args(op, card, 1024, 5) + (25,), False)


def _assert_wide_recurrences_equal_plain(op, dev, B, seed, force=None):
    """The wide rollout and certificate as their plans lay them out (or as
    ``force``, wide_recurrence_plan's keywords, forces both) against their
    plain versions."""
    _, _, e0T, ballr, lamX0, lamU0, lamX1, lamU1 = _op_args(op, dev, B, seed)
    launches = dict(admm_fused.LAUNCHES)
    if force is None:
        X = riccati_fused.rollout_wide(op, e0T, lamU1)
    else:
        plan = riccati_fused.wide_recurrence_plan(op, B, "rollout", **force)
        X = riccati_fused._launch_rollout_wide(op, e0T, lamU1, plan=plan)
    args = (op, lamX1, lamX0, lamU1, lamU0, X, ballr)
    if force is None:
        terms = riccati_fused.certificate_terms_wide(*args)
    else:
        plan = riccati_fused.wide_recurrence_plan(op, B, "certificate", **force)
        terms = riccati_fused._launch_certificate_wide(*args, plan=plan)
    torch.cuda.synchronize()
    for key in ("rollout-wide", "certificate-wide"):
        assert admm_fused.LAUNCHES[key] == launches[key] + 1, key
    assert torch.equal(X.view(torch.int32), riccati.rollout_warm(op, e0T, lamU1).view(torch.int32))
    want = riccati_fused.certificate_terms_plain(*args)
    # the adjoint and max|dlam| in the same order; the support's long fp64
    # sums in another order, each rounded once
    assert torch.equal(terms[0], want[0]) and torch.equal(terms[2], want[2])
    finite = torch.isfinite(want[1])
    assert torch.equal(torch.isfinite(terms[1]), finite)
    err = (terms[1][finite] - want[1][finite]).abs()
    assert bool((err <= 1e-6 * want[1][finite].abs().clamp_min(1.0)).all())


_WIDE_OPS = {}


def _wide_op(N, nx, nu, branch, dev):
    """_synthetic_op, designed once per shape and branch in the module."""
    key = (N, nx, nu, branch)
    if key not in _WIDE_OPS:
        _WIDE_OPS[key] = _synthetic_op(N, nx, nu, branch, dev, seed=nx)
    return _WIDE_OPS[key]


# wide_recurrence_plan's keywords: the plan's own layout, each placement of
# A and B, the lane buffers in a device scratch, and each register tile at
# lanes that leave the batches a partial last block
WIDE_REC_FORCED = {
    "plan": None,
    "fp64": dict(place="fp64"),
    "fp32": dict(place="fp32"),
    "global": dict(place="global"),
    "device": dict(route="device"),
    "tile11-x4": dict(lanes=4, rows_per_thread=1, lanes_per_thread=1),
    "tile11-x32": dict(lanes=32, rows_per_thread=1, lanes_per_thread=1),
    "tile22-x2": dict(lanes=2, rows_per_thread=2, lanes_per_thread=2),
    "tile22-x8": dict(lanes=8, rows_per_thread=2, lanes_per_thread=2),
    "tile22-x32": dict(lanes=32, rows_per_thread=2, lanes_per_thread=2),
}


@pytest.mark.parametrize("layout", list(WIDE_REC_FORCED))
@pytest.mark.parametrize("branch", list(RICCATI_BRANCHES))
@pytest.mark.parametrize("N,nx,nu,B", [(1, 3, 1, 1), (12, 40, 20, 77), (30, 64, 32, 33),
                                        (50, 4, 2, 300), (30, 64, 32, 1000),
                                        (10, 160, 80, 77)])
def test_wide_recurrences_match_plain_versions(card, branch, N, nx, nu, B, layout):
    """The wide rollout and certificate against their plain versions at
    every branch, with partial last blocks (B = 33, 77, 1000 at the forced
    lanes), on every placement of A and B, the device route and each
    register tile; the (160, 80) plant is too wide for the fp64 placement
    (A alone 200 KB), so its plan keeps them in fp32."""
    op = _wide_op(N, nx, nu, branch, card)
    force = WIDE_REC_FORCED[layout]
    if force is not None:
        try:
            for kernel in riccati_fused.WIDE_REC_KERNELS:
                riccati_fused.wide_recurrence_plan(op, B, kernel, **force)
        except ValueError:
            pytest.skip(f"the layout {layout} does not fit N={N}, nx={nx}, nu={nu}")
    if nx == 160:
        for kernel in riccati_fused.WIDE_REC_KERNELS:
            assert riccati_fused.wide_recurrence_plan(op, B, kernel).place == "fp32"
    _assert_wide_recurrences_equal_plain(op, card, B, N + B, force)


def test_wide_recurrence_wrappers_reject_bad_plans_and_operands(card):
    """The C entries refuse shared-memory bytes that differ from their own
    layout, and the wrappers an operand of the wrong dtype or strides."""
    op = _synthetic_op(6, 5, 3, "state", card)
    _, _, e0T, ballr, lamX0, lamU0, lamX1, lamU1 = _op_args(op, card, 8, 1)
    for kernel in riccati_fused.WIDE_REC_KERNELS:
        plan = riccati_fused.wide_recurrence_plan(op, 8, kernel)
        bad = plan._replace(smem_bytes=plan.smem_bytes + 16)
        with pytest.raises(RuntimeError, match="cudaError_t"):
            if kernel == "rollout":
                riccati_fused._launch_rollout_wide(op, e0T, lamU1, plan=bad)
            else:
                riccati_fused._launch_certificate_wide(op, lamX1, lamX0, lamU1, lamU0, lamX1,
                                                       ballr, plan=bad)
    ops = riccati_fused.k3w_seq_operands(op)
    AT = ops["AT"]
    try:
        ops["AT"] = AT.double()
        with pytest.raises(ValueError, match="dtype"):
            riccati_fused.rollout_wide(op, e0T, lamU1)
        ops["AT"] = AT.T.contiguous().T
        with pytest.raises(ValueError, match="not contiguous"):
            riccati_fused.rollout_wide(op, e0T, lamU1)
    finally:
        ops["AT"] = AT
    with pytest.raises(ValueError, match="not contiguous"):
        riccati_fused.certificate_terms_wide(op, lamX1, lamX0, lamU1.transpose(0, 2).contiguous()
                                             .transpose(0, 2), lamU0, lamX1, ballr)


def test_k3w_wrappers_reject_wrong_dtypes_and_strides(card):
    op = _synthetic_op(6, 5, 3, "state", card)
    args = list(_op_args(op, card, 8, 1)) + [2]
    bad = list(args)
    bad[4] = args[4].double()
    with pytest.raises(ValueError, match="dtype"):
        riccati_fused.iterate_chunk_riccati_wide(*bad)
    bad = list(args)
    bad[5] = torch.empty(tuple(reversed(args[5].shape)), device=card).permute(2, 1, 0)
    with pytest.raises(ValueError, match="not contiguous"):
        riccati_fused.iterate_chunk_riccati_doubling(*bad)
    bad = list(args)
    bad[1] = args[1].long()
    with pytest.raises(ValueError, match="dtype"):
        riccati_fused.iterate_chunk_riccati_doubling(*bad)
    _, _, e0T, ballr, lamX, lamU, _, _ = args[:8]
    with pytest.raises(ValueError, match="not contiguous"):
        riccati_fused.rollout_wide(op, e0T.T.contiguous().T, lamU)
    with pytest.raises(ValueError, match="dtype"):
        riccati_fused.certificate_terms_wide(op, lamX, lamX, lamU, lamU, lamX.half(), ballr)
    with pytest.raises(ValueError, match="runs at least one iteration"):
        riccati_fused._launch_k3w(*args[:8], 0)


def test_per_lane_engine_on_k3w_doubling_equals_its_plain_version(card):
    """The per-lane engine under parallel_sweeps at h50 with the state box
    and the rho rule at every check: its K3W-doubling launches against the
    same engine with the doubling form's plain version on the card, equal
    solves (the rest of the two runs is the same code)."""
    ctrl = proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control", 50, 5.0,
        [0.65] * 4, [1.2] * 2, engine="riccati", mpc_state_constraint=True, device=card,
        riccati_config=riccati.RiccatiConfig(max_iter=1000, adapt_interval=25,
                                             parallel_sweeps=True),
    )
    op, cfg = ctrl.engine.op, ctrl.engine.config
    rng = np.random.default_rng(7)
    x0 = np.clip(0.65 + 0.15 * rng.standard_normal((200, 4)), 0.3, 1.3)
    e0s = torch.from_numpy((x0 - 0.65).astype(np.float32)).to(card)
    launches, plain = dict(admm_fused.LAUNCHES), dict(admm_fused.PLAIN_CALLS)
    out_k = riccati_fused.solve_sparse(op, e0s, config=cfg)
    torch.cuda.synchronize()
    assert admm_fused.LAUNCHES["K3W-doubling"] > launches["K3W-doubling"]
    assert admm_fused.LAUNCHES["K3"] == launches["K3"]
    assert admm_fused.PLAIN_CALLS == plain
    out_p = riccati_fused.solve_sparse(op, e0s, config=cfg,
                                       chunk_fn=riccati_fused.iterate_chunk_riccati_doubling_plain)
    assert bool((out_k[2] == 0).all())
    for name, a, b in zip(("X", "U", "status", "iterations"), out_k[:4], out_p[:4]):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("B", [1, 64])
def test_wider_riccati_plant_on_k3w(card, B):
    """A (40, 20) Riccati controller: solve_batch_auto and solve_batch
    launch K3W and the wide recurrences, never K3 or a plain version, and
    agree with the same solves on the CPU."""
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big

    design = lambda dev: proceed_controller(
        big.random_stable_system(40, 20, seed=0), "model_predictive_control", 10, 1.0,
        np.zeros(40, np.float32), np.zeros(20, np.float32), mpc_Q=10.0, mpc_R=0.1,
        engine="riccati", riccati_config=riccati.RiccatiConfig(max_iter=1000), device=dev)
    ctrl, ctrl_cpu = design(card), design("cpu")
    rng = np.random.default_rng(B)
    x0 = torch.from_numpy(np.clip(0.4 * rng.standard_normal((B, 40)), -0.95, 0.95).astype(np.float32))
    for solve in (parallel.solve_batch_auto, parallel.solve_batch):
        launches, plain = dict(admm_fused.LAUNCHES), dict(admm_fused.PLAIN_CALLS)
        s_gpu, _, _, d_gpu = solve(ctrl, x0.to(card))
        torch.cuda.synchronize()
        for key in ("K3W", "rollout-wide", "certificate-wide"):
            assert admm_fused.LAUNCHES[key] > launches[key], key
        for key in ("K3", "rollout", "certificate"):
            assert admm_fused.LAUNCHES[key] == launches[key], key
        assert admm_fused.PLAIN_CALLS == plain
        s_cpu, _, _, d_cpu = solve(ctrl_cpu, x0)
        assert int(d_gpu.n_converged) == int(d_cpu.n_converged) == B
        assert torch.equal(s_gpu.status.cpu(), s_cpu.status)
        assert float((s_gpu.u.cpu() - s_cpu.u).abs().max()) <= 1e-4


@pytest.fixture(scope="module")
def nccl_mesh(card, tmp_path_factory):
    """A one-rank NCCL process group over a file store, and its mesh."""
    import torch.distributed as dist

    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield parallel.make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("cell", ["h20-K1", "h50-riccati-K3"])
def test_solve_sharded_one_nccl_rank_equals_batch(card, controllers, nccl_mesh, cell):
    """solve_sharded on a one-rank NCCL mesh: the solution, the warm pair
    and the diagnostics (all-reduced on the card) equal the batch solve it
    routes to bit for bit (h20 at B = 4096 on K1 through solve_batch_auto;
    the h50 Riccati controller at fused=True on K3)."""
    if cell == "h20-K1":
        ctrl, B, fused, batch = controllers[0], 4096, None, parallel.solve_batch_auto
    else:
        ctrl = proceed_controller(
            qtp.linearized_discrete_system(), "model_predictive_control", 50, 5.0,
            [0.65] * 4, [1.2] * 2, engine="riccati", device=card)
        B, fused, batch = 256, True, parallel.solve_batch_fused
    assert (nccl_mesh.n, nccl_mesh.rank) == (1, 0) and nccl_mesh.group is not None
    x0s = torch.from_numpy(_x0s(B, 5)).to(card)
    kernel = "K1" if cell == "h20-K1" else "K3"
    before = admm_fused.LAUNCHES[kernel]
    sol, wz, wy, diag = parallel.solve_sharded(ctrl, x0s, nccl_mesh, fused=fused)
    assert admm_fused.LAUNCHES[kernel] > before
    want, wz_b, wy_b, diag_b = batch(ctrl, x0s)
    torch.cuda.synchronize()
    for name, a, b in (("u", sol.u, want.u), ("status", sol.status, want.status),
                       ("iterations", sol.iterations, want.iterations), ("wz", wz, wz_b),
                       ("wy", wy, wy_b)):
        assert torch.equal(a, b), name
    for key in diag.__dataclass_fields__:
        a, b = getattr(diag, key), getattr(diag_b, key)
        assert a.device == b.device and a.dtype == b.dtype and torch.equal(a, b), key
