"""The kernel precisions of K1, K2, K4 and K5 (``AdmmConfig.
kernel_precision``), port vs JAX, on the CPU.

"bf16x3" and "default" are what each product of the JAX kernel bodies
computes under ``admm_pallas._make_dot`` / ``_make_opdot``; "hybrid" is the
fused driver's per-chunk schedule. On a CPU tensor each chunk function runs
its plain version in the requested precision; the JAX side runs the Pallas
bodies in interpret mode with ``dot_mode``, as the JAX package's own tests
run them. Inputs are made with numpy from a seed.

One divergence is on purpose: XLA on the CPU ignores ``Precision.DEFAULT``
and computes those products in fp32, so JAX on the CPU is no reference for
"default". The port computes what the TPU computes, one bf16 pass, and is
held to a numpy product of ``ml_dtypes.bfloat16``-rounded operands.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu import parallel as jpar
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops import admm as jadmm
from automationlabsmodelpredictivecontrol_jl_tpu.ops import admm_pallas
from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig as JConfig

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
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

# One chunk of 25 iterations: both packages split every operand into the
# same bf16 hi and lo (round to nearest even) and sum exact products in
# fp32, the port in index order, XLA in its own; the difference is fp32
# roundoff, as at "highest", and the bar is the "highest" chunk tests'
# (tests/test_torch_admm_fused.py), normwise relative to each array's
# largest entry.
RTOL, ATOL = 1e-4, 1e-5
U_BF16X3 = 5e-3  # bf16x3 u against highest: the JAX package's own bar (test_pallas_fused.py)
U_JAX = 1e-3  # the port's bf16x3 solve against JAX's
TOL = 5e-4  # the JAX package's fused-vs-engine bar, for the hybrid solves
EPS_ABOVE_FLOOR = dict(eps_abs=1e-4, eps_rel=1e-4, check_interval=5, adapt_interval=5)

# (rows of the QP, config) of each kernel's case, at h10 (K1, K2) or h20
# (K4, K5: the QP with its state or terminal rows first, a dense A, on the
# kernel the JAX package's variant rule picks at the dense cells' shapes)
TIER1 = dict(max_iter=200, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0)
TIER2 = dict(max_iter=250, rho=1.0, rho_grid=(0.1, 1.0, 10.0, 100.0), refine_steps=2)
CASES = {
    "K1": (dict(), TIER2),
    "K2": (dict(mpc_state_constraint=True), dict(max_iter=1000)),
    "K4": (dict(mpc_terminal_ingredient="equality"), dict(max_iter=1000)),
    "K5": (dict(mpc_state_constraint=True), dict(max_iter=1000)),
}


def _eq_mask(l, u):
    return np.isfinite(l) & np.isfinite(u) & (l == u)


def _pair(kernel, **cfg):
    """The JAX and the port's controller of the kernel's case, both with
    their rows first for K4 and K5 (each package's own build_operator on
    the permuted QP)."""
    rows, base = CASES[kernel]
    cfg = dict(base, **cfg)
    horizon = 10 if kernel in ("K1", "K2") else 20
    jc = jmpc.proceed_controller(
        jqtp.linearized_discrete_system(), "model_predictive_control", horizon, 5.0,
        np.full(4, 0.65), np.full(2, 1.2), admm_config=JConfig(**cfg), **rows,
    )
    tc = tmpc.proceed_controller(
        tqtp.linearized_discrete_system(), "model_predictive_control", horizon, 5.0,
        [0.65] * 4, [1.2] * 2, admm_config=TConfig(**cfg), device="cpu", **rows,
    )
    if kernel in ("K1", "K2"):
        return jc, tc
    m, n = tc.engine.qp.A.shape
    perm = np.r_[np.arange(n, m), np.arange(n)]
    jqp = jc.engine.qp
    jqp = dataclasses.replace(jqp, **{k: jnp.asarray(np.asarray(getattr(jqp, k))[perm])
                                      for k in ("A", "l_const", "u_const", "b_x0")})
    jop = jadmm.build_operator(np.asarray(jqp.P), np.asarray(jqp.A),
                               _eq_mask(np.asarray(jqp.l_const), np.asarray(jqp.u_const)), 0,
                               jc.engine.config)
    jc = dataclasses.replace(jc, engine=dataclasses.replace(jc.engine, qp=jqp, op=jop))
    tqp = tc.engine.qp
    tqp = tqp.replace(**{k: getattr(tqp, k)[perm] for k in ("A", "l_const", "u_const", "b_x0")})
    top = tadmm.build_operator(tqp.P.numpy(), tqp.A.numpy(),
                               _eq_mask(tqp.l_const.numpy(), tqp.u_const.numpy()), 0,
                               tc.engine.config)
    tc = tc.replace(engine=LinearEngine(qp=tqp, op=top, soft_mu=None, config=tc.engine.config))
    return jc, tc


@pytest.fixture(scope="module")
def designs():
    return {k: _pair(k) for k in CASES}


def _x0s(B, seed, spread=0.1):
    rng = np.random.default_rng(seed)
    return np.clip(0.65 + spread * rng.standard_normal((B, 4)), 0.3, 1.3).astype(np.float32)


def _chunk_inputs(tc, B, seed):
    """Scaled lane-last QP vectors from real initial states, a state near
    the driver's cold start with a small seeded perturbation, and random
    rho indices, as numpy."""
    op = tc.engine.op
    R = op.rho_grid.shape[0]
    x0s = torch.from_numpy(_x0s(B, seed, 0.002))
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


def _jax_chunk(kernel, jc, args, chunk, mode="bf16x3"):
    """The JAX body's chunk at ``mode`` (interpret mode), lane-last."""
    op, cfg = jc.engine.op, jc.engine.config
    if kernel in ("K1", "K2"):
        fn = (admm_pallas._iterate_chunk_diag_T if kernel == "K1"
              else admm_pallas._iterate_chunk_mixed_T)
        out = fn(op, *[jnp.asarray(a) for a in args], chunk, cfg, interpret=True,
                 dot_mode=mode)
        return [np.asarray(o) for o in out]
    qT, lT, uT, idx, x, s, y, ax = args
    out = admm_pallas._iterate_chunk(
        op, *(jnp.asarray(a.T) for a in (qT, lT, uT)), jnp.asarray(idx),
        *(jnp.asarray(a.T) for a in (x, s, y, ax)), chunk, cfg, interpret=True,
        dot_mode=mode,
    )
    return [np.asarray(o).T for o in out]


@pytest.mark.parametrize("chunk", [1, 25])
@pytest.mark.parametrize("kernel", list(CASES))
def test_bf16x3_chunk_matches_jax(designs, kernel, chunk):
    """A chunk of each plain kernel in bf16x3 against the JAX body's bf16x3
    chunk on the same state, counted under its precision. Over 25
    iterations K4's QP, the equality terminal whose rows carry 100 x the
    others' rho, grows the fp32 difference of the sums' order: a partial
    sum that moves across a bf16 rounding tie moves an operand's lo by
    2^-16 relative, and after 25 iterations bf16x3 lies ~5e-3 from highest
    in either package (the same kia in both moves none of this). There
    every output lies within the JAX package's own bf16x3 bar (5e-3) of
    JAX's, y in its row's units, and x, s and ax of both packages lie as
    far from their own highest chunk, within a factor of 2."""
    jc, tc = designs[kernel]
    cfg = dataclasses.replace(tc.engine.config, kernel_precision="bf16x3")
    op = tc.engine.op
    m, n = (int(d) for d in op.A_s.shape)
    if kernel in ("K4", "K5"):
        packed = admm_fused.use_packed(n, m, int(op.rho_grid.shape[0]), cfg.refine_steps)
        assert packed is (kernel == "K4")
    args = _chunk_inputs(tc, 16, seed=len(kernel) + n)
    run = lambda c: admm_fused.chunk_fn_for(op, config=c)(
        op, *[torch.from_numpy(a) for a in args], chunk, c)
    calls = dict(admm_fused.PLAIN_CALLS)
    out_t = run(cfg)
    key = f"{kernel}-bf16x3"
    assert admm_fused.PLAIN_CALLS == dict(calls, **{key: calls[key] + 1})
    out_h = run(tc.engine.config)
    out_j = _jax_chunk(kernel, jc, args, chunk)
    for i, (name, a, b, h) in enumerate(zip(("x", "s", "y", "ax"), out_t, out_j, out_h)):
        a, h = a.numpy(), h.numpy()
        assert np.abs(a - h).max() > 0, name  # bf16x3 is not highest
        if kernel == "K4" and chunk > 1:
            # y in its row's units (y / rho): the equality rows' rho, up to
            # 1e3 here, carries the primal difference into y as many times
            scale = op.rho_vecs.numpy()[args[3]].T if name == "y" else 1.0
            err = np.abs((a - b) / scale).max()
            assert err <= U_BF16X3, (name, err)
            if name != "y":
                jh = _jax_chunk(kernel, jc, args, chunk, "highest")[i]
                d_t, d_j = np.abs(a - h).max(), np.abs(b - jh).max()
                assert 0.5 * d_j <= d_t <= 2 * d_j, (name, d_t, d_j)
            continue
        err = np.abs(a - b).max()
        assert err <= RTOL * np.abs(b).max() + ATOL, (name, err)


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_packed_entries_round_as_jax(designs, kernel):
    """The dense kernels round the operators' entries, the packed ones as
    entries: fl(rho_r A) and A equal JAX's bit for bit, so their splits do;
    K4's K_r^-1 A' is an fp64 sum rounded once in the port and an fp32
    product in JAX (within 1e-6 relative, tests/test_torch_admm_dense.py):
    its bf16 hi agrees on all but entries next to a rounding tie, its lo,
    which keeps the next 8 bits, on about 95% (a 2^-20 relative difference
    moves lo's rounding within 2^-16 of a tie); the chunk test above holds
    what that leaves at the chunks' bar."""
    jc, tc = designs[kernel]
    jrhs1, _, _, jwrow = (np.asarray(a) for a in admm_pallas.packed_operators(jc.engine.op))
    rhs1, _, wrow = (a for a in admm_fused.packed_operators(tc.engine.op))
    for ours, theirs, exact in ((rhs1, jrhs1, True), (wrow, jwrow, False)):
        hi, lo = admm_fused.bf16_split(ours)
        jhi = theirs.astype(ml_dtypes.bfloat16).astype(np.float32)
        jlo = (theirs - jhi).astype(ml_dtypes.bfloat16).astype(np.float32)
        if exact:
            np.testing.assert_array_equal(hi.numpy(), jhi)
            np.testing.assert_array_equal(lo.numpy(), jlo)
        else:
            assert (hi.numpy() != jhi).mean() <= 1e-3
            assert (lo.numpy() != jlo).mean() <= 0.1


@pytest.mark.parametrize("mode", ["default", "bf16x3"])
def test_product_matches_numpy_bf16(mode):
    """dot_bf16 against numpy on ml_dtypes.bfloat16-rounded operands: the
    same passes, summed in fp32 from +0 in column order, bit for bit."""
    rng = np.random.default_rng(3)
    M = rng.standard_normal((9, 40)).astype(np.float32)
    v = (rng.standard_normal((40, 7)) * np.logspace(-3, 2, 7)).astype(np.float32)
    got = admm_fused.dot_bf16(torch.from_numpy(M), torch.from_numpy(v), mode).numpy()
    rnd = lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float32)

    def passes(A, V):
        acc = np.zeros((A.shape[0], V.shape[1]), np.float32)
        for j in range(A.shape[1]):
            acc = acc + A[:, j:j + 1] * V[j:j + 1]  # exact products, fp32 sums
        return acc

    if mode == "default":
        want = passes(rnd(M), rnd(v))
    else:
        mh, vh = rnd(M), rnd(v)
        ml, vl = rnd(M - mh), rnd(v - vh)
        want = passes(mh, vh) + (passes(ml, vh) + passes(mh, vl))
    np.testing.assert_array_equal(got, want)
    exact = M.astype(np.float64) @ v.astype(np.float64)
    err = np.abs(got - exact).max() / np.abs(exact).max()
    assert err < (2e-2 if mode == "default" else 1e-4)


def _fleet(mode, **cfg):
    """The JAX package's bf16x3 test controller (test_pallas_fused.py, h5)
    in both packages."""
    kw = dict(max_iter=200, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0,
              kernel_precision=mode, **cfg)
    jc = jmpc.proceed_controller(jqtp.linearized_discrete_system(), "model_predictive_control",
                                 5, 5.0, np.full(4, 0.65), np.full(2, 1.2), engine="condensed",
                                 admm_config=JConfig(**kw))
    tc = tmpc.proceed_controller(tqtp.linearized_discrete_system(), "model_predictive_control",
                                 5, 5.0, [0.65] * 4, [1.2] * 2, engine="condensed",
                                 admm_config=TConfig(**kw), device="cpu")
    return jc, tc


def test_bf16x3_solve_accurate_and_as_jax():
    """The counterpart of test_kernel_precision_bf16x3_accurate_but_
    uncertified (h5, B = 8, seed 5): bf16x3's u within 5e-3 of highest's,
    and the port's bf16x3 solve against JAX's: statuses equal, u within
    1e-3."""
    x0s = _x0s(8, seed=5)
    _, th = _fleet("highest")
    jb, tb = _fleet("bf16x3")
    calls = dict(admm_fused.PLAIN_CALLS)
    s_hi, _, _, _ = tpar.solve_batch_fused(th, torch.from_numpy(x0s))
    s_b3, _, _, _ = tpar.solve_batch_fused(tb, torch.from_numpy(x0s))
    assert admm_fused.PLAIN_CALLS["K1-bf16x3"] > calls["K1-bf16x3"]
    np.testing.assert_allclose(s_b3.u.numpy(), s_hi.u.numpy(), atol=U_BF16X3)
    j_b3, _, _, _ = jpar.solve_batch_fused(jb, jnp.asarray(x0s))
    np.testing.assert_array_equal(s_b3.status.numpy(), np.asarray(j_b3.status))
    np.testing.assert_allclose(s_b3.u.numpy(), np.asarray(j_b3.u), atol=U_JAX)


def _recording(kernel):
    """The plain chunk function of the kernel, recording each chunk's
    precision."""
    modes = []
    plain = {"K1": admm_fused.iterate_chunk_diag_T_plain,
             "K2": admm_fused.iterate_chunk_mixed_T_plain}[kernel]

    def chunk_fn(*args):
        modes.append(args[-1].kernel_precision)
        return plain(*args)

    return chunk_fn, modes


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_hybrid_solve_matches_jax(kernel):
    """The hybrid schedule against JAX's solve_batch_fused (interpret mode)
    on K1's and K2's shapes: the same statuses, z and y within 5e-4 (the
    iteration counts follow roundoff: a bf16x3 chunk's products move by a
    bf16 lo rounding where the sums' order moves a partial sum across a
    tie); the first chunk runs bf16x3 (the residuals start at +inf) and
    later ones highest, wherever the open lanes' worst residual is at most
    the switch."""
    jc, tc = _pair(kernel, kernel_precision="hybrid", hybrid_switch_residual=2e-3,
                   **EPS_ABOVE_FLOOR)
    x0s = _x0s(16, seed=9, spread=0.05)
    q, l, u, _, _ = runtime_qp_vectors_batch(
        tc.engine.qp, torch.from_numpy(x0s) - tc.tuning.references.x[:, 0])
    chunk_fn, modes = _recording(kernel)
    zt, yt, _, st, it, _, _ = admm_fused.solve_batch_fused(
        tc.engine.op, q, l, u, config=tc.engine.config, chunk_fn=chunk_fn)
    zj, yj, _, sj, ij, _, _ = admm_pallas.solve_batch_fused(
        jc.engine.op, *(jnp.asarray(v.numpy()) for v in (q, l, u)), config=jc.engine.config,
        interpret=True)
    assert modes[0] == "bf16x3" and "highest" in modes
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (st.numpy() == 0).all()
    assert abs(float(it.float().mean()) - float(np.asarray(ij).mean())) <= 5
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=TOL)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=TOL)


def _exact_residuals(tc, x0s, sol):
    """Each lane's residuals recomputed in fp64 from the solution the
    driver returned (z, y, s unscaled), and the driver's bar on them."""
    e0s = torch.from_numpy(x0s) - tc.tuning.references.x[:, 0]
    q, l, u, _, _ = runtime_qp_vectors_batch(tc.engine.qp, e0s)
    qp, cfg = tc.engine.qp, tc.engine.config
    P, A = qp.P.double(), qp.A.double()
    z, y, s = (t.double() for t in sol)
    Az, Pz, Aty = z @ A.T, z @ P, y @ A
    amax = lambda t: t.abs().amax(1)
    r_prim = amax(Az - s)
    r_dual = amax(Pz + q.double() + Aty)
    bar_p = cfg.eps_abs + cfg.eps_rel * torch.maximum(amax(Az), amax(s))
    bar_d = cfg.eps_abs + cfg.eps_rel * torch.maximum(torch.maximum(amax(Pz), amax(Aty)),
                                                      amax(q.double()))
    return r_prim, r_dual, bar_p, bar_d, (q, l, u)


def test_default_certifies_fewer_lanes_honestly():
    """One bf16 pass stalls above eps 1e-6 (the reference's finding): on
    the h10 box-only QP at tier 1's grid it certifies fewer lanes than
    highest, and every lane it does certify meets the certificate on its
    residuals recomputed in fp64 from the returned solution (within the
    fp32 rounding of that solution: twice the bar)."""
    _, th = _pair("K1", **TIER1)
    _, td = _pair("K1", **dict(TIER1, kernel_precision="default"))
    x0s = _x0s(32, seed=11)
    counts = {}
    for name, c in (("highest", th), ("default", td)):
        e0s = torch.from_numpy(x0s) - c.tuning.references.x[:, 0]
        q, l, u, _, _ = runtime_qp_vectors_batch(c.engine.qp, e0s)
        z, y, s, status, _, _, _ = admm_fused.solve_batch_fused(
            c.engine.op, q, l, u, config=c.engine.config)
        r_prim, r_dual, bar_p, bar_d, _ = _exact_residuals(c, x0s, (z, y, s))
        ok = status == 0
        counts[name] = int(ok.sum())
        assert bool((r_prim[ok] <= 2 * bar_p[ok]).all() and (r_dual[ok] <= 2 * bar_d[ok]).all())
    assert counts["default"] < counts["highest"]


@pytest.mark.parametrize("mode", ["bf16x3", "default", "hybrid"])
@pytest.mark.parametrize("kernel", list(CASES))
def test_every_precision_solves_on_the_kernel(designs, kernel, mode):
    """Every precision the JAX package accepts solves through
    parallel.solve_batch_fused on each kernel's plain version (hybrid
    through bf16x3 and then highest), at a shape the kernel takes at
    highest; "tf32" is still refused."""
    _, tc = designs[kernel]
    c = tc.replace(engine=dataclasses.replace(
        tc.engine, config=dataclasses.replace(tc.engine.config, kernel_precision=mode,
                                              max_iter=100)))
    calls = dict(admm_fused.PLAIN_CALLS)
    sol, _, _, _ = tpar.solve_batch_fused(c, torch.from_numpy(_x0s(4, seed=13, spread=0.002)))
    assert bool(torch.isfinite(sol.u).all())
    ran = {k for k in calls if admm_fused.PLAIN_CALLS[k] > calls[k]}
    want = {f"{kernel}-bf16x3"} if mode == "hybrid" else {f"{kernel}-{mode}"}
    assert want <= ran <= want | {kernel}
    with pytest.raises(ValueError, match="tf32"):
        tpar.solve_batch_fused(c.replace(engine=dataclasses.replace(
            c.engine, config=dataclasses.replace(c.engine.config, kernel_precision="tf32"))),
            torch.from_numpy(_x0s(4, seed=13)))


@pytest.mark.parametrize("mode", ["bf16x3", "default", "hybrid"])
def test_escalation_carries_the_precision(mode):
    """Tier 2 of the escalated solve carries the controller's
    kernel_precision, as JAX's escalation_controller does (it replaces only
    the grid, the budget and the refinement): solve_batch_auto and
    solve_batch_escalated run K1's plain version at the precision in both
    tiers."""
    _, tc = _pair("K1", **dict(TIER1, max_iter=50, kernel_precision=mode))
    fb = tpar.escalation_controller(tc, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=50,
                                    refine_steps=2)
    assert fb.engine.config.kernel_precision == mode and fb.engine.config.refine_steps == 2
    x0 = torch.from_numpy(_x0s(16, seed=17))
    key = "K1-default" if mode == "default" else "K1-bf16x3"
    calls = admm_fused.PLAIN_CALLS[key]
    sol, _, _, _ = tpar.solve_batch_auto(tc, x0)
    assert admm_fused.PLAIN_CALLS[key] > calls and bool(torch.isfinite(sol.u).all())
    wz, wy = tpar.init_warm_batch(tc, 16)
    calls = admm_fused.PLAIN_CALLS[key]
    sol, _, _, diag = tpar.solve_batch_escalated(tc, fb, x0, wz, wy, bucket=16)
    assert admm_fused.PLAIN_CALLS[key] > calls and bool(torch.isfinite(sol.u).all())


@pytest.mark.parametrize("mode", ["bf16x3", "default"])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K4", "K5"])
def test_every_shape_has_a_plan_at_every_precision(kernel, mode):
    """Every shape a kernel takes at "highest" gets a plan at each bf16
    precision, on the same route and in the same bytes (an entry takes 8
    bytes at every precision); the layout may differ where the
    instantiations' registers do."""
    shapes = [(n, m, R, rs) for n in (1, 7, 40, 100, 128) for m in (1, 44, 120, 300, 512)
              for R in (1, 2, 5) for rs in (0, 1, 2)]
    for n, m, R, rs in shapes:
        for B in (1, 77, 2048, 16384):
            if kernel == "K1":
                if not admm_fused.k1_fits(n, R, rs):
                    continue
                hi = admm_fused.k1_plan(n, R, rs, B)
                lo = admm_fused.k1_plan(n, R, rs, B, mode=mode)
                assert lo.route == hi.route
                if lo.route == "shared":
                    assert lo.smem_bytes == admm_fused.k1_smem_bytes(
                        n, R, rs, lo.lanes, lo.groups, lo.rpt)
                else:
                    assert lo == hi and lo.smem_bytes == admm_fused.k12_stream_smem_bytes(
                        n, 0, lo.lanes, lo.panel)
            elif kernel == "K2":
                if m <= n or not admm_fused.k2_fits(n, m, R, rs):
                    continue
                hi = admm_fused.k2_plan(n, m, R, rs, B)
                lo = admm_fused.k2_plan(n, m, R, rs, B, mode=mode)
                assert lo == hi
            else:
                plan = admm_fused.k4_plan if kernel == "K4" else admm_fused.k5_plan
                hi = plan(n, m, R, rs, B)
                lo = plan(n, m, R, rs, B, mode=mode)
                assert lo.route == hi.route
                if lo.route == "shared":
                    assert lo.smem_bytes == admm_fused.k5_smem_bytes(
                        n, m, R, rs, lo.lanes, lo.groups, lo.rpt_n, lo.rpt_m, kernel == "K4")
                else:
                    assert lo.smem_bytes == admm_fused.k5_stream_smem_bytes(
                        m, lo.lanes, lo.groups, lo.rpt_n, lo.rpt_m, lo.panel)
    with pytest.raises(ValueError):
        admm_fused.k1_plan(40, 2, 0, 64, mode="hybrid")


@pytest.mark.parametrize("mode", ["bf16x3", "default"])
def test_precision_registers_change_a_plan(mode):
    """The registers of a bf16 precision's instantiations
    (``PRECISION_REGISTERS``) choose its own plan where they differ from
    highest's: K1 at n = 22, R = 1, one refinement, B = 16384. At
    "highest" the 8-row instantiation (243 registers a thread) fits 2
    blocks of 3 warps an SM, as the 6-row one fits 2 of 4, and the 6-row
    one wins; at the bf16 precisions it takes 224 (bf16x3) or 216
    (default) registers, fits 3 blocks an SM and wins."""
    hi = admm_fused.k1_plan(22, 1, 1, 16384)
    lo = admm_fused.k1_plan(22, 1, 1, 16384, mode=mode)
    assert (hi.lanes, hi.groups, hi.rpt, hi.per_sm) == (32, 4, 6, 2)
    assert (lo.lanes, lo.groups, lo.rpt, lo.per_sm) == (32, 3, 8, 3)
    assert lo.smem_bytes == hi.smem_bytes


def test_bf16_certificate_holds_on_the_exact_image():
    """The driver certifies a lane at a bf16 precision only where the
    primal test also holds on the exact image A x: a chunk that moves s by
    1e-3 and reports its running image ax there (no primal residual on ax)
    gets lanes certified on the dual test alone at "highest" (the JAX
    driver's rule, which tests ax), none at "bf16x3", where A x - s is
    1e-3."""
    _, tc = _pair("K1", **TIER1)
    op = tc.engine.op
    x0s = torch.from_numpy(_x0s(16, seed=19))
    q, l, u, _, _ = runtime_qp_vectors_batch(tc.engine.qp, x0s - tc.tuning.references.x[:, 0])

    def lying_chunk(op, qT, lT, uT, idx, x, s, y, ax, chunk, cfg):
        x2, s2, y2, _ = admm_fused.iterate_chunk_diag_T_plain(
            op, qT, lT, uT, idx, x, s, y, ax, chunk,
            dataclasses.replace(cfg, kernel_precision="highest"))
        return x2, s2 + 1e-3, y2, s2 + 1e-3

    out = {}
    for mode in ("highest", "bf16x3"):
        cfg = dataclasses.replace(tc.engine.config, kernel_precision=mode, max_iter=25)
        *_, status, _, rp, _ = admm_fused.solve_batch_fused(op, q, l, u, config=cfg,
                                                            chunk_fn=lying_chunk)
        assert float(rp.abs().max()) == 0.0  # what ax reports
        out[mode] = status
    assert int((out["highest"] == 0).sum()) > 0
    assert int((out["bf16x3"] == 0).sum()) == 0
