"""The per-lane Riccati engine (``ops.riccati_fused.solve_sparse``), port vs the
JAX package's ``jax.vmap(solve_sparse)``, and Riccati escalation.

Each lane adapts its own rho, so a check runs K3 (its plain version here)
once per rho that open lanes hold, on those lanes gathered. The cases
below make lanes take different rho: the h50 state box with the rho rule
at every check, and each branch of the kernel at h12. Inputs are made with
numpy from a seed; K3's plain version sums in fp64 where XLA sums in fp32,
so solutions are held within 1e-4 and, away from the noise, statuses and
iteration counts lane by lane."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu import parallel as jpar
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops import riccati as jric

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import STATUS_PRIMAL_INFEASIBLE
from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused, riccati_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati as tric

torch.set_num_threads(1)

TOL = 1e-4
B = 8


def _pair(horizon, cfg, **kw):
    jc = jmpc.proceed_controller(
        jqtp.linearized_discrete_system(), "model_predictive_control", horizon, 5.0,
        np.full(4, 0.65), np.full(2, 1.2), engine="riccati",
        riccati_config=jric.RiccatiConfig(**cfg), **kw,
    )
    tc = tmpc.proceed_controller(
        tqtp.linearized_discrete_system(), "model_predictive_control", horizon, 5.0,
        [0.65] * 4, [1.2] * 2, engine="riccati", riccati_config=tric.RiccatiConfig(**cfg),
        device="cpu", **kw,
    )
    return jc, tc


def _e0s(spread, seed=0, n=B):
    rng = np.random.default_rng(seed)
    x0 = np.clip(0.65 + spread * rng.standard_normal((n, 4)), 0.3, 1.3)
    return (x0 - 0.65).astype(np.float32)


class _Groups:
    """K3's plain version, recording the rho index and lanes of each call."""

    def __init__(self):
        self.calls = []

    def __call__(self, op, ridx, e0T, *rest):
        self.calls.append((int(ridx[0]), int(e0T.shape[1])))
        return riccati_fused.iterate_chunk_riccati(op, ridx, e0T, *rest)


def _solve_pair(jc, tc, e0s, warm=None):
    jop, jcfg = jc.engine.op, jc.engine.config
    groups = _Groups()
    if warm is None:
        j = jax.vmap(lambda e: jric.solve_sparse(jop, e, config=jcfg))(jnp.asarray(e0s))
        t = riccati_fused.solve_sparse(tc.engine.op, torch.from_numpy(e0s),
                                       config=tc.engine.config, chunk_fn=groups)
    else:
        U, lamX, lamU = warm
        j = jax.vmap(lambda e, u, lx, lu: jric.solve_sparse(
            jop, e, warm_U=u, warm_lam=(lx, lu), config=jcfg))(
                *map(jnp.asarray, (e0s, U, lamX, lamU)))
        t = riccati_fused.solve_sparse(tc.engine.op, torch.from_numpy(e0s),
                                       warm_U=torch.from_numpy(U),
                                       warm_lam=(torch.from_numpy(lamX), torch.from_numpy(lamU)),
                                       config=tc.engine.config, chunk_fn=groups)
    return j, t, groups


def _held(j, t, iterations=True):
    (Xj, Uj, sj, ij, _, _, (lxj, luj)), (Xt, Ut, st, it, _, _, (lxt, lut)) = j, t
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    if iterations:
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    ok = st.numpy() == 0
    np.testing.assert_allclose(Ut.numpy()[ok], np.asarray(Uj)[ok], atol=TOL)
    np.testing.assert_allclose(Xt.numpy()[ok], np.asarray(Xj)[ok], atol=TOL)
    scale = max(1.0, float(np.abs(np.asarray(lxj)).max()), float(np.abs(np.asarray(luj)).max()))
    np.testing.assert_allclose(lxt.numpy()[ok], np.asarray(lxj)[ok], atol=TOL * scale)
    np.testing.assert_allclose(lut.numpy()[ok], np.asarray(luj)[ok], atol=TOL * scale)
    assert Xt.shape == Xj.shape and Ut.shape == Uj.shape and st.dtype == torch.int32


def test_lanes_on_different_rho_match_vmapped_jax():
    """h50 with the state box, the rho rule at every check: lanes split
    over the grid, each check launches K3 once per rho with open lanes,
    and every lane takes JAX's walk (statuses, counts, solutions, duals)."""
    cfg = dict(max_iter=1000, adapt_interval=25)
    jc, tc = _pair(50, cfg, mpc_state_constraint=True)
    j, t, groups = _solve_pair(jc, tc, _e0s(0.15))
    _held(j, t)
    assert (t[2].numpy() == 0).all()
    assert len({r for r, _ in groups.calls}) >= 2  # lanes on two rhos at least
    assert max(n for _, n in groups.calls) <= B
    # at most R launches a check
    R = len(tc.engine.op.rho_grid)
    checks = -(-int(t[3].max()) // 25)
    assert len(groups.calls) <= R * checks


BRANCHES = {
    "none": dict(),
    "contractive": dict(mpc_terminal_ingredient="contractive"),
    "equality": dict(mpc_terminal_ingredient="equality"),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branches_match_vmapped_jax(branch):
    """K3's other branches at h12, the rho rule at every check; the
    equality terminal near the reference, where it is reachable."""
    cfg = dict(max_iter=3000, adapt_interval=25, eps_abs=1e-5, eps_rel=1e-5)
    jc, tc = _pair(12, cfg, **BRANCHES[branch])
    spread = 0.002 if branch == "equality" else 0.1
    j, t, groups = _solve_pair(jc, tc, _e0s(spread, seed=1))
    _held(j, t)
    assert (t[2].numpy() == 0).all()
    if branch == "contractive":
        r = np.sqrt(0.9) * np.linalg.norm(_e0s(spread, seed=1), axis=1)
        assert (np.linalg.norm(t[0].numpy()[:, -1], axis=1) <= r + 1e-4).all()


def test_warm_start_and_infeasible_lane():
    """A warm pair (U, lamX, lamU) carried in; a lane whose equality
    terminal is out of reach certified infeasible beside one near the
    reference that is not, in both packages."""
    cfg = dict(max_iter=2000, adapt_interval=25)
    jc, tc = _pair(12, cfg, mpc_state_constraint=True)
    e0 = _e0s(0.1, seed=2)
    _, t0, _ = _solve_pair(jc, tc, e0)
    warm = tuple(v.numpy() for v in (t0[1], *t0[6]))
    j, t, _ = _solve_pair(jc, tc, e0, warm)
    _held(j, t)
    assert int(t[3].max()) <= int(t0[3].max())

    jc, tc = _pair(3, dict(max_iter=4000), mpc_terminal_ingredient="equality")
    e0 = np.vstack([np.full((1, 4), 0.3), np.full((1, 4), 0.001)]).astype(np.float32)
    j, t, _ = _solve_pair(jc, tc, e0)
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    assert int(t[2][0]) == STATUS_PRIMAL_INFEASIBLE and int(t[2][1]) != STATUS_PRIMAL_INFEASIBLE


def test_riccati_escalation_matches_jax():
    """solve_batch_escalated on a Riccati engine: tier 1 (the port: K3's
    fused driver, one rho for the batch; JAX: its per-lane engine) leaves
    stragglers at a short budget, tier 2 restarts them from the original
    warm pair on the per-lane engine of a deeper fallback. Every lane ends
    converged in both, on the same solutions."""
    cfg = dict(max_iter=50)
    jc, tc = _pair(12, cfg, mpc_state_constraint=True)
    deep = dict(cfg, max_iter=2000)
    jfb = jc.replace(engine=dataclasses.replace(jc.engine, config=jric.RiccatiConfig(**deep)))
    tfb = tc.replace(engine=tc.engine.replace(config=tric.RiccatiConfig(**deep)))
    rng = np.random.default_rng(3)
    x0 = np.clip(0.65 + 0.1 * rng.standard_normal((B, 4)), 0.3, 1.3).astype(np.float32)
    t1, _, _, _ = tpar.solve_batch_auto(tc, torch.from_numpy(x0))
    stragglers = int((t1.status == tmpc.STATUS_MAX_ITER).sum())
    assert stragglers > 0
    twz, twy = tpar.init_warm_batch(tc, B)
    jwz, jwy = jpar.init_warm_batch(jc, B)
    calls = dict(admm_fused.PLAIN_CALLS)
    ts, _, _, td = tpar.solve_batch_escalated(tc, tfb, torch.from_numpy(x0), twz, twy)
    # tier 1 on the fused driver, tier 2 on the per-lane engine: both K3
    assert admm_fused.PLAIN_CALLS["K3"] > calls["K3"]
    js, _, _, jd = jpar.solve_batch_escalated(jc, jfb, jnp.asarray(x0), jwz, jwy)
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    assert int(td.n_converged) == B
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), atol=2e-4)
    # iteration counts continue tier 1's on the re-solved lanes
    redo = t1.status.numpy() == tmpc.STATUS_MAX_ITER
    assert (ts.iterations.numpy()[redo] > t1.iterations.numpy()[redo]).all()
    np.testing.assert_array_equal(ts.iterations.numpy()[~redo], t1.iterations.numpy()[~redo])


def test_solve_batch_runs_the_per_lane_engine():
    """parallel.solve_batch on a Riccati engine is the per-lane engine, with
    the shifted warm carry of the fused path."""
    jc, tc = _pair(12, dict(max_iter=1000), mpc_state_constraint=True)
    rng = np.random.default_rng(4)
    x0 = np.clip(0.65 + 0.1 * rng.standard_normal((5, 4)), 0.3, 1.3).astype(np.float32)
    ts, twz, twy, td = tpar.solve_batch(tc, torch.from_numpy(x0))
    js, jwz, jwy, jd = jpar.solve_batch(jc, jnp.asarray(x0))
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_array_equal(ts.iterations.numpy(), np.asarray(js.iterations))
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), atol=TOL)
    np.testing.assert_allclose(twz.numpy(), np.asarray(jwz), atol=TOL)
    assert twy.shape == tuple(jwy.shape)


def test_wide_plant_raises():
    """Plants wider than K3's widest register tier (32, 16): K3's own plan
    raises ValueError, and the per-lane engine routes them to K3W
    (``tests/test_torch_riccati_wider.py`` solves one)."""
    _, tc = _pair(5, dict(max_iter=100))
    op = tc.engine.op
    wide = op.replace(nx=riccati_fused.MAX_NX + 1)
    with pytest.raises(ValueError, match="nx <="):
        riccati_fused.k3_plan(wide, 2)
    chunk = riccati_fused.riccati_chunk_fn(wide, tc.engine.config, "per-lane")
    assert chunk is riccati_fused.iterate_chunk_riccati_wide
