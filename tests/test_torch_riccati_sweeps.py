"""The parallel-in-time Riccati sweeps (``RiccatiConfig.parallel_sweeps``),
port vs the JAX package.

The doubling levels are designed in f64 by the same numpy code, so the
port's f32 levels equal the JAX package's bit for bit. The port's doubling
w-update (``riccati.lqr_affine_solve_pscan``, the plain version of K3W's
doubling form) sums each small product in fp64 where XLA sums in fp32, so
it is held to JAX's ``_lqr_affine_solve_pscan`` and ``_lqr_affine_solve``
within 1e-5 of max(1, ||ref||_inf), and whole solves within 1e-4 on u
(``tests/test_torch_riccati_engine.py``'s TOL) with statuses lane by lane.
Inputs are made with numpy from a seed and handed to both packages.
"""

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
from automationlabsmodelpredictivecontrol_jl_torch import interop
from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused, riccati_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati as tric

torch.set_num_threads(1)

TOL = 1e-4  # whole solves, on u
PRE_TOL = 1e-5  # one w-update, relative to max(1, ||ref||_inf)
B = 8
LEVELS = ("bwd_levels", "bwd_full", "fwd_levels", "fwd_full")
KINDS = {
    "state": dict(mpc_state_constraint=True),
    "equality": dict(mpc_terminal_ingredient="equality"),
    "contractive": dict(mpc_terminal_ingredient="contractive"),
}


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


@pytest.fixture(scope="module")
def h24():
    cfg = dict(max_iter=1000, parallel_sweeps=True)
    return {k: _pair(24, cfg, **kw) for k, kw in KINDS.items()}


def _operators(N):
    """The h-N operators of both packages from the same numpy inputs: the
    QTP with a state box, Q 100, R 0.1, P = 2 Q."""
    A = np.asarray(jqtp.linearized_discrete_system().A, np.float64)
    Bm = np.asarray(jqtp.linearized_discrete_system().B, np.float64)
    args = (A, Bm, 100.0 * np.eye(4), 0.1 * np.eye(2), 200.0 * np.eye(4), N,
            np.full(4, -0.45), np.full(4, 0.6), np.full(2, -1.2), np.full(2, 0.8), True)
    return jric.build_riccati_operator(*args), tric.build_riccati_operator(*args)


def _assert_levels_equal(jop, top):
    for name in LEVELS:
        a, b = getattr(top, name), torch.from_numpy(np.array(getattr(jop, name)))
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert torch.equal(a, b), name


def test_levels_equal_jax_on_the_h24_state_box(h24):
    jc, tc = h24["state"]
    _assert_levels_equal(jc.engine.op, tc.engine.op)
    R = len(tc.engine.op.rho_grid)
    assert tuple(tc.engine.op.bwd_levels.shape) == (R, 5, 24, 4, 4)


@pytest.mark.parametrize("N", [1, 2, 5])
def test_levels_equal_jax_at_short_horizons(N):
    """N = 1 has one level of zeros and no combine step; N = 2 one level;
    N = 5 three, the last of stride 4."""
    jop, top = _operators(N)
    _assert_levels_equal(jop, top)
    assert top.bwd_levels.shape[1] == max(1, int(np.ceil(np.log2(N))))
    if N == 1:
        assert not bool(top.bwd_levels.any())
        assert torch.equal(top.fwd_full, top.factors.AmBK)


def _w_inputs(N, nx, nu, seed):
    rng = np.random.default_rng(seed)
    draw = lambda *shape: (0.3 * rng.standard_normal(shape)).astype(np.float32)
    return draw(B, nx), draw(B, N - 1, nx), draw(B, nx), draw(B, N, nu), draw(B, N, nx)


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=PRE_TOL * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("N", [1, 2, 5, 24])
@pytest.mark.parametrize("ridx", [0, 3])
def test_pscan_matches_jax(N, ridx):
    """One w-update: ``lqr_affine_solve_pscan`` against JAX's doubling and
    sequential solves, and ``affine_prefix`` against ``_affine_prefix``,
    lane by lane (the port lane-last, JAX vmapped over lanes)."""
    jop, top = _operators(N)
    e0, lint, lxn, lu, b = _w_inputs(N, 4, 2, seed=N + ridx)
    lane_last = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, 0, -1)))
    X, U = tric.lqr_affine_solve_pscan(
        top, ridx, lane_last(e0), lane_last(lint), lane_last(lxn), lane_last(lu))
    for solve in (jric._lqr_affine_solve_pscan, jric._lqr_affine_solve):
        jX, jU = jax.vmap(lambda *a: solve(jop, jnp.int32(ridx), *a))(*map(jnp.asarray, (e0, lint, lxn, lu)))
        _close(np.moveaxis(X.numpy(), -1, 0), jX)
        _close(np.moveaxis(U.numpy(), -1, 0), jU)
    y = tric.affine_prefix(top.fwd_levels[ridx], top.fwd_full[ridx], lane_last(b), lane_last(e0))
    jy = jax.vmap(lambda bi, y0: jric._affine_prefix(
        jop.fwd_levels[ridx], jop.fwd_full[ridx], bi, y0, N))(jnp.asarray(b), jnp.asarray(e0))
    _close(np.moveaxis(y.numpy(), -1, 0), jy)


# initial spreads about the reference: the equality terminal's lanes are
# feasible only close to it
SPREAD = {"state": 0.1, "equality": 0.01, "contractive": 0.1}


def _held(status, u, j_status, j_u):
    """Statuses equal lane by lane, u within TOL where converged, and most
    lanes converged."""
    np.testing.assert_array_equal(status, np.asarray(j_status))
    ok = status == 0
    assert ok.sum() >= B // 2
    np.testing.assert_allclose(u[ok], np.asarray(j_u)[ok], atol=TOL)


def _e0s(spread, seed, n=B):
    rng = np.random.default_rng(seed)
    x0 = np.clip(0.65 + spread * rng.standard_normal((n, 4)), 0.3, 1.3)
    return (x0 - 0.65).astype(np.float32)


@pytest.mark.parametrize("kind", list(KINDS))
def test_per_lane_engine_with_parallel_sweeps_matches_vmapped_jax(h24, kind):
    """The per-lane engine under ``parallel_sweeps`` against JAX's vmapped
    ``solve_sparse`` with the same flag: statuses equal, U within 1e-4. On
    the CPU the doubling form's plain version runs, and nothing else."""
    jc, tc = h24[kind]
    e0s = _e0s(SPREAD[kind], seed=len(kind))
    j = jax.vmap(lambda e: jric.solve_sparse(jc.engine.op, e, config=jc.engine.config))(
        jnp.asarray(e0s))
    admm_fused.reset_counts()
    t = riccati_fused.solve_sparse(tc.engine.op, torch.from_numpy(e0s), config=tc.engine.config)
    _held(t[2].numpy(), t[1].numpy(), j[2], j[1])
    assert admm_fused.PLAIN_CALLS["K3W-doubling"] > 0
    assert admm_fused.PLAIN_CALLS["K3"] == admm_fused.PLAIN_CALLS["K3W"] == 0
    assert not any(admm_fused.LAUNCHES.values())


def test_parallel_sweeps_match_sequential(h24):
    """The mirror of the JAX package's test of the same name: one lane of
    the h24 state box with ``parallel_sweeps`` True and False, U within
    1e-4, both converged."""
    _, tc = h24["state"]
    e0 = torch.tensor([[-0.05, 0.02, -0.04, 0.03]])
    outs = {}
    for ps in (False, True):
        cfg = dataclasses.replace(tc.engine.config, max_iter=600, parallel_sweeps=ps)
        outs[ps] = riccati_fused.solve_sparse(tc.engine.op, e0, config=cfg)
    np.testing.assert_allclose(outs[True][1].numpy(), outs[False][1].numpy(), atol=TOL)
    assert int(outs[True][2][0]) == int(outs[False][2][0]) == 0


def test_routing_under_parallel_sweeps(h24):
    """parallel.solve_batch takes the doubling form under the flag; the
    fused driver does not read the flag and keeps K3."""
    _, tc = h24["contractive"]
    x0 = torch.from_numpy(_e0s(0.1, seed=5) + 0.65)
    admm_fused.reset_counts()
    sol, _, _, d = tpar.solve_batch(tc, x0)
    assert int(d.n_converged) == B
    assert admm_fused.PLAIN_CALLS["K3W-doubling"] > 0 and admm_fused.PLAIN_CALLS["K3"] == 0
    admm_fused.reset_counts()
    fused, _, _, _ = tpar.solve_batch_auto(tc, x0)
    assert admm_fused.PLAIN_CALLS["K3"] > 0 and admm_fused.PLAIN_CALLS["K3W-doubling"] == 0
    np.testing.assert_allclose(fused.u.numpy(), sol.u.numpy(), atol=5e-4)


def _export(jc):
    """The JAX Riccati controller's designed arrays as numpy, for interop."""
    op, t = jc.engine.op, jc.tuning
    as_np = lambda v: v if isinstance(v, (bool, int, float, tuple)) or v is None else np.asarray(v)
    ops = {f.name: as_np(getattr(op, f.name)) for f in dataclasses.fields(op) if f.name != "factors"}
    ops["factors"] = {f.name: np.asarray(getattr(op.factors, f.name))
                      for f in dataclasses.fields(op.factors)}
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


def test_interop_carries_the_levels_and_solves_with_parallel_sweeps(h24):
    """A JAX Riccati controller carried across keeps its four level arrays
    bit for bit, and its per-lane solve under ``parallel_sweeps`` on the
    CPU is JAX's: statuses equal, u within 1e-4."""
    jc, tc = h24["equality"]
    rc = interop.controller_from_numpy(**_export(jc), device="cpu")
    assert rc.engine.config.parallel_sweeps
    _assert_levels_equal(jc.engine.op, rc.engine.op)
    for name in LEVELS:
        assert torch.equal(getattr(rc.engine.op, name), getattr(tc.engine.op, name)), name
    x0 = _e0s(SPREAD["equality"], seed=7) + 0.65
    admm_fused.reset_counts()
    rs, _, _, _ = tpar.solve_batch(rc, torch.from_numpy(x0))
    assert admm_fused.PLAIN_CALLS["K3W-doubling"] > 0
    js, _, _, _ = jpar.solve_batch(jc, jnp.asarray(x0))
    _held(rs.status.numpy(), rs.u.numpy(), js.status, js.u)


def test_io_round_trip_designs_the_levels(h24, tmp_path):
    """``load_controller`` re-designs a saved Riccati controller, so its
    levels are the design's own, bit for bit."""
    _, tc = h24["state"]
    path = str(tmp_path / "ctrl.npz")
    tmpc.save_controller(path, tc)
    lc = tmpc.load_controller(path, device="cpu")
    assert lc.engine.config.parallel_sweeps
    for name in LEVELS:
        assert torch.equal(getattr(lc.engine.op, name), getattr(tc.engine.op, name)), name
