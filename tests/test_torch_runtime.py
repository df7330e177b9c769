"""The port's runtime (``solve_once``, ``step``, ``calculate``, the
reference updates) and the shapes no kernel takes, port vs the frozen f64
goldens and vs the JAX package.

``step`` is held to tests/golden/qtp_golden.npz directly, at the JAX
package's own bars (tests/test_golden_parity.py): u within 1e-4 and x
within 5e-4 on the 19 feasible rows (condensed engine), u within 1e-4 on
the 8 rows its Riccati engine is held to, status 2 on the infeasible row.
Where no golden exists the JAX package runs live on the same inputs, made
with numpy from a seed: the contractive and soft controllers through
``solve_batch_auto`` (both packages take their general engine there),
five steps of warm carry, and the reference updates."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu import parallel as jpar
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig as JAdmm
from automationlabsmodelpredictivecontrol_jl_tpu.ops.riccati import RiccatiConfig as JRicc

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig as TAdmm
from automationlabsmodelpredictivecontrol_jl_torch.ops.condense import (
    runtime_qp_vectors,
    runtime_qp_vectors_batch,
)
from automationlabsmodelpredictivecontrol_jl_torch.ops.riccati import RiccatiConfig as TRicc

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
_GOLDEN = np.load(os.path.join(GOLDEN_DIR, "qtp_golden.npz"))
with open(os.path.join(GOLDEN_DIR, "qtp_golden_meta.json")) as f:
    _META = json.load(f)["configs"]
_FEASIBLE = [c for c in _META if c["status"] == 0]
_INFEASIBLE = [c for c in _META if c["status"] != 0]
_RICCATI_OK = [
    c for c in _FEASIBLE if c["horizon"] == 5 and (
        c["terminal"] == "none" or (c["terminal"] == "equality" and c["R"] == 0.1)
    )
]
# the JAX package's parity-grade configs (tests/test_golden_parity.py)
_ADMM = dict(max_iter=20000, refine_steps=2)
_RICC = dict(max_iter=20000, eps_abs=1e-6, eps_rel=1e-6)
X_REF, U_REF = [0.65] * 4, [1.2] * 2
TOL = 1e-4  # the engines' bar to the goldens, and live engine vs engine


def _golden_controller(cfg, engine="condensed"):
    kw = dict(mpc_terminal_ingredient=cfg["terminal"], mpc_R=cfg["R"], engine=engine)
    if engine == "condensed":
        kw["admm_config"] = TAdmm(**_ADMM)
    else:
        kw["riccati_config"] = TRicc(**_RICC)
    if cfg["state_constraint"]:
        kw["mpc_state_constraint"] = True
    return tmpc.proceed_controller(
        tqtp.linearized_discrete_system(), "model_predictive_control", cfg["horizon"], 5.0,
        X_REF, U_REF, device="cpu", **kw,
    )


def _x0(cfg):
    return torch.tensor(cfg.get("x0", [0.6] * 4), dtype=torch.float32)


@pytest.mark.parametrize("cfg", _FEASIBLE, ids=[c["key"] for c in _FEASIBLE])
def test_step_matches_frozen_golden(cfg):
    c = _golden_controller(cfg)
    c, sol = tmpc.step(c, _x0(cfg))
    assert int(sol.status) == 0
    np.testing.assert_allclose(sol.u.numpy().T, _GOLDEN[cfg["key"] + "__u"], atol=TOL)
    np.testing.assert_allclose(sol.x.numpy().T, _GOLDEN[cfg["key"] + "__x"], atol=5e-4)


@pytest.mark.parametrize("cfg", _RICCATI_OK, ids=[c["key"] for c in _RICCATI_OK])
def test_riccati_step_matches_frozen_golden(cfg):
    """The per-lane Riccati engine (K3's plain version here) through
    ``step``."""
    c = _golden_controller(cfg, engine="riccati")
    assert isinstance(c.engine, tmpc.RiccatiEngine)
    c, sol = tmpc.step(c, _x0(cfg))
    assert int(sol.status) == 0
    np.testing.assert_allclose(sol.u.numpy().T, _GOLDEN[cfg["key"] + "__u"], atol=TOL)


@pytest.mark.parametrize("cfg", _INFEASIBLE, ids=[c["key"] for c in _INFEASIBLE])
def test_frozen_infeasibility_certificate(cfg):
    c = _golden_controller(cfg)
    c, sol = tmpc.step(c, _x0(cfg))
    assert int(sol.status) == tmpc.STATUS_PRIMAL_INFEASIBLE
    assert bool(torch.isfinite(sol.u).all())


def _pair(horizon, admm=None, ricc=None, **kw):
    jkw, tkw = dict(kw), dict(kw)
    if admm is not None:
        jkw["admm_config"], tkw["admm_config"] = JAdmm(**admm), TAdmm(**admm)
    if ricc is not None:
        jkw["riccati_config"], tkw["riccati_config"] = JRicc(**ricc), TRicc(**ricc)
    jc = jmpc.proceed_controller(
        jqtp.linearized_discrete_system(), "model_predictive_control", horizon, 5.0,
        np.asarray(X_REF), np.asarray(U_REF), **jkw,
    )
    tc = tmpc.proceed_controller(
        tqtp.linearized_discrete_system(), "model_predictive_control", horizon, 5.0,
        X_REF, U_REF, device="cpu", **tkw,
    )
    return jc, tc


def _suite_x0s(B, seed=0):
    rng = np.random.default_rng(seed)
    return (0.65 + 0.002 * rng.standard_normal((B, 4))).astype(np.float32)


def _close(ts, js, tol=TOL):
    """u and x within tol; the objective (up to ~3e3 from outside the
    box) within tol relative."""
    for f in ("u", "x", "objective"):
        np.testing.assert_allclose(
            getattr(ts, f).numpy(), np.asarray(getattr(js, f)), atol=tol, err_msg=f,
            rtol=tol if f == "objective" else 0,
        )


# the soft rows at the tolerance the JAX package's soft test asks for (a
# 1e3 penalty raises the fp32 residual floor to ~1e-5), so their solutions
# are held at the package's fused-vs-engine bar, 5e-4
SHAPES_NO_KERNEL = {
    "contractive": (dict(max_iter=4000), dict(mpc_terminal_ingredient="contractive"), TOL),
    "soft": (dict(max_iter=4000, eps_abs=1e-4, eps_rel=1e-4),
             dict(mpc_soft_state_constraint=1e3), 5e-4),
}


@pytest.mark.parametrize("kind", list(SHAPES_NO_KERNEL))
def test_no_kernel_shapes_solve_through_auto(kind):
    """The contractive terminal (a ball block) and soft state rows design
    fine and take no kernel: solve_batch_auto falls to solve_batch, the
    general engine, in the port as in JAX."""
    admm, kw, tol = SHAPES_NO_KERNEL[kind]
    jc, tc = _pair(20, admm=admm, **kw)
    assert not tpar.fused_supported(tc) and not jpar.fused_supported(jc)
    if kind == "contractive":
        assert tc.engine.op.n_ball == 4
    else:
        assert tc.engine.soft_mu is not None
    x0 = _suite_x0s(16)
    if kind == "soft":
        x0[3] = [1.45, 1.45, 1.4, 1.4]  # outside the state box: soft rows stay feasible
    before = dict(admm_fused.PLAIN_CALLS)
    ts, twz, twy, td = tpar.solve_batch_auto(tc, torch.from_numpy(x0))
    assert admm_fused.PLAIN_CALLS == before  # no kernel, not even its plain version
    js, jwz, jwy, jd = jpar.solve_batch_auto(jc, jnp.asarray(x0))
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    assert int(td.n_converged) == 16
    _close(ts, js, tol=tol)
    np.testing.assert_allclose(twz.numpy(), np.asarray(jwz), atol=tol)
    if kind == "contractive":
        e_end = ts.e_x.numpy()[:, :, -1]
        r = np.sqrt(0.9) * np.linalg.norm(x0 - 0.65, axis=1)
        assert (np.linalg.norm(e_end, axis=1) <= r + 1e-4).all()


def _drive(controller, step, plant, x, steps):
    out = []
    for _ in range(steps):
        controller, sol = step(controller, x)
        out.append((sol, controller.warm_z, controller.warm_y))
        x = plant(x, sol.u[:, 0])
    return out


@pytest.mark.parametrize("engine", ["condensed", "riccati"])
def test_five_steps_of_warm_carry_match_jax(engine):
    """step in a closed loop on the true plant: the shifted warm carry, the
    pinned state and every step's solution, in both packages."""
    if engine == "condensed":
        jc, tc = _pair(20, admm=dict(max_iter=2000), mpc_state_constraint=True)
    else:
        jc, tc = _pair(12, ricc=dict(max_iter=2000, eps_abs=1e-6, eps_rel=1e-6),
                       engine="riccati", mpc_terminal_ingredient="contractive")
    x0 = np.asarray([0.6, 0.62, 0.6, 0.61], np.float32)
    tout = _drive(tc, tmpc.step, tqtp.qtp_discrete_step, torch.from_numpy(x0), 5)
    jout = _drive(jc, jmpc.step, jqtp.qtp_discrete_step, jnp.asarray(x0), 5)
    for k, ((ts, twz, twy), (js, jwz, jwy)) in enumerate(zip(tout, jout)):
        assert int(ts.status) == int(js.status) == 0, k
        assert ts.u.shape == (2, ts.e_u.shape[1]) and ts.status.shape == ()
        _close(ts, js)
        np.testing.assert_allclose(twz.numpy(), np.asarray(jwz), atol=TOL, err_msg=f"wz {k}")
        # the dual carry is held on its own scale (duals of the tight rows)
        scale = max(1.0, float(np.abs(np.asarray(jwy)).max()))
        np.testing.assert_allclose(twy.numpy(), np.asarray(jwy), atol=TOL * scale, err_msg=f"wy {k}")
    # warm-started steps take no more iterations than the cold first one
    its = [int(s.iterations) for s, _, _ in tout]
    assert max(its[1:]) <= its[0]


def test_solve_once_calculate_and_initialization():
    _, tc = _pair(5)
    x0 = torch.tensor([0.6, 0.6, 0.6, 0.6])
    c = tmpc.update_initialization(tc, x0.numpy())
    assert torch.equal(c.initialization, x0) and c.initialization.dtype == torch.float32
    c = tmpc.calculate(c)
    sol = c.results
    assert sol.x.shape == (4, 6) and sol.u.shape == (2, 5)
    assert sol.status.shape == () and sol.iterations.shape == () and int(sol.status) == 0
    np.testing.assert_allclose(sol.x[:, 0].numpy(), x0.numpy(), atol=1e-6)
    sol2, wz, wy = tmpc.solve_once(tc, x0, tc.warm_z, tc.warm_y)
    assert torch.equal(sol2.u, sol.u) and torch.equal(wz, c.warm_z) and torch.equal(wy, c.warm_y)
    # the single-lane QP vectors are the batch form's at B = 1
    qp = tc.engine.qp
    e0 = x0 - 0.65
    single = runtime_qp_vectors(qp, e0)
    batch = runtime_qp_vectors_batch(qp, e0[None])
    assert [tuple(v.shape) for v in single] == [(10,), (10,), (10,), (0,), ()]
    for a, b in zip(single, batch):
        assert torch.equal(a, b[0])


def test_x0_outside_the_state_box():
    """A hard state box reports an x0 outside it as primal infeasible (the
    JAX runtime's check); soft rows never do, and steer back."""
    x0 = np.asarray([1.5, 1.5, 1.4, 1.4], np.float32)
    jc, tc = _pair(10, mpc_state_constraint=True)
    _, ts = tmpc.step(tc, torch.from_numpy(x0))
    _, js = jmpc.step(jc, jnp.asarray(x0))
    assert int(ts.status) == int(js.status) == tmpc.STATUS_PRIMAL_INFEASIBLE
    _, tc = _pair(10, admm=dict(max_iter=2000, eps_abs=1e-4, eps_rel=1e-4),
                  mpc_soft_state_constraint=1e3)
    _, ts = tmpc.step(tc, torch.from_numpy(x0))
    assert int(ts.status) == tmpc.STATUS_CONVERGED
    assert (ts.x.numpy()[:, -1] <= tqtp.x_box().hi.numpy() + 0.05).all()


@pytest.mark.parametrize("engine", ["condensed", "riccati"])
def test_update_references_and_update_and_compute(engine):
    """New references re-design the controller (DARE, terminal, operators)
    with the engine's config carried over, in both packages."""
    if engine == "condensed":
        kw = dict(admm=dict(max_iter=3000, rho_grid=(0.1, 1.0, 10.0)),
                  mpc_soft_state_constraint=500.0)
    else:
        kw = dict(ricc=dict(max_iter=2000, rho=0.2), engine="riccati",
                  mpc_state_constraint=True)
    jc, tc = _pair(8, **kw)
    xr, ur = np.full(4, 0.7), np.full(2, 1.3)
    tn = tmpc.update_references(tc, xr, ur)
    jn = jmpc.update_references(jc, xr, ur)
    assert type(tn.engine) is type(tc.engine)
    assert tn.engine.config == tc.engine.config
    np.testing.assert_allclose(tn.tuning.references.x.numpy(), np.asarray(jn.tuning.references.x))
    np.testing.assert_allclose(tn.tuning.terminal.P.numpy(), np.asarray(jn.tuning.terminal.P),
                               rtol=1e-6)
    if engine == "condensed":
        assert float(tn.engine.soft_mu[torch.isfinite(tn.engine.soft_mu)].min()) == 500.0
    x0 = np.asarray([0.68, 0.69, 0.7, 0.71], np.float32)
    tn2, ts = tmpc.update_and_compute(tc, torch.from_numpy(x0), x_ref=xr, u_ref=ur)
    jn2, js = jmpc.update_and_compute(jc, jnp.asarray(x0), x_ref=xr, u_ref=ur)
    assert int(ts.status) == int(js.status) == 0
    _close(ts, js, tol=5e-4 if engine == "riccati" else TOL)
    # without new references it is a step
    _, ts3 = tmpc.update_and_compute(tn2, torch.from_numpy(x0))
    assert int(ts3.status) == 0


def test_unported_engines_raise():
    """Every engine of the JAX package is ported; an object that is no
    engine raises at the solve in both packages, and update_references
    re-designs from the tuning as the JAX package's does."""
    jc, tc = _pair(5)
    odd, jodd = tc.replace(engine=object()), jc.replace(engine=object())
    x0 = torch.tensor([0.6] * 4)
    with pytest.raises(TypeError, match="not an engine"):
        tmpc.step(odd, x0)
    with pytest.raises(AttributeError):
        jmpc.step(jodd, jnp.asarray(x0.numpy()))
    tn = tmpc.update_references(odd, X_REF, U_REF)
    jn = jmpc.update_references(jodd, np.asarray(X_REF), np.asarray(U_REF))
    assert type(tn.engine).__name__ == type(jn.engine).__name__ == "LinearEngine"
