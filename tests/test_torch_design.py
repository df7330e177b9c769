"""Port vs JAX controller design: the host design is the same numpy f64
code in both packages, so the stored f32 arrays must agree bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig as JConfig

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import interop
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig as TConfig

torch.set_num_threads(1)

X_REF = [0.65] * 4
U_REF = [1.2] * 2
CFG = dict(max_iter=75, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0)


def export(jc):
    """The JAX controller's designed arrays as numpy, for interop."""
    eng = jc.engine
    as_np = lambda rec: {
        f.name: (getattr(rec, f.name) if isinstance(getattr(rec, f.name), (int, float, bool, str))
                 else np.asarray(getattr(rec, f.name)))
        for f in dataclasses.fields(rec)
    }
    t = jc.tuning
    return dict(
        qp=as_np(eng.qp),
        op=as_np(eng.op),
        references=as_np(t.references),
        weights=as_np(t.weights),
        terminal_P=np.asarray(t.terminal.P),
        config=dataclasses.asdict(eng.config),
        tuning=dict(
            horizon=t.horizon, sample_time=t.sample_time, max_time=t.max_time,
            programming_type=t.programming_type, solver_name=t.solver_name,
            state_constraint=t.state_constraint, terminal_kind=t.terminal.kind,
        ),
    )


@pytest.fixture(scope="module", params=[5, 10, 20], ids=lambda h: f"h{h}")
def pair(request):
    h = request.param
    jc = jmpc.proceed_controller(
        jqtp.linearized_discrete_system(), "model_predictive_control", h, 5.0,
        np.asarray(X_REF), np.asarray(U_REF), admm_config=JConfig(**CFG),
    )
    tc = tmpc.proceed_controller(
        tqtp.linearized_discrete_system(), "model_predictive_control", h, 5.0,
        X_REF, U_REF, admm_config=TConfig(**CFG), device="cpu",
    )
    return jc, tc


def _bits_equal(a, b, name):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, name
    assert a.dtype == b.dtype == np.float32, name
    assert np.array_equal(a.view(np.int32), b.view(np.int32)), name


def test_plant_matches(pair):
    jc, tc = pair
    _bits_equal(jc.system.A, tc.system.A, "A")
    _bits_equal(jc.system.B, tc.system.B, "B")


def test_condensed_qp_bitwise(pair):
    jc, tc = pair
    jqp, tqp = jc.engine.qp, tc.engine.qp
    for f in dataclasses.fields(jqp):
        jv, tv = getattr(jqp, f.name), getattr(tqp, f.name)
        if isinstance(jv, (int, float)):
            assert jv == tv, f.name
        else:
            _bits_equal(jv, tv, f.name)


def test_admm_operator_bitwise(pair):
    jc, tc = pair
    jop, top = jc.engine.op, tc.engine.op
    for f in dataclasses.fields(jop):
        jv, tv = getattr(jop, f.name), getattr(top, f.name)
        if isinstance(jv, (bool, int)):
            assert jv == tv, f.name
        else:
            _bits_equal(jv, tv, f.name)
    assert top.diag_a and not top.mixed_a


def test_tuning_bitwise(pair):
    jc, tc = pair
    jt, tt = jc.tuning, tc.tuning
    _bits_equal(jt.terminal.P, tt.terminal.P, "terminal P")
    for name in ("x", "u"):
        _bits_equal(getattr(jt.references, name), getattr(tt.references, name), name)
    for name in ("Q", "R", "S"):
        _bits_equal(getattr(jt.weights, name), getattr(tt.weights, name), name)
    assert (tt.horizon, tt.solver_name, tt.programming_type) == (
        jt.horizon, jt.solver_name, jt.programming_type
    )


def test_controller_from_numpy_round_trips(pair):
    jc, tc = pair
    rc = interop.controller_from_numpy(**export(jc), device="cpu")
    assert rc.engine.config == tc.engine.config
    for rec_r, rec_t in ((rc.engine.qp, tc.engine.qp), (rc.engine.op, tc.engine.op)):
        for f in dataclasses.fields(rec_t):
            a, b = getattr(rec_r, f.name), getattr(rec_t, f.name)
            if isinstance(b, torch.Tensor):
                _bits_equal(a, b, f.name)
            else:
                assert a == b, f.name
    _bits_equal(rc.tuning.terminal.P, tc.tuning.terminal.P, "P")
    assert rc.warm_z.shape == tc.warm_z.shape and rc.warm_y.shape == tc.warm_y.shape
    assert (rc.nx, rc.nu) == (4, 2)


def test_escalation_operator_bitwise(pair):
    from automationlabsmodelpredictivecontrol_jl_tpu import parallel as jpar
    from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar

    jc, tc = pair
    jfb = jpar.escalation_controller(jc, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250)
    tfb = tpar.escalation_controller(tc, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250)
    assert jfb.engine.config == jfb.engine.config.__class__(**dataclasses.asdict(tfb.engine.config))
    for name in ("Ks", "K_invs", "rho_vecs", "rho_invs", "rho_grid"):
        _bits_equal(getattr(jfb.engine.op, name), getattr(tfb.engine.op, name), name)


def test_unported_branches_raise():
    """Every branch is ported and designs what the JAX package designs for
    the same call: the economic engine over a linear plant (always the NLP
    route), the tracking QP where an EmpcConfig or a terminal cost comes
    without a stage cost, the QP for an sqp_config on a linear plant, and a
    ValueError for mixed_linear on a linear plant and for an unknown
    controller type."""
    sys = tqtp.linearized_discrete_system()
    jsys = jqtp.linearized_discrete_system()
    c = tmpc.proceed_controller(
        sys, "economic_model_predictive_control", 5, 5.0, X_REF, U_REF,
        mpc_cost_function=lambda x, u: 0.0, device="cpu",
    )
    jc = jmpc.proceed_controller(
        jsys, "economic_model_predictive_control", 5, 5.0, np.asarray(X_REF),
        np.asarray(U_REF), mpc_cost_function=lambda x, u: 0.0,
    )
    assert type(c.engine).__name__ == type(jc.engine).__name__ == "EmpcEngine"
    assert c.tuning.programming_type == jc.tuning.programming_type == "non_linear"
    assert c.engine.m_total == jc.engine.m_total
    for key in ("empc_config", "mpc_terminal_cost_function"):
        c = tmpc.proceed_controller(
            sys, "model_predictive_control", 5, 5.0, X_REF, U_REF, device="cpu",
            **{key: object()},
        )
        assert isinstance(c.engine, tmpc.LinearEngine)
    for m in (tmpc, jmpc):
        with pytest.raises(ValueError, match="ReLU-network"):
            m.proceed_controller(
                tqtp.linearized_discrete_system() if m is tmpc else jsys,
                "model_predictive_control", 5, 5.0, np.asarray(X_REF), np.asarray(U_REF),
                mpc_programming_type="mixed_linear", **({"device": "cpu"} if m is tmpc else {}),
            )
    c = tmpc.proceed_controller(
        sys, "model_predictive_control", 5, 5.0, X_REF, U_REF, sqp_config=tmpc.SqpConfig(),
        device="cpu",
    )
    assert isinstance(c.engine, tmpc.LinearEngine) and c.tuning.programming_type == "linear"
    with pytest.raises(ValueError):
        tmpc.proceed_controller(sys, "nonsense", 5, 5.0, X_REF, U_REF, device="cpu")


def test_entry_points_default_to_the_card():
    """Without ``device=`` every entry point asks for the card, and raises
    where there is none: nothing carries on on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    sys = tqtp.linearized_discrete_system()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmpc.proceed_controller(sys, "model_predictive_control", 5, 5.0, X_REF, U_REF)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmpc.design_controller(sys, 5, 5.0, X_REF, U_REF)
    jc = jmpc.proceed_controller(
        jqtp.linearized_discrete_system(), "model_predictive_control", 5, 5.0,
        np.asarray(X_REF), np.asarray(U_REF),
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.controller_from_numpy(**export(jc))


@pytest.fixture(scope="module", params=[10, 20], ids=lambda h: f"h{h}")
def neighborhood_pair(request):
    kw = dict(mpc_terminal_ingredient="neighborhood")
    jc = jmpc.proceed_controller(
        jqtp.linearized_discrete_system(), "model_predictive_control", request.param,
        5.0, np.asarray(X_REF), np.asarray(U_REF), **kw,
    )
    tc = tmpc.proceed_controller(
        tqtp.linearized_discrete_system(), "model_predictive_control", request.param,
        5.0, X_REF, U_REF, device="cpu", **kw,
    )
    return jc, tc


def test_neighborhood_controller_designs(neighborhood_pair):
    """The neighborhood terminal: its set, its condensed rows (H G_last with
    l = -inf, u = b, b_x0 = -H F_last) and the mixed operator, against the
    JAX design."""
    jc, tc = neighborhood_pair
    jt, tt = jc.tuning.terminal, tc.tuning.terminal
    assert tt.kind == "neighborhood" and tt.H.shape == np.asarray(jt.H).shape
    np.testing.assert_allclose(tt.H.numpy(), np.asarray(jt.H), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.b.numpy(), np.asarray(jt.b), rtol=0, atol=1e-6)
    jqp, tqp = jc.engine.qp, tc.engine.qp
    n_h = tt.H.shape[0]
    assert tqp.A.shape == (tqp.N * 2 + n_h, tqp.N * 2)
    for name in ("A", "l_const", "u_const", "b_x0"):
        np.testing.assert_allclose(
            getattr(tqp, name).numpy()[-n_h:], np.asarray(getattr(jqp, name))[-n_h:],
            rtol=0, atol=1e-6, err_msg=name,
        )
    assert np.all(np.isneginf(tqp.l_const.numpy()[-n_h:]))
    assert tc.engine.op.mixed_a and not tc.engine.op.diag_a
    _bits_equal(jc.engine.op.K_invs, tc.engine.op.K_invs, "K_invs")


def test_neighborhood_controller_round_trips(neighborhood_pair):
    """interop carries a neighborhood terminal's set across."""
    jc, tc = neighborhood_pair
    ex = export(jc)
    ex.update(terminal_H=np.asarray(jc.tuning.terminal.H), terminal_b=np.asarray(jc.tuning.terminal.b))
    rc = interop.controller_from_numpy(**ex, device="cpu")
    assert rc.tuning.terminal.kind == "neighborhood"
    _bits_equal(rc.tuning.terminal.H, tc.tuning.terminal.H, "H")
    _bits_equal(rc.tuning.terminal.b, tc.tuning.terminal.b, "b")
    for f in dataclasses.fields(tc.engine.op):
        a, b = getattr(rc.engine.op, f.name), getattr(tc.engine.op, f.name)
        if isinstance(b, torch.Tensor):
            _bits_equal(a, b, f.name)
        else:
            assert a == b, f.name
    _bits_equal(rc.engine.qp.u_const, tc.engine.qp.u_const, "u_const")


@pytest.mark.parametrize(
    "kw",
    [dict(mpc_terminal_ingredient="equality"), dict(mpc_terminal_ingredient="neighborhood"),
     dict(mpc_state_constraint=True),
     dict(mpc_state_constraint=True, mpc_terminal_ingredient="neighborhood")],
    ids=["equality", "neighborhood", "state", "state+neighborhood"],
)
def test_h20_row_configs_are_mixed(kw):
    """Every h20 QP with state or terminal rows is mixed (the input-box
    rows first, diagonal), in the port as in the JAX package, and K2 takes
    its shape at the suite's R=5/refine 1."""
    jc = jmpc.proceed_controller(
        jqtp.linearized_discrete_system(), "model_predictive_control", 20, 5.0,
        np.asarray(X_REF), np.asarray(U_REF), **kw,
    )
    tc = tmpc.proceed_controller(
        tqtp.linearized_discrete_system(), "model_predictive_control", 20, 5.0,
        X_REF, U_REF, device="cpu", **kw,
    )
    jop, top = jc.engine.op, tc.engine.op
    assert (top.mixed_a, top.diag_a) == (bool(jop.mixed_a), bool(jop.diag_a)) == (True, False)
    _bits_equal(jop.A_s, top.A_s, "A_s")
    m, n = top.A_s.shape
    assert admm_fused.k2_fits(n, m, 5, 1)
