"""Checkpoints: the port loads what the JAX package's ``save_controller``
writes (at run time, into a temporary directory), and its own files
round-trip, on the CPU.

For a linear condensed controller, a Riccati one, the golden fnn's SQP
controller (single and multiple shooting), its soft-box SQP controller and
its linearized controller: the loaded controller is the one the port
designs from the same arguments (engine, config, weights, warm state,
parameters bit for bit), its designed arrays within 1e-5 of the JAX
controller's, and a step after loading resumes from the saved warm state.
The JAX package loads the port's files too."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu import io as jio
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.models import zoo as jzoo
from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig as JAdmm
from automationlabsmodelpredictivecontrol_jl_tpu.ops.riccati import RiccatiConfig as JRicc
from automationlabsmodelpredictivecontrol_jl_tpu.solvers.sqp import SqpConfig as JSqp

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import interop
from automationlabsmodelpredictivecontrol_jl_torch import io as tio
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.models import zoo as tzoo
from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig as TAdmm
from automationlabsmodelpredictivecontrol_jl_torch.ops.riccati import RiccatiConfig as TRicc

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "qtp_nl_golden.npz")
X_REF, U_REF = [0.65] * 4, [1.2] * 2


@pytest.fixture(scope="module")
def plants():
    flat = np.load(GOLDEN)["fnn_params"]
    japply, p0 = jzoo.init_model("fnn", jax.random.PRNGKey(0), 4, 2, hidden=8, depth=1)
    _, unravel = ravel_pytree(p0)
    js = jmpc.NeuralDiscreteSystem(
        apply_fn=japply, family="fnn", nx=4, nu=2, params=unravel(jnp.asarray(flat, jnp.float32)),
        X=jqtp.X_BOX, U=jqtp.U_BOX, activation="relu",
    )
    tapply, act = tzoo.make_apply("fnn")
    ts = tmpc.NeuralDiscreteSystem(
        apply_fn=tapply, family="fnn", nx=4, nu=2,
        params=interop.unravel_params("fnn", 4, 2, 8, 1, flat),
        X=tqtp.x_box(), U=tqtp.u_box(), activation=act,
    )
    return js, ts


# (name, neural?, the JAX package's kwargs, the port's kwargs)
CASES = [
    ("linear-condensed", False,
     dict(admm_config=JAdmm(max_iter=300, rho_grid=(0.1, 1.0)), mpc_state_constraint=True,
          mpc_R=0.5),
     dict(admm_config=TAdmm(max_iter=300, rho_grid=(0.1, 1.0)), mpc_state_constraint=True,
          mpc_R=0.5)),
    ("linear-riccati", False,
     dict(engine="riccati", riccati_config=JRicc(max_iter=500), mpc_terminal_ingredient="equality"),
     dict(engine="riccati", riccati_config=TRicc(max_iter=500), mpc_terminal_ingredient="equality")),
    ("sqp-single", True, dict(sqp_config=JSqp(max_sqp_iter=8)),
     dict(sqp_config=tmpc.SqpConfig(max_sqp_iter=8))),
    ("sqp-multiple", True, dict(sqp_config=JSqp(shooting="multiple", max_sqp_iter=12)),
     dict(sqp_config=tmpc.SqpConfig(shooting="multiple", max_sqp_iter=12))),
    ("sqp-soft", True, dict(sqp_config=JSqp(max_sqp_iter=8), mpc_soft_state_constraint=10.0),
     dict(sqp_config=tmpc.SqpConfig(max_sqp_iter=8), mpc_soft_state_constraint=10.0)),
    ("neural-linearized", True, dict(mpc_programming_type="linear"),
     dict(mpc_programming_type="linear")),
]


def _close(t, j, rel=1e-5):
    t = np.asarray(t, np.float64)
    j = np.asarray(j, np.float64)
    assert t.shape == j.shape
    assert np.max(np.abs(t - j), initial=0.0) <= rel * max(1.0, np.max(np.abs(j), initial=0.0))


def _designed_arrays(c):
    """The arrays a controller's engine was designed into (numpy)."""
    e = c.engine
    if hasattr(e, "qp"):
        return {k: getattr(e.qp, k) for k in ("P", "A", "q_x0", "l_const", "u_const")}
    if hasattr(e, "op"):
        return {k: getattr(e.op.factors, k) for k in ("K", "G", "AmBK")}
    return {}


@pytest.mark.parametrize("name,neural,jkw,tkw", CASES, ids=[c[0] for c in CASES])
def test_loads_jax_checkpoint(plants, tmp_path, name, neural, jkw, tkw):
    js, ts = plants
    N = 10 if neural else 12
    jsys = js if neural else jqtp.linearized_discrete_system()
    tsys = ts if neural else tqtp.linearized_discrete_system()
    jc = jmpc.proceed_controller(jsys, "model_predictive_control", N, 5.0, np.asarray(X_REF),
                                 np.asarray(U_REF), **jkw)
    # a non-trivial runtime state: one step from an off-reference state
    jc, _ = jax.jit(jmpc.step)(jc, jnp.full(4, 0.6))
    path = str(tmp_path / f"{name}.npz")
    jio.save_controller(path, jc)

    c = tio.load_controller(path, device="cpu")
    ref = tmpc.proceed_controller(tsys, "model_predictive_control", N, 5.0, X_REF, U_REF,
                                  device="cpu", **tkw)
    assert type(c.engine) is type(ref.engine)
    assert c.tuning.programming_type == ref.tuning.programming_type
    assert c.tuning.terminal.kind == ref.tuning.terminal.kind
    if hasattr(ref.engine, "config"):
        assert c.engine.config == ref.engine.config
    if isinstance(ref.engine, tmpc.SqpEngine):
        assert c.engine == ref.engine
    for f in ("Q", "R", "S"):
        torch.testing.assert_close(getattr(c.tuning.weights, f), getattr(ref.tuning.weights, f),
                                   rtol=0, atol=0)
    for f in ("initialization", "warm_z", "warm_y"):
        np.testing.assert_array_equal(getattr(c, f).numpy(), np.asarray(getattr(jc, f)))
    if neural:
        for k, v in c.system.params.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(js.params[k]))
        assert c.system.activation == "relu"
    _close(c.tuning.terminal.P, jc.tuning.terminal.P)
    jarr = _designed_arrays(jc)
    for k, v in _designed_arrays(c).items():
        _close(v, jarr[k])
    # resumes: a step from the loaded warm state is the step of the
    # freshly designed controller given that warm state
    x = torch.full((4,), 0.62)
    _, s1 = tmpc.step(c, x)
    _, s2 = tmpc.step(ref.replace(warm_z=c.warm_z, warm_y=c.warm_y), x)
    torch.testing.assert_close(s1.u, s2.u, rtol=0, atol=0)
    assert int(s1.status) == int(s2.status)


@pytest.mark.parametrize("mode", ["hybrid", "bf16x3"])
def test_loads_jax_checkpoint_with_kernel_precision(tmp_path, mode):
    """A JAX-written checkpoint of a controller designed with
    kernel_precision "hybrid" or "bf16x3" loads with the field kept, and
    solves on the fused kernel (K2, the state box; its plain version here)
    in that precision, as the port's own controller of the same design
    does, to the bit."""
    from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    kw = dict(max_iter=300, kernel_precision=mode)
    jc = jmpc.proceed_controller(jqtp.linearized_discrete_system(), "model_predictive_control",
                                 12, 5.0, np.asarray(X_REF), np.asarray(U_REF),
                                 admm_config=JAdmm(**kw), mpc_state_constraint=True)
    path = str(tmp_path / f"{mode}.npz")
    jio.save_controller(path, jc)
    c = tio.load_controller(path, device="cpu")
    ref = tmpc.proceed_controller(tqtp.linearized_discrete_system(), "model_predictive_control",
                                  12, 5.0, X_REF, U_REF, admm_config=TAdmm(**kw), device="cpu",
                                  mpc_state_constraint=True)
    assert c.engine.config.kernel_precision == mode
    assert c.engine.config == ref.engine.config
    x0 = torch.from_numpy(
        (0.65 + 0.05 * np.random.default_rng(3).standard_normal((8, 4))).astype(np.float32))
    calls = admm_fused.PLAIN_CALLS["K2-bf16x3"]
    s1, _, _, _ = tpar.solve_batch_fused(c, x0)
    assert admm_fused.PLAIN_CALLS["K2-bf16x3"] > calls
    s2, _, _, _ = tpar.solve_batch_fused(ref, x0)
    assert torch.equal(s1.status, s2.status)
    torch.testing.assert_close(s1.u, s2.u, rtol=0, atol=0)


@pytest.mark.parametrize("name,neural,jkw,tkw", CASES, ids=[c[0] for c in CASES])
def test_port_checkpoint_round_trip(plants, tmp_path, name, neural, jkw, tkw):
    """The port's file loads back into the same controller (arrays bit for
    bit), and the JAX package loads it into its own."""
    js, ts = plants
    tsys = ts if neural else tqtp.linearized_discrete_system()
    c = tmpc.proceed_controller(tsys, "model_predictive_control", 8, 5.0, X_REF, U_REF,
                                device="cpu", **tkw)
    c, _ = tmpc.step(c, torch.full((4,), 0.6))
    path = str(tmp_path / f"{name}.npz")
    tio.save_controller(path, c)
    c2 = tio.load_controller(path, device="cpu")
    for f in ("initialization", "warm_z", "warm_y"):
        assert torch.equal(getattr(c2, f), getattr(c, f))
    arr = _designed_arrays(c)
    for k, v in _designed_arrays(c2).items():
        assert torch.equal(v, arr[k]), k
    if neural:
        for k, v in c2.system.params.items():
            assert torch.equal(v, c.system.params[k])
    jc = jio.load_controller(path)
    assert type(jc.engine).__name__ == type(c.engine).__name__
    np.testing.assert_array_equal(np.asarray(jc.warm_z), c.warm_z.numpy())
    if hasattr(c.engine, "config"):
        assert dataclasses.asdict(jc.engine.config) == dataclasses.asdict(c.engine.config)


def test_refuses_what_cannot_be_rebuilt(tmp_path):
    """What cannot be re-designed on load is refused at save, as the JAX
    package refuses it: an economic controller (its cost is a Python
    callable), a Takagi-Sugeno plant (a family the zoo does not register),
    and a controller without a plant."""
    plant = tqtp.linearized_discrete_system()
    c = tmpc.proceed_controller(plant, "model_predictive_control", 5, 5.0, X_REF, U_REF,
                                device="cpu")
    e = tmpc.proceed_controller(plant, "economic_model_predictive_control", 5, 5.0, X_REF,
                                U_REF, mpc_cost_function=lambda x, u: u @ u, device="cpu")
    je = jmpc.proceed_controller(jqtp.linearized_discrete_system(),
                                 "economic_model_predictive_control", 5, 5.0,
                                 np.asarray(X_REF), np.asarray(U_REF),
                                 mpc_cost_function=lambda x, u: u @ u)
    with pytest.raises(ValueError, match="economic controllers"):
        tio.save_controller(str(tmp_path / "e.npz"), e)
    with pytest.raises(ValueError, match="economic controllers"):
        jio.save_controller(str(tmp_path / "je.npz"), je)
    A, B = plant.A.numpy(), plant.B.numpy()
    ts = tmpc.takagi_sugeno_system(np.stack([A, A]), np.stack([B, B]), np.full((2, 4), 0.65),
                                   np.full(2, 0.25), plant.X, plant.U)
    with pytest.raises(ValueError, match="unregistered family"):
        tio.save_controller(str(tmp_path / "t.npz"), c.replace(system=ts))
    with pytest.raises(ValueError):
        tio.save_controller(str(tmp_path / "n.npz"), c.replace(system=None))
