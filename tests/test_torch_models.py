"""The port's model zoo, learned systems and weight carry-over against the
JAX package, on the CPU.

Each of the 15 families of ``MODEL_FAMILIES`` evaluates the same map: the
JAX package's parameter tree, with every leaf redrawn from a numpy seed
(biases included, so no term is zero), is carried across by
``interop.params_from_numpy`` and both applies run on the same batch (rel
1e-5 of max(1, |JAX|)); so does the jacfwd linearization (1e-5). "linear"
is the plain linear system and "physical" a user function. The golden
fnn's 160 raveled floats unravel as ``ravel_pytree`` unravels them, bit
for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from automationlabsmodelpredictivecontrol_jl_tpu import systems as jsys
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import training as jtraining
from automationlabsmodelpredictivecontrol_jl_tpu.models import activations as jact
from automationlabsmodelpredictivecontrol_jl_tpu.models import zoo as jzoo

from automationlabsmodelpredictivecontrol_jl_torch import interop
from automationlabsmodelpredictivecontrol_jl_torch import systems as tsys
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import training as ttraining
from automationlabsmodelpredictivecontrol_jl_torch.models import activations as tact
from automationlabsmodelpredictivecontrol_jl_torch.models import zoo as tzoo

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
LEARNED = [f for f in jzoo.MODEL_FAMILIES if f not in ("linear", "physical")]
REL = 1e-5
NX, NU, B = 4, 2, 16


def _close(t, j, rel=REL):
    t = np.asarray(t, np.float64)
    j = np.asarray(j, np.float64)
    assert t.shape == j.shape
    err = np.max(np.abs(t - j)) / max(1.0, np.max(np.abs(j)))
    assert err <= rel, err


def _random_tree(tree, rng):
    """Every leaf redrawn uniformly in [-0.6, 0.6] (dt kept)."""
    if isinstance(tree, dict):
        return {k: (v if k == "dt" else _random_tree(v, rng)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_random_tree(v, rng) for v in tree]
    return rng.uniform(-0.6, 0.6, np.shape(tree)).astype(np.float32)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


def _pair(family, seed, hidden=8, depth=2):
    """(JAX apply, JAX params, port apply, port params) of one family."""
    rng = np.random.default_rng(seed)
    japply, jp = jzoo.init_model(
        family, jax.random.PRNGKey(seed), NX, NU, hidden=hidden, depth=depth, sample_time=0.5
    )
    tree = _random_tree(_np_tree(jp), rng)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tapply, _ = tzoo.make_apply(family)
    return japply, jp, tapply, interop.params_from_numpy(family, tree)


def _inputs(seed, n=B):
    rng = np.random.default_rng(100 + seed)
    x = rng.uniform(0.2, 1.2, (n, NX)).astype(np.float32)
    u = rng.uniform(0.0, 3.0, (n, NU)).astype(np.float32)
    return x, u


@pytest.mark.parametrize("name", sorted(jact.ACTIVATIONS))
def test_activation_matches_jax(name):
    x = np.linspace(-30.0, 30.0, 601).astype(np.float32)
    _close(tact.get_activation(name)(torch.from_numpy(x)), jact.get_activation(name)(jnp.asarray(x)))


@pytest.mark.parametrize("family", LEARNED)
def test_apply_matches_jax(family):
    japply, jp, tapply, tp = _pair(family, 1)
    x, u = _inputs(1)
    j = jax.vmap(japply, in_axes=(None, 0, 0))(jp, jnp.asarray(x), jnp.asarray(u))
    _close(tapply(tp, torch.from_numpy(x), torch.from_numpy(u)), j)


@pytest.mark.parametrize("family", LEARNED)
def test_linearize_matches_jax(family):
    japply, jp, tapply, tp = _pair(family, 2, depth=1)
    x, u = _inputs(2, 1)
    js = jsys.NeuralDiscreteSystem(apply_fn=japply, family=family, nx=NX, nu=NU, params=jp,
                                   X=jqtp.X_BOX, U=jqtp.U_BOX)
    ts = tsys.NeuralDiscreteSystem(apply_fn=tapply, family=family, nx=NX, nu=NU, params=tp,
                                   X=tqtp.x_box(), U=tqtp.u_box())
    jA, jB = jsys.linearize(js, jnp.asarray(x[0]), jnp.asarray(u[0]))
    tA, tB = tsys.linearize(ts, torch.from_numpy(x[0]), torch.from_numpy(u[0]))
    _close(tA, jA)
    _close(tB, jB)


def test_linear_and_physical_families():
    """"linear": a linear system linearizes to its own matrices; "physical":
    a user function (the true QTP step) through user_function_system, its
    jacfwd linearization against the JAX package's."""
    lin = tqtp.linearized_discrete_system()
    A, Bm = tsys.linearize(lin, None, None)
    assert A is lin.A and Bm is lin.B
    x0 = np.full(4, 0.6, np.float32)
    u0 = np.full(2, 1.2, np.float32)
    js = jsys.user_function_system(jqtp.qtp_discrete_step, 4, 2, jqtp.X_BOX, jqtp.U_BOX)
    ts = tsys.user_function_system(tqtp.qtp_discrete_step, 4, 2, tqtp.x_box(), tqtp.u_box())
    assert ts.family == js.family == "physical"
    jA, jB = jsys.linearize(js, jnp.asarray(x0), jnp.asarray(u0))
    tA, tB = tsys.linearize(ts, torch.from_numpy(x0), torch.from_numpy(u0))
    _close(tA, jA)
    _close(tB, jB)
    # the linearized system keeps the boxes and the Jacobians
    ls = tsys.linearize_to_system(ts, torch.from_numpy(x0), torch.from_numpy(u0))
    assert torch.equal(ls.A, tA) and torch.equal(ls.X.lo, ts.X.lo)


def test_relu_jacobian_at_zero_matches_jax():
    """Every hidden pre-activation exactly 0 (x = u = 0, zero biases): the
    relu's derivative there is 0 in both packages, so A and B are 0."""
    japply, jp, tapply, tp = _pair("fnn", 3, depth=1)
    jp = {**jp, "b_in": jnp.zeros_like(jp["b_in"]), "b": jnp.zeros_like(jp["b"])}
    tp = {**tp, "b_in": torch.zeros_like(tp["b_in"]), "b": torch.zeros_like(tp["b"])}
    f_j = lambda x, u: japply(jp, x, u)
    f_t = lambda x, u: tapply(tp, x, u)
    jA, jB = jax.jacfwd(f_j, argnums=(0, 1))(jnp.zeros(NX), jnp.zeros(NU))
    tA, tB = torch.func.jacfwd(f_t, argnums=(0, 1))(torch.zeros(NX), torch.zeros(NU))
    np.testing.assert_array_equal(tA.numpy(), np.asarray(jA))
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    assert not tA.any() and not tB.any()


def test_continuous_neural_system_rk4_matches_jax():
    """as_discrete on a NeuralContinuousSystem: RK4 substeps over the
    sample time, the same map as the JAX package's."""
    japply, jp, tapply, tp = _pair("fnn", 4, depth=1)
    jc = jsys.NeuralContinuousSystem(apply_fn=japply, family="fnn", nx=NX, nu=NU, params=jp,
                                     X=jqtp.X_BOX, U=jqtp.U_BOX)
    tc = tsys.NeuralContinuousSystem(apply_fn=tapply, family="fnn", nx=NX, nu=NU, params=tp,
                                     X=tqtp.x_box(), U=tqtp.u_box())
    jd = jsys.as_discrete(jc, 0.2, substeps=3)
    td = tsys.as_discrete(tc, 0.2, substeps=3)
    x, u = _inputs(4)
    j = jax.vmap(lambda a, b: jd.step(a, b))(jnp.asarray(x), jnp.asarray(u))
    _close(td.step(torch.from_numpy(x), torch.from_numpy(u)), j)


def test_unravel_params_matches_ravel_pytree():
    """The golden fnn's 160 floats: leaves in sorted-key order W (1, 8, 8),
    W_in (8, 6), W_out (4, 8), b (1, 8), b_in (8,), equal to JAX's unravel
    bit for bit."""
    flat = np.load(os.path.join(GOLDEN, "qtp_nl_golden.npz"))["fnn_params"]
    assert flat.size == 160
    _, p0 = jzoo.init_model("fnn", jax.random.PRNGKey(0), 4, 2, hidden=8, depth=1)
    _, unravel = ravel_pytree(p0)
    jp = unravel(jnp.asarray(flat, jnp.float32))
    tp = interop.unravel_params("fnn", 4, 2, 8, 1, flat)
    assert list(tp) == ["W", "W_in", "W_out", "b", "b_in"]
    assert [tuple(v.shape) for v in tp.values()] == [(1, 8, 8), (8, 6), (4, 8), (1, 8), (8,)]
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    with pytest.raises(ValueError):
        interop.unravel_params("fnn", 4, 2, 8, 2, flat)


@pytest.mark.parametrize("family", ["densenet", "rknn4", "lstm"])
def test_unravel_params_nested_trees(family):
    """A list of blocks (densenet), a 0-d dt leaf (rknn4), gates (lstm):
    ravel a random JAX tree, unravel it in the port."""
    japply, jp, tapply, _ = _pair(family, 5)
    flat, _ = ravel_pytree(jp)
    tp = interop.unravel_params(family, NX, NU, 8, 2, np.asarray(flat), sample_time=0.5)
    x, u = _inputs(5)
    j = jax.vmap(japply, in_axes=(None, 0, 0))(jp, jnp.asarray(x), jnp.asarray(u))
    _close(tapply(tp, torch.from_numpy(x), torch.from_numpy(u)), j)


def test_rollout_and_make_system():
    sys = tzoo.make_system("resnet", 7, NX, NU, tqtp.x_box(), tqtp.u_box(), hidden=8, depth=1)
    assert sys.activation == "relu" and sys.params["W"].shape == (1, 8, 8)
    x0 = torch.full((3, NX), 0.6)
    us = torch.full((3, 5, NU), 1.2)
    xs = tzoo.rollout(sys.apply_fn, sys.params, x0, us)
    assert xs.shape == (3, 6, NX)
    assert torch.equal(xs[:, 1], sys.step(x0, us[:, 0]))
    with pytest.raises(ValueError):
        tzoo.init_model("lstm", 0, 3, 2)
    with pytest.raises(ValueError):
        tzoo.init_model("transformer", 0, 4, 2)


def test_training_dataset_matches_jax_and_fits():
    """The identification data of the true plant (the same numpy draws,
    the same RK4 plant) agree with the JAX package's to 1e-5; 300 Adam
    steps on it at least halve the untrained model's one-step RMSE."""
    jX, jU, jXN = jtraining.generate_qtp_dataset(n_traj=8, n_steps=6, seed=0)
    tX, tU, tXN = ttraining.generate_qtp_dataset(n_traj=8, n_steps=6, seed=0, device="cpu")
    np.testing.assert_array_equal(tU.numpy(), np.asarray(jU))
    _close(tX, jX)
    _close(tXN, jXN)
    _, rmse0 = ttraining.trained_system("fnn", (tX, tU, tXN), steps=0, seed=0)
    system, rmse = ttraining.trained_system("fnn", (tX, tU, tXN), steps=300, seed=0)
    assert rmse < 0.5 * rmse0 and system.activation == "relu"
    assert not any(v.requires_grad for v in system.params.values())


def test_unstable_and_wide_plants_match_jax():
    """benchmarks/unstable.py: the closed-loop identification data (LQR
    plus the same numpy noise) within 1e-5, the linearization and the
    stabilizing gain equal; benchmarks/big.py: the same wide plant bit for
    bit (numpy draws, stored fp32)."""
    from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import big as jbig
    from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import unstable as junst

    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big as tbig
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import unstable as tunst

    jd = junst.generate_dataset(n_traj=8, n_steps=5, seed=0)
    td = tunst.generate_dataset(n_traj=8, n_steps=5, seed=0, device="cpu")
    for t, j in zip(td, jd):
        _close(t, j)
    np.testing.assert_array_equal(tunst.stabilizing_gain(), junst.stabilizing_gain())
    lin_t, lin_j = tunst.linearized_discrete_system(), junst.linearized_discrete_system()
    np.testing.assert_array_equal(lin_t.A.numpy(), np.asarray(lin_j.A))
    x = np.asarray([[0.3, -0.2], [1.0, 2.0]], np.float32)
    u = np.asarray([[0.5], [-1.0]], np.float32)
    j = jax.vmap(junst.unstable_discrete_step)(jnp.asarray(x), jnp.asarray(u))
    _close(tunst.unstable_discrete_step(torch.from_numpy(x), torch.from_numpy(u)), j)
    wt, wj = tbig.random_stable_system(16, 8, seed=0), jbig.random_stable_system(16, 8, seed=0)
    np.testing.assert_array_equal(wt.A.numpy(), np.asarray(wj.A))
    np.testing.assert_array_equal(wt.B.numpy(), np.asarray(wj.B))
    np.testing.assert_array_equal(wt.U.hi.numpy(), np.asarray(wj.U.hi))
