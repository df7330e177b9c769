"""Learned-dynamics model zoo: the JAX package's 15 model families.

Each family is a pure function ``apply(params, x, u) -> x_next`` over a
parameter dict, evaluated on a batch: x (..., nx), u (..., nu), any
leading axes (one sample, a (B, nx) fleet, or a ``torch.func.vmap`` /
``jacfwd`` trace). The parameter names and shapes are the JAX package's
(``W_in`` (h, nx+nu), ``b_in`` (h,), hidden ``W`` (depth, h, h), ``b``
(depth, h), ``W_out`` (nx, h), ...), so a JAX parameter tree carries
across leaf for leaf (``interop.params_from_numpy``). The JAX package
scans the hidden blocks with ``lax.scan``; here they are a loop over
layers.

Shared architecture: input layer (nx+nu -> h) with bias, ``depth`` hidden
blocks (h -> h) with bias, linear output layer (h -> nx) without bias.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..utils.precision import assert_ieee_fp32
from .activations import get_activation

Tensor = torch.Tensor

MODEL_FAMILIES = (
    "linear",
    "fnn",
    "icnn",
    "resnet",
    "densenet",
    "rbf",
    "polynet",
    "neuralode",
    "rknn1",
    "rknn2",
    "rknn4",
    "physical",
    # recurrent families: the cell's recurrent state is the plant state
    "rnn",
    "lstm",
    "gru",
)


def _lin(W: Tensor, h: Tensor) -> Tensor:
    """W @ h over the last axis of h (a batch of vectors)."""
    return h @ W.transpose(-1, -2)


def _dense_init(gen: torch.Generator, n_in: int, n_out: int) -> Tensor:
    scale = 1.0 / float(n_in) ** 0.5
    return (torch.rand((n_out, n_in), generator=gen) * 2.0 - 1.0) * scale


def _stack_init(gen, depth, n_in, n_out) -> Tensor:
    if depth == 0:
        return torch.zeros((0, n_out, n_in))
    return torch.stack([_dense_init(gen, n_in, n_out) for _ in range(depth)])


def _mlp_params(gen, n_in, n_out, hidden, depth) -> Dict[str, Tensor]:
    """W_in (h, n_in), hidden W (depth, h, h) and b (depth, h), W_out (n_out, h)."""
    return {
        "W_in": _dense_init(gen, n_in, hidden),
        "b_in": torch.zeros((hidden,)),
        "W": _stack_init(gen, depth, hidden, hidden),
        "b": torch.zeros((depth, hidden)),
        "W_out": _dense_init(gen, hidden, n_out),
    }


# fnn: plain feedforward net
def fnn_init(gen, nx, nu, hidden=16, depth=2, activation="relu"):
    return _mlp_params(gen, nx + nu, nx, hidden, depth)


def fnn_apply(params, x, u, activation="relu"):
    act = get_activation(activation)
    z = torch.cat([x, u], dim=-1)
    h = act(_lin(params["W_in"], z) + params["b_in"])
    for W, b in zip(params["W"], params["b"]):
        h = act(_lin(W, h) + b)
    return _lin(params["W_out"], h)


# icnn: input-convex network, z_{j+1} = act(relu(Wz_j) z_j + Wx_j [x; u] + b_j)
def icnn_init(gen, nx, nu, hidden=16, depth=2, activation="relu"):
    n_in = nx + nu
    return {
        "W_in": _dense_init(gen, n_in, hidden),
        "b_in": torch.zeros((hidden,)),
        "Wz": _stack_init(gen, depth, hidden, hidden),
        "Wx": _stack_init(gen, depth, n_in, hidden),
        "b": torch.zeros((depth, hidden)),
        "W_out": _dense_init(gen, hidden, nx),
        "Wx_out": _dense_init(gen, n_in, nx),
    }


def icnn_apply(params, x, u, activation="relu"):
    act = get_activation(activation)
    z_in = torch.cat([x, u], dim=-1)
    h = act(_lin(params["W_in"], z_in) + params["b_in"])
    for Wz, Wx, b in zip(params["Wz"], params["Wx"], params["b"]):
        h = act(_lin(torch.relu(Wz), h) + _lin(Wx, z_in) + b)
    # nonneg weights on the convex hidden state plus an affine input skip
    return _lin(torch.relu(params["W_out"]), h) + _lin(params["Wx_out"], z_in)


# resnet: residual blocks y_j = y_{j-1} + act(W y_{j-1} + b)
resnet_init = fnn_init


def resnet_apply(params, x, u, activation="relu"):
    act = get_activation(activation)
    z = torch.cat([x, u], dim=-1)
    h = act(_lin(params["W_in"], z) + params["b_in"])
    for W, b in zip(params["W"], params["b"]):
        h = h + act(_lin(W, h) + b)
    return _lin(params["W_out"], h)


# densenet: concatenating skips; block j reads every earlier block's output
def densenet_init(gen, nx, nu, hidden=16, depth=2, activation="relu"):
    params = {
        "W_in": _dense_init(gen, nx + nu, hidden),
        "b_in": torch.zeros((hidden,)),
        "blocks": [],
    }
    width = hidden
    for _ in range(depth):
        params["blocks"].append(
            {"W": _dense_init(gen, width, hidden), "b": torch.zeros((hidden,))}
        )
        width += hidden
    params["W_out"] = _dense_init(gen, width, nx)
    return params


def densenet_apply(params, x, u, activation="relu"):
    act = get_activation(activation)
    z = torch.cat([x, u], dim=-1)
    h = act(_lin(params["W_in"], z) + params["b_in"])
    for blk in params["blocks"]:
        h = torch.cat([h, act(_lin(blk["W"], h) + blk["b"])], dim=-1)
    return _lin(params["W_out"], h)


# rbf: the fnn with the Gaussian activation
def rbf_init(gen, nx, nu, hidden=16, depth=1, activation="gaussian"):
    return _mlp_params(gen, nx + nu, nx, hidden, depth)


def rbf_apply(params, x, u, activation="gaussian"):
    return fnn_apply(params, x, u, activation="gaussian")


# polynet: y_j = y_{j-1} + s + act(W2 s + b2), s = act(W1 y_{j-1} + b1)
def polynet_init(gen, nx, nu, hidden=16, depth=2, activation="relu"):
    return {
        "W_in": _dense_init(gen, nx + nu, hidden),
        "b_in": torch.zeros((hidden,)),
        "W1": _stack_init(gen, depth, hidden, hidden),
        "b1": torch.zeros((depth, hidden)),
        "W2": _stack_init(gen, depth, hidden, hidden),
        "b2": torch.zeros((depth, hidden)),
        "W_out": _dense_init(gen, hidden, nx),
    }


def polynet_apply(params, x, u, activation="relu"):
    act = get_activation(activation)
    z = torch.cat([x, u], dim=-1)
    h = act(_lin(params["W_in"], z) + params["b_in"])
    for W1, b1, W2, b2 in zip(params["W1"], params["b1"], params["W2"], params["b2"]):
        s = act(_lin(W1, h) + b1)
        h = h + s + act(_lin(W2, s) + b2)
    return _lin(params["W_out"], h)


# neuralode / rknn1 / rknn2 / rknn4: an MLP vector field integrated by an
# explicit Runge-Kutta scheme over the sample time ``dt`` (a 0-d leaf)
def _odenet_init(gen, nx, nu, hidden=16, depth=2, dt=1.0):
    p = _mlp_params(gen, nx + nu, nx, hidden, depth)
    p["dt"] = torch.tensor(dt, dtype=torch.float32)
    return p


neuralode_init = rknn1_init = rknn2_init = rknn4_init = _odenet_init


def rknn1_apply(params, x, u, activation="tanh"):
    """Explicit Euler (1-stage RK)."""
    return x + params["dt"] * fnn_apply(params, x, u, activation)


def rknn2_apply(params, x, u, activation="tanh"):
    """Midpoint (2-stage RK)."""
    dt = params["dt"]
    k1 = fnn_apply(params, x, u, activation)
    k2 = fnn_apply(params, x + 0.5 * dt * k1, u, activation)
    return x + dt * k2


def _rk4(f, x, dt):
    k1 = f(x)
    k2 = f(x + 0.5 * dt * k1)
    k3 = f(x + 0.5 * dt * k2)
    k4 = f(x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def rknn4_apply(params, x, u, activation="tanh"):
    """Classic RK4."""
    return _rk4(lambda xx: fnn_apply(params, xx, u, activation), x, params["dt"])


def neuralode_apply(params, x, u, activation="tanh", substeps=4):
    """Neural ODE: RK4 with ``substeps`` fixed steps across the sample time."""
    dt = params["dt"] / substeps
    for _ in range(substeps):
        x = _rk4(lambda xx: fnn_apply(params, xx, u, activation), x, dt)
    return x


# rnn / lstm / gru: a recurrent cell as the dynamics map; for the LSTM the
# state stacks [h; c] (nx even)
def rnn_init(gen, nx, nu, hidden=None, depth=None):
    """Elman cell: x' = tanh(Wx x + Wu u + b)."""
    return {
        "Wx": _dense_init(gen, nx, nx),
        "Wu": _dense_init(gen, nu, nx),
        "b": torch.zeros((nx,)),
    }


def rnn_apply(params, x, u, activation="tanh"):
    act = get_activation(activation)
    return act(_lin(params["Wx"], x) + _lin(params["Wu"], u) + params["b"])


def gru_init(gen, nx, nu, hidden=None, depth=None):
    """GRU cell with input u and recurrent state x (gates z, r, candidate n)."""
    p = {}
    for g in ("z", "r", "n"):
        p[f"W{g}"] = _dense_init(gen, nx, nx)
        p[f"U{g}"] = _dense_init(gen, nu, nx)
    for g in ("z", "r", "n"):
        p[f"b{g}"] = torch.zeros((nx,))
    return p


def gru_apply(params, x, u, activation="tanh"):
    z = torch.sigmoid(_lin(params["Wz"], x) + _lin(params["Uz"], u) + params["bz"])
    r = torch.sigmoid(_lin(params["Wr"], x) + _lin(params["Ur"], u) + params["br"])
    n = torch.tanh(_lin(params["Wn"], r * x) + _lin(params["Un"], u) + params["bn"])
    return (1.0 - z) * n + z * x


def lstm_init(gen, nx, nu, hidden=None, depth=None):
    """LSTM cell; the plant state stacks [h; c], so nx must be even."""
    if nx % 2 != 0:
        raise ValueError("lstm family needs an even state dimension ([h; c])")
    nh = nx // 2
    p = {}
    for g in ("i", "f", "g", "o"):
        p[f"W{g}"] = _dense_init(gen, nh, nh)
        p[f"U{g}"] = _dense_init(gen, nu, nh)
        p[f"b{g}"] = torch.zeros((nh,))
    p["bf"] = torch.ones((nh,))  # forget-gate bias 1: the usual stability choice
    return p


def lstm_apply(params, x, u, activation="tanh"):
    nh = x.shape[-1] // 2
    h, c = x[..., :nh], x[..., nh:]
    gate = lambda g: _lin(params[f"W{g}"], h) + _lin(params[f"U{g}"], u) + params[f"b{g}"]
    gi = torch.sigmoid(gate("i"))
    gf = torch.sigmoid(gate("f"))
    gg = torch.tanh(gate("g"))
    go = torch.sigmoid(gate("o"))
    c_new = gf * c + gi * gg
    return torch.cat([go * torch.tanh(c_new), c_new], dim=-1)


_INITS = {
    "fnn": fnn_init,
    "icnn": icnn_init,
    "resnet": resnet_init,
    "densenet": densenet_init,
    "rbf": rbf_init,
    "polynet": polynet_init,
    "neuralode": neuralode_init,
    "rknn1": rknn1_init,
    "rknn2": rknn2_init,
    "rknn4": rknn4_init,
    "rnn": rnn_init,
    "gru": gru_init,
    "lstm": lstm_init,
}

_APPLIES = {
    "fnn": fnn_apply,
    "icnn": icnn_apply,
    "resnet": resnet_apply,
    "densenet": densenet_apply,
    "rbf": rbf_apply,
    "polynet": polynet_apply,
    "neuralode": neuralode_apply,
    "rknn1": rknn1_apply,
    "rknn2": rknn2_apply,
    "rknn4": rknn4_apply,
    "rnn": rnn_apply,
    "gru": gru_apply,
    "lstm": lstm_apply,
}

ODE_FAMILIES = ("neuralode", "rknn1", "rknn2", "rknn4")


def default_activation(family: str) -> str:
    """The family's default activation."""
    return {
        "rbf": "gaussian",
        "neuralode": "tanh",
        "rknn1": "tanh",
        "rknn2": "tanh",
        "rknn4": "tanh",
        "rnn": "tanh",
        "gru": "tanh",
        "lstm": "tanh",
    }.get(family, "relu")


def make_apply(family: str, activation: Optional[str] = None) -> Tuple[Callable, str]:
    """(apply_fn bound to the activation, the resolved activation name).

    On the card every product of the dynamics runs in IEEE fp32
    (``assert_ieee_fp32``: TF32 off). The model is the plant the solver
    certifies against: at reduced precision its forward carries errors of
    ~1e-2 (the JAX package measured multiple shooting stalled at a 9e-3
    defect under a bf16 default, far above the 1e-4 feasibility gate)."""
    act = activation or default_activation(family)
    base_apply = _APPLIES[family]

    def apply_fn(p, x, u):
        if x.is_cuda:
            assert_ieee_fp32()
        return base_apply(p, x, u, activation=act)

    return apply_fn, act


def init_model(
    family: str,
    gen: Any,
    nx: int,
    nu: int,
    hidden: int = 16,
    depth: int = 2,
    activation: Optional[str] = None,
    sample_time: float = 1.0,
) -> Tuple[Callable, Any]:
    """(apply_fn, params) of a family, float32 on the CPU. ``gen`` is a
    ``torch.Generator`` or an int seed (the weights are not the JAX
    package's for the same seed: its generator is another)."""
    if family not in _INITS:
        raise ValueError(f"unknown model family {family!r}; see MODEL_FAMILIES")
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(gen))
    init = _INITS[family]
    if family in ODE_FAMILIES:
        params = init(gen, nx, nu, hidden=hidden, depth=depth, dt=sample_time)
    else:
        params = init(gen, nx, nu, hidden=hidden, depth=depth)
    apply_fn, _ = make_apply(family, activation)
    return apply_fn, params


def make_system(
    family: str,
    gen: Any,
    nx: int,
    nu: int,
    X,
    U,
    hidden: int = 16,
    depth: int = 2,
    activation: Optional[str] = None,
    sample_time: float = 1.0,
):
    """A NeuralDiscreteSystem of a zoo family, with the activation recorded
    on the system (checkpoints rebuild the exact dynamics)."""
    from ..systems import NeuralDiscreteSystem

    apply_fn, params = init_model(
        family, gen, nx, nu, hidden=hidden, depth=depth,
        activation=activation, sample_time=sample_time,
    )
    _, act = make_apply(family, activation)
    return NeuralDiscreteSystem(
        apply_fn=apply_fn, family=family, nx=nx, nu=nu,
        params=params, X=X, U=U, activation=act,
    )


def rollout(apply_fn: Callable, params: Any, x0: Tensor, u_seq: Tensor) -> Tensor:
    """Roll the dynamics forward: x0 (..., nx), u_seq (..., N, nu) -> the
    states (..., N+1, nx)."""
    xs = [x0]
    for k in range(u_seq.shape[-2]):
        xs.append(apply_fn(params, xs[-1], u_seq[..., k, :]))
    return torch.stack(xs, dim=-2)
