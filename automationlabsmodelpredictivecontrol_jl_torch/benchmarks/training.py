"""Training harness for learned QTP plants.

The JAX package's ``benchmarks/training.py``: excite the true QTP plant
(``benchmarks/qtp.py``), collect one-step transitions, and fit a zoo family
by full-batch Adam on the one-step MSE (``torch.optim.Adam``, the same
learning rate and step count as the JAX package's ``optax.adam``). The
gradient is autograd's. Training makes a plant for the controllers; it is
not part of the controller. Everything runs on the device named (the card
by default); the seed fixes the data (numpy) and the initial weights
(``torch.Generator``), so a run repeats on one device.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..models import zoo
from ..systems import NeuralDiscreteSystem
from ..utils.devices import resolve_device
from . import qtp

Tensor = torch.Tensor


def generate_qtp_dataset(
    n_traj: int = 64,
    n_steps: int = 40,
    seed: int = 0,
    input_hold: int = 4,
    device: Any = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """One-step transitions (x_k, u_k, x_{k+1}) of the true plant: random
    initial levels inside the state box, piecewise-constant random pump
    flows inside the input box held ``input_hold`` samples, the next levels
    clipped to [0.05, 1.4] (the plant saturates empty or full). float32,
    shapes (n_traj n_steps, {4, 2, 4})."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0.25, 1.25, (n_traj, 4)).astype(np.float32)
    n_holds = (n_steps + input_hold - 1) // input_hold
    u_holds = rng.uniform([0.0, 0.0], [4.0, 3.26], (n_traj, n_holds, 2)).astype(np.float32)
    u_seq = torch.from_numpy(np.repeat(u_holds, input_hold, axis=1)[:, :n_steps]).to(dev)
    x = torch.from_numpy(x0).to(dev)
    xs, us, xns = [], [], []
    for k in range(n_steps):
        xn = torch.clamp(qtp.qtp_discrete_step(x, u_seq[:, k]), 0.05, 1.4)
        xs.append(x)
        us.append(u_seq[:, k])
        xns.append(xn)
        x = xn
    return torch.cat(xs), torch.cat(us), torch.cat(xns)


def train_family(
    family: str,
    data: Tuple[Tensor, Tensor, Tensor],
    hidden: int = 8,
    depth: int = 1,
    steps: int = 600,
    lr: float = 5e-3,
    seed: int = 0,
    activation: Optional[str] = None,
    nx: int = 4,
    nu: int = 2,
    sample_time: float = qtp.SAMPLE_TIME,
) -> Tuple[Callable, Any, float]:
    """Fit one zoo family to the transitions by full-batch Adam, on the
    device of the data. Returns (apply_fn, trained params, final one-step
    RMSE). The integrator families get dt = ``sample_time``."""
    X, U, XN = data
    apply_fn, params = zoo.init_model(
        family, torch.Generator().manual_seed(int(seed)), nx, nu, hidden=hidden,
        depth=depth, activation=activation, sample_time=sample_time,
    )
    leaves = []

    def to_leaf(t):
        t = t.to(X.device).requires_grad_(True)
        leaves.append(t)
        return t

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return to_leaf(tree)

    params = walk(params)
    opt = torch.optim.Adam(leaves, lr=lr)
    loss = torch.tensor(float("inf"))
    for _ in range(int(steps)):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((apply_fn(params, X, U) - XN) ** 2)
        loss.backward()
        opt.step()
    with torch.no_grad():
        loss = torch.mean((apply_fn(params, X, U) - XN) ** 2)
    for leaf in leaves:
        leaf.requires_grad_(False)
    return apply_fn, params, float(torch.sqrt(loss))


def trained_system(
    family: str,
    data: Tuple[Tensor, Tensor, Tensor],
    hidden: int = 8,
    depth: int = 1,
    steps: int = 600,
    lr: float = 5e-3,
    seed: int = 0,
    activation: Optional[str] = None,
) -> Tuple[NeuralDiscreteSystem, float]:
    """Train a family and wrap it as a NeuralDiscreteSystem on the QTP
    boxes, on the device of the data. Returns (system, one-step RMSE)."""
    apply_fn, params, rmse = train_family(
        family, data, hidden=hidden, depth=depth, steps=steps, lr=lr,
        seed=seed, activation=activation,
    )
    _, act = zoo.make_apply(family, activation)
    dev = data[0].device
    system = NeuralDiscreteSystem(
        apply_fn=apply_fn, family=family, nx=4, nu=2, params=params,
        X=qtp.x_box().to(dev), U=qtp.u_box().to(dev), activation=act,
    )
    return system, rmse
