"""Open-loop-unstable benchmark plant: the JAX package's
``benchmarks/unstable.py``.

A mildly nonlinear two-state plant with spectral radius ~1.15, so
open-loop excitation diverges (the identification data is collected in
closed loop, LQR plus exploration noise) and controller mistakes show as
divergence:

    x+ = A x + B u + 0.08 tanh(x),   A = [[1.15, 0.25], [0, 1.08]]

Equilibrium at the origin; references x_ref = 0, u_ref = 0.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import scipy.linalg as sla
import torch

from ..types import Box, f32
from ..utils.devices import resolve_device

Tensor = torch.Tensor

SAMPLE_TIME = 1.0
NX, NU = 2, 1

A = np.asarray([[1.15, 0.25], [0.0, 1.08]], np.float64)
B = np.asarray([[0.0], [1.0]], np.float64)


def x_box() -> Box:
    return Box(lo=f32([-3.0, -3.0]), hi=f32([3.0, 3.0]))


def u_box() -> Box:
    return Box(lo=f32([-8.0]), hi=f32([8.0]))


def unstable_discrete_step(x: Tensor, u: Tensor) -> Tensor:
    """The true plant, batched: x (..., 2), u (..., 1)."""
    A32 = f32(A).to(x.device)
    B32 = f32(B).to(x.device)
    return x @ A32.T + u @ B32.T + 0.08 * torch.tanh(x)


def linearized_discrete_system():
    """The Jacobian linearization at the origin (d tanh/dx = I there)."""
    from ..systems import LinearDiscreteSystem

    return LinearDiscreteSystem(A=f32(A + 0.08 * np.eye(NX)), B=f32(B), X=x_box(), U=u_box())


def stabilizing_gain() -> np.ndarray:
    """LQR gain for closed-loop data collection (u = -K x + noise)."""
    A_lin = A + 0.08 * np.eye(NX)
    P = sla.solve_discrete_are(A_lin, B, np.eye(NX), np.eye(NU))
    return np.linalg.solve(1.0 + B.T @ P @ B, B.T @ P @ A_lin)


def generate_dataset(
    n_traj: int = 64, n_steps: int = 30, seed: int = 0, device: Any = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """Closed-loop one-step transitions (x, u, x+): LQR feedback keeps the
    trajectories bounded, uniform exploration noise excites the dynamics."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    K = f32(stabilizing_gain()).to(dev)
    x = torch.from_numpy(rng.uniform(-1.5, 1.5, (n_traj, NX)).astype(np.float32)).to(dev)
    noise = torch.from_numpy(rng.uniform(-2.0, 2.0, (n_traj, n_steps, NU)).astype(np.float32)).to(dev)
    ub, xb = u_box().to(dev), x_box().to(dev)
    xs, us, xns = [], [], []
    for k in range(n_steps):
        u = torch.clamp(-x @ K.T + noise[:, k], ub.lo, ub.hi)
        xn = torch.clamp(unstable_discrete_step(x, u), xb.lo, xb.hi)
        xs.append(x)
        us.append(u)
        xns.append(xn)
        x = xn
    return torch.cat(xs), torch.cat(us), torch.cat(xns)


def trained_system(family: str, data, **kw):
    """Train a zoo family on the unstable plant and wrap it as a
    NeuralDiscreteSystem on the data's device. Returns (system, RMSE)."""
    from ..models import zoo
    from ..systems import NeuralDiscreteSystem
    from .training import train_family

    kw.setdefault("hidden", 8)
    kw.setdefault("steps", 600)
    apply_fn, params, rmse = train_family(family, data, nx=NX, nu=NU, sample_time=SAMPLE_TIME, **kw)
    _, act = zoo.make_apply(family, kw.get("activation"))
    dev = data[0].device
    system = NeuralDiscreteSystem(
        apply_fn=apply_fn, family=family, nx=NX, nu=NU, params=params,
        X=x_box().to(dev), U=u_box().to(dev), activation=act,
    )
    return system, rmse
