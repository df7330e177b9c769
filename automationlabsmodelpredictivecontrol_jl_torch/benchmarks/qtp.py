"""Quadruple-tank process (QTP), the reference's canonical plant.

4 states (tank levels, m), 2 inputs (pump flows), box bounds
x in [0.2, 1.36/1.36/1.30/1.30], u in [0, 4] x [0, 3.26], sample time 5 s.
The true nonlinear plant is batched over (B, 4) states for closed loops.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from ..systems import LinearDiscreteSystem, NeuralContinuousSystem, rk4_step
from ..types import Box, f32

S_TANK = 0.06
GAMMA_A = 0.3
GAMMA_B = 0.4
G = 9.81
A1, A2, A3, A4 = 1.34e-4, 1.51e-4, 9.27e-5, 8.82e-5

SAMPLE_TIME = 5.0


def x_box() -> Box:
    return Box(lo=f32([0.2, 0.2, 0.2, 0.2]), hi=f32([1.36, 1.36, 1.30, 1.30]))


def u_box() -> Box:
    return Box(lo=f32([0.0, 0.0]), hi=f32([4.0, 3.26]))


# the JAX package's constants; x_box() and u_box() give fresh copies
X_BOX = x_box()
U_BOX = u_box()


def qtp_ode(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """dx/dt = f(x, u) for x (B, 4) levels and u (B, 2) pump flows."""
    x = torch.clamp(x, min=1e-6)  # sqrt guard
    x1, x2, x3, x4 = x.unbind(-1)
    qa, qb = u.unbind(-1)
    sq = lambda v: torch.sqrt(2.0 * G * v)
    d1 = -A1 / S_TANK * sq(x1) + A3 / S_TANK * sq(x3) + GAMMA_A / (S_TANK * 3600) * qa
    d2 = -A2 / S_TANK * sq(x2) + A4 / S_TANK * sq(x4) + GAMMA_B / (S_TANK * 3600) * qb
    d3 = -A3 / S_TANK * sq(x3) + (1 - GAMMA_B) / (S_TANK * 3600) * qb
    d4 = -A4 / S_TANK * sq(x4) + (1 - GAMMA_A) / (S_TANK * 3600) * qa
    return torch.stack([d1, d2, d3, d4], dim=-1)


def qtp_discrete_step(x, u, dt: float = SAMPLE_TIME, substeps: int = 10):
    """RK4-integrated discrete step of the true plant, batched over lanes."""
    h = dt / substeps
    for _ in range(substeps):
        x = rk4_step(qtp_ode, x, u, h)
    return x


def linearized_discrete_system(
    x_op=None, u_op=None, dt: float = SAMPLE_TIME
) -> LinearDiscreteSystem:
    """Discrete linearization of the QTP around an operating point (analytic
    jacobian + scipy expm, f64 on the host, stored f32)."""
    x_op = np.full(4, 0.65) if x_op is None else np.asarray(x_op, np.float64)
    dsq = G / np.sqrt(2.0 * G * x_op)  # d/dv sqrt(2 g v)
    Ac = np.zeros((4, 4))
    Ac[0, 0] = -A1 / S_TANK * dsq[0]
    Ac[0, 2] = A3 / S_TANK * dsq[2]
    Ac[1, 1] = -A2 / S_TANK * dsq[1]
    Ac[1, 3] = A4 / S_TANK * dsq[3]
    Ac[2, 2] = -A3 / S_TANK * dsq[2]
    Ac[3, 3] = -A4 / S_TANK * dsq[3]
    Bc = np.zeros((4, 2))
    Bc[0, 0] = GAMMA_A / (S_TANK * 3600)
    Bc[1, 1] = GAMMA_B / (S_TANK * 3600)
    Bc[2, 1] = (1 - GAMMA_B) / (S_TANK * 3600)
    Bc[3, 0] = (1 - GAMMA_A) / (S_TANK * 3600)
    M = np.zeros((6, 6))
    M[:4, :4] = Ac
    M[:4, 4:] = Bc
    E = sla.expm(M * dt)
    return LinearDiscreteSystem(A=f32(E[:4, :4]), B=f32(E[:4, 4:]), X=x_box(), U=u_box())


def neural_continuous_system(apply_fn, params) -> NeuralContinuousSystem:
    """A learned continuous-time QTP, dx/dt = apply_fn(params, x, u), with
    the QTP's boxes."""
    return NeuralContinuousSystem(
        apply_fn=apply_fn, family="physical", nx=4, nu=2, params=params, X=x_box(), U=u_box()
    )
