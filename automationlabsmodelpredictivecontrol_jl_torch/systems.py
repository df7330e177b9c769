"""Linear system types, discretization and linearization.

The linear half of the JAX package's ``systems.py``. Learned (neural)
dynamics are not ported yet: ``linearize`` raises ``NotImplementedError``
for them (ROADMAP Queue 1, "Learned dynamics").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import scipy.linalg as sla
import torch

from .types import Box, TensorRecord, f32

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LinearDiscreteSystem(TensorRecord):
    """x_{k+1} = A x_k + B u_k with box constraints x in X, u in U."""

    A: Tensor  # (nx, nx)
    B: Tensor  # (nx, nu)
    X: Box
    U: Box

    @property
    def nx(self) -> int:
        return self.B.shape[-2]

    @property
    def nu(self) -> int:
        return self.B.shape[-1]

    def step(self, x: Tensor, u: Tensor) -> Tensor:
        """Batched step: x (..., nx), u (..., nu)."""
        return x @ self.A.T + u @ self.B.T


@dataclasses.dataclass(frozen=True)
class LinearContinuousSystem(TensorRecord):
    """dx/dt = A x + B u with box constraints. Discretized at design time."""

    A: Tensor
    B: Tensor
    X: Box
    U: Box

    @property
    def nx(self) -> int:
        return self.B.shape[-2]

    @property
    def nu(self) -> int:
        return self.B.shape[-1]


def discretize(system: LinearContinuousSystem, sample_time: float) -> LinearDiscreteSystem:
    """Exact zero-order-hold discretization: one matrix exponential of the
    augmented matrix [[A, B], [0, 0]] * Ts, in f64 on the host, stored f32."""
    A = np.asarray(system.A, np.float64)
    B = np.asarray(system.B, np.float64)
    nx, nu = B.shape
    M = np.zeros((nx + nu, nx + nu))
    M[:nx, :nx] = A
    M[:nx, nx:] = B
    E = sla.expm(M * sample_time)
    return LinearDiscreteSystem(A=f32(E[:nx, :nx]), B=f32(E[:nx, nx:]), X=system.X, U=system.U)


def rk4_step(
    deriv: Callable[[Tensor, Tensor], Tensor], x: Tensor, u: Tensor, dt: float
) -> Tensor:
    """One classic RK4 step with zero-order-held input."""
    k1 = deriv(x, u)
    k2 = deriv(x + 0.5 * dt * k1, u)
    k3 = deriv(x + 0.5 * dt * k2, u)
    k4 = deriv(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def as_discrete(system: Any, sample_time: float) -> Any:
    """Continuous linear systems are discretized (ZOH); discrete ones pass
    through unchanged."""
    if isinstance(system, LinearContinuousSystem):
        return discretize(system, sample_time)
    if isinstance(system, LinearDiscreteSystem):
        return system
    raise NotImplementedError(
        f"{type(system).__name__}: only linear systems are ported so far "
        "(learned dynamics: ROADMAP Queue 1, 'Learned dynamics')"
    )


def linearize(system: Any, x0: Any = None, u0: Any = None) -> Tuple[Tensor, Tensor]:
    """Jacobians (A, B) of a linear system: the system's own matrices."""
    if isinstance(system, (LinearDiscreteSystem, LinearContinuousSystem)):
        return system.A, system.B
    raise NotImplementedError(
        f"linearize({type(system).__name__}): neural systems are not ported "
        "yet (ROADMAP Queue 1, 'Learned dynamics')"
    )
