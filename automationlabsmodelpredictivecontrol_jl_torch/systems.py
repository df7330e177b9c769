"""System types, discretization and linearization.

The JAX package's ``systems.py``: linear discrete and continuous plants
(exact zero-order-hold discretization), learned plants
(:class:`NeuralDiscreteSystem`, :class:`NeuralContinuousSystem`, RK4
integration), the fuzzy :func:`takagi_sugeno_system`, and Jacobian
linearization by ``torch.func.jacfwd``. A learned plant's
``apply_fn(params, x, u)`` takes batches: x (..., nx), u (..., nu).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

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


@dataclasses.dataclass(frozen=True)
class NeuralDiscreteSystem(TensorRecord):
    """x_{k+1} = f(params, x_k, u_k), f a learned model of a zoo family
    (``models/zoo.py``) or a user function. ``activation`` records the
    activation name of a zoo model (checkpoints rebuild apply_fn from
    (family, activation)); None for an opaque callable. ``.to(device)``
    moves the parameter tree."""

    apply_fn: Callable[..., Tensor]
    family: str
    nx: int
    nu: int
    params: Any
    X: Box
    U: Box
    activation: Optional[str] = None

    def step(self, x: Tensor, u: Tensor) -> Tensor:
        """Batched step: x (..., nx), u (..., nu)."""
        return self.apply_fn(self.params, x, u)


@dataclasses.dataclass(frozen=True)
class NeuralContinuousSystem(TensorRecord):
    """dx/dt = f(params, x, u); integrated with RK4 by :func:`as_discrete`."""

    apply_fn: Callable[..., Tensor]
    family: str
    nx: int
    nu: int
    params: Any
    X: Box
    U: Box
    activation: Optional[str] = None

    def deriv(self, x: Tensor, u: Tensor) -> Tensor:
        return self.apply_fn(self.params, x, u)


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


def as_discrete(system: Any, sample_time: float, substeps: int = 1) -> Any:
    """Any system as a discrete one: a continuous linear plant by exact
    ZOH, a continuous learned one by ``substeps`` RK4 steps over the sample
    time; discrete systems pass through unchanged."""
    if isinstance(system, LinearContinuousSystem):
        return discretize(system, sample_time)
    if isinstance(system, NeuralContinuousSystem):
        dt = sample_time / substeps
        cont = system

        def stepped(params, x, u):
            for _ in range(substeps):
                x = rk4_step(lambda xx, uu: cont.apply_fn(params, xx, uu), x, u, dt)
            return x

        return NeuralDiscreteSystem(
            apply_fn=stepped, family=cont.family, nx=cont.nx, nu=cont.nu,
            params=cont.params, X=cont.X, U=cont.U, activation=cont.activation,
        )
    if isinstance(system, (LinearDiscreteSystem, NeuralDiscreteSystem)):
        return system
    raise TypeError(f"not a system: {type(system).__name__}")


def takagi_sugeno_system(
    As: Any,  # (M, nx, nx) local models
    Bs: Any,  # (M, nx, nu)
    centers: Any,  # (M, nx) membership centers
    widths: Any,  # (M,) or (M, nx) Gaussian membership widths
    X: Box,
    U: Box,
) -> NeuralDiscreteSystem:
    """Takagi-Sugeno multi-model system: x+ = sum_i mu_i(x) (A_i x + B_i u)
    with normalized Gaussian memberships mu_i = softmax_i(-d_i^2 / 2), d_i
    the distance of x from center i in units of its widths. The blend is a
    smooth model like any learned one: ``mpc_programming_type=
    "fuzzy_linear"`` routes it to the SQP engine (``solvers/registry.py``).
    ``apply_fn`` takes batches: x (..., nx), u (..., nu)."""
    params = {
        k: torch.as_tensor(np.asarray(v, np.float32))
        for k, v in (("As", As), ("Bs", Bs), ("centers", centers), ("widths", widths))
    }
    nx = params["As"].shape[-1]
    nu = params["Bs"].shape[-1]

    def apply_fn(p, x, u):
        c = p["centers"]
        w = p["widths"].reshape(c.shape[0], -1)  # (M, 1) or (M, nx)
        d2 = (((x[..., None, :] - c) / w) ** 2).sum(-1)  # (..., M)
        mu = torch.softmax(-0.5 * d2, dim=-1)
        xs = torch.einsum("mij,...j->...mi", p["As"], x) + torch.einsum(
            "mij,...j->...mi", p["Bs"], u
        )
        return torch.einsum("...m,...mi->...i", mu, xs)

    return NeuralDiscreteSystem(
        apply_fn=apply_fn, family="takagi_sugeno", nx=int(nx), nu=int(nu),
        params=params, X=X, U=U,
    )


def user_function_system(
    f: Callable[[Tensor, Tensor], Tensor],
    nx: int,
    nu: int,
    X: Box,
    U: Box,
    *,
    discrete: bool = True,
) -> Any:
    """A user's dynamics f(x, u) -> x_next (discrete) or dx/dt (continuous),
    batched over leading axes, as a system of the "physical" family."""

    def apply_fn(params, x, u):
        return f(x, u)

    cls = NeuralDiscreteSystem if discrete else NeuralContinuousSystem
    return cls(apply_fn=apply_fn, family="physical", nx=nx, nu=nu, params=None, X=X, U=U)


def linearize(system: Any, x0: Any = None, u0: Any = None) -> Tuple[Tensor, Tensor]:
    """Jacobians A = df/dx, B = df/du at (x0, u0): a linear system's own
    matrices, a learned one's by forward-mode ``torch.func.jacfwd`` of its
    apply_fn (a relu's derivative at exactly 0 is 0, as jax.nn.relu's)."""
    if isinstance(system, (LinearDiscreteSystem, LinearContinuousSystem)):
        return system.A, system.B
    if isinstance(system, (NeuralDiscreteSystem, NeuralContinuousSystem)):
        x0 = torch.as_tensor(x0, dtype=torch.float32)
        u0 = torch.as_tensor(u0, dtype=torch.float32)
        f = lambda x, u: system.apply_fn(system.params, x, u)
        return torch.func.jacfwd(f, argnums=(0, 1))(x0, u0)
    raise TypeError(f"not a system: {type(system).__name__}")


def linearize_to_system(system: Any, x0: Any, u0: Any) -> LinearDiscreteSystem:
    """A (discrete) learned system linearized at (x0, u0) as a
    LinearDiscreteSystem with the same constraint sets: the "linear"
    programming type on a learned plant."""
    A, B = linearize(system, x0, u0)
    return LinearDiscreteSystem(A=A.detach(), B=B.detach(), X=system.X, U=system.U)
