"""Core type vocabulary of the PyTorch port.

The same records as the JAX package's ``types.py`` (Box, References,
Weights, TerminalIngredient, MpcSolution, the status codes), written as
frozen dataclasses of tensors. ``.to(device)`` moves every tensor field,
recursively, and returns a new record; ``.replace(**fields)`` is
``dataclasses.replace``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

Tensor = torch.Tensor

STATUS_CONVERGED = 0
STATUS_MAX_ITER = 1
STATUS_PRIMAL_INFEASIBLE = 2
STATUS_DUAL_INFEASIBLE = 3
STATUS_NUMERIC_ERROR = 4  # NaN/inf in the iterates

STATUS_NAMES = {
    STATUS_CONVERGED: "converged",
    STATUS_MAX_ITER: "max_iterations",
    STATUS_PRIMAL_INFEASIBLE: "primal_infeasible",
    STATUS_DUAL_INFEASIBLE: "dual_infeasible",
    STATUS_NUMERIC_ERROR: "numeric_error",
}


def _move(value: Any, device) -> Any:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, TensorRecord):
        return value.to(device)
    if isinstance(value, dict):  # a learned model's parameter tree
        return {k: _move(v, device) for k, v in value.items()}
    if isinstance(value, list):
        return [_move(v, device) for v in value]
    return value


class TensorRecord:
    """Mixin for frozen dataclasses whose fields are tensors (or records)."""

    def to(self, device):
        return dataclasses.replace(
            self,
            **{
                f.name: _move(getattr(self, f.name), device)
                for f in dataclasses.fields(self)
            },
        )

    def replace(self, **updates: Any):
        return dataclasses.replace(self, **updates)


def f32(a: Any) -> Tensor:
    """float32 tensor on the CPU, rounded by numpy exactly as ``jnp.asarray
    (a, jnp.float32)`` rounds, so host-designed arrays match bit for bit."""
    return torch.from_numpy(np.array(np.asarray(a, np.float64), np.float32))


@dataclasses.dataclass(frozen=True)
class Box(TensorRecord):
    """Axis-aligned box constraint set."""

    lo: Tensor  # (n,)
    hi: Tensor  # (n,)

    @property
    def n(self) -> int:
        return self.lo.shape[-1]

    def contains(self, x: Tensor, atol: float = 0.0) -> Tensor:
        return torch.all((x >= self.lo - atol) & (x <= self.hi + atol), dim=-1)

    def clip(self, x: Tensor) -> Tensor:
        return torch.clamp(x, self.lo, self.hi)


@dataclasses.dataclass(frozen=True)
class References(TensorRecord):
    """x: (nx, N+1) state reference, u: (nu, N) input reference."""

    x: Tensor
    u: Tensor

    @property
    def horizon(self) -> int:
        return self.u.shape[-1]


def design_references(x_ref: Any, u_ref: Any, horizon: int) -> References:
    """Broadcast setpoint vectors into constant reference trajectories:
    x: (nx, N+1), u: (nu, N)."""
    x = torch.as_tensor(np.asarray(x_ref, np.float32))
    u = torch.as_tensor(np.asarray(u_ref, np.float32))
    return References(
        x=x[:, None].repeat(1, horizon + 1), u=u[:, None].repeat(1, horizon)
    )


@dataclasses.dataclass(frozen=True)
class Weights(TensorRecord):
    """Q: (nx,nx) state weight, R: (nu,nu) input weight, S: (nu,nu) input
    rate-of-change weight."""

    Q: Tensor
    R: Tensor
    S: Tensor


TERMINAL_KINDS = ("none", "equality", "contractive", "neighborhood")
CONTRACTIVE_FACTOR = 0.9


@dataclasses.dataclass(frozen=True)
class TerminalIngredient(TensorRecord):
    """Terminal cost P (DARE) and, for kind "neighborhood", the set
    H e_x_N <= b."""

    kind: str
    P: Tensor
    H: Optional[Tensor] = None
    b: Optional[Tensor] = None


@dataclasses.dataclass(frozen=True)
class MpcSolution(TensorRecord):
    """Result of one MPC solve with solver diagnostics.

    Batched layouts: x, e_x: (B, nx, N+1); u, e_u: (B, nu, N); status,
    iterations, residuals, objective: (B,).
    """

    x: Tensor
    e_x: Tensor
    u: Tensor
    e_u: Tensor
    status: Tensor  # int32 status code (STATUS_*)
    iterations: Tensor  # int32
    primal_residual: Tensor
    dual_residual: Tensor
    objective: Tensor
