"""Controller design: the once-per-controller stage of the MPC engine.

Design precomputes numeric solver operators on the host, in numpy f64,
exactly as the JAX package does: the condensed QP matrices and the
factorized ADMM KKT system. The finished controller is then moved to the
device the caller names.

Ported: the condensed linear branch. The Riccati, SQP, economic-MPC and
MILP branches raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .ops import admm as admm_ops
from .ops.condense import CondensedQpData, condense_np
from .solvers.registry import engine_for, resolve_solver
from .systems import LinearDiscreteSystem, as_discrete
from .terminal import create_terminal_ingredient
from .utils.devices import resolve_device
from .types import (
    MpcSolution,
    References,
    TensorRecord,
    TerminalIngredient,
    Weights,
    design_references,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MpcTuning(TensorRecord):
    """Design-time tuning record."""

    references: References
    weights: Weights
    terminal: TerminalIngredient
    horizon: int
    sample_time: float
    max_time: float
    programming_type: str
    solver_name: str
    state_constraint: bool


@dataclasses.dataclass(frozen=True)
class LinearEngine(TensorRecord):
    """Condensed-QP + factorized-ADMM engine. soft_mu: per-row L1 penalty
    for soft rows (inf = hard); None when all rows are hard."""

    qp: CondensedQpData
    op: admm_ops.AdmmOperator
    soft_mu: Optional[Tensor]
    config: admm_ops.AdmmConfig


@dataclasses.dataclass(frozen=True)
class MpcController(TensorRecord):
    """System + tuning + engine + warm state, replaced (never mutated)."""

    system: Any
    tuning: MpcTuning
    engine: Any
    initialization: Tensor  # (nx,)
    warm_z: Tensor  # (n,)
    warm_y: Tensor  # (m,)
    results: Optional[MpcSolution]

    @property
    def nx(self) -> int:
        return self.tuning.references.x.shape[0]

    @property
    def nu(self) -> int:
        return self.tuning.references.u.shape[0]

    @property
    def device(self) -> torch.device:
        return self.warm_z.device


def create_weights(nx: int, nu: int, q: Any, r: Any, s: Any) -> Weights:
    """Q = q I(nx), R = r I(nu), S = s I(nu) for scalars, in float32; full
    matrices pass through."""

    def mat(v, n):
        v = torch.as_tensor(np.asarray(v, np.float32))
        return v if v.ndim == 2 else v * torch.eye(n, dtype=torch.float32)

    return Weights(Q=mat(q, nx), R=mat(r, nu), S=mat(s, nu))


def _linear_engine(
    lin_system: LinearDiscreteSystem,
    tuning: MpcTuning,
    admm_config: admm_ops.AdmmConfig,
    soft_state_penalty: Optional[float] = None,
) -> LinearEngine:
    qp = condense_np(
        lin_system.A,
        lin_system.B,
        tuning.horizon,
        tuning.weights,
        tuning.terminal,
        tuning.references,
        lin_system.X,
        lin_system.U,
        tuning.state_constraint,
    )
    l_np = np.asarray(qp.l_const)
    u_np = np.asarray(qp.u_const)
    eq_mask = np.isfinite(l_np) & np.isfinite(u_np) & (l_np == u_np)
    op = admm_ops.build_operator(qp.P, qp.A, eq_mask, qp.n_ball, admm_config)
    soft_mu = None
    if soft_state_penalty is not None and tuning.state_constraint:
        N, nx, nu = qp.N, qp.nx, qp.nu
        mu = np.full(qp.A.shape[0], np.inf, np.float32)
        mu[N * nu : N * nu + N * nx] = float(soft_state_penalty)
        soft_mu = torch.from_numpy(mu)
    return LinearEngine(qp=qp, op=op, soft_mu=soft_mu, config=admm_config)


def design_controller(
    system: Any,
    horizon: int,
    sample_time: float,
    x_ref: Any,
    u_ref: Any,
    *,
    programming_type: Optional[str] = None,
    solver: str = "auto",
    terminal_ingredient: str = "none",
    Q: float = 100.0,
    R: float = 0.1,
    S: float = 0.0,
    max_time: float = 30.0,
    state_constraint: bool = False,
    soft_state_penalty: Optional[float] = None,
    admm_config: Optional[admm_ops.AdmmConfig] = None,
    economic_cost: Optional[Any] = None,
    engine: str = "auto",
    device: Any = None,
) -> MpcController:
    """Design an MPC controller on the host and move it to ``device``
    (``None``: the card, raising where there is none; "cpu" only when
    named).

    ``engine``: "condensed" (the ported engine) or "auto", which is the
    condensed engine here: the JAX package's switch to its O(N) Riccati
    engine at long horizons was measured on other hardware and is not
    ported (ROADMAP Queue 1, "Riccati engine"). "riccati" raises.
    """
    dev = resolve_device(device)  # before the design: no card, no work
    if economic_cost is not None:
        raise NotImplementedError(
            "economic MPC is not ported yet (ROADMAP Queue 1, 'Economic MPC "
            "and fuzzy control')"
        )
    sys_d = as_discrete(system, sample_time)
    if programming_type is None:
        programming_type = "linear"
    solver_name = resolve_solver(programming_type, solver)
    engine_kind = engine_for(programming_type)
    if engine_kind == "milp":
        raise ValueError(
            "mixed_linear programming requires a learned ReLU-network system"
        )
    # nonlinear programming over a linear model degenerates to the QP
    programming_type = "linear"

    if engine not in ("auto", "condensed", "riccati"):
        raise ValueError(f"unknown engine {engine!r}; available: auto|condensed|riccati")
    if engine == "riccati":
        raise NotImplementedError(
            "the Riccati engine is not ported yet (ROADMAP Queue 1, 'Riccati engine')"
        )

    nx, nu = sys_d.nx, sys_d.nu
    references = design_references(x_ref, u_ref, horizon)
    weights = create_weights(nx, nu, Q, R, S)
    terminal = create_terminal_ingredient(sys_d, terminal_ingredient, references, weights)
    tuning = MpcTuning(
        references=references,
        weights=weights,
        terminal=terminal,
        horizon=int(horizon),
        sample_time=float(sample_time),
        max_time=float(max_time),
        programming_type=programming_type,
        solver_name=solver_name,
        state_constraint=bool(state_constraint),
    )
    eng = _linear_engine(
        sys_d, tuning, admm_config or admm_ops.AdmmConfig(), soft_state_penalty
    )
    m, n = eng.op.A_s.shape
    return MpcController(
        system=sys_d,
        tuning=tuning,
        engine=eng,
        initialization=torch.zeros((nx,), dtype=torch.float32),
        warm_z=torch.zeros((n,), dtype=torch.float32),
        warm_y=torch.zeros((m,), dtype=torch.float32),
        results=None,
    ).to(dev)
