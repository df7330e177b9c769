"""Controller design: the once-per-controller stage of the MPC engine.

Design precomputes numeric solver operators on the host, in numpy f64,
exactly as the JAX package does: the condensed QP matrices and the
factorized ADMM KKT system. The finished controller is then moved to the
device the caller names.

Every branch of the JAX package: the condensed linear branch, the
Riccati branch (the O(N) long-horizon engine), the learned-plant branches
(the SQP engine, ``programming_type="non_linear"``, the default for a
learned plant and for a Takagi-Sugeno one under "fuzzy_linear"; "linear"
programming, which linearizes the plant at the first reference and designs
the linear engines on that), the economic-MPC engine (``economic_cost``)
and the exact-ReLU MILP engine (``programming_type="mixed_linear"``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .ops import admm as admm_ops
from .ops import riccati as riccati_ops
from .ops.condense import CondensedQpData, condense_np
from .solvers import empc as empc_mod
from .solvers import milp as milp_mod
from .solvers import sqp as sqp_mod
from .solvers.registry import engine_for, resolve_solver
from .systems import (
    LinearDiscreteSystem,
    NeuralContinuousSystem,
    NeuralDiscreteSystem,
    as_discrete,
    linearize_to_system,
)
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
class RiccatiEngine(TensorRecord):
    """O(N) sparse engine: Riccati-factorized ADMM over the block-
    tridiagonal KKT system (``ops/riccati.py``), the long-horizon path.
    Selected by ``engine="riccati"``, or by "auto" at long horizons. The
    engine keeps the user's config (auto rho stays None); the operator
    resolves it against R."""

    op: riccati_ops.RiccatiOperator
    config: riccati_ops.RiccatiConfig


# horizon at which engine="auto" switches the linear path from the
# condensed O((N nu)^2) engine to the O(N) Riccati engine. The JAX
# package's value, measured on a TPU v5e (QTP, B=2048-4096); kept so that
# both packages design the same controller for the same arguments. It is
# re-decided on the H100 once the port has its condensed general engine
# (ROADMAP Queue 1, "Riccati engine").
RICCATI_AUTO_HORIZON = 500


def riccati_supported(terminal_kind: str, S, soft_state_penalty) -> bool:
    """Feature gate of the sparse engine: no input-rate weight (S = 0), no
    soft rows, a terminal kind that is a box or a ball per state block."""
    if soft_state_penalty is not None:
        return False
    if terminal_kind not in ("none", "equality", "contractive"):
        return False
    return not np.any(np.asarray(S, np.float64) != 0.0)


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


def _riccati_engine(
    lin_system: LinearDiscreteSystem,
    tuning: MpcTuning,
    config: riccati_ops.RiccatiConfig,
) -> RiccatiEngine:
    """The factorized sparse engine, with deviation-space boxes around the
    first reference point. Warm state: U (N nu,) and the duals (lamX,
    lamU) ((N+1) nx + N nu,)."""
    refs = tuning.references
    nx = refs.x.shape[0]
    x_ref0 = np.asarray(refs.x[:, 0], np.float64)
    u_ref0 = np.asarray(refs.u[:, 0], np.float64)
    if tuning.state_constraint:
        x_lo = np.asarray(lin_system.X.lo, np.float64) - x_ref0
        x_hi = np.asarray(lin_system.X.hi, np.float64) - x_ref0
    else:
        x_lo = np.full((nx,), -np.inf)
        x_hi = np.full((nx,), np.inf)
    op = riccati_ops.build_riccati_operator(
        lin_system.A, lin_system.B, tuning.weights.Q, tuning.weights.R,
        tuning.terminal.P, tuning.horizon, x_lo, x_hi,
        np.asarray(lin_system.U.lo, np.float64) - u_ref0,
        np.asarray(lin_system.U.hi, np.float64) - u_ref0,
        tuning.state_constraint,
        terminal_kind=tuning.terminal.kind,
        config=config,
    )
    return RiccatiEngine(op=op, config=config)


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
    economic_terminal_cost: Optional[Any] = None,
    empc_config: Optional[empc_mod.EmpcConfig] = None,
    engine: str = "auto",
    riccati_config: Optional[riccati_ops.RiccatiConfig] = None,
    sqp_config: Optional[sqp_mod.SqpConfig] = None,
    device: Any = None,
) -> MpcController:
    """Design an MPC controller on the host and move it to ``device``
    (``None``: the card, raising where there is none; "cpu" only when
    named).

    ``engine``: "condensed" (dense condensed QP and factorized ADMM, the
    short-horizon default), "riccati" (the O(N) Riccati-ADMM engine; needs
    S = 0, hard constraints and a none/equality/contractive terminal), or
    "auto": Riccati at ``horizon >= RICCATI_AUTO_HORIZON`` where it is
    supported, condensed otherwise, as in the JAX package.

    A learned plant (``NeuralDiscreteSystem``, or a continuous one,
    integrated by RK4) gets the SQP engine (``sqp_config``) by default
    (``programming_type="non_linear"``); ``programming_type="linear"``
    linearizes it at the first reference point and designs the linear
    engines on that.

    ``economic_cost``, a stage cost ``l(x, u) -> scalar`` of torch tensors
    that ``torch.func`` can trace, switches to the economic-MPC engine
    (``solvers/empc.py``, ``empc_config``; ``economic_terminal_cost`` an
    optional ``Vf(x) -> scalar``), always the NLP route, even over a linear
    plant. ``programming_type="mixed_linear"`` on a ReLU-network plant
    designs the exact-ReLU MILP engine (``solvers/milp.py``), which solves
    on the host.
    """
    dev = resolve_device(device)  # before the design: no card, no work
    if isinstance(system, (NeuralDiscreteSystem, NeuralContinuousSystem)):
        system = system.to("cpu")  # design runs on the host
    sys_d = as_discrete(system, sample_time)
    is_neural = isinstance(sys_d, NeuralDiscreteSystem)
    if economic_cost is not None:
        # economic objectives are generically not quadratic: always the
        # NLP route, even over a linear plant
        if programming_type is None:
            programming_type = "non_linear"
        solver_name = resolve_solver(programming_type, solver)
        engine_kind = "empc"
    else:
        if programming_type is None:
            programming_type = "non_linear" if is_neural else "linear"
        solver_name = resolve_solver(programming_type, solver)
        engine_kind = engine_for(programming_type)
        if engine_kind == "milp" and not is_neural:
            raise ValueError(
                "mixed_linear programming requires a learned ReLU-network system "
                "(the MILP transcription exists for fnn/icnn/resnet/densenet/polynet)"
            )
        if not is_neural and engine_kind == "sqp":
            # nonlinear programming over a linear model degenerates to the QP
            engine_kind = "admm"
            programming_type = "linear"

    if engine not in ("auto", "condensed", "riccati"):
        raise ValueError(f"unknown engine {engine!r}; available: auto|condensed|riccati")

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
    if engine_kind in ("sqp", "empc", "milp"):
        if engine_kind == "sqp":
            eng = sqp_mod.build_engine(
                sys_d, tuning, sqp_config, soft_state_penalty=soft_state_penalty
            )
            warm_z, warm_y = sqp_mod.initial_warm_state(eng, tuning)
        elif engine_kind == "empc":
            eng = empc_mod.build_engine(
                sys_d, tuning, economic_cost, economic_terminal_cost, empc_config
            )
            warm_z, warm_y = empc_mod.initial_warm_state(eng, tuning)
        else:
            eng = milp_mod.build_engine(sys_d, tuning)
            warm_z, warm_y = torch.zeros((eng.n,)), torch.zeros((eng.m,))
        return MpcController(
            system=sys_d,
            tuning=tuning,
            engine=eng,
            initialization=torch.zeros((nx,), dtype=torch.float32),
            warm_z=warm_z,
            warm_y=warm_y,
            results=None,
        ).to(dev)

    # "linear" programming on a learned plant: linearize at the first
    # reference point, then the linear engines
    lin_sys = (
        linearize_to_system(sys_d, references.x[:, 0], references.u[:, 0])
        if is_neural
        else sys_d
    )
    use_riccati = engine == "riccati" or (
        engine == "auto"
        and horizon >= RICCATI_AUTO_HORIZON
        and riccati_supported(terminal.kind, weights.S, soft_state_penalty)
    )
    if use_riccati:
        if not riccati_supported(terminal.kind, weights.S, soft_state_penalty):
            raise ValueError(
                "riccati engine requires S=0, hard constraints and a "
                "none/equality/contractive terminal kind; use "
                "engine='condensed' for this configuration"
            )
        eng = _riccati_engine(lin_sys, tuning, riccati_config or riccati_ops.RiccatiConfig())
        n, m = horizon * nu, (horizon + 1) * nx + horizon * nu
    else:
        eng = _linear_engine(
            lin_sys, tuning, admm_config or admm_ops.AdmmConfig(), soft_state_penalty
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
