"""Runtime: the receding-horizon solve.

The port of the JAX package's ``runtime.py``:

- :func:`update_initialization` pins the measured state (a new
  controller; x0 only enters the per-solve QP vectors);
- :func:`calculate` solves at the pinned state and stores the results and
  the warm state on the controller;
- :func:`step` is both, the function a control loop calls every sample
  time;
- :func:`update_references` and :func:`update_and_compute` re-design the
  controller for new references (a fresh DARE, terminal ingredient and
  operators), keeping its engine's configuration.

:func:`solve_lanes` is the engines' batched solve: the condensed engine on
the general ADMM engine (``ops/admm.solve``), the Riccati engine on its
per-lane engine (``ops/riccati_fused.solve_sparse``, which runs K3, K3W
past (32, 16), or K3W's doubling form under ``parallel_sweeps``), the
SQP engine on ``solvers/sqp.py`` (single or multiple shooting), the
economic engine on ``solvers/empc.py``, and the MILP engine on the host
(``solvers/milp.solve_milp_batch``, a thread per lane). :func:`solve_once`
is its batch of one with the JAX package's unbatched shapes, and
``parallel.solve_batch`` its fleet form.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from .design import LinearEngine, MpcController, RiccatiEngine, design_controller
from .ops import admm as admm_ops
from .ops import riccati_fused
from .ops.condense import runtime_qp_vectors_batch
from .solvers import empc as empc_mod
from .solvers import sqp as sqp_mod
from .solvers.empc import EmpcEngine
from .solvers.milp import MilpEngine, solve_milp_batch
from .solvers.sqp import SqpEngine, true_objective
from .types import STATUS_PRIMAL_INFEASIBLE, MpcSolution

Tensor = torch.Tensor


def _infeasible_x0(controller: MpcController, x0s: Tensor, status: Tensor) -> Tensor:
    """Status 2 on lanes whose x0 lies outside the plant's state box. The
    reference also poses the box row on the (fixed) first state; with x0
    pinned it is a pure feasibility check, applied wherever the state
    constraint is hard (the JAX package's runtime and fused Riccati paths;
    its fused condensed path skips it, ROADMAP Queue 3)."""
    if controller.system is None:
        raise ValueError(
            "a state-constrained controller without a plant: the state box "
            "that x0 is checked against is unknown"
        )
    X = controller.system.X
    outside = ~torch.all((x0s >= X.lo) & (x0s <= X.hi), dim=1)
    return torch.where(outside, STATUS_PRIMAL_INFEASIBLE, status).to(torch.int32)


def linear_solution(
    controller: MpcController,
    x0s: Tensor,  # (B, nx)
    z: Tensor,  # (B, N nu) input deviations
    status: Tensor,
    iterations: Tensor,
    primal_residual: Tensor,
    dual_residual: Tensor,
) -> Tuple[MpcSolution, Tensor]:
    """A condensed engine's batch of solutions from its QP solutions: the
    trajectories, the objective, the x0-box status of a hard state
    constraint, and the next warm z (the input plan shifted one step)."""
    qp = controller.engine.qp
    tuning = controller.tuning
    refs = tuning.references
    N, nx, nu = qp.N, qp.nx, qp.nu
    B = x0s.shape[0]
    e0s = x0s - refs.x[:, 0][None]
    ex_tail = (z @ qp.G_flat.T + e0s @ qp.F.reshape(N * nx, nx).T).reshape(B, N, nx)
    ex = torch.cat([e0s[:, None], ex_tail], dim=1)  # (B, N+1, nx)
    eu = z.reshape(B, N, nu)
    xs = ex + refs.x.T[None]
    us = eu + refs.u.T[None]
    if tuning.state_constraint and controller.engine.soft_mu is None:
        # soft-constrained controllers never declare infeasibility on it
        status = _infeasible_x0(controller, x0s, status)
    sol = MpcSolution(
        x=xs.transpose(1, 2),
        e_x=ex.transpose(1, 2),
        u=us.transpose(1, 2),
        e_u=eu.transpose(1, 2),
        status=status,
        iterations=iterations,
        primal_residual=primal_residual,
        dual_residual=dual_residual,
        objective=true_objective(tuning, xs, us),
    )
    return sol, torch.cat([eu[:, 1:], eu[:, -1:]], dim=1).reshape(B, -1)


def riccati_solution(
    controller: MpcController,
    x0s: Tensor,  # (B, nx)
    X: Tensor,  # (B, N+1, nx) state deviations
    U: Tensor,  # (B, N, nu)
    status: Tensor,
    iterations: Tensor,
    primal_residual: Tensor,
    dual_residual: Tensor,
    lams: Tuple[Tensor, Tensor],  # lamX (B, N+1, nx), lamU (B, N, nu)
) -> Tuple[MpcSolution, Tensor, Tensor]:
    """A Riccati engine's batch of solutions: the objective, the x0-box
    status, and the receding-horizon warm carry (U, lamX and lamU shifted
    one step)."""
    tuning = controller.tuning
    refs = tuning.references
    B = x0s.shape[0]
    xs = X + refs.x.T[None]  # (B, N+1, nx)
    us = U + refs.u.T[None]  # (B, N, nu)
    if tuning.state_constraint:
        status = _infeasible_x0(controller, x0s, status)
    sol = MpcSolution(
        x=xs.transpose(1, 2),
        e_x=X.transpose(1, 2),
        u=us.transpose(1, 2),
        e_u=U.transpose(1, 2),
        status=status,
        iterations=iterations,
        primal_residual=primal_residual,
        dual_residual=dual_residual,
        objective=true_objective(tuning, xs, us),
    )
    shift = lambda t: torch.cat([t[:, 1:], t[:, -1:]], dim=1).reshape(B, -1)
    return sol, shift(U), torch.cat([shift(lams[0]), shift(lams[1])], dim=1)


def _solve_linear(controller, x0s, warm_z, warm_y):
    engine = controller.engine
    e0s = x0s - controller.tuning.references.x[:, 0][None]
    q, l, u, ball_c, ball_r = runtime_qp_vectors_batch(engine.qp, e0s)
    res = admm_ops.solve(
        engine.op, q, l, u, ball_c, ball_r, warm_z, warm_y,
        config=engine.config, soft_mu=engine.soft_mu,
    )
    sol, wz = linear_solution(
        controller, x0s, res.z, res.status, res.iterations,
        res.primal_residual, res.dual_residual,
    )
    return sol, wz, res.y


def riccati_warm(op, warm_z: Tensor, warm_y: Tensor):
    """A Riccati engine's flat warm pair as the solves take it: U (B, N,
    nu) and (lamX (B, N+1, nx), lamU (B, N, nu))."""
    N, nx, nu = op.N, op.nx, op.nu
    B = warm_z.shape[0]
    lamX = warm_y[:, : (N + 1) * nx].reshape(B, N + 1, nx)
    lamU = warm_y[:, (N + 1) * nx :].reshape(B, N, nu)
    return warm_z.reshape(B, N, nu), (lamX, lamU)


def _solve_riccati(controller, x0s, warm_z, warm_y):
    e0s = x0s - controller.tuning.references.x[:, 0][None]
    U0, lams0 = riccati_warm(controller.engine.op, warm_z, warm_y)
    X, U, status, iters, rp, rd, lams = riccati_fused.solve_sparse(
        controller.engine.op, e0s, warm_U=U0, warm_lam=lams0, config=controller.engine.config,
    )
    return riccati_solution(controller, x0s, X, U, status, iters, rp, rd, lams)


def _solve_sqp(controller, x0s, warm_z, warm_y):
    """The SQP engine over the lanes, and its shifted warm carry."""
    system, tuning, engine = controller.system, controller.tuning, controller.engine
    N, nx, nu = tuning.horizon, system.nx, system.nu
    if engine.shooting == "multiple":
        sol, z_f, y_f = sqp_mod.solve_nonlinear_ms(system, tuning, engine, x0s, warm_z, warm_y)
        z_next, y_next = sqp_mod.shift_warm_ms(z_f, y_f, N, nx, nu)
        return sol, z_next, y_next
    sol, u_f, y_f = sqp_mod.solve_nonlinear(system, tuning, engine, x0s, warm_z, warm_y)
    return sol, sqp_mod.shift_warm(u_f, N, nu), y_f


def _solve_empc(controller, x0s, warm_z, warm_y):
    """The economic engine over the lanes, and the shifted warm input."""
    system, tuning = controller.system, controller.tuning
    sol, u_f, y_f = empc_mod.solve_economic(system, tuning, controller.engine, x0s, warm_z, warm_y)
    return sol, sqp_mod.shift_warm(u_f, tuning.horizon, system.nu), y_f


def solve_lanes(
    controller: MpcController,
    x0s: Tensor,  # (B, nx)
    warm_z: Tensor,  # (B, n)
    warm_y: Tensor,  # (B, m)
) -> Tuple[MpcSolution, Tensor, Tensor]:
    """Solve a batch of states on the controller's engine, on the device of
    ``x0s``: the general ADMM engine for a condensed engine, the per-lane
    Riccati engine for a Riccati one, the batched SQP or EMPC for those,
    the host's branch and bound for a MILP engine. Returns (solutions with
    a leading batch axis, next warm_z, next warm_y): for a condensed engine
    the shifted primal and the raw dual, for a Riccati engine the shifted
    carries of U and of (lamX, lamU); a MILP engine carries no warm state
    (the pair comes back as it went in)."""
    engine = controller.engine
    if isinstance(engine, LinearEngine):
        return _solve_linear(controller, x0s, warm_z, warm_y)
    if isinstance(engine, RiccatiEngine):
        return _solve_riccati(controller, x0s, warm_z, warm_y)
    if isinstance(engine, SqpEngine):
        return _solve_sqp(controller, x0s, warm_z, warm_y)
    if isinstance(engine, EmpcEngine):
        return _solve_empc(controller, x0s, warm_z, warm_y)
    if isinstance(engine, MilpEngine):
        return solve_milp_batch(engine, controller.tuning, x0s), warm_z, warm_y
    raise TypeError(f"not an engine: {type(engine).__name__}")


def solve_once(
    controller: MpcController, x0: Tensor, warm_z: Tensor, warm_y: Tensor
) -> Tuple[MpcSolution, Tensor, Tensor]:
    """One solve at state x0 (nx,) with an explicit warm state: the batched
    engines at B = 1. Returns the JAX package's unbatched shapes: x (nx,
    N+1), u (nu, N), 0-d status, and the next warm pair."""
    sol, wz, wy = solve_lanes(controller, x0[None], warm_z[None], warm_y[None])
    return (
        MpcSolution(**{f.name: getattr(sol, f.name)[0] for f in dataclasses.fields(sol)}),
        wz[0],
        wy[0],
    )


def update_initialization(controller: MpcController, x0: Any) -> MpcController:
    """Pin the measured state (the only thing that changes between
    solves)."""
    x0 = torch.as_tensor(x0, dtype=torch.float32).to(controller.device)
    return controller.replace(initialization=x0)


def calculate(controller: MpcController) -> MpcController:
    """Solve at the pinned state; store the results and the warm state on
    the controller."""
    sol, wz, wy = solve_once(
        controller, controller.initialization, controller.warm_z, controller.warm_y
    )
    return controller.replace(results=sol, warm_z=wz, warm_y=wy)


def step(controller: MpcController, x0: Any) -> Tuple[MpcController, MpcSolution]:
    """update_initialization and calculate together: returns the controller
    carrying the new warm state, and the solution."""
    c = calculate(update_initialization(controller, x0))
    return c, c.results


def _host(v: Any) -> Any:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def update_references(controller: MpcController, x_ref: Any, u_ref: Any) -> MpcController:
    """Re-design the controller for new references: the reference
    trajectories, the terminal ingredient (a fresh DARE at the new
    endpoint) and the operators, on the host, then back to the
    controller's device. The engine's configuration carries over (the ADMM
    or Riccati config, the soft state penalty), the weight matrices pass
    through as they are, and so do the pinned state and the warm pair.
    An SQP engine keeps its SqpConfig and its soft boxes, an economic one
    its cost functions and EmpcConfig; a MILP engine is rebuilt from the
    plant and the tuning."""
    t = controller.tuning
    eng = controller.engine
    kwargs = {}
    if isinstance(eng, LinearEngine):
        kwargs["engine"] = "condensed"
        kwargs["admm_config"] = eng.config
        if eng.soft_mu is not None:
            mu = _host(eng.soft_mu)
            finite = mu[np.isfinite(mu)]
            if finite.size:
                kwargs["soft_state_penalty"] = float(finite.min())
    elif isinstance(eng, RiccatiEngine):
        kwargs["engine"] = "riccati"
        kwargs["riccati_config"] = eng.config
    elif isinstance(eng, SqpEngine):
        kwargs["sqp_config"] = eng.config
        if eng.soft_boxes:
            # keep the user-soft boxes (and their status gate) across the re-design
            kwargs["soft_state_penalty"] = eng.config.soft_state_penalty
    elif isinstance(eng, EmpcEngine):
        kwargs["economic_cost"] = eng.cost_fn
        kwargs["economic_terminal_cost"] = eng.terminal_cost_fn
        kwargs["empc_config"] = eng.config
    w = t.weights
    new = design_controller(
        controller.system.to("cpu"),
        t.horizon,
        t.sample_time,
        _host(x_ref),
        _host(u_ref),
        programming_type=t.programming_type,
        solver=t.solver_name,
        terminal_ingredient=t.terminal.kind,
        Q=_host(w.Q),
        R=_host(w.R),
        S=_host(w.S),
        max_time=t.max_time,
        state_constraint=t.state_constraint,
        device=controller.device,
        **kwargs,
    )
    return new.replace(
        initialization=controller.initialization,
        warm_z=controller.warm_z,
        warm_y=controller.warm_y,
    )


def update_and_compute(
    controller: MpcController, x0: Any, x_ref: Any = None, u_ref: Any = None
) -> Tuple[MpcController, MpcSolution]:
    """Refresh the references (where given), pin x0 and solve."""
    if x_ref is not None or u_ref is not None:
        refs = controller.tuning.references
        xr = refs.x[:, 0] if x_ref is None else x_ref
        ur = refs.u[:, 0] if u_ref is None else u_ref
        controller = update_references(controller, xr, ur)
    return step(controller, x0)
