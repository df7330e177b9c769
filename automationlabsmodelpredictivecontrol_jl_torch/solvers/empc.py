"""Economic MPC: generic (non-tracking) stage costs, over a batch of lanes.

The JAX package's ``solvers/empc.py`` (its vmapped ``solve_economic``), in
PyTorch with the lanes on the leading axis:

  minimize  sum_{k=0..N-1} l(x_k, u_k)  +  Vf(x_N)
  s.t.      x_{k+1} = f(x_k, u_k),  u in U,  [x in X],  [terminal set]

with ``l`` a differentiable stage cost of torch tensors that ``torch.func``
can trace, and ``Vf`` an optional terminal cost (by default the quadratic
e_N' P e_N with P from the DARE at the reference endpoint).

Single-shooting SQP in the condensed input space. A generic economic cost
has no Gauss-Newton structure, so each iteration takes an exact Newton step
on the reduced objective, every lane at once:

  1. roll the dynamics forward,
  2. g = grad_u J (``torch.func.grad`` through the rollout, vmapped over
     the lanes),
  3. H = jacfwd(grad_u J), the exact reduced Hessian (n = N nu is small),
  4. H projected onto the PSD cone by eigenvalue clipping (a batched
     ``torch.linalg.eigh``),
  5. constraint rows from the trajectory Jacobians (``torch.func.jacfwd``,
     ``ops/condense.ltv_prediction_matrices``), the QPs solved by the
     general ADMM engine on per-lane operators,
  6. a branchless line search on an L1-penalty merit: every step length
     and the zero step rolled out at once.

A lane whose step falls under ``tol_du`` keeps its carry and its own
iteration count while the others go on; the loop reads the host once per
SQP iteration.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from ..ops import admm as admm_ops
from ..ops.condense import ltv_prediction_matrices
from ..types import STATUS_CONVERGED, STATUS_MAX_ITER, MpcSolution, TensorRecord
from . import sqp as sqp_mod

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EmpcConfig:
    """The JAX package's ``EmpcConfig``, same fields and defaults."""

    max_sqp_iter: int = 20
    damping: float = 1e-4  # Hessian eigenvalue floor and Levenberg term
    line_search_alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.03)
    soft_state_penalty: float = 1e4
    terminal_penalty: float = 1e4
    tol_du: float = 1e-6
    feas_tol: float = 1e-4  # constraint-violation gate on STATUS_CONVERGED
    scaling_iters: int = 2
    admm: admm_ops.AdmmConfig = admm_ops.AdmmConfig(
        max_iter=200, eps_abs=1e-7, eps_rel=1e-7, adaptive=True
    )


@dataclasses.dataclass(frozen=True)
class EmpcEngine(TensorRecord):
    """Engine record of the economic path: ``cost_fn(x, u) -> scalar`` the
    stage cost, ``terminal_cost_fn(x) -> scalar`` the terminal cost (None:
    the quadratic DARE penalty of the tuning's terminal ingredient), and
    the structure of the subproblem's rows."""

    config: EmpcConfig
    cost_fn: Callable
    terminal_cost_fn: Optional[Callable]
    state_rows: bool
    terminal_kind: str
    n_terminal_rows: int
    m_total: int

    @property
    def soft_boxes(self) -> bool:
        """Never: the state boxes are hard in the economic status gate."""
        return False


def build_engine(
    system,
    tuning,
    cost_fn: Callable,
    terminal_cost_fn: Optional[Callable] = None,
    config: Optional[EmpcConfig] = None,
) -> EmpcEngine:
    config = config or EmpcConfig()
    N, nx = tuning.horizon, system.nx
    kind = tuning.terminal.kind
    if kind in ("equality", "contractive"):
        n_term = nx
    elif kind == "neighborhood":
        n_term = int(tuning.terminal.H.shape[0])
    else:
        n_term = 0
    m = N * system.nu + (N * nx if tuning.state_constraint else 0) + n_term
    return EmpcEngine(
        config=config,
        cost_fn=cost_fn,
        terminal_cost_fn=terminal_cost_fn,
        state_rows=bool(tuning.state_constraint),
        terminal_kind=kind,
        n_terminal_rows=n_term,
        m_total=m,
    )


def initial_warm_state(engine: EmpcEngine, tuning) -> Tuple[Tensor, Tensor]:
    """Warm start: the input reference, duals 0."""
    u0 = tuning.references.u.T.reshape(-1).float().clone()
    return u0, torch.zeros((engine.m_total,))


def _dynamics_fn(system, refs):
    """(f(x, u) -> x_next, batched over leading axes; the per-step affine
    offsets cs (N, nx) or None).

    A linear system here is a deviation model valid around the reference
    trajectory; rolled out in absolute coordinates it needs the drift
    c_k = x_ref_{k+1} - A x_ref_k - B u_ref_k, so that the reference is an
    equilibrium of the prediction: x_{k+1} = A x_k + B u_k + c_k. Learned
    models are absolute (cs None)."""
    if hasattr(system, "apply_fn"):
        return (lambda x, u: system.apply_fn(system.params, x, u)), None
    A, B = system.A, system.B
    f = lambda x, u: x @ A.T + u @ B.T
    cs = refs.x[:, 1:].T - refs.x[:, :-1].T @ A.T - refs.u.T @ B.T
    return f, cs


def _rollout(f, x0: Tensor, us: Tensor, cs: Optional[Tensor]) -> Tensor:
    """x0 (..., nx), us (..., N, nu) -> (..., N+1, nx)."""
    xs = [x0]
    for k in range(us.shape[-2]):
        xn = f(xs[-1], us[..., k, :])
        xs.append(xn if cs is None else xn + cs[k])
    return torch.stack(xs, -2)


def economic_objective(engine: EmpcEngine, tuning, xs: Tensor, us: Tensor) -> Tensor:
    """J = sum_k l(x_k, u_k) + Vf(x_N) over the predicted pairs k = 0..N-1,
    for xs (..., N+1, nx), us (..., N, nu) -> (...). Vf defaults to the
    quadratic e_N' P e_N."""
    nx, nu = xs.shape[-1], us.shape[-1]
    lead = us.shape[:-2]
    stage = torch.func.vmap(engine.cost_fn)(xs[..., :-1, :].reshape(-1, nx), us.reshape(-1, nu))
    J = stage.reshape(lead + us.shape[-2:-1]).sum(-1)
    x_last = xs[..., -1, :]
    if engine.terminal_cost_fn is not None:
        return J + torch.func.vmap(engine.terminal_cost_fn)(x_last.reshape(-1, nx)).reshape(lead)
    e_last = x_last - tuning.references.x[:, -1]
    return J + torch.einsum("...i,ij,...j->...", e_last, tuning.terminal.P, e_last)


def _merit(engine: EmpcEngine, tuning, system, xs: Tensor, us: Tensor) -> Tensor:
    """Line-search merit per lane: the economic objective plus L1 penalties
    on state-box and terminal-set violation. xs (B, N+1, nx), us (B, N, nu)."""
    J = economic_objective(engine, tuning, xs, us)
    return sqp_mod._add_penalties(engine, tuning, system, xs, J)


def _psd_project(H: Tensor, floor: float) -> Tensor:
    """Eigenvalue-clipped PSD projection of symmetric (B, n, n) matrices
    (economic Hessians go indefinite away from optima; clipping keeps the
    Newton step a descent direction)."""
    w, V = torch.linalg.eigh(H)
    w = torch.clamp_min(w, floor)
    return (V * w[:, None, :]) @ V.transpose(1, 2)


def solve_economic(
    system,
    tuning,
    engine: EmpcEngine,
    x0: Tensor,  # (B, nx)
    u_warm: Tensor,  # (B, N nu) raw input trajectory
    y_warm: Tensor,  # (B, m) duals
):
    """EMPC solves of a batch of lanes. Returns (MpcSolution with a leading
    batch axis, u_final (B, N nu), y_final (B, m))."""
    cfg = engine.config
    N = tuning.horizon
    nx, nu = system.nx, system.nu
    n = N * nu
    Bt = x0.shape[0]
    dev, dt = x0.device, torch.float32
    refs = tuning.references
    f, cs = _dynamics_fn(system, refs)
    x0 = x0.to(dt)

    eq_mask, soft_mu, n_ball = sqp_mod._row_masks(engine, N, nx, nu, dev)
    alphas = torch.tensor(cfg.line_search_alphas, dtype=dt, device=dev)
    u_lo = system.U.lo.repeat(N)
    u_hi = system.U.hi.repeat(N)
    eye_n = torch.eye(n, dtype=dt, device=dev)
    need_G = engine.state_rows or engine.terminal_kind != "none"

    def reduced_objective(u_flat, x0_lane):  # one lane: (n,), (nx,) -> ()
        us = u_flat.reshape(N, nu)
        return economic_objective(engine, tuning, _rollout(f, x0_lane, us, cs), us)

    grad_fn = torch.func.grad(reduced_objective)
    grads = torch.func.vmap(grad_fn)
    hessians = torch.func.vmap(torch.func.jacfwd(grad_fn))
    jacs = torch.func.vmap(torch.func.jacfwd(f, argnums=(0, 1)))
    merit = lambda xx, uu: _merit(engine, tuning, system, xx, uu)

    def sqp_step(u_flat, y):
        us = u_flat.reshape(Bt, N, nu)
        xs = _rollout(f, x0, us, cs)

        # the exact reduced Newton model g + H d, H projected onto the PSD cone
        g = grads(u_flat, x0)
        H = hessians(u_flat, x0)
        P_qp = _psd_project(0.5 * (H + H.transpose(1, 2)), cfg.damping) + cfg.damping * eye_n

        rows_A = [eye_n.expand(Bt, n, n)]
        rows_l = [u_lo - u_flat]
        rows_u = [u_hi - u_flat]
        if need_G:
            As, Bs = jacs(xs[:, :-1].reshape(Bt * N, nx), us.reshape(Bt * N, nu))
            _, G, _ = ltv_prediction_matrices(
                As.reshape(Bt, N, nx, nx), Bs.reshape(Bt, N, nx, nu)
            )
            G_flat = G.permute(0, 1, 3, 2, 4).reshape(Bt, N * nx, n)
        if engine.state_rows:
            xs_tail = xs[:, 1:].reshape(Bt, -1)
            rows_A.append(G_flat)
            rows_l.append(system.X.lo.repeat(N) - xs_tail)
            rows_u.append(system.X.hi.repeat(N) - xs_tail)
        ball_c = xs.new_zeros((Bt, 0))
        ball_r = xs.new_zeros((Bt,))
        ex_last = xs[:, -1] - refs.x[:, -1]
        if engine.terminal_kind == "equality":
            rows_A.append(G_flat[:, -nx:])
            rows_l.append(-ex_last)
            rows_u.append(-ex_last)
        elif engine.terminal_kind == "neighborhood":
            Ht, b = tuning.terminal.H, tuning.terminal.b
            rows_A.append(Ht @ G_flat[:, -nx:])
            rows_l.append(xs.new_full((Bt, Ht.shape[0]), -math.inf))
            rows_u.append(b - ex_last @ Ht.T)
        elif engine.terminal_kind == "contractive":
            rows_A.append(G_flat[:, -nx:])
            rows_l.append(xs.new_full((Bt, nx), -math.inf))
            rows_u.append(xs.new_full((Bt, nx), math.inf))
            ball_c = ex_last
            ball_r = sqp_mod._sqrt_f32(0.9, xs) * torch.linalg.vector_norm(
                x0 - refs.x[:, 0], dim=1
            )

        op = admm_ops.build_operator_traced(
            2.0 * P_qp, torch.cat(rows_A, 1), eq_mask, n_ball, cfg.admm, cfg.scaling_iters
        )
        res = admm_ops.solve(
            op, 2.0 * g, torch.cat(rows_l, 1), torch.cat(rows_u, 1), ball_c, ball_r, None, y,
            config=cfg.admm, soft_mu=soft_mu,
        )
        du = res.z.reshape(Bt, N, nu)

        def cands(a):
            uc = torch.clamp(us[None] + a[:, None, None, None] * du[None], system.U.lo, system.U.hi)
            xc = _rollout(f, x0.repeat(a.shape[0], 1), uc.reshape(-1, N, nu), cs)
            return [xc.reshape((a.shape[0], Bt) + xc.shape[1:]), uc]

        _, u_new = sqp_mod._line_search(merit, alphas, cands, [xs, us])
        du_norm = (u_new - us).abs().flatten(1).amax(1)
        return u_new.reshape(Bt, -1), res.y, du_norm

    u_f = u_warm.to(dt)
    y_f = y_warm.to(dt)
    it_f = torch.zeros((Bt,), dtype=torch.int32, device=dev)
    done_f = torch.zeros((Bt,), dtype=torch.bool, device=dev)
    while True:
        open_ = (~done_f) & (it_f < cfg.max_sqp_iter)
        if not bool(open_.any()):
            break
        u_n, y_n, du_norm = sqp_step(u_f, y_f)
        u_f = sqp_mod._where(open_, u_n, u_f)
        y_f = sqp_mod._where(open_, y_n, y_f)
        it_f = it_f + open_.to(torch.int32)
        done_f = torch.where(open_, du_norm < cfg.tol_du, done_f)

    us = u_f.reshape(Bt, N, nu)
    xs = _rollout(f, x0, us, cs)
    # the status gate: a merit-stalled iterate with unresolved state or
    # terminal violations does not report converged (tol_du alone cannot see
    # feasibility); the violation is reported as the primal residual
    viol = sqp_mod._violation(engine, tuning, system, xs)
    status = torch.where(done_f & (viol <= cfg.feas_tol), STATUS_CONVERGED, STATUS_MAX_ITER)
    sol = MpcSolution(
        x=xs.transpose(1, 2),
        e_x=(xs - refs.x.T).transpose(1, 2),
        u=us.transpose(1, 2),
        e_u=(us - refs.u.T).transpose(1, 2),
        status=status.to(torch.int32),
        iterations=it_f,
        primal_residual=viol,
        dual_residual=xs.new_zeros((Bt,)),
        objective=economic_objective(engine, tuning, xs, us),
    )
    return sol, u_f, y_f
