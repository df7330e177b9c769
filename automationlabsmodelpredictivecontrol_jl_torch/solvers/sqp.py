"""SQP nonlinear-MPC engine over a batch of lanes.

The JAX package's ``solvers/sqp.py`` (its vmapped ``solve_once``), in
PyTorch with the lanes on the leading axis. Single shooting:

  1. roll the learned model forward (a loop over the horizon of batched
     model calls),
  2. linearize along the trajectory with ``torch.func.jacfwd``, every
     (lane, step) pair at once under ``torch.func.vmap``,
  3. build the condensed Gauss-Newton LTV-QP in the input deviations with
     Levenberg damping, one operator per lane
     (``ops.admm.build_operator_traced``),
  4. solve the lanes' QPs with the general ADMM engine (``ops.admm.solve``
     on the per-lane operator),
  5. a branchless line search: every step length and the zero step rolled
     out at once, the least merit (true cost + L1 penalties on state-box and
     terminal violation) taken per lane.

Phase 1 runs ``full_jacobian_iters`` full relinearizations, masked per
lane; phase 2 is the quasi-Newton tail on the frozen operators, run while
any lane is open, a finished lane keeping its carry (the JAX package's
vmapped ``while_loop``). Multiple shooting (``shooting="multiple"``) keeps
the states as decision variables and solves the block-tridiagonal KKT of
each Gauss-Newton step with ``ops/riccati_ltv.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import admm as admm_ops
from ..ops.condense import ltv_prediction_matrices
from ..types import STATUS_CONVERGED, STATUS_MAX_ITER, MpcSolution, TensorRecord

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SqpConfig:
    """The JAX package's ``SqpConfig``, same fields and defaults."""

    # "single": condensed rollout SQP; "multiple": the states are decision
    # variables and the dynamics equality rows (robust where a single-
    # shooting rollout of an unstable or stiff model explodes)
    shooting: str = "single"
    max_sqp_iter: int = 12
    # the first full_jacobian_iters iterations relinearize and refactorize;
    # later ones reuse the frozen operator with the gradient from the
    # current rollout (the line search and the status always measure the
    # true rollout). 0 relinearizes every iteration.
    full_jacobian_iters: int = 3
    damping: float = 1e-4
    line_search_alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1)
    soft_state_penalty: float = 1e4  # L1 slack penalty on state boxes
    terminal_penalty: float = 1e4  # merit penalty on terminal-set violation
    defect_penalty: float = 1e4  # merit penalty on shooting defects (multiple)
    tol_du: float = 1e-5
    feas_tol: float = 1e-4  # constraint-violation gate on STATUS_CONVERGED
    scaling_iters: int = 2
    # multiple shooting's inner subproblem: fixed ADMM budget and consensus
    # rho (None: matched to the weights' scale)
    ms_admm_iters: int = 120
    ms_rho: Optional[float] = None
    # refine_steps=1: the Newton-Schulz inverse saturates at a residual
    # floor of ~kappa eps; one refinement against the exact K contracts the
    # K-solve error by that floor (kappa 1e4: 1.9e-2 -> 1.2e-6)
    admm: admm_ops.AdmmConfig = admm_ops.AdmmConfig(
        max_iter=150, eps_abs=1e-6, eps_rel=1e-6, adaptive=True, refine_steps=1,
    )


@dataclasses.dataclass(frozen=True)
class SqpEngine(TensorRecord):
    """Engine record of the nonlinear path: the subproblem operators are
    rebuilt every SQP iteration, so it carries only the rows' structure."""

    config: SqpConfig
    state_rows: bool
    terminal_kind: str
    n_terminal_rows: int
    m_total: int
    shooting: str
    # True when the user declared the state boxes soft
    # (mpc_soft_state_constraint=<penalty>): their violation is a priced
    # objective term, not a feasibility failure of the status gate
    soft_boxes: bool = False


def build_engine(system, tuning, config: Optional[SqpConfig], soft_state_penalty=None) -> SqpEngine:
    config = config or SqpConfig()
    if soft_state_penalty is not None:
        config = dataclasses.replace(config, soft_state_penalty=float(soft_state_penalty))
    if config.shooting not in ("single", "multiple"):
        raise ValueError(f"unknown shooting {config.shooting!r}; available: single|multiple")
    N, nx, nu = tuning.horizon, system.nx, system.nu
    kind = tuning.terminal.kind
    if config.shooting == "multiple":
        if kind == "neighborhood":
            raise ValueError(
                "multiple shooting supports terminal kinds none/equality/contractive "
                "(H-rep rows are not box/ball-representable per state block); use "
                "shooting='single' for neighborhood sets"
            )
        if np.any(np.asarray(tuning.weights.S) != 0.0):
            raise ValueError(
                "multiple shooting requires S=0 (the du coupling breaks the "
                "block-tridiagonal KKT); use shooting='single'"
            )
    if kind in ("equality", "contractive"):
        n_term = nx
    elif kind == "neighborhood":
        n_term = int(tuning.terminal.H.shape[0])
    else:
        n_term = 0
    if config.shooting == "multiple":
        m = (N + 1) * nx + N * nu  # consensus duals on every state node and input
    else:
        m = N * nu + (N * nx if tuning.state_constraint else 0) + n_term
    return SqpEngine(
        config=config,
        state_rows=bool(tuning.state_constraint),
        terminal_kind=kind,
        n_terminal_rows=n_term,
        m_total=m,
        shooting=config.shooting,
        soft_boxes=soft_state_penalty is not None,
    )


def initial_warm_state(engine: SqpEngine, tuning) -> Tuple[Tensor, Tensor]:
    """Warm start: the input reference, duals 0; multiple shooting also
    carries the state iterate, started at the state reference."""
    u0 = tuning.references.u.T.reshape(-1)
    if engine.shooting == "multiple":
        x0 = tuning.references.x.T.reshape(-1)
        return torch.cat([u0, x0]).float(), torch.zeros((engine.m_total,))
    return u0.float().clone(), torch.zeros((engine.m_total,))


def true_objective(tuning, xs: Tensor, us: Tensor) -> Tensor:
    """Reference-parity objective, batched over lanes: stage sum over e_x
    rows 0..N-1 with Q, P on the last state, R on all inputs, S on input
    differences. xs: (B, N+1, nx), us: (B, N, nu) -> (B,)."""
    w = tuning.weights
    P = tuning.terminal.P
    ex = xs - tuning.references.x.T
    eu = us - tuning.references.u.T
    J = torch.einsum("bki,ij,bkj->b", ex[:, :-1], w.Q, ex[:, :-1])
    J = J + torch.einsum("bi,ij,bj->b", ex[:, -1], P, ex[:, -1])
    J = J + torch.einsum("bki,ij,bkj->b", eu, w.R, eu)
    du = us[:, :-1] - us[:, 1:]
    return J + torch.einsum("bki,ij,bkj->b", du, w.S, du)


def _sqrt_f32(v: float, like: Tensor) -> Tensor:
    """sqrt(v) rounded as fp32 arithmetic rounds it (jnp.sqrt(0.9))."""
    return torch.sqrt(torch.tensor(v, dtype=torch.float32, device=like.device))


def _rollout(system, x0: Tensor, us: Tensor) -> Tensor:
    """x0 (B, nx), us (B, N, nu) -> (B, N+1, nx)."""
    xs = [x0]
    for k in range(us.shape[1]):
        xs.append(system.apply_fn(system.params, xs[-1], us[:, k]))
    return torch.stack(xs, 1)


def _trajectory_jacobians(system, xs: Tensor, us: Tensor):
    """(A_k, B_k) at every (lane, step) pair at once: xs (B, N+1, nx), us
    (B, N, nu) -> (B, N, nx, nx), (B, N, nx, nu)."""
    Bt, N, nu = us.shape
    nx = xs.shape[-1]
    f = lambda x, u: system.apply_fn(system.params, x, u)
    jac = torch.func.vmap(torch.func.jacfwd(f, argnums=(0, 1)))
    As, Bs = jac(xs[:, :-1].reshape(Bt * N, nx), us.reshape(Bt * N, nu))
    return As.reshape(Bt, N, nx, nx), Bs.reshape(Bt, N, nx, nu)


def _box_excess(system, xs: Tensor) -> Tensor:
    """relu(lo - x) + relu(x - hi) of the states after x0, (B, N, nx)."""
    return torch.relu(system.X.lo - xs[:, 1:]) + torch.relu(xs[:, 1:] - system.X.hi)


def _violation(engine: SqpEngine, tuning, system, xs: Tensor) -> Tensor:
    """Max hard-constraint violation of a trajectory per lane: the state
    boxes (unless the user declared them soft) and the terminal set; the
    inputs are clipped to their box. Reported as the primal residual and
    gating STATUS_CONVERGED."""
    viol = xs.new_zeros(xs.shape[0])
    if engine.state_rows and not engine.soft_boxes:
        viol = _box_excess(system, xs).flatten(1).amax(1)
    refs = tuning.references.x
    ex_last = xs[:, -1] - refs[:, -1]
    if engine.terminal_kind == "equality":
        viol = torch.maximum(viol, ex_last.abs().amax(1))
    elif engine.terminal_kind == "contractive":
        ex0 = xs[:, 0] - refs[:, 0]
        viol = torch.maximum(
            viol, torch.relu((ex_last**2).sum(1) - 0.9 * (ex0**2).sum(1))
        )
    elif engine.terminal_kind == "neighborhood":
        H, b = tuning.terminal.H, tuning.terminal.b
        viol = torch.maximum(viol, torch.relu(ex_last @ H.T - b).amax(1))
    return viol


def _merit(engine: SqpEngine, tuning, system, xs: Tensor, us: Tensor) -> Tensor:
    """Line-search merit per lane: the true objective plus L1 penalties on
    state-box and terminal-set violation."""
    return _add_penalties(engine, tuning, system, xs, true_objective(tuning, xs, us))


def _add_penalties(engine, tuning, system, xs: Tensor, J: Tensor) -> Tensor:
    """J plus the merit's L1 penalties on state-box and terminal-set
    violation, added in that order (an SQP or economic engine's config)."""
    cfg = engine.config
    if engine.state_rows:
        J = J + cfg.soft_state_penalty * _box_excess(system, xs).flatten(1).sum(1)
    refs = tuning.references.x
    ex_last = xs[:, -1] - refs[:, -1]
    if engine.terminal_kind == "equality":
        J = J + cfg.terminal_penalty * ex_last.abs().sum(1)
    elif engine.terminal_kind == "contractive":
        ex0 = xs[:, 0] - refs[:, 0]
        J = J + cfg.terminal_penalty * torch.relu(
            (ex_last**2).sum(1) - 0.9 * (ex0**2).sum(1)
        )
    elif engine.terminal_kind == "neighborhood":
        H, b = tuning.terminal.H, tuning.terminal.b
        J = J + cfg.terminal_penalty * torch.relu(ex_last @ H.T - b).sum(1)
    return J


def _row_masks(engine: SqpEngine, N: int, nx: int, nu: int, dev):
    """Static equality-row mask and soft-penalty vector of the subproblem rows."""
    cfg = engine.config
    m = engine.m_total
    eq = np.zeros((m,), bool)
    soft = np.full((m,), np.inf)
    off = N * nu
    if engine.state_rows:
        soft[off : off + N * nx] = cfg.soft_state_penalty
        off += N * nx
    if engine.terminal_kind == "equality":
        eq[off : off + nx] = True
    n_ball = nx if engine.terminal_kind == "contractive" else 0
    return eq, torch.from_numpy(soft.astype(np.float32)).to(dev), n_ball


def _where(mask: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """a on the lanes of ``mask`` (B,), b elsewhere."""
    return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


def _line_search(merit_fn, alphas: Tensor, cands, current):
    """The branchless line search: every candidate (one per step length)
    and the current iterate scored by ``merit_fn``, the least merit taken
    per lane (the first on ties, as jnp.argmin). ``cands(alphas)`` returns
    the candidates' tensors with a leading (A, B) pair of axes; ``current``
    the current iterate's tensors (B, ...)."""
    A = alphas.shape[0]
    cand = cands(alphas)
    Bt = current[0].shape[0]
    flat = [c.reshape((A * Bt,) + c.shape[2:]) for c in cand]
    merits = merit_fn(*flat).reshape(A, Bt)
    all_m = torch.cat([merits, merit_fn(*current)[None]], 0)
    best = torch.argmin(all_m, 0)  # (B,)
    lanes = torch.arange(Bt, device=best.device)
    return [torch.cat([c, cur[None]], 0)[best, lanes] for c, cur in zip(cand, current)]


def solve_nonlinear(
    system,
    tuning,
    engine: SqpEngine,
    x0: Tensor,  # (B, nx)
    u_warm: Tensor,  # (B, N nu) raw input trajectory
    y_warm: Tensor,  # (B, m) duals
):
    """Single-shooting SQP over a batch of lanes. Returns (MpcSolution with
    a leading batch axis, u_final (B, N nu), y_final (B, m))."""
    cfg = engine.config
    N = tuning.horizon
    nx, nu = system.nx, system.nu
    n = N * nu
    Bt = x0.shape[0]
    dev, f = x0.device, torch.float32

    w = tuning.weights
    refs = tuning.references
    xref_tail = refs.x.T[1:]  # (N, nx) steps 2..N+1
    uref_stack = refs.u.T.reshape(-1)
    eye_N = torch.eye(N, dtype=f, device=dev)
    Rbar = torch.kron(eye_N, w.R)
    Dop = torch.kron(eye_N[:-1] - eye_N[1:], torch.eye(nu, dtype=f, device=dev))
    Sbar = torch.kron(torch.eye(N - 1, dtype=f, device=dev), w.S)
    DSD = Dop.T @ Sbar @ Dop
    Qbar = torch.block_diag(*([w.Q] * (N - 1) + [tuning.terminal.P]))

    eq_mask, soft_mu, n_ball = _row_masks(engine, N, nx, nu, dev)
    alphas = torch.tensor(cfg.line_search_alphas, dtype=f, device=dev)
    u_lo = system.U.lo.repeat(N)
    u_hi = system.U.hi.repeat(N)
    # box-only subproblem: A is the identity, Ruiz is skipped
    ident = (not engine.state_rows) and engine.terminal_kind == "none"
    eye_n = torch.eye(n, dtype=f, device=dev)

    def build_parts(u_flat, xs):
        """Relinearize and refactorize the Gauss-Newton operators at the
        current iterate (jacfwd, LTV condensing, K^-1 per lane)."""
        As, Bs = _trajectory_jacobians(system, xs, u_flat.reshape(Bt, N, nu))
        _, G, _ = ltv_prediction_matrices(As, Bs)
        G_flat = G.permute(0, 1, 3, 2, 4).reshape(Bt, N * nx, n)
        GtQ = G_flat.transpose(1, 2) @ Qbar
        P_qp = 2.0 * (GtQ @ G_flat + Rbar + DSD) + 2.0 * cfg.damping * eye_n
        rows_A = [eye_n.expand(Bt, n, n)]
        if engine.state_rows:
            rows_A.append(G_flat)
        G_last = G_flat[:, -nx:]
        if engine.terminal_kind in ("equality", "contractive"):
            rows_A.append(G_last)
        elif engine.terminal_kind == "neighborhood":
            rows_A.append(tuning.terminal.H @ G_last)
        op = admm_ops.build_operator_traced(
            P_qp, torch.cat(rows_A, 1), eq_mask, n_ball, cfg.admm, cfg.scaling_iters,
            identity_A=ident,
        )
        return op, GtQ

    def solve_sub(parts, u_flat, xs, y):
        """One SQP iteration on given (possibly frozen) operators: the
        gradient and bounds from the current rollout, the QPs, the line
        search on the true merit."""
        op, GtQ = parts
        us = u_flat.reshape(Bt, N, nu)
        ebar = (xs[:, 1:] - xref_tail).reshape(Bt, -1)
        eu_bar = u_flat - uref_stack
        q = 2.0 * (
            (GtQ @ ebar[..., None])[..., 0] + eu_bar @ Rbar.T + ((u_flat @ Dop.T) @ Sbar.T) @ Dop
        )
        rows_l = [u_lo - u_flat]
        rows_u = [u_hi - u_flat]
        if engine.state_rows:
            xs_tail = xs[:, 1:].reshape(Bt, -1)
            rows_l.append(system.X.lo.repeat(N) - xs_tail)
            rows_u.append(system.X.hi.repeat(N) - xs_tail)
        ball_c = xs.new_zeros((Bt, 0))
        ball_r = xs.new_zeros((Bt,))
        ex_last = ebar[:, -nx:]
        if engine.terminal_kind == "equality":
            rows_l.append(-ex_last)
            rows_u.append(-ex_last)
        elif engine.terminal_kind == "neighborhood":
            H, b = tuning.terminal.H, tuning.terminal.b
            rows_l.append(xs.new_full((Bt, H.shape[0]), -math.inf))
            rows_u.append(b - ex_last @ H.T)
        elif engine.terminal_kind == "contractive":
            rows_l.append(xs.new_full((Bt, nx), -math.inf))
            rows_u.append(xs.new_full((Bt, nx), math.inf))
            ball_c = ex_last
            ball_r = _sqrt_f32(0.9, xs) * torch.linalg.vector_norm(x0 - refs.x[:, 0], dim=1)
        res = admm_ops.solve(
            op, q, torch.cat(rows_l, 1), torch.cat(rows_u, 1), ball_c, ball_r, None, y,
            config=cfg.admm, soft_mu=soft_mu,
        )
        du = res.z.reshape(Bt, N, nu)

        def cands(a):
            uc = torch.clamp(us[None] + a[:, None, None, None] * du[None], system.U.lo, system.U.hi)
            xc = _rollout(system, x0.repeat(a.shape[0], 1), uc.reshape(-1, N, nu))
            return [xc.reshape((a.shape[0], Bt) + xc.shape[1:]), uc]

        merit = lambda xx, uu: _merit(engine, tuning, system, xx, uu)
        xs_new, u_new = _line_search(merit, alphas, cands, [xs, us])
        du_norm = (u_new - us).abs().flatten(1).amax(1)
        return u_new.reshape(Bt, -1), xs_new, res.y, du_norm, res.status

    u_f = u_warm.to(f)
    y_f = y_warm.to(f)
    xs = _rollout(system, x0, u_f.reshape(Bt, N, nu))
    it_f = torch.zeros((Bt,), dtype=torch.int32, device=dev)
    done_f = torch.zeros((Bt,), dtype=torch.bool, device=dev)
    admm_status = torch.full((Bt,), STATUS_MAX_ITER, dtype=torch.int32, device=dev)

    def advance(open_, out):
        """Take one iteration's results on the lanes in ``open_``."""
        nonlocal u_f, xs, y_f, admm_status, it_f
        u2, xs2, y2, _, st = out
        u_f = _where(open_, u2, u_f)
        xs = _where(open_, xs2, xs)
        y_f = _where(open_, y2, y_f)
        admm_status = torch.where(open_, st, admm_status)
        it_f = it_f + open_.to(torch.int32)

    # phase 1: full relinearizations, masked per lane
    k_full = min(int(cfg.full_jacobian_iters), int(cfg.max_sqp_iter))
    parts = None
    for _ in range(k_full):
        parts = build_parts(u_f, xs)
        out = solve_sub(parts, u_f, xs, y_f)
        advance(~done_f, out)
        done_f = done_f | (out[3] < cfg.tol_du)
    # phase 2: while any lane is open, quasi-Newton iterations on the
    # frozen operators (or full ones when freezing is off); a finished
    # lane keeps its carry. One host read per iteration.
    while True:
        open_ = (~done_f) & (it_f < cfg.max_sqp_iter)
        if not bool(open_.any()):
            break
        if k_full == 0:
            parts = build_parts(u_f, xs)
        out = solve_sub(parts, u_f, xs, y_f)
        advance(open_, out)
        done_f = torch.where(open_, out[3] < cfg.tol_du, done_f)

    us = u_f.reshape(Bt, N, nu)
    # the status gate: du small and the measured violation within feas_tol
    viol = _violation(engine, tuning, system, xs)
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
        objective=true_objective(tuning, xs, us),
    )
    return sol, u_f, y_f


def shift_warm(u_flat: Tensor, N: int, nu: int) -> Tensor:
    """Receding-horizon shift of (B, N nu) plans: drop step 0, repeat the last."""
    us = u_flat.reshape(u_flat.shape[0], N, nu)
    return torch.cat([us[:, 1:], us[:, -1:]], 1).reshape(u_flat.shape[0], -1)


def _defects(system, Xb: Tensor, Ub: Tensor) -> Tensor:
    """Multiple-shooting defects c_k = f(x_k, u_k) - x_{k+1}, (B, N, nx)."""
    Bt, N, nu = Ub.shape
    nx = Xb.shape[-1]
    fx = system.apply_fn(system.params, Xb[:, :-1].reshape(Bt * N, nx), Ub.reshape(Bt * N, nu))
    return fx.reshape(Bt, N, nx) - Xb[:, 1:]


def _merit_ms(engine: SqpEngine, tuning, system, Xb: Tensor, Ub: Tensor) -> Tensor:
    """Multiple-shooting merit per lane: the true objective plus L1
    penalties on the defects and on state-box and terminal violation."""
    cfg = engine.config
    J = true_objective(tuning, Xb, Ub)
    J = J + cfg.defect_penalty * _defects(system, Xb, Ub).abs().flatten(1).sum(1)
    if engine.state_rows:
        J = J + cfg.soft_state_penalty * _box_excess(system, Xb).flatten(1).sum(1)
    refs = tuning.references.x
    ex_last = Xb[:, -1] - refs[:, -1]
    if engine.terminal_kind == "equality":
        J = J + cfg.terminal_penalty * ex_last.abs().sum(1)
    elif engine.terminal_kind == "contractive":
        ex0 = Xb[:, 0] - refs[:, 0]
        J = J + cfg.terminal_penalty * torch.relu(
            (ex_last**2).sum(1) - 0.9 * (ex0**2).sum(1)
        )
    return J


def solve_nonlinear_ms(
    system,
    tuning,
    engine: SqpEngine,
    x0: Tensor,  # (B, nx)
    warm_z: Tensor,  # (B, N nu + (N+1) nx) flat (U, X) iterate
    warm_y: Tensor,  # (B, (N+1) nx + N nu) flat (lamX, lamU) consensus duals
):
    """Multiple-shooting SQP over a batch of lanes: each outer iteration
    linearizes the dynamics along the (X, U) iterate (which need not
    satisfy them) and solves the Gauss-Newton subproblem on the LTV
    Riccati KKT. Returns (MpcSolution, z_final (B, .), y_final (B, .))."""
    from ..ops import riccati_ltv

    cfg = engine.config
    N = tuning.horizon
    nx, nu = system.nx, system.nu
    Bt = x0.shape[0]
    dev, f = x0.device, torch.float32
    w = tuning.weights
    refs = tuning.references
    P_term = tuning.terminal.P
    x0 = x0.to(f)

    if cfg.ms_rho is None:
        rho = torch.clamp_min(2.0 * torch.diag(w.R).mean(), 1e-6)
        # the state rows' rho matched to the state cost's curvature (2Q,
        # 2P): the dual of a binding state row climbs by rho_x (w - v) per
        # inner iteration toward its shadow price
        rho_x = torch.maximum(
            torch.maximum(2.0 * torch.diag(w.Q).mean(), 2.0 * torch.diag(P_term).mean()), rho
        )
    else:
        rho = rho_x = torch.tensor(cfg.ms_rho, dtype=f, device=dev)
    split_interior = engine.state_rows
    kind = engine.terminal_kind
    split_terminal = split_interior or kind in ("equality", "contractive")

    eye_x = torch.eye(nx, dtype=f, device=dev)
    eye_u = torch.eye(nu, dtype=f, device=dev)
    Qb = 2.0 * w.Q + cfg.damping * eye_x
    if split_interior:
        Qb = Qb + rho_x * eye_x
    QbT = 2.0 * P_term + cfg.damping * eye_x
    if split_terminal:
        QbT = QbT + rho_x * eye_x
    Rb = 2.0 * w.R + cfg.damping * eye_u + rho * eye_u

    Ub = warm_z[:, : N * nu].reshape(Bt, N, nu).to(f)
    Xb = warm_z[:, N * nu :].reshape(Bt, N + 1, nx).to(f).clone()
    Xb[:, 0] = x0
    lamX = warm_y[:, : (N + 1) * nx].reshape(Bt, N + 1, nx).to(f)
    lamU = warm_y[:, (N + 1) * nx :].reshape(Bt, N, nu).to(f)

    ball_r = _sqrt_f32(0.9, x0) * torch.linalg.vector_norm(x0 - refs.x[:, 0], dim=1)
    alphas = torch.tensor(cfg.line_search_alphas, dtype=f, device=dev)
    soft_mu = float(cfg.soft_state_penalty) if engine.soft_boxes else None
    merit = lambda XX, UU: _merit_ms(engine, tuning, system, XX, UU)

    def sqp_step(Xb, Ub, lamX, lamU):
        As, Bs = _trajectory_jacobians(system, Xb, Ub)
        cs = _defects(system, Xb, Ub)
        ex = Xb - refs.x.T
        eu = Ub - refs.u.T
        factors = riccati_ltv.ltv_factorize(As, Bs, cs, Qb, Rb, QbT)
        lq_nodes = torch.cat(
            [Xb.new_zeros((Bt, 1, nx)), 2.0 * (ex[:, 1:-1] @ w.Q), (2.0 * (ex[:, -1] @ P_term.T))[:, None]],
            1,
        )
        lu0 = 2.0 * (eu @ w.R)
        u_lo = system.U.lo - Ub
        u_hi = system.U.hi - Ub
        x_lo = x_hi = None
        if split_interior:
            x_lo = system.X.lo - Xb[:, 1:-1]
            x_hi = system.X.hi - Xb[:, 1:-1]
        xN_lo = xN_hi = ball_c = None
        if kind == "equality":
            xN_lo = xN_hi = -ex[:, -1]
        elif kind == "contractive":
            ball_c = ex[:, -1]
        elif split_terminal:
            xN_lo = system.X.lo - Xb[:, -1]
            xN_hi = system.X.hi - Xb[:, -1]
        dX, dU, lamXn, lamUn, _ = riccati_ltv.solve_ms_qp(
            factors, lq_nodes, lu0, u_lo, u_hi, x_lo, x_hi, xN_lo, xN_hi, ball_c, ball_r,
            lamX, lamU, rho, int(cfg.ms_admm_iters), soft_mu=soft_mu,
            terminal_is_box=(kind not in ("equality", "contractive")), rho_x=rho_x,
        )

        def cands(a):
            a4 = a[:, None, None, None]
            Xc = Xb[None] + a4 * dX[None]
            Uc = torch.clamp(Ub[None] + a4 * dU[None], system.U.lo, system.U.hi)
            return [Xc, Uc]

        X_new, U_new = _line_search(merit, alphas, cands, [Xb, Ub])
        du_norm = torch.maximum(
            (X_new - Xb).abs().flatten(1).amax(1), (U_new - Ub).abs().flatten(1).amax(1)
        )
        return X_new, U_new, lamXn, lamUn, du_norm

    def measured_violation(X, U):
        viol = _defects(system, X, U).abs().flatten(1).amax(1)
        return torch.maximum(viol, _violation(engine, tuning, system, X))

    it_f = torch.zeros((Bt,), dtype=torch.int32, device=dev)
    done_f = torch.zeros((Bt,), dtype=torch.bool, device=dev)
    # a small step alone is not convergence (a zero step on a merit plateau
    # while the consensus duals still climb): done needs feasibility too
    while True:
        open_ = (~done_f) & (it_f < cfg.max_sqp_iter)
        if not bool(open_.any()):
            break
        Xn, Un, lamXn, lamUn, du_norm = sqp_step(Xb, Ub, lamX, lamU)
        done_n = (du_norm < cfg.tol_du) & (measured_violation(Xn, Un) <= cfg.feas_tol)
        Xb = _where(open_, Xn, Xb)
        Ub = _where(open_, Un, Ub)
        lamX = _where(open_, lamXn, lamX)
        lamU = _where(open_, lamUn, lamU)
        it_f = it_f + open_.to(torch.int32)
        done_f = torch.where(open_, done_n, done_f)

    viol = measured_violation(Xb, Ub)
    status = torch.where(done_f & (viol <= cfg.feas_tol), STATUS_CONVERGED, STATUS_MAX_ITER)
    sol = MpcSolution(
        x=Xb.transpose(1, 2),
        e_x=(Xb - refs.x.T).transpose(1, 2),
        u=Ub.transpose(1, 2),
        e_u=(Ub - refs.u.T).transpose(1, 2),
        status=status.to(torch.int32),
        iterations=it_f,
        primal_residual=viol,
        dual_residual=Xb.new_zeros((Bt,)),
        objective=true_objective(tuning, Xb, Ub),
    )
    z_f = torch.cat([Ub.reshape(Bt, -1), Xb.reshape(Bt, -1)], 1)
    y_f = torch.cat([lamX.reshape(Bt, -1), lamU.reshape(Bt, -1)], 1)
    return sol, z_f, y_f


def shift_warm_ms(z_flat: Tensor, y_flat: Tensor, N: int, nx: int, nu: int):
    """Receding-horizon shift of the multiple-shooting carry (B, .): the
    inputs, the state iterate and the consensus duals each drop step 0 and
    repeat the last."""
    Bt = z_flat.shape[0]
    shift = lambda t: torch.cat([t[:, 1:], t[:, -1:]], 1).reshape(Bt, -1)
    U = z_flat[:, : N * nu].reshape(Bt, N, nu)
    X = z_flat[:, N * nu :].reshape(Bt, N + 1, nx)
    lamX = y_flat[:, : (N + 1) * nx].reshape(Bt, N + 1, nx)
    lamU = y_flat[:, (N + 1) * nx :].reshape(Bt, N, nu)
    return torch.cat([shift(U), shift(X)], 1), torch.cat([shift(lamX), shift(lamU)], 1)
