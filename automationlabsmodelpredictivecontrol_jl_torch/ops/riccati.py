"""Riccati-sweep sparse MPC engine: the design half and the driver's helpers.

The condensed engine (``ops/condense.py``) eliminates the states: O(N^2)
memory and O((N nu)^2) work per iteration. This engine keeps the sparse
(X, U) variables and solves the block-tridiagonal KKT system of each ADMM
w-update with an affine LQR: its factorization (Riccati matrices and
feedback gains) depends only on (A, B, the weights, rho), so it is computed
once at design time for every rho of a grid, and each iteration reruns only
the affine backward sweep and the forward rollout, O(N) per lane.

ADMM splitting
    min 0.5 w' H w + q' w + I_dyn(w) + I_box(v),   w = v
with w = (e_x_1..N+1, e_u_1..N), H = blkdiag(Q.., P_term, R..).

Terminal kinds: "none"; "equality" (the terminal state joins the splitting
with a [0, 0] box, its consensus boosted by ``rho_eq_scale``);
"contractive" (the terminal state joins the splitting with a Euclidean-ball
projection of radius sqrt(0.9) ||e_1||). "neighborhood" rows are not
box- or ball-representable per state block: the condensed engine takes
them.

The design is the JAX package's numpy f64 code, so the stored f32 factors
agree with it bit for bit. Two solves run on the kernel K3, both in
``ops/riccati_fused.py``: the fused driver, with one rho for the whole
batch, and the per-lane engine ``solve_sparse``, whose every lane adapts
its own rho. Not ported yet (ROADMAP Queue 1): the
parallel-in-time sweeps (``parallel_sweeps``: ``_scan_levels``,
``_lqr_affine_solve_pscan``) and a per-lane engine for plants wider than
K3 takes.

The helpers below work on the lane-last layout of the drivers: states
(N+1, nx, B), inputs (N, nu, B).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..types import CONTRACTIVE_FACTOR, TensorRecord, f32

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RiccatiConfig:
    """Knobs of the sparse Riccati-ADMM engine (the JAX package's
    ``RiccatiConfig``, same defaults).

    ``rho=None`` / ``rho_grid=None`` mean auto: resolved at design time
    against the input weight R (:func:`resolve_config`). The fused driver
    adapts one batch-global rho over the prefactorized grid every
    ``adapt_interval`` iterations; ``stall_checks`` stalled check blocks
    walk it one grid entry up. The equality terminal's consensus runs at
    ``rho_eq_scale * rho`` (capped at 1e3). ``eps_infeas`` is the
    tolerance of the primal-infeasibility certificate. The per-lane engine
    (``riccati_fused.solve_sparse``) adapts each lane's rho and escalates each
    lane's stall. ``parallel_sweeps`` selects the per-lane engine's
    doubling sweeps, which are not ported (neither engine here reads
    it)."""

    max_iter: int = 2000
    rho: Optional[float] = None
    rho_grid: Optional[tuple] = None
    adapt_interval: int = 50
    check_interval: int = 25
    sigma: float = 1e-6
    eps_abs: float = 1e-5
    eps_rel: float = 1e-5
    rho_eq_scale: float = 1e2
    eps_infeas: float = 1e-5
    stall_checks: int = 8
    parallel_sweeps: bool = False


@dataclasses.dataclass(frozen=True)
class RiccatiFactors(TensorRecord):
    """Design-time affine-LQR factorization, stacked over the rho grid.

    Backward Riccati on cost blocks Qb = Q + reg (the terminal block
    P_term + reg_term) and Rb = R + (sigma + rho) I:

        S_{N+1} = Qb_term
        G_k  = (Rb + B' S_{k+1} B)^{-1}
        K_k  = G_k B' S_{k+1} A
        S_k  = Qb + A' S_{k+1} (A - B K_k)
    """

    K: Tensor  # (R, N, nu, nx)
    G: Tensor  # (R, N, nu, nu)
    AmBK: Tensor  # (R, N, nx, nx) = A - B K_k
    A: Tensor  # (nx, nx)
    B: Tensor  # (nx, nu)


@dataclasses.dataclass(frozen=True)
class RiccatiOperator(TensorRecord):
    """Sparse-MPC ADMM operator: the factorizations of every rho of the
    grid, and the deviation-space boxes.

    ``x_lo/x_hi`` bound the interior states e_2..e_N (split only when
    ``split_interior``); ``xN_lo/xN_hi`` the terminal state (split when
    ``split_terminal``; [0, 0] for the equality kind). ``rho_tab`` (4, R)
    holds, per grid entry, the float32 rho, 1/rho, terminal rho and
    1/terminal rho that the kernel reads by the device-resident grid
    index (:func:`rho_table`)."""

    factors: RiccatiFactors
    rho_grid: tuple  # (R,) sorted rho values, Python floats
    rho0: float  # the resolve_config rho
    rho_tab: Tensor  # (4, R)
    Q: Tensor  # (nx, nx) stage state cost
    P_term: Tensor  # (nx, nx)
    R_in: Tensor  # (nu, nu)
    x_lo: Tensor  # (nx,) interior deviation box (may be +-inf)
    x_hi: Tensor
    xN_lo: Tensor  # (nx,) terminal deviation box
    xN_hi: Tensor
    u_lo: Tensor  # (nu,)
    u_hi: Tensor
    N: int
    nx: int
    nu: int
    split_interior: bool
    split_terminal: bool
    terminal_ball: bool  # contractive: ball-project e_{N+1}
    # equality kind: the terminal consensus runs at term_rho_scale * rho
    # (config.rho_eq_scale; 1.0 for every other kind)
    term_rho_scale: float = 1.0


def _factorize_one(A, B, Qb, Rb, Qb_term, N):
    """Backward Riccati factorization (host, f64)."""
    S = Qb_term
    Ks, Gs, AmBKs = [], [], []
    for _ in range(N):
        BtS = B.T @ S
        G = np.linalg.inv(Rb + BtS @ B)
        K = G @ (BtS @ A)
        AmBK = A - B @ K
        S = Qb + A.T @ S @ AmBK
        S = 0.5 * (S + S.T)
        Ks.append(K)
        Gs.append(G)
        AmBKs.append(AmBK)
    # reverse to time order k=0..N-1 (built from the tail)
    return np.stack(Ks[::-1]), np.stack(Gs[::-1]), np.stack(AmBKs[::-1])


def resolve_config(config: RiccatiConfig, R) -> RiccatiConfig:
    """Fill in auto (None) rho / rho_grid from the input-weight scale:
    rho0 = mean(diag R), the grid a decade below and two above it (binding
    contractive and equality terminal rows need rho well above R-bar)."""
    rho = config.rho
    grid = config.rho_grid
    if rho is None:
        rho = float(np.mean(np.diag(np.asarray(R, np.float64))))
        rho = max(rho, 1e-6)
    if grid is None:
        grid = (0.1 * rho, rho, 10.0 * rho, 100.0 * rho)
    return dataclasses.replace(config, rho=float(rho), rho_grid=tuple(grid))


def _initial_ridx(op: RiccatiOperator, config: RiccatiConfig) -> int:
    """Grid index of the starting rho. Auto (rho=None) starts at the
    operator's own resolved rho0, so the engine can keep the user's
    unresolved config."""
    rho = op.rho0 if config.rho is None else float(config.rho)
    return int(np.argmin(np.abs(np.log(op.rho_grid) - np.log(rho))))


def rho_table(rho_grid, term_rho_scale: float) -> Tensor:
    """(4, R) float32: rho, 1/rho, rho_t = min(term_rho_scale rho, 1e3) and
    1/rho_t per grid entry, each computed in f64 from the grid's Python
    floats and rounded once, as the JAX kernel rounds its constants."""
    rows = []
    for rho in rho_grid:
        rho_t = min(float(term_rho_scale) * float(rho), 1e3)
        rows.append((float(rho), 1.0 / float(rho), rho_t, 1.0 / rho_t))
    return f32(np.ascontiguousarray(np.asarray(rows).T))


def build_riccati_operator(
    A,
    B,
    Q,
    R,
    P_term,
    N: int,
    x_lo,
    x_hi,
    u_lo,
    u_hi,
    state_constraint: bool,
    terminal_kind: str = "none",
    config: RiccatiConfig = RiccatiConfig(),
) -> RiccatiOperator:
    """Design-time factorization for every rho-grid entry (host, f64),
    stored f32 on the CPU. Boxes are deviation-space."""
    if terminal_kind not in ("none", "equality", "contractive"):
        raise ValueError(
            f"riccati engine does not support terminal kind {terminal_kind!r}"
        )
    config = resolve_config(config, R)
    A64 = np.asarray(A, np.float64)
    B64 = np.asarray(B, np.float64)
    Q64 = np.asarray(Q, np.float64)
    R64 = np.asarray(R, np.float64)
    P64 = np.asarray(P_term, np.float64)
    nx, nu = B64.shape

    split_interior = bool(state_constraint)
    split_terminal = bool(state_constraint) or terminal_kind in ("equality", "contractive")
    terminal_ball = terminal_kind == "contractive"
    # the [0, 0] projection is exact under any rho; boosting the terminal
    # consensus speeds up its dual
    term_scale = float(config.rho_eq_scale) if terminal_kind == "equality" else 1.0

    x_lo64 = np.asarray(x_lo, np.float64)
    x_hi64 = np.asarray(x_hi, np.float64)
    if terminal_kind == "equality":
        xN_lo = np.zeros(nx)
        xN_hi = np.zeros(nx)
    elif state_constraint:
        xN_lo, xN_hi = x_lo64, x_hi64
    else:
        xN_lo = np.full(nx, -np.inf)
        xN_hi = np.full(nx, np.inf)

    grid = sorted(set(float(r) for r in config.rho_grid) | {float(config.rho)})
    Ks, Gs, AmBKs = [], [], []
    for rho in grid:
        reg_u = (config.sigma + rho) * np.eye(nu)
        # rho joins a state block's cost only where that block is split
        rho_int = (config.sigma + rho) * np.eye(nx) if split_interior else config.sigma * np.eye(nx)
        rho_t = min(term_scale * rho, 1e3)
        rho_term = (
            (config.sigma + rho_t) * np.eye(nx) if split_terminal else config.sigma * np.eye(nx)
        )
        K, G, AmBK = _factorize_one(A64, B64, Q64 + rho_int, R64 + reg_u, P64 + rho_term, N)
        Ks.append(K)
        Gs.append(G)
        AmBKs.append(AmBK)

    return RiccatiOperator(
        factors=RiccatiFactors(
            K=f32(np.stack(Ks)),
            G=f32(np.stack(Gs)),
            AmBK=f32(np.stack(AmBKs)),
            A=f32(A64),
            B=f32(B64),
        ),
        rho_grid=tuple(grid),
        rho0=float(config.rho),
        rho_tab=rho_table(grid, term_scale),
        Q=f32(Q64),
        P_term=f32(P64),
        R_in=f32(R64),
        x_lo=f32(x_lo64),
        x_hi=f32(x_hi64),
        xN_lo=f32(xN_lo),
        xN_hi=f32(xN_hi),
        u_lo=f32(u_lo),
        u_hi=f32(u_hi),
        N=int(N),
        nx=int(nx),
        nu=int(nu),
        split_interior=split_interior,
        split_terminal=split_terminal,
        terminal_ball=terminal_ball,
        term_rho_scale=term_scale,
    )


def dot64(M: Tensor, v: Tensor) -> Tensor:
    """M v for a small M (a, n) and lane-last v (n, B), as the kernels form
    it: exact fp32 products summed in fp64 in column order j = 0..n-1, and
    rounded once to fp32. The fixed order makes the plain versions agree
    with the kernels bit for bit."""
    M64 = M.double()
    v64 = v.double()
    acc = M64[:, :1] * v64[:1]
    for j in range(1, M64.shape[1]):
        acc = torch.addcmul(acc, M64[:, j : j + 1], v64[j : j + 1])
    return acc.float()


def norm64(w: Tensor) -> Tensor:
    """Euclidean norm of each lane of w (n, B): squares summed in fp64 in
    row order, rounded once, then an fp32 square root."""
    w64 = w.double()
    acc = w64[0] * w64[0]
    for i in range(1, w64.shape[0]):
        acc = torch.addcmul(acc, w64[i], w64[i])
    return torch.sqrt(acc.float())


def ball_radius(op: RiccatiOperator, e0T: Tensor) -> Tensor:
    """(B,) radius of the contractive terminal ball, sqrt(0.9) ||e_1||
    (zeros for the other kinds)."""
    if not op.terminal_ball:
        return torch.zeros(e0T.shape[1], dtype=torch.float32, device=e0T.device)
    factor = torch.sqrt(torch.tensor(CONTRACTIVE_FACTOR, dtype=torch.float32))
    return factor.to(e0T.device) * norm64(e0T)


def rollout_warm(op: RiccatiOperator, e0T: Tensor, U: Tensor) -> Tensor:
    """Forward rollout of an input plan, lane-last: X[0] = e0, X[k+1] =
    A X[k] + B U[k], each product summed as :func:`dot64` does. e0T (nx,
    B), U (N, nu, B) -> X (N+1, nx, B). The plain version of the rollout
    kernel (``ops/riccati_fused.rollout``)."""
    A, Bm = op.factors.A, op.factors.B
    X = torch.empty((op.N + 1,) + tuple(e0T.shape), dtype=torch.float32, device=e0T.device)
    X[0] = e0T
    e = e0T
    for k in range(op.N):
        e = dot64(A, e) + dot64(Bm, U[k])
        X[k + 1] = e
    return X


def project_X(op: RiccatiOperator, V: Tensor, ball_r: Tensor) -> Tensor:
    """Project the state copy V (N+1, nx, B) onto its per-block sets: the
    interior box (rows 1..N-1), then the terminal box or ball (row N). Row
    0 (the fixed e_1) is never projected."""
    out = V.clone()
    if op.split_interior:
        out[1:-1] = torch.clamp(V[1:-1], op.x_lo[:, None], op.x_hi[:, None])
    if op.terminal_ball:
        w = V[-1]
        nrm = norm64(w)
        scale = torch.where(nrm > ball_r, ball_r / torch.clamp_min(nrm, 1e-30), 1.0)
        out[-1] = w * scale
    elif op.split_terminal:
        out[-1] = torch.clamp(V[-1], op.xN_lo[:, None], op.xN_hi[:, None])
    return out


def box_support(d: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """Support function of a box at directions d (rows, n, B), per lane:
    +inf rays count only where d points along them (d == 0 rows give 0).
    The fp32 terms are summed in fp64 and rounded once."""
    lo, hi = lo[:, None], hi[:, None]
    inf = torch.tensor(float("inf"), dtype=d.dtype, device=d.device)
    pos = torch.where(d > 0, torch.where(torch.isfinite(hi), hi * d, inf), 0.0)
    neg = torch.where(d < 0, torch.where(torch.isfinite(lo), lo * d, inf), 0.0)
    return (pos + neg).double().sum(dim=(0, 1)).float()

