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
and doubling levels agree with it bit for bit. The two sweeps of a
w-update come in two forms: sequential (a recurrence over the horizon) and
parallel in time (``RiccatiConfig.parallel_sweeps``): the recurrences'
matrices are design-time constants, so :func:`_scan_levels` precomputes
Hillis-Steele doubling levels per rho and each sweep runs as ceil(log2 N)
combine levels (:func:`affine_prefix`, :func:`lqr_affine_solve_pscan`).
The solves run in ``ops/riccati_fused.py``: the fused driver, with one rho
for the whole batch, and the per-lane engine ``solve_sparse``, whose every
lane adapts its own rho, each on the Riccati kernel that takes the plant
and the sweeps (``riccati_fused.riccati_chunk_fn``).

The helpers below work on the lane-last layout of the drivers: states
(N+1, nx, B), inputs (N, nu, B).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    lane's stall. ``parallel_sweeps`` makes the per-lane engine run each
    w-update's sweeps in doubling form (:func:`lqr_affine_solve_pscan`:
    ceil(log2 N) combine levels over the horizon) where the sequential
    form runs N dependent steps; the fused driver does not read it, as the
    JAX package's fused kernel does not."""

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
    # the doubling levels and full prefix products of the backward
    # (reversed (A - B K)' sequence) and forward (A - B K in order)
    # recurrences, per grid entry (:func:`_scan_levels`; L = max(1,
    # ceil(log2 N)))
    bwd_levels: Tensor  # (R, L, N, nx, nx)
    bwd_full: Tensor  # (R, N, nx, nx)
    fwd_levels: Tensor  # (R, L, N, nx, nx)
    fwd_full: Tensor  # (R, N, nx, nx)
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


def _scan_levels(Ms: np.ndarray):
    """Hillis-Steele doubling levels of the affine prefix recurrence y_i =
    M_i y_{i-1} + b_i (host, f64; the JAX package's code line for line).

    Returns (levels (L, N, nx, nx), full (N, nx, nx)): level l, of stride s
    = 2^l, updates b[s:] += levels[l][s:] @ b[:-s]; after every level y_i =
    b_i + full_i @ y_init (full_i = M_i ... M_0)."""
    N = Ms.shape[0]
    C = Ms.copy()
    levels = []
    s = 1
    while s < N:
        levels.append(C.copy())
        Cn = C.copy()
        Cn[s:] = np.einsum("nij,njk->nik", C[s:], C[:-s])
        C = Cn
        s *= 2
    if not levels:  # N == 1: no combine levels needed
        levels = [np.zeros_like(Ms)]
    return np.stack(levels), C


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
    bwd_lv, bwd_fu, fwd_lv, fwd_fu = [], [], [], []
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
        # the backward g-recursion runs the reversed (A - B K)' sequence,
        # the forward rollout A - B K in order
        lv, fu = _scan_levels(np.transpose(AmBK, (0, 2, 1))[::-1].copy())
        bwd_lv.append(lv)
        bwd_fu.append(fu)
        lv, fu = _scan_levels(AmBK.copy())
        fwd_lv.append(lv)
        fwd_fu.append(fu)

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
        bwd_levels=f32(np.stack(bwd_lv)),
        bwd_full=f32(np.stack(bwd_fu)),
        fwd_levels=f32(np.stack(fwd_lv)),
        fwd_full=f32(np.stack(fwd_fu)),
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


def bdot64(M: Tensor, v: Tensor) -> Tensor:
    """M_k v_k for a stack of small matrices M (N, a, n) and lane-last
    vectors v (N, n, B) (or (1, n, B), shared by every k): each row summed
    as :func:`dot64` sums it, in column order j = 0..n-1."""
    M64 = M.double()
    v64 = v.double()
    acc = M64[:, :, :1] * v64[:, :1]
    for j in range(1, M64.shape[2]):
        acc = torch.addcmul(acc, M64[:, :, j : j + 1], v64[:, j : j + 1])
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


def affine_prefix(levels: Tensor, full: Tensor, b: Tensor, y_init: Tensor) -> Tensor:
    """y_i = M_i y_{i-1} + b_i (y_{-1} = y_init) for every i at once, lane-
    last, from the doubling levels of M (the JAX package's
    ``_affine_prefix``): level l, of stride s = 2^l, adds levels[l][i] @
    b[i - s] to every b[i] with i >= s, then y = b + full @ y_init. levels
    (L, N, nx, nx), full (N, nx, nx), b (N, nx, B), y_init (nx, B). Each
    product is summed as :func:`dot64` sums it, which is the order the
    doubling kernel (``csrc/riccati_wide.cu``) follows."""
    N = b.shape[0]
    s, lvl = 1, 0
    while s < N:
        contrib = bdot64(levels[lvl, s:], b[:-s])
        b = torch.cat([b[:s], b[s:] + contrib])
        s *= 2
        lvl += 1
    return b + bdot64(full, y_init[None])


def lqr_affine_solve_pscan(
    op: RiccatiOperator,
    ridx,
    e0T: Tensor,  # (nx, B)
    lin_int: Tensor,  # (N-1, nx, B): linear terms on the interior states e_2..e_N
    lin_xN: Tensor,  # (nx, B): on the terminal state
    lin_u: Tensor,  # (N, nu, B)
) -> Tuple[Tensor, Tensor]:
    """The w-update's affine LQR solve with the sweeps in doubling form
    (the JAX package's ``_lqr_affine_solve_pscan``, lane-last), at grid
    entry ``ridx`` (an int or a (1,) tensor): the backward recursion g_k =
    (A - B K_k)' g_{k+1} + (lpre_k - K_k' lu_k) from g_N = lin_xN as a
    prefix over the reversed horizon, ff_k = G_k (B' g_{k+1} + lu_k), and
    the forward rollout e_{k+1} = (A - B K_k) e_k - B ff_k as a prefix.
    Returns (X (N+1, nx, B) with e0 in row 0, U (N, nu, B)). Only the
    lane's own rho is computed; JAX selects it by a masked sum over every
    grid entry, so an inf in another entry's solve makes JAX's lane NaN
    and not the port's."""
    i = torch.as_tensor(ridx).long().reshape(1).to(op.factors.K.device)
    f = op.factors
    K, G = f.K[i][0], f.G[i][0]
    N = op.N
    lpre = torch.cat([torch.zeros_like(e0T)[None], lin_int])  # (N, nx, B)
    bb = lpre - bdot64(K.transpose(1, 2), lin_u)
    g = affine_prefix(op.bwd_levels[i][0], op.bwd_full[i][0], bb.flip(0), lin_xN).flip(0)
    gnext = torch.cat([g[1:], lin_xN[None]])  # g_{k+1}
    ff = bdot64(G, bdot64(f.B.T[None], gnext) + lin_u)
    bf = -bdot64(f.B[None], ff)
    e_next = affine_prefix(op.fwd_levels[i][0], op.fwd_full[i][0], bf, e0T)
    X = torch.cat([e0T[None], e_next])
    U = -bdot64(K, X[:N]) - ff
    return X, U


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


def infeas_certificate(op: RiccatiOperator, dlamX: Tensor, dlamU: Tensor, Xbar: Tensor,
                       ball_r, eps: float) -> Tensor:
    """The primal-infeasibility certificate of the consensus splitting (the
    JAX package's ``infeas_certificate``; Banjac et al. 2019): True where
    the dual deltas dlamX (N+1, nx), dlamU (N, nu) separate the dynamics'
    affine set, through the zero-input rollout Xbar (N+1, nx), from the
    boxes and the terminal ball of radius ``ball_r``, with a leading lane
    axis allowed on each (and on ``ball_r``). The terms are
    ``riccati_fused``'s certificate terms (the certificate kernel's plain
    version): the adjoint's orthogonality residual, the support value and
    max |dlam|; a lane is certified where max |dlam| > 1e-9, the residual is
    at most eps max |dlam| and the support at most -eps max |dlam|."""
    from .riccati_fused import _certificate_plain

    lanes = dlamX.dim() == 3
    if not lanes:
        dlamX, dlamU, Xbar = dlamX[None], dlamU[None], Xbar[None]
    last = lambda t: t.permute(1, 2, 0).contiguous()  # (lanes, rows, n) -> lane-last
    ball_r = torch.as_tensor(ball_r, dtype=torch.float32, device=dlamX.device).reshape(-1)
    ball_r = ball_r.expand(dlamX.shape[0]).contiguous()
    dX, dU = last(dlamX), last(dlamU)
    ortho, support, dnorm = _certificate_plain(
        op, dX, torch.zeros_like(dX), dU, torch.zeros_like(dU), last(Xbar), ball_r)
    cert = (dnorm > 1e-9) & (ortho <= eps * dnorm) & (support <= -eps * dnorm)
    return cert if lanes else cert[0]


def __getattr__(name: str):
    # ``solve_sparse`` is the per-lane Riccati engine,
    # ``riccati_fused.solve_sparse`` (the JAX package's ``solve_sparse`` for
    # every lane of a batch); riccati_fused imports this module, so it is
    # looked up on first use
    if name == "solve_sparse":
        from .riccati_fused import solve_sparse

        return solve_sparse
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
