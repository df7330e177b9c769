"""OSQP-style ADMM operator: configuration, equilibration, factorization.

Solves  min 0.5 z'Pz + q'z  s.t.  l <= A z <= u  (box rows), with an
optional trailing Euclidean-ball block. The KKT matrix
K_r = P_s + sigma I + A_s' diag(rho_r) A_s is inverted once, at design
time, for every rho of a log-spaced grid; the iteration then selects a
grid entry per lane instead of refactorizing.

Scaling conventions (OSQP section 5): P_s = c D P D, q_s = c D q,
A_s = E A D, l_s = E l, u_s = E u; unscale with z = D z_s, y = E y_s / c.

The host part is the JAX package's numpy f64 code, so the stored f32
operator agrees with it bit for bit. :func:`solve` is the general engine:
plain fp32 PyTorch over a batch of lanes, for every QP the designer makes
(box, soft and ball rows, any rho grid), with infeasibility certificates.
The fused kernels (``ops/admm_fused.py``) take the shapes they fit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..types import (
    STATUS_CONVERGED,
    STATUS_DUAL_INFEASIBLE,
    STATUS_MAX_ITER,
    STATUS_NUMERIC_ERROR,
    STATUS_PRIMAL_INFEASIBLE,
    TensorRecord,
    f32,
)
from ..utils.precision import assert_ieee_fp32

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdmmConfig:
    """Solver knobs (the JAX package's ``AdmmConfig``, same defaults)."""

    max_iter: int = 500
    sigma: float = 1e-6
    alpha: float = 1.6
    rho: float = 0.1
    # equality rows get rho_eq_scale * rho (a 1e3 scale amplifies f32
    # roundoff past the residual tolerance; 1e2 converges)
    rho_eq_scale: float = 1e2
    rho_grid: tuple = (0.01, 0.1, 1.0, 10.0, 100.0)
    adapt_interval: int = 25  # 0 disables rho adaptation
    check_interval: int = 25  # iterations between convergence checks
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    eps_infeas: float = 1e-5
    refine_steps: int = 1
    scaling_iters: int = 10
    adaptive: bool = True
    # the products inside the fused kernels K1, K2, K4, K5 (the general
    # engine reads none): "highest" (fp32 operands, fp64 sums), "bf16x3"
    # (three bf16 passes on a hi/lo split of both operands), "default" (one
    # bf16 pass), "hybrid" (bf16x3 chunks until the worst open lane's
    # residual is at most hybrid_switch_residual, then highest); the
    # between-chunk diagnostics are exact fp32 in every precision
    kernel_precision: str = "highest"
    hybrid_switch_residual: float = 2e-3


@dataclasses.dataclass(frozen=True)
class AdmmOperator(TensorRecord):
    """Design-time operator for one QP structure; rho-dependent pieces are
    stacked over the rho grid (leading axis R)."""

    P_s: Tensor  # (n, n) scaled
    A_s: Tensor  # (m, n) scaled
    Ks: Tensor  # (R, n, n) = P_s + sigma I + A_s' diag(rho_r) A_s
    K_invs: Tensor  # (R, n, n)
    rho_vecs: Tensor  # (R, m)
    rho_invs: Tensor  # (R, m)
    rho_grid: Tensor  # (R,)
    D: Tensor  # (n,)
    E: Tensor  # (m,)
    c: Tensor  # ()
    n_ball: int = 0
    # A_s is square and diagonal (box-only QP): the fused diag kernel
    diag_a: bool = False
    # first n rows diagonal, the rest dense (state / terminal rows)
    mixed_a: bool = False
    # (R, n, m) K_r^-1 A_s' of a dense operator (neither diagonal nor mixed,
    # no ball rows), for the packed dense kernel K4; None otherwise
    kia: Optional[Tensor] = None

    @property
    def dense_a(self) -> bool:
        """Neither diagonal nor mixed, and no ball rows: the dense kernels'
        operator (K4/K5, ``ops/admm_fused.py``)."""
        return self.n_ball == 0 and not self.diag_a and not self.mixed_a


@dataclasses.dataclass(frozen=True)
class AdmmResult(TensorRecord):
    """A batch of solves, each field with a leading batch axis B."""

    z: Tensor  # (B, n) primal solution (unscaled)
    y: Tensor  # (B, m) dual solution (unscaled)
    s: Tensor  # (B, m) constraint-space solution (unscaled)
    status: Tensor  # (B,) int32
    iterations: Tensor  # (B,) int32
    primal_residual: Tensor  # (B,)
    dual_residual: Tensor  # (B,)


def packed_kia(K_invs: Tensor, A_s: Tensor) -> Tensor:
    """K_r^-1 A_s' for every rho of the grid, (R, n, m): fp64 sums of the
    stored fp32 entries, rounded once to fp32. Built once per operator
    (the JAX package forms it at fp32 HIGHEST on every chunk)."""
    return (K_invs.double() @ A_s.double().T).float()


def _ruiz_equilibrate(P: np.ndarray, A: np.ndarray, n_ball: int, iters: int):
    """Modified Ruiz equilibration (OSQP section 5): diagonals D, E and cost
    scale c bringing the scaled KKT matrix to near-unit row/col inf-norms.
    Ball rows get one uniform scale so balls stay balls. Host, float64."""
    n = P.shape[0]
    m = A.shape[0]
    D = np.ones(n)
    E = np.ones(m)
    c = 1.0
    Pc = P.copy()
    Ac = A.copy()
    for _ in range(iters):
        col_norm = np.maximum(np.abs(Pc).max(axis=0), np.abs(Ac).max(axis=0))
        row_norm = np.abs(Ac).max(axis=1)
        if n_ball:
            rows = slice(m - n_ball, m)
            gm = np.exp(np.mean(np.log(np.maximum(row_norm[rows], 1e-12))))
            row_norm[rows] = gm
        # zero-norm columns/rows keep scale 1 (clipping would compound to inf)
        d = np.where(col_norm > 1e-12, 1.0 / np.sqrt(np.clip(col_norm, 1e-8, 1e8)), 1.0)
        e = np.where(row_norm > 1e-12, 1.0 / np.sqrt(np.clip(row_norm, 1e-8, 1e8)), 1.0)
        Pc = (d[:, None] * Pc) * d[None, :]
        Ac = (e[:, None] * Ac) * d[None, :]
        D *= d
        E *= e
        gamma = min(1.0 / max(np.mean(np.abs(Pc).max(axis=0)), 1e-8), 1e8)
        Pc *= gamma
        c *= gamma
    return Pc, Ac, D, E, c


def _rho_grid(config: AdmmConfig):
    """The rho grid for prefactorized adaptation; always contains config.rho."""
    if not config.adapt_interval:
        return [float(config.rho)]
    return sorted(set(float(r) for r in config.rho_grid) | {float(config.rho)})


def start_rho_index(config: AdmmConfig) -> int:
    """Grid index of the configured starting rho."""
    return _rho_grid(config).index(float(config.rho))


def build_operator(
    P,
    A,
    eq_row_mask,
    n_ball: int = 0,
    config: AdmmConfig = AdmmConfig(),
) -> AdmmOperator:
    """Equilibrate and factorize on the host (f64); stored f32 on the CPU."""
    P64 = np.asarray(P, np.float64)
    A64 = np.asarray(A, np.float64)
    n = P64.shape[0]
    P_s, A_s, D, E, c = _ruiz_equilibrate(P64, A64, n_ball, config.scaling_iters)

    eq = np.asarray(eq_row_mask, bool)
    grid = _rho_grid(config)
    Ks, K_invs, rho_vecs = [], [], []
    for rho in grid:
        # cap per-row rho: beyond ~1e3 the f32 iteration's roundoff exceeds
        # the residual tolerance
        rho_vec = np.minimum(np.where(eq, rho * config.rho_eq_scale, rho), 1e3)
        K = P_s + config.sigma * np.eye(n) + (A_s.T * rho_vec) @ A_s
        Ks.append(K)
        K_invs.append(np.linalg.inv(K))
        rho_vecs.append(rho_vec)
    rho_vecs = np.stack(rho_vecs)

    m = A64.shape[0]
    diag_a = bool(
        n_ball == 0
        and m == n
        and np.count_nonzero(A_s - np.diag(np.diag(A_s))) == 0
    )
    top = A_s[:n, :] if m >= n else None
    mixed_a = bool(
        n_ball == 0
        and not diag_a
        and m > n
        and top is not None
        and np.count_nonzero(top - np.diag(np.diag(top))) == 0
    )
    op = AdmmOperator(
        P_s=f32(P_s),
        A_s=f32(A_s),
        Ks=f32(np.stack(Ks)),
        K_invs=f32(np.stack(K_invs)),
        rho_vecs=f32(rho_vecs),
        rho_invs=f32(1.0 / rho_vecs),
        rho_grid=f32(np.asarray(grid)),
        D=f32(D),
        E=f32(E),
        c=f32(c),
        n_ball=n_ball,
        diag_a=diag_a,
        mixed_a=mixed_a,
    )
    if op.dense_a:
        op = op.replace(kia=packed_kia(op.K_invs, op.A_s))
    return op


def newton_schulz_inverse(K: Tensor, iters: int = 40) -> Tensor:
    """Inverse of a batch of small well-posed matrices K (..., n, n) by the
    Newton-Schulz iteration X <- X (2I - K X) from X0 = K' / (||K||_1
    ||K||_inf), products only (the JAX package's MXU inverse, kept for
    parity: the SQP's traced operators are factorized with it).

    In fp32 the iteration saturates at a residual floor of ~kappa eps
    (3e-4 at kappa = 1e3, 1.9e-2 at 1e4, measured by the JAX package);
    40 iterations reach it. Pair it with at least one refinement step
    against the exact K (``AdmmConfig.refine_steps``; ``SqpConfig`` keeps
    1), which contracts the K-solve error by that floor per step."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    n1 = K.abs().sum(-2).amax(-1)
    ninf = K.abs().sum(-1).amax(-1)
    X = K.transpose(-1, -2) / torch.clamp_min(n1 * ninf, 1e-30)[..., None, None]
    for _ in range(iters):
        X = X @ (2.0 * eye - K @ X)
    return X


def build_operator_traced(
    P: Tensor,  # (B, n, n)
    A: Tensor,  # (B, m, n)
    eq_row_mask,
    n_ball: int = 0,
    config: AdmmConfig = AdmmConfig(),
    scaling_iters: int = 3,
    identity_A: bool = False,
) -> AdmmOperator:
    """An operator per lane, built on the device in fp32: the JAX package's
    ``build_operator_traced`` over a batch of QPs whose matrices are
    themselves per-lane values (the SQP's Gauss-Newton subproblems, rebuilt
    every outer iteration). A few Ruiz sweeps, then K = P_s + sigma I +
    A_s' diag(rho) A_s at the single rho ``config.rho`` (R = 1), inverted by
    :func:`newton_schulz_inverse`. ``eq_row_mask`` is a static numpy bool
    array (the rows' structure is the same in every lane).

    The operator's fields carry a leading lane axis: P_s (B, n, n), A_s
    (B, m, n), Ks and K_invs (B, 1, n, n), D (B, n), E (B, m), c (B,);
    rho_vecs, rho_invs (1, m) and rho_grid (1,) are shared.

    ``identity_A=True`` declares A == I (input boxes only): Ruiz is
    skipped, P keeps the cost normalization gamma, and K is formed
    without the product. ``diag_a`` is set only with ``n_ball == 0``, as
    ``build_operator`` sets it."""
    dev, f = P.device, torch.float32
    P_s = P.to(f)
    A_s = A.to(f)
    Bt, m, n = A_s.shape
    D = P_s.new_ones((Bt, n))
    E = P_s.new_ones((Bt, m))
    c = P_s.new_ones((Bt,))

    def gamma_of(P_s):
        return torch.clamp(
            1.0 / torch.clamp_min(P_s.abs().amax(-2).mean(-1), 1e-8), max=1e8
        )

    for _ in range(0 if identity_A else scaling_iters):
        col_norm = torch.maximum(P_s.abs().amax(-2), A_s.abs().amax(-2))
        row_norm = A_s.abs().amax(-1)
        if n_ball:
            gm = torch.exp(torch.log(torch.clamp_min(row_norm[:, m - n_ball :], 1e-12)).mean(-1))
            row_norm = torch.cat([row_norm[:, : m - n_ball], gm[:, None].expand(Bt, n_ball)], 1)
        d = torch.where(col_norm > 1e-12, 1.0 / torch.sqrt(torch.clamp(col_norm, 1e-8, 1e8)), 1.0)
        e = torch.where(row_norm > 1e-12, 1.0 / torch.sqrt(torch.clamp(row_norm, 1e-8, 1e8)), 1.0)
        P_s = d[:, :, None] * P_s * d[:, None, :]
        A_s = e[:, :, None] * A_s * d[:, None, :]
        D = D * d
        E = E * e
        gamma = gamma_of(P_s)
        P_s = P_s * gamma[:, None, None]
        c = c * gamma
    if identity_A:
        # one rho and no grid to absorb P's scale: keep the cost normalization
        gamma = gamma_of(P_s)
        P_s = P_s * gamma[:, None, None]
        c = c * gamma

    eq = np.asarray(eq_row_mask, bool)
    rho_vec = torch.from_numpy(
        np.minimum(np.where(eq, config.rho * config.rho_eq_scale, config.rho), 1e3).astype(
            np.float32
        )
    ).to(dev)
    eye = torch.eye(n, dtype=f, device=dev)
    if identity_A:
        K = P_s + (config.sigma + rho_vec) * eye
    else:
        K = P_s + config.sigma * eye + (A_s.transpose(1, 2) * rho_vec) @ A_s
    K_inv = newton_schulz_inverse(K)
    return AdmmOperator(
        P_s=P_s,
        A_s=A_s,
        Ks=K[:, None],
        K_invs=K_inv[:, None],
        rho_vecs=rho_vec[None],
        rho_invs=(1.0 / rho_vec)[None],
        rho_grid=torch.tensor([config.rho], dtype=f, device=dev),
        D=D,
        E=E,
        c=c,
        n_ball=n_ball,
        diag_a=bool(identity_A and n_ball == 0),
    )


def _project(
    op: AdmmOperator,
    v: Tensor,  # (m, B)
    l_s: Tensor,  # (m, B)
    u_s: Tensor,
    ball_c_s: Tensor,  # (n_ball, B)
    ball_r_s: Tensor,  # (B,)
    soft_shrink_s: Optional[Tensor] = None,  # (m, B); inf on hard rows
) -> Tensor:
    """Prox step onto the scaled constraint set, lane-last: interval clip on
    box rows (on soft rows the prox of a penalized L1 distance, a shrink
    toward the interval) and a Euclidean-ball projection of the trailing
    ball block, per lane."""
    clipped = torch.clamp(v, l_s, u_s)
    if soft_shrink_s is None:
        out = clipped
    else:
        # prox of mu dist_1(s, [l, u]) at v: above, max(u, v - mu/rho);
        # below, min(l, v + mu/rho); hard rows shrink by inf, a clip
        above = torch.maximum(u_s, v - soft_shrink_s)
        below = torch.minimum(l_s, v + soft_shrink_s)
        out = torch.where(v > u_s, above, torch.where(v < l_s, below, v))
    if op.n_ball:
        nb = op.n_ball
        w = v[-nb:] + ball_c_s
        nrm = torch.linalg.vector_norm(w, dim=0)
        scale = torch.where(nrm > ball_r_s, ball_r_s / torch.clamp_min(nrm, 1e-30), 1.0)
        out = torch.cat([out[:-nb], w * scale - ball_c_s])
    return out


def solve(
    op: AdmmOperator,
    q: Tensor,  # (B, n) unscaled
    l: Tensor,  # (B, m)
    u: Tensor,  # (B, m)
    ball_c: Tensor,  # (B, n_ball)
    ball_r: Tensor,  # (B,)
    z0: Optional[Tensor] = None,  # (B, n) unscaled warm primal
    y0: Optional[Tensor] = None,  # (B, m) unscaled warm dual
    config: AdmmConfig = AdmmConfig(),
    soft_mu: Optional[Tensor] = None,  # (m,) L1 penalty of soft rows, inf on hard
) -> AdmmResult:
    """The general engine: a batch of QP solves on the device of ``q``, the
    JAX package's ``solve`` for every lane at once (its ``vmap``), in fp32.

    Per lane, as there: the x-update through the prefactorized K_r^-1 of
    the lane's grid rho (for R > 1 every candidate by products shared by
    all lanes, then a select; for R = 1 with ``refine_steps`` corrections
    through K), relaxation, the projection (box, soft and ball rows), dual
    ascent; every ``check_interval`` iterations exact unscaled residuals,
    the primal and dual infeasibility certificates, the NaN/inf guard and
    the OSQP rho rule. A lane that is done keeps its state, status and
    iteration count while the others go on (the batched ``while_loop``);
    the loop ends when every lane is done or at ``max_iter``, reading the
    host once per check. ``adaptive=False`` runs ``max_iter`` iterations
    at the starting rho and one check against the iterate one step
    before. ``kernel_precision`` is not read: no kernel runs here.

    An operator with a leading lane axis (``build_operator_traced``: each
    lane its own P, A, K and K^-1, at one rho) takes the same iteration
    with batched products over the lanes' matrices."""
    B, n = q.shape
    lanes = op.P_s.dim() == 3
    m = int(op.A_s.shape[-2])
    R = int(op.rho_grid.shape[0])
    dev, f = q.device, torch.float32
    if dev.type == "cuda":
        assert_ieee_fp32()
    if lanes:
        if R != 1:
            raise ValueError("an operator per lane has one rho (R = 1)")
        # (B, r, k) @ (k, B): each lane's matrix against its own column
        mv = lambda M, v: torch.einsum("bik,kb->ib", M, v)
        D, E, c = op.D.T, op.E.T, op.c[None, :]
        P_s, A_s, AT_s = op.P_s, op.A_s, op.A_s.transpose(1, 2)
        K0, K_inv0 = op.Ks[:, 0], op.K_invs[:, 0]
    else:
        mv = lambda M, v: M @ v
        D, E, c = op.D[:, None], op.E[:, None], op.c
        P_s, A_s, AT_s = op.P_s, op.A_s, op.A_s.T
        K0, K_inv0 = op.Ks[0], op.K_invs[0]
    sigma = torch.tensor(config.sigma, dtype=f, device=dev)
    alpha = torch.tensor(config.alpha, dtype=f, device=dev)
    one_m_alpha = 1.0 - alpha
    D_inv, E_inv, c_inv = 1.0 / D, 1.0 / E, 1.0 / c
    c_inv_b = c_inv.reshape(-1) if lanes else c_inv  # against per-lane reductions
    lT, uT = l.T, u.T
    q_s = (c * D) * q.T
    l_s = E * lT
    u_s = E * uT
    if op.n_ball:
        E_ball = E[m - op.n_ball]  # one scale for the ball rows
        ball_c_s = E_ball * ball_c.T
        ball_r_s = E_ball * ball_r
    else:
        ball_c_s = ball_r_s = None

    def shrink_for(rho_vec):
        return None if soft_mu is None else soft_mu[:, None] / (E * rho_vec)

    def rho_parts(idx):  # the lanes' rho rows, (m, B) (R = 1: (m, 1))
        if R == 1:
            return op.rho_vecs[0][:, None], op.rho_invs[0][:, None]
        i = idx.long()
        return op.rho_vecs[i].T, op.rho_invs[i].T

    idx0 = start_rho_index(config) if R > 1 else 0
    log_grid = torch.log(op.rho_grid)
    x = torch.zeros((n, B), dtype=f, device=dev) if z0 is None else z0.T / D
    y = torch.zeros((m, B), dtype=f, device=dev) if y0 is None else (c * y0.T) / E
    ax = mv(A_s, x)
    idx = torch.full((B,), idx0, dtype=torch.int32, device=dev)
    rho_vec, rho_inv = rho_parts(idx)
    s = _project(op, ax + rho_inv * y, l_s, u_s, ball_c_s, ball_r_s, shrink_for(rho_vec))

    # A_s' diag(rho_r), (R, n, m): every candidate x-update from products
    # that all lanes share, in place of a gathered (B, n, n) K^-1
    AtRho = None if lanes else op.A_s.T[None] * op.rho_vecs[:, None, :]

    def step(x, s, y, ax, sel, rho_vec, rho_inv, shrink):
        if R == 1:
            rhs = sigma * x - q_s + mv(AT_s, rho_vec * s - y)
            xt = mv(K_inv0, rhs)
            for _ in range(config.refine_steps):
                xt = xt + mv(K_inv0, rhs - mv(K0, xt))
        else:
            base = sigma * x - q_s - op.A_s.T @ y
            rhs_r = base[None] + AtRho @ s  # (R, n, B)
            xt_r = op.K_invs @ rhs_r
            for _ in range(config.refine_steps):
                xt_r = xt_r + op.K_invs @ (rhs_r - op.Ks @ xt_r)
            xt = torch.gather(xt_r, 0, sel.expand(1, n, B))[0]
        st = mv(A_s, xt)
        x_new = alpha * xt + one_m_alpha * x
        v = alpha * st + one_m_alpha * s  # relaxed with the projected variable
        s_new = _project(op, v + rho_inv * y, l_s, u_s, ball_c_s, ball_r_s, shrink)
        y_new = y + rho_vec * (v - s_new)
        ax_new = alpha * st + one_m_alpha * ax  # A x_new, for the residuals
        return x_new, s_new, y_new, ax_new

    amax = lambda t: t.abs().amax(0)
    dual_norm_q = amax(D_inv * q_s)
    eps_i = config.eps_infeas
    inf = torch.tensor(float("inf"), dtype=f, device=dev)
    fin_l, fin_u = torch.isfinite(lT), torch.isfinite(uT)

    def diagnostics(x, s, y, ax, x_prev, y_prev):
        """Unscaled residuals, convergence, the infeasibility certificates
        and the NaN guard per lane; the normalized residual ratio for the
        rho rule."""
        r_prim = amax(E_inv * (ax - s))
        Px = mv(P_s, x)
        Aty = mv(AT_s, y)
        r_dual = c_inv_b * amax(D_inv * (Px + q_s + Aty))
        prim_norm = torch.maximum(amax(E_inv * ax), amax(E_inv * s))
        dual_norm = c_inv_b * torch.maximum(
            torch.maximum(amax(D_inv * Px), amax(D_inv * Aty)), dual_norm_q
        )
        converged = (r_prim <= config.eps_abs + config.eps_rel * prim_norm) & (
            r_dual <= config.eps_abs + config.eps_rel * dual_norm
        )
        # OSQP section 5.2: rho <- rho sqrt(normalized rp / normalized rd)
        ratio = (r_prim / torch.clamp_min(prim_norm, 1e-12)) / torch.clamp_min(
            r_dual / torch.clamp_min(dual_norm, 1e-12), 1e-12
        )
        # primal infeasibility certificate from the dual delta (OSQP 3.4)
        dys = y - y_prev
        dy = E * dys * c_inv
        dy_norm = amax(dy)
        Atdy = c_inv_b * amax(D_inv * mv(AT_s, dys))
        dy_plus = torch.clamp_min(dy, 0.0)
        dy_minus = torch.clamp_max(dy, 0.0)
        support = (
            torch.where(dy_plus > 0, torch.where(fin_u, uT * dy_plus, inf), 0.0)
            + torch.where(dy_minus < 0, torch.where(fin_l, lT * dy_minus, inf), 0.0)
        ).sum(0)
        prim_infeas = (
            (dy_norm > 1e-12) & (Atdy <= eps_i * dy_norm) & (support <= -eps_i * dy_norm)
        )
        # dual infeasibility certificate from the primal delta
        dxs = x - x_prev
        dx_norm = amax(D * dxs)
        Pdx = c_inv_b * amax(D_inv * mv(P_s, dxs))
        qdx = c_inv_b * (q_s * dxs).sum(0)
        Adx = E_inv * mv(A_s, dxs)
        dir_ok = (
            (~fin_u | (Adx <= eps_i * dx_norm)) & (~fin_l | (Adx >= -eps_i * dx_norm))
        ).all(0)
        dual_infeas = (
            (dx_norm > 1e-12) & (Pdx <= eps_i * dx_norm) & (qdx <= -eps_i * dx_norm) & dir_ok
        )
        # a poisoned iterate surfaces as its own status (NaN compares false,
        # so it cannot pass as converged)
        finite = torch.isfinite(x.sum(0) + y.sum(0) + s.sum(0))
        status = torch.where(
            ~finite, STATUS_NUMERIC_ERROR,
            torch.where(converged, STATUS_CONVERGED,
                        torch.where(prim_infeas, STATUS_PRIMAL_INFEASIBLE,
                                    torch.where(dual_infeas, STATUS_DUAL_INFEASIBLE,
                                                STATUS_MAX_ITER))),
        ).to(torch.int32)
        done = converged | prim_infeas | dual_infeas | ~finite
        return r_prim, r_dual, done, status, ratio

    def adapt_rho(idx, ratio, it, done):
        """The grid rho nearest rho sqrt(ratio), on the first check at or
        after each ``adapt_interval`` boundary."""
        if R == 1 or not config.adapt_interval:
            return idx
        if it % config.adapt_interval >= config.check_interval:
            return idx
        log_target = log_grid[idx.long()] + 0.5 * torch.log(torch.clamp(ratio, 1e-8, 1e8))
        # argmin returns the first minimum, as jnp.argmin does
        idx_new = torch.argmin((log_grid[None, :] - log_target[:, None]).abs(), dim=1)
        return torch.where(done, idx, idx_new.to(torch.int32))

    if config.adaptive:
        ck = max(1, int(config.check_interval))
        iters = torch.zeros((B,), dtype=torch.int32, device=dev)
        rp = torch.full((B,), float("inf"), dtype=f, device=dev)
        rd = torch.full_like(rp, float("inf"))
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        status = torch.full((B,), STATUS_MAX_ITER, dtype=torch.int32, device=dev)
        it = 0
        while it < config.max_iter and not bool(done.all()):
            rho_vec, rho_inv = rho_parts(idx)
            shrink = shrink_for(rho_vec)
            sel = idx.long()[None, None, :]
            xn, sn, yn, axn = x, s, y, ax
            for _ in range(ck):
                xn, sn, yn, axn = step(xn, sn, yn, axn, sel, rho_vec, rho_inv, shrink)
            rp2, rd2, done2, status2, ratio = diagnostics(xn, sn, yn, axn, x, y)
            idx2 = adapt_rho(idx, ratio, it + ck, done2)
            # lanes already done keep everything
            keep = done
            x, s, y, ax = (torch.where(keep[None], a, b) for a, b in ((x, xn), (s, sn), (y, yn), (ax, axn)))
            idx = torch.where(keep, idx, idx2)
            iters = torch.where(keep, iters, it + ck).to(torch.int32)
            rp = torch.where(keep, rp, rp2)
            rd = torch.where(keep, rd, rd2)
            status = torch.where(keep, status, status2)
            done = keep | done2
            it += ck
    else:
        # fixed cost: no checks inside, the starting rho, one check at the
        # end against the iterate one step before
        shrink = shrink_for(rho_vec)
        sel = idx.long()[None, None, :]
        for _ in range(config.max_iter - 1):
            x, s, y, ax = step(x, s, y, ax, sel, rho_vec, rho_inv, shrink)
        x_p, y_p = x, y
        x, s, y, ax = step(x, s, y, ax, sel, rho_vec, rho_inv, shrink)
        rp, rd, _, status, _ = diagnostics(x, s, y, ax, x_p, y_p)
        iters = torch.full((B,), config.max_iter, dtype=torch.int32, device=dev)

    return AdmmResult(
        z=(D * x).T.contiguous(),
        y=(E * y * c_inv).T.contiguous(),
        s=(E_inv * s).T.contiguous(),
        status=status,
        iterations=iters,
        primal_residual=rp,
        dual_residual=rd,
    )
