"""LTV Riccati QP solver: the multiple-shooting SQP subproblem, over lanes.

The JAX package's ``ops/riccati_ltv.py``. Gauss-Newton subproblem around
an iterate (X, U) that need not satisfy the dynamics:

    min  sum_k 0.5 dx_k' Qb dx_k + lq_k' dx_k + 0.5 du_k' Rb du_k + lu_k' du_k
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k   (c_k = f(x_k, u_k) - x_{k+1},
                                               the shooting defects)
         dx_0 = 0, boxes / terminal set on (x + dx, u + du)

solved by consensus ADMM: the w-update is the affine LTV-LQR (one backward
gain sweep per factorization, then per ADMM iteration one O(N) affine
backward and forward sweep), the v-update the projections. Every lane has
its own (A_k, B_k, c_k); the JAX package's ``lax.scan``s over the horizon
are loops over N of batched small products, the lanes on the leading axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..types import TensorRecord

Tensor = torch.Tensor


def _mv(M: Tensor, v: Tensor) -> Tensor:
    """M (B, r, k) @ v (B, k) -> (B, r)."""
    return (M @ v[..., None])[..., 0]


@dataclasses.dataclass(frozen=True)
class LtvFactors(TensorRecord):
    """Backward LTV Riccati factorization around one SQP iterate, per lane.

    With S_N = Qb_term and for k = N-1..0:
        G_k    = (Rb + B_k' S_{k+1} B_k)^-1
        K_k    = G_k B_k' S_{k+1} A_k
        AmBK_k = A_k - B_k K_k
        S_k    = Qb + A_k' S_{k+1} AmBK_k
    h_k = S_{k+1} c_k feeds the defects into the affine sweep."""

    K: Tensor  # (B, N, nu, nx)
    G: Tensor  # (B, N, nu, nu)
    AmBK: Tensor  # (B, N, nx, nx)
    A: Tensor  # (B, N, nx, nx)
    B: Tensor  # (B, N, nx, nu)
    c: Tensor  # (B, N, nx)
    h: Tensor  # (B, N, nx)
    # the affine sweep's steps as one product each (fewer small operations
    # per ADMM iteration): backward [ff; g - lq] = Wb [g + h; lu], forward
    # [du; dx' - c] = Wf [dx; ff]
    Wb: Tensor  # (B, N, nu+nx, nx+nu) = [[G B', G], [AmBK', -K']]
    Wf: Tensor  # (B, N, nu+nx, nx+nu) = [[-K, -I], [AmBK, -B]]


def ltv_factorize(
    As: Tensor,  # (B, N, nx, nx)
    Bs: Tensor,  # (B, N, nx, nu)
    cs: Tensor,  # (B, N, nx)
    Qb: Tensor,  # (nx, nx) interior-node cost (nodes 1..N-1)
    Rb: Tensor,  # (nu, nu)
    Qb_term: Tensor,  # (nx, nx) node-N cost
) -> LtvFactors:
    """The backward Riccati sweep over the lanes' (A_k, B_k)."""
    Bt, N, nx, nu = Bs.shape
    eye_u = torch.eye(nu, dtype=Bs.dtype, device=Bs.device).expand(Bt, nu, nu)
    S = Qb_term.to(Bs.dtype).expand(Bt, nx, nx)
    K, G, AmBK, h = [None] * N, [None] * N, [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        A_k, B_k = As[:, k], Bs[:, k]
        BtS = B_k.transpose(1, 2) @ S
        M = Rb + BtS @ B_k
        G[k] = torch.linalg.solve(M, eye_u)
        K[k] = G[k] @ (BtS @ A_k)
        AmBK[k] = A_k - B_k @ K[k]
        h[k] = _mv(S, cs[:, k])  # S_{k+1} c_k
        S_new = Qb + A_k.transpose(1, 2) @ (S @ AmBK[k])
        S = 0.5 * (S_new + S_new.transpose(1, 2))
    st = lambda xs: torch.stack(xs, 1)
    K, G, AmBK = st(K), st(G), st(AmBK)
    t = lambda M: M.transpose(-1, -2)
    eye_n = torch.eye(nu, dtype=Bs.dtype, device=Bs.device).expand(Bt, N, nu, nu)
    Wb = torch.cat([torch.cat([G @ t(Bs), G], -1), torch.cat([t(AmBK), -t(K)], -1)], -2)
    Wf = torch.cat([torch.cat([-K, -eye_n], -1), torch.cat([AmBK, -Bs], -1)], -2)
    return LtvFactors(K=K, G=G, AmBK=AmBK, A=As, B=Bs, c=cs, h=st(h), Wb=Wb, Wf=Wf)


def ltv_affine_solve(
    f: LtvFactors,
    lq: Tensor,  # (B, N, nx) linear cost on nodes 0..N-1 (row 0 unused: dx_0 = 0)
    lq_term: Tensor,  # (B, nx) linear cost on node N
    lu: Tensor,  # (B, N, nu)
) -> Tuple[Tensor, Tensor]:
    """The affine sweep against the factorized gains:
        ff_k = G_k (B_k'(h_k + g_{k+1}) + lu_k)
        g_k  = lq_k + AmBK_k'(g_{k+1} + h_k) - K_k' lu_k
    then dx_{k+1} = AmBK_k dx_k - B_k ff_k + c_k, du_k = -K_k dx_k - ff_k,
    each step one product with the stacked Wb or Wf.
    Returns (dX (B, N+1, nx) with dx_0 = 0, dU (B, N, nu))."""
    Bt, N, nx, nu = f.B.shape
    # column vectors (B, n, 1) through both sweeps: one product a step
    g = lq_term[..., None]
    lq, lu, h, c = lq[..., None], lu[..., None], f.h[..., None], f.c[..., None]
    ffs = [None] * N
    for k in range(N - 1, -1, -1):
        y = f.Wb[:, k] @ torch.cat([g + h[:, k], lu[:, k]], 1)
        ffs[k] = y[:, :nu]
        g = lq[:, k] + y[:, nu:]
    dx = f.B.new_zeros((Bt, nx, 1))
    dxs, dus = [dx], []
    for k in range(N):
        y = f.Wf[:, k] @ torch.cat([dx, ffs[k]], 1)
        dus.append(y[:, :nu])
        dx = y[:, nu:] + c[:, k]
        dxs.append(dx)
    return torch.stack(dxs, 1)[..., 0], torch.stack(dus, 1)[..., 0]


def solve_ms_qp(
    factors: LtvFactors,
    lq_nodes: Tensor,  # (B, N+1, nx) base linear cost per node (row 0 = 0)
    lu0: Tensor,  # (B, N, nu) base linear cost on inputs
    u_lo: Tensor,  # (B, N, nu) du bounds (iterate-relative)
    u_hi: Tensor,
    x_lo: Optional[Tensor],  # (B, N-1, nx) interior dx bounds, or None
    x_hi: Optional[Tensor],
    xN_lo: Optional[Tensor],  # (B, nx) terminal dx box, or None
    xN_hi: Optional[Tensor],
    ball_c: Optional[Tensor],  # (B, nx) contractive: ||dx_N + ball_c|| <= ball_r
    ball_r: Tensor,  # (B,)
    lamX0: Tensor,  # (B, N+1, nx) dual warm start
    lamU0: Tensor,  # (B, N, nu)
    rho: Tensor,
    iters: int,
    soft_mu: Optional[float] = None,
    terminal_is_box: bool = False,
    rho_x: Optional[Tensor] = None,
):
    """Fixed-iteration consensus ADMM on the multiple-shooting subproblem
    (the inner loop of one SQP iteration; the SQP masks convergence, so
    this runs ``iters`` iterations and reports its final residual).

    w = (dX, dU) by :func:`ltv_affine_solve`; v = the per-block
    projections; node 0 (dx_0 = 0) never splits. ``soft_mu``: soft state
    boxes, whose projection is the prox of mu dist(v, box), a shrink by
    mu / rho_x toward the box. ``terminal_is_box``: the xN rows are the
    plain state box (they follow the soft/hard choice), not an equality
    pin. ``rho_x``: the state rows' own consensus rho (defaults to rho);
    it must equal the rho the caller folded into Qb / Qb_term.
    Returns (dX, dU, lamX, lamU, rp (B,))."""
    Bt, N1, nx = lq_nodes.shape
    N = N1 - 1
    if rho_x is None:
        rho_x = rho
    split_interior = x_lo is not None
    split_terminal = xN_lo is not None or ball_c is not None or split_interior
    ball = ball_c is not None
    lq_int = lq_nodes[:, 1:-1]
    lq_term = lq_nodes[:, -1]

    def box_prox(V, lo, hi):
        if soft_mu is None:
            return torch.clamp(V, lo, hi)
        k = soft_mu / rho_x
        return V - torch.clamp(V - torch.clamp(V, lo, hi), -k, k)

    def project_X(V):
        out = V.clone()
        if split_interior:
            out[:, 1:-1] = box_prox(V[:, 1:-1], x_lo, x_hi)
        if ball:
            w = V[:, -1] + ball_c
            nrm = torch.linalg.vector_norm(w, dim=-1)
            scale = torch.where(nrm > ball_r, ball_r / torch.clamp_min(nrm, 1e-30), 1.0)
            out[:, -1] = w * scale[:, None] - ball_c
        elif xN_lo is not None:
            # terminal equality rows stay exact; a plain terminal state box
            # follows the soft/hard choice
            if terminal_is_box:
                out[:, -1] = box_prox(V[:, -1], xN_lo, xN_hi)
            else:
                out[:, -1] = torch.clamp(V[:, -1], xN_lo, xN_hi)
        return out

    dX = lq_nodes.new_zeros((Bt, N + 1, nx))
    dU = lu0.new_zeros(lu0.shape)
    vX = project_X(dX)
    vU = torch.clamp(dU, u_lo, u_hi)
    lamX, lamU = lamX0, lamU0
    zero_x = lq_nodes.new_zeros((Bt, 1, nx))
    for _ in range(int(iters)):
        # w-update linear terms: base cost + augmented (-rho v + lam)
        lu = lu0 - rho * vU + lamU
        if split_interior:
            lq = torch.cat([zero_x, lq_int - rho_x * vX[:, 1:-1] + lamX[:, 1:-1]], 1)
        else:
            lq = torch.cat([zero_x, lq_int], 1)
        lqT = lq_term - rho_x * vX[:, -1] + lamX[:, -1] if split_terminal else lq_term
        dX, dU = ltv_affine_solve(factors, lq, lqT, lu)
        vU = torch.clamp(dU + lamU / rho, u_lo, u_hi)
        lamU = lamU + rho * (dU - vU)
        if split_terminal:
            vXn = project_X(dX + lamX / rho_x)
            lamXn = lamX + rho_x * (dX - vXn)
            vXn[:, 0] = dX[:, 0]
            lamXn[:, 0] = 0.0
            if not split_interior:
                vXn[:, 1:-1] = dX[:, 1:-1]
                lamXn[:, 1:-1] = 0.0
            vX, lamX = vXn, lamXn
        else:
            vX = dX
    amax = lambda t: t.abs().flatten(1).amax(1)
    rp = amax(dU - vU)
    if split_terminal:
        rp = torch.maximum(rp, amax(dX[:, -1] - vX[:, -1]))
    if split_interior:
        rp = torch.maximum(rp, amax(dX[:, 1:-1] - vX[:, 1:-1]))
    # the projected (feasible-in-the-QP) step
    return dX, torch.clamp(dU, u_lo, u_hi), lamX, lamU, rp
