"""Discrete algebraic Riccati equation by structure-preserving doubling.

The JAX package's ``ops/dare.py``: a fixed number of SDA iterations of
products and small dense solves, in fp32, over any leading batch axes
(many linearization points at once). Design itself solves its DARE in f64
on the host with scipy (``terminal.py``); this is the device solver.

    A_{k+1} = A_k (I + G_k H_k)^-1 A_k
    G_{k+1} = G_k + A_k (I + G_k H_k)^-1 G_k A_k'
    H_{k+1} = H_k + A_k' H_k (I + G_k H_k)^-1 A_k

with A_0 = A, G_0 = B R^-1 B', H_0 = Q; H_k converges quadratically to
the P of P = A'PA - A'PB (R + B'PB)^-1 B'PA + Q.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _t(M: Tensor) -> Tensor:
    return M.transpose(-1, -2)


def solve_dare(A, B, Q, R, iters: int = 30) -> Tensor:
    """P (..., nx, nx), symmetric, of the DARE of each (A, B, Q, R); every
    iterate is symmetrized. fp32 (IEEE on the card) reaches ~1e-5 relative
    residual on well-conditioned problems."""
    A, B, Q, R = (torch.as_tensor(v, dtype=torch.float32) for v in (A, B, Q, R))
    nx = A.shape[-1]
    eye = torch.eye(nx, dtype=A.dtype, device=A.device)
    Ak, Gk, Hk = A, B @ torch.linalg.solve(R, _t(B)), Q
    for _ in range(int(iters)):
        # W = (I + G H)^-1 [A, G]: one solve, used twice
        W = torch.linalg.solve(eye + Gk @ Hk, torch.cat([Ak, Gk], dim=-1))
        WA, WG = W[..., :nx], W[..., nx:]
        A1 = Ak @ WA
        G1 = Gk + Ak @ (WG @ _t(Ak))
        H1 = Hk + _t(Ak) @ (Hk @ WA)
        Ak, Gk, Hk = A1, 0.5 * (G1 + _t(G1)), 0.5 * (H1 + _t(H1))
    return 0.5 * (Hk + _t(Hk))


def dare_residual(A, B, Q, R, P) -> Tensor:
    """max |A'PA - P - A'PB (R + B'PB)^-1 B'PA + Q| (..., ): the check."""
    APA = _t(A) @ (P @ A)
    APB = _t(A) @ (P @ B)
    K = torch.linalg.solve(R + _t(B) @ (P @ B), _t(APB))
    return (APA - P - APB @ K + Q).abs().amax(dim=(-2, -1))


def lqr_gain(A, B, R, P) -> Tensor:
    """The infinite-horizon LQR gain K = (R + B'PB)^-1 B'PA (u = -K x)."""
    return torch.linalg.solve(R + _t(B) @ (P @ B), _t(B) @ (P @ A))
