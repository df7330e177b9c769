"""SQP engine: only the reference-parity objective is ported so far.

The SQP solver itself (single and multiple shooting) is ROADMAP Queue 1,
"SQP".
"""

from __future__ import annotations

import torch


def true_objective(tuning, xs: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
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
