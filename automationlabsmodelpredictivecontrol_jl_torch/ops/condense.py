"""Condensed MPC -> QP transcription.

The state trajectory is eliminated with prediction matrices, so the
decision variable is the stacked input deviation z = vec(e_u), step-major
[e_u_1; ...; e_u_N], and every x0-dependent quantity is a small matrix-
vector product. Design runs once per controller, on the host, in numpy
f64 (the same code as the JAX package's ``condense_np``, so the f32 arrays
agree bit for bit); the per-solve vectors are fp32 matmuls on the device.

Row layout of A: [input-box rows (N*nu)] then [state-box rows (N*nx),
opt-in] then [terminal rows: nx (equality, contractive), the rows of H
(neighborhood, with l = -inf) or none]. The last ``n_ball`` rows are a
Euclidean-ball block (contractive terminal set).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..types import (
    CONTRACTIVE_FACTOR,
    Box,
    References,
    TensorRecord,
    TerminalIngredient,
    Weights,
    f32,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CondensedQpData(TensorRecord):
    """Everything needed to pose the condensed QP for any x0."""

    P: Tensor  # (n, n)
    A: Tensor  # (m, n)
    # x0-affine runtime data: q = q_const + q_x0 @ e0, l/u = *_const + b_x0 @ e0
    q_const: Tensor  # (n,)
    q_x0: Tensor  # (n, nx)
    l_const: Tensor  # (m,)
    u_const: Tensor  # (m,)
    b_x0: Tensor  # (m, nx)
    ball_c_x0: Tensor  # (n_ball, nx)
    # trajectory reconstruction: e_x[2..N+1] = G_flat z + F e0
    F: Tensor  # (N, nx, nx)
    G_flat: Tensor  # (N*nx, n)
    N: int
    nx: int
    nu: int
    n_ball: int  # 0 or nx (contractive)
    ball_radius_sq_factor: float


def condense_np(
    A,
    B,
    horizon: int,
    weights: Weights,
    terminal: TerminalIngredient,
    references: References,
    X: Box,
    U: Box,
    state_constraint: bool,
) -> CondensedQpData:
    """Build the condensed QP data on the host (f64), stored f32 on the CPU."""
    N = horizon
    A64 = np.asarray(A, np.float64)
    B64 = np.asarray(B, np.float64)
    nx, nu = B64.shape
    n = N * nu

    # prediction operators by forward recursion
    F = np.zeros((N, nx, nx))
    G = np.zeros((N, N, nx, nu))
    Fk = np.eye(nx)
    for k in range(N):
        Gk = np.zeros((N, nx, nu))
        if k > 0:
            Gk = np.einsum("ab,jbc->jac", A64, G[k - 1])
        Gk[k] = B64
        Fk = A64 @ Fk
        F[k] = Fk
        G[k] = Gk
    G_flat = G.transpose(0, 2, 1, 3).reshape(N * nx, N * nu)
    F_flat = F.reshape(N * nx, nx)

    Q = np.asarray(weights.Q, np.float64)
    P_term = np.asarray(terminal.P, np.float64)
    R = np.asarray(weights.R, np.float64)
    S = np.asarray(weights.S, np.float64)
    Qbar = np.zeros((N * nx, N * nx))
    for i in range(N):
        Qbar[i * nx : (i + 1) * nx, i * nx : (i + 1) * nx] = (
            P_term if i == N - 1 else Q
        )
    Rbar = np.kron(np.eye(N), R)

    GtQ = G_flat.T @ Qbar
    P_qp = 2.0 * (GtQ @ G_flat + Rbar)
    q_x0 = 2.0 * (GtQ @ F_flat)

    uref_stack = np.asarray(references.u).T.reshape(-1)
    xref_stack = np.asarray(references.x).T[1:].reshape(-1)

    q_const = np.zeros(n)
    if np.any(S != 0.0):
        eye = np.eye(N)
        Dstep = eye[:-1] - eye[1:]
        D = np.kron(Dstep, np.eye(nu))
        Sbar = np.kron(np.eye(N - 1), S)
        P_qp = P_qp + 2.0 * D.T @ Sbar @ D
        q_const = q_const + 2.0 * D.T @ Sbar @ (D @ uref_stack)

    rows_A = [np.eye(n)]
    rows_l = [np.tile(np.asarray(U.lo, np.float64), N) - uref_stack]
    rows_u = [np.tile(np.asarray(U.hi, np.float64), N) - uref_stack]
    rows_bx0 = [np.zeros((n, nx))]
    if state_constraint:
        rows_A.append(G_flat)
        rows_l.append(np.tile(np.asarray(X.lo, np.float64), N) - xref_stack)
        rows_u.append(np.tile(np.asarray(X.hi, np.float64), N) - xref_stack)
        rows_bx0.append(-F_flat)

    n_ball = 0
    ball_c_x0 = np.zeros((0, nx))
    G_last = G_flat[-nx:]
    F_last = F_flat[-nx:]
    if terminal.kind == "equality":
        rows_A.append(G_last)
        rows_l.append(np.zeros(nx))
        rows_u.append(np.zeros(nx))
        rows_bx0.append(-F_last)
    elif terminal.kind == "neighborhood":
        if terminal.H is None or terminal.b is None:
            raise ValueError("neighborhood terminal kind requires H, b")
        H = np.asarray(terminal.H, np.float64)
        rows_A.append(H @ G_last)
        rows_l.append(np.full(H.shape[0], -np.inf))
        rows_u.append(np.asarray(terminal.b, np.float64))
        rows_bx0.append(-(H @ F_last))
    elif terminal.kind == "contractive":
        rows_A.append(G_last)
        rows_l.append(np.full(nx, -np.inf))
        rows_u.append(np.full(nx, np.inf))
        rows_bx0.append(np.zeros((nx, nx)))
        n_ball = nx
        ball_c_x0 = F_last

    return CondensedQpData(
        P=f32(P_qp),
        A=f32(np.concatenate(rows_A, axis=0)),
        q_const=f32(q_const),
        q_x0=f32(q_x0),
        l_const=f32(np.concatenate(rows_l)),
        u_const=f32(np.concatenate(rows_u)),
        b_x0=f32(np.concatenate(rows_bx0, axis=0)),
        ball_c_x0=f32(ball_c_x0),
        F=f32(F),
        G_flat=f32(G_flat),
        N=N,
        nx=nx,
        nu=nu,
        n_ball=n_ball,
        ball_radius_sq_factor=CONTRACTIVE_FACTOR,
    )


def condense(
    A: Tensor,
    B: Tensor,
    horizon: int,
    weights: Weights,
    terminal: TerminalIngredient,
    references: References,
    X: Box,
    U: Box,
    state_constraint: bool,
) -> CondensedQpData:
    """The condensed QP data of a discrete linear system, on the device of
    ``B``: :func:`condense_np` on host copies of the inputs. Its f32 data
    equal the JAX package's ``condense_np`` bit for bit, and its traced
    ``condense`` to fp32 roundoff."""
    host = lambda r: r.to("cpu")
    qp = condense_np(
        torch.as_tensor(A).cpu(), torch.as_tensor(B).cpu(), horizon, host(weights),
        host(terminal), host(references), host(X), host(U), state_constraint,
    )
    return qp.to(torch.as_tensor(B).device)


def runtime_qp_vectors(qp: CondensedQpData, e0: Tensor):
    """Per-solve QP vectors of one initial deviation e0 (nx,): the batch
    form at B = 1. Returns (q (n,), l (m,), u (m,), ball_c (n_ball,),
    ball_r ())."""
    return tuple(v[0] for v in runtime_qp_vectors_batch(qp, e0[None]))


def runtime_qp_vectors_batch(qp: CondensedQpData, e0s: Tensor):
    """Per-solve QP vectors for a batch of initial deviations e0s (B, nx):
    three fp32 matmuls against the shared design matrices.
    Returns (q, l, u, ball_c, ball_r), each with a leading batch axis."""
    q = qp.q_const[None] + e0s @ qp.q_x0.T
    shift = e0s @ qp.b_x0.T  # b_x0 already carries the sign (-F)
    l = qp.l_const[None] + shift
    u = qp.u_const[None] + shift
    if qp.n_ball:
        ball_c = e0s @ qp.ball_c_x0.T
        ball_r = float(np.sqrt(qp.ball_radius_sq_factor)) * torch.linalg.vector_norm(
            e0s, dim=1
        )
    else:
        B = e0s.shape[0]
        ball_c = e0s.new_zeros((B, 0))
        ball_r = e0s.new_zeros((B,))
    return q, l, u, ball_c, ball_r


def ltv_prediction_matrices(As: Tensor, Bs: Tensor, cs: Tensor = None):
    """Prediction operators of e_{k+1} = A_k e_k + B_k du_k + c_k over a
    batch of lanes: As (B, N, nx, nx), Bs (B, N, nx, nu), cs (B, N, nx) or
    None. Returns F (B, N, nx, nx) with e_pred[i] += F[i] e_0, G (B, N, N,
    nx, nu) lower block triangular with e_pred[i] += sum_j G[i, j] du_j,
    and h (B, N, nx), the offset from cs; e_pred[i] is the state at step
    i + 1 (steps 2..N+1 of the reference's 1-based indexing). One batched
    product per horizon step (the JAX package's ``lax.scan``)."""
    Bt, N, nx, nu = Bs.shape
    if cs is None:
        cs = Bs.new_zeros((Bt, N, nx))
    Fk = torch.eye(nx, dtype=Bs.dtype, device=Bs.device).expand(Bt, nx, nx)
    Gk = Bs.new_zeros((Bt, N, nx, nu))
    hk = Bs.new_zeros((Bt, nx))
    Fs, Gs, hs = [], [], []
    for k in range(N):
        A_k = As[:, k]
        Gk = torch.einsum("bij,bnjc->bnic", A_k, Gk)
        Gk[:, k] = Bs[:, k]
        Fk = A_k @ Fk
        hk = (A_k @ hk[..., None])[..., 0] + cs[:, k]
        Fs.append(Fk)
        Gs.append(Gk)
        hs.append(hk)
    return torch.stack(Fs, 1), torch.stack(Gs, 1), torch.stack(hs, 1)


def lti_prediction_matrices(A: Tensor, B: Tensor, N: int):
    """:func:`ltv_prediction_matrices` of one time-invariant plant, A (nx,
    nx) and B (nx, nu) at every step: F (N, nx, nx), G (N, N, nx, nu) and
    h (N, nx), zeros."""
    As = A[None, None].expand(1, N, *A.shape)
    Bs = B[None, None].expand(1, N, *B.shape)
    return tuple(v[0] for v in ltv_prediction_matrices(As, Bs))
