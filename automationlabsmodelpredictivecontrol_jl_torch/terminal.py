"""Terminal-ingredient synthesis (terminal cost + terminal set).

- terminal cost P: the DARE solution (scipy, f64) at the system's
  linearization around the last reference point;
- kind "equality": e_x_N == 0; kind "contractive": a Euclidean-ball block
  enforced downstream by projection; kind "none": cost only;
- kind "neighborhood": the maximal constraint-admissible invariant set of
  the LQR closed loop, H e_x_N <= b (:func:`invariant_terminal_set`).

Host design in numpy f64, the same code as the JAX package's, so the
stored f32 arrays agree with it.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import scipy.linalg as sla
from scipy.optimize import linprog

from .systems import linearize
from .types import Box, References, TerminalIngredient, Weights, f32


def invariant_terminal_set(
    A: Any,
    B: Any,
    K: Any,
    X: Box,
    U: Box,
    x_ref: Any,
    u_ref: Any,
    max_depth: int = 30,
    tol: float = 1e-9,
) -> Tuple[np.ndarray, np.ndarray]:
    """Maximal constraint-admissible invariant set of e+ = (A - B K) e, in
    deviation coordinates around (x_ref, u_ref).

    Base rows C e <= c encode the state box and the input box under the
    LQR law u = u_ref - K e. Rows C Acl^t e <= c are added for t = 1 ..
    max_depth while any of them is not implied over the box hull of the
    state box (interval arithmetic), then redundant rows are removed
    exactly by LP. Returns (H, b) in f64 with H e <= b.
    """
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    K = np.asarray(K, np.float64)
    x_ref = np.asarray(x_ref, np.float64)
    u_ref = np.asarray(u_ref, np.float64)
    x_lo = np.asarray(X.lo, np.float64)
    x_hi = np.asarray(X.hi, np.float64)
    Acl = A - B @ K

    eye = np.eye(A.shape[0])
    C = np.vstack([eye, -eye, -K, K])
    c = np.concatenate(
        [
            x_hi - x_ref,
            x_ref - x_lo,
            np.asarray(U.hi, np.float64) - u_ref,
            u_ref - np.asarray(U.lo, np.float64),
        ]
    )
    hi_e = x_hi - x_ref
    lo_e = x_lo - x_ref

    H_rows = [C]
    b_rows = [c]
    M = C @ Acl
    for _ in range(max_depth):
        worst = np.where(M > 0, M * hi_e[None, :], M * lo_e[None, :]).sum(axis=1)
        keep = worst > c + tol
        if not np.any(keep):
            break
        H_rows.append(M[keep])
        b_rows.append(c[keep])
        M = M @ Acl
    return _remove_redundant_rows(np.vstack(H_rows), np.concatenate(b_rows))


def _remove_redundant_rows(
    H: np.ndarray, b: np.ndarray, tol: float = 1e-9
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact LP redundancy removal: row i goes when
    max{H_i e : H_j e <= b_j for the other kept rows j} <= b_i. scipy is a
    dependency of this package: an unpruned set would be another
    controller, so there is no fallback."""
    keep = np.ones(len(b), bool)
    for i in range(len(b)):
        mask = keep.copy()
        mask[i] = False
        if not np.any(mask):
            continue
        res = linprog(
            -H[i],
            A_ub=H[mask],
            b_ub=b[mask],
            bounds=[(None, None)] * H.shape[1],
            method="highs",
        )
        if res.status == 0 and -res.fun <= b[i] + tol:
            keep[i] = False
    return H[keep], b[keep]


def create_terminal_ingredient(
    system: Any,
    kind: str,
    references: References,
    weights: Weights,
    max_set_depth: int = 30,
) -> TerminalIngredient:
    """Synthesize the terminal ingredient for a discrete linear system."""
    if kind not in ("none", "equality", "contractive", "neighborhood"):
        raise ValueError(f"unknown terminal ingredient kind {kind!r}")
    x_end = references.x[:, -1]
    u_end = references.u[:, -1]
    A, B = linearize(system, x_end, u_end)
    A64 = np.asarray(A, np.float64)
    B64 = np.asarray(B, np.float64)
    R64 = np.asarray(weights.R, np.float64)
    P = f32(sla.solve_discrete_are(A64, B64, np.asarray(weights.Q, np.float64), R64))
    if kind != "neighborhood":
        return TerminalIngredient(kind=kind, P=P)
    # the LQR gain from the stored (f32-rounded) P, as the JAX package does
    P64 = np.asarray(P, np.float64)
    K = np.linalg.solve(R64 + B64.T @ P64 @ B64, B64.T @ P64 @ A64)
    H, b = invariant_terminal_set(
        A64, B64, K, system.X, system.U, x_end, u_end, max_depth=max_set_depth
    )
    return TerminalIngredient(kind=kind, P=P, H=f32(H), b=f32(b))
