"""The plain reference of a linear tracking MPC with input boxes, and the
judge that holds the program's answers to it.

The problem of a lane with initial deviation e0 = x0 - x_ref:

    min  sum_{k<N} e_k' Q e_k + e_N' P e_N + sum_{k<N} v_k' R v_k
    s.t. e_{k+1} = A e_k + B v_k,  u_lo - u_ref <= v_k <= u_hi - u_ref

with P the discrete algebraic Riccati equation's solution (the terminal
cost of the configuration's "none" terminal). The reference condenses it
into a dense box QP in float64 (min 1/2 v'Hv + (F e0)'v) and solves it by
projected gradient with constant momentum from the Hessian's extreme
eigenvalues, to a KKT residual of 1e-11: an algorithm and a formulation
the program uses neither of. The same code runs in bfloat16 as the control.
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional

import numpy as np
import torch

KKT_TOL = 1e-11


def dare(A, B, Q, R, tol=1e-14, max_iter=200000):
    """P = Q + A'P A - A'P B (R + B'P B)^-1 B'P A by value iteration in
    float64 (the plant is stable, so it converges from P = Q)."""
    P = Q.copy()
    for _ in range(max_iter):
        K = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
        Pn = Q + A.T @ P @ (A - B @ K)
        if np.abs(Pn - P).max() <= tol * np.abs(Pn).max():
            return Pn
        P = Pn
    raise RuntimeError("the DARE iteration did not converge")


class Design:
    """The reference's design of a configuration, float64 numpy: the plant,
    the weights, the terminal cost, the input box in deviations, and the
    condensed QP (H, F with gradient F e0, the prediction matrices)."""

    def __init__(self, cfg: Dict):
        plant = importlib.import_module(f"{__package__}.{cfg['plant']}")
        A, B, x_box, u_box = plant.linear_system(cfg)
        nx, nu, N = A.shape[0], B.shape[1], int(cfg["horizon"])
        Q = float(cfg["Q"]) * np.eye(nx)
        R = float(cfg["R"]) * np.eye(nu)
        x_ref = np.asarray(cfg["x_ref"], np.float64)
        u_ref = np.asarray(cfg["u_ref"], np.float64)
        self.A, self.B, self.Q, self.R = A, B, Q, R
        self.P = dare(A, B, Q, R)
        self.N, self.nx, self.nu = N, nx, nu
        self.x_ref, self.u_ref = x_ref, u_ref
        self.v_lo = np.asarray(u_box[0], np.float64) - u_ref
        self.v_hi = np.asarray(u_box[1], np.float64) - u_ref
        # A^d B for d = 0..N-1, and the block lower-triangular prediction
        # e_{k+1} = A^{k+1} e0 + sum_{j<=k} A^{k-j} B v_j
        AdB = np.empty((N, nx, nu))
        Ak = np.eye(nx)
        powers = np.empty((N, nx, nx))
        for d in range(N):
            AdB[d] = Ak @ B
            Ak = A @ Ak
            powers[d] = Ak
        k, j = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
        blocks = np.where((k >= j)[..., None, None], AdB[np.clip(k - j, 0, N - 1)], 0.0)
        self.Gp = blocks.transpose(0, 2, 1, 3).reshape(N * nx, N * nu)
        self.Fp = powers.reshape(N * nx, nx)

    def qp(self, device, dtype=torch.float64):
        """(H, F, lo, hi) on ``device``: H = 2 (G'Qbar G + Rbar), the
        gradient's F e0 with F = 2 G'Qbar A-powers, computed in ``dtype``
        from the design rounded to it."""
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
        N = self.N
        G, Fp = t(self.Gp), t(self.Fp)
        Qbar = torch.block_diag(*([t(self.Q)] * (N - 1) + [t(self.P)]))
        GtQ = G.T @ Qbar
        Rbar = torch.block_diag(*([t(self.R)] * N))
        H = 2.0 * (GtQ @ G + Rbar)
        F = 2.0 * (GtQ @ Fp)
        lo = t(np.tile(self.v_lo, N))
        hi = t(np.tile(self.v_hi, N))
        return H, F, lo, hi

    def arrays(self) -> Dict[str, np.ndarray]:
        """The design as it reaches a solve, by the names the judge uses."""
        return {"A": self.A, "B": self.B, "Q": self.Q, "R": self.R, "P": self.P,
                "v_lo": self.v_lo, "v_hi": self.v_hi}


def solve_box_qp(H, F, lo, hi, e0, iters: Optional[int] = None, tol: float = KKT_TOL):
    """Solutions v (L, n) of min 1/2 v'Hv + (F e0)'v over lo <= v <= hi for
    e0 (L, nx), by projected gradient with constant momentum
    (sqrt(kappa) - 1) / (sqrt(kappa) + 1), step 1 / lambda_max. Without
    ``iters`` it runs to a KKT residual (the projected gradient step's
    largest move, times lambda_max) under ``tol`` and raises if that takes
    more than 40000 steps; with ``iters`` it runs that many steps. Returns
    (v, kkt residual per lane)."""
    ev = torch.linalg.eigvalsh(H.double())
    L, mu = float(ev[-1]), float(ev[0])
    beta = (np.sqrt(L / mu) - 1.0) / (np.sqrt(L / mu) + 1.0)
    dt = H.dtype
    g0 = e0.to(dt) @ F.T  # (L, n)
    step = 1.0 / L
    proj = lambda v: torch.maximum(torch.minimum(v, hi[None]), lo[None])
    v = proj(torch.zeros_like(g0))
    prev = v
    kkt = lambda v: (v - proj(v - step * (v @ H + g0))).abs().amax(1) * L
    limit = 40000 if iters is None else int(iters)
    for i in range(limit):
        y = v + beta * (v - prev)
        prev = v
        v = proj(y - step * (y @ H + g0))
        if iters is None and i % 200 == 199 and float(kkt(v).max()) <= tol:
            return v, kkt(v)
    r = kkt(v)
    if iters is None:
        raise RuntimeError(f"the reference QP solve stopped at KKT residual {float(r.max()):.3g}")
    return v, r


def rollout(A, B, e0, V, nu):
    """Deviations e_0..e_N (L, N+1, nx) of inputs V (L, N nu) from e0."""
    Vs = V.reshape(V.shape[0], -1, nu)
    xs = [e0]
    for k in range(Vs.shape[1]):
        xs.append(xs[-1] @ A.T + Vs[:, k] @ B.T)
    return torch.stack(xs, 1)


def solve(design: Design, x0, device, dtype=torch.float64, iters=None):
    """The reference's answers for initial states x0 (L, nx): inputs u (L,
    N, nu) and states x (L, N+1, nx), absolute, in ``dtype``, and the KKT
    residual of each lane."""
    H, F, lo, hi = design.qp(device, dtype)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
    e0 = torch.as_tensor(x0, device=device).to(torch.float64) - t(design.x_ref).double()
    e0 = e0.to(dtype)
    outs, kkts = [], []
    for rows in torch.split(e0, 4096):
        v, r = solve_box_qp(H, F, lo, hi, rows, iters=iters)
        outs.append(v)
        kkts.append(r)
    v = torch.cat(outs)
    x = rollout(t(design.A), t(design.B), e0, v, design.nu)
    u = v.reshape(v.shape[0], design.N, design.nu) + t(design.u_ref)
    return u, x + t(design.x_ref), torch.cat(kkts)


def recompute_diagnostics(status, iterations, rp, rd) -> Dict[str, float]:
    """A batch's diagnostics worked out from its lanes' outputs (numpy):
    the counts of each status, the residuals' and iterations' maxima, and
    the mean of iterations."""
    return {
        "n_total": float(status.size),
        "n_converged": float(np.count_nonzero(status == 0)),
        "n_max_iter": float(np.count_nonzero(status == 1)),
        "n_infeasible": float(np.count_nonzero(status >= 2)),
        "max_primal_residual": float(rp.max()),
        "max_dual_residual": float(rd.max()),
        "max_iterations": float(iterations.max()),
        "mean_iterations": float(iterations.astype(np.float64).mean()),
    }


def diagnostics_mismatch(program: Dict[str, float], ref: Dict[str, float]) -> bool:
    """Whether a batch's diagnostics differ from those its lanes give: the
    counts and maxima exactly, the fp32 mean of iterations to 2 ulps."""
    for key, want in ref.items():
        got = program[key]
        if key == "mean_iterations":
            if abs(got - want) > 2.0 ** -22 * abs(want):
                return True
        elif got != np.float32(want) and got != want:
            return True
    return False
