"""OSQP-style ADMM operator: configuration, equilibration, factorization.

Solves  min 0.5 z'Pz + q'z  s.t.  l <= A z <= u  (box rows), with an
optional trailing Euclidean-ball block. The KKT matrix
K_r = P_s + sigma I + A_s' diag(rho_r) A_s is inverted once, at design
time, for every rho of a log-spaced grid; the iteration then selects a
grid entry per lane instead of refactorizing.

Scaling conventions (OSQP section 5): P_s = c D P D, q_s = c D q,
A_s = E A D, l_s = E l, u_s = E u; unscale with z = D z_s, y = E y_s / c.

The host part is the JAX package's numpy f64 code, so the stored f32
operator agrees with it bit for bit. The general per-solve engine
(``solve``) is not ported yet (ROADMAP Queue 1, item 4); batched solves
run on the fused kernel (``ops/admm_fused.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..types import TensorRecord, f32

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
    # matmul precision inside the fused kernel. Only "highest" (IEEE fp32)
    # is ported; "bf16x3", "default" and "hybrid" raise NotImplementedError
    # (ROADMAP Queue 2, kernel precisions).
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
