"""Batched ADMM on the fused diag-A kernel (K1) and its driver.

The counterpart of the JAX package's ``ops/admm_pallas.py`` for box-only
QPs, whose scaled constraint matrix A_s is square and diagonal (every
input-box-only condensed MPC, the h20 main path included):

- :func:`iterate_chunk_diag_T` runs ``chunk`` ADMM iterations on the lane-
  last state (n, B). On a CUDA tensor it launches the hand-written kernel
  ``csrc/admm_diag.cu``; on a CPU tensor it runs the plain PyTorch version
  :func:`iterate_chunk_diag_T_plain`, the same chunk math, which the CPU
  tests hold against the JAX kernel in interpret mode.
- :func:`solve_batch_fused` is the driver: a Python loop over chunks that,
  between chunks, computes the exact unscaled residuals, applies the OSQP
  rho rule per lane, runs the NaN guard and freezes converged lanes.

``K1_LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` calls of the
plain version, so a run can show which one did the work.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import _build
from .admm import AdmmConfig, AdmmOperator, start_rho_index
from ..types import STATUS_CONVERGED, STATUS_MAX_ITER, STATUS_NUMERIC_ERROR
from ..utils.precision import assert_ieee_fp32

Tensor = torch.Tensor

K1_LAUNCHES = 0
PLAIN_CALLS = 0

# shared memory one block may use on Hopper (227 KB), and the widest n the
# kernel's register layout takes (csrc/admm_diag.cu)
SMEM_LIMIT = 232448
MAX_N = 128
_LANES = 32


def k1_smem_bytes(n: int, R: int, refine_steps: int) -> int:
    """Dynamic shared memory of one K1 block: the K^-1 stack (and K when
    refining) plus two (n, 32) vector buffers, all fp64."""
    stacks = 2 if refine_steps > 0 else 1
    return (stacks * R * n * n + 2 * n * _LANES) * 8


def k1_fits(n: int, R: int, refine_steps: int) -> bool:
    """Whether K1 takes this operator shape (tiling K for larger n is
    later work, ROADMAP Queue 2)."""
    return n <= MAX_N and k1_smem_bytes(n, R, refine_steps) <= SMEM_LIMIT


def iterate_chunk_diag_T_plain(
    op: AdmmOperator,
    qT: Tensor,  # (n, B) scaled, lane-last
    lT: Tensor,
    uT: Tensor,
    idx: Tensor,  # (B,) int32 rho-grid index per lane
    xT: Tensor,
    sT: Tensor,
    yT: Tensor,
    axT: Tensor,
    chunk: int,
    config: AdmmConfig,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K1: all R candidates K_r^-1 rhs as one
    (R*n, n) @ (n, B) matmul, then a per-lane select.

    Like K1, every matrix-vector product is accumulated in fp64 and rounded
    once to fp32 (the state stays fp32): fp32 accumulation leaves about
    three times as many h20 lanes above the 1e-6 certificate after tier 1
    (csrc/admm_diag.cu, "Precision")."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    n, B = qT.shape
    R = int(op.rho_grid.shape[0])
    kicat = op.K_invs.reshape(R * n, n).double()
    kcat = op.Ks.reshape(R * n, n).double()
    d = torch.diagonal(op.A_s)[:, None]
    il = idx.long()
    rho = op.rho_vecs[il].T  # (n, B)
    rho_inv = op.rho_invs[il].T
    pick = il.view(1, 1, B).expand(1, n, B)

    def solve(M, v):  # (R*n, n) @ (n, B) in fp64, the lane's own block, fp32
        return (M @ v.double()).view(R, n, B).gather(0, pick)[0].float()

    sigma, alpha = float(config.sigma), float(config.alpha)
    x, s, y, ax = xT, sT, yT, axT
    for _ in range(int(chunk)):
        rhs = sigma * x - qT - d * y + d * (rho * s)
        xt = solve(kicat, rhs)
        for _ in range(int(config.refine_steps)):
            xt = xt + solve(kicat, rhs - solve(kcat, xt))
        st = d * xt
        x_new = alpha * xt + (1.0 - alpha) * x
        v = alpha * st + (1.0 - alpha) * s
        s_new = torch.clamp(v + rho_inv * y, lT, uT)
        y = y + rho * (v - s_new)
        ax = alpha * st + (1.0 - alpha) * ax
        x, s = x_new, s_new
    return x, s, y, ax


def _launch_k1(op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config):
    global K1_LAUNCHES
    n, B = qT.shape
    R = int(op.rho_grid.shape[0])
    rs = int(config.refine_steps)
    if not k1_fits(n, R, rs):
        raise ValueError(
            f"K1 takes n <= {MAX_N} and an operator stack within "
            f"{SMEM_LIMIT} B of shared memory; n={n}, R={R}, "
            f"refine_steps={rs} needs {k1_smem_bytes(n, R, rs)} B"
        )
    dev = qT.device
    dvec = torch.diagonal(op.A_s).contiguous()
    args = [
        ("K_invs", op.K_invs, (R, n, n), torch.float32),
        ("Ks", op.Ks, (R, n, n), torch.float32),
        ("diag(A_s)", dvec, (n,), torch.float32),
        ("rho_vecs", op.rho_vecs, (R, n), torch.float32),
        ("rho_invs", op.rho_invs, (R, n), torch.float32),
        ("qT", qT, (n, B), torch.float32),
        ("lT", lT, (n, B), torch.float32),
        ("uT", uT, (n, B), torch.float32),
        ("idx", idx, (B,), torch.int32),
        ("xT", xT, (n, B), torch.float32),
        ("sT", sT, (n, B), torch.float32),
        ("yT", yT, (n, B), torch.float32),
        ("axT", axT, (n, B), torch.float32),
    ]
    for name, t, shape, dtype in args:
        if t.device != dev:
            raise ValueError(f"K1: {name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise ValueError(f"K1: {name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"K1: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"K1: {name} is not contiguous")
    outs = [torch.empty_like(xT) for _ in range(4)]
    lib = _build.load_kernels()
    with torch.cuda.device(dev):
        err = lib.admm_diag_chunk(
            *[t.data_ptr() for _, t, _, _ in args],
            *[o.data_ptr() for o in outs],
            n, B, R, int(chunk), rs, float(config.sigma), float(config.alpha),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 (admm_diag_chunk) launch failed: cudaError_t {err}")
    K1_LAUNCHES += 1
    return tuple(outs)


def iterate_chunk_diag_T(
    op: AdmmOperator,
    qT: Tensor,
    lT: Tensor,
    uT: Tensor,
    idx: Tensor,
    xT: Tensor,
    sT: Tensor,
    yT: Tensor,
    axT: Tensor,
    chunk: int,
    config: AdmmConfig,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``chunk`` ADMM iterations of a diag-A QP batch, lane-last (n, B).

    CUDA tensors launch K1 (``csrc/admm_diag.cu``) and raise if it cannot
    run; CPU tensors take the plain version. The state is out of place."""
    kind = qT.device.type
    if kind == "cuda":
        return _launch_k1(op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config)
    if kind == "cpu":
        return iterate_chunk_diag_T_plain(
            op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config
        )
    raise ValueError(f"K1 runs on CUDA (or its plain version on CPU), not {kind}")


def _check_precision(config: AdmmConfig) -> None:
    mode = str(config.kernel_precision)
    if mode in ("bf16x3", "default", "hybrid"):
        raise NotImplementedError(
            f"kernel_precision={mode!r} is not ported yet (ROADMAP Queue 2, "
            "'bf16x3 / default / hybrid kernel precisions'); use 'highest'"
        )
    if mode != "highest":
        raise ValueError(
            f"unknown kernel_precision {mode!r}; valid: 'highest' (ported), "
            "'bf16x3', 'default', 'hybrid'"
        )


ChunkFn = Callable[..., Tuple[Tensor, Tensor, Tensor, Tensor]]


def _solve_batch_fused_diag(
    op: AdmmOperator,
    q: Tensor,  # (B, n) unscaled
    l: Tensor,
    u: Tensor,
    z0: Optional[Tensor],
    y0: Optional[Tensor],
    config: AdmmConfig,
    chunk_fn: ChunkFn,
):
    """Lane-last driver: transposes once at entry and exit; between chunks,
    exact unscaled residuals (P_s @ x as a matmul; A'y and Ax are elementwise
    for a diagonal A), the OSQP per-lane rho rule, the NaN guard and the
    freezing of converged lanes. One host read of ``done`` per chunk."""
    B = q.shape[0]
    R = int(op.rho_grid.shape[0])
    ck = max(1, int(config.check_interval))
    D_c = op.D[:, None]  # (n, 1)
    E_c = op.E[:, None]
    dvec = torch.diagonal(op.A_s)[:, None]
    qT = ((op.c * op.D)[:, None] * q.T).contiguous()
    lT = (E_c * l.T).contiguous()
    uT = (E_c * u.T).contiguous()

    x = torch.zeros_like(qT) if z0 is None else (z0.T / D_c).contiguous()
    y = torch.zeros_like(lT) if y0 is None else (op.c * y0.T / E_c).contiguous()
    ax = dvec * x
    idx = torch.full(
        (B,), start_rho_index(config) if R > 1 else 0, dtype=torch.int32,
        device=q.device,
    )
    rho_inv0 = op.rho_invs[idx.long()].T  # (m, B)
    s = torch.clamp(ax + rho_inv0 * y, lT, uT)

    D_inv = (1.0 / op.D)[:, None]
    E_inv = (1.0 / op.E)[:, None]
    c_inv = 1.0 / op.c
    log_grid = torch.log(op.rho_grid)
    dual_norm_q = (D_inv * qT).abs().amax(0)  # loop constant

    def diagnostics(x, s, y, ax):
        r_prim = (E_inv * (ax - s)).abs().amax(0)
        Px = op.P_s @ x  # P_s symmetric
        Aty = dvec * y
        r_dual = c_inv * (D_inv * (Px + qT + Aty)).abs().amax(0)
        prim_norm = torch.maximum(
            (E_inv * ax).abs().amax(0), (E_inv * s).abs().amax(0)
        )
        dual_norm = c_inv * torch.maximum(
            torch.maximum(
                (D_inv * Px).abs().amax(0), (D_inv * Aty).abs().amax(0)
            ),
            dual_norm_q,
        )
        conv = (r_prim <= config.eps_abs + config.eps_rel * prim_norm) & (
            r_dual <= config.eps_abs + config.eps_rel * dual_norm
        )
        ratio = (r_prim / prim_norm.clamp_min(1e-12)) / (
            r_dual / dual_norm.clamp_min(1e-12)
        ).clamp_min(1e-12)
        finite = torch.isfinite(x.sum(0) + y.sum(0) + s.sum(0))
        return r_prim, r_dual, conv, ratio, finite

    def adapt(idx, ratio, done):
        if R == 1 or not config.adapt_interval:
            return idx
        log_target = log_grid[idx.long()] + 0.5 * torch.log(ratio.clamp(1e-8, 1e8))
        # argmin returns the first minimum, as jnp.argmin does
        idx_new = torch.argmin(
            (log_grid[None, :] - log_target[:, None]).abs(), dim=1
        ).to(torch.int32)
        return torch.where(done, idx, idx_new)

    rp = torch.full((B,), float("inf"), device=q.device)
    rd = torch.full((B,), float("inf"), device=q.device)
    done = torch.zeros((B,), dtype=torch.bool, device=q.device)
    bad = torch.zeros_like(done)
    iters = torch.zeros((B,), dtype=torch.int32, device=q.device)
    it = 0
    while it < config.max_iter and not bool(done.all()):
        x2, s2, y2, ax2 = chunk_fn(op, qT, lT, uT, idx, x, s, y, ax, ck, config)
        # frozen lanes keep their first-converged state (exact iteration counts)
        keep = done[None, :]
        x2 = torch.where(keep, x, x2)
        s2 = torch.where(keep, s, s2)
        y2 = torch.where(keep, y, y2)
        ax2 = torch.where(keep, ax, ax2)
        rp, rd, conv, ratio, finite = diagnostics(x2, s2, y2, ax2)
        bad = bad | (~finite & ~done)
        done2 = done | conv | ~finite
        iters = torch.where(done, iters, torch.full_like(iters, it + ck))
        idx = adapt(idx, ratio, done2)
        x, s, y, ax, done = x2, s2, y2, ax2, done2
        it += ck

    status = torch.where(
        bad,
        STATUS_NUMERIC_ERROR,
        torch.where(done, STATUS_CONVERGED, STATUS_MAX_ITER),
    ).to(torch.int32)
    return (
        (D_c * x).T.contiguous(),
        (E_c * y * c_inv).T.contiguous(),
        (E_inv * s).T.contiguous(),
        status,
        iters,
        rp,
        rd,
    )


def solve_batch_fused(
    op: AdmmOperator,
    q: Tensor,  # (B, n) unscaled
    l: Tensor,  # (B, m)
    u: Tensor,  # (B, m)
    z0: Optional[Tensor] = None,  # (B, n)
    y0: Optional[Tensor] = None,  # (B, m)
    config: AdmmConfig = AdmmConfig(),
    chunk_fn: ChunkFn = iterate_chunk_diag_T,
):
    """Batched QP solve on K1. Returns (z, y, s, status, iterations,
    primal_residual, dual_residual), each with a leading batch axis, on the
    device of ``q``. ``chunk_fn`` is K1's wrapper; the plain version may be
    passed to re-solve on the card for comparison."""
    if op.n_ball:
        raise ValueError("fused kernel does not support ball rows")
    if not op.diag_a:
        raise NotImplementedError(
            "only the diagonal-A kernel (K1) is ported; mixed-A operators need "
            "K2 and dense ones K4/K5 (ROADMAP Queue 2)"
        )
    _check_precision(config)
    if q.device.type == "cuda":
        assert_ieee_fp32()
    return _solve_batch_fused_diag(op, q, l, u, z0, y0, config, chunk_fn)
