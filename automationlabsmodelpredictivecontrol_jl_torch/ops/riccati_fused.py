"""Batched Riccati-ADMM on the Riccati kernels, and their two drivers.

The counterpart of the JAX package's ``ops/riccati_pallas.py`` and of its
``ops/riccati.solve_sparse``: the long-horizon sparse MPC engine, whose
w-update is an affine backward sweep and a forward rollout over the horizon
with the factors of the current rho (``ops/riccati.py``).

- :func:`iterate_chunk_riccati` runs ``chunk`` ADMM iterations on the
  lane-last state, kernel K3 (``csrc/riccati_chunk.cuh``), laid out for the
  shape by :func:`k3_plan`: the lanes' rows in shared memory for the whole
  chunk beside the current rho's factors (widened to fp64 where they fit,
  else fp32 in shared or device memory), or the rows streamed from device
  memory where not even one lane's fit. K3 keeps a lane's vectors in
  registers, so it takes plants up to (32, 16) (:func:`k3_fits`);
- :func:`iterate_chunk_riccati_wide` and :func:`iterate_chunk_riccati_doubling`
  run the same iterations on K3W, laid out by :func:`k3w_plan`, the
  plant's width a runtime value: the sweeps sequential (the JAX package's
  ``_lqr_affine_solve``; ``csrc/riccati_wide_seq.cu``: a block's lanes
  share each horizon step's factors through a ring in shared memory, a
  thread takes a row of 4 lanes) or in doubling form
  (``_lqr_affine_solve_pscan``: ceil(log2 N) combine levels a sweep;
  ``csrc/riccati_wide.cu``: a block's lanes share each level's operator,
  a thread a register tile of 4 rows x 1-8 lanes of a horizon step);
- :func:`rollout` and :func:`certificate_terms` are the driver's two O(N)
  recurrences (the warm and zero-input rollouts, once per solve; the
  infeasibility certificate's adjoint recursion, every chunk), each a small
  per-lane kernel, K3's or the wide ones (:func:`rollout_wide`,
  :func:`certificate_terms_wide`, laid out by :func:`wide_recurrence_plan`)
  by the plant's tier (``RECURRENCE_ROUTES``), the wide ones past K3's
  tiers, so that no Python loop over the horizon runs between chunks;
- :func:`riccati_chunk_fn` routes a driver's chunks: K3 or K3W by the
  plant's tier (``CHUNK_ROUTES``, an A/B on the card), K3W past K3's
  tiers, and, on the per-lane engine under ``parallel_sweeps``, K3W's
  doubling form;
- :func:`solve_sparse_fused` is the fused driver: a Python loop over chunks
  that, between chunks, computes the residuals, the certificate, the stall
  escalation and the batch-global rho adaptation, and freezes converged
  lanes;
- :func:`solve_sparse` is the per-lane engine (the JAX package's
  ``ops/riccati.solve_sparse``): the same start and tests between checks,
  with each lane's own rho, its chunk launched once per rho that open
  lanes hold.

On a CUDA tensor each wrapper launches its kernel and raises if it cannot;
on a CPU tensor it runs its plain PyTorch version, which forms the same
sums in the same order. Launches and plain calls are counted in
``admm_fused.LAUNCHES`` / ``PLAIN_CALLS`` under "K3", "rollout",
"certificate", "K3W", "K3W-doubling", "rollout-wide" and
"certificate-wide".

The rho index is batch-global and stays on the device: the kernel takes
the whole factor stacks and reads the index itself, where the JAX driver
switches between compiled variants with ``lax.switch``. The JAX driver
pads a batch above 128 lanes to a multiple of 128 with copies of its last
lane, which then take part in the batch-global rho rule; the port does not
pad.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .admm_fused import LAUNCHES, PLAIN_CALLS, SMEM_LIMIT, _check_args, _dispatch, _launch
from .riccati import (
    RiccatiConfig,
    RiccatiOperator,
    _initial_ridx,
    ball_radius,
    box_support,
    dot64,
    lqr_affine_solve_pscan,
    norm64,
    project_X,
    rollout_warm,
)
from ..types import (
    STATUS_CONVERGED,
    STATUS_MAX_ITER,
    STATUS_NUMERIC_ERROR,
    STATUS_PRIMAL_INFEASIBLE,
)

Tensor = torch.Tensor

__all__ = [
    "LAUNCHES", "PLAIN_CALLS", "MAX_NX", "MAX_NU", "k3_fits", "K3_ROUTES", "K3Plan",
    "k3_plan", "certificate_plan", "iterate_chunk_riccati", "iterate_chunk_riccati_plain", "rollout",
    "certificate_terms", "certificate_terms_plain", "K3WPlan", "k3w_plan", "k3w_dbl_floats",
    "k3w_dbl_step",
    "K3WSeqPlan", "k3w_seq_floats", "k3w_seq_operands",
    "iterate_chunk_riccati_wide", "iterate_chunk_riccati_doubling",
    "iterate_chunk_riccati_doubling_plain", "rollout_wide", "certificate_terms_wide",
    "CHUNK_ROUTES", "chunk_kernel", "RECURRENCE_ROUTES", "recurrence_kernel", "WideRecPlan",
    "wide_recurrence_plan", "wide_rec_bytes", "WIDE_REC_RING",
    "riccati_chunk_fn", "solve_sparse_fused", "solve_sparse",
]

# the widest plant the kernels' register arrays take (csrc/riccati_chunk.cuh)
MAX_NX, MAX_NU = 32, 16


def k3_fits(op: RiccatiOperator) -> bool:
    """Whether K3 (and the driver's recurrences) take this plant."""
    return 1 <= op.nx <= MAX_NX and 1 <= op.nu <= MAX_NU


# What K3's and the certificate's blocks are sized for: the SMs of an H100
# SXM, the shared memory of one SM (a block may use SMEM_LIMIT of it; each
# resident block reserves 1 KiB more), the threads of a block (one per lane)
SM_COUNT = 132
SM_SMEM = 233472
BLOCK_THREADS = 128

# K3's routes (csrc/riccati_chunk.cuh), each one instantiation of the kernel:
# where a block keeps its lanes' rows and the factors of the current rho.
# (rows in shared memory, the kernel's fac_mode, where the factors sit, and
# the cost of a horizon step relative to the first route, measured on an
# NVIDIA H100 80GB HBM3, 700.00 W at h500, B=1024 by k3_ab.py)
K3_ROUTES = {
    "shared-fp64": (True, 0, "shared memory, widened to fp64", 1.0),
    "shared-fp32": (True, 1, "shared memory, fp32", 2.3),
    "shared-l2": (True, 2, "device memory through L1/L2, fp32", 2.4),
    "stream": (False, 2, "device memory through L1/L2, fp32", 3.0),
}


class K3Plan(NamedTuple):
    """How one K3 launch is laid out: the route, the lanes and threads of a
    block, its dynamic shared memory, where the factors sit, the blocks of
    the grid, and the two switches the C entry takes."""

    route: str
    lanes: int
    threads: int
    smem_bytes: int
    factors: str
    blocks: int
    rows_shared: bool
    fac_mode: int


def _tier(nx: int, nu: int) -> Tuple[int, int]:
    """The kernels' register tier (MX, MU) of a plant."""
    for mx, mu in ((4, 2), (8, 4), (16, 8), (MAX_NX, MAX_NU)):
        if nx <= mx and nu <= mu:
            return mx, mu
    raise ValueError(f"K3 takes nx <= {MAX_NX} and nu <= {MAX_NU}; nx={nx}, nu={nu}")


def _split_x_rows(op: RiccatiOperator) -> int:
    """The rows of vX and lamX that a lane iterates on: all N past the fixed
    first one when the interior is split, the terminal row when only it is."""
    if op.split_interior:
        return op.N
    return 1 if (op.split_terminal or op.terminal_ball) else 0


def k3_plan(op: RiccatiOperator, B: int, route: Optional[str] = None) -> K3Plan:
    """The layout of a K3 launch for ``B`` lanes, from the shape alone (N,
    nx, nu, which rows are split, B).

    A lane's rows (vU, lamU, ffs and the split rows of vX, lamX; rows that
    are not split are never staged) live in shared memory beside the
    factors of the current rho. A block takes as many lanes as fit, but no
    more than spread the batch over every SM. The factors sit, in order of
    speed, widened to fp64 in shared memory, as fp32 in shared memory, or
    in device memory; where not even one lane's rows fit in shared memory
    the rows stay in device memory ("stream"). Among the routes that fit,
    the one with the least estimated time wins: waves of blocks times the
    warps that share an SM's four schedulers times the route's cost per
    horizon step. Every shape :func:`k3_fits` takes gets a route. ``route``
    forces one (ValueError if it does not fit)."""
    mx, mu = _tier(op.nx, op.nu)
    N, nx, nu = op.N, op.nx, op.nu
    B = int(B)
    if B < 1:
        raise ValueError(f"K3 takes at least one lane; B={B}")
    if route is not None and route not in K3_ROUTES:
        raise ValueError(f"unknown K3 route {route!r}; one of {sorted(K3_ROUTES)}")
    lane_bytes = 4 * (3 * N * nu + 2 * _split_x_rows(op) * nx)
    fac_bytes = {
        0: 8 * (N * (mu * mx + mu * mu + mx * mx) + mx * mx + mx * mu),
        1: -(-4 * (N * (nu * nx + nu * nu + nx * nx) + nx * nx + nx * nu) // 16) * 16,
        2: 0,
    }  # a multiple of 16: the rows behind them are read as vectors
    want = min(max(math.ceil(B / SM_COUNT), 1), BLOCK_THREADS)  # lanes that fill the card
    best = None
    for name, (rows_shared, fac_mode, where, step_cost) in K3_ROUTES.items():
        if route not in (None, name):
            continue
        if rows_shared:
            lanes = min((SMEM_LIMIT - fac_bytes[fac_mode]) // lane_bytes, want)
            if lanes < 1:
                continue
            smem = fac_bytes[fac_mode] + lanes * lane_bytes
        else:
            lanes, smem = want, 0
        blocks = math.ceil(B / lanes)
        per_sm = max(1, min(16, SM_SMEM // (smem + 1024)))
        waves = math.ceil(blocks / (SM_COUNT * per_sm))
        warps = min(per_sm, math.ceil(blocks / SM_COUNT)) * math.ceil(lanes / 32)
        cost = waves * math.ceil(warps / 4) * step_cost
        if best is None or cost < best[0]:
            best = (cost, K3Plan(name, lanes, BLOCK_THREADS, smem, where, blocks,
                                 rows_shared, fac_mode))
    if best is None:
        raise ValueError(f"K3's route {route!r} does not fit N={N}, nx={nx}, nu={nu}")
    return best[1]


def certificate_plan(op: RiccatiOperator, B: int) -> Tuple[int, int, int]:
    """(lanes per block, horizon rows per tile, shared-memory bytes) of a
    certificate launch: lanes that spread the batch over every SM, and as
    many rows of the dual deltas and Xbar as fit in a block's shared memory
    beside the widened plant (the whole horizon where it does)."""
    mx, mu = _tier(op.nx, op.nu)
    lanes = min(max(math.ceil(int(B) / SM_COUNT), 1), BLOCK_THREADS)
    plant = 8 * mx * (mx + mu)
    row_bytes = 4 * lanes * (2 * op.nx + op.nu)
    tile = max(1, min(op.N, (SMEM_LIMIT - plant) // row_bytes))
    return lanes, tile, plant + tile * row_bytes


def _grid_entry(op: RiccatiOperator, ridx: Tensor):
    """The factors and the (rho, 1/rho, rho_t, 1/rho_t) row of the grid
    entry ``ridx`` (1,), gathered on the device (no host read)."""
    i = ridx.long()
    f = op.factors
    return f.K[i][0], f.G[i][0], f.AmBK[i][0], op.rho_tab[:, i]


def _chunk_plain(op, ridx, e0T, ballr, vX, vU, lamX, lamU, chunk, doubling):
    """``chunk`` iterations of the per-lane engine's ADMM iteration (the
    JAX package's ``admm_iter``), lane-last, at grid index ``ridx``: the
    w-update's sweeps sequential (a Python loop over the horizon) or in
    doubling form (``riccati.lqr_affine_solve_pscan``), then the
    projections and dual ascent. Each small product is summed as
    ``riccati.dot64`` does. Returns (X, U, vX, vU, lamX, lamU), out of
    place."""
    N, nu = op.N, op.nu
    K, G, AmBK, (rho, rho_inv, rho_t, rho_t_inv) = _grid_entry(op, ridx)
    A, Bm = op.factors.A, op.factors.B
    # products that share their vector are stacked (each row's sum is
    # unchanged): [B'; (A - B K_k)'] g in the sweep, [K_k; A] e in the rollout
    BtAmBKT = torch.cat([Bm.T.expand(N, -1, -1), AmBK.transpose(1, 2)], dim=1).double()
    KA = torch.cat([K, A.expand(N, -1, -1)], dim=1).double()
    G64, KT64, B64 = G.double(), K.transpose(1, 2).double(), Bm.double()
    nrho = -rho
    col = lambda v: v[:, None]
    si, st = op.split_interior, op.split_terminal
    split_x = si or st

    vX, vU, lamX, lamU = vX.clone(), vU.clone(), lamX.clone(), lamU.clone()
    # rows the engine never lets carry a dual: the fixed e_1 and, when only
    # the terminal row is split, the interior rows
    if not split_x:
        lamX.zero_()
    else:
        lamX[0] = 0.0
        if not si and N > 1:
            lamX[1:N] = 0.0
    for _ in range(int(chunk)):
        g = (-rho_t) * vX[N] + lamX[N] if st else torch.zeros_like(e0T)
        if doubling:
            lin_int = nrho * vX[1:N] + lamX[1:N] if si else torch.zeros_like(vX[1:N])
            X, U = lqr_affine_solve_pscan(op, ridx, e0T, lin_int, g, nrho * vU + lamU)
        else:
            # backward affine sweep
            ffs = [None] * N
            for k in range(N - 1, -1, -1):
                lu = nrho * vU[k] + lamU[k]
                bg_ag = dot64(BtAmBKT[k], g)
                ffs[k] = dot64(G64[k], bg_ag[:nu] + lu)
                g = bg_ag[nu:] - dot64(KT64[k], lu)
                if si and k >= 1:
                    g = g + (nrho * vX[k] + lamX[k])
            # forward rollout
            e, xs, us = e0T, [e0T], []
            for k in range(N):
                ke_ae = dot64(KA[k], e)
                u = -ke_ae[:nu] - ffs[k]
                e = ke_ae[nu:] + dot64(B64, u)
                xs.append(e)
                us.append(u)
            X, U = torch.stack(xs), torch.stack(us)
        # projections and dual ascent: U, the interior X, the terminal row
        vU_new = torch.clamp(U + rho_inv * lamU, col(op.u_lo), col(op.u_hi))
        lamU = lamU + rho * (U - vU_new)
        vU = vU_new
        if si and N > 1:
            Xi = X[1:N]
            vXi = torch.clamp(Xi + rho_inv * lamX[1:N], col(op.x_lo), col(op.x_hi))
            lamX[1:N] = lamX[1:N] + rho * (Xi - vXi)
            vX[1:N] = vXi
        if op.terminal_ball:
            w = X[N] + rho_inv * lamX[N]
            nrm = norm64(w)
            scale = torch.where(nrm > ballr, ballr / torch.clamp_min(nrm, 1e-30), 1.0)
            v = w * scale
            lamX[N] = lamX[N] + rho * (X[N] - v)
            vX[N] = v
        elif st:
            v = torch.clamp(X[N] + rho_t_inv * lamX[N], col(op.xN_lo), col(op.xN_hi))
            lamX[N] = lamX[N] + rho_t * (X[N] - v)
            vX[N] = v
    # rows that are not split mirror X, so the driver's residuals see none
    if not split_x:
        vX = X.clone()
    else:
        vX[0] = e0T
        if not si and N > 1:
            vX[1:N] = X[1:N]
    return X, U, vX, vU, lamX, lamU


def iterate_chunk_riccati_plain(
    op: RiccatiOperator,
    ridx: Tensor,  # (1,) int32 grid index
    e0T: Tensor,  # (nx, B)
    ballr: Tensor,  # (B,)
    vX: Tensor,  # (N+1, nx, B)
    vU: Tensor,  # (N, nu, B)
    lamX: Tensor,
    lamU: Tensor,
    chunk: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K3, with a Python loop over the horizon:
    the JAX kernel's iteration, each small product summed as
    ``riccati.dot64`` does. Returns (X, U, vX, vU, lamX, lamU), out of
    place. K3W's sequential form has the same plain version, counted
    under "K3W" (:func:`iterate_chunk_riccati_wide` on a CPU tensor)."""
    PLAIN_CALLS["K3"] += 1
    return _chunk_plain(op, ridx, e0T, ballr, vX, vU, lamX, lamU, chunk, False)


def _k3w_plain(op, ridx, e0T, ballr, vX, vU, lamX, lamU, chunk):
    PLAIN_CALLS["K3W"] += 1
    return _chunk_plain(op, ridx, e0T, ballr, vX, vU, lamX, lamU, chunk, False)


def iterate_chunk_riccati_doubling_plain(
    op: RiccatiOperator,
    ridx: Tensor,
    e0T: Tensor,
    ballr: Tensor,
    vX: Tensor,
    vU: Tensor,
    lamX: Tensor,
    lamU: Tensor,
    chunk: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K3W's doubling form: the projections and
    dual ascent of :func:`iterate_chunk_riccati_plain`, each w-update by
    ``riccati.lqr_affine_solve_pscan`` (the JAX package's
    ``_lqr_affine_solve_pscan``), whose summation order the kernel
    follows."""
    PLAIN_CALLS["K3W-doubling"] += 1
    return _chunk_plain(op, ridx, e0T, ballr, vX, vU, lamX, lamU, chunk, True)


def _shape_args(op: RiccatiOperator, B: int):
    """The operator's arguments of the kernels, with their shapes."""
    N, nx, nu = op.N, op.nx, op.nu
    R = len(op.rho_grid)
    f = torch.float32
    fac = op.factors
    return [
        ("K", fac.K, (R, N, nu, nx), f),
        ("G", fac.G, (R, N, nu, nu), f),
        ("AmBK", fac.AmBK, (R, N, nx, nx), f),
    ], [("A", fac.A, (nx, nx), f), ("B", fac.B, (nx, nu), f)], [
        ("x_lo", op.x_lo, (nx,), f),
        ("x_hi", op.x_hi, (nx,), f),
        ("xN_lo", op.xN_lo, (nx,), f),
        ("xN_hi", op.xN_hi, (nx,), f),
        ("u_lo", op.u_lo, (nu,), f),
        ("u_hi", op.u_hi, (nu,), f),
    ]


def _require_fits(kernel: str, op: RiccatiOperator) -> None:
    if not k3_fits(op):
        raise ValueError(
            f"{kernel} takes nx <= {MAX_NX} and nu <= {MAX_NU}; nx={op.nx}, nu={op.nu}"
        )


def _flags(op: RiccatiOperator):
    return (int(op.split_interior), int(op.split_terminal), int(op.terminal_ball))


def _launch_k3(op, ridx, e0T, ballr, vX, vU, lamX, lamU, chunk, route=None):
    """Launch K3 as :func:`k3_plan` lays it out (``route`` forces one of
    ``K3_ROUTES``, for the comparisons of the routes)."""
    _require_fits("K3", op)
    if int(chunk) < 1:
        raise ValueError(f"K3 runs at least one iteration; chunk={chunk}")
    N, nx, nu = op.N, op.nx, op.nu
    B = e0T.shape[1]
    plan = k3_plan(op, B, route)
    R = len(op.rho_grid)
    f = torch.float32
    stacks, plant, boxes = _shape_args(op, B)
    args = stacks + plant + boxes + [
        ("rho_tab", op.rho_tab, (4, R), f),
        ("ridx", ridx, (1,), torch.int32),
        ("e0T", e0T, (nx, B), f),
        ("ballr", ballr, (B,), f),
        ("vX", vX, (N + 1, nx, B), f),
        ("vU", vU, (N, nu, B), f),
        ("lamX", lamX, (N + 1, nx, B), f),
        ("lamU", lamU, (N, nu, B), f),
    ]
    _check_args("K3", args, e0T.device)
    # X, U, vX, vU, lamX, lamU, then ffs, a scratch only where the rows stay
    # in device memory
    outs = [torch.empty_like(t) for t in (vX, vU) * 3]
    outs.append(torch.empty_like(vU) if not plan.rows_shared else vU.new_empty(0))
    out = _launch(
        "K3", "riccati_admm_chunk", args, outs,
        (N, nx, nu, B, R, int(chunk), *_flags(op), plan.lanes, int(plan.rows_shared),
         plan.fac_mode, plan.smem_bytes),
    )
    return out[:6]


def iterate_chunk_riccati(
    op: RiccatiOperator,
    ridx: Tensor,
    e0T: Tensor,
    ballr: Tensor,
    vX: Tensor,
    vU: Tensor,
    lamX: Tensor,
    lamU: Tensor,
    chunk: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """``chunk`` Riccati-ADMM iterations of a batch, lane-last, at the
    device-resident grid index ``ridx`` (1,) int32.

    CUDA tensors launch K3 (``csrc/riccati_chunk.cuh``) and raise if it
    cannot run; CPU tensors take the plain version. Returns (X, U, vX, vU,
    lamX, lamU), out of place."""
    return _dispatch(
        "K3", _launch_k3, iterate_chunk_riccati_plain,
        (op, ridx, e0T, ballr, vX, vU, lamX, lamU, chunk),
    )


# K3W's doubling form (csrc/riccati_wide.cu): the lanes a block may take;
# a thread's register tile of K3W_DBL_ROWS rows x LT lanes (LT, the lanes a
# thread, one of K3W_DBL_TILE_LANES); where a launch keeps its lanes' work
# area and state: both in "shared" memory, the state in "device" memory
# (the outputs, in place), or the work area in a device scratch too
# ("global"; the C entry's route 0, 1, 2); the layouts the plan tries, in
# order (route, the slots of its operator ring: none keeps the work area in
# shared memory where a ring would push it to device memory, 23.4 against
# 40.7 ms a chunk at the (64, 32) plant's h30, B = 1024); the items a level's
# product should have before a thread takes more lanes (k3_ab.py --kernel
# K3W-doubling: at h50, B = 1024, 4 lanes a thread, 100 items, 0.47 ms a
# chunk against 0.61 at 1 lane, 400 items); the least whole steps of its
# widest stream a ring slot holds (fewer: the next layout; the (64, 32)
# plant's h30 ran 96.7 ms a chunk on slots of one step, 40.2 on four)
K3W_DBL_LANES = (1, 2, 4, 8, 16, 32)
K3W_DBL_TILE_LANES = (1, 2, 4, 8)
K3W_DBL_ROWS = 4
K3W_DBL_ROUTES = ("shared", "device", "global")
K3W_DBL_LAYOUTS = (("shared", 3), ("device", 3), ("shared", 2), ("device", 2), ("shared", 0),
                   ("device", 0), ("global", 3), ("global", 2), ("global", 0))
K3W_DBL_ITEMS = 64
K3W_DBL_MIN_STEPS = 4
# the layouts without a ring (the operators read where they lie, through
# L1/L2), tried first at the QTP's width (the kernel's compile-time (4, 2)
# instantiation: 1.70 against 2.06 ms a chunk at h500, B = 1024, with the
# ring of bulk copies; 0.656 against 0.834 at B = 1; 0.256 against 0.387 at
# h24, B = 77; k3_ab.py --kernel K3W-doubling on an NVIDIA H100 80GB HBM3,
# 700.00 W) and elsewhere where one rho's operators of an iteration take at
# most K3W_DBL_L1_BYTES (they stay in the SM's L1 from one iteration to the
# next)
K3W_DBL_L1_LAYOUTS = (("shared", 0), ("device", 0), ("global", 0))
K3W_DBL_L1_BYTES = 64 * 1024


def k3w_dbl_max_threads(lanes_per_thread: int) -> int:
    """The most threads of a doubling block (``dbl_max_threads`` of
    csrc/riccati_wide.cu): 256 where a thread takes 8 lanes (its tile needs
    more than 128 registers), else 512."""
    return 256 if lanes_per_thread == 8 else 512


class K3WPlan(NamedTuple):
    """How one launch of K3W's doubling form is laid out: the lanes of a
    block (one rho's: every operator panel serves them all), its threads,
    the lanes of a thread's tile, the slots of the operator ring and the
    floats of a slot (a panel of whole horizon steps), where the lanes'
    work area and state lie (``K3W_DBL_ROUTES``), the block's dynamic
    shared memory, the blocks of the grid and the floats of the "global"
    route's device scratch (0 on the others)."""

    lanes: int
    threads: int
    lanes_per_thread: int
    ring: int
    panel: int
    route: str
    smem_bytes: int
    blocks: int
    scratch_floats: int


def _ceil32(n: int) -> int:
    return -(-int(n) // 32) * 32


def _pad4(n: int) -> int:
    return -(-int(n) // 4) * 4


def _dbl_stride(rows: int, lanes: int, lt: int) -> int:
    unit = min(lt, 4)
    s = rows * lanes
    return s + unit if (s // unit) % 2 == 0 else s


# the kernel's compile-time instantiation of the QTP's width (dbl_qtp of
# csrc/riccati_wide.cu)
K3W_DBL_TIER = (4, 2)


def k3w_dbl_operator_floats(N: int, nx: int, nu: int) -> int:
    """The operator floats one doubling iteration reads at one rho: K twice,
    the combine levels' rows (step k >= 2^l of level l) and the prefix
    products of both sweeps, and G."""
    levels = sum(N - 2 ** l for l in range(max(N - 1, 0).bit_length()))
    return 2 * N * nu * nx + 2 * (levels + N) * nx * nx + N * nu * nu


def k3w_dbl_step(nx: int, nu: int) -> int:
    """The least panel of a doubling ring: one step of its widest stream,
    at the odd stride a step takes in a slot."""
    return max(nx * nx, nu * nx, nu * nu) | 1


def k3w_dbl_floats(N: int, nx: int, nu: int, xrows: int, lanes: int, lanes_per_thread: int,
                   ring: int, panel: int, route: str) -> Tuple[int, int]:
    """(the work area's floats, the block's shared-memory floats) of a
    doubling block, as ``dbl_layout`` of csrc/riccati_wide.cu lays them out
    (the C entry refuses shared-memory bytes that differ). The work area:
    the two horizon buffers and ff (and s where nu > K3W_DBL_ROWS), each N
    steps [row][lane] at a padded stride, lin_xN and e0 [row][lane], the
    ball's scale; shared memory: the ring, the plant's B, the work area
    where it is not in the device scratch, the lanes' state (vU, lamU, the
    split rows of vX, lamX) on the "shared" route."""
    ks = _dbl_stride(nx, lanes, lanes_per_thread)
    ku = _dbl_stride(nu, lanes, lanes_per_thread)
    work = 2 * N * ks + N * ku + (N * ku if nu > K3W_DBL_ROWS else 0) + 2 * nx * lanes + lanes
    work = _pad4(work)
    total = ring * panel + _pad4(nx * nu) + (work if route != "global" else 0)
    if route == "shared":
        total += (2 * N * nu + 2 * xrows * nx) * lanes
    return work, total


def _k3w_dbl_plan(op: RiccatiOperator, B: int, route: Optional[str], lanes: Optional[int],
                  ring: Optional[int], threads: Optional[int], lanes_per_thread: Optional[int],
                  panel: Optional[int]) -> K3WPlan:
    N, nx, nu = op.N, op.nx, op.nu
    if route not in (None, *K3W_DBL_ROUTES):
        raise ValueError(f"unknown K3W route {route!r}; one of {sorted(K3W_DBL_ROUTES)}")
    if lanes is None:  # the fewest lanes that spread the batch over every SM
        want = math.ceil(B / SM_COUNT)
        lanes = next((n for n in K3W_DBL_LANES if n >= want), K3W_DBL_LANES[-1])
    elif lanes not in K3W_DBL_LANES:
        raise ValueError(f"K3W's doubling form takes one of {K3W_DBL_LANES} lanes a block; "
                         f"lanes={lanes}")
    groups = -(-nx // K3W_DBL_ROWS)  # a step's row groups
    lt = lanes_per_thread
    if lt is None:  # the widest tile that leaves a level K3W_DBL_ITEMS items
        lt = next((t for t in (8, 4, 2) if t <= lanes
                   and N * groups * (lanes // t) >= K3W_DBL_ITEMS), 1)
    elif lt not in K3W_DBL_TILE_LANES or lanes % lt:
        raise ValueError(f"K3W's doubling form takes a tile of {K3W_DBL_TILE_LANES} lanes that "
                         f"divides the block's {lanes}; lanes_per_thread={lt}")
    most = k3w_dbl_max_threads(lt)
    if threads is None:  # about one item of a level a thread
        threads = max(32, min(_ceil32(N * groups * (lanes // lt)), most))
    elif threads % 32 or not max(32, lanes) <= threads <= most:
        raise ValueError(f"K3W's doubling form takes a multiple of 32 threads, {max(32, lanes)} "
                         f"to {most}; threads={threads}")
    big = k3w_dbl_step(nx, nu)
    whole = _pad4(N * big)  # the longest stream in one panel
    xrows = _split_x_rows(op)
    layouts = K3W_DBL_LAYOUTS
    small = 4 * k3w_dbl_operator_floats(N, nx, nu) <= K3W_DBL_L1_BYTES
    if ring == 0 or (ring is None and ((nx, nu) == K3W_DBL_TIER or small)):
        layouts = K3W_DBL_L1_LAYOUTS + layouts
    for where, depth in layouts:
        if route not in (None, where) or ring not in (None, depth):
            continue
        work, fixed = k3w_dbl_floats(N, nx, nu, xrows, lanes, lt, depth, 0, where)
        room = SMEM_LIMIT // 4 - fixed
        if depth == 0:  # no ring, no panel
            pan = 0 if panel in (None, 0) else -1
            if pan or room < 0:
                continue
        else:
            pan = panel if panel is not None else min(whole, room // depth // 4 * 4)
            least = big if panel is not None else min(whole, K3W_DBL_MIN_STEPS * big)
            if pan < least or pan % 4 or depth * pan > room:
                continue
        blocks = math.ceil(B / lanes)
        return K3WPlan(lanes, threads, lt, depth, pan, where, 4 * (fixed + depth * pan), blocks,
                       blocks * work if where == "global" else 0)
    raise ValueError(f"K3W's doubling layout (route {route!r}, ring {ring!r}, panel {panel!r}, "
                     f"{lanes} lanes) does not fit N={N}, nx={nx}, nu={nu}")


# K3W's sequential form (csrc/riccati_wide_seq.cu): a thread takes 4 lanes
# of a row; a block takes 4, 8, 16 or 32 lanes and at most 256 threads
K3W_SEQ_LANES, K3W_SEQ_MAX_THREADS = (4, 8, 16, 32), 256
# where a sequential launch keeps the lanes' horizon state: in "shared"
# memory, in "device" memory (the outputs themselves), or there with the
# step's vectors in a device scratch too ("global"; the C entry's route 0,
# 1, 2)
K3W_SEQ_ROUTES = ("shared", "device", "global")
# the layouts the plan tries, in order: (route, the horizon steps its ring
# holds (0: the factors are read through L1/L2), the plant in shared memory)
K3W_SEQ_LAYOUTS = (
    ("shared", 3, True), ("shared", 2, True), ("device", 3, True), ("device", 2, True),
    ("device", 2, False), ("device", 0, False), ("global", 0, False),
)


class K3WSeqPlan(NamedTuple):
    """How one launch of K3W's sequential form is laid out: where the lanes'
    horizon state lies (``K3W_SEQ_ROUTES``), the lanes of a block (one of
    ``K3W_SEQ_LANES``), its threads, the horizon steps of its factor ring,
    whether the plant sits in shared memory, the block's dynamic shared
    memory, the blocks of the grid, and the floats of the "global" route's
    device scratch (0 on the others)."""

    route: str
    lanes: int
    threads: int
    ring: int
    plant_shared: bool
    smem_bytes: int
    blocks: int
    scratch_floats: int


def k3w_seq_floats(N: int, nx: int, nu: int, xrows: int, lanes: int, ring: int,
                   plant_shared: bool, state_shared: bool) -> Tuple[int, int]:
    """(the step vectors' floats, the block's floats) of a sequential K3W
    block, as ``seq_layout`` of csrc/riccati_wide_seq.cu lays them out (the
    C entry refuses shared-memory bytes that differ): fp64 g, lu, e (two
    buffers each), u, s and fp32 lu (two), A e, e0 and the ball's scale, a
    lane each; then the ring's steps (K_k and A - B K_k, or K_k' and G_k',
    each padded to 4 floats), the plant (B, A', B') and the lanes' state
    (vU, lamU, s and the split rows of vX, lamX) where they sit in shared
    memory."""
    p4 = lambda n: -(-n // 4) * 4
    work = lanes * (10 * nx + 10 * nu + 1)
    slot = p4(nu * nx) + p4(max(nx * nx, nu * nu))
    total = work + ring * slot
    if plant_shared:
        total += 2 * p4(nx * nu) + p4(nx * nx)
    if state_shared:
        total += (3 * N * nu + 2 * xrows * nx) * lanes
    return work, total


def _k3w_seq_plan(op: RiccatiOperator, B: int, route: Optional[str], lanes: Optional[int],
                  ring: Optional[int]) -> K3WSeqPlan:
    N, nx, nu = op.N, op.nx, op.nu
    if route not in (None, *K3W_SEQ_ROUTES):
        raise ValueError(f"unknown K3W route {route!r}; one of {sorted(K3W_SEQ_ROUTES)}")
    if lanes is None:  # lanes that spread the batch over every SM
        want = math.ceil(B / SM_COUNT)
        lanes = next((n for n in K3W_SEQ_LANES if n >= want), K3W_SEQ_LANES[-1])
    elif lanes not in K3W_SEQ_LANES:
        raise ValueError(f"K3W takes one of {K3W_SEQ_LANES} lanes a block; lanes={lanes}")
    threads = min(_ceil32((nu + nx) * (lanes // 4)), K3W_SEQ_MAX_THREADS)
    blocks = math.ceil(B / lanes)
    xrows = _split_x_rows(op)
    for where, depth, plant in K3W_SEQ_LAYOUTS:
        if route not in (None, where) or ring not in (None, depth):
            continue
        work, total = k3w_seq_floats(N, nx, nu, xrows, lanes, depth, plant, where == "shared")
        if where == "global":
            return K3WSeqPlan(where, lanes, threads, 0, False, 0, blocks, blocks * work)
        if 4 * total <= SMEM_LIMIT:
            return K3WSeqPlan(where, lanes, threads, depth, plant, 4 * total, blocks, 0)
    raise ValueError(f"K3W's layout (route {route!r}, ring {ring!r}, {lanes} lanes) does not "
                     f"fit N={N}, nx={nx}, nu={nu}")


def k3w_plan(op: RiccatiOperator, B: int, doubling: bool = False, route: Optional[str] = None,
             lanes: Optional[int] = None, ring: Optional[int] = None,
             threads: Optional[int] = None, lanes_per_thread: Optional[int] = None,
             panel: Optional[int] = None):
    """The layout of a K3W launch for ``B`` lanes, from the shape alone.

    The sequential form (a :class:`K3WSeqPlan`): a block takes the lanes
    that spread the batch over every SM (4, 8, 16 or 32), one
    rho's lanes sharing each horizon step's factors; its threads run over
    (row, 4 lanes). The first of ``K3W_SEQ_LAYOUTS`` whose shared memory
    fits wins: the lanes' horizon state in shared memory beside a ring of
    3, then 2 steps; else in device memory; the plant out of shared memory
    and the ring shrunk to nothing last; "global" (no shared memory) takes
    any shape. ``route``, ``lanes`` and ``ring`` force a layout (ValueError
    where it does not fit).

    The doubling form (a :class:`K3WPlan`): a block takes the lanes that
    spread the batch over every SM (one of ``K3W_DBL_LANES``), so that one
    copy of each operator panel serves them all; a thread takes a tile of
    4 rows x ``lanes_per_thread`` lanes of a horizon step, the widest (8,
    4, 2) that leaves a combine level ``K3W_DBL_ITEMS`` items, else 1; the
    block about one item a thread, at most ``k3w_dbl_max_threads``. The
    first of ``K3W_DBL_LAYOUTS`` that fits wins: the lanes' work area and
    state in shared memory, then the state in device memory, beside a ring
    of 3, then 2 slots, then without a ring; last the work area in device
    memory too ("global", any shape). A slot holds the longest operator
    stream where it fits,
    else as many whole steps as the shared memory leaves, and at least
    ``K3W_DBL_MIN_STEPS`` steps of the widest stream. At the QTP's
    width, and where one rho's operators of an iteration take at most
    ``K3W_DBL_L1_BYTES``, the same routes without a ring come first
    (``K3W_DBL_L1_LAYOUTS``: the blocks read them where they lie, through
    L1/L2; ring = panel = 0), the faster on the card. Every argument forces its part of a
    layout (ValueError where it does not fit or is not one the kernel
    takes)."""
    N, nx, nu = op.N, op.nx, op.nu
    B = int(B)
    if B < 1 or nx < 1 or nu < 1:
        raise ValueError(f"K3W takes at least one lane, state and input; B={B}, nx={nx}, nu={nu}")
    if doubling:
        return _k3w_dbl_plan(op, B, route, lanes, ring, threads, lanes_per_thread, panel)
    if (threads, lanes_per_thread, panel) != (None, None, None):
        raise ValueError("K3W's sequential form takes no forced threads, tile or panel")
    return _k3w_seq_plan(op, B, route, lanes, ring)


def k3w_seq_operands(op: RiccatiOperator) -> dict:
    """K_k' and G_k' (every rho and step) and A', B' as K3W's sequential form
    reads them (csrc/riccati_wide_seq.cu: the rollout's products read their
    matrices by column), contiguous fp32 on the operator's device. Built
    once per operator and kept on it (a new operator, as ``op.to`` or
    ``replace`` make, builds its own)."""
    cache = op.__dict__.get("_k3w_seq_operands")
    if cache is None:
        f = op.factors
        cache = dict(KT=f.K.transpose(-1, -2).contiguous(), GT=f.G.transpose(-1, -2).contiguous(),
                     AT=f.A.T.contiguous(), BT=f.B.T.contiguous())
        op.__dict__["_k3w_seq_operands"] = cache
    return cache


def _level_args(op: RiccatiOperator):
    N, nx = op.N, op.nx
    R, L = op.bwd_levels.shape[:2]
    f = torch.float32
    return [
        ("bwd_levels", op.bwd_levels, (R, L, N, nx, nx), f),
        ("bwd_full", op.bwd_full, (R, N, nx, nx), f),
        ("fwd_levels", op.fwd_levels, (R, L, N, nx, nx), f),
        ("fwd_full", op.fwd_full, (R, N, nx, nx), f),
    ]


def _launch_k3w(op, ridx, e0T, ballr, vX, vU, lamX, lamU, chunk, doubling=False, route=None,
                plan=None):
    """Launch K3W, sequential or in doubling form, as :func:`k3w_plan`
    lays it out (``route`` forces one of its routes, ``plan`` a whole
    layout)."""
    kernel = "K3W-doubling" if doubling else "K3W"
    if int(chunk) < 1:
        raise ValueError(f"{kernel} runs at least one iteration; chunk={chunk}")
    N, nx, nu = op.N, op.nx, op.nu
    B = e0T.shape[1]
    if plan is None:
        plan = k3w_plan(op, B, doubling, route)
    R = len(op.rho_grid)
    f = torch.float32
    (K, G, AmBK), (_, Bm), boxes = _shape_args(op, B)
    lanes = [
        ("rho_tab", op.rho_tab, (4, R), f),
        ("ridx", ridx, (1,), torch.int32),
        ("e0T", e0T, (nx, B), f),
        ("ballr", ballr, (B,), f),
        ("vX", vX, (N + 1, nx, B), f),
        ("vU", vU, (N, nu, B), f),
        ("lamX", lamX, (N + 1, nx, B), f),
        ("lamU", lamU, (N, nu, B), f),
    ]
    # X, U, vX, vU, lamX, lamU, then the scratch where the layout has one
    outs = [torch.empty_like(t) for t in (vX, vU) * 3]
    if doubling:
        L = int(op.bwd_levels.shape[1])
        args = [K, G, Bm] + _level_args(op) + boxes + lanes
        outs.append(e0T.new_empty(plan.scratch_floats))
        entry = "riccati_wide_chunk"
        ints = (N, nx, nu, B, R, L, int(chunk), *_flags(op), plan.lanes, plan.threads,
                plan.lanes_per_thread, plan.ring, plan.panel, K3W_DBL_ROUTES.index(plan.route),
                plan.smem_bytes)
    else:
        ops = k3w_seq_operands(op)
        args = [K, ("K'", ops["KT"], (R, N, nx, nu), f), ("G'", ops["GT"], (R, N, nu, nu), f),
                AmBK, Bm, ("A'", ops["AT"], (nx, nx), f), ("B'", ops["BT"], (nu, nx), f)]
        args += boxes + lanes
        outs.append(e0T.new_empty(plan.scratch_floats))
        entry = "riccati_wide_seq_chunk"
        ints = (N, nx, nu, B, R, int(chunk), *_flags(op), plan.lanes, plan.threads, plan.ring,
                int(plan.plant_shared), K3W_SEQ_ROUTES.index(plan.route), plan.smem_bytes)
    _check_args(kernel, args, e0T.device)
    return _launch(kernel, entry, args, outs, ints)[:6]


def iterate_chunk_riccati_wide(
    op: RiccatiOperator,
    ridx: Tensor,
    e0T: Tensor,
    ballr: Tensor,
    vX: Tensor,
    vU: Tensor,
    lamX: Tensor,
    lamU: Tensor,
    chunk: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """:func:`iterate_chunk_riccati` for a plant of any width: K3W's
    sequential form (csrc/riccati_wide_seq.cu) on CUDA tensors (raises if it
    cannot run), the plain version on CPU ones."""
    return _dispatch(
        "K3W", _launch_k3w, _k3w_plain, (op, ridx, e0T, ballr, vX, vU, lamX, lamU, chunk),
    )


def iterate_chunk_riccati_doubling(
    op: RiccatiOperator,
    ridx: Tensor,
    e0T: Tensor,
    ballr: Tensor,
    vX: Tensor,
    vU: Tensor,
    lamX: Tensor,
    lamU: Tensor,
    chunk: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The same iterations with the sweeps in doubling form (the JAX
    package's ``parallel_sweeps``): K3W-doubling on CUDA tensors (raises if
    it cannot run), :func:`iterate_chunk_riccati_doubling_plain` on CPU
    ones."""
    launch = lambda *a: _launch_k3w(*a, doubling=True)
    return _dispatch(
        "K3W-doubling", launch, iterate_chunk_riccati_doubling_plain,
        (op, ridx, e0T, ballr, vX, vU, lamX, lamU, chunk),
    )


# Which kernel runs the sequential chunk of a plant K3 takes, by K3's
# register tier: the faster one at the tier's widest plant on the card at
# every batch the drivers launch. ms per 25-iteration chunk, K3 / K3W on
# the same inputs, at B = 1, 256, 1024 (2048 at (32, 16)); k3_ab.py
# --kernel K3-K3W on an NVIDIA H100 80GB HBM3, 700.00 W:
#   (4, 2) QTP h500  3.65 / 34.36, 3.62 / 34.38, 3.71 / 34.51
#   (4, 2) QTP h50   0.39 / 3.49, 0.39 / 3.49, 0.40 / 3.47 (B=4096 0.40 / 3.43)
#   (8, 4) h30       0.53 / 2.45, 0.53 / 2.46, 0.56 / 2.47
#   (16, 8) h30      1.63 / 3.11, 1.66 / 3.12, 1.64 / 3.08
#   (32, 16) h30     39.01 / 4.46, 48.51 / 4.47, 55.76 / 4.00
# No batch crosses over, so the batch does not enter the choice.
CHUNK_ROUTES = {(4, 2): "K3", (8, 4): "K3", (16, 8): "K3", (MAX_NX, MAX_NU): "K3W"}


# Which kernels run the drivers' rollout and certificate of a plant K3
# takes, by K3's register tier: K3's own ("K3": riccati_rollout,
# riccati_certificate) or the wide ones ("wide": rollout_wide,
# certificate_terms_wide). At (32, 16), h30, ms a launch, rollout /
# certificate, K3's against the wide ones on the same inputs at the
# riccati-wide-nx32 cell's B = 2048, 256 and 1 (k3_ab.py --kernel wide-rec
# on an NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6):
#   K3    1.027 / 0.544, 1.025 / 0.485, 1.020 / 0.473
#   wide  0.0495 / 0.0458, 0.0349 / 0.0266, 0.0368 / 0.0263
# The narrower tiers keep K3's (not measured against the wide ones); past
# K3's tiers the wide ones run.
RECURRENCE_ROUTES = {(4, 2): "K3", (8, 4): "K3", (16, 8): "K3", (MAX_NX, MAX_NU): "wide"}


def recurrence_kernel(op: RiccatiOperator) -> str:
    """"K3" or "wide": the kernels of ``op``'s rollout and certificate, from
    ``RECURRENCE_ROUTES`` (the wide ones past K3's widest tier)."""
    return RECURRENCE_ROUTES[_tier(op.nx, op.nu)] if k3_fits(op) else "wide"


def chunk_kernel(op: RiccatiOperator) -> str:
    """"K3" or "K3W": the kernel of ``op``'s sequential chunk, from
    ``CHUNK_ROUTES`` (K3W past K3's widest tier)."""
    return CHUNK_ROUTES[_tier(op.nx, op.nu)] if k3_fits(op) else "K3W"


def riccati_chunk_fn(op: RiccatiOperator, config: RiccatiConfig, driver: str) -> "ChunkFn":
    """The chunk a driver launches: on the per-lane engine (``driver=
    "per-lane"``) K3W's doubling form under ``config.parallel_sweeps``;
    otherwise (and on the fused driver, ``"fused"``, which does not read
    ``parallel_sweeps``, as the JAX package's fused kernel does not) the
    sequential chunk on the kernel :func:`chunk_kernel` picks: K3 or K3W
    by the plant's tier, K3W past K3's tiers."""
    if driver not in ("per-lane", "fused"):
        raise ValueError(f"unknown Riccati driver {driver!r}; one of ['fused', 'per-lane']")
    if driver == "per-lane" and config.parallel_sweeps:
        return iterate_chunk_riccati_doubling
    return iterate_chunk_riccati if chunk_kernel(op) == "K3" else iterate_chunk_riccati_wide


def _rollout_plain(op, e0T, U):
    PLAIN_CALLS["rollout"] += 1
    return rollout_warm(op, e0T, U)


def _launch_rollout(op, e0T, U):
    _require_fits("the rollout kernel", op)
    N, nx, nu = op.N, op.nx, op.nu
    B = e0T.shape[1]
    f = torch.float32
    _, plant, _ = _shape_args(op, B)
    args = plant + [("e0T", e0T, (nx, B), f), ("U", U, (N, nu, B), f)]
    _check_args("rollout", args, e0T.device)
    X = torch.empty((N + 1, nx, B), dtype=f, device=e0T.device)
    return _launch("rollout", "riccati_rollout", args, [X], (N, nx, nu, B))[0]


def rollout(op: RiccatiOperator, e0T: Tensor, U: Tensor) -> Tensor:
    """X (N+1, nx, B) of the input plan U (N, nu, B) from e0T (nx, B):
    the rollout kernel on a CUDA tensor, ``riccati.rollout_warm`` on a CPU
    one."""
    return _dispatch("rollout", _launch_rollout, _rollout_plain, (op, e0T, U))


def certificate_terms_plain(op, lamX_new, lamX_old, lamU_new, lamU_old, Xbar, ballr):
    """Plain PyTorch version of the certificate kernel (the JAX driver's
    ``infeas_cert`` up to its final comparisons): (3, B) rows max_k |r_k|,
    the support value, max |dlam|. Also the wide certificate's plain
    version, counted under "certificate-wide"."""
    PLAIN_CALLS["certificate"] += 1
    return _certificate_plain(op, lamX_new, lamX_old, lamU_new, lamU_old, Xbar, ballr)


def _certificate_plain(op, lamX_new, lamX_old, lamU_new, lamU_old, Xbar, ballr):
    dlx = lamX_new - lamX_old
    dlu = lamU_new - lamU_old
    nu = op.nu
    BtAt = torch.cat([op.factors.B.T, op.factors.A.T]).double()  # [B'; A'] g at once
    g = dlx[op.N]
    ortho = torch.zeros_like(ballr)
    for k in range(op.N - 1, -1, -1):
        bg_ag = dot64(BtAt, g)
        ortho = torch.maximum(ortho, (bg_ag[:nu] + dlu[k]).abs().amax(0))
        g = bg_ag[nu:] + dlx[k]
    s_c = box_support(dlu, op.u_lo, op.u_hi)
    if op.split_interior:
        s_c = s_c + box_support(dlx[1:-1], op.x_lo, op.x_hi)
    if op.terminal_ball:
        s_c = s_c + ballr * norm64(dlx[-1])
    elif op.split_terminal:
        s_c = s_c + box_support(dlx[-1:], op.xN_lo, op.xN_hi)
    support = s_c - (dlx.double() * Xbar.double()).sum(dim=(0, 1)).float()
    dnorm = torch.maximum(dlx.abs().amax(dim=(0, 1)), dlu.abs().amax(dim=(0, 1)))
    return torch.stack([ortho, support, dnorm])


def _launch_certificate(op, lamX_new, lamX_old, lamU_new, lamU_old, Xbar, ballr, tile=None):
    """Launch the certificate kernel as :func:`certificate_plan` lays it out
    (``tile`` forces the horizon rows staged at a time)."""
    _require_fits("the certificate kernel", op)
    N, nx, nu = op.N, op.nx, op.nu
    B = ballr.shape[0]
    f = torch.float32
    _, plant, boxes = _shape_args(op, B)
    args = plant + boxes + [
        ("lamX_new", lamX_new, (N + 1, nx, B), f),
        ("lamX_old", lamX_old, (N + 1, nx, B), f),
        ("lamU_new", lamU_new, (N, nu, B), f),
        ("lamU_old", lamU_old, (N, nu, B), f),
        ("Xbar", Xbar, (N + 1, nx, B), f),
        ("ballr", ballr, (B,), f),
    ]
    _check_args("certificate", args, ballr.device)
    out = torch.empty((3, B), dtype=f, device=ballr.device)
    lanes, planned, _ = certificate_plan(op, B)
    tile = planned if tile is None else min(int(tile), planned)
    return _launch(
        "certificate", "riccati_certificate", args, [out],
        (N, nx, nu, B, *_flags(op), lanes, tile),
    )[0]


def certificate_terms(
    op: RiccatiOperator,
    lamX_new: Tensor,
    lamX_old: Tensor,
    lamU_new: Tensor,
    lamU_old: Tensor,
    Xbar: Tensor,
    ballr: Tensor,
) -> Tensor:
    """The primal-infeasibility certificate's terms of each lane, from the
    dual deltas over a check block (the consensus splitting's version of
    Banjac et al. 2019, as ``ops/riccati.py`` of the JAX package derives
    it): (3, B) rows

    - max_k |B' g_{k+1} + dlamU_k| along the adjoint recursion g_k = A' g_{k+1}
      + dlamX_k from g_N = dlamX_N (orthogonality to the dynamics);
    - S_C(dlam) - <dlamX, Xbar>, the box and ball support less the
      zero-input rollout's term (separation);
    - max |dlam|.

    The certificate kernel on CUDA tensors, its plain version on CPU ones."""
    return _dispatch(
        "certificate", _launch_certificate, certificate_terms_plain,
        (op, lamX_new, lamX_old, lamU_new, lamU_old, Xbar, ballr),
    )


def _rollout_wide_plain(op, e0T, U):
    PLAIN_CALLS["rollout-wide"] += 1
    return rollout_warm(op, e0T, U)


# The drivers' wide rollout and certificate (csrc/riccati_wide_rec.cu): the
# lanes a block may take; a thread's register tile of (rows, lanes), the
# kernel's instantiations in the order the plan tries them (the first that
# leaves a block WIDE_REC_MIN_THREADS threads, else (1, 1), the one with
# the most: a lane's rows spread over the threads); the most threads of a block
# (more row groups: a thread loops over them); where the operators sit, in
# the order tried (widened to fp64 in shared memory, fp32 there, read
# through L1/L2; the C entry's place); where the lane buffers lie (shared
# memory, or a device scratch: one lane, the (1, 1) tile, the operators
# through L1/L2; the C entry's route)
WIDE_REC_KERNELS = ("rollout", "certificate")
WIDE_REC_LANES = (1, 2, 4, 8, 16, 32)
WIDE_REC_TILES = ((2, 2), (1, 1))
WIDE_REC_MIN_THREADS = 128
WIDE_REC_MAX_THREADS = 512
WIDE_REC_PLACES = ("fp64", "fp32", "global")
WIDE_REC_ROUTES = ("shared", "device")
# the rollout's slots of U in a block (kRing of csrc/riccati_wide_rec.cu:
# the one a step reads, and the one the next step's U goes to where it
# ends)
WIDE_REC_RING = 2


class WideRecPlan(NamedTuple):
    """How one launch of the wide rollout or certificate is laid out: the
    lanes of a block, its threads, a thread's tile of rows x lanes, where
    the operators sit (``WIDE_REC_PLACES``), where the lane buffers lie
    (``WIDE_REC_ROUTES``), the block's dynamic shared memory, the blocks of
    the grid and the floats of the "device" route's scratch (0 on the
    other)."""

    kernel: str
    lanes: int
    threads: int
    rows_per_thread: int
    lanes_per_thread: int
    place: str
    route: str
    smem_bytes: int
    blocks: int
    scratch_floats: int


def _a16(n: int) -> int:
    return -(-int(n) // 16) * 16


def wide_rec_bytes(kernel: str, nx: int, nu: int, lanes: int, rows_per_thread: int,
                   threads: int, place: str, route: str) -> Tuple[int, int]:
    """(the lane buffers' bytes, the block's shared-memory bytes) of a wide
    rollout or certificate block, as ``rollout_layout`` /
    ``certificate_layout`` of csrc/riccati_wide_rec.cu lay them out (the C
    entry refuses other bytes): the operators [j][row] (fp64 or fp32; none
    through L1/L2), rows padded to the tile; the certificate's reduction
    (4 fp64 and 2 fp32 partials a warp and lane); the lane buffers (the
    rollout: e in fp64, two slots, a step's U in fp32, ``WIDE_REC_RING``
    slots, B u_{k+1}; the certificate: g in fp64, two slots), in shared
    memory on the "shared" route."""
    x, u, l, rt = int(nx), int(nu), int(lanes), int(rows_per_thread)
    pad = lambda n: -(-n // rt) * rt
    width = {"fp64": 8, "fp32": 4, "global": 0}[place]
    if kernel == "rollout":
        ops = _a16(width * (x + u) * pad(x))
        red = 0
        lane = _a16(16 * x * l) + _a16(4 * WIDE_REC_RING * u * l) + _a16(4 * pad(x) * l)
    else:
        ops = _a16(width * x * (pad(x) + pad(u)))
        red = _a16(40 * (int(threads) // 32) * l)
        lane = _a16(16 * x * l)
    return lane, ops + red + (lane if route == "shared" else 0)


def _wide_rec_rows(kernel: str, nx: int, nu: int, rt: int) -> int:
    """The row groups of a tile space: A e's rows, or A' g's and B' g's."""
    groups = -(-nx // rt)
    return groups + (-(-nu // rt) if kernel == "certificate" else 0)


def wide_recurrence_plan(op: RiccatiOperator, B: int, kernel: str = "rollout",
                         lanes: Optional[int] = None, place: Optional[str] = None,
                         route: Optional[str] = None, rows_per_thread: Optional[int] = None,
                         lanes_per_thread: Optional[int] = None,
                         threads: Optional[int] = None) -> WideRecPlan:
    """The layout of a wide rollout or certificate launch (``kernel``) for
    ``B`` lanes, from the shape alone.

    A block takes the fewest of ``WIDE_REC_LANES`` that spread the batch
    over every SM, so that one staging of the operators serves them all; a
    thread the (2, 2) tile where it leaves the block ``WIDE_REC_MIN_THREADS``
    threads, else the (1, 1) tile (at B = 1 a lane's rows spread over the
    threads), with one thread a (row group, lane group) up to
    ``WIDE_REC_MAX_THREADS``. On an H100 (scripts/wide_rec_phase_probe.py,
    PERF.md section 6) the (2, 2) tile ran as fast as or faster than the
    (4, 1), (4, 2) and (2, 1) tiles forced at (64, 32) h30, B = 1024 and at
    (32, 16) h30, B = 2048, and (1, 1) ran 1.7-2.7x faster than (4, 1) at
    B = 1; other shapes were not timed. The operators sit widened to fp64 in
    shared memory where they fit, else in fp32, each at those lanes or down
    to a quarter of them; else through L1/L2 at any lanes down to one; where
    not even one lane's buffers fit shared memory, they lie in a device
    scratch (route "device"), so that every width is taken. Every argument
    forces its part of a layout (ValueError where it does not fit or is not
    one the kernel takes)."""
    N, nx, nu = op.N, op.nx, op.nu
    B = int(B)
    if kernel not in WIDE_REC_KERNELS:
        raise ValueError(f"unknown wide recurrence {kernel!r}; one of {list(WIDE_REC_KERNELS)}")
    if B < 1 or nx < 1 or nu < 1 or N < 1:
        raise ValueError(f"the wide {kernel} takes at least one lane, step, state and input; "
                         f"B={B}, N={N}, nx={nx}, nu={nu}")
    if place not in (None, *WIDE_REC_PLACES):
        raise ValueError(f"unknown placement {place!r}; one of {list(WIDE_REC_PLACES)}")
    if route not in (None, *WIDE_REC_ROUTES):
        raise ValueError(f"unknown route {route!r}; one of {list(WIDE_REC_ROUTES)}")
    if lanes is not None and lanes not in WIDE_REC_LANES:
        raise ValueError(f"the wide {kernel} takes one of {WIDE_REC_LANES} lanes a block; "
                         f"lanes={lanes}")
    tiles = WIDE_REC_TILES
    if rows_per_thread is not None or lanes_per_thread is not None:
        tiles = tuple(t for t in tiles if rows_per_thread in (None, t[0])
                      and lanes_per_thread in (None, t[1]))
        if not tiles:
            raise ValueError(f"the wide {kernel} takes a tile of {WIDE_REC_TILES}; "
                             f"({rows_per_thread}, {lanes_per_thread})")
    if threads is not None and (threads % 32 or not 32 <= threads <= WIDE_REC_MAX_THREADS):
        raise ValueError(f"the wide {kernel} takes a multiple of 32 threads, 32 to "
                         f"{WIDE_REC_MAX_THREADS}; threads={threads}")
    want = math.ceil(B / SM_COUNT)
    top = next((n for n in WIDE_REC_LANES if n >= want), WIDE_REC_LANES[-1])
    for where in WIDE_REC_ROUTES:
        if route not in (None, where):
            continue
        for pl in WIDE_REC_PLACES if where == "shared" else ("global",):
            if place not in (None, pl):
                continue
            if lanes is not None:
                options = (lanes,)
            elif where == "device":
                options = (1,)
            else:  # fp64 / fp32 down to a quarter of the lanes, unless forced
                least = 1 if (pl == "global" or place is not None) else max(1, top // 4)
                options = tuple(n for n in reversed(WIDE_REC_LANES) if least <= n <= top)
            for L in options:
                fits = [t for t in tiles if t[1] <= L]
                if where == "device":
                    fits = [t for t in fits if t == (1, 1)] if L == 1 else []
                if not fits:
                    continue
                rows = lambda t: _wide_rec_rows(kernel, nx, nu, t[0]) * (L // t[1])
                rt, lt = next((t for t in fits if rows(t) >= WIDE_REC_MIN_THREADS), fits[-1])
                T = threads or min(_ceil32(rows((rt, lt))), WIDE_REC_MAX_THREADS)
                lane_bytes, smem = wide_rec_bytes(kernel, nx, nu, L, rt, T, pl, where)
                if smem > SMEM_LIMIT:
                    continue
                blocks = math.ceil(B / L)
                return WideRecPlan(kernel, L, T, rt, lt, pl, where, smem, blocks,
                                   blocks * lane_bytes // 4 if where == "device" else 0)
    raise ValueError(f"the wide {kernel}'s layout (lanes {lanes!r}, place {place!r}, route "
                     f"{route!r}, tile ({rows_per_thread}, {lanes_per_thread})) does not fit "
                     f"nx={nx}, nu={nu}")


def _rec_ints(plan: WideRecPlan):
    return (plan.lanes, plan.threads, plan.rows_per_thread, plan.lanes_per_thread,
            WIDE_REC_PLACES.index(plan.place), WIDE_REC_ROUTES.index(plan.route),
            plan.smem_bytes)


def _launch_rollout_wide(op, e0T, U, plan=None):
    """Launch the wide rollout as :func:`wide_recurrence_plan` lays it out
    (``plan`` forces a layout). It reads A' and B' by row
    (:func:`k3w_seq_operands`)."""
    N, nx, nu = op.N, op.nx, op.nu
    B = e0T.shape[1]
    if plan is None:
        plan = wide_recurrence_plan(op, B, "rollout")
    f = torch.float32
    ops = k3w_seq_operands(op)
    args = [("A'", ops["AT"], (nx, nx), f), ("B'", ops["BT"], (nu, nx), f),
            ("e0T", e0T, (nx, B), f), ("U", U, (N, nu, B), f)]
    _check_args("rollout-wide", args, e0T.device)
    X = torch.empty((N + 1, nx, B), dtype=f, device=e0T.device)
    outs = [X, e0T.new_empty(plan.scratch_floats)]
    return _launch("rollout-wide", "riccati_wide_rollout", args, outs,
                   (N, nx, nu, B, *_rec_ints(plan)))[0]


def rollout_wide(op: RiccatiOperator, e0T: Tensor, U: Tensor) -> Tensor:
    """:func:`rollout` for a plant of any width: the wide rollout kernel
    (csrc/riccati_wide_rec.cu) on a CUDA tensor, ``riccati.rollout_warm`` on
    a CPU one."""
    return _dispatch("rollout-wide", _launch_rollout_wide, _rollout_wide_plain, (op, e0T, U))


def _certificate_wide_plain(op, lamX_new, lamX_old, lamU_new, lamU_old, Xbar, ballr):
    PLAIN_CALLS["certificate-wide"] += 1
    return _certificate_plain(op, lamX_new, lamX_old, lamU_new, lamU_old, Xbar, ballr)


def _launch_certificate_wide(op, lamX_new, lamX_old, lamU_new, lamU_old, Xbar, ballr,
                             plan=None):
    """Launch the wide certificate as :func:`wide_recurrence_plan` lays it
    out (``plan`` forces a layout)."""
    N, nx, nu = op.N, op.nx, op.nu
    B = ballr.shape[0]
    if plan is None:
        plan = wide_recurrence_plan(op, B, "certificate")
    f = torch.float32
    _, plant, boxes = _shape_args(op, B)
    args = plant + boxes + [
        ("lamX_new", lamX_new, (N + 1, nx, B), f),
        ("lamX_old", lamX_old, (N + 1, nx, B), f),
        ("lamU_new", lamU_new, (N, nu, B), f),
        ("lamU_old", lamU_old, (N, nu, B), f),
        ("Xbar", Xbar, (N + 1, nx, B), f),
        ("ballr", ballr, (B,), f),
    ]
    _check_args("certificate-wide", args, ballr.device)
    out = torch.empty((3, B), dtype=f, device=ballr.device)
    outs = [out, ballr.new_empty(plan.scratch_floats)]
    return _launch("certificate-wide", "riccati_wide_certificate", args, outs,
                   (N, nx, nu, B, *_flags(op), *_rec_ints(plan)))[0]


def certificate_terms_wide(
    op: RiccatiOperator,
    lamX_new: Tensor,
    lamX_old: Tensor,
    lamU_new: Tensor,
    lamU_old: Tensor,
    Xbar: Tensor,
    ballr: Tensor,
) -> Tensor:
    """:func:`certificate_terms` for a plant of any width: the wide
    certificate kernel (csrc/riccati_wide_rec.cu) on CUDA tensors, the
    plain version on CPU ones."""
    return _dispatch(
        "certificate-wide", _launch_certificate_wide, _certificate_wide_plain,
        (op, lamX_new, lamX_old, lamU_new, lamU_old, Xbar, ballr),
    )


ChunkFn = Callable[..., Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]]


def _lane_last(t: Tensor) -> Tensor:
    return t.to(torch.float32).permute(1, 2, 0).contiguous()


def _lane_first(t: Tensor) -> Tensor:
    return t.permute(2, 0, 1).contiguous()


def _start(op: RiccatiOperator, e0s: Tensor, warm_U: Optional[Tensor],
           warm_lam: Optional[Tuple[Tensor, Tensor]]):
    """Both drivers' start, lane-last: e0T (nx, B), the terminal ball's
    radius, the zero-input rollout Xbar (the certificate's anchor on the
    dynamics), and the state (X, U, vX, vU, lamX, lamU): the warm input
    plan (zeros where none) and its rollout, the warm duals, and the
    projected copies."""
    N, nu = op.N, op.nu
    f = torch.float32
    zeros = lambda: torch.zeros((N, nu, e0s.shape[0]), dtype=f, device=e0s.device)
    e0T = e0s.to(f).T.contiguous()
    ballr = ball_radius(op, e0T)
    roll = rollout if recurrence_kernel(op) == "K3" else rollout_wide
    U = zeros() if warm_U is None else _lane_last(warm_U)
    X = roll(op, e0T, U)
    if warm_lam is None:
        lamX, lamU = torch.zeros_like(X), torch.zeros_like(U)
    else:
        lamX, lamU = (_lane_last(t) for t in warm_lam)
    vX = project_X(op, X, ballr)
    vU = torch.clamp(U, op.u_lo[:, None], op.u_hi[:, None])
    Xbar = roll(op, e0T, zeros())
    return e0T, ballr, Xbar, (X, U, vX, vU, lamX, lamU)


def _amax(t: Tensor) -> Tensor:
    return t.abs().amax(dim=(0, 1))


def _check(op: RiccatiOperator, config: RiccatiConfig, new, old, rp_prev, rho, Xbar, ballr):
    """Both drivers' tests per lane after a check block that ended in
    ``new`` (X, U, vX, vU, lamX, lamU) from ``old`` at rho (one, or one a
    lane): the primal and dual residuals, whether X and U are finite, the
    infeasibility certificate (a separating functional on the block's dual
    delta, never a guess from slow progress), whether the primal residual
    stalled against the last check's ``rp_prev``, and convergence."""
    X, U, vX, vU, lamX, lamU = new
    vX0, vU0, lamX0, lamU0 = old[2:]
    rp = _amax(U - vU)
    rd = rho * _amax(vU - vU0)
    if op.split_interior or op.split_terminal:
        rp = torch.maximum(_amax(X - vX), rp)
        rd = torch.maximum(rho * _amax(vX - vX0), rd)
    scale = torch.maximum(_amax(U), torch.clamp_min(_amax(X), 1e-6))
    tol = config.eps_abs + config.eps_rel * scale
    finite = torch.isfinite(U.sum(dim=(0, 1)) + X.sum(dim=(0, 1)))
    terms = certificate_terms if recurrence_kernel(op) == "K3" else certificate_terms_wide
    ortho, support, dnorm = terms(op, lamX, lamX0, lamU, lamU0, Xbar, ballr)
    eps = config.eps_infeas
    cert = (dnorm > 1e-9) & (ortho <= eps * dnorm) & (support <= -eps * dnorm)
    stalled = (rp > 10.0 * tol) & ((rp_prev - rp).abs() <= 1e-3 * rp)
    conv = (rp <= tol) & (rd <= tol * rho)
    return rp, rd, finite, cert, stalled, conv


def _log_ratio(op: RiccatiOperator, new, rp: Tensor, rd: Tensor) -> Tensor:
    """The OSQP rule's log of (rp / prim_norm) / (rd / dual_norm) per lane,
    clamped to [1e-8, 1e8] before the log."""
    X, U, vX, vU, lamX, lamU = new
    prim_norm = torch.maximum(_amax(U), _amax(vU))
    dual_norm = _amax(lamU)
    if op.split_interior or op.split_terminal:
        prim_norm = torch.maximum(prim_norm, torch.maximum(_amax(X), _amax(vX)))
        dual_norm = torch.maximum(dual_norm, _amax(lamX))
    ratio = (rp / torch.clamp_min(prim_norm, 1e-6)) / torch.clamp_min(
        rd / torch.clamp_min(dual_norm, 1e-6), 1e-12
    )
    return torch.log(torch.clamp(ratio, 1e-8, 1e8))


def _result(op: RiccatiOperator, state, bad, infeas, done, iters, rp, rd):
    """Both drivers' return, lane first: U projected onto its box, the
    status from the numeric, certificate and convergence flags."""
    X, U, _, _, lamX, lamU = state
    status = torch.where(
        bad,
        STATUS_NUMERIC_ERROR,
        torch.where(infeas, STATUS_PRIMAL_INFEASIBLE, torch.where(done, STATUS_CONVERGED, STATUS_MAX_ITER)),
    ).to(torch.int32)
    U_out = torch.clamp(U, op.u_lo[:, None], op.u_hi[:, None])
    return (
        _lane_first(X),
        _lane_first(U_out),
        status,
        iters,
        rp,
        rd,
        (_lane_first(lamX), _lane_first(lamU)),
    )


def solve_sparse_fused(
    op: RiccatiOperator,
    e0s: Tensor,  # (B, nx)
    warm_U: Optional[Tensor] = None,  # (B, N, nu)
    warm_lam: Optional[Tuple[Tensor, Tensor]] = None,  # ((B, N+1, nx), (B, N, nu))
    config: RiccatiConfig = RiccatiConfig(),
    chunk_fn: Optional[ChunkFn] = None,
):
    """Batched sparse solves on K3 or K3W (``CHUNK_ROUTES``), on the device of
    ``e0s``. Returns (X (B, N+1, nx), U (B, N, nu), status (B,),
    iterations (B,), rp (B,), rd (B,), (lamX, lamU)), as the JAX package's
    ``solve_sparse_fused``. ``chunk_fn`` defaults to
    ``riccati_chunk_fn(op, config, "fused")``; a plain version may be
    passed to re-solve on the card for comparison.

    Between chunks: residuals, the per-lane certificate verdict, the stall
    escalation and the OSQP rho rule, both batch-global, and the freezing
    of finished lanes; one host read (all lanes done?) per chunk."""
    fn = riccati_chunk_fn(op, config, "fused") if chunk_fn is None else chunk_fn
    dev = e0s.device
    B = e0s.shape[0]
    R = len(op.rho_grid)
    top = R - 1
    adapt = int(config.adapt_interval or 0)
    ck = max(1, int(config.check_interval))
    grid = op.rho_tab[0]  # (R,) float32
    log_grid = torch.log(grid)

    e0T, ballr, Xbar, state = _start(op, e0s, warm_U, warm_lam)
    ridx = torch.full((1,), _initial_ridx(op, config), dtype=torch.int32, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    rp = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    rd = torch.full_like(rp, float("inf"))
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    stall = torch.zeros_like(iters)
    bad = torch.zeros_like(done)
    infeas = torch.zeros_like(done)
    it = 0
    while it < config.max_iter and not bool(done.all()):
        rho = grid[ridx.long()]  # (1,)
        out = fn(op, ridx, e0T, ballr, *state[2:], ck)
        keep = done[None, None, :]
        new = [torch.where(keep, a, b) for a, b in zip(state, out)]

        rp2, rd2, finite, cert, stalled, conv = _check(op, config, new, state, rp, rho, Xbar, ballr)
        # a stall only escalates rho
        cert = cert & ~done
        stall_tmp = torch.where(done, stall, torch.where(stalled, stall + 1, 0))
        esc = (~done & (stall_tmp >= config.stall_checks)).any() & (ridx < top)  # (1,)
        stall = torch.where(esc, 0, stall_tmp)
        bad = bad | (~finite & ~done)
        infeas = infeas | cert
        done2 = done | conv | ~finite | cert
        iters = torch.where(done, iters, it + ck).to(torch.int32)

        # batch-global rho adaptation (OSQP section 5.2): the mean normalized
        # log-ratio over the lanes still active picks the next grid entry
        ridx2 = ridx
        if R > 1 and adapt and (it + ck) % adapt < ck:
            active = ~done2
            n_act = torch.clamp_min(active.sum(), 1)
            mean_lr = torch.where(active, _log_ratio(op, new, rp2, rd2), 0.0).sum() / n_act
            log_t = torch.log(rho) + 0.5 * mean_lr
            ridx_t = torch.argmin((log_grid - log_t).abs()).to(torch.int32).view(1)
            ridx2 = torch.where(active.any(), ridx_t, ridx)
        # stall escalation wins the block over the adaptation rule
        ridx = torch.where(esc, torch.clamp_max(ridx2 + 1, top), ridx2)

        state = new
        rp, rd, done = rp2, rd2, done2
        it += ck

    return _result(op, state, bad, infeas, done, iters, rp, rd)


def solve_sparse(
    op: RiccatiOperator,
    e0s: Tensor,  # (B, nx) initial deviations
    warm_U: Optional[Tensor] = None,  # (B, N, nu)
    warm_lam: Optional[Tuple[Tensor, Tensor]] = None,  # ((B, N+1, nx), (B, N, nu))
    config: RiccatiConfig = RiccatiConfig(),
    chunk_fn: Optional[ChunkFn] = None,
):
    """The per-lane engine: the JAX package's ``solve_sparse`` for every
    lane of a batch (its ``vmap``), on the device of ``e0s``. Returns what
    :func:`solve_sparse_fused` returns.

    Each lane keeps its own grid rho: every ``adapt_interval`` iterations
    the OSQP rule moves it, and ``stall_checks`` stalled checks move it one
    entry up. The chunk (``riccati_chunk_fn(op, config, "per-lane")``: K3
    or K3W by ``CHUNK_ROUTES``, K3W's doubling form under
    ``parallel_sweeps``; or ``chunk_fn``) takes one rho for its whole launch, so
    each check runs one launch per rho that open lanes hold, on those
    lanes gathered along the lane axis: at most R launches, and no loop
    over the horizon in Python. The tests between checks are the fused
    driver's, per lane. A lane that is done keeps its state; the loop ends
    when every lane is done or at ``max_iter``, with one host read per
    check (the lanes in each rho group, and the done lanes). The status
    comes from the last finite test, the certificates and the convergence
    tests."""
    fn = riccati_chunk_fn(op, config, "per-lane") if chunk_fn is None else chunk_fn
    dev = e0s.device
    B = e0s.shape[0]
    R = len(op.rho_grid)
    top = R - 1
    adapt = int(config.adapt_interval or 0)
    ck = max(1, int(config.check_interval))
    grid = op.rho_tab[0]  # (R,) float32
    log_grid = torch.log(grid)

    e0T, ballr, Xbar, state = _start(op, e0s, warm_U, warm_lam)
    group_idx = [torch.full((1,), r, dtype=torch.int32, device=dev) for r in range(R)]
    ridx = torch.full((B,), _initial_ridx(op, config), dtype=torch.int32, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    rp = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    rd = torch.full_like(rp, float("inf"))
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    stall = torch.zeros_like(iters)
    infeas = torch.zeros_like(done)
    it = 0
    while it < config.max_iter:
        # open lanes by rho index, done lanes last: the one host read
        key = torch.where(done, R, ridx).long()
        counts = torch.bincount(key, minlength=R + 1).tolist()
        if counts[R] == B:
            break
        order = torch.argsort(key, stable=True)
        new = list(state)
        start = 0
        for r in range(R):
            cnt = counts[r]
            if cnt == B:  # one group holds every lane: no gather
                new = list(fn(op, group_idx[r], e0T, ballr, *state[2:], ck))
            elif cnt:
                lanes = order[start:start + cnt]
                pick = lambda t: t.index_select(t.dim() - 1, lanes)
                out = fn(op, group_idx[r], pick(e0T), ballr[lanes], *map(pick, state[2:]), ck)
                new = [t.index_copy(t.dim() - 1, lanes, o) for t, o in zip(new, out)]
            start += cnt

        rho = grid[ridx.long()]  # (B,)
        rp2, rd2, finite, cert, stalled, conv = _check(op, config, new, state, rp, rho, Xbar, ballr)
        # a stall only walks the lane's rho up the grid
        stall_tmp = torch.where(stalled, stall + 1, 0)
        esc = (stall_tmp >= config.stall_checks) & (ridx < top)
        stall2 = torch.where(esc, 0, stall_tmp)
        done2 = conv | ~finite | cert
        ridx2 = ridx
        if R > 1 and adapt and (it + ck) % adapt < ck:
            # OSQP section 5.2 per lane: the grid entry nearest
            # rho sqrt(rp_n / rd_n)
            log_t = torch.log(rho) + 0.5 * _log_ratio(op, new, rp2, rd2)
            near = torch.argmin((log_grid[None, :] - log_t[:, None]).abs(), dim=1)
            ridx2 = torch.where(done2, ridx, near.to(torch.int32))
        ridx3 = torch.where(esc, torch.clamp_max(ridx2 + 1, top), ridx2)

        # lanes done before this check kept their state above; they keep
        # their counters here
        keep = done
        state = new
        ridx = torch.where(keep, ridx, ridx3).to(torch.int32)
        iters = torch.where(keep, iters, it + ck).to(torch.int32)
        rp = torch.where(keep, rp, rp2)
        rd = torch.where(keep, rd, rd2)
        stall = torch.where(keep, stall, stall2).to(torch.int32)
        infeas = infeas | (cert & ~keep)
        done = keep | done2
        it += ck

    X, U = state[:2]
    bad = ~torch.isfinite(U.sum(dim=(0, 1)) + X.sum(dim=(0, 1)))
    return _result(op, state, bad, infeas, done, iters, rp, rd)
