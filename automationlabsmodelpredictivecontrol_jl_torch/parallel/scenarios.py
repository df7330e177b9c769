"""Batched scenario solves: many initial states, one controller.

The port of the JAX package's ``parallel/scenarios.py``:

- :func:`solve_batch_fused` solves a batch on a fused kernel: K1 for a
  diagonal A (input boxes only), K2 for a mixed one (state-box or
  terminal rows after the input boxes), K4 or K5 for a dense one (rows
  that are not box-first), K3 for a Riccati engine (the long-horizon
  sparse solve; K3W past K3's (32, 16));
- :func:`solve_batch` solves a batch on the engines themselves
  (``runtime.solve_lanes``): the general ADMM engine for a condensed
  engine, the per-lane Riccati engine (on K3, K3W past (32, 16), K3W's
  doubling form under ``parallel_sweeps``) for a Riccati one, one
  batched SQP over all lanes for an SQP engine (a learned or fuzzy plant),
  one batched EMPC for an economic engine, and the MILP engine's fleet of
  host threads;
- :func:`solve_batch_auto` routes a batch to the fused path wherever a
  kernel takes the shape and to :func:`solve_batch` elsewhere (soft or
  ball rows, operators wider than the kernels take);
- :func:`solve_batch_escalated` and :func:`make_escalated_solver` close the
  straggler tail in tiers: the controller's config on the fused kernel,
  then the unconverged lanes gathered on the device into a static bucket
  and continued on a wider rho grid with refinement (a Riccati engine's
  lanes restarted on the per-lane engine), then the host f64 oracle;
- :func:`closed_loop_batch` runs the receding-horizon loop over a plant;
- :func:`make_mesh` and :func:`solve_sharded` split a batch over the ranks
  of a ``torch.distributed`` process group (the JAX package's
  ``shard_map`` over a device mesh), each rank solving its rows on its own
  device, and all-reduce the fleet's diagnostics.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import native_qp
from ..design import LinearEngine, MpcController, RiccatiEngine
from ..ops import admm as admm_ops
from ..ops import admm_fused, riccati_fused
from ..ops.condense import runtime_qp_vectors_batch
from ..runtime import linear_solution, riccati_solution, riccati_warm, solve_lanes
from ..solvers.milp import MilpEngine
from ..solvers.sqp import true_objective
from ..types import (
    STATUS_CONVERGED,
    STATUS_MAX_ITER,
    STATUS_NUMERIC_ERROR,
    MpcSolution,
    TensorRecord,
)

Tensor = torch.Tensor

SCENARIO_AXIS = "scenario"


@dataclasses.dataclass(frozen=True)
class BatchDiagnostics(TensorRecord):
    """Fleet-level solve diagnostics (0-d tensors on the solve's device)."""

    n_total: Tensor
    n_converged: Tensor
    n_max_iter: Tensor
    n_infeasible: Tensor
    max_primal_residual: Tensor
    max_dual_residual: Tensor
    mean_iterations: Tensor
    max_iterations: Tensor


def _diagnostics(sol: MpcSolution) -> BatchDiagnostics:
    status = sol.status
    i32 = torch.int32
    return BatchDiagnostics(
        n_total=torch.tensor(status.shape[0], dtype=i32, device=status.device),
        n_converged=(status == STATUS_CONVERGED).sum().to(i32),
        n_max_iter=(status == STATUS_MAX_ITER).sum().to(i32),
        n_infeasible=(status >= 2).sum().to(i32),
        max_primal_residual=sol.primal_residual.max(),
        max_dual_residual=sol.dual_residual.max(),
        mean_iterations=sol.iterations.to(torch.float32).mean(),
        max_iterations=sol.iterations.max().to(i32),
    )


def init_warm_batch(controller: MpcController, batch: int) -> Tuple[Tensor, Tensor]:
    """Broadcast the controller's warm state over a scenario batch."""
    return (
        controller.warm_z.expand(batch, -1),
        controller.warm_y.expand(batch, -1),
    )


def _redispatch(status: Tensor) -> Tensor:
    """Lanes a later tier re-solves: MAX_ITER and NUMERIC_ERROR (an
    infeasibility certificate is final)."""
    return (status == STATUS_MAX_ITER) | (status == STATUS_NUMERIC_ERROR)


def solve_batch(
    controller: MpcController,
    x0s: Tensor,  # (B, nx)
    warm_z: Optional[Tensor] = None,  # (B, n)
    warm_y: Optional[Tensor] = None,  # (B, m)
) -> Tuple[MpcSolution, Tensor, Tensor, BatchDiagnostics]:
    """Batched solves on the controller's engine itself, on the device of
    ``x0s``: the general ADMM engine (a condensed engine), the per-lane
    Riccati engine (a Riccati one), the SQP or the EMPC over all lanes at
    once, the JAX package's vmapped ``solve_once``; a MILP engine's lanes
    run on the host, in threads (``solvers/milp.solve_milp_batch``), and
    its warm pair comes back as it went in. Same contract as
    :func:`solve_batch_fused`."""
    if warm_z is None or warm_y is None:
        warm_z, warm_y = init_warm_batch(controller, x0s.shape[0])
    sol, wz, wy = solve_lanes(controller, x0s, warm_z, warm_y)
    return sol, wz, wy, _diagnostics(sol)


def solve_batch_fused(
    controller: MpcController,
    x0s: Tensor,  # (B, nx)
    warm_z: Optional[Tensor] = None,  # (B, n)
    warm_y: Optional[Tensor] = None,  # (B, m)
    chunk_fn: Optional[Callable] = None,
) -> Tuple[MpcSolution, Tensor, Tensor, BatchDiagnostics]:
    """Batched linear-MPC solves on K1, K2, K4 or K5 (a condensed engine) or
    K3 or K3W (a Riccati engine), on the device of ``x0s``.

    Returns (solutions with a leading batch axis, next warm_z, next
    warm_y, diagnostics). For a condensed engine warm_z is the shifted
    primal and warm_y the raw dual; for a Riccati engine both are shifted
    receding-horizon carries (U; lamX, lamU). ``chunk_fn`` as in
    ``ops.admm_fused.solve_batch_fused`` or
    ``ops.riccati_fused.solve_sparse_fused``. With a hard state
    constraint, a lane whose x0 lies outside the state box reports
    STATUS_PRIMAL_INFEASIBLE."""
    engine = controller.engine
    if isinstance(engine, RiccatiEngine):
        if warm_z is None or warm_y is None:
            warm_z, warm_y = init_warm_batch(controller, x0s.shape[0])
        return _solve_batch_fused_riccati(controller, x0s, warm_z, warm_y, chunk_fn)
    if not isinstance(engine, LinearEngine):
        raise ValueError("fused path requires a linear engine")
    if engine.soft_mu is not None:
        raise ValueError("fused path does not support soft rows")
    B = x0s.shape[0]
    if warm_z is None or warm_y is None:
        warm_z, warm_y = init_warm_batch(controller, B)

    e0s = x0s - controller.tuning.references.x[:, 0][None]
    qv, lv, uv, _, _ = runtime_qp_vectors_batch(engine.qp, e0s)
    z, y, _, status, iters, rp, rd = admm_fused.solve_batch_fused(
        engine.op, qv, lv, uv, warm_z, warm_y, config=engine.config,
        chunk_fn=chunk_fn,
    )
    sol, wz_next = linear_solution(controller, x0s, z, status, iters, rp, rd)
    return sol, wz_next, y, _diagnostics(sol)


def _solve_batch_fused_riccati(
    controller: MpcController,
    x0s: Tensor,  # (B, nx)
    warm_z: Tensor,  # (B, N*nu)
    warm_y: Tensor,  # (B, (N+1)*nx + N*nu)
    chunk_fn: Optional[Callable],
) -> Tuple[MpcSolution, Tensor, Tensor, BatchDiagnostics]:
    """Batched sparse solves on K3 or K3W: the deviation shift, the x0-box
    status, the objective, and the shifted warm carry of U, lamX, lamU."""
    engine = controller.engine
    e0s = x0s - controller.tuning.references.x[:, 0][None]
    U0, lams0 = riccati_warm(engine.op, warm_z, warm_y)
    X, U, status, iters, rp, rd, lams = riccati_fused.solve_sparse_fused(
        engine.op, e0s, warm_U=U0, warm_lam=lams0, config=engine.config, chunk_fn=chunk_fn,
    )
    sol, wz, wy = riccati_solution(controller, x0s, X, U, status, iters, rp, rd, lams)
    return sol, wz, wy, _diagnostics(sol)


def fused_supported(controller: MpcController) -> bool:
    """The port's routing rule: fused wherever a kernel takes the shape. A
    linear engine without soft or ball rows whose operator is diagonal and
    fits K1, or mixed and fits K2 (on their shared route, every rho's
    operators in one block's shared memory, or on their stream route, n and
    a dense tail of up to 1024 rows: every width the JAX package's
    ``fused_fits`` takes), or dense and fits the kernel that ``use_packed``
    picks, K4 or K5 (on their shared and stream routes up to n = 128 and
    512 rows, on their wide route n <= 1024 and up to 4096 rows: every
    dense shape ``fused_fits`` takes), as the JAX package's
    ``_kernel_viable`` takes a dense operator. A Riccati engine on any
    plant: K3 takes it up to (32, 16), K3W (``csrc/riccati_wide.cu``, the
    plant's width a runtime value) past that. Never an SQP, economic or
    MILP engine (no kernel takes their per-lane operators or host search).
    The JAX package's bands were measured on other hardware and are not
    copied (it routes its Riccati engine to the vmapped engine); bands for
    this card come from its own A/B runs."""
    eng = controller.engine
    if isinstance(eng, RiccatiEngine):
        return True
    if not isinstance(eng, LinearEngine):
        return False
    op = eng.op
    if eng.soft_mu is not None or op.n_ball != 0:
        return False
    m, n = (int(d) for d in op.A_s.shape)
    R = int(op.rho_grid.shape[0])
    rs = int(eng.config.refine_steps)
    if op.diag_a:
        return admm_fused.k1_fits(n, R, rs)
    if op.mixed_a:
        return admm_fused.k2_fits(n, m, R, rs)
    if admm_fused.use_packed(n, m, R, rs):
        return admm_fused.k4_fits(n, m, R)
    return admm_fused.k5_fits(n, m, R)


def solve_batch_auto(
    controller: MpcController,
    x0s: Tensor,
    warm_z: Optional[Tensor] = None,
    warm_y: Optional[Tensor] = None,
) -> Tuple[MpcSolution, Tensor, Tensor, BatchDiagnostics]:
    """Batch solve on the fused kernel where :func:`fused_supported`, on
    :func:`solve_batch` elsewhere; same contract as
    :func:`solve_batch_fused`."""
    if fused_supported(controller):
        return solve_batch_fused(controller, x0s, warm_z, warm_y)
    return solve_batch(controller, x0s, warm_z, warm_y)


@dataclasses.dataclass(frozen=True)
class ScenarioMesh:
    """The ranks a scenario batch is split over: ``group`` (a
    ``torch.distributed`` process group, or None for this process alone),
    its size ``n``, this process's ``rank`` in it (-1 outside it) and the
    name of the scenario ``axis``."""

    group: Optional[object]
    n: int
    rank: int
    axis: str = SCENARIO_AXIS


def make_mesh(n_devices: Optional[int] = None, axis: str = SCENARIO_AXIS) -> ScenarioMesh:
    """A 1-D mesh of ranks over the scenario axis.

    The caller initialises ``torch.distributed`` (NCCL for ranks on
    separate cards, gloo on the CPU), as the JAX package's multi-process
    runs call ``jax.distributed.initialize``. With a process group, ``None``
    takes every rank, and n up to the world size ranks 0..n-1. Such a
    sub-mesh is a new process group (under NCCL a communicator of its own,
    held until the process group is destroyed), which every rank of the
    world must create together: build it once and reuse it, not once a
    step. Without one, the mesh is this process alone (``None`` or 1), and
    no collective is ever called. Never shrinks: more ranks than exist
    raise ValueError. Each rank solves on the device of the tensors it is
    given; nothing falls back to the CPU."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(
                f"requested a {n_devices}-rank mesh but no process group is "
                "initialised: this process is the only rank"
            )
        return ScenarioMesh(group=None, n=1, rank=0, axis=axis)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"requested a {n}-rank mesh but the process group has {world} ranks")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    return ScenarioMesh(group=group, n=n, rank=rank if rank < n else -1, axis=axis)


_SUMS = ("n_total", "n_converged", "n_max_iter", "n_infeasible")
_MAXES = ("max_primal_residual", "max_dual_residual", "max_iterations")


def _pack_diagnostics(d: BatchDiagnostics, device) -> Tuple[Tensor, Tensor]:
    """Fp64 vectors of a shard's diagnostics on ``device``: the counts with
    mean x n_total (exact in fp64 below 2^29 lanes), and the maxima."""
    sums = [getattr(d, k).double() for k in _SUMS]
    sums.append(d.mean_iterations.double() * d.n_total.double())
    return (torch.stack(sums).to(device),
            torch.stack([getattr(d, k).double() for k in _MAXES]).to(device))


def _unpack_diagnostics(sums: Tensor, maxes: Tensor, like: BatchDiagnostics) -> BatchDiagnostics:
    """The fleet's diagnostics from reduced vectors, with the dtypes and the
    device of ``like``."""
    dev = like.n_total.device
    sums, maxes = sums.to(dev), maxes.to(dev)
    fields = {k: sums[i].to(getattr(like, k).dtype) for i, k in enumerate(_SUMS)}
    fields.update({k: maxes[i].to(getattr(like, k).dtype) for i, k in enumerate(_MAXES)})
    fields["mean_iterations"] = (sums[4] / sums[0]).to(like.mean_iterations.dtype)
    return BatchDiagnostics(**fields)


def _psum_diagnostics(d: BatchDiagnostics, mesh: ScenarioMesh) -> BatchDiagnostics:
    """Fleet diagnostics over the mesh, the same bits on every rank: sums of
    the counts, maxima of the residuals and of max_iterations, and the mean
    of iterations weighted by n_total. Two all_reduces (one of the sums, one
    of the maxima), on the card under NCCL and on the host under gloo and
    the other backends. A mesh without a group returns ``d`` as it is."""
    import torch.distributed as dist

    if mesh.group is None:
        return d
    on_card = dist.get_backend(mesh.group) == "nccl"
    sums, maxes = _pack_diagnostics(d, d.n_total.device if on_card else "cpu")
    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=mesh.group)
    dist.all_reduce(maxes, op=dist.ReduceOp.MAX, group=mesh.group)
    return _unpack_diagnostics(sums, maxes, d)


def solve_sharded(
    controller: MpcController,
    x0s: Tensor,  # (B, nx), the same on every rank; B divisible by the mesh size
    mesh: Optional[ScenarioMesh] = None,
    warm_z: Optional[Tensor] = None,  # (B, n)
    warm_y: Optional[Tensor] = None,  # (B, m)
    fused: Optional[bool] = None,
) -> Tuple[MpcSolution, Tensor, Tensor, BatchDiagnostics]:
    """Scenario-sharded batch solve over a mesh of ranks (SPMD: every rank
    of the mesh calls it with the whole batch).

    The controller is replicated; rank r solves rows [r B/n, (r+1) B/n) of
    x0s and of the warm pair (``init_warm_batch`` without one) on
    :func:`solve_batch_fused` (``fused=True``) or :func:`solve_batch`
    (``False``; ``None``: :func:`fused_supported`), on the device of
    ``x0s``. Returns this rank's shard of (solutions, next warm_z, next
    warm_y) and the fleet's diagnostics, equal on every rank. A Riccati
    engine's batch-wide rho rule runs per shard, as in the JAX package's
    ``shard_map``: a rank's lanes equal a solve of its rows alone."""
    mesh = make_mesh() if mesh is None else mesh
    B = x0s.shape[0]
    if B % mesh.n:
        raise ValueError(f"batch {B} not divisible by mesh size {mesh.n}")
    if mesh.rank < 0:
        raise ValueError("this process is not a rank of the mesh")
    if warm_z is None or warm_y is None:
        warm_z, warm_y = init_warm_batch(controller, B)
    if fused is None:
        fused = fused_supported(controller)
    rows = slice(mesh.rank * (B // mesh.n), (mesh.rank + 1) * (B // mesh.n))
    solve = solve_batch_fused if fused else solve_batch
    sol, wz, wy, diag = solve(controller, x0s[rows], warm_z[rows], warm_y[rows])
    return sol, wz, wy, _psum_diagnostics(diag, mesh)


def escalation_controller(
    controller: MpcController,
    rho_grid: Tuple[float, ...] = (0.01, 0.1, 1.0, 10.0, 100.0),
    max_iter: int = 4000,
    refine_steps: int = 2,
) -> MpcController:
    """Fallback controller for straggler re-dispatch: the same condensed QP
    with a wider prefactorized rho grid, a deeper iteration budget and
    iterative refinement of the K-solve. Built on the host, moved to the
    controller's device."""
    eng = controller.engine
    if not isinstance(eng, LinearEngine):
        return controller
    cfg = dataclasses.replace(
        eng.config, rho_grid=tuple(rho_grid), max_iter=int(max_iter),
        adaptive=True, refine_steps=int(refine_steps),
    )
    qp = eng.qp.to("cpu")
    l_np = qp.l_const.numpy()
    u_np = qp.u_const.numpy()
    eq_mask = np.isfinite(l_np) & np.isfinite(u_np) & (l_np == u_np)
    op = admm_ops.build_operator(qp.P, qp.A, eq_mask, qp.n_ball, cfg)
    return controller.replace(
        engine=LinearEngine(
            qp=eng.qp, op=op.to(controller.device), soft_mu=eng.soft_mu, config=cfg
        )
    )


def _native_lane_solve(controller: MpcController, x0, wz_lane, wy_lane):
    """Tier-3 straggler solve in f64 on the host through the native oracle.
    Returns numpy pieces of one lane of the batch solution, the next warm
    z (shifted) and the raw dual."""
    np64 = lambda t: np.asarray(torch.as_tensor(t).detach().cpu(), np.float64)
    qp = controller.engine.qp.to("cpu")
    tuning = controller.tuning.to("cpu")
    refs = tuning.references
    N, nx, nu = qp.N, qp.nx, qp.nu
    e0 = np64(x0) - np64(refs.x[:, 0])
    q = np64(qp.q_const) + np64(qp.q_x0) @ e0
    shift = np64(qp.b_x0) @ e0
    l = np64(qp.l_const) + shift
    u = np64(qp.u_const) + shift
    z, y, status, iters, rp, rd = native_qp.solve_qp(
        np64(qp.P), q, np64(qp.A), l, u,
        z0=np64(wz_lane), y0=np64(wy_lane), eps_abs=1e-7, eps_rel=1e-7,
    )
    eu = z.reshape(N, nu)
    ex_tail = (np64(qp.G_flat) @ z + np64(qp.F).reshape(N * nx, nx) @ e0).reshape(N, nx)
    ex = np.concatenate([e0[None], ex_tail], axis=0)  # (N+1, nx)
    xs = ex + np64(refs.x).T
    us = eu + np64(refs.u).T
    obj = float(
        true_objective(
            tuning,
            torch.from_numpy(xs.astype(np.float32))[None],
            torch.from_numpy(us.astype(np.float32))[None],
        )[0]
    )
    wz_next = np.concatenate([eu[1:], eu[-1:]], axis=0).reshape(-1)
    lane_sol = dict(
        x=xs.T, e_x=ex.T, u=us.T, e_u=eu.T, status=status,
        iterations=iters, primal_residual=rp, dual_residual=rd, objective=obj,
    )
    return lane_sol, wz_next.astype(np.float32), y.astype(np.float32)


def _gather_iterate(sol: MpcSolution, wy, warm_z, warm_y, idx: Tensor):
    """The current primal/dual iterate of lanes ``idx`` (sol.e_u is the
    unshifted z, wy the raw y), falling back to the warm pair on lanes that
    are not finite."""
    B = sol.e_u.shape[0]
    z_it = sol.e_u.transpose(1, 2).reshape(B, -1)[idx]
    y_it = wy[idx]
    ok = (torch.isfinite(z_it).all(1) & torch.isfinite(y_it).all(1))[:, None]
    return torch.where(ok, z_it, warm_z[idx]), torch.where(ok, y_it, warm_y[idx])


def _scatter(old: Tensor, idx: Tensor, new: Tensor) -> Tensor:
    out = old.clone()
    out[idx] = new
    return out


def solve_batch_escalated(
    controller: MpcController,
    fallback: MpcController,
    x0s: Tensor,  # (B, nx)
    warm_z: Tensor,
    warm_y: Tensor,
    bucket: int = 256,
) -> Tuple[MpcSolution, Tensor, Tensor, BatchDiagnostics]:
    """Two-tier batch solve on the device.

    Tier 1 runs the controller's config through :func:`solve_batch_auto`.
    The straggler lanes (MAX_ITER / NUMERIC_ERROR) are gathered on the
    device into a static ``bucket`` (a stable partition: stragglers first,
    in lane order) and re-solved on the fallback: a condensed engine's
    lanes continue from the tier-1 iterate on the fallback's fused kernel
    where one takes it, else on :func:`solve_batch`; a Riccati engine's
    lanes (whose warm pair is a shifted carry, not an iterate) restart from
    the original warm pair on the per-lane engine. Results are written back
    only over lanes that were stragglers; their iteration counts continue
    tier 1's. Stragglers beyond the bucket stay MAX_ITER for the host tier
    of make_escalated_solver.
    """
    B = x0s.shape[0]
    bucket = min(bucket, B)
    sol, wz, wy, _ = solve_batch_auto(controller, x0s, warm_z, warm_y)

    bad = _redispatch(sol.status)
    # stable: lanes keep their order within each side, as jnp.argsort does
    gidx = torch.argsort((~bad).to(torch.int8), stable=True)[:bucket]
    bad_g = bad[gidx]

    if isinstance(controller.engine, RiccatiEngine):
        sol2, wz2, wy2, _ = solve_batch(fallback, x0s[gidx], warm_z[gidx], warm_y[gidx])
    else:
        z0, y0 = _gather_iterate(sol, wy, warm_z, warm_y, gidx)
        tier2 = solve_batch_fused if fused_supported(fallback) else solve_batch
        sol2, wz2, wy2, _ = tier2(fallback, x0s[gidx], z0, y0)
    sol2 = sol2.replace(iterations=sol2.iterations + sol.iterations[gidx])

    def merge(old, new):
        flag = bad_g.reshape((bucket,) + (1,) * (new.ndim - 1))
        return _scatter(old, gidx, torch.where(flag, new, old[gidx]))

    sol_m = MpcSolution(
        **{
            f.name: merge(getattr(sol, f.name), getattr(sol2, f.name))
            for f in dataclasses.fields(MpcSolution)
        }
    )
    return sol_m, merge(wz, wz2), merge(wy, wy2), _diagnostics(sol_m)


def make_escalated_solver(
    controller: MpcController,
    fallback: Optional[MpcController] = None,
    min_bucket: int = 256,
    native_tier: bool = True,
) -> Callable:
    """Tiered batch solver: tiers 1 and 2 as :func:`solve_batch_escalated`
    on the device, then every lane still MAX_ITER / NUMERIC_ERROR is solved
    on the host by the f64 native oracle, continuing from the tier-2
    iterate. Returns ``solve(x0s, warm_z=None, warm_y=None) -> (sol, wz,
    wy, diag)``."""
    fb = fallback if fallback is not None else escalation_controller(controller)
    native_ok = native_tier and isinstance(controller.engine, LinearEngine)

    def solve(x0s, warm_z=None, warm_y=None):
        B = x0s.shape[0]
        if warm_z is None or warm_y is None:
            warm_z, warm_y = init_warm_batch(controller, B)
        sol, wz, wy, diag = solve_batch_escalated(
            controller, fb, x0s, warm_z, warm_y, bucket=min_bucket
        )
        if not native_ok:
            return sol, wz, wy, diag
        li = torch.nonzero(_redispatch(sol.status)).flatten()
        if li.numel() == 0:
            return sol, wz, wy, diag

        z_g, y_g = _gather_iterate(sol, wy, warm_z, warm_y, li)
        x0_g, z_g, y_g = (t.cpu().numpy() for t in (x0s[li], z_g, y_g))
        lanes, wz3, wy3 = [], [], []
        for k in range(li.numel()):
            lane, wzl, wyl = _native_lane_solve(controller, x0_g[k], z_g[k], y_g[k])
            lanes.append(lane)
            wz3.append(wzl)
            wy3.append(wyl)

        dev = sol.status.device
        stack = lambda key, dt=np.float32: torch.from_numpy(
            np.stack([np.asarray(ln[key], np.float64) for ln in lanes]).astype(dt)
        ).to(dev)
        patch = {
            f.name: stack(f.name, np.int32 if f.name in ("status", "iterations") else np.float32)
            for f in dataclasses.fields(MpcSolution)
        }
        sol = MpcSolution(
            **{k: _scatter(getattr(sol, k), li, v) for k, v in patch.items()}
        )
        wz = _scatter(wz, li, torch.from_numpy(np.stack(wz3)).to(dev))
        wy = _scatter(wy, li, torch.from_numpy(np.stack(wy3)).to(dev))
        return sol, wz, wy, _diagnostics(sol)

    return solve


def closed_loop_batch(
    controller: MpcController,
    plant_step: Callable[[Tensor, Tensor], Tensor],  # (x (B,nx), u (B,nu)) -> x_next
    x0s: Tensor,  # (B, nx)
    n_steps: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Batched receding-horizon closed loop, a Python loop over steps with
    the warm start carried from step to step. ``plant_step`` takes the
    whole batch at once (the JAX package vmaps a one-state plant): the
    QTP's ``qtp_discrete_step``, or a learned plant's ``system.step`` (a
    zoo model takes (B, nx) and (B, nu)).

    Returns (states (n_steps+1, B, nx), inputs (n_steps, B, nu),
    statuses (n_steps, B)). A MILP engine is refused with TypeError, as the
    JAX package's traced loop refuses its host branch and bound: loop over
    :func:`solve_batch` instead."""
    if isinstance(controller.engine, MilpEngine):
        raise TypeError(
            "closed_loop_batch does not take a MILP engine: its branch and bound "
            "runs on the host; call solve_batch once per step instead"
        )
    wz, wy = init_warm_batch(controller, x0s.shape[0])
    x = x0s
    xs, us, statuses = [x0s], [], []
    for _ in range(int(n_steps)):
        sol, wz, wy, _ = solve_batch_auto(controller, x, wz, wy)
        u0 = sol.u[:, :, 0]
        x = plant_step(x, u0)
        xs.append(x)
        us.append(u0)
        statuses.append(sol.status)
    return torch.stack(xs), torch.stack(us), torch.stack(statuses)
