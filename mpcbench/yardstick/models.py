"""Bytes and operations of the port's kernels per chunk, and the least time
the H100 could take for them: a copy, frozen here, of the port's
``utils/roofline.py`` models for K1 and K3 (the arithmetic as it stood when
the benchmark was defined).

A cell's work is counted from its configuration file, never from a counter
of the program: ``work.lane_iterations`` is the mean of each lane's own
iterations to its certificate, read once on the seed-0 inputs when the cell
was added. The bound of a batch's work is a chunk's bound (:func:`k1_chunk`,
:func:`k3_chunk`) scaled by the lane-iterations the batch needs over the
lane-iterations one chunk over every lane executes.
"""

from __future__ import annotations

from typing import Dict, Tuple

from . import peaks


def bound(nbytes: float, fp64_ops: float, fp32_ops: float = 0.0) -> Tuple[float, float, float]:
    """(bound_ms, bytes_ms, ops_ms): the larger of the bytes over HBM
    bandwidth and the operations over their peaks, and each side."""
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S * 1e3
    t_ops = (fp64_ops / peaks.FP64_OPS_PER_S + fp32_ops / peaks.FP32_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def k1_macs(n: int, refine_steps: int) -> int:
    """Multiply-adds of one lane and iteration of K1 (diagonal A): the
    K-solves, (1 + 2 refine) n^2."""
    return (1 + 2 * refine_steps) * n * n


def k1_chunk_bytes(n: int, B: int, R: int, refine_steps: int) -> int:
    """Bytes one K1 chunk over B lanes must move: every rho's K^-1 (and K
    where it refines), the rho vectors, q, l, u and the state in, the state
    out."""
    m = n
    stacks = 2 if refine_steps else 1
    operator = stacks * R * n * n + 2 * R * m + n
    lane = (2 * n + 5 * m + 1) + (n + 3 * m)
    return 4 * (operator + lane * B)


def k1_chunk(n: int, B: int, R: int, refine_steps: int, chunk: int) -> Tuple[float, float, float]:
    """Least ms of one K1 chunk at "highest" precision: 2 fp64 operations a
    multiply-add against its bytes."""
    ops = 2 * k1_macs(n, refine_steps) * B * chunk
    return bound(k1_chunk_bytes(n, B, R, refine_steps), ops)


def _riccati_work(N: int, nx: int, nu: int, split_interior: bool):
    """(factor floats, lane floats in and out, fp64 multiply-adds and fp32
    elementwise steps a lane and iteration) of K3."""
    factors = (nu * nx + nu * nu + nx * nx) * N + nx * nx + nx * nu + 4 * nx + 2 * nu + 4
    lane = (nx + 1 + 2 * (N + 1) * nx + 2 * N * nu) + (3 * (N + 1) * nx + 3 * N * nu)
    macs = (4 * nu * nx + nu * nu + 2 * nx * nx) * N
    elementwise = (12 * nu + 2 * nx + (10 * nx if split_interior else 0)) * N + 8 * nx
    return factors, lane, macs, elementwise


def k3_chunk(N: int, nx: int, nu: int, B: int, chunk: int,
             split_interior: bool = False) -> Tuple[float, float, float]:
    """Least ms of one K3 chunk: one rho's factors and each lane's inputs and
    outputs once over HBM, against 2 operations a fp64 multiply-add of the
    sweep and rollout and the fp32 elementwise steps."""
    factors, lane, macs, elementwise = _riccati_work(N, nx, nu, split_interior)
    return bound(4 * (factors + lane * B), 2 * macs * B * chunk, elementwise * B * chunk)


def chunk_bound(cfg: Dict, lanes: int) -> Tuple[float, float, float]:
    """A chunk of the configuration's kernel over ``lanes`` lanes."""
    w, s = cfg["work"], cfg["solver"]
    chunk = int(s.get("check_interval", 25))
    if w["kernel"] == "K3":
        return k3_chunk(cfg["horizon"], cfg["nx"], cfg["nu"], lanes, chunk,
                        bool(cfg.get("state_constraint", False)))
    if w["kernel"] == "K1":
        return k1_chunk(cfg["horizon"] * cfg["nu"], lanes, len(s["rho_grid"]),
                        int(s.get("refine_steps", 1)), chunk)
    raise ValueError(f"no model of kernel {w['kernel']!r}")


def batch_work(cfg: Dict, lanes: int) -> Dict[str, float]:
    """The frozen work of one batch of ``lanes`` lanes: the kernel's least
    ms for it (``bound_ms``) and its operations' ms at the peaks
    (``ops_ms``), a chunk's scaled by lane_iterations / chunk."""
    chunk = int(cfg["solver"].get("check_interval", 25))
    scale = float(cfg["work"]["lane_iterations"]) / chunk
    b, _, ops = chunk_bound(cfg, lanes)
    return {"kernel": cfg["work"]["kernel"], "bound_ms": b * scale, "ops_ms": ops * scale}
