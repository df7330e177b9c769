"""Speed-of-light accounting for the port's kernels on an NVIDIA H100.

The JAX package's ``utils/roofline.py`` models a TPU: MXU passes over
padded tiles. This module models the card the port runs on. Each model
counts what a call must do, per chunk and per lane: the bytes it must move
(each input read once, each output written once) over HBM bandwidth, and
the operations it does over the card's peak rate for their type. The
larger of the two times is the least time the card could take (the
"bound"); ``sol_fraction`` is that time over a measured one, and ``mfu``
the operations' own share of the card's peak in the measured time.

The kernels sum exact fp32 products in fp64 ("highest" precision), so a
multiply-add counts as 2 operations at the fp64 tensor-core rate, 67
TFLOP/s, the least time the card could take for it (the kernels' index-
order sums run on the FMA units at half that; :func:`fma_floor_ms` is that
floor). The bf16 precisions' passes count at the bf16 tensor-core rate,
989 TFLOP/s, and the plain fp32 steps (projections, dual ascent, the
between-chunk diagnostics) at the fp32 rate outside the tensor cores, 67
TFLOP/s. Peaks are NVIDIA's data sheet for the SXM part at its 700 W power
limit; a card set below it runs slower under load.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

# the H100 SXM data sheet (dense rates): HBM bytes/s; fp64 operations/s on
# the tensor cores; fp32 outside them; bf16 products summed in fp32 on them
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 67e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# multiply-adds a clock an SM on the FMA units (scripts/fp64_rate_probe.py
# measured 63.2 fp64)
FP64_FMA_PER_CLOCK_SM = 64
FP32_FMA_PER_CLOCK_SM = 128

# the JAX package's placeholder for a host device, so that the report runs
# in CPU tests: bf16 flop/s, HBM bytes/s, and its "highest" fp32 as 6 passes
_HOST_FLOPS, _HOST_BYTES_PER_S, _HOST_F32_PASSES = 1e12, 100e9, 6

# operations per multiply-add at each kernel precision: its bf16 passes
_PASSES = {"highest": 1, "bf16x3": 3, "default": 1}


def device_peaks(device=None) -> Dict[str, object]:
    """The peaks of ``device`` (a torch.device, a string or a CUDA index;
    ``None``: the card where one is visible, else the host).

    An H100 gives the data sheet's rates above and its SM count from
    ``torch.cuda.get_device_properties``; a CPU device gives the JAX
    package's ``"host"`` placeholder. Other cards raise ValueError: no rate
    of another card is guessed. Keys: ``device_kind``, ``hbm_bytes_per_s``,
    ``fp64_flops``, ``fp32_flops``, ``bf16_flops``, ``f32_highest_flops``
    (the rate "highest" precision's operations take: fp64 on the card),
    ``sm_count``, ``fp64_fma_per_clock_sm`` and ``fp32_fma_per_clock_sm``.
    """
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device) if not isinstance(device, int) else torch.device("cuda", device)
    if device.type != "cuda":
        f32 = _HOST_FLOPS / _HOST_F32_PASSES
        return dict(device_kind=device.type, hbm_bytes_per_s=_HOST_BYTES_PER_S,
                    fp64_flops=f32, fp32_flops=f32, bf16_flops=_HOST_FLOPS,
                    f32_highest_flops=f32, sm_count=None, fp64_fma_per_clock_sm=None,
                    fp32_fma_per_clock_sm=None)
    name = torch.cuda.get_device_name(device)
    if "H100" not in name:
        raise ValueError(f"no peak rates for {name!r}: this model knows the H100")
    return dict(device_kind=name, hbm_bytes_per_s=HBM_BYTES_PER_S,
                fp64_flops=FP64_OPS_PER_S, fp32_flops=FP32_OPS_PER_S,
                bf16_flops=BF16_OPS_PER_S, f32_highest_flops=FP64_OPS_PER_S,
                sm_count=torch.cuda.get_device_properties(device).multi_processor_count,
                fp64_fma_per_clock_sm=FP64_FMA_PER_CLOCK_SM,
                fp32_fma_per_clock_sm=FP32_FMA_PER_CLOCK_SM)


def bound(nbytes: float, fp64_ops: float, fp32_ops: float = 0.0) -> Tuple[float, str]:
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    the operations over their peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = fp64_ops / FP64_OPS_PER_S + fp32_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


# ---------------------------------------------------------------- ADMM chunks


def kernel_of(op, config) -> str:
    """The kernel that takes a condensed engine's operator: K1 (diagonal A),
    K2 (mixed), K4 or K5 (dense, by ``admm_fused.use_packed``)."""
    from ..ops import admm_fused

    if op.diag_a:
        return "K1"
    if op.mixed_a:
        return "K2"
    m, n = (int(d) for d in op.A_s.shape)
    packed = admm_fused.use_packed(n, m, int(op.rho_grid.shape[0]), int(config.refine_steps))
    return "K4" if packed else "K5"


def chunk_macs(n: int, m: int, refine_steps: int, kernel: str) -> int:
    """Multiply-adds of one lane and iteration of K1 (m = n), K2, K4 or K5:
    K1 the K-solves, (1 + 2 refine) n^2; K2 those and the three A2
    products, 3 (m - n) n; K5 A'y, A' rho s, A xt and the K-solves, 3 m n +
    (1 + 2 refine) n^2; K4 A'y, A' rho s and the packed solve with its
    image, 2 m n + n (n + m) + refine (n^2 + n (n + m)). A diagonal A's
    products are elementwise, and a lane computes only its own rho."""
    if kernel == "K5":
        return 3 * m * n + (1 + 2 * refine_steps) * n * n
    if kernel == "K4":
        return 2 * m * n + n * (n + m) + refine_steps * (n * n + n * (n + m))
    return (1 + 2 * refine_steps) * n * n + (3 * (m - n) * n if kernel == "K2" else 0)


def chunk_bytes(n: int, m: int, B: int, R: int, refine_steps: int, kernel: str) -> int:
    """Bytes one chunk of K1, K2, K4 or K5 over B lanes must move: the
    operators once (every rho's K^-1, and K where it refines; the rho
    vectors; A's dense rows, and K4's packed K^-1 A'), q, l, u, idx and the
    state x, s, y, ax in, the state out."""
    stacks = 2 if refine_steps else 1
    if kernel in ("K1", "K2"):
        operator = stacks * R * n * n + 2 * R * m + n + (m - n) * n
    else:
        operator = stacks * R * n * n + 2 * R * m + m * n + (R * n * m if kernel == "K4" else 0)
    lane = (2 * n + 5 * m + 1) + (n + 3 * m)
    return 4 * (operator + lane * B)


def chunk_bound(n, m, B, R, refine_steps, chunk, kernel, mode="highest"):
    """Least milliseconds of one chunk of K1, K2, K4 or K5 on the card:
    :func:`chunk_bytes` over HBM bandwidth against :func:`chunk_macs` of
    every lane and iteration. At "highest" they are fp64 multiply-adds
    over the fp64 peak; at "bf16x3" three bf16 multiply-adds each (its
    passes) and at "default" one, summed in fp32, over the bf16
    tensor-core peak, the rate the TPU body's MXU passes have on this card.
    Returns (bound_ms, bound_by, floor_ms): floor_ms is this design's
    floor at a bf16 precision, its passes as fp32 multiply-adds outside
    the tensor cores (as the kernels take them) against the same bytes,
    else None."""
    ops = 2 * chunk_macs(n, m, refine_steps, kernel) * B * chunk * _PASSES[mode]
    t_bytes = chunk_bytes(n, m, B, R, refine_steps, kernel) / HBM_BYTES_PER_S
    t_ops = ops / (FP64_OPS_PER_S if mode == "highest" else BF16_OPS_PER_S)
    floor = None if mode == "highest" else max(t_bytes, ops / FP32_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations"), floor


def fma_floor_ms(n, m, B, refine_steps, chunk, peaks, sm_clock_hz, kernel="K1",
                 mode="highest"):
    """Least milliseconds of one chunk of K1 (m = n), K2, K4 or K5 on the
    card's CUDA cores: :func:`chunk_macs` as fp64 FMAs ("highest"; the
    bound takes them at the fp64 tensor-core rate, which the kernels'
    index-order sums cannot use), or the bf16 precisions' passes as fp32
    FMAs (3 a multiply-add at "bf16x3", 1 at "default"), at the rates a
    clock an SM and on the SMs that ``peaks`` (:func:`device_peaks` of the
    card) gives, at ``sm_clock_hz`` (the card's highest SM clock, which
    ``nvidia-smi`` reads as clocks.max.sm)."""
    per_clock = (peaks["fp64_fma_per_clock_sm"] if mode == "highest"
                 else peaks["fp32_fma_per_clock_sm"] / _PASSES[mode])
    macs = chunk_macs(n, m, refine_steps, kernel)
    return macs * B * chunk / per_clock / (peaks["sm_count"] * sm_clock_hz) * 1e3


def admm_diag_model(n: int, m: int, batch: int) -> Dict[str, float]:
    """The between-chunk diagnostics (plain fp32 PyTorch, the JAX package's
    ``admm_diag_model``): P x and A'y over the batch, and x, s, y, ax, q,
    l, u read and the residuals and masks written (~4 values a lane)."""
    ops = 2.0 * batch * n * n + 2.0 * batch * m * n
    return {"useful_flops": ops, "padded_flops": ops,
            "bytes": batch * (2 * n + 5 * m + 8) * 4.0}


def _iteration_model(n, m, block, refine_steps, kernel):
    ops = 2.0 * chunk_macs(n, m, refine_steps, kernel) * block
    return {"useful_flops": ops, "padded_flops": ops, "block": block}


def admm_iteration_model(n: int, m: int, R: int, block: int = 1024,
                         refine_steps: int = 0) -> Dict[str, float]:
    """Operations of one iteration of the dense packed kernel K4 (the JAX
    package's lane-packed body) over ``block`` lanes. ``padded_flops``
    equals ``useful_flops``: the card pads no tile, and a lane computes
    only its own rho (R does not enter)."""
    return _iteration_model(n, m, block, refine_steps, "K4")


def admm_diag_iteration_model(n: int, R: int, block: int = 1024,
                              refine_steps: int = 0) -> Dict[str, float]:
    """Operations of one iteration of K1 (diagonal A) over ``block`` lanes:
    the K-solves; A's products are elementwise."""
    return _iteration_model(n, n, block, refine_steps, "K1")


def admm_mixed_iteration_model(n: int, m: int, R: int, block: int = 1024,
                               refine_steps: int = 0) -> Dict[str, float]:
    """Operations of one iteration of K2 (mixed A) over ``block`` lanes: the
    K-solves and the three products with the dense tail A2 (A2'y, A2' rho s,
    A2 xt). A refinement step adds two K-solves and no A2 product."""
    return _iteration_model(n, m, block, refine_steps, "K2")


def admm_diag_chunk_bytes(n: int, R: int, block: int = 1024, refine_steps: int = 0) -> float:
    """Bytes one K1 launch moves for ``block`` lanes (:func:`chunk_bytes`)."""
    return float(chunk_bytes(n, n, block, R, refine_steps, "K1"))


def admm_chunk_bytes(n: int, m: int, R: int, block: int = 1024, refine_steps: int = 0,
                     kernel: str = "K4") -> float:
    """Bytes one launch of a dense or mixed kernel moves for ``block`` lanes
    (:func:`chunk_bytes`)."""
    return float(chunk_bytes(n, m, block, R, refine_steps, kernel))


def _tier_model(op, config, batch: int, iterations: float) -> Dict[str, float]:
    """Bytes and operations of one solver tier that executes ``iterations``
    lockstep iterations over ``batch`` lanes: the kernel's chunks and the
    diagnostics after each."""
    kernel = kernel_of(op, config)
    m, n = (int(d) for d in op.A_s.shape)
    R = int(op.rho_grid.shape[0])
    rs = int(config.refine_steps)
    chunk = max(1, int(config.check_interval))
    n_chunks = max(1.0, float(iterations) / chunk)
    mode = str(config.kernel_precision)
    mode = "bf16x3" if mode == "hybrid" else mode  # its chunks before the switch
    kernel_ops = 2.0 * chunk_macs(n, m, rs, kernel) * batch * float(iterations) * _PASSES[mode]
    dg = admm_diag_model(n, m, batch)
    return {
        "n": n, "m": m, "R": R, "kernel": kernel,
        "fp64_ops": kernel_ops if mode == "highest" else 0.0,
        "bf16_ops": 0.0 if mode == "highest" else kernel_ops,
        "fp32_ops": dg["useful_flops"] * n_chunks,
        "bytes": chunk_bytes(n, m, batch, R, rs, kernel) * n_chunks + dg["bytes"] * n_chunks,
    }


def _report(tiers, measured_time_s: float, device=None) -> Dict[str, object]:
    peaks = device_peaks(device)
    limbs = {k: sum(t[f"{k}_ops"] for t in tiers) / peaks[f"{k}_flops"]
             for k in ("fp64", "fp32", "bf16")}
    t_ops = sum(limbs.values())
    t_hbm = sum(t["bytes"] for t in tiers) / peaks["hbm_bytes_per_s"]
    ops = sum(t[f"{k}_ops"] for t in tiers for k in limbs)
    roofline_t = max(t_ops, t_hbm)
    return {
        "device_kind": peaks["device_kind"],
        "n": tiers[0]["n"],
        "m": tiers[0]["m"],
        "rho_grid": tiers[0]["R"],
        "kernels": [t["kernel"] for t in tiers],
        "achieved_padded_tflops": ops / measured_time_s / 1e12,
        "achieved_useful_tflops": ops / measured_time_s / 1e12,
        "roofline_time_s": roofline_t,
        "measured_time_s": measured_time_s,
        "bound": max(limbs, key=limbs.get) if t_ops >= t_hbm else "hbm",
        "sol_fraction": roofline_t / measured_time_s,
        "mfu": t_ops / measured_time_s,
    }


def speed_of_light(op, config, batch: int, mean_iterations: float, measured_time_s: float,
                   device=None) -> Dict[str, object]:
    """Roofline report for a measured fused batch solve of a condensed
    engine (K1, K2, K4 or K5, as :func:`kernel_of` picks).

    ``roofline_time_s`` is the least time the card could take: the larger
    of the bytes (each chunk's operators and lane state once, and the
    diagnostics after it) over HBM bandwidth and the operations over their
    peaks; ``sol_fraction`` = roofline / measured; ``mfu`` the operations'
    time at peak over the measured time; ``bound`` the limb that bounds it
    ("fp64", "fp32", "bf16" or "hbm"). ``achieved_padded_tflops`` counts
    the operations the port's kernels execute, and equals
    ``achieved_useful_tflops``: the card pads no tile, and each lane
    computes only its own rho, where the TPU body computes every rho of the
    grid. ``mean_iterations`` should be the iterations the card executed
    (every lane runs until the batch's slowest converges)."""
    out = _report([_tier_model(op, config, batch, mean_iterations)], measured_time_s, device)
    out["mean_iterations"] = float(mean_iterations)
    return out


def speed_of_light_tiered(tiers: Iterable, measured_time_s: float,
                          device=None) -> Dict[str, object]:
    """Roofline report for an escalated solve: ``tiers`` is a list of (op,
    config, batch, executed_iterations), e.g. the whole batch at tier 1's
    cap and the straggler bucket at tier 2's."""
    return _report([_tier_model(op, cfg, b, it) for (op, cfg, b, it) in tiers],
                   measured_time_s, device)


# ------------------------------------------------------------ Riccati chunks


def _riccati_work(N, nx, nu, split_interior):
    """(factor floats, lane floats in and out, fp64 multiply-adds and fp32
    elementwise steps a lane and iteration) of K3: the sweep's B'g, G(.),
    (A-BK)'g, K'lu and the rollout's Ke, Ae, Bu; the linear terms, the
    projections and dual ascent, the interior rows' terms when split."""
    factors = (nu * nx + nu * nu + nx * nx) * N + nx * nx + nx * nu + 4 * nx + 2 * nu + 4
    lane = (nx + 1 + 2 * (N + 1) * nx + 2 * N * nu) + (3 * (N + 1) * nx + 3 * N * nu)
    macs = (4 * nu * nx + nu * nu + 2 * nx * nx) * N
    elementwise = (12 * nu + 2 * nx + (10 * nx if split_interior else 0)) * N + 8 * nx
    return factors, lane, macs, elementwise


def riccati_chunk_bound(N, nx, nu, B, chunk, split_interior):
    """Least milliseconds of one K3 chunk: the factors of one rho (K, G,
    A - BK), A, B and the boxes, each lane's inputs (e0, ball radius, vX,
    lamX, vU, lamU) and outputs (X, vX, lamX, U, vU, lamU) once over HBM,
    against 2 operations per fp64 multiply-add of the sweep and the
    rollout over the fp64 peak, plus the fp32 elementwise steps over the
    fp32 peak."""
    factors, lane, macs, elementwise = _riccati_work(N, nx, nu, split_interior)
    return bound(4 * (factors + lane * B), 2 * macs * B * chunk, elementwise * B * chunk)


def riccati_iteration_model(N: int, nx: int, nu: int, block: int) -> Dict[str, float]:
    """Operations of one iteration of the sparse Riccati-ADMM engine (K3's
    sweep and rollout) over ``block`` lanes: ``useful_flops`` 2 a fp64
    multiply-add, equal to ``padded_flops`` (no tile padding on the card),
    and ``elementwise_ops``, the fp32 steps, without split state rows."""
    _, _, macs, elementwise = _riccati_work(N, nx, nu, False)
    return {"useful_flops": 2.0 * macs * block, "padded_flops": 2.0 * macs * block,
            "elementwise_ops": float(elementwise * block), "block": block}


def k3w_bound(N, nx, nu, B, chunk, split_interior, doubling, L):
    """Least milliseconds of one K3W chunk: one rho's factors (K, G, and
    A - B K for the sequential form, the two level stacks and prefix
    products for the doubling form, ``L`` levels), A, B and the boxes, each
    lane's inputs and outputs once over HBM, against 2 operations per fp64
    multiply-add over the fp64 peak and the fp32 elementwise steps over
    the fp32 peak. The sequential form's multiply-adds are K3's; the
    doubling form's are K' lu, the levels' (sum over levels of (N - 2^l)
    nx^2, both sweeps), the prefix products' (N nx^2 each sweep), B' g,
    G (.), B ff and K e."""
    if not doubling:
        return riccati_chunk_bound(N, nx, nu, B, chunk, split_interior)
    level_rows = sum(max(N - 2 ** l, 0) for l in range(L)) if N > 1 else 0
    factors = ((nu * nx + nu * nu) * N + 2 * (L + 1) * N * nx * nx + nx * nx + nx * nu
               + 4 * nx + 2 * nu + 4)
    _, lane, _, elementwise = _riccati_work(N, nx, nu, split_interior)
    macs = 3 * N * nu * nx + N * nu * nu + N * nx * nu + 2 * (level_rows + N) * nx * nx
    return bound(4 * (factors + lane * B), 2 * macs * B * chunk, elementwise * B * chunk)


def rollout_bound(N, nx, nu, B):
    """The drivers' rollout: A, B, e0 and U in, X out; A e and B u a step."""
    nbytes = 4 * (nx * nx + nx * nu + (nx + N * nu + (N + 1) * nx) * B)
    return bound(nbytes, 2 * (nx * nx + nx * nu) * N * B, nx * N * B)


def certificate_bound(N, nx, nu, B):
    """The drivers' certificate: A, B, the boxes, lamX new/old and Xbar,
    lamU new/old and the ball radius in, three values a lane out; the
    adjoint's B'g and A'g and <dlamX, Xbar> a step, and its fp32 deltas,
    residuals and support terms."""
    nbytes = 4 * (nx * nx + nx * nu + 4 * nx + 2 * nu
                  + (3 * (N + 1) * nx + 2 * N * nu + 1 + 3) * B)
    macs = (nu * nx + nx * nx + nx) * N + 2 * nx
    elementwise = (6 * nu + 6 * nx) * N
    return bound(nbytes, 2 * macs * B, elementwise * B)


def wide_chain_floor_ms(N: int, nx: int, chain_ns: float) -> float:
    """The wide rollout's and certificate's chain floor: N x nx dependent
    fp64 multiply-adds (a lane's A e or A' g, a step after another; the
    rollout's fp32 add a step aside), ``chain_ns`` each (one dependent
    multiply-add's latency, ``scripts/fp64_rate_probe.py --chain``)."""
    return N * nx * chain_ns * 1e-6
