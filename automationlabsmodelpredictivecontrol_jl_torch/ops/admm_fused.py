"""Batched ADMM on the fused kernels K1 (diagonal A), K2 (mixed A), K4 and
K5 (dense A), and their driver.

The counterpart of the JAX package's ``ops/admm_pallas.py`` for condensed
QPs whose scaled constraint matrix A_s is

- square and diagonal (``op.diag_a``: every input-box-only condensed MPC,
  the h20 main path included): :func:`iterate_chunk_diag_T`, kernel K1
  (``csrc/admm_diag.cu``);
- mixed, A_s = [diag(d); A2] with a dense tail A2 of state-box and terminal
  rows (``op.mixed_a``: every condensed MPC with state or terminal rows):
  :func:`iterate_chunk_mixed_T`, kernel K2 (``csrc/admm_mixed.cu``);
  K1 and K2 take wider operators than these shared routes hold on their
  stream route (``csrc/admm_diag_stream.cu``; :func:`k1_plan`,
  :func:`k2_plan`);
- dense, any other A without ball rows (``op.dense_a``: a QP whose rows
  are not box-first, such as OSQP's convention of equality and coupling
  rows above the variable bounds): :func:`iterate_chunk_dense_packed_T`,
  kernel K4, or :func:`iterate_chunk_dense_perr_T`, kernel K5, as
  :func:`use_packed` picks; both are instantiations of the two kernels of
  ``csrc/admm_perr.cu`` and, at the shapes those do not take, of the wide
  route's (``csrc/admm_perr_wide.cu``), laid out by :func:`k4_plan` and
  :func:`k5_plan`.

Each chunk function runs ``chunk`` ADMM iterations on the lane-last state,
its products at ``config.kernel_precision`` (``PRECISIONS``: the JAX
package's ``_make_dot``; "hybrid" is the driver's per-chunk schedule).
On a CUDA tensor it launches its hand-written kernel and raises if it
cannot; on a CPU tensor it runs its plain PyTorch version, the same chunk
math, which the CPU tests hold against the JAX kernel in interpret mode.
:func:`solve_batch_fused` is the driver: a Python loop over chunks that,
between chunks, computes the exact unscaled residuals, applies the OSQP
rho rule per lane, runs the NaN guard and freezes converged lanes.

``LAUNCHES`` counts each kernel's launches and ``PLAIN_CALLS`` the calls
of each plain version, so a run can show which one did the work. The
registry also holds the Riccati path's kernels (``ops/riccati_fused.py``):
K3 and the two recurrences of its driver, "rollout" and "certificate".
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import _build
from .admm import AdmmConfig, AdmmOperator, start_rho_index
from .riccati import dot64
from ..types import STATUS_CONVERGED, STATUS_MAX_ITER, STATUS_NUMERIC_ERROR
from ..utils.precision import assert_ieee_fp32

Tensor = torch.Tensor

# the kernel precisions the fused kernels compute (AdmmConfig.kernel_precision
# but "hybrid", which the driver resolves per chunk into "bf16x3" or
# "highest"), by the code their C entries take
PRECISIONS = ("highest", "bf16x3", "default")

LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "rollout": 0, "certificate": 0, "K4": 0, "K5": 0,
            "K3W": 0, "K3W-doubling": 0, "rollout-wide": 0, "certificate-wide": 0}
# the bf16 precisions of K1, K2, K4 and K5 count apart ("K1-bf16x3", ...)
LAUNCHES.update({f"{k}-{mode}": 0 for k in ("K1", "K2", "K4", "K5") for mode in PRECISIONS[1:]})
PLAIN_CALLS = dict(LAUNCHES)


def reset_counts() -> None:
    """Set every launch and plain-call count to 0."""
    for counts in (LAUNCHES, PLAIN_CALLS):
        for key in counts:
            counts[key] = 0


# shared memory one block may use on Hopper (227 KB), the widest n the
# shared routes of K1 and K2 and the shared and stream routes of K4 and K5
# take, K2's shared route's widest dense tail and the most constraint rows
# K4's and K5's shared and stream routes take
SMEM_LIMIT = 232448
MAX_N = 128
MAX_TAIL = 128
MAX_DENSE_ROWS = 512
# K4's and K5's wide route (csrc/admm_perr_wide.cu): the widest n and the
# most constraint rows; the lanes a block may take (a power of 2: its
# vector buffer holds n rows of them in fp64), the threads of a block and
# the registers a thread is held to (its __launch_bounds__), the ring's
# slots, the register tiles (rows, lanes a thread) a product may take
# (kTiles), and the blocks of a cluster that share their lanes, each taking
# its span of every product's rows
MAX_WIDE_N = 1024
MAX_WIDE_ROWS = 4096
WIDE_LANES = (64, 32, 16, 8, 4, 2, 1)
WIDE_THREADS = 256
WIDE_REGISTERS = 255
WIDE_DEPTHS = (2, 3, 4)
WIDE_CLUSTERS = (1, 2)
WIDE_TILES = ((4, 4), (2, 4), (4, 2), (2, 2), (4, 1), (2, 1))
# K1's and K2's stream route (csrc/admm_diag_stream.cu): the widest n and
# K2's longest tail; the rows a thread takes in each tile of K2's A2' pass
# (K12_PASS_ROWS; elsewhere k12_rows_options), the most threads a block
# and the registers a thread is held to (its __launch_bounds__); the lanes
# a block takes, from how many a thread takes 4 lanes and 2 (1 below), and
# the 16-byte chunks of a streamed panel a thread stages in registers
MAX_STREAM_N = 1024
MAX_STREAM_TAIL = 1024
K12_PASS_ROWS = 4
K12_STREAM_THREADS = 256
K12_STREAM_REGISTERS = 256
K12_STREAM_LANES = (64, 32, 16, 8, 4)
K12_WIDE_LANES = 32
K12_MID_LANES = 16
K12_STREAM_STAGE = 8
# one SM of the card: its SM count, shared memory (of which the runtime
# keeps 1 KB per resident block), registers, threads and resident blocks
SM_COUNT = 132
SM_SMEM, SM_SMEM_PER_BLOCK, SM_REGISTERS, SM_THREADS, SM_BLOCKS = 233472, 1024, 65536, 2048, 32
# lanes per block of K1's and K2's layouts
LANES = (32, 16, 8, 4)


def row_strides(n: int, lanes: int) -> Tuple[int, int]:
    """The strides, in doubles, of an (n, n) operator stack in K1's and K2's
    shared memory (csrc/admm_common.cuh, row_stride): rows at ``ld``, even
    so that a row is read two entries at a time, and for fewer than 32
    lanes an odd multiple of lanes / 4 in 16-byte units, so that the
    32 / lanes consecutive rows a warp reads start in distinct bank groups;
    rho copies at ``sk``, odd in 16-byte units, so that the same entry of
    two copies never shares a bank group."""
    ld = n + (n & 1)
    if lanes < 32:
        unit = lanes // 4
        while (ld // 2) % unit or ((ld // 2) // unit) % 2 == 0:
            ld += 2
    return ld, (n * ld) | 2


def _warp_cost(per_sm_lanes: int, lane_reads: int, warps: float) -> float:
    """K1's and K2's plans rank layouts by the doubles the busiest SM reads
    from shared memory (per_sm_lanes lanes, lane_reads each per iteration),
    with a penalty where fewer than 7 warps are resident on the SM to hide
    the loads' latency. It ranks the layouts as measured (k3_ab.py --kernel
    K2 and K1, PERF.md) but is no time: a warp whose lanes share a rho index
    reads faster than its bytes say."""
    return per_sm_lanes * lane_reads * max(1.0, 7 / warps)


# K1's instantiations (csrc/admm_diag.cu, MPC_K1_INSTANCES): rows per
# thread -> the most threads a block of it may have and the registers a
# thread takes without and with refinement (nvcc 12.9's -Xptxas -v report
# on the H100; none spills)
K1_INSTANCES = {1: (512, 45, 57), 2: (512, 70, 80), 3: (512, 94, 108), 4: (512, 121, 128),
                5: (256, 126, 163), 6: (256, 164, 192), 7: (256, 186, 216), 8: (256, 208, 243)}
# the C entries' int parameters, in order (the wrapper passes them so): the
# shared route's (admm_diag_chunk) and the stream route's
# (admm_diag_stream_chunk)
K1_INTS = ("n", "B", "R", "chunk", "refine_steps", "mode", "lanes", "groups", "rpt",
           "smem_bytes")
K1_STREAM_INTS = ("n", "B", "R", "chunk", "refine_steps", "mode", "lanes", "groups", "rpt",
                  "panel", "smem_bytes")
# "shared": admm_diag_chunk / admm_mixed_chunk, every rho's fp64 operators in
# one block's shared memory; "stream": admm_diag_stream_chunk /
# admm_mixed_stream_chunk (csrc/admm_diag_stream.cu), lanes grouped by rho
# index, one rho's operators resident in two shared panels or streamed
# through them, where the shared route has no layout
K12_ROUTES = ("shared", "stream")


class K1Plan(NamedTuple):
    """How one K1 launch is laid out: lanes and row-groups of a block
    (blockDim.x, blockDim.y), the rows each thread owns (on the stream
    route in each tile of a product), the blocks of the grid (the stream
    route's has R more: each rho index's partial last block), the block's
    dynamic shared memory, how many blocks an SM holds at once, the route
    and the doubles of one operator panel (the stream route; 0 else)."""

    lanes: int
    groups: int
    rpt: int
    blocks: int
    smem_bytes: int
    per_sm: int
    route: str = "shared"
    panel: int = 0


def k1_smem_bytes(n: int, R: int, refine_steps: int, lanes: int, groups: int, rpt: int) -> int:
    """Dynamic shared memory of one K1 block, all fp64: the K^-1 stack (and
    K when refining) at :func:`row_strides`, and two vector buffers of
    ``lanes`` lanes whose rows (padded ones included) are rounded up to
    pairs (csrc/admm_diag.cu)."""
    _, sk = row_strides(n, lanes)
    stacks = 2 if refine_steps > 0 else 1
    slots = (groups * rpt + 1) & ~1
    return (stacks * R * sk + 2 * slots * lanes) * 8


def blocks_per_sm(threads: int, smem_bytes: int, registers: int) -> int:
    """Blocks of ``threads`` threads, ``smem_bytes`` of dynamic shared
    memory and ``registers`` a thread that one SM holds at once: the least
    of what its shared memory, threads, registers (allocated per warp in
    units of 256) and block slots allow."""
    warps = -(-threads // 32)
    per_warp = -(-registers * 32 // 256) * 256
    return min(SM_SMEM // (smem_bytes + SM_SMEM_PER_BLOCK), SM_THREADS // threads,
               SM_REGISTERS // (warps * per_warp), SM_BLOCKS)


def _k1_layouts(n: int, R: int, refine_steps: int, mode: str = "highest"):
    """Every (lanes, groups, rpt, smem_bytes, per_sm) K1 can launch for this
    operator shape at precision ``mode``: whole warps, an instantiated row
    count, no more threads than it allows, a block within the card's
    shared memory (the same bytes at every precision)."""
    if not 1 <= n <= MAX_N:
        return
    for lanes in LANES:
        step = max(1, 32 // lanes)
        for groups in range(step, 512 // lanes + 1, step):
            rpt = -(-n // groups)
            if rpt not in K1_INSTANCES:
                continue
            threads = K1_INSTANCES[rpt][0]
            registers = _registers("K1", K1_INSTANCES, rpt, refine_steps, mode)
            if lanes * groups > threads:
                continue
            smem = k1_smem_bytes(n, R, refine_steps, lanes, groups, rpt)
            if smem <= SMEM_LIMIT:
                yield lanes, groups, rpt, smem, blocks_per_sm(lanes * groups, smem, registers)


@functools.lru_cache(maxsize=256)  # the driver asks once per chunk
def k1_plan(n: int, R: int, refine_steps: int, B: int,
            lanes: Optional[int] = None, groups: Optional[int] = None,
            mode: str = "highest", route: Optional[str] = None) -> K1Plan:
    """The layout of a K1 launch for ``B`` lanes, from the shape alone.

    The shared route where some layout of it fits (every rho's fp64 K^-1,
    and K when refining, in one block's shared memory), else the stream
    route (:func:`k12_stream_plan`), so that every shape the shared route
    takes keeps its plan. On the shared route the busiest SM runs
    ceil(ceil(B / L) / 132) blocks of L lanes; several of them at once
    where its shared memory, threads and the instantiation's registers
    allow (tier 1's operators take 25 KB, so up to 4 blocks of 32 lanes
    share an SM). A lane reads per iteration an operator entry per
    multiply-add, padded rows included, and its vector once per thread, so
    fewer row-groups G read less; the cost (:func:`_warp_cost`) counts the
    warps resident on the SM, not those of one block. Ties go to more lanes
    per block. ``lanes`` and ``groups`` force a layout, ``route`` a route
    of ``K12_ROUTES`` (ValueError if it does not fit). ``mode``, a
    precision of ``PRECISIONS``, sets the registers the shared route's
    instantiations take; the bytes are the same at every precision."""
    B = int(B)
    _check_mode(mode)
    if B < 1:
        raise ValueError(f"K1 takes at least one lane; B={B}")
    if n * B >= 2**31:
        raise ValueError(f"K1 indexes the (n, B) state with 32 bits; n={n}, B={B}")
    if route not in (None,) + K12_ROUTES:
        raise ValueError(f"K1 routes are {K12_ROUTES}, not {route!r}")
    products = 1 + 2 * int(refine_steps)
    best, shared = None, False
    for L, G, rpt, smem, per_sm in _k1_layouts(n, R, int(refine_steps), mode):
        shared = True
        if route == "stream" or lanes not in (None, L) or groups not in (None, G):
            continue
        blocks = -(-B // L)
        busiest = -(-blocks // SM_COUNT)
        warps = min(per_sm, busiest) * L * G / 32
        cost = _warp_cost(busiest * L, (G * rpt + G) * n * products, warps)
        key = (cost, -L)
        if best is None or key < best[0]:
            best = (key, K1Plan(L, G, rpt, blocks, smem, per_sm))
    if best is not None:
        return best[1]
    stream = None
    if route == "stream" or (route is None and not shared):
        stream = k12_stream_plan(n, 0, R, refine_steps, B, lanes, groups)
    if stream is None:
        raise ValueError(
            f"no K1 layout for n={n}, R={R}, refine_steps={refine_steps}"
            + ("" if lanes is None and groups is None else f", lanes={lanes}, groups={groups}")
            + ("" if route is None else f" on the {route} route")
            + f": K1 takes n <= {MAX_N} with every rho's operators in a block's "
            f"{SMEM_LIMIT} B of shared memory, or n <= {MAX_STREAM_N} on its stream route"
        )
    L, G, rows, smem, per_sm, panel = stream
    return K1Plan(L, G, rows, -(-B // L) + R, smem, per_sm, "stream", panel)


def k1_fits(n: int, R: int, refine_steps: int) -> bool:
    """Whether K1 takes this operator shape: a layout of its shared route
    (n <= 128, every rho's operators within the card's shared memory) or
    of its stream route (n <= 1024)."""
    return (next(_k1_layouts(n, R, refine_steps), None) is not None
            or bool(_k12_stream_layouts(n, 0, int(refine_steps))))


# K2's instantiated rows per thread of the box and of the tail
# (csrc/admm_mixed.cu, MPC_K2_RPT_N / MPC_K2_RPT_T)
K2_RPT_N = (1, 2, 3, 4)
K2_RPT_T = (1, 2, 3, 4, 5, 6, 8)
# the C entry's int parameters, in order (the wrapper passes them so)
K2_INTS = ("n", "m", "B", "R", "chunk", "refine_steps", "mode", "lanes", "groups", "rpt_n",
           "rpt_t", "smem_bytes")
K2_STREAM_INTS = ("n", "m", "B", "R", "chunk", "refine_steps", "mode", "lanes", "groups",
                  "rpt_n", "panel", "smem_bytes")


class K2Plan(NamedTuple):
    """How one K2 launch is laid out: lanes and row-groups of a block
    (blockDim.x, blockDim.y), the box and tail rows each thread owns (on
    the stream route in each tile of a product), the blocks of the grid
    (the stream route's has R more), the block's dynamic shared memory,
    the route and the doubles of one operator panel (the stream route; 0
    else)."""

    lanes: int
    groups: int
    rpt_n: int
    rpt_t: int
    blocks: int
    smem_bytes: int
    route: str = "shared"
    panel: int = 0


def k2_max_threads(rpt_n: int, rpt_t: int) -> int:
    """The most threads a K2 block of these rows per thread may have
    (csrc/admm_mixed.cu, max_threads): 512 where a thread's rows fit 128
    registers (no spills at 512 threads, measured), else 256."""
    return 512 if rpt_t <= 4 and (rpt_n <= 2 or (rpt_n == 3 and rpt_t <= 2)) else 256


def k2_smem_bytes(n: int, m: int, R: int, refine_steps: int, lanes: int, groups: int,
                  rpt_n: int, rpt_t: int) -> int:
    """Dynamic shared memory of one K2 block, all fp64: the K^-1 stack (and
    K when refining) at :func:`row_strides`; A2 (rows at the same stride);
    two box-row and two tail-row buffers of ``lanes`` lanes, their rows
    (padded ones included) rounded up to pairs (csrc/admm_mixed.cu)."""
    ld, sk = row_strides(n, lanes)
    stacks = 2 if refine_steps > 0 else 1
    slots = lambda rows: (rows + 1) & ~1
    buffers = 2 * (slots(groups * rpt_n) + slots(groups * rpt_t)) * lanes
    return (stacks * R * sk + (m - n) * ld + buffers) * 8


def _k2_layouts(n: int, m: int, R: int, refine_steps: int):
    """Every (lanes, groups, rpt_n, rpt_t, smem_bytes) K2 can launch for
    this operator shape: whole warps, an instantiated row count, no more
    threads than its registers allow, a block within the card's shared
    memory."""
    ms = m - n
    if not (1 <= n <= MAX_N and 1 <= ms <= MAX_TAIL):
        return
    for lanes in LANES:
        step = max(1, 32 // lanes)
        for groups in range(step, 512 // lanes + 1, step):
            rpt_n, rpt_t = -(-n // groups), -(-ms // groups)
            if rpt_n not in K2_RPT_N or rpt_t not in K2_RPT_T:
                continue
            if lanes * groups > k2_max_threads(rpt_n, rpt_t):
                continue
            smem = k2_smem_bytes(n, m, R, refine_steps, lanes, groups, rpt_n, rpt_t)
            if smem <= SMEM_LIMIT:
                yield lanes, groups, rpt_n, rpt_t, smem


@functools.lru_cache(maxsize=256)  # the driver asks once per chunk
def k2_plan(n: int, m: int, R: int, refine_steps: int, B: int,
            lanes: Optional[int] = None, groups: Optional[int] = None,
            mode: str = "highest", route: Optional[str] = None) -> K2Plan:
    """The layout of a K2 launch for ``B`` lanes, from the shape alone.

    The shared route where some layout of it fits (every rho's fp64 K^-1,
    K when refining, and A2 in one block's shared memory), else the stream
    route (:func:`k12_stream_plan`). On the shared route one block per SM
    (its shared memory holds every rho's operators), so the time is the
    lanes an SM runs, ceil(ceil(B / L) / 132) L (16 at B = 2048, 4 at
    B = 512), times a lane's reads (:func:`_warp_cost`): an operator entry
    per multiply-add, padded rows included, and the lane vectors once per
    thread, so fewer row-groups G read less; the warps are those of one
    block. Ties go to more lanes per block. ``lanes`` and
    ``groups`` force a layout, ``route`` a route of ``K12_ROUTES``
    (ValueError if it does not fit). Every precision ``mode`` has the same
    layouts: the same bytes, and one block an SM whatever its registers."""
    B = int(B)
    _check_mode(mode)
    if B < 1:
        raise ValueError(f"K2 takes at least one lane; B={B}")
    if m * B >= 2**31:
        raise ValueError(f"K2 indexes the (m, B) state with 32 bits; m={m}, B={B}")
    if route not in (None,) + K12_ROUTES:
        raise ValueError(f"K2 routes are {K12_ROUTES}, not {route!r}")
    ms, rs = m - n, int(refine_steps)
    best, shared = None, False
    for L, G, rpt_n, rpt_t, smem in _k2_layouts(n, m, R, rs):
        shared = True
        if route == "stream" or lanes not in (None, L) or groups not in (None, G):
            continue
        blocks = -(-B // L)
        box, tail = G * rpt_n, G * rpt_t
        operator = box * ((1 + 2 * rs) * n + ms) + tail * n
        vectors = G * ((2 + 2 * rs) * n + 2 * ms)
        cost = _warp_cost(-(-blocks // SM_COUNT) * L, operator + vectors, L * G // 32)
        key = (cost, -L)
        if best is None or key < best[0]:
            best = (key, K2Plan(L, G, rpt_n, rpt_t, blocks, smem))
    if best is not None:
        return best[1]
    stream = None
    if ms >= 1 and (route == "stream" or (route is None and not shared)):
        stream = k12_stream_plan(n, ms, R, rs, B, lanes, groups)
    if stream is None:
        raise ValueError(
            f"no K2 layout for n={n}, m={m}, R={R}, refine_steps={rs}"
            + ("" if lanes is None and groups is None else f", lanes={lanes}, groups={groups}")
            + ("" if route is None else f" on the {route} route")
            + f": K2 takes n <= {MAX_N} and 1 to {MAX_TAIL} dense rows with every rho's "
            f"operators in a block's {SMEM_LIMIT} B of shared memory, or n <= {MAX_STREAM_N} "
            f"and 1 to {MAX_STREAM_TAIL} dense rows on its stream route"
        )
    L, G, rows, smem, _, panel = stream
    return K2Plan(L, G, rows, rows, -(-B // L) + R, smem, "stream", panel)


def k2_fits(n: int, m: int, R: int, refine_steps: int) -> bool:
    """Whether K2 takes this operator shape: a dense tail of at least one
    row and a layout of its shared route (n <= 128, a tail of at most 128
    rows, every rho's operators within the card's shared memory) or of its
    stream route (n <= 1024, a tail of at most 1024 rows)."""
    return m > n and (next(_k2_layouts(n, m, R, refine_steps), None) is not None
                      or bool(_k12_stream_layouts(n, m - n, int(refine_steps))))


# K4's and K5's wide route ranks its layouts (_wide_cost) in clocks of one
# SM, as _k12_stream_cost ranks K1's and K2's: a warp's fp64 multiply-add
# takes 2 clocks of its quarter of the SM (16 a clock each), its 16-byte
# shared-memory load 4 of the SM (K12_LOAD_CLOCKS), and a warp's column
# pair at least its own serial time (WIDE_PAIR_CLOCKS, and a load's and a
# multiply-add's issue each after it: what sets a product of one or two
# warps, as K4's 20-row pass); L2 as K12_L2_BYTES_PER_CLOCK and
# K12_SM_L2_BYTES_PER_CLOCK; one L2 round trip (a panel takes at least its
# share of one over the depth - 1 in flight). The rest is fit to the
# kernel's steps timed phase by phase on the H100
# (scripts/wide_phase_probe.py, PERF.md section 6): an entry's
# widening and a copied entry's issue, a panel's barrier and bookkeeping, a
# tile's epilogue for each row a thread takes (round trips of its state to
# L2), the reload of the vector buffer, a cluster's barrier, and the ring's
# restart each iteration. The model lies within 15% of 12 layouts timed by
# k3_ab.py, but where a grid past 132 blocks would run a second
# wave (it counts every rho index but one ending in a partial cluster).
WIDE_PAIR_CLOCKS = 60
WIDE_PAIR_LOAD_CLOCKS = 6
WIDE_PAIR_FMA_CLOCKS = 2
WIDE_LATENCY = 2000
WIDE_WIDEN_CLOCKS = 0.27
WIDE_ISSUE_CLOCKS = 0.2
WIDE_STEP_CLOCKS = 400
WIDE_ROW_CLOCKS = 1500
WIDE_RELOAD_CLOCKS = 1500
WIDE_CLUSTER_CLOCKS = 1000
WIDE_RESTART_CLOCKS = 8000
# layouts whose modelled costs lie within this share of the least are
# ranked as equal, and the plan takes the one of them that reads the
# fewest L2 operator bytes a chunk: at K4's (20, 660, R = 2, B = 2048) 16
# lanes a block and clusters of two blocks of 32 lanes model 2% apart and
# ran 1.570 and 1.581 ms on the H100 (scripts/wide_phase_probe.py,
# PERF.md section 6), the second on half the L2 bytes
WIDE_COST_TIE = 0.05


# K1's and K2's stream route ranks its layouts (_k12_stream_cost) in clocks
# of one SM: the fp64 multiply-adds it starts a clock, the clocks a warp's
# 16-byte shared-memory load takes (scripts/fp64_rate_probe.py: a 4 x 4
# register tile fed so runs 32 multiply-adds a clock, 8 x 4 42) and the
# warps it needs resident to keep its pipes fed; the card's L2 rate in
# bytes a clock (about 2 TB/s at 1980 MHz, the rate the wide route's copies
# reach, PERF.md), shared by the blocks a launch keeps busy, and one SM's
# most; a streamed panel's barrier and staging; a tile's epilogue (its
# state's round trips to L2). The last two are fit to 14 layouts forced
# by k3_ab.py --kernel K1 and K2 on the H100 (PERF.md section 6): the
# model's times lie within about 20% of theirs and rank each shape's
# fastest first.
K12_FMA_PER_CLOCK = 64
K12_LOAD_CLOCKS = 4
K12_WARPS = 8
K12_L2_BYTES_PER_CLOCK = 1000
K12_SM_L2_BYTES_PER_CLOCK = 64
K12_PANEL_CLOCKS = 3000
K12_TILE_CLOCKS = 1500


def k12_lanes_per_thread(lanes: int) -> int:
    """The lanes a thread of K1's and K2's stream route takes
    (csrc/admm_diag_stream.cu, lanes_per_thread): 4 in a block of at least
    ``K12_WIDE_LANES`` lanes, 2 in one of ``K12_MID_LANES``, 1 in a smaller
    one."""
    return 4 if lanes >= K12_WIDE_LANES else 2 if lanes >= K12_MID_LANES else 1


def k12_rows_options(lanes: int, tail: bool) -> tuple:
    """The rows a thread of K1's (``tail`` false) or K2's stream route may
    take in each tile of its products but K2's A2' pass, which takes
    ``K12_PASS_ROWS`` (csrc/admm_diag_stream.cu, rows_fit): 4, or 8 in
    K1's blocks of 4 lanes a thread."""
    if k12_lanes_per_thread(lanes) == 4 and not tail:
        return (K12_PASS_ROWS, 2 * K12_PASS_ROWS)
    return (K12_PASS_ROWS,)


def _round4(v: int) -> int:
    return (v + 3) & ~3


def k12_stream_smem_bytes(n: int, ms: int, lanes: int, panel: int) -> int:
    """Dynamic shared memory of one block of K1's (ms = 0) or K2's stream
    route (csrc/admm_diag_stream.cu): two operator panels of ``panel``
    doubles; the box rows' two lane buffers and K2's tail rows' two, fp64,
    of ``lanes`` lanes, their rows rounded up to pairs."""
    nslots, tslots = (n + 1) & ~1, (ms + 1) & ~1
    return 8 * (2 * panel + 2 * (nslots + tslots) * lanes)


def _full_stride(ld: int) -> int:
    """The least row stride, at least ld, whose rows a warp reads without
    bank conflicts: a whole row of a resident operator."""
    return _panel_stride(ld + 2, 1, ld)


def _k12_resident_doubles(n: int, ms: int, refine_steps: int) -> int:
    """The doubles one rho's operators take whole in shared memory on K1's
    and K2's stream route, widened to 8-byte entries, rows of 4-entry
    chunks: K^-1, K when refining, and for K2 A2' and A2."""
    fn = _full_stride(_round4(n))
    ft = _full_stride(_round4(ms)) if ms else 0
    return n * fn * (2 if refine_steps > 0 else 1) + n * ft + ms * fn


class K12StreamLayout(NamedTuple):
    """The stream route's layout of one K1 or K2 launch
    (csrc/admm_diag_stream.cu, make_layout): whether one rho's operators
    stay whole in the two panels for the chunk, and the row stride and
    columns of a panel of an n-column operator (K^-1, K, A2) and of A2'."""

    resident: bool
    sn: int
    pn: int
    st: int
    pt: int


def k12_stream_layout(n: int, ms: int, refine_steps: int, lanes: int, groups: int,
                      rows: int, panel: int) -> Optional[K12StreamLayout]:
    """The layout the C entry derives from a plan (csrc/admm_diag_stream.cu,
    make_layout): resident where every operator fits the two panels whole,
    else panels of a tile's rows (``rows`` ``groups``, ``K12_PASS_ROWS``
    ``groups`` for K2's A2') and at most the columns the block's threads
    stage (``K12_STREAM_STAGE`` chunks of 4 a thread); None where a panel
    holds fewer than 4 columns."""
    ldn, ldm = _round4(n), _round4(ms)
    if _k12_resident_doubles(n, ms, refine_steps) <= 2 * panel:
        return K12StreamLayout(True, _full_stride(ldn), ldn, _full_stride(ldm) if ms else 0, ldm)
    capt = K12_STREAM_STAGE * (lanes // k12_lanes_per_thread(lanes))
    sn = _panel_stride(panel, rows * groups, min(ldn, capt * K12_PASS_ROWS // rows))
    st = _panel_stride(panel, K12_PASS_ROWS * groups, min(ldm, capt)) if ms else 0
    pn, pt = sn - 2, (st - 2 if ms else 0)
    if pn < 4 or (ms and pt < 4):
        return None
    return K12StreamLayout(False, sn, pn, st, pt)


@functools.lru_cache(maxsize=256)
def _k12_stream_layouts(n: int, ms: int, refine_steps: int) -> tuple:
    """Every (lanes, groups, rows, smem_bytes, per_sm, panel) of K1's (ms =
    0) or K2's stream route for this operator shape: lanes of
    ``K12_STREAM_LANES``, whole warps of at most 256 threads (a thread
    takes :func:`k12_lanes_per_thread` lanes and the rows of
    :func:`k12_rows_options`), tiles no taller than the rows need, the
    largest panel that fits beside the lane buffers with one or with two
    blocks an SM, up to what
    the operators can use (all of one rho's operators whole, or whole rows
    of a tile up to the columns the threads stage), and a panel of at
    least 8 columns of a tile, or whole rows."""
    if not (1 <= n <= MAX_STREAM_N and 0 <= ms <= MAX_STREAM_TAIL):
        return ()
    rows = max(n, ms)
    ldn, ldm = _round4(n), _round4(ms)
    whole = _k12_resident_doubles(n, ms, refine_steps)
    wide_enough = lambda cols, ld: cols >= min(8, ld)
    out = []
    for lanes in K12_STREAM_LANES:
        lg = lanes // k12_lanes_per_thread(lanes)
        capt = K12_STREAM_STAGE * lg
        step = max(1, 32 // lg)
        fixed = k12_stream_smem_bytes(n, ms, lanes, 0)
        for rt in k12_rows_options(lanes, ms > 0):
            for groups in range(step, K12_STREAM_THREADS // lg + 1, step):
                if rt * (groups - step) >= rows:
                    break  # fewer groups cover the rows in one tile
                most = max(-(-whole // 2),
                           rt * groups * (min(ldn, capt * K12_PASS_ROWS // rt) + 2),
                           K12_PASS_ROWS * groups * (min(ldm, capt) + 2) if ms else 0)
                most += most & 1
                panels = set()
                for per in (1, 2):  # the largest panel with `per` blocks an SM
                    room = min(SMEM_LIMIT, SM_SMEM // per - SM_SMEM_PER_BLOCK) - fixed
                    panels.add(min(most, max(room, 0) // 16) & ~1)
                for panel in sorted(panels, reverse=True):
                    lay = (k12_stream_layout(n, ms, refine_steps, lanes, groups, rt, panel)
                           if panel else None)
                    if lay is None or not (lay.resident or (
                            wide_enough(lay.pn, ldn) and (not ms or wide_enough(lay.pt, ldm)))):
                        continue
                    smem = k12_stream_smem_bytes(n, ms, lanes, panel)
                    per_sm = blocks_per_sm(lg * groups, smem, K12_STREAM_REGISTERS)
                    out.append((lanes, groups, rt, smem, per_sm, panel))
    return tuple(out)


def k12_scratch_floats(n: int, m: int, refine_steps: int, blocks: int, lanes: int) -> int:
    """The device scratch of one K1 (m = n) or K2 launch on the stream route
    (csrc/admm_diag_stream.cu): a region per block, of a column per lane, of
    the lanes' working copy (x and q, n rows each; s, y, ax, l and u, m rows
    each) and, when refining, of the refinement's rhs and xt (n rows
    each)."""
    return (2 * n + 5 * m + (2 * n if refine_steps > 0 else 0)) * blocks * lanes


def k12_blocks_used(R: int, B: int, lanes: int) -> int:
    """The blocks of ``lanes`` lanes that a batch of B lanes spread evenly
    over R rho indices fills (the grid has R more than B needs, one partial
    block per index; the rest return at once)."""
    held = min(R, B)
    return min(-(-B // lanes) + R, held * -(-B // (held * lanes)))


def _k12_products(n: int, ms: int, refine_steps: int, rt: int,
                  lay: K12StreamLayout) -> list:
    """(rows, columns, a panel's columns, vectors, rows a thread) of each
    product of one iteration of K1's (ms = 0) or K2's stream route at
    ``rt`` rows a thread: the K-solves and products, K2's A2' pass (two
    vectors) and A2 xt."""
    products = [(n, n, lay.pn, 1, rt)] * (1 + 2 * int(refine_steps))
    if ms:
        products += [(n, ms, lay.pt, 2, K12_PASS_ROWS), (ms, n, lay.pn, 1, rt)]
    return products


def k12_stream_l2_bytes(n: int, ms: int, R: int, refine_steps: int, B: int, lanes: int,
                        groups: int, rows: int, panel: int, chunk: int) -> int:
    """The operator bytes one chunk of ``chunk`` iterations of K1's (ms =
    0) or K2's stream route reads from L2 on this layout: each block one
    rho's operators as 4-byte entries, rows padded to 4 (K^-1 for every
    solve, K for every refinement, K2's A2' and A2), every iteration where
    they are streamed, once a chunk where they are resident, over the
    blocks B lanes spread evenly over R rho indices fill
    (:func:`k12_blocks_used`)."""
    lay = k12_stream_layout(n, ms, refine_steps, lanes, groups, rows, panel)
    ldn, ldm = _round4(n), _round4(ms)
    if lay.resident:
        entries = (2 if refine_steps > 0 else 1) * n * ldn + n * ldm + ms * ldn
    else:
        entries = sum(r * _round4(cols) for r, cols, _, _, _ in
                      _k12_products(n, ms, refine_steps, rows, lay))
        entries *= chunk
    return 4 * entries * k12_blocks_used(R, B, lanes)


def _k12_stream_cost(n: int, ms: int, R: int, refine_steps: int, B: int, lanes: int,
                     groups: int, rows: int, per_sm: int, panel: int) -> float:
    """The stream route's cost of a layout, for ranking: clocks of the
    busiest SM per iteration. Its blocks each take their products' tiles
    and panels in turn. A warp's two columns of a tile cost the larger of
    its fp64 multiply-adds (its rows x lanes x the vectors, 64 a clock on
    the SM) and its 16-byte shared-memory loads (a row's operator entries,
    a lane's vector entries, ``K12_LOAD_CLOCKS`` each), padded rows
    included, times ``K12_WARPS`` over the warps resident where fewer; a
    streamed panel takes at least its copy from L2 (4 bytes an entry, the
    card's rate shared by the blocks at work) and ``K12_PANEL_CLOCKS``
    more, a resident product one such step; each tile's epilogue
    ``K12_TILE_CLOCKS``."""
    lay = k12_stream_layout(n, ms, refine_steps, lanes, groups, rows, panel)
    lt = k12_lanes_per_thread(lanes)
    lg = lanes // lt
    used = k12_blocks_used(R, B, lanes)
    busiest = -(-used // SM_COUNT)
    at_once = min(per_sm, busiest)
    l2 = min(K12_SM_L2_BYTES_PER_CLOCK, K12_L2_BYTES_PER_CLOCK / min(used, SM_COUNT * at_once))
    warps = lg * groups / 32
    slow = max(1.0, K12_WARPS / (at_once * warps))
    cost = 0.0
    for height_all, cols, pk, vectors, rt in _k12_products(n, ms, refine_steps, rows, lay):
        pair = max(2 * rt * lt * vectors * 32 / K12_FMA_PER_CLOCK,
                   K12_LOAD_CLOCKS * (rt + lt * vectors))
        H = rt * groups
        tiles = -(-height_all // H)
        cost += tiles * K12_TILE_CLOCKS
        if lay.resident:
            cost += tiles * -(-cols // 2) * warps * pair * slow + K12_PANEL_CLOCKS
            continue
        for tile in range(tiles):
            height = min(H, height_all - tile * H)
            for c0 in range(0, cols, pk):
                width = min(pk, cols - c0)
                compute = -(-width // 2) * warps * pair * slow
                copy = height * _round4(width) * 4 / l2
                cost += max(compute, copy) + K12_PANEL_CLOCKS
    return busiest * cost


@functools.lru_cache(maxsize=256)
def k12_stream_plan(n: int, ms: int, R: int, refine_steps: int, B: int,
                    lanes: Optional[int] = None,
                    groups: Optional[int] = None) -> Optional[tuple]:
    """The (lanes, groups, rows, smem_bytes, per_sm, panel) of the cheapest
    layout of K1's (ms = 0) or K2's stream route for ``B`` lanes
    (:func:`_k12_stream_cost`; ties go to more lanes a block), or None
    where none fits. ``lanes`` and ``groups`` force a layout."""
    best = None
    for L, G, rt, smem, per_sm, panel in _k12_stream_layouts(n, ms, int(refine_steps)):
        if lanes not in (None, L) or groups not in (None, G):
            continue
        cost = _k12_stream_cost(n, ms, R, refine_steps, B, L, G, rt, per_sm, panel)
        key = (cost, -L, -panel, rt)
        if best is None or key < best[0]:
            best = (key, (L, G, rt, smem, per_sm, panel))
    return None if best is None else best[1]


def _padded_flops_per_lane(n: int, m: int, R: int, rs: int, packed: bool) -> int:
    """The JAX package's cost model (``admm_pallas._padded_flops_per_lane``):
    multiply-adds per lane and iteration with every GEMM operand padded to
    the TPU's 128-wide tile, for the packed (K4) and per-rho (K5) bodies."""
    pad = lambda v: -(-v // 128) * 128
    if packed:
        f = 2 * pad(m) * pad((R + 1) * n)
        f += pad(R * n) * pad(R * (n + m))
        f += rs * (pad(n) * pad(R * n) + pad(n) * pad(R * (n + m)))
    else:
        f = pad(m) * pad(n)
        f += R * (pad(m) * pad(n) + pad(n) * pad(n))
        f += rs * 2 * R * pad(n) * pad(n)
        f += pad(n) * pad(m)
    return f


def use_packed(n: int, m: int, R: int, refine_steps: int = 1) -> bool:
    """Whether a dense operator of this shape runs K4 (packed) or K5 (per
    rho): the JAX package's rule (``admm_pallas._use_packed``), its padded-
    tile cost model with a cap on the packed operator's size.

    K4 forms the constraint image through K_r^-1 A' and K5 as A x, so the two
    round differently and converge in different iteration counts. The port
    keeps the JAX rule, measured on the TPU, so that both packages compute
    the same function at every shape; re-deciding the split for this card is
    later work (ROADMAP Queue 2)."""
    if R * n * R * (n + m) * 4 > 2 * 2**20:
        return False
    return _padded_flops_per_lane(n, m, R, refine_steps, True) <= _padded_flops_per_lane(
        n, m, R, refine_steps, False
    )


def k4_fits(n: int, m: int, R: int) -> bool:
    """Whether K4 takes this operator shape, a layout on some route at any
    R (:func:`k4_plan`): as K5 (:func:`k5_fits`)."""
    return k5_fits(n, m, R)


def k5_fits(n: int, m: int, R: int) -> bool:
    """Whether K5 takes this operator shape, a layout on some route at any
    R (:func:`k5_plan`): n <= 1024 and 1 to 4096 constraint rows (every
    dense shape the JAX package's ``fused_fits`` admits: n up to 582, up
    to 3839 rows). Every shape with n <= 128 and 1 to 512 rows has a layout
    on the stream route, whose shared memory holds the lane buffers and two
    operator panels whatever R is, and every other one on the wide route,
    whose lane buffers of one lane and two panels of 8 columns of a tile
    take at most 139 KB (n = 1024, m = 4096, K4's with refinement). K4
    takes the same (:func:`k4_fits`)."""
    return 1 <= n <= MAX_WIDE_N and 1 <= m <= MAX_WIDE_ROWS


# K5's shared route (csrc/admm_perr.cu, MPC_K5_INSTANCES) and stream route
# (MPC_K5_STREAM_INSTANCES): rows per thread (variable rows, constraint
# rows) -> the most threads a block of it may have and the registers a
# thread takes without and with refinement (nvcc 12.9's -Xptxas -v report
# on the H100; within the budgets the sources hold them to)
K5_INSTANCES = {(1, 3): (512, 113, 108), (2, 5): (384, 157, 156), (2, 6): (320, 168, 168),
                (3, 8): (256, 236, 229), (3, 9): (256, 244, 242)}
K5_STREAM_INSTANCES = {(2, 6): (384, 135, 129), (3, 8): (448, 128, 128),
                       (4, 10): (480, 128, 128)}
# K4's instantiations of the same two kernels (PACKED: MPC_K4_INSTANCES and
# MPC_K4_STREAM_INSTANCES), as K5's
K4_INSTANCES = {(1, 2): (512, 87, 105), (1, 3): (512, 119, 120), (2, 3): (384, 125, 144),
                (2, 6): (320, 168, 168), (3, 4): (256, 161, 201)}
K4_STREAM_INSTANCES = {(2, 3): (384, 116, 125), (2, 6): (384, 153, 151), (3, 4): (256, 143, 141),
                       (3, 8): (320, 168, 168)}
# the registers a thread of each instantiation takes, without and with
# refinement, at the bf16 precisions (K1, K4 and K5 on each route; the
# tables above hold "highest"'s), within the same budgets (nvcc 12.9's
# -Xptxas -v report on the H100; K5-stream (4, 10) spills 156 bytes at
# bf16x3, 24 at default)
PRECISION_REGISTERS = {
    "bf16x3": {
        "K1": {1: (46, 54), 2: (72, 84), 3: (101, 113), 4: (121, 128), 5: (128, 162),
               6: (157, 182), 7: (172, 204), 8: (191, 224)},
        "K5": {(1, 3): (101, 101), (2, 5): (161, 145), (2, 6): (161, 149), (3, 8): (179, 181),
               (3, 9): (190, 191)},
        "K5-stream": {(2, 6): (151, 151), (3, 8): (128, 128), (4, 10): (128, 128)},
        "K4": {(1, 2): (91, 95), (1, 3): (107, 128), (2, 3): (124, 136), (2, 6): (167, 168),
               (3, 4): (172, 171)},
        "K4-stream": {(2, 3): (129, 128), (2, 6): (168, 167), (3, 4): (158, 157),
                      (3, 8): (168, 168)},
    },
    "default": {
        "K1": {1: (37, 50), 2: (56, 72), 3: (72, 94), 4: (96, 115), 5: (127, 139),
               6: (128, 168), 7: (160, 190), 8: (168, 216)},
        "K5": {(1, 3): (104, 95), (2, 5): (142, 128), (2, 6): (158, 162), (3, 8): (208, 191),
               (3, 9): (216, 201)},
        "K5-stream": {(2, 6): (128, 128), (3, 8): (127, 127), (4, 10): (128, 128)},
        "K4": {(1, 2): (69, 89), (1, 3): (96, 94), (2, 3): (96, 119), (2, 6): (168, 168),
               (3, 4): (121, 161)},
        "K4-stream": {(2, 3): (111, 109), (2, 6): (146, 146), (3, 4): (135, 127),
                      (3, 8): (168, 168)},
    },
}


def _check_mode(mode: str) -> None:
    if mode not in PRECISIONS:
        raise ValueError(f"unknown kernel_precision {mode!r}: the fused kernels compute "
                         f"{PRECISIONS}, and their driver the schedule 'hybrid'")


def _registers(name: str, table: dict, key, refine_steps: int, mode: str) -> int:
    """The registers a thread of instantiation ``key`` of kernel ``name``
    (K1, K5, K5-stream, K4, K4-stream) takes at precision ``mode``."""
    regs = table[key][1:] if mode == "highest" else PRECISION_REGISTERS[mode][name][key]
    return regs[1 if refine_steps > 0 else 0]


# the C entries' int parameters, in order (the wrapper passes them so), of
# K4's as of K5's
K5_INTS = ("n", "m", "B", "R", "chunk", "refine_steps", "mode", "lanes", "groups", "rpt_n",
           "rpt_m", "smem_bytes")
K5_STREAM_INTS = ("n", "m", "B", "R", "chunk", "refine_steps", "mode", "lanes", "groups",
                  "rpt_n", "rpt_m", "panel", "smem_bytes")
K5_WIDE_INTS = ("n", "m", "B", "R", "chunk", "refine_steps", "mode", "lanes", "rt_pass", "lt_pass",
                "rt", "lt", "depth", "panel", "cluster", "smem_bytes")
# "shared": admm_perr_chunk / admm_packed_chunk (K5 / K4, csrc/admm_perr.cu),
# every rho's fp64 operators in shared memory; "stream":
# admm_perr_stream_chunk / admm_packed_stream_chunk (the same file), lanes
# grouped by rho index, one rho's fp64 operators streamed through shared
# panels, a thread's rows in registers; "wide": admm_perr_wide_chunk /
# admm_packed_wide_chunk (csrc/admm_perr_wide.cu), lanes grouped by rho
# index, each product a register tile of rows x lanes a thread over one
# rho's 4-byte operators widened panel by panel, the lane state in a
# working copy in device memory, at any n <= 1024 and up to 4096 rows,
# where neither of the others has a layout
DENSE_ROUTES = ("shared", "stream", "wide")


class DensePlan(NamedTuple):
    """How one K4 or K5 launch is laid out: the route, lanes and row-groups
    of a block (blockDim.x, blockDim.y), the variable and constraint rows
    each thread owns, the blocks of the grid (on the stream route, whose
    blocks take lanes of one rho index each, R more: each index's partial
    last one), the block's dynamic shared memory, how many blocks an SM
    holds at once, and the doubles of one operator panel (the stream route;
    0 else)."""

    route: str
    lanes: int
    groups: int
    rpt_n: int
    rpt_m: int
    blocks: int
    smem_bytes: int
    per_sm: int
    panel: int = 0


def rho_stride(m: int) -> int:
    """The stride, in floats, of the rows of K5's fp32 rho table: even (a
    lane reads rho_i, rho_i+1 as one 8-byte load) and odd in 8-byte units
    (lanes of distinct rho indices read distinct banks); csrc/admm_perr.cu,
    rho_stride."""
    mr = m + (m & 1)
    return mr + 2 if (mr // 2) % 2 == 0 else mr


def k5_smem_bytes(n: int, m: int, R: int, refine_steps: int, lanes: int, groups: int,
                  rpt_n: int, rpt_m: int, packed: bool = False) -> int:
    """Dynamic shared memory of one block of K5's shared route, or K4's
    (``packed``; csrc/admm_perr.cu): in fp64 the K^-1 stack (and K when
    refining), R copies at :func:`row_strides`, A with rows at the same
    stride (K4: kia_r transposed, R copies of m rows, at (m ld) | 2), four
    lane buffers of ``lanes`` lanes whose rows (padded ones included) are
    rounded up to pairs; in fp32 the rho table and A."""
    ld, sk = row_strides(n, lanes)
    stacks = 2 if refine_steps > 0 else 1
    nslots, mslots = (groups * rpt_n + 1) & ~1, (groups * rpt_m + 1) & ~1
    image = R * ((m * ld) | 2) if packed else m * ld
    doubles = 2 * (nslots + mslots) * lanes + stacks * R * sk + image
    floats = R * rho_stride(m) + m * n
    return 8 * doubles + 4 * floats


@functools.lru_cache(maxsize=256)
def _shared_layouts(n: int, m: int, R: int, refine_steps: int, packed: bool = False,
                    mode: str = "highest") -> tuple:
    """Every (lanes, groups, rpt_n, rpt_m, smem_bytes, per_sm) of K5's
    shared route (K4's if ``packed``) for this operator shape at precision
    ``mode``: whole warps, an instantiation whose rows cover n and m, no
    more threads than it allows, a block within the card's shared memory."""
    return tuple(_shared_layouts_of(n, m, R, refine_steps, packed, mode))


def _shared_layouts_of(n, m, R, refine_steps, packed, mode):
    if not (1 <= n <= MAX_N and 1 <= m <= MAX_DENSE_ROWS):
        return
    table = K4_INSTANCES if packed else K5_INSTANCES
    for lanes in LANES:
        step = max(1, 32 // lanes)
        for groups in range(step, 512 // lanes + 1, step):
            for (rpt_n, rpt_m), (threads, *_) in table.items():
                if groups * rpt_n < n or groups * rpt_m < m or lanes * groups > threads:
                    continue
                smem = k5_smem_bytes(n, m, R, refine_steps, lanes, groups, rpt_n, rpt_m, packed)
                if smem <= SMEM_LIMIT:
                    registers = _registers("K4" if packed else "K5", table, (rpt_n, rpt_m),
                                           refine_steps, mode)
                    per_sm = blocks_per_sm(lanes * groups, smem, registers)
                    yield lanes, groups, rpt_n, rpt_m, smem, per_sm


def k5_stream_smem_bytes(m: int, lanes: int, groups: int, rpt_n: int, rpt_m: int,
                         panel: int) -> int:
    """Dynamic shared memory of one block of K5's or K4's stream route
    (csrc/admm_perr.cu): two operator panels of ``panel`` doubles, the four
    fp64 lane buffers as on the shared route, and the block's rho and
    rho^-1 in fp32."""
    nslots, mslots = (groups * rpt_n + 1) & ~1, (groups * rpt_m + 1) & ~1
    return 8 * (2 * panel + 2 * (nslots + mslots) * lanes) + 4 * 2 * m


def _panel_stride(panel: int, rows: int, ldg: int) -> int:
    """The row stride (doubles) of a stream panel of ``rows`` rows within
    ``panel`` doubles: even, odd in 16-byte units, at most ldg + 2; 0 if
    not even 2 columns fit (csrc/admm_perr.cu, panel_stride)."""
    s = min(panel // rows, ldg + 2) & ~1
    if (s // 2) % 2 == 0:
        s -= 2
    return 0 if s < 2 else s


def k4_resident(n: int, m: int, refine_steps: int, panel: int) -> bool:
    """Whether K4's stream route keeps all of one rho's operators in its
    two panels of ``panel`` doubles for the whole chunk, copied once
    instead of once per iteration: the A'y / A'rho.s pass's m rows of A
    and fl(rho_r A), then K^-1 with kia (n + m rows) and K when refining,
    at the panels' strides (csrc/admm_perr.cu: stream_chunk's layout, with
    the pass's rows capped at m for K4, and the kernel's test)."""
    ldg = n + (n & 1)
    pc = min((panel // (2 * ldg)) & ~1, m + (m & 1))
    skn, skm = _panel_stride(panel, n, ldg), _panel_stride(panel, n + m, ldg)
    k_at = 2 * pc * ldg + (n + m) * skm
    return (pc >= m and min(skm, ldg) >= n and min(skn, ldg) >= n
            and k_at + (n * skn if refine_steps > 0 else 0) <= 2 * panel)


def _k4_resident_panel(n: int, m: int, refine_steps: int) -> int:
    """The smallest panel with which :func:`k4_resident` holds."""
    ldg, rows = n + (n & 1), m + (m & 1)
    k_rows = n if refine_steps > 0 else 0
    panel = max(2 * ldg * rows, -(-(2 * rows * ldg + (n + m + k_rows) * (ldg + 2)) // 2))
    panel += panel & 1
    while not k4_resident(n, m, refine_steps, panel):
        panel += 2
    return panel


@functools.lru_cache(maxsize=256)
def _stream_layouts(n: int, m: int, refine_steps: int, packed: bool = False,
                    mode: str = "highest") -> tuple:
    """Every (lanes, groups, rpt_n, rpt_m, smem_bytes, per_sm, panel) of
    K5's stream route (K4's if ``packed``): as :func:`_shared_layouts`, with
    the largest panel that fits beside the buffers with one or with two
    blocks an SM, up to what a product can use (all the A'y / A'rho.s
    pass's rows, or every column of its widest operator: A, m rows, on K5;
    K^-1 with kia, n + m rows, on K4, or on K4 every operator of one rho
    at once, :func:`k4_resident`), and at least two rows of that pass and
    two columns of every product."""
    if not (1 <= n <= MAX_N and 1 <= m <= MAX_DENSE_ROWS):
        return ()
    ldg = n + (n & 1)
    wide = n + m if packed else max(n, m)
    most = max(2 * (m + (m & 1)) * ldg, wide * (ldg + 2))
    if packed:
        most = max(most, _k4_resident_panel(n, m, refine_steps))
    least = max(4 * ldg, 2 * wide)
    out = []
    table = K4_STREAM_INSTANCES if packed else K5_STREAM_INSTANCES
    for lanes in LANES:
        step = max(1, 32 // lanes)
        for groups in range(step, 512 // lanes + 1, step):
            for (rpt_n, rpt_m), (threads, *_) in table.items():
                if groups * rpt_n < n or groups * rpt_m < m or lanes * groups > threads:
                    continue
                registers = _registers("K4-stream" if packed else "K5-stream", table,
                                       (rpt_n, rpt_m), refine_steps, mode)
                fixed = k5_stream_smem_bytes(m, lanes, groups, rpt_n, rpt_m, 0)
                panels = set()
                for per in (1, 2):  # the largest panel with `per` blocks an SM
                    room = min(SMEM_LIMIT, SM_SMEM // per - SM_SMEM_PER_BLOCK) - fixed
                    panels.add(min(most, max(room, 0) // 16) & ~1)
                for per, panel in enumerate(sorted(panels, reverse=True), 1):
                    if panel < least:
                        continue
                    smem = k5_stream_smem_bytes(m, lanes, groups, rpt_n, rpt_m, panel)
                    per_sm = blocks_per_sm(lanes * groups, smem, registers)
                    if per_sm >= per or panel == max(panels):
                        out.append((lanes, groups, rpt_n, rpt_m, smem, per_sm, panel))
    return tuple(out)


class WideGeometry(NamedTuple):
    """One product of the wide route at a register tile
    (csrc/admm_perr_wide.cu, make_geo): the operator's rows and columns,
    its row stride in device memory (columns rounded up to 4), the rows a
    block of a cluster takes (its span), the operators and staged vectors
    a panel holds (the pass: A' and fl(rho A)', y and s), the rows and
    lanes a thread takes, the lane-groups and
    row-groups (threads past lg G idle in the product), rows of a tile and
    tiles, a panel's columns and the column panels of a tile."""

    rows: int
    cols: int
    ld: int
    span: int
    ops: int
    vecs: int
    rt: int
    lt: int
    lg: int
    G: int
    H: int
    tiles: int
    pk: int
    np: int

    @property
    def padded_rows(self) -> int:
        """Rows a block's tiles compute past its span (a padded row reads
        its tile's last one): fewer than rt a tile."""
        return self.tiles * self.H - self.span


def wide_geometry(rows: int, cols: int, ops: int, vecs: int, rt: int, lt: int, lanes: int,
                  panel: int, cluster: int = 1) -> Optional[WideGeometry]:
    """One product's geometry (csrc/admm_perr_wide.cu, make_geo, which this
    mirrors): LG = lanes / lt lane-groups; each block of a ``cluster``
    takes a span of ceil(rows / cluster) rows, in as few tiles as the
    block's WIDE_THREADS / LG row-groups allow and as few row-groups as
    cover the span in them, and the widest panel of whole 4-entry chunks
    whose fp64 entries (rows at stride pk + 2) and staged vectors (pk rows
    of ``lanes`` lanes each) fit ``panel`` doubles (their 4-byte entries
    then fit a ring slot of ``panel`` floats). None where the lanes do not
    split so or a panel holds fewer than 4 columns."""
    if lanes % lt:
        return None
    lg = lanes // lt
    most = WIDE_THREADS // lg
    span = -(-rows // cluster)
    tiles = -(-span // (rt * most))
    G = -(-span // (tiles * rt))
    H = rt * G
    ld = _round4(cols)
    by_panel = (panel - 2 * ops * H) // (ops * H + vecs * lanes) if panel >= 2 * ops * H else 0
    pk = min(ld, by_panel) & ~3
    if pk < 4:
        return None
    return WideGeometry(rows, cols, ld, span, ops, vecs, rt, lt, lg, G, H, tiles, pk,
                        -(-cols // pk))


def wide_smem_bytes(n: int, lanes: int, panel: int, depth: int) -> int:
    """Dynamic shared memory of one block of K5's or K4's wide route
    (csrc/admm_perr_wide.cu): two fp64 panels of ``panel`` doubles and the
    vector buffer, n rows rounded up to pairs of ``lanes`` lanes in fp64;
    a ring of ``depth`` slots of ``panel`` 4-byte entries."""
    return 8 * (2 * panel + ((n + 1) & ~1) * lanes) + 4 * depth * panel


def wide_scratch_floats(n: int, m: int, refine_steps: int, blocks: int, lanes: int,
                        packed: bool = False, cluster: int = 1) -> int:
    """The device scratch of one launch of the wide route
    (csrc/admm_perr_wide.cu): a region per cluster of ``cluster`` of its
    ``blocks``, of a column per lane, of
    the lanes' working copy, every array's rows rounded up to 4: x, q, rhs
    and xt (n rows each), s, y, ax, l and u (m rows each), and when
    refining the refinement's residual (n rows) and K4's image (m rows)."""
    n4, m4 = _round4(n), _round4(m)
    rs = refine_steps > 0
    rows = 4 * n4 + (n4 if rs else 0) + 5 * m4 + (m4 if packed and rs else 0)
    return rows * lanes * (blocks // max(cluster, 1))


class WideLayout(NamedTuple):
    """The wide route's layout of one K4 or K5 launch
    (csrc/admm_perr_wide.cu, make_layout): the geometry of the pass, the
    solves (K^-1' or W), the refinement's K' (None without refinement) and
    K5's A (None for K4)."""

    products: tuple


def wide_layout(n: int, m: int, refine_steps: int, lanes: int, tiles: tuple, panel: int,
                packed: bool = False, cluster: int = 1) -> Optional[WideLayout]:
    """The layout the C entry derives from a plan (csrc/admm_perr_wide.cu,
    make_layout): ``tiles`` the pass's and the other products' (rows,
    lanes) a thread, ``cluster`` the blocks that share their lanes; None
    where a product has no geometry."""
    (rtp, ltp), (rt, lt) = tiles
    geo = lambda rows, cols, ops, vecs, r, l: wide_geometry(rows, cols, ops, vecs, r, l, lanes,
                                                            panel, cluster)
    products = (geo(n, m, 2, 2, rtp, ltp), geo(n + m if packed else n, n, 1, 0, rt, lt),
                geo(n, n, 1, 0, rt, lt) if refine_steps > 0 else None,
                None if packed else geo(m, n, 1, 0, rt, lt))
    need = (True, True, refine_steps > 0, not packed)
    if any(want and p is None for want, p in zip(need, products)):
        return None
    return WideLayout(products)


class WidePlan(NamedTuple):
    """How one launch of K4's or K5's wide route is laid out
    (csrc/admm_perr_wide.cu): the lanes a block (and its cluster) takes,
    the rows and lanes a thread takes in the pass (rt_pass, lt_pass) and in
    the other products (rt, lt), the ring's slots, the blocks of a cluster
    that share their lanes, the blocks of the grid (cluster times the clusters:
    R more than B needs, each rho's partial last one), the block's dynamic
    shared memory, the blocks an SM holds and the doubles of an fp64
    panel."""

    route: str
    lanes: int
    rt_pass: int
    lt_pass: int
    rt: int
    lt: int
    depth: int
    cluster: int
    blocks: int
    smem_bytes: int
    per_sm: int
    panel: int

    @property
    def tiles(self) -> tuple:
        return ((self.rt_pass, self.lt_pass), (self.rt, self.lt))


@functools.lru_cache(maxsize=256)
def _wide_layouts(n: int, m: int, refine_steps: int, packed: bool = False) -> tuple:
    """Every (lanes, depth, cluster, panel, smem_bytes) of the wide route
    for this operator shape: lanes of WIDE_LANES, depths of WIDE_DEPTHS,
    clusters of WIDE_CLUSTERS (at most n and m blocks), and the
    largest panel, a multiple of 8 doubles, that fits one block's shared
    memory (a block takes a whole SM's registers) and leaves some tile of
    each product a geometry."""
    if not (1 <= n <= MAX_WIDE_N and 1 <= m <= MAX_WIDE_ROWS):
        return ()
    out = []
    for lanes in WIDE_LANES:
        for depth in WIDE_DEPTHS:
            fixed = wide_smem_bytes(n, lanes, 0, depth)
            panel = max(SMEM_LIMIT - fixed, 0) // (16 + 4 * depth) & ~7
            if panel <= 0:
                continue
            smem = wide_smem_bytes(n, lanes, panel, depth)
            assert smem <= SMEM_LIMIT
            for cluster in WIDE_CLUSTERS:
                if cluster > min(n, m):
                    continue
                if any(wide_layout(n, m, refine_steps, lanes, (tp, ts), panel, packed, cluster)
                       for tp in WIDE_TILES for ts in WIDE_TILES):
                    out.append((lanes, depth, cluster, panel, smem))
    return tuple(out)


def _wide_product_cost(g: WideGeometry, lanes: int, depth: int, l2: float) -> float:
    """One product's clocks a block and iteration on the wide route: each
    panel takes the longer of its sums (its column pairs, each the longer
    of the warps' multiply-adds on their quarter of the SM and their
    16-byte loads: rt operator and lt vector entries an operator, and one
    warp's serial time), its
    entries' widening and copies' issue and a step's overhead, and its copy
    from L2 (the operator's rows, the pass's vectors) with its share of an
    L2 round trip; each tile its epilogue, a
    round trip to L2 for each of its rows a thread takes."""
    warps = -(-g.G * g.lg // 32)
    loads, fmas = g.ops * (g.rt + g.lt), 2 * g.rt * g.lt * g.ops
    pair = max(-(-warps // 4) * 2 * fmas, warps * K12_LOAD_CLOCKS * loads,
               WIDE_PAIR_CLOCKS + WIDE_PAIR_LOAD_CLOCKS * loads + WIDE_PAIR_FMA_CLOCKS * fmas)
    last_rows = g.span - (g.tiles - 1) * g.H
    last_cols = g.cols - (g.np - 1) * g.pk
    cost = g.tiles * g.rt * WIDE_ROW_CLOCKS
    for rows, n_tiles in ((g.H, g.tiles - 1), (last_rows, 1)):
        for cols, n_panels in ((g.pk, g.np - 1), (last_cols, 1)):
            if not n_tiles or not n_panels:
                continue
            entries = g.ops * rows * _round4(cols)
            vectors = g.vecs * _round4(cols) * lanes
            copied = entries + vectors
            compute = (-(-cols // 2) * pair + copied * (WIDE_WIDEN_CLOCKS + WIDE_ISSUE_CLOCKS))
            step = max(compute + WIDE_STEP_CLOCKS, 4 * copied / l2 + WIDE_LATENCY / (depth - 1))
            cost += n_tiles * n_panels * step
    return cost


def _wide_clusters_busy(R: int, B: int, lanes: int) -> int:
    """The clusters a launch of the wide route may keep busy, for ranking:
    B lanes in full clusters and all but one of the R rho indices ending in
    a partial one (random indices do; a grid past the card's SMs runs a
    second wave)."""
    return -(-B // lanes) + R - 1


def _wide_cost(n: int, m: int, R: int, refine_steps: int, B: int, lanes: int, depth: int,
               cluster: int, lay: WideLayout) -> float:
    """The wide route's cost of a layout, for ranking: clocks of the busiest
    SM (a block an SM) for an iteration: its block's products in turn
    (:func:`_wide_product_cost`), each but the pass after a reload of the
    vector buffer (and in a cluster a barrier of its blocks), and the
    ring's restart."""
    used = cluster * _wide_clusters_busy(R, B, lanes)
    busiest = -(-used // SM_COUNT)
    l2 = min(K12_SM_L2_BYTES_PER_CLOCK, K12_L2_BYTES_PER_CLOCK / min(used, SM_COUNT))
    pass_, solve, kprod, ax = lay.products
    rs = int(refine_steps)
    reload = WIDE_RELOAD_CLOCKS + (WIDE_CLUSTER_CLOCKS if cluster > 1 else 0)
    cost = WIDE_RESTART_CLOCKS + reload + _wide_product_cost(pass_, lanes, depth, l2)
    cost += (1 + rs) * (reload + _wide_product_cost(solve, lanes, depth, l2))
    if rs:
        cost += rs * (reload + _wide_product_cost(kprod, lanes, depth, l2))
    if ax is not None:
        cost += reload + _wide_product_cost(ax, lanes, depth, l2)
    return busiest * cost


def wide_l2_bytes(n: int, m: int, R: int, refine_steps: int, B: int, plan, chunk: int,
                  packed: bool = False) -> int:
    """The operator bytes one chunk of ``chunk`` iterations of the wide
    route reads from L2 on this plan: each cluster one rho's operators as
    4-byte entries, rows padded to 4 (its blocks a span of rows each),
    every iteration (the pass's two, the solves' once a solve, K' once a
    refinement, K5's A), over the clusters B lanes spread evenly over R rho
    indices fill (:func:`k12_blocks_used`)."""
    ldn, ldm = _round4(n), _round4(m)
    rs = int(refine_steps)
    clusters = k12_blocks_used(R, B, plan.lanes)
    entries = 2 * n * ldm + (1 + rs) * (n + m if packed else n) * ldn + rs * n * ldn
    entries = chunk * (entries + (0 if packed else m * ldn))
    return 4 * entries * clusters


@functools.lru_cache(maxsize=256)  # the driver asks once per chunk
def k5_plan(n: int, m: int, R: int, refine_steps: int, B: int,
            lanes: Optional[int] = None, groups: Optional[int] = None,
            route: Optional[str] = None, mode: str = "highest", tiles: Optional[tuple] = None,
            depth: Optional[int] = None, cluster: Optional[int] = None):
    """The layout of a K5 launch for ``B`` lanes, from the shape alone.

    The shared route where some layout of it fits (its fp64 operators and
    lane buffers within one block's shared memory: the h20 state box), else
    the stream route (the h50 state box), which takes every shape with n <=
    128 and 1 to 512 rows, else the wide route (the h100 state box), which
    takes every other shape :func:`k5_fits` takes, ranked by
    :func:`_wide_cost`. Within the shared and stream routes the busiest SM runs
    ceil(blocks / 132) blocks of L lanes, several at once where shared
    memory, threads and the instantiation's registers allow; a lane reads
    per iteration an operator entry per multiply-add (on the shared route
    an fp32 A entry counts half), padded rows included, and its vectors
    once per thread, so fewer row-groups G read less; the cost
    (:func:`_warp_cost`) counts the warps resident on the SM. A stream
    launch has up to R - 1 more blocks (each rho's partial last one). Ties
    go to more lanes per block. ``lanes``, ``groups`` and ``route`` force a
    layout (ValueError if it does not fit; the wide route only where it is
    forced or neither other route has any layout); on the wide route, a
    :class:`WidePlan` (:func:`_wide_plan`), ``tiles`` ((rt_pass, lt_pass),
    (rt, lt)), ``depth`` and ``cluster`` force its tiles, ring and blocks
    a cluster (``groups`` does not apply
    there). ``mode``, a
    precision of ``PRECISIONS``, sets the registers the instantiations
    take; bytes, panels and routes are the same at every precision."""
    return _dense_plan(False, n, m, R, refine_steps, B, lanes, groups, route, mode, tiles, depth,
                       cluster)


@functools.lru_cache(maxsize=256)  # the driver asks once per chunk
def k4_plan(n: int, m: int, R: int, refine_steps: int, B: int,
            lanes: Optional[int] = None, groups: Optional[int] = None,
            route: Optional[str] = None, mode: str = "highest", tiles: Optional[tuple] = None,
            depth: Optional[int] = None, cluster: Optional[int] = None):
    """The layout of a K4 launch for ``B`` lanes, as :func:`k5_plan` lays
    out K5's, with K4's instantiations (``K4_INSTANCES``,
    ``K4_STREAM_INSTANCES``) and bytes: on the shared route kia_r in place
    of the fp64 A (the h20 equality terminal, its tier 2 and the h20 state
    box at tier 1's grid), on the stream route panels of K_r^-1 with kia_r
    (n + m rows; the h20 neighborhood terminal), whole where they fit
    (:func:`k4_resident`), on the wide route as K5's (W's n + m rows in its
    solves). A lane reads per iteration the fp32 A once for
    A'y and A'rho.s and widens it twice (each widening costs about what a
    double's read does: k3_ab.py --kernel K4), K^-1 and kia for xt and its
    image in one product, and K, K^-1 and kia again per refinement.
    ``mode``, ``tiles``, ``depth`` and ``cluster`` as in
    :func:`k5_plan`."""
    return _dense_plan(True, n, m, R, refine_steps, B, lanes, groups, route, mode, tiles, depth,
                       cluster)


def _dense_plan(packed, n, m, R, refine_steps, B, lanes, groups, route, mode, tiles, depth,
                cluster):
    name = "K4" if packed else "K5"
    _check_mode(mode)
    B = int(B)
    if B < 1:
        raise ValueError(f"{name} takes at least one lane; B={B}")
    if m * B >= 2**31:
        raise ValueError(f"{name} indexes the (m, B) state with 32 bits; m={m}, B={B}")
    if n * B >= 2**31:
        raise ValueError(f"{name} indexes the (n, B) state with 32 bits; n={n}, B={B}")
    if not k5_fits(n, m, R):
        raise ValueError(
            f"no {name} route for n={n}, m={m}: {name} takes n <= {MAX_WIDE_N} and 1 to "
            f"{MAX_WIDE_ROWS} rows"
        )
    if route not in (None,) + DENSE_ROUTES:
        raise ValueError(f"{name} routes are {DENSE_ROUTES}, not {route!r}")
    rs = int(refine_steps)
    older = (1 <= n <= MAX_N and 1 <= m <= MAX_DENSE_ROWS)  # the stream route has a layout
    if route == "wide" or (route is None and not older):
        if groups is not None:
            raise ValueError(f"{name}'s wide route takes no row-groups: its tiles set them")
        return _wide_plan(packed, n, m, R, rs, B, lanes, tiles, depth, cluster)
    if (tiles, depth, cluster) != (None, None, None):
        raise ValueError(f"tiles, depth and cluster are {name}'s wide route's, not its "
                         f"{route or 'shared or stream'} route's")
    for kind in DENSE_ROUTES[:2]:
        if route not in (None, kind):
            continue
        grouped = kind == "stream"
        if grouped:
            layouts = _stream_layouts(n, m, rs, packed, mode)
        else:
            layouts = [lay + (0,) for lay in _shared_layouts(n, m, R, rs, packed, mode)]
        best = None
        for L, G, rpt_n, rpt_m, smem, per_sm, panel in layouts:
            if lanes not in (None, L) or groups not in (None, G):
                continue
            blocks = -(-B // L) + (R if grouped else 0)
            used = min(blocks, (B + (R * (L - 1) if grouped else L - 1)) // L)
            busiest = -(-used // SM_COUNT)
            warps = min(per_sm, busiest) * L * G / 32
            rows_n, rows_m = G * rpt_n, G * rpt_m
            if packed:  # a widening costs as much as reading a double
                operator = (rows_n * (m * (2 if grouped else 2.5) + (1 + 2 * rs) * n)
                            + rows_m * (1 + rs) * n)
                vectors = G * ((2 if grouped else 2.5) * m + (1 + 2 * rs) * n)
            else:
                operator = rows_n * (m * (2 if grouped else 1.5) + (1 + 2 * rs) * n) + rows_m * n
                vectors = G * ((2 if grouped else 2.5) * m + (2 + 2 * rs) * n)
            cost = _warp_cost(busiest * L, operator + vectors, warps)
            key = (cost, -L)
            if best is None or key < best[0]:
                best = (key, DensePlan(kind, L, G, rpt_n, rpt_m, blocks, smem, per_sm, panel))
        if best is not None:
            return best[1]
    raise ValueError(
        f"no layout of {name}'s {route or 'shared or stream'} route for n={n}, m={m}, R={R}, "
        f"refine_steps={rs}"
        + ("" if lanes is None and groups is None else f", lanes={lanes}, groups={groups}")
        + f" within {SMEM_LIMIT} B of shared memory"
    )


def _wide_plan(packed, n, m, R, rs, B, lanes, tiles, depth, cluster) -> WidePlan:
    """The layout of the wide route for this shape: each of its layouts
    (:func:`_wide_layouts`) with the pass's tile and the other products'
    tile that cost least on it (:func:`_wide_cost`), of those with two
    lanes a thread or more (one lane a thread only in a block of one); of
    the layouts within ``WIDE_COST_TIE`` of the least cost, the one that
    reads the fewest L2 operator bytes a chunk (:func:`wide_l2_bytes`),
    then the cheapest, more lanes a block, the larger panel. ``lanes``,
    ``tiles`` ((rt_pass, lt_pass), (rt, lt)), ``depth`` and ``cluster``
    force one."""
    ranked = []
    for L, D, C, panel, smem in _wide_layouts(n, m, rs, packed):
        if lanes not in (None, L) or depth not in (None, D) or cluster not in (None, C):
            continue
        used = C * _wide_clusters_busy(R, B, L)
        l2 = min(K12_SM_L2_BYTES_PER_CLOCK, K12_L2_BYTES_PER_CLOCK / min(used, SM_COUNT))
        pick = []
        for kind, options in ((0, WIDE_TILES), (1, WIDE_TILES)):
            if tiles is not None:  # forced: only a tile the kernel has
                options = tuple(tile for tile in options if tile == tuple(tiles[kind]))
            else:  # a thread holds more than one lane's sums where there are two
                options = tuple(tile for tile in options if tile[1] >= min(2, L))
            choice = None
            for rt, lt in options:
                geo = lambda rows, cols, ops, vecs: wide_geometry(
                    rows, cols, ops, vecs, rt, lt, L, panel, C)
                if kind == 0:
                    parts = [geo(n, m, 2, 2)]
                else:
                    parts = [geo(n + m if packed else n, n, 1, 0)]
                    parts += [geo(n, n, 1, 0)] * min(rs, 1) + ([] if packed else [geo(m, n, 1, 0)])
                if any(p is None for p in parts):
                    continue
                c = sum(_wide_product_cost(p, L, D, l2) for p in parts)
                if choice is None or c < choice[0]:
                    choice = (c, (rt, lt))
            pick.append(choice)
        if None in pick:
            continue
        lay = wide_layout(n, m, rs, L, (pick[0][1], pick[1][1]), panel, packed, C)
        (rtp, ltp), (rt, lt) = pick[0][1], pick[1][1]
        plan = WidePlan("wide", L, rtp, ltp, rt, lt, D, C, C * (-(-B // L) + R), smem,
                        blocks_per_sm(WIDE_THREADS, smem, WIDE_REGISTERS), panel)
        ranked.append((_wide_cost(n, m, R, rs, B, L, D, C, lay), plan))
    if not ranked:
        raise ValueError(
            f"no layout of {'K4' if packed else 'K5'}'s wide route for n={n}, m={m}, R={R}, "
            f"refine_steps={rs}"
            + ("" if lanes is None else f", lanes={lanes}")
            + ("" if tiles is None else f", tiles={tiles}")
            + ("" if depth is None else f", depth={depth}")
            + ("" if cluster is None else f", cluster={cluster}")
            + f" within {SMEM_LIMIT} B of shared memory"
        )
    least = min(cost for cost, _ in ranked)
    return min(((wide_l2_bytes(n, m, R, rs, B, plan, 25, packed), cost, -plan.lanes, -plan.panel),
                plan) for cost, plan in ranked if cost <= least * (1 + WIDE_COST_TIE))[1]


def rho_order(idx: Tensor, R: int) -> Tuple[Tensor, Tensor]:
    """The lanes sorted by rho index, stable (lane order within an index),
    and where each index's lanes start in that order (R + 1 entries, the
    last B), both int32 on idx's device, with no host sync: the stream
    route of K5 and K4 gives each block the lanes of one index
    (csrc/admm_perr.cu)."""
    values, order = torch.sort(idx, stable=True)
    bounds = torch.arange(R + 1, dtype=idx.dtype, device=idx.device)
    starts = torch.searchsorted(values, bounds, out_int32=True)
    return order.to(torch.int32), starts


def kernel_mode(config: AdmmConfig) -> str:
    """The precision a chunk of K1, K2, K4 or K5 computes under ``config``:
    one of ``PRECISIONS``. "hybrid" is the driver's schedule, resolved per
    chunk into "bf16x3" or "highest" (:func:`solve_batch_fused`), and never
    reaches a chunk, as in the JAX package (``admm_pallas._make_dot``);
    ValueError for it and for an unknown value."""
    mode = str(config.kernel_precision)
    if mode == "hybrid":
        raise ValueError("kernel_precision 'hybrid' is resolved per chunk by the driver")
    _check_mode(mode)
    return mode


def _count_key(kernel: str, mode: str) -> str:
    return kernel if mode == "highest" else f"{kernel}-{mode}"


def bf16_split(t: Tensor) -> Tuple[Tensor, Tensor]:
    """The JAX body's split of an fp32 operand for bf16x3: hi = bf16(t),
    lo = bf16(t - hi), each rounded to nearest even and held (exactly) in
    fp32; t - hi is exact."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def dot_bf16(M: Tensor, v: Tensor, mode: str) -> Tensor:
    """M v for a small M (a, K) and lane-last v (K, B) in a bf16 precision,
    as K1, K2, K4 and K5 form it: "default" one pass bf16(M) bf16(v);
    "bf16x3" the passes hi.hi, lo.hi and hi.lo of both operands' splits
    (:func:`bf16_split`; lo.lo is left out), combined hh + (lh + hl) in
    fp32 as ``admm_pallas._make_dot`` combines them. A product of two bf16
    values is exact in fp32, so each pass is a sum of exact terms: taken in
    fp32 from +0 in column order j = 0..K-1, as the kernels take it, the
    two agree bit for bit."""
    if mode == "default":
        ops, vs = M.to(torch.bfloat16).float()[None], v.to(torch.bfloat16).float()[None]
    elif mode == "bf16x3":
        (mh, ml), (vh, vl) = bf16_split(M), bf16_split(v)
        ops, vs = torch.stack([mh, ml, mh]), torch.stack([vh, vh, vl])
    else:
        raise ValueError(f"dot_bf16 computes 'bf16x3' or 'default', not {mode!r}")
    acc = torch.zeros((ops.shape[0], M.shape[0], v.shape[1]), dtype=torch.float32,
                      device=v.device)
    for j in range(M.shape[1]):
        acc = torch.addcmul(acc, ops[:, :, j : j + 1], vs[:, j : j + 1])
    return acc[0] if mode == "default" else acc[0] + (acc[1] + acc[2])


def _lane_solver(op: AdmmOperator, idx: Tensor, n: int, mode: str = "highest"):
    """The lane's own K_r^-1 v (or K_r v): all R candidates, then a per-lane
    gather; "highest" as one fp64 (R*n, n) @ (n, B) matmul rounded once to
    fp32, a bf16 precision by :func:`dot_bf16`."""
    R = int(op.rho_grid.shape[0])
    B = idx.shape[0]
    if mode != "highest":
        solve = lambda M, v: _own(dot_bf16(M, v, mode), idx, R)
        return solve, op.K_invs.reshape(R * n, n), op.Ks.reshape(R * n, n)
    kicat = op.K_invs.reshape(R * n, n).double()
    kcat = op.Ks.reshape(R * n, n).double()
    pick = idx.long().view(1, 1, B).expand(1, n, B)

    def solve(M, v):
        return (M @ v.double()).view(R, n, B).gather(0, pick)[0].float()

    return solve, kicat, kcat


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

    Like K1, at ``config.kernel_precision`` "highest" every matrix-vector
    product is accumulated in fp64 and rounded once to fp32 (the state
    stays fp32): fp32 accumulation leaves about three times as many h20
    lanes above the 1e-6 certificate after tier 1 (csrc/admm_diag.cu,
    "Precision"); at "bf16x3" or "default" each product is
    :func:`dot_bf16`'s."""
    mode = kernel_mode(config)
    PLAIN_CALLS[_count_key("K1", mode)] += 1
    n = qT.shape[0]
    solve, kicat, kcat = _lane_solver(op, idx, n, mode)
    d = torch.diagonal(op.A_s)[:, None]
    il = idx.long()
    rho = op.rho_vecs[il].T  # (n, B)
    rho_inv = op.rho_invs[il].T

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


def iterate_chunk_mixed_T_plain(
    op: AdmmOperator,
    qT: Tensor,  # (n, B) scaled, lane-last
    lT: Tensor,  # (m, B)
    uT: Tensor,
    idx: Tensor,  # (B,) int32 rho-grid index per lane
    xT: Tensor,  # (n, B)
    sT: Tensor,  # (m, B)
    yT: Tensor,
    axT: Tensor,
    chunk: int,
    config: AdmmConfig,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K2, for A_s = [diag(d); A2].

    A'y = d.y[:n] + A2' y[n:] and A'(rho.s) split the same way; the
    K-solve as in K1; st = [d.xt; A2 xt]. At "highest" every matrix-vector
    product (the K-solves and the three A2 products) is accumulated in fp64
    and rounded once to fp32, as in K2; at "bf16x3" or "default" each is
    :func:`dot_bf16`'s."""
    mode = kernel_mode(config)
    PLAIN_CALLS[_count_key("K2", mode)] += 1
    n = qT.shape[0]
    solve, kicat, kcat = _lane_solver(op, idx, n, mode)
    d = torch.diagonal(op.A_s[:n, :n])[:, None]
    a2 = op.A_s[n:] if mode != "highest" else op.A_s[n:].double()  # (m - n, n)
    a2t = a2.T
    il = idx.long()
    rho = op.rho_vecs[il].T  # (m, B)
    rho_inv = op.rho_invs[il].T

    def prod(M, v):  # fp64 sums of exact fp32 products, rounded once
        if mode != "highest":
            return dot_bf16(M, v, mode)
        return (M @ v.double()).float()

    sigma, alpha = float(config.sigma), float(config.alpha)
    x, s, y, ax = xT, sT, yT, axT
    for _ in range(int(chunk)):
        rs = rho * s
        aty = d * y[:n] + prod(a2t, y[n:])
        w = d * rs[:n] + prod(a2t, rs[n:])
        rhs = sigma * x - qT - aty + w
        xt = solve(kicat, rhs)
        for _ in range(int(config.refine_steps)):
            xt = xt + solve(kicat, rhs - solve(kcat, xt))
        st = torch.cat([d * xt, prod(a2, xt)])
        x_new = alpha * xt + (1.0 - alpha) * x
        v = alpha * st + (1.0 - alpha) * s
        s_new = torch.clamp(v + rho_inv * y, lT, uT)
        y = y + rho * (v - s_new)
        ax = alpha * st + (1.0 - alpha) * ax
        x, s = x_new, s_new
    return x, s, y, ax


def _kia(op: AdmmOperator) -> Tensor:
    if op.kia is None:
        raise ValueError(
            "K4 needs the operator's kia = K_r^-1 A_s' (admm.packed_kia), "
            "which build_operator forms for a dense operator"
        )
    return op.kia


def packed_operators(op: AdmmOperator) -> Tuple[Tensor, Tensor, Tensor]:
    """K4's column-packed operators (``admm_pallas.packed_operators``):

    - rhs1 (m, n + R n) = [A_s | fl(rho_0 A_s) | ... ], whose columns give
      A'y and every A' diag(rho_r) s;
    - kcat (n, R n) = [K_0 | ... ], for the refinement's xt K_r;
    - wrow (n, R (n + m)) = [K_0^-1 | K_0^-1 A_s' | ... ], for every rho's
      xt and its image.

    The JAX package also builds wcat, the block diagonal of wrow's blocks;
    a per-lane gather needs only the blocks. K_r^-1 A_s' is the operator's
    ``kia``, built once with it (``admm.packed_kia``)."""
    A = op.A_s
    R, n = op.K_invs.shape[0], op.K_invs.shape[1]
    m = A.shape[0]
    sacat = (op.rho_vecs[:, :, None] * A[None]).transpose(0, 1).reshape(m, R * n)
    rhs1 = torch.cat([A, sacat], dim=1)
    kcat = op.Ks.transpose(0, 1).reshape(n, R * n)
    blocks = torch.cat([op.K_invs, _kia(op)], dim=2)  # (R, n, n + m)
    wrow = blocks.transpose(0, 1).reshape(n, R * (n + m))
    return rhs1, kcat, wrow


def _own(cand: Tensor, idx: Tensor, R: int) -> Tensor:
    """(R * rows, B) candidates, one block per rho -> (rows, B), each lane's
    own block (a gather: an inf in another lane's block stays there)."""
    rows, B = cand.shape[0] // R, cand.shape[1]
    pick = idx.long().view(1, 1, B).expand(1, rows, B)
    return cand.view(R, rows, B).gather(0, pick)[0]


def _iterate_dense_plain(packed, op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config):
    """K4's (packed) or K5's chunk math, lane-last. At "highest" each
    product sums exact fp32 products in fp64 in the kernel's index order
    and rounds once (``riccati.dot64``), at "bf16x3" or "default" it is
    :func:`dot_bf16`'s (the operators' entries split as the JAX body
    splits them: the packed ones, fl(rho_r A) and kia, as entries); each
    lane takes its own rho's block of all R candidates. The two differ only
    in the constraint image st."""
    mode = kernel_mode(config)
    PLAIN_CALLS[_count_key("K4" if packed else "K5", mode)] += 1
    dot = dot64 if mode == "highest" else functools.partial(dot_bf16, mode=mode)
    n, m = qT.shape[0], lT.shape[0]
    R = int(op.rho_grid.shape[0])
    if packed:
        rhs1, kcat, wrow = packed_operators(op)
        at, sat = rhs1[:, :n].T, rhs1[:, n:].T  # A', fl(rho_r A)' stacked
        kit = wrow.T  # (R (n + m), n): rhs -> [xt; st] of every rho
        kt = kcat.T
    else:
        at = op.A_s.T
        sat = (op.A_s.T[None] * op.rho_vecs[:, None, :]).reshape(R * n, m)
        kit = op.K_invs.transpose(1, 2).reshape(R * n, n)  # rhs -> xt
        kt = op.Ks.transpose(1, 2).reshape(R * n, n)
        a = op.A_s
    own = lambda M, v: _own(dot(M, v), idx, R)
    il = idx.long()
    rho = op.rho_vecs[il].T  # (m, B)
    rho_inv = op.rho_invs[il].T

    sigma, alpha = float(config.sigma), float(config.alpha)
    x, s, y, ax = xT, sT, yT, axT
    for _ in range(int(chunk)):
        rhs = sigma * x - qT - dot(at, y) + own(sat, s)
        cs = own(kit, rhs)
        xt, st = cs[:n], cs[n:]
        for _ in range(int(config.refine_steps)):
            corr = own(kit, rhs - own(kt, xt))
            xt = xt + corr[:n]
            if packed:
                st = st + corr[n:]
        if not packed:
            st = dot(a, xt)
        x_new = alpha * xt + (1.0 - alpha) * x
        v = alpha * st + (1.0 - alpha) * s
        s_new = torch.clamp(v + rho_inv * y, lT, uT)
        y = y + rho * (v - s_new)
        ax = alpha * st + (1.0 - alpha) * ax
        x, s = x_new, s_new
    return x, s, y, ax


def iterate_chunk_dense_packed_T_plain(
    op: AdmmOperator,
    qT: Tensor,  # (n, B) scaled, lane-last
    lT: Tensor,  # (m, B)
    uT: Tensor,
    idx: Tensor,  # (B,) int32 rho-grid index per lane
    xT: Tensor,  # (n, B)
    sT: Tensor,  # (m, B)
    yT: Tensor,
    axT: Tensor,
    chunk: int,
    config: AdmmConfig,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K4 (``admm_pallas._iterate_kernel``), for a
    dense A_s: GEMM 1 gives A'y and A' diag(rho_r) s from rhs1, GEMM 2 the
    lane's xt and its image st = rhs K_r^-1 A' from wrow's blocks; the
    refinement corrects both through K_r (kcat) and wrow."""
    return _iterate_dense_plain(True, op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config)


def iterate_chunk_dense_perr_T_plain(
    op: AdmmOperator,
    qT: Tensor,  # (n, B) scaled, lane-last
    lT: Tensor,  # (m, B)
    uT: Tensor,
    idx: Tensor,  # (B,) int32 rho-grid index per lane
    xT: Tensor,  # (n, B)
    sT: Tensor,  # (m, B)
    yT: Tensor,
    axT: Tensor,
    chunk: int,
    config: AdmmConfig,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K5 (``admm_pallas._iterate_kernel_perr``),
    for a dense A_s: A'y, A' diag(rho_r) s, xt = rhs K_r^-1, the refinement
    through K_r, then st = A xt."""
    return _iterate_dense_plain(False, op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config)


def _check_args(kernel: str, args, dev) -> None:
    for name, t, shape, dtype in args:
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")


def _state_args(n, m, B, qT, lT, uT, idx, xT, sT, yT, axT):
    f = torch.float32
    return [
        ("qT", qT, (n, B), f),
        ("lT", lT, (m, B), f),
        ("uT", uT, (m, B), f),
        ("idx", idx, (B,), torch.int32),
        ("xT", xT, (n, B), f),
        ("sT", sT, (m, B), f),
        ("yT", yT, (m, B), f),
        ("axT", axT, (m, B), f),
    ]


def _launch(kernel: str, entry: str, args, outs, ints, floats=()):
    """Call the C entry ``entry`` with the tensors' pointers, ``ints`` and
    ``floats`` on the current stream; raise on a non-zero cudaError_t,
    count the launch under ``kernel`` (with its precision: "K1-bf16x3")
    otherwise."""
    dev = args[0][1].device
    lib = _build.load_kernels()
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            *[t.data_ptr() for _, t, _, _ in args],
            *[o.data_ptr() for o in outs],
            *ints, *floats, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{kernel} ({entry}) launch failed: cudaError_t {err}")
    LAUNCHES[kernel] += 1
    return tuple(outs)


def _launch_k1(op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config, plan=None):
    """Launch K1 on the route :func:`k1_plan` picks (``plan`` forces one)."""
    n, B = qT.shape
    R = int(op.rho_grid.shape[0])
    rs = int(config.refine_steps)
    mode = kernel_mode(config)
    if plan is None:
        plan = k1_plan(n, R, rs, B, mode=mode)
    if plan.route == "stream":
        return _launch_k12_stream(False, op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config,
                                  plan)
    f = torch.float32
    args = [
        ("K_invs", op.K_invs, (R, n, n), f),
        ("Ks", op.Ks, (R, n, n), f),
        ("diag(A_s)", torch.diagonal(op.A_s).contiguous(), (n,), f),
        ("rho_vecs", op.rho_vecs, (R, n), f),
        ("rho_invs", op.rho_invs, (R, n), f),
    ] + _state_args(n, n, B, qT, lT, uT, idx, xT, sT, yT, axT)
    _check_args("K1", args, qT.device)
    outs = [torch.empty_like(xT) for _ in range(4)]
    ints = dict(n=n, B=B, R=R, chunk=int(chunk), refine_steps=rs,
                mode=PRECISIONS.index(mode), **plan._asdict())
    return _launch(_count_key("K1", mode), "admm_diag_chunk", args, outs,
                   [ints[k] for k in K1_INTS], (float(config.sigma), float(config.alpha)))


def _launch_k2(op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config, plan=None):
    """Launch K2 on the route :func:`k2_plan` picks (``plan`` forces one)."""
    n, B = qT.shape
    m = lT.shape[0]
    R = int(op.rho_grid.shape[0])
    rs = int(config.refine_steps)
    mode = kernel_mode(config)
    if plan is None:
        plan = k2_plan(n, m, R, rs, B, mode=mode)
    if plan.route == "stream":
        return _launch_k12_stream(True, op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config,
                                  plan)
    f = torch.float32
    args = [
        ("K_invs", op.K_invs, (R, n, n), f),
        ("Ks", op.Ks, (R, n, n), f),
        ("A2", op.A_s[n:], (m - n, n), f),
        ("diag(A_s[:n])", torch.diagonal(op.A_s[:n, :n]).contiguous(), (n,), f),
        ("rho_vecs", op.rho_vecs, (R, m), f),
        ("rho_invs", op.rho_invs, (R, m), f),
    ] + _state_args(n, m, B, qT, lT, uT, idx, xT, sT, yT, axT)
    _check_args("K2", args, qT.device)
    outs = [torch.empty_like(xT)] + [torch.empty_like(sT) for _ in range(3)]
    ints = dict(n=n, m=m, B=B, R=R, chunk=int(chunk), refine_steps=rs,
                mode=PRECISIONS.index(mode), **plan._asdict())
    return _launch(_count_key("K2", mode), "admm_mixed_chunk", args, outs,
                   [ints[k] for k in K2_INTS], (float(config.sigma), float(config.alpha)))


def _launch_k12_stream(tail, op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config, plan):
    """K1 (``tail`` false: admm_diag_stream_chunk) or K2
    (admm_mixed_stream_chunk) on the stream route, with the lanes ordered
    by rho index, the 4-byte operators of :func:`kernel_operators` and a
    scratch for the blocks' working copy of their lanes' state
    (:func:`k12_scratch_floats`)."""
    name = "K2" if tail else "K1"
    n, B = qT.shape
    m = lT.shape[0]
    R = int(op.rho_grid.shape[0])
    rs = int(config.refine_steps)
    mode = kernel_mode(config)
    ops = kernel_operators(op, mode, "kinv", "k", *(("a2t", "a2") if tail else ()), narrow=True)
    ldn, ldm = _round4(n), _round4(m - n)
    f, i32 = torch.float32, torch.int32
    operators = [("K_invs (entries)", ops["kinv"], (R, n, ldn), f),
                 ("Ks (entries)", ops["k"], (R, n, ldn), f)]
    if tail:
        operators += [("A2' (entries)", ops["a2t"], (n, ldm), f),
                      ("A2 (entries)", ops["a2"], (m - n, ldn), f)]
    operators += [
        ("diag(A_s[:n])", torch.diagonal(op.A_s[:n, :n]).contiguous(), (n,), f),
        ("rho_vecs", op.rho_vecs, (R, m), f),
        ("rho_invs", op.rho_invs, (R, m), f),
    ]
    state = _state_args(n, m, B, qT, lT, uT, idx, xT, sT, yT, axT)
    order, starts = rho_order(idx, R)
    args = operators + state[:3] + [("order", order, (B,), i32),
                                    ("starts", starts, (R + 1,), i32)] + state[4:]
    _check_args(name, args, qT.device)
    outs = [torch.empty_like(xT)] + [torch.empty_like(sT) for _ in range(3)]
    scratch = torch.empty(k12_scratch_floats(n, m, rs, plan.blocks, plan.lanes), dtype=f,
                          device=qT.device)
    ints = dict(n=n, m=m, B=B, R=R, chunk=int(chunk), refine_steps=rs,
                mode=PRECISIONS.index(mode), **plan._asdict())
    keys, entry = ((K2_STREAM_INTS, "admm_mixed_stream_chunk") if tail
                   else (K1_STREAM_INTS, "admm_diag_stream_chunk"))
    return _launch(_count_key(name, mode), entry, args, outs + [scratch],
                   [ints[k] for k in keys], (float(config.sigma), float(config.alpha)))[:4]


def _launch_k4(op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config, plan=None):
    """Launch K4 on the route :func:`k4_plan` picks (``plan`` forces one)."""
    return _launch_dense(True, op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config, plan)


def _launch_k5(op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config, plan=None):
    """Launch K5 on the route :func:`k5_plan` picks (``plan`` forces one)."""
    return _launch_dense(False, op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config, plan)


# how each operator the stream and wide routes read from device memory is
# formed from the operator before its entries are taken (rows padded to an
# even stride): K1's and K2's K^-1 and K, and K2's A2' and A2; K4's and
# K5's K^-1 transposed, W = [K^-1'; kia'] (K4's solves), K transposed, A
# and fl(rho_r A) (one fp32 product), and the wide route's A' and
# fl(rho_r A)'
_KERNEL_OPERATORS = {
    "kinv": lambda op: op.K_invs,
    "k": lambda op: op.Ks,
    "a2t": lambda op: op.A_s[op.A_s.shape[1]:].T,
    "a2": lambda op: op.A_s[op.A_s.shape[1]:],
    "kinv_t": lambda op: op.K_invs.transpose(1, 2),
    "w": lambda op: torch.cat([op.K_invs.transpose(1, 2), _kia(op).transpose(1, 2)], dim=1),
    "k_t": lambda op: op.Ks.transpose(1, 2),
    "a": lambda op: op.A_s,
    "ra": lambda op: op.rho_vecs[:, :, None] * op.A_s[None],
    "at": lambda op: op.A_s.T,
    "rat": lambda op: (op.rho_vecs[:, :, None] * op.A_s[None]).transpose(1, 2),
}


def kernel_operators(op: AdmmOperator, mode: str, *keys: str, narrow: bool = False) -> dict:
    """The operators ``keys`` of the stream and wide routes as their kernels
    read them from device memory: for K4's and K5's stream route
    (csrc/admm_perr.cu) :func:`operator_entries` at precision ``mode`` of
    ``_KERNEL_OPERATORS``' forms, rows padded to an even stride for 16-byte
    copies; ``narrow`` for K1's and K2's stream route
    (csrc/admm_diag_stream.cu) and K4's and K5's wide route
    (csrc/admm_perr_wide.cu) :func:`narrow_entries`, rows padded to a
    multiple of 4. Each is built
    once per operator, precision and form and kept on the operator (a new
    operator, as ``op.to`` or ``replace`` make, builds its own)."""
    cache = op.__dict__.setdefault("_kernel_operators", {}).setdefault(
        (mode, "narrow") if narrow else mode, {})
    for key in keys:
        if key not in cache:
            M = _KERNEL_OPERATORS[key](op)
            if narrow:
                cache[key] = narrow_entries(
                    torch.nn.functional.pad(M, (0, -M.shape[-1] % 4)), mode)
            else:
                cache[key] = operator_entries(
                    torch.nn.functional.pad(M, (0, M.shape[-1] & 1)), mode)
    return cache


def _launch_dense(packed, op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config, plan):
    """K4 (``packed``) or K5 on the shared route (admm_packed_chunk,
    admm_perr_chunk), the stream route (admm_packed_stream_chunk,
    admm_perr_stream_chunk) or the wide route (admm_packed_wide_chunk,
    admm_perr_wide_chunk), the last two with the lanes ordered by rho index
    and the operators of :func:`kernel_operators`."""
    name = "K4" if packed else "K5"
    n, B = qT.shape
    m = lT.shape[0]
    R = int(op.rho_grid.shape[0])
    rs = int(config.refine_steps)
    mode = kernel_mode(config)
    if plan is None:
        plan = (k4_plan if packed else k5_plan)(n, m, R, rs, B, mode=mode)
    f, i32 = torch.float32, torch.int32
    state = _state_args(n, m, B, qT, lT, uT, idx, xT, sT, yT, axT)
    outs = [torch.empty_like(xT)] + [torch.empty_like(sT) for _ in range(3)]
    ints = dict(n=n, m=m, B=B, R=R, chunk=int(chunk), refine_steps=rs,
                mode=PRECISIONS.index(mode), **plan._asdict())
    floats = (float(config.sigma), float(config.alpha))
    name = _count_key(name, mode)
    if plan.route in ("stream", "wide"):
        # one rho's operators a block: K^-1 (K4: W, with kia below it) and K
        # transposed, A, and on the stream route fl(rho_r A), as the
        # kernel's 8-byte entries; on the wide route A' and fl(rho_r A)',
        # all as 4-byte entries (narrow), with a scratch for the blocks'
        # working copy of their lanes' state (wide_scratch_floats)
        wide = plan.route == "wide"
        first = "w" if packed else "kinv_t"
        ops = kernel_operators(op, mode, first, "k_t", "a", *(("at", "rat") if wide else ("ra",)),
                               narrow=wide)
        if wide:
            ldn, ldm = _round4(n), _round4(m)
            shape, dt = (lambda *dims: dims), f
        else:
            ldn = n + (n & 1)
            shape = lambda *dims: dims if mode == "highest" else dims + (2,)
            dt = torch.float64 if mode == "highest" else f
        order, starts = rho_order(idx, R)
        args = [
            ("[K_invs'; kia'] (entries)" if packed else "K_invs' (entries)", ops[first],
             shape(R, n + m if packed else n, ldn), dt),
            ("Ks' (entries)", ops["k_t"], shape(R, n, ldn), dt),
            ("A_s (entries)", ops["a"], shape(m, ldn), dt),
        ] + ([
            ("A_s' (entries)", ops["at"], shape(n, ldm), dt),
            ("fl(rho A_s)' (entries)", ops["rat"], shape(R, n, ldm), dt),
        ] if wide else [
            ("fl(rho A_s) (entries)", ops["ra"], shape(R, m, ldn), dt),
        ]) + [
            ("rho_vecs", op.rho_vecs, (R, m), f),
            ("rho_invs", op.rho_invs, (R, m), f),
        ] + state[:3] + [("order", order, (B,), i32), ("starts", starts, (R + 1,), i32)] + state[4:]
        _check_args(name, args, qT.device)
        if not wide:
            return _launch(name, f"admm_{'packed' if packed else 'perr'}_stream_chunk", args, outs,
                           [ints[k] for k in K5_STREAM_INTS], floats)
        scratch = torch.empty(wide_scratch_floats(n, m, rs, plan.blocks, plan.lanes, packed,
                                                  plan.cluster), dtype=f, device=qT.device)
        return _launch(name, f"admm_{'packed' if packed else 'perr'}_wide_chunk", args,
                       outs + [scratch], [ints[k] for k in K5_WIDE_INTS], floats)[:4]
    args = [
        ("K_invs", op.K_invs, (R, n, n), f),
        ("Ks", op.Ks, (R, n, n), f),
    ] + ([("kia", _kia(op), (R, n, m), f)] if packed else []) + [
        ("A_s", op.A_s, (m, n), f),
        ("rho_vecs", op.rho_vecs, (R, m), f),
        ("rho_invs", op.rho_invs, (R, m), f),
    ] + state
    _check_args(name, args, qT.device)
    entry = "admm_packed_chunk" if packed else "admm_perr_chunk"
    return _launch(name, entry, args, outs, [ints[k] for k in K5_INTS], floats)


def operator_entries(M: Tensor, mode: str) -> Tensor:
    """An fp32 operator as the 8-byte entries K4's and K5's stream route
    reads from device memory: fp64 at "highest"; at "bf16x3" the pair
    (hi, lo) of :func:`bf16_split`, at "default" (bf16(M), 0), as fp32 in
    a trailing axis of 2. Every precision's entry takes 8 bytes, so the
    panels and their strides are the same in each."""
    if mode == "highest":
        return M.double().contiguous()
    hi, lo = bf16_split(M)
    if mode == "default":
        lo = torch.zeros_like(hi)
    return torch.stack([hi, lo], dim=-1).contiguous()


def narrow_entries(M: Tensor, mode: str) -> Tensor:
    """An fp32 operator as the 4-byte entries K1's and K2's stream route
    reads from device memory and widens once into :func:`operator_entries`'
    8-byte ones as it copies them into shared memory
    (csrc/admm_diag_stream.cu, widen4): the fp32 value at "highest"; at
    "bf16x3" the pair (hi, lo) of :func:`bf16_split`, at "default"
    (bf16(M), 0), as two bf16 values, hi in the low half, viewed as
    float32. Half the bytes of :func:`operator_entries`, the same
    entries."""
    if mode == "highest":
        return M.float().contiguous()
    hi, lo = bf16_split(M)
    if mode == "default":
        lo = torch.zeros_like(hi)
    pair = torch.stack([hi, lo], dim=-1).to(torch.bfloat16).contiguous()
    return pair.view(torch.float32).squeeze(-1)


def _dispatch(kernel, launch, plain, args):
    kind = args[1].device.type
    if kind == "cuda":
        return launch(*args)
    if kind == "cpu":
        return plain(*args)
    raise ValueError(f"{kernel} runs on CUDA (or its plain version on CPU), not {kind}")


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

    CUDA tensors launch K1 on the route :func:`k1_plan` picks
    (``csrc/admm_diag.cu``, or ``csrc/admm_diag_stream.cu`` where the
    shared route has no layout) and raise if it cannot run; CPU tensors
    take the plain version. The state is out of place."""
    return _dispatch(
        "K1", _launch_k1, iterate_chunk_diag_T_plain,
        (op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config),
    )


def iterate_chunk_mixed_T(
    op: AdmmOperator,
    qT: Tensor,  # (n, B)
    lT: Tensor,  # (m, B)
    uT: Tensor,
    idx: Tensor,
    xT: Tensor,  # (n, B)
    sT: Tensor,  # (m, B)
    yT: Tensor,
    axT: Tensor,
    chunk: int,
    config: AdmmConfig,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``chunk`` ADMM iterations of a mixed-A QP batch, lane-last.

    CUDA tensors launch K2 on the route :func:`k2_plan` picks
    (``csrc/admm_mixed.cu``, or ``csrc/admm_diag_stream.cu`` where the
    shared route has no layout) and raise if it cannot run; CPU tensors
    take the plain version. The state is out of place."""
    return _dispatch(
        "K2", _launch_k2, iterate_chunk_mixed_T_plain,
        (op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config),
    )


def iterate_chunk_dense_packed_T(
    op: AdmmOperator,
    qT: Tensor,  # (n, B)
    lT: Tensor,  # (m, B)
    uT: Tensor,
    idx: Tensor,
    xT: Tensor,  # (n, B)
    sT: Tensor,  # (m, B)
    yT: Tensor,
    axT: Tensor,
    chunk: int,
    config: AdmmConfig,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``chunk`` ADMM iterations of a dense-A QP batch on K4, lane-last.

    CUDA tensors launch K4 (``csrc/admm_perr.cu``) on the route
    :func:`k4_plan` picks and raise if it cannot run; CPU tensors take the
    plain version. The state is out of place."""
    return _dispatch(
        "K4", _launch_k4, iterate_chunk_dense_packed_T_plain,
        (op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config),
    )


def iterate_chunk_dense_perr_T(
    op: AdmmOperator,
    qT: Tensor,  # (n, B)
    lT: Tensor,  # (m, B)
    uT: Tensor,
    idx: Tensor,
    xT: Tensor,  # (n, B)
    sT: Tensor,  # (m, B)
    yT: Tensor,
    axT: Tensor,
    chunk: int,
    config: AdmmConfig,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``chunk`` ADMM iterations of a dense-A QP batch on K5, lane-last.

    CUDA tensors launch K5 (``csrc/admm_perr.cu``) on the route
    :func:`k5_plan` picks and raise if it cannot run; CPU tensors take the
    plain version. The state is out of place."""
    return _dispatch(
        "K5", _launch_k5, iterate_chunk_dense_perr_T_plain,
        (op, qT, lT, uT, idx, xT, sT, yT, axT, chunk, config),
    )


def _check_precision(config: AdmmConfig) -> None:
    mode = str(config.kernel_precision)
    if mode != "hybrid":  # the driver's schedule over "bf16x3" and "highest"
        _check_mode(mode)


ChunkFn = Callable[..., Tuple[Tensor, Tensor, Tensor, Tensor]]


def chunk_fn_for(
    op: AdmmOperator, plain: bool = False, config: Optional[AdmmConfig] = None
) -> ChunkFn:
    """The chunk function of the kernel that takes ``op`` (or its plain
    version): K1 for a diagonal A, K2 for a mixed one, and for a dense one
    K4 or K5 as :func:`use_packed` says for ``config.refine_steps``. A
    dense shape that the chosen kernel does not take raises ValueError:
    nothing falls back to the other kernel, which computes another
    function, or to the CPU."""
    if op.diag_a:
        return iterate_chunk_diag_T_plain if plain else iterate_chunk_diag_T
    if op.mixed_a:
        return iterate_chunk_mixed_T_plain if plain else iterate_chunk_mixed_T
    if op.n_ball:
        raise ValueError("the fused kernels take no ball rows")
    if config is None:
        raise ValueError("a dense operator's kernel (K4 or K5) depends on the config's refine_steps")
    m, n = (int(d) for d in op.A_s.shape)
    R = int(op.rho_grid.shape[0])
    rs = int(config.refine_steps)
    packed = use_packed(n, m, R, rs)
    name = "K4" if packed else "K5"
    if not (k4_fits if packed else k5_fits)(n, m, R):
        raise ValueError(
            f"no kernel takes this dense operator: use_packed picks {name} for "
            f"n={n}, m={m}, R={R}, refine_steps={rs}, and {name} takes n <= "
            f"{MAX_WIDE_N} and 1 to {MAX_WIDE_ROWS} rows"
        )
    if packed:
        return iterate_chunk_dense_packed_T_plain if plain else iterate_chunk_dense_packed_T
    return iterate_chunk_dense_perr_T_plain if plain else iterate_chunk_dense_perr_T


def _solve_batch_fused_T(
    op: AdmmOperator,
    q: Tensor,  # (B, n) unscaled
    l: Tensor,  # (B, m)
    u: Tensor,
    z0: Optional[Tensor],
    y0: Optional[Tensor],
    config: AdmmConfig,
    chunk_fn: ChunkFn,
):
    """Lane-last driver for diagonal, mixed and dense A: transposes once at
    entry and exit; between chunks, exact unscaled residuals (P_s @ x as a
    matmul; the box block of A'y and Ax is elementwise, the dense tail A2,
    or a dense A whole, an fp32 matmul), the OSQP per-lane rho rule, the
    NaN guard and the freezing of converged lanes. One host read of
    ``done`` per chunk.

    Under ``kernel_precision="hybrid"`` (``admm_pallas.py:1093-1115`` and
    ``:1272-1300``) a chunk runs "highest" when the worst open lane's
    max(r_prim, r_dual), +inf before the first check, is at most
    ``hybrid_switch_residual``, else "bf16x3"; the same host read carries
    that switch. The diagnostics are fp32 in every precision; at any but
    "highest" a lane is certified only where the primal test also holds
    on the exact image A x, not only on the chunks' running image ax (a
    divergence from the JAX driver, which tests ax alone: ROADMAP Queue
    3). The rho rule and the reported residuals are JAX's."""
    B = q.shape[0]
    n = op.A_s.shape[1]
    R = int(op.rho_grid.shape[0])
    ck = max(1, int(config.check_interval))
    D_c = op.D[:, None]  # (n, 1)
    E_c = op.E[:, None]  # (m, 1)
    dvec = torch.diagonal(op.A_s[:n, :n])[:, None]
    a2 = op.A_s[n:] if op.mixed_a else None  # (m - n, n) dense tail
    qT = ((op.c * op.D)[:, None] * q.T).contiguous()
    lT = (E_c * l.T).contiguous()
    uT = (E_c * u.T).contiguous()

    def a_apply(x):  # A_s @ x
        if op.dense_a:
            return op.A_s @ x
        if a2 is None:
            return dvec * x
        return torch.cat([dvec * x, a2 @ x])

    def at_apply(y):  # A_s' y
        if op.dense_a:
            return op.A_s.T @ y
        if a2 is None:
            return dvec * y
        return dvec * y[:n] + a2.T @ y[n:]

    x = torch.zeros_like(qT) if z0 is None else (z0.T / D_c).contiguous()
    y = torch.zeros_like(lT) if y0 is None else (op.c * y0.T / E_c).contiguous()
    ax = a_apply(x).contiguous()
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
        Aty = at_apply(y)
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
        if bf16_image:  # the certificate also holds on the exact image A x
            Ax = a_apply(x)
            conv = conv & ((E_inv * (Ax - s)).abs().amax(0) <= config.eps_abs + config.eps_rel
                           * torch.maximum((E_inv * Ax).abs().amax(0), (E_inv * s).abs().amax(0)))
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
    # a bf16 precision's chunks carry the constraint image ax from their
    # bf16 products, and JAX's test of r_prim on it certified lanes whose
    # A x - s was 3.3 x the bar (dense h20 equality QP, bf16x3; PERF.md
    # section 6): there the test also holds on A x in fp32
    bf16_image = str(config.kernel_precision) != "highest"
    hybrid = str(config.kernel_precision) == "hybrid"
    if hybrid:  # the chunk's config by whether the open lanes reached the switch
        by_switch = {flag: dataclasses.replace(config, kernel_precision=mode)
                     for flag, mode in ((True, "highest"), (False, "bf16x3"))}
    cfg = config
    it = 0
    while it < config.max_iter:
        if hybrid:
            r_active = torch.where(done, 0.0, torch.maximum(rp, rd)).amax()
            finished, below = torch.stack(
                [done.all(), r_active <= config.hybrid_switch_residual]).tolist()
            cfg = by_switch[below]
        else:
            finished = bool(done.all())
        if finished:
            break
        x2, s2, y2, ax2 = chunk_fn(op, qT, lT, uT, idx, x, s, y, ax, ck, cfg)
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
    chunk_fn: Optional[ChunkFn] = None,
):
    """Batched QP solve on K1 (diagonal A), K2 (mixed A), or K4/K5 (dense
    A, as :func:`use_packed` picks). Returns (z, y,
    s, status, iterations, primal_residual, dual_residual), each with a
    leading batch axis, on the device of ``q``. ``chunk_fn`` defaults to
    the kernel's wrapper (:func:`chunk_fn_for`); its plain version may be
    passed to re-solve on the card for comparison."""
    if op.n_ball:
        raise ValueError("fused kernel does not support ball rows")
    fn = chunk_fn_for(op, config=config) if chunk_fn is None else chunk_fn
    _check_precision(config)
    if q.device.type == "cuda":
        assert_ieee_fp32()
    return _solve_batch_fused_T(op, q, l, u, z0, y0, config, fn)
