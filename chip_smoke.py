"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's kernel paths and its general engines at full size,
through the entry points a user calls (``proceed_controller(...,
device=card)``, then ``parallel`` and ``step``):

- K1, the box-only main path: the QTP plant at horizon 20 (n = m = 40),
  16384 scenarios, tier 1 on the diagonal-A kernel K1 (rho grid (1, 10), no
  refinement, 75 iterations), stragglers gathered on the device into a
  512-lane bucket for tier 2 (rho grid (0.1, 1, 10, 100), 2 refinement
  steps, 250 iterations), then the host f64 oracle; and a 4096-lane closed
  loop on the true plant;
- K2, the mixed-A path: the suite's terminal-ingredient config
  (benchmarks_suite.py config 2: h20, equality and neighborhood terminals,
  the default rho grid of 5 with one refinement step, 1000 iterations,
  2048 initial states 0.65 + 0.002 N(0, 1)) through ``solve_batch_auto``,
  and the state-constrained h20 controller on 2048 of bench.py's initial
  states;
- K3, the long-horizon Riccati path: the QTP plant at horizon 500, where
  ``engine="auto"`` designs the Riccati engine (benchmarks_suite.py config
  6, ``RiccatiConfig(max_iter=1000)``), 1024 initial states
  clip(0.65 + 0.1 N(0, 1), 0.3, 1.3) through ``solve_batch_auto``; the
  same at horizon 50 over 4096 states (``engine="riccati"``); and a
  1024-lane closed loop at h500. K3's driver runs two small per-lane
  kernels of its own, the rollout and the certificate. K3 lays each launch
  out by shape (``riccati_fused.k3_plan``): the lanes' rows in shared
  memory beside fp64 factors, or with fp32 factors in shared or device
  memory, or the rows streamed from device memory; every route is held to
  the plain version at a shape that takes it;
- K4 and K5, the dense-A path: the same QTP QPs with their state or
  terminal rows moved above the input-box rows (OSQP's convention, rows
  not box-first), so the designer's operator classes are bypassed and
  ``use_packed`` picks the kernel: the h20 equality terminal on K4 (2048
  of the suite's states; K4's shared route, laid out by
  ``admm_fused.k4_plan``), the h20 state box on K5 (2048 of bench.py's
  states; K5's shared route, laid out by ``admm_fused.k5_plan``) and the
  h50 state box on K5 (its stream route), through
  ``parallel.solve_batch_fused``, each h20 cell held to the K2 solve of
  the same QP. K4 and K5 are two instantiations of the kernels of
  ``csrc/admm_perr.cu``;
- the general engines and the runtime: the verify skill's closed loop of
  ``step`` (h20, input boxes, the default AdmmConfig, 50 steps on the true
  plant) on the general ADMM engine, ``parallel.solve_batch`` at B = 1, 8
  and 128 against the QTP's 5 s sample time, fused against general at
  B = 4096 (the default config) and 16384 (tier 1's), the contractive
  terminal and soft state rows (no kernel takes them) through
  ``solve_batch_auto``, the per-lane Riccati engine on K3 (``step`` at
  h500 and B = 1, and tier 2 of ``solve_batch_escalated`` on the h500
  cell), and the general engine on the card against the CPU;
- learned plants (``learned_phase``): the golden's frozen fnn
  (tests/golden/qtp_nl_golden.npz) and a resnet trained on the card by
  ``benchmarks/training.py`` as QTP plants (benchmarks_suite.py configs 3
  and 4: h10, 256 states): the SQP controller, single and multiple
  shooting and with soft state boxes, through ``parallel.solve_batch``;
  ``step`` on the frozen NL goldens and the wide plant, and at B = 1 over
  the true plant; the SQP on the card against the CPU; and the fnn
  linearized at the reference (programming type "linear") on K1 through
  ``solve_batch_escalated`` at bench.py's tiers and 16384 states;
- the controller types (``controllers_phase``): a Riccati controller on a
  wide plant (32 states, 16 inputs, h30, 2048 states: K3's (32, 16)
  register tier, whose chunk the routing table sends to K3W and whose
  rollout and certificate RECURRENCE_ROUTES sends to the wide ones, through
  ``solve_batch_auto``), the Takagi-Sugeno fuzzy QTP and the economic QTP
  (h10, 256 states, ``parallel.solve_batch`` and ``step``; the economic
  engine also on the card against the CPU) and the exact-ReLU MILP fleet
  on a relu fnn trained on the card (h5, 32 states, host threads);
- the Riccati sweeps (``riccati_sweeps_phase``): K3W, the width-general
  Riccati chunk (``csrc/riccati_wide_seq.cu``; its doubling form
  ``csrc/riccati_wide.cu``), with the wide rollout and certificate
  (``csrc/riccati_wide_rec.cu``), on a (64, 32) plant at h30 past K3's (32, 16)
  (``solve_batch_auto``, ``parallel.solve_batch`` over 1024 states, 10
  ``step``s, the card against the CPU), and its doubling form under
  ``RiccatiConfig(parallel_sweeps=True)`` on suite config 6 (h500, 1024
  states, the per-lane engine against itself on K3) and in a 20-step h500
  closed loop at B = 1;
- the kernel precisions (``precision_phase``): K1, K2, K4 and K5 at
  "bf16x3" and "default" against their plain versions at the main path's
  shapes and on both dense routes, each timed beside "highest"; the
  headline tier-1 cell, the K2 state box and the dense cells solved under
  every ``kernel_precision``, each certified lane's residuals recomputed in
  fp64 from the timed solve's own z, y and s. A bf16 precision's bound
  takes its passes at the bf16 tensor-core rate; ``fp32_floor_ms`` beside
  it is this design's floor, the passes as fp32 multiply-adds;
- the scenario-sharded solve (``sharded_phase``): ``parallel.make_mesh``
  and ``parallel.solve_sharded`` on one NCCL rank (the headline's tier-1
  cell on K1 and the h500 cell on K3, each against the batch path bit for
  bit, with both timed by ``utils.profiling.benchmark``) and on two gloo
  ranks, spawned processes sharing the card (the tier-1 cell, 8192 lanes a
  rank, each shard against a solve of its rows), and the escalated
  headline's roofline (``utils.roofline.speed_of_light_tiered``);
- K1's and K2's stream route (``stream_phase``, ``csrc/admm_diag_stream.cu``):
  each kernel against its plain version at the widths the Pallas bodies
  take past the shared routes (the QTP at h50 and its tier 2, h100 and
  h264 box-only, the (16, 8) plant at h30, the h50 state box at every
  precision), then the cells qtp-h50-default-B4096, qtp-sc-h50-B2048 and
  wide16x8-h30-B4096 through ``parallel.solve_batch_fused`` against the
  general engine on the same states;
- K4's and K5's wide route (``wide_phase``, ``csrc/admm_perr_wide.cu``):
  each kernel against its plain version at the dense shapes the Pallas
  bodies take past the shared and stream routes (n <= 128, m <= 512): the
  QTP's h100 state box (every precision) and equality terminal at the
  default config, its h154 state box and h228 equality terminal at tier
  1's grid (the widest the JAX package fuses), the (32, 1) plant's h20
  state box on K4 (660 rows); then the cells dense-sc-h100-B2048 and
  dense-eq-h100-B2048 through ``parallel.solve_batch_fused`` against the
  general engine on the same states, and dense-sc32x1-h20-B2048 on K4
  against the same solve with its plain version.

Phases (any failure raises and exits non-zero):
1. the card: its name, count, and power limit from nvidia-smi;
2. build: csrc/*.cu with one nvcc per source, all at once (a summary of
   the -Xptxas -v report is printed, the whole report is written to
   build/kernels/ptxas.txt), and the native oracle with g++, into build/;
3. each kernel against its plain PyTorch version on the card at its
   main-path shapes (K1 at tier 1's 16384 lanes and the closed loop's 4096
   and at tier 2's bucket, K2 at every tail the paths give it, each with
   random rho indices and with one index for all lanes, then both at
   ragged batches, each with its k1_plan or k2_plan line, and K1 at the
   default config's R = 5 with one refinement (the general phase's A/B);
   K3 at h500 (1024 lanes, and the runtime's one lane) and at one h50
   shape per branch of the kernel, then at the shapes that take the other
   routes of its plan: h500 with the state box, a ragged batch, longer
   horizons, an (8, 4) and a (16, 8) plant, and in the controllers' phase
   the (32, 16) tier on each of its routes, beside K3W on the same inputs
   (equal bit for bit); K3's rollout and certificate
   kernels at h500 (1024 lanes, one lane, and the 256-lane bucket of the
   escalated solve's tier 2); K3W sequential at (32, 16) h30 in the
   controllers' phase and in the sweeps' phase at (64, 32) h30 (with the
   chain floor) and (40, 20) h10 on its three routes, K3W-doubling at the
   QTP's h500 (1024 lanes and one, beside K3 on the same inputs), h50 and
   h24, each shape also on the other routes and rings its plan takes there
   (a model line each: L2 operator bytes, conversion and FMA floors, phases
   and barriers an iteration), and the wide rollout and certificate at
   (64, 32) h30 (1024 lanes and one), (40, 20) h10 with the state box and,
   in the controllers' phase, (32, 16) h30 (2048, 256 and one lane), each
   with its wide_recurrence_plan line, device times from CUDA graphs after
   0.3 s of warm-up with the SM clock beside them, and their chain floor
   (N x nx dependent fp64 multiply-adds at scripts/fp64_rate_probe.py's
   chain latency, measured once a run); K4 at the h20 equality
   terminal (random and one rho index, tier 2's bucket, a ragged batch),
   the state box at tier 1's grid (no refinement) and the neighborhood
   terminal (its stream route), K5 at h20 (random and one rho index, tier
   2's bucket, a ragged batch) and h50, each with its k4_plan or k5_plan
   line), every ADMM kernel equal
   bit for bit (max_ulps 0), with times from CUDA graphs (K3's from CUDA
   events), and beside K1's, K2's, K4's and K5's their shared-memory floor
   (smem_floor_ms) and beside K3's the time of its dependency chain alone
   (chain_floor_ms);
4. each path, with the launch counts set to 0 just before it and read
   just after, showing that it went through its kernel and never through
   a plain version (the general engines' phase: K1 on the fused side of
   its A/B, K3 and its recurrence kernels in the per-lane engine; the
   sharded phase: K1, and K3 with its recurrences, in this process, and
   K1 in the gloo ranks; the
   learned phase: no kernel on the SQP cells, K1 on the learned-linear
   cell, held to its plain version on that operator first; the
   controllers' phase: the chunk the routing table picks (K3W, never K3)
   and the recurrences RECURRENCE_ROUTES picks (the wide ones, never K3's)
   on the wide Riccati cell, no kernel on the fuzzy,
   economic and MILP cells; the sweeps' phase:
   K3W and the wide recurrences on the (64, 32) cell and never K3,
   K3W-doubling and never K3 on the per-lane engine under
   parallel_sweeps);
5. where the time goes in each path's cells (torch.profiler: device time
   per solve, the kernels' share of it, the card's idle share); then
   re-solves of 256 lanes with the plain versions (K3's at h50, K4's at
   the dense h20 equality cell, K5's at h50).

The last two lines are the card's name and power limit, and
{"ok": true, "device": {...}}; the line before them lists the kernels
with their launches, errors, times and bounds. Exits non-zero without
printing them when no card is visible or when the script stands outside
its repository.
"""

import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "automationlabsmodelpredictivecontrol_jl_torch"
TPU_ADMM = "automationlabsmodelpredictivecontrol_jl_tpu/ops/admm_pallas.py"
TPU_RICCATI = "automationlabsmodelpredictivecontrol_jl_tpu/ops/riccati_pallas.py"
SHAPES_OK_REL = 1e-4  # kernel vs plain, relative to max(1, ||plain||_inf)
U_OK = 5e-4  # plain re-solve vs kernel re-solve, absolute on u
CONV_OK = 0.999  # in-program converged fraction of the h20 and h500 paths

B_MAIN, BUCKET, B_CL, CL_STEPS = 16384, 512, 4096, 5
B_SLICE, B_RESOLVE, REPS, REPS_SC = 2048, 256, 20, 5
B_H500, B_H50, REPS_RICCATI = 1024, 4096, 10
RAGGED = (1, 33, 77, 1000)  # tier-2 buckets of K1 and K2
VERIFY_STEPS, RICCATI_STEPS, REPS_AB = 50, 5, 5  # the general engine's phase
ESC_TIER1_ITERS = 100  # leaves ~20% of the h500 cell's lanes to tier 2
CARD_CPU_COMPARED = 0.85  # least share of lanes converged on the card and on the CPU
# the learned-plant phase: suite configs 3 and 4 at their width
B_SQP, REPS_SQP, B_SQP_CPU, SQP_STEPS = 256, 10, 64, 20
SQP_CONV_OK = 0.99  # converged fraction of the fnn SQP cells
SQP_STATUS_OK = 0.98  # least share of equal statuses, card against CPU
NL_U_OK, WIDE_OK = 1e-3, 1e-4  # the frozen NL goldens' bars (tests/test_golden_nl.py)
# the controller types' phase: the wide Riccati row and the extra
# benchmarks' fuzzy and economic rows, and the suite's MILP fleet
B_WIDE, REPS_WIDE, B_CTRL, REPS_CTRL, B_CTRL_CPU, CTRL_STEPS = 2048, 5, 256, 5, 64, 10
B_MILP, REPS_MILP = 32, 3
CTRL_CONV_OK = 0.99  # converged fraction of the fuzzy and economic cells
# the Riccati sweeps' phase: K3W past (32, 16) and the doubling sweeps
REPS_SWEEPS, WIDE_STEPS, H500_STEPS, B_SWEEPS_CPU, H_SWEEPS = 3, 10, 20, 64, 500
# the kernel precisions' phase: bf16x3 u against highest on the headline
# (the JAX package's own bar, tests/test_pallas_fused.py), and the slack on
# a certified lane's residuals recomputed in fp64 from the returned fp32
# solution (highest's own reach 1.19 x the bar there: its running image
# ax against A z)
PRECISIONS, REPS_PREC, U_BF16X3, CERT_SLACK = ("highest", "bf16x3", "default", "hybrid"), 3, 5e-3, 2.0
# the stream route's phase: K1 and K2 past their shared routes, the solve
# cells' repetitions and batches
REPS_STREAM, B_STREAM = 3, 4096
# the wide route's phase: K4 and K5 past their shared and stream routes,
# the solve cells' repetitions, the tier-1 batch of the widest shapes, and
# the lanes and iterations of the K4 cell's re-solve with the plain version
REPS_WIDE_ROUTE, B_WIDE_T1, B_WIDE_PLAIN, WIDE_PLAIN_ITERS = 3, 1024, 64, 100
# the sharded phase: the headline's tier-1 config (bench.py's), the gloo
# ranks that share the card, the latency repetitions, the seconds a rank
# may take, and the phase's budget (recorded, not enforced)
TIER1 = dict(max_iter=75, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0)
RANKS_SHARED, REPS_SHARDED, RANK_JOIN_S, SHARDED_BUDGET_S = 2, 5, 120, 60.0


def log(**kv):
    print(json.dumps(kv), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(report: str):
    """(kernel template arguments, registers, spill stores) of each kernel
    in the -Xptxas -v report."""
    rows, name, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kind = next(k for key, k in (
                ("riccati_wide_rollout", "rollout-wide"),
                ("riccati_wide_certificate", "certificate-wide"), ("riccati_wide_seq", "K3W"),
                ("riccati_wide_kernel", "K3W-doubling"),
                ("riccati_admm_chunk", "K3"), ("riccati_rollout", "K3 rollout"),
                ("riccati_certificate", "K3 certificate"),
                ("riccati_chain_floor", "K3 chain floor"), ("admm_stream_kernel", "stream"),
                ("admm_wide_kernel", "wide"), ("perr_stream", "K5 stream"),
                ("admm_perr", "K5"), ("mixed", "K2"), ("", "K1"),
            ) if key in name)
            targs = re.findall(r"L[ib](\d+)E", name)  # int and bool arguments
            if kind in ("stream", "wide"):  # K1's and K2's stream route: TAIL, the
                # precision, the lanes and rows a thread; K4's and K5's wide
                # route: PACKED, the precision
                pair = ("K2", "K1") if kind == "stream" else ("K4", "K5")
                lanes = "".join(f" {tag}{v}" for tag, v in zip(("x", "r"), targs[2:]))
                kind = f"{pair[0] if targs[0] == '1' else pair[1]} {kind}" + (
                    "" if targs[1] == "0" else f" {('bf16x3', 'default')[int(targs[1]) - 1]}"
                ) + lanes
            elif kind in ("K1", "K2", "K5", "K5 stream"):
                # the precision comes last (sources before it have none)
                flags, precision = targs, "highest"
                if len(targs) == {"K1": 5, "K2": 3}.get(kind, 7):
                    flags, precision = targs[:-1], ("highest", "bf16x3", "default")[int(targs[-1])]
                if kind.startswith("K5") and flags[-1] == "1":  # PACKED: K4
                    kind = kind.replace("K5", "K4")
                if precision != "highest":
                    kind = f"{kind} {precision}"
            rows.append(dict(kernel=kind, template=[int(a) for a in targs],
                             registers=int(m.group(1)), spill_bytes=spill))
            name, spill = None, 0
    return rows


def cuda_ms(fn, reps=20, warm_up=True):
    """Mean milliseconds of fn() over reps launches (after one warm-up),
    from CUDA events."""
    import torch

    if warm_up:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_once(fn):
    """(fn(), its milliseconds from CUDA events around the one call)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_graph_ms(fn, reps=20, repeats=5, warm_s=0.0):
    """Device milliseconds per call of fn(): reps calls captured in a CUDA
    graph, replayed `repeats` times, the median replay over reps. For
    kernels whose launch takes about as long on the host as the kernel on
    the card, where cuda_ms would time the host. ``warm_s``: replay for
    that many seconds first, so that a card left idle between small
    kernels (its lowest clock) is timed at its
    working clock."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = time.perf_counter()
    while time.perf_counter() - start < warm_s:
        graph.replay()
        torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bench_x0s(B):
    """The benchmark's initial states: default_rng(0),
    clip(0.65 + 0.15 N(0, 1), 0.25, 1.3), shape (B, 4)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return np.clip(0.65 + 0.15 * rng.standard_normal((B, 4)), 0.25, 1.3).astype(np.float32)


def suite_x0s(B):
    """benchmarks_suite.py config 2's initial states: default_rng(0),
    0.65 + 0.002 N(0, 1) in float32, shape (B, 4)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return 0.65 + 0.002 * rng.standard_normal((B, 4)).astype(np.float32)


def suite6_x0s(B):
    """benchmarks_suite.py config 6's initial states: default_rng(0),
    clip(0.65 + 0.1 N(0, 1), 0.3, 1.3), shape (B, 4)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return np.clip(0.65 + 0.1 * rng.standard_normal((B, 4)), 0.3, 1.3).astype(np.float32)


def _errors(outs_k, outs_p, tag):
    """Max absolute and relative error, and the largest distance in fp32
    ulps, of a kernel's outputs against its plain version's."""
    import torch

    abs_err, rel_err, ulps = 0.0, 0.0, 0
    for a, b in zip(outs_k, outs_p):
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"{tag} produced non-finite values")
        e = float((a - b).abs().max())
        abs_err = max(abs_err, e)
        rel_err = max(rel_err, e / max(1.0, float(b.abs().max())))
        ulps = max(ulps, int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max()))
    return abs_err, rel_err, ulps


def riccati_inputs(ctrl, B, seed, x0s_fn):
    """A chunk's inputs at a real shape: initial states from x0s_fn, the
    ball radius they give, and a seeded state near the driver's start."""
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati

    x0s = torch.from_numpy(x0s_fn(B)).to(ctrl.device)
    e0T = (x0s - ctrl.tuning.references.x[:, 0]).T.contiguous()
    ridx = riccati._initial_ridx(ctrl.engine.op, ctrl.engine.config)
    return operator_inputs(ctrl.engine.op, ridx, e0T, seed)


def operator_inputs(op, ridx, e0T, seed):
    """A chunk's inputs for a Riccati operator on the card: the grid index,
    the initial deviations e0T (nx, B) and a seeded state of scale 0.05."""
    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati

    dev, B = e0T.device, int(e0T.shape[1])
    rng = np.random.default_rng(seed)
    noise = lambda *shape: torch.from_numpy(
        (0.05 * rng.standard_normal(shape)).astype(np.float32)
    ).to(dev)
    N, nx, nu = op.N, op.nx, op.nu
    return (op, torch.tensor([ridx], dtype=torch.int32, device=dev), e0T,
            riccati.ball_radius(op, e0T), noise(N + 1, nx, B), noise(N, nu, B),
            noise(N + 1, nx, B), noise(N, nu, B))


def operator_like(op, N, state_constraint):
    """The Riccati operator of op's plant, weights and boxes at another
    horizon, with or without the state box, on op's device: a shape of the
    suite's horizon sweep without the controller's design."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati

    dev = op.rho_tab.device
    c = op.to("cpu")
    f = lambda t: t.double().numpy()
    return riccati.build_riccati_operator(
        f(c.factors.A), f(c.factors.B), f(c.Q), f(c.R_in), f(c.P_term), N, f(c.x_lo),
        f(c.x_hi), f(c.u_lo), f(c.u_hi), state_constraint,
        config=riccati.RiccatiConfig(max_iter=1000),
    ).to(dev)


def wide_operator(nx, nu, N, dev, seed):
    """A Riccati operator with the state box for a seeded stable plant of nx
    states and nu inputs: K3's wider register tiers."""
    import numpy as np

    from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nx, nx))
    A *= 0.95 / np.abs(np.linalg.eigvals(A)).max()
    return riccati.build_riccati_operator(
        A, 0.5 * rng.standard_normal((nx, nu)), np.eye(nx), 0.5 * np.eye(nu), 2.0 * np.eye(nx),
        N, -np.ones(nx), np.ones(nx), -0.5 * np.ones(nu), 0.5 * np.ones(nu), True,
    ).to(dev)


def chain_floor_ms(N, nx, nu, chunk, dev):
    """Milliseconds of K3's dependency chain alone: one warp runs the
    dependent instructions of N x chunk sweep steps and as many rollout
    steps from registers, with no memory in the loop (riccati_chain_floor).
    What a recurrence of this length can reach, beside the operations
    bound."""
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build

    lib = _build.load_kernels()
    io = torch.full((34,), 0.5, dtype=torch.float32, device=dev)

    def launch():
        err = lib.riccati_chain_floor(io.data_ptr(), N, nx, nu, chunk,
                                      torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"riccati_chain_floor launch failed: cudaError_t {err}")

    return cuda_ms(launch, reps=5)


def compare_k3(ctrl, branch, B, seed, x0s_fn, plain_reps):
    """K3 against its plain version for one chunk at one of the
    controllers' shapes, on the card."""
    chunk = int(ctrl.engine.config.check_interval)
    return compare_k3_args(riccati_inputs(ctrl, B, seed, x0s_fn) + (chunk,), branch, plain_reps)


def compare_k3_args(args, branch, plain_reps, route=None):
    """K3, laid out as its plan says for the shape (or on a forced
    ``route``), against its plain version on one chunk's inputs."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati_fused
    from automationlabsmodelpredictivecontrol_jl_torch.utils import roofline

    op, B, chunk = args[0], int(args[2].shape[1]), args[-1]
    plan = riccati_fused.k3_plan(op, B, route)
    log(phase="k3_plan", branch=branch, N=op.N, nx=op.nx, nu=op.nu, B=B, **plan._asdict())
    kernel, plain = riccati_fused.iterate_chunk_riccati, riccati_fused.iterate_chunk_riccati_plain
    if route is not None:
        kernel = lambda *a: riccati_fused._launch_k3(*a, route=route)
    # the plain version's compared run is also its timed one where one run
    # is timed (seconds a run at h500: each repetition costs the script that)
    out_p, plain_once_ms = cuda_ms_once(lambda: plain(*args))
    abs_err, rel_err, ulps = _errors(kernel(*args), out_p, "K3")
    rec = dict(branch=branch, N=op.N, nx=op.nx, nu=op.nu, B=B, chunk=chunk,
               rho_index=int(args[1][0]), route=plan.route, lanes=plan.lanes,
               blocks=plan.blocks, smem_bytes=plan.smem_bytes,
               split_interior=op.split_interior, terminal_ball=op.terminal_ball,
               term_rho_scale=op.term_rho_scale, max_abs_err=abs_err, max_rel_err=rel_err,
               max_ulps=ulps)
    if rel_err > SHAPES_OK_REL or ulps != 0:
        raise RuntimeError(f"K3 disagrees with its plain version: {rec}")
    rec["ms"] = cuda_ms(lambda: kernel(*args))
    rec["plain_ms"] = (plain_once_ms if plain_reps == 1 else
                       cuda_ms(lambda: plain(*args), reps=plain_reps, warm_up=False))
    rec["bound_ms"], rec["bound_by"] = roofline.riccati_chunk_bound(
        op.N, op.nx, op.nu, B, chunk, op.split_interior
    )
    return rec


def compare_recurrences(ctrl, B, seed, x0s_fn):
    """The rollout and certificate kernels against their plain versions at
    the cell's shape (the certificate on a chunk's worth of dual change)."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati_fused
    from automationlabsmodelpredictivecontrol_jl_torch.utils import roofline

    op, _, e0T, ballr, _, vU, lamX, lamU = riccati_inputs(ctrl, B, seed, x0s_fn)
    lamX2, lamU2 = lamX + 0.01 * lamX.flip(0), lamU - 0.02 * lamU.flip(0)
    N, nx, nu = op.N, op.nx, op.nu
    recs = []
    for name, kernel, plain, args, bound in (
        ("rollout", riccati_fused.rollout, riccati_fused._rollout_plain, (op, e0T, vU),
         roofline.rollout_bound(N, nx, nu, B)),
        ("certificate", riccati_fused.certificate_terms, riccati_fused.certificate_terms_plain,
         (op, lamX2, lamX, lamU2, lamU, riccati_fused.rollout(op, e0T, vU), ballr),
         roofline.certificate_bound(N, nx, nu, B)),
    ):
        abs_err, rel_err, ulps = _errors([kernel(*args)], [plain(*args)], name)
        rec = dict(kernel=name, N=N, B=B, max_abs_err=abs_err, max_rel_err=rel_err, max_ulps=ulps)
        if rel_err > SHAPES_OK_REL:
            raise RuntimeError(f"the {name} kernel disagrees with its plain version: {rec}")
        rec["ms"] = cuda_ms(lambda: kernel(*args))
        rec["plain_ms"] = cuda_ms(lambda: plain(*args), reps=2, warm_up=False)
        rec["bound_ms"], rec["bound_by"] = bound
        recs.append(rec)
    return recs


def kernel_inputs(ctrl, B, seed, x0s_fn, single_index=False):
    """One chunk's arguments for the kernel that takes the controller's
    operator (K1, K2, K4 or K5), on its device: the QP vectors of B initial
    states from x0s_fn, a seeded state of scale 0.05 and the lanes' rho
    indices, drawn at random or all at the start index of the config."""
    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import start_rho_index
    from automationlabsmodelpredictivecontrol_jl_torch.ops.condense import (
        runtime_qp_vectors_batch,
    )

    dev = ctrl.device
    op, cfg = ctrl.engine.op, ctrl.engine.config
    R = int(op.rho_grid.shape[0])
    m, n = (int(d) for d in op.A_s.shape)
    x0s = torch.from_numpy(x0s_fn(B)).to(dev)
    q, l, u, _, _ = runtime_qp_vectors_batch(
        ctrl.engine.qp, x0s - ctrl.tuning.references.x[:, 0]
    )
    qT = ((op.c * op.D)[:, None] * q.T).contiguous()
    lT = (op.E[:, None] * l.T).contiguous()
    uT = (op.E[:, None] * u.T).contiguous()
    rng = np.random.default_rng(seed)
    noise = lambda rows: torch.from_numpy(
        (0.05 * rng.standard_normal((rows, B))).astype(np.float32)
    ).to(dev)
    x, y, ax = noise(n), noise(m), noise(m)
    s = torch.clamp(ax, lT, uT).contiguous()
    idx = rng.integers(0, R, size=B).astype(np.int32)
    if single_index:
        idx[:] = start_rho_index(cfg) if R > 1 else 0
    idx = torch.from_numpy(idx).to(dev)
    return (op, qT, lT, uT, idx, x, s, y, ax, int(cfg.check_interval), cfg)


def smem_floor_ms(n, m, R, refine_steps, B, chunk, kernel="K2"):
    """Least milliseconds of one K1 (m = n), K2, K4 or K5 chunk if its
    shared memory delivered one operator entry per lane and multiply-add at
    one 32-lane wavefront a clock on every SM, B chunk lane-iterations over
    the card's SMs at its highest SM clock. Entries per lane and iteration:
    the K-solves, (1 + 2 refine) n^2, and the products with the constraint
    rows, each entry read once for A'y and A'(rho s) together and once for
    A x: K1 and K2 2 (m - n) n (A2), K5 2 m n (all of A); K4 m n for the
    pass and n m for the image rhs kia and again per refinement, (2 +
    refine) m n. The vector loads, the fp32 product fl(rho a) and the
    entries a lane of another rho index cannot share come on top. R does
    not enter: each lane reads only its own rho's operators."""
    dense = {"K5": 2 * m, "K4": (2 + refine_steps) * m}.get(kernel, 2 * (m - n))
    entries = (1 + 2 * refine_steps) * n * n + dense * n
    return entries * B * chunk / 32 / sm_clocks_per_s() * 1e3


def tile_floor_ms(n, m, B, refine_steps, chunk, plan, packed=False):
    """Least milliseconds of one chunk of K1 (m = n) or K2 on the stream
    route's register tile of ``plan`` (a K1Plan or K2Plan), or of K4
    (``packed``) or K5 on the wide route's (a WidePlan), at "highest": each
    product (admm_fused._k12_products; the wide route's
    admm_fused.wide_layout) at a thread's LT lanes and RT rows loads per 2
    columns RT operator and LT vector entries an operator (the wide pass:
    two) as 16-byte shared-memory loads, 4 clocks of its SM a warp's load
    (scripts/fp64_rate_probe.py), and does 2 RT LT multiply-adds an
    operator at the SM's fp64 FMA rate (card_peaks); each takes the longer
    of the two, padded rows and idle threads left out, at the card's
    highest SM clock."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    fma = card_peaks()["fp64_fma_per_clock_sm"]
    if plan.route == "wide":
        lay = admm_fused.wide_layout(n, m, refine_steps, plan.lanes, plan.tiles, plan.panel,
                                     packed, plan.cluster)
        pass_, solve, kprod, ax = lay.products
        clocks = 0.0
        for g, times in ((pass_, 1), (solve, 1 + refine_steps), (kprod, refine_steps), (ax, 1)):
            if g is None or not times:
                continue
            per_warp = max(2 * g.rt * g.lt * g.ops * 32 / fma, 4 * g.ops * (g.rt + g.lt))
            clocks += times * g.rows * g.cols * per_warp / (32 * g.rt * g.lt * 2)
        return clocks * B * chunk / sm_clocks_per_s() * 1e3
    lt = admm_fused.k12_lanes_per_thread(plan.lanes)
    rows = plan.rpt_n if m > n else plan.rpt
    lay = admm_fused.k12_stream_layout(n, m - n, refine_steps, plan.lanes, plan.groups, rows,
                                       plan.panel)
    clocks = 0.0
    for r, c, _, v, rt in admm_fused._k12_products(n, m - n, refine_steps, rows, lay):
        per_warp = max(2 * rt * lt * v * 32 / fma, 4 * (rt + lt * v))  # 2 columns of a warp
        clocks += r * c * v * per_warp / (32 * rt * lt * 2 * v)  # a lane's multiply-add
    return clocks * B * chunk / sm_clocks_per_s() * 1e3


@functools.lru_cache(maxsize=None)
def sm_clock_now_mhz():
    """The SM clock nvidia-smi reads now, in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    return float(out.stdout.strip().splitlines()[0])


def sm_clock_hz():
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


@functools.lru_cache(maxsize=None)
def card_peaks():
    """The card's peaks, SM count and FMA rates (utils.roofline.device_peaks),
    the one source of the floors' card numbers."""
    from automationlabsmodelpredictivecontrol_jl_torch.utils import roofline

    return roofline.device_peaks(0)


def sm_clocks_per_s():
    """SM clocks a second on the whole card: its SMs at its highest clock."""
    return card_peaks()["sm_count"] * sm_clock_hz()


def compare_kernel(ctrl, B, seed, x0s_fn, plain_reps=REPS, single_index=False):
    """A kernel against its plain version at one shape, on the card; the
    kernel is K1, K2, K4 or K5 as the controller's operator says, at the
    precision its config's kernel_precision names, and must equal it bit
    for bit (max_ulps 0). Each logs its plan; every kernel is timed as a
    CUDA graph (``ms``) and through its wrapper (``wrapper_ms``). Returns
    a record."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
    from automationlabsmodelpredictivecontrol_jl_torch.utils import roofline

    op, cfg = ctrl.engine.op, ctrl.engine.config
    R = int(op.rho_grid.shape[0])
    m, n = (int(d) for d in op.A_s.shape)
    rs = int(cfg.refine_steps)
    mode = admm_fused.kernel_mode(cfg)
    kernel = admm_fused.chunk_fn_for(op, config=cfg)
    plain = admm_fused.chunk_fn_for(op, plain=True, config=cfg)
    args = kernel_inputs(ctrl, B, seed, x0s_fn, single_index)
    chunk = args[-2]

    name = roofline.kernel_of(op, cfg)
    abs_err, rel_err, ulps = _errors(kernel(*args), plain(*args), name)
    rec = dict(
        kernel=name, n=n, m=m, R=R, refine_steps=rs, B=B, chunk=chunk,
        rho_index="single" if single_index else "random",
        max_abs_err=abs_err, max_rel_err=rel_err, max_ulps=ulps,
    )
    if mode != "highest":
        rec["precision"] = mode
    if name == "K1":
        plan = admm_fused.k1_plan(n, R, rs, B, mode=mode)
    elif name == "K2":
        plan = admm_fused.k2_plan(n, m, R, rs, B, mode=mode)
    else:
        plan = (admm_fused.k4_plan if name == "K4" else admm_fused.k5_plan)(n, m, R, rs, B,
                                                                           mode=mode)
    log(phase=f"{name.lower()}_plan", n=n, m=m, R=R, refine_steps=rs, B=B,
        rho_index=rec["rho_index"], **({} if mode == "highest" else dict(precision=mode)),
        **plan._asdict())
    rec["plan"] = plan._asdict()
    if rel_err > SHAPES_OK_REL or ulps != 0:
        raise RuntimeError(f"{kernel.__name__} disagrees with its plain version: {rec}")
    # 0.04-6 ms a launch: graph-timed (device time), and through the wrapper
    rec["ms"] = cuda_graph_ms(lambda: kernel(*args))
    rec["wrapper_ms"] = cuda_ms(lambda: kernel(*args))
    rec["smem_floor_ms"] = smem_floor_ms(n, m, R, rs, B, chunk, name)
    rec["plain_ms"] = cuda_ms(lambda: plain(*args), reps=plain_reps)
    rec["bound_ms"], rec["bound_by"], floor = roofline.chunk_bound(n, m, B, R, rs, chunk, name,
                                                                    mode)
    if floor is not None:
        rec["fp32_floor_ms"] = floor
    return rec


def rows_first(ctrl):
    """The controller with its QP's state and terminal rows moved above the
    input-box rows: the same QP, on an operator built for that order, which
    is dense (its first n rows are not the diagonal input box)."""
    import numpy as np

    from automationlabsmodelpredictivecontrol_jl_torch.design import LinearEngine
    from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import build_operator

    dev = ctrl.device
    c = ctrl.to("cpu")
    qp = c.engine.qp
    m, n = qp.A.shape
    perm = np.r_[np.arange(n, m), np.arange(n)]
    qp = qp.replace(**{k: getattr(qp, k)[perm] for k in ("A", "l_const", "u_const", "b_x0")})
    l, u = qp.l_const.numpy(), qp.u_const.numpy()
    eq = np.isfinite(l) & np.isfinite(u) & (l == u)
    op = build_operator(qp.P.numpy(), qp.A.numpy(), eq, 0, c.engine.config)
    return c.replace(
        engine=LinearEngine(qp=qp, op=op, soft_mu=None, config=c.engine.config)
    ).to(dev)


def timed(fn, reps):
    """fn() once, then reps calls timed by ``utils.profiling.latencies_ms``
    (the host clock, each call ending when its result's devices are done).
    Returns (first result, seconds per call)."""
    import torch
    from automationlabsmodelpredictivecontrol_jl_torch.utils import profiling

    out = fn()
    torch.cuda.synchronize()
    return out, profiling.latencies_ms(fn, warmup=0, reps=reps) / 1e3


def profile(fn, reps, cpu=True):
    """``utils.profiling.trace`` (no file) over reps calls of fn() after one
    warm-up: device milliseconds per call (all kernels and copies; those of
    the port's own kernels apart), kernels per call, and the share of the
    wall time in which the card ran nothing. ``cpu=False`` traces the card
    alone: the host's operator events of a solve of 10^5 small operations
    take minutes to collect."""
    import torch
    from torch.autograd import DeviceType
    from automationlabsmodelpredictivecontrol_jl_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    with profiling.trace(None, host=cpu) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    ours = [e for e in dev if "admm_" in e.name or "riccati_" in e.name]
    k3 = sum(e.time_range.elapsed_us() for e in ours if "riccati_admm_chunk" in e.name) / 1e3
    ours = sum(e.time_range.elapsed_us() for e in ours) / 1e3
    return dict(
        wall_ms_per_call=wall_ms / reps, device_ms_per_call=busy / reps,
        port_kernels_ms_per_call=ours / reps, k3_ms_per_call=k3 / reps,
        device_ops_per_call=len(dev) / reps,
        idle_share=1.0 - busy / wall_ms if dev else None,
    )


def check_solution(sol, B, N, tag, nx=4, nu=2):
    import torch

    for f in ("x", "u", "objective"):
        if not bool(torch.isfinite(getattr(sol, f)).all()):
            raise RuntimeError(f"non-finite {f} in {tag}")
    if tuple(sol.u.shape) != (B, nu, N) or tuple(sol.x.shape) != (B, nx, N + 1):
        raise RuntimeError(
            f"{tag}: unexpected shapes u {tuple(sol.u.shape)}, x {tuple(sol.x.shape)}"
        )


def plain_resolve(parallel, ctrl, x0s, config, plain_fn):
    """256 lanes solved with the kernel and with its plain version on the
    card: statuses equal and u within U_OK."""
    import torch

    s_k, _, _, _ = parallel.solve_batch_fused(ctrl, x0s)
    s_p, _, _, _ = parallel.solve_batch_fused(ctrl, x0s, chunk_fn=plain_fn)
    du = float((s_k.u - s_p.u).abs().max())
    same = bool(torch.equal(s_k.status, s_p.status))
    log(phase="plain_resolve", config=config, lanes=int(x0s.shape[0]), max_abs_u_diff=du,
        statuses_equal=same, converged_kernel=int((s_k.status == 0).sum()),
        converged_plain=int((s_p.status == 0).sum()))
    if du > U_OK or not same:
        raise RuntimeError(f"plain re-solve disagrees with the kernel at {config}")


def kernel_entry(name, source, replaces, launches, shapes):
    head = shapes[0]
    return {
        "name": name,
        "route": "cuda",
        "source": f"{PKG}/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        # no single PyTorch call runs an ADMM chunk or a horizon recurrence
        "library_ms": None,
        "shapes": shapes,
    }


def percentiles_ms(lat):
    import numpy as np

    return float(np.percentile(lat, 50)) * 1e3, float(np.percentile(lat, 99)) * 1e3


def sqp_x0s(B):
    """benchmarks_suite.py config 3's initial states: default_rng(0),
    clip(0.65 + 0.05 N(0, 1), 0.3, 1.3), shape (B, 4)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return np.clip(0.65 + 0.05 * rng.standard_normal((B, 4)), 0.3, 1.3).astype(np.float32)


def golden_fnn(dev):
    """The frozen golden fnn (hidden 8, depth 1, relu; 160 floats in
    tests/golden/qtp_nl_golden.npz, read with numpy) as a learned QTP
    plant on ``dev``, and the golden file's metadata."""
    import numpy as np

    from automationlabsmodelpredictivecontrol_jl_torch import interop
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp
    from automationlabsmodelpredictivecontrol_jl_torch.models import zoo
    from automationlabsmodelpredictivecontrol_jl_torch.systems import NeuralDiscreteSystem

    golden = os.path.join(HERE, "tests", "golden")
    data = np.load(os.path.join(golden, "qtp_nl_golden.npz"))
    with open(os.path.join(golden, "qtp_nl_golden_meta.json")) as f:
        meta = json.load(f)
    apply_fn, act = zoo.make_apply("fnn")
    plant = NeuralDiscreteSystem(
        apply_fn=apply_fn, family="fnn", nx=4, nu=2,
        params=interop.unravel_params("fnn", 4, 2, 8, 1, data["fnn_params"]),
        X=qtp.x_box(), U=qtp.u_box(), activation=act,
    ).to(dev)
    return plant, data, meta


def admm_iterations(fn):
    """fn() once with the general ADMM engine's solves counted: the calls,
    and per call the iterations of its slowest lane (the batch runs until
    then) and the lanes' mean."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm

    calls, orig = [], admm.solve

    def counted(*args, **kwargs):
        res = orig(*args, **kwargs)
        calls.append((int(res.iterations.max()), float(res.iterations.float().mean())))
        return res

    admm.solve = counted
    try:
        fn()
    finally:
        admm.solve = orig
    n = max(len(calls), 1)
    return dict(admm_calls_per_solve=len(calls),
                admm_iterations_per_call_slowest_lane=sum(c[0] for c in calls) / n,
                admm_iterations_per_call_lane_mean=sum(c[1] for c in calls) / n)


def learned_phase(dev, tier1, tier2):
    """Learned plants on the card (benchmarks_suite.py configs 3 and 4 at
    their width, h10, sample time 5 s, references 0.65 / 1.2):

    - sqp-fnn-single-B256 and sqp-fnn-multiple-B256: the golden fnn,
      SqpConfig(max_sqp_iter=8) and (12, multiple shooting), 256 states,
      10 timed batch solves through ``parallel.solve_batch``; the SQP path
      launches none of the port's kernels;
    - sqp-resnet-soft-B256: a resnet (hidden 8, depth 1) trained on the
      card by ``benchmarks/training.py`` (48 x 30 QTP transitions, seed 1,
      600 Adam steps), soft state boxes at 10;
    - nl-golden-on-card: ``step`` on the four frozen NL configs, both
      transcriptions, within 1e-3 of the golden u and x, and the wide
      linear plant (nx 16, nu 8) within 1e-4;
    - sqp-card-vs-cpu: the single-shooting fleet on 64 lanes on both
      devices;
    - sqp-step-loop: ``step`` at B = 1, 20 times, on the true QTP plant;
    - learned-linear-h20-B16384: the fnn linearized at the reference
      (programming type "linear"), bench.py's tier-1 and tier-2 configs,
      ``solve_batch_escalated`` over 16384 states, counted from zero: K1
      launched, no plain version; K1 held to its plain version on this
      operator first (max_ulps 0).
    Returns the K1 launches of the learned-linear path and K1's record on
    its operator."""
    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch import (
        SqpConfig, parallel, proceed_controller, runtime,
    )
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big, qtp, training
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    plant, golden, meta = golden_fnn(dev)
    design = lambda system, cfg, **kw: proceed_controller(
        system, "model_predictive_control", 10, 5.0, [0.65] * 4, [1.2] * 2,
        sqp_config=cfg, device=dev, **kw,
    )
    seconds, t_part = {}, time.perf_counter()

    def lap(part):
        nonlocal t_part
        now = time.perf_counter()
        seconds[part] = now - t_part
        t_part = now

    t0 = time.perf_counter()
    data = training.generate_qtp_dataset(n_traj=48, n_steps=30, seed=0, device=dev)
    resnet, rmse_res = training.trained_system("resnet", data, seed=1)
    torch.cuda.synchronize()
    log(phase="training", family="resnet", seed=1, steps=600, samples=int(data[0].shape[0]),
        rmse=rmse_res, seconds=time.perf_counter() - t0)
    single = design(plant, SqpConfig(max_sqp_iter=8))
    cells = {
        "sqp-fnn-single-B256": (single, None),
        "sqp-fnn-multiple-B256": (design(plant, SqpConfig(max_sqp_iter=12, shooting="multiple")),
                                  None),
        "sqp-resnet-soft-B256": (design(resnet, SqpConfig(max_sqp_iter=8),
                                        mpc_soft_state_constraint=10.0), rmse_res),
    }
    x = torch.from_numpy(sqp_x0s(B_SQP)).to(dev)
    recs = {}
    for cell, (c, rmse) in cells.items():
        admm_fused.reset_counts()
        fn = lambda c=c: parallel.solve_batch(c, x)
        (sol, _, _, d), lat = timed(fn, REPS_SQP)
        check_solution(sol, B_SQP, 10, cell)
        if any(admm_fused.LAUNCHES.values()) or any(admm_fused.PLAIN_CALLS.values()):
            raise RuntimeError(f"{cell}: the SQP path ran a kernel or a plain version")
        p50, p99 = percentiles_ms(lat)
        cfg = c.engine.config
        rec = dict(cell=cell, B=B_SQP, shooting=cfg.shooting, max_sqp_iter=cfg.max_sqp_iter,
                   batch_p50_ms=p50, batch_p99_ms=p99, solves_per_s=B_SQP / float(np.median(lat)),
                   converged_fraction=int(d.n_converged) / B_SQP,
                   mean_sqp_iterations=float(d.mean_iterations),
                   max_sqp_iterations=int(d.max_iterations),
                   max_primal_residual=float(d.max_primal_residual), model_rmse=rmse)
        if cfg.shooting == "single":
            rec.update(admm_iterations(fn))
        else:
            rec["inner_admm_iterations_per_sqp_iteration"] = cfg.ms_admm_iters
        t0 = time.perf_counter()
        rec.update(profile(fn, 1, cpu=False), profile_seconds=time.perf_counter() - t0)
        log(phase="sqp", **rec)
        recs[cell] = rec
    for cell in ("sqp-fnn-single-B256", "sqp-fnn-multiple-B256"):
        if recs[cell]["converged_fraction"] < SQP_CONV_OK:
            raise RuntimeError(f"{cell}: converged fraction too low: {recs[cell]}")
    lap("sqp cells")

    for cfg in meta["nl_configs"]:
        for shooting in ("single", "multiple"):
            kw = {}
            if cfg["soft"] is not None:
                kw["mpc_soft_state_constraint"] = cfg["soft"]
            elif cfg["state_constraint"]:
                kw["mpc_state_constraint"] = True
            c = proceed_controller(plant, "model_predictive_control", cfg["horizon"], 5.0,
                                   [0.65] * 4, [1.2] * 2, device=dev,
                                   sqp_config=SqpConfig(shooting=shooting, max_sqp_iter=80), **kw)
            t0 = time.perf_counter()
            _, sol = runtime.step(c, torch.tensor(cfg.get("x0", meta["x0"]), device=dev))
            key = f"{cfg['key']}__{shooting}"
            du = float(np.abs(sol.u.cpu().numpy().T - golden[key + "__u"]).max())
            dx = float(np.abs(sol.x.cpu().numpy().T - golden[key + "__x"]).max())
            log(phase="nl_golden", config=key, status=int(sol.status),
                iterations=int(sol.iterations), max_abs_u_diff=du, max_abs_x_diff=dx,
                objective=float(sol.objective), golden_objective=cfg["objective"][shooting],
                seconds=time.perf_counter() - t0)
            if int(sol.status) != 0 or du > NL_U_OK or dx > NL_U_OK:
                raise RuntimeError(f"{key}: off the frozen golden on the card")
    w = meta["wide"]
    c = proceed_controller(big.random_stable_system(w["nx"], w["nu"], seed=w["seed"]),
                           "model_predictive_control", w["horizon"], 1.0, np.zeros(w["nx"]),
                           np.zeros(w["nu"]), mpc_state_constraint=True, device=dev)
    _, sol = runtime.step(c, torch.tensor(w["x0"], dtype=torch.float32, device=dev))
    du = float(np.abs(sol.u.cpu().numpy().T - golden["wide__u"]).max())
    dx = float(np.abs(sol.x.cpu().numpy().T - golden["wide__x"]).max())
    log(phase="nl_golden", config="wide nx16 nu8 h10", status=int(sol.status),
        iterations=int(sol.iterations), max_abs_u_diff=du, max_abs_x_diff=dx)
    if int(sol.status) != 0 or du > WIDE_OK or dx > WIDE_OK:
        raise RuntimeError("the wide plant is off its frozen oracle on the card")
    lap("nl goldens")

    xs = torch.from_numpy(sqp_x0s(B_SQP_CPU))
    s_card, _, _, _ = parallel.solve_batch(single, xs.to(dev))
    s_cpu, _, _, _ = parallel.solve_batch(single.to("cpu"), xs)
    st_card, st_cpu = s_card.status.cpu(), s_cpu.status
    both = (st_card == 0) & (st_cpu == 0)
    du = float((s_card.u.cpu() - s_cpu.u).abs()[both].max()) if bool(both.any()) else float("inf")
    same = float((st_card == st_cpu).float().mean())
    log(phase="card_vs_cpu", engine="sqp single shooting", lanes=B_SQP_CPU,
        converged_card=int((st_card == 0).sum()), converged_cpu=int((st_cpu == 0).sum()),
        statuses_equal_fraction=same, max_abs_u_diff=du,
        iterations_equal_fraction=float((s_card.iterations.cpu() == s_cpu.iterations)
                                        .float().mean()))
    if same < SQP_STATUS_OK or du > NL_U_OK:
        raise RuntimeError("the SQP on the card disagrees with the CPU")
    lap("card_vs_cpu")

    c, xk, st, its, lat = single, torch.full((4,), 0.6, device=dev), [], [], []
    for _ in range(SQP_STEPS):
        t0 = time.perf_counter()
        c, sol = runtime.step(c, xk)
        st.append(int(sol.status))
        lat.append(time.perf_counter() - t0)
        its.append(int(sol.iterations))
        xk = qtp.qtp_discrete_step(xk, sol.u[:, 0])
    p50, p99 = percentiles_ms(np.asarray(lat))
    log(phase="step_loop", engine="sqp single shooting (golden fnn, h10)", B=1,
        steps=SQP_STEPS, statuses=st, iterations=its, step_p50_ms=p50, step_p99_ms=p99,
        sample_time_ms=5000.0, p99_share_of_sample_time=p99 / 5000.0,
        x_end=xk.cpu().tolist())
    if not bool(torch.isfinite(xk).all()):
        raise RuntimeError("the SQP closed loop left the plant's state non-finite")
    lap("sqp step loop")

    lin = lambda cfg: proceed_controller(
        plant, "model_predictive_control", 20, 5.0, [0.65] * 4, [1.2] * 2,
        mpc_programming_type="linear", admm_config=cfg, device=dev,
    )
    ctrl = lin(tier1)
    fb = parallel.escalation_controller(ctrl, **tier2)
    if not (ctrl.engine.op.diag_a and parallel.fused_supported(ctrl)):
        raise RuntimeError("the linearized fnn's h20 operator is expected on K1")
    k1_rec = compare_kernel(ctrl, B_MAIN, 33, bench_x0s)
    k1_rec["operator"] = "fnn linearized at the reference"
    log(phase="k1_vs_plain", **k1_rec)
    x0s = torch.from_numpy(bench_x0s(B_MAIN)).to(dev)
    wz, wy = parallel.init_warm_batch(ctrl, B_MAIN)
    admm_fused.reset_counts()
    (sol, _, _, d), lat = timed(
        lambda: parallel.solve_batch_escalated(ctrl, fb, x0s, wz, wy, bucket=BUCKET), REPS_SC)
    k1 = admm_fused.LAUNCHES["K1"]
    plain = dict(admm_fused.PLAIN_CALLS)
    check_solution(sol, B_MAIN, 20, "learned-linear-h20-B16384")
    p50, p99 = percentiles_ms(lat)
    log(phase="learned_linear", cell="learned-linear-h20-B16384", B=B_MAIN, bucket=BUCKET,
        converged_fraction=int(d.n_converged) / B_MAIN,
        mean_iterations=float(d.mean_iterations), max_iterations=int(d.max_iterations),
        batch_p50_ms=p50, batch_p99_ms=p99, solves_per_s=B_MAIN / float(np.median(lat)),
        k1_launches=k1, k1_launches_per_solve=k1 / (REPS_SC + 1), plain_calls=plain)
    if k1 <= 0 or any(plain.values()):
        raise RuntimeError("the learned-linear path did not run on K1 alone")
    lap("learned-linear")
    log(phase="learned_seconds", **seconds)
    return k1, k1_rec


def wide_x0s(B):
    """The wide row's initial states (benchmarks_extra.py): default_rng(0),
    clip(0.4 N(0, 1), -0.95, 0.95), shape (B, 32)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return np.clip(0.4 * rng.standard_normal((B, 32)), -0.95, 0.95).astype(np.float32)


def fuzzy_qtp_plant():
    """benchmarks_extra.py's Takagi-Sugeno plant: the QTP linearized at the
    levels 0.4 and 0.9, Gaussian memberships of width 0.25 around them."""
    import numpy as np

    from automationlabsmodelpredictivecontrol_jl_torch import takagi_sugeno_system
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp

    lo = qtp.linearized_discrete_system(x_op=np.full(4, 0.4))
    hi = qtp.linearized_discrete_system(x_op=np.full(4, 0.9))
    return takagi_sugeno_system(
        As=np.stack([lo.A.numpy(), hi.A.numpy()]), Bs=np.stack([lo.B.numpy(), hi.B.numpy()]),
        centers=[[0.4] * 4, [0.9] * 4], widths=[0.25, 0.25], X=qtp.x_box(), U=qtp.u_box(),
    )


def economic_cost(dev):
    """benchmarks_extra.py's economic stage cost in torch: an input-weighted
    operating cost with a soft pull toward the level reference 0.65."""
    import torch

    xr = torch.full((4,), 0.65, device=dev)
    return lambda x, u: 10.0 * (u @ u) + 50.0 * (x - xr) @ (x - xr)


def controllers_phase(dev):
    """The wide Riccati plant and the fuzzy, economic and MILP controllers
    on the card, each cell counted from zero:

    - riccati-wide-nx32-h30-B2048: ``big.random_stable_system(32, 16,
      seed=0)`` at h30 with ``engine="riccati"`` (Q 10, R 0.1; the wide row
      of benchmarks_extra.py), K3's (32, 16) register tier: K3 against its
      plain version at B = 2048, 256 and 1 (max_ulps 0), on every route of
      the tier (the fp64 factors only fit up to h15: an h10 operator of the
      same plant), the rollout and the certificate likewise; K3W's
      sequential form against its plain version and against K3 at B =
      2048, 256 and 1 (max_ulps 0 both); the wide rollout and certificate
      likewise (max_ulps 0); then ``solve_batch_auto`` over 2048 states on
      the chunk ``riccati_fused.chunk_kernel`` picks (K3W) and the
      recurrences ``riccati_fused.recurrence_kernel`` picks, those kernels
      launched and the others not, no plain version, converged >= 0.999;
    - fuzzy-ts-h10-B256: the Takagi-Sugeno QTP (benchmarks_extra.py lines
      77-92), ``mpc_programming_type="fuzzy_linear"``, the SQP over 256
      states through ``parallel.solve_batch``, and ``step`` at B = 1;
    - economic-h10-B256: the QTP's linearization with the extra
      benchmarks' economic stage cost, EmpcConfig(max_sqp_iter=15), 256
      states, ``step`` at B = 1, and 64 lanes on the card against the CPU;
    - milp-relu-fleet-h5-B32: a relu fnn (hidden 4) trained on the card by
      ``benchmarks/training.py`` (benchmarks_suite.py config 7), the exact
      MILP engine at h5 over 32 states: host threads by design, converged
      1.0.
    The fuzzy, economic and MILP paths run no kernel and no plain version.
    Returns K3's records at the tier, K3W's, K3's recurrences' records, the
    launches of K3, K3W and both pairs of recurrences on the wide cell, and
    the wide recurrences' records at the tier."""
    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch import (
        EmpcConfig, RiccatiEngine, parallel, proceed_controller, runtime,
    )
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big, qtp, training
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused, riccati_fused
    from automationlabsmodelpredictivecontrol_jl_torch.solvers import milp

    seconds, t_part = {}, time.perf_counter()

    def lap(part):
        nonlocal t_part
        now = time.perf_counter()
        seconds[part] = now - t_part
        t_part = now

    # riccati-wide-nx32-h30-B2048
    wide = proceed_controller(
        big.random_stable_system(32, 16, seed=0), "model_predictive_control", 30, 1.0,
        np.zeros(32, np.float32), np.zeros(16, np.float32), mpc_Q=10.0, mpc_R=0.1,
        engine="riccati", device=dev,
    )
    if not (isinstance(wide.engine, RiccatiEngine) and parallel.fused_supported(wide)
            and riccati_fused.k3_fits(wide.engine.op)):
        raise RuntimeError("the wide Riccati controller is expected in K3's (32, 16) tier")
    chunk = int(wide.engine.config.check_interval)
    shapes = [compare_k3(wide, "(32, 16) plant, h30", B, 50 + i, wide_x0s, plain_reps=1)
              for i, B in enumerate((B_WIDE, 256, 1))]
    shapes[0]["chain_floor_ms"] = chain_floor_ms(30, 32, 16, chunk, dev)
    ridx = shapes[0]["rho_index"]
    for i, (branch, op, route) in enumerate((
        ("(32, 16) plant, h30, fp32 factors in shared memory", wide.engine.op, "shared-fp32"),
        ("(32, 16) plant, h30, rows streamed", wide.engine.op, "stream"),
        ("(32, 16) plant, h10", operator_like(wide.engine.op, 10, False), None),
    )):
        e0T = torch.from_numpy(wide_x0s(256).T.copy()).to(dev)
        args = operator_inputs(op, ridx, e0T, 60 + i) + (chunk,)
        shapes.append(compare_k3_args(args, branch, plain_reps=1, route=route))
    tier_routes = {rec["route"] for rec in shapes}
    if tier_routes != set(riccati_fused.K3_ROUTES):
        raise RuntimeError(f"K3's (32, 16) tier not held on every route: {tier_routes}")
    recurrences = [compare_recurrences(wide, B, 70 + i, wide_x0s)
                   for i, B in enumerate((B_WIDE, 256, 1))]
    rollout_recs = [r for r, _ in recurrences]
    cert_recs = [c for _, c in recurrences]
    for rec in shapes:
        log(phase="k3_vs_plain", **rec)
    for rec in rollout_recs + cert_recs:
        if rec["max_ulps"] != 0:
            raise RuntimeError(f"the (32, 16) {rec['kernel']} differs from its plain version: {rec}")
        log(phase="k3_driver_vs_plain", **rec)
    # K3W's sequential form at the tier, against its plain version and K3
    k3w_recs = [compare_k3w(wide.engine.op, B, 75 + i, chunk, False,
                            f"(32, 16) h30, K3's widest tier, B={B}", k3=True)
                for i, B in enumerate((B_WIDE, 256, 1))]
    # the wide rollout and certificate at the tier
    wide_rec = [rec for i, B in enumerate((B_WIDE, 256, 1))
                for rec in compare_wide_recurrences(wide.engine.op, B, 95 + i, "(32, 16) h30")]
    lap("wide kernels")

    # the cell runs its chunk and its recurrences on the kernels the routing
    # tables pick
    picked = riccati_fused.chunk_kernel(wide.engine.op)
    other = "K3" if picked == "K3W" else "K3W"
    rec_keys = (("rollout", "certificate") if riccati_fused.recurrence_kernel(wide.engine.op)
                == "K3" else ("rollout-wide", "certificate-wide"))
    rec_other = ("rollout-wide", "certificate-wide") if rec_keys[0] == "rollout" else (
        "rollout", "certificate")
    head = k3w_recs[0] if picked == "K3W" else shapes[0]
    x_w = torch.from_numpy(wide_x0s(B_WIDE)).to(dev)
    admm_fused.reset_counts()
    fn = lambda: parallel.solve_batch_auto(wide, x_w)
    (sol, _, _, d), lat = timed(fn, REPS_WIDE)
    counts = {k: admm_fused.LAUNCHES[k] for k in ("K3", "K3W", "rollout", "certificate",
                                                   "rollout-wide", "certificate-wide")}
    plain = dict(admm_fused.PLAIN_CALLS)
    check_solution(sol, B_WIDE, 30, "riccati-wide-nx32-h30-B2048", nx=32, nu=16)
    p50, p99 = percentiles_ms(lat)
    rec = dict(cell="riccati-wide-nx32-h30-B2048", B=B_WIDE, chunk_kernel=picked,
               recurrence_kernels=rec_keys,
               route=head["route"], converged_fraction=int(d.n_converged) / B_WIDE,
               mean_iterations=float(d.mean_iterations), max_iterations=int(d.max_iterations),
               batch_p50_ms=p50, batch_p99_ms=p99, solves_per_s=B_WIDE / float(np.median(lat)),
               launches=counts, chunk_launches_per_solve=counts[picked] / (REPS_WIDE + 1),
               chunk_ms=head["ms"], k3_ms_per_chunk=shapes[0]["ms"],
               k3w_ms_per_chunk=k3w_recs[0]["ms"], bound_ms=head["bound_ms"],
               chain_floor_ms=shapes[0]["chain_floor_ms"], plain_calls=plain)
    rec.update(profile(fn, 2))
    log(phase="riccati_wide", **rec)
    if (min(counts[k] for k in (picked, *rec_keys)) <= 0 or counts[other]
            or any(counts[k] for k in rec_other) or any(plain.values())):
        raise RuntimeError(f"the wide Riccati path did not run on its kernels alone: {rec}")
    if rec["converged_fraction"] < CONV_OK:
        raise RuntimeError(f"the wide Riccati cell converged too little: {rec}")
    lap("wide cell")

    x_ref, u_ref = [0.65] * 4, [1.2] * 2
    x0s = torch.from_numpy(suite6_x0s(B_CTRL)).to(dev)
    cells = {
        "fuzzy-ts-h10-B256": proceed_controller(
            fuzzy_qtp_plant(), "model_predictive_control", 10, 5.0, x_ref, u_ref,
            mpc_programming_type="fuzzy_linear", device=dev),
        "economic-h10-B256": proceed_controller(
            qtp.linearized_discrete_system(), "economic_model_predictive_control", 10, 5.0,
            x_ref, u_ref, mpc_cost_function=economic_cost(dev),
            empc_config=EmpcConfig(max_sqp_iter=15), device=dev),
    }
    for cell, c in cells.items():
        admm_fused.reset_counts()
        fn = lambda c=c: parallel.solve_batch(c, x0s)
        (sol, _, _, d), lat = timed(fn, REPS_CTRL)
        check_solution(sol, B_CTRL, 10, cell)
        if any(admm_fused.LAUNCHES.values()) or any(admm_fused.PLAIN_CALLS.values()):
            raise RuntimeError(f"{cell}: a kernel or a plain version ran on a path that has none")
        p50, p99 = percentiles_ms(lat)
        rec = dict(cell=cell, B=B_CTRL, engine=type(c.engine).__name__,
                   converged_fraction=int(d.n_converged) / B_CTRL,
                   mean_sqp_iterations=float(d.mean_iterations),
                   max_sqp_iterations=int(d.max_iterations), batch_p50_ms=p50,
                   batch_p99_ms=p99, solves_per_s=B_CTRL / float(np.median(lat)))
        rec.update(admm_iterations(fn))
        t0 = time.perf_counter()
        rec.update(profile(fn, 1, cpu=False), profile_seconds=time.perf_counter() - t0)
        ck, xk, st, step_lat = c, torch.full((4,), 0.6, device=dev), [], []
        for _ in range(CTRL_STEPS):
            t0 = time.perf_counter()
            ck, s1 = runtime.step(ck, xk)
            torch.cuda.synchronize()
            step_lat.append(time.perf_counter() - t0)
            st.append(int(s1.status))
            xk = qtp.qtp_discrete_step(xk, s1.u[:, 0])
        sp50, sp99 = percentiles_ms(np.asarray(step_lat))
        rec.update(step_statuses=st, step_p50_ms=sp50, step_p99_ms=sp99,
                   p99_share_of_sample_time=sp99 / 5000.0, x_end=xk.cpu().tolist())
        log(phase="controllers", **rec)
        if rec["converged_fraction"] < CTRL_CONV_OK or not bool(torch.isfinite(xk).all()):
            raise RuntimeError(f"{cell}: converged too little: {rec}")
        lap(cell)

    # the economic engine on the card against the CPU (its cost's
    # constants on each device)
    xs = torch.from_numpy(suite6_x0s(B_CTRL_CPU))
    c_cpu = proceed_controller(
        qtp.linearized_discrete_system(), "economic_model_predictive_control", 10, 5.0, x_ref,
        u_ref, mpc_cost_function=economic_cost("cpu"), empc_config=EmpcConfig(max_sqp_iter=15),
        device="cpu")
    s_card, _, _, _ = parallel.solve_batch(cells["economic-h10-B256"], xs.to(dev))
    s_cpu, _, _, _ = parallel.solve_batch(c_cpu, xs)
    st_card, st_cpu = s_card.status.cpu(), s_cpu.status
    both = (st_card == 0) & (st_cpu == 0)
    du = float((s_card.u.cpu() - s_cpu.u).abs()[both].max()) if bool(both.any()) else float("inf")
    same = float((st_card == st_cpu).float().mean())
    log(phase="card_vs_cpu", engine="economic", lanes=B_CTRL_CPU,
        converged_card=int((st_card == 0).sum()), converged_cpu=int((st_cpu == 0).sum()),
        statuses_equal_fraction=same, max_abs_u_diff=du,
        iterations_equal_fraction=float((s_card.iterations.cpu() == s_cpu.iterations)
                                        .float().mean()))
    if same < SQP_STATUS_OK or du > NL_U_OK:
        raise RuntimeError("the economic engine on the card disagrees with the CPU")
    lap("economic card_vs_cpu")

    # milp-relu-fleet-h5-B32
    t0 = time.perf_counter()
    data = training.generate_qtp_dataset(n_traj=48, n_steps=30, seed=0, device=dev)
    relu, rmse = training.trained_system("fnn", data, hidden=4, activation="relu")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    c_m = proceed_controller(relu, "model_predictive_control", 5, 5.0, x_ref, u_ref,
                             mpc_programming_type="mixed_linear", device=dev)
    if not isinstance(c_m.engine, milp.MilpEngine):
        raise RuntimeError("the relu fnn's mixed_linear controller is expected on the MILP engine")
    x_m = torch.from_numpy(sqp_x0s(B_MILP)).to(dev)
    admm_fused.reset_counts()
    (sol, _, _, d), lat = timed(lambda: parallel.solve_batch(c_m, x_m), REPS_MILP)
    check_solution(sol, B_MILP, 5, "milp-relu-fleet-h5-B32")
    if any(admm_fused.LAUNCHES.values()) or any(admm_fused.PLAIN_CALLS.values()):
        raise RuntimeError("the MILP fleet ran a kernel or a plain version")
    p50, p99 = percentiles_ms(lat)
    cpus = os.cpu_count() or 1
    rec = dict(cell="milp-relu-fleet-h5-B32", B=B_MILP, model_rmse=rmse, train_seconds=t_train,
               converged_fraction=int(d.n_converged) / B_MILP,
               mean_nodes_per_solve=float(d.mean_iterations), max_nodes=int(d.max_iterations),
               n_binary=c_m.engine.n_binary, batch_p50_ms=p50, batch_p99_ms=p99,
               solves_per_s=B_MILP / float(np.median(lat)), host_cpu_count=cpus,
               threads=min(B_MILP, cpus), solution_device=str(sol.u.device))
    log(phase="milp_fleet", **rec)
    if rec["converged_fraction"] != 1.0:
        raise RuntimeError(f"the MILP fleet left a lane unsolved: {rec}")
    lap("milp fleet")
    log(phase="controllers_seconds", **seconds)
    return shapes, k3w_recs, rollout_recs, cert_recs, counts, wide_rec


TPU_RICCATI_XLA = "automationlabsmodelpredictivecontrol_jl_tpu/ops/riccati.py"


def wide64_x0s(B):
    """riccati-wide-nx64-h30's initial states: default_rng(0),
    clip(0.4 N(0, 1), -0.95, 0.95), shape (B, 64)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return np.clip(0.4 * rng.standard_normal((B, 64)), -0.95, 0.95).astype(np.float32)


def k3w_dbl_models(op, plan, B, chunk):
    """Model numbers of one K3W-doubling chunk as ``plan`` lays it out, for
    its phase's log line (not the kernels line): the operator bytes its
    blocks copy from L2 (each block every stream of every iteration once);
    the fp32 -> fp64 conversions (each operator entry once per lane group
    of a block, each lane entry once per 4-row group of its product) at 16
    a clock on every SM and the fp64 multiply-adds (roofline.k3w_bound's) at
    the SM's fp64 FMA rate (card_peaks), at the card's highest SM clock;
    the dependent phases of an iteration, 2 (L + 1) + 6, and the block's
    barriers (one a panel, one before each phase without an operator)."""
    N, nx, nu = op.N, op.nx, op.nu
    lv = max(N - 1, 0).bit_length()  # the combine levels a sweep runs
    steps = sum(N - 2 ** l for l in range(lv)) + N  # a sweep's level and prefix steps
    lanes, lg = plan.lanes, plan.lanes // plan.lanes_per_thread
    rg = lambda rows: -(-rows // 4)
    streams = [(N, nu * nx)] + [(N - 2 ** l, nx * nx) for l in range(lv)] + [(N, nx * nx)]
    streams += [(N, nu * nu)] + streams[1:lv + 2] + [(N, nu * nx)]
    op_floats = sum(n * m for n, m in streams)
    conv = lg * (op_floats + 2 * N * nx * nu) + lanes * (
        2 * steps * nx * rg(nx) + N * nu * rg(nx) + N * nx * rg(nu) + N * nu * rg(nu)
        + N * nu * rg(nx) + N * nx * rg(nu))
    clock = sm_clocks_per_s()
    macs = 3 * N * nu * nx + N * nu * nu + N * nx * nu + 2 * steps * nx * nx
    steps = lambda n, m: plan.panel // (m | 1) if plan.ring else n  # a panel's
    barriers = sum(-(-n // steps(n, m)) for n, m in streams)
    barriers += (1 if nu > 4 else 0) + 1 + (1 if op.split_terminal or op.terminal_ball else 0)
    return dict(l2_operator_bytes=4 * op_floats * plan.blocks * chunk,
                conversions=conv * plan.blocks * chunk,
                conversion_floor_ms=conv * plan.blocks * chunk / 16 / clock * 1e3,
                fma_floor_ms=macs * B * chunk / card_peaks()["fp64_fma_per_clock_sm"] / clock * 1e3,
                depth_phases_per_iteration=2 * (lv + 1) + 6,
                barriers_per_iteration=barriers)


def compare_k3w(op, B, seed, chunk, doubling, label, plain_reps=1, route=None, k3=False,
                layouts=()):
    """K3W (sequential or doubling) against its plain version on one
    chunk's seeded inputs at a real shape, on the card: max_ulps 0, a
    k3w_plan line, CUDA-event time over 20 launches beside its bound; with
    ``k3``, K3 on the same inputs too (the sequential form's outputs equal
    K3's bit for bit; the doubling form's time beside K3's). ``layouts``:
    keyword sets that force other doubling layouts on the same inputs, each
    held to the plain version too (max_ulps 0, not timed). The doubling
    form's log line carries its model numbers (k3w_dbl_models)."""
    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati, riccati_fused
    from automationlabsmodelpredictivecontrol_jl_torch.utils import roofline

    dev = op.rho_tab.device
    e0T = torch.from_numpy(
        (0.1 * np.random.default_rng(seed).standard_normal((op.nx, B))).astype(np.float32)).to(dev)
    ridx = riccati._initial_ridx(op, riccati.RiccatiConfig())
    args = operator_inputs(op, ridx, e0T, seed + 1) + (chunk,)
    name = "K3W-doubling" if doubling else "K3W"
    plan = riccati_fused.k3w_plan(op, B, doubling, route)
    log(phase="k3w_plan", kernel=name, cell=label, N=op.N, nx=op.nx, nu=op.nu, B=B,
        **plan._asdict())
    kernel = lambda: riccati_fused._launch_k3w(*args, doubling=doubling, route=route)
    plain_fn = (riccati_fused.iterate_chunk_riccati_doubling_plain if doubling
                else riccati_fused.iterate_chunk_riccati_plain)
    out_p, plain_once_ms = cuda_ms_once(lambda: plain_fn(*args))
    out_k = kernel()
    abs_err, rel_err, ulps = _errors(out_k, out_p, name)
    rec = dict(kernel=name, cell=label, N=op.N, nx=op.nx, nu=op.nu, B=B, chunk=chunk,
               route=plan.route, lanes=plan.lanes, smem_bytes=plan.smem_bytes,
               layout=plan._asdict(), split_interior=op.split_interior,
               terminal_ball=op.terminal_ball, max_abs_err=abs_err, max_rel_err=rel_err,
               max_ulps=ulps)
    if ulps != 0:
        raise RuntimeError(f"{name} disagrees with its plain version: {rec}")
    held = []
    for force in layouts:  # the other layouts the plan can take here
        try:
            other = riccati_fused.k3w_plan(op, B, True, **force)
        except ValueError:
            continue
        _, _, other_ulps = _errors(riccati_fused._launch_k3w(*args, doubling=True, plan=other),
                                   out_p, name)
        held.append(dict(other._asdict(), max_ulps=other_ulps))
        if other_ulps != 0:
            raise RuntimeError(f"{name} on {other} disagrees with its plain version: {rec}")
    if held:
        rec["layouts_held"] = held
    if k3:  # K3 on the same inputs
        launch_k3 = lambda: riccati_fused._launch_k3(*args)
        if not doubling:  # the same bits
            _, _, k3_ulps = _errors(launch_k3(), out_k, "K3 against K3W")
            rec["k3_max_ulps"] = k3_ulps
            if k3_ulps != 0:
                raise RuntimeError(f"K3 and K3W differ on the same inputs: {rec}")
        rec["k3_ms"] = cuda_ms(launch_k3, reps=3 if not doubling else 20)
    rec["ms"] = cuda_ms(kernel)
    rec["plain_ms"] = (plain_once_ms if plain_reps == 1 else
                       cuda_ms(lambda: plain_fn(*args), reps=plain_reps, warm_up=False))
    rec["bound_ms"], rec["bound_by"] = roofline.k3w_bound(
        op.N, op.nx, op.nu, B, chunk, op.split_interior, doubling, int(op.bwd_levels.shape[1]))
    models = k3w_dbl_models(op, plan, B, chunk) if doubling else {}
    if models:
        models["ms_per_barrier"] = rec["ms"] / (chunk * models["barriers_per_iteration"])
    log(phase="k3w_vs_plain", **rec, **models)
    return rec


@functools.lru_cache(maxsize=None)
def dfma_chain_ns():
    """Nanoseconds of one dependent fp64 multiply-add on the card, at its
    highest SM clock: scripts/fp64_rate_probe.py's chain case (one warp,
    clock64 around 2^20 of them), measured once a run."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "fp64_rate_probe", os.path.join(HERE, "scripts", "fp64_rate_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    rec = probe.chain_latency()
    log(phase="dfma_chain", **rec)
    return rec["ns"]


def compare_wide_recurrences(op, B, seed, label):
    """The wide rollout and certificate kernels against their plain
    versions at one shape (the certificate on a chunk's worth of dual
    change), max_ulps 0, a wide_recurrence_plan line each; device times from
    CUDA graphs replayed for 0.3 s first (``ms``, with the SM clock just
    after, ``sm_mhz``; ``wrapper_ms`` through the wrapper) beside their
    bounds and chain floor."""
    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati, riccati_fused
    from automationlabsmodelpredictivecontrol_jl_torch.utils import roofline

    dev = op.rho_tab.device
    e0T = torch.from_numpy(
        (0.1 * np.random.default_rng(seed).standard_normal((op.nx, B))).astype(np.float32)).to(dev)
    _, _, e0T, ballr, _, vU, lamX, lamU = operator_inputs(op, 0, e0T, seed + 1)
    lamX2, lamU2 = lamX + 0.01 * lamX.flip(0), lamU - 0.02 * lamU.flip(0)
    N, nx, nu = op.N, op.nx, op.nu
    Xbar = riccati.rollout_warm(op, e0T, vU)
    recs = []
    for name, kernel, plain, args, bound in (
        ("rollout-wide", riccati_fused.rollout_wide, riccati_fused._rollout_wide_plain,
         (op, e0T, vU), roofline.rollout_bound(N, nx, nu, B)),
        ("certificate-wide", riccati_fused.certificate_terms_wide,
         riccati_fused._certificate_wide_plain, (op, lamX2, lamX, lamU2, lamU, Xbar, ballr),
         roofline.certificate_bound(N, nx, nu, B)),
    ):
        plan = riccati_fused.wide_recurrence_plan(op, B, name.split("-")[0])
        log(phase="wide_rec_plan", cell=label, N=N, nx=nx, nu=nu, B=B, **plan._asdict())
        abs_err, rel_err, ulps = _errors([kernel(*args)], [plain(*args)], name)
        rec = dict(kernel=name, cell=label, N=N, nx=nx, nu=nu, B=B, plan=plan._asdict(),
                   max_abs_err=abs_err, max_rel_err=rel_err, max_ulps=ulps)
        if ulps != 0:
            raise RuntimeError(f"the {name} kernel disagrees with its plain version: {rec}")
        rec["ms"] = cuda_graph_ms(lambda: kernel(*args), repeats=10, warm_s=0.3)
        rec["sm_mhz"] = sm_clock_now_mhz()
        rec["wrapper_ms"] = cuda_ms(lambda: kernel(*args))
        rec["plain_ms"] = cuda_ms(lambda: plain(*args), reps=2, warm_up=False)
        rec["bound_ms"], rec["bound_by"] = bound
        rec["chain_floor_ms"] = roofline.wide_chain_floor_ms(N, nx, dfma_chain_ns())
        log(phase="wide_recurrence_vs_plain", **rec)
        recs.append(rec)
    return recs


def riccati_sweeps_phase(dev):
    """K3W, the width-general Riccati chunk, in its two forms (plants past
    K3's (32, 16), and ``parallel_sweeps``), with the wide rollout and
    certificate, on the card; each path counted from zero:

    - each kernel against its plain version, max_ulps 0, a k3w_plan line a
      shape: K3W sequential at (64, 32) h30 (B = 1024 and 1, with the chain
      floor of the (64, 32) cell's chunk), (40, 20) h10 with the state box
      on each of its routes (the lanes' state in shared memory, in device
      memory, and with the step's vectors in device memory too; (32, 16)
      h30 is the controllers' phase's); K3W-doubling at the QTP's h500 (B = 1024 and
      1), h50 with the state box and with the contractive ball, and h24;
      the wide rollout and certificate at (64, 32) h30 (B = 1024 and 1)
      and (40, 20) h10 with the state box (B = 77), each with its chain
      floor;
    - riccati-wide-nx64-h30-B1024: ``big.random_stable_system(64, 32,
      seed=0)`` at h30, ``engine="riccati"``, Q 10, R 0.1 (the extra
      benchmarks' wide row at twice its width), 1024 states through
      ``solve_batch_auto`` (the fused driver on K3W) and
      ``parallel.solve_batch`` (the per-lane engine), then 10 ``step``s at
      B = 1; converged >= 0.999 on both, the first 64 lanes held to the
      port's CPU solve (statuses equal, |du| <= 1e-3), no K3 launch and no
      plain call;
    - riccati-h500-B1024-doubling: suite config 6 (the QTP at h500,
      ``RiccatiConfig(max_iter=1000)``) through ``parallel.solve_batch``
      with ``parallel_sweeps`` True against False (K3) on the same 1024
      states: converged >= 0.999 on both, statuses equal on >= 0.999 of
      lanes, |du| <= 5e-4 where both converged, K3W-doubling launched and
      K3 not on the doubling side;
    - riccati-h500-step-doubling: 20 closed-loop ``step``s at B = 1 on the
      QTP plant, ``parallel_sweeps`` True against False, p50/p99 against
      the 5 s sample time.
    Returns the records of each kernel's shapes and the launches of each
    on the phase's paths."""
    import dataclasses

    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch import parallel, proceed_controller, runtime
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big, qtp
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused, riccati_fused
    from automationlabsmodelpredictivecontrol_jl_torch.ops.riccati import RiccatiConfig

    seconds, t_part = {}, time.perf_counter()

    def lap(part):
        nonlocal t_part
        now = time.perf_counter()
        seconds[part] = now - t_part
        t_part = now

    wide_design = lambda d: proceed_controller(
        big.random_stable_system(64, 32, seed=0), "model_predictive_control", 30, 1.0,
        np.zeros(64, np.float32), np.zeros(32, np.float32), mpc_Q=10.0, mpc_R=0.1,
        engine="riccati", device=d)
    wide = wide_design(dev)
    if riccati_fused.k3_fits(wide.engine.op) or not parallel.fused_supported(wide):
        raise RuntimeError("the (64, 32) Riccati controller is expected past K3, on K3W")
    long = lambda N, **kw: proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control", N, 5.0, [0.65] * 4,
        [1.2] * 2, riccati_config=RiccatiConfig(max_iter=1000, parallel_sweeps=True),
        device=dev, **kw)
    h500 = long(H_SWEEPS, engine="riccati")  # what engine="auto" designs at h500
    h50_state = long(50, engine="riccati", mpc_state_constraint=True).engine.op
    h50_ball = long(50, engine="riccati", mpc_terminal_ingredient="contractive").engine.op
    h24 = long(24, engine="riccati").engine.op
    wide_op = wide.engine.op
    w40 = wide_operator(40, 20, 10, dev, 21)
    lap("design")

    # each kernel against its plain version at the phase's shapes
    seq = [compare_k3w(wide_op, B_H500, 80, 25, False, "(64, 32) h30", plain_reps=1),
           compare_k3w(wide_op, 1, 81, 25, False, "(64, 32) h30, one lane"),
           compare_k3w(w40, 77, 82, 25, False, "(40, 20) h10 state box"),
           compare_k3w(w40, 77, 83, 25, False, "(40, 20) h10 state box, state in device memory",
                       route="device"),
           compare_k3w(w40, 77, 84, 25, False, "(40, 20) h10 state box, all in device memory",
                       route="global")]
    seq[0]["chain_floor_ms"] = chain_floor_ms(wide_op.N, wide_op.nx, wide_op.nu, 25, dev)
    # each doubling shape also holds the plan's other routes and rings there
    held = [dict(route="shared"), dict(route="device"), dict(route="global"), dict(ring=0),
            dict(ring=2), dict(ring=3)]
    dbl = [compare_k3w(h500.engine.op, B_H500, 84, 25, True, "QTP h500", plain_reps=2, k3=True,
                       layouts=held),
           compare_k3w(h500.engine.op, 1, 85, 25, True, "QTP h500, one lane", plain_reps=2,
                       k3=True, layouts=held),
           compare_k3w(h50_state, B_H500, 86, 25, True, "QTP h50 state box", plain_reps=2,
                       layouts=held),
           compare_k3w(h50_ball, B_H500, 87, 25, True, "QTP h50 contractive ball", plain_reps=2,
                       layouts=held),
           compare_k3w(h24, 77, 88, 25, True, "QTP h24", plain_reps=2, layouts=held),
           compare_k3w(h50_state, 77, 89, 25, True, "QTP h50 state box, device scratch",
                       plain_reps=2, route="global")]
    rec_w = [compare_wide_recurrences(wide_op, B_H500, 90, "(64, 32) h30"),
             compare_wide_recurrences(wide_op, 1, 91, "(64, 32) h30, one lane"),
             compare_wide_recurrences(w40, 77, 92, "(40, 20) h10 state box")]
    rollout_recs = [r for r, _ in rec_w]
    cert_recs = [c for _, c in rec_w]
    lap("kernels")

    # riccati-wide-nx64-h30-B1024: the fused driver, then the per-lane engine
    x_w = torch.from_numpy(wide64_x0s(B_H500)).to(dev)
    wide_counts, wide_sols = {}, {}
    for path, solve in (("solve_batch_auto", parallel.solve_batch_auto),
                        ("solve_batch", parallel.solve_batch)):
        admm_fused.reset_counts()
        fn = lambda solve=solve: solve(wide, x_w)
        (sol, _, _, d), lat = timed(fn, REPS_SWEEPS)
        counts = {k: admm_fused.LAUNCHES[k] for k in ("K3W", "rollout-wide", "certificate-wide")}
        others = {k: v for k, v in admm_fused.LAUNCHES.items() if k not in counts and v}
        plain = {k: v for k, v in admm_fused.PLAIN_CALLS.items() if v}
        check_solution(sol, B_H500, 30, "riccati-wide-nx64-h30-B1024", nx=64, nu=32)
        p50, p99 = percentiles_ms(lat)
        rec = dict(cell="riccati-wide-nx64-h30-B1024", path=path, B=B_H500,
                   converged_fraction=int(d.n_converged) / B_H500,
                   mean_iterations=float(d.mean_iterations), max_iterations=int(d.max_iterations),
                   batch_p50_ms=p50, batch_p99_ms=p99, solves_per_s=B_H500 / float(np.median(lat)),
                   launches=counts, k3w_launches_per_solve=counts["K3W"] / (REPS_SWEEPS + 1),
                   other_launches=others, plain_calls=plain)
        rec.update(profile(fn, 1))
        log(phase="riccati_sweeps", **rec)
        if min(counts.values()) <= 0 or others or plain:
            raise RuntimeError(f"the wide Riccati path did not run on K3W alone: {rec}")
        if rec["converged_fraction"] < CONV_OK:
            raise RuntimeError(f"the wide Riccati cell converged too little: {rec}")
        wide_counts[path], wide_sols[path] = counts, sol
    # 10 closed-loop steps at B = 1 on the per-lane engine
    admm_fused.reset_counts()
    plant = big.random_stable_system(64, 32, seed=0).to(dev)
    ck, xk, st, step_lat = wide, x_w[0], [], []
    for _ in range(WIDE_STEPS):
        t0 = time.perf_counter()
        ck, s1 = runtime.step(ck, xk)
        torch.cuda.synchronize()
        step_lat.append(time.perf_counter() - t0)
        st.append(int(s1.status))
        xk = plant.step(xk, s1.u[:, 0])
    step_counts = {k: admm_fused.LAUNCHES[k] for k in ("K3W", "rollout-wide", "certificate-wide")}
    sp50, sp99 = percentiles_ms(np.asarray(step_lat))
    log(phase="riccati_sweeps", cell="riccati-wide-nx64-h30-B1024", path="step", steps=WIDE_STEPS,
        statuses=st, step_p50_ms=sp50, step_p99_ms=sp99, launches=step_counts,
        k3_launches=admm_fused.LAUNCHES["K3"], plain_calls=sum(admm_fused.PLAIN_CALLS.values()),
        x_end_inf_norm=float(xk.abs().max()))
    if (min(step_counts.values()) <= 0 or admm_fused.LAUNCHES["K3"]
            or any(admm_fused.PLAIN_CALLS.values()) or any(s != 0 for s in st)):
        raise RuntimeError("the wide closed loop did not converge on K3W alone")
    lap("wide cell")
    # the card against the port's CPU solve of the first 64 lanes (the
    # JAX package on the CPU converges all 64 at this config, PERF.md)
    wide_cpu = wide_design("cpu")
    x_cpu = x_w[:B_SWEEPS_CPU].cpu()
    for path, solve in (("solve_batch_auto", parallel.solve_batch_auto),
                        ("solve_batch", parallel.solve_batch)):
        s_cpu, _, _, _ = solve(wide_cpu, x_cpu)
        s_card = wide_sols[path]
        st_card = s_card.status[:B_SWEEPS_CPU].cpu()
        du = float((s_card.u[:B_SWEEPS_CPU].cpu() - s_cpu.u).abs().max())
        rec = dict(engine=f"riccati K3W ({path})", lanes=B_SWEEPS_CPU,
                   converged_card=int((st_card == 0).sum()),
                   converged_cpu=int((s_cpu.status == 0).sum()),
                   statuses_equal=bool(torch.equal(st_card, s_cpu.status)), max_abs_u_diff=du,
                   iterations_equal_fraction=float(
                       (s_card.iterations[:B_SWEEPS_CPU].cpu() == s_cpu.iterations).float().mean()))
        log(phase="card_vs_cpu", **rec)
        if not rec["statuses_equal"] or du > NL_U_OK:
            raise RuntimeError(f"K3W on the card disagrees with the CPU: {rec}")
    lap("wide card_vs_cpu")

    # riccati-h500-B1024-doubling: the per-lane engine, doubling against K3
    x_h = torch.from_numpy(suite6_x0s(B_H500)).to(dev)
    cfg = h500.engine.config
    variants = {
        True: h500,
        False: h500.replace(engine=h500.engine.replace(
            config=dataclasses.replace(cfg, parallel_sweeps=False))),
    }
    sols, dbl_counts = {}, {}
    for ps, c in variants.items():
        admm_fused.reset_counts()
        fn = lambda c=c: parallel.solve_batch(c, x_h)
        (sol, _, _, d), lat = timed(fn, REPS_SWEEPS)
        counts = {k: v for k, v in admm_fused.LAUNCHES.items() if v}
        plain = {k: v for k, v in admm_fused.PLAIN_CALLS.items() if v}
        check_solution(sol, B_H500, H_SWEEPS, "riccati-h500-B1024-doubling")
        p50, p99 = percentiles_ms(lat)
        rec = dict(cell="riccati-h500-B1024-doubling", parallel_sweeps=ps, B=B_H500,
                   converged_fraction=int(d.n_converged) / B_H500,
                   mean_iterations=float(d.mean_iterations), max_iterations=int(d.max_iterations),
                   batch_p50_ms=p50, batch_p99_ms=p99, solves_per_s=B_H500 / float(np.median(lat)),
                   launches=counts, plain_calls=plain,
                   chunk_launches_per_solve=counts.get("K3W-doubling" if ps else "K3", 0)
                   / (REPS_SWEEPS + 1))
        rec.update(profile(fn, 1))
        log(phase="riccati_sweeps", **rec)
        chunk_key, other_key = ("K3W-doubling", "K3") if ps else ("K3", "K3W-doubling")
        if counts.get(chunk_key, 0) <= 0 or counts.get(other_key, 0) or plain:
            raise RuntimeError(f"the h500 per-lane path ran the wrong chunk: {rec}")
        if rec["converged_fraction"] < CONV_OK:
            raise RuntimeError(f"h500 convergence too low: {rec}")
        sols[ps], dbl_counts[ps] = sol, counts
    same = float((sols[True].status == sols[False].status).float().mean())
    both = (sols[True].status == 0) & (sols[False].status == 0)
    du = float((sols[True].u - sols[False].u).abs()[both].max())
    log(phase="riccati_sweeps", cell="riccati-h500-B1024-doubling", statuses_equal_fraction=same,
        max_abs_u_diff_where_both_converged=du,
        iterations_equal_fraction=float((sols[True].iterations == sols[False].iterations)
                                        .float().mean()))
    if same < CONV_OK or du > U_OK:
        raise RuntimeError(f"doubling and sequential sweeps disagree at h500: {same}, {du}")
    lap("h500 doubling cell")

    # riccati-h500-step-doubling: 20 steps at B = 1, doubling against K3
    for ps, c in variants.items():
        admm_fused.reset_counts()
        ck, xk, st, step_lat = c, torch.full((4,), 0.6, device=dev), [], []
        for _ in range(H500_STEPS):
            t0 = time.perf_counter()
            ck, s1 = runtime.step(ck, xk)
            torch.cuda.synchronize()
            step_lat.append(time.perf_counter() - t0)
            st.append(int(s1.status))
            xk = qtp.qtp_discrete_step(xk, s1.u[:, 0])
        sp50, sp99 = percentiles_ms(np.asarray(step_lat))
        counts = {k: v for k, v in admm_fused.LAUNCHES.items() if v}
        rec = dict(cell="riccati-h500-step-doubling", parallel_sweeps=ps, steps=H500_STEPS,
                   converged_steps=sum(s == 0 for s in st), step_p50_ms=sp50, step_p99_ms=sp99,
                   p99_share_of_sample_time=sp99 / 5000.0, launches=counts,
                   plain_calls=sum(admm_fused.PLAIN_CALLS.values()), x_end=xk.cpu().tolist())
        log(phase="riccati_sweeps", **rec)
        chunk_key = "K3W-doubling" if ps else "K3"
        if counts.get(chunk_key, 0) <= 0 or rec["plain_calls"] or not bool(torch.isfinite(xk).all()):
            raise RuntimeError(f"the h500 step loop did not run on its chunk: {rec}")
        if ps:
            dbl_counts["step"] = counts
    lap("h500 step cell")
    log(phase="riccati_sweeps_seconds", **seconds)
    launches = {
        "K3W": sum(c["K3W"] for c in wide_counts.values()) + step_counts["K3W"],
        "K3W-doubling": dbl_counts[True]["K3W-doubling"] + dbl_counts["step"]["K3W-doubling"],
        "rollout-wide": sum(c["rollout-wide"] for c in wide_counts.values())
        + step_counts["rollout-wide"],
        "certificate-wide": sum(c["certificate-wide"] for c in wide_counts.values())
        + step_counts["certificate-wide"],
    }
    return seq, dbl, rollout_recs, cert_recs, launches


def _shard_record(sol, wz, wy, diag):
    """A shard's solution, warm pair and diagnostics on the host."""
    return dict(u=sol.u.cpu(), status=sol.status.cpu(), iterations=sol.iterations.cpu(),
                wz=wz.cpu(), wy=wy.cpu(),
                diag={k: getattr(diag, k).cpu() for k in diag.__dataclass_fields__})


def _equal_shards(got, want, what):
    """Raise unless two shard records are equal bit for bit."""
    import torch

    for key in ("u", "status", "iterations", "wz", "wy"):
        if not torch.equal(got[key], want[key]):
            raise RuntimeError(f"{what}: {key} differs")
    for key, v in want["diag"].items():
        w = got["diag"][key]
        if v.dtype != w.dtype or not torch.equal(v, w):
            raise RuntimeError(f"{what}: diagnostics {key} differ ({w} against {v})")


def sharded_rank(rank, world, store, out_dir):
    """One of the gloo ranks that share the card (spawned by
    ``sharded_phase``): design the headline's tier-1 controller on cuda:0,
    solve the headline's states through ``parallel.solve_sharded`` over a
    mesh of every rank, and save this rank's shard, its diagnostics and its
    launch counts to ``<out_dir>/rank<r>.pt``."""
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    from automationlabsmodelpredictivecontrol_jl_torch import parallel, proceed_controller
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
    from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig

    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        ctrl = proceed_controller(
            qtp.linearized_discrete_system(), "model_predictive_control", 20, 5.0,
            [0.65] * 4, [1.2] * 2, admm_config=AdmmConfig(**TIER1), device=dev)
        x0s = torch.from_numpy(bench_x0s(B_MAIN)).to(dev)
        admm_fused.reset_counts()
        rec = _shard_record(*parallel.solve_sharded(ctrl, x0s, parallel.make_mesh()))
        rec.update(launches=dict(admm_fused.LAUNCHES), plain_calls=dict(admm_fused.PLAIN_CALLS))
        torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def sharded_phase(dev, ctrl, fb, x0s, ctrl_h500, x_h500, esc_p50_s):
    """The scenario-sharded solve (``parallel.make_mesh``,
    ``parallel.solve_sharded``) on the card, counted from zero:

    - one rank over NCCL (a file store in a temporary directory): the
      headline's tier-1 cell (h20, B = 16384, K1, the default route) and
      riccati-h500-B1024 at ``fused=True`` (K3), each equal bit for bit to
      ``solve_batch_auto`` / ``solve_batch_fused`` on the same inputs (u,
      status, iterations, the warm pair, and the diagnostics, all-reduced on
      the card, to the batch's), with ``utils.profiling.benchmark`` of both
      side by side (a record, not a claim);
    - RANKS_SHARED gloo ranks, spawned processes sharing cuda:0, on the
      headline's tier-1 cell (8192 lanes a rank): each rank's shard equal
      bit for bit to ``solve_batch_fused`` on its rows in this process, the
      diagnostics the same on every rank and equal to the shards' combined;
    - the roofline of the escalated headline solve at its measured p50
      (``utils.roofline.speed_of_light_tiered``; tier 1 at the K1 launches
      of a tier-1 solve, tier 2's 512-lane bucket at the rest).

    Returns the phase's launches by count key (this process and the ranks')."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from automationlabsmodelpredictivecontrol_jl_torch import parallel
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
    from automationlabsmodelpredictivecontrol_jl_torch.parallel import scenarios
    from automationlabsmodelpredictivecontrol_jl_torch.utils import profiling, roofline

    t0 = time.perf_counter()
    admm_fused.reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            mesh = parallel.make_mesh()
            if (mesh.n, mesh.rank) != (1, 0) or dist.get_backend(mesh.group) != "nccl":
                raise RuntimeError(f"unexpected one-rank mesh: {mesh}")
            for cell, c, x, fused, batch in (
                ("h20-tier1-B16384", ctrl, x0s, None, parallel.solve_batch_auto),
                ("riccati-h500-B1024", ctrl_h500, x_h500, True, parallel.solve_batch_fused),
            ):
                sharded = lambda c=c, x=x, fused=fused: parallel.solve_sharded(c, x, mesh,
                                                                               fused=fused)
                got = _shard_record(*sharded())
                want = _shard_record(*batch(c, x))
                _equal_shards(got, want, f"one NCCL rank at {cell}")
                stats = profiling.benchmark(sharded, warmup=1, reps=REPS_SHARDED)
                ref = profiling.benchmark(lambda c=c, x=x: batch(c, x), warmup=1,
                                          reps=REPS_SHARDED)
                log(phase="sharded", mesh="nccl x1", cell=cell, B=int(x.shape[0]),
                    bit_equal=True, n_converged=int(got["diag"]["n_converged"]),
                    sharded_p50_ms=stats["p50_ms"], sharded_p99_ms=stats["p99_ms"],
                    batch_p50_ms=ref["p50_ms"], batch_p99_ms=ref["p99_ms"],
                    batch_path=batch.__name__)
        finally:
            dist.destroy_process_group()

        # the ranks sharing the card over gloo
        t_ranks = time.perf_counter()
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=sharded_rank, args=(r, RANKS_SHARED, f"{tmp}/gloo", tmp))
                 for r in range(RANKS_SHARED)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(RANK_JOIN_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if [p.exitcode for p in procs] != [0] * RANKS_SHARED:
            raise RuntimeError(f"the gloo ranks failed: exit codes {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(RANKS_SHARED)]
    b = B_MAIN // RANKS_SHARED
    local = [parallel.solve_batch_fused(ctrl, x0s[r * b:(r + 1) * b]) for r in range(RANKS_SHARED)]
    packs = [scenarios._pack_diagnostics(d, "cpu") for *_, d in local]
    fleet = scenarios._unpack_diagnostics(torch.stack([s for s, _ in packs]).sum(0),
                                          torch.stack([m for _, m in packs]).amax(0), local[0][3])
    for r, rec in enumerate(ranks):
        want = _shard_record(*local[r][:3], fleet)
        _equal_shards(rec, want, f"gloo rank {r} of {RANKS_SHARED}")
        if any(rec["plain_calls"].values()) or rec["launches"]["K1"] <= 0:
            raise RuntimeError(f"gloo rank {r} did not run K1 alone: {rec['launches']}")
    log(phase="sharded", mesh=f"gloo x{RANKS_SHARED} on one card", cell="h20-tier1-B16384",
        lanes_per_rank=b, bit_equal=True, ranks_seconds=time.perf_counter() - t_ranks,
        n_converged=int(fleet.n_converged), mean_iterations=float(fleet.mean_iterations),
        rank_k1_launches=[rec["launches"]["K1"] for rec in ranks])

    # the escalated headline's roofline at its measured p50
    before = admm_fused.LAUNCHES["K1"]
    parallel.solve_batch_fused(ctrl, x0s)
    t1 = admm_fused.LAUNCHES["K1"] - before
    before = admm_fused.LAUNCHES["K1"]
    parallel.solve_batch_escalated(ctrl, fb, x0s, *parallel.init_warm_batch(ctrl, B_MAIN),
                                   bucket=BUCKET)
    t2 = admm_fused.LAUNCHES["K1"] - before - t1
    tiers = [(ctrl.engine.op, ctrl.engine.config, B_MAIN,
              t1 * int(ctrl.engine.config.check_interval)),
             (fb.engine.op, fb.engine.config, BUCKET, t2 * int(fb.engine.config.check_interval))]
    log(phase="roofline", cell="h20-B16384-escalated", tier_launches=[t1, t2],
        **roofline.speed_of_light_tiered(tiers, esc_p50_s, device=dev))

    counts = dict(admm_fused.LAUNCHES)
    for rec in ranks:
        for k, v in rec["launches"].items():
            counts[k] += v
    plain = dict(admm_fused.PLAIN_CALLS)
    seconds = time.perf_counter() - t0
    log(phase="counts", path="sharded", launches=counts, plain_calls=plain,
        sharded_seconds=seconds, budget_s=SHARDED_BUDGET_S)
    if min(counts[k] for k in ("K1", "K3", "rollout", "certificate")) <= 0:
        raise RuntimeError(f"the sharded phase left a kernel unlaunched: {counts}")
    if any(plain.values()):
        raise RuntimeError("the sharded phase ran a plain version")
    return counts


def general_phase(dev, plant, ctrl, ctrl_def, ctrl_h500, suite_cfg, x0s, x_h500, x_suite):
    """The general ADMM engine, the per-lane Riccati engine and the runtime
    on the card, counted from zero by the caller:

    - the verify skill's drive: ``step`` 50 times on the true plant at h20
      (input boxes, the default AdmmConfig), every step converged, latency
      at B = 1;
    - ``parallel.solve_batch`` (the general engine) at B = 1, 8 and 128,
      p50 and p99 against the QTP's 5 s sample time;
    - fused against general on the same inputs: the h20 box-only
      controller at the default config (R = 5, one refinement) at B =
      4096, the tier-1 headline config at B = 16384, and the h500 Riccati
      cell (K3's fused driver, one rho for the batch, against the per-lane
      engine);
    - the shapes no kernel takes (the contractive terminal, soft state
      rows) through ``solve_batch_auto`` on 2048 of the suite's states;
    - the per-lane Riccati engine on K3: ``step`` 5 times at h500 and B = 1,
      and ``solve_batch_escalated`` on the h500 cell's 1024 states, tier 1
      at a short budget: tier 2 restarts its stragglers on the per-lane
      engine, every one converges and its iterations continue tier 1's;
    - the general engine on the card against the same function on the CPU
      (256 lanes of the h20 state box, at least 85% of them converged on
      both): the check that catches a TF32 product. Returns the K3
      launches of each Riccati path and the last fused solve of each
      fused-against-general cell."""
    import dataclasses

    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch import parallel, proceed_controller, runtime
    from automationlabsmodelpredictivecontrol_jl_torch.types import STATUS_MAX_ITER
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
    from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig

    design = lambda cfg, **kw: proceed_controller(
        plant, "model_predictive_control", 20, 5.0, [0.65] * 4, [1.2] * 2,
        admm_config=cfg, device=dev, **kw,
    )

    def drive(c, x, steps):
        """step in a closed loop on the true plant: statuses, iterations,
        seconds per step (host clock, the status read ends each)."""
        st, its, lat = [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            c, sol = runtime.step(c, x)
            st.append(int(sol.status))
            lat.append(time.perf_counter() - t0)
            its.append(int(sol.iterations))
            x = qtp.qtp_discrete_step(x, sol.u[:, 0])
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError("the closed loop of step left the plant's state non-finite")
        return st, its, np.asarray(lat), x

    seconds, t_part = {}, time.perf_counter()

    def lap(part):
        nonlocal t_part
        now = time.perf_counter()
        seconds[part] = now - t_part
        t_part = now

    st, its, lat, x_end = drive(ctrl_def, torch.full((4,), 0.6, device=dev), VERIFY_STEPS)
    p50, p99 = percentiles_ms(lat)
    log(phase="step_loop", engine="general (condensed h20, default config)", B=1,
        steps=VERIFY_STEPS, statuses=st, iterations=its, step_p50_ms=p50, step_p99_ms=p99,
        sample_time_ms=5000.0, x_end=x_end.cpu().tolist())
    if any(s != 0 for s in st):
        raise RuntimeError(f"a step of the verify drive did not converge: {st}")

    for B in (1, 8, 128):
        x = torch.from_numpy(bench_x0s(B)).to(dev)
        (sol, _, _, d), lat = timed(lambda x=x: parallel.solve_batch(ctrl_def, x), REPS)
        check_solution(sol, B, 20, f"the general engine at B={B}")
        p50, p99 = percentiles_ms(lat)
        log(phase="latency", engine="general", B=B, batch_p50_ms=p50, batch_p99_ms=p99,
            sample_time_ms=5000.0, p99_share_of_sample_time=p99 / 5000.0,
            converged_fraction=int(d.n_converged) / B, mean_iterations=float(d.mean_iterations))

    lap("step_loop and latency")
    fused_sols = {}
    for cell, c, x, N in (("h20-default-B4096", ctrl_def, x0s[:B_CL], 20),
                          ("h20-tier1-B16384", ctrl, x0s[:B_MAIN], 20),
                          ("riccati-h500-B1024", ctrl_h500, x_h500, 500)):
        B = int(x.shape[0])
        if not parallel.fused_supported(c):
            raise RuntimeError(f"{cell}: expected a kernel to take the fused side")
        for path, fn in (("fused", parallel.solve_batch_fused), ("general", parallel.solve_batch),
                         ("general", parallel.solve_batch), ("fused", parallel.solve_batch_fused)):
            (sol, _, _, d), lat = timed(lambda c=c, x=x, fn=fn: fn(c, x), REPS_AB)
            check_solution(sol, B, N, f"{cell} {path}")
            if path == "fused":
                fused_sols[cell] = sol
            p50, p99 = percentiles_ms(lat)
            log(phase="fused_vs_general", cell=cell, path=path, B=B,
                R=len(c.engine.op.rho_grid), solves_per_s=B / float(np.median(lat)),
                batch_p50_ms=p50, batch_p99_ms=p99, mean_iterations=float(d.mean_iterations),
                converged_fraction=int(d.n_converged) / B)
    lap("fused_vs_general")

    for kind, kw in (("contractive", dict(mpc_terminal_ingredient="contractive")),
                     ("soft", dict(mpc_soft_state_constraint=1e3))):
        c = design(suite_cfg, **kw)
        if parallel.fused_supported(c):
            raise RuntimeError(f"the {kind} controller is expected to take no kernel")
        before = dict(admm_fused.LAUNCHES)
        (sol, _, _, d), lat = timed(lambda c=c: parallel.solve_batch_auto(c, x_suite), REPS_SC)
        check_solution(sol, B_SLICE, 20, f"the {kind} controller")
        if admm_fused.LAUNCHES != before:
            raise RuntimeError(f"the {kind} controller launched a kernel")
        p50, p99 = percentiles_ms(lat)
        log(phase="no_kernel", controller=kind, B=B_SLICE, m=int(c.engine.op.A_s.shape[0]),
            converged_fraction=int(d.n_converged) / B_SLICE,
            mean_iterations=float(d.mean_iterations), batch_p50_ms=p50, batch_p99_ms=p99)

    lap("no_kernel")
    k3 = {}
    before = admm_fused.LAUNCHES["K3"]
    x = torch.from_numpy(suite6_x0s(1)[0]).to(dev)
    st, its, lat, _ = drive(ctrl_h500, x, RICCATI_STEPS)
    k3["h500 step x5 (B=1)"] = admm_fused.LAUNCHES["K3"] - before
    p50, p99 = percentiles_ms(lat)
    log(phase="step_loop", engine="per-lane Riccati (h500, K3)", B=1, steps=RICCATI_STEPS,
        statuses=st, iterations=its, step_p50_ms=p50, step_p99_ms=p99,
        k3_launches=k3["h500 step x5 (B=1)"])
    if any(s != 0 for s in st):
        raise RuntimeError(f"a step of the h500 drive did not converge: {st}")

    # tier 1 at a short budget leaves stragglers (fewer than the bucket's
    # 256); tier 2 restarts them on the per-lane engine at the cell's budget
    # (a Riccati engine is its own fallback)
    short = ctrl_h500.replace(engine=ctrl_h500.engine.replace(
        config=dataclasses.replace(ctrl_h500.engine.config, max_iter=ESC_TIER1_ITERS)))
    t1, _, _, _ = parallel.solve_batch_auto(short, x_h500)
    redo = t1.status == STATUS_MAX_ITER
    stragglers = int(redo.sum())
    if not 0 < stragglers <= 256:
        raise RuntimeError(f"tier 1 of the escalated h500 solve left {stragglers} stragglers")
    wz, wy = parallel.init_warm_batch(ctrl_h500, B_H500)
    before = admm_fused.LAUNCHES["K3"]
    (sol, _, _, d), lat = timed(
        lambda: parallel.solve_batch_escalated(short, ctrl_h500, x_h500, wz, wy), REPS_SC)
    k3["h500 escalated (B=1024)"] = (admm_fused.LAUNCHES["K3"] - before) / (REPS_SC + 1)
    check_solution(sol, B_H500, 500, "the escalated h500 solve")
    p50, p99 = percentiles_ms(lat)
    kept = bool(torch.equal(sol.iterations[~redo], t1.iterations[~redo]))
    continued = bool((sol.iterations[redo] > t1.iterations[redo]).all())
    log(phase="riccati_escalated", B=B_H500, bucket=256, tier1_max_iter=ESC_TIER1_ITERS,
        stragglers=stragglers, stragglers_converged=int((sol.status[redo] == 0).sum()),
        converged_fraction=int(d.n_converged) / B_H500, mean_iterations=float(d.mean_iterations),
        max_iterations=int(d.max_iterations), batch_p50_ms=p50, batch_p99_ms=p99,
        k3_launches_per_solve=k3["h500 escalated (B=1024)"])
    if int(d.n_converged) != B_H500 or not (kept and continued):
        raise RuntimeError("tier 2 of the escalated h500 solve left a straggler unconverged, "
                           "or its iteration counts do not continue tier 1's")

    lap("riccati per-lane")
    # the h20 state box on config 6's states at eps 1e-5, where ~90% of the
    # lanes converge (at 1e-6 the fp32 residual floor leaves most of the
    # bench's lanes at the limit however long the budget), many with their
    # inputs at the box
    c = design(AdmmConfig(max_iter=1000, eps_abs=1e-5, eps_rel=1e-5), mpc_state_constraint=True)
    x = torch.from_numpy(suite6_x0s(B_RESOLVE)).to(dev)
    s_card, _, _, _ = parallel.solve_batch(c, x)
    s_cpu, _, _, _ = parallel.solve_batch(c.to("cpu"), x.cpu())
    st_card, st_cpu = s_card.status.cpu(), s_cpu.status
    both = (st_card == 0) & (st_cpu == 0)
    limit = (st_card == STATUS_MAX_ITER) | (st_cpu == STATUS_MAX_ITER)
    diff = (s_card.u.cpu() - s_cpu.u).abs().amax(dim=(1, 2))
    du = float(diff[both].max()) if bool(both.any()) else float("inf")
    same = bool(torch.equal(st_card[~limit], st_cpu[~limit]))
    log(phase="card_vs_cpu", engine="general", controller="h20 state box, eps 1e-5",
        lanes=B_RESOLVE, converged_card=int((st_card == 0).sum()),
        converged_cpu=int((st_cpu == 0).sum()), compared=int(both.sum()),
        at_iteration_limit=int(limit.sum()), max_abs_u_diff=du,
        max_abs_u_diff_at_the_limit=float(diff[limit].max()) if bool(limit.any()) else 0.0,
        iterations_equal_fraction=float((s_card.iterations.cpu() == s_cpu.iterations)
                                        .float().mean()),
        statuses_equal_off_the_limit=same)
    if du > U_OK or not same or int(both.sum()) < CARD_CPU_COMPARED * B_RESOLVE:
        raise RuntimeError("the general engine on the card disagrees with the CPU")
    lap("card_vs_cpu")
    log(phase="general_seconds", **seconds)
    return k3, fused_sols


def with_precision(ctrl, mode):
    """The controller with its AdmmConfig's kernel_precision set."""
    import dataclasses

    cfg = dataclasses.replace(ctrl.engine.config, kernel_precision=mode)
    return ctrl.replace(engine=dataclasses.replace(ctrl.engine, config=cfg))


def with_iterations(ctrl, max_iter):
    """The controller with its AdmmConfig's max_iter set."""
    import dataclasses

    cfg = dataclasses.replace(ctrl.engine.config, max_iter=max_iter)
    return ctrl.replace(engine=dataclasses.replace(ctrl.engine, config=cfg))


@contextlib.contextmanager
def first_fused_solve():
    """A context in which ``ops.admm_fused.solve_batch_fused``, the fused
    solve under parallel.solve_batch_fused and solve_batch_auto, keeps the QP
    vectors (q, l, u) and the solution (z, y, s, status) of its first call
    in the dict it yields, and returns as before: those of the solve that
    ``timed`` returns."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    inner, first = admm_fused.solve_batch_fused, {}

    def solve(op, q, l, u, *args, **kwargs):
        out = inner(op, q, l, u, *args, **kwargs)
        if not first:
            first.update(q=q, l=l, u=u, z=out[0], y=out[1], s=out[2], status=out[3])
        return out

    admm_fused.solve_batch_fused = solve
    try:
        yield first
    finally:
        admm_fused.solve_batch_fused = inner


def certificate_ratios(ctrl, solved):
    """For each lane the fused solve ``solved`` (a :func:`first_fused_solve`
    record) certifies, its primal and dual residuals recomputed in fp64
    from the returned z, y and s, over the bar the driver holds them to
    (eps_abs + eps_rel times the norms). Returns (certified lanes, the
    worst ratio of either)."""
    import torch

    qp, cfg = ctrl.engine.qp, ctrl.engine.config
    P, A = qp.P.double(), qp.A.double()
    z, y, s, q = (solved[k].double() for k in ("z", "y", "s", "q"))
    Az, Pz, Aty = z @ A.T, z @ P, y @ A
    amax = lambda t: t.abs().amax(1)
    bar_p = cfg.eps_abs + cfg.eps_rel * torch.maximum(amax(Az), amax(s))
    bar_d = cfg.eps_abs + cfg.eps_rel * torch.maximum(torch.maximum(amax(Pz), amax(Aty)),
                                                      amax(q))
    ratio = torch.maximum(amax(Az - s) / bar_p, amax(Pz + q + Aty) / bar_d)
    ok = solved["status"] == 0
    return int(ok.sum()), float(ratio[ok].max()) if bool(ok.any()) else 0.0


def precision_phase(dev, kernels, cells):
    """The kernel precisions of K1, K2, K4 and K5 on the card
    (AdmmConfig.kernel_precision: "bf16x3", "default" and the driver's
    "hybrid" schedule beside "highest").

    - Each kernel at "bf16x3" and "default" against its plain version, bit
      for bit (max_ulps 0), at the shapes of the "highest" rows of PERF.md
      section 6 and on both routes of K4 and K5: ``kernels`` maps a label
      to (controller, B, initial states); each is graph-timed beside
      "highest"'s time at the same shape in the same call, with its bound.
    - Every cell of ``cells`` (label -> (controller, initial states, solve
      function, the earlier phases' "highest" solution of the same QPs))
      solved under each precision, counted from zero: converged fraction at
      the config's eps, mean and max iterations, p50, the chunks run at each
      precision a solve, max |u - u_highest|, and the lanes certified with
      their residuals recomputed in fp64.
    Fails if a kernel differs from its plain version, if bf16x3's u lies
    more than 5e-3 from highest's on the headline cell, if a "highest"
    solve's statuses or iteration counts differ from the earlier phases'
    same solve, or if any precision certifies a lane whose recomputed
    residual exceeds twice its bar. Returns (the kernel records by
    kernel and precision, the launches by count key)."""
    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    t0 = time.perf_counter()
    records = {}
    for label, (ctrl, B, x0s_fn) in kernels.items():
        hi_args = kernel_inputs(ctrl, B, 50, x0s_fn)
        hi_fn = admm_fused.chunk_fn_for(ctrl.engine.op, config=ctrl.engine.config)
        highest_ms = cuda_graph_ms(lambda: hi_fn(*hi_args))
        for mode in ("bf16x3", "default"):
            rec = compare_kernel(with_precision(ctrl, mode), B, 50, x0s_fn, plain_reps=1)
            rec.update(shape=label, highest_ms=highest_ms)
            log(phase="precision_vs_plain", **rec)
            records.setdefault((rec["kernel"], mode), []).append(rec)
    t_kernels = time.perf_counter() - t0

    admm_fused.reset_counts()
    for cell, (ctrl, x0s, solve, ref) in cells.items():
        B = int(x0s.shape[0])
        u_hi = None
        for mode in PRECISIONS:
            c = with_precision(ctrl, mode)
            before = dict(admm_fused.LAUNCHES)
            with first_fused_solve() as solved:
                (sol, _, _, diag), lat = timed(lambda c=c: solve(c, x0s), REPS_PREC)
            check_solution(sol, B, c.engine.qp.N, f"{cell} {mode}")
            chunks = {k: (admm_fused.LAUNCHES[k] - before[k]) / (REPS_PREC + 1)
                      for k in before if admm_fused.LAUNCHES[k] > before[k]}
            if mode == "highest":
                u_hi = sol.u
                same = bool(torch.equal(sol.status, ref.status)
                            and torch.equal(sol.iterations, ref.iterations))
                if not same:
                    raise RuntimeError(f"{cell}: the highest solve differs from the earlier "
                                       "phases' same solve")
            certified, worst = certificate_ratios(c, solved)
            du = float((sol.u - u_hi).abs().max())
            rec = dict(phase="precision_solve", cell=cell, precision=mode, B=B,
                       converged_fraction=int(diag.n_converged) / B,
                       mean_iterations=float(diag.mean_iterations),
                       max_iterations=int(diag.max_iterations),
                       batch_p50_ms=float(np.percentile(lat, 50)) * 1e3,
                       chunks_per_solve=chunks, max_abs_u_diff_vs_highest=du,
                       certified=certified, worst_certified_residual_over_bar=worst)
            log(**rec)
            if worst > CERT_SLACK:
                raise RuntimeError(f"{cell} {mode} certifies a lane above its bar: {rec}")
            if cell.startswith("h20-tier1") and mode == "bf16x3" and du > U_BF16X3:
                raise RuntimeError(f"bf16x3 u lies {du} from highest on the headline: {rec}")
    counts = dict(admm_fused.LAUNCHES)
    plain = dict(admm_fused.PLAIN_CALLS)
    log(phase="counts", path="precisions", launches={k: v for k, v in counts.items() if v},
        plain_calls=plain)
    if any(plain.values()):
        raise RuntimeError("the precisions' solves ran a plain version")
    for kernel in ("K1", "K2", "K4", "K5"):
        for mode in ("bf16x3", "default"):
            if counts[f"{kernel}-{mode}"] <= 0:
                raise RuntimeError(f"the precisions' solves never launched {kernel} at {mode}")
    log(phase="precision_seconds", kernels=t_kernels, total=time.perf_counter() - t0)
    return records, counts


def wide16_x0s(B):
    """The routing audit's wide-plant states (benchmarks_routing_audit.py):
    default_rng(0), 0.5 clip(N(0, 1), -1, 1), shape (B, 16)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return (0.5 * rng.standard_normal((B, 16)).clip(-1, 1)).astype(np.float32)


def stream_phase(dev):
    """K1's and K2's stream route on the card (csrc/admm_diag_stream.cu):
    the operator widths their Pallas bodies take and their shared routes do
    not, on the routing audit's config (``AdmmConfig(max_iter=1000)``: the
    default grid of 5 with one refinement) unless named.

    - Each kernel against its plain version, bit for bit (max_ulps 0), as
      k1_plan or k2_plan lays it out on the stream route, graph-timed with
      its bound, the FMA floor (roofline.fma_floor_ms), the register tile's
      shared-memory floor (tile_floor_ms), the plan's model of its L2
      operator bytes a chunk (l2_bytes) and its lanes a thread, and plain
      time: K1 at the QTP's h50 (n = 100, B = 4096) and its tier 2 (R = 4,
      2 refinements, B = 512), h100 (n = 200, B = 4096), the (16, 8) plant
      at h30 (n = 240, B = 4096) and h264 at tier 1's grid (n = 528, the
      widest the Pallas K1 fuses; B = 2048); K2 at the h50 state box (n =
      100, m = 300, B = 2048) at each precision. The three models are logged
      with the shape and left out of the records returned, which the
      kernels line carries.
    - The cells qtp-h50-default-B4096, qtp-sc-h50-B2048 and
      wide16x8-h30-B4096 through ``parallel.solve_batch_fused`` (which
      raised ValueError on the card before the stream route) and the
      general engine (``parallel.solve_batch``) on the same states,
      counted from zero: launches per solve, statuses, converged
      fractions, |du| where both converged (U_OK), p50 of each side, and
      each cell's fused solve under torch.profiler.
    Fails if a kernel differs from its plain version, if a cell's fused
    solve launches no stream-route kernel, runs a plain version, leaves a
    lane non-finite or lies more than U_OK from the general engine where
    both converged. Returns (the kernel records by kernel, the launches by
    count key)."""
    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch import parallel, proceed_controller
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big, qtp
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
    from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig
    from automationlabsmodelpredictivecontrol_jl_torch.types import STATUS_NUMERIC_ERROR
    from automationlabsmodelpredictivecontrol_jl_torch.utils import roofline

    t0 = time.perf_counter()
    audit = AdmmConfig(max_iter=1000)
    tier1 = AdmmConfig(max_iter=75, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0)
    design = lambda N, cfg, **kw: proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control", N, 5.0, [0.65] * 4,
        [1.2] * 2, admm_config=cfg, device=dev, **kw)
    h50 = design(50, audit)
    sc50 = design(50, audit, mpc_state_constraint=True)
    wide = proceed_controller(
        big.random_stable_system(16, 8, seed=0), "model_predictive_control", 30, 5.0,
        [0.0] * 16, [0.0] * 8, admm_config=audit, device=dev)
    shapes = [
        ("K1 h50 default", h50, B_STREAM, bench_x0s),
        ("K1 h50 tier 2", parallel.escalation_controller(
            h50, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250, refine_steps=2),
         BUCKET, bench_x0s),
        ("K1 h100 default", design(100, audit), B_STREAM, bench_x0s),
        ("K1 wide16x8 h30", wide, B_STREAM, wide16_x0s),
        ("K1 h264 tier 1", design(264, tier1), B_SLICE, bench_x0s),
        *((f"K2 h50 state box {mode}", with_precision(sc50, mode), B_SLICE, bench_x0s)
          for mode in PRECISIONS[:3]),
    ]
    t_design = time.perf_counter() - t0
    records = {"K1": [], "K2": []}
    for label, c, B, x0s_fn in shapes:
        rec = compare_kernel(c, B, 60, x0s_fn, plain_reps=1)
        del rec["smem_floor_ms"]  # one entry a multiply-add: not the register tile's model
        n, m, rs, chunk = (rec[k] for k in ("n", "m", "refine_steps", "chunk"))
        plan = (admm_fused.K2Plan if m > n else admm_fused.K1Plan)(**rec["plan"])
        rows = plan.rpt_n if m > n else plan.rpt
        rec.update(shape=label, lanes_per_thread=admm_fused.k12_lanes_per_thread(plan.lanes))
        models = dict(
            fma_floor_ms=roofline.fma_floor_ms(n, m, B, rs, chunk, card_peaks(), sm_clock_hz(),
                                               rec["kernel"], rec.get("precision", "highest")),
            tile_floor_ms=tile_floor_ms(n, m, B, rs, chunk, plan),
            l2_bytes=admm_fused.k12_stream_l2_bytes(n, m - n, rec["R"], rs, B, plan.lanes,
                                                    plan.groups, rows, plan.panel, chunk),
        )
        log(phase="stream_vs_plain", **rec, **models)
        if rec["plan"]["route"] != "stream":
            raise RuntimeError(f"{label}: expected the stream route: {rec['plan']}")
        records[rec["kernel"]].append(rec)
    t_kernels = time.perf_counter() - t0 - t_design

    cells = {
        "qtp-h50-default-B4096": (h50, bench_x0s(B_STREAM), "K1", (4, 2)),
        "qtp-sc-h50-B2048": (sc50, bench_x0s(B_SLICE), "K2", (4, 2)),
        "wide16x8-h30-B4096": (wide, wide16_x0s(B_STREAM), "K1", (16, 8)),
    }
    admm_fused.reset_counts()
    solves = {}
    for cell, (c, x0s, kernel, (nx, nu)) in cells.items():
        op = c.engine.op
        m, n = (int(d) for d in op.A_s.shape)
        B, N = int(x0s.shape[0]), c.engine.qp.N
        R, rs = int(op.rho_grid.shape[0]), int(c.engine.config.refine_steps)
        plan = (admm_fused.k1_plan(n, R, rs, B) if op.diag_a
                else admm_fused.k2_plan(n, m, R, rs, B))
        if plan.route != "stream" or not parallel.fused_supported(c):
            raise RuntimeError(f"{cell}: expected the fused path on the stream route: {plan}")
        x = torch.from_numpy(x0s).to(dev)
        before = admm_fused.LAUNCHES[kernel]
        (sol_f, _, _, d_f), lat_f = timed(lambda c=c, x=x: parallel.solve_batch_fused(c, x),
                                          REPS_STREAM)
        launches = (admm_fused.LAUNCHES[kernel] - before) / (REPS_STREAM + 1)
        (sol_g, _, _, d_g), lat_g = timed(lambda c=c, x=x: parallel.solve_batch(c, x),
                                          REPS_STREAM)
        for tag, sol in (("fused", sol_f), ("general", sol_g)):
            check_solution(sol, B, N, f"{cell} {tag}", nx=nx, nu=nu)
        both = (sol_f.status == 0) & (sol_g.status == 0)
        du = float((sol_f.u - sol_g.u).abs()[both].max()) if bool(both.any()) else 0.0
        rec = dict(
            phase="stream_solve", cell=cell, kernel=kernel, n=n, m=m, B=B, plan=plan._asdict(),
            launches_per_solve=launches,
            converged_fraction_fused=int(d_f.n_converged) / B,
            converged_fraction_general=int(d_g.n_converged) / B,
            statuses_equal_fraction=float((sol_f.status == sol_g.status).float().mean()),
            converged_both=int(both.sum()), max_abs_u_diff_vs_general=du,
            numeric_errors_fused=int((sol_f.status == STATUS_NUMERIC_ERROR).sum()),
            mean_iterations_fused=float(d_f.mean_iterations),
            mean_iterations_general=float(d_g.mean_iterations),
            max_iterations_fused=int(d_f.max_iterations),
            batch_p50_ms_fused=float(np.percentile(lat_f, 50)) * 1e3,
            batch_p50_ms_general=float(np.percentile(lat_g, 50)) * 1e3,
        )
        log(**rec)
        if rec["numeric_errors_fused"] or du > U_OK or not bool(both.any()):
            raise RuntimeError(f"{cell}: the fused solve disagrees with the general engine: {rec}")
        solves[cell] = rec
    counts = dict(admm_fused.LAUNCHES)
    plain = dict(admm_fused.PLAIN_CALLS)
    log(phase="counts", path="stream route", launches={k: v for k, v in counts.items() if v},
        plain_calls=plain)
    if any(plain.values()):
        raise RuntimeError("the stream route's solves ran a plain version")
    if min(counts["K1"], counts["K2"]) <= 0:
        raise RuntimeError(f"the stream route's solves left a kernel unlaunched: {counts}")
    t_solves = time.perf_counter() - t0 - t_design - t_kernels
    for cell, (c, x0s, kernel, _) in cells.items():
        x = torch.from_numpy(x0s).to(dev)
        rec = profile(lambda c=c, x=x: parallel.solve_batch_fused(c, x), 2)
        per_solve = solves[cell]["launches_per_solve"]
        rec["device_ops_per_chunk"] = rec["device_ops_per_call"] / per_solve
        log(phase="profile", cell=cell, reps=2, **rec)
    log(phase="stream_seconds", design=t_design, kernels=t_kernels, solves=t_solves,
        total=time.perf_counter() - t0)
    return records, counts


def wide32_x0s(B):
    """The (32, 1) plant's initial states: default_rng(0), 0.1 clip(N(0, 1),
    -3, 3) inside its unit state box, shape (B, 32)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return (0.1 * rng.standard_normal((B, 32)).clip(-3, 3)).astype(np.float32)


def wide_phase(dev):
    """K4's and K5's wide route on the card (csrc/admm_perr_wide.cu): the
    dense shapes their Pallas bodies take and the shared and stream routes
    (n <= 128, m <= 512) do not, each QP with its state or terminal rows
    first (``rows_first``).

    - Each kernel against its plain version, bit for bit (max_ulps 0), as
      k5_plan or k4_plan lays it out on the wide route, graph-timed over 20
      launches with its bound, shared-memory floor, FMA floor
      (roofline.fma_floor_ms), the register tiles' shared-memory floor
      (tile_floor_ms), the plan's L2 operator bytes a chunk (l2_bytes),
      its largest share of padded rows and its panel steps an iteration,
      and plain time: K5 at
      the QTP's h100 state box (n = 200, m = 600, the default config, B =
      2048) at each precision, its h100 equality terminal (200, 204), and
      at tier 1's grid (R = 2, no refinement, B = 1024) the widest state
      box (h154: 308, 924) and equality terminal (h228: 456, 460) the JAX
      package fuses; K4 at the (32, 1) plant's h20 state box at tier 1's
      grid (20, 660, B = 2048).
    - The cells dense-sc-h100-B2048 and dense-eq-h100-B2048 (the suite's
      ``AdmmConfig(max_iter=1000)`` and states) through
      ``parallel.solve_batch_fused`` (which raised ValueError before the
      wide route) and the general engine (``parallel.solve_batch``) on the
      same states, counted from zero: launches per solve, statuses,
      converged fractions, |du| where both converged (U_OK), p50 of each
      side, and each fused solve under torch.profiler; and the K4 cell
      dense-sc32x1-h20-B2048 (its lanes reach no certificate at eps 1e-6
      in 1000 iterations on either engine), whose fused solve is held to
      the same solve with K4's plain version on the card instead, and
      timed beside the general engine's on the same states.
    Fails if a kernel differs from its plain version, if a fused solve
    raises, runs a plain version, launches no wide-route kernel, leaves a
    lane non-finite, or lies more than U_OK from the general engine where
    both converged (from the plain version's solve on the K4 cell).
    Returns (the kernel records by kernel, the launches by count key)."""
    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch import parallel, proceed_controller
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big, qtp
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
    from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig
    from automationlabsmodelpredictivecontrol_jl_torch.types import STATUS_NUMERIC_ERROR
    from automationlabsmodelpredictivecontrol_jl_torch.utils import roofline

    t0 = time.perf_counter()
    suite = AdmmConfig(max_iter=1000)
    tier1 = AdmmConfig(max_iter=1000, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0)
    design = lambda N, cfg, **kw: rows_first(proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control", N, 5.0, [0.65] * 4,
        [1.2] * 2, admm_config=cfg, device=dev, **kw))
    sc100 = design(100, suite, mpc_state_constraint=True)
    eq100 = design(100, suite, mpc_terminal_ingredient="equality")
    k4 = rows_first(proceed_controller(
        big.random_stable_system(32, 1, seed=0), "model_predictive_control", 20, 5.0,
        [0.0] * 32, [0.0], admm_config=tier1, device=dev, mpc_state_constraint=True))
    shapes = [
        *((f"K5 h100 state box {mode}", with_precision(sc100, mode), B_SLICE, suite_x0s)
          for mode in PRECISIONS[:3]),
        ("K5 h100 equality", eq100, B_SLICE, suite_x0s),
        ("K5 h154 state box tier 1", design(154, tier1, mpc_state_constraint=True), B_WIDE_T1,
         bench_x0s),
        ("K5 h228 equality tier 1", design(228, tier1, mpc_terminal_ingredient="equality"),
         B_WIDE_T1, suite_x0s),
        ("K4 (32, 1) h20 state box tier 1", k4, B_SLICE, wide32_x0s),
    ]
    t_design = time.perf_counter() - t0
    records = {"K4": [], "K5": []}
    for label, c, B, x0s_fn in shapes:
        rec = compare_kernel(c, B, 70, x0s_fn, plain_reps=1)
        rec.update(shape=label)
        plan = admm_fused.WidePlan(**rec["plan"])
        n, m, rs, packed = rec["n"], rec["m"], rec["refine_steps"], rec["kernel"] == "K4"
        lay = admm_fused.wide_layout(n, m, rs, plan.lanes, plan.tiles, plan.panel, packed,
                                     plan.cluster)
        # the plan's models, in this log line only (the kernels line carries
        # measurements and the bound)
        models = dict(
            fma_floor_ms=roofline.fma_floor_ms(n, m, B, rs, rec["chunk"], card_peaks(), sm_clock_hz(),
                                               rec["kernel"], rec.get("precision", "highest")),
            tile_floor_ms=tile_floor_ms(n, m, B, rs, rec["chunk"], plan, packed),
            l2_bytes=admm_fused.wide_l2_bytes(n, m, rec["R"], rs, B, plan, rec["chunk"], packed),
            padded_share=max(g.padded_rows / (g.tiles * g.H) for g in lay.products if g),
            clusters_used=admm_fused.k12_blocks_used(rec["R"], B, plan.lanes),
            steps_per_iteration=sum(g.tiles * g.np * k for g, k in zip(
                lay.products, (1, 1 + rs, rs, 1)) if g),
        )
        log(phase="wide_vs_plain", **rec, **models)
        if rec["plan"]["route"] != "wide":
            raise RuntimeError(f"{label}: expected the wide route: {rec['plan']}")
        records[rec["kernel"]].append(rec)
    t_kernels = time.perf_counter() - t0 - t_design

    cells = {
        "dense-sc-h100-B2048": (sc100, suite_x0s(B_SLICE), "K5", 4),
        "dense-eq-h100-B2048": (eq100, suite_x0s(B_SLICE), "K5", 4),
        "dense-sc32x1-h20-B2048": (k4, wide32_x0s(B_SLICE), "K4", 32),
    }
    admm_fused.reset_counts()
    solves = {}
    for cell, (c, x0s, kernel, nx) in cells.items():
        op = c.engine.op
        m, n = (int(d) for d in op.A_s.shape)
        B, N = int(x0s.shape[0]), c.engine.qp.N
        R, rs = int(op.rho_grid.shape[0]), int(c.engine.config.refine_steps)
        plan = (admm_fused.k4_plan if kernel == "K4" else admm_fused.k5_plan)(n, m, R, rs, B)
        if plan.route != "wide" or not parallel.fused_supported(c):
            raise RuntimeError(f"{cell}: expected the fused path on the wide route: {plan}")
        x = torch.from_numpy(x0s).to(dev)
        before = admm_fused.LAUNCHES[kernel]
        (sol_f, _, _, d_f), lat_f = timed(lambda c=c, x=x: parallel.solve_batch_fused(c, x),
                                          REPS_WIDE_ROUTE)
        launches = (admm_fused.LAUNCHES[kernel] - before) / (REPS_WIDE_ROUTE + 1)
        check_solution(sol_f, B, N, f"{cell} fused", nx=nx, nu=1 if kernel == "K4" else 2)
        rec = dict(
            phase="wide_solve", cell=cell, kernel=kernel, n=n, m=m, B=B, plan=plan._asdict(),
            launches_per_solve=launches,
            converged_fraction_fused=int(d_f.n_converged) / B,
            numeric_errors_fused=int((sol_f.status == STATUS_NUMERIC_ERROR).sum()),
            mean_iterations_fused=float(d_f.mean_iterations),
            max_iterations_fused=int(d_f.max_iterations),
            batch_p50_ms_fused=float(np.percentile(lat_f, 50)) * 1e3,
        )
        if kernel == "K5":
            (sol_g, _, _, d_g), lat_g = timed(lambda c=c, x=x: parallel.solve_batch(c, x),
                                              REPS_WIDE_ROUTE)
            check_solution(sol_g, B, N, f"{cell} general")
            both = (sol_f.status == 0) & (sol_g.status == 0)
            du = float((sol_f.u - sol_g.u).abs()[both].max()) if bool(both.any()) else 0.0
            rec.update(
                converged_fraction_general=int(d_g.n_converged) / B,
                statuses_equal_fraction=float((sol_f.status == sol_g.status).float().mean()),
                converged_both=int(both.sum()), max_abs_u_diff_vs_general=du,
                mean_iterations_general=float(d_g.mean_iterations),
                batch_p50_ms_general=float(np.percentile(lat_g, 50)) * 1e3,
            )
            bad = du > U_OK or not bool(both.any())
        else:  # the same solve with the plain version, on fewer lanes and iterations
            # the general engine on the same states: a time only (neither
            # engine certifies these lanes at eps 1e-6 in 1000 iterations)
            (sol_g, _, _, d_g), lat_g = timed(lambda c=c, x=x: parallel.solve_batch(c, x),
                                              REPS_WIDE_ROUTE)
            check_solution(sol_g, B, N, f"{cell} general", nx=nx, nu=1)
            rec.update(converged_fraction_general=int(d_g.n_converged) / B,
                       mean_iterations_general=float(d_g.mean_iterations),
                       batch_p50_ms_general=float(np.percentile(lat_g, 50)) * 1e3)
            short = with_iterations(c, WIDE_PLAIN_ITERS)
            plain_fn = admm_fused.chunk_fn_for(op, plain=True, config=c.engine.config)
            xs = x[:B_WIDE_PLAIN]
            counted = dict(admm_fused.LAUNCHES), dict(admm_fused.PLAIN_CALLS)
            s_k, _, _, _ = parallel.solve_batch_fused(short, xs)
            s_p, _, _, _ = parallel.solve_batch_fused(short, xs, chunk_fn=plain_fn)
            for counts, before in zip((admm_fused.LAUNCHES, admm_fused.PLAIN_CALLS), counted):
                counts.update(before)  # the comparison's launches are not the path's
            du = float((s_k.u - s_p.u).abs().max())
            rec.update(plain_lanes=B_WIDE_PLAIN, plain_iterations=WIDE_PLAIN_ITERS,
                       statuses_equal_plain=bool(torch.equal(s_k.status, s_p.status)),
                       max_abs_u_diff_vs_plain=du)
            bad = du > U_OK or not rec["statuses_equal_plain"]
        log(**rec)
        if rec["numeric_errors_fused"] or bad:
            raise RuntimeError(f"{cell}: the fused solve disagrees with its reference: {rec}")
        solves[cell] = rec
    counts = dict(admm_fused.LAUNCHES)
    plain = dict(admm_fused.PLAIN_CALLS)
    log(phase="counts", path="wide route", launches={k: v for k, v in counts.items() if v},
        plain_calls=plain)
    if any(plain.values()):
        raise RuntimeError("the wide route's solves ran a plain version")
    if min(counts["K4"], counts["K5"]) <= 0:
        raise RuntimeError(f"the wide route's solves left a kernel unlaunched: {counts}")
    t_solves = time.perf_counter() - t0 - t_design - t_kernels
    for cell, (c, x0s, _, _) in cells.items():
        x = torch.from_numpy(x0s).to(dev)
        rec = profile(lambda c=c, x=x: parallel.solve_batch_fused(c, x), 2)
        per_solve = solves[cell]["launches_per_solve"]
        rec["device_ops_per_chunk"] = rec["device_ops_per_call"] / per_solve
        log(phase="profile", cell=cell, reps=2, **rec)
    log(phase="wide_seconds", design=t_design, kernels=t_kernels, solves=t_solves,
        total=time.perf_counter() - t0)
    return records, counts


def main():
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke.py: the {PKG} package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch import native_qp, parallel
    from automationlabsmodelpredictivecontrol_jl_torch import RiccatiEngine, proceed_controller
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp
    from automationlabsmodelpredictivecontrol_jl_torch.ops import (
        _build, admm_fused, riccati, riccati_fused,
    )
    from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig
    from automationlabsmodelpredictivecontrol_jl_torch.ops.riccati import RiccatiConfig
    from automationlabsmodelpredictivecontrol_jl_torch.utils import roofline
    from automationlabsmodelpredictivecontrol_jl_torch.utils.devices import require_cuda

    # 1. the card
    t_start = time.perf_counter()
    dev = require_cuda()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(phase="device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        sms=torch.cuda.get_device_properties(0).multi_processor_count)

    # 2. build from the checkout's sources
    t0 = time.perf_counter()
    ptxas = _build.build_kernels(force=True)
    t_nvcc = time.perf_counter() - t0
    with open(os.path.join(os.path.dirname(_build.LIB_PATH), "ptxas.txt"), "w") as f:
        f.write(ptxas)
    for row in ptxas_summary(ptxas):
        log(phase="ptxas", **row)
    t0 = time.perf_counter()
    native_qp.build(force=True)
    t_gxx = time.perf_counter() - t0
    _build.load_kernels()
    log(phase="build", nvcc_s=t_nvcc, gxx_s=t_gxx)

    plant = qtp.linearized_discrete_system()
    design = lambda cfg, **kw: proceed_controller(
        plant, "model_predictive_control", 20, 5.0, [0.65] * 4, [1.2] * 2,
        admm_config=cfg, device=dev, **kw,
    )

    # the K1 path's controllers, designed on the host and moved to the card
    tier1 = AdmmConfig(**TIER1)
    ctrl = design(tier1)
    fb = parallel.escalation_controller(
        ctrl, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250, refine_steps=2
    )
    if not (ctrl.engine.op.diag_a and fb.engine.op.diag_a):
        raise RuntimeError("the h20 box-only operator is expected to be diagonal")
    # the verify skill's controller, the default AdmmConfig (R = 5, one
    # refinement): the general engine's phase, and K1 at its shape
    ctrl_def = design(None)

    # the K2 path's controllers: the suite's config, and its state-
    # constrained counterpart; tier 2 of the latter at R=4/refine 2
    suite = AdmmConfig(max_iter=1000)
    ctrl_eq = design(suite, mpc_terminal_ingredient="equality")
    ctrl_nb = design(suite, mpc_terminal_ingredient="neighborhood")
    ctrl_sc = design(suite, mpc_state_constraint=True)
    ctrl_scnb = design(suite, mpc_state_constraint=True, mpc_terminal_ingredient="neighborhood")
    fb_sc = parallel.escalation_controller(
        ctrl_sc, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250, refine_steps=2
    )
    for c in (ctrl_eq, ctrl_nb, ctrl_sc, ctrl_scnb, fb_sc):
        if not (c.engine.op.mixed_a and parallel.fused_supported(c)):
            raise RuntimeError("the h20 row configs are expected to be mixed and fused")

    # the K3 path's controllers: h500, where engine="auto" designs the
    # Riccati engine, and h50 with engine="riccati" (suite config 6's
    # RiccatiConfig); one h50 controller for each other branch of K3
    long = lambda N, **kw: proceed_controller(
        plant, "model_predictive_control", N, 5.0, [0.65] * 4, [1.2] * 2,
        riccati_config=RiccatiConfig(max_iter=1000), device=dev, **kw,
    )
    ctrl_h500 = long(500)
    ctrl_h50 = long(50, engine="riccati")
    branches_h50 = {
        "state": long(50, engine="riccati", mpc_state_constraint=True),
        "contractive": long(50, engine="riccati", mpc_terminal_ingredient="contractive"),
        "equality": long(50, engine="riccati", mpc_terminal_ingredient="equality"),
    }
    for c in (ctrl_h500, ctrl_h50, *branches_h50.values()):
        if not (isinstance(c.engine, RiccatiEngine) and parallel.fused_supported(c)):
            raise RuntimeError("the long-horizon controllers are expected on K3")
    ops = {k: c.engine.op for k, c in branches_h50.items()}
    if not (ops["state"].split_interior and ops["contractive"].terminal_ball
            and ops["equality"].term_rho_scale == 100.0):
        raise RuntimeError("the h50 controllers are expected to take K3's three branches")

    # the dense path's controllers: the h20 equality and state-box QPs and
    # the h50 state-box QP with their state or terminal rows first; and, on
    # K4, the state-box QP at tier 1's grid (no refinement), the equality
    # QP's tier 2 and the neighborhood QP (K4's stream route)
    dense = {
        "dense-eq-h20-B2048": rows_first(ctrl_eq),
        "dense-sc-h20-B2048": rows_first(ctrl_sc),
        "dense-sc-h50-B2048": rows_first(proceed_controller(
            plant, "model_predictive_control", 50, 5.0, [0.65] * 4, [1.2] * 2,
            admm_config=suite, device=dev, mpc_state_constraint=True,
        )),
    }
    dense_t1 = rows_first(design(
        AdmmConfig(max_iter=1000, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0),
        mpc_state_constraint=True,
    ))
    tier2 = lambda c: parallel.escalation_controller(
        c, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250, refine_steps=2)
    dense_fb = tier2(dense["dense-sc-h20-B2048"])  # tier 2 of the h20 state box
    dense_eq_fb = tier2(dense["dense-eq-h20-B2048"])  # and of the equality terminal
    dense_nb = rows_first(ctrl_nb)
    want = {"dense-eq-h20-B2048": "K4", "dense-sc-h20-B2048": "K5", "dense-sc-h50-B2048": "K5"}
    checks = [(k, c, want[k]) for k, c in dense.items()] + [
        ("tier-1 state box", dense_t1, "K4"), ("tier-2 state box", dense_fb, "K5"),
        ("tier-2 equality", dense_eq_fb, "K4"), ("neighborhood", dense_nb, "K4")]
    for cell, c, kind in checks:
        if not (c.engine.op.dense_a and parallel.fused_supported(c)
                and roofline.kernel_of(c.engine.op, c.engine.config) == kind):
            raise RuntimeError(f"{cell}: expected a dense operator on {kind}")

    # 3. each kernel against its plain version at its main-path shapes
    # K1 at tier 1's B, tier 2's bucket and the closed loop's B, each with
    # random rho indices and with every lane at the config's start index;
    # then tier 2 at ragged buckets, which take the plan's other layouts
    k1_cases = ((ctrl, B_MAIN, 1), (fb, BUCKET, 2), (ctrl, B_CL, 24))
    k1_shapes = [compare_kernel(c, B, seed, bench_x0s, single_index=single)
                 for c, B, seed in k1_cases for single in (False, True)]
    k1_shapes += [compare_kernel(fb, B, 25 + i, bench_x0s, plain_reps=2)
                  for i, B in enumerate(RAGGED)]
    k1_shapes.append(compare_kernel(ctrl_def, B_CL, 32, bench_x0s, plain_reps=5))
    k1_layouts = {(r["plan"]["lanes"], r["plan"]["groups"]) for r in k1_shapes}
    for rec in k1_shapes:
        log(phase="k1_vs_plain", **rec)
    # K2 at the state-constrained shape first (40 launches per solve), then
    # the suite's two terminals, state + neighborhood and tier 2, each with
    # random rho indices and with every lane at the config's start index;
    # then ragged batches, which take the plan's other lanes per block
    k2_cases = ((ctrl_sc, B_SLICE, bench_x0s), (ctrl_eq, B_SLICE, suite_x0s),
                (ctrl_nb, B_SLICE, suite_x0s), (ctrl_scnb, B_SLICE, bench_x0s),
                (fb_sc, BUCKET, bench_x0s))
    k2_shapes = [compare_kernel(c, B, 3 + i, x0s_fn, single_index=single)
                 for i, (c, B, x0s_fn) in enumerate(k2_cases) for single in (False, True)]
    k2_shapes += [compare_kernel(ctrl_sc, B, 20 + i, bench_x0s, plain_reps=2)
                  for i, B in enumerate(RAGGED)]
    k2_layouts = {(r["plan"]["lanes"], r["plan"]["groups"]) for r in k2_shapes}
    for rec in k2_shapes:
        log(phase="k2_vs_plain", **rec)
    # K3 at the h500 cell's shape (plain timed once: ~10^6 small launches)
    # and at h50 on each other branch; the driver's two recurrences at h500
    k3_shapes = [compare_k3(ctrl_h500, "none", B_H500, 8, suite6_x0s, plain_reps=1)]
    k3_shapes[0]["chain_floor_ms"] = chain_floor_ms(
        500, 4, 2, int(ctrl_h500.engine.config.check_interval), dev)
    k3_shapes += [compare_k3(c, k, B_H500, 9 + i, suite6_x0s, plain_reps=2)
                  for i, (k, c) in enumerate(branches_h50.items())]
    # the runtime's step on the per-lane engine: h500 at one lane
    k3_shapes.append(compare_k3(ctrl_h500, "none", 1, 31, suite6_x0s, plain_reps=1))
    # the shapes that take the other routes of K3's plan: fewer lanes beside
    # the fp64 factors (h500 with the state box), a ragged batch, fp32
    # factors read through L1/L2 (h800) or in shared memory (h1000 at 256
    # lanes), the rows streamed (h500 at 4096 lanes), and the (8, 4) and
    # (16, 8) register tiers (seeded plants); 5 iterations where the plain
    # version's Python loop over the horizon is long
    qtp_op = ctrl_h500.engine.op
    sc_op = branches_h50["state"].engine.op
    e0 = lambda nx, B, seed: torch.from_numpy(
        (0.1 * np.random.default_rng(seed).standard_normal((nx, B))).astype(np.float32)
    ).to(dev)
    ridx0 = riccati._initial_ridx(qtp_op, ctrl_h500.engine.config)
    extra = [
        ("h500 state box", operator_like(sc_op, 500, True), B_H500, 25, "shared-fp64"),
        ("h50 state box, ragged batch", sc_op, 1000, 25, "shared-fp64"),
        ("h800", operator_like(qtp_op, 800, False), B_H500, 5, "shared-l2"),
        ("h1000, 256 lanes", operator_like(qtp_op, 1000, False), 256, 5, "shared-fp32"),
        ("h500, 4096 lanes", qtp_op, B_H50, 5, "stream"),
        ("(8, 4) plant, h50 state box", wide_operator(8, 4, 50, dev, 18), B_H500, 25,
         "shared-fp64"),
        ("(16, 8) plant, h50 state box, ragged batch", wide_operator(16, 8, 50, dev, 19), 1000,
         5, "shared-fp64"),
        ("(7, 3) plant, h200 state box", wide_operator(7, 3, 200, dev, 20), B_H500, 5,
         "shared-fp32"),
    ]
    for i, (branch, op_x, B_x, chunk_x, want_route) in enumerate(extra):
        args = operator_inputs(op_x, ridx0, e0(op_x.nx, B_x, 30 + i), 40 + i) + (chunk_x,)
        rec = compare_k3_args(args, branch, plain_reps=1)
        if rec["route"] != want_route:
            raise RuntimeError(f"K3's plan took {rec['route']} at {branch}, expected {want_route}")
        k3_shapes.append(rec)
    routes = {rec["route"] for rec in k3_shapes}
    if routes != set(riccati_fused.K3_ROUTES):
        raise RuntimeError(f"K3 routes not held to the plain version: {set(riccati_fused.K3_ROUTES) - routes}")
    for rec in k3_shapes:
        log(phase="k3_vs_plain", **rec)
    # at the h500 cell's 1024 lanes, the runtime's one lane and the 256-lane
    # bucket of the escalated solve's tier 2 (both on the per-lane engine)
    recurrences = [compare_recurrences(ctrl_h500, B, 13 + i, suite6_x0s)
                   for i, B in enumerate((B_H500, 1, 256))]
    rollout_recs = [rec for rec, _ in recurrences]
    cert_recs = [rec for _, rec in recurrences]
    for rec in rollout_recs + cert_recs:
        log(phase="k3_driver_vs_plain", **rec)
    # K4 at the equality terminal (random and one rho index, tier 2's
    # bucket, a ragged batch), the state box at tier 1's grid: the shared
    # route; the neighborhood terminal: the stream route. K5 at h20 (random
    # and one rho index, tier 2's bucket, a ragged batch: the shared route)
    # and h50 (the stream route). Each with its plan line (plain timed
    # less: ~10^4 small launches per chunk)
    eq20 = dense["dense-eq-h20-B2048"]
    k4_shapes = [compare_kernel(eq20, B_SLICE, 14, suite_x0s),
                 compare_kernel(eq20, B_SLICE, 27, suite_x0s, plain_reps=5, single_index=True),
                 compare_kernel(dense_eq_fb, BUCKET, 28, suite_x0s, plain_reps=5),
                 compare_kernel(eq20, RAGGED[2], 29, suite_x0s, plain_reps=5),
                 compare_kernel(dense_t1, B_SLICE, 15, bench_x0s, plain_reps=5),
                 compare_kernel(dense_nb, B_SLICE, 30, suite_x0s, plain_reps=5)]
    k4_routes = {rec["plan"]["route"] for rec in k4_shapes}
    if k4_routes != {"shared", "stream"}:  # the wide route: wide_phase
        raise RuntimeError(f"K4 routes not held to the plain version: {k4_routes}")
    sc20 = dense["dense-sc-h20-B2048"]
    k5_shapes = [compare_kernel(sc20, B_SLICE, 16, bench_x0s, plain_reps=5),
                 compare_kernel(sc20, B_SLICE, 18, bench_x0s, plain_reps=2, single_index=True),
                 compare_kernel(dense_fb, BUCKET, 19, bench_x0s, plain_reps=2),
                 compare_kernel(sc20, RAGGED[2], 26, bench_x0s, plain_reps=2),
                 compare_kernel(dense["dense-sc-h50-B2048"], B_SLICE, 17, suite_x0s, plain_reps=2)]
    k5_routes = {rec["plan"]["route"] for rec in k5_shapes}
    if k5_routes != {"shared", "stream"}:  # the wide route: wide_phase
        raise RuntimeError(f"K5 routes not held to the plain version: {k5_routes}")
    for rec in k4_shapes + k5_shapes:
        log(phase="dense_vs_plain", **rec)

    # 4a. the K1 path, counted from zero
    x0s = torch.from_numpy(bench_x0s(B_MAIN)).to(dev)
    wz, wy = parallel.init_warm_batch(ctrl, B_MAIN)
    admm_fused.reset_counts()

    esc_solve = lambda: parallel.solve_batch_escalated(ctrl, fb, x0s, wz, wy, bucket=BUCKET)
    (sol, _, _, diag), lat = timed(esc_solve, REPS)
    esc_p50_s = float(np.percentile(lat, 50))
    k1_per_solve = admm_fused.LAUNCHES["K1"] / (REPS + 1)  # the solves are alike
    check_solution(sol, B_MAIN, 20, "the escalated solve")
    conv = int(diag.n_converged) / B_MAIN
    log(phase="escalated", B=B_MAIN, bucket=BUCKET, converged_fraction=conv,
        mean_iterations=float(diag.mean_iterations),
        max_iterations=int(diag.max_iterations),
        batch_p50_ms=float(np.percentile(lat, 50)) * 1e3,
        batch_p99_ms=float(np.percentile(lat, 99)) * 1e3,
        solves_per_s=B_MAIN / float(np.median(lat)))

    esc = parallel.make_escalated_solver(ctrl, fallback=fb, min_bucket=BUCKET)
    t0 = time.perf_counter()
    sol_e, _, _, diag_e = esc(x0s)
    torch.cuda.synchronize()
    t_esc = time.perf_counter() - t0
    conv_final = int(diag_e.n_converged) / B_MAIN
    log(phase="three_tier", converged_fraction_final=conv_final,
        host_tier_lanes=int((sol.status != 0).sum()), seconds=t_esc)

    t0 = time.perf_counter()
    xs_cl, us_cl, st_cl = parallel.closed_loop_batch(
        ctrl, qtp.qtp_discrete_step, x0s[:B_CL], CL_STEPS
    )
    torch.cuda.synchronize()
    t_cl = time.perf_counter() - t0
    if not bool(torch.isfinite(xs_cl).all()) or tuple(xs_cl.shape) != (CL_STEPS + 1, B_CL, 4):
        raise RuntimeError("closed loop produced non-finite or misshapen states")
    cl_ok = float((st_cl == 0).float().mean())
    log(phase="closed_loop", lanes=B_CL, steps=CL_STEPS, converged_step_fraction=cl_ok,
        steps_per_s=B_CL * CL_STEPS / t_cl, seconds=t_cl)

    k1_launches = admm_fused.LAUNCHES["K1"]
    plain_k1 = dict(admm_fused.PLAIN_CALLS)
    log(phase="counts", path="K1", k1_launches=k1_launches,
        k1_launches_per_escalated_solve=k1_per_solve, plain_calls=plain_k1)
    if k1_launches <= 0:
        raise RuntimeError("the K1 path never launched K1")
    if any(plain_k1.values()):
        raise RuntimeError("the K1 path ran a plain version")
    if conv < CONV_OK or conv_final != 1.0:
        raise RuntimeError(f"convergence too low: {conv}, final {conv_final}")

    # 4b. the K2 path, counted from zero: the suite's terminal config at
    # B=2048 through solve_batch_auto, then the state-constrained controller
    x_suite = torch.from_numpy(suite_x0s(B_SLICE)).to(dev)
    x_bench = x0s[:B_SLICE]
    admm_fused.reset_counts()
    slice_recs, k2_sols = [], {}
    for kind, c in (("equality", ctrl_eq), ("neighborhood", ctrl_nb)):
        before = admm_fused.LAUNCHES["K2"]
        (sol_s, _, _, diag_s), lat = timed(lambda c=c: parallel.solve_batch_auto(c, x_suite), REPS)
        check_solution(sol_s, B_SLICE, 20, f"the {kind} slice")
        k2_sols[kind] = sol_s
        rec = dict(
            phase="slice", terminal=kind, B=B_SLICE, m=int(c.engine.op.A_s.shape[0]),
            converged_fraction=int(diag_s.n_converged) / B_SLICE,
            mean_iterations=float(diag_s.mean_iterations),
            max_iterations=int(diag_s.max_iterations),
            batch_p50_ms=float(np.percentile(lat, 50)) * 1e3,
            batch_p99_ms=float(np.percentile(lat, 99)) * 1e3,
            solves_per_s=B_SLICE / float(np.median(lat)),
            k2_launches_per_solve=(admm_fused.LAUNCHES["K2"] - before) / (REPS + 1),
        )
        log(**rec)
        slice_recs.append(rec)

    before = admm_fused.LAUNCHES["K2"]
    (sol_sc, _, _, diag_sc), lat = timed(
        lambda: parallel.solve_batch_auto(ctrl_sc, x_bench), REPS_SC
    )
    check_solution(sol_sc, B_SLICE, 20, "the state-constrained solve")
    log(phase="state_constrained", B=B_SLICE, m=int(ctrl_sc.engine.op.A_s.shape[0]),
        converged_fraction=int(diag_sc.n_converged) / B_SLICE,
        n_max_iter=int(diag_sc.n_max_iter), n_infeasible=int(diag_sc.n_infeasible),
        mean_iterations=float(diag_sc.mean_iterations), solves=len(lat),
        batch_p50_ms=float(np.percentile(lat, 50)) * 1e3,
        batch_p99_ms=float(np.percentile(lat, 99)) * 1e3,
        k2_launches_per_solve=(admm_fused.LAUNCHES["K2"] - before) / (REPS_SC + 1))

    k2_launches = admm_fused.LAUNCHES["K2"]
    plain_k2 = dict(admm_fused.PLAIN_CALLS)
    log(phase="counts", path="K2", k2_launches=k2_launches,
        k1_launches=admm_fused.LAUNCHES["K1"], plain_calls=plain_k2)
    if k2_launches <= 0:
        raise RuntimeError("the K2 path never launched K2")
    if any(plain_k2.values()):
        raise RuntimeError("the K2 path ran a plain version")
    for rec in slice_recs:
        if rec["converged_fraction"] < CONV_OK:
            raise RuntimeError(f"slice convergence too low: {rec}")

    # 4c. the K3 path, counted from zero: the h500 cell and the h50 cell
    # through solve_batch_auto, then a closed loop at h500
    x_h500 = torch.from_numpy(suite6_x0s(B_H500)).to(dev)
    x_h50 = torch.from_numpy(suite6_x0s(B_H50)).to(dev)
    admm_fused.reset_counts()
    ricc_recs = {}
    for cell, c, x in (("riccati-h500-B1024", ctrl_h500, x_h500),
                       ("riccati-h50-B4096", ctrl_h50, x_h50)):
        B = int(x.shape[0])
        before = admm_fused.LAUNCHES["K3"]
        (sol_r, _, _, diag_r), lat = timed(
            lambda c=c, x=x: parallel.solve_batch_auto(c, x), REPS_RICCATI
        )
        check_solution(sol_r, B, c.engine.op.N, cell)
        rec = dict(
            phase="riccati", cell=cell, B=B, N=c.engine.op.N,
            converged_fraction=int(diag_r.n_converged) / B,
            n_max_iter=int(diag_r.n_max_iter), n_infeasible=int(diag_r.n_infeasible),
            mean_iterations=float(diag_r.mean_iterations),
            max_iterations=int(diag_r.max_iterations), solves=len(lat),
            batch_p50_ms=float(np.percentile(lat, 50)) * 1e3,
            batch_p99_ms=float(np.percentile(lat, 99)) * 1e3,
            solves_per_s=B / float(np.median(lat)),
            k3_launches_per_solve=(admm_fused.LAUNCHES["K3"] - before) / (REPS_RICCATI + 1),
        )
        log(**rec)
        ricc_recs[cell] = rec
        if cell == "riccati-h500-B1024":
            # the share of lanes still iterating in each chunk, from the
            # solution's per-lane counts: what skipping finished lanes could save
            ck = int(c.engine.config.check_interval)
            its = sol_r.iterations.cpu().numpy()
            chunks = -(-int(its.max()) // ck)
            log(phase="active_lanes_per_chunk", cell=cell, chunk=ck, chunks=chunks,
                share=[float((its > j * ck).mean()) for j in range(chunks)])

    t0 = time.perf_counter()
    xs_r, _, st_r = parallel.closed_loop_batch(ctrl_h500, qtp.qtp_discrete_step, x_h500, CL_STEPS)
    torch.cuda.synchronize()
    t_clr = time.perf_counter() - t0
    if not bool(torch.isfinite(xs_r).all()) or tuple(xs_r.shape) != (CL_STEPS + 1, B_H500, 4):
        raise RuntimeError("the h500 closed loop produced non-finite or misshapen states")
    log(phase="closed_loop", cell="riccati-h500-closed-loop", lanes=B_H500, steps=CL_STEPS,
        converged_step_fraction=float((st_r == 0).float().mean()),
        steps_per_s=B_H500 * CL_STEPS / t_clr, seconds=t_clr)

    k3_counts = {k: admm_fused.LAUNCHES[k] for k in ("K3", "rollout", "certificate")}
    plain_k3 = dict(admm_fused.PLAIN_CALLS)
    log(phase="counts", path="K3", launches=k3_counts,
        k1_k2_launches=[admm_fused.LAUNCHES["K1"], admm_fused.LAUNCHES["K2"]],
        plain_calls=plain_k3)
    if min(k3_counts.values()) <= 0:
        raise RuntimeError(f"the K3 path left a kernel unlaunched: {k3_counts}")
    if any(plain_k3.values()):
        raise RuntimeError("the K3 path ran a plain version")
    if ricc_recs["riccati-h500-B1024"]["converged_fraction"] < CONV_OK:
        raise RuntimeError(f"h500 convergence too low: {ricc_recs['riccati-h500-B1024']}")

    # 4c'. the scenario-sharded solve: one NCCL rank against the batch paths
    # on the headline's tier-1 cell and the h500 cell, two gloo ranks
    # sharing the card on the tier-1 cell, counted from zero
    sharded_counts = sharded_phase(dev, ctrl, fb, x0s, ctrl_h500, x_h500, esc_p50_s)

    # 4d. the dense path, counted from zero: each cell through
    # parallel.solve_batch_fused; the h20 cells against the K2 solves of
    # the same QPs above (K2 does not take h50's 200-row tail)
    dense_x0s = {
        "dense-eq-h20-B2048": (x_suite, k2_sols["equality"]),
        "dense-sc-h20-B2048": (x_bench, sol_sc),
        "dense-sc-h50-B2048": (torch.from_numpy(suite_x0s(B_SLICE)).to(dev), None),
    }
    admm_fused.reset_counts()
    dense_recs, dense_sols = {}, {}
    for cell, c in dense.items():
        x, ref = dense_x0s[cell]
        kind = want[cell]
        before = admm_fused.LAUNCHES[kind]
        reps = REPS if cell == "dense-eq-h20-B2048" else 5
        (sol_d, _, _, diag_d), lat = timed(lambda c=c, x=x: parallel.solve_batch_fused(c, x), reps)
        check_solution(sol_d, B_SLICE, c.engine.qp.N, cell)
        rec = dict(
            phase="dense", cell=cell, kernel=kind, B=B_SLICE, N=c.engine.qp.N,
            m=int(c.engine.op.A_s.shape[0]),
            converged_fraction=int(diag_d.n_converged) / B_SLICE,
            n_max_iter=int(diag_d.n_max_iter), n_infeasible=int(diag_d.n_infeasible),
            mean_iterations=float(diag_d.mean_iterations),
            max_iterations=int(diag_d.max_iterations), solves=len(lat),
            batch_p50_ms=float(np.percentile(lat, 50)) * 1e3,
            batch_p99_ms=float(np.percentile(lat, 99)) * 1e3,
            solves_per_s=B_SLICE / float(np.median(lat)),
            launches_per_solve=(admm_fused.LAUNCHES[kind] - before) / (reps + 1),
        )
        if ref is not None:
            same = sol_d.status == ref.status
            both = (sol_d.status == 0) & (ref.status == 0)
            rec.update(
                k2_converged_fraction=float((ref.status == 0).float().mean()),
                statuses_equal_fraction=float(same.float().mean()),
                max_abs_u_diff_vs_k2=float((sol_d.u - ref.u).abs()[both].max()) if bool(both.any()) else 0.0,
            )
        log(**rec)
        dense_recs[cell] = rec
        dense_sols[cell] = sol_d

    dense_counts = {k: admm_fused.LAUNCHES[k] for k in ("K4", "K5")}
    plain_dense = dict(admm_fused.PLAIN_CALLS)
    log(phase="counts", path="K4/K5", launches=dense_counts,
        other_launches={k: v for k, v in admm_fused.LAUNCHES.items() if k not in dense_counts},
        plain_calls=plain_dense)
    if min(dense_counts.values()) <= 0:
        raise RuntimeError(f"the dense path left a kernel unlaunched: {dense_counts}")
    if any(plain_dense.values()):
        raise RuntimeError("the dense path ran a plain version")
    for cell in ("dense-eq-h20-B2048", "dense-sc-h50-B2048"):
        if dense_recs[cell]["converged_fraction"] < CONV_OK:
            raise RuntimeError(f"dense convergence too low: {dense_recs[cell]}")
    # statuses are held to K2's on the equality cell; on the state box about
    # half the lanes end at the iteration limit, decided by roundoff in
    # either kernel, so there u is held where both converged
    for cell in ("dense-eq-h20-B2048", "dense-sc-h20-B2048"):
        rec = dense_recs[cell]
        same_ok = cell != "dense-eq-h20-B2048" or rec["statuses_equal_fraction"] >= CONV_OK
        if not same_ok or rec["max_abs_u_diff_vs_k2"] > U_OK:
            raise RuntimeError(f"the dense solve disagrees with K2 on the same QP: {rec}")

    # 4e. the general engine, the per-lane Riccati engine and the runtime,
    # counted from zero
    admm_fused.reset_counts()
    k3_general, fused_sols = general_phase(dev, plant, ctrl, ctrl_def, ctrl_h500, suite, x0s,
                                           x_h500, x_suite)
    general_counts = dict(admm_fused.LAUNCHES)
    plain_general = dict(admm_fused.PLAIN_CALLS)
    log(phase="counts", path="general", launches=general_counts,
        k3_launches_by_riccati_path=k3_general, plain_calls=plain_general)
    if min(general_counts[k] for k in ("K1", "K3", "rollout", "certificate")) <= 0:
        raise RuntimeError(f"the general phase left a kernel unlaunched: {general_counts}")
    if any(plain_general.values()):
        raise RuntimeError("the general phase ran a plain version")

    # 4f. learned plants: the SQP and the linearized learned controller on
    # K1, counted from zero cell by cell
    k1_learned, k1_learned_rec = learned_phase(
        dev, tier1, dict(rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250, refine_steps=2))
    k1_shapes.append(k1_learned_rec)

    # 4g. the controller types: K3's (32, 16) tier on the wide Riccati
    # cell, the fuzzy, economic and MILP cells, counted from zero cell by cell
    k3_wide, k3w_wide, rollout_wide, cert_wide, ctrl_counts, ctrl_wide_rec = controllers_phase(dev)
    k3_shapes += k3_wide
    rollout_recs += rollout_wide
    cert_recs += cert_wide

    # 4h. the Riccati sweeps: K3W past (32, 16) and under parallel_sweeps,
    # with the wide rollout and certificate, counted from zero path by path
    k3w_seq, k3w_dbl, rollout_w, cert_w, k3w_counts = riccati_sweeps_phase(dev)
    rollout_w += [r for r in ctrl_wide_rec if r["kernel"] == "rollout-wide"]
    cert_w += [r for r in ctrl_wide_rec if r["kernel"] == "certificate-wide"]

    # 4i. the kernel precisions: each kernel at bf16x3 and default against
    # its plain version at the main-path shapes and routes, then the
    # headline tier 1, the K2 state box and the dense cells under each
    # precision, counted from zero
    prec_kernels = {
        "K1 tier 1": (ctrl, B_MAIN, bench_x0s), "K1 tier 2": (fb, BUCKET, bench_x0s),
        "K2 state box": (ctrl_sc, B_SLICE, bench_x0s),
        "K4 equality (shared)": (dense["dense-eq-h20-B2048"], B_SLICE, suite_x0s),
        "K4 neighborhood (stream)": (dense_nb, B_SLICE, suite_x0s),
        "K5 h20 state box (shared)": (dense["dense-sc-h20-B2048"], B_SLICE, bench_x0s),
        "K5 h50 state box (stream)": (dense["dense-sc-h50-B2048"], B_SLICE, suite_x0s),
    }
    fused = lambda c, x: parallel.solve_batch_fused(c, x)
    prec_cells = {
        "h20-tier1-B16384": (ctrl, x0s, fused, fused_sols["h20-tier1-B16384"]),
        "state-constrained-B2048": (ctrl_sc, x_bench, parallel.solve_batch_auto, sol_sc),
        **{cell: (c, dense_x0s[cell][0], fused, dense_sols[cell]) for cell, c in dense.items()},
    }
    prec_recs, prec_counts = precision_phase(dev, prec_kernels, prec_cells)

    # 4j. K1's and K2's stream route: each kernel against its plain version
    # at the widths past the shared routes, then the three cells that
    # raised on the card before it, fused against the general engine,
    # counted from zero
    stream_recs, stream_counts = stream_phase(dev)

    # 4k. K4's and K5's wide route: each kernel against its plain version at
    # the dense shapes past the shared and stream routes, then the h100
    # cells that raised before it, fused against the general engine, and
    # the (32, 1) plant's K4 cell, counted from zero
    wide_recs, wide_counts = wide_phase(dev)

    # where the time goes in each cell (after the counts: these launches
    # are not the paths' runs)
    for cell, fn, reps in (
        ("h20-B16384-escalated", esc_solve, 5),
        ("suite-equality-B2048", lambda: parallel.solve_batch_auto(ctrl_eq, x_suite), 5),
        ("suite-neighborhood-B2048", lambda: parallel.solve_batch_auto(ctrl_nb, x_suite), 5),
        ("state-constrained-B2048", lambda: parallel.solve_batch_auto(ctrl_sc, x_bench), 2),
        ("riccati-h500-B1024", lambda: parallel.solve_batch_auto(ctrl_h500, x_h500), 3),
        ("riccati-h50-B4096", lambda: parallel.solve_batch_auto(ctrl_h50, x_h50), 3),
        *((cell, lambda c=c, x=dense_x0s[cell][0]: parallel.solve_batch_fused(c, x), 3)
          for cell, c in dense.items()),
        ("general-h20-default-B4096", lambda: parallel.solve_batch(ctrl_def, x0s[:B_CL]), 3),
        ("general-h20-default-B1", lambda: parallel.solve_batch(ctrl_def, x0s[:1]), 5),
    ):
        rec = profile(fn, reps)
        if cell in ricc_recs:  # the driver's device operations around each K3 launch
            rec["device_ops_per_chunk"] = (
                rec["device_ops_per_call"] / ricc_recs[cell]["k3_launches_per_solve"]
            )
        if cell in dense_recs:
            rec["device_ops_per_chunk"] = (
                rec["device_ops_per_call"] / dense_recs[cell]["launches_per_solve"]
            )
        log(phase="profile", cell=cell, reps=reps, **rec)

    # 256 lanes of each path re-solved with the kernel and with its plain
    # version on the card
    plain_resolve(parallel, ctrl, x0s[:B_RESOLVE], "K1 tier1",
                  admm_fused.chunk_fn_for(ctrl.engine.op, plain=True))
    plain_resolve(parallel, fb, x0s[:B_RESOLVE], "K1 tier2",
                  admm_fused.chunk_fn_for(fb.engine.op, plain=True))
    plain_resolve(parallel, ctrl_sc, x_bench[:B_RESOLVE], "K2 state-constrained",
                  admm_fused.chunk_fn_for(ctrl_sc.engine.op, plain=True))
    plain_resolve(parallel, ctrl_h50, x_h50[:B_RESOLVE], "K3 h50",
                  riccati_fused.iterate_chunk_riccati_plain)
    for cell, label in (("dense-eq-h20-B2048", "K4 dense h20 equality"),
                        ("dense-sc-h50-B2048", "K5 dense h50 state box")):
        c = dense[cell]
        plain_resolve(parallel, c, dense_x0s[cell][0][:B_RESOLVE], label,
                      admm_fused.chunk_fn_for(c.engine.op, plain=True, config=c.engine.config))

    log(phase="seconds", total=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [
        dict(kernel_entry("admm_diag_chunk (K1)", "admm_diag.cu", f"{TPU_ADMM}:348",
                          k1_launches + general_counts["K1"] + k1_learned
                          + sharded_counts["K1"], k1_shapes),
             smem_floor_ms=k1_shapes[0]["smem_floor_ms"],
             layouts=sorted(k1_layouts)),
        dict(kernel_entry("admm_mixed_chunk (K2)", "admm_mixed.cu", f"{TPU_ADMM}:580",
                          k2_launches, k2_shapes),
             smem_floor_ms=k2_shapes[0]["smem_floor_ms"],
             layouts=sorted(k2_layouts)),
        dict(kernel_entry("riccati_admm_chunk (K3)", "riccati_chunk.cuh", f"{TPU_RICCATI}:60",
                          k3_counts["K3"] + general_counts["K3"] + ctrl_counts["K3"]
                          + sharded_counts["K3"], k3_shapes),
             routes=sorted({rec["route"] for rec in k3_shapes}),
             tiers=sorted({(rec["nx"], rec["nu"]) for rec in k3_shapes})),
        # the driver's rollouts and certificate recursion (lax.scan there)
        kernel_entry("riccati_rollout (K3 driver)", "riccati_admm.cu", f"{TPU_RICCATI}:352",
                     k3_counts["rollout"] + general_counts["rollout"] + ctrl_counts["rollout"]
                     + sharded_counts["rollout"], rollout_recs),
        kernel_entry("riccati_certificate (K3 driver)", "riccati_admm.cu", f"{TPU_RICCATI}:384",
                     k3_counts["certificate"] + general_counts["certificate"]
                     + ctrl_counts["certificate"] + sharded_counts["certificate"], cert_recs),
        dict(kernel_entry("admm_packed_chunk (K4)", "admm_perr.cu", f"{TPU_ADMM}:252",
                          dense_counts["K4"], k4_shapes),
             smem_floor_ms=k4_shapes[0]["smem_floor_ms"],
             routes={"shared": "admm_packed_chunk", "stream": "admm_packed_stream_chunk",
                     "wide": "admm_packed_wide_chunk"}),
        dict(kernel_entry("admm_perr_chunk (K5)", "admm_perr.cu", f"{TPU_ADMM}:778",
                          dense_counts["K5"], k5_shapes),
             smem_floor_ms=k5_shapes[0]["smem_floor_ms"],
             routes={"shared": "admm_perr_chunk", "stream": "admm_perr_stream_chunk",
                     "wide": "admm_perr_wide_chunk"}),
        # the per-lane engine's XLA sweeps (no pallas_call there): K3W
        # past (32, 16), its doubling form under parallel_sweeps, and the
        # wide recurrences
        dict(kernel_entry("riccati_wide_seq_chunk (K3W)", "riccati_wide_seq.cu",
                          f"{TPU_RICCATI_XLA}:377", k3w_counts["K3W"] + ctrl_counts["K3W"],
                          k3w_seq + k3w_wide),
             routes=sorted({rec["route"] for rec in k3w_seq + k3w_wide}),
             layouts=sorted({(rec["layout"]["route"], rec["layout"]["ring"],
                              rec["layout"]["lanes"]) for rec in k3w_seq + k3w_wide}),
             chain_floor_ms=k3w_seq[0]["chain_floor_ms"]),
        kernel_entry("riccati_wide_chunk (K3W-doubling)", "riccati_wide.cu",
                     f"{TPU_RICCATI_XLA}:444", k3w_counts["K3W-doubling"], k3w_dbl),
        dict(kernel_entry("riccati_wide_rollout", "riccati_wide_rec.cu",
                          f"{TPU_RICCATI_XLA}:562",
                          k3w_counts["rollout-wide"] + ctrl_counts["rollout-wide"], rollout_w),
             chain_floor_ms=rollout_w[0]["chain_floor_ms"]),
        dict(kernel_entry("riccati_wide_certificate", "riccati_wide_rec.cu",
                          f"{TPU_RICCATI_XLA}:515",
                          k3w_counts["certificate-wide"] + ctrl_counts["certificate-wide"],
                          cert_w),
             chain_floor_ms=cert_w[0]["chain_floor_ms"]),
        # the bf16 precisions' instantiations of K1, K2, K4 and K5 (the
        # precisions' phase)
        *(dict(kernel_entry(f"{entry} ({kernel}, {mode})", source, f"{TPU_ADMM}:{line}",
                            prec_counts[f"{kernel}-{mode}"], prec_recs[(kernel, mode)]),
               highest_ms=prec_recs[(kernel, mode)][0]["highest_ms"],
               fp32_floor_ms=prec_recs[(kernel, mode)][0]["fp32_floor_ms"],
               **({"routes": sorted({r["plan"]["route"] for r in prec_recs[(kernel, mode)]})}
                  if kernel in ("K4", "K5") else {}))
          for kernel, entry, source, line in (
              ("K1", "admm_diag_chunk", "admm_diag.cu", 348),
              ("K2", "admm_mixed_chunk", "admm_mixed.cu", 580),
              ("K4", "admm_packed_chunk", "admm_perr.cu", 252),
              ("K5", "admm_perr_chunk", "admm_perr.cu", 778))
          for mode in ("bf16x3", "default")),
        # K1's and K2's stream route (the stream route's phase): the widths
        # the Pallas bodies take past the shared routes
        *(dict(kernel_entry(f"{entry} ({kernel}, stream route)", "admm_diag_stream.cu",
                            f"{TPU_ADMM}:{line}", stream_counts[kernel], stream_recs[kernel]),
               layouts=sorted({(r["plan"]["lanes"], r["lanes_per_thread"], r["plan"]["groups"],
                                r["plan"].get("rpt", r["plan"].get("rpt_n")), r["plan"]["panel"])
                               for r in stream_recs[kernel]}))
          for kernel, entry, line in (("K1", "admm_diag_stream_chunk", 348),
                                      ("K2", "admm_mixed_stream_chunk", 580))),
        # K4's and K5's wide route (the wide route's phase): the dense shapes
        # the Pallas bodies take past the shared and stream routes
        *(dict(kernel_entry(f"{entry} ({kernel}, wide route)", "admm_perr_wide.cu",
                            f"{TPU_ADMM}:{line}", wide_counts[kernel], wide_recs[kernel]),
               smem_floor_ms=wide_recs[kernel][0]["smem_floor_ms"],
               layouts=sorted({tuple(r["plan"][k] for k in (
                   "lanes", "rt_pass", "lt_pass", "rt", "lt", "depth", "cluster", "panel"))
                               for r in wide_recs[kernel]}))
          for kernel, entry, line in (("K5", "admm_perr_wide_chunk", 778),
                                      ("K4", "admm_packed_wide_chunk", 252))),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
