"""A/B timing of K3 and the certificate kernel, or of K2, K1, K5, K4 or
K3W, across source trees, or of K3 against K3W in one tree, on one NVIDIA
GPU, in one process tree (so on one card, under one power limit).

    python3 k3_ab.py NAME=TREE[:ROUTE] [NAME=TREE[:ROUTE] ...] [--sass NAME]
    python3 k3_ab.py --kernel K2 NAME=TREE[:LxG] [...] [--plain NAME] [--sass NAME]
    python3 k3_ab.py --kernel K1 NAME=TREE[:LxG[rR][s][/PANEL]] [...] [--plain NAME] [--sass NAME]
    python3 k3_ab.py --kernel K5 NAME=TREE[:LAYOUT] [...] [--plain NAME] [--sass NAME]
    python3 k3_ab.py --kernel K4 NAME=TREE[:LAYOUT] [...] [--plain NAME] [--sass NAME]
    python3 k3_ab.py --kernel K3W NAME=TREE[:LAYOUT] [...] [--plain NAME]
    python3 k3_ab.py --kernel K3W-doubling NAME=TREE[:LAYOUT] [...] [--plain NAME]
    python3 k3_ab.py --kernel K3-K3W NAME=TREE [...]
    python3 k3_ab.py --kernel wide-rec NAME=TREE[:LAYOUT] [...] [--plain NAME]

Each TREE is a directory that holds the port's package (this checkout is
"."; an earlier commit unpacked with ``git archive`` is another). The specs
run in the order given, each in a child process that imports the package
from its tree, builds the tree's kernels on first use (into the tree's own
build/), and times K3 on the inputs chip_smoke.py's compare_k3 uses (the
QTP plant, suite config 6's states, seeded noise of 0.05) at

- h500, no state rows, B=1024 (the riccati-h500-B1024 cell's chunk);
- h500 with the state box, B=1024;
- h50 with the state box, the contractive ball and the equality terminal,
  B=1024; h50, no state rows, B=4096 (the riccati-h50-B4096 cell's chunk);

and the certificate and rollout kernels at h500, B=1024. ROUTE forces one
of ``riccati_fused.K3_ROUTES`` in a tree that has them; a shape the route
does not fit is skipped. Times are CUDA-event means over 20 launches after
a warm-up (5 at h500). Each child also prints a SHA-256 of every output, so
that trees can be held to each other bit for bit without the plain version;
``--plain NAME`` also runs the plain version once per shape in that tree,
compares, and (``--kernel``) times it (``plain_ms``, 2 calls after one). A spec that fails is reported and the next one runs; the exit
code is 1 if any failed. ``--sass NAME`` writes the SASS of that tree's (4, 2) K3 kernels to
sass_NAME.txt under ``--sass-dir`` (default build/sass; cuobjdump). ``--shapes`` keeps only the named
shapes. A tree that has the chain-floor probe (riccati_chain_floor: one warp
running only the dependent instructions of the two horizon loops) reports
its time for an h500 chunk as chain_floor_ms.

With ``--kernel K2`` each tree's ``csrc/admm_mixed.cu`` alone is built
first, all trees at once (one nvcc each, into the tree's build/k2ab/), and
each child times K2 on chip_smoke.py's ``kernel_inputs`` at the shapes of
K2_SHAPES (n = 40; m = 120 at B = 2048, tier 2's m = 120 at B = 512, the
suite's m = 44 and 52, m = 132, and ragged B = 1, 33, 77, 1000), each with
random rho indices and with every lane at the config's start index, timed
as a CUDA graph of 20 launches replayed 5 times (the median: device time
alone, ``ms``) and as 20 launches through the wrapper (``wrapper_ms``). LxG
forces K2's lanes and row-groups per block (``admm_fused.k2_plan``) in a
tree that has a plan; a layout that does not fit is skipped. A tree that
fails to build is reported and skipped. ``--sass NAME`` writes the SASS of
that tree's K2 kernels to sass_NAME.txt.

``--kernel K1`` does the same for K1 with each tree's ``csrc/admm_diag.cu``
(into build/k1ab/), at the shapes of K1_SHAPES: tier 1 (n = 40, R = 2, no
refinement) at the headline's B = 16384 and the closed loop's 4096, tier 2
(R = 4, 2 refinements) at its bucket of 512 and ragged B = 1, 33, 77, 1000,
and the h50 box-only operator (n = 100) at tier 1, B = 2048; LxG forces
``admm_fused.k1_plan``'s layout. A tree's wrapper calls its own C entry,
whose parameters may differ from this checkout's.

Both also time their stream route (``csrc/admm_diag_stream.cu``, built
beside each into the same library where a tree has it) at the shapes past
their shared routes: K1_STREAM_SHAPES (the QTP at h50 at the routing
audit's config and its tier 2, h100, the (16, 8) plant at h30, h264 at
tier 1's grid) and K2_STREAM_SHAPES (the h50 state box); a tree without
it has no layout there and reports them skipped. LxG forces the stream
route's lanes and row-groups there too; ``rR`` the rows a thread takes
(``32x28r8``), ``LxGs`` the stream route at every shape (``s`` alone:
the plan's layout on it), and ``/PANEL`` (after either) its panel's
doubles, resident or streamed as the layout makes them, in a tree whose
stream route reads 4-byte entries. On the stream
route each record also has the plan's L2 operator bytes a chunk
(``l2_bytes``), the FMA floor (``fma_floor_ms``: the fp64 multiply-adds
at 64 a clock on every SM) and the register tile's shared-memory floor
(``tile_floor_ms``), where the tree's chip_smoke.py has them.

``--kernel K5`` does the same for K5, the dense-A per-rho kernel, with
each tree's K5 sources (``csrc/admm_perr.cu`` where the tree has it;
``csrc/admm_dense.cu``, whose admm_dense_perr_chunk is the older trees'
K5) built into one library (build/k5ab/), at the shapes of
K5_SHAPES: the h20 state box (n = 40, m = 120, R = 5, refine 1) with its
rows first (chip_smoke.rows_first) at B = 2048 and ragged B = 1, 33, 77,
1000, its tier-2 escalation (R = 4, refine 2) at B = 512, and the h50
state box (n = 100, m = 300) at B = 2048. LAYOUT forces
``admm_fused.k5_plan``'s: ``LxG`` lanes and row-groups, with a suffix
``h`` (the shared route) or ``s`` (the stream route; ``s/PANEL`` also
forces the doubles of its operator panel), or a suffix alone.

``--kernel K4`` does the same for K4, the dense-A packed kernel (each
tree's ``csrc/admm_perr.cu``, whose PACKED instantiations are K4, and
``csrc/admm_dense.cu``, the older trees' K4, into build/k4ab/), at the
shapes of K4_SHAPES, each with its rows first: the h20 equality terminal
(n = 40, m = 44, R = 5, refine 1) at B = 2048 and 77, its tier-2
escalation (R = 4, refine 2) at B = 512, the h20 state box at tier 1's
grid (m = 120, R = 2, no refinement) and the neighborhood terminal (m =
52, K4's stream route), B = 2048. LAYOUT forces ``admm_fused.k4_plan``'s
as K5's. In a tree that has K5's wrapper each shape also times K5 on the
same inputs and operator (``k5_ms``): the two kernels' view of the packed
/ per-rho split on this card (they round differently, so only the time
per chunk compares).

Both also time their wide route (``csrc/admm_perr_wide.cu``, built beside
``admm_perr.cu`` into the same library where a tree has it) at the dense
shapes past the shared and stream routes, each with its rows first:
K5_WIDE_SHAPES (the QTP's h100 state box and equality terminal at the
suite's config, B = 2048; its h154 state box and h228 equality terminal
at tier 1's grid, B = 1024) and K4_WIDE_SHAPES (the (32, 1) plant's h20
state box at tier 1's grid, B = 2048); a tree without it has no layout
there and reports them skipped (the K4 shape it skips). LAYOUT
``Lw[pRxL][sRxL][dD][cC][/PANEL]`` forces the wide route's lanes a
block, the pass's and the other products' register tiles (rows x lanes a
thread), the ring's depth, the blocks of a cluster and the doubles of an
fp64 panel (``w`` alone: the wide route at any shape;
``32wp2x2s4x4d2c2``); each wide
record carries the plan's L2 operator bytes a chunk (``l2_bytes``), the FMA
floor and the register tiles' floor.

``--kernel K3W`` times K3W's sequential form (each tree's
``csrc/riccati_wide.cu`` and, where the tree has it,
``csrc/riccati_wide_seq.cu``, built into build/k3wab/) at K3W_SHAPES: the
(64, 32) plant's h30 chunk at the riccati-wide-nx64 cell's B = 1024 and at
a step's B = 1, the (32, 16) plant's h30 chunk at the riccati-wide-nx32
cell's B = 2048, a bucket of 256 and B = 1, and the (40, 20) plant's h10
state box at B = 77. LAYOUT forces ``riccati_fused.k3w_plan``'s route
("shared", "device" or "global"), and in a tree whose plan takes them
the ring and the lanes a block: ``ROUTE[/RING][xLANES]``. ``--plain NAME``
holds that tree's outputs to the plain version and times it.

``--kernel K3W-doubling`` times K3W's doubling form (each tree's whole
library, built for every tree at once before the first child runs) at
DOUBLING_SHAPES, the shapes of the port's doubling paths on the QTP: h500
at the riccati-h500-B1024-doubling cell's B = 1024 and the runtime's step
(B = 1), h50 with the state box and with the contractive ball at B =
1024, h24 at B = 77, and h50 with the state box at B = 77 with every lane
array in device memory (the route "global" in a tree whose plan has it,
else "device", the older doubling form's device scratch); and two wider
plants, the (64, 32) plant's h30 at B = 1024 and the (40, 20) plant's
h10 state box at B = 77. Each record has the plan, the outputs' SHA-256,
``ms`` (CUDA events over 10 launches after one) and, where K3 takes the
plant, ``k3_ms``, K3 on the same inputs (the sequential chunk the
doubling form must beat); ``--plain NAME`` also holds that tree's
outputs to the plain version and times it. LAYOUT forces the plan, in a
tree whose k3w_plan takes it, as ``ROUTE[/RING][xLANES][tLT][nTHREADS]
[pPANEL]`` (``device/2x8t4n256``); an older tree takes the route alone.

``--kernel K3-K3W`` times K3 against K3W's sequential form in each tree
(its whole library, as the package builds it) on the same inputs at
AB_SHAPES, each of K3's register tiers at its widest plant (the QTP at h500
and h50; the (8, 4), (16, 8) and (32, 16) plants at h30) and the batches the
drivers launch (1 to 4096): the two kernels' times, whether their outputs
are equal bit for bit, the faster one, and the one the tree's
``riccati_fused.chunk_kernel`` routes the shape to.

``--kernel wide-rec`` times the drivers' wide rollout and certificate
(``riccati_fused.rollout_wide`` / ``certificate_terms_wide``; each tree's
whole library, built for every tree at once first) at WIDE_REC_SHAPES: the
(64, 32) plant's h30 at the riccati-wide-nx64 cell's B = 1024 and a step's
B = 1, the (32, 16) plant's h30 at the riccati-wide-nx32 cell's B = 2048,
a bucket of 256 and B = 1, and the (40, 20) plant's h10 state box at B =
77, on seeded inputs (the certificate's Xbar is the plain zero-input
rollout, the same bits in every tree). Each record has the tree's plans,
SHA-256s of the rollout's X, of the certificate's rows 0 and 2 (bit-equal
across trees) and of its row 1 (its long fp64 sums may be taken in
another order), ``rollout_ms`` / ``certificate_ms`` (CUDA events around a
CUDA graph of 20 launches, replayed for 0.3 s first so that the card
leaves its idle clock, then the median of 10 replays: device time alone;
``*_sm_mhz`` the SM clock just after) and ``*_wrapper_ms`` (20 launches
through the wrapper, host included); where K3
takes the plant, K3's rollout and certificate on the same inputs
(``k3_*_ms``, and whether their outputs equal the wide ones'). ``--plain
NAME`` also holds that tree's outputs to the plain versions and times
them. LAYOUT forces ``riccati_fused.wide_recurrence_plan``'s layout on both
kernels in a tree that has it, as ``[PLACE][/ROUTE][xLANES][rRT][lLT]
[nTHREADS]`` (``fp32x8r2l2``, ``/device``).

List a tree twice (first and last) to see the drift within the call. The
last line is a JSON object of all records.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

SHAPES = (  # name, horizon, B, controller options, launches timed
    ("h500-none-B1024", 500, 1024, {}, 5),
    ("h500-state-B1024", 500, 1024, {"mpc_state_constraint": True}, 5),
    ("h50-state-B1024", 50, 1024, {"mpc_state_constraint": True}, 20),
    ("h50-contractive-B1024", 50, 1024, {"mpc_terminal_ingredient": "contractive"}, 20),
    ("h50-equality-B1024", 50, 1024, {"mpc_terminal_ingredient": "equality"}, 20),
    ("h50-none-B4096", 50, 4096, {}, 20),
)


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chain_floor_ms(lib, N, nx, nu, chunk, dev):
    """Milliseconds of one warp running K3's dependent instructions for
    N x chunk sweep steps and as many rollout steps, from registers."""
    import torch

    io = torch.full((34,), 0.5, dtype=torch.float32, device=dev)

    def launch():
        err = lib.riccati_chain_floor(io.data_ptr(), N, nx, nu, chunk,
                                      torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"riccati_chain_floor launch failed: cudaError_t {err}")

    return _ms(launch, 5)


def child(tree, route, plain, sass, sass_dir, shapes):
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch import proceed_controller
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp
    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build, riccati, riccati_fused
    from automationlabsmodelpredictivecontrol_jl_torch.ops.riccati import RiccatiConfig

    dev = torch.device("cuda", 0)
    lib = _build.load_kernels()
    if sass:
        text = subprocess.run(["cuobjdump", "-sass", _build.LIB_PATH], capture_output=True,
                              text=True, check=True).stdout
        parts = text.split("\t\tFunction : ")
        keep = [p for p in parts[1:] if "riccati_admm_chunk" in p.split("\n", 1)[0]
                and "Li4ELi2" in p.split("\n", 1)[0]]
        os.makedirs(sass_dir, exist_ok=True)
        with open(os.path.join(sass_dir, f"sass_{sass}.txt"), "w") as f:
            f.write("\n\t\tFunction : ".join([""] + keep))
    plant = qtp.linearized_discrete_system()
    records = []
    for name, N, B, kw, reps in SHAPES:
        if shapes and name not in shapes:
            continue
        ctrl = proceed_controller(
            plant, "model_predictive_control", N, 5.0, [0.65] * 4, [1.2] * 2,
            riccati_config=RiccatiConfig(max_iter=1000), device=dev, engine="riccati", **kw,
        )
        op = ctrl.engine.op
        rng = np.random.default_rng(0)
        x0s = np.clip(0.65 + 0.1 * rng.standard_normal((B, 4)), 0.3, 1.3).astype(np.float32)
        e0T = (torch.from_numpy(x0s).to(dev) - ctrl.tuning.references.x[:, 0]).T.contiguous()
        rng = np.random.default_rng(8)
        noise = lambda *shape: torch.from_numpy(
            (0.05 * rng.standard_normal(shape)).astype(np.float32)).to(dev)
        ridx = torch.tensor([riccati._initial_ridx(op, ctrl.engine.config)],
                            dtype=torch.int32, device=dev)
        ballr = riccati.ball_radius(op, e0T)
        state = (noise(N + 1, 4, B), noise(N, 2, B), noise(N + 1, 4, B), noise(N, 2, B))
        args = (op, ridx, e0T, ballr, *state, int(ctrl.engine.config.check_interval))
        rec = dict(shape=name)
        if route is None:
            fn = lambda: riccati_fused.iterate_chunk_riccati(*args)
            if hasattr(riccati_fused, "k3_plan"):
                rec["plan"] = riccati_fused.k3_plan(op, B)._asdict()
        else:
            try:
                rec["plan"] = riccati_fused.k3_plan(op, B, route)._asdict()
            except ValueError as err:
                records.append(dict(rec, skipped=str(err)))
                continue
            fn = lambda: riccati_fused._launch_k3(*args, route=route)
        out = fn()
        torch.cuda.synchronize()
        rec["sha256"] = _digest(out)
        if plain:
            want = riccati_fused.iterate_chunk_riccati_plain(*args)
            rec["equals_plain"] = all(
                torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(out, want))
        rec["ms"] = _ms(fn, reps)
        if name == "h500-none-B1024":  # the driver's two recurrences at the cell's shape
            lamX, lamU = state[2], state[3]
            lamX2, lamU2 = lamX + 0.01 * lamX.flip(0), lamU - 0.02 * lamU.flip(0)
            Xbar = riccati_fused.rollout(op, e0T, state[1])
            cert = lambda: riccati_fused.certificate_terms(op, lamX2, lamX, lamU2, lamU, Xbar, ballr)
            rec["certificate_sha256"] = _digest([cert()])
            rec["certificate_ms"] = _ms(cert, 20)
            rec["rollout_ms"] = _ms(lambda: riccati_fused.rollout(op, e0T, state[1]), 20)
            if hasattr(lib, "riccati_chain_floor"):
                rec["chain_floor_ms"] = chain_floor_ms(lib, N, 4, 2, args[-1], dev)
        records.append(rec)
    print("K3_AB " + json.dumps(records), flush=True)

K2_SHAPES = (  # name, controller options, initial states, B, tier-2 fallback, seed
    ("m120-B2048", {"mpc_state_constraint": True}, "bench", 2048, False, 3),
    ("m120-tier2-B512", {"mpc_state_constraint": True}, "bench", 512, True, 7),
    ("m44-B2048", {"mpc_terminal_ingredient": "equality"}, "suite", 2048, False, 4),
    ("m52-B2048", {"mpc_terminal_ingredient": "neighborhood"}, "suite", 2048, False, 5),
    ("m132-B2048", {"mpc_state_constraint": True, "mpc_terminal_ingredient": "neighborhood"},
     "bench", 2048, False, 6),
    ("m120-B1", {"mpc_state_constraint": True}, "bench", 1, False, 20),
    ("m120-B33", {"mpc_state_constraint": True}, "bench", 33, False, 21),
    ("m120-B77", {"mpc_state_constraint": True}, "bench", 77, False, 22),
    ("m120-B1000", {"mpc_state_constraint": True}, "bench", 1000, False, 23),
)
# name, horizon, initial states, B, tier-2 fallback, seed: tier 1 (rho grid
# (1, 10), no refinement) at the headline's B and the closed loop's, tier
# 2's bucket and ragged buckets (grid (0.1, 1, 10, 100), 2 refinements),
# and the box-only operator of another width (h50, n = 100) at tier 1
K1_SHAPES = (
    ("tier1-B16384", 20, "bench", 16384, False, 1),
    ("tier2-B512", 20, "bench", 512, True, 2),
    ("closed-loop-B4096", 20, "bench", 4096, False, 30),
    ("tier2-B1", 20, "bench", 1, True, 31),
    ("tier2-B33", 20, "bench", 33, True, 32),
    ("tier2-B77", 20, "bench", 77, True, 33),
    ("tier2-B1000", 20, "bench", 1000, True, 34),
    ("h50-tier1-B2048", 50, "bench", 2048, False, 35),
)
# the stream route's K1 shapes (csrc/admm_diag_stream.cu; an older tree
# has no layout there and skips them): name, plant, horizon, config (the
# routing audit's AdmmConfig(max_iter=1000), or tier 1's), B, tier-2
# fallback, seed
K1_STREAM_SHAPES = (
    ("h50-default-B4096", "qtp", 50, "audit", 4096, False, 36),
    ("h50-tier2-B512", "qtp", 50, "audit", 512, True, 37),
    ("h100-default-B4096", "qtp", 100, "audit", 4096, False, 38),
    ("wide16x8-h30-B4096", "wide16x8", 30, "audit", 4096, False, 39),
    ("h264-tier1-B2048", "qtp", 264, "tier1", 2048, False, 40),
)
# and K2's: name, horizon, controller options, initial states, B, seed
K2_STREAM_SHAPES = (
    ("sc-h50-B2048", 50, {"mpc_state_constraint": True}, "bench", 2048, 41),
)
# name, horizon, tier-2 fallback, B, seed: the h20 state box with its rows
# first at the dense-sc-h20 cell's B and ragged batches, its tier-2
# escalation's bucket (grid (0.1, 1, 10, 100), 2 refinements; off the
# timed path) and the h50 state box (the dense-sc-h50 cell)
K5_SHAPES = (
    ("h20-B2048", 20, False, 2048, 50),
    ("h20-B1", 20, False, 1, 51),
    ("h20-B33", 20, False, 33, 52),
    ("h20-B77", 20, False, 77, 53),
    ("h20-B1000", 20, False, 1000, 54),
    ("h20-tier2-B512", 20, True, 512, 55),
    ("h50-B2048", 50, False, 2048, 56),
)
# name, controller options, grid (the suite's, tier 1's (1, 10) without
# refinement, or tier 2's escalation), initial states, B, seed: the
# dense-eq-h20 cell's K4, a ragged batch and its tier 2, the state box
# without refinement, the neighborhood terminal (the stream route)
K4_SHAPES = (
    ("eq-h20-B2048", {"mpc_terminal_ingredient": "equality"}, "suite", "suite", 2048, 60),
    ("eq-h20-B77", {"mpc_terminal_ingredient": "equality"}, "suite", "suite", 77, 62),
    ("eq-tier2-B512", {"mpc_terminal_ingredient": "equality"}, "tier2", "suite", 512, 63),
    ("sc-tier1-h20-B2048", {"mpc_state_constraint": True}, "tier1", "bench", 2048, 61),
    ("nb-h20-B2048", {"mpc_terminal_ingredient": "neighborhood"}, "suite", "suite", 2048, 64),
)
# the wide route's K5 shapes (csrc/admm_perr_wide.cu): name, horizon,
# controller options, grid (the suite's or tier 1's), initial states, B,
# seed; and K4's: the (32, 1) plant's h20 state box at tier 1's grid
K5_WIDE_SHAPES = (
    ("sc-h100-B2048", 100, {"mpc_state_constraint": True}, "suite", "suite", 2048, 70),
    ("eq-h100-B2048", 100, {"mpc_terminal_ingredient": "equality"}, "suite", "suite", 2048, 71),
    ("sc-h154-tier1-B1024", 154, {"mpc_state_constraint": True}, "tier1", "bench", 1024, 72),
    ("eq-h228-tier1-B1024", 228, {"mpc_terminal_ingredient": "equality"}, "tier1", "suite",
     1024, 73),
)
K4_WIDE_SHAPES = (
    ("sc32x1-h20-tier1-B2048", 20, {"mpc_state_constraint": True}, "tier1", "wide32", 2048, 74),
)
# K3W's sequential form across trees: name, plant (nx, nu), horizon,
# controller options, B, seed
K3W_SHAPES = (
    ("nx64-h30-B1024", (64, 32), 30, {}, 1024, 80),
    ("nx64-h30-B1", (64, 32), 30, {}, 1, 81),
    ("nx32-h30-B2048", (32, 16), 30, {}, 2048, 79),
    ("nx32-h30-B256", (32, 16), 30, {}, 256, 78),
    ("nx32-h30-B1", (32, 16), 30, {}, 1, 77),
    ("nx40-h10-state-B77", (40, 20), 10, {"mpc_state_constraint": True}, 77, 82),
)
# K3W's doubling form: name, plant (nx, nu), horizon, controller options,
# B, seed, every lane array in device memory
DOUBLING_SHAPES = (
    ("qtp-h500-B1024", (4, 2), 500, {}, 1024, 84, False),
    ("qtp-h500-B1", (4, 2), 500, {}, 1, 85, False),
    ("qtp-h50-state-B1024", (4, 2), 50, {"mpc_state_constraint": True}, 1024, 86, False),
    ("qtp-h50-ball-B1024", (4, 2), 50, {"mpc_terminal_ingredient": "contractive"}, 1024, 87,
     False),
    ("qtp-h24-B77", (4, 2), 24, {}, 77, 88, False),
    ("qtp-h50-state-B77-scratch", (4, 2), 50, {"mpc_state_constraint": True}, 77, 89, True),
    ("nx64-h30-B1024", (64, 32), 30, {}, 1024, 90, False),
    ("nx40-h10-state-B77", (40, 20), 10, {"mpc_state_constraint": True}, 77, 91, False),
)
# the drivers' wide rollout and certificate: name, plant (nx, nu), horizon,
# controller options, B, seed
WIDE_REC_SHAPES = (
    ("nx64-h30-B1024", (64, 32), 30, {}, 1024, 110),
    ("nx64-h30-B1", (64, 32), 30, {}, 1, 111),
    ("nx32-h30-B2048", (32, 16), 30, {}, 2048, 112),
    ("nx32-h30-B256", (32, 16), 30, {}, 256, 113),
    ("nx32-h30-B1", (32, 16), 30, {}, 1, 114),
    ("nx40-h10-state-B77", (40, 20), 10, {"mpc_state_constraint": True}, 77, 115),
)
# K3 against K3W in one tree: name, plant (nx, nu), horizon, the batches
AB_SHAPES = (
    ("qtp-h500", (4, 2), 500, (1, 256, 1024)),
    ("qtp-h50", (4, 2), 50, (1, 256, 1024, 4096)),
    ("nx8-h30", (8, 4), 30, (1, 256, 1024)),
    ("nx16-h30", (16, 8), 30, (1, 256, 1024)),
    ("nx32-h30", (32, 16), 30, (1, 256, 2048)),
)
ADMM_KERNELS = {  # the sources each tree builds alone (those it has), and their C entries
    "K1": (("admm_diag.cu", "admm_diag_stream.cu"), ("admm_diag_chunk", "admm_diag_stream_chunk")),
    "K2": (("admm_mixed.cu", "admm_diag_stream.cu"),
           ("admm_mixed_chunk", "admm_mixed_stream_chunk")),
    "K4": (("admm_perr.cu", "admm_dense.cu", "admm_perr_wide.cu"),
           ("admm_packed_chunk", "admm_packed_stream_chunk", "admm_dense_packed_chunk",
            "admm_perr_chunk", "admm_perr_stream_chunk", "admm_packed_wide_chunk",
            "admm_perr_wide_chunk")),
    "K5": (("admm_perr.cu", "admm_dense.cu", "admm_perr_wide.cu"),
           ("admm_perr_chunk", "admm_perr_stream_chunk", "admm_dense_perr_chunk",
            "admm_perr_wide_chunk")),
    "K3W": (("riccati_wide.cu", "riccati_wide_seq.cu"),
            ("riccati_wide_chunk", "riccati_wide_seq_chunk")),
}


def _admm_lib(tree, kernel):
    return os.path.join(os.path.abspath(tree), "build", f"{kernel.lower()}ab",
                        f"lib{kernel.lower()}.so")


def build_admm(trees, kernel):
    """nvcc each tree's sources of the kernel (K1: csrc/admm_diag.cu, K2:
    csrc/admm_mixed.cu, K4 and K5: those of csrc/admm_perr.cu and
    csrc/admm_dense.cu it has, K3W: csrc/riccati_wide.cu and
    csrc/riccati_wide_seq.cu) into a library of its own, one nvcc per
    tree, all at once, with this checkout's flags. Returns {tree: (seconds,
    report or None if it failed, error text)}."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build

    procs = {}
    for tree in trees:
        csrc = os.path.join(os.path.abspath(tree), "automationlabsmodelpredictivecontrol_jl_torch",
                            "csrc")
        srcs = [os.path.join(csrc, f) for f in ADMM_KERNELS[kernel][0]
                if os.path.exists(os.path.join(csrc, f))]
        lib = _admm_lib(tree, kernel)
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, *srcs]
        procs[tree] = (time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for tree, (t0, proc) in procs.items():
        text, _ = proc.communicate()
        out[tree] = (time.perf_counter() - t0, text if proc.returncode == 0 else None, text)
    return out


def _admm_cases(kernel, dev, shapes):
    """(name, controller, initial states, B, seed) of each shape of the
    kernel's table that ``shapes`` keeps, on the card."""
    import chip_smoke
    from automationlabsmodelpredictivecontrol_jl_torch import parallel, proceed_controller
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big, qtp
    from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig

    x0s = {"bench": chip_smoke.bench_x0s, "suite": chip_smoke.suite_x0s,
           "wide16x8": chip_smoke.wide16_x0s,
           "wide32": getattr(chip_smoke, "wide32_x0s", None)}
    tier2 = lambda c: parallel.escalation_controller(
        c, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250, refine_steps=2)
    design = lambda N, cfg, **kw: proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control", N, 5.0,
        [0.65] * 4, [1.2] * 2, admm_config=cfg, device=dev, **kw,
    )
    ctrls = {}
    t1 = AdmmConfig(max_iter=1000, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0)
    if kernel in ("K4", "K5"):  # the wide route's shapes
        for name, N, kw, grid, x0s_name, B, seed in (K4_WIDE_SHAPES if kernel == "K4"
                                                     else K5_WIDE_SHAPES):
            if (shapes and name not in shapes) or x0s[x0s_name] is None:
                continue  # not asked for, or an older tree (no wide route)
            cfg = t1 if grid == "tier1" else AdmmConfig(max_iter=1000)
            if x0s_name == "wide32":
                c = proceed_controller(
                    big.random_stable_system(32, 1, seed=0), "model_predictive_control", N, 5.0,
                    [0.0] * 32, [0.0], admm_config=cfg, device=dev, **kw)
            else:
                c = design(N, cfg, **kw)
            yield name, chip_smoke.rows_first(c), x0s[x0s_name], B, seed
    if kernel == "K4":
        for name, kw, grid, x0s_name, B, seed in K4_SHAPES:
            if shapes and name not in shapes:
                continue
            key = (tuple(sorted(kw.items())), grid == "tier1")
            if key not in ctrls:
                ctrls[key] = chip_smoke.rows_first(
                    design(20, t1 if grid == "tier1" else AdmmConfig(max_iter=1000), **kw))
            c = ctrls[key]
            yield name, tier2(c) if grid == "tier2" else c, x0s[x0s_name], B, seed
        return
    if kernel == "K5":
        for name, N, fallback, B, seed in K5_SHAPES:
            if shapes and name not in shapes:
                continue
            if N not in ctrls:
                ctrls[N] = chip_smoke.rows_first(
                    design(N, AdmmConfig(max_iter=1000), mpc_state_constraint=True))
            yield name, tier2(ctrls[N]) if fallback else ctrls[N], chip_smoke.bench_x0s, B, seed
        return
    if kernel == "K1":
        cfg = AdmmConfig(max_iter=75, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0)
        for name, N, x0s_name, B, fallback, seed in K1_SHAPES:
            if shapes and name not in shapes:
                continue
            if N not in ctrls:
                ctrls[N] = design(N, cfg)
            yield name, tier2(ctrls[N]) if fallback else ctrls[N], x0s[x0s_name], B, seed
        configs = {"audit": AdmmConfig(max_iter=1000), "tier1": cfg}
        for name, plant, N, config, B, fallback, seed in K1_STREAM_SHAPES:
            if shapes and name not in shapes:
                continue
            key = (plant, N, config)
            if key not in ctrls:
                ctrls[key] = design(N, configs[config]) if plant == "qtp" else proceed_controller(
                    big.random_stable_system(16, 8, seed=0), "model_predictive_control", N, 5.0,
                    [0.0] * 16, [0.0] * 8, admm_config=configs[config], device=dev)
            c = tier2(ctrls[key]) if fallback else ctrls[key]
            yield name, c, x0s["bench" if plant == "qtp" else plant], B, seed
        return
    cases = [(name, 20, kw, x0s_name, B, fallback, seed)
             for name, kw, x0s_name, B, fallback, seed in K2_SHAPES]
    cases += [(name, N, kw, x0s_name, B, False, seed)
              for name, N, kw, x0s_name, B, seed in K2_STREAM_SHAPES]
    for name, N, kw, x0s_name, B, fallback, seed in cases:
        if shapes and name not in shapes:
            continue
        key = (N,) + tuple(sorted(kw.items()))
        if key not in ctrls:
            ctrls[key] = design(N, AdmmConfig(max_iter=1000), **kw)
        yield name, tier2(ctrls[key]) if fallback else ctrls[key], x0s[x0s_name], B, seed


def _wide_spec(spec):
    """The k4_plan / k5_plan arguments a wide-route LAYOUT forces:
    ``Lw[pRxL][sRxL][dD][cC][/PANEL]``: lanes a block, the pass's and the
    other products' rows x lanes a thread, the ring's depth, the blocks of
    a cluster, the doubles of an fp64 panel; ``w`` alone the wide route at
    any shape."""
    import re

    m = re.fullmatch(r"(\d*)w(?:p(\d)x(\d))?(?:s(\d)x(\d))?(?:d(\d))?(?:c(\d))?"
                     r"(?:/(\d+))?", spec)
    if m is None:
        raise SystemExit(f"k3_ab.py: not a wide layout: {spec!r}")
    lanes, pr, pl, sr, sl, depth, cluster, panel = m.groups()
    force = dict(route="wide")
    if lanes:
        force["lanes"] = int(lanes)
    if pr or sr:
        plan_tiles = (int(pr), int(pl)) if pr else None, (int(sr), int(sl)) if sr else None
        if None in plan_tiles:
            raise SystemExit(f"k3_ab.py: a wide layout forces both tiles or neither: {spec!r}")
        force["tiles"] = plan_tiles
    if depth:
        force["depth"] = int(depth)
    if cluster:
        force["cluster"] = int(cluster)
    if panel:
        force["panel"] = int(panel)
    return force


def _fma_floor_ms(chip_smoke, n, m, B, refine_steps, chunk, kernel):
    """The FMA floor of one chunk: the tree's utils/roofline model where the
    tree has one, else its chip_smoke.py's."""
    try:
        from automationlabsmodelpredictivecontrol_jl_torch.utils import roofline
    except ImportError:
        return chip_smoke.fma_floor_ms(n, m, B, refine_steps, chunk, kernel)
    return roofline.fma_floor_ms(n, m, B, refine_steps, chunk, roofline.device_peaks(0),
                                 chip_smoke.sm_clock_hz(), kernel)


def child_admm(kernel, tree, layout, plain, sass, sass_dir, shapes):
    """Time K1, K2, K4 or K5 of one tree at its shapes; print one K1_AB,
    K2_AB, K4_AB or K5_AB line of records. Each tree's wrapper calls its
    own C entries with that tree's signatures (an older tree's entry takes
    other parameters)."""
    sys.path.insert(0, os.path.abspath(tree))
    import ctypes

    import torch

    import chip_smoke
    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build, admm_fused

    entries = [e for e in ADMM_KERNELS[kernel][1] if e in _build.SIGNATURES]
    lib = ctypes.CDLL(_admm_lib(tree, kernel))
    for entry_name in entries:
        entry = getattr(lib, entry_name)
        entry.restype = ctypes.c_int
        entry.argtypes = [_build._CTYPES[c] for c in _build.SIGNATURES[entry_name]]
    _build._lib = lib  # the wrappers launch from this library
    if sass:
        text = subprocess.run(["cuobjdump", "-sass", _admm_lib(tree, kernel)],
                              capture_output=True, text=True, check=True).stdout
        parts = text.split("\t\tFunction : ")
        keep = [p for p in parts[1:]
                if any(e.rsplit("_", 1)[0] in p.split("\n", 1)[0] for e in entries)]
        os.makedirs(sass_dir, exist_ok=True)
        with open(os.path.join(sass_dir, f"sass_{sass}.txt"), "w") as f:
            f.write("\n\t\tFunction : ".join([""] + keep))
    dev = torch.device("cuda", 0)
    force, panel, rows_forced = {}, "", 0
    if kernel in ("K1", "K2") and layout:  # LxG[rR][s][/PANEL]: rows a thread, the stream
        layout, _, panel = layout.partition("/")  # route, a panel forced
        if layout.endswith("s"):
            force, layout = dict(route="stream"), layout[:-1]
        layout, _, rows_text = layout.partition("r")
        rows_forced = int(rows_text or 0)
    if kernel == "K1":
        wrapper, plain_fn = admm_fused.iterate_chunk_diag_T, admm_fused.iterate_chunk_diag_T_plain
        plan_fn, launch = getattr(admm_fused, "k1_plan", None), getattr(admm_fused, "_launch_k1")
    elif kernel in ("K4", "K5"):
        if kernel == "K4":
            wrapper = admm_fused.iterate_chunk_dense_packed_T
            plain_fn = admm_fused.iterate_chunk_dense_packed_T_plain
        else:
            wrapper = admm_fused.iterate_chunk_dense_perr_T
            plain_fn = admm_fused.iterate_chunk_dense_perr_T_plain
        plan_fn = getattr(admm_fused, f"{kernel.lower()}_plan", None)
        launch = getattr(admm_fused, f"_launch_{kernel.lower()}", None)
        if layout and "w" in layout:  # the wide route: Lw[pRxL][sRxL][dD][r|t][cC][/PANEL]
            force, layout, panel = _wide_spec(layout), None, ""
        elif layout and "s" in layout:  # LxGs[/PANEL]: the stream route, a panel forced
            layout, _, panel = layout.partition("s")
            force, layout = dict(route="stream"), layout or None
        elif layout and layout[-1] == "h":
            force, layout = dict(route="shared"), layout[:-1] or None
    else:
        wrapper, plain_fn = admm_fused.iterate_chunk_mixed_T, admm_fused.iterate_chunk_mixed_T_plain
        plan_fn, launch = getattr(admm_fused, "k2_plan", None), getattr(admm_fused, "_launch_k2")
    records = []
    for name, ctrl, x0s_fn, B, seed in _admm_cases(kernel, dev, shapes):
        for single in (False, True):
            args = chip_smoke.kernel_inputs(ctrl, B, seed, x0s_fn, single)
            op, cfg = args[0], args[-1]
            m, n = (int(d) for d in op.A_s.shape)
            R, rs = int(op.rho_grid.shape[0]), int(cfg.refine_steps)
            rec = dict(shape=name, rho_index="single" if single else "random",
                       n=n, m=m, R=R, refine_steps=rs, B=B)
            fn = lambda: wrapper(*args)
            if plan_fn is not None:
                lanes, groups = (int(v) for v in layout.split("x")) if layout else (None, None)
                shape = (n, R, rs, B) if kernel == "K1" else (n, m, R, rs, B)
                wide_panel, forced = None, force
                if kernel in ("K4", "K5") and force.get("route") == "wide":
                    forced = dict(force)
                    wide_panel = forced.pop("panel", None)
                    lanes = forced.pop("lanes", None)
                try:
                    plan = plan_fn(*shape, lanes=lanes, groups=groups, **forced)
                except ValueError as err:
                    records.append(dict(rec, skipped=str(err)))
                    continue
                if wide_panel:
                    plan = plan._replace(panel=wide_panel, smem_bytes=admm_fused.wide_smem_bytes(
                        n, plan.lanes, wide_panel, plan.depth))
                if kernel in ("K4", "K5") and force.get("route") == "stream" and panel:
                    plan = plan._replace(panel=int(panel[1:]), smem_bytes=admm_fused.k5_stream_smem_bytes(
                        m, plan.lanes, plan.groups, plan.rpt_n, plan.rpt_m, int(panel[1:])))
                if kernel in ("K1", "K2") and rows_forced:
                    plan = plan._replace(**({"rpt": rows_forced} if kernel == "K1" else
                                            {"rpt_n": rows_forced, "rpt_t": rows_forced}))
                if kernel in ("K1", "K2") and panel:
                    plan = plan._replace(panel=int(panel), smem_bytes=admm_fused.k12_stream_smem_bytes(
                        n, m - n, plan.lanes, int(panel)))
                rec["plan"] = plan._asdict()
                if kernel in ("K1", "K2") and plan.route == "stream" and hasattr(
                        admm_fused, "k12_stream_l2_bytes"):
                    rows = plan.rpt if kernel == "K1" else plan.rpt_n
                    rec["l2_bytes"] = admm_fused.k12_stream_l2_bytes(
                        n, m - n, R, rs, B, plan.lanes, plan.groups, rows, plan.panel, args[-2])
                    rec["fma_floor_ms"] = _fma_floor_ms(chip_smoke, n, m, B, rs, args[-2], kernel)
                    rec["tile_floor_ms"] = chip_smoke.tile_floor_ms(n, m, B, rs, args[-2], plan)
                if plan.route == "wide" and hasattr(admm_fused, "wide_l2_bytes"):
                    packed = kernel == "K4"
                    rec["l2_bytes"] = admm_fused.wide_l2_bytes(n, m, R, rs, B, plan, args[-2],
                                                               packed)
                    rec["fma_floor_ms"] = _fma_floor_ms(chip_smoke, n, m, B, rs, args[-2], kernel)
                    rec["tile_floor_ms"] = chip_smoke.tile_floor_ms(n, m, B, rs, args[-2], plan,
                                                                    packed)
                fn = lambda plan=plan: launch(*args, plan=plan)
            out = fn()
            torch.cuda.synchronize()
            rec["sha256"] = _digest(out)
            if plain:
                want = plain_fn(*args)
                rec["max_ulps_vs_plain"] = max(
                    int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())
                    for a, b in zip(out, want))
                rec["plain_ms"] = _ms(lambda: plain_fn(*args), 2)
            rec["ms"] = chip_smoke.cuda_graph_ms(fn)
            rec["wrapper_ms"] = _ms(fn, 20)
            rec["smem_floor_ms"] = chip_smoke.smem_floor_ms(n, m, R, rs, B, args[-2], kernel)
            if kernel == "K4" and hasattr(admm_fused, "k5_plan"):  # the split: K5 on K4's inputs
                k5 = lambda: admm_fused._launch_k5(*args)
                rec["k5_plan"] = admm_fused.k5_plan(n, m, R, rs, B)._asdict()
                rec["k5_ms"] = chip_smoke.cuda_graph_ms(k5)
            records.append(rec)
    print(f"{kernel}_AB " + json.dumps(records), flush=True)


def _riccati_op(plant, N, kw, dev):
    """The Riccati operator of the QTP ((4, 2): suite config 6's design) or
    of ``big.random_stable_system(nx, nu, seed=0)`` (the wide cells'
    design: Q 10, R 0.1) at horizon N, on the card."""
    import numpy as np

    from automationlabsmodelpredictivecontrol_jl_torch import proceed_controller
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big, qtp
    from automationlabsmodelpredictivecontrol_jl_torch.ops.riccati import RiccatiConfig

    if plant == (4, 2):
        return proceed_controller(
            qtp.linearized_discrete_system(), "model_predictive_control", N, 5.0, [0.65] * 4,
            [1.2] * 2, riccati_config=RiccatiConfig(max_iter=1000), device=dev,
            engine="riccati", **kw).engine.op
    nx, nu = plant
    return proceed_controller(
        big.random_stable_system(nx, nu, seed=0), "model_predictive_control", N, 1.0,
        np.zeros(nx, np.float32), np.zeros(nu, np.float32), mpc_Q=10.0, mpc_R=0.1,
        engine="riccati", device=dev, **kw).engine.op


def _chunk_args(op, B, seed, dev):
    """A 25-iteration chunk's seeded inputs: e0 of 0.1 N(0, 1), the state of
    0.05 N(0, 1), the start rho."""
    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati

    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(
        (0.05 * rng.standard_normal(shape)).astype(np.float32)).to(dev)
    N, nx, nu = op.N, op.nx, op.nu
    e0T = 2.0 * t(nx, B)
    ridx = torch.tensor([riccati._initial_ridx(op, riccati.RiccatiConfig())], dtype=torch.int32,
                        device=dev)
    return (op, ridx, e0T, riccati.ball_radius(op, e0T), t(N + 1, nx, B), t(N, nu, B),
            t(N + 1, nx, B), t(N, nu, B), 25)


def _k3w_layout(riccati_fused, op, B, layout):
    """The keywords that force ``layout`` (ROUTE[/RING][xLANES]) on this
    tree's k3w_plan, and the plan; an older tree takes the route alone."""
    import inspect

    route, _, rest = (layout or "").partition("/")
    route, _, lanes = route.partition("x")
    ring, _, lanes2 = rest.partition("x")
    force = dict(route=route or None)
    if "ring" in inspect.signature(riccati_fused.k3w_plan).parameters:
        force.update(ring=int(ring) if ring else None,
                     lanes=int(lanes or lanes2) if (lanes or lanes2) else None)
    elif ring or lanes or lanes2:
        raise ValueError("this tree's k3w_plan takes no forced ring or lanes")
    return force, riccati_fused.k3w_plan(op, B, False, **force)


def child_k3w(kernel, tree, layout, plain, shapes):
    """K3W's sequential form of one tree at K3W_SHAPES (``kernel`` "K3W",
    from the tree's build/k3wab library), or K3 against it at AB_SHAPES
    ("K3-K3W", the tree's whole library); print one K3W_AB or K3-K3W_AB
    line of records."""
    sys.path.insert(0, os.path.abspath(tree))
    import ctypes

    import torch

    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build, riccati_fused

    dev = torch.device("cuda", 0)
    if kernel == "K3W":
        lib = ctypes.CDLL(_admm_lib(tree, kernel))
        for name in ADMM_KERNELS[kernel][1]:
            if name in _build.SIGNATURES:
                entry = getattr(lib, name)
                entry.restype = ctypes.c_int
                entry.argtypes = [_build._CTYPES[c] for c in _build.SIGNATURES[name]]
        _build._lib = lib  # the wrappers launch from this library
    else:
        _build.load_kernels()
    records = []
    if kernel == "K3W":
        for name, plant, N, kw, B, seed in K3W_SHAPES:
            if shapes and name not in shapes:
                continue
            op = _riccati_op(plant, N, kw, dev)
            args = _chunk_args(op, B, seed, dev)
            rec = dict(shape=name, nx=op.nx, nu=op.nu, N=N, B=B)
            try:
                force, plan = _k3w_layout(riccati_fused, op, B, layout)
            except ValueError as err:
                records.append(dict(rec, skipped=str(err)))
                continue
            rec["plan"] = plan._asdict()
            if "ring" in force:
                fn = lambda plan=plan: riccati_fused._launch_k3w(*args, plan=plan)
            else:
                fn = lambda: riccati_fused._launch_k3w(*args, route=force["route"])
            out = fn()
            torch.cuda.synchronize()
            rec["sha256"] = _digest(out)
            if plain:
                want = riccati_fused.iterate_chunk_riccati_plain(*args)
                rec["equals_plain"] = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                                          for a, b in zip(out, want))
                rec["plain_ms"] = _ms(lambda: riccati_fused.iterate_chunk_riccati_plain(*args), 1)
            rec["ms"] = _ms(fn, 10)
            records.append(rec)
    else:
        for name, plant, N, batches in AB_SHAPES:
            if shapes and name not in shapes:
                continue
            op = _riccati_op(plant, N, {}, dev)
            for i, B in enumerate(batches):
                args = _chunk_args(op, B, 90 + i, dev)
                k3 = lambda: riccati_fused._launch_k3(*args)
                k3w = lambda: riccati_fused._launch_k3w(*args)
                out3, outw = k3(), k3w()
                torch.cuda.synchronize()
                rec = dict(shape=name, nx=op.nx, nu=op.nu, N=N, B=B,
                           k3_plan=riccati_fused.k3_plan(op, B)._asdict(),
                           k3w_plan=riccati_fused.k3w_plan(op, B)._asdict(),
                           equal=all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                                     for a, b in zip(out3, outw)))
                rec["k3_ms"] = _ms(k3, 5)
                rec["k3w_ms"] = _ms(k3w, 5)
                rec["faster"] = "K3" if rec["k3_ms"] <= rec["k3w_ms"] else "K3W"
                if hasattr(riccati_fused, "chunk_kernel"):
                    rec["routed"] = riccati_fused.chunk_kernel(op)
                records.append(rec)
    print(f"{kernel}_AB " + json.dumps(records), flush=True)


def _dbl_layout(riccati_fused, op, B, layout, scratch):
    """The plan that ``layout`` (ROUTE[/RING][xLANES][tLT][nTHREADS][pPANEL])
    forces on this tree's doubling form (``scratch``: every lane array in
    device memory), and the keywords _launch_k3w takes for it; an older
    tree takes the route alone."""
    import inspect
    import re

    m = re.fullmatch(r"([a-z]*)(?:/(\d+))?(?:x(\d+))?(?:t(\d+))?(?:n(\d+))?(?:p(\d+))?",
                     layout or "")
    if m is None:
        raise ValueError(f"unknown doubling layout {layout!r}")
    route, ring, lanes, lt, threads, panel = (
        m.group(1) or None, *(int(g) if g else None for g in m.groups()[1:]))
    new = "lanes_per_thread" in inspect.signature(riccati_fused.k3w_plan).parameters
    if scratch:
        route = "global" if new else "device"
    if not new:
        if (ring, lanes, lt, threads, panel) != (None,) * 5:
            raise ValueError("this tree's doubling form takes no forced layout but its route")
        return riccati_fused.k3w_plan(op, B, True, route), dict(route=route)
    plan = riccati_fused.k3w_plan(op, B, True, route, lanes=lanes, ring=ring, threads=threads,
                                  lanes_per_thread=lt, panel=panel)
    return plan, dict(plan=plan)


def child_dbl(tree, layout, plain, shapes):
    """K3W's doubling form of one tree at DOUBLING_SHAPES beside K3 on the
    same inputs; print one K3W-doubling_AB line of records."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build, riccati_fused

    dev = torch.device("cuda", 0)
    _build.load_kernels()
    records = []
    for name, plant, N, kw, B, seed, scratch in DOUBLING_SHAPES:
        if shapes and name not in shapes:
            continue
        op = _riccati_op(plant, N, kw, dev)
        args = _chunk_args(op, B, seed, dev)
        rec = dict(shape=name, nx=op.nx, nu=op.nu, N=N, B=B)
        try:
            plan, force = _dbl_layout(riccati_fused, op, B, layout, scratch)
        except ValueError as err:
            records.append(dict(rec, skipped=str(err)))
            continue
        rec["plan"] = plan._asdict()
        fn = lambda: riccati_fused._launch_k3w(*args, doubling=True, **force)
        out = fn()
        torch.cuda.synchronize()
        rec["sha256"] = _digest(out)
        if plain:
            want = riccati_fused.iterate_chunk_riccati_doubling_plain(*args)
            rec["equals_plain"] = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                                      for a, b in zip(out, want))
            rec["plain_ms"] = _ms(
                lambda: riccati_fused.iterate_chunk_riccati_doubling_plain(*args), 1)
        rec["ms"] = _ms(fn, 10)
        if riccati_fused.k3_fits(op):
            rec["k3_ms"] = _ms(lambda: riccati_fused._launch_k3(*args), 10)
        records.append(rec)
    print("K3W-doubling_AB " + json.dumps(records), flush=True)


def _rec_layout(layout):
    """wide_recurrence_plan's keywords that LAYOUT ([PLACE][/ROUTE][xLANES]
    [rRT][lLT][nTHREADS]) forces."""
    import re

    m = re.fullmatch(r"([a-z0-9]*?)(?:/([a-z]+))?(?:x(\d+))?(?:r(\d+))?(?:l(\d+))?(?:n(\d+))?",
                     layout or "")
    if m is None:
        raise ValueError(f"unknown wide recurrence layout {layout!r}")
    place, route, lanes, rt, lt, threads = m.groups()
    force = dict(place=place or None, route=route, lanes=lanes, rows_per_thread=rt,
                 lanes_per_thread=lt, threads=threads)
    return {k: (int(v) if k not in ("place", "route") else v) for k, v in force.items()
            if v is not None}


def child_rec(tree, layout, plain, shapes):
    """The wide rollout and certificate of one tree at WIDE_REC_SHAPES, K3's
    beside them where K3 takes the plant; print one wide-rec_AB line of
    records."""
    import importlib.util

    # this checkout's timing helpers, whatever the tree: every tree is timed
    # the same way
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                          "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build, riccati, riccati_fused

    dev = torch.device("cuda", 0)
    _build.load_kernels()
    planned = hasattr(riccati_fused, "wide_recurrence_plan")
    force = _rec_layout(layout)
    records = []
    bits = lambda a, b: torch.equal(a.view(torch.int32), b.view(torch.int32))
    for name, plant, N, kw, B, seed in WIDE_REC_SHAPES:
        if shapes and name not in shapes:
            continue
        op = _riccati_op(plant, N, kw, dev)
        rng = np.random.default_rng(seed)
        t = lambda *shape: torch.from_numpy(
            (0.05 * rng.standard_normal(shape)).astype(np.float32)).to(dev)
        e0T, U = 2.0 * t(op.nx, B), t(N, op.nu, B)
        lamX = t(N + 1, op.nx, B)
        lamU = t(N, op.nu, B)
        lamX2, lamU2 = lamX + 0.01 * lamX.flip(0), lamU - 0.02 * lamU.flip(0)
        ballr = riccati.ball_radius(op, e0T)
        Xbar = riccati.rollout_warm(op, e0T, torch.zeros_like(U))
        rec = dict(shape=name, nx=op.nx, nu=op.nu, N=N, B=B)
        extra = {}, {}
        if planned:
            try:
                plans = [riccati_fused.wide_recurrence_plan(op, B, k, **force)
                         for k in ("rollout", "certificate")]
            except ValueError as err:
                records.append(dict(rec, skipped=str(err)))
                continue
            rec["rollout_plan"], rec["certificate_plan"] = (p._asdict() for p in plans)
            extra = dict(plan=plans[0]), dict(plan=plans[1])
        elif force:
            records.append(dict(rec, skipped="this tree's wide recurrences take no layout"))
            continue
        cargs = (op, lamX2, lamX, lamU2, lamU, Xbar, ballr)
        roll = lambda: riccati_fused._launch_rollout_wide(op, e0T, U, **extra[0])
        cert = lambda: riccati_fused._launch_certificate_wide(*cargs, **extra[1])
        X, T = roll(), cert()
        torch.cuda.synchronize()
        rec.update(rollout_sha256=_digest([X]), certificate_rows02_sha256=_digest([T[0], T[2]]),
                   certificate_row1_sha256=_digest([T[1]]))
        if plain:
            Xp = riccati.rollout_warm(op, e0T, U)
            Tp = riccati_fused.certificate_terms_plain(*cargs)
            rec.update(rollout_equals_plain=bits(X, Xp),
                       certificate_rows02_equal_plain=bits(T[0], Tp[0]) and bits(T[2], Tp[2]),
                       certificate_row1_max_rel_err=float(
                           ((T[1] - Tp[1]).abs() / Tp[1].abs().clamp_min(1.0)).max()))
            rec["rollout_plain_ms"] = _ms(lambda: riccati.rollout_warm(op, e0T, U), 2)
            rec["certificate_plain_ms"] = _ms(
                lambda: riccati_fused.certificate_terms_plain(*cargs), 2)
        warm = lambda fn: chip_smoke.cuda_graph_ms(fn, repeats=10, warm_s=0.3)
        rec["rollout_ms"] = warm(roll)
        rec["rollout_sm_mhz"] = chip_smoke.sm_clock_now_mhz()
        rec["certificate_ms"] = warm(cert)
        rec["certificate_sm_mhz"] = chip_smoke.sm_clock_now_mhz()
        rec["rollout_wrapper_ms"] = _ms(roll, 20)
        rec["certificate_wrapper_ms"] = _ms(cert, 20)
        if riccati_fused.k3_fits(op):  # K3's recurrences on the same inputs
            k3_roll = lambda: riccati_fused._launch_rollout(op, e0T, U)
            k3_cert = lambda: riccati_fused._launch_certificate(*cargs)
            X3, T3 = k3_roll(), k3_cert()
            torch.cuda.synchronize()
            rec.update(k3_rollout_equal=bits(X3, X),
                       k3_certificate_rows02_equal=bits(T3[0], T[0]) and bits(T3[2], T[2]))
            rec["k3_rollout_ms"] = warm(k3_roll)
            rec["k3_certificate_ms"] = warm(k3_cert)
            if hasattr(riccati_fused, "recurrence_kernel"):
                rec["routed"] = riccati_fused.recurrence_kernel(op)
        records.append(rec)
    print("wide-rec_AB " + json.dumps(records), flush=True)


def build_trees(trees):
    """Build each tree's whole kernel library (csrc/*.cu, one nvcc a source)
    into its own build/kernels, every tree at once. Returns {tree:
    (seconds, ok, output)}."""
    procs = {}
    for tree in trees:
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "from automationlabsmodelpredictivecontrol_jl_torch.ops import _build; "
                "print(_build.build_kernels())")
        procs[tree] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, "-c", code, os.path.abspath(tree)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for tree, (t0, proc) in procs.items():
        text, _ = proc.communicate()
        out[tree] = (time.perf_counter() - t0, proc.returncode == 0, text)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("specs", nargs="*",
                    help="NAME=TREE[:ROUTE] (K1, K2: NAME=TREE[:LxG]; K4, K5: NAME=TREE[:LAYOUT])")
    ap.add_argument("--kernel",
                    choices=("K3", "K2", "K1", "K5", "K4", "K3W", "K3W-doubling", "K3-K3W",
                             "wide-rec"),
                    default="K3",
                    help="the kernel timed")
    ap.add_argument("--plain", default=None, help="the spec name whose outputs are held to the plain version")
    ap.add_argument("--sass", action="append", default=[], help="spec names whose K3 SASS is written out")
    ap.add_argument("--sass-dir", default=os.path.join("build", "sass"),
                    help="where --sass writes")
    ap.add_argument("--shapes", default="", help="comma-separated shape names (default: all)")
    ap.add_argument("--child-timeout", type=float, default=1800.0,
                    help="seconds a spec's child may run before it counts as failed")
    ap.add_argument("--child", nargs=2, metavar=("TREE", "ROUTE"), help=argparse.SUPPRESS)
    ap.add_argument("--child-plain", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--child-sass", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        tree, route = a.child
        args = (tree, None if route == "-" else route, a.child_plain, a.child_sass,
                os.path.abspath(a.sass_dir), [s for s in a.shapes.split(",") if s])
        if a.kernel == "K3W-doubling":
            child_dbl(*args[:3], args[5])
        elif a.kernel == "wide-rec":
            child_rec(*args[:3], args[5])
        elif a.kernel in ("K3W", "K3-K3W"):
            child_k3w(a.kernel, *args[:3], args[5])
        elif a.kernel in ADMM_KERNELS:
            child_admm(a.kernel, *args)
        else:
            child(*args)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k3_ab.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    results, plained, dumped, failed = [], set(), set(), []
    tag = f"{a.kernel}_AB "
    built = {}
    if a.kernel in ("K3W-doubling", "wide-rec"):
        kinds = (("K3W-doubling",) if a.kernel == "K3W-doubling"
                 else ("rollout-wide", "certificate-wide"))
        trees = sorted({spec.partition("=")[2].partition(":")[0] for spec in a.specs})
        for tree, (secs, ok, text) in build_trees(trees).items():
            import chip_smoke
            rec = dict(tree=tree, nvcc_s=secs, built=ok)
            if ok:
                rec["ptxas"] = [(r["kernel"], r["template"], r["registers"], r["spill_bytes"])
                                for r in chip_smoke.ptxas_summary(text)
                                if r["kernel"] in kinds]
            else:
                rec["error"] = text[-4000:]
            built[tree] = (secs, text if ok else None, text)
            print(json.dumps(rec), flush=True)
    elif a.kernel in ADMM_KERNELS:
        trees = sorted({spec.partition("=")[2].partition(":")[0] for spec in a.specs})
        built = build_admm(trees, a.kernel)
        for tree, (secs, report, text) in built.items():
            rec = dict(tree=tree, nvcc_s=secs, built=report is not None)
            if report is None:
                rec["error"] = text[-4000:]
            else:  # registers and spills per instantiation
                import chip_smoke
                rec["ptxas"] = [(r["template"], r["registers"], r["spill_bytes"])
                                for r in chip_smoke.ptxas_summary(report)]
            print(json.dumps(rec), flush=True)
    for spec in a.specs:
        name, _, rest = spec.partition("=")
        tree, _, route = rest.partition(":")
        if built and built[tree][1] is None:
            print(f"k3_ab.py: {spec} skipped: its tree did not build", file=sys.stderr)
            failed.append(spec)
            continue
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree, route or "-",
               "--kernel", a.kernel, "--shapes", a.shapes, "--sass-dir", a.sass_dir]
        if a.plain == name and name not in plained:
            cmd.append("--child-plain")
            plained.add(name)
        if name in a.sass and name not in dumped:
            cmd += ["--child-sass", name]
            dumped.add(name)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=a.child_timeout)
        except subprocess.TimeoutExpired as err:
            print(f"k3_ab.py: {spec} timed out after {err.timeout} s", file=sys.stderr)
            failed.append(spec)
            continue
        line = next((l for l in proc.stdout.splitlines() if l.startswith(tag)), None)
        if proc.returncode != 0 or line is None:
            print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n", file=sys.stderr)
            print(f"k3_ab.py: {spec} failed with exit code {proc.returncode}", file=sys.stderr)
            failed.append(spec)
            continue
        for rec in json.loads(line[len(tag):]):
            rec = dict(spec=name, tree=tree, route=route or None, **rec)
            print(json.dumps(rec), flush=True)
            results.append(rec)
    print(json.dumps({"card": smi, "records": results, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
