"""Where a step of K4's and K5's wide route (csrc/admm_perr_wide.cu) spends
its clocks, on one GPU.

    python3 scripts/wide_phase_probe.py

Writes an instrumented copy of the kernel's source to build/wide_probe/
(thread 0 of each block reads clock64 between the phases of each panel
step and adds them up), builds it with the flags of ``ops/_build.py`` into
a library of its own, and launches it through the port's wrappers (the
library stands in for the port's) at the wide shapes of k3_ab.py
(K5_WIDE_SHAPES but the tier-1 equality terminal, K4_WIDE_SHAPES) on the
plan's layout and on a few forced ones, random rho indices. Prints one
JSON line a layout: ms a chunk (CUDA events over 5 launches, the
instrumented build), and the clocks of an SM a block spends an iteration
in each phase: the copies' issue, the sums, the wait for a panel's
copies, its widening, the barrier, the tiles' epilogues, the reloads of
the vector buffer, the ring's restart; and the panel steps an iteration.
The counters cost a few percent; the port's kernel has none. Exits
non-zero without a card.
"""

import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

# the phases' counters, in the order the instrumented kernel adds them up
PHASES = ("issue", "compute", "wait", "widen", "barrier", "epilogue_last", "reload", "restart",
          "steps", "epilogue")


def instrumented_source(text: str) -> str:
    """The kernel's source with clock64 counters between its phases and a
    C entry, wide_probe_read, that returns and clears them."""
    def rep(old, new):
        nonlocal text
        if old not in text:
            raise SystemExit(f"wide_phase_probe.py: the source has changed near {old[:60]!r}")
        text = text.replace(old, new, 1)

    rep('#include "admm_common.cuh"',
        '#include "admm_common.cuh"\n__device__ unsigned long long g_probe[16];\n')
    rep("  const int tid = threadIdx.x;\n  const int L = lay.lanes;\n",
        "  const int tid = threadIdx.x;\n  const int L = lay.lanes;\n"
        "  unsigned long long tp[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
        "  long long t_mark = clock64();\n"
        "#define PROBE(k) do { const long long t_now = clock64(); tp[k] += t_now - t_mark; "
        "t_mark = t_now; } while (0)\n")
    rep("    issue(iss, cslot);\n    if (iss.ph < phases) advance(iss);\n",
        "    PROBE(9);\n    issue(iss, cslot);\n    if (iss.ph < phases) advance(iss);\n"
        "    PROBE(0);\n    tp[8] += 1;\n")
    rep("    if (wid.ph < phases) {\n      wait_ring();\n",
        "    PROBE(1);\n    if (wid.ph < phases) {\n      wait_ring();\n      PROBE(2);\n")
    rep("      advance(wid);\n    }\n    __syncthreads();",
        "      advance(wid);\n      PROBE(3);\n    }\n    __syncthreads();\n    PROBE(4);")
    rep("  auto reload = [&](const float* src) {\n",
        "  auto reload = [&](const float* src) {\n    PROBE(5);\n")
    rep("    __syncthreads();\n  };\n\n  for (int it = 0; it < chunk; ++it) {",
        "    __syncthreads();\n    PROBE(6);\n  };\n\n  for (int it = 0; it < chunk; ++it) {")
    rep("    iss = Step{0, 0, 0};", "    PROBE(5);\n    iss = Step{0, 0, 0};")
    rep("    cslot = 0;\n    for (int ph = 0;",
        "    cslot = 0;\n    PROBE(7);\n    for (int ph = 0;")
    rep("  // the outputs: each live lane's working copy",
        "  PROBE(5);\n  if (tid == 0)\n    for (int k = 0; k < 10; ++k) atomicAdd(&g_probe[k], tp[k]);\n"
        "  // the outputs: each live lane's working copy")
    return text + """
extern "C" int wide_probe_read(unsigned long long* out) {
  cudaDeviceSynchronize();
  cudaError_t e = cudaMemcpyFromSymbol(out, g_probe, sizeof(unsigned long long) * 16);
  unsigned long long zero[16] = {0};
  cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  return (int)e;
}
"""


def main():
    import torch

    if not torch.cuda.is_available():
        print("wide_phase_probe.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    import k3_ab
    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build, admm_fused

    out_dir = os.path.join(ROOT, "build", "wide_probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "admm_perr_wide_probe.cu")
    with open(os.path.join(_build.CSRC_DIR, "admm_perr_wide.cu")) as f:
        text = instrumented_source(f.read())
    with open(src, "w") as f:
        f.write(text)
    lib_path = os.path.join(out_dir, "libwideprobe.so")
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-shared", "-o",
                    lib_path, src], check=True, capture_output=True, text=True)
    print(json.dumps(dict(nvcc_s=time.perf_counter() - t0)), flush=True)
    lib = ctypes.CDLL(lib_path)
    for entry in ("admm_perr_wide_chunk", "admm_packed_wide_chunk"):
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [_build._CTYPES[c] for c in _build.SIGNATURES[entry]]
    _build._lib = lib  # the wrappers launch from this library
    counters = (ctypes.c_ulonglong * 16)()
    dev = torch.device("cuda", 0)
    cases = list(k3_ab._admm_cases("K5", dev, ["sc-h100-B2048", "eq-h100-B2048",
                                               "sc-h154-tier1-B1024"]))
    cases += list(k3_ab._admm_cases("K4", dev, ["sc32x1-h20-tier1-B2048"]))
    for name, ctrl, x0s_fn, B, seed in cases:
        args = chip_smoke.kernel_inputs(ctrl, B, seed, x0s_fn, False)
        op, cfg = args[0], args[-1]
        m, n = (int(d) for d in op.A_s.shape)
        R, rs = int(op.rho_grid.shape[0]), int(cfg.refine_steps)
        packed = admm_fused.use_packed(n, m, R, rs)
        plan_fn = admm_fused.k4_plan if packed else admm_fused.k5_plan
        launch = admm_fused._launch_k4 if packed else admm_fused._launch_k5
        for force in ({}, dict(cluster=2, lanes=32), dict(cluster=1, lanes=16)):
            plan = plan_fn(n, m, R, rs, B, **force)
            launch(*args, plan=plan)
            lib.wide_probe_read(counters)  # clears them
            ms = chip_smoke.cuda_ms(lambda: launch(*args, plan=plan), reps=5, warm_up=False)
            lib.wide_probe_read(counters)
            per = plan.cluster * admm_fused.k12_blocks_used(R, B, plan.lanes) * args[-2] * 5
            rec = {k: list(counters)[i] / per for i, k in enumerate(PHASES)}
            print(json.dumps(dict(shape=name, forced=str(force), ms=ms, plan=plan._asdict(),
                                  clocks_per_iteration=sum(v for k, v in rec.items()
                                                           if k != "steps"), **rec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
