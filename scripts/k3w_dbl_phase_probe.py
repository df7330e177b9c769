"""Where K3W-doubling's chunk spends its clocks, phase by phase, on the card.

    python3 scripts/k3w_dbl_phase_probe.py [--tree TREE] [--shapes a,b] [--layout SPEC]

Builds TREE's ``csrc/riccati_wide.cu`` (default: this checkout) and an
instrumented copy of it apart, under TREE/build/k3wprobe/, one nvcc each
(~40 s): in the copy thread 0 of block 0 reads
``clock64()`` around each panel of the operator ring (the wait for its
copies and the block's barrier, the start of the next panel's copies, and
the block's work until the next panel: the panel's products and any phase
without an operator that follows it; without a ring, a stream's barrier
and its work) and sums them by the stream the panel belongs to (K for the sweep's K' lu, the combine levels, the prefix
products, G for s and ffs, K for the rollout's u and the projections),
with the kernel's clocks from start to end. The kernel the package builds
carries no such counters. Each shape of k3_ab.py's DOUBLING_SHAPES runs once as the plan (or ``--layout``, k3_ab.py's
spec) lays it out, after a warm-up; the uninstrumented kernel's CUDA-event
time on the same inputs is printed beside. One JSON line a shape; the
clocks are thread 0's of block 0, so a phase's wait includes the slowest
warp of that block.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("K' lu", "levels", "prefix products", "s and ffs", "u and projections")

PROBE_KIND = ("pr_kind = st == 0 ? 0 : st == 2 * lv + 4 ? 4 : st == lv + 2 ? 3"
              " : (st == lv + 1 || st == 2 * lv + 3) ? 2 : 1;")
PATCHES = (  # (text of the source, what replaces it in the copy)
    ("namespace {\n", "namespace {\n__device__ unsigned long long g_probe[64];\n"),
    ("  const size_t ks = lay.ks, ku = lay.ku;\n",
     "  const size_t ks = lay.ks, ku = lay.ku;\n"
     "  const bool pr_on = blockIdx.x == 0 && threadIdx.x == 0;\n"
     "  long long pr_t = clock64(), pr_t0 = pr_t;\n"
     "  int pr_kind = 0, pr_prev = -1;\n"),
    ("  const auto next = [&]() -> const float* {\n",
     "  const auto next = [&]() -> const float* {\n"
     "    if (pr_on) { long long t = clock64(); if (pr_prev >= 0) g_probe[3 * pr_prev + 2] += t - pr_t;"
     " pr_t = t; }\n"),
    ("    __syncthreads();\n    fill();\n",
     "    __syncthreads();\n"
     "    if (pr_on) { long long t = clock64(); g_probe[3 * pr_kind] += t - pr_t; pr_t = t; }\n"
     "    fill();\n"
     "    if (pr_on) { long long t = clock64(); g_probe[3 * pr_kind + 1] += t - pr_t; pr_t = t;"
     " pr_prev = pr_kind; g_probe[30 + pr_kind] += 1; }\n"),
    ("    if (!p.ring) {\n      __syncthreads();\n",
     "    if (!p.ring) {\n      __syncthreads();\n"
     "      if (pr_on) { long long t = clock64(); g_probe[3 * pr_kind] += t - pr_t; pr_t = t;"
     " pr_prev = pr_kind; g_probe[30 + pr_kind] += 1; }\n"),
    ("    for (int q = 0; q * P < s.n; ++q) {\n",
     "    for (int q = 0; q * P < s.n; ++q) {\n      " + PROBE_KIND + "\n"),
    ("  __syncthreads();\n  for (int e = tid; e < (N + 1) * nx * LB; e += T) {\n",
     "  if (pr_on) { long long t = clock64(); if (pr_prev >= 0) g_probe[3 * pr_prev + 2] += t - pr_t;"
     " g_probe[60] += t - pr_t0; g_probe[61] += 1; }\n"
     "  __syncthreads();\n  for (int e = tid; e < (N + 1) * nx * LB; e += T) {\n"),
)
READER = """
extern "C" int riccati_wide_probe_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  static unsigned long long zero[64] = {};
  cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  return static_cast<int>(cudaGetLastError());
}
"""


def build(tree):
    """(the library of TREE's riccati_wide.cu as it is, the instrumented
    one), each nvcc'd alone, both at once."""
    sys.path.insert(0, os.path.abspath(tree))
    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build

    src = os.path.join(_build.CSRC_DIR, "riccati_wide.cu")
    text = open(src).read()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise RuntimeError(f"the probe's anchor is not once in the source: {old!r}")
        text = text.replace(old, new)
    out = os.path.join(os.path.abspath(tree), "build", "k3wprobe")
    os.makedirs(out, exist_ok=True)
    probe_src = os.path.join(out, "riccati_wide_probe.cu")
    open(probe_src, "w").write(text + READER)
    libs = [os.path.join(out, "libk3wplain.so"), os.path.join(out, "libk3wprobe.so")]
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, s],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for lib, s in zip(libs, (src, probe_src))]
    for proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{text}")
    return libs


def _load(path, entries):
    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build

    lib = ctypes.CDLL(path)
    for name in entries:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [_build._CTYPES[c] for c in _build.SIGNATURES[name]]
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--shapes", default="")
    ap.add_argument("--layout", default="")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k3w_dbl_phase_probe.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import k3_ab

    plain_path, probe_path = build(a.tree)
    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build, riccati_fused

    main_lib = _load(plain_path, ("riccati_wide_chunk",))
    probe = _load(probe_path, ("riccati_wide_chunk",))
    probe.riccati_wide_probe_read.restype = ctypes.c_int
    probe.riccati_wide_probe_read.argtypes = [ctypes.c_void_p]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    shapes = [s for s in a.shapes.split(",") if s]
    buf = (ctypes.c_ulonglong * 64)()
    for name, plant, N, kw, B, seed, scratch in k3_ab.DOUBLING_SHAPES:
        if shapes and name not in shapes:
            continue
        op = k3_ab._riccati_op(plant, N, kw, dev)
        args = k3_ab._chunk_args(op, B, seed, dev)
        plan, _ = k3_ab._dbl_layout(riccati_fused, op, B, a.layout, scratch)
        _build._lib = main_lib
        run = lambda: riccati_fused._launch_k3w(*args, doubling=True, plan=plan)
        ms = k3_ab._ms(run, 10)
        _build._lib = probe
        run()
        torch.cuda.synchronize()
        probe.riccati_wide_probe_read(ctypes.addressof(buf))
        run()
        torch.cuda.synchronize()
        if probe.riccati_wide_probe_read(ctypes.addressof(buf)) != 0:
            raise RuntimeError("the probe's read failed")
        chunk = args[-1]
        per = lambda v: v / chunk
        rec = dict(shape=name, plan=plan._asdict(), ms=ms, kernel_clocks=buf[60],
                   clocks_per_iteration=per(buf[60]))
        for i, kind in enumerate(KINDS):
            rec[kind] = dict(panels_per_iteration=per(buf[30 + i]), wait=per(buf[3 * i]),
                             fill=per(buf[3 * i + 1]), work=per(buf[3 * i + 2]))
        print(json.dumps(rec), flush=True)
    _build._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
