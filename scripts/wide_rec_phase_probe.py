"""Where the drivers' wide rollout and certificate spend a horizon step's
clocks, phase by phase, on the card.

    python3 scripts/wide_rec_phase_probe.py [--shapes a,b] [--layout SPEC] [--source FILE ...]

Builds ``csrc/riccati_wide_rec.cu`` (or each ``--source`` file, a variant of
it with the same C entries) and an instrumented copy of each, apart, under
build/wide_rec_probe/ (once a source text), every nvcc at once. In a copy
two threads of block 0 read ``clock64()`` around each horizon step:
thread 0 (the first row group:
A e, or A' g) and, in the certificate, the first thread of B' g's row
groups. Their clocks are summed by phase: ``product`` (the step's sums, from
the step's start to the end of their loop), ``fold`` (the sums' epilogue:
the stores of e or g, X, B u, and the dual deltas folded into the
certificate's partials; a global load the step issued and not yet used is
waited for here), ``stage`` (the rollout's U of a later step into its
shared slot) and ``barrier`` (the wait for the block's slowest warp), with
the kernel's clocks from its start to the end of the horizon loop. The
kernels the package builds carry no such counters. Each shape of k3_ab.py's
WIDE_REC_SHAPES runs as ``wide_recurrence_plan`` (or ``--layout``, k3_ab.py's
spec) lays it out; the uninstrumented kernel's time (a CUDA graph after 0.3
s of warm-up, as k3_ab.py --kernel wide-rec times it) and a SHA-256 of its
outputs are printed beside. One JSON line a source, kernel and shape.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("product", "fold", "stage", "barrier")
ENTRIES = ("riccati_wide_rollout", "riccati_wide_certificate")

# g_probe[16 w + i]: thread w's clocks in phase i, then [16 w + 8] its
# steps and [16 w + 9] its clocks from the kernel's start to the loop's end
STAMP = "pr_t = pr_stamp(pr_who, {phase}, pr_t);"
PATCHES = (  # (text of the source, what replaces it in the copy)
    ("namespace {\n",
     "namespace {\n__device__ unsigned long long g_probe[32];\n"
     "__device__ __forceinline__ long long pr_stamp(int who, int phase, long long t0) {\n"
     "  const long long t = clock64();\n"
     "  if (who >= 0) g_probe[16 * who + phase] += t - t0;\n"
     "  return t;\n}\n"),
    # the rollout
    ("  const size_t es = static_cast<size_t>(nx) * lanes, us = static_cast<size_t>(nu) * lanes;\n",
     "  const size_t es = static_cast<size_t>(nx) * lanes, us = static_cast<size_t>(nu) * lanes;\n"
     "  const int pr_who = blockIdx.x == 0 && tid == 0 ? 0 : -1;\n"
     "  const long long pr_start = clock64();\n  long long pr_t = pr_start;\n"),
    ("    double* nxt = E + ((k + 1) & 1) * es;\n",
     "    double* nxt = E + ((k + 1) & 1) * es;\n    pr_t = clock64();\n"),
    ("      tile_dot2<RT, LT, PLACE>(a, mA, cur, nx, b, mB, un, n2, lanes, c, l0);\n",
     "      tile_dot2<RT, LT, PLACE>(a, mA, cur, nx, b, mB, un, n2, lanes, c, l0);\n      "
     + STAMP.format(phase=0) + "\n"),
    ("    st.store(Us + (k % kRing) * us);  // into U_k's slot\n",
     "    " + STAMP.format(phase=1) + "\n"
     "    st.store(Us + (k % kRing) * us);  // into U_k's slot\n    "
     + STAMP.format(phase=2) + "\n"),
    ("    __syncthreads();\n  }\n}\n\nstruct CertArgs",
     "    __syncthreads();\n    " + STAMP.format(phase=3) + "\n"
     "    if (pr_who >= 0) g_probe[16 * pr_who + 8] += 1;\n  }\n"
     "  if (pr_who >= 0) g_probe[16 * pr_who + 9] += clock64() - pr_start;\n}\n\nstruct CertArgs"),
    # the certificate
    ("  const size_t gs = static_cast<size_t>(nx) * lanes;\n",
     "  const size_t gs = static_cast<size_t>(nx) * lanes;\n"
     "  const int pr_who = blockIdx.x != 0 ? -1 : tid == 0 ? 0 : tid == xp / RT * LG ? 1 : -1;\n"
     "  const long long pr_start = clock64();\n  long long pr_t = pr_start;\n"),
    ("    double* gk = G + (k & 1) * gs;\n",
     "    double* gk = G + (k & 1) * gs;\n    pr_t = clock64();\n"),
    ("        if (k >= 1) tile_dot<RT, LT, PLACE>(a, mA, gn, nx, lanes, c, l0);\n",
     "        if (k >= 1) tile_dot<RT, LT, PLACE>(a, mA, gn, nx, lanes, c, l0);\n        "
     + STAMP.format(phase=0) + "\n"),
    ("        tile_dot<RT, LT, PLACE>(a, mB, gn, nx, lanes, c, l0);\n",
     "        tile_dot<RT, LT, PLACE>(a, mB, gn, nx, lanes, c, l0);\n        "
     + STAMP.format(phase=0) + "\n"),
    ("      }\n    }\n    __syncthreads();\n  }\n\n",
     "      }\n    }\n    " + STAMP.format(phase=1) + "\n    __syncthreads();\n    "
     + STAMP.format(phase=3) + "\n    if (pr_who >= 0) g_probe[16 * pr_who + 8] += 1;\n  }\n"
     "  if (pr_who >= 0) g_probe[16 * pr_who + 9] += clock64() - pr_start;\n\n"),
)
READER = """
extern "C" int riccati_wide_rec_probe_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  static unsigned long long zero[32] = {};
  cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  return static_cast<int>(cudaGetLastError());
}
"""


def build(sources):
    """[(the library of each source as it is, its instrumented one)], every
    nvcc at once."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build

    out = os.path.join(ROOT, "build", "wide_rec_probe")
    os.makedirs(out, exist_ok=True)
    jobs, libs = [], []
    for i, src in enumerate(sources):
        text = open(src).read()
        for old, new in PATCHES:
            if text.count(old) != 1:
                raise RuntimeError(f"the probe's anchor is not once in {src}: {old!r}")
            text = text.replace(old, new)
        tag = hashlib.sha256(text.encode()).hexdigest()[:12]  # a source built once
        probe_src = os.path.join(out, f"probe_{tag}.cu")
        open(probe_src, "w").write(text + READER)
        pair = (os.path.join(out, f"libplain_{tag}.so"), os.path.join(out, f"libprobe_{tag}.so"))
        jobs += [(lib, s) for lib, s in zip(pair, (src, probe_src)) if not os.path.exists(lib)]
        libs.append(pair)
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, s],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for lib, s in jobs]
    for (lib, _), proc in zip(jobs, procs):
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{text}")
        spills = [line.strip() for line in text.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        print(json.dumps(dict(library=os.path.basename(lib), spills=spills)), flush=True)
    return libs


def _load(path):
    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build

    lib = ctypes.CDLL(path)
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [_build._CTYPES[c] for c in _build.SIGNATURES[name]]
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="nx64-h30-B1024,nx64-h30-B1")
    ap.add_argument("--layout", default="")
    ap.add_argument("--source", action="append", default=[])
    a = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("wide_rec_phase_probe.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    import k3_ab
    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build, riccati, riccati_fused

    sources = a.source or [os.path.join(_build.CSRC_DIR, "riccati_wide_rec.cu")]
    libs = [(_load(p), _load(q)) for p, q in build(sources)]
    for _, probe in libs:
        probe.riccati_wide_rec_probe_read.restype = ctypes.c_int
        probe.riccati_wide_rec_probe_read.argtypes = [ctypes.c_void_p]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    shapes = [s for s in a.shapes.split(",") if s]
    force = k3_ab._rec_layout(a.layout)
    buf = (ctypes.c_ulonglong * 32)()
    for name, plant, N, kw, B, seed in k3_ab.WIDE_REC_SHAPES:
        if shapes and name not in shapes:
            continue
        op = k3_ab._riccati_op(plant, N, kw, dev)
        rng = np.random.default_rng(seed)  # k3_ab.py's inputs
        t = lambda *shape: torch.from_numpy(
            (0.05 * rng.standard_normal(shape)).astype(np.float32)).to(dev)
        e0T, U = 2.0 * t(op.nx, B), t(N, op.nu, B)
        lamX, lamU = t(N + 1, op.nx, B), t(N, op.nu, B)
        lamX2, lamU2 = lamX + 0.01 * lamX.flip(0), lamU - 0.02 * lamU.flip(0)
        ballr = riccati.ball_radius(op, e0T)
        Xbar = riccati.rollout_warm(op, e0T, torch.zeros_like(U))
        cargs = (op, lamX2, lamX, lamU2, lamU, Xbar, ballr)
        for kernel in ("rollout", "certificate"):
            try:
                plan = riccati_fused.wide_recurrence_plan(op, B, kernel, **force)
            except ValueError as err:  # a forced layout that does not fit
                print(json.dumps(dict(kernel=kernel, shape=name, skipped=str(err))), flush=True)
                continue
            run = ((lambda: riccati_fused._launch_rollout_wide(op, e0T, U, plan=plan))
                   if kernel == "rollout" else
                   (lambda: riccati_fused._launch_certificate_wide(*cargs, plan=plan)))
            for src, (plain, probe) in zip(sources, libs):
                _build._lib = plain
                out = run()
                rec = dict(source=os.path.relpath(src, ROOT), kernel=kernel, shape=name,
                           plan=plan._asdict(), sha256=k3_ab._digest([out]),
                           ms=chip_smoke.cuda_graph_ms(run, repeats=10, warm_s=0.3),
                           sm_mhz=chip_smoke.sm_clock_now_mhz())
                _build._lib = probe
                run()
                torch.cuda.synchronize()
                probe.riccati_wide_rec_probe_read(ctypes.addressof(buf))
                run()
                torch.cuda.synchronize()
                if probe.riccati_wide_rec_probe_read(ctypes.addressof(buf)) != 0:
                    raise RuntimeError("the probe's read failed")
                for who, label in enumerate(("A rows", "B' rows")):
                    steps = buf[16 * who + 8]
                    if steps:
                        rec[label] = dict(steps=steps, kernel_clocks=buf[16 * who + 9],
                                          **{p: buf[16 * who + i] / steps
                                             for i, p in enumerate(PHASES)})
                print(json.dumps(rec), flush=True)
    _build._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
