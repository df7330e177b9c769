"""Build time and first check of K3's (32, 16) register tier, on one GPU.

    python3 scripts/k3_tier_probe.py

Compiles every ``csrc/*.cu`` of the port with its own nvcc, all at once
(the flags of ``ops/_build.py``), and prints when each finished, the
registers and spills of K3's (16, 8) and (32, 16) instantiations from the
``-Xptxas -v`` report (the whole report goes to
``build/kernels/ptxas_t3.txt``), then links the library and holds K3 at the
wide Riccati cell's plant (``big.random_stable_system(32, 16, seed=0)``,
h30) against its plain version: at B = 1, 256 and 2048 on the routes its
plan takes, at 256 on the fp32 and streamed routes forced, and an h10
operator on the fp64 route; the rollout and the certificate at 1, 256 and
2048; and two ``solve_batch_auto`` calls over 2048 states. Exits non-zero
without a card.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def build(out_dir):
    """(seconds at which each source's nvcc finished, the ptxas report)."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build

    t0, procs = time.perf_counter(), {}
    for src in _build._sources():
        stem = os.path.splitext(os.path.basename(src))[0]
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", os.path.join(out_dir, stem + ".o"), src]
        procs[stem] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    finished, report = {}, ""
    while procs:
        for stem, proc in list(procs.items()):
            if proc.poll() is None:
                continue
            finished[stem] = time.perf_counter() - t0
            text = proc.stdout.read()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {stem}:\n{text}")
            report += text
            del procs[stem]
        time.sleep(0.2)
    subprocess.run([_build._nvcc(), *_build.ARCH, "-shared", "-o", _build.LIB_PATH]
                   + [os.path.join(out_dir, s + ".o") for s in finished], check=True)
    return finished, report


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from automationlabsmodelpredictivecontrol_jl_torch import parallel, proceed_controller
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big
    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build, riccati_fused

    if not torch.cuda.is_available():
        print("k3_tier_probe.py: no CUDA device", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    out_dir = os.path.dirname(_build.LIB_PATH)
    os.makedirs(out_dir, exist_ok=True)
    finished, report = build(out_dir)
    print(json.dumps({"nvcc_finish_s": finished}), flush=True)
    with open(os.path.join(out_dir, "ptxas_t3.txt"), "w") as f:
        f.write(report)
    for row in cs.ptxas_summary(report):
        if row["kernel"].startswith("K3") and row["template"][:2] in ([32, 16], [16, 8]):
            print(json.dumps(row))
    _build.load_kernels()

    dev = torch.device("cuda")
    plant = big.random_stable_system(32, 16, seed=0)
    design = lambda N: proceed_controller(
        plant, "model_predictive_control", N, 1.0, np.zeros(32, np.float32),
        np.zeros(16, np.float32), mpc_Q=10.0, mpc_R=0.1, engine="riccati", device=dev)
    c30, c10 = design(30), design(10)
    for ctrl, B, route in ((c30, 1, None), (c30, 256, None), (c30, 2048, None),
                           (c30, 256, "shared-fp32"), (c30, 256, "stream"), (c10, 256, None)):
        args = cs.riccati_inputs(ctrl, B, 5, cs.wide_x0s) + (25,)
        kernel = lambda: riccati_fused._launch_k3(*args, route=route)
        abs_err, rel_err, ulps = cs._errors(kernel(), riccati_fused.iterate_chunk_riccati_plain(*args),
                                            "K3")
        print(json.dumps(dict(
            N=ctrl.engine.op.N, B=B, route=route or riccati_fused.k3_plan(ctrl.engine.op, B).route,
            abs=abs_err, rel=rel_err, ulps=ulps, ms=cs.cuda_ms(kernel, reps=5))), flush=True)
    for B in (1, 256, 2048):
        print(json.dumps(cs.compare_recurrences(c30, B, 7, cs.wide_x0s)), flush=True)
    x0s = torch.from_numpy(cs.wide_x0s(2048)).to(dev)
    for _ in range(2):
        t0 = time.perf_counter()
        _, _, _, d = parallel.solve_batch_auto(c30, x0s)
        torch.cuda.synchronize()
        print(json.dumps(dict(solve_s=time.perf_counter() - t0,
                              converged=int(d.n_converged) / 2048,
                              mean_iterations=float(d.mean_iterations),
                              max_iterations=int(d.max_iterations))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
