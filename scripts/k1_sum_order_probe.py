"""The lanes of the wide16x8-h30 cell that K1's fused solve leaves at the
iteration limit, and what the K-solve's summation order does to them.

    python3 scripts/k1_sum_order_probe.py [--lanes 4096] [--threads 6]

On the CPU, with the port alone: the routing audit's (16, 8) plant at h30
(``big.random_stable_system(16, 8, seed=0)``, ``AdmmConfig(max_iter=1000)``,
n = 240) over chip_smoke.py's ``wide16_x0s`` states, solved by
``ops.admm_fused.solve_batch_fused`` (K1's plain version, which the
kernel equals bit for bit: exact fp32 products summed in fp64, rounded
once) and by the general engine (``parallel.solve_batch``, fp32 sums).
The lanes the fused solve leaves unconverged are solved again alone, with
the fused driver's K-solve summed in fp64 as K1 sums it and in fp32 (the
general engine's and the JAX kernel's order of magnitude of roundoff).
Prints one JSON line per solve: statuses, iterations and dual residuals.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--threads", type=int, default=6)
    a = ap.parse_args()

    import torch

    import chip_smoke
    from automationlabsmodelpredictivecontrol_jl_torch import parallel, proceed_controller
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
    from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig
    from automationlabsmodelpredictivecontrol_jl_torch.ops.condense import (
        runtime_qp_vectors_batch,
    )

    torch.set_num_threads(a.threads)
    c = proceed_controller(
        big.random_stable_system(16, 8, seed=0), "model_predictive_control", 30, 5.0,
        [0.0] * 16, [0.0] * 8, admm_config=AdmmConfig(max_iter=1000), device="cpu")
    x = torch.from_numpy(chip_smoke.wide16_x0s(a.lanes))
    t0 = time.perf_counter()
    fused, _, _, d_f = parallel.solve_batch_fused(c, x)
    t1 = time.perf_counter()
    general, _, _, d_g = parallel.solve_batch(c, x)
    t2 = time.perf_counter()
    stalled = torch.nonzero(fused.status != 0).flatten()
    print(json.dumps(dict(
        solve="cell", lanes=a.lanes, converged_fused=int(d_f.n_converged),
        converged_general=int(d_g.n_converged), fused_s=t1 - t0, general_s=t2 - t1,
        stalled=stalled.tolist(), general_status_there=general.status[stalled].tolist(),
        general_iterations_there=general.iterations[stalled].tolist())), flush=True)

    op = c.engine.op
    q, l, u, _, _ = runtime_qp_vectors_batch(c.engine.qp, x[stalled] - c.tuning.references.x[:, 0])
    fp64 = admm_fused._lane_solver

    def fp32(op, idx, n, mode="highest"):  # the K-solve summed in fp32
        R, B = int(op.rho_grid.shape[0]), idx.shape[0]
        pick = idx.long().view(1, 1, B).expand(1, n, B)
        solve = lambda M, v: (M @ v).view(R, n, B).gather(0, pick)[0]
        return solve, op.K_invs.reshape(R * n, n), op.Ks.reshape(R * n, n)

    try:
        for sums, solver in (("fp64", fp64), ("fp32", fp32)):
            admm_fused._lane_solver = solver
            _, _, _, st, it, rp, rd = admm_fused.solve_batch_fused(op, q, l, u, config=c.engine.config)
            print(json.dumps(dict(solve="stalled lanes", k_solve_sums=sums, status=st.tolist(),
                                  iterations=it.tolist(), r_prim=rp.tolist(), r_dual=rd.tolist())),
                  flush=True)
    finally:
        admm_fused._lane_solver = fp64
    return 0


if __name__ == "__main__":
    sys.exit(main())
