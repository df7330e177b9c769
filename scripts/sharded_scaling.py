"""Weak scaling of the scenario-sharded solve over NCCL, one rank a card.

    python3 scripts/sharded_scaling.py [--cards N] [--lanes 16384] [--reps 10]

Builds the kernels once, then spawns one process per card (rank r on
cuda:r; NCCL over a file store in a temporary directory). Each rank designs
the headline's tier-1 controller (the QTP at h20, bench.py's tier-1 config:
rho grid (1, 10), 75 iterations, no refinement; K1) on its card, and

- solves its ``--lanes`` rows of an N x lanes batch (chip_smoke.py's
  ``bench_x0s``) through ``parallel.solve_sharded`` on a mesh of every rank,
  held bit for bit to ``parallel.solve_batch_fused`` on the same rows on
  its card, with the fleet's diagnostics the same bits on every rank;
- times both with ``utils.profiling.benchmark``: ``solve_batch_fused`` of
  its rows alone (one card's throughput) and ``solve_sharded`` of the
  whole batch (the fleet's; every rank waits for the slowest in the
  diagnostics' all_reduce); and, rep by rep, the two parts a sharded solve
  adds: the wait for the slowest rank (a barrier after this rank's solve)
  and the diagnostics' reduction (``scenarios._psum_diagnostics``) alone.

Prints one JSON line per rank and a summary: the one-card p50 (the ranks'
median), the fleet p50 (the slowest rank's), solves/s, the weak-scaling
efficiency throughput(N) / (N throughput(1)) = p50(1) / p50(N), and the
largest wait and reduction p50s. Exits non-zero without N cards or when
a check fails.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_main(rank, cards, lanes, reps, store, out_dir):
    """Rank ``rank`` on cuda:rank: check its shard, time it, and save its
    record to ``<out_dir>/rank<r>.pt``."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke
    from automationlabsmodelpredictivecontrol_jl_torch import parallel, proceed_controller
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
    from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig
    from automationlabsmodelpredictivecontrol_jl_torch.parallel import scenarios
    from automationlabsmodelpredictivecontrol_jl_torch.utils import profiling

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank, world_size=cards)
    try:
        ctrl = proceed_controller(
            qtp.linearized_discrete_system(), "model_predictive_control", 20, 5.0,
            [0.65] * 4, [1.2] * 2, admm_config=AdmmConfig(**chip_smoke.TIER1), device=dev)
        x0s = torch.from_numpy(chip_smoke.bench_x0s(cards * lanes)).to(dev)
        rows = x0s[rank * lanes:(rank + 1) * lanes]
        mesh = parallel.make_mesh()
        admm_fused.reset_counts()
        got = chip_smoke._shard_record(*parallel.solve_sharded(ctrl, x0s, mesh))
        want = chip_smoke._shard_record(*parallel.solve_batch_fused(ctrl, rows))
        for key in ("u", "status", "iterations", "wz", "wy"):
            if not torch.equal(got[key], want[key]):
                raise RuntimeError(f"rank {rank}: {key} differs from its rows solved alone")
        if any(admm_fused.PLAIN_CALLS.values()) or admm_fused.LAUNCHES["K1"] <= 0:
            raise RuntimeError(f"rank {rank} did not run K1 alone: {admm_fused.LAUNCHES}")
        alone = profiling.benchmark(lambda: parallel.solve_batch_fused(ctrl, rows), reps=reps)
        dist.barrier()
        fleet = profiling.benchmark(lambda: parallel.solve_sharded(ctrl, x0s, mesh), reps=reps)
        # the sharded step's parts: the wait for the slowest rank (a barrier
        # after this rank's solve) and the diagnostics' reduction alone
        wait, reduce = [], []
        for _ in range(reps):
            *_, local = parallel.solve_batch_fused(ctrl, rows)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            dist.barrier()
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            scenarios._psum_diagnostics(local, mesh)
            torch.cuda.synchronize(dev)
            wait.append(t1 - t0)
            reduce.append(time.perf_counter() - t1)
        rec = dict(rank=rank, device=torch.cuda.get_device_name(dev), lanes=lanes,
                   alone_p50_ms=alone["p50_ms"], alone_p99_ms=alone["p99_ms"],
                   sharded_p50_ms=fleet["p50_ms"], sharded_p99_ms=fleet["p99_ms"],
                   wait_p50_ms=float(np.median(wait)) * 1e3,
                   reduce_p50_ms=float(np.median(reduce)) * 1e3,
                   diag={k: float(v) for k, v in got["diag"].items()})
        torch.save(dict(rec, diag_bits=got["diag"]), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, default=4)
    parser.add_argument("--lanes", type=int, default=16384, help="lanes a card")
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    import chip_smoke
    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build

    if not torch.cuda.is_available() or torch.cuda.device_count() < args.cards:
        print(f"sharded_scaling.py: needs {args.cards} cards, sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi(), flush=True)
    _build.build_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(rank_main, args=(args.cards, args.lanes, args.reps,
                                            os.path.join(tmp, "store"), tmp),
                           nprocs=args.cards, start_method="spawn")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(args.cards)]
    bits = [rec.pop("diag_bits") for rec in ranks]
    for rec, diag in zip(ranks, bits):
        for key, v in diag.items():
            if v.dtype != bits[0][key].dtype or not torch.equal(v, bits[0][key]):
                raise RuntimeError(f"rank {rec['rank']}: diagnostics {key} differ from rank 0's")
        print(json.dumps(rec), flush=True)
    t1 = float(np.median([r["alone_p50_ms"] for r in ranks]))
    tn = max(r["sharded_p50_ms"] for r in ranks)
    summary = dict(cards=args.cards, lanes_per_card=args.lanes, one_card_p50_ms=t1,
                   fleet_p50_ms=tn, one_card_solves_per_s=args.lanes / t1 * 1e3,
                   fleet_solves_per_s=args.cards * args.lanes / tn * 1e3,
                   scaling_efficiency=t1 / tn,
                   wait_p50_ms=max(r["wait_p50_ms"] for r in ranks),
                   reduce_p50_ms=max(r["reduce_p50_ms"] for r in ranks),
                   n_total=ranks[0]["diag"]["n_total"],
                   n_converged=ranks[0]["diag"]["n_converged"])
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
