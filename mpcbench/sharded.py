"""The four-rank launcher: one process a card, NCCL over TCP on a free port
of localhost (nothing on disk), rank 0 the process that ``run.py`` started,
which prints the one result line.

Every rank draws the whole batch from the seed on its own card, solves its
rows through ``parallel.solve_sharded`` (the fused path; the fleet's
diagnostics all-reduced) and keeps its lanes' results. Rank 0 times each
batch from its dispatch to the reduced diagnostics on its host and decides,
after each batch, whether the window goes on (one broadcast). After the
window every rank sends rank 0 its lanes, samples, memory peak and trace;
rank 0 runs the reference.
"""

from __future__ import annotations

import datetime
import socket
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import harness


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(spec, cell, cfg, mix, seed, seconds, trace, t_start, device_type="cuda",
           out=sys.stdout, err=sys.stderr, patch: Optional[Callable] = None,
           bench_dir: str = harness.HERE) -> int:
    """Start ranks 1.. as processes, run rank 0 here, and wait for all.
    ``patch(session)``, a module-level function, may break every rank's
    timed path (the fault tests)."""
    import multiprocessing as mp

    ranks = int(mix["ranks"])
    if device_type == "cuda":
        harness.importlib.import_module(f"{harness.PORT}.ops._build").build_kernels()
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, ranks, port, cfg, mix, seed, seconds, trace,
                                                 None, device_type, patch, bench_dir))
             for r in range(1, ranks)]
    for p in procs:
        p.start()
    try:
        code = rank_main(0, ranks, port, cfg, mix, seed, seconds, trace, (spec, cell, t_start),
                         device_type, patch, bench_dir, out, err)
    finally:
        for p in procs:
            p.join(timeout=300)
            if p.is_alive():
                p.terminate()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad and code == 0:
        print(f"mpcbench: a rank exited with {bad}", file=err)
        return 4
    return code


def _stop_rule(dist, rank: int, device, rule: Callable[[float], bool]) -> Callable[[float], bool]:
    """Rank 0's ``rule`` decides; every rank learns it from one broadcast."""
    flag = torch.zeros(1, dtype=torch.int32, device=device)

    def stop(elapsed: float) -> bool:
        if rank == 0:
            flag.fill_(int(rule(elapsed)))
        dist.broadcast(flag, 0)
        return bool(flag.item())

    return stop


def rank_main(rank, ranks, port, cfg, mix, seed, seconds, trace, head, device_type, patch,
              bench_dir, out=sys.stdout, err=sys.stderr) -> int:
    """One rank. ``head`` is (spec, cell, t_start) on rank 0, else None."""
    import torch.distributed as dist

    if head is None:
        sys.path.insert(0, harness.ROOT)
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=ranks, timeout=datetime.timedelta(seconds=300))
    try:
        parallel = harness.importlib.import_module(f"{harness.PORT}.parallel")
        mesh = parallel.make_mesh()
        session = harness.Session(cfg, mix, device, mesh=mesh, bench_dir=bench_dir)
        if patch is not None:
            patch(session)
        source = session.source(seed)
        session.kind.warm_up(session, source)
        harness.sync(device)
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        dist.barrier()
        setup_s = time.perf_counter() - head[2] if head else 0.0
        w = harness.run_window(session, source, seconds,
                               stop=_stop_rule(dist, rank, device, lambda e: e >= seconds))
        traced, overhead = None, None
        if trace:
            traced = harness.device_trace(
                lambda: harness.run_window(session, source, 0, keep=False,
                                           stop=_stop_rule(dist, rank, device,
                                                           harness._after(harness.TRACE_BATCHES))),
                device)
            overhead = _overhead(dist, session, source)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        design_pairs = harness.program_design(session.ctrl) if rank == 0 else None
        samples = [{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in s.items()}
                   for s in w.samples]
        mine = dict(lanes=w.lanes, samples=samples, peak=peak, plain=w.plain_calls,
                    busy=traced["busy_s"] if traced else None, alone=overhead)
        gathered = [None] * ranks if rank == 0 else None
        dist.gather_object(mine, gathered, dst=0)
        if rank != 0:
            return 0
        design_s = session.design_s
        del session
        if cuda:
            torch.cuda.empty_cache()
        spec, cell, _ = head
        lanes = [[g["lanes"][b] for g in gathered] for b in range(len(w.lanes))]
        samples = [s for g in gathered for s in g["samples"]]
        plain = sum(g["plain"] for g in gathered) if cuda else None
        sharded = busy = None
        if trace:
            sharded = dict(fleet_ms=overhead["fleet_ms"],
                           alone_ms=[g["alone"]["alone_ms"] for g in gathered])
            busy = float(np.mean([g["busy"] for g in gathered]))
        return harness.finish(spec, cell, cfg, mix, w, lanes, samples, design_pairs, plain, device,
                              ranks, max(g["peak"] for g in gathered), setup_s, design_s, traced,
                              busy, sharded=sharded, out=out, err=err, bench_dir=bench_dir)
    finally:
        dist.destroy_process_group()


def _overhead(dist, session, source):
    """Each rank's own rows solved alone on the batch entry, then the fleet's
    sharded batch, on the same inputs, ``OVERHEAD_BATCHES`` times: the
    rank's ms alone, and rank 0's fleet ms (dispatch to the reduced
    diagnostics on the host)."""
    alone, fleet_ms = [], []
    for _ in range(harness.OVERHEAD_BATCHES):
        x0s = source.next()
        dist.barrier()
        t0 = time.perf_counter()
        sol, _, _, _ = session.solve_rows(x0s)
        sol.status.cpu()
        alone.append((time.perf_counter() - t0) * 1e3)
        dist.barrier()
        t0 = time.perf_counter()
        _, _, _, diag = session.solve(x0s)
        harness.diag_vector(diag).cpu()
        fleet_ms.append((time.perf_counter() - t0) * 1e3)
    return dict(alone_ms=alone, fleet_ms=fleet_ms)
