"""Readings that the limits of a configuration are set from, on the chip at
the cell's own size, all seeds in one process (set-up once):

    python3 mpcbench/readings.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103 --seconds 3 [--out FILE]

For each of ``--seeds`` a short window of the program on the cell's timed
path and the comparison's numbers (the lower readings), with the window's
batch ms, the K1/K3 launches a batch and the mean of the lanes' own
iterations (``work.lane_iterations`` is this on seed 0). For each of
``--control-seeds`` the configuration's control, computed in the precision
below the one it states, judged by the same numbers (the upper readings):

- ``{"kind": "reference", "dtype": ...}``: the plain reference in that
  dtype puts its design and answers in the program's place (``iterations``
  steps of its solver), on two of the mix's batches, every lane;
- ``{"kind": "program", "solver": {...}}``: the program with those solver
  knobs (its own lower-precision path) over a short window.

Both are judged by ``harness.judge`` and ``harness.is_correct``, as a run
is; a control's line reads ``"correct": false`` where it fails.

One JSON line a reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mpcbench import harness, traffic  # noqa: E402
from mpcbench.reference import mpc as ref_mpc  # noqa: E402
from mpcbench.yardstick import stats  # noqa: E402


def window_reading(session, cfg, mix, seed, seconds, device, limits=None):
    """A window of ``session`` on ``seed``, the judge's numbers and whether
    they pass the configuration's limits (``correct``, as a run decides it)."""
    w = harness.run_window(session, session.source(seed), seconds)
    cuda = torch.device(device).type == "cuda"
    checks = harness.judge(cfg, harness.program_design(session.ctrl),
                           [{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in s.items()}
                            for s in w.samples],
                           [[b] for b in w.lanes], w.diags, w.plain_calls if cuda else None,
                           device, limits)
    iters = np.concatenate([b[1] for b in w.lanes])
    status = np.concatenate([b[0] for b in w.lanes])
    return dict(
        seed=seed, correct=harness.is_correct(checks),
        checks={k: c["value"] for k, c in checks.items()}, batches=len(w.batch_ms),
        p50_ms=stats.percentile(w.batch_ms, 50), p95_ms=stats.percentile(w.batch_ms, 95),
        k3_per_batch=w.launches.get("K3", 0) / len(w.batch_ms),
        k1_per_batch=w.launches.get("K1", 0) / len(w.batch_ms),
        lane_iterations=float(iters.mean()), max_iterations=int(iters.max()),
        converged=float(np.mean(status == 0)), window_s=w.seconds)


def reference_control(cfg, mix, seed, device, batches=2):
    """The reference in the control's dtype put in the program's place: its
    design (rounded to that dtype) and its answers for every lane of
    ``batches`` of the mix's batches, each lane reported converged after
    ``iterations`` steps with its batch's diagnostics worked out from its
    lanes, judged by ``harness.judge`` and ``harness.is_correct`` as a run's
    answers are."""
    ctl = cfg["control"]
    dtype = getattr(torch, ctl["dtype"])
    source = traffic.generator(harness.HERE, mix["kind"]).Source(mix, seed, cfg["nx"], device)
    design = ref_mpc.Design(cfg)
    pairs = [(k, torch.as_tensor(v).to(dtype).double().numpy()) for k, v in design.arrays().items()]
    samples, lanes, diags = [], [], []
    for b in range(batches):
        x0 = source.next()
        u, x, _ = ref_mpc.solve(design, x0.double(), device, dtype=dtype, iters=ctl["iterations"])
        n = x0.shape[0]
        status = np.zeros(n, np.int32)
        iters = np.full(n, ctl["iterations"], np.int32)
        rp = rd = np.zeros(n, np.float32)
        # the program's layout: (lane, nu, N) and (lane, nx, N+1)
        samples.append(dict(batch=b, lanes=list(range(n)), x0=x0.cpu(),
                            u=u.transpose(1, 2).float().cpu(), x=x.transpose(1, 2).float().cpu(),
                            status=status, iterations=iters))
        lanes.append([[status, iters, rp, rd]])
        d = ref_mpc.recompute_diagnostics(status, iters, rp, rd)
        diags.append(np.array([d[k] for k in harness.DIAG_FIELDS]))
    checks = harness.judge(cfg, pairs, samples, lanes, diags, None, device)
    return dict(seed=seed, control=ctl, correct=harness.is_correct(checks),
                checks={k: c["value"] for k, c in checks.items()},
                limits={k: c["limit"] for k, c in checks.items()},
                lanes=sum(len(s["lanes"]) for s in samples))


def design_control(cfg, keys):
    """The design gap of the reference's design rounded to the control's
    dtype (bfloat16 where the control names none): the design's upper
    reading, whichever path the control takes for the solve."""
    dtype = getattr(torch, cfg["control"].get("dtype", "bfloat16"))
    design = ref_mpc.Design(cfg)
    ref = harness.reference_arrays(design, keys)
    pairs = [(k, torch.as_tensor(ref[k]).to(dtype).double().numpy()) for k in keys]
    return harness.design_gap(pairs, design)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    spec = harness.load_spec()
    cell = harness.find_cell(spec, a.workload)
    cfg = harness.load_config(harness.HERE, cell["config"])
    mix = traffic.load(harness.HERE, cell["traffic"])
    if not torch.cuda.is_available():
        print("readings.py: needs a CUDA device", file=sys.stderr)
        return 2
    device = "cuda:0"
    harness.importlib.import_module(f"{harness.PORT}.ops._build").build_kernels()
    mix = dict(mix, ranks=1, lanes=mix["lanes"] // mix["ranks"])
    out = open(a.out, "a") if a.out else None

    def emit(rec):
        rec = dict(rec, workload=a.workload, device=torch.cuda.get_device_name(0))
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)

    if a.seeds:
        t0 = time.perf_counter()
        session = harness.Session(cfg, mix, device)
        session.kind.warm_up(session, session.source(-1))
        emit(dict(kind="setup", seconds=time.perf_counter() - t0, design_s=session.design_s))
        for seed in a.seeds:
            emit(dict(window_reading(session, cfg, mix, seed, a.seconds, device), kind="program"))
        del session
        torch.cuda.empty_cache()
    ctl = cfg["control"]
    if a.control_seeds:
        keys = [k for k, _ in harness.program_design(harness.build_controller(cfg, "cpu"))]
        emit(dict(kind="control-design", design_gap=design_control(cfg, keys)))
    if a.control_seeds and ctl["kind"] == "program":
        session = harness.Session(cfg, mix, device, overrides=ctl["solver"])
        session.kind.warm_up(session, session.source(-1))
        for seed in a.control_seeds:
            emit(dict(window_reading(session, cfg, mix, seed, a.seconds, device),
                      kind="control", control=ctl))
    elif a.control_seeds:
        for seed in a.control_seeds:
            emit(dict(reference_control(cfg, mix, seed, device), kind="control"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
