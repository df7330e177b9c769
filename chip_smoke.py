"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two kernel paths at full size, through the entry points
a user calls (``proceed_controller(..., device=card)``, then ``parallel``):

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
  states.

Phases (any failure raises and exits non-zero):
1. the card: its name, count, and power limit from nvidia-smi;
2. build: csrc/*.cu with one nvcc per source, all at once (a summary of
   the -Xptxas -v report is printed, the whole report is written to
   build/kernels/ptxas.txt), and the native oracle with g++, into build/;
3. each kernel against its plain PyTorch version on the card at its
   main-path shapes, with times from CUDA events;
4. each path, with the launch counts set to 0 just before it and read
   just after, showing that it went through its kernel and never through
   a plain version;
5. where the time goes in each path's cells (torch.profiler: device time
   per solve, the kernels' share of it, the card's idle share); then
   re-solves of 256 lanes with the plain versions.

The last two lines are the card's name and power limit, and
{"ok": true, "device": {...}}; the line before them lists the kernels
with their launches, errors, times and bounds. Exits non-zero without
printing them when no card is visible or when the script stands outside
its repository.
"""

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "automationlabsmodelpredictivecontrol_jl_torch"
TPU_OPS = "automationlabsmodelpredictivecontrol_jl_tpu/ops/admm_pallas.py"
SHAPES_OK_REL = 1e-4  # kernel vs plain, relative to max(1, ||plain||_inf)
U_OK = 5e-4  # plain re-solve vs kernel re-solve, absolute on u
CONV_OK = 0.999  # in-program converged fraction of the h20 paths
# the least time the card could take (H100 SXM data sheet): HBM bytes/s,
# and fp64 operations/s on the tensor cores (67 TFLOP/s; the FMA units
# give half); the kernels' work is fp64 multiply-adds
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 67e12

B_MAIN, BUCKET, B_CL, CL_STEPS = 16384, 512, 4096, 5
B_SLICE, B_RESOLVE, REPS = 2048, 256, 20


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
            kind = "K2" if "mixed" in name else "K1"
            targs = re.findall(r"Li(\d+)E", name)
            rows.append(dict(kernel=kind, rpt=[int(a) for a in targs],
                             registers=int(m.group(1)), spill_bytes=spill))
            name, spill = None, 0
    return rows


def cuda_ms(fn, reps=20):
    """Mean milliseconds of fn() over reps launches after one warm-up,
    from CUDA events."""
    import torch

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


def chunk_bound(n, m, B, R, refine_steps, chunk, mixed):
    """Least milliseconds of one chunk on the card: each input read and
    each output written once (the operators once, q, l, u, idx and the
    state x, s, y, ax in, the state out) over HBM bandwidth, against the
    fp64 multiply-adds of the K-solves (and the three A2 products) over the
    fp64 peak. Returns (bound_ms, bound_by)."""
    ms = m - n
    stacks = 2 if refine_steps else 1
    operator = stacks * R * n * n + 2 * R * m + n + ms * n
    lane = (2 * n + 5 * m + 1) + (n + 3 * m)
    nbytes = 4 * (operator + lane * B)
    macs = (1 + 2 * refine_steps) * n * n + (3 * ms * n if mixed else 0)
    ops = 2 * macs * B * chunk
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def compare_kernel(ctrl, B, seed, x0s_fn):
    """A kernel against its plain version at one shape, on the card; the
    kernel is K1 or K2 as the controller's operator says. Returns a
    record."""
    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
    from automationlabsmodelpredictivecontrol_jl_torch.ops.condense import (
        runtime_qp_vectors_batch,
    )

    dev = ctrl.device
    op, cfg = ctrl.engine.op, ctrl.engine.config
    R = int(op.rho_grid.shape[0])
    m, n = (int(d) for d in op.A_s.shape)
    kernel = admm_fused.chunk_fn_for(op)
    plain = admm_fused.chunk_fn_for(op, plain=True)
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
    idx = torch.from_numpy(rng.integers(0, R, size=B).astype(np.int32)).to(dev)
    chunk = int(cfg.check_interval)
    args = (op, qT, lT, uT, idx, x, s, y, ax, chunk, cfg)

    out_k = kernel(*args)
    out_p = plain(*args)
    torch.cuda.synchronize()
    abs_err, rel_err = 0.0, 0.0
    for a, b in zip(out_k, out_p):
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"{kernel.__name__} produced non-finite values")
        e = float((a - b).abs().max())
        abs_err = max(abs_err, e)
        rel_err = max(rel_err, e / max(1.0, float(b.abs().max())))
    rs = int(cfg.refine_steps)
    rec = dict(
        n=n, m=m, R=R, refine_steps=rs, B=B, chunk=chunk,
        max_abs_err=abs_err, max_rel_err=rel_err,
    )
    if rel_err > SHAPES_OK_REL:
        raise RuntimeError(f"{kernel.__name__} disagrees with its plain version: {rec}")
    rec["ms"] = cuda_ms(lambda: kernel(*args))
    rec["plain_ms"] = cuda_ms(lambda: plain(*args))
    rec["bound_ms"], rec["bound_by"] = chunk_bound(n, m, B, R, rs, chunk, bool(op.mixed_a))
    return rec


def timed(fn, reps):
    """fn() once, then reps timed calls on the host clock, each ending in
    a synchronize. Returns (first result, seconds per call)."""
    import numpy as np
    import torch

    out = fn()
    torch.cuda.synchronize()
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    return out, np.asarray(lat)


def profile(fn, reps):
    """torch.profiler over reps calls of fn() after one warm-up: device
    milliseconds per call (all kernels and copies; those of the port's own
    kernels apart), kernels per call, and the share of the wall time in
    which the card ran nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    ours = sum(e.time_range.elapsed_us() for e in dev if "admm_" in e.name) / 1e3
    return dict(
        wall_ms_per_call=wall_ms / reps, device_ms_per_call=busy / reps,
        port_kernels_ms_per_call=ours / reps, device_ops_per_call=len(dev) / reps,
        idle_share=1.0 - busy / wall_ms if dev else None,
    )


def check_solution(sol, B, N, tag):
    import torch

    for f in ("x", "u", "objective"):
        if not bool(torch.isfinite(getattr(sol, f)).all()):
            raise RuntimeError(f"non-finite {f} in {tag}")
    if tuple(sol.u.shape) != (B, 2, N) or tuple(sol.x.shape) != (B, 4, N + 1):
        raise RuntimeError(
            f"{tag}: unexpected shapes u {tuple(sol.u.shape)}, x {tuple(sol.x.shape)}"
        )


def plain_resolve(parallel, admm_fused, ctrl, x0s, config):
    """256 lanes solved with the kernel and with its plain version on the
    card: statuses equal and u within U_OK."""
    import torch

    s_k, _, _, _ = parallel.solve_batch_fused(ctrl, x0s)
    s_p, _, _, _ = parallel.solve_batch_fused(
        ctrl, x0s, chunk_fn=admm_fused.chunk_fn_for(ctrl.engine.op, plain=True)
    )
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
        "replaces": f"{TPU_OPS}:{replaces}",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,  # no single PyTorch call runs a 25-iteration ADMM chunk
        "shapes": shapes,
    }


def main():
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke.py: the {PKG} package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch import native_qp, parallel
    from automationlabsmodelpredictivecontrol_jl_torch import proceed_controller
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp
    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build, admm_fused
    from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig
    from automationlabsmodelpredictivecontrol_jl_torch.utils.devices import require_cuda

    # 1. the card
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
    tier1 = AdmmConfig(max_iter=75, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0)
    ctrl = design(tier1)
    fb = parallel.escalation_controller(
        ctrl, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250, refine_steps=2
    )
    if not (ctrl.engine.op.diag_a and fb.engine.op.diag_a):
        raise RuntimeError("the h20 box-only operator is expected to be diagonal")

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

    # 3. each kernel against its plain version at its main-path shapes
    k1_shapes = [compare_kernel(ctrl, B_MAIN, 1, bench_x0s),
                 compare_kernel(fb, BUCKET, 2, bench_x0s)]
    for rec in k1_shapes:
        log(phase="k1_vs_plain", **rec)
    k2_shapes = [compare_kernel(c, B_SLICE, 3 + i, x0s_fn)
                 for i, (c, x0s_fn) in enumerate(
                     ((ctrl_eq, suite_x0s), (ctrl_nb, suite_x0s),
                      (ctrl_sc, bench_x0s), (ctrl_scnb, bench_x0s)))]
    k2_shapes.append(compare_kernel(fb_sc, BUCKET, 7, bench_x0s))
    for rec in k2_shapes:
        log(phase="k2_vs_plain", **rec)

    # 4a. the K1 path, counted from zero
    x0s = torch.from_numpy(bench_x0s(B_MAIN)).to(dev)
    wz, wy = parallel.init_warm_batch(ctrl, B_MAIN)
    admm_fused.reset_counts()

    esc_solve = lambda: parallel.solve_batch_escalated(ctrl, fb, x0s, wz, wy, bucket=BUCKET)
    (sol, _, _, diag), lat = timed(esc_solve, REPS)
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
    slice_recs = []
    for kind, c in (("equality", ctrl_eq), ("neighborhood", ctrl_nb)):
        before = admm_fused.LAUNCHES["K2"]
        (sol_s, _, _, diag_s), lat = timed(lambda c=c: parallel.solve_batch_auto(c, x_suite), REPS)
        check_solution(sol_s, B_SLICE, 20, f"the {kind} slice")
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

    t0 = time.perf_counter()
    sol_sc, _, _, diag_sc = parallel.solve_batch_auto(ctrl_sc, x_bench)
    torch.cuda.synchronize()
    t_sc = time.perf_counter() - t0
    check_solution(sol_sc, B_SLICE, 20, "the state-constrained solve")
    log(phase="state_constrained", B=B_SLICE, m=int(ctrl_sc.engine.op.A_s.shape[0]),
        converged_fraction=int(diag_sc.n_converged) / B_SLICE,
        n_max_iter=int(diag_sc.n_max_iter), n_infeasible=int(diag_sc.n_infeasible),
        mean_iterations=float(diag_sc.mean_iterations), seconds=t_sc)

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

    # where the time goes in each cell (after the counts: these launches
    # are not the paths' runs)
    for cell, fn, reps in (
        ("h20-B16384-escalated", esc_solve, 5),
        ("suite-equality-B2048", lambda: parallel.solve_batch_auto(ctrl_eq, x_suite), 5),
        ("suite-neighborhood-B2048", lambda: parallel.solve_batch_auto(ctrl_nb, x_suite), 5),
        ("state-constrained-B2048", lambda: parallel.solve_batch_auto(ctrl_sc, x_bench), 2),
    ):
        log(phase="profile", cell=cell, reps=reps, **profile(fn, reps))

    # 256 lanes of each path re-solved with the kernel and with its plain
    # version on the card
    plain_resolve(parallel, admm_fused, ctrl, x0s[:B_RESOLVE], "K1 tier1")
    plain_resolve(parallel, admm_fused, fb, x0s[:B_RESOLVE], "K1 tier2")
    plain_resolve(parallel, admm_fused, ctrl_sc, x_bench[:B_RESOLVE], "K2 state-constrained")

    print(json.dumps({"kernels": [
        kernel_entry("admm_diag_chunk (K1)", "admm_diag.cu", 348, k1_launches, k1_shapes),
        kernel_entry("admm_mixed_chunk (K2)", "admm_mixed.cu", 580, k2_launches, k2_shapes),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
