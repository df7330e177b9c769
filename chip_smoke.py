"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path at full size: the QTP plant at horizon 20
(n = m = 40, box constraints), 16384 scenarios, tier 1 on the fused
diagonal-A ADMM kernel K1 (rho grid (1, 10), no refinement, 75
iterations), stragglers gathered on the device into a 512-lane bucket for
tier 2 (rho grid (0.1, 1, 10, 100), 2 refinement steps, 250 iterations),
then the host f64 oracle; and a 4096-lane closed loop on the true plant.

Phases (any failure raises and exits non-zero):
1. the card: its name, count, and power limit from nvidia-smi;
2. build: csrc/*.cu with nvcc (its -Xptxas -v report is printed) and the
   native oracle with g++, both into build/;
3. K1 against its plain PyTorch version on the card at both main-path
   shapes, with times from CUDA events;
4. the slice, with launch counts showing it went through K1, and a
   re-solve of 256 lanes with the plain version.

The last two lines are the card's name and power limit, and
{"ok": true, "device": {...}}. Exits non-zero without printing them when
no card is visible or when the script stands outside its repository.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "automationlabsmodelpredictivecontrol_jl_torch"
SHAPES_OK_REL = 1e-4  # K1 vs plain, relative to max(1, ||plain||_inf)
U_OK = 5e-4  # plain re-solve vs K1 re-solve, absolute on u


def log(**kv):
    print(json.dumps(kv), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def compare_k1(ctrl, B, seed):
    """K1 vs the plain version at one shape; returns a record."""
    import numpy as np
    import torch

    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused
    from automationlabsmodelpredictivecontrol_jl_torch.ops.condense import (
        runtime_qp_vectors_batch,
    )

    dev = ctrl.device
    op, cfg = ctrl.engine.op, ctrl.engine.config
    R = int(op.rho_grid.shape[0])
    n = int(op.A_s.shape[1])
    x0s = torch.from_numpy(bench_x0s(B)).to(dev)
    q, l, u, _, _ = runtime_qp_vectors_batch(
        ctrl.engine.qp, x0s - ctrl.tuning.references.x[:, 0]
    )
    qT = ((op.c * op.D)[:, None] * q.T).contiguous()
    lT = (op.E[:, None] * l.T).contiguous()
    uT = (op.E[:, None] * u.T).contiguous()
    rng = np.random.default_rng(seed)
    x, y, ax = (
        torch.from_numpy((0.05 * rng.standard_normal((n, B))).astype(np.float32)).to(dev)
        for _ in range(3)
    )
    s = torch.clamp(ax, lT, uT).contiguous()
    idx = torch.from_numpy(rng.integers(0, R, size=B).astype(np.int32)).to(dev)
    args = (op, qT, lT, uT, idx, x, s, y, ax, cfg.check_interval, cfg)

    out_k = admm_fused.iterate_chunk_diag_T(*args)
    out_p = admm_fused.iterate_chunk_diag_T_plain(*args)
    torch.cuda.synchronize()
    abs_err, rel_err = 0.0, 0.0
    for a, b in zip(out_k, out_p):
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError("K1 produced non-finite values")
        e = float((a - b).abs().max())
        abs_err = max(abs_err, e)
        rel_err = max(rel_err, e / max(1.0, float(b.abs().max())))
    rec = dict(
        n=n, R=R, refine_steps=int(cfg.refine_steps), B=B,
        chunk=int(cfg.check_interval), max_abs_err=abs_err, max_rel_err=rel_err,
    )
    if rel_err > SHAPES_OK_REL:
        raise RuntimeError(f"K1 disagrees with its plain version: {rec}")
    rec["ms"] = cuda_ms(lambda: admm_fused.iterate_chunk_diag_T(*args))
    rec["plain_ms"] = cuda_ms(lambda: admm_fused.iterate_chunk_diag_T_plain(*args))
    return rec


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
        torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build from the checkout's sources
    t0 = time.perf_counter()
    ptxas = _build.build_kernels(force=True)
    t_nvcc = time.perf_counter() - t0
    print(ptxas.strip(), flush=True)
    t0 = time.perf_counter()
    native_qp.build(force=True)
    t_gxx = time.perf_counter() - t0
    _build.load_kernels()
    log(phase="build", nvcc_s=t_nvcc, gxx_s=t_gxx)

    # the main-path controllers, designed on the host and moved to the card
    B, BUCKET = 16384, 512
    tier1 = AdmmConfig(max_iter=75, rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0)
    ctrl = proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control", 20, 5.0,
        [0.65] * 4, [1.2] * 2, admm_config=tier1, device=dev,
    )
    fb = parallel.escalation_controller(
        ctrl, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250, refine_steps=2
    )
    if not (ctrl.engine.op.diag_a and fb.engine.op.diag_a):
        raise RuntimeError("the h20 box-only operator is expected to be diagonal")

    # 3. K1 against its plain version at both main-path shapes
    shapes = [compare_k1(ctrl, B, seed=1), compare_k1(fb, BUCKET, seed=2)]
    for rec in shapes:
        log(phase="k1_vs_plain", **rec)

    # 4. the slice, counted from zero
    x0s = torch.from_numpy(bench_x0s(B)).to(dev)
    wz, wy = parallel.init_warm_batch(ctrl, B)
    admm_fused.K1_LAUNCHES = 0
    admm_fused.PLAIN_CALLS = 0

    sol, _, _, diag = parallel.solve_batch_escalated(ctrl, fb, x0s, wz, wy, bucket=BUCKET)
    torch.cuda.synchronize()
    for f in ("x", "u", "objective"):
        v = getattr(sol, f)
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"non-finite {f} in the escalated solve")
    if tuple(sol.u.shape) != (B, 2, 20) or tuple(sol.x.shape) != (B, 4, 21):
        raise RuntimeError(f"unexpected shapes u {tuple(sol.u.shape)}, x {tuple(sol.x.shape)}")
    conv = int(diag.n_converged) / B
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        sol, _, _, diag = parallel.solve_batch_escalated(ctrl, fb, x0s, wz, wy, bucket=BUCKET)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat)
    log(phase="escalated", B=B, bucket=BUCKET, converged_fraction=conv,
        mean_iterations=float(diag.mean_iterations),
        max_iterations=int(diag.max_iterations),
        batch_p50_ms=float(np.percentile(lat, 50)) * 1e3,
        batch_p99_ms=float(np.percentile(lat, 99)) * 1e3,
        solves_per_s=B / float(np.median(lat)))

    esc = parallel.make_escalated_solver(ctrl, fallback=fb, min_bucket=BUCKET)
    t0 = time.perf_counter()
    sol_e, _, _, diag_e = esc(x0s)
    torch.cuda.synchronize()
    t_esc = time.perf_counter() - t0
    conv_final = int(diag_e.n_converged) / B
    log(phase="three_tier", converged_fraction_final=conv_final,
        host_tier_lanes=int((sol.status != 0).sum()), seconds=t_esc)

    B_cl, steps = 4096, 5
    t0 = time.perf_counter()
    xs_cl, us_cl, st_cl = parallel.closed_loop_batch(
        ctrl, qtp.qtp_discrete_step, x0s[:B_cl], steps
    )
    torch.cuda.synchronize()
    t_cl = time.perf_counter() - t0
    if not bool(torch.isfinite(xs_cl).all()) or tuple(xs_cl.shape) != (steps + 1, B_cl, 4):
        raise RuntimeError("closed loop produced non-finite or misshapen states")
    cl_ok = float((st_cl == 0).float().mean())
    log(phase="closed_loop", lanes=B_cl, steps=steps, converged_step_fraction=cl_ok,
        steps_per_s=B_cl * steps / t_cl, seconds=t_cl)

    launches, plain_calls = admm_fused.K1_LAUNCHES, admm_fused.PLAIN_CALLS
    log(phase="counts", k1_launches=launches, plain_calls=plain_calls)
    if launches <= 0:
        raise RuntimeError("the main path never launched K1")
    if plain_calls != 0:
        raise RuntimeError("the main path ran the plain version")
    if conv < 0.999 or conv_final != 1.0:
        raise RuntimeError(f"convergence too low: {conv}, final {conv_final}")

    # 256 of the lanes re-solved with K1 and with the plain version on the
    # card, at the tier-1 and the tier-2 config
    x256 = x0s[:256]
    for tier, c in (("tier1", ctrl), ("tier2", fb)):
        s_k, _, _, _ = parallel.solve_batch_fused(c, x256)
        s_p, _, _, _ = parallel.solve_batch_fused(
            c, x256, chunk_fn=admm_fused.iterate_chunk_diag_T_plain
        )
        du = float((s_k.u - s_p.u).abs().max())
        same = bool(torch.equal(s_k.status, s_p.status))
        log(phase="plain_resolve", config=tier, lanes=256, max_abs_u_diff=du,
            statuses_equal=same, converged_k1=int((s_k.status == 0).sum()),
            converged_plain=int((s_p.status == 0).sum()))
        if du > U_OK or not same:
            raise RuntimeError(f"plain re-solve disagrees with K1 at the {tier} config")

    head = shapes[0]
    print(json.dumps({"kernels": [{
        "name": "admm_diag_chunk (K1)",
        "route": "cuda",
        "source": f"{PKG}/csrc/admm_diag.cu",
        "replaces": "automationlabsmodelpredictivecontrol_jl_tpu/ops/admm_pallas.py:348",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "shapes": shapes,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
