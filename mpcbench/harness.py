"""One cell of BENCHMARK.json, run once: set-up, a measured window, an
optional traced pass, and the comparison with the plain reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<mix>.json`` (read by the generator
of its kind, ``kinds/<kind>.py``; see ``traffic.py``) and
``metrics/<metric>.py`` (a ``read(ctx)`` that returns a number, or None
where the run has nothing for it to read). From the program, the PyTorch
and CUDA port, the harness takes the controller, the batch entry
(``parallel.solve_batch_fused``, or ``parallel.solve_sharded`` over one
process a card) and its launch counters.

A batch runs from its dispatch to its results on the host: the lanes'
statuses, iterations and residuals and the batch's diagnostics (in a
sharded run, rank 0's copy of the fleet's reduced diagnostics).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import traffic
from .reference import mpc as ref_mpc
from .yardstick import models, stats

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT = "automationlabsmodelpredictivecontrol_jl_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "automationlabsmodelpredictivecontrol_jl_tpu")
DIAG_FIELDS = ("n_total", "n_converged", "n_max_iter", "n_infeasible", "max_primal_residual",
               "max_dual_residual", "mean_iterations", "max_iterations")
TRACE_BATCHES = 5  # steady batches profiled after the window of a traced run
OVERHEAD_BATCHES = 10  # batches a sharded traced run times alone and as a fleet
CERTIFIED = (0, 2)  # converged, or certified primal-infeasible
SOUND = (0, 1)  # the statuses a feasible box QP may end with


def forbidden_modules(names=None) -> List[str]:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (the port's own name begins with the JAX
    package's)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


# ----------------------------------------------------------------- discovery


def load_spec(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(spec: Dict, name: str) -> Dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(bench_dir: str, name: str) -> Dict:
    with open(os.path.join(bench_dir, "configs", f"{name}.json")) as f:
        return json.load(f)


def load_reader(bench_dir: str, name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_mpcbench_metric_{len(sys.modules)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(spec: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    whose ``workloads`` name it, and those without the key."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


# ------------------------------------------------------------------- program


def build_controller(cfg: Dict, device, overrides: Optional[Dict] = None):
    """The configuration's controller, designed by the port on ``device``."""
    port = importlib.import_module(PORT)
    plant = importlib.import_module(f"{PORT}.benchmarks.{cfg['plant']}")
    system = plant.linearized_discrete_system(x_op=cfg["x_op"], dt=cfg["sample_time"])
    solver = dict(cfg["solver"], **(overrides or {}))
    solver = {k: tuple(v) if isinstance(v, list) else v for k, v in solver.items()}
    kw = {}
    if cfg["engine"] == "riccati":
        kw["riccati_config"] = port.RiccatiConfig(**solver)
    else:
        kw["admm_config"] = importlib.import_module(f"{PORT}.ops.admm").AdmmConfig(**solver)
    if cfg["state_constraint"]:
        kw["mpc_state_constraint"] = True
    return port.proceed_controller(
        system, "model_predictive_control", cfg["horizon"], cfg["sample_time"],
        cfg["x_ref"], cfg["u_ref"], device=device, engine=cfg["engine"],
        mpc_Q=cfg["Q"], mpc_R=cfg["R"], mpc_terminal_ingredient=cfg["terminal"], **kw)


def program_design(ctrl) -> List:
    """(reference key, array) pairs of the design as it reaches the solve:
    the plant, weights and terminal cost of the controller and those its
    engine holds (the Riccati operator's, or the condensed QP)."""
    n = lambda t: t.detach().cpu().double().numpy()
    tun, eng = ctrl.tuning, ctrl.engine
    out = [("A", n(ctrl.system.A)), ("B", n(ctrl.system.B)), ("Q", n(tun.weights.Q)),
           ("R", n(tun.weights.R)), ("P", n(tun.terminal.P))]
    if hasattr(eng, "qp"):
        qp = eng.qp
        out += [("H", n(qp.P)), ("F", n(qp.q_x0)), ("v_lo_N", n(qp.l_const)),
                ("v_hi_N", n(qp.u_const))]
    else:
        op = eng.op
        out += [("A", n(op.factors.A)), ("B", n(op.factors.B)), ("Q", n(op.Q)),
                ("R", n(op.R_in)), ("P", n(op.P_term)), ("v_lo", n(op.u_lo)),
                ("v_hi", n(op.u_hi))]
    return out


def reference_arrays(design: ref_mpc.Design, keys) -> Dict[str, np.ndarray]:
    """The reference's arrays under the keys a program's design names."""
    out = design.arrays()
    if {"H", "F"} & set(keys):
        H, F, lo, hi = design.qp("cpu")
        out.update(H=H.numpy(), F=F.numpy(), v_lo_N=lo.numpy(), v_hi_N=hi.numpy())
    return out


def design_gap(pairs, design: ref_mpc.Design) -> float:
    """The largest relative gap, max |program - reference| / max |reference|,
    over the design's arrays."""
    ref = reference_arrays(design, [k for k, _ in pairs])
    return max(float(np.abs(v - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-300))
               for k, v in pairs)


def diag_vector(diag) -> torch.Tensor:
    return torch.stack([getattr(diag, k).double() for k in DIAG_FIELDS])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Session:
    """The program set up for a cell on one device: the controller and its
    batch entry, over a mesh of ranks where one is given, and the generator
    of the cell's traffic kind (``kinds/<kind>.py`` under ``bench_dir``)."""

    def __init__(self, cfg: Dict, mix: Dict, device, mesh=None, overrides=None,
                 bench_dir: str = HERE):
        self.cfg, self.mix, self.device, self.mesh = cfg, mix, torch.device(device), mesh
        self.kind = traffic.generator(bench_dir, mix["kind"])
        t0 = time.perf_counter()
        self.ctrl = build_controller(cfg, self.device, overrides)
        sync(self.device)
        self.design_s = time.perf_counter() - t0
        self.parallel = importlib.import_module(f"{PORT}.parallel")
        self.counters = importlib.import_module(f"{PORT}.ops.admm_fused")
        ranks = mesh.n if mesh is not None else 1
        self.rows = mix["lanes"] // ranks
        rank = mesh.rank if mesh is not None else 0
        self.row0 = rank * self.rows

    def source(self, seed: int):
        """The traffic's batches from ``seed``."""
        return self.kind.Source(self.mix, seed, self.cfg["nx"], self.device)

    def solve(self, x0s):
        if self.mesh is None:
            return self.parallel.solve_batch_fused(self.ctrl, x0s)
        return self.parallel.solve_sharded(self.ctrl, x0s, self.mesh, fused=True)

    def solve_rows(self, x0s):
        """This rank's rows alone, on the batch entry."""
        rows = x0s[self.row0:self.row0 + self.rows]
        return self.parallel.solve_batch_fused(self.ctrl, rows)


class Window:
    """A measured window, which a traffic kind's ``run_window`` drives batch
    by batch. It keeps what the metrics and the judge read: each batch's
    ms, its lanes' statuses, iterations and residuals (this rank's rows),
    its diagnostics, the sampled lanes' inputs and answers, and the port's
    launch counters over the window."""

    def __init__(self, session: Session):
        self.session = session
        self.batch_ms: List[float] = []
        self.lanes: List[List[np.ndarray]] = []  # per batch: status, iterations, rp, rd
        self.diags: List[np.ndarray] = []
        self.samples: List[Dict] = []
        self.launches: Dict[str, int] = {}
        self.plain_calls = 0
        c = session.counters
        self._launches0, self._plain0 = dict(c.LAUNCHES), sum(c.PLAIN_CALLS.values())
        self.start = time.perf_counter()
        self.seconds = 0.0  # the window's first dispatch to its last batch's results

    def batch(self, x0s, source, keep: bool = True):
        """Solve one batch through the session's entry, timed from its
        dispatch to its results on the host, and keep it; returns the
        solution."""
        s = self.session
        t0 = time.perf_counter()
        sol, _, _, diag = s.solve(x0s)
        host = [t.cpu().numpy() for t in (sol.status, sol.iterations, sol.primal_residual,
                                          sol.dual_residual, diag_vector(diag))]
        t1 = time.perf_counter()
        b = len(self.batch_ms)
        self.batch_ms.append((t1 - t0) * 1e3)
        self.lanes.append(host[:4])
        self.diags.append(host[4])
        self.seconds = t1 - self.start
        if keep:
            status, iters = host[0], host[1]
            idx = set(source.sample(b, s.rows).tolist())
            idx.add(int(np.argmax(iters)))  # the batch's slowest lane
            idx = sorted(idx)
            it = torch.as_tensor(idx, device=sol.u.device)
            rows = x0s[s.row0:s.row0 + s.rows]
            self.samples.append(dict(batch=b, lanes=idx, x0=rows[it], u=sol.u[it], x=sol.x[it],
                                     status=status[idx], iterations=iters[idx]))
        return sol

    def close(self) -> "Window":
        c = self.session.counters
        self.launches = {k: c.LAUNCHES[k] - self._launches0[k] for k in c.LAUNCHES}
        self.plain_calls = sum(c.PLAIN_CALLS.values()) - self._plain0
        return self


def run_window(session: Session, source, seconds: float, stop: Callable[[float], bool] = None,
               keep: bool = True) -> Window:
    """The cell's traffic kind's window on ``source``."""
    return session.kind.run_window(session, source, seconds, stop=stop, keep=keep)


# --------------------------------------------------------------------- trace


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and arguments."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0][:120]


def device_trace(fn: Callable[[], None], device) -> Dict:
    """``torch.profiler`` with CUDA activity only around ``fn``: the traced
    window's host seconds, the seconds in which a kernel, copy or set ran on
    the card, each kernel's seconds by name, and the longest idle gaps,
    named by the operation before them. On the CPU (the tests) the host's
    operators stand in for the card's."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    cats = ("kernel", "gpu_memcpy", "gpu_memset") if cuda else ("cpu_op",)
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        window_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ops = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), short_name(e["name"]))
           for e in events
           if e.get("ph") == "X" and e.get("cat") in cats]
    ops.sort()
    by_name: Dict[str, float] = {}
    busy, gaps, end, prev = 0.0, [], None, None
    for s, e, name in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        if end is None or s > end:
            if end is not None:
                gaps.append((f"after {prev}", (s - end) * 1e-6))
            busy += (e - s) * 1e-6
            end = e
        elif e > end:
            busy += (e - end) * 1e-6
            end = e
        prev = name
    gaps.sort(key=lambda g: -g[1])
    return dict(window_s=window_s, busy_s=busy, kernels=by_name, gaps=gaps[:10])


# --------------------------------------------------------------------- judge


def judge(cfg: Dict, design_pairs, samples: List[Dict], lanes: List[List[np.ndarray]],
          diags: List[np.ndarray], plain_calls: Optional[int], device,
          limits: Optional[Dict] = None) -> Dict[str, Dict]:
    """The numbers that decide ``correct``, each with its limit.

    ``lanes`` holds every batch's lanes (each rank's rows, in rank order),
    ``diags`` the diagnostics the program reported for each batch. The
    reference solves the sampled lanes' QPs in float64 on ``device``."""
    t0 = time.perf_counter()
    limits = dict(cfg["limits"] if limits is None else limits)
    design = ref_mpc.Design(cfg)
    checks = {"design_gap": design_gap(design_pairs, design)}
    x0 = torch.cat([torch.as_tensor(s["x0"]).reshape(-1, cfg["nx"]) for s in samples])
    u = torch.cat([torch.as_tensor(s["u"]) for s in samples]).double()
    x = torch.cat([torch.as_tensor(s["x"]) for s in samples]).double()
    u_ref, x_ref, kkt = ref_mpc.solve(design, x0.double(), device)
    if float(kkt.max()) > ref_mpc.KKT_TOL:
        raise RuntimeError(f"the reference's own KKT residual {float(kkt.max())} is over its tolerance")
    # the program's layout is (lane, nu, N) and (lane, nx, N+1)
    checks["u_gap"] = float((u.to(device).transpose(1, 2) - u_ref).abs().max())
    checks["x_gap"] = float((x.to(device).transpose(1, 2) - x_ref).abs().max())
    wrong, mism = 0, 0
    for batch, d in zip(lanes, diags):
        status, iters, rp, rd = (np.concatenate(p) for p in zip(*batch))
        wrong += int(np.count_nonzero(~np.isin(status, SOUND)))
        want = ref_mpc.recompute_diagnostics(status, iters, rp, rd)
        mism += int(ref_mpc.diagnostics_mismatch(dict(zip(DIAG_FIELDS, d.tolist())), want))
    checks["status_wrong"] = wrong
    checks["diag_mismatch"] = mism
    limits.update(status_wrong=0, diag_mismatch=0)
    if plain_calls is not None:
        checks["plain_calls"] = plain_calls
        limits["plain_calls"] = 0
    print(f"mpcbench: the reference compared {x0.shape[0]} lanes and {len(lanes)} batches in "
          f"{time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)
    return {k: {"value": v, "limit": limits.get(k)} for k, v in checks.items()}


def is_correct(checks: Dict[str, Dict]) -> bool:
    return all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())


# ----------------------------------------------------------------------- run


def metric(value: float, unit: str) -> Dict:
    return {"value": value, "unit": unit}


def end_to_end(spec: Dict, cell: str, w_ms: List[float], solves: int, window_s: float,
               setup_s: float) -> Dict:
    values = {
        "solves_per_s": (solves / window_s, "solves/s"),
        "batch_p95_ms": (stats.percentile(w_ms, 95), "ms"),
        "setup_s": (setup_s, "s"),
    }
    return {m["name"]: metric(*values[m["name"]]) for m in cell_metrics(spec, cell, "end_to_end")}


def per_layer(spec: Dict, cell: str, ctx: Dict, bench_dir: str = HERE) -> Dict:
    out = {}
    for m in cell_metrics(spec, cell, "per_layer"):
        value = load_reader(bench_dir, m["name"])(ctx)
        if value is not None:
            out[m["name"]] = metric(value, m["unit"])
    return out


def report(result: Dict, checks: Dict[str, Dict], out=sys.stdout, err=sys.stderr) -> None:
    """Print each number compared beside its limit as the last lines on
    standard error, and the result line, checks last, on standard output."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err, flush=True)
    result["checks"] = checks
    print(json.dumps(result), file=out, flush=True)


def device_record(device, count: int, peak: int) -> Dict:
    return {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(device) if torch.device(device).type == "cuda"
            else "cpu", "count": count, "memory_peak_bytes": int(peak)}


def run_single(spec: Dict, cell: Dict, cfg: Dict, mix: Dict, seed: int, seconds: float,
               trace: bool, t_start: float, device, out=sys.stdout, err=sys.stderr,
               patch: Optional[Callable] = None, bench_dir: str = HERE) -> int:
    """One cell on one device. ``patch(session)`` may break the timed path
    (the fault tests); ``bench_dir`` holds the traffic kinds and the
    metrics' readers."""
    session = Session(cfg, mix, device, bench_dir=bench_dir)
    if patch is not None:
        patch(session)
    source = session.source(seed)
    session.kind.warm_up(session, source)
    sync(device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    w = run_window(session, source, seconds)
    traced = None
    if trace:
        traced = device_trace(lambda: run_window(session, source, 0, stop=_after(TRACE_BATCHES),
                                                 keep=False), device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    design_pairs = program_design(session.ctrl)
    samples = [{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in s.items()} for s in w.samples]
    design_s = session.design_s
    del session
    if cuda:
        torch.cuda.empty_cache()
    return finish(spec, cell, cfg, mix, w, [[b] for b in w.lanes], samples, design_pairs,
                  w.plain_calls if cuda else None, device, 1, peak, setup_s, design_s,
                  traced, traced["busy_s"] if traced else None, out=out, err=err,
                  bench_dir=bench_dir)


def finish(spec: Dict, cell: Dict, cfg: Dict, mix: Dict, w: Window, lanes, samples, design_pairs,
           plain_calls: Optional[int], device, count: int, peak: int, setup_s: float,
           design_s: float, traced: Optional[Dict], busy_s: Optional[float],
           sharded: Optional[Dict] = None, out=sys.stdout, err=sys.stderr,
           bench_dir: str = HERE) -> int:
    """Judge the window's answers, and print the result line (the
    end-to-end metrics, or with ``traced`` the per-layer ones) with each
    number compared beside its limit. ``lanes`` holds every batch's lanes,
    each rank's rows in rank order; ``busy_s`` is the card's busy seconds
    averaged over the ranks. Returns the exit code: 3, printing no result,
    where modules of JAX or the JAX package are loaded."""
    checks = judge(cfg, design_pairs, samples, lanes, w.diags, plain_calls, device)
    statuses = np.concatenate([np.concatenate([r[0] for r in b]) for b in lanes])
    solves = int(np.count_nonzero(np.isin(statuses, CERTIFIED)))
    result = {"correct": is_correct(checks), "attempted": int(statuses.size),
              "failed": int(statuses.size - solves)}
    dev = device_record(device, count, peak)
    if traced is not None:
        ctx = context(cfg, mix, w, design_s, traced, device, sharded=sharded)
        result["metrics"] = per_layer(spec, cell["name"], ctx, bench_dir)
        dev.update(busy_s=busy_s, window_s=traced["window_s"])
        result["breakdown"] = breakdown(traced)
    else:
        result["metrics"] = end_to_end(spec, cell["name"], w.batch_ms, solves, w.seconds, setup_s)
    result["device"] = dev
    found = forbidden_modules()
    if found:
        print(f"mpcbench: modules of JAX or the JAX package are loaded: {found}", file=err)
        return 3
    report(result, checks, out, err)
    return 0


def _after(n: int) -> Callable[[float], bool]:
    count = [0]

    def stop(_elapsed):
        count[0] += 1
        return count[0] >= n

    return stop


def context(cfg, mix, w: Window, design_s: float, traced: Optional[Dict], device,
            sharded: Optional[Dict] = None) -> Dict:
    """What the per-layer readers read."""
    kind = torch.cuda.get_device_name(device) if torch.device(device).type == "cuda" else "cpu"
    return dict(config=cfg, mix=mix, design_s=design_s, batch_ms=list(w.batch_ms),
                batches=len(w.batch_ms), launches=dict(w.launches), device_kind=kind,
                work=models.batch_work(cfg, mix["lanes"] // mix["ranks"])
                if cfg["work"]["lane_iterations"] is not None else None,
                trace=traced, trace_batches=TRACE_BATCHES, sharded=sharded)


def breakdown(traced: Dict) -> Dict:
    ops = sorted(traced["kernels"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in traced["gaps"][:10]]}


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    spec = load_spec()
    cell = find_cell(spec, a.workload)
    cfg = load_config(HERE, cell["config"])
    mix = traffic.load(HERE, cell["traffic"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"] or mix["ranks"] > cell["chips"]:
        print(f"mpcbench: {a.workload} needs {cell['chips']} CUDA devices, sees {have}",
              file=sys.stderr)
        return 2
    # build caches at fixed paths inside the checkout (the port's kernels
    # build into its own build/kernels/)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    torch.set_num_threads(4)
    if mix["ranks"] > 1:
        from . import sharded

        return sharded.launch(spec, cell, cfg, mix, a.seed, a.seconds, bool(a.trace), t_start)
    importlib.import_module(f"{PORT}.ops._build").build_kernels()
    return run_single(spec, cell, cfg, mix, a.seed, a.seconds, bool(a.trace), t_start, "cuda:0")
