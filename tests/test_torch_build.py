"""The ctypes signatures of the kernel library against the C sources.

The library is built and loaded only on a machine with a card, so this is
the one check that runs everywhere: every ``extern "C"`` entry of
``csrc/*.cu`` has a row in ``_build.SIGNATURES`` with the same parameters
in the same order, and no row names a missing entry."""

import glob
import os
import re

import pytest

from automationlabsmodelpredictivecontrol_jl_torch.ops import _build

_ENTRY = re.compile(r"^int\s+(\w+)\(([^)]*)\)\s*\{", re.MULTILINE)


def _kind(param: str) -> str:
    param = param.strip()
    if "*" in param:
        return "p"
    return {"int": "i", "float": "f"}[param.split()[0]]


def _c_entries():
    entries = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu"))):
        text = open(path).read()
        if 'extern "C" {' not in text:  # a register tier of K3: no entry of its own
            continue
        body = text[text.index('extern "C" {'):]
        for name, params in _ENTRY.findall(body):
            entries[name] = "".join(_kind(p) for p in params.split(","))
    return entries


def test_signatures_match_the_c_entries():
    entries = _c_entries()
    assert set(entries) == set(_build.SIGNATURES)
    for name, params in entries.items():
        assert _build.SIGNATURES[name] == params, name
        assert params.endswith("p"), f"{name}: the stream comes last"


def _c_params(entry):
    """The parameter names of a C entry of csrc/*.cu, in order."""
    for path in sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu"))):
        for name, params in _ENTRY.findall(open(path).read()):
            if name == entry:
                return [p.strip().split()[-1].lstrip("*") for p in params.split(",")]
    raise AssertionError(f"no C entry {entry}")


def test_k3w_entries_take_the_wrappers_arguments():
    """riccati_wide_chunk's (the doubling form's) and riccati_wide_seq_chunk's
    (the sequential form's) parameters are the ones _launch_k3w passes, in
    its order: the factor stacks, the plant, the doubling-level arrays or
    the transposes K', G', A', B', the boxes and the lane state, the
    outputs and the scratch, then the shape, the flags and k3w_plan's
    layout (the doubling form's ints as the wrapper passes them, caught on
    the CPU at the launch); the wide rollout and certificate take K3's
    recurrences' tensors (the rollout A' and B'), a scratch and
    wide_recurrence_plan's layout, as their wrappers pass them."""
    import dataclasses

    import torch

    from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati, riccati_fused

    params = _c_params("riccati_wide_chunk")
    sig = _build.SIGNATURES["riccati_wide_chunk"]
    assert params[:7] == ["Kf", "Gf", "Bm", "bwdL", "bwdF", "fwdL", "fwdF"]
    assert params[27] == "scratch"
    ints = [p for p, kind in zip(params, sig) if kind == "i"]
    assert ints == [
        "N", "nx", "nu", "B", "R", "L", "chunk", "split_interior", "split_terminal",
        "terminal_ball", "lanes", "threads", "lanes_per_thread", "ring", "panel", "route",
        "smem_bytes"]
    op = riccati.build_riccati_operator(
        [[0.9, 0.1], [0.0, 0.8]], [[1.0], [0.5]], [[1.0, 0.0], [0.0, 1.0]], [[1.0]],
        [[1.0, 0.0], [0.0, 1.0]], 5, [-1.0, -1.0], [1.0, 1.0], [-1.0], [1.0], True)
    op = dataclasses.replace(op, split_terminal=True)
    B = 9
    zeros = lambda *shape: torch.zeros(shape)
    args = (op, torch.zeros(1, dtype=torch.int32), zeros(2, B), zeros(B), zeros(6, 2, B),
            zeros(5, 1, B), zeros(6, 2, B), zeros(5, 1, B), 3)
    caught = []
    launch = riccati_fused._launch
    try:
        riccati_fused._launch = lambda kernel, entry, a, outs, ii: caught.append(
            (entry, [name for name, *_ in a], len(outs), ii)) or tuple(outs)
        plan = riccati_fused.k3w_plan(op, B, True, "global", lanes=4, lanes_per_thread=2)
        riccati_fused._launch_k3w(*args, doubling=True, plan=plan)
    finally:
        riccati_fused._launch = launch
    (entry, names, n_out, got), = caught
    assert entry == "riccati_wide_chunk" and len(names) + n_out == 28
    assert names[:7] == ["K", "G", "B", "bwd_levels", "bwd_full", "fwd_levels", "fwd_full"]
    values = dict(N=5, nx=2, nu=1, B=B, R=len(op.rho_grid), L=3, chunk=3, split_interior=1,
                  split_terminal=1, terminal_ball=0, lanes=4, threads=plan.threads,
                  lanes_per_thread=2, ring=plan.ring, panel=plan.panel, route=2,
                  smem_bytes=plan.smem_bytes)
    assert list(got) == [values[name] for name in ints]
    params = _c_params("riccati_wide_seq_chunk")
    sig = _build.SIGNATURES["riccati_wide_seq_chunk"]
    assert params[:7] == ["K", "KT", "GT", "AmBK", "Bm", "AT", "BT"]
    assert params[27] == "scratch"
    assert [p for p, kind in zip(params, sig) if kind == "i"] == [
        "N", "nx", "nu", "B", "R", "chunk", "split_interior", "split_terminal",
        "terminal_ball", "lanes", "threads", "ring", "plant_shared", "route", "smem_bytes"]
    # the wide rollout and certificate: K3's recurrences' tensors (the
    # rollout's plant as A', B'), a scratch, the shape, the certificate's
    # flags and wide_recurrence_plan's layout, as their wrappers pass them
    layout = ["lanes", "threads", "rows_per_thread", "lanes_per_thread", "place", "route",
              "smem_bytes"]
    roll, cert = _c_params("riccati_wide_rollout"), _c_params("riccati_wide_certificate")
    assert roll == ["AT", "BT", "e0", "U", "X", "scratch", "N", "nx", "nu", "B", *layout,
                    "stream"]
    k3 = _c_params("riccati_certificate")
    assert cert[:15] == k3[:15] and cert[15:] == [
        "scratch", "N", "nx", "nu", "B", "split_interior", "split_terminal", "terminal_ball",
        *layout, "stream"]
    caught = []
    try:
        riccati_fused._launch = lambda kernel, entry, a, outs, ii: caught.append(
            (entry, [name for name, *_ in a], len(outs), ii)) or tuple(outs)
        for kernel, force in (("rollout", {}), ("certificate", dict(route="device"))):
            plan = riccati_fused.wide_recurrence_plan(op, B, kernel, **force)
            if kernel == "rollout":
                riccati_fused._launch_rollout_wide(op, args[2], args[5], plan=plan)
            else:
                riccati_fused._launch_certificate_wide(op, args[4], args[6], args[5], args[7],
                                                       args[4], args[3], plan=plan)
            entry, names, n_out, got = caught.pop()
            params = roll if kernel == "rollout" else cert
            sig = _build.SIGNATURES[entry]
            assert entry == f"riccati_wide_{kernel}" and len(names) + n_out == sig.count("p") - 1
            values = dict(N=5, nx=2, nu=1, B=B, split_interior=1, split_terminal=1,
                          terminal_ball=0, lanes=plan.lanes, threads=plan.threads,
                          rows_per_thread=plan.rows_per_thread,
                          lanes_per_thread=plan.lanes_per_thread,
                          place=riccati_fused.WIDE_REC_PLACES.index(plan.place),
                          route=riccati_fused.WIDE_REC_ROUTES.index(plan.route),
                          smem_bytes=plan.smem_bytes)
            assert list(got) == [values[p] for p, kind in zip(params, sig) if kind == "i"]
    finally:
        riccati_fused._launch = launch


def test_k3w_lane_floats_match_the_source():
    """k3w_dbl_floats is csrc/riccati_wide.cu's dbl_layout (the doubling
    form's work area and shared memory): each region's floats and the step
    strides, read from the source (n = N, x = nx, u = nu, l = lanes), summed
    as the plan sums them, at several shapes, tiles and routes."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati_fused

    text = open(os.path.join(_build.CSRC_DIR, "riccati_wide.cu")).read()
    body = text[text.index("inline DblLayout dbl_layout("):]
    body = body[:body.index("return d;")]
    regions = dict(re.findall(r"d\.(\w+) = o, o \+= ([^;]+);", body))
    assert set(regions) == {"ha", "hb", "ff", "s", "y", "e0", "sc", "ring", "plant", "wbase"}
    assert "d.ks = dbl_stride(x, l, lt);" in body and "d.ku = dbl_stride(u, l, lt);" in body
    assert "d.work = pad4(o);" in body
    assert "if (route == 0) o += (2 * n * u + 2 * static_cast<size_t>(xrows) * x) * l;" in body
    stride = text[text.index("inline size_t dbl_stride("):]
    assert "return (s / unit) % 2 == 0 ? s + unit : s;" in stride[:stride.index("}")]
    pad4 = lambda n: -(-n // 4) * 4

    def dbl_stride(rows, lanes, lt):
        unit = min(lt, 4)
        return rows * lanes + (unit if (rows * lanes // unit) % 2 == 0 else 0)

    for n, x, u, xrows in ((1, 1, 1, 1), (30, 64, 32, 0), (500, 4, 2, 500), (7, 3, 7, 1)):
        for l, lt, ring, panel in ((1, 1, 3, 8500), (8, 8, 3, 4008), (8, 2, 2, 852),
                                   (32, 4, 3, 4100)):
            for route in range(3):
                env = dict(n=n, x=x, u=u, l=l, nu=u, kRt=4, pad4=pad4, ring=ring, panel=panel,
                           route=route, d=type("D", (), dict(ks=dbl_stride(x, l, lt),
                                                             ku=dbl_stride(u, l, lt))))
                conv = lambda v: v.replace("static_cast<size_t>(ring)", "ring").replace(
                    "nu > kRt ? n * d.ku : 0", "(n * d.ku if nu > kRt else 0)").replace(
                    "route < 2 ? d.work : 0", "(work if route < 2 else 0)")
                sizes = {}
                for key in ("ha", "hb", "ff", "s", "y", "e0", "sc"):
                    sizes[key] = eval(conv(regions[key]), env)
                work = pad4(sum(sizes.values()))
                env["work"] = work
                total = sum(eval(conv(regions[k]), env) for k in ("ring", "plant", "wbase"))
                total += (2 * n * u + 2 * xrows * x) * l if route == 0 else 0
                name = riccati_fused.K3W_DBL_ROUTES[route]
                assert riccati_fused.k3w_dbl_floats(n, x, u, xrows, l, lt, ring, panel, name) == (
                    work, total)


def test_wide_rec_bytes_match_the_source():
    """wide_rec_bytes is csrc/riccati_wide_rec.cu's rollout_layout and
    certificate_layout: each region's bytes, read from the source and
    evaluated at several shapes, tiles, threads, placements and routes,
    summed as the plan sums them; and the ring's slots."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati_fused

    text = open(os.path.join(_build.CSRC_DIR, "riccati_wide_rec.cu")).read()
    assert f"constexpr int kRing = {riccati_fused.WIDE_REC_RING};" in text
    assert f"constexpr int kRecMaxThreads = {riccati_fused.WIDE_REC_MAX_THREADS};" in text
    a16 = lambda n: -(-n // 16) * 16
    pad_to = lambda n, m: -(-n // m) * m
    op_width = lambda place: {0: 8, 1: 4, 2: 0}[place]
    for kernel in riccati_fused.WIDE_REC_KERNELS:
        body = text[text.index(f"inline RecLayout {kernel}_layout("):]
        body = body[:body.index("return d;")]
        regions = dict(re.findall(r"d\.(\w+) = ([^;]+);", body))
        assert set(regions) == {"ops", "red", "e", "u", "bu", "lane", "total"}, kernel
        assert regions["total"] == "d.ops + d.red + d.lane * (route == 0)"
        for nx, nu in ((1, 1), (3, 7), (64, 32), (160, 80), (6000, 3)):
            for lanes, rt, threads in ((1, 1, 32), (8, 4, 128), (16, 2, 192), (32, 4, 512)):
                for place, name in enumerate(riccati_fused.WIDE_REC_PLACES):
                    for route, where in enumerate(riccati_fused.WIDE_REC_ROUTES):
                        env = dict(a16=a16, pad_to=pad_to, op_width=op_width, x=nx, u=nu,
                                   kRing=riccati_fused.WIDE_REC_RING,
                                   l=lanes, xp=pad_to(nx, rt), w=threads // 32, place=place,
                                   route=route, cols=pad_to(nx, rt) + pad_to(nu, rt),
                                   nx=nx, nu=nu, rt=rt)
                        d = {}
                        for key in ("ops", "red", "e", "u", "bu", "lane", "total"):
                            expr = regions[key].replace("d.", "d_")
                            d[key] = int(eval(expr, env, {f"d_{k}": v for k, v in d.items()}))
                        got = riccati_fused.wide_rec_bytes(kernel, nx, nu, lanes, rt, threads,
                                                           name, where)
                        assert got == (d["lane"], d["total"]), (kernel, nx, nu, lanes, rt,
                                                                name, where)


def test_k3w_seq_floats_match_the_source():
    """k3w_seq_floats is csrc/riccati_wide_seq.cu's seq_layout: each region's
    floats, read from the source (x = nx, u = nu, l = lanes), summed as the
    plan sums them, at several shapes and layouts."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati_fused

    text = open(os.path.join(_build.CSRC_DIR, "riccati_wide_seq.cu")).read()
    body = text[text.index("inline SeqLayout seq_layout("):]
    body = body[:body.index("return s;")]
    regions = dict(re.findall(r"s\.(\w+) = o, o \+= ([^;]+);", body))
    assert set(regions) == {"g", "lud", "e", "u", "s", "luf", "ae", "e0", "sc", "ring", "pb",
                            "pat", "pbt"}
    assert "s.slot = s.padk + pad4(x * x > u * u ? x * x : u * u);" in body
    assert "o += (3 * static_cast<size_t>(N) * u + 2 * static_cast<size_t>(xrows) * x) * l;" in body
    pad4 = lambda n: -(-n // 4) * 4
    for N, x, u, xrows in ((1, 1, 1, 1), (30, 64, 32, 0), (30, 32, 16, 30), (7, 3, 7, 1)):
        for l, ring, plant, state in ((4, 3, True, True), (16, 2, True, False),
                                      (8, 0, False, False)):
            slot = pad4(u * x) + pad4(max(x * x, u * u))
            env = dict(x=x, u=u, l=l, pad4=pad4, plant_shared=plant, ring=ring,
                       s=type("S", (), dict(slot=slot)))
            sizes = {k: eval(v.replace("static_cast<size_t>(ring)", "ring").replace(
                "plant_shared ? ", "(").replace(" : 0", ") if plant_shared else 0"), env)
                for k, v in regions.items()}
            work = sum(v for k, v in sizes.items() if k not in ("ring", "pb", "pat", "pbt"))
            total = work + sum(sizes[k] for k in ("ring", "pb", "pat", "pbt"))
            total += (3 * N * u + 2 * xrows * x) * l if state else 0
            assert riccati_fused.k3w_seq_floats(N, x, u, xrows, l, ring, plant, state) == (
                work, total)


def test_k2_entry_takes_the_plan():
    """admm_mixed_chunk's int parameters are the ones the wrapper passes,
    in its order (admm_fused.K2_INTS: the shape, then k2_plan's layout)."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    params = _c_params("admm_mixed_chunk")
    sig = _build.SIGNATURES["admm_mixed_chunk"]
    ints = [p for p, kind in zip(params, sig) if kind == "i"]
    assert tuple(ints) == admm_fused.K2_INTS
    assert sig == "p" * 18 + "i" * len(admm_fused.K2_INTS) + "ff" + "p"


def test_k2_instantiations_match_the_plan():
    """The rows per thread K2 instantiates (MPC_K2_RPT_N / _T in
    csrc/admm_mixed.cu) are the ones k2_plan may pick."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    text = open(os.path.join(_build.CSRC_DIR, "admm_mixed.cu")).read()
    box = re.search(r"#define MPC_K2_RPT_N\(X\) (.*)", text).group(1)
    tail = re.search(r"#define MPC_K2_RPT_T\(N, X\) (.*)", text).group(1)
    assert tuple(int(v) for v in re.findall(r"X\((\d+)\)", box)) == admm_fused.K2_RPT_N
    assert tuple(int(v) for v in re.findall(r"X\(N, (\d+)\)", tail)) == admm_fused.K2_RPT_T


def test_k1_entry_takes_the_plan():
    """admm_diag_chunk's int parameters are the ones the wrapper passes,
    in its order (admm_fused.K1_INTS: the shape, then k1_plan's layout)."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    params = _c_params("admm_diag_chunk")
    sig = _build.SIGNATURES["admm_diag_chunk"]
    ints = [p for p, kind in zip(params, sig) if kind == "i"]
    assert tuple(ints) == admm_fused.K1_INTS
    assert sig == "p" * 17 + "i" * len(admm_fused.K1_INTS) + "ff" + "p"


def test_k1_instantiations_match_the_plan():
    """The rows per thread K1 instantiates (MPC_K1_INSTANCES in
    csrc/admm_diag.cu) are the ones k1_plan may pick, with the same most
    threads a block, and the registers the plan counts, without and with
    refinement, fit the budgets that __launch_bounds__ holds each
    instantiation to."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    text = open(os.path.join(_build.CSRC_DIR, "admm_diag.cu")).read()
    body = re.search(r"#define MPC_K1_INSTANCES\(X\)((?:.*\\\n)*.*)", text).group(1)
    rows = [tuple(int(v) for v in m)
            for m in re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)", body)]
    assert [row[0] for row in rows] == sorted(admm_fused.K1_INSTANCES)
    for rpt, threads, *budgets in rows:
        planned_threads, *registers = admm_fused.K1_INSTANCES[rpt]
        assert planned_threads == threads
        for used, budget in zip(registers, budgets):
            assert used <= budget <= 255 and 65536 // (threads * budget) >= 1


def test_k5_entry_takes_the_plan():
    """admm_perr_chunk's int parameters are the ones the wrapper passes,
    in its order (admm_fused.K5_INTS: the shape, then k5_plan's layout),
    after its 17 arrays."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    params = _c_params("admm_perr_chunk")
    sig = _build.SIGNATURES["admm_perr_chunk"]
    ints = [p for p, kind in zip(params, sig) if kind == "i"]
    assert tuple(ints) == admm_fused.K5_INTS
    assert sig == "p" * 17 + "i" * len(admm_fused.K5_INTS) + "ff" + "p"


@pytest.mark.parametrize("macro,table", [("MPC_K5_INSTANCES", "K5_INSTANCES"),
                                         ("MPC_K5_STREAM_INSTANCES", "K5_STREAM_INSTANCES"),
                                         ("MPC_K4_INSTANCES", "K4_INSTANCES"),
                                         ("MPC_K4_STREAM_INSTANCES", "K4_STREAM_INSTANCES")])
def test_k5_instantiations_match_the_plan(macro, table):
    """The rows per thread K5 and K4 instantiate on their shared and stream
    routes (csrc/admm_perr.cu) are the ones k5_plan and k4_plan may pick,
    with the same most threads a block, and the registers the plan counts,
    without and with refinement, fit the budgets that __launch_bounds__
    holds them to."""
    keys = 2
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    text = open(os.path.join(_build.CSRC_DIR, "admm_perr.cu")).read()
    body = re.search(rf"#define {macro}\(X\)((?:.*\\\n)*.*)", text).group(1)
    rows = [tuple(int(v) for v in m)
            for m in re.findall(r"X\(" + ", ".join([r"(\d+)"] * (keys + 3)) + r"\)", body)]
    planned = getattr(admm_fused, table)
    assert sorted(row[:keys] for row in rows) == sorted(planned)
    for row in rows:
        threads, *budgets = row[keys:]
        planned_threads, *registers = planned[row[:keys]]
        assert planned_threads == threads
        for used, budget in zip(registers, budgets):
            assert used <= budget <= 255 and 65536 // (threads * budget) >= 1


def test_k5_stream_entry_takes_the_plan():
    """admm_perr_stream_chunk's int parameters are the ones the wrapper
    passes (admm_fused.K5_STREAM_INTS), and its shared-memory bytes are
    k5_stream_smem_bytes: the entry's two lines, read from the source."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    params = _c_params("admm_perr_stream_chunk")
    sig = _build.SIGNATURES["admm_perr_stream_chunk"]
    assert tuple(p for p, kind in zip(params, sig) if kind == "i") == admm_fused.K5_STREAM_INTS
    text = open(os.path.join(_build.CSRC_DIR, "admm_perr.cu")).read()
    exprs = [re.search(rf"const long long {name} = (.*);", text).group(1)
             for name in ("stream_doubles", "stream_need")]
    py = lambda e: re.sub(r"(\d+)LL", r"\1", e).replace("lay.", "")
    for n, m, lanes, groups, rpt_n, rpt_m, panel in (
            (100, 300, 16, 30, 4, 10, 7658), (100, 300, 8, 28, 4, 12, 10794),
            (41, 77, 4, 40, 2, 6, 500), (128, 512, 4, 64, 2, 8, 2048)):
        env = dict(n=n, m=m, lanes=lanes, panel=panel, nslots=(groups * rpt_n + 1) & ~1,
                   mslots=(groups * rpt_m + 1) & ~1)
        env["stream_doubles"] = eval(py(exprs[0]), {}, env)
        assert eval(py(exprs[1]), {}, env) == admm_fused.k5_stream_smem_bytes(
            m, lanes, groups, rpt_n, rpt_m, panel)


def _shared_bytes_cases(packed):
    """admm_fused.k5_smem_bytes (K4's with ``packed``) against the C
    entries' own formula: the four lines of shared_chunk that count the
    layout's doubles and floats, read from the source and evaluated on the
    same layouts, the ternary on PACKED as Python's. Returns the cases."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    text = open(os.path.join(_build.CSRC_DIR, "admm_perr.cu")).read()
    exprs = {name: re.search(rf"const long long {name} = (.*);", text).group(1)
             for name in ("image", "doubles", "floats", "need")}
    py = lambda e: re.sub(r"^(.*) \? (.*) : (.*)$", r"(\2) if (\1) else (\3)",
                          re.sub(r"(\d+)LL", r"\1", e).replace("lay.", ""))
    table = admm_fused.K4_INSTANCES if packed else admm_fused.K5_INSTANCES
    cases = 0
    for n, m in ((40, 120), (100, 300), (7, 13), (128, 1), (41, 44)):
        for R in (1, 4, 5, 8):
            for rs in (0, 1, 2):
                for lanes in admm_fused.LANES:
                    for (rpt_n, rpt_m), _ in table.items():
                        groups = max(-(-n // rpt_n), -(-m // rpt_m))
                        ld, sk = admm_fused.row_strides(n, lanes)
                        env = dict(
                            n=n, m=m, R=R, lanes=lanes, ld=ld, sk=sk, PACKED=packed,
                            nslots=(groups * rpt_n + 1) & ~1, mslots=(groups * rpt_m + 1) & ~1,
                            mr=admm_fused.rho_stride(m), stacks=2 if rs > 0 else 1,
                        )
                        for name in ("image", "doubles", "floats"):
                            env[name] = eval(py(exprs[name]), {}, env)
                        assert eval(py(exprs["need"]), {}, env) == admm_fused.k5_smem_bytes(
                            n, m, R, rs, lanes, groups, rpt_n, rpt_m, packed)
                        cases += 1
    return cases


def test_k5_shared_bytes_match_the_c_entry():
    """admm_fused.k5_smem_bytes is the C entry's own formula."""
    assert _shared_bytes_cases(False) > 1000


def test_k4_shared_bytes_match_the_c_entry():
    """K4's shared-route bytes (k5_smem_bytes, packed: kia_r in place of the
    fp64 A) are the same entry's formula with PACKED true."""
    assert _shared_bytes_cases(True) > 1000


@pytest.mark.parametrize("entry,ints", [("admm_packed_chunk", "K5_INTS"),
                                        ("admm_packed_stream_chunk", "K5_STREAM_INTS")])
def test_k4_entries_take_the_plan(entry, ints):
    """K4's C entries take the same ints as K5's, in the wrapper's order:
    the shared route after its 18 arrays (kia beside A), the stream route
    after 19, as K5's."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    params = _c_params(entry)
    sig = _build.SIGNATURES[entry]
    assert tuple(p for p, kind in zip(params, sig) if kind == "i") == getattr(admm_fused, ints)
    arrays = 18 if entry == "admm_packed_chunk" else 19
    assert sig == "p" * arrays + "i" * len(getattr(admm_fused, ints)) + "ff" + "p"
    if entry == "admm_packed_chunk":
        assert params[:4] == ["kinv", "kmat", "kia", "a"]


@pytest.mark.parametrize("mode", ["bf16x3", "default"])
@pytest.mark.parametrize("name,source,macro,keys", [
    ("K1", "admm_diag.cu", "MPC_K1_INSTANCES", 1),
    ("K5", "admm_perr.cu", "MPC_K5_INSTANCES", 2),
    ("K5-stream", "admm_perr.cu", "MPC_K5_STREAM_INSTANCES", 2),
    ("K4", "admm_perr.cu", "MPC_K4_INSTANCES", 2),
    ("K4-stream", "admm_perr.cu", "MPC_K4_STREAM_INSTANCES", 2),
])
def test_precision_registers_fit_the_budgets(name, source, macro, keys, mode):
    """Each bf16 precision instantiates the same rows per thread under the
    same __launch_bounds__ budgets as "highest": the registers the plans
    count at that precision (admm_fused.PRECISION_REGISTERS) cover every
    instantiation and fit its budgets."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    text = open(os.path.join(_build.CSRC_DIR, source)).read()
    body = re.search(rf"#define {macro}\(X\)((?:.*\\\n)*.*)", text).group(1)
    rows = [tuple(int(v) for v in m)
            for m in re.findall(r"X\(" + ", ".join([r"(\d+)"] * (keys + 3)) + r"\)", body)]
    table = admm_fused.PRECISION_REGISTERS[mode][name]
    key = (lambda row: row[0]) if keys == 1 else (lambda row: row[:keys])
    assert sorted(table) == sorted(key(row) for row in rows)
    for row in rows:
        threads, *budgets = row[keys:]
        for used, budget in zip(table[key(row)], budgets):
            assert used <= budget <= 255 and 65536 // (threads * budget) >= 1


@pytest.mark.parametrize("entry,ints,arrays", [
    ("admm_diag_stream_chunk", "K1_STREAM_INTS", 19),
    ("admm_mixed_stream_chunk", "K2_STREAM_INTS", 21),
])
def test_k12_stream_entries_take_the_plan(entry, ints, arrays):
    """The stream route's C entries take the ints the wrapper passes, in
    its order (admm_fused.K1_STREAM_INTS / K2_STREAM_INTS: the shape, then
    the plan's lanes, groups, panel and bytes), after their arrays: K^-1
    and K (K2: A2' and A2) as entries, then the vectors, the rho order,
    the lane state and the refinement's scratch."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    params = _c_params(entry)
    sig = _build.SIGNATURES[entry]
    assert tuple(p for p, kind in zip(params, sig) if kind == "i") == getattr(admm_fused, ints)
    assert sig == "p" * arrays + "i" * len(getattr(admm_fused, ints)) + "ff" + "p"
    assert params[:2] == ["kinv", "kmat"] and params[arrays - 11:arrays - 9] == ["order", "starts"]
    assert params[arrays - 1] == "scratch"
    if arrays == 21:
        assert params[2:4] == ["a2t", "a2"]


def test_k12_stream_bytes_match_the_c_entry():
    """admm_fused.k12_stream_smem_bytes is the stream route's own formula:
    the entry's two lines, read from csrc/admm_diag_stream.cu and evaluated
    (its ternary as Python's) on the same layouts."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    text = open(os.path.join(_build.CSRC_DIR, "admm_diag_stream.cu")).read()
    exprs = [re.search(rf"const long long {name} = (.*);", text).group(1)
             for name in ("stream_doubles", "stream_need")]
    py = lambda e: re.sub(r"\(([^()?]*) \? ([^():]*) : ([^()]*)\)", r"((\2) if (\1) else (\3))",
                          re.sub(r"(\d+)LL", r"\1", e).replace("lay.", "").replace("a.", ""))
    cases = 0
    for n, ms in ((100, 0), (61, 7), (528, 0), (275, 550), (1, 1), (33, 1)):
        for rs in (0, 1, 2):
            for lanes in admm_fused.K12_STREAM_LANES:
                for panel in (96, 7658, 12848):
                    env = dict(n=n, lanes=lanes, panel=panel, refine_steps=rs,
                               nslots=(n + 1) & ~1, tslots=(ms + 1) & ~1)
                    env["stream_doubles"] = eval(py(exprs[0]), {}, env)
                    assert eval(py(exprs[1]), {}, env) == admm_fused.k12_stream_smem_bytes(
                        n, ms, lanes, panel)
                    cases += 1
    assert cases > 200


def test_k12_stream_constants_match_the_source():
    """The stream route's rows a thread takes in a tile (4, 8 in K1's
    blocks of 4 lanes a thread), most threads a block, lanes from which a
    thread takes 4 and 2 (1 below), chunks of a panel a thread stages and
    widest n and tail are the plans' (admm_fused.K12_PASS_ROWS,
    k12_rows_options, K12_STREAM_THREADS, K12_WIDE_LANES, K12_MID_LANES,
    K12_STREAM_STAGE, MAX_STREAM_N, MAX_STREAM_TAIL), its entry takes the
    plans' lanes, and its __launch_bounds__ holds a thread to the
    registers the plans count."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    text = open(os.path.join(_build.CSRC_DIR, "admm_diag_stream.cu")).read()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    assert const("kPassRows") == admm_fused.K12_PASS_ROWS
    assert "return rows == kPassRows || (rows == 2 * kPassRows && lt == 4 && !tail);" in text
    assert [admm_fused.k12_rows_options(v, tail) for v in (4, 16, 32, 64)
            for tail in (False, True)] == [(4,)] * 4 + [(4, 8), (4,)] * 2
    assert "return lanes >= kWideLanes ? 4 : lanes >= kMidLanes ? 2 : 1;" in text
    assert [admm_fused.k12_lanes_per_thread(v) for v in (4, 8, 16, 32, 64)] == [1, 1, 2, 4, 4]
    assert const("kThreads") == admm_fused.K12_STREAM_THREADS
    assert const("kWideLanes") == admm_fused.K12_WIDE_LANES
    assert const("kMidLanes") == admm_fused.K12_MID_LANES
    assert const("kStage") == admm_fused.K12_STREAM_STAGE
    assert const("kMaxWidth") == admm_fused.MAX_STREAM_N == admm_fused.MAX_STREAM_TAIL
    assert "__launch_bounds__(kThreads, 1)" in text
    assert admm_fused.K12_STREAM_REGISTERS == 65536 // admm_fused.K12_STREAM_THREADS
    checked = re.search(r"\(lanes != 4 && [^\n]*\n[^\n]*\)", text).group(0)
    assert sorted(int(v) for v in re.findall(r"lanes != (\d+)", checked)) == sorted(
        admm_fused.K12_STREAM_LANES)


def test_k12_stream_scratch_takes_every_batch_the_entry_takes():
    """The stream route's working copy in its device scratch
    (admm_fused.k12_scratch_floats) is a region of (2 n + 5 m, and 2 n more
    when refining) rows of L lanes for each block: a block's offsets fit
    an int and only its region's start is 64-bit, so its entry refuses no
    batch on the scratch's account. The one size it checks is m B < 2^31,
    the lane state's own index, as k1_plan and k2_plan do. At n = 1024 and
    B = 2^21 - 1 the scratch holds more than 2^31 floats."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    text = open(os.path.join(_build.CSRC_DIR, "admm_diag_stream.cu")).read()
    assert "const int region = (2 * n + 5 * m + (refine ? 2 * n : 0)) * L;" in text
    assert "float* wx = scratch + static_cast<long long>(blockIdx.x) * region + g0;" in text
    assert admm_fused.k12_scratch_floats(100, 300, 1, 7, 32) == (4 * 100 + 5 * 300) * 32 * 7
    assert admm_fused.k12_scratch_floats(100, 100, 0, 7, 32) == (2 * 100 + 5 * 100) * 32 * 7
    checks = text[text.index("int stream_chunk("):text.index("Layout lay;")]
    assert checks.count("INT_MAX") == 1
    assert "static_cast<long long>(a.m) * a.B > INT_MAX" in checks
    B = 2**21 - 1
    plan = admm_fused.k1_plan(1024, 5, 1, B)
    assert plan.route == "stream" and admm_fused.k1_fits(1024, 5, 1)
    assert admm_fused.k12_scratch_floats(1024, 1024, 1, plan.blocks, plan.lanes) > 2**31


@pytest.mark.parametrize("entry,first", [("admm_perr_wide_chunk", "kinv"),
                                         ("admm_packed_wide_chunk", "w")])
def test_wide_entries_take_the_plan(entry, first):
    """K5's and K4's wide-route C entries (csrc/admm_perr_wide.cu) take the
    ints the wrapper passes, in its order (admm_fused.K5_WIDE_INTS: the
    shape, then the plan's lanes, tiles, depth, panel, cluster and
    bytes), after their 21 arrays: K^-1' (K4: W), K', A, A' and fl(rho A)'
    as 4-byte entries, the rho table, the vectors, the rho order, the lane
    state and the working copy's scratch."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    params = _c_params(entry)
    sig = _build.SIGNATURES[entry]
    assert tuple(p for p, kind in zip(params, sig) if kind == "i") == admm_fused.K5_WIDE_INTS
    assert sig == "p" * 21 + "i" * len(admm_fused.K5_WIDE_INTS) + "ff" + "p"
    assert params[:5] == [first, "kmat", "a", "at", "rat"]
    assert params[10:12] == ["order", "starts"]
    assert params[20] == "scratch"
    plan = admm_fused.k5_plan(200, 600, 5, 1, 2048)
    assert set(admm_fused.K5_WIDE_INTS[7:]) <= set(plan._fields)


def test_wide_bytes_match_the_c_entry():
    """admm_fused.wide_smem_bytes is the wide route's own formula: the
    entry's three lines, read from csrc/admm_perr_wide.cu and evaluated on
    the same layouts, at every lane count and depth (K5's and K4's bytes
    are the same: no operator is held whole)."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    text = open(os.path.join(_build.CSRC_DIR, "admm_perr_wide.cu")).read()
    names = ("wide_doubles", "ring_floats", "wide_need")
    exprs = [re.search(rf"const long long {name} = (.*);", text).group(1) for name in names]
    py = lambda e: re.sub(r"(\d+)LL", r"\1", e).replace("lay.", "")
    cases = 0
    for n in (1, 7, 20, 130, 200, 582, 1024):
        for lanes in admm_fused.WIDE_LANES:
            for panel in (8, 96, 1000, 7656, 12848):
                for depth in admm_fused.WIDE_DEPTHS:
                    env = dict(n=n, lanes=lanes, panel=panel, depth=depth,
                               nslots=(n + 1) & ~1)
                    for name, expr in zip(names, exprs):
                        env[name] = eval(py(expr), {}, env)
                    assert env["wide_need"] == admm_fused.wide_smem_bytes(n, lanes, panel, depth)
                    cases += 1
    assert cases > 700
    # a ring slot of a panel's floats, as the kernel lays the ring out
    assert text.count("ring + k * lay.panel;") == 2


def test_wide_geometry_matches_the_c_entry():
    """admm_fused.wide_geometry is make_geo's rule: its tiles, row-groups
    and panel columns, read from csrc/admm_perr_wide.cu and evaluated on
    the same products."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    text = open(os.path.join(_build.CSRC_DIR, "admm_perr_wide.cu")).read()
    body = text[text.index("bool make_geo("):text.index("// The layout of a launch")]
    for line in ("const int most = kThreads / lg;", "g.span = (rows + cluster - 1) / cluster;",
                 "g.tiles = (g.span + rt * most - 1) / (rt * most);",
                 "g.G = (g.span + g.tiles * rt - 1) / (g.tiles * rt);", "g.H = rt * g.G;",
                 "g.pk = static_cast<int>(pk < 0 ? 0 : pk & ~3LL);", "g.sp = g.pk + 2;",
                 "return g.pk >= 4;"):
        assert line in body, line
    assert re.search(r"by_panel = \(static_cast<long long>\(panel\) - 2LL \* ops \* g\.H\) /\s+"
                     r"\(static_cast<long long>\(ops\) \* g\.H \+ 1LL \* vecs \* lanes\);",
                     body)
    g = admm_fused.wide_geometry(200, 600, 2, 2, 4, 4, 16, 7064)
    assert (g.lg, g.G, g.H, g.tiles, g.pk, g.np) == (4, 50, 200, 1, 12, 50)
    g = admm_fused.wide_geometry(600, 200, 1, 0, 8, 4, 16, 7064)
    assert (g.G, g.H, g.tiles, g.padded_rows) == (38, 304, 2, 8)
    g = admm_fused.wide_geometry(600, 200, 1, 0, 8, 4, 32, 7064, cluster=2)
    assert (g.span, g.lg, g.G, g.H, g.tiles, g.padded_rows) == (300, 8, 19, 152, 2, 4)
    assert admm_fused.wide_geometry(20, 660, 2, 2, 4, 4, 3, 7064) is None
    assert admm_fused.wide_geometry(1024, 1024, 2, 2, 4, 4, 64, 800) is None


def test_wide_constants_match_the_source():
    """The wide route's threads a block, widest n, most rows and deepest
    ring are the plans' (admm_fused.WIDE_THREADS, MAX_WIDE_N,
    MAX_WIDE_ROWS, WIDE_DEPTHS), its register tiles are the plans'
    (WIDE_TILES, every product's) and each has a case in both of the kernel's
    dispatch, its entry takes the plans' lanes a block (WIDE_LANES), and
    its __launch_bounds__ holds a block's thread to the registers the
    plans count (WIDE_REGISTERS: one block an SM)."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    text = open(os.path.join(_build.CSRC_DIR, "admm_perr_wide.cu")).read()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    assert const("kThreads") == admm_fused.WIDE_THREADS
    assert const("kMaxN") == admm_fused.MAX_WIDE_N
    assert const("kMaxRows") == admm_fused.MAX_WIDE_ROWS
    assert const("kMaxDepth") == max(admm_fused.WIDE_DEPTHS)
    assert "depth < 2 ||" in text and min(admm_fused.WIDE_DEPTHS) == 2
    assert const("kMaxCluster") == max(admm_fused.WIDE_CLUSTERS)
    assert min(admm_fused.WIDE_CLUSTERS) == 1
    assert "cluster < 1 || cluster > kMaxCluster || n < cluster || m < cluster ||" in text
    assert "__launch_bounds__(kThreads, 1)" in text
    assert admm_fused.blocks_per_sm(admm_fused.WIDE_THREADS, 1000, admm_fused.WIDE_REGISTERS) == 1
    tiles = lambda name: tuple(tuple(int(v) for v in pair) for pair in re.findall(
        r"\{(\d+), (\d+)\}", re.search(rf"constexpr int {name}\[\]\[2\] = \{{(.*)\}};",
                                       text).group(1)))
    assert tiles("kTiles") == admm_fused.WIDE_TILES
    cases = re.findall(r"case (\d+) \* 16 \+ (\d+):", text)
    dispatch = [tuple(int(v) for v in c) for c in cases]
    for part in (dispatch[:5], dispatch[5:]):  # the pass's, the other products'
        assert len(part) == 5 and set(part) | {admm_fused.WIDE_TILES[-1]} == set(
            admm_fused.WIDE_TILES)
    lanes = re.search(r"\(lanes != 1 &&[^)]*\)", text).group(0)
    assert sorted(int(v) for v in re.findall(r"lanes != (\d+)", lanes)) == sorted(
        admm_fused.WIDE_LANES)
