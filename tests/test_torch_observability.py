"""The port's observability surface and last exports, against the JAX package:
utils/profiling (JAX tests/test_aux.py), utils/roofline's report and
invariants (JAX tests/test_observability.py), the H100 models pinned to
the bounds PERF.md's kernel table records, and the exports the port lacked
(condense, lti_prediction_matrices, infeas_certificate, the QTP's boxes
and neural_continuous_system, the package's and parallel's __all__)."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu import parallel as jpar
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp
from automationlabsmodelpredictivecontrol_jl_tpu.ops import condense as jcond
from automationlabsmodelpredictivecontrol_jl_tpu.ops import riccati as jric
from automationlabsmodelpredictivecontrol_jl_tpu.terminal import (
    create_terminal_ingredient as jterminal,
)
from automationlabsmodelpredictivecontrol_jl_tpu.utils import roofline as jroof

import automationlabsmodelpredictivecontrol_jl_torch as tmpc
from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp
from automationlabsmodelpredictivecontrol_jl_torch.ops import condense as tcond
from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati as tric
from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati_fused
from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig
from automationlabsmodelpredictivecontrol_jl_torch.terminal import (
    create_terminal_ingredient as tterminal,
)
from automationlabsmodelpredictivecontrol_jl_torch.utils import profiling, roofline

torch.set_num_threads(1)


def _controller(N=20, **kw):
    return tmpc.proceed_controller(
        tqtp.linearized_discrete_system(), "model_predictive_control", N, 5.0,
        [0.65] * 4, [1.2] * 2, admm_config=AdmmConfig(max_iter=100), device="cpu", **kw)


# ------------------------------------------------------------------ profiling


def test_profiling_benchmark_helper():
    c = _controller(N=5)
    x0 = torch.full((4,), 0.6)
    stats = profiling.benchmark(lambda: tmpc.solve_once(c, x0, c.warm_z, c.warm_y)[0].u,
                                warmup=1, reps=5)
    assert set(stats) == {"p50_ms", "p90_ms", "p99_ms", "mean_ms", "reps"}
    assert stats["p50_ms"] > 0 and stats["p99_ms"] >= stats["p50_ms"] and stats["reps"] == 5
    assert profiling.solve_rate(32, stats) == pytest.approx(32 / (stats["mean_ms"] / 1e3))


def test_profiling_trace_writes_chrome_trace(tmp_path):
    c = _controller(N=5)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        tmpc.step(c, torch.full((4,), 0.6))
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert prof.key_averages()


def test_profiling_trace_without_file_and_latencies(tmp_path, monkeypatch):
    """``trace(None)`` writes nothing and still yields the events;
    ``latencies_ms`` gives one time a timed call."""
    c = _controller(N=5)
    monkeypatch.chdir(tmp_path)
    with profiling.trace(None) as prof:
        tmpc.step(c, torch.full((4,), 0.6))
    assert any(e.name.startswith("aten::") for e in prof.events())
    assert list(tmp_path.iterdir()) == []
    lat = profiling.latencies_ms(lambda: tmpc.step(c, torch.full((4,), 0.6))[1].u, warmup=0,
                                 reps=3)
    assert lat.shape == (3,) and (lat > 0).all()


# ------------------------------------------------------------------- roofline


@pytest.fixture(scope="module")
def h20():
    return _controller()


def test_speed_of_light_report_invariants(h20):
    rep = roofline.speed_of_light(h20.engine.op, h20.engine.config, batch=512,
                                  mean_iterations=80.0, measured_time_s=0.01)
    assert rep["bound"] in ("fp64", "fp32", "bf16", "hbm")
    assert 0.0 < rep["sol_fraction"] and rep["roofline_time_s"] > 0.0
    # no tile padding on the card: the executed operations are the useful ones
    assert rep["achieved_padded_tflops"] == rep["achieved_useful_tflops"] > 0
    assert rep["mfu"] <= rep["sol_fraction"] + 1e-12
    assert (rep["n"], rep["m"], rep["rho_grid"], rep["kernels"]) == (40, 40, 5, ["K1"])
    assert rep["mean_iterations"] == 80.0 and rep["device_kind"] == "cpu"


def test_speed_of_light_scales_with_time(h20):
    """Half the measured time doubles the achieved rate and the SOL share;
    twice the time halves it."""
    r1 = roofline.speed_of_light(h20.engine.op, h20.engine.config, 512, 80.0, 0.02)
    r2 = roofline.speed_of_light(h20.engine.op, h20.engine.config, 512, 80.0, 0.01)
    np.testing.assert_allclose(r2["sol_fraction"], 2 * r1["sol_fraction"], rtol=1e-9)
    np.testing.assert_allclose(r2["achieved_padded_tflops"], 2 * r1["achieved_padded_tflops"],
                               rtol=1e-9)
    assert r2["roofline_time_s"] == r1["roofline_time_s"]


def test_speed_of_light_tiered_sums_tiers(h20):
    fb = tpar.escalation_controller(h20, rho_grid=(0.1, 1.0, 10.0, 100.0), max_iter=250,
                                    refine_steps=2)
    t1 = (h20.engine.op, h20.engine.config, 16384, 75.0)
    t2 = (fb.engine.op, fb.engine.config, 512, 250.0)
    both = roofline.speed_of_light_tiered([t1, t2], 0.01)
    one = [roofline.speed_of_light_tiered([t], 0.01) for t in (t1, t2)]
    np.testing.assert_allclose(both["achieved_useful_tflops"],
                               sum(r["achieved_useful_tflops"] for r in one), rtol=1e-12)
    assert both["kernels"] == ["K1", "K1"] and both["rho_grid"] == 5


def test_device_peaks_host_placeholder():
    """On the CPU the peaks are the JAX package's host placeholder."""
    ours, theirs = roofline.device_peaks("cpu"), jroof.device_peaks(jax.devices("cpu")[0])
    for key in ("device_kind", "bf16_flops", "f32_highest_flops", "hbm_bytes_per_s"):
        assert ours[key] == theirs[key], key
    assert ours["f32_highest_flops"] > 0 and ours["hbm_bytes_per_s"] > 0


# the bounds of PERF.md's kernel table, to 4 significant digits: (model,
# arguments, bound ms, bound by)
PERF_BOUNDS = (
    ("chunk_bound", (40, 40, 16384, 2, 0, 25, "K1"), 0.01956, "operations"),
    ("chunk_bound", (40, 120, 2048, 5, 1, 25, "K2"), 0.02201, "operations"),
    ("riccati_chunk_bound", (500, 4, 2, 1024, 25, False), 0.03211, "operations"),
    ("rollout_bound", (30, 64, 32, 1024), 0.005663, "operations"),
    ("certificate_bound", (30, 64, 32, 1024), 0.009638, "bytes"),
    ("chunk_bound", (200, 600, 2048, 5, 1, 25, "K5"), 0.7336, "operations"),
    ("k3w_bound", (30, 64, 32, 1024, 25, False, False, 5), 0.4051, "operations"),
)


@pytest.mark.parametrize("model,args,ms,by", PERF_BOUNDS)
def test_models_reproduce_perf_bounds(model, args, ms, by):
    out = getattr(roofline, model)(*args)
    assert float(f"{out[0]:.4g}") == ms and out[1] == by


def test_floors_and_iteration_models(monkeypatch):
    """An H100's peaks (its name and SM count as PyTorch reports them): the
    FMA floor at their 64 fp64 multiply-adds a clock an SM on their SMs; the
    chain floor; the iteration models count each lane's own rho only (R
    does not enter), and refinement adds no A2 product to K2's."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d=None: types.SimpleNamespace(multi_processor_count=132))
    peaks = roofline.device_peaks(0)
    assert (peaks["sm_count"], peaks["fp64_fma_per_clock_sm"], peaks["fp32_fma_per_clock_sm"],
            peaks["fp64_flops"]) == (132, 64, 128, 67e12)
    ms = roofline.fma_floor_ms(40, 40, 16384, 0, 25, peaks, 1.98e9)
    assert ms == pytest.approx(1600 * 16384 * 25 / 64 / (132 * 1.98e9) * 1e3)
    assert roofline.fma_floor_ms(40, 40, 16384, 0, 25, peaks, 1.98e9, mode="bf16x3") == (
        pytest.approx(ms * 64 * 3 / 128))
    assert roofline.wide_chain_floor_ms(30, 64, 4.0) == pytest.approx(30 * 64 * 4.0e-6)
    k2 = lambda rs: roofline.admm_mixed_iteration_model(40, 120, 5, 1, rs)["useful_flops"]
    assert k2(1) - k2(0) == 2 * 2 * 40 * 40
    assert (roofline.admm_diag_iteration_model(40, 2)["useful_flops"]
            == roofline.admm_diag_iteration_model(40, 8)["useful_flops"] == 2 * 1600 * 1024)
    it = roofline.admm_iteration_model(40, 120, 5)
    assert it["padded_flops"] == it["useful_flops"] > 0
    ric = roofline.riccati_iteration_model(500, 4, 2, 1024)
    assert ric["useful_flops"] == 2 * (4 * 2 * 4 + 4 + 2 * 16) * 500 * 1024
    assert roofline.admm_diag_chunk_bytes(40, 2, 16384) == roofline.chunk_bytes(
        40, 40, 16384, 2, 0, "K1")


def test_kernel_of_follows_the_fused_route():
    box = _controller()
    state = _controller(mpc_state_constraint=True)
    assert roofline.kernel_of(box.engine.op, box.engine.config) == "K1"
    assert roofline.kernel_of(state.engine.op, state.engine.config) == "K2"


# -------------------------------------------------------------------- exports


def test_all_contains_jax_exports():
    assert set(jmpc.__all__) <= set(tmpc.__all__)
    assert tpar.__all__ == jpar.__all__
    assert tmpc.invariant_terminal_set is not None and tmpc.rollout is not None


def test_qtp_boxes_and_neural_continuous_system():
    for ours, theirs in ((tqtp.X_BOX, jqtp.X_BOX), (tqtp.U_BOX, jqtp.U_BOX)):
        np.testing.assert_array_equal(ours.lo.numpy(), np.asarray(theirs.lo))
        np.testing.assert_array_equal(ours.hi.numpy(), np.asarray(theirs.hi))
    fn = lambda p, x, u: p * x
    ours = tqtp.neural_continuous_system(fn, 2.0)
    theirs = jqtp.neural_continuous_system(fn, 2.0)
    assert (ours.family, ours.nx, ours.nu) == (theirs.family, theirs.nx, theirs.nu)
    np.testing.assert_array_equal(ours.X.hi.numpy(), np.asarray(theirs.X.hi))
    np.testing.assert_array_equal(ours.U.hi.numpy(), np.asarray(theirs.U.hi))
    assert float(ours.deriv(torch.ones(4), torch.zeros(2))[0]) == 2.0


def test_lti_prediction_matrices_match_jax():
    """JAX tests/test_condense.py's inputs: the operators agree with JAX's
    and reproduce a dense rollout."""
    rng = np.random.default_rng(0)
    N, nx, nu = 6, 3, 2
    A = (rng.normal(size=(nx, nx)) * 0.5).astype(np.float32)
    B = rng.normal(size=(nx, nu)).astype(np.float32)
    F, G, h = tcond.lti_prediction_matrices(torch.from_numpy(A), torch.from_numpy(B), N)
    jF, jG, jh = jcond.lti_prediction_matrices(jnp.asarray(A), jnp.asarray(B), N)
    assert F.shape == (N, nx, nx) and G.shape == (N, N, nx, nu) and h.shape == (N, nx)
    for ours, theirs in ((F, jF), (G, jG), (h, jh)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-6)
    e0 = rng.normal(size=nx).astype(np.float32)
    du = rng.normal(size=(N, nu)).astype(np.float32)
    G_flat = G.permute(0, 2, 1, 3).reshape(N * nx, N * nu).numpy()
    pred = (G_flat @ du.reshape(-1) + F.reshape(N * nx, nx).numpy() @ e0).reshape(N, nx)
    e, want = e0, []
    for k in range(N):
        e = A @ e + B @ du[k]
        want.append(e)
    np.testing.assert_allclose(pred, np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("kind,state", [("none", False), ("equality", False),
                                        ("contractive", False), ("none", True),
                                        ("neighborhood", True)])
def test_condense_matches_jax(kind, state):
    """JAX tests/test_condense.py's _qp: the port's condense equals the JAX
    package's host condense_np bit for bit and its traced condense to fp32
    roundoff, with the same row layout."""
    N = 5
    jsys, tsys = jqtp.linearized_discrete_system(), tqtp.linearized_discrete_system()
    jrefs = jmpc.design_references(np.full(4, 0.65), np.full(2, 1.2), N)
    trefs = tmpc.design_references(np.full(4, 0.65), np.full(2, 1.2), N)
    jw, tw = jmpc.create_weights(4, 2, 100.0, 0.1, 0.0), tmpc.create_weights(4, 2, 100.0, 0.1, 0.0)
    jterm, tterm = jterminal(jsys, kind, jrefs, jw), tterminal(tsys, kind, trefs, tw)
    ours = tcond.condense(tsys.A, tsys.B, N, tw, tterm, trefs, tsys.X, tsys.U, state)
    traced = jcond.condense(jsys.A, jsys.B, N, jw, jterm, jrefs, jsys.X, jsys.U, state)
    host = jcond.condense_np(jsys.A, jsys.B, N, jw, jterm, jrefs, jsys.X, jsys.U, state)
    assert (ours.N, ours.nx, ours.nu, ours.n_ball) == (traced.N, traced.nx, traced.nu,
                                                       traced.n_ball)
    for key in ("P", "A", "q_const", "q_x0", "l_const", "u_const", "b_x0", "ball_c_x0",
                "F", "G_flat"):
        mine = getattr(ours, key).numpy()
        np.testing.assert_array_equal(mine, np.asarray(getattr(host, key)), err_msg=key)
        np.testing.assert_allclose(mine, np.asarray(getattr(traced, key)), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_infeas_certificate_matches_jax():
    """Seeded dual deltas orthogonal to the dynamics (dlamU_k = -B' g_{k+1}
    along the adjoint recursion) on the h8 state-boxed QP: lanes whose
    zero-input rollout lies along dlamX are certified infeasible, the
    mirrored ones are not, and random deltas are not; lane by lane as
    the JAX package's infeas_certificate decides, one lane and a batch."""
    N, lanes, eps = 8, 12, 1e-4
    design = lambda mpc, qtp: mpc.proceed_controller(
        qtp.linearized_discrete_system(), "model_predictive_control", N, 5.0,
        np.full(4, 0.65), np.full(2, 1.2), engine="riccati", mpc_state_constraint=True,
        **({"device": "cpu"} if mpc is tmpc else {}))
    top, jop = design(tmpc, tqtp).engine.op, design(jmpc, jqtp).engine.op
    assert top.split_interior and jop.split_interior
    A = top.factors.A.double().numpy()
    Bm = top.factors.B.double().numpy()
    rng = np.random.default_rng(7)
    dX = rng.standard_normal((lanes, N + 1, 4))
    dU = np.empty((lanes, N, 2))
    for i in range(lanes):
        g = dX[i, N]
        for k in range(N - 1, -1, -1):
            dU[i, k] = -Bm.T @ g
            g = A.T @ g + dX[i, k]
    dU[lanes - 2:] = rng.standard_normal((2, N, 2))  # not orthogonal
    sign = np.where(np.arange(lanes) % 2 == 0, 1.0, -1.0)
    Xbar = 50.0 * sign[:, None, None] * dX  # <dlamX, Xbar> = +-50 |dlamX|^2
    f = lambda v: v.astype(np.float32)
    ours = tric.infeas_certificate(top, *(torch.from_numpy(f(v)) for v in (dX, dU, Xbar)),
                                   torch.zeros(lanes), eps)
    theirs = jax.vmap(lambda x, u, b: jric.infeas_certificate(jop, x, u, b, 0.0, eps))(
        *(jnp.asarray(f(v)) for v in (dX, dU, Xbar)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert ours[: lanes - 2].tolist() == [bool(s > 0) for s in sign[: lanes - 2]]
    assert not ours[lanes - 2:].any()
    one = tric.infeas_certificate(top, *(torch.from_numpy(f(v[0])) for v in (dX, dU, Xbar)),
                                  0.0, eps)
    assert one.shape == () and bool(one) == bool(ours[0])


def test_solve_sparse_names_the_per_lane_engine():
    assert tric.solve_sparse is riccati_fused.solve_sparse
