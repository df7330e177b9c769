"""SQP iteration counts against fp32 roundoff, on the CPU.

Solves the golden fnn's SQP fleet (tests/golden/qtp_nl_golden.npz; h5
and h10, 8 lanes of suite config 3's states, max_sqp_iter 8) and the
Takagi-Sugeno fuzzy fleet (two QTP linearizations, levels 0.4 and 0.9; h10,
8 lanes of clip(0.65 + 0.1 N(0, 1), 0.3, 1.3) from default_rng(0), the
default SqpConfig) three ways on the same inputs: the JAX package's
``parallel.solve_batch`` eager and jitted, and the PyTorch port's. Prints
each one's per-lane iteration counts, their means, the largest |du| and the
largest relative objective difference between them. The counts and u
differ between the JAX package's own two runs about as much as between
either and the port: after the first SQP iterations the line search's
candidate merits differ by ~1e-5 relative, so roundoff picks the step.

    JAX_PLATFORMS=cpu python scripts/sqp_count_roundoff.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc  # noqa: E402
from automationlabsmodelpredictivecontrol_jl_tpu import parallel as jpar  # noqa: E402
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp  # noqa: E402
from automationlabsmodelpredictivecontrol_jl_tpu.models import zoo as jzoo  # noqa: E402
from automationlabsmodelpredictivecontrol_jl_tpu.solvers.sqp import SqpConfig as JSqp  # noqa: E402

import automationlabsmodelpredictivecontrol_jl_torch as tmpc  # noqa: E402
from automationlabsmodelpredictivecontrol_jl_torch import interop  # noqa: E402
from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar  # noqa: E402
from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp as tqtp  # noqa: E402
from automationlabsmodelpredictivecontrol_jl_torch.models import zoo as tzoo  # noqa: E402


def main():
    torch.set_num_threads(1)
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests", "golden")
    flat = np.load(os.path.join(golden, "qtp_nl_golden.npz"))["fnn_params"]
    japply, p0 = jzoo.init_model("fnn", jax.random.PRNGKey(0), 4, 2, hidden=8, depth=1)
    _, unravel = ravel_pytree(p0)
    js = jmpc.NeuralDiscreteSystem(apply_fn=japply, family="fnn", nx=4, nu=2,
                                   params=unravel(jnp.asarray(flat, jnp.float32)),
                                   X=jqtp.X_BOX, U=jqtp.U_BOX)
    tapply, _ = tzoo.make_apply("fnn")
    ts = tmpc.NeuralDiscreteSystem(apply_fn=tapply, family="fnn", nx=4, nu=2,
                                   params=interop.unravel_params("fnn", 4, 2, 8, 1, flat),
                                   X=tqtp.x_box(), U=tqtp.u_box())
    rng = np.random.default_rng(10)
    x0 = np.clip(0.65 + 0.05 * rng.standard_normal((8, 4)), 0.3, 1.3).astype(np.float32)
    cases = []
    for N, kw in ((10, dict(mpc_state_constraint=True)), (5, {})):
        jc = jmpc.proceed_controller(js, "model_predictive_control", N, 5.0, np.full(4, 0.65),
                                     np.full(2, 1.2), sqp_config=JSqp(max_sqp_iter=8), **kw)
        tc = tmpc.proceed_controller(ts, "model_predictive_control", N, 5.0, [0.65] * 4,
                                     [1.2] * 2, sqp_config=tmpc.SqpConfig(max_sqp_iter=8),
                                     device="cpu", **kw)
        cases.append((f"fnn h{N} {'state boxes' if kw else 'input boxes'}", jc, tc, x0))
    lo = jqtp.linearized_discrete_system(x_op=np.full(4, 0.4))
    hi = jqtp.linearized_discrete_system(x_op=np.full(4, 0.9))
    ts_arrays = dict(As=np.stack([np.asarray(lo.A), np.asarray(hi.A)]),
                     Bs=np.stack([np.asarray(lo.B), np.asarray(hi.B)]),
                     centers=np.array([[0.4] * 4, [0.9] * 4], np.float32),
                     widths=np.array([0.25, 0.25], np.float32))
    jts = jmpc.takagi_sugeno_system(**{k: jnp.asarray(v) for k, v in ts_arrays.items()},
                                    X=jqtp.X_BOX, U=jqtp.U_BOX)
    tts = tmpc.takagi_sugeno_system(**ts_arrays, X=tqtp.x_box(), U=tqtp.u_box())
    x0_ts = np.clip(0.65 + 0.1 * np.random.default_rng(0).standard_normal((8, 4)), 0.3,
                    1.3).astype(np.float32)
    cases.append((
        "fuzzy h10 input boxes",
        jmpc.proceed_controller(jts, "model_predictive_control", 10, 5.0, np.full(4, 0.65),
                                np.full(2, 1.2), mpc_programming_type="fuzzy_linear"),
        tmpc.proceed_controller(tts, "model_predictive_control", 10, 5.0, [0.65] * 4, [1.2] * 2,
                                mpc_programming_type="fuzzy_linear", device="cpu"),
        x0_ts,
    ))
    for label, jc, tc, x0 in cases:
        eager = jpar.solve_batch(jc, jnp.asarray(x0))[0]
        jitted = jax.jit(lambda x: jpar.solve_batch(jc, x))(jnp.asarray(x0))[0]
        port = tpar.solve_batch(tc, torch.from_numpy(x0))[0]
        runs = {"jax eager": (np.asarray(eager.iterations), np.asarray(eager.u),
                              np.asarray(eager.objective)),
                "jax jit": (np.asarray(jitted.iterations), np.asarray(jitted.u),
                            np.asarray(jitted.objective)),
                "port": (port.iterations.numpy(), port.u.numpy(), port.objective.numpy())}
        print(f"{label}:")
        for name, (its, _, _) in runs.items():
            print(f"  {name:10s} counts {its.tolist()} mean {its.mean():.3f}")
        names = list(runs)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                du = np.abs(runs[a][1] - runs[b][1]).max()
                dj = (np.abs(runs[a][2] - runs[b][2]) / np.abs(runs[b][2])).max()
                print(f"  max |du| {a} vs {b}: {du:.3g}, objective {dj:.3g} relative")


if __name__ == "__main__":
    main()
