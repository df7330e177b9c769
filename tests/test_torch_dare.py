"""The port's device DARE solver (``ops/dare.py``) against the JAX
package's and scipy's, on the CPU.

Plants: the QTP linearization at the canonical weights, the wide random
plant (nx 16, nu 8) and seeded random stabilizable plants, made with
numpy. Bars: P within 1e-5 of the JAX package's SDA relative to max|P|
(both fp32, the same iteration), within 1e-4 of scipy's f64 solution,
the LQR gain within 1e-4 of JAX's; a batch of plants solves as each alone."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from automationlabsmodelpredictivecontrol_jl_tpu.ops import dare as jdare

from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big, qtp
from automationlabsmodelpredictivecontrol_jl_torch.ops import dare as tdare

torch.set_num_threads(1)


def _random_plant(seed, nx=5, nu=2):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nx, nx)) / np.sqrt(nx)
    A *= 1.05 / np.max(np.abs(np.linalg.eigvals(A)))  # mildly unstable
    B = rng.standard_normal((nx, nu))
    Q = np.diag(rng.uniform(0.5, 5.0, nx))
    R = np.diag(rng.uniform(0.1, 1.0, nu))
    return [a.astype(np.float32) for a in (A, B, Q, R)]


def _plants():
    s = qtp.linearized_discrete_system()
    yield "qtp", [s.A.numpy(), s.B.numpy(), 100 * np.eye(4, dtype=np.float32),
                  0.1 * np.eye(2, dtype=np.float32)]
    w = big.random_stable_system(16, 8, seed=0)
    yield "wide", [w.A.numpy(), w.B.numpy(), np.eye(16, dtype=np.float32),
                   np.eye(8, dtype=np.float32)]
    for seed in range(3):
        yield f"random{seed}", _random_plant(seed)


PLANTS = list(_plants())


@pytest.mark.parametrize("name,plant", PLANTS, ids=[p[0] for p in PLANTS])
def test_solve_dare_matches_jax_and_scipy(name, plant):
    A, B, Q, R = plant
    P = tdare.solve_dare(A, B, Q, R).numpy()
    Pj = np.asarray(jdare.solve_dare(*(jnp.asarray(a) for a in plant)))
    Ps = sla.solve_discrete_are(*(a.astype(np.float64) for a in plant))
    scale = np.max(np.abs(Ps))
    assert np.max(np.abs(P - Pj)) / scale <= 1e-5
    assert np.max(np.abs(P - Ps)) / scale <= 1e-4
    np.testing.assert_array_equal(P, P.T)
    res = float(tdare.dare_residual(*(torch.from_numpy(a) for a in plant), torch.from_numpy(P)))
    res_j = float(jdare.dare_residual(*(jnp.asarray(a) for a in plant), jnp.asarray(P)))
    assert abs(res - res_j) <= 1e-6 * scale and res <= 1e-4 * scale


@pytest.mark.parametrize("name,plant", PLANTS, ids=[p[0] for p in PLANTS])
def test_lqr_gain_matches_jax(name, plant):
    A, B, Q, R = plant
    Ps = sla.solve_discrete_are(*(a.astype(np.float64) for a in plant)).astype(np.float32)
    K = tdare.lqr_gain(*(torch.from_numpy(a) for a in (A, B, R, Ps))).numpy()
    Kj = np.asarray(jdare.lqr_gain(*(jnp.asarray(a) for a in (A, B, R, Ps))))
    np.testing.assert_allclose(K, Kj, rtol=0, atol=1e-4 * max(1.0, np.abs(Kj).max()))
    # the closed loop of the gain is stable
    assert np.max(np.abs(np.linalg.eigvals(A - B @ K))) < 1.0


def test_solve_dare_batched():
    """Three plants at once on a leading axis: each P as solved alone."""
    plants = [_random_plant(s) for s in range(3)]
    stack = [torch.from_numpy(np.stack([p[i] for p in plants])) for i in range(4)]
    P = tdare.solve_dare(*stack)
    assert P.shape == (3, 5, 5)
    for k, p in enumerate(plants):
        torch.testing.assert_close(P[k], tdare.solve_dare(*p), rtol=0, atol=1e-5 * float(P[k].abs().max()))
