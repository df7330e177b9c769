"""The general ADMM engine, port vs JAX: ``ops.admm._project`` on box, soft
and ball rows, and the batched ``ops.admm.solve`` against the JAX
package's ``jax.vmap(admm.solve)`` on the kinds of QP of
tests/test_admm.py (random, equality rows, primal and dual infeasible,
NaN-poisoned, warm-started, a ball block), made with numpy from a seed,
each lane its own QP vectors.

At eps 1e-4 every decision sits above both packages' fp32 noise, so
statuses and iteration counts are held lane by lane. At the default 1e-6
convergence is decided near that noise (XLA's CPU dot and torch's matmul
sum in different orders), so there statuses, the mean iteration count
(within one check interval) and, on converged lanes, z and y within 1e-4
are held.

The equality row is the exception: at rho_eq = 100 rho the first
x-update of either package already lies ~5e-3 off an f64 step of the same
fp32 operator (y of magnitude 21), so without refinement (the lean
config) its iteration counts follow roundoff even at 1e-4, and at 1e-6 it
converges only after thousands of iterations in either package (the
unperturbed QP of tests/test_admm.py: JAX over 4000, the port 3125). For
it the counts are not compared lane by lane, and at 1e-6 it gets a deep
budget so that both converge."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from automationlabsmodelpredictivecontrol_jl_tpu.ops import admm as jadmm

from automationlabsmodelpredictivecontrol_jl_torch import (
    STATUS_CONVERGED,
    STATUS_DUAL_INFEASIBLE,
    STATUS_NUMERIC_ERROR,
    STATUS_PRIMAL_INFEASIBLE,
)
from automationlabsmodelpredictivecontrol_jl_torch.ops import admm as tadmm

torch.set_num_threads(1)

B = 6
TOL = 1e-4  # z and y of converged lanes at eps 1e-6
ITER_SLACK = 25  # mean iterations at eps 1e-6: one check interval


def _random_qp(seed, n=8, m=12):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    P = M @ M.T + 0.1 * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    z0 = rng.normal(size=n)
    slack = rng.uniform(0.1, 1.0, size=m)
    Az = A @ z0
    return P, q, A, Az - slack, Az + slack


def _lanes(q, l, u, seed, spread=0.3):
    """B lanes: q perturbed per lane, the same bounds."""
    rng = np.random.default_rng(seed)
    qs = q[None] + spread * rng.normal(size=(B, q.size))
    tile = lambda v: np.tile(v, (B, 1))
    return qs.astype(np.float32), tile(l).astype(np.float32), tile(u).astype(np.float32)


def _kind(kind):
    """(P, A, eq mask, n_ball, q, l, u, ball_c, ball_r) of one kind, batched."""
    if kind in ("random", "warm", "nan"):
        P, q, A, l, u = _random_qp({"random": 0, "warm": 7, "nan": 1}[kind])
        qs, ls, us = _lanes(q, l, u, 11)
        if kind == "nan":
            qs[2, 0] = np.nan  # one lane poisoned
        nb = 0
    elif kind == "equality":
        P, q, A, l, u = _random_qp(5)
        l[0] = u[0] = 0.5 * (l[0] + u[0])
        qs, ls, us = _lanes(q, l, u, 12)
        nb = 0
    elif kind == "primal_infeasible":
        n = 4
        P, q = np.eye(n), np.zeros(n)
        A = np.zeros((2, n))
        A[0, 0] = A[1, 0] = 1.0
        l, u = np.asarray([1.0, -np.inf]), np.asarray([np.inf, -1.0])
        qs, ls, us = _lanes(q, l, u, 13)
        nb = 0
    elif kind == "dual_infeasible":
        P, q = np.diag([1.0, 0.0]), np.asarray([0.0, -1.0])
        A, l, u = np.asarray([[1.0, 0.0]]), np.asarray([-1.0]), np.asarray([1.0])
        qs, ls, us = _lanes(q, l, u, 14, spread=0.1)
        qs[:, 1] = -np.abs(qs[:, 1]) - 0.5  # a strictly descending ray in every lane
        nb = 0
    elif kind == "ball":
        # min ||z - z*||^2 s.t. ||z + c|| <= r: box rows, then a ball block
        n = 3
        P = 2.0 * np.eye(n)
        rng = np.random.default_rng(15)
        zstar = 1.0 + 0.2 * rng.normal(size=(B, n))
        qs = (-2.0 * zstar).astype(np.float32)
        A = np.vstack([np.eye(n), np.eye(n)])
        l = np.r_[np.full(n, -0.4), np.full(n, -np.inf)]
        u = np.r_[np.full(n, 0.9), np.full(n, np.inf)]
        ls, us = np.tile(l, (B, 1)).astype(np.float32), np.tile(u, (B, 1)).astype(np.float32)
        nb = n
        ball_c = (0.05 * rng.normal(size=(B, n))).astype(np.float32)
        ball_r = rng.uniform(0.3, 0.6, size=B).astype(np.float32)
        return P, A, np.zeros(2 * n, bool), nb, qs, ls, us, ball_c, ball_r
    else:
        raise KeyError(kind)
    eq = np.isfinite(l) & np.isfinite(u) & (l == u)
    return P, A, eq, nb, qs, ls, us, np.zeros((B, 0), np.float32), np.zeros(B, np.float32)


KINDS = ("random", "equality", "primal_infeasible", "dual_infeasible", "nan", "warm", "ball")
CONFIGS = {
    "default": dict(),  # R = 5, one refinement step
    "R1": dict(adapt_interval=0, refine_steps=2),  # one rho: the R = 1 path
    "R2-lean": dict(rho=1.0, rho_grid=(1.0, 10.0), refine_steps=0),
}


def _solve_pair(kind, eps, extra, warm=None):
    P, A, eq, nb, qs, ls, us, bc, br = _kind(kind)
    cfg = dict(dict(max_iter=4000, eps_abs=eps, eps_rel=eps), **extra)
    jcfg, tcfg = jadmm.AdmmConfig(**cfg), tadmm.AdmmConfig(**cfg)
    jop = jadmm.build_operator(P, A, eq, nb, jcfg)
    top = tadmm.build_operator(P, A, eq, nb, tcfg)
    args = (qs, ls, us, bc, br)
    if warm is None:
        jres = jax.vmap(lambda q, l, u, c, r: jadmm.solve(jop, q, l, u, c, r, config=jcfg))(
            *map(jnp.asarray, args))
        tres = tadmm.solve(top, *map(torch.from_numpy, args), config=tcfg)
    else:
        z0, y0 = warm
        jres = jax.vmap(
            lambda q, l, u, c, r, z, y: jadmm.solve(jop, q, l, u, c, r, z, y, config=jcfg)
        )(*map(jnp.asarray, args + (z0, y0)))
        tres = tadmm.solve(top, *map(torch.from_numpy, args), torch.from_numpy(z0),
                           torch.from_numpy(y0), config=tcfg)
    return jres, tres


EXPECT = {
    "random": STATUS_CONVERGED, "equality": STATUS_CONVERGED, "warm": STATUS_CONVERGED,
    "ball": STATUS_CONVERGED, "primal_infeasible": STATUS_PRIMAL_INFEASIBLE,
    "dual_infeasible": STATUS_DUAL_INFEASIBLE,
}


def _statuses(kind, jres, tres):
    st = tres.status.numpy()
    np.testing.assert_array_equal(st, np.asarray(jres.status))
    if kind == "nan":
        assert st[2] == STATUS_NUMERIC_ERROR
        assert (np.delete(st, 2) == STATUS_CONVERGED).all()
    else:
        assert (st == EXPECT[kind]).all()
    assert tres.z.shape == jres.z.shape and tres.y.shape == jres.y.shape
    assert tres.status.dtype == torch.int32 and tres.iterations.dtype == torch.int32


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("kind", KINDS)
def test_solve_matches_vmapped_jax_above_the_noise(kind, config):
    """eps 1e-4: statuses and iteration counts equal lane by lane (the
    equality row without refinement: statuses, see the module's note)."""
    jres, tres = _solve_pair(kind, 1e-4, CONFIGS[config])
    _statuses(kind, jres, tres)
    if (kind, config) != ("equality", "R2-lean"):
        np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))


@pytest.mark.parametrize("kind", KINDS)
def test_solve_matches_vmapped_jax_at_default_eps(kind):
    """eps 1e-6 (the default config): statuses, the mean iteration count,
    and z and y of converged lanes within 1e-4."""
    warm = None
    if kind == "warm":
        _, cold = _solve_pair(kind, 1e-6, {})
        warm = (cold.z.numpy(), cold.y.numpy())
    extra = dict(max_iter=20000) if kind == "equality" else {}
    jres, tres = _solve_pair(kind, 1e-6, extra, warm)
    _statuses(kind, jres, tres)
    it_j, it_t = np.asarray(jres.iterations, float), tres.iterations.numpy().astype(float)
    if kind != "equality":
        assert abs(it_t.mean() - it_j.mean()) <= ITER_SLACK
    ok = tres.status.numpy() == STATUS_CONVERGED
    np.testing.assert_allclose(tres.z.numpy()[ok], np.asarray(jres.z)[ok], atol=TOL)
    np.testing.assert_allclose(tres.y.numpy()[ok], np.asarray(jres.y)[ok], atol=TOL)
    if kind == "warm":
        # a warm start from the solution converges at the first check
        assert (tres.iterations.numpy() <= 25).all()
    if kind == "ball":
        bc, br = _kind("ball")[7:]
        z = tres.z.numpy()
        assert (np.linalg.norm(z + bc, axis=1) <= br + 1e-4).all()


def test_fixed_cost_path_matches_vmapped_jax():
    """adaptive=False: max_iter iterations at the starting rho, one check
    against the iterate one step before."""
    for kind in ("random", "primal_infeasible"):
        jres, tres = _solve_pair(kind, 1e-6, dict(adaptive=False, max_iter=300))
        np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
        assert (tres.iterations.numpy() == 300).all()
        np.testing.assert_allclose(tres.z.numpy(), np.asarray(jres.z), atol=1e-3)


def test_frozen_lanes_keep_their_state():
    """A lane that is done keeps its iterate and count while others go on:
    solving it alone gives the same answer as inside a slower batch."""
    P, q, A, l, u = _random_qp(0)
    cfg = tadmm.AdmmConfig(max_iter=4000, eps_abs=1e-4, eps_rel=1e-4)
    op = tadmm.build_operator(P, A, np.zeros(len(l), bool), 0, cfg)
    qs, ls, us = _lanes(q, l, u, 21, spread=1.0)
    e = torch.zeros((B, 0))
    full = tadmm.solve(op, *map(torch.from_numpy, (qs, ls, us)), e, torch.zeros(B), config=cfg)
    for i in range(B):
        one = tadmm.solve(op, *(torch.from_numpy(a[i:i + 1]) for a in (qs, ls, us)),
                          e[:1], torch.zeros(1), config=cfg)
        assert int(one.iterations[0]) == int(full.iterations[i])
        # products over one lane and over six round apart in the last bits
        np.testing.assert_allclose(one.z.numpy()[0], full.z.numpy()[i], atol=1e-5)


def _project_inputs(seed, m=9, nb=3):
    rng = np.random.default_rng(seed)
    v = (2.0 * rng.normal(size=(B, m))).astype(np.float32)
    lo = (-0.5 - rng.uniform(size=(B, m))).astype(np.float32)
    hi = (0.5 + rng.uniform(size=(B, m))).astype(np.float32)
    lo[:, 1] = -np.inf
    hi[:, 2] = np.inf
    shrink = np.full((B, m), np.inf, np.float32)  # hard rows
    shrink[:, 3:6] = rng.uniform(0.1, 2.0, size=(B, 3))  # soft rows
    bc = (0.3 * rng.normal(size=(B, nb))).astype(np.float32)
    br = rng.uniform(0.2, 3.0, size=B).astype(np.float32)
    return v, lo, hi, shrink, bc, br


@pytest.mark.parametrize("rows", ["box", "soft", "ball", "soft+ball"])
def test_project_matches_jax(rows):
    m = 9
    nb = 3 if "ball" in rows else 0
    v, lo, hi, shrink, bc, br = _project_inputs(3)
    A = np.vstack([np.eye(6), np.eye(6)[:3]])  # (9, 6): every row nonzero
    jop = jadmm.build_operator(np.eye(6), A, np.zeros(m, bool), nb)
    top = tadmm.build_operator(np.eye(6), A, np.zeros(m, bool), nb)
    assert top.n_ball == jop.n_ball == nb
    soft = "soft" in rows
    if not nb:
        bc = np.zeros((B, 0), np.float32)
    jf = lambda v, l, u, c, r, s: jadmm._project(jop, v, l, u, c, r, s if soft else None)
    want = jax.vmap(jf)(*map(jnp.asarray, (v, lo, hi, bc, br, shrink)))
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))
    got = tadmm._project(top, T(v), T(lo), T(hi), T(bc), torch.from_numpy(br),
                         T(shrink) if soft else None)
    np.testing.assert_allclose(got.numpy().T, np.asarray(want), rtol=1e-6, atol=1e-6)
    if nb:
        w = got.numpy().T[:, -nb:] + bc
        assert (np.linalg.norm(w, axis=1) <= br * (1 + 1e-6)).all()


def test_kernel_precision_is_not_read():
    """The general engine runs no kernel: every kernel_precision solves."""
    P, A, eq, nb, qs, ls, us, bc, br = _kind("random")
    res = []
    for mode in ("highest", "bf16x3", "default", "hybrid"):
        cfg = tadmm.AdmmConfig(max_iter=2000, kernel_precision=mode)
        op = tadmm.build_operator(P, A, eq, nb, dataclasses.replace(cfg, kernel_precision="highest"))
        res.append(tadmm.solve(op, *map(torch.from_numpy, (qs, ls, us, bc, br)), config=cfg))
    for r in res[1:]:
        assert torch.equal(r.z, res[0].z) and torch.equal(r.status, res[0].status)
