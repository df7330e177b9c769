"""The building blocks of the port's nonlinear path against the JAX
package, lane by lane, on the CPU: the LTV condensing
(``ltv_prediction_matrices``), the Newton-Schulz inverse, the per-lane
ADMM operator (``build_operator_traced``) and the general engine's solve
on it, and the LTV Riccati KKT of multiple shooting (``ltv_factorize``,
``ltv_affine_solve``, ``solve_ms_qp``). Inputs are made with numpy from a
seed; each lane of the port's batch against the JAX function on that
lane, at 1e-5 of max(1, |JAX|) (1e-4 after 120 ADMM iterations)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automationlabsmodelpredictivecontrol_jl_tpu.ops import admm as jadmm
from automationlabsmodelpredictivecontrol_jl_tpu.ops import riccati_ltv as jltv
from automationlabsmodelpredictivecontrol_jl_tpu.ops.admm import AdmmConfig as JAdmm
from automationlabsmodelpredictivecontrol_jl_tpu.ops.condense import (
    ltv_prediction_matrices as j_ltv_pred,
)
from automationlabsmodelpredictivecontrol_jl_tpu.solvers.sqp import SqpConfig as JSqp

from automationlabsmodelpredictivecontrol_jl_torch.ops import admm as tadmm
from automationlabsmodelpredictivecontrol_jl_torch.ops import riccati_ltv as tltv
from automationlabsmodelpredictivecontrol_jl_torch.ops.admm import AdmmConfig as TAdmm
from automationlabsmodelpredictivecontrol_jl_torch.ops.condense import ltv_prediction_matrices

torch.set_num_threads(1)


def _close(t, j, rel):
    t = np.asarray(t, np.float64)
    j = np.asarray(j, np.float64)
    assert t.shape == j.shape, (t.shape, j.shape)
    err = np.max(np.abs(t - j)) / max(1.0, np.max(np.abs(j)))
    assert err <= rel, err


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def test_ltv_prediction_matrices_match_jax():
    rng = np.random.default_rng(0)
    As, Bs, cs = _rand(rng, 3, 6, 4, 4, scale=0.5), _rand(rng, 3, 6, 4, 2), _rand(rng, 3, 6, 4)
    F, G, h = ltv_prediction_matrices(*(torch.from_numpy(a) for a in (As, Bs, cs)))
    for lane in range(3):
        jF, jG, jh = j_ltv_pred(jnp.asarray(As[lane]), jnp.asarray(Bs[lane]), jnp.asarray(cs[lane]))
        _close(F[lane], jF, 1e-5)
        _close(G[lane], jG, 1e-5)
        _close(h[lane], jh, 1e-5)
    # cs None: no offset
    _, _, h0 = ltv_prediction_matrices(torch.from_numpy(As), torch.from_numpy(Bs))
    assert not h0.any()


@pytest.mark.parametrize("kappa", [1e2, 1e3, 1e4])
def test_newton_schulz_inverse_matches_jax(kappa):
    """Lanes of SPD matrices at a given condition number: the inverse as the
    JAX package's (1e-5 of max |K^-1|), and its residual at the fp32 floor
    that one refinement step then contracts (~kappa eps)."""
    rng = np.random.default_rng(int(kappa))
    n, lanes = 10, 3
    Ks = []
    for _ in range(lanes):
        Qm, _ = np.linalg.qr(rng.standard_normal((n, n)))
        Ks.append((Qm * np.geomspace(1.0, kappa, n)) @ Qm.T)
    K = np.asarray(Ks, np.float32)
    X = tadmm.newton_schulz_inverse(torch.from_numpy(K))
    for lane in range(lanes):
        jX = np.asarray(jadmm.newton_schulz_inverse(jnp.asarray(K[lane])))
        _close(X[lane].numpy() / np.abs(jX).max(), jX / np.abs(jX).max(), 1e-5 * kappa)
        res = np.abs(K[lane].astype(np.float64) @ X[lane].numpy() - np.eye(n)).max()
        assert res <= 50 * kappa * np.finfo(np.float32).eps


@pytest.mark.parametrize("kind", ["identity", "state_rows", "equality", "ball"])
def test_build_operator_traced_matches_jax(kind):
    rng = np.random.default_rng(1)
    n, lanes = 6, 3
    M = _rand(rng, lanes, n, n)
    P = np.einsum("bij,bkj->bik", M, M) + 0.5 * np.eye(n, dtype=np.float32)
    eye = np.broadcast_to(np.eye(n, dtype=np.float32), (lanes, n, n))
    extra = {"identity": 0, "state_rows": 8, "equality": 4, "ball": 4}[kind]
    A = np.concatenate([eye, _rand(rng, lanes, extra, n)], 1) if extra else eye.copy()
    eq = np.zeros(n + extra, bool)
    if kind == "equality":
        eq[n:] = True
    n_ball = 4 if kind == "ball" else 0
    cfg = JSqp().admm
    top = tadmm.build_operator_traced(
        torch.from_numpy(P), torch.from_numpy(np.ascontiguousarray(A)), eq, n_ball,
        TAdmm(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}), 2,
        identity_A=(kind == "identity"),
    )
    assert top.diag_a == (kind == "identity")
    for lane in range(lanes):
        jop = jadmm.build_operator_traced(
            jnp.asarray(P[lane]), jnp.asarray(A[lane]), eq, n_ball, cfg, 2,
            identity_A=(kind == "identity"),
        )
        for f in ("P_s", "A_s", "D", "E", "c"):
            _close(getattr(top, f)[lane], getattr(jop, f), 1e-5)
        _close(top.Ks[lane], jop.Ks, 1e-5)
        kinv = np.abs(np.asarray(jop.K_invs)).max()
        _close(top.K_invs[lane] / kinv, np.asarray(jop.K_invs) / kinv, 1e-4)
        _close(top.rho_vecs, jop.rho_vecs, 0)


@pytest.mark.parametrize("kind", ["box", "soft", "ball"])
def test_lane_operator_solve_matches_jax(kind):
    """The general engine on a per-lane operator: each lane as the JAX
    package's solve of its own QP (z within 1e-5 of max(1, |z|); status and
    iterations equal: at eps 1e-4 the checks' decisions sit above the fp32
    noise of the residuals, which at 1e-5 moves a lane's last check by
    one)."""
    rng = np.random.default_rng(2)
    n, lanes = 6, 4
    M = _rand(rng, lanes, n, n)
    P = np.einsum("bij,bkj->bik", M, M) + np.eye(n, dtype=np.float32)
    extra = 4
    A = np.concatenate([np.broadcast_to(np.eye(n, dtype=np.float32), (lanes, n, n)),
                        _rand(rng, lanes, extra, n)], 1)
    m = n + extra
    q = _rand(rng, lanes, n, scale=3.0)
    l = np.full((lanes, m), -1.0, np.float32)
    u = np.full((lanes, m), 1.0, np.float32)
    soft = np.full((m,), np.inf, np.float32)
    n_ball, ball_c, ball_r = 0, np.zeros((lanes, 0), np.float32), np.zeros(lanes, np.float32)
    if kind == "soft":
        soft[n:] = 5.0
        l[:, n:], u[:, n:] = -0.05, 0.05
    if kind == "ball":
        n_ball = extra
        l[:, n:], u[:, n:] = -np.inf, np.inf
        ball_c = _rand(rng, lanes, extra, scale=0.1)
        ball_r = np.full(lanes, 0.3, np.float32)
    y0 = _rand(rng, lanes, m, scale=0.1)
    jcfg = JAdmm(max_iter=4000, eps_abs=1e-4, eps_rel=1e-4, refine_steps=1)
    tcfg = TAdmm(max_iter=4000, eps_abs=1e-4, eps_rel=1e-4, refine_steps=1)
    top = tadmm.build_operator_traced(torch.from_numpy(P), torch.from_numpy(A),
                                      np.zeros(m, bool), n_ball, tcfg, 2)
    res = tadmm.solve(top, *(torch.from_numpy(a) for a in (q, l, u, ball_c, ball_r)), None,
                      torch.from_numpy(y0), config=tcfg, soft_mu=torch.from_numpy(soft))
    for lane in range(lanes):
        jop = jadmm.build_operator_traced(jnp.asarray(P[lane]), jnp.asarray(A[lane]),
                                          np.zeros(m, bool), n_ball, jcfg, 2)
        jr = jadmm.solve(jop, jnp.asarray(q[lane]), jnp.asarray(l[lane]), jnp.asarray(u[lane]),
                         jnp.asarray(ball_c[lane]), jnp.asarray(ball_r[lane]), None,
                         jnp.asarray(y0[lane]), config=jcfg, soft_mu=jnp.asarray(soft))
        _close(res.z[lane], jr.z, 1e-5)
        assert int(res.status[lane]) == int(jr.status) == 0
        assert int(res.iterations[lane]) == int(jr.iterations)


def _ltv_problem(seed, lanes=3, N=6, nx=4, nu=2):
    rng = np.random.default_rng(seed)
    As = _rand(rng, lanes, N, nx, nx, scale=0.4) + np.eye(nx, dtype=np.float32)
    Bs = _rand(rng, lanes, N, nx, nu, scale=0.5)
    cs = _rand(rng, lanes, N, nx, scale=0.05)
    Qb = np.diag(rng.uniform(1.0, 3.0, nx)).astype(np.float32)
    Rb = np.diag(rng.uniform(0.5, 1.0, nu)).astype(np.float32)
    QbT = (2 * Qb).astype(np.float32)
    return rng, As, Bs, cs, Qb, Rb, QbT


def test_ltv_factorize_and_affine_solve_match_jax():
    rng, As, Bs, cs, Qb, Rb, QbT = _ltv_problem(3)
    lanes, N, nx, nu = Bs.shape
    t = lambda a: torch.from_numpy(a)
    f = tltv.ltv_factorize(t(As), t(Bs), t(cs), t(Qb), t(Rb), t(QbT))
    lq, lqT, lu = _rand(rng, lanes, N, nx), _rand(rng, lanes, nx), _rand(rng, lanes, N, nu)
    dX, dU = tltv.ltv_affine_solve(f, t(lq), t(lqT), t(lu))
    for lane in range(lanes):
        jf = jltv.ltv_factorize(*(jnp.asarray(a) for a in (As[lane], Bs[lane], cs[lane])),
                                jnp.asarray(Qb), jnp.asarray(Rb), jnp.asarray(QbT))
        for k in ("K", "G", "AmBK", "h"):
            _close(getattr(f, k)[lane], getattr(jf, k), 1e-5)
        jdX, jdU = jltv.ltv_affine_solve(jf, jnp.asarray(lq[lane]), jnp.asarray(lqT[lane]),
                                         jnp.asarray(lu[lane]))
        _close(dX[lane], jdX, 1e-5)
        _close(dU[lane], jdU, 1e-5)


@pytest.mark.parametrize("kind", ["none", "state_box", "equality", "contractive", "soft"])
def test_solve_ms_qp_matches_jax(kind):
    """120 consensus ADMM iterations on the multiple-shooting subproblem,
    each terminal branch and soft boxes: lane by lane within 1e-4."""
    rng, As, Bs, cs, Qb, Rb, QbT = _ltv_problem(4)
    lanes, N, nx, nu = Bs.shape
    rho, rho_x = np.float32(0.5), np.float32(2.0)
    interior = kind in ("state_box", "soft")
    eye = np.eye(nx, dtype=np.float32)
    Qb_ = Qb + rho_x * eye if interior else Qb
    QbT_ = QbT + rho_x * eye if kind != "none" else QbT
    lq_nodes = np.concatenate([np.zeros((lanes, 1, nx), np.float32),
                               _rand(rng, lanes, N, nx)], 1)
    lu0 = _rand(rng, lanes, N, nu)
    u_lo = np.full((lanes, N, nu), -0.3, np.float32)
    u_hi = np.full((lanes, N, nu), 0.3, np.float32)
    x_lo = x_hi = xN_lo = xN_hi = ball_c = None
    if interior:
        x_lo = np.full((lanes, N - 1, nx), -0.2, np.float32)
        x_hi = -x_lo
        xN_lo, xN_hi = np.full((lanes, nx), -0.2, np.float32), np.full((lanes, nx), 0.2, np.float32)
    if kind == "equality":
        xN_lo = xN_hi = _rand(rng, lanes, nx, scale=0.05)
    if kind == "contractive":
        ball_c = _rand(rng, lanes, nx, scale=0.2)
    ball_r = np.full(lanes, 0.1, np.float32)
    lamX0 = _rand(rng, lanes, N + 1, nx, scale=0.01)
    lamU0 = _rand(rng, lanes, N, nu, scale=0.01)
    soft = 3.0 if kind == "soft" else None
    box = kind not in ("equality", "contractive")
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))
    f = tltv.ltv_factorize(t(As), t(Bs), t(cs), t(Qb_), t(Rb), t(QbT_))
    out = tltv.solve_ms_qp(f, t(lq_nodes), t(lu0), t(u_lo), t(u_hi), t(x_lo), t(x_hi),
                           t(xN_lo), t(xN_hi), t(ball_c), t(ball_r), t(lamX0), t(lamU0),
                           torch.tensor(rho), 120, soft_mu=soft, terminal_is_box=box,
                           rho_x=torch.tensor(rho_x))
    for lane in range(lanes):
        jf = jltv.ltv_factorize(*(jnp.asarray(a[lane]) for a in (As, Bs, cs)),
                                jnp.asarray(Qb_), jnp.asarray(Rb), jnp.asarray(QbT_))
        g = lambda a: None if a is None else jnp.asarray(a[lane])
        jout = jltv.solve_ms_qp(jf, g(lq_nodes), g(lu0), g(u_lo), g(u_hi), g(x_lo), g(x_hi),
                                g(xN_lo), g(xN_hi), g(ball_c), g(ball_r), g(lamX0), g(lamU0),
                                jnp.asarray(rho), 120, soft_mu=soft, terminal_is_box=box,
                                rho_x=jnp.asarray(rho_x))
        for a, b in zip(out, jout):
            _close(a[lane], b, 1e-4)
