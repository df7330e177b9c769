"""Faults planted under the timed path, for the fault tests. Each is a
module-level function of the session, so that spawned ranks can take it."""

import dataclasses

import torch


def stuck_state(session):
    """Every chunk returns its state unchanged."""
    ctrl, parallel = session.ctrl, session.parallel
    if hasattr(ctrl.engine, "qp"):
        def chunk(op, qT, lT, uT, idx, x, s, y, ax, ck, cfg):
            return x, s, y, ax
    else:
        def chunk(op, ridx, e0T, ballr, vX, vU, lamX, lamU, ck):
            return vX, vU, vX, vU, lamX, lamU
    session.solve = lambda x0s: parallel.solve_batch_fused(ctrl, x0s, chunk_fn=chunk)


def half_batch(session):
    """Half of the batch left out: its lanes copy the solved half's, and
    the diagnostics are taken over the solved half."""
    ctrl, parallel = session.ctrl, session.parallel

    def solve(x0s):
        B = x0s.shape[0]
        h = B // 2
        sol, wz, wy, d = parallel.solve_batch_fused(ctrl, x0s[:h])
        dup = lambda t: torch.cat([t, t[:B - h]])
        sol = type(sol)(**{f.name: dup(getattr(sol, f.name)) for f in dataclasses.fields(sol)})
        return sol, dup(wz), dup(wy), d

    session.solve = solve


def altered_answer(session):
    """Every lane's input sequence altered where the solve returns it."""
    real = session.solve

    def solve(x0s):
        sol, wz, wy, d = real(x0s)
        return sol.replace(u=sol.u + 0.05), wz, wy, d

    session.solve = solve


def exchange_left_out(session):
    """The ranks' diagnostics never exchanged: each keeps its own."""
    from automationlabsmodelpredictivecontrol_jl_torch.parallel import scenarios

    scenarios._psum_diagnostics = lambda d, mesh: d
