"""Mixed-integer (exact ReLU) MPC on the host: the MILP engine.

The JAX package's ``solvers/milp.py``, kept in numpy float64 as it is
there. The global optimum of MPC over piecewise-affine ReLU dynamics comes
from the branch-and-bound solver of the native C++ runtime
(``native/qpref``: ``qpref_solve_relu_bb``, bound by ``native_qp``), which
branches on neuron phases,

    off: r = 0, a <= 0          on: r = a, a >= 0,

with the triangle relaxation (the convex hull of the ReLU graph on the
neuron's pre-activation interval [lo_a, hi_a], from forward interval
arithmetic over the box constraints) at unbranched nodes. Neurons whose
interval is sign-stable drop out of the search at transcription time.

The transcription is generic over the zoo's ReLU families (fnn, icnn,
resnet, densenet, polynet): one dynamics step is traced as affine
expressions over [x_k; u_k; relu outputs], read from the port's parameter
tensors as float64, and validated against the family's own ``apply_fn``.
Solutions come back as tensors on the controller's device; the search runs
on the host, a fleet of lanes in threads (:func:`solve_milp_batch`).
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .. import native_qp
from ..types import STATUS_CONVERGED, STATUS_MAX_ITER, STATUS_PRIMAL_INFEASIBLE, MpcSolution

MILP_FAMILIES = ("fnn", "icnn", "resnet", "densenet", "polynet")
BIG_M = 1000.0  # interval clamp, the big-M of the Julia package's MILP modelers


# ---------------------------------------------------------------------------
# Affine-expression tracing over the step-local variable vector
# [x_k (nx); u_k (nu); r_1; r_2; ...]
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Aff:
    M: np.ndarray  # (dim, width)
    c: np.ndarray  # (dim,)


def _pad(e: _Aff, width: int) -> _Aff:
    if e.M.shape[1] == width:
        return e
    M = np.zeros((e.M.shape[0], width))
    M[:, : e.M.shape[1]] = e.M
    return _Aff(M, e.c)


def _add(a: _Aff, b: _Aff) -> _Aff:
    w = max(a.M.shape[1], b.M.shape[1])
    a, b = _pad(a, w), _pad(b, w)
    return _Aff(a.M + b.M, a.c + b.c)


def _mat(W: np.ndarray, e: _Aff, b: Optional[np.ndarray] = None) -> _Aff:
    c = W @ e.c
    if b is not None:
        c = c + b
    return _Aff(W @ e.M, c)


def _cat(a: _Aff, b: _Aff) -> _Aff:
    w = max(a.M.shape[1], b.M.shape[1])
    a, b = _pad(a, w), _pad(b, w)
    return _Aff(np.vstack([a.M, b.M]), np.concatenate([a.c, b.c]))


class _Transcriber:
    """Collects ReLU units while a family's transcription traces one step."""

    def __init__(self, nx: int, nu: int):
        self.nx, self.nu = nx, nu
        self.width = nx + nu
        self.units: List[_Aff] = []  # pre-activation affine expr per unit

    def x(self) -> _Aff:
        M = np.zeros((self.nx, self.width))
        M[:, : self.nx] = np.eye(self.nx)
        return _Aff(M, np.zeros(self.nx))

    def u(self) -> _Aff:
        M = np.zeros((self.nu, self.width))
        M[:, self.nx : self.nx + self.nu] = np.eye(self.nu)
        return _Aff(M, np.zeros(self.nu))

    def relu(self, a: _Aff) -> _Aff:
        h = a.M.shape[0]
        self.units.append(_pad(a, self.width))
        start = self.width
        self.width += h
        M = np.zeros((h, self.width))
        M[:, start:] = np.eye(h)
        return _Aff(M, np.zeros(h))


def _np64(a) -> np.ndarray:
    """float64 numpy of a tensor (on any device) or an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def _transcribe_step(family: str, params, nx: int, nu: int) -> Tuple[_Transcriber, _Aff]:
    """Trace one step x_{k+1} = f(x_k, u_k) of a ReLU family into affine
    expressions + relu units (family math mirrors models/zoo.py)."""
    tr = _Transcriber(nx, nu)
    z = _cat(tr.x(), tr.u())
    if family in ("fnn", "resnet"):
        W_in, b_in = _np64(params["W_in"]), _np64(params["b_in"])
        Ws, bs = _np64(params["W"]), _np64(params["b"])
        W_out = _np64(params["W_out"])
        h = tr.relu(_mat(W_in, z, b_in))
        for j in range(Ws.shape[0]):
            r = tr.relu(_mat(Ws[j], h, bs[j]))
            h = _add(h, r) if family == "resnet" else r
        out = _mat(W_out, h)
    elif family == "icnn":
        W_in, b_in = _np64(params["W_in"]), _np64(params["b_in"])
        Wz, Wx, bs = _np64(params["Wz"]), _np64(params["Wx"]), _np64(params["b"])
        h = tr.relu(_mat(W_in, z, b_in))
        for j in range(Wz.shape[0]):
            a = _add(_mat(np.maximum(Wz[j], 0.0), h), _mat(Wx[j], z, bs[j]))
            h = tr.relu(a)
        out = _add(
            _mat(np.maximum(_np64(params["W_out"]), 0.0), h),
            _mat(_np64(params["Wx_out"]), z),
        )
    elif family == "densenet":
        W_in, b_in = _np64(params["W_in"]), _np64(params["b_in"])
        h = tr.relu(_mat(W_in, z, b_in))
        for blk in params["blocks"]:
            r = tr.relu(_mat(_np64(blk["W"]), h, _np64(blk["b"])))
            h = _cat(h, r)
        out = _mat(_np64(params["W_out"]), h)
    elif family == "polynet":
        W_in, b_in = _np64(params["W_in"]), _np64(params["b_in"])
        W1, b1 = _np64(params["W1"]), _np64(params["b1"])
        W2, b2 = _np64(params["W2"]), _np64(params["b2"])
        h = tr.relu(_mat(W_in, z, b_in))
        for j in range(W1.shape[0]):
            s = tr.relu(_mat(W1[j], h, b1[j]))
            t = tr.relu(_mat(W2[j], s, b2[j]))
            h = _add(_add(h, s), t)
        out = _mat(_np64(params["W_out"]), h)
    else:
        raise ValueError(
            f"family {family!r} has no MILP transcription; supported: "
            f"{MILP_FAMILIES}"
        )
    return tr, _pad(out, tr.width)


def _eval_transcription(tr: _Transcriber, out: _Aff, x: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Forward-evaluate the traced step (relu units in emission order)."""
    v = np.concatenate([x, u])
    for unit in tr.units:
        a = unit.M @ v[: unit.M.shape[1]] + unit.c
        v = np.concatenate([v, np.maximum(a, 0.0)])
    return out.M @ v[: out.M.shape[1]] + out.c


def _interval_bounds(
    tr: _Transcriber, x_lo, x_hi, u_lo, u_hi, big_m: float
):
    """Per-unit pre-activation interval bounds by forward interval
    arithmetic over the box constraints. Sign-stable neurons drop out of
    the search entirely; unstable ones get their triangle relaxation from
    these bounds. Returns ([(lo_a, hi_a)], lo_v, hi_v)."""
    lo = np.concatenate([x_lo, u_lo]).astype(np.float64)
    hi = np.concatenate([x_hi, u_hi]).astype(np.float64)
    bounds = []
    for unit in tr.units:
        M, c = unit.M[:, : lo.shape[0]], unit.c
        Mp, Mn = np.maximum(M, 0.0), np.minimum(M, 0.0)
        # true (unclipped) bounds — the a-range rows are sound constraints,
        # not big-M coefficients; big_m only seeds the unconstrained-state box
        lo_a = c + Mp @ lo + Mn @ hi
        hi_a = c + Mp @ hi + Mn @ lo
        bounds.append((lo_a, hi_a))
        lo = np.concatenate([lo, np.maximum(lo_a, 0.0)])
        hi = np.concatenate([hi, np.maximum(hi_a, 0.0)])
    return bounds, lo, hi


# ---------------------------------------------------------------------------
# Global assembly — condensed over the horizon.
#
# The state trajectory is ELIMINATED: x_{k+1} is affine in (x0, u_0..u_k,
# r_0..r_k), so the decision vector is only z = [u (N·nu); r (N·n_r)] —
# the same condensation philosophy as the linear path (ops/condense.py).
# Every constraint row is static in its coefficients; only the bounds
# depend on x0 (l = l0 + B·x0), which keeps the per-solve work to a few
# GEMVs — and lets the solver re-run forward interval propagation from the
# *measured* x0 each solve, re-classifying neurons (solve-time stabilized
# neurons never enter the branch-and-bound at all).
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _GlobAff:
    """Affine map value = Mz @ z + Mx0 @ x0 + c over the global decision z."""

    Mz: np.ndarray  # (dim, n)
    Mx0: np.ndarray  # (dim, nx)
    c: np.ndarray  # (dim,)


@dataclasses.dataclass
class MilpEngine:
    """Host-side exact-ReLU branch-and-bound engine (numpy float64). Not a
    TensorRecord: it stays on the host when its controller moves to the
    card, and each solve crosses into native/qpref."""

    # objective: 0.5 z'Pz + (q_const + Qx0 x0)'z  (+ state-only constant)
    P: np.ndarray
    q_const: np.ndarray
    Qx0: np.ndarray  # (n, nx)
    # constraints: l0 + B x0 <= A z <= u0 + B x0 (inf entries stay inf)
    A: np.ndarray
    l0: np.ndarray
    u0: np.ndarray
    B: np.ndarray  # (m, nx)
    # per design-unstable neuron instance (step-major):
    row_ge: np.ndarray
    row_a: np.ndarray
    row_tri: np.ndarray
    row_rbox: np.ndarray
    col_r: np.ndarray
    inst_step: np.ndarray  # step k of each instance
    inst_unit: np.ndarray  # unit index of each instance
    inst_elem: np.ndarray  # element within the unit
    a_Mx0: np.ndarray  # (nb, nx)  bias = a_c + a_Mx0 @ x0
    a_c: np.ndarray  # (nb,)
    # state-trajectory reconstruction: x_k = Xz z + Xx0 x0 + Xc
    Xz: np.ndarray  # ((N+1)*nx, n)
    Xx0: np.ndarray  # ((N+1)*nx, nx)
    Xc: np.ndarray  # ((N+1)*nx,)
    # per-solve re-propagation data
    tr: Any
    out: Any
    # design-time x0 propagation box: every static row (design-ON equality,
    # OFF r=0 pin, triangle relaxation) is sound only for x0 inside it; the
    # system handle lets solve_milp rebuild sound rows for an excursion
    system: Any
    x0_lo_design: np.ndarray
    x0_hi_design: np.ndarray
    n: int
    m: int
    N: int
    nx: int
    nu: int
    n_r: int
    state_constraint: bool
    X_lo: np.ndarray
    X_hi: np.ndarray
    U_lo: np.ndarray
    U_hi: np.ndarray
    big_m: float
    max_nodes: int = 100000
    # per-node budget: nodes are solved by the native IPM (~15 Newton
    # steps); this is the ADMM *fallback* budget, used only to certify
    # infeasible/stalled nodes (further capped at 5000 inside the C++ tree)
    max_iter: int = 20000
    # root OBBT passes (0 disables): each free pre-activation is min/max-ed
    # over the relaxation via the IPM to pin neurons and steepen triangle
    # slopes before the search, as SCIP's propagator does for big-M rows
    obbt_passes: int = 2
    # node-relaxation tolerance: 1e-6 keeps per-node ADMM cheap; the
    # incumbent is always re-solved phase-pinned, so exactness of the
    # returned trajectory doesn't hinge on node accuracy
    eps: float = 1e-6
    phase_tol: float = 1e-6

    @property
    def n_binary(self) -> int:
        """Search dimension (design-unstable neuron instances): the
        counterpart of a big-M MILP's binary count."""
        return int(self.col_r.shape[0])


def _apply_local(expr: _Aff, x_aff: _GlobAff, k: int, n: int, nx: int, nu: int,
                 off_u: int, off_r: int, n_r: int) -> _GlobAff:
    """Lift a step-local affine expr over [x_k; u_k; r_k] to global z/x0."""
    E = expr.M
    w = E.shape[1]
    Mz = E[:, :nx] @ x_aff.Mz
    Mz[:, off_u + k * nu : off_u + (k + 1) * nu] += E[:, nx : nx + nu]
    if w > nx + nu:
        Mz[:, off_r + k * n_r : off_r + k * n_r + (w - nx - nu)] += E[:, nx + nu :]
    return _GlobAff(
        Mz=Mz,
        Mx0=E[:, :nx] @ x_aff.Mx0,
        c=E[:, :nx] @ x_aff.c + expr.c,
    )


def _step_bounds(engine_or_args, x_lo_0, x_hi_0):
    """Forward interval propagation over the horizon. Returns per-step
    per-unit (lo_a, hi_a) lists. Used at design time (x_0 = box) and at
    solve time (x_0 = the measured point — much tighter)."""
    e = engine_or_args
    bounds_per_step = []
    x_lo, x_hi = np.asarray(x_lo_0, np.float64), np.asarray(x_hi_0, np.float64)
    for _k in range(e["N"]):
        ub, v_lo, v_hi = _interval_bounds(
            e["tr"], x_lo, x_hi, e["U_lo"], e["U_hi"], e["big_m"]
        )
        bounds_per_step.append(ub)
        out = e["out"]
        Mp, Mn = np.maximum(out.M, 0.0), np.minimum(out.M, 0.0)
        x_lo = out.c + Mp @ v_lo + Mn @ v_hi
        x_hi = out.c + Mp @ v_hi + Mn @ v_lo
        if e["state_constraint"]:
            # feasible trajectories also satisfy the box — intersect
            x_lo = np.maximum(x_lo, e["X_lo"])
            x_hi = np.minimum(x_hi, e["X_hi"])
    return bounds_per_step


def build_engine(
    system,
    tuning,
    max_nodes: int = 100000,
    big_m: float = BIG_M,
    x0_box: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> MilpEngine:
    """Assemble the condensed exact-ReLU program for N-step network MPC.

    Decision vector: z = [u_0..u_{N-1}; r_0..r_{N-1}] (states eliminated).
    Cost parity with the linear path (design_mpc.jl:405-468 / ops/condense):
    stage Q on x_1..x_{N-1}, terminal P on x_N, R on all inputs, S on Δu.

    ``x0_box`` overrides the design-time x0 propagation seed (used by
    solve_milp to rebuild sound rows when a measured x0 falls outside the
    original design box).
    """
    system = system.to("cpu")
    family = system.family
    params = system.params
    nx, nu, N = system.nx, system.nu, tuning.horizon
    tr, out = _transcribe_step(family, params, nx, nu)

    # validate the transcription against the model's own apply_fn
    rng = np.random.default_rng(0)
    for _ in range(4):
        xs = rng.standard_normal(nx) * 0.5
        us = rng.standard_normal(nu) * 0.5
        with torch.no_grad():
            want = system.apply_fn(
                params, torch.from_numpy(xs.astype(np.float32)),
                torch.from_numpy(us.astype(np.float32)),
            ).double().numpy()
        got = _eval_transcription(tr, out, xs, us)
        if not np.allclose(got, want, atol=1e-4):
            raise ValueError(
                f"MILP transcription of family {family!r} disagrees with "
                "apply_fn — the model must be ReLU-activated (the exact "
                "encoding holds only for relu, fnn/...:193-330)"
            )

    X_lo, X_hi = _np64(system.X.lo), _np64(system.X.hi)
    U_lo, U_hi = _np64(system.U.lo), _np64(system.U.hi)
    if x0_box is not None:
        x0_lo, x0_hi = _np64(x0_box[0]), _np64(x0_box[1])
    else:
        # seed the design-time propagation from the plant's state box even
        # when state constraints are off: ±big_m seeds blow the interval
        # bounds through trained-scale weights into useless relaxations
        # (B&B then stalls on its z=0 incumbent). Sound because solve_milp
        # gates every solve on x0 ∈ design box and rebuilds from the
        # widened box on excursion.
        x0_lo = np.where(np.isfinite(X_lo), X_lo, -big_m)
        x0_hi = np.where(np.isfinite(X_hi), X_hi, big_m)

    prop_args = {
        "N": N, "tr": tr, "out": out, "U_lo": U_lo, "U_hi": U_hi,
        "big_m": big_m, "state_constraint": bool(tuning.state_constraint),
        "X_lo": X_lo, "X_hi": X_hi,
    }
    design_bounds = _step_bounds(prop_args, x0_lo, x0_hi)

    n_r = tr.width - (nx + nu)
    off_u = 0
    off_r = N * nu
    n = off_r + N * n_r

    # --- lift the per-step affine maps to global (z, x0) ------------------
    x_aff = _GlobAff(
        Mz=np.zeros((nx, n)), Mx0=np.eye(nx), c=np.zeros(nx)
    )
    x_affs = [x_aff]
    unit_affs: List[List[_GlobAff]] = []
    for k in range(N):
        step_units = [
            _apply_local(_pad(u_, tr.width), x_aff, k, n, nx, nu, off_u, off_r, n_r)
            for u_ in tr.units
        ]
        unit_affs.append(step_units)
        x_aff = _apply_local(out, x_aff, k, n, nx, nu, off_u, off_r, n_r)
        x_affs.append(x_aff)

    rows_A: List[np.ndarray] = []
    rows_l: List[np.ndarray] = []
    rows_u: List[np.ndarray] = []
    rows_B: List[np.ndarray] = []
    row_count = 0

    def add_rows(A_blk, l_blk, u_blk, B_blk=None) -> int:
        nonlocal row_count
        rows_A.append(A_blk)
        rows_l.append(np.asarray(l_blk, np.float64))
        rows_u.append(np.asarray(u_blk, np.float64))
        rows_B.append(
            np.zeros((A_blk.shape[0], nx)) if B_blk is None else B_blk
        )
        first = row_count
        row_count += A_blk.shape[0]
        return first

    inf = np.inf
    row_ge_l: List[int] = []
    row_a_l: List[int] = []
    row_tri_l: List[int] = []
    row_rbox_l: List[int] = []
    col_r_l: List[int] = []
    inst_step: List[int] = []
    inst_unit: List[int] = []
    inst_elem: List[int] = []
    a_Mx0_l: List[np.ndarray] = []
    a_c_l: List[float] = []
    # r box rows, tightened per classification (filled as we walk)
    rbox_pending: List[Tuple[int, float]] = []  # (col, hi)

    for k in range(N):
        r_pos = 0
        for ui, (unit, aff) in enumerate(zip(tr.units, unit_affs[k])):
            h = unit.M.shape[0]
            lo_a, hi_a = design_bounds[k][ui]
            col0 = off_r + k * n_r + r_pos
            Er = np.zeros((h, n))
            Er[:, col0 : col0 + h] = np.eye(h)
            on = lo_a >= 0.0
            off = hi_a <= 0.0
            mid = ~(on | off)
            if np.any(on):
                # r == a: (Er - Mz) z = c + Mx0 x0  (x0-dependent equality)
                add_rows(
                    (Er - aff.Mz)[on], aff.c[on], aff.c[on], aff.Mx0[on]
                )
            if np.any(mid):
                nm = int(mid.sum())
                # r - a >= 0: (Er - Mz) z >= c + Mx0 x0
                first_ge = add_rows(
                    (Er - aff.Mz)[mid], aff.c[mid], np.full(nm, inf), aff.Mx0[mid]
                )
                # a in [lo, hi]: Mz z in [lo - c - Mx0 x0, hi - c - Mx0 x0]
                first_a = add_rows(
                    aff.Mz[mid], lo_a[mid] - aff.c[mid], hi_a[mid] - aff.c[mid],
                    -aff.Mx0[mid],
                )
                # triangle upper (design slope): r <= s (a - lo) with
                # s = hi/(hi - lo):
                # (Er - s Mz) z <= s (c - lo) ... + s Mx0 x0
                slope = hi_a[mid] / np.maximum(hi_a[mid] - lo_a[mid], 1e-12)
                first_tri = add_rows(
                    Er[mid] - slope[:, None] * aff.Mz[mid],
                    np.full(nm, -inf),
                    slope * (aff.c[mid] - lo_a[mid]),
                    slope[:, None] * aff.Mx0[mid],
                )
                for jj, j in enumerate(np.nonzero(mid)[0]):
                    row_ge_l.append(first_ge + jj)
                    row_a_l.append(first_a + jj)
                    row_tri_l.append(first_tri + jj)
                    col_r_l.append(col0 + int(j))
                    inst_step.append(k)
                    inst_unit.append(ui)
                    inst_elem.append(int(j))
                    a_Mx0_l.append(aff.Mx0[j])
                    a_c_l.append(float(aff.c[j]))
            for j in range(h):
                rbox_pending.append(
                    (col0 + j, 0.0 if off[j] else float(max(hi_a[j], 0.0)))
                )
            r_pos += h

    # r var boxes (col-ordered; OFF branches pin them to 0 at solve time)
    rbox_first = row_count
    Errs = np.zeros((len(rbox_pending), n))
    rb_hi = np.zeros(len(rbox_pending))
    rbox_row_of_col = {}
    for i, (col, hiv) in enumerate(rbox_pending):
        Errs[i, col] = 1.0
        rb_hi[i] = hiv
        rbox_row_of_col[col] = rbox_first + i
    add_rows(Errs, np.zeros(len(rbox_pending)), rb_hi)
    row_rbox_l = [rbox_row_of_col[c] for c in col_r_l]

    # input box (always on: linear/...:72-78)
    Eu = np.zeros((N * nu, n))
    Eu[:, off_u : off_u + N * nu] = np.eye(N * nu)
    add_rows(Eu, np.tile(U_lo, N), np.tile(U_hi, N))

    # state box, opt-in (linear/...:62), on x_1..x_N
    if tuning.state_constraint:
        for k in range(1, N + 1):
            add_rows(
                x_affs[k].Mz,
                X_lo - x_affs[k].c,
                X_hi - x_affs[k].c,
                -x_affs[k].Mx0,
            )

    # terminal constraint (design_mpc.jl:330-391)
    xrefN = _np64(tuning.references.x[:, -1])
    kind = tuning.terminal.kind
    if kind == "equality":
        add_rows(
            x_affs[N].Mz, xrefN - x_affs[N].c, xrefN - x_affs[N].c,
            -x_affs[N].Mx0,
        )
    elif kind == "neighborhood":
        H = _np64(tuning.terminal.H)
        b = _np64(tuning.terminal.b)
        add_rows(
            H @ x_affs[N].Mz,
            np.full(H.shape[0], -inf),
            b + H @ (xrefN - x_affs[N].c),
            -H @ x_affs[N].Mx0,
        )
    elif kind == "contractive":
        raise ValueError(
            "contractive terminal sets are quadratic — not representable in "
            "the MILP path; use the non_linear programming type"
        )

    A = np.vstack(rows_A)
    l0 = np.concatenate(rows_l)
    u0 = np.concatenate(rows_u)
    B = np.vstack(rows_B)

    # --- objective (cost parity with ops/condense._blockdiag_weight) ------
    P = np.zeros((n, n))
    q_const = np.zeros(n)
    Qx0 = np.zeros((n, nx))
    Q = _np64(tuning.weights.Q)
    R = _np64(tuning.weights.R)
    S = _np64(tuning.weights.S)
    Pterm = _np64(tuning.terminal.P)
    xref = _np64(tuning.references.x)  # (nx, N+1)
    uref = _np64(tuning.references.u)  # (nu, N)
    # stage Q on x_1..x_{N-1}, terminal P on x_N (e_x_1 constant, excluded)
    for k in range(1, N + 1):
        W = Pterm if k == N else Q
        Xk = x_affs[k]
        WX = W @ Xk.Mz
        P += 2.0 * Xk.Mz.T @ WX
        q_const += 2.0 * Xk.Mz.T @ (W @ (Xk.c - xref[:, k]))
        Qx0 += 2.0 * Xk.Mz.T @ (W @ Xk.Mx0)
    for k in range(N):
        i0 = off_u + k * nu
        P[i0 : i0 + nu, i0 : i0 + nu] += 2.0 * R
        q_const[i0 : i0 + nu] += -2.0 * R @ uref[:, k]
    if np.any(S != 0.0):
        for k in range(N - 1):
            i0 = off_u + k * nu
            i1 = off_u + (k + 1) * nu
            P[i0 : i0 + nu, i0 : i0 + nu] += 2.0 * S
            P[i1 : i1 + nu, i1 : i1 + nu] += 2.0 * S
            P[i0 : i0 + nu, i1 : i1 + nu] += -2.0 * S
            P[i1 : i1 + nu, i0 : i0 + nu] += -2.0 * S

    return MilpEngine(
        P=P, q_const=q_const, Qx0=Qx0, A=A, l0=l0, u0=u0, B=B,
        row_ge=np.asarray(row_ge_l, np.int32),
        row_a=np.asarray(row_a_l, np.int32),
        row_tri=np.asarray(row_tri_l, np.int32),
        row_rbox=np.asarray(row_rbox_l, np.int32),
        col_r=np.asarray(col_r_l, np.int32),
        inst_step=np.asarray(inst_step, np.int32),
        inst_unit=np.asarray(inst_unit, np.int32),
        inst_elem=np.asarray(inst_elem, np.int32),
        a_Mx0=np.asarray(a_Mx0_l) if a_Mx0_l else np.zeros((0, nx)),
        a_c=np.asarray(a_c_l, np.float64),
        Xz=np.vstack([xa.Mz for xa in x_affs]),
        Xx0=np.vstack([xa.Mx0 for xa in x_affs]),
        Xc=np.concatenate([xa.c for xa in x_affs]),
        tr=tr, out=out,
        system=system, x0_lo_design=x0_lo, x0_hi_design=x0_hi,
        n=n, m=A.shape[0], N=N, nx=nx, nu=nu, n_r=n_r,
        state_constraint=bool(tuning.state_constraint),
        X_lo=X_lo, X_hi=X_hi, U_lo=U_lo, U_hi=U_hi, big_m=big_m,
        max_nodes=max_nodes,
    )


def _rollout_incumbent(
    e: "MilpEngine", x0: np.ndarray, us: np.ndarray, A: np.ndarray,
    l: np.ndarray, u: np.ndarray,
) -> Optional[np.ndarray]:
    """Dive heuristic: roll the TRUE network from x0 under the warm input
    trajectory ``us`` (N, nu), capturing every relu output. The resulting
    z = [u; r] is phase-consistent by construction, so it is feasible for
    the exact-ReLU program whenever it satisfies the plain rows (boxes /
    terminal). Passed to the B&B as the initial incumbent: pruning starts
    at node 1 and any node/time-limit exit still returns an exact,
    dynamics-consistent control sequence (SCIP gets the same effect from
    its own diving heuristics)."""
    N, nx, nu, n_r = e.N, e.nx, e.nu, e.n_r
    z = np.zeros(e.n)
    z[: N * nu] = np.asarray(us, np.float64).reshape(-1)
    xk = np.asarray(x0, np.float64)
    for k in range(N):
        v = np.concatenate([xk, us[k]])
        for unit in e.tr.units:
            a = unit.M @ v[: unit.M.shape[1]] + unit.c
            v = np.concatenate([v, np.maximum(a, 0.0)])
        z[N * nu + k * n_r : N * nu + (k + 1) * n_r] = v[nx + nu :]
        xk = e.out.M @ v[: e.out.M.shape[1]] + e.out.c
    rows = A @ z
    tol = 1e-9 * (1.0 + np.abs(rows))
    lo_ok = ~np.isfinite(l) | (rows >= l - tol)
    hi_ok = ~np.isfinite(u) | (rows <= u + tol)
    return z if bool(np.all(lo_ok & hi_ok)) else None


# native statuses as the controller reports them: an incumbent optimal
# within the pruning slacks is a converged move
_STATUS = {
    native_qp.MIQP_OPTIMAL: STATUS_CONVERGED,
    native_qp.MIQP_NODE_LIMIT: STATUS_MAX_ITER,
    native_qp.MIQP_INFEASIBLE: STATUS_PRIMAL_INFEASIBLE,
    native_qp.MIQP_OPTIMAL_TOL: STATUS_CONVERGED,
}


def _no_trajectory(e: MilpEngine, tuning, status: int) -> MpcSolution:
    """A solution with zero trajectories and the status: no trajectory was
    found (never garbage values)."""
    refs = tuning.references
    dev = refs.x.device
    zero_x = torch.zeros((e.nx, e.N + 1), device=dev)
    zero_u = torch.zeros((e.nu, e.N), device=dev)
    big = torch.tensor(3.4e38, device=dev)
    return MpcSolution(
        x=zero_x, e_x=zero_x - refs.x, u=zero_u, e_u=zero_u - refs.u,
        status=torch.tensor(status, dtype=torch.int32, device=dev),
        iterations=torch.tensor(0, dtype=torch.int32, device=dev),
        primal_residual=big, dual_residual=torch.tensor(0.0, device=dev), objective=big,
    )


def solve_milp(engine: MilpEngine, tuning, x0: Any) -> MpcSolution:
    """One receding-horizon exact-ReLU solve on the host; the solution's
    tensors lie on the device of the tuning's references.

    Per solve, forward interval propagation from the measured x0
    re-classifies every design-unstable neuron instance: the solve-stable
    ones get their rows pinned and never enter the search; the root's
    bound tightening (OBBT) pins more. ``tuning.max_time`` bounds the
    search's wall clock."""
    from .sqp import true_objective  # the cost every engine reports

    t_start = time.time()
    e = engine
    x0 = _np64(x0).reshape(-1)
    # the static rows (design-ON equalities, OFF r = 0 pins, triangle
    # relaxations) hold only for x0 inside the design box: outside it,
    # rebuild from a widened box first
    tol = 1e-9 * (1.0 + np.abs(x0))
    if np.any(x0 < e.x0_lo_design - tol) or np.any(x0 > e.x0_hi_design + tol):
        # widen with a margin so that a drifting state does not rebuild every step
        span = np.maximum(e.x0_hi_design - e.x0_lo_design, 1e-3)
        lo = np.minimum(e.x0_lo_design, x0 - 0.1 * span)
        hi = np.maximum(e.x0_hi_design, x0 + 0.1 * span)
        e = build_engine(e.system, tuning, max_nodes=e.max_nodes, big_m=e.big_m, x0_box=(lo, hi))
    N, nx, nu = e.N, e.nx, e.nu
    refs = tuning.references
    dev = refs.x.device
    uref = _np64(refs.u)

    # the per-solve vectors: a few products with x0
    shift = e.B @ x0
    l = np.where(np.isfinite(e.l0), e.l0 + shift, e.l0)
    u = np.where(np.isfinite(e.u0), e.u0 + shift, e.u0)
    q = e.q_const + e.Qx0 @ x0

    # interval propagation from the measured x0
    prop_args = {
        "N": N, "tr": e.tr, "out": e.out, "U_lo": e.U_lo, "U_hi": e.U_hi,
        "big_m": e.big_m, "state_constraint": e.state_constraint,
        "X_lo": e.X_lo, "X_hi": e.X_hi,
    }
    sb = _step_bounds(prop_args, x0, x0)
    nb = e.n_binary
    bias = e.a_c + (e.a_Mx0 @ x0 if nb else np.zeros(0))
    lo_a = np.empty(nb)
    hi_a = np.empty(nb)
    for i in range(nb):
        lo, hi = sb[e.inst_step[i]][e.inst_unit[i]]
        lo_a[i] = lo[e.inst_elem[i]]
        hi_a[i] = hi[e.inst_elem[i]]
    ge, ar, rb, tri = e.row_ge, e.row_a, e.row_rbox, e.row_tri
    A_s = np.array(e.A)  # this solve's copy: the triangle slopes depend on the bounds

    def apply_bounds(lo_a, hi_a):
        """Re-derive every instance's rows from [lo_a, hi_a]: the a-row and
        r-box bounds, the ON pins, and the triangle relaxation's
        coefficients (its slope hi / (hi - lo) holds the interval, and the
        measured x0's intervals are far tighter than the design box's)."""
        on = lo_a >= 0.0
        off = hi_a <= 0.0
        free = ~(on | off)
        l[ar] = lo_a - bias
        u[ar] = hi_a - bias
        u[rb] = np.where(off, 0.0, np.maximum(hi_a, 0.0))
        l[ge[on]] = bias[on]
        u[ge[on]] = bias[on]
        # a pinned instance is exact (r = a or r = 0): relax its triangle
        # row so that a stale design slope cuts nothing
        u[tri[~free]] = np.inf
        fi = np.nonzero(free)[0]
        if fi.size:
            s = hi_a[fi] / np.maximum(hi_a[fi] - lo_a[fi], 1e-12)
            A_s[tri[fi], :] = -s[:, None] * e.A[ar[fi], :]
            A_s[tri[fi], e.col_r[fi]] += 1.0
            u[tri[fi]] = s * (bias[fi] - lo_a[fi])
            l[tri[fi]] = -np.inf
        return on, off, free

    on, off, free = apply_bounds(lo_a, hi_a)

    # bound tightening at the root: each free pre-activation minimized and
    # maximized over the current relaxation by the native IPM; tighter
    # intervals pin neurons and steepen the triangle slopes
    for _pass in range(e.obbt_passes):
        fi = np.nonzero(free)[0]
        if fi.size == 0:
            break
        changed = False
        for i in fi:
            c_row = e.A[ar[i]]
            for sign in (1.0, -1.0):
                x_o, _, st_o, _, _, _ = native_qp.solve_qp_ipm(
                    1e-9 * np.eye(e.n), sign * c_row, A_s, l, u, tol=1e-8
                )
                if st_o != 0:
                    continue
                val = float(c_row @ x_o) + bias[i]
                if sign > 0 and val - 1e-6 > lo_a[i]:
                    lo_a[i] = val - 1e-6
                    changed = True
                elif sign < 0 and val + 1e-6 < hi_a[i]:
                    hi_a[i] = val + 1e-6
                    changed = True
        if not changed:
            break
        on, off, free = apply_bounds(lo_a, hi_a)

    if np.any(lo_a > hi_a):
        # the reachable set from this x0 misses the state box
        return _no_trajectory(e, tuning, STATUS_PRIMAL_INFEASIBLE)

    idx = np.nonzero(free)[0].astype(np.int32)
    z_init = _rollout_incumbent(e, x0, np.clip(uref.T, e.U_lo, e.U_hi), A_s, l, u)
    z, _, st, nodes, obj = native_qp.solve_relu_bb(
        e.P, q, A_s, l, u,
        ge[idx], ar[idx], rb[idx], e.col_r[idx],
        lo_a[idx], hi_a[idx], bias[idx],
        max_iter=e.max_iter, eps_abs=e.eps, eps_rel=e.eps,
        max_nodes=e.max_nodes, phase_tol=e.phase_tol,
        # the wall-clock budget net of the root's bound tightening
        time_limit=max(1.0, float(tuning.max_time) - (time.time() - t_start)),
        z_init=z_init,
    )
    if st == native_qp.MIQP_NODE_LIMIT and obj >= 1e299:
        # the limit came before any incumbent: z means nothing
        return _no_trajectory(e, tuning, STATUS_MAX_ITER)
    t32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    xs = t32((e.Xz @ z + e.Xx0 @ x0 + e.Xc).reshape(N + 1, nx))  # (N+1, nx)
    us = t32(z[: N * nu].reshape(N, nu))
    if st == native_qp.MIQP_INFEASIBLE:
        objective = torch.tensor(3.4e38, device=dev)
    else:
        objective = true_objective(tuning, xs[None], us[None])[0]
    return MpcSolution(
        x=xs.T, e_x=xs.T - refs.x, u=us.T, e_u=us.T - refs.u,
        status=torch.tensor(_STATUS[st], dtype=torch.int32, device=dev),
        iterations=torch.tensor(nodes, dtype=torch.int32, device=dev),
        primal_residual=torch.tensor(0.0, device=dev),
        dual_residual=torch.tensor(0.0, device=dev),
        objective=objective,
    )


def solve_milp_batch(
    engine: MilpEngine,
    tuning,
    x0s: Any,  # (B, nx)
    n_workers: Optional[int] = None,
) -> MpcSolution:
    """B independent exact-ReLU solves in a pool of threads (at most
    ``os.cpu_count()``, or ``n_workers``). Each lane's interval propagation,
    bound tightening and search spend their time in native calls, which
    release the interpreter lock, and the native library keeps no global
    state. Returns a batched MpcSolution (leading axis B) on the device of
    the tuning's references."""
    x0s = _np64(x0s)
    B = x0s.shape[0]
    workers = n_workers or min(B, os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        sols = list(ex.map(lambda x0: solve_milp(engine, tuning, x0), x0s))
    return MpcSolution(**{
        f.name: torch.stack([getattr(s, f.name) for s in sols])
        for f in dataclasses.fields(MpcSolution)
    })
