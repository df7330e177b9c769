"""ctypes bindings of the native f64 solvers of ``native/qpref/qpref.cpp``:
``qpref_solve`` (ADMM), the host oracle that closes the last straggler
lanes of an escalated batch; ``qpref_solve_ipm`` (a dense interior-point
method), ``qpref_solve_miqp`` and ``qpref_solve_relu_bb`` (branch and
bound), the MILP engine's back end (``solvers/milp.py``); and
``qpref_solve_batch``. ctypes releases the interpreter lock for each call,
and the library keeps no global state, so threads may call it at once.

The library is compiled from the checkout's source with
``g++ -O3 -fPIC -std=c++17 -shared`` into ``build/qpref/libqpref.so`` on
first use (or when the source is newer). It never runs ``make`` in
``native/qpref``, whose tracked library belongs to the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_ROOT, "native", "qpref", "qpref.cpp")
LIB_PATH = os.path.join(_ROOT, "build", "qpref", "libqpref.so")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> None:
    """Compile the library unless it is newer than its source."""
    if (
        not force
        and os.path.exists(LIB_PATH)
        and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE)
    ):
        return
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"  # atomic replace: concurrent builders
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"g++ failed with exit code {res.returncode}: {' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, LIB_PATH)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(LIB_PATH)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.qpref_solve.restype = ctypes.c_int
    lib.qpref_solve.argtypes = [
        ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, dp, dp, ip, dp, dp,
    ]
    lib.qpref_solve_ipm.restype = ctypes.c_int
    lib.qpref_solve_ipm.argtypes = [
        ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp,
        ctypes.c_int, ctypes.c_double, dp, dp, ip, dp, dp,
    ]
    lib.qpref_solve_batch.restype = ctypes.c_int
    lib.qpref_solve_batch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, dp, dp, ip, ip, dp, dp,
    ]
    lib.qpref_solve_miqp.restype = ctypes.c_int
    lib.qpref_solve_miqp.argtypes = [
        ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp,
        ctypes.c_int, ip, ip,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_double,
        ctypes.c_double,
        dp, dp, dp, ip, ip,
    ]
    lib.qpref_solve_relu_bb.restype = ctypes.c_int
    lib.qpref_solve_relu_bb.argtypes = [
        ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp,
        ctypes.c_int, ip, ip, ip, ip, dp, dp, dp,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, dp,
        dp, dp, dp, ip, ip,
    ]
    _lib = lib
    return lib


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _f64(*arrays):
    return [np.ascontiguousarray(a, np.float64) for a in arrays]


def _i32(*arrays):
    return [np.ascontiguousarray(a, np.int32) for a in arrays]


def _check_qp(P, q, A, l, u):
    """(n, m) of a QP, raising where its shapes disagree."""
    n, m = P.shape[0], A.shape[0]
    if P.shape != (n, n) or q.shape != (n,) or A.shape != (m, n):
        raise ValueError(f"shapes P {P.shape}, q {q.shape}, A {A.shape} disagree")
    if l.shape != (m,) or u.shape != (m,):
        raise ValueError(f"bounds l {l.shape}, u {u.shape} need shape ({m},)")
    return n, m


def solve_qp(
    P: np.ndarray,
    q: np.ndarray,
    A: np.ndarray,
    l: np.ndarray,
    u: np.ndarray,
    max_iter: int = 20000,
    eps_abs: float = 1e-9,
    eps_rel: float = 1e-9,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    z0: Optional[np.ndarray] = None,
    y0: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, int, int, float, float]:
    """Solve min 0.5 z'Pz + q'z s.t. l <= Az <= u in f64.

    Returns (z, y, status, iterations, primal_residual, dual_residual);
    status codes match types.STATUS_*."""
    lib = _load()
    P, q, A, l, u = _f64(P, q, A, l, u)
    n, m = _check_qp(P, q, A, l, u)
    z = np.zeros(n) if z0 is None else np.array(z0, np.float64).reshape(n)
    y = np.zeros(m) if y0 is None else np.array(y0, np.float64).reshape(m)
    iters = ctypes.c_int(0)
    rp = ctypes.c_double(0.0)
    rd = ctypes.c_double(0.0)
    status = lib.qpref_solve(
        n, m, _dp(P), _dp(q), _dp(A), _dp(l), _dp(u),
        max_iter, eps_abs, eps_rel, rho, sigma, alpha,
        _dp(z), _dp(y), ctypes.byref(iters), ctypes.byref(rp), ctypes.byref(rd),
    )
    return z, y, int(status), int(iters.value), float(rp.value), float(rd.value)


def solve_qp_ipm(
    P: np.ndarray,
    q: np.ndarray,
    A: np.ndarray,
    l: np.ndarray,
    u: np.ndarray,
    max_iter: int = 100,
    tol: float = 1e-9,
    x0: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, int, int, float, float]:
    """Dense Mehrotra predictor-corrector interior-point method, the node
    solver of the branch-and-bound searches: the problem and status codes
    of :func:`solve_qp`, in ~10-30 Newton iterations."""
    lib = _load()
    P, q, A, l, u = _f64(P, q, A, l, u)
    n, m = _check_qp(P, q, A, l, u)
    x = np.zeros(n) if x0 is None else np.array(x0, np.float64).reshape(n)
    y = np.zeros(m)
    iters = ctypes.c_int(0)
    rp = ctypes.c_double(0.0)
    rd = ctypes.c_double(0.0)
    status = lib.qpref_solve_ipm(
        n, m, _dp(P), _dp(q), _dp(A), _dp(l), _dp(u), max_iter, tol,
        _dp(x), _dp(y), ctypes.byref(iters), ctypes.byref(rp), ctypes.byref(rd),
    )
    return x, y, int(status), int(iters.value), float(rp.value), float(rd.value)


# statuses of the branch-and-bound solvers
MIQP_OPTIMAL = 0
MIQP_NODE_LIMIT = 1
MIQP_INFEASIBLE = 2
# the tree was explored, but some subtree was cut without a certificate
# (a stalled node, or a bound prune on an approximately converged
# relaxation): the incumbent is feasible and optimal within the pruning
# slacks, not certified globally optimal
MIQP_OPTIMAL_TOL = 3


def solve_miqp(
    P: np.ndarray,
    q: np.ndarray,
    A: np.ndarray,
    l: np.ndarray,
    u: np.ndarray,
    bin_rows: np.ndarray,
    bin_cols: np.ndarray,
    max_iter: int = 20000,
    eps_abs: float = 1e-9,
    eps_rel: float = 1e-9,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    max_nodes: int = 100000,
    int_tol: float = 1e-5,
    time_limit: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, int, int, float]:
    """Branch-and-bound MIQP: z[bin_cols] binary, with [0, 1] boxes at the
    rows ``bin_rows`` of A. ``time_limit`` (seconds, <= 0: none) bounds the
    search's wall clock. Returns (z, y, status (MIQP_*), nodes,
    objective)."""
    lib = _load()
    P, q, A, l, u = _f64(P, q, A, l, u)
    n, m = _check_qp(P, q, A, l, u)
    bin_rows, bin_cols = _i32(bin_rows, bin_cols)
    nb = bin_rows.shape[0]
    if bin_cols.shape != (nb,):
        raise ValueError(f"bin_rows {bin_rows.shape} and bin_cols {bin_cols.shape} disagree")
    z = np.zeros(n)
    y = np.zeros(m)
    obj = ctypes.c_double(0.0)
    nodes = ctypes.c_int(0)
    status = ctypes.c_int(0)
    lib.qpref_solve_miqp(
        n, m, _dp(P), _dp(q), _dp(A), _dp(l), _dp(u), nb, _ip(bin_rows), _ip(bin_cols),
        max_iter, eps_abs, eps_rel, rho, sigma, alpha, max_nodes, float(time_limit), int_tol,
        _dp(z), _dp(y), ctypes.byref(obj), ctypes.byref(nodes), ctypes.byref(status),
    )
    return z, y, int(status.value), int(nodes.value), float(obj.value)


def solve_relu_bb(
    P: np.ndarray,
    q: np.ndarray,
    A: np.ndarray,
    l: np.ndarray,
    u: np.ndarray,
    row_ge: np.ndarray,
    row_a: np.ndarray,
    row_rbox: np.ndarray,
    col_r: np.ndarray,
    lo_a: np.ndarray,
    hi_a: np.ndarray,
    a_bias: Optional[np.ndarray] = None,
    max_iter: int = 20000,
    eps_abs: float = 1e-9,
    eps_rel: float = 1e-9,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    max_nodes: int = 100000,
    phase_tol: float = 1e-6,
    time_limit: float = 0.0,
    z_init: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, int, int, float]:
    """Exact-ReLU branch and bound: branches on neuron phases (off: r = 0,
    a <= 0; on: r = a, a >= 0) with the triangle relaxation at unbranched
    nodes. Per unstable neuron: its r >= a row, its a-range row, its r box
    row, the r column and [lo_a, hi_a] in a-space (``a_bias`` the affine
    constant c, the row's value being a - c). ``z_init``: a feasible,
    phase-consistent point that seeds the incumbent. Returns (z, y, status
    (MIQP_*), nodes, objective)."""
    lib = _load()
    P, q, A, l, u = _f64(P, q, A, l, u)
    n, m = _check_qp(P, q, A, l, u)
    row_ge, row_a, row_rbox, col_r = _i32(row_ge, row_a, row_rbox, col_r)
    nb = row_ge.shape[0]
    lo_a, hi_a = _f64(lo_a, hi_a)
    a_bias = np.zeros(nb) if a_bias is None else _f64(a_bias)[0]
    for name, a in (("row_a", row_a), ("row_rbox", row_rbox), ("col_r", col_r),
                    ("lo_a", lo_a), ("hi_a", hi_a), ("a_bias", a_bias)):
        if a.shape != (nb,):
            raise ValueError(f"{name} {a.shape} needs shape ({nb},)")
    if z_init is not None:
        z_init = _f64(z_init)[0]
        if z_init.shape != (n,):
            raise ValueError(f"z_init {z_init.shape} needs shape ({n},)")
    z = np.zeros(n)
    y = np.zeros(m)
    obj = ctypes.c_double(0.0)
    nodes = ctypes.c_int(0)
    status = ctypes.c_int(0)
    lib.qpref_solve_relu_bb(
        n, m, _dp(P), _dp(q), _dp(A), _dp(l), _dp(u),
        nb, _ip(row_ge), _ip(row_a), _ip(row_rbox), _ip(col_r), _dp(lo_a), _dp(hi_a), _dp(a_bias),
        max_iter, eps_abs, eps_rel, rho, sigma, alpha, max_nodes, float(time_limit), phase_tol,
        _dp(z_init) if z_init is not None else None,
        _dp(z), _dp(y), ctypes.byref(obj), ctypes.byref(nodes), ctypes.byref(status),
    )
    return z, y, int(status.value), int(nodes.value), float(obj.value)


def solve_qp_batch(
    P: np.ndarray,
    qs: np.ndarray,  # (B, n)
    A: np.ndarray,
    ls: np.ndarray,  # (B, m)
    us: np.ndarray,  # (B, m)
    max_iter: int = 20000,
    eps_abs: float = 1e-9,
    eps_rel: float = 1e-9,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """B QPs that share (P, A), with their own q, l, u. Returns (z (B, n),
    y (B, m), status (B,), iterations (B,))."""
    lib = _load()
    P, A, qs, ls, us = _f64(P, A, qs, ls, us)
    B, n = qs.shape
    m = A.shape[0]
    if P.shape != (n, n) or A.shape != (m, n) or ls.shape != (B, m) or us.shape != (B, m):
        raise ValueError(
            f"shapes P {P.shape}, qs {qs.shape}, A {A.shape}, ls {ls.shape}, us {us.shape} disagree"
        )
    z = np.zeros((B, n))
    y = np.zeros((B, m))
    status = np.zeros(B, np.int32)
    iters = np.zeros(B, np.int32)
    rp = np.zeros(B)
    rd = np.zeros(B)
    lib.qpref_solve_batch(
        B, n, m, _dp(P), _dp(qs), _dp(A), _dp(ls), _dp(us),
        int(max_iter), float(eps_abs), float(eps_rel), float(rho), float(sigma), float(alpha),
        _dp(z), _dp(y), _ip(status), _ip(iters), _dp(rp), _dp(rd),
    )
    return z, y, status, iters
