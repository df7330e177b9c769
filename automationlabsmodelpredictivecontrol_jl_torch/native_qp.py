"""ctypes binding of the native f64 QP solver ``qpref_solve``
(``native/qpref/qpref.cpp``), the host oracle that closes the last
straggler lanes of an escalated batch.

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
    _lib = lib
    return lib


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


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
    P = np.ascontiguousarray(P, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    l = np.ascontiguousarray(l, np.float64)
    u = np.ascontiguousarray(u, np.float64)
    n = P.shape[0]
    m = A.shape[0]
    if P.shape != (n, n) or q.shape != (n,) or A.shape != (m, n):
        raise ValueError(f"shapes P {P.shape}, q {q.shape}, A {A.shape} disagree")
    if l.shape != (m,) or u.shape != (m,):
        raise ValueError(f"bounds l {l.shape}, u {u.shape} need shape ({m},)")
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
