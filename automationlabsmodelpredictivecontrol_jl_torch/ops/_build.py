"""Build and load the port's CUDA kernels.

The sources in ``csrc/*.cu`` compile with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, ``build/kernels/libmpc_kernels.so``
at the root of the checkout, on first use (or when a source is newer than
the library). The library is loaded with ctypes. Nothing here runs at
import time: the CPU tests import every module on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
LIB_PATH = os.path.join(os.path.dirname(_PKG), "build", "kernels", "libmpc_kernels.so")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--fmad=false",  # round after every elementwise op, as PyTorch does
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel
)

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build_kernels(force: bool = False) -> str:
    """Compile ``csrc/*.cu`` into the library unless it is up to date.

    Returns the compiler's output (``-Xptxas -v`` reports each kernel's
    registers, shared memory and spills), or "" when nothing was built.
    Raises RuntimeError when nvcc fails.
    """
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    if (
        not force
        and os.path.exists(LIB_PATH)
        and os.path.getmtime(LIB_PATH) >= max(os.path.getmtime(s) for s in sources)
    ):
        return ""
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"  # atomic replace: concurrent builders
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {res.returncode}: {' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    return res.stdout + res.stderr


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use, with every C signature set."""
    global _lib
    if _lib is not None:
        return _lib
    build_kernels()
    lib = ctypes.CDLL(LIB_PATH)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.admm_diag_chunk.restype = ci
    lib.admm_diag_chunk.argtypes = [vp] * 17 + [ci] * 5 + [cf, cf, vp]
    _lib = lib
    return lib
