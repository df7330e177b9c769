"""Build and load the port's CUDA kernels.

Each source in ``csrc/*.cu`` compiles with its own ``nvcc`` for
``sm_90a``, all of them at once, into an object file; the objects link
into one shared library with a plain C interface,
``build/kernels/libmpc_kernels.so`` at the root of the checkout (K3's
register tiers, and the widest tier's routes, are sources of their own
over one header, so that they build side by side; K3W, the width-general
Riccati chunk, is ``riccati_wide_seq.cu`` (the sequential sweeps) and
``riccati_wide.cu`` (the doubling sweeps), with the drivers' wide rollout
and certificate in ``riccati_wide_rec.cu``;
the stream route of K1 and K2, ``admm_diag_stream.cu``; the wide route of
K4 and K5, ``admm_perr_wide.cu``). That happens on
first use, or when a source or a header is newer than the library. The
library is loaded with ctypes. Nothing here runs at import time: the CPU
tests import every module on a machine with no nvcc.
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

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def _run(procs) -> str:
    """Wait for every (cmd, Popen); return their output, raise on the first
    that failed."""
    out, failed = [], None
    for cmd, proc in procs:
        stdout, _ = proc.communicate()
        out.append(stdout)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, stdout)
    if failed:
        cmd, code, text = failed
        raise RuntimeError(f"nvcc failed with exit code {code}: {' '.join(cmd)}\n{text}")
    return "".join(out)


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
        and os.path.getmtime(LIB_PATH) >= max(
            os.path.getmtime(s) for s in sources + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
        )
    ):
        return ""
    out_dir = os.path.dirname(LIB_PATH)
    os.makedirs(out_dir, exist_ok=True)
    tag = os.getpid()  # concurrent builders write their own files
    objs, procs = [], []
    for src in sources:
        stem = os.path.splitext(os.path.basename(src))[0]
        obj = os.path.join(out_dir, f"{stem}.{tag}.o")
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
        objs.append(obj)
    report = _run(procs)
    tmp = f"{LIB_PATH}.{tag}.tmp"  # atomic replace
    cmd = [_nvcc(), *ARCH, "-shared", "-o", tmp, *objs]
    report += _run([(cmd, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    ))])
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, LIB_PATH)
    return report


# The parameters of each C entry of csrc/*.cu, in order: "p" a pointer
# (the last one is the stream), "i" an int, "f" a float. Every entry
# returns its cudaError_t as an int.
SIGNATURES = {
    "admm_diag_chunk": "p" * 17 + "i" * 10 + "ff" + "p",
    "admm_mixed_chunk": "p" * 18 + "i" * 12 + "ff" + "p",
    "admm_diag_stream_chunk": "p" * 19 + "i" * 11 + "ff" + "p",
    "admm_mixed_stream_chunk": "p" * 21 + "i" * 12 + "ff" + "p",
    "admm_perr_chunk": "p" * 17 + "i" * 12 + "ff" + "p",
    "admm_perr_stream_chunk": "p" * 19 + "i" * 13 + "ff" + "p",
    "admm_packed_chunk": "p" * 18 + "i" * 12 + "ff" + "p",
    "admm_packed_stream_chunk": "p" * 19 + "i" * 13 + "ff" + "p",
    "admm_perr_wide_chunk": "p" * 21 + "i" * 16 + "ff" + "p",
    "admm_packed_wide_chunk": "p" * 21 + "i" * 16 + "ff" + "p",
    "riccati_admm_chunk": "p" * 26 + "i" * 13 + "p",
    "riccati_rollout": "p" * 5 + "i" * 4 + "p",
    "riccati_certificate": "p" * 15 + "i" * 9 + "p",
    "riccati_chain_floor": "p" + "i" * 4 + "p",
    "riccati_wide_chunk": "p" * 28 + "i" * 17 + "p",
    "riccati_wide_seq_chunk": "p" * 28 + "i" * 15 + "p",
    "riccati_wide_rollout": "p" * 6 + "i" * 11 + "p",
    "riccati_wide_certificate": "p" * 16 + "i" * 14 + "p",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use, with every C signature set."""
    global _lib
    if _lib is not None:
        return _lib
    build_kernels()
    lib = ctypes.CDLL(LIB_PATH)
    for name, params in SIGNATURES.items():
        entry = getattr(lib, name)
        entry.restype = ctypes.c_int
        entry.argtypes = [_CTYPES[c] for c in params]
    _lib = lib
    return lib
