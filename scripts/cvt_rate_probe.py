"""The card's fp32 <-> fp64 conversion rate against its fp64 multiply-add
rate, and the exact integer widening K3W-doubling uses, on one GPU.

    python3 scripts/cvt_rate_probe.py

Builds a small CUDA source (written to build/cvt_probe/, the flags of
``ops/_build.py``) and times, with CUDA events over one launch of 132 x
(SMs) blocks of 512 threads after a warm-up, rounds of 8 independent chains
a thread, each round of a chain one of:

- ``f2d``: an fp32 add, its widening to fp64 (``F2F.F64.F32``), an fp64 add;
- ``d2f``: an fp64 add, its rounding to fp32 (``F2F.F32.F64``), an fp32 add;
- ``widen``: an fp32 add, the integer widening of csrc/riccati_wide.cu
  (``widen_lo``: the float's bits moved into a double's, the value x 2^-896,
  exact), an fp64 add;
- ``dfma``: one fp64 multiply-add, for scale.

Prints one JSON line a case: operations of the case's kind a clock and SM,
at the card's highest SM clock (nvidia-smi clocks.max.sm). Exits non-zero
without a card.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

SOURCE = r"""
#include <cuda_runtime.h>

__device__ __forceinline__ double widen_lo(float x) {
  const unsigned b = __float_as_uint(x);
  unsigned hi = (b & 0x80000000u) | ((b & 0x7fffffffu) >> 3);
  if ((b & 0x7f800000u) == 0x7f800000u) hi |= 0x70000000u;
  return __hiloint2double(static_cast<int>(hi), static_cast<int>(b << 29));
}

template <int MODE>
__global__ void probe(double* out, int rounds) {
  float x[8];
  double d[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = 1e-3f * (threadIdx.x + i), d[i] = 1e-3 * (threadIdx.x - i);
  for (int j = 0; j < rounds; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (MODE == 0) {
        x[i] = x[i] + 1.5f;
        d[i] = d[i] + static_cast<double>(x[i]);
      } else if (MODE == 1) {
        d[i] = d[i] + 1.5;
        x[i] = x[i] + static_cast<float>(d[i]);
      } else if (MODE == 2) {
        x[i] = x[i] + 1.5f;
        d[i] = d[i] + widen_lo(x[i]);
      } else {
        d[i] = fma(d[i], 0.999, 1e-3);
      }
    }
  }
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += d[i] + x[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int cvt_probe(int mode, double* out, int blocks, int threads, int rounds) {
  switch (mode) {
    case 0: probe<0><<<blocks, threads>>>(out, rounds); break;
    case 1: probe<1><<<blocks, threads>>>(out, rounds); break;
    case 2: probe<2><<<blocks, threads>>>(out, rounds); break;
    default: probe<3><<<blocks, threads>>>(out, rounds); break;
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def main():
    import torch

    if not torch.cuda.is_available():
        print("cvt_rate_probe.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "cvt_probe")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = os.path.join(out_dir, "cvt_probe.cu"), os.path.join(out_dir, "libcvt.so")
    open(src, "w").write(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib_path, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    lib.cvt_probe.restype = ctypes.c_int
    lib.cvt_probe.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True).stdout.strip().split(", ")
    clock = float(smi[2]) * 1e6
    blocks, threads, rounds = 132, 512, 4096
    out = torch.empty(blocks * threads, dtype=torch.float64, device="cuda")
    for mode, name in enumerate(("f2d", "d2f", "widen", "dfma")):
        launch = lambda: lib.cvt_probe(mode, out.data_ptr(), blocks, threads, rounds)
        if launch() != 0:
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        ops = blocks * threads * rounds * 8
        print(json.dumps(dict(case=name, card=smi[0], power_limit=smi[1], ms=ms,
                              per_clock_per_sm=ops / (ms * 1e-3 * clock) / blocks)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
