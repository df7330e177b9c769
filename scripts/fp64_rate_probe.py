"""The card's fp64 multiply-add rate on its CUDA cores, alone and fed from
shared memory as the stream route of K1 and K2 feeds it, on one GPU.

    python3 scripts/fp64_rate_probe.py [--chain]

Builds a small CUDA source (written to build/fp64_probe/, the flags of
``ops/_build.py``) and times, with CUDA events over one launch of 132 x
(SMs) blocks after a warm-up, each of:

- ``regs``: every thread runs 16 independent fp64 sums, 32 DFMA a round
  from registers (4 rows x 4 lanes x 2 columns, the stream route's
  register tile at 4 lanes a thread);
- ``smem``: the same sums, each round's 2 columns of 4 operator rows and 4
  lanes' vectors loaded from shared memory as 16-byte loads at the stream
  route's addresses (8 ``LDS.128`` a round, rows at an odd 16-byte stride,
  lanes g + c LG);
- ``smem-rows8``: 8 rows x 4 lanes a thread (12 loads for 64 DFMA);
- ``ffma``: the ``regs`` round in fp32, for scale;

at 128, 256 and 512 threads a block, one block an SM. Prints one JSON line
a case: multiply-adds a clock and SM (at the card's highest SM clock,
nvidia-smi clocks.max.sm) and TFLOP/s. Then the ``chain`` case: one warp
whose threads each run 2^20 dependent fp64 multiply-adds (acc = fma(acc, a,
b)), timed by the SM's clock64 around the loop: the clocks and
nanoseconds (at the highest SM clock) of one dependent multiply-add, the
latency that sets a recurrence's chain floor (N x nx of them for the
Riccati drivers' rollout and adjoint). ``--chain`` runs that case alone;
``chain_latency()`` returns it to a caller on the card. Exits non-zero
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

template <typename T, bool SMEM, int RT>
__global__ void probe(T* out, const T* in, int rounds, int LG) {
  extern __shared__ __align__(16) double sm[];
  const int g0 = threadIdx.x % LG, t = threadIdx.x / LG, G = blockDim.x / LG;
  T acc[RT][4], a0[RT], a1[RT], v0[4], v1[4];
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    a0[k] = in[k];
    a1[k] = in[k + 8];
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[k][c] = in[16 + c] * T(threadIdx.x);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v0[c] = in[20 + c];
    v1[c] = in[24 + c];
  }
  const int sp = 2 * 51;  // an odd stride in 16-byte units
  if (SMEM)
    for (int i = threadIdx.x; i < 12288; i += blockDim.x) sm[i] = 1e-3 * (i % 7);
  __syncthreads();
  for (int j = 0; j < rounds; ++j) {
    if (SMEM) {
      const int col = 2 * (j & 31);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const double2 v = *reinterpret_cast<const double2*>(
            sm + 8192 + (j & 31) * 2 * 4 * LG + 2 * (g0 + c * LG));
        v0[c] = v.x;
        v1[c] = v.y;
      }
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        const double2 a = *reinterpret_cast<const double2*>(sm + ((t + k * G) % 80) * sp + col);
        a0[k] = a.x;
        a1[k] = a.y;
      }
    }
#pragma unroll
    for (int k = 0; k < RT; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[k][c] = fma(a0[k], v0[c], acc[k][c]);
        acc[k][c] = fma(a1[k], v1[c], acc[k][c]);
      }
    }
  }
  T s = 0;
#pragma unroll
  for (int k = 0; k < RT; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) s += acc[k][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void chain(double* out, long long* clocks, const double* in, int rounds) {
  double acc = in[threadIdx.x & 7];
  const double a = in[8], b = in[9];
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 16
  for (int j = 0; j < rounds; ++j) acc = fma(acc, a, b);
  const long long t1 = clock64();
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) clocks[0] = t1 - t0;
}

extern "C" int chain_launch(void* out, void* clocks, const void* in, int rounds) {
  chain<<<1, 32>>>((double*)out, (long long*)clocks, (const double*)in, rounds);
  return (int)cudaGetLastError();
}

extern "C" int launch(int which, void* out, const void* in, int blocks, int threads, int rounds) {
  const int LG = 8;
  const size_t smem = 12288 * 8;
  switch (which) {
    case 0: probe<double, false, 4><<<blocks, threads>>>((double*)out, (const double*)in, rounds, LG); break;
    case 1:
      cudaFuncSetAttribute(probe<double, true, 4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      probe<double, true, 4><<<blocks, threads, smem>>>((double*)out, (const double*)in, rounds, LG); break;
    case 2:
      cudaFuncSetAttribute(probe<double, true, 8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      probe<double, true, 8><<<blocks, threads, smem>>>((double*)out, (const double*)in, rounds, LG); break;
    case 3: probe<float, false, 4><<<blocks, threads>>>((float*)out, (const float*)in, rounds, LG); break;
  }
  return (int)cudaGetLastError();
}
"""

CASES = (("regs", 0, 4, "float64"), ("smem", 1, 4, "float64"), ("smem-rows8", 2, 8, "float64"),
         ("ffma", 3, 4, "float32"))


def _build_probe():
    """The probe's library, built with the port's nvcc flags into
    build/fp64_probe/, its entries' signatures set."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "fp64_probe")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = os.path.join(out_dir, "probe.cu"), os.path.join(out_dir, "libprobe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib_path, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    lib.launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
    lib.chain_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    return lib


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def chain_latency(lib=None, rounds=1 << 20):
    """{"clocks": SM clocks of one dependent fp64 multiply-add, "ns": the
    same at the card's highest SM clock, "card": name, power limit and
    that clock}: one warp's chain of ``rounds`` multiply-adds (after one
    warm-up run), timed by clock64 in the kernel."""
    import torch

    lib = lib or _build_probe()
    smi = _smi()
    clock = float(smi.split(",")[-1]) * 1e6
    out = torch.empty(32, dtype=torch.float64, device="cuda")
    ticks = torch.zeros(1, dtype=torch.int64, device="cuda")
    inp = torch.linspace(0.5, 1.0, 10, dtype=torch.float64, device="cuda")
    inp[8], inp[9] = 0.5, 0.25  # a contraction: the values stay bounded
    for _ in range(2):
        if lib.chain_launch(out.data_ptr(), ticks.data_ptr(), inp.data_ptr(), rounds):
            raise RuntimeError("the chain probe did not launch")
        torch.cuda.synchronize()
    clocks = int(ticks.item()) / rounds
    return dict(clocks=clocks, ns=clocks / clock * 1e9, card=smi)


def main():
    import torch

    if not torch.cuda.is_available():
        print("fp64_rate_probe.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    lib = _build_probe()
    if "--chain" in sys.argv[1:]:
        print(json.dumps(dict(case="chain", **chain_latency(lib))), flush=True)
        return 0
    smi = _smi()
    clock = float(smi.split(",")[-1]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rounds = 20000
    for name, which, rows, dtype in CASES:
        for threads in (128, 256, 512):
            dt = getattr(torch, dtype)
            out = torch.empty(sms * threads, dtype=dt, device="cuda")
            inp = torch.linspace(0.5, 1.5, 32, dtype=dt, device="cuda")
            run = lambda: lib.launch(which, out.data_ptr(), inp.data_ptr(), sms, threads, rounds)
            err = run()
            torch.cuda.synchronize()
            if err:  # too many registers for the block, say
                print(json.dumps(dict(case=name, threads=threads, cuda_error=err)), flush=True)
                continue
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            assert run() == 0
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            fmas = sms * threads * rounds * rows * 4 * 2
            print(json.dumps(dict(case=name, threads=threads, ms=ms,
                                  fma_per_clock_sm=fmas / (ms * 1e-3) / clock / sms,
                                  tflops=2 * fmas / (ms * 1e-3) / 1e12, card=smi)), flush=True)
    print(json.dumps(dict(case="chain", **chain_latency(lib))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
