// What K1 (admm_diag.cu), K2 (admm_mixed.cu), K5 and K4 (admm_perr.cu) share:
// the layout of the operators and lane buffers in shared memory, and the
// fp64 matrix-vector product that reads them. Each kernel stages its operators itself: K2's
// loop in the form of K1's ran 2% slower (PERF.md, Findings, K1's
// redesign).
//
// - Operators: the R rho copies of K^-1 (and of K), rows at a stride ld
//   (row_stride), copies at a stride sk = (n ld) | 2, odd in 16-byte
//   units, so that the same entry of two copies never shares a bank group
//   and lanes at mixed rho indices do not serialize.
// - Lane buffers: L lanes, rows paired, row i of lane b at
//   ((i / 2) L + b) 2 + i % 2 (slot), so that a lane's rows j, j+1 are one
//   16-byte load and the L lanes of a warp read L neighbouring ones.
// ops/admm_fused.row_strides and the plans' shared-memory bytes mirror
// these formulas.

#pragma once

#include <cuda_runtime.h>

namespace mpc_admm {

constexpr size_t kSmemLimit = 232448;  // dynamic shared memory of a block

// jnp.clip / torch.clamp semantics: a NaN passes through, l = -inf clips
// nothing from below.
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

__device__ __forceinline__ double2 load2(const double* p) {
  return *reinterpret_cast<const double2*>(p);
}

// the double index of row i of lane b in an L-lane buffer of paired rows
__device__ __forceinline__ int slot(int i, int L, int b) {
  return (((i >> 1) * L + b) << 1) | (i & 1);
}

// out[k] = sum_j M[off[k] + j] v[j] over j < len, in index order: fp64 sums
// of exact fp32 products, rounded once. v is the lane's column of a paired
// buffer (rows j, j+1 at v + (j / 2) * pair_stride); both are read two
// entries at a time.
template <int RPT>
__device__ __forceinline__ void matvec(const double* __restrict__ M,
                                       const double* __restrict__ v,
                                       const int (&off)[RPT], int len,
                                       int pair_stride, float (&out)[RPT]) {
  double acc[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) acc[k] = 0.0;
  const int pairs = len >> 1;
#pragma unroll 2
  for (int p = 0; p < pairs; ++p) {
    const double2 vj = load2(v + p * pair_stride);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const double2 a = load2(M + off[k] + 2 * p);
      acc[k] = fma(a.x, vj.x, acc[k]);
      acc[k] = fma(a.y, vj.y, acc[k]);
    }
  }
  if (len & 1) {
    const double vj = v[pairs * pair_stride];
#pragma unroll
    for (int k = 0; k < RPT; ++k) acc[k] = fma(M[off[k] + len - 1], vj, acc[k]);
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) out[k] = static_cast<float>(acc[k]);
}

// The row stride (in doubles) of an operator read two entries at a time by
// blocks of `lanes` lanes: even, and such that the 32 / lanes consecutive
// rows a warp reads start in distinct 16-byte bank groups (the stride in
// 16-byte units an odd multiple of lanes / 4).
inline int row_stride(int n, int lanes) {
  int ld = n + (n & 1);
  if (lanes >= 32) return ld;
  const int unit = lanes / 4;
  while ((ld / 2) % unit != 0 || ((ld / 2) / unit) % 2 == 0) ld += 2;
  return ld;
}

// the stride (in doubles) of the rho copies of an (n, n) operator
inline int copy_stride(int n, int ld) { return (n * ld) | 2; }

}  // namespace mpc_admm
