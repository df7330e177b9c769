// K5 and K4 on Hopper: `chunk` ADMM iterations of a batch of QPs whose
// scaled constraint matrix A (m, n) is dense (rows not box-first), per rho
// (K5) or lane-packed (K4).
//
// K5 replaces ops/admm_pallas.py::_iterate_kernel_perr of the JAX package,
// K4 its _iterate_kernel (both driven by _iterate_chunk, which picks one by
// _use_packed, ported as admm_fused.use_packed; the two round differently).
// Per lane b and iteration, r the lane's rho-grid index:
//
//   rhs = sigma x - q - A'y + sum_i s_i fl(rho_r,i A_i.)
//   xt  = rhs K_r^-1                       (row vector times matrix)
//   K5: refine_steps times: xt += (rhs - xt K_r) K_r^-1
//       st  = A xt
//   K4: st  = rhs kia_r,  kia_r = K_r^-1 A'  (the packed image, built once)
//       refine_steps times: res = rhs - xt K_r;  xt += res K_r^-1;
//                           st += res kia_r
//   x = alpha xt + (1-alpha) x;  v = alpha st + (1-alpha) s
//   s = clip(v + rho^-1 y, l, u);  y += rho (v - s);  ax = alpha st + (1-alpha) ax
//
// One source, two kernels (the shared and the stream route), each
// instantiated for K5 and, with the compile-time flag PACKED, for K4: the
// flag swaps the A xt pass for the image rhs kia_r, which the refinement
// corrects with res kia_r; nothing else differs.
//
// fl(rho a) is one fp32 product, as the JAX body's atrho. Two routes, one
// entry each per kernel; ops/admm_fused.k5_plan and k4_plan pick one from
// the shape before the launch: the shared route (admm_perr_chunk,
// admm_packed_chunk, below) where every rho's fp64 operators fit one
// block's shared memory beside the lane buffers (the h20 state box on K5;
// the h20 equality terminal, its tier 2 and the state box at tier 1's grid
// on K4), else the stream route (admm_perr_stream_chunk,
// admm_packed_stream_chunk, further below), which takes every shape with
// n <= 128 and m <= 512 (the h50 state box on K5; the h20 neighborhood
// terminal on K4).
//
// The shared route. What bounds it on this card: not the fp64 multiply-adds (3 m n +
// (1 + 2 refine) n^2 per lane and iteration: 19,200 at the h20 state box)
// but the shared-memory loads that feed them, one operator entry per
// multiply-add and the lane vectors once per thread, as in K1 and K2
// (admm_diag.cu, admm_mixed.cu; PERF.md, Findings: their redesigns). So,
// as in K2:
// - The operators are fp64 in shared memory, widened once per launch: an
//   fp32 -> fp64 conversion runs at a quarter of the fp64 FMA rate, and
//   widening at use would cost one per multiply-add. K^-1 and K are staged
//   transposed, so that the lane's row-vector products read rows, two
//   entries at a time; the R copies at a stride odd in 16-byte units, rows
//   at a stride chosen for the lanes per block (admm_common.cuh).
// - fl(rho_r,i a_ij) needs the lane's rho: A is also kept in fp32 beside
//   its fp64 copy, with the (R, m) rho table, and each entry of the
//   A'rho.s pass costs one fp32 multiply and one widening: a quarter of
//   the conversions of widening at use. Blocks of lanes grouped by rho
//   index, each staging its rho's fl(rho_r A) in fp64, ran as fast at this
//   route's shapes (k3_ab.py --kernel K5; PERF.md, Findings: K5's
//   redesign) and cost the host an ordering per launch; the stream route
//   below groups its lanes.
// - A block covers L lanes x G row-groups from the wrapper's plan
//   (ops/admm_fused.k5_plan): L so that the blocks fill the 132 SMs, G as
//   few as latency allows. Thread (b, t) owns variable rows t + k G
//   (RPT_N of them) and constraint rows t + k G (RPT_M) of lane b and keeps
//   x, q and s, y, ax, rho, rho^-1 of them in registers for the chunk; l
//   and u are read at each use (coalesced, L1-resident).
// - No predicates and no 64-bit index arithmetic in the iteration loop:
//   rows past n or m (padding) and lanes past B compute on clamped copies
//   of real data into buffer slots of their own, and store nothing.
// - Operator rows and the lane vectors are read 16 bytes at a time.
// - Instantiations with and without refinement, each held to a register
//   budget by __launch_bounds__, as K1's.
// - K4 (PACKED) keeps no fp64 A: kia_r (R copies, transposed, rows at ld,
//   copies at (m ld) | 2) takes its room (at the h20 equality terminal,
//   n = 40, m = 44, R = 5, one refinement, K^-1, K and kia fill 199 KB of
//   a 16-lane block's 226 KB), so A'y reads the fp32 A and widens it: two
//   conversions per entry and lane, each costing about what reading 8
//   bytes does, a fifth of K4's time there (k3_ab.py --kernel K4; PERF.md,
//   Findings: K4's redesign). One product over rhs, and one over each
//   refinement residual, gives xt from K^-1 and the image st from kia,
//   reading the vector once; st stays in registers through the
//   refinement, and no barrier or A xt pass follows it.
//
// Precision, as in K1 and K2: the state is fp32; at "highest"
// every matrix-vector product is accumulated in fp64 from exact fp32
// products, in index order, and rounded once to fp32; the plain version
// (admm_fused.iterate_chunk_dense_perr_T_plain, and _packed_T_plain for
// K4) sums in the same order, so the two agree bit for bit. At "bf16x3"
// and "default" (the template parameter MODE, admm_common.cuh) each
// product is that precision's passes over the same 8-byte slots: the
// operators staged (shared route) or handed over (stream route) as bf16
// pairs, fl(rho a) and, on K4's shared route, A split at use, the lane
// vectors split when written to the lane buffers; the stream route then
// keeps s and y in registers, since a buffer's pair no longer holds them
// exactly. Built with --fmad=false so the elementwise updates round like
// PyTorch's.
//
// Shared memory, fp64 first: K^-1 (and K when refining) transposed, R
// copies at stride sk, rows at ld; A, m rows at ld (K4: kia transposed, R
// copies of m rows at ld); four lane buffers of
// paired rows (admm_common.cuh): the variable rows' rhs (then the
// refinement residual) and xt, the constraint rows' y and s. Then fp32:
// the rho table (R rows at mr) and A (m rows at n).
//
// The state is out of place. Every thread reaches every barrier; the only
// early return (lanes past B) comes after the last one.
//
// Bound to PyTorch by ctypes through the plain C functions admm_perr_chunk,
// admm_perr_stream_chunk (K5), admm_packed_chunk and
// admm_packed_stream_chunk (K4), which return cudaGetLastError() after the
// launch (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "admm_common.cuh"

namespace {

using mpc_admm::clip;
using mpc_admm::copy16;
using mpc_admm::matvec;
using mpc_admm::panel_stride;
using mpc_admm::Prec;
using mpc_admm::slot;
using mpc_admm::StreamLayout;

struct Layout {
  int ld, sk, nslots, mslots, mr;  // strides and buffer rows
};

// The stride (in floats) of the rows of the rho table: even, so that a
// lane's rho_i, rho_i+1 are one 8-byte load, and odd in 8-byte units, so
// that lanes of distinct rho indices read distinct banks.
inline int rho_stride(int m) {
  int mr = m + (m & 1);
  if ((mr / 2) % 2 == 0) mr += 2;
  return mr;
}

template <int RPT_N, int RPT_M, bool REFINE, int THREADS, int REGS, bool PACKED, int MODE>
__global__ void __launch_bounds__(THREADS, 65536 / (THREADS * REGS))
admm_perr_chunk_kernel(const float* __restrict__ kinv,
                       const float* __restrict__ kmat,
                       const float* __restrict__ kia,  // K4: (R, n, m); K5: unused
                       const float* __restrict__ a,
                       const float* __restrict__ rho_vecs,
                       const float* __restrict__ rho_invs,
                       const float* __restrict__ q,
                       const float* __restrict__ l,
                       const float* __restrict__ u,
                       const int* __restrict__ idx,
                       const float* __restrict__ x_in,
                       const float* __restrict__ s_in,
                       const float* __restrict__ y_in,
                       const float* __restrict__ ax_in,
                       float* __restrict__ x_out, float* __restrict__ s_out,
                       float* __restrict__ y_out, float* __restrict__ ax_out,
                       int n, int m, int B, int R, int chunk,
                       int refine_steps, float sigma, float alpha,
                       Layout lay) {
  using P = Prec<MODE>;
  extern __shared__ __align__(16) double smem[];
  const int L = blockDim.x;
  const int G = blockDim.y;
  const int b = threadIdx.x;
  const int t = threadIdx.y;
  const int tid = t * L + b;
  const int nthreads = L * G;

  // the lane this thread works for (lc: clamped to a real one) and its rho
  const int lane = blockIdx.x * L + b;
  const bool live = lane < B;
  const int lc = live ? lane : B - 1;  // lanes past B run on lane B-1's data
  const int r = idx[lc];

  const int ld = lay.ld, sk = lay.sk;
  const int skm = (m * ld) | 2;                  // K4: the stride of the kia copies
  double* ki_sh = smem;                          // K^-1 transposed
  double* k_sh = ki_sh + R * sk;                 // K transposed
  double* a_sh = k_sh + (REFINE ? R * sk : 0);   // A (K4: kia transposed)
  double* bn0 = a_sh + (PACKED ? R * skm : m * ld);  // rhs, then the residual
  double* bn1 = bn0 + lay.nslots * L;            // xt
  double* bm0 = bn1 + lay.nslots * L;                 // y
  double* bm1 = bm0 + lay.mslots * L;                 // s
  float* rho_sh = reinterpret_cast<float*>(bm1 + lay.mslots * L);  // (R, mr)
  float* a32_sh = rho_sh + R * lay.mr;           // A in fp32, rows at n

  // the operators, widened once: K^-1[r][row][col] to row col, column row
  const int nn = n * n;
  for (int i = tid; i < R * nn; i += nthreads) {
    const int rr = i / nn;
    const int e = i - rr * nn;
    const int row = e / n;
    const int dst = rr * sk + (e - row * n) * ld + row;
    P::store(ki_sh + dst, P::entry(kinv[i]));
    if (REFINE) P::store(k_sh + dst, P::entry(kmat[i]));
  }
  if constexpr (PACKED) {
    // kia[r][j][i] to row i, column j of copy r: st_i sums over j
    const int nm = n * m;
    for (int i = tid; i < R * nm; i += nthreads) {
      const int rr = i / nm;
      const int e = i - rr * nm;
      const int row = e / m;
      P::store(a_sh + rr * skm + (e - row * m) * ld + row, P::entry(kia[i]));
    }
    for (int i = tid; i < m * n; i += nthreads) a32_sh[i] = a[i];
  } else {
    for (int i = tid; i < m * n; i += nthreads) {
      const int row = i / n;
      const float av = a[i];
      P::store(a_sh + row * ld + (i - row * n), P::entry(av));
      a32_sh[i] = av;
    }
  }
  for (int i = tid; i < R * m; i += nthreads) {
    const int rr = i / m;
    rho_sh[rr * lay.mr + (i - rr * m)] = rho_vecs[i];
  }

  const float* rho_r = rho_vecs + r * m;
  const float* rhoi_r = rho_invs + r * m;
  const int kr = r * sk;  // the lane's copy of K^-1 and K

  // variable rows j = t + k G (k < RPT_N), constraint rows i = t + k G
  // (k < RPT_M); a padded row reads the last real row and owns a buffer
  // slot past the real ones
  float x[RPT_N], qv[RPT_N];
  int koff[RPT_N], col[RPT_N];
#pragma unroll
  for (int k = 0; k < RPT_N; ++k) {
    const int j = t + k * G;
    const int jc = j < n ? j : n - 1;
    koff[k] = kr + jc * ld;
    col[k] = jc;
    x[k] = x_in[jc * B + lc];
    qv[k] = q[jc * B + lc];
  }
  float s[RPT_M], y[RPT_M], ax[RPT_M], rho[RPT_M], rhoi[RPT_M];
#pragma unroll
  for (int k = 0; k < RPT_M; ++k) {
    const int i = t + k * G;
    const int ic = i < m ? i : m - 1;
    const int g = ic * B + lc;
    s[k] = s_in[g];
    y[k] = y_in[g];
    ax[k] = ax_in[g];
    rho[k] = rho_r[ic];
    rhoi[k] = rhoi_r[ic];
  }
  // K4: the lane's rows of K^-1 and then of kia, from smem: one product
  // with rhs (or the residual) gives xt and st, reading the vector once
  int woff[RPT_N + RPT_M];
  if constexpr (PACKED) {
#pragma unroll
    for (int k = 0; k < RPT_N; ++k) woff[k] = koff[k];  // ki_sh is smem
#pragma unroll
    for (int k = 0; k < RPT_M; ++k) {
      const int i = t + k * G;
      woff[RPT_N + k] = static_cast<int>(a_sh - smem) + r * skm + (i < m ? i : m - 1) * ld;
    }
  }
  __syncthreads();

  const float beta = 1.0f - alpha;
  const int ps = 2 * L;  // doubles between a lane's row pairs
  const double* bn0_b = bn0 + 2 * b;
  const double* bn1_b = bn1 + 2 * b;
  const double* bm0_b = bm0 + 2 * b;
  const double* bm1_b = bm1 + 2 * b;
  const float* rho_b = rho_sh + r * lay.mr;
  const int pairs = m >> 1;
  for (int it = 0; it < chunk; ++it) {
#pragma unroll
    for (int k = 0; k < RPT_M; ++k) {
      const int sl = slot(t + k * G, L, b);
      P::store(bm0 + sl, P::entry(y[k]));
      P::store(bm1 + sl, P::entry(s[k]));
    }
    __syncthreads();
    // A'y and sum_i s_i fl(rho_i A_i.) in one pass over the constraint rows
    float rhs[RPT_N];
    {
      typename P::Acc acc_y[RPT_N], acc_s[RPT_N];
#pragma unroll
      for (int k = 0; k < RPT_N; ++k) {
        P::zero(acc_y[k]);
        P::zero(acc_s[k]);
      }
#pragma unroll 2
      for (int p = 0; p < pairs; ++p) {
        typename P::Entry vy0, vy1, vs0, vs1;
        P::load2(bm0_b + p * ps, vy0, vy1);
        P::load2(bm1_b + p * ps, vs0, vs1);
        const double* a0 = a_sh + 2 * p * ld;  // rows 2p and 2p + 1
        const float2 rp = *reinterpret_cast<const float2*>(rho_b + 2 * p);
        const float* f0 = a32_sh + 2 * p * n;
#pragma unroll
        for (int k = 0; k < RPT_N; ++k) {
          if constexpr (PACKED) {  // A'y from the fp32 A, widened (split)
            const float w0 = f0[col[k]], w1 = f0[n + col[k]];
            P::mac(acc_y[k], P::entry(w0), vy0);
            P::mac(acc_s[k], P::entry(rp.x * w0), vs0);
            P::mac(acc_y[k], P::entry(w1), vy1);
            P::mac(acc_s[k], P::entry(rp.y * w1), vs1);
          } else {
            P::mac(acc_y[k], P::load(a0 + col[k]), vy0);
            P::mac(acc_s[k], P::entry(rp.x * f0[col[k]]), vs0);
            P::mac(acc_y[k], P::load(a0 + ld + col[k]), vy1);
            P::mac(acc_s[k], P::entry(rp.y * f0[n + col[k]]), vs1);
          }
        }
      }
      if (m & 1) {
        const typename P::Entry vy = P::load(bm0_b + pairs * ps);
        const typename P::Entry vs = P::load(bm1_b + pairs * ps);
        const double* a0 = a_sh + (m - 1) * ld;
#pragma unroll
        for (int k = 0; k < RPT_N; ++k) {
          if constexpr (PACKED)
            P::mac(acc_y[k], P::entry(a32_sh[(m - 1) * n + col[k]]), vy);
          else
            P::mac(acc_y[k], P::load(a0 + col[k]), vy);
          const float w = rho_b[m - 1] * a32_sh[(m - 1) * n + col[k]];
          P::mac(acc_s[k], P::entry(w), vs);
        }
      }
#pragma unroll
      for (int k = 0; k < RPT_N; ++k) {
        rhs[k] = sigma * x[k] - qv[k] - P::result(acc_y[k]) + P::result(acc_s[k]);
        P::store(bn0 + slot(t + k * G, L, b), P::entry(rhs[k]));
      }
    }
    __syncthreads();
    float xt[RPT_N];
    float st[RPT_M];
    if constexpr (PACKED) {
      float w[RPT_N + RPT_M];
      matvec<MODE, RPT_N + RPT_M>(smem, bn0_b, woff, n, ps, w);  // rhs [K_r^-1 | kia_r]
#pragma unroll
      for (int k = 0; k < RPT_N; ++k) xt[k] = w[k];
#pragma unroll
      for (int k = 0; k < RPT_M; ++k) st[k] = w[RPT_N + k];
    } else {
      matvec<MODE, RPT_N>(ki_sh, bn0_b, koff, n, ps, xt);
    }
    for (int step = 0; REFINE && step < refine_steps; ++step) {
      float tmp[RPT_N];
#pragma unroll
      for (int k = 0; k < RPT_N; ++k) P::store(bn1 + slot(t + k * G, L, b), P::entry(xt[k]));
      __syncthreads();  // also: every thread is done reading bn0
      matvec<MODE, RPT_N>(k_sh, bn1_b, koff, n, ps, tmp);
#pragma unroll
      for (int k = 0; k < RPT_N; ++k)
        P::store(bn0 + slot(t + k * G, L, b), P::entry(rhs[k] - tmp[k]));
      __syncthreads();  // also: every thread is done reading bn1
      if constexpr (PACKED) {
        float w[RPT_N + RPT_M];
        matvec<MODE, RPT_N + RPT_M>(smem, bn0_b, woff, n, ps, w);  // res [K_r^-1 | kia_r]
#pragma unroll
        for (int k = 0; k < RPT_N; ++k) xt[k] += w[k];
#pragma unroll
        for (int k = 0; k < RPT_M; ++k) st[k] += w[RPT_N + k];
      } else {
        matvec<MODE, RPT_N>(ki_sh, bn0_b, koff, n, ps, tmp);
#pragma unroll
        for (int k = 0; k < RPT_N; ++k) xt[k] += tmp[k];
      }
    }
    if constexpr (PACKED) {
      // the next iteration writes bm0 and bm1 before its first barrier: no
      // thread reads them after this iteration's second one
#pragma unroll
      for (int k = 0; k < RPT_N; ++k) x[k] = alpha * xt[k] + beta * x[k];
    } else {
#pragma unroll
      for (int k = 0; k < RPT_N; ++k) {
        P::store(bn1 + slot(t + k * G, L, b), P::entry(xt[k]));
        x[k] = alpha * xt[k] + beta * x[k];
      }
      __syncthreads();  // also: every thread is done reading bn0, bm0, bm1
      int aoff[RPT_M];
#pragma unroll
      for (int k = 0; k < RPT_M; ++k) {
        const int i = t + k * G;
        aoff[k] = (i < m ? i : m - 1) * ld;
      }
      matvec<MODE, RPT_M>(a_sh, bn1_b, aoff, n, ps, st);  // A xt
    }
#pragma unroll
    for (int k = 0; k < RPT_M; ++k) {
      const int i = t + k * G;
      const int g = (i < m ? i : m - 1) * B + lc;
      const float v = alpha * st[k] + beta * s[k];
      const float s_new = clip(v + rhoi[k] * y[k], l[g], u[g]);
      y[k] = y[k] + rho[k] * (v - s_new);
      ax[k] = alpha * st[k] + beta * ax[k];
      s[k] = s_new;
    }
  }

  if (!live) return;  // after the last barrier
#pragma unroll
  for (int k = 0; k < RPT_N; ++k) {
    const int j = t + k * G;
    if (j < n) x_out[j * B + lc] = x[k];
  }
#pragma unroll
  for (int k = 0; k < RPT_M; ++k) {
    const int i = t + k * G;
    if (i >= m) continue;
    const int g = i * B + lc;
    s_out[g] = s[k];
    y_out[g] = y[k];
    ax_out[g] = ax[k];
  }
}

struct Args {
  const float *kinv, *kmat, *kia, *a, *rho_vecs, *rho_invs, *q, *l, *u;
  const int* idx;
  const float *x_in, *s_in, *y_in, *ax_in;
  float *x_out, *s_out, *y_out, *ax_out;
  int n, m, B, R, chunk, refine_steps;
  float sigma, alpha;
};

template <int RPT_N, int RPT_M, bool REFINE, int THREADS, int REGS, bool PACKED, int MODE>
cudaError_t launch(const Args& a, dim3 block, const Layout& lay, size_t smem,
                   cudaStream_t stream) {
  if (static_cast<int>(block.x * block.y) > THREADS) return cudaErrorInvalidValue;
  auto kernel = admm_perr_chunk_kernel<RPT_N, RPT_M, REFINE, THREADS, REGS, PACKED, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + block.x - 1) / block.x);
  kernel<<<grid, block, smem, stream>>>(
      a.kinv, a.kmat, a.kia, a.a, a.rho_vecs, a.rho_invs, a.q, a.l, a.u, a.idx,
      a.x_in, a.s_in, a.y_in, a.ax_in, a.x_out, a.s_out, a.y_out, a.ax_out,
      a.n, a.m, a.B, a.R, a.chunk, a.refine_steps, a.sigma, a.alpha, lay);
  return cudaGetLastError();
}

// the instantiated rows per thread (variable rows, constraint rows), each
// with the most threads its block may have and the registers a thread is
// held to without and with refinement (ptxas rounds the threads up to a
// multiple of 128 when it sets the limit); ops/admm_fused.K5_INSTANCES
// plans only these. Only (2, 6) with refinement spills (16 bytes)
#define MPC_K5_INSTANCES(X)                                               \
  X(1, 3, 512, 128, 128) X(2, 5, 384, 168, 168) X(2, 6, 320, 168, 168)    \
  X(3, 8, 256, 255, 255) X(3, 9, 256, 255, 255)
// K4's, as ops/admm_fused.K4_INSTANCES: the h20 equality terminal (m = 44)
// at 14, 20 or 40 row-groups, the state box (m = 120) at 20 or 40. (2, 6)
// spills 20 and 32 bytes; (3, 9), (4, 5) and (4, 12) ran slower (PERF.md,
// Findings: K4's redesign)
#define MPC_K4_INSTANCES(X)                                               \
  X(1, 2, 512, 128, 128) X(1, 3, 512, 128, 128) X(2, 3, 384, 168, 168)    \
  X(2, 6, 320, 168, 168) X(3, 4, 256, 255, 255)

// the shared route's instantiation of rows per thread (rpt_n, rpt_m) for
// K5 (PACKED false) or K4 at precision MODE
template <bool PACKED, int MODE>
int shared_dispatch(const Args& args, dim3 block, const Layout& lay, size_t smem,
                    cudaStream_t st, int rpt_n, int rpt_m) {
  const bool refine = args.refine_steps > 0;
#define MPC_DENSE_CASE(N, M, T, REGS, REGS_REFINE)                                     \
  case 64 * N + M:                                                                      \
    return static_cast<int>(                                                            \
        refine ? launch<N, M, true, T, REGS_REFINE, PACKED, MODE>(args, block, lay, smem, \
                                                                  st)                   \
               : launch<N, M, false, T, REGS, PACKED, MODE>(args, block, lay, smem, st));
  if constexpr (PACKED) {
    switch (64 * rpt_n + rpt_m) {
      MPC_K4_INSTANCES(MPC_DENSE_CASE)
    }
  } else {
    switch (64 * rpt_n + rpt_m) {
      MPC_K5_INSTANCES(MPC_DENSE_CASE)
    }
  }
#undef MPC_DENSE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The shared route's entry for K5 (PACKED false) or K4: checks the shape
// and the plan's layout, then launches the instantiation of its rows per
// thread at precision `mode`.
template <bool PACKED>
int shared_chunk(const Args& args, int mode, int lanes, int groups, int rpt_n, int rpt_m,
                 int smem_bytes, void* stream) {
  const int n = args.n, m = args.m, B = args.B, R = args.R;
  if (n <= 0 || n > 128 || m < 1 || m > 512 || B <= 0 || R <= 0 ||
      args.chunk < 0 || args.refine_steps < 0 ||
      static_cast<long long>(m) * B > INT_MAX ||
      (lanes != 4 && lanes != 8 && lanes != 16 && lanes != 32) ||
      groups <= 0 || lanes * groups > 512 || rpt_n * groups < n ||
      rpt_m * groups < m)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout lay;
  lay.ld = mpc_admm::row_stride(n, lanes);
  lay.sk = mpc_admm::copy_stride(n, lay.ld);
  lay.nslots = (groups * rpt_n + 1) & ~1;
  lay.mslots = (groups * rpt_m + 1) & ~1;
  lay.mr = rho_stride(m);
  const long long stacks = args.refine_steps > 0 ? 2 : 1;
  // the bytes of the layout above (ops/admm_fused.k5_smem_bytes and
  // k4_smem_bytes mirror these four lines, which tests/test_torch_build.py
  // reads): K5 keeps A in fp64, K4 kia_r
  const long long image = PACKED ? 1LL * R * ((m * lay.ld) | 2) : 1LL * m * lay.ld;
  const long long doubles = 2LL * (lay.nslots + lay.mslots) * lanes + stacks * R * lay.sk + image;
  const long long floats = 1LL * R * lay.mr + 1LL * m * n;
  const long long need = 8 * doubles + 4 * floats;
  if (need != smem_bytes || need > static_cast<long long>(mpc_admm::kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(need);
  const dim3 block(lanes, groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case mpc_admm::kHighest:
      return shared_dispatch<PACKED, mpc_admm::kHighest>(args, block, lay, smem, st, rpt_n, rpt_m);
    case mpc_admm::kBf16x3:
      return shared_dispatch<PACKED, mpc_admm::kBf16x3>(args, block, lay, smem, st, rpt_n, rpt_m);
    case mpc_admm::kDefault:
      return shared_dispatch<PACKED, mpc_admm::kDefault>(args, block, lay, smem, st, rpt_n, rpt_m);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------
// The stream route: shapes whose fp64 operators exceed shared memory (the
// h50 state box: one rho's K^-1 and K are 160 KB, A and fl(rho_r A) 480
// KB). The wrapper orders the lanes by rho index on the device
// (admm_fused.rho_order, no host sync) and each block takes lanes of one
// index only, so it needs one rho's operators; the lanes stay where they
// are in memory (the block reads and writes them through the order). The
// wrapper hands the operators over once per launch as fp64
// copies in device memory, K^-1 and K transposed, rows padded to an even
// stride ldg (admm_fused._launch_k5). Each product streams its operator
// through two shared panels with cp.async (16 bytes a thread at a time),
// the next panel in flight while the block computes on the current one,
// so that every entry is read from L2 once per block and iteration and
// serves all the block's lanes. A panel holds pc constraint rows of A and
// of fl(rho_r A) (the A'y / A'rho.s pass, summed over the rows), or pk
// columns of every row of K^-1, K or A (the row-vector products, summed
// over the columns); the panels of a product go in index order, so each
// output still sums in index order. The schedule repeats every iteration:
// the pass, the solve, refine_steps times the residual and the solve, A xt.
// K4 (PACKED) has no A xt: its solves read W_r = [K_r^-1'; kia_r'] (n + m
// rows, in place of K^-1), whose panels give xt and the image st at once.
// What bounds it on this card: at the h50 state box the products alone
// (the panels' shared-memory reads, one entry per lane and multiply-add)
// take about 1.8 ms a chunk and the panel copies alone about 0.9 ms (L2 at
// ~3.6 TB/s), and the two overlap only in part (PERF.md, Findings: K5's
// redesign); two lanes a thread, which halves the entries read, gained
// nothing.

template <int RPT_N, int RPT_M, bool REFINE, int THREADS, int REGS, bool PACKED, int MODE>
__global__ void __launch_bounds__(THREADS, 65536 / (THREADS * REGS))
admm_perr_stream_kernel(const double* __restrict__ kinv,  // K4: W, n + m rows a rho
                        const double* __restrict__ kmat,
                        const double* __restrict__ a,
                        const double* __restrict__ ra,
                        const float* __restrict__ rho_vecs,
                        const float* __restrict__ rho_invs,
                        const float* __restrict__ q,
                        const float* __restrict__ l,
                        const float* __restrict__ u,
                        const int* __restrict__ order,
                        const int* __restrict__ starts,
                        const float* __restrict__ x_in,
                        const float* __restrict__ s_in,
                        const float* __restrict__ y_in,
                        const float* __restrict__ ax_in,
                        float* __restrict__ x_out, float* __restrict__ s_out,
                        float* __restrict__ y_out, float* __restrict__ ax_out,
                        int n, int m, int B, int R, int chunk,
                        int refine_steps, float sigma, float alpha,
                        StreamLayout lay) {
  using P = Prec<MODE>;
  constexpr bool EXACT = MODE == mpc_admm::kHighest;  // buffers hold s and y exactly
  extern __shared__ __align__(16) double smem[];
  const int L = blockDim.x;
  const int G = blockDim.y;
  const int b = threadIdx.x;
  const int t = threadIdx.y;
  const int tid = t * L + b;
  const int nthreads = L * G;

  // the block's lanes: one rho index's (mpc_admm::rho_block)
  const mpc_admm::RhoBlock rb = mpc_admm::rho_block(starts, R, L);
  if (rb.r == R) return;  // a spare block: every thread, before any barrier
  const int r = rb.r, seg = rb.seg, cnt = rb.cnt;
  const int off = rb.off + b;
  const bool live = off < cnt;
  const int lc = order[seg + (live ? off : cnt - 1)];

  const int ldg = lay.ldg, pc = lay.pc;
  double* pan = smem;                          // two panels
  double* bn0 = pan + 2 * lay.panel;           // rhs, then the residual
  double* bn1 = bn0 + lay.nslots * L;          // xt
  double* bm0 = bn1 + lay.nslots * L;          // y
  double* bm1 = bm0 + lay.mslots * L;          // s
  float* rho_sh = reinterpret_cast<float*>(bm1 + lay.mslots * L);  // rho_r
  float* rhoi_sh = rho_sh + m;                 // rho_r^-1
  const double* ki_r = kinv + r * (PACKED ? n + m : n) * ldg;
  const double* k_r = kmat + r * n * ldg;
  const double* ra_r = ra + r * m * ldg;
  for (int i = tid; i < m; i += nthreads) {
    rho_sh[i] = rho_vecs[r * m + i];
    rhoi_sh[i] = rho_invs[r * m + i];
  }

  // x, q and ax in registers; s and y only in their lane buffers (fp64,
  // exact), so that a thread's rows fit the register budget; at a bf16
  // precision the buffers hold their split, and s and y stay in registers
  float x[RPT_N], qv[RPT_N], ax[RPT_M];
  float sv[EXACT ? 1 : RPT_M], yv[EXACT ? 1 : RPT_M];
  int col[RPT_N];
#pragma unroll
  for (int k = 0; k < RPT_N; ++k) {
    const int j = t + k * G;
    col[k] = j < n ? j : n - 1;
    x[k] = x_in[col[k] * B + lc];
    qv[k] = q[col[k] * B + lc];
  }
#pragma unroll
  for (int k = 0; k < RPT_M; ++k) {
    const int i = t + k * G;
    const int g = (i < m ? i : m - 1) * B + lc;
    ax[k] = ax_in[g];
    const int sl = slot(i, L, b);
    if constexpr (EXACT) {
      bm0[sl] = y_in[g];
      bm1[sl] = s_in[g];
    } else {
      yv[k] = y_in[g];
      sv[k] = s_in[g];
      P::store(bm0 + sl, P::entry(yv[k]));
      P::store(bm1 + sl, P::entry(sv[k]));
    }
  }

  // phases of an iteration: 0 the A'y / A'rho.s pass, odd a K^-1 solve,
  // even a K product, the last A xt (K4: the last a solve). A wide phase
  // reads the operator of the pkm / skm panels: A xt (K5, the last), a
  // solve with its image (K4, every odd one)
  const int phases = (PACKED ? 2 : 3) + 2 * (REFINE ? refine_steps : 0);
  auto panels = [&](int ph) {
    return ph == 0 ? (m + pc - 1) / pc
                   : (PACKED ? (ph & 1) == 1 : ph == phases - 1) ? (n + lay.pkm - 1) / lay.pkm
                                                                 : (n + lay.pkn - 1) / lay.pkn;
  };
  // start copying panel p of phase ph into dst
  auto issue = [&](int ph, int p, double* dst) {
    if (ph == 0) {
      const int i0 = p * pc;
      const int rows = (m - i0 < pc ? m - i0 : pc);
      const int chunks = rows * ldg / 2;
      for (int c = tid; c < 2 * chunks; c += nthreads) {
        const int w = c < chunks ? 0 : 1;
        const int h = c - w * chunks;
        copy16(dst + w * pc * ldg + 2 * h, (w ? ra_r : a) + i0 * ldg + 2 * h);
      }
    } else {
      const bool last = PACKED ? (ph & 1) == 1 : ph == phases - 1;  // wide
      const double* M = PACKED ? (last ? ki_r : k_r) : last ? a : (ph & 1) ? ki_r : k_r;
      const int rows = last ? (PACKED ? n + m : m) : n;
      const int pk = last ? lay.pkm : lay.pkn;
      const int sk = last ? lay.skm : lay.skn;
      const int l0 = p * pk;
      mpc_admm::copy_rows(dst, sk, M + l0, ldg, rows, n - l0 < pk ? n - l0 : pk, tid, nthreads);
    }
  };

  constexpr int ACC = PACKED ? (RPT_M > RPT_N ? RPT_N + RPT_M : 2 * RPT_N)
                             : RPT_M > 2 * RPT_N ? RPT_M : 2 * RPT_N;
  constexpr int ROWS = PACKED ? RPT_N + RPT_M : RPT_M > RPT_N ? RPT_M : RPT_N;
  const float beta = 1.0f - alpha;
  const int ps = 2 * L;
  const double* bn0_b = bn0 + 2 * b;
  const double* bn1_b = bn1 + 2 * b;
  const double* bm0_b = bm0 + 2 * b;
  const double* bm1_b = bm1 + 2 * b;
  int buf = 0;
  // K4: where the two panels hold all of one rho's operators (the pass's
  // A and fl(rho A), W, and K when refining, at the panels' strides) they
  // are copied once and stay for the chunk; ops/admm_fused.k4_resident
  // mirrors this test
  bool resident = false;
  int w_at = 0, k_at = 0;  // where W and K sit then
  if constexpr (PACKED) {
    const bool refine = REFINE && refine_steps > 0;
    w_at = 2 * pc * ldg;
    k_at = w_at + (n + m) * lay.skm;
    resident = pc >= m && lay.pkm >= n && lay.pkn >= n &&
               k_at + (refine ? n * lay.skn : 0) <= 2 * lay.panel;
  }
  issue(0, 0, pan);
  if (PACKED && resident) {
    issue(1, 0, pan + w_at);
    if (phases > 2) issue(2, 0, pan + k_at);
  }
  __pipeline_commit();
  for (int it = 0; it < chunk; ++it) {
    float rhs[RPT_N], xt[RPT_N], image[PACKED ? RPT_M : 1];  // image: K4's st
    for (int ph = 0; ph < phases; ++ph) {
      const int np = panels(ph);
      const bool end = ph == phases - 1;
      const bool last = PACKED ? (ph & 1) == 1 : end;  // wide
      const int sk = last ? lay.skm : lay.skn;
      const int pk = last ? lay.pkm : lay.pkn;
      const int rows = last ? (PACKED ? RPT_N + RPT_M : RPT_M) : RPT_N;
      // a solve reads rhs or the residual, a K product and A xt read xt
      const double* v = (ph & 1) ? bn0_b : bn1_b;
      typename P::Acc acc[ACC];
#pragma unroll
      for (int k = 0; k < ACC; ++k) P::zero(acc[k]);
      int roff[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        if constexpr (PACKED) {  // W's rows: xt's n, then the image's m
          const int j = t + k * G;
          const int i = t + (k - RPT_N) * G;
          roff[k] = k < RPT_N ? (j < n ? j : n - 1) * sk : (n + (i < m ? i : m - 1)) * sk;
        } else {
          const int i = t + k * G;
          roff[k] = last ? (i < m ? i : m - 1) * sk : (i < n ? i : n - 1) * sk;
        }
      }
      for (int p = 0; p < np; ++p) {
        if (!PACKED || !resident) {
          // the next panel of the schedule into the other buffer
          if (p + 1 < np)
            issue(ph, p + 1, pan + (buf ^ 1) * lay.panel);
          else if (!end)
            issue(ph + 1, 0, pan + (buf ^ 1) * lay.panel);
          else if (it + 1 < chunk)
            issue(0, 0, pan + (buf ^ 1) * lay.panel);
          __pipeline_commit();
          __pipeline_wait_prior(1);
        } else if (it == 0 && ph == 0) {  // resident: one panel a phase, in place
          __pipeline_wait_prior(0);
        }
        __syncthreads();  // the panel and the lane buffers it meets are complete
        const double* Pn = pan + buf * lay.panel;  // the panel
        if (PACKED && resident) Pn = pan + (ph == 0 ? 0 : (ph & 1) ? w_at : k_at);
        if (ph == 0) {
          const int i0 = p * pc;
          const int i1 = (m - i0 < pc ? m : i0 + pc);
          int i = i0;
#pragma unroll 2
          for (; i + 1 < i1; i += 2) {
            typename P::Entry vy0, vy1, vs0, vs1;
            P::load2(bm0_b + (i >> 1) * ps, vy0, vy1);
            P::load2(bm1_b + (i >> 1) * ps, vs0, vs1);
            const double* a0 = Pn + (i - i0) * ldg;
            const double* w0 = a0 + pc * ldg;
#pragma unroll
            for (int k = 0; k < RPT_N; ++k) {
              P::mac(acc[2 * k], P::load(a0 + col[k]), vy0);
              P::mac(acc[2 * k + 1], P::load(w0 + col[k]), vs0);
              P::mac(acc[2 * k], P::load(a0 + ldg + col[k]), vy1);
              P::mac(acc[2 * k + 1], P::load(w0 + ldg + col[k]), vs1);
            }
          }
          if (i < i1) {
            const typename P::Entry vy = P::load(bm0_b + (i >> 1) * ps);
            const typename P::Entry vs = P::load(bm1_b + (i >> 1) * ps);
            const double* a0 = Pn + (i - i0) * ldg;
            const double* w0 = a0 + pc * ldg;
#pragma unroll
            for (int k = 0; k < RPT_N; ++k) {
              P::mac(acc[2 * k], P::load(a0 + col[k]), vy);
              P::mac(acc[2 * k + 1], P::load(w0 + col[k]), vs);
            }
          }
        } else {
          const int l0 = p * pk;
          const int l1 = (n - l0 < pk ? n : l0 + pk);
          int j = l0;
#pragma unroll 2
          for (; j + 1 < l1; j += 2) {
            typename P::Entry v0, v1;
            P::load2(v + (j >> 1) * ps, v0, v1);
#pragma unroll
            for (int k = 0; k < ROWS; ++k) {
              if (k >= rows) break;
              typename P::Entry c0, c1;
              P::load2(Pn + roff[k] + (j - l0), c0, c1);
              P::mac(acc[k], c0, v0);
              P::mac(acc[k], c1, v1);
            }
          }
          if (j < l1) {
            const typename P::Entry vj = P::load(v + (j >> 1) * ps);
#pragma unroll
            for (int k = 0; k < ROWS; ++k) {
              if (k >= rows) break;
              P::mac(acc[k], P::load(Pn + roff[k] + (j - l0)), vj);
            }
          }
        }
        // every thread is done with the panel (a resident one stays: the
        // next phase's first barrier orders the lane buffers)
        if (!PACKED || !resident) __syncthreads();
        buf ^= 1;
      }
      // the phase's result; the next phase reads it after its first barrier
      if (ph == 0) {
#pragma unroll
        for (int k = 0; k < RPT_N; ++k) {
          rhs[k] = sigma * x[k] - qv[k] - P::result(acc[2 * k]) + P::result(acc[2 * k + 1]);
          P::store(bn0 + slot(t + k * G, L, b), P::entry(rhs[k]));
        }
      } else if constexpr (PACKED) {
        if (ph & 1) {  // a solve: xt and st, or their corrections
#pragma unroll
          for (int k = 0; k < RPT_N; ++k) {
            const float c = P::result(acc[k]);
            xt[k] = ph == 1 ? c : xt[k] + c;
            P::store(bn1 + slot(t + k * G, L, b), P::entry(xt[k]));
          }
#pragma unroll
          for (int k = 0; k < RPT_M; ++k) {
            const float c = P::result(acc[RPT_N + k]);
            image[k] = ph == 1 ? c : image[k] + c;
          }
        } else {  // the refinement residual
#pragma unroll
          for (int k = 0; k < RPT_N; ++k)
            P::store(bn0 + slot(t + k * G, L, b), P::entry(rhs[k] - P::result(acc[k])));
        }
        if (end) {
#pragma unroll
          for (int k = 0; k < RPT_N; ++k) x[k] = alpha * xt[k] + beta * x[k];
#pragma unroll
          for (int k = 0; k < RPT_M; ++k) {
            const int i = t + k * G;
            const int ic = i < m ? i : m - 1;
            const int g = ic * B + lc;
            const int sl = slot(i, L, b);
            const float s_old = EXACT ? static_cast<float>(bm1[sl]) : sv[EXACT ? 0 : k];
            const float y_old = EXACT ? static_cast<float>(bm0[sl]) : yv[EXACT ? 0 : k];
            const float vv = alpha * image[k] + beta * s_old;
            const float s_new = clip(vv + rhoi_sh[ic] * y_old, l[g], u[g]);
            const float y_new = y_old + rho_sh[ic] * (vv - s_new);
            if constexpr (EXACT) {
              bm0[sl] = y_new;
              bm1[sl] = s_new;
            } else {
              yv[k] = y_new;
              sv[k] = s_new;
              P::store(bm0 + sl, P::entry(y_new));
              P::store(bm1 + sl, P::entry(s_new));
            }
            ax[k] = alpha * image[k] + beta * ax[k];
          }
        }
      } else if (ph == 1) {
#pragma unroll
        for (int k = 0; k < RPT_N; ++k) {
          xt[k] = P::result(acc[k]);
          P::store(bn1 + slot(t + k * G, L, b), P::entry(xt[k]));
        }
      } else if (!last && (ph & 1) == 0) {  // the refinement residual
#pragma unroll
        for (int k = 0; k < RPT_N; ++k)
          P::store(bn0 + slot(t + k * G, L, b), P::entry(rhs[k] - P::result(acc[k])));
      } else if (!last) {  // the refinement's correction
#pragma unroll
        for (int k = 0; k < RPT_N; ++k) {
          xt[k] += P::result(acc[k]);
          P::store(bn1 + slot(t + k * G, L, b), P::entry(xt[k]));
        }
      } else {
#pragma unroll
        for (int k = 0; k < RPT_N; ++k) x[k] = alpha * xt[k] + beta * x[k];
#pragma unroll
        for (int k = 0; k < RPT_M; ++k) {
          const int i = t + k * G;
          const int ic = i < m ? i : m - 1;
          const int g = ic * B + lc;
          const int sl = slot(i, L, b);
          const float st = P::result(acc[k]);
          const float s_old = EXACT ? static_cast<float>(bm1[sl]) : sv[EXACT ? 0 : k];
          const float y_old = EXACT ? static_cast<float>(bm0[sl]) : yv[EXACT ? 0 : k];
          const float vv = alpha * st + beta * s_old;
          const float s_new = clip(vv + rhoi_sh[ic] * y_old, l[g], u[g]);
          const float y_new = y_old + rho_sh[ic] * (vv - s_new);
          if constexpr (EXACT) {
            bm0[sl] = y_new;
            bm1[sl] = s_new;
          } else {
            yv[k] = y_new;
            sv[k] = s_new;
            P::store(bm0 + sl, P::entry(y_new));
            P::store(bm1 + sl, P::entry(s_new));
          }
          ax[k] = alpha * st + beta * ax[k];
        }
      }
    }
  }

  if (!live) return;  // after the last barrier
#pragma unroll
  for (int k = 0; k < RPT_N; ++k) {
    const int j = t + k * G;
    if (j < n) x_out[j * B + lc] = x[k];
  }
#pragma unroll
  for (int k = 0; k < RPT_M; ++k) {
    const int i = t + k * G;
    if (i >= m) continue;
    const int g = i * B + lc;
    const int sl = slot(i, L, b);  // the thread's own slots: no barrier needed
    s_out[g] = EXACT ? static_cast<float>(bm1[sl]) : sv[EXACT ? 0 : k];
    y_out[g] = EXACT ? static_cast<float>(bm0[sl]) : yv[EXACT ? 0 : k];
    ax_out[g] = ax[k];
  }
}

struct StreamArgs {
  const double *kinv, *kmat, *a, *ra;
  const float *rho_vecs, *rho_invs, *q, *l, *u;
  const int *order, *starts;
  const float *x_in, *s_in, *y_in, *ax_in;
  float *x_out, *s_out, *y_out, *ax_out;
  int n, m, B, R, chunk, refine_steps;
  float sigma, alpha;
};

template <int RPT_N, int RPT_M, bool REFINE, int THREADS, int REGS, bool PACKED, int MODE>
cudaError_t launch_stream(const StreamArgs& a, int lanes, int groups, const StreamLayout& lay,
                          size_t smem, cudaStream_t stream) {
  const dim3 block(lanes, groups);
  if (static_cast<int>(block.x * block.y) > THREADS) return cudaErrorInvalidValue;
  auto kernel = admm_perr_stream_kernel<RPT_N, RPT_M, REFINE, THREADS, REGS, PACKED, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + lanes - 1) / lanes + a.R);
  kernel<<<grid, block, smem, stream>>>(
      a.kinv, a.kmat, a.a, a.ra, a.rho_vecs, a.rho_invs, a.q, a.l, a.u,
      a.order, a.starts, a.x_in, a.s_in, a.y_in, a.ax_in, a.x_out, a.s_out,
      a.y_out, a.ax_out, a.n, a.m, a.B, a.R, a.chunk, a.refine_steps,
      a.sigma, a.alpha, lay);
  return cudaGetLastError();
}

// the stream route's instantiations, as MPC_K5_INSTANCES;
// ops/admm_fused.K5_STREAM_INSTANCES plans only these. At 128 registers
// (4, 10) spills 8 to 12 bytes and (3, 8) 12
#define MPC_K5_STREAM_INSTANCES(X)                                         \
  X(2, 6, 384, 168, 168) X(3, 8, 448, 128, 128) X(4, 10, 480, 128, 128)
// K4's (ops/admm_fused.K4_STREAM_INSTANCES): a solve holds n + m rows'
// sums and the image through the refinement, so fewer rows a thread;
// (3, 8) spills 20 to 24 bytes
#define MPC_K4_STREAM_INSTANCES(X)                                         \
  X(2, 3, 384, 168, 168) X(2, 6, 384, 168, 168) X(3, 4, 256, 255, 255)     \
  X(3, 8, 320, 168, 168)

// the stream route's instantiation of rows per thread (rpt_n, rpt_m) for
// K5 (PACKED false) or K4 at precision MODE
template <bool PACKED, int MODE>
int stream_dispatch(const StreamArgs& args, int lanes, int groups, const StreamLayout& lay,
                    size_t smem, cudaStream_t st, int rpt_n, int rpt_m) {
  const bool refine = args.refine_steps > 0;
#define MPC_DENSE_STREAM_CASE(N, M, T, REGS, REGS_REFINE)                               \
  case 64 * N + M:                                                                        \
    return static_cast<int>(                                                              \
        refine ? launch_stream<N, M, true, T, REGS_REFINE, PACKED, MODE>(args, lanes,     \
                                                                         groups, lay,     \
                                                                         smem, st)        \
               : launch_stream<N, M, false, T, REGS, PACKED, MODE>(args, lanes, groups,   \
                                                                   lay, smem, st));
  if constexpr (PACKED) {
    switch (64 * rpt_n + rpt_m) {
      MPC_K4_STREAM_INSTANCES(MPC_DENSE_STREAM_CASE)
    }
  } else {
    switch (64 * rpt_n + rpt_m) {
      MPC_K5_STREAM_INSTANCES(MPC_DENSE_STREAM_CASE)
    }
  }
#undef MPC_DENSE_STREAM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The stream route's entry for K5 (PACKED false) or K4, as shared_chunk.
template <bool PACKED>
int stream_chunk(const StreamArgs& args, int mode, int lanes, int groups, int rpt_n, int rpt_m,
                 int panel, int smem_bytes, void* stream) {
  const int n = args.n, m = args.m, B = args.B;
  if (n <= 0 || n > 128 || m < 1 || m > 512 || B <= 0 || args.R <= 0 ||
      args.chunk < 0 || args.refine_steps < 0 ||
      static_cast<long long>(m) * B > INT_MAX ||
      (lanes != 4 && lanes != 8 && lanes != 16 && lanes != 32) ||
      groups <= 0 || lanes * groups > 512 || rpt_n * groups < n ||
      rpt_m * groups < m || panel <= 0 || panel % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  StreamLayout lay;
  lay.ldg = n + (n & 1);
  lay.nslots = (groups * rpt_n + 1) & ~1;
  lay.mslots = (groups * rpt_m + 1) & ~1;
  lay.panel = panel;
  lay.pc = (panel / (2 * lay.ldg)) & ~1;
  if (PACKED && lay.pc > m + (m & 1)) lay.pc = m + (m & 1);  // K4: room for W and K beside
  lay.skn = panel_stride(panel, n, lay.ldg);
  lay.skm = panel_stride(panel, PACKED ? n + m : m, lay.ldg);
  lay.pkn = lay.skn < lay.ldg ? lay.skn : lay.ldg;
  lay.pkm = lay.skm < lay.ldg ? lay.skm : lay.ldg;
  if (lay.pc < 2 || lay.skn == 0 || lay.skm == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the bytes of the layout (ops/admm_fused.k5_stream_smem_bytes mirrors
  // these two lines, which tests/test_torch_build.py reads)
  const long long stream_doubles = 2LL * panel + 2LL * (lay.nslots + lay.mslots) * lanes;
  const long long stream_need = 8 * stream_doubles + 4 * (2LL * m);
  if (stream_need != smem_bytes || stream_need > static_cast<long long>(mpc_admm::kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(stream_need);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case mpc_admm::kHighest:
      return stream_dispatch<PACKED, mpc_admm::kHighest>(args, lanes, groups, lay, smem, st,
                                                         rpt_n, rpt_m);
    case mpc_admm::kBf16x3:
      return stream_dispatch<PACKED, mpc_admm::kBf16x3>(args, lanes, groups, lay, smem, st,
                                                        rpt_n, rpt_m);
    case mpc_admm::kDefault:
      return stream_dispatch<PACKED, mpc_admm::kDefault>(args, lanes, groups, lay, smem, st,
                                                         rpt_n, rpt_m);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// K5: launch `chunk` iterations on `stream` on the shared route at
// precision `mode` (0 "highest", 1 "bf16x3", 2 "default";
// ops/admm_fused.PRECISIONS). All arrays are float32 and contiguous on one
// device: kinv, kmat (R, n, n) (kmat
// unused when refine_steps == 0), a (m, n), rho_vecs, rho_invs (R, m), q,
// x_in, x_out (n, B); l, u, s_in, y_in, ax_in, s_out, y_out, ax_out
// (m, B); idx (B) int32 in [0, R). Takes n <= 128, 1 <= m <= 512 and
// m B < 2^31. The layout comes from ops/admm_fused.k5_plan: lanes (4, 8,
// 16 or 32) and groups per block, rows per thread of the variables
// (rpt_n) and of the constraints (rpt_m), and the dynamic shared memory
// they take, which must equal what the kernel's layout needs. Returns the
// cudaError_t of the launch (0 on success).
int admm_perr_chunk(const float* kinv, const float* kmat, const float* a,
                    const float* rho_vecs, const float* rho_invs,
                    const float* q, const float* l, const float* u,
                    const int* idx, const float* x_in, const float* s_in,
                    const float* y_in, const float* ax_in, float* x_out,
                    float* s_out, float* y_out, float* ax_out, int n, int m,
                    int B, int R, int chunk, int refine_steps, int mode, int lanes,
                    int groups, int rpt_n, int rpt_m, int smem_bytes,
                    float sigma, float alpha, void* stream) {
  const Args args{kinv, kmat, nullptr, a, rho_vecs, rho_invs, q, l, u, idx,
                  x_in, s_in, y_in, ax_in, x_out, s_out, y_out, ax_out,
                  n, m, B, R, chunk, refine_steps, sigma, alpha};
  return shared_chunk<false>(args, mode, lanes, groups, rpt_n, rpt_m, smem_bytes, stream);
}

// K4 on the shared route: as admm_perr_chunk, with kia (R, n, m) =
// K_r^-1 A' beside A; the layout from ops/admm_fused.k4_plan.
int admm_packed_chunk(const float* kinv, const float* kmat, const float* kia,
                      const float* a, const float* rho_vecs, const float* rho_invs,
                      const float* q, const float* l, const float* u,
                      const int* idx, const float* x_in, const float* s_in,
                      const float* y_in, const float* ax_in, float* x_out,
                      float* s_out, float* y_out, float* ax_out, int n, int m,
                      int B, int R, int chunk, int refine_steps, int mode, int lanes,
                      int groups, int rpt_n, int rpt_m, int smem_bytes,
                      float sigma, float alpha, void* stream) {
  const Args args{kinv, kmat, kia, a, rho_vecs, rho_invs, q, l, u, idx,
                  x_in, s_in, y_in, ax_in, x_out, s_out, y_out, ax_out,
                  n, m, B, R, chunk, refine_steps, sigma, alpha};
  return shared_chunk<true>(args, mode, lanes, groups, rpt_n, rpt_m, smem_bytes, stream);
}

// K5 on the stream route (the same arithmetic; shapes whose fp64
// operators do not fit shared memory): kinv, kmat (R, n, ldg) are K^-1 and
// K transposed (row j holds column j), a (m, ldg) is A and ra (R, m, ldg)
// fl(rho_r A), all as the precision's 8-byte entries (fp64 at "highest",
// the fp32 pair (hi, lo) at "bf16x3", (hi, 0) at "default":
// ops/admm_fused.operator_entries) with rows padded to ldg = n rounded up
// to even (kmat unused when refine_steps == 0); the other arrays as on the shared
// route, with order (B), the lanes sorted by rho index (stable), and
// starts (R + 1), where each index's lanes start in that order
// (admm_fused.rho_order), in place of idx. The layout comes from
// ops/admm_fused.k5_plan: lanes and groups per block, rows per thread, the
// doubles of one operator panel (panel) and the dynamic shared memory they
// take, which must equal what the kernel's layout needs. Returns the
// cudaError_t of the launch (0 on success).
int admm_perr_stream_chunk(const double* kinv, const double* kmat,
                           const double* a, const double* ra,
                           const float* rho_vecs, const float* rho_invs,
                           const float* q, const float* l, const float* u,
                           const int* order, const int* starts,
                           const float* x_in, const float* s_in,
                           const float* y_in, const float* ax_in,
                           float* x_out, float* s_out, float* y_out,
                           float* ax_out, int n, int m, int B, int R,
                           int chunk, int refine_steps, int mode, int lanes, int groups,
                           int rpt_n, int rpt_m, int panel, int smem_bytes,
                           float sigma, float alpha, void* stream) {
  const StreamArgs args{kinv, kmat, a, ra, rho_vecs, rho_invs, q, l, u, order,
                        starts, x_in, s_in, y_in, ax_in, x_out, s_out, y_out,
                        ax_out, n, m, B, R, chunk, refine_steps, sigma, alpha};
  return stream_chunk<false>(args, mode, lanes, groups, rpt_n, rpt_m, panel, smem_bytes,
                             stream);
}

// K4 on the stream route: as admm_perr_stream_chunk, with w (R, n + m,
// ldg) in place of kinv: rows 0..n-1 of w_r are K_r^-1 transposed, rows
// n..n+m-1 kia_r = K_r^-1 A' transposed (row i holds column i); the layout
// from ops/admm_fused.k4_plan.
int admm_packed_stream_chunk(const double* w, const double* kmat,
                             const double* a, const double* ra,
                             const float* rho_vecs, const float* rho_invs,
                             const float* q, const float* l, const float* u,
                             const int* order, const int* starts,
                             const float* x_in, const float* s_in,
                             const float* y_in, const float* ax_in,
                             float* x_out, float* s_out, float* y_out,
                             float* ax_out, int n, int m, int B, int R,
                             int chunk, int refine_steps, int mode, int lanes,
                             int groups, int rpt_n, int rpt_m, int panel, int smem_bytes,
                             float sigma, float alpha, void* stream) {
  const StreamArgs args{w, kmat, a, ra, rho_vecs, rho_invs, q, l, u, order,
                        starts, x_in, s_in, y_in, ax_in, x_out, s_out, y_out,
                        ax_out, n, m, B, R, chunk, refine_steps, sigma, alpha};
  return stream_chunk<true>(args, mode, lanes, groups, rpt_n, rpt_m, panel, smem_bytes,
                            stream);
}

}  // extern "C"
