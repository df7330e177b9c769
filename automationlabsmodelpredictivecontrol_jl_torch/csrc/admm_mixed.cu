// K2 on Hopper: `chunk` ADMM iterations of a batch of condensed QPs whose
// constraint matrix is A = [diag(d); A2]: the n input-box rows are diagonal,
// the ms = m - n state and terminal rows form a dense tail A2 (ms, n).
//
// Replaces ops/admm_pallas.py::_iterate_kernel_mixed of the JAX package
// (driven by _iterate_chunk_mixed_T). Same math, per lane b and iteration:
//
//   A'y   = d.y[:n] + A2' y[n:];   A'(rho.s) split the same way
//   rhs   = sigma x - q - A'y + A'(rho.s)
//   xt    = K_r^-1 rhs,                r = the lane's rho-grid index
//   refine_steps times: xt += K_r^-1 (rhs - K_r xt)
//   st    = [d.xt; A2 xt];  v = alpha st + (1-alpha) s
//   x     = alpha xt + (1-alpha) x;  s = clip(v + rho^-1 y, l, u)
//   y    += rho (v - s);  ax = alpha st + (1-alpha) ax
//
// What bounds it on this card: not the fp64 multiply-adds (a lane does
// (1 + 2 refine) n^2 for the K-solve and 3 ms n for the A2 products per
// iteration; at the state-constrained h20 shape, n = 40 and ms = 80: 4,800
// + 9,600) but the shared-memory loads that feed them, one operator entry
// per multiply-add and the lane vectors once per thread, with 5-12 warps
// per SM to hide their latency (one block per SM: shared memory). The
// loads of a warp cost their bytes whether or not its threads read the
// same address (k3_ab.py --kernel K2; PERF.md, Findings PR 7). So:
// - No bank conflicts between the rho copies or the rows of a warp: the
//   copies sit at a stride that is odd in 16-byte units, and the rows at a
//   stride chosen for the lanes per block (admm_common.cuh), so that the
//   distinct entries a warp reads fall in distinct banks. Lanes at mixed
//   rho indices no longer serialize.
// - A block covers L lanes x G row-groups with L and G from the wrapper's
//   plan (ops/admm_fused.k2_plan): L small enough that ceil(B / L) blocks
//   fill the 132 SMs, G as few as latency allows (each thread reads the
//   vectors once for all its rows) and dividing the rows where it can.
// - No predicates and no 64-bit index arithmetic in the iteration loop:
//   offsets are 32-bit and computed once; rows past n or ms (padding) and
//   lanes past B compute on clamped copies of real data into slots of
//   their own, and store nothing.
// - Operator rows and the lane vectors are read two entries at a time
//   (16-byte loads): half the load instructions.
//
// Precision, as in K1 (csrc/admm_diag.cu): the state is fp32; at
// "highest" every matrix-vector product (the K-solves and the three A2
// products) is accumulated in fp64 from exact fp32 products, in index
// order, and rounded once to fp32; at "bf16x3" and "default" (the template
// parameter MODE, admm_common.cuh) each is that precision's passes over
// operators staged as bf16 pairs and lane vectors split when they are
// written to the lane buffers (the tail of rho.s split after its fp32
// product, as JAX's rs_all), in the same layout. Built with --fmad=false so
// the elementwise updates round like PyTorch's.
//
// Layout:
// - Lane-last state in device memory: x, q (n, B); s, y, ax, l, u (m, B),
//   row-major, so neighbouring threads own neighbouring lanes and every
//   global access is coalesced.
// - Thread (b, t) owns box rows t, t+G, ... (RPT_N of them) and tail rows
//   t, t+G, ... (RPT_T) and keeps x, q, d, rho, rho^-1 and s, y, ax of
//   them in registers for the chunk (rho is fixed for a lane within a
//   chunk); l and u are read at each use (coalesced, L1-resident).
// - Shared memory, fp64: the R stacked K^-1 (and K when refining), rows at
//   stride ld, copies at stride sk; A2 once (rows at stride ld; A2' y is
//   read column-wise from the same copy); two box-row buffers (rhs and xt)
//   and two tail-row buffers (the tail of y and of rho.s, so both A2'
//   products run in one pass), L lanes each, rows paired: row i of lane b
//   at ((i / 2) L + b) 2 + i % 2. The operators arrive as fp32 and are
//   widened once per launch: widening at use would cost a conversion per
//   multiply-add, at a quarter of the fp64 FMA rate.
// - Each lane applies only its own K_r^-1: the TPU kernel's "all R
//   candidates, then mask-select" was a gather workaround.
// - The state is out of place. Every thread reaches every barrier; the
//   only early return comes after the last one.
//
// Bound to PyTorch by ctypes through the plain C function admm_mixed_chunk,
// which returns cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "admm_common.cuh"

namespace {

using mpc_admm::clip;
using mpc_admm::load2;
using mpc_admm::matvec;
using mpc_admm::Prec;
using mpc_admm::slot;

// The most threads (L x G) a block of an instantiation may have: 512 where
// its rows fit 128 registers a thread, else 256 (255 registers a thread).
// ops/admm_fused.k2_max_threads mirrors it.
constexpr int max_threads(int rpt_n, int rpt_t) {
  return rpt_t <= 4 && (rpt_n <= 2 || (rpt_n == 3 && rpt_t <= 2)) ? 512 : 256;
}

struct Layout {
  int ld, sk, nslots, tslots;  // row and copy strides, buffer rows
};

template <int RPT_N, int RPT_T, int MODE>
__global__ void __launch_bounds__(max_threads(RPT_N, RPT_T), 1)
admm_mixed_chunk_kernel(const float* __restrict__ kinv,
                        const float* __restrict__ kmat,
                        const float* __restrict__ a2,
                        const float* __restrict__ dvec,
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
  // "highest" is written out in plain fp64 stores and sums: the same
  // operations through Prec<kHighest> compiled to code 2-4% slower at the
  // state box's shape on an H100 80GB HBM3 at 700 W (k3_ab.py --kernel
  // K2; PERF.md, Findings)
  constexpr bool kHi = MODE == mpc_admm::kHighest;
  extern __shared__ __align__(16) double smem[];
  const int L = blockDim.x;
  const int G = blockDim.y;
  const int ms = m - n;
  const int ld = lay.ld, sk = lay.sk;
  double* ki_sh = smem;
  double* k_sh = smem + R * sk;  // present only when refining
  double* a2_sh = smem + (refine_steps > 0 ? 2 : 1) * R * sk;
  double* bn0 = a2_sh + ms * ld;       // box rows: rhs, then the residual
  double* bn1 = bn0 + lay.nslots * L;  // box rows: xt
  double* bt0 = bn1 + lay.nslots * L;  // tail rows: y[n:]
  double* bt1 = bt0 + lay.tslots * L;  // tail rows: (rho.s)[n:]

  const int b = threadIdx.x;
  const int t = threadIdx.y;
  const int tid = t * L + b;
  const int nthreads = L * G;
  const int lane = blockIdx.x * L + b;
  const bool live = lane < B;
  const int lc = live ? lane : B - 1;  // lanes past B run on lane B-1's data

  const int nn = n * n;
  for (int i = tid; i < R * nn; i += nthreads) {
    const int rr = i / nn;
    const int row = (i - rr * nn) / n;
    const int dst = rr * sk + row * ld + (i - rr * nn - row * n);
    if constexpr (kHi) {
      ki_sh[dst] = kinv[i];
      if (refine_steps > 0) k_sh[dst] = kmat[i];
    } else {
      P::store(ki_sh + dst, P::entry(kinv[i]));
      if (refine_steps > 0) P::store(k_sh + dst, P::entry(kmat[i]));
    }
  }
  for (int i = tid; i < ms * n; i += nthreads) {
    const int row = i / n;
    if constexpr (kHi)
      a2_sh[row * ld + (i - row * n)] = a2[i];
    else
      P::store(a2_sh + row * ld + (i - row * n), P::entry(a2[i]));
  }

  const int r = idx[lc];
  const float* rho_r = rho_vecs + r * m;
  const float* rhoi_r = rho_invs + r * m;

  // box rows i = t + k G (k < RPT_N), tail rows j = t + k G (k < RPT_T),
  // which are rows n + j of s, y, ax, l, u; a padded row reads the last
  // real row and owns a buffer slot past the real ones
  float x[RPT_N], qv[RPT_N], d[RPT_N], sb[RPT_N], yb[RPT_N], axb[RPT_N];
  float rhob[RPT_N], rhoib[RPT_N];
  float st[RPT_T], yt[RPT_T], axt[RPT_T], rhot[RPT_T], rhoit[RPT_T];
  int koff[RPT_N];  // the row of K_r^-1 and K_r
  int acol[RPT_N];  // the column of A2
  int gn[RPT_N];    // (row, lane) in the (n or m, B) arrays
  int sn[RPT_N];    // the row's slot in bn0, bn1
  int aoff[RPT_T], gt[RPT_T], stl[RPT_T];
#pragma unroll
  for (int k = 0; k < RPT_N; ++k) {
    const int i = t + k * G;
    const int ic = i < n ? i : n - 1;
    koff[k] = r * sk + ic * ld;
    acol[k] = ic;
    gn[k] = ic * B + lc;
    sn[k] = slot(i, L, b);
    x[k] = x_in[gn[k]];
    qv[k] = q[gn[k]];
    d[k] = dvec[ic];
    sb[k] = s_in[gn[k]];
    yb[k] = y_in[gn[k]];
    axb[k] = ax_in[gn[k]];
    rhob[k] = rho_r[ic];
    rhoib[k] = rhoi_r[ic];
  }
#pragma unroll
  for (int k = 0; k < RPT_T; ++k) {
    const int j = t + k * G;
    const int jc = j < ms ? j : ms - 1;
    aoff[k] = jc * ld;
    gt[k] = (n + jc) * B + lc;
    stl[k] = slot(j, L, b);
    st[k] = s_in[gt[k]];
    yt[k] = y_in[gt[k]];
    axt[k] = ax_in[gt[k]];
    rhot[k] = rho_r[n + jc];
    rhoit[k] = rhoi_r[n + jc];
  }
  __syncthreads();

  // one relaxation / clip / dual update of a row at g in the (m, B) arrays
  auto update = [&](float stv, float& s, float& y, float& ax, int g,
                    float rho, float rho_inv) {
    const float lo = l[g];
    const float hi = u[g];
    const float v = alpha * stv + (1.0f - alpha) * s;
    const float s_new = clip(v + rho_inv * y, lo, hi);
    y = y + rho * (v - s_new);
    ax = alpha * stv + (1.0f - alpha) * ax;
    s = s_new;
  };

  const float beta = 1.0f - alpha;
  const int ps = 2 * L;  // doubles between a lane's row pairs
  const double* bn0_b = bn0 + 2 * b;
  const double* bn1_b = bn1 + 2 * b;
  const double* bt0_b = bt0 + 2 * b;
  const double* bt1_b = bt1 + 2 * b;
  for (int it = 0; it < chunk; ++it) {
    // the tail of y and of rho.s, for both A2' products in one pass
#pragma unroll
    for (int k = 0; k < RPT_T; ++k) {
      if constexpr (kHi) {
        bt0[stl[k]] = yt[k];
        bt1[stl[k]] = rhot[k] * st[k];
      } else {
        P::store(bt0 + stl[k], P::entry(yt[k]));
        P::store(bt1 + stl[k], P::entry(rhot[k] * st[k]));
      }
    }
    __syncthreads();
    float aty2[RPT_N], ars2[RPT_N];
    if constexpr (kHi) {
      double acc_y[RPT_N], acc_r[RPT_N];
#pragma unroll
      for (int k = 0; k < RPT_N; ++k) acc_y[k] = acc_r[k] = 0.0;
      const int pairs = ms >> 1;
#pragma unroll 2
      for (int p = 0; p < pairs; ++p) {
        const double2 vy = load2(bt0_b + p * ps);
        const double2 vr = load2(bt1_b + p * ps);
        const double* a0 = a2_sh + 2 * p * ld;  // A2 rows 2p and 2p + 1
#pragma unroll
        for (int k = 0; k < RPT_N; ++k) {
          const double c0 = a0[acol[k]];
          const double c1 = a0[ld + acol[k]];
          acc_y[k] = fma(c0, vy.x, acc_y[k]);
          acc_r[k] = fma(c0, vr.x, acc_r[k]);
          acc_y[k] = fma(c1, vy.y, acc_y[k]);
          acc_r[k] = fma(c1, vr.y, acc_r[k]);
        }
      }
      if (ms & 1) {
        const double vy = bt0_b[pairs * ps];
        const double vr = bt1_b[pairs * ps];
        const double* a0 = a2_sh + (ms - 1) * ld;
#pragma unroll
        for (int k = 0; k < RPT_N; ++k) {
          const double c0 = a0[acol[k]];
          acc_y[k] = fma(c0, vy, acc_y[k]);
          acc_r[k] = fma(c0, vr, acc_r[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < RPT_N; ++k) {
        aty2[k] = static_cast<float>(acc_y[k]);
        ars2[k] = static_cast<float>(acc_r[k]);
      }
    } else {
      typename P::Acc acc_y[RPT_N], acc_r[RPT_N];
#pragma unroll
      for (int k = 0; k < RPT_N; ++k) {
        P::zero(acc_y[k]);
        P::zero(acc_r[k]);
      }
      const int pairs = ms >> 1;
#pragma unroll 2
      for (int p = 0; p < pairs; ++p) {
        typename P::Entry vy0, vy1, vr0, vr1;
        P::load2(bt0_b + p * ps, vy0, vy1);
        P::load2(bt1_b + p * ps, vr0, vr1);
        const double* a0 = a2_sh + 2 * p * ld;  // A2 rows 2p and 2p + 1
#pragma unroll
        for (int k = 0; k < RPT_N; ++k) {
          const typename P::Entry c0 = P::load(a0 + acol[k]);
          const typename P::Entry c1 = P::load(a0 + ld + acol[k]);
          P::mac(acc_y[k], c0, vy0);
          P::mac(acc_r[k], c0, vr0);
          P::mac(acc_y[k], c1, vy1);
          P::mac(acc_r[k], c1, vr1);
        }
      }
      if (ms & 1) {
        const typename P::Entry vy = P::load(bt0_b + pairs * ps);
        const typename P::Entry vr = P::load(bt1_b + pairs * ps);
        const double* a0 = a2_sh + (ms - 1) * ld;
#pragma unroll
        for (int k = 0; k < RPT_N; ++k) {
          const typename P::Entry c0 = P::load(a0 + acol[k]);
          P::mac(acc_y[k], c0, vy);
          P::mac(acc_r[k], c0, vr);
        }
      }
#pragma unroll
      for (int k = 0; k < RPT_N; ++k) {
        aty2[k] = P::result(acc_y[k]);
        ars2[k] = P::result(acc_r[k]);
      }
    }
    float rhs[RPT_N], xt[RPT_N];
#pragma unroll
    for (int k = 0; k < RPT_N; ++k) {
      const float aty = d[k] * yb[k] + aty2[k];
      const float w = d[k] * (rhob[k] * sb[k]) + ars2[k];
      rhs[k] = sigma * x[k] - qv[k] - aty + w;
      if constexpr (kHi)
        bn0[sn[k]] = rhs[k];
      else
        P::store(bn0 + sn[k], P::entry(rhs[k]));
    }
    __syncthreads();
    matvec<MODE, RPT_N>(ki_sh, bn0_b, koff, n, ps, xt);
    for (int step = 0; step < refine_steps; ++step) {
      float tmp[RPT_N];
#pragma unroll
      for (int k = 0; k < RPT_N; ++k)
        if constexpr (kHi)
          bn1[sn[k]] = xt[k];
        else
          P::store(bn1 + sn[k], P::entry(xt[k]));
      __syncthreads();  // also: every thread is done reading bn0
      matvec<MODE, RPT_N>(k_sh, bn1_b, koff, n, ps, tmp);
#pragma unroll
      for (int k = 0; k < RPT_N; ++k)
        if constexpr (kHi)
          bn0[sn[k]] = rhs[k] - tmp[k];
        else
          P::store(bn0 + sn[k], P::entry(rhs[k] - tmp[k]));
      __syncthreads();  // also: every thread is done reading bn1
      matvec<MODE, RPT_N>(ki_sh, bn0_b, koff, n, ps, tmp);
#pragma unroll
      for (int k = 0; k < RPT_N; ++k) xt[k] += tmp[k];
    }
#pragma unroll
    for (int k = 0; k < RPT_N; ++k)
      if constexpr (kHi)
        bn1[sn[k]] = xt[k];
      else
        P::store(bn1 + sn[k], P::entry(xt[k]));
    __syncthreads();  // also: every thread is done reading bn0 and bn1
    float st2[RPT_T];
    matvec<MODE, RPT_T>(a2_sh, bn1_b, aoff, n, ps, st2);  // A2 xt for the tail rows

#pragma unroll
    for (int k = 0; k < RPT_N; ++k) {
      update(d[k] * xt[k], sb[k], yb[k], axb[k], gn[k], rhob[k], rhoib[k]);
      x[k] = alpha * xt[k] + beta * x[k];
    }
#pragma unroll
    for (int k = 0; k < RPT_T; ++k)
      update(st2[k], st[k], yt[k], axt[k], gt[k], rhot[k], rhoit[k]);
  }

  if (!live) return;  // after the last barrier
#pragma unroll
  for (int k = 0; k < RPT_N; ++k) {
    if (t + k * G >= n) continue;
    x_out[gn[k]] = x[k];
    s_out[gn[k]] = sb[k];
    y_out[gn[k]] = yb[k];
    ax_out[gn[k]] = axb[k];
  }
#pragma unroll
  for (int k = 0; k < RPT_T; ++k) {
    if (t + k * G >= ms) continue;
    s_out[gt[k]] = st[k];
    y_out[gt[k]] = yt[k];
    ax_out[gt[k]] = axt[k];
  }
}

struct Args {
  const float *kinv, *kmat, *a2, *dvec, *rho_vecs, *rho_invs, *q, *l, *u;
  const int* idx;
  const float *x_in, *s_in, *y_in, *ax_in;
  float *x_out, *s_out, *y_out, *ax_out;
  int n, m, B, R, chunk, refine_steps;
  float sigma, alpha;
};

template <int RPT_N, int RPT_T, int MODE>
cudaError_t launch(const Args& a, dim3 block, const Layout& lay, size_t smem,
                   cudaStream_t stream) {
  if (static_cast<int>(block.x * block.y) > max_threads(RPT_N, RPT_T))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      admm_mixed_chunk_kernel<RPT_N, RPT_T, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + block.x - 1) / block.x);
  admm_mixed_chunk_kernel<RPT_N, RPT_T, MODE><<<grid, block, smem, stream>>>(
      a.kinv, a.kmat, a.a2, a.dvec, a.rho_vecs, a.rho_invs, a.q, a.l, a.u,
      a.idx, a.x_in, a.s_in, a.y_in, a.ax_in, a.x_out, a.s_out, a.y_out,
      a.ax_out, a.n, a.m, a.B, a.R, a.chunk, a.refine_steps, a.sigma,
      a.alpha, lay);
  return cudaGetLastError();
}

// the instantiated rows per thread; ops/admm_fused.py (K2_RPT_N, K2_RPT_T)
// plans only these
#define MPC_K2_RPT_N(X) X(1) X(2) X(3) X(4)
#define MPC_K2_RPT_T(N, X) X(N, 1) X(N, 2) X(N, 3) X(N, 4) X(N, 5) X(N, 6) X(N, 8)

// the instantiation of rows per thread (rpt_n, rpt_t) at precision MODE
template <int MODE>
int dispatch(const Args& a, dim3 block, const Layout& lay, size_t smem, cudaStream_t st,
             int rpt_n, int rpt_t) {
#define MPC_K2_CASE(N, T) \
  case 16 * N + T:        \
    return static_cast<int>(launch<N, T, MODE>(a, block, lay, smem, st));
#define MPC_K2_TAILS(N) MPC_K2_RPT_T(N, MPC_K2_CASE)
  switch (16 * rpt_n + rpt_t) {
    MPC_K2_RPT_N(MPC_K2_TAILS)
  }
#undef MPC_K2_TAILS
#undef MPC_K2_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launch `chunk` iterations on `stream` at precision `mode` (0 "highest",
// 1 "bf16x3", 2 "default"; ops/admm_fused.PRECISIONS). All arrays are
// float32 and contiguous on one device: kinv, kmat (R, n, n) (kmat unused
// when refine_steps == 0), a2 (m - n, n), dvec (n), rho_vecs, rho_invs (R, m),
// q, x_in, x_out (n, B); l, u, s_in, y_in, ax_in, s_out, y_out, ax_out
// (m, B); idx (B) int32 in [0, R). Takes n <= 128, 1 <= m - n <= 128 and
// m B < 2^31. The layout comes from ops/admm_fused.k2_plan: lanes (4, 8, 16
// or 32) and groups per block (at most max_threads(rpt_n, rpt_t) threads),
// rows per thread of the box (rpt_n) and of the tail (rpt_t), and the
// dynamic shared memory they take, which must equal what the kernel's
// layout needs.
// Returns the cudaError_t of the launch (0 on success).
int admm_mixed_chunk(const float* kinv, const float* kmat, const float* a2,
                     const float* dvec, const float* rho_vecs,
                     const float* rho_invs, const float* q, const float* l,
                     const float* u, const int* idx, const float* x_in,
                     const float* s_in, const float* y_in, const float* ax_in,
                     float* x_out, float* s_out, float* y_out, float* ax_out,
                     int n, int m, int B, int R, int chunk, int refine_steps,
                     int mode, int lanes, int groups, int rpt_n, int rpt_t,
                     int smem_bytes, float sigma, float alpha, void* stream) {
  const int ms = m - n;
  if (n <= 0 || n > 128 || ms < 1 || ms > 128 || B <= 0 || R <= 0 ||
      chunk < 0 || refine_steps < 0 ||
      static_cast<long long>(m) * B > INT_MAX ||
      (lanes != 4 && lanes != 8 && lanes != 16 && lanes != 32) ||
      groups <= 0 || lanes * groups > 512 || rpt_n * groups < n ||
      rpt_t * groups < ms)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout lay;
  lay.ld = mpc_admm::row_stride(n, lanes);
  lay.sk = mpc_admm::copy_stride(n, lay.ld);
  lay.nslots = (groups * rpt_n + 1) & ~1;
  lay.tslots = (groups * rpt_t + 1) & ~1;
  const size_t stacks = refine_steps > 0 ? 2 : 1;
  const size_t smem =
      (stacks * R * lay.sk + static_cast<size_t>(ms) * lay.ld +
       2 * static_cast<size_t>(lay.nslots + lay.tslots) * lanes) *
      sizeof(double);
  if (smem != static_cast<size_t>(smem_bytes) || smem > mpc_admm::kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{kinv, kmat, a2, dvec, rho_vecs, rho_invs, q, l, u, idx,
               x_in, s_in, y_in, ax_in, x_out, s_out, y_out, ax_out,
               n, m, B, R, chunk, refine_steps, sigma, alpha};
  const dim3 block(lanes, groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case mpc_admm::kHighest:
      return dispatch<mpc_admm::kHighest>(a, block, lay, smem, st, rpt_n, rpt_t);
    case mpc_admm::kBf16x3:
      return dispatch<mpc_admm::kBf16x3>(a, block, lay, smem, st, rpt_n, rpt_t);
    case mpc_admm::kDefault:
      return dispatch<mpc_admm::kDefault>(a, block, lay, smem, st, rpt_n, rpt_t);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
