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
// What bounds it on this card: the fp64 multiply-adds of its matrix-vector
// products, read from shared memory. A lane does (1 + 2 refine) n^2 for the
// K-solve and 3 ms n for the A2 products per iteration (at the state-
// constrained h20 shape, n = 40 and ms = 80: 4,800 + 9,600) against 4 m + 2 n
// floats moved per chunk; plus 3 + 2 refine barriers per iteration.
//
// Precision, as in K1 (csrc/admm_diag.cu): the state is fp32, every
// matrix-vector product (the K-solves and the three A2 products) is
// accumulated in fp64 from exact fp32 products and rounded once to fp32.
// Built with --fmad=false so the elementwise updates round like PyTorch's.
//
// Design:
// - Layout stays lane-last: x, q (n, B); s, y, ax, l, u (m, B), row-major,
//   so neighbouring threads own neighbouring lanes and every global access
//   is coalesced.
// - A block covers 32 lanes x 16 row-groups (512 threads). Thread (b, t)
//   owns box rows t, t+16, ... (RPT_N of them) and tail rows t, t+16, ...
//   (RPT_T), and keeps x, q, d and s, y, ax of those rows in registers for
//   the whole chunk. l and u are read from global memory at each use
//   (coalesced, L1-resident), rho and rho^-1 from an (R, m) shared table by
//   the lane's index: at m = 132 a thread holding all seven per row would
//   spill.
// - Shared memory, fp64 unless said: the R stacked K^-1 (and K when
//   refining), A2 once (A2' y is read column-wise from the same copy, so
//   there is no transposed copy), two (n, 32) buffers (rhs and xt) and two
//   (ms, 32) buffers (the tail of y and of rho.s, so both A2' products run
//   in one pass), and the fp32 rho tables. The operators arrive as fp32 and
//   are widened once per launch: widening at use would cost a conversion
//   per multiply-add, at a quarter of the fp64 FMA rate. At the state +
//   neighborhood h20 shape (n = 40, m = 132, R = 5, refine 1) that is
//   230,304 of the 232,448 bytes a block may use; the wrapper (k2_fits)
//   refuses what does not fit.
// - Each lane applies only its own K_r^-1: the TPU kernel's "all R
//   candidates, then mask-select" was a gather workaround.
// - The state is out of place, as in K1. Lanes past B compute on zeros,
//   store nothing and reach every barrier.
// - One block per SM (shared memory), so B = 2048 fills 64 of 132 SMs.
//
// Bound to PyTorch by ctypes through the plain C function admm_mixed_chunk,
// which returns cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLanes = 32;  // lanes per block (blockDim.x)
constexpr int kGroups = 16;  // row-groups per block (blockDim.y)
constexpr int kThreads = kLanes * kGroups;

// jnp.clip / torch.clamp semantics: a NaN passes through, l = -inf clips
// nothing from below.
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// out[k] = sum_j M[off[k] + j] v[j, b] over j < len, fp64 sums of exact
// fp32 products, rounded once
template <int RPT>
__device__ __forceinline__ void matvec(const double* __restrict__ M,
                                       const double* __restrict__ v,
                                       const int (&off)[RPT], int len, int b,
                                       float (&out)[RPT]) {
  double acc[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) acc[k] = 0.0;
  for (int j = 0; j < len; ++j) {
    const double vj = v[j * kLanes + b];
#pragma unroll
    for (int k = 0; k < RPT; ++k) acc[k] = fma(M[off[k] + j], vj, acc[k]);
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) out[k] = static_cast<float>(acc[k]);
}

template <int RPT_N, int RPT_T>
__global__ void __launch_bounds__(kThreads, 1)
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
                        int refine_steps, float sigma, float alpha) {
  extern __shared__ double smem[];
  const int ms = m - n;
  const int nn = n * n;
  const int ops = R * nn;
  double* ki_sh = smem;
  double* k_sh = smem + ops;  // present only when refining
  double* a2_sh = smem + (refine_steps > 0 ? 2 : 1) * ops;
  double* bn0 = a2_sh + ms * n;    // (n, 32): rhs, then the refinement residual
  double* bn1 = bn0 + n * kLanes;  // (n, 32): xt
  double* bt0 = bn1 + n * kLanes;  // (ms, 32): y[n:]
  double* bt1 = bt0 + ms * kLanes;  // (ms, 32): (rho.s)[n:]
  float* rho_sh = reinterpret_cast<float*>(bt1 + ms * kLanes);  // (R, m)
  float* rhoi_sh = rho_sh + R * m;

  const int b = threadIdx.x;
  const int t = threadIdx.y;
  const int tid = t * kLanes + b;
  const int lane = blockIdx.x * kLanes + b;
  const bool live = lane < B;

  for (int i = tid; i < ops; i += kThreads) ki_sh[i] = kinv[i];
  if (refine_steps > 0)
    for (int i = tid; i < ops; i += kThreads) k_sh[i] = kmat[i];
  for (int i = tid; i < ms * n; i += kThreads) a2_sh[i] = a2[i];
  for (int i = tid; i < R * m; i += kThreads) {
    rho_sh[i] = rho_vecs[i];
    rhoi_sh[i] = rho_invs[i];
  }

  const int r = live ? idx[lane] : 0;
  const double* Ki = ki_sh + r * nn;
  const double* Km = k_sh + r * nn;
  const float* rho_r = rho_sh + r * m;
  const float* rhoi_r = rhoi_sh + r * m;

  // box rows i = t + k*16 (k < RPT_N); tail rows j = t + k*16 (k < RPT_T),
  // which are rows n + j of s, y, ax, l, u
  float x[RPT_N], qv[RPT_N], d[RPT_N], sb[RPT_N], yb[RPT_N], axb[RPT_N];
  float st[RPT_T], yt[RPT_T], axt[RPT_T];
  int noff[RPT_N];  // K row offsets (row clamped into range)
  int ncol[RPT_N];  // A2 column of the box row (clamped)
  int toff[RPT_T];  // A2 row offsets (clamped)
  bool nown[RPT_N], town[RPT_T];
#pragma unroll
  for (int k = 0; k < RPT_N; ++k) {
    const int i = t + k * kGroups;
    nown[k] = i < n;
    ncol[k] = nown[k] ? i : n - 1;
    noff[k] = ncol[k] * n;
    const bool ok = live && nown[k];
    const size_t gn = static_cast<size_t>(i) * B + lane;
    x[k] = ok ? x_in[gn] : 0.0f;
    qv[k] = ok ? q[gn] : 0.0f;
    d[k] = ok ? dvec[i] : 0.0f;
    sb[k] = ok ? s_in[gn] : 0.0f;
    yb[k] = ok ? y_in[gn] : 0.0f;
    axb[k] = ok ? ax_in[gn] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < RPT_T; ++k) {
    const int j = t + k * kGroups;
    town[k] = j < ms;
    toff[k] = (town[k] ? j : ms - 1) * n;
    const bool ok = live && town[k];
    const size_t gm = static_cast<size_t>(n + j) * B + lane;
    st[k] = ok ? s_in[gm] : 0.0f;
    yt[k] = ok ? y_in[gm] : 0.0f;
    axt[k] = ok ? ax_in[gm] : 0.0f;
  }
  __syncthreads();

  // one relaxation / clip / dual update of a row (row = its index in m)
  auto update = [&](float stv, float& s, float& y, float& ax, int row) {
    const float lo = live ? l[static_cast<size_t>(row) * B + lane] : 0.0f;
    const float hi = live ? u[static_cast<size_t>(row) * B + lane] : 0.0f;
    const float v = alpha * stv + (1.0f - alpha) * s;
    const float s_new = clip(v + rhoi_r[row] * y, lo, hi);
    y = y + rho_r[row] * (v - s_new);
    ax = alpha * stv + (1.0f - alpha) * ax;
    s = s_new;
  };

  const float beta = 1.0f - alpha;
  for (int it = 0; it < chunk; ++it) {
    // the tail of y and of rho.s, for both A2' products in one pass
#pragma unroll
    for (int k = 0; k < RPT_T; ++k) {
      if (!town[k]) continue;
      const int j = t + k * kGroups;
      bt0[j * kLanes + b] = yt[k];
      bt1[j * kLanes + b] = rho_r[n + j] * st[k];
    }
    __syncthreads();
    float aty2[RPT_N], ars2[RPT_N];
    {
      double acc_y[RPT_N], acc_r[RPT_N];
#pragma unroll
      for (int k = 0; k < RPT_N; ++k) acc_y[k] = acc_r[k] = 0.0;
      for (int j = 0; j < ms; ++j) {
        const double vy = bt0[j * kLanes + b];
        const double vr = bt1[j * kLanes + b];
#pragma unroll
        for (int k = 0; k < RPT_N; ++k) {
          const double a = a2_sh[j * n + ncol[k]];  // A2'[col, j]
          acc_y[k] = fma(a, vy, acc_y[k]);
          acc_r[k] = fma(a, vr, acc_r[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < RPT_N; ++k) {
        aty2[k] = static_cast<float>(acc_y[k]);
        ars2[k] = static_cast<float>(acc_r[k]);
      }
    }
    float rhs[RPT_N], xt[RPT_N];
#pragma unroll
    for (int k = 0; k < RPT_N; ++k) {
      const int i = t + k * kGroups;
      const float aty = d[k] * yb[k] + aty2[k];
      const float w = d[k] * ((nown[k] ? rho_r[i] : 0.0f) * sb[k]) + ars2[k];
      rhs[k] = sigma * x[k] - qv[k] - aty + w;
      if (nown[k]) bn0[i * kLanes + b] = rhs[k];
    }
    __syncthreads();
    matvec<RPT_N>(Ki, bn0, noff, n, b, xt);
    for (int step = 0; step < refine_steps; ++step) {
      float tmp[RPT_N];
#pragma unroll
      for (int k = 0; k < RPT_N; ++k)
        if (nown[k]) bn1[(t + k * kGroups) * kLanes + b] = xt[k];
      __syncthreads();  // also: every thread is done reading bn0
      matvec<RPT_N>(Km, bn1, noff, n, b, tmp);
#pragma unroll
      for (int k = 0; k < RPT_N; ++k)
        if (nown[k]) bn0[(t + k * kGroups) * kLanes + b] = rhs[k] - tmp[k];
      __syncthreads();  // also: every thread is done reading bn1
      matvec<RPT_N>(Ki, bn0, noff, n, b, tmp);
#pragma unroll
      for (int k = 0; k < RPT_N; ++k) xt[k] += tmp[k];
    }
#pragma unroll
    for (int k = 0; k < RPT_N; ++k)
      if (nown[k]) bn1[(t + k * kGroups) * kLanes + b] = xt[k];
    __syncthreads();  // also: every thread is done reading bn0 and bn1
    float st2[RPT_T];
    matvec<RPT_T>(a2_sh, bn1, toff, n, b, st2);  // A2 xt for the tail rows

#pragma unroll
    for (int k = 0; k < RPT_N; ++k) {
      if (!nown[k]) continue;
      update(d[k] * xt[k], sb[k], yb[k], axb[k], t + k * kGroups);
      x[k] = alpha * xt[k] + beta * x[k];
    }
#pragma unroll
    for (int k = 0; k < RPT_T; ++k) {
      if (!town[k]) continue;
      update(st2[k], st[k], yt[k], axt[k], n + t + k * kGroups);
    }
  }

  if (!live) return;
#pragma unroll
  for (int k = 0; k < RPT_N; ++k) {
    if (!nown[k]) continue;
    const size_t g = static_cast<size_t>(t + k * kGroups) * B + lane;
    x_out[g] = x[k];
    s_out[g] = sb[k];
    y_out[g] = yb[k];
    ax_out[g] = axb[k];
  }
#pragma unroll
  for (int k = 0; k < RPT_T; ++k) {
    if (!town[k]) continue;
    const size_t g = static_cast<size_t>(n + t + k * kGroups) * B + lane;
    s_out[g] = st[k];
    y_out[g] = yt[k];
    ax_out[g] = axt[k];
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

template <int RPT_N, int RPT_T>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      admm_mixed_chunk_kernel<RPT_N, RPT_T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 block(kLanes, kGroups);
  const dim3 grid((a.B + kLanes - 1) / kLanes);
  admm_mixed_chunk_kernel<RPT_N, RPT_T><<<grid, block, smem, stream>>>(
      a.kinv, a.kmat, a.a2, a.dvec, a.rho_vecs, a.rho_invs, a.q, a.l, a.u,
      a.idx, a.x_in, a.s_in, a.y_in, a.ax_in, a.x_out, a.s_out, a.y_out,
      a.ax_out, a.n, a.m, a.B, a.R, a.chunk, a.refine_steps, a.sigma,
      a.alpha);
  return cudaGetLastError();
}

// rows per thread are rounded up to an instantiated count; the extra rows
// are masked
int round_rpt(int rows, const int* counts, int k) {
  const int need = (rows + kGroups - 1) / kGroups;
  for (int i = 0; i < k; ++i)
    if (counts[i] >= need) return counts[i];
  return 0;
}

template <int RPT_N>
cudaError_t dispatch_tail(int rpt_t, const Args& a, size_t smem,
                          cudaStream_t st) {
  switch (rpt_t) {
    case 1: return launch<RPT_N, 1>(a, smem, st);
    case 2: return launch<RPT_N, 2>(a, smem, st);
    case 4: return launch<RPT_N, 4>(a, smem, st);
    case 6: return launch<RPT_N, 6>(a, smem, st);
    case 8: return launch<RPT_N, 8>(a, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch `chunk` iterations on `stream`. All arrays are float32 and
// contiguous on one device: kinv, kmat (R, n, n) (kmat unused when
// refine_steps == 0), a2 (m - n, n), dvec (n), rho_vecs, rho_invs (R, m),
// q, x_in, x_out (n, B); l, u, s_in, y_in, ax_in, s_out, y_out, ax_out
// (m, B); idx (B) int32 in [0, R). Takes n <= 128 and 1 <= m - n <= 128.
// Returns the cudaError_t of the launch (0 on success).
int admm_mixed_chunk(const float* kinv, const float* kmat, const float* a2,
                     const float* dvec, const float* rho_vecs,
                     const float* rho_invs, const float* q, const float* l,
                     const float* u, const int* idx, const float* x_in,
                     const float* s_in, const float* y_in, const float* ax_in,
                     float* x_out, float* s_out, float* y_out, float* ax_out,
                     int n, int m, int B, int R, int chunk, int refine_steps,
                     float sigma, float alpha, void* stream) {
  const int ms = m - n;
  if (n <= 0 || n > 128 || ms < 1 || ms > 128 || B <= 0 || R <= 0 ||
      chunk < 0 || refine_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static const int kCountsN[] = {1, 2, 3, 4, 6, 8};
  static const int kCountsT[] = {1, 2, 4, 6, 8};
  const int rpt_n = round_rpt(n, kCountsN, 6);
  const int rpt_t = round_rpt(ms, kCountsT, 5);
  // the layout of the kernel's dynamic shared memory; the wrapper checks
  // the same sum against the card's 227 KB per block (k2_smem_bytes)
  const size_t stacks = refine_steps > 0 ? 2 : 1;
  const size_t smem =
      (stacks * R * n * n + static_cast<size_t>(ms) * n +
       2 * static_cast<size_t>(n) * kLanes + 2 * static_cast<size_t>(ms) * kLanes) *
          sizeof(double) +
      2 * static_cast<size_t>(R) * m * sizeof(float);
  const Args a{kinv, kmat, a2, dvec, rho_vecs, rho_invs, q, l, u, idx,
               x_in, s_in, y_in, ax_in, x_out, s_out, y_out, ax_out,
               n, m, B, R, chunk, refine_steps, sigma, alpha};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (rpt_n) {
    case 1: err = dispatch_tail<1>(rpt_t, a, smem, st); break;
    case 2: err = dispatch_tail<2>(rpt_t, a, smem, st); break;
    case 3: err = dispatch_tail<3>(rpt_t, a, smem, st); break;
    case 4: err = dispatch_tail<4>(rpt_t, a, smem, st); break;
    case 6: err = dispatch_tail<6>(rpt_t, a, smem, st); break;
    case 8: err = dispatch_tail<8>(rpt_t, a, smem, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
