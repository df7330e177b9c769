// K1 on Hopper: `chunk` ADMM iterations of a box-only (diagonal-A) QP batch.
//
// Replaces ops/admm_pallas.py::_iterate_kernel_diag of the JAX package
// (driven by _iterate_chunk_diag_T). Same math, per lane b and iteration:
//
//   rhs = sigma x - q - d.y + d.(rho.s)
//   xt  = K_r^-1 rhs,                r = the lane's rho-grid index
//   refine_steps times: xt += K_r^-1 (rhs - K_r xt)
//   st  = d.xt;  v = alpha st + (1-alpha) s
//   x   = alpha xt + (1-alpha) x;  s = clip(v + rho^-1 y, l, u)
//   y  += rho (v - s);  ax = alpha st + (1-alpha) ax
//
// What bounds it on this card: not device memory. At the main-path shape
// (n = 40) a lane moves 11 n floats per chunk but does n^2 multiply-adds per
// K-solve per iteration, so the work is the K-solve's reads of the operator
// and of the right-hand side from shared memory, its fp64 multiply-adds
// (half the fp32 rate), plus one barrier per matrix-vector product.
//
// Precision: the state is fp32, but every matrix-vector product is
// accumulated in fp64 (exact fp32 products, fp64 sums) and rounded once to
// fp32. Accumulated in fp32, the K-solve's roundoff leaves 8.1% of the h20
// main-path lanes (16384, the benchmark's initial states) above the 1e-6
// certificate after tier 1's 75 iterations, more than the 512-lane tier-2
// bucket holds; accumulated in fp64, 2.5% (counted with the plain version
// on the CPU). The file is built with --fmad=false so that the elementwise
// updates round after every operation, as PyTorch's do.
//
// Design:
// - Layout stays lane-last, (n, B) row-major: neighbouring threads own
//   neighbouring lanes, so every global load and store is coalesced.
// - A block covers 32 lanes x W row-groups (blockDim = (32, W)). Thread
//   (b, t) owns rows t, t+W, t+2W, ... of lane b and keeps that lane's x, s,
//   y, ax, q, l, u, rho, rho^-1 and d for those rows in registers for the
//   whole chunk (RPT = ceil(n / W) rows, a template parameter so the arrays
//   stay in registers).
// - The R stacked K^-1 (and K, when refining) are copied into dynamic
//   shared memory, widened to fp64, once per launch. Each lane applies only
//   its own K_r^-1:
//   the TPU kernel's "all R candidates, then mask-select" existed to avoid
//   gathers on the TPU and is not needed here.
// - The rhs (and the refinement vectors) of the block's 32 lanes go through
//   two (n, 32) fp64 shared buffers; a warp (fixed t, 32 lanes) reads them
//   conflict-free, and reads the operator row by broadcast when its lanes
//   share r.
// - The state is out of place: the caller allocates x, s, y, ax out, since
//   the driver keeps the pre-chunk state to freeze converged lanes.
// - Lanes past B (the ragged last block) compute on zeros and store nothing;
//   they still reach every barrier.
//
// Bound to PyTorch by ctypes through the plain C function admm_diag_chunk,
// which returns cudaGetLastError() after the launch (0 on success).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC --fmad=false

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLanes = 32;  // lanes per block (blockDim.x)
constexpr int kMaxThreads = 512;

// out = (M v)[rows], accumulated in fp64 and rounded once to fp32
template <int RPT>
__device__ __forceinline__ void matvec(const double* __restrict__ M,
                                       const double* __restrict__ v,
                                       const int (&roff)[RPT], int n, int b,
                                       float (&out)[RPT]) {
  double acc[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) acc[k] = 0.0;
  for (int j = 0; j < n; ++j) {
    const double vj = v[j * kLanes + b];
#pragma unroll
    for (int k = 0; k < RPT; ++k) acc[k] = fma(M[roff[k] + j], vj, acc[k]);
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) out[k] = static_cast<float>(acc[k]);
}

// jnp.clip / torch.clamp semantics: a NaN passes through (fminf/fmaxf
// would drop it, and the driver's NaN guard relies on it propagating).
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

template <int RPT>
__global__ void __launch_bounds__(kMaxThreads)
admm_diag_chunk_kernel(const float* __restrict__ kinv,
                       const float* __restrict__ kmat,
                       const float* __restrict__ dvec,
                       const float* __restrict__ rho_vecs,
                       const float* __restrict__ rho_invs,
                       const float* __restrict__ q, const float* __restrict__ l,
                       const float* __restrict__ u,
                       const int* __restrict__ idx,
                       const float* __restrict__ x_in,
                       const float* __restrict__ s_in,
                       const float* __restrict__ y_in,
                       const float* __restrict__ ax_in,
                       float* __restrict__ x_out, float* __restrict__ s_out,
                       float* __restrict__ y_out, float* __restrict__ ax_out,
                       int n, int B, int R, int chunk, int refine_steps,
                       float sigma, float alpha) {
  extern __shared__ double smem[];
  const int nn = n * n;
  const int ops = R * nn;
  double* ki_sh = smem;
  double* k_sh = smem + ops;  // present only when refining
  double* buf0 = smem + (refine_steps > 0 ? 2 : 1) * ops;
  double* buf1 = buf0 + n * kLanes;

  const int b = threadIdx.x;
  const int t = threadIdx.y;
  const int W = blockDim.y;
  const int tid = t * kLanes + b;
  const int nthreads = W * kLanes;
  const int lane = blockIdx.x * kLanes + b;
  const bool live = lane < B;

  for (int i = tid; i < ops; i += nthreads) ki_sh[i] = kinv[i];
  if (refine_steps > 0)
    for (int i = tid; i < ops; i += nthreads) k_sh[i] = kmat[i];

  const int r = live ? idx[lane] : 0;
  const double* Ki = ki_sh + r * nn;
  const double* Km = k_sh + r * nn;

  float x[RPT], s[RPT], y[RPT], ax[RPT], qv[RPT], lv[RPT], uv[RPT];
  float rho[RPT], rhoi[RPT], d[RPT];
  int roff[RPT];   // operator row offsets (row clamped into range)
  bool own[RPT];   // row exists
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int i = t + k * W;
    own[k] = i < n;
    roff[k] = (own[k] ? i : n - 1) * n;
    const bool ok = live && own[k];
    const size_t g = static_cast<size_t>(i) * B + lane;
    x[k] = ok ? x_in[g] : 0.0f;
    s[k] = ok ? s_in[g] : 0.0f;
    y[k] = ok ? y_in[g] : 0.0f;
    ax[k] = ok ? ax_in[g] : 0.0f;
    qv[k] = ok ? q[g] : 0.0f;
    lv[k] = ok ? l[g] : 0.0f;
    uv[k] = ok ? u[g] : 0.0f;
    rho[k] = ok ? rho_vecs[r * n + i] : 0.0f;
    rhoi[k] = ok ? rho_invs[r * n + i] : 0.0f;
    d[k] = ok ? dvec[i] : 0.0f;
  }
  __syncthreads();

  const float beta = 1.0f - alpha;
  for (int it = 0; it < chunk; ++it) {
    float rhs[RPT], xt[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      rhs[k] = sigma * x[k] - qv[k] - d[k] * y[k] + d[k] * (rho[k] * s[k]);
      if (own[k]) buf0[(t + k * W) * kLanes + b] = rhs[k];
    }
    __syncthreads();
    matvec<RPT>(Ki, buf0, roff, n, b, xt);
    for (int step = 0; step < refine_steps; ++step) {
      float tmp[RPT];
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        if (own[k]) buf1[(t + k * W) * kLanes + b] = xt[k];
      __syncthreads();  // also: every thread is done reading buf0
      matvec<RPT>(Km, buf1, roff, n, b, tmp);
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        if (own[k]) buf0[(t + k * W) * kLanes + b] = rhs[k] - tmp[k];
      __syncthreads();  // also: every thread is done reading buf1
      matvec<RPT>(Ki, buf0, roff, n, b, tmp);
#pragma unroll
      for (int k = 0; k < RPT; ++k) xt[k] += tmp[k];
    }
    __syncthreads();  // buf0 is read by all before the next iteration writes it
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const float st = d[k] * xt[k];
      const float v = alpha * st + beta * s[k];
      const float s_new = clip(v + rhoi[k] * y[k], lv[k], uv[k]);
      x[k] = alpha * xt[k] + beta * x[k];
      y[k] = y[k] + rho[k] * (v - s_new);
      ax[k] = alpha * st + beta * ax[k];
      s[k] = s_new;
    }
  }

  if (!live) return;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    if (!own[k]) continue;
    const size_t g = static_cast<size_t>(t + k * W) * B + lane;
    x_out[g] = x[k];
    s_out[g] = s[k];
    y_out[g] = y[k];
    ax_out[g] = ax[k];
  }
}

template <int RPT>
cudaError_t launch(dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                   const float* kinv, const float* kmat, const float* dvec,
                   const float* rho_vecs, const float* rho_invs,
                   const float* q, const float* l, const float* u,
                   const int* idx, const float* x_in, const float* s_in,
                   const float* y_in, const float* ax_in, float* x_out,
                   float* s_out, float* y_out, float* ax_out, int n, int B,
                   int R, int chunk, int refine_steps, float sigma,
                   float alpha) {
  cudaError_t err = cudaFuncSetAttribute(
      admm_diag_chunk_kernel<RPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  admm_diag_chunk_kernel<RPT><<<grid, block, smem, stream>>>(
      kinv, kmat, dvec, rho_vecs, rho_invs, q, l, u, idx, x_in, s_in, y_in,
      ax_in, x_out, s_out, y_out, ax_out, n, B, R, chunk, refine_steps, sigma,
      alpha);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch `chunk` iterations on `stream`. All arrays are float32 and
// contiguous on one device: kinv, kmat (R, n, n) (kmat unused when
// refine_steps == 0), dvec (n), rho_vecs, rho_invs (R, n), q, l, u, x_in,
// s_in, y_in, ax_in and the outputs (n, B); idx (B) int32 in [0, R).
// Returns the cudaError_t of the launch (0 on success).
int admm_diag_chunk(const float* kinv, const float* kmat, const float* dvec,
                    const float* rho_vecs, const float* rho_invs,
                    const float* q, const float* l, const float* u,
                    const int* idx, const float* x_in, const float* s_in,
                    const float* y_in, const float* ax_in, float* x_out,
                    float* s_out, float* y_out, float* ax_out, int n, int B,
                    int R, int chunk, int refine_steps, float sigma,
                    float alpha, void* stream) {
  if (n <= 0 || n > 128 || B <= 0 || R <= 0 || chunk < 0 || refine_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // row-groups: 8 up to n = 64, 16 up to n = 128, so rpt <= 8 and a block
  // has at most kMaxThreads threads
  const int W = n <= 64 ? 8 : 16;
  const int rpt = (n + W - 1) / W;
  // the K^-1 stack (and K when refining) plus two (n, 32) vector buffers,
  // all fp64; the wrapper checks this against the card's 227 KB per block
  const size_t stacks = refine_steps > 0 ? 2 : 1;
  const size_t smem =
      (stacks * R * n * n + 2 * static_cast<size_t>(n) * kLanes) * sizeof(double);
  const dim3 block(kLanes, W);
  const dim3 grid((B + kLanes - 1) / kLanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MPC_K1_CASE(RPT)                                                      \
  case RPT:                                                                   \
    return static_cast<int>(launch<RPT>(                                      \
        grid, block, smem, st, kinv, kmat, dvec, rho_vecs, rho_invs, q, l, u, \
        idx, x_in, s_in, y_in, ax_in, x_out, s_out, y_out, ax_out, n, B, R,   \
        chunk, refine_steps, sigma, alpha));
  switch (rpt) {
    MPC_K1_CASE(1)
    MPC_K1_CASE(2)
    MPC_K1_CASE(3)
    MPC_K1_CASE(4)
    MPC_K1_CASE(5)
    MPC_K1_CASE(6)
    MPC_K1_CASE(7)
    MPC_K1_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MPC_K1_CASE
}

}  // extern "C"
