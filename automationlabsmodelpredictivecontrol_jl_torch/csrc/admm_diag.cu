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
// What bounds it on this card: not device memory (a lane moves 11 n floats
// per chunk) and not the fp64 multiply-adds ((1 + 2 refine) n^2 per lane
// and iteration) but the shared-memory loads that feed them, an operator
// entry per multiply-add and the lane's vector once per thread, and the
// warps resident on an SM to hide their latency: at tier 1, two blocks of
// 8 warps an SM run a chunk about 10% faster than one (PERF.md, Findings,
// K1's redesign). Lanes of a warp that share a rho index read one address, which
// the card serves faster than the distinct addresses of mixed indices,
// but no layout can count on it. So, as in K2 (admm_mixed.cu):
// - No bank conflicts between the rho copies or the rows a warp reads
//   (admm_common.cuh): lanes at mixed rho indices do not serialize.
// - A block covers L lanes x G row-groups with L and G from the wrapper's
//   plan (ops/admm_fused.k1_plan): L small enough that ceil(B / L) blocks
//   fill the 132 SMs (4 lanes at tier 2's 512), G as few as the warps
//   resident on an SM allow (each thread reads a lane's vector once for
//   all its rows). Tier 1's operators take 25 KB, so up to 4 blocks share
//   an SM: the plan counts the blocks that fit at once by shared memory,
//   threads and the instantiation's registers (held by __launch_bounds__).
// - No predicates and no 64-bit index arithmetic in the iteration loop:
//   offsets are 32-bit and computed once; rows past n (padding) and lanes
//   past B compute on clamped copies of real data into slots of their own,
//   and store nothing.
// - Operator rows and the lane vectors are read 16 bytes at a time.
// - One barrier per matrix-vector product: the products alternate between
//   two lane buffers, so a buffer is written again only after the barrier
//   that follows every read of it.
//
// Precision: the state is fp32, and at "highest" every matrix-vector
// product is accumulated in fp64 (exact fp32 products, fp64 sums in index
// order) and rounded once to fp32. Accumulated in fp32, the K-solve's roundoff leaves
// 8.1% of the h20 main-path lanes (16384, the benchmark's initial states)
// above the 1e-6 certificate after tier 1's 75 iterations, more than the
// 512-lane tier-2 bucket holds; accumulated in fp64, 2.5% (counted with
// the plain version on the CPU). At "bf16x3" and "default" (the template
// parameter MODE, admm_common.cuh) the operators are staged as bf16 pairs
// and the lane vectors split when they are written to the lane buffers;
// the layout and the plans are the same. The file is built with
// --fmad=false so that the elementwise updates round after every
// operation, as PyTorch's do.
//
// Layout:
// - Lane-last state in device memory, (n, B) row-major: neighbouring
//   threads own neighbouring lanes, so every global access is coalesced.
// - Thread (b, t) owns rows t, t+G, ... (RPT of them) of lane b and keeps
//   x, q, d, s, y, ax, l, u, rho and rho^-1 of them in registers for the
//   chunk (rho is fixed for a lane within a chunk).
// - Shared memory, fp64: the R stacked K^-1 (and K when refining) as
//   admm_common.cuh lays them out, widened once per launch; two lane
//   buffers of paired rows. Each lane applies only its own K_r^-1: the TPU
//   kernel's "all R candidates, then mask-select" was a gather workaround.
// - The state is out of place: the caller allocates x, s, y, ax out, since
//   the driver keeps the pre-chunk state to freeze converged lanes. Every
//   thread reaches every barrier; the only early return comes after the
//   last one.
//
// Bound to PyTorch by ctypes through the plain C function admm_diag_chunk,
// which returns cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "admm_common.cuh"

namespace {

using mpc_admm::clip;
using mpc_admm::matvec;
using mpc_admm::Prec;
using mpc_admm::slot;

struct Layout {
  int ld, sk, nslots;  // row and copy strides, buffer rows
};

// Copy the R stacked (n, n) fp32 operators K^-1 (and K, when kmat is
// given) into shared memory as MODE's entries (fp64 at "highest"), rows at
// ld and copies at sk, with all `nthreads` threads of the block, both
// stacks in one pass. Widening at use would cost a conversion per
// multiply-add, at a quarter of the fp64 FMA rate.
template <int MODE>
__device__ __forceinline__ void stage_operators(double* __restrict__ ki_sh,
                                                double* __restrict__ k_sh,
                                                const float* __restrict__ kinv,
                                                const float* __restrict__ kmat,
                                                int R, int n, int ld, int sk,
                                                int tid, int nthreads) {
  const int nn = n * n;
  for (int i = tid; i < R * nn; i += nthreads) {
    const int rr = i / nn;
    const int row = (i - rr * nn) / n;
    const int dst = rr * sk + row * ld + (i - rr * nn - row * n);
    Prec<MODE>::store(ki_sh + dst, Prec<MODE>::entry(kinv[i]));
    if (kmat != nullptr) Prec<MODE>::store(k_sh + dst, Prec<MODE>::entry(kmat[i]));
  }
}

// out = M v for the thread's rows t + k G: v into the buffer at `cur` (as
// MODE's entries), a barrier, the product; the next product writes the
// other buffer, which nobody reads after this barrier. The slots are
// computed here, not held in registers across the chunk.
template <int MODE, int RPT>
__device__ __forceinline__ void product(const double* __restrict__ M,
                                        double* __restrict__ bufs, int& cur,
                                        int other, const int (&koff)[RPT],
                                        const float (&v)[RPT], int n, int t,
                                        int G, int L, int b,
                                        float (&out)[RPT]) {
  double* w = bufs + cur;
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    Prec<MODE>::store(w + slot(t + k * G, L, b), Prec<MODE>::entry(v[k]));
  __syncthreads();
  matvec<MODE, RPT>(M, w + 2 * b, koff, n, 2 * L, out);
  cur = other - cur;
}

// REFINE: refine_steps > 0 (without it the right-hand side dies after the
// first product, and tier 1's rows fit fewer registers); THREADS: the most
// threads a block may have; REGS: the registers a thread is held to, so
// that 65536 / (THREADS REGS) such blocks fit an SM; MODE: the precision.
template <int RPT, bool REFINE, int THREADS, int REGS, int MODE>
__global__ void __launch_bounds__(THREADS, 65536 / (THREADS * REGS))
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
                       float sigma, float alpha, Layout lay) {
  extern __shared__ __align__(16) double smem[];
  const int L = blockDim.x;
  const int G = blockDim.y;
  const int sk = lay.sk;
  double* ki_sh = smem;
  double* k_sh = smem + R * sk;  // present only when refining
  double* bufs = smem + (REFINE ? 2 : 1) * R * sk;
  const int other = lay.nslots * L;  // doubles from one buffer to the next

  const int b = threadIdx.x;
  const int t = threadIdx.y;
  const int tid = t * L + b;
  const int nthreads = L * G;
  const int lane = blockIdx.x * L + b;
  const bool live = lane < B;
  const int lc = live ? lane : B - 1;  // lanes past B run on lane B-1's data

  stage_operators<MODE>(ki_sh, k_sh, kinv, REFINE ? kmat : nullptr, R, n, lay.ld, sk,
                        tid, nthreads);

  const int r = idx[lc];
  const float* rho_r = rho_vecs + r * n;
  const float* rhoi_r = rho_invs + r * n;

  // rows i = t + k G; a padded row reads the last real row and owns a
  // buffer slot past the real ones
  float x[RPT], qv[RPT], d[RPT], s[RPT], y[RPT], ax[RPT], rho[RPT], rhoi[RPT];
  float lv[RPT], uv[RPT];
  int koff[RPT];  // the row of K_r^-1 and K_r
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int i = t + k * G;
    const int ic = i < n ? i : n - 1;
    const int g = ic * B + lc;  // (row, lane) in the (n, B) arrays
    koff[k] = r * sk + ic * lay.ld;
    x[k] = x_in[g];
    qv[k] = q[g];
    d[k] = dvec[ic];
    s[k] = s_in[g];
    y[k] = y_in[g];
    ax[k] = ax_in[g];
    lv[k] = l[g];
    uv[k] = u[g];
    rho[k] = rho_r[ic];
    rhoi[k] = rhoi_r[ic];
  }
  __syncthreads();

  int cur = 0;  // the buffer the next product writes: 0 or `other`
  const float beta = 1.0f - alpha;
  for (int it = 0; it < chunk; ++it) {
    float rhs[RPT], xt[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      rhs[k] = sigma * x[k] - qv[k] - d[k] * y[k] + d[k] * (rho[k] * s[k]);
    product<MODE, RPT>(ki_sh, bufs, cur, other, koff, rhs, n, t, G, L, b, xt);
    for (int step = 0; REFINE && step < refine_steps; ++step) {
      float tmp[RPT], res[RPT];
      product<MODE, RPT>(k_sh, bufs, cur, other, koff, xt, n, t, G, L, b, tmp);
#pragma unroll
      for (int k = 0; k < RPT; ++k) res[k] = rhs[k] - tmp[k];
      product<MODE, RPT>(ki_sh, bufs, cur, other, koff, res, n, t, G, L, b, tmp);
#pragma unroll
      for (int k = 0; k < RPT; ++k) xt[k] += tmp[k];
    }
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

  if (!live) return;  // after the last barrier
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int i = t + k * G;
    if (i >= n) continue;
    const int g = i * B + lane;
    x_out[g] = x[k];
    s_out[g] = s[k];
    y_out[g] = y[k];
    ax_out[g] = ax[k];
  }
}

struct Args {
  const float *kinv, *kmat, *dvec, *rho_vecs, *rho_invs, *q, *l, *u;
  const int* idx;
  const float *x_in, *s_in, *y_in, *ax_in;
  float *x_out, *s_out, *y_out, *ax_out;
  int n, B, R, chunk, refine_steps;
  float sigma, alpha;
};

template <int RPT, bool REFINE, int THREADS, int REGS, int MODE>
cudaError_t launch(const Args& a, dim3 block, const Layout& lay, size_t smem,
                   cudaStream_t stream) {
  if (static_cast<int>(block.x * block.y) > THREADS) return cudaErrorInvalidValue;
  auto kernel = admm_diag_chunk_kernel<RPT, REFINE, THREADS, REGS, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + block.x - 1) / block.x);
  kernel<<<grid, block, smem, stream>>>(
      a.kinv, a.kmat, a.dvec, a.rho_vecs, a.rho_invs, a.q, a.l, a.u, a.idx,
      a.x_in, a.s_in, a.y_in, a.ax_in, a.x_out, a.s_out, a.y_out, a.ax_out,
      a.n, a.B, a.R, a.chunk, a.refine_steps, a.sigma, a.alpha, lay);
  return cudaGetLastError();
}

// the instantiated rows per thread, each with the most threads its block
// may have and the registers a thread is held to without and with
// refinement (none spills at "highest"; 5 rows without it fit 128, so
// that two 256-thread blocks share an SM at tier 1), the same budgets at
// every precision; ops/admm_fused.K1_INSTANCES plans only these
#define MPC_K1_INSTANCES(X)                                                \
  X(1, 512, 64, 64) X(2, 512, 128, 128) X(3, 512, 128, 128)              \
  X(4, 512, 128, 128) X(5, 256, 128, 255) X(6, 256, 255, 255)            \
  X(7, 256, 255, 255) X(8, 256, 255, 255)

// the instantiation of rows per thread `rpt` at precision MODE
template <int MODE>
int dispatch(const Args& a, dim3 block, const Layout& lay, size_t smem, cudaStream_t st,
             int rpt) {
#define MPC_K1_CASE(N, T, REGS, REGS_REFINE)                                     \
  case N:                                                                         \
    return static_cast<int>(                                                      \
        a.refine_steps > 0                                                        \
            ? launch<N, true, T, REGS_REFINE, MODE>(a, block, lay, smem, st)      \
            : launch<N, false, T, REGS, MODE>(a, block, lay, smem, st));
  switch (rpt) {
    MPC_K1_INSTANCES(MPC_K1_CASE)
  }
#undef MPC_K1_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launch `chunk` iterations on `stream` at precision `mode` (0 "highest",
// 1 "bf16x3", 2 "default"; ops/admm_fused.PRECISIONS). All arrays are
// float32 and contiguous on one device: kinv, kmat (R, n, n) (kmat unused
// when refine_steps == 0), dvec (n), rho_vecs, rho_invs (R, n), q, l, u,
// x_in, s_in, y_in, ax_in and the outputs (n, B); idx (B) int32 in [0, R).
// Takes n <= 128 and n B < 2^31. The layout comes from ops/admm_fused.k1_plan:
// lanes (4, 8, 16 or 32) and groups per block, rows per thread (rpt), and
// the dynamic shared memory they take, which must equal what the kernel's
// layout needs.
// Returns the cudaError_t of the launch (0 on success).
int admm_diag_chunk(const float* kinv, const float* kmat, const float* dvec,
                    const float* rho_vecs, const float* rho_invs,
                    const float* q, const float* l, const float* u,
                    const int* idx, const float* x_in, const float* s_in,
                    const float* y_in, const float* ax_in, float* x_out,
                    float* s_out, float* y_out, float* ax_out, int n, int B,
                    int R, int chunk, int refine_steps, int mode, int lanes,
                    int groups, int rpt, int smem_bytes, float sigma, float alpha,
                    void* stream) {
  if (n <= 0 || n > 128 || B <= 0 || R <= 0 || chunk < 0 || refine_steps < 0 ||
      static_cast<long long>(n) * B > INT_MAX ||
      (lanes != 4 && lanes != 8 && lanes != 16 && lanes != 32) ||
      groups <= 0 || lanes * groups > 512 || rpt * groups < n)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout lay;
  lay.ld = mpc_admm::row_stride(n, lanes);
  lay.sk = mpc_admm::copy_stride(n, lay.ld);
  lay.nslots = (groups * rpt + 1) & ~1;
  const size_t stacks = refine_steps > 0 ? 2 : 1;
  const size_t smem =
      (stacks * R * lay.sk + 2 * static_cast<size_t>(lay.nslots) * lanes) *
      sizeof(double);
  if (smem != static_cast<size_t>(smem_bytes) || smem > mpc_admm::kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{kinv, kmat, dvec, rho_vecs, rho_invs, q, l, u, idx,
               x_in, s_in, y_in, ax_in, x_out, s_out, y_out, ax_out,
               n, B, R, chunk, refine_steps, sigma, alpha};
  const dim3 block(lanes, groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case mpc_admm::kHighest:
      return dispatch<mpc_admm::kHighest>(a, block, lay, smem, st, rpt);
    case mpc_admm::kBf16x3:
      return dispatch<mpc_admm::kBf16x3>(a, block, lay, smem, st, rpt);
    case mpc_admm::kDefault:
      return dispatch<mpc_admm::kDefault>(a, block, lay, smem, st, rpt);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
