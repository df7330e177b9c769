// K4 on Hopper: `chunk` ADMM iterations of a batch of QPs whose scaled
// constraint matrix A (m, n) is dense: its rows are not box-first, so
// neither K1 (diagonal A) nor K2 (A = [diag(d); A2]) takes it.
//
// Replaces _iterate_kernel, the lane-packed body of ops/admm_pallas.py's
// dense pallas_call (driven by _iterate_chunk). The JAX package picks it or
// the per-rho body K5 by its cost model (_use_packed, ported as
// admm_fused.use_packed); the two round differently, so each is its own
// kernel here (K5: csrc/admm_perr.cu). Per lane b and iteration, with r the
// lane's rho-grid index:
//
//   A'y     = sum_i y_i A_i.;   A'rho.s = sum_i s_i fl(rho_r,i A_i.)
//   rhs     = sigma x - q - A'y + A'rho.s
//   xt      = rhs K_r^-1                       (row vector times matrix)
//   st      = rhs (K_r^-1 A')                  (the image from the packed
//                                               operator kia, built once)
//   refine_steps times: res = rhs - xt K_r;  xt += res K_r^-1;
//                       st += res (K_r^-1 A')
//   x = alpha xt + (1-alpha) x;  v = alpha st + (1-alpha) s
//   s = clip(v + rho^-1 y, l, u);  y += rho (v - s);  ax = alpha st + (1-alpha) ax
//
// What bounds it on this card: the fp64 multiply-adds of the matrix-vector
// products and the reads of their operator entries. A lane does 3 m n + n^2
// + refine (2 n^2 + n m) multiply-adds per iteration (the A'y, A'rho.s
// pass, the K^-1 solve and its image, the refinement), against 3 n + 7 m
// floats moved per chunk; plus 2 + 2 refine barriers per iteration. Each
// multiply-add also widens its fp32 operator entry to fp64.
//
// Precision, as in K1 and K2: the state is fp32, every matrix-vector product
// is accumulated in fp64 from exact fp32 products, in index order, and
// rounded once to fp32; the plain version (admm_fused.iterate_chunk_dense_
// packed_T_plain) sums in the same order, so the two agree bit for bit.
// fl(rho_r,i A_ij) is one fp32 product, as in the JAX package's sacat.
// Built with --fmad=false so the elementwise updates round like PyTorch's.
//
// Design:
// - Layout stays lane-last: x, q (n, B); s, y, ax, l, u (m, B), row-major, so
//   neighbouring threads own neighbouring lanes and every global access is
//   coalesced.
// - A block covers 32 lanes x 16 row-groups (512 threads). Thread (b, t)
//   owns rows t, t+16, ... of lane b, both of the n variable rows and of the
//   m constraint rows, and works through them in tiles of 4 rows, so the
//   registers do not grow with n or m. The lane's state lives in the output
//   arrays (copied from the input at the start: out of place, as in K1/K2),
//   read and written by the thread that owns each row; at these widths it
//   stays in L1/L2.
// - Vectors that every row-group reads (y, s, rhs, xt, the refinement
//   residual) go through lane-last fp32 shared buffers, 2 m + 3 n rows of 32
//   lanes; the image st reuses y's buffer once A'y is formed.
// - The operators: fp32 K^-1 (R, n, n), K when refining, K^-1 A' (R, n, m)
//   and A (m, n). They are copied into shared memory when they fit beside
//   the buffers (at the main path's shapes), the R copies at an odd stride
//   so that lanes of one warp at different r hit different banks; otherwise
//   they are read from global memory through L1/L2. One generic pointer
//   serves both. fp32 widened on read gives the same bits as an fp64 copy
//   and takes half the space.
// - Each lane applies only its own K_r^-1: the TPU kernels' "all R
//   candidates, then mask-select" was a gather workaround.
// - Lanes past B compute on zeros, touch no global state and reach every
//   barrier. One block per SM (shared memory), so B = 2048 fills 64 of 132.
//
// Bound to PyTorch by ctypes through the plain C function
// admm_dense_packed_chunk, which returns cudaGetLastError() after the
// launch (0 on success).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLanes = 32;   // lanes per block (blockDim.x)
constexpr int kGroups = 16;  // row-groups per block (blockDim.y)
constexpr int kThreads = kLanes * kGroups;
constexpr int kTile = 4;     // rows a thread accumulates at once

// jnp.clip / torch.clamp semantics: a NaN passes through, l = -inf clips
// nothing from below.
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// The rows of one tile of thread t: t + (k0 + k) * 16 for k < kTile; rows
// past `rows` are clamped to a valid one and not owned.
struct Tile {
  int row[kTile];
  bool own[kTile];
  __device__ Tile(int t, int k0, int rows) {
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const int i = t + (k0 + k) * kGroups;
      own[k] = i < rows;
      row[k] = own[k] ? i : rows - 1;
    }
  }
};

// acc[k] = sum_{j < len} M[row_k * rs + j * cs] v[j, b]: exact fp32 products
// summed in fp64 in index order j = 0, 1, ...
__device__ __forceinline__ void tile_dot(const float* M, int rs, int cs,
                                         const Tile& tile,
                                         const float* __restrict__ v, int len,
                                         int b, double (&acc)[kTile]) {
#pragma unroll
  for (int k = 0; k < kTile; ++k) acc[k] = 0.0;
  for (int j = 0; j < len; ++j) {
    const double vj = v[j * kLanes + b];
#pragma unroll
    for (int k = 0; k < kTile; ++k)
      acc[k] = fma(static_cast<double>(M[tile.row[k] * rs + j * cs]), vj, acc[k]);
  }
}

struct Args {
  const float *kinv, *kmat, *kia, *a, *rho_vecs, *rho_invs, *q, *l, *u;
  const int* idx;
  const float *x_in, *s_in, *y_in, *ax_in;
  float *x_out, *s_out, *y_out, *ax_out;
  int n, m, B, R, chunk, refine_steps;
  float sigma, alpha;
  int ops_shared;  // 1: copy the operators into shared memory
};

// Words of each R-stack in shared memory: odd, so that the same entry of
// two rho copies lies in two banks.
__host__ __device__ inline int odd_stride(int words) { return words | 1; }

__device__ __forceinline__ void dense_chunk(const Args& p) {
  extern __shared__ float smem[];
  const int n = p.n, m = p.m, R = p.R;
  float* rho_sh = smem;  // (R, m)
  float* rhoi_sh = rho_sh + R * m;
  float* vy = rhoi_sh + R * m;  // (m, 32): y, then the image st
  float* vs = vy + m * kLanes;  // (m, 32): s
  float* vrhs = vs + m * kLanes;  // (n, 32)
  float* vxt = vrhs + n * kLanes;  // (n, 32)
  float* vres = vxt + n * kLanes;  // (n, 32)
  float* ops_sh = vres + n * kLanes;

  const int b = threadIdx.x;
  const int t = threadIdx.y;
  const int tid = t * kLanes + b;
  const int lane = blockIdx.x * kLanes + b;
  const bool live = lane < p.B;
  const int nn = n * n;
  const int refine = p.refine_steps;

  for (int i = tid; i < R * m; i += kThreads) {
    rho_sh[i] = p.rho_vecs[i];
    rhoi_sh[i] = p.rho_invs[i];
  }
  // the operators: shared copies at odd R-strides, or global memory
  const float *kinv = p.kinv, *kmat = p.kmat, *kia = p.kia, *amat = p.a;
  int kst = nn, ast = n * m;
  if (p.ops_shared) {
    kst = odd_stride(nn);
    float* dst = ops_sh;
    for (int i = tid; i < R * nn; i += kThreads)
      dst[(i / nn) * kst + i % nn] = p.kinv[i];
    kinv = dst;
    dst += R * kst;
    if (refine > 0) {
      for (int i = tid; i < R * nn; i += kThreads)
        dst[(i / nn) * kst + i % nn] = p.kmat[i];
      kmat = dst;
      dst += R * kst;
    }
    const int nm = n * m;
    ast = odd_stride(nm);
    for (int i = tid; i < R * nm; i += kThreads)
      dst[(i / nm) * ast + i % nm] = p.kia[i];
    kia = dst;
    dst += R * ast;
    for (int i = tid; i < m * n; i += kThreads) dst[i] = p.a[i];
    amat = dst;
  }

  const int r = live ? p.idx[lane] : 0;
  const float* ki_r = kinv + r * kst;
  const float* k_r = kmat + r * kst;
  const float* kia_r = kia + r * ast;
  const float* rho_r = rho_sh + r * m;
  const float* rhoi_r = rhoi_sh + r * m;
  const size_t B = p.B;

  // the state out of place: each thread copies the rows it owns
  if (live) {
    for (int i = t; i < n; i += kGroups) p.x_out[i * B + lane] = p.x_in[i * B + lane];
    for (int i = t; i < m; i += kGroups) {
      const size_t g = i * B + lane;
      p.s_out[g] = p.s_in[g];
      p.y_out[g] = p.y_in[g];
      p.ax_out[g] = p.ax_in[g];
    }
  }
  __syncthreads();

  const float alpha = p.alpha, beta = 1.0f - alpha, sigma = p.sigma;
  // one relaxation / clip / dual update of constraint row i
  auto update = [&](float stv, int i) {
    if (!live) return;
    const size_t g = i * B + lane;
    const float s = p.s_out[g], y = p.y_out[g];
    const float v = alpha * stv + beta * s;
    const float s_new = clip(v + rhoi_r[i] * y, p.l[g], p.u[g]);
    p.y_out[g] = y + rho_r[i] * (v - s_new);
    p.ax_out[g] = alpha * stv + beta * p.ax_out[g];
    p.s_out[g] = s_new;
  };

  for (int it = 0; it < p.chunk; ++it) {
    for (int i = t; i < m; i += kGroups) {
      const size_t g = i * B + lane;
      vy[i * kLanes + b] = live ? p.y_out[g] : 0.0f;
      vs[i * kLanes + b] = live ? p.s_out[g] : 0.0f;
    }
    __syncthreads();
    // A'y and A'rho.s in one pass over the constraint rows; then rhs
    for (int k0 = 0; k0 * kGroups < n; k0 += kTile) {
      const Tile tile(t, k0, n);
      double acc_y[kTile], acc_s[kTile];
#pragma unroll
      for (int k = 0; k < kTile; ++k) acc_y[k] = acc_s[k] = 0.0;
      for (int i = 0; i < m; ++i) {
        const double y_i = vy[i * kLanes + b];
        const double s_i = vs[i * kLanes + b];
        const float rho_i = rho_r[i];
#pragma unroll
        for (int k = 0; k < kTile; ++k) {
          const float a = amat[i * n + tile.row[k]];
          acc_y[k] = fma(static_cast<double>(a), y_i, acc_y[k]);
          acc_s[k] = fma(static_cast<double>(rho_i * a), s_i, acc_s[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        if (!tile.own[k]) continue;
        const int j = tile.row[k];
        const size_t g = j * B + lane;
        const float x = live ? p.x_out[g] : 0.0f;
        const float q = live ? p.q[g] : 0.0f;
        vrhs[j * kLanes + b] = sigma * x - q - static_cast<float>(acc_y[k]) +
                               static_cast<float>(acc_s[k]);
      }
    }
    __syncthreads();
    // xt = rhs K_r^-1 (column j of K_r^-1 for row j); st = rhs kia_r
    for (int k0 = 0; k0 * kGroups < n; k0 += kTile) {
      const Tile tile(t, k0, n);
      double acc[kTile];
      tile_dot(ki_r, 1, n, tile, vrhs, n, b, acc);
#pragma unroll
      for (int k = 0; k < kTile; ++k)
        if (tile.own[k]) vxt[tile.row[k] * kLanes + b] = static_cast<float>(acc[k]);
    }
    for (int k0 = 0; k0 * kGroups < m; k0 += kTile) {
      const Tile tile(t, k0, m);
      double acc[kTile];
      tile_dot(kia_r, 1, m, tile, vrhs, n, b, acc);
#pragma unroll
      for (int k = 0; k < kTile; ++k)
        if (tile.own[k]) vy[tile.row[k] * kLanes + b] = static_cast<float>(acc[k]);
    }
    for (int step = 0; step < refine; ++step) {
      __syncthreads();  // xt complete
      for (int k0 = 0; k0 * kGroups < n; k0 += kTile) {
        const Tile tile(t, k0, n);
        double acc[kTile];
        tile_dot(k_r, 1, n, tile, vxt, n, b, acc);
#pragma unroll
        for (int k = 0; k < kTile; ++k) {
          if (!tile.own[k]) continue;
          const int j = tile.row[k] * kLanes + b;
          vres[j] = vrhs[j] - static_cast<float>(acc[k]);
        }
      }
      __syncthreads();  // the residual complete; every thread done reading xt
      for (int k0 = 0; k0 * kGroups < n; k0 += kTile) {
        const Tile tile(t, k0, n);
        double acc[kTile];
        tile_dot(ki_r, 1, n, tile, vres, n, b, acc);
#pragma unroll
        for (int k = 0; k < kTile; ++k) {
          if (!tile.own[k]) continue;
          const int j = tile.row[k] * kLanes + b;
          vxt[j] = vxt[j] + static_cast<float>(acc[k]);
        }
      }
      for (int k0 = 0; k0 * kGroups < m; k0 += kTile) {
        const Tile tile(t, k0, m);
        double acc[kTile];
        tile_dot(kia_r, 1, m, tile, vres, n, b, acc);
#pragma unroll
        for (int k = 0; k < kTile; ++k) {
          if (!tile.own[k]) continue;
          const int i = tile.row[k] * kLanes + b;
          vy[i] = vy[i] + static_cast<float>(acc[k]);
        }
      }
    }
    for (int i = t; i < m; i += kGroups) update(vy[i * kLanes + b], i);
    if (live)
      for (int j = t; j < n; j += kGroups) {
        const size_t g = j * B + lane;
        p.x_out[g] = alpha * vxt[j * kLanes + b] + beta * p.x_out[g];
      }
  }
}

__global__ void __launch_bounds__(kThreads, 1) admm_dense_packed_kernel(Args p) {
  dense_chunk(p);
}

// Bytes of dynamic shared memory: the rho tables and the vector buffers,
// plus the operators when they are copied in. ops/admm_fused.py counts the
// same (dense_smem_bytes, dense_ops_shared).
size_t buffer_bytes(int n, int m, int R) {
  return (2 * static_cast<size_t>(R) * m + (2 * static_cast<size_t>(m) + 3 * n) * kLanes) *
         sizeof(float);
}

size_t operator_bytes(int n, int m, int R, int refine_steps) {
  const size_t words = static_cast<size_t>(R) * odd_stride(n * n) * (refine_steps > 0 ? 2 : 1) +
                       static_cast<size_t>(m) * n + static_cast<size_t>(R) * odd_stride(n * m);
  return words * sizeof(float);
}

constexpr size_t kSmemLimit = 232448;  // what one block may use on Hopper

int launch(Args a, void* stream) {
  if (a.n <= 0 || a.m <= 0 || a.B <= 0 || a.R <= 0 || a.chunk < 0 || a.refine_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = buffer_bytes(a.n, a.m, a.R);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const size_t ops = operator_bytes(a.n, a.m, a.R, a.refine_steps);
  a.ops_shared = smem + ops <= kSmemLimit;
  if (a.ops_shared) smem += ops;
  auto kernel = admm_dense_packed_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kLanes, kGroups);
  const dim3 grid((a.B + kLanes - 1) / kLanes);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K4: launch `chunk` iterations on `stream`. All arrays are float32 and
// contiguous on one device: kinv, kmat (R, n, n) (kmat unused when
// refine_steps == 0), kia (R, n, m) = K_r^-1 A', a (m, n), rho_vecs, rho_invs
// (R, m), q, x_in, x_out (n, B); l, u, s_in, y_in, ax_in, s_out, y_out,
// ax_out (m, B); idx (B) int32 in [0, R). Returns the cudaError_t of the
// launch (0 on success; cudaErrorInvalidValue when the buffers of
// 2 m + 3 n rows exceed shared memory).
int admm_dense_packed_chunk(const float* kinv, const float* kmat,
                            const float* kia, const float* a,
                            const float* rho_vecs, const float* rho_invs,
                            const float* q, const float* l, const float* u,
                            const int* idx, const float* x_in,
                            const float* s_in, const float* y_in,
                            const float* ax_in, float* x_out, float* s_out,
                            float* y_out, float* ax_out, int n, int m, int B,
                            int R, int chunk, int refine_steps, float sigma,
                            float alpha, void* stream) {
  const Args p{kinv, kmat, kia, a, rho_vecs, rho_invs, q, l, u, idx,
               x_in, s_in, y_in, ax_in, x_out, s_out, y_out, ax_out,
               n, m, B, R, chunk, refine_steps, sigma, alpha, 0};
  return launch(p, stream);
}

}  // extern "C"
