// The C entries of the Riccati path's kernels, and the small ones themselves:
// riccati_admm_chunk (K3, in riccati_chunk.cuh, which describes the design
// and the precision of all of them), riccati_rollout, riccati_certificate and
// riccati_chain_floor. K3's instantiations for the (4, 2) register tier are
// built here, those for (8, 4) in riccati_admm_t1.cu, and those for (16, 8)
// and (32, 16), the longest to compile, one route each in
// riccati_admm_t2r0.cu, _t2r1.cu, _t2r2.cu and riccati_admm_t3r0.cu, _t3r1.cu,
// _t3r2.cu.
//
// Bound to PyTorch by ctypes through plain C functions that return
// cudaGetLastError() after the launch (0 on success).

#include "riccati_chunk.cuh"

MPC_K3_TIER_ROUTE(0, 4, 2, 0)
MPC_K3_TIER_ROUTE(0, 4, 2, 1)
MPC_K3_TIER_ROUTE(0, 4, 2, 2)

namespace {

constexpr int kLanes = 32;  // the rollout: threads (= lanes) per block
// The rollout and the certificate read the fp32 plant itself: fully unrolled
// at (16, 8) they would hoist its 384 widened entries into registers and
// spill, so that tier and (32, 16) keep their predicated instantiation.
constexpr int kFullTierMax = 8;

template <int MX, int MU, bool FULL>
__global__ void __launch_bounds__(kLanes)
riccati_rollout_kernel(const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       const float* __restrict__ e0,
                       const float* __restrict__ U, float* __restrict__ X,
                       int N, int nx_, int nu_, int B) {
  const int nx = FULL ? MX : nx_, nu = FULL ? MU : nu_;
  const int b = blockIdx.x * kLanes + threadIdx.x;
  if (b >= B) return;  // no barriers below
  float e[MX];
#pragma unroll
  for (int i = 0; i < MX; ++i) {
    e[i] = i < nx ? e0[static_cast<size_t>(i) * B + b] : 0.0f;
    if (i < nx) X[static_cast<size_t>(i) * B + b] = e[i];
  }
  for (int k = 0; k < N; ++k) {
    float u[MU], ae[MX], bu[MX];
    double ed[MX], ud[MU];
#pragma unroll
    for (int i = 0; i < MU; ++i)
      u[i] = i < nu ? U[(static_cast<size_t>(k) * nu + i) * B + b] : 0.0f;
    widen(e, ed);
    widen(u, ud);
    mv<MX, MX>(A, nx, nx, nx, ed, ae);
    mv<MX, MU>(Bm, nu, nx, nu, ud, bu);
#pragma unroll
    for (int i = 0; i < MX; ++i) {
      e[i] = ae[i] + bu[i];
      if (i < nx) X[(static_cast<size_t>(k + 1) * nx + i) * B + b] = e[i];
    }
  }
}

// A block takes `lanes` lanes and walks the horizon in tiles of `tile` rows:
// all threads load a tile's dual deltas and Xbar rows into shared memory
// ([row][dim][lane], coalesced reads), then one thread per lane runs the
// tile's steps of the adjoint recursion and the row-ordered sums from there.
template <int MX, int MU, bool FULL>
__global__ void __launch_bounds__(kThreads)
riccati_certificate_kernel(
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ xlo, const float* __restrict__ xhi,
    const float* __restrict__ xNlo, const float* __restrict__ xNhi,
    const float* __restrict__ ulo, const float* __restrict__ uhi,
    const float* __restrict__ lamX_new, const float* __restrict__ lamX_old,
    const float* __restrict__ lamU_new, const float* __restrict__ lamU_old,
    const float* __restrict__ Xbar, const float* __restrict__ ballr,
    float* __restrict__ out, int N, int nx_, int nu_, int B,
    int split_interior, int split_terminal, int terminal_ball, int lanes,
    int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nx = FULL ? MX : nx_, nu = FULL ? MU : nu_;
  double* sA = reinterpret_cast<double*>(smem);  // A, B widened, padded
  double* sB = sA + MX * MX;
  float* sdx = reinterpret_cast<float*>(sB + MX * MU);        // (tile, nx, lanes)
  float* sxb = sdx + static_cast<size_t>(tile) * nx * lanes;  // (tile, nx, lanes)
  float* sdu = sxb + static_cast<size_t>(tile) * nx * lanes;  // (tile, nu, lanes)
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * lanes;
  const int live = min(lanes, B - b0);
  const bool active = tid < live;  // mask the work: barriers below
  const int b = b0 + tid;

  // the plant, widened once (the first tile's barrier publishes it)
  for (int idx = tid; idx < MX * MX; idx += blockDim.x) {
    const int i = idx / MX, j = idx - i * MX;
    sA[idx] = (i < nx && j < nx) ? static_cast<double>(A[i * nx + j]) : 0.0;
  }
  for (int idx = tid; idx < MX * MU; idx += blockDim.x) {
    const int i = idx / MU, j = idx - i * MU;
    sB[idx] = (i < nx && j < nu) ? static_cast<double>(Bm[i * nu + j]) : 0.0;
  }

  float ulo_r[MU], uhi_r[MU], xlo_r[MX], xhi_r[MX];  // the boxes the walk reads
#pragma unroll
  for (int i = 0; i < MU; ++i) {
    ulo_r[i] = i < nu ? ulo[i] : 0.0f;
    uhi_r[i] = i < nu ? uhi[i] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < MX; ++i) {
    xlo_r[i] = (split_interior && i < nx) ? xlo[i] : 0.0f;
    xhi_r[i] = (split_interior && i < nx) ? xhi[i] : 0.0f;
  }

  // the terminal row starts the adjoint recursion
  float g[MX];
  float dnorm = 0.0f, ortho = 0.0f;
  double s_u = 0.0, s_int = 0.0, s_term = 0.0, sq_term = 0.0, xbar = 0.0;
#pragma unroll
  for (int i = 0; i < MX; ++i) {
    g[i] = 0.0f;
    if (i >= nx || !active) continue;
    const size_t a = (static_cast<size_t>(N) * nx + i) * B + b;
    const float d = lamX_new[a] - lamX_old[a];
    g[i] = d;
    dnorm = nanmax(dnorm, fabsf(d));
    s_term += static_cast<double>(box_term(d, xNlo[i], xNhi[i]));
    sq_term = fma(static_cast<double>(d), static_cast<double>(d), sq_term);
    xbar = fma(static_cast<double>(d), static_cast<double>(Xbar[a]), xbar);
  }

  for (int khi = N; khi > 0; khi -= tile) {  // rows [klo, khi)
    const int klo = max(khi - tile, 0), rows = khi - klo;
    __syncthreads();  // the previous tile is consumed
#pragma unroll 4  // several loads in flight
    for (int idx = tid; idx < rows * nx * lanes; idx += blockDim.x) {
      const int ri = idx / lanes, l = idx - ri * lanes;
      if (l >= live) continue;
      const size_t a = (static_cast<size_t>(klo) * nx + ri) * B + b0 + l;
      sdx[idx] = lamX_new[a] - lamX_old[a];
      sxb[idx] = Xbar[a];
    }
#pragma unroll 4
    for (int idx = tid; idx < rows * nu * lanes; idx += blockDim.x) {
      const int ri = idx / lanes, l = idx - ri * lanes;
      if (l >= live) continue;
      const size_t a = (static_cast<size_t>(klo) * nu + ri) * B + b0 + l;
      sdu[idx] = lamU_new[a] - lamU_old[a];
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 2
    for (int k = khi - 1; k >= klo; --k) {
      const int kk = k - klo;
      float dlu[MU], dlx[MX], xb[MX], bg[MU], ag[MX];
      double gd[MX];
#pragma unroll
      for (int i = 0; i < MU; ++i)
        dlu[i] = i < nu ? sdu[(kk * nu + i) * lanes + tid] : 0.0f;
#pragma unroll
      for (int i = 0; i < MX; ++i) {
        dlx[i] = i < nx ? sdx[(kk * nx + i) * lanes + tid] : 0.0f;
        xb[i] = i < nx ? sxb[(kk * nx + i) * lanes + tid] : 0.0f;
      }
      widen(g, gd);
      mtv<MU, MX>(sB, MU, nu, nx, gd, bg);  // B' g
#pragma unroll
      for (int i = 0; i < MU; ++i) {
        if (i >= nu) continue;
        ortho = nanmax(ortho, fabsf(bg[i] + dlu[i]));
        dnorm = nanmax(dnorm, fabsf(dlu[i]));
        s_u += static_cast<double>(box_term(dlu[i], ulo_r[i], uhi_r[i]));
      }
      mtv<MX, MX>(sA, MX, nx, nx, gd, ag);  // A' g
#pragma unroll
      for (int i = 0; i < MX; ++i) {
        g[i] = ag[i] + dlx[i];
        if (i >= nx) continue;
        dnorm = nanmax(dnorm, fabsf(dlx[i]));
        if (split_interior && k >= 1)
          s_int += static_cast<double>(box_term(dlx[i], xlo_r[i], xhi_r[i]));
        xbar = fma(static_cast<double>(dlx[i]), static_cast<double>(xb[i]), xbar);
      }
    }
  }
  if (!active) return;  // no barrier follows
  float s_c = static_cast<float>(s_u);
  if (split_interior) s_c = s_c + static_cast<float>(s_int);
  if (terminal_ball)
    s_c = s_c + ballr[b] * sqrtf(static_cast<float>(sq_term));
  else if (split_terminal)
    s_c = s_c + static_cast<float>(s_term);
  out[b] = ortho;
  out[B + b] = s_c - static_cast<float>(xbar);
  out[2 * static_cast<size_t>(B) + b] = dnorm;
}

// The dependent instructions of K3's two horizon loops, from registers: per
// sweep step a widening, nx chained fp64 multiply-adds, the rounding and an
// fp32 subtraction; per rollout step the same for K e, then the negation and
// subtraction that form u, its widening, nu chained multiply-adds for B u,
// the rounding and the addition. One warp, `steps` steps of each.
__global__ void __launch_bounds__(32)
riccati_chain_floor_kernel(float* __restrict__ io, int steps, int nx, int nu) {
  const double m = static_cast<double>(io[32]);  // 0.5: the values stay bounded
  const float c = io[33];
  float g = io[threadIdx.x], e = g;
  for (int s = 0; s < steps; ++s) {
    {
      const double d = static_cast<double>(g);
      double acc = m * d;
      for (int j = 1; j < nx; ++j) acc = fma(m, d, acc);
      g = static_cast<float>(acc) - c;
    }
    {
      const double d = static_cast<double>(e);
      double acc = m * d;
      for (int j = 1; j < nx; ++j) acc = fma(m, d, acc);
      const float u = -static_cast<float>(acc) - c;
      const double ud = static_cast<double>(u);
      double acc2 = m * ud;
      for (int j = 1; j < nu; ++j) acc2 = fma(m, ud, acc2);
      e = c + static_cast<float>(acc2);
    }
  }
  io[threadIdx.x] = g + e;
}

// the smallest register tier (MX, MU) that holds (nx, nu), or -1
int tier(int nx, int nu) {
  if (nx <= 0 || nu <= 0) return -1;
  if (nx <= 4 && nu <= 2) return 0;
  if (nx <= 8 && nu <= 4) return 1;
  if (nx <= 16 && nu <= 8) return 2;
  if (nx <= 32 && nu <= 16) return 3;
  return -1;
}

dim3 grid_for(int B) { return dim3((B + kLanes - 1) / kLanes); }

// the unpredicated instantiation where the plant fills a tier that has one
template <int MX, int MU>
auto rollout_kernel(int nx, int nu) {
  if constexpr (MX <= kFullTierMax)
    if (nx == MX && nu == MU) return riccati_rollout_kernel<MX, MU, true>;
  return riccati_rollout_kernel<MX, MU, false>;
}

template <int MX, int MU>
auto certificate_kernel(int nx, int nu) {
  if constexpr (MX <= kFullTierMax)
    if (nx == MX && nu == MU) return riccati_certificate_kernel<MX, MU, true>;
  return riccati_certificate_kernel<MX, MU, false>;
}

}  // namespace

#define MPC_K3_TIERS(LAUNCH)  \
  switch (tier(nx, nu)) {     \
    case 0:                   \
      LAUNCH(4, 2);           \
      break;                  \
    case 1:                   \
      LAUNCH(8, 4);           \
      break;                  \
    case 2:                   \
      LAUNCH(16, 8);          \
      break;                  \
    case 3:                   \
      LAUNCH(32, 16);         \
      break;                  \
    default:                  \
      return static_cast<int>(cudaErrorInvalidValue); \
  }                           \
  return static_cast<int>(cudaGetLastError());

extern "C" {

// Launch `chunk` (>= 1) iterations on `stream`. All arrays are float32 and
// contiguous on one device: Kf (R, N, nu, nx), Gf (R, N, nu, nu), AmBKf
// (R, N, nx, nx), A (nx, nx), Bm (nx, nu), the boxes xlo, xhi, xNlo, xNhi
// (nx) and ulo, uhi (nu), rho_tab (4, R); ridx (1) int32 in [0, R); e0
// (nx, B), ballr (B); vX_in, lamX_in and the outputs X, vX, lamX
// (N+1, nx, B); vU_in, lamU_in and the outputs U, vU, lamU (N, nu, B); ffs
// (N, nu, B) scratch when the rows are not shared (unused otherwise).
// The route comes from the host's plan (ops/riccati_fused.k3_plan): `lanes`
// lanes per block (1..128), rows_shared (the lanes' rows in shared memory,
// else in the outputs), fac_mode (0 fp64 factors in shared memory, 1 fp32
// in shared memory, 2 fp32 from device memory) and the dynamic shared
// memory they take, which must equal what the kernel's layout needs.
// Returns the cudaError_t of the launch (0 on success).
int riccati_admm_chunk(const float* Kf, const float* Gf, const float* AmBKf,
                       const float* A, const float* Bm, const float* xlo,
                       const float* xhi, const float* xNlo, const float* xNhi,
                       const float* ulo, const float* uhi,
                       const float* rho_tab, const int* ridx, const float* e0,
                       const float* ballr, const float* vX_in,
                       const float* vU_in, const float* lamX_in,
                       const float* lamU_in, float* X, float* U, float* vX,
                       float* vU, float* lamX, float* lamU, float* ffs, int N,
                       int nx, int nu, int B, int R, int chunk,
                       int split_interior, int split_terminal,
                       int terminal_ball, int lanes, int rows_shared,
                       int fac_mode, int smem_bytes, void* stream) {
  if (N <= 0 || B <= 0 || R <= 0 || chunk <= 0 || lanes <= 0 || lanes > kThreads ||
      smem_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ChunkArgs p;
  p.Kf = Kf, p.Gf = Gf, p.AmBKf = AmBKf, p.A = A, p.Bm = Bm;
  p.xlo = xlo, p.xhi = xhi, p.xNlo = xNlo, p.xNhi = xNhi, p.ulo = ulo, p.uhi = uhi;
  p.rho_tab = rho_tab, p.ridx = ridx, p.e0 = e0, p.ballr = ballr;
  p.vX_in = vX_in, p.vU_in = vU_in, p.lamX_in = lamX_in, p.lamU_in = lamU_in;
  p.X = X, p.U = U, p.vX = vX, p.vU = vU, p.lamX = lamX, p.lamU = lamU, p.ffs = ffs;
  p.N = N, p.nx = nx, p.nu = nu, p.B = B, p.R = R, p.chunk = chunk;
  p.split_interior = split_interior, p.split_terminal = split_terminal;
  p.terminal_ball = terminal_ball, p.lanes = lanes, p.fac_shared = 0;
  if (fac_mode < 0 || fac_mode > 2 || (!rows_shared && fac_mode != 2) || tier(nx, nu) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.fac_shared = fac_mode == 1;
  const int route = rows_shared ? (fac_mode == 0 ? 0 : 1) : 2;
  const size_t bytes = static_cast<size_t>(smem_bytes);
#define MPC_K3_CASE(TIER, ROUTE) \
  case 3 * TIER + ROUTE:         \
    return static_cast<int>(mpc_k3::launch_tier<TIER, ROUTE>(p, bytes, st));
  switch (3 * tier(nx, nu) + route) {
    MPC_K3_CASE(0, 0) MPC_K3_CASE(0, 1) MPC_K3_CASE(0, 2)
    MPC_K3_CASE(1, 0) MPC_K3_CASE(1, 1) MPC_K3_CASE(1, 2)
    MPC_K3_CASE(2, 0) MPC_K3_CASE(2, 1) MPC_K3_CASE(2, 2)
    MPC_K3_CASE(3, 0) MPC_K3_CASE(3, 1) MPC_K3_CASE(3, 2)
  }
#undef MPC_K3_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// X (N+1, nx, B) from e0 (nx, B) and U (N, nu, B); A (nx, nx), Bm (nx, nu).
int riccati_rollout(const float* A, const float* Bm, const float* e0,
                    const float* U, float* X, int N, int nx, int nu, int B,
                    void* stream) {
  if (N <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MPC_K3_ROLLOUT(MX, MU)                                          \
  rollout_kernel<MX, MU>(nx, nu)<<<grid_for(B), kLanes, 0, st>>>(       \
      A, Bm, e0, U, X, N, nx, nu, B)
  MPC_K3_TIERS(MPC_K3_ROLLOUT)
#undef MPC_K3_ROLLOUT
}

// out (3, B): max_k |B' g_{k+1} + dlamU_k|, the support value and
// max |dlam| of each lane, from lamX_new/old, Xbar (N+1, nx, B), lamU_new/
// old (N, nu, B), ballr (B) and the boxes as in riccati_admm_chunk. A block
// takes `lanes` lanes (1..128) and stages `tile` (>= 1) horizon rows at a
// time: 4 tile lanes (2 nx + nu) bytes of shared memory beside the widened
// plant (8 MX (MX + MU) bytes at the register tier).
int riccati_certificate(const float* A, const float* Bm, const float* xlo,
                        const float* xhi, const float* xNlo,
                        const float* xNhi, const float* ulo, const float* uhi,
                        const float* lamX_new, const float* lamX_old,
                        const float* lamU_new, const float* lamU_old,
                        const float* Xbar, const float* ballr, float* out,
                        int N, int nx, int nu, int B, int split_interior,
                        int split_terminal, int terminal_ball, int lanes,
                        int tile, void* stream) {
  if (N <= 0 || B <= 0 || lanes <= 0 || lanes > kThreads || tile <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t tile_bytes =
      sizeof(float) * static_cast<size_t>(tile) * lanes * (2 * nx + nu);
  const int blocks = (B + lanes - 1) / lanes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MPC_K3_CERT(MX, MU)                                                   \
  {                                                                           \
    const size_t smem_bytes = sizeof(double) * MX * (MX + MU) + tile_bytes;   \
    if (smem_bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue); \
    auto kernel = certificate_kernel<MX, MU>(nx, nu);                         \
    const cudaError_t err = cudaFuncSetAttribute(                             \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,                  \
        static_cast<int>(smem_bytes));                                        \
    if (err != cudaSuccess) return static_cast<int>(err);                     \
    kernel<<<blocks, kThreads, smem_bytes, st>>>(                             \
        A, Bm, xlo, xhi, xNlo, xNhi, ulo, uhi, lamX_new, lamX_old, lamU_new,  \
        lamU_old, Xbar, ballr, out, N, nx, nu, B, split_interior,             \
        split_terminal, terminal_ball, lanes, tile);                          \
  }
  MPC_K3_TIERS(MPC_K3_CERT)
#undef MPC_K3_CERT
}

// One warp runs N x chunk sweep steps and as many rollout steps of K3's
// dependent instructions from registers (no memory in the loop). io (34)
// float32: 32 starting values, then the multiplier (0.5) and the offset.
int riccati_chain_floor(float* io, int N, int nx, int nu, int chunk,
                        void* stream) {
  if (N <= 0 || nx <= 0 || nu <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  riccati_chain_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      io, N * chunk, nx, nu);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#undef MPC_K3_TIERS
