// K3 on Hopper: `chunk` Riccati-ADMM iterations of a long-horizon sparse MPC
// batch, and the two per-lane O(N) recurrences of its driver.
//
// riccati_admm_chunk replaces ops/riccati_pallas.py::_kernel of the JAX
// package (driven by _run_chunk). Per lane b and iteration, with rho, 1/rho,
// rho_t = min(term_rho_scale rho, 1e3) and 1/rho_t of the batch's grid
// index r, and the factors K_k, G_k, (A - B K_k) of that rho:
//
//   backward:  g = split_terminal ? -rho_t vX_N + lamX_N : 0
//              for k = N-1 .. 0:
//                lu_k  = -rho vU_k + lamU_k
//                ffs_k = G_k (B' g + lu_k)
//                g     = (A - B K_k)' g - K_k' lu_k  [+ (-rho vX_k + lamX_k)
//                        when split_interior and k >= 1]
//   forward:   e = e0; for k = 0 .. N-1: u_k = -K_k e - ffs_k, e = A e + B u_k
//   project:   vU = clip(U + lamU/rho, u box), lamU += rho (U - vU); the
//              interior X rows likewise (split_interior); the terminal row
//              onto the ball of radius ballr at rho (terminal_ball) or its
//              box at rho_t (split_terminal); rows not split mirror X and
//              carry no dual, and row 0 is e0.
//
// riccati_rollout replaces the driver's lax.scan rollouts (riccati_pallas.py
// :352-354 and :379-382): X_0 = e0, X_{k+1} = A X_k + B U_k.
// riccati_certificate replaces the certificate's adjoint lax.scan and its
// support terms (riccati_pallas.py:384-422): per lane, from the dual deltas
// dlamX = lamX_new - lamX_old and dlamU likewise, the adjoint recursion
// g <- A' g + dlamX_k with residual r_k = B' g + dlamU_k, and returns
// max_k |r_k|, the support value S_C(dlam) - <dlamX, Xbar> and max |dlam|.
//
// What bounds it on this card: neither bytes nor operations. Each iteration
// is a chain of 2N dependent steps per lane (a step is a few products of
// length nx or nu), so K3 is bound by the latency of that chain: at h500 a
// lane does about 34,000 multiply-adds and moves about 60 KB per
// iteration, far below the card's rates per SM.
//
// Design:
// - One thread per lane, 32 lanes per block (one warp), so B = 1024 lanes
//   spread over 32 SMs and B = 4096 over all 132; more lanes per SM would
//   only queue behind the same chain.
// - The state stays lane-last in device memory, (rows, dims, B): each
//   thread walks its own lane and every load and store of a warp is
//   coalesced. The sweep's g and e stay in registers; ffs goes to a global
//   scratch (N, nu, B). The per-row projections run inside the forward
//   rollout, as each u_k and e_{k+1} is formed (the rows are disjoint, so
//   the order of the JAX kernel's three projection passes does not change
//   a bit), and X and U are stored only in the last iteration of the chunk
//   (no iteration reads them).
// - The whole (R, N, ...) factor stacks are passed with a device-resident
//   grid index, so the driver never reads the index on the host. The factor
//   reads are uniform across the warp (L1 broadcasts).
// - Out of place, since the driver keeps the pre-chunk state: the first
//   iteration reads the inputs, and the iterations then alternate between
//   the outputs and a scratch set of v and lam, so that no step reads a
//   buffer it writes and the last iteration writes the outputs. Rows that
//   are not split are never read; the last iteration mirrors X into them
//   and zeroes their dual.
// - Template arguments MX, MU bound nx, nu (register arrays); the C entry
//   picks the smallest of (4, 2), (8, 4), (16, 8) that holds the plant.
//
// Precision: the state is fp32; each product of length nx or nu sums exact
// fp32 products in fp64 in column order and is rounded once to fp32 (as K1
// and K2 do); the elementwise steps are fp32 in the JAX kernel's order. The
// file is built with --fmad=false, so nothing is contracted, and the plain
// versions (ops/riccati_fused.py) form the same sums in the same order:
// kernel and plain version agree bit for bit. The certificate's long sums
// (the support terms, <dlamX, Xbar>) run in fp64 in row order and are
// rounded once; the plain version sums them in another order.
//
// Bound to PyTorch by ctypes through plain C functions that return
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kLanes = 32;  // threads (= lanes) per block

// jnp.clip / torch.clamp semantics: a NaN passes through
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// max that propagates NaN, as jnp.max and torch.amax do
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// out[i] = sum_j M[i*rs + j*cs] v[j] for i < a, j < n: exact fp32 products
// summed in fp64 in order j = 0..n-1, rounded once to fp32
template <int MA, int MN>
__device__ __forceinline__ void dot64(const float* __restrict__ M, int rs,
                                      int cs, int a, int n,
                                      const float (&v)[MN], float (&out)[MA]) {
#pragma unroll
  for (int i = 0; i < MA; ++i) {
    out[i] = 0.0f;
    if (i < a) {
      double acc = static_cast<double>(M[i * rs]) * static_cast<double>(v[0]);
#pragma unroll
      for (int j = 1; j < MN; ++j)
        if (j < n)
          acc = fma(static_cast<double>(M[i * rs + j * cs]),
                    static_cast<double>(v[j]), acc);
      out[i] = static_cast<float>(acc);
    }
  }
}

// the support of a box at direction d: +inf rays only where d points
// along them
__device__ __forceinline__ float box_term(float d, float lo, float hi) {
  const float inf = INFINITY;
  const float pos = d > 0.0f ? (isfinite(hi) ? hi * d : inf) : 0.0f;
  const float neg = d < 0.0f ? (isfinite(lo) ? lo * d : inf) : 0.0f;
  return pos + neg;
}

// Lane b's element (row k, dim i) of a lane-last (rows, n, B) array.
__device__ __forceinline__ size_t at(int k, int i, int n, int B, int b) {
  return (static_cast<size_t>(k) * n + i) * B + b;
}

// The grid entry's factors and constants, and the boxes.
struct Operator {
  const float* K;     // (N, nu, nx)
  const float* G;     // (N, nu, nu)
  const float* AmBK;  // (N, nx, nx)
  const float *A, *Bm, *xlo, *xhi, *xNlo, *xNhi, *ulo, *uhi;
  float rho, rho_inv, rho_t, rho_t_inv;
  int N, nx, nu, B;
  bool split_interior, split_terminal, terminal_ball;
};

// One ADMM iteration of lane b: reads v and lam from the r-arrays, writes
// them to the w-arrays (distinct buffers, so the compiler may issue a
// step's loads ahead of the previous steps' stores). In the last iteration
// it also stores X and U, mirrors X into the rows of vX that are not split
// and zeroes their dual.
template <int MX, int MU>
__device__ __forceinline__ void iteration(
    const Operator& op, const float (&e0)[MX], float rad, int b, bool last,
    const float* __restrict__ vXr, const float* __restrict__ vUr,
    const float* __restrict__ lamXr, const float* __restrict__ lamUr,
    float* __restrict__ vXw, float* __restrict__ vUw,
    float* __restrict__ lamXw, float* __restrict__ lamUw,
    float* __restrict__ ffs, float* __restrict__ X, float* __restrict__ U) {
  const int N = op.N, nx = op.nx, nu = op.nu, B = op.B;
  const float rho = op.rho, rho_inv = op.rho_inv;

  // ---- w-update: backward affine sweep (fills ffs) ----
  float g[MX];
#pragma unroll
  for (int i = 0; i < MX; ++i)
    g[i] = (op.split_terminal && i < nx)
               ? -op.rho_t * vXr[at(N, i, nx, B, b)] + lamXr[at(N, i, nx, B, b)]
               : 0.0f;
#pragma unroll 4
  for (int k = N - 1; k >= 0; --k) {
    float lu[MU], bg[MU], t[MU], ff[MU], ag[MX], kl[MX];
#pragma unroll
    for (int i = 0; i < MU; ++i)
      lu[i] = i < nu ? -rho * vUr[at(k, i, nu, B, b)] + lamUr[at(k, i, nu, B, b)] : 0.0f;
    dot64<MU, MX>(op.Bm, 1, nu, nu, nx, g, bg);  // B' g
#pragma unroll
    for (int i = 0; i < MU; ++i) t[i] = bg[i] + lu[i];
    dot64<MU, MU>(op.G + static_cast<size_t>(k) * nu * nu, nu, 1, nu, nu, t, ff);
#pragma unroll
    for (int i = 0; i < MU; ++i)
      if (i < nu) ffs[at(k, i, nu, B, b)] = ff[i];
    dot64<MX, MX>(op.AmBK + static_cast<size_t>(k) * nx * nx, 1, nx, nx, nx, g, ag);
    dot64<MX, MU>(op.K + static_cast<size_t>(k) * nu * nx, 1, nx, nx, nu, lu, kl);
#pragma unroll
    for (int i = 0; i < MX; ++i) g[i] = ag[i] - kl[i];
    if (op.split_interior && k >= 1) {
#pragma unroll
      for (int i = 0; i < MX; ++i)
        if (i < nx)
          g[i] = g[i] + (-rho * vXr[at(k, i, nx, B, b)] + lamXr[at(k, i, nx, B, b)]);
    }
  }

  // ---- forward rollout, with each row's projection and dual ascent ----
  float e[MX];
#pragma unroll
  for (int i = 0; i < MX; ++i) e[i] = e0[i];
#pragma unroll 4
  for (int k = 0; k < N; ++k) {
    float ke[MU], u[MU], ae[MX], bu[MX];
    dot64<MU, MX>(op.K + static_cast<size_t>(k) * nu * nx, nx, 1, nu, nx, e, ke);
#pragma unroll
    for (int i = 0; i < MU; ++i) u[i] = i < nu ? -ke[i] - ffs[at(k, i, nu, B, b)] : 0.0f;
    dot64<MX, MX>(op.A, nx, 1, nx, nx, e, ae);
    dot64<MX, MU>(op.Bm, nu, 1, nx, nu, u, bu);
#pragma unroll
    for (int i = 0; i < MX; ++i) e[i] = ae[i] + bu[i];
#pragma unroll
    for (int i = 0; i < MU; ++i) {
      if (i >= nu) continue;
      const size_t a = at(k, i, nu, B, b);
      const float lam = lamUr[a];
      const float v = clip(u[i] + rho_inv * lam, op.ulo[i], op.uhi[i]);
      lamUw[a] = lam + rho * (u[i] - v);
      vUw[a] = v;
      if (last) U[a] = u[i];
    }
    if (k + 1 < N) {  // interior row k+1
#pragma unroll
      for (int i = 0; i < MX; ++i) {
        if (i >= nx) continue;
        const size_t a = at(k + 1, i, nx, B, b);
        if (op.split_interior) {
          const float lam = lamXr[a];
          const float v = clip(e[i] + rho_inv * lam, op.xlo[i], op.xhi[i]);
          lamXw[a] = lam + rho * (e[i] - v);
          vXw[a] = v;
        } else if (last) {
          vXw[a] = e[i];
          lamXw[a] = 0.0f;
        }
      }
    }
    if (last) {
#pragma unroll
      for (int i = 0; i < MX; ++i)
        if (i < nx) X[at(k + 1, i, nx, B, b)] = e[i];
    }
  }

  // ---- terminal row: the ball at rho, or the box at rho_t ----
  if (op.terminal_ball) {
    float w[MX];
#pragma unroll
    for (int i = 0; i < MX; ++i)
      w[i] = i < nx ? e[i] + rho_inv * lamXr[at(N, i, nx, B, b)] : 0.0f;
    double acc = static_cast<double>(w[0]) * static_cast<double>(w[0]);
#pragma unroll
    for (int i = 1; i < MX; ++i)
      if (i < nx) acc = fma(static_cast<double>(w[i]), static_cast<double>(w[i]), acc);
    const float nrm = sqrtf(static_cast<float>(acc));
    const float scale = nrm > rad ? rad / nanmax(nrm, 1e-30f) : 1.0f;
#pragma unroll
    for (int i = 0; i < MX; ++i) {
      if (i >= nx) continue;
      const size_t a = at(N, i, nx, B, b);
      const float v = w[i] * scale;
      lamXw[a] = lamXr[a] + rho * (e[i] - v);
      vXw[a] = v;
    }
  } else if (op.split_terminal) {
#pragma unroll
    for (int i = 0; i < MX; ++i) {
      if (i >= nx) continue;
      const size_t a = at(N, i, nx, B, b);
      const float lam = lamXr[a];
      const float v = clip(e[i] + op.rho_t_inv * lam, op.xNlo[i], op.xNhi[i]);
      lamXw[a] = lam + op.rho_t * (e[i] - v);
      vXw[a] = v;
    }
  } else if (last) {
#pragma unroll
    for (int i = 0; i < MX; ++i) {
      if (i >= nx) continue;
      vXw[at(N, i, nx, B, b)] = e[i];
      lamXw[at(N, i, nx, B, b)] = 0.0f;
    }
  }
}

template <int MX, int MU>
__global__ void __launch_bounds__(kLanes)
riccati_admm_chunk_kernel(
    const float* __restrict__ Kf, const float* __restrict__ Gf,
    const float* __restrict__ AmBKf, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ xlo,
    const float* __restrict__ xhi, const float* __restrict__ xNlo,
    const float* __restrict__ xNhi, const float* __restrict__ ulo,
    const float* __restrict__ uhi, const float* __restrict__ rho_tab,
    const int* __restrict__ ridx, const float* __restrict__ e0,
    const float* __restrict__ ballr, const float* __restrict__ vX_in,
    const float* __restrict__ vU_in, const float* __restrict__ lamX_in,
    const float* __restrict__ lamU_in, float* __restrict__ X,
    float* __restrict__ U, float* __restrict__ vX, float* __restrict__ vU,
    float* __restrict__ lamX, float* __restrict__ lamU,
    float* __restrict__ vX2, float* __restrict__ vU2,
    float* __restrict__ lamX2, float* __restrict__ lamU2,
    float* __restrict__ ffs, int N, int nx, int nu, int B, int R, int chunk,
    int split_interior, int split_terminal, int terminal_ball) {
  const int b = blockIdx.x * kLanes + threadIdx.x;
  if (b >= B) return;  // no barriers below
  const int r = ridx[0];
  Operator op;
  op.K = Kf + static_cast<size_t>(r) * N * nu * nx;
  op.G = Gf + static_cast<size_t>(r) * N * nu * nu;
  op.AmBK = AmBKf + static_cast<size_t>(r) * N * nx * nx;
  op.A = A;
  op.Bm = Bm;
  op.xlo = xlo;
  op.xhi = xhi;
  op.xNlo = xNlo;
  op.xNhi = xNhi;
  op.ulo = ulo;
  op.uhi = uhi;
  op.rho = rho_tab[r];
  op.rho_inv = rho_tab[R + r];
  op.rho_t = rho_tab[2 * R + r];
  op.rho_t_inv = rho_tab[3 * R + r];
  op.N = N;
  op.nx = nx;
  op.nu = nu;
  op.B = B;
  op.split_interior = split_interior != 0;
  op.split_terminal = split_terminal != 0;
  op.terminal_ball = terminal_ball != 0;

  float e0r[MX];
#pragma unroll
  for (int i = 0; i < MX; ++i) e0r[i] = i < nx ? e0[at(0, i, nx, B, b)] : 0.0f;
  const float rad = ballr[b];

  // iterations alternate between the outputs and the scratch set, so that
  // the last one writes the outputs; the first reads the inputs
  for (int it = 0; it < chunk; ++it) {
    const bool to_out = ((chunk - 1 - it) & 1) == 0;
    float *wX = to_out ? vX : vX2, *wU = to_out ? vU : vU2;
    float *wlX = to_out ? lamX : lamX2, *wlU = to_out ? lamU : lamU2;
    const float *rX = vX_in, *rU = vU_in, *rlX = lamX_in, *rlU = lamU_in;
    if (it > 0) {
      rX = to_out ? vX2 : vX;
      rU = to_out ? vU2 : vU;
      rlX = to_out ? lamX2 : lamX;
      rlU = to_out ? lamU2 : lamU;
    }
    iteration<MX, MU>(op, e0r, rad, b, it == chunk - 1, rX, rU, rlX, rlU, wX, wU,
                      wlX, wlU, ffs, X, U);
  }
  // row 0 is the fixed e_1: X = vX = e0, no dual
#pragma unroll
  for (int i = 0; i < MX; ++i) {
    if (i >= nx) continue;
    X[at(0, i, nx, B, b)] = e0r[i];
    vX[at(0, i, nx, B, b)] = e0r[i];
    lamX[at(0, i, nx, B, b)] = 0.0f;
  }
}

template <int MX, int MU>
__global__ void __launch_bounds__(kLanes)
riccati_rollout_kernel(const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       const float* __restrict__ e0,
                       const float* __restrict__ U, float* __restrict__ X,
                       int N, int nx, int nu, int B) {
  const int b = blockIdx.x * kLanes + threadIdx.x;
  if (b >= B) return;
  float e[MX];
#pragma unroll
  for (int i = 0; i < MX; ++i) {
    e[i] = i < nx ? e0[static_cast<size_t>(i) * B + b] : 0.0f;
    if (i < nx) X[static_cast<size_t>(i) * B + b] = e[i];
  }
  for (int k = 0; k < N; ++k) {
    float u[MU], ae[MX], bu[MX];
#pragma unroll
    for (int i = 0; i < MU; ++i)
      u[i] = i < nu ? U[(static_cast<size_t>(k) * nu + i) * B + b] : 0.0f;
    dot64<MX, MX>(A, nx, 1, nx, nx, e, ae);
    dot64<MX, MU>(Bm, nu, 1, nx, nu, u, bu);
#pragma unroll
    for (int i = 0; i < MX; ++i) {
      e[i] = ae[i] + bu[i];
      if (i < nx) X[(static_cast<size_t>(k + 1) * nx + i) * B + b] = e[i];
    }
  }
}

template <int MX, int MU>
__global__ void __launch_bounds__(kLanes)
riccati_certificate_kernel(
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ xlo, const float* __restrict__ xhi,
    const float* __restrict__ xNlo, const float* __restrict__ xNhi,
    const float* __restrict__ ulo, const float* __restrict__ uhi,
    const float* __restrict__ lamX_new, const float* __restrict__ lamX_old,
    const float* __restrict__ lamU_new, const float* __restrict__ lamU_old,
    const float* __restrict__ Xbar, const float* __restrict__ ballr,
    float* __restrict__ out, int N, int nx, int nu, int B,
    int split_interior, int split_terminal, int terminal_ball) {
  const int b = blockIdx.x * kLanes + threadIdx.x;
  if (b >= B) return;
  const auto xa = [=](int k, int i) {
    return (static_cast<size_t>(k) * nx + i) * B + b;
  };
  const auto ua = [=](int k, int i) {
    return (static_cast<size_t>(k) * nu + i) * B + b;
  };

  // the terminal row starts the adjoint recursion
  float g[MX];
  float dnorm = 0.0f;
  double s_u = 0.0, s_int = 0.0, s_term = 0.0, sq_term = 0.0, xbar = 0.0;
#pragma unroll
  for (int i = 0; i < MX; ++i) {
    g[i] = 0.0f;
    if (i >= nx) continue;
    const float d = lamX_new[xa(N, i)] - lamX_old[xa(N, i)];
    g[i] = d;
    dnorm = nanmax(dnorm, fabsf(d));
    s_term += static_cast<double>(box_term(d, xNlo[i], xNhi[i]));
    sq_term = fma(static_cast<double>(d), static_cast<double>(d), sq_term);
    xbar = fma(static_cast<double>(d), static_cast<double>(Xbar[xa(N, i)]), xbar);
  }
  float ortho = 0.0f;
  for (int k = N - 1; k >= 0; --k) {
    float dlu[MU], dlx[MX], bg[MU], ag[MX];
#pragma unroll
    for (int i = 0; i < MU; ++i)
      dlu[i] = i < nu ? lamU_new[ua(k, i)] - lamU_old[ua(k, i)] : 0.0f;
#pragma unroll
    for (int i = 0; i < MX; ++i)
      dlx[i] = i < nx ? lamX_new[xa(k, i)] - lamX_old[xa(k, i)] : 0.0f;
    dot64<MU, MX>(Bm, 1, nu, nu, nx, g, bg);  // B' g
#pragma unroll
    for (int i = 0; i < MU; ++i) {
      if (i >= nu) continue;
      ortho = nanmax(ortho, fabsf(bg[i] + dlu[i]));
      dnorm = nanmax(dnorm, fabsf(dlu[i]));
      s_u += static_cast<double>(box_term(dlu[i], ulo[i], uhi[i]));
    }
    dot64<MX, MX>(A, 1, nx, nx, nx, g, ag);  // A' g
#pragma unroll
    for (int i = 0; i < MX; ++i) {
      g[i] = ag[i] + dlx[i];
      if (i >= nx) continue;
      dnorm = nanmax(dnorm, fabsf(dlx[i]));
      if (split_interior && k >= 1)
        s_int += static_cast<double>(box_term(dlx[i], xlo[i], xhi[i]));
      xbar = fma(static_cast<double>(dlx[i]), static_cast<double>(Xbar[xa(k, i)]), xbar);
    }
  }
  float s_c = static_cast<float>(s_u);
  if (split_interior) s_c = s_c + static_cast<float>(s_int);
  if (terminal_ball)
    s_c = s_c + ballr[b] * sqrtf(static_cast<float>(sq_term));
  else if (split_terminal)
    s_c = s_c + static_cast<float>(s_term);
  out[b] = ortho;
  out[B + b] = s_c - static_cast<float>(xbar);
  out[2 * B + b] = dnorm;
}

// the smallest register tier (MX, MU) that holds (nx, nu), or -1
int tier(int nx, int nu) {
  if (nx <= 0 || nu <= 0) return -1;
  if (nx <= 4 && nu <= 2) return 0;
  if (nx <= 8 && nu <= 4) return 1;
  if (nx <= 16 && nu <= 8) return 2;
  return -1;
}

dim3 grid_for(int B) { return dim3((B + kLanes - 1) / kLanes); }

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
    default:                  \
      return static_cast<int>(cudaErrorInvalidValue); \
  }                           \
  return static_cast<int>(cudaGetLastError());

extern "C" {

// Launch `chunk` (>= 1) iterations on `stream`. All arrays are float32 and
// contiguous on one device: Kf (R, N, nu, nx), Gf (R, N, nu, nu), AmBKf
// (R, N, nx, nx), A (nx, nx), Bm (nx, nu), the boxes xlo, xhi, xNlo, xNhi
// (nx) and ulo, uhi (nu), rho_tab (4, R); ridx (1) int32 in [0, R); e0
// (nx, B), ballr (B); vX_in, lamX_in, the outputs X, vX, lamX and the
// scratch vX2, lamX2 (N+1, nx, B); vU_in, lamU_in, the outputs U, vU, lamU
// and the scratch vU2, lamU2, ffs (N, nu, B).
// Returns the cudaError_t of the launch (0 on success).
int riccati_admm_chunk(const float* Kf, const float* Gf, const float* AmBKf,
                       const float* A, const float* Bm, const float* xlo,
                       const float* xhi, const float* xNlo, const float* xNhi,
                       const float* ulo, const float* uhi,
                       const float* rho_tab, const int* ridx, const float* e0,
                       const float* ballr, const float* vX_in,
                       const float* vU_in, const float* lamX_in,
                       const float* lamU_in, float* X, float* U, float* vX,
                       float* vU, float* lamX, float* lamU, float* vX2,
                       float* vU2, float* lamX2, float* lamU2, float* ffs, int N,
                       int nx, int nu, int B, int R, int chunk,
                       int split_interior, int split_terminal,
                       int terminal_ball, void* stream) {
  if (N <= 0 || B <= 0 || R <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MPC_K3_CHUNK(MX, MU)                                                  \
  riccati_admm_chunk_kernel<MX, MU><<<grid_for(B), kLanes, 0, st>>>(          \
      Kf, Gf, AmBKf, A, Bm, xlo, xhi, xNlo, xNhi, ulo, uhi, rho_tab, ridx,    \
      e0, ballr, vX_in, vU_in, lamX_in, lamU_in, X, U, vX, vU, lamX, lamU,    \
      vX2, vU2, lamX2, lamU2, ffs, N, nx, nu, B, R, chunk, split_interior,     \
      split_terminal,                                                          \
      terminal_ball)
  MPC_K3_TIERS(MPC_K3_CHUNK)
#undef MPC_K3_CHUNK
}

// X (N+1, nx, B) from e0 (nx, B) and U (N, nu, B); A (nx, nx), Bm (nx, nu).
int riccati_rollout(const float* A, const float* Bm, const float* e0,
                    const float* U, float* X, int N, int nx, int nu, int B,
                    void* stream) {
  if (N <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MPC_K3_ROLLOUT(MX, MU)                                        \
  riccati_rollout_kernel<MX, MU><<<grid_for(B), kLanes, 0, st>>>(     \
      A, Bm, e0, U, X, N, nx, nu, B)
  MPC_K3_TIERS(MPC_K3_ROLLOUT)
#undef MPC_K3_ROLLOUT
}

// out (3, B): max_k |B' g_{k+1} + dlamU_k|, the support value and
// max |dlam| of each lane, from lamX_new/old, Xbar (N+1, nx, B), lamU_new/
// old (N, nu, B), ballr (B) and the boxes as in riccati_admm_chunk.
int riccati_certificate(const float* A, const float* Bm, const float* xlo,
                        const float* xhi, const float* xNlo,
                        const float* xNhi, const float* ulo, const float* uhi,
                        const float* lamX_new, const float* lamX_old,
                        const float* lamU_new, const float* lamU_old,
                        const float* Xbar, const float* ballr, float* out,
                        int N, int nx, int nu, int B, int split_interior,
                        int split_terminal, int terminal_ball, void* stream) {
  if (N <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MPC_K3_CERT(MX, MU)                                                  \
  riccati_certificate_kernel<MX, MU><<<grid_for(B), kLanes, 0, st>>>(        \
      A, Bm, xlo, xhi, xNlo, xNhi, ulo, uhi, lamX_new, lamX_old, lamU_new,   \
      lamU_old, Xbar, ballr, out, N, nx, nu, B, split_interior,              \
      split_terminal, terminal_ball)
  MPC_K3_TIERS(MPC_K3_CERT)
#undef MPC_K3_CERT
}

}  // extern "C"

#undef MPC_K3_TIERS
