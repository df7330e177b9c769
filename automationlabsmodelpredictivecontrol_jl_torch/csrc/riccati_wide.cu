// K3W's doubling form on Hopper: `chunk` Riccati-ADMM iterations of the
// per-lane engine for a plant of any width with the sweeps in doubling
// form; and the driver's two per-lane recurrences at any width. (K3W's
// sequential form is riccati_wide_seq.cu.)
//
// riccati_wide_chunk replaces, for RiccatiConfig.parallel_sweeps, the JAX
// package's XLA code in ops/riccati.py: solve_sparse's admm_iter
// (:619-659) with its w-update _lqr_affine_solve_pscan (:444-486). Per lane
// and iteration, with rho, 1/rho, rho_t, 1/rho_t of the launch's grid index
// r and the factors K_k, G_k, (A - B K_k) of that rho:
//
//   doubling:   b_k = lpre_k - K_k' lu_k, reversed; ceil(log2 N) combine
//               levels b[i] += bwd_levels[l][i] b[i - 2^l], then g = b +
//               bwd_full lin_xN; ffs_k = G_k (B' g_{k+1} + lu_k); the
//               forward recurrence e_{k+1} = (A - B K_k) e_k - B ffs_k the
//               same way with fwd_levels, fwd_full and e0; u_k = -K_k e_k -
//               ffs_k;
//
// then the projections and dual ascent of K3: vU = clip(U + lamU/rho),
// lamU += rho (U - vU); the interior X rows likewise (split_interior); the
// terminal row onto the ball (terminal_ball) at rho or its box at rho_t
// (split_terminal); rows not split mirror X and carry no dual; row 0 is e0.
// lin_xN = -rho_t vX_N + lamX_N where the terminal row is split (else 0),
// lpre_k = -rho vX_k + lamX_k where the interior is split and k >= 1.
//
// riccati_wide_rollout replaces rollout_warm (:562-570) and
// riccati_wide_certificate infeas_certificate's terms (:515-559), as K3's
// rollout and certificate kernels (riccati_admm.cu) do up to (32, 16).
//
// What bounds them on this card: neither bytes nor operations. The
// doubling form does ceil(log2 N) times the multiply-adds of the
// sequential one (each level reads one nx x nx matrix per horizon step, ~
// N nx^2) in 2 ceil(log2 N) dependent levels instead of 2N steps.
//
// Design (a simple kernel that is right first):
// - A block takes `lanes` lanes of one rho; `lane_threads` threads serve
//   each lane. The threads run over the (step, row) pairs of a level. A
//   barrier separates the phases: one per combine level and a few per
//   iteration. The plant's width is a runtime value and every loop is
//   rolled: no register tier per width.
// - A lane's scratch holds its split rows (vU, lamU and the split rows of
//   vX, lamX), e0, the terminal linear term and the iteration's buffers
//   (the linear terms and ffs, and two horizon buffers of nx rows, the
//   doubling levels' double buffer: a level reads the old b[i - s] while it
//   writes the new b[i]). It sits in shared memory where it fits beside the block's
//   other lanes (the host's plan, ops/riccati_fused.k3w_plan), else in a
//   scratch in device memory, with the same code and barriers.
// - The factors, the doubling levels and the plant are read as fp32 from
//   device memory through L1/L2, widened per product; a lane's threads read
//   neighbouring rows (coalesced across a level's rows).
// - Barriers: no thread returns early; a partial last block masks its work.
//
// Precision: the state is fp32; each product of length nx or nu sums exact
// fp32 products in fp64 in column order and is rounded once to fp32; the
// elementwise steps are fp32 in the plain version's order. Built with
// --fmad=false, the kernel agrees with its plain versions bit for bit
// (ops/riccati_fused.py: iterate_chunk_riccati_doubling_plain, whose
// summation order the kernel follows; riccati.rollout_warm;
// certificate_terms_plain, whose long fp64 sums the kernel forms in
// another order before the one rounding).
//
// Bound to PyTorch by ctypes through plain C functions that return
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr size_t kSmemLimit = 232448;
// the most threads of a block: the plan's lanes x lane_threads, and the
// rollout's and certificate's threads (K3W_LANE_THREADS,
// K3W_BLOCK_THREADS in ops/riccati_fused.py); the bound lets ptxas give a
// thread up to 255 registers
constexpr int kMaxThreads = 256;

// jnp.clip / torch.clamp semantics: a NaN passes through
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// max that propagates NaN, as torch.amax does
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// the support of a box at direction d: +inf rays only where d points along
// them
__device__ __forceinline__ float box_term(float d, float lo, float hi) {
  const float inf = INFINITY;
  const float pos = d > 0.0f ? (isfinite(hi) ? hi * d : inf) : 0.0f;
  const float neg = d < 0.0f ? (isfinite(lo) ? lo * d : inf) : 0.0f;
  return pos + neg;
}

// sum_j M[j * sj] v[j] for j < n (n >= 1): exact fp32 products summed in
// fp64 in order j = 0..n-1, rounded once. v may be scratch that the block
// writes (no read-only loads).
__device__ __forceinline__ float dot(const float* __restrict__ M, ptrdiff_t sj,
                                    const float* v, int n) {
  double acc = static_cast<double>(M[0]) * static_cast<double>(v[0]);
  for (int j = 1; j < n; ++j)
    acc = fma(static_cast<double>(M[j * sj]), static_cast<double>(v[j]), acc);
  return static_cast<float>(acc);
}

// The split rows of X: N when the interior is split, the terminal row alone
// when only it is, none otherwise.
__host__ __device__ inline int wide_split_x_rows(int N, int si, int st, int ball) {
  return si ? N : ((st || ball) ? 1 : 0);
}

// The floats of one lane's scratch (ops/riccati_fused.k3w_lane_floats):
// vU, lamU (N nu each), the split rows of vX and lamX, e0 and the terminal
// linear term (nx each); then the linear terms and ffs (N nu each) and two
// horizon buffers (N nx each); a multiple of 4.
__host__ __device__ inline size_t wide_lane_floats(int N, int nx, int nu, int xrows) {
  const size_t n = static_cast<size_t>(N), x = nx, u = nu;
  size_t f = 2 * n * u + 2 * static_cast<size_t>(xrows) * x + 2 * x;
  f += 2 * n * u + 2 * n * x;
  return (f + 3) / 4 * 4;
}

struct WideArgs {
  const float *Kf, *Gf, *Bm, *bwdL, *bwdF, *fwdL, *fwdF;
  const float *xlo, *xhi, *xNlo, *xNhi, *ulo, *uhi, *rho_tab;
  const int* ridx;
  const float *e0, *ballr, *vX_in, *vU_in, *lamX_in, *lamU_in;
  float *X, *U, *vX, *vU, *lamX, *lamU, *scratch;
  int N, nx, nu, B, R, L, chunk, si, st, ball, lanes, lane_threads;
  size_t lane_floats;
  bool shared;
};

// y_i = M_i y_{i-1} + b_i for every i from the doubling levels lv (L, N, nx,
// nx) and prefix products full (N, nx, nx) of M, y_{-1} = y: b in `cur`
// (N nx), `nxt` its double buffer. Every thread of the block calls it (it
// has barriers); the lane's threads t < T do the work where `active`.
// Returns the buffer that holds y.
__device__ float* affine_prefix(const float* __restrict__ lv, const float* __restrict__ full,
                                float* cur, float* nxt, const float* y, int N, int nx,
                                int t, int T, bool active) {
  const int rows = N * nx;
  int l = 0;
  for (int s = 1; s < N; s *= 2, ++l) {
    if (active) {
      for (int idx = t; idx < rows; idx += T) {
        const int k = idx / nx, i = idx - k * nx;
        nxt[idx] = k >= s ? cur[idx] + dot(lv + ((static_cast<size_t>(l) * N + k) * nx + i) * nx,
                                           1, cur + (k - s) * nx, nx)
                          : cur[idx];
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (active) {
    for (int idx = t; idx < rows; idx += T) {
      const int k = idx / nx, i = idx - k * nx;
      cur[idx] = cur[idx] + dot(full + (static_cast<size_t>(k) * nx + i) * nx, 1, y, nx);
    }
  }
  __syncthreads();
  return cur;
}

__global__ void __launch_bounds__(kMaxThreads) riccati_wide_kernel(const WideArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int T = p.lane_threads;
  const int lane = threadIdx.x / T, t = threadIdx.x - lane * T;
  const int slot = blockIdx.x * p.lanes + lane;
  const bool active = slot < p.B;  // mask the work: barriers below
  const int b = slot;
  const int N = p.N, nx = p.nx, nu = p.nu, R = p.R;
  const ptrdiff_t B = p.B;
  const int xrows = wide_split_x_rows(N, p.si, p.st, p.ball);
  const int xoff = N + 1 - xrows;  // the first split row
  float* base = p.shared ? smem + lane * p.lane_floats
                         : p.scratch + static_cast<size_t>(slot) * p.lane_floats;
  float* vU = base;
  float* lamU = vU + N * nu;
  float* vX = lamU + N * nu;  // split row k at (k - xoff) nx
  float* lamX = vX + xrows * nx;
  float* E0 = lamX + xrows * nx;
  float* Y = E0 + nx;  // lin_xN
  float* W = Y + nx;
  float* const vXN = vX + (N - xoff) * nx;  // the terminal row (when split)
  float* const lamXN = lamX + (N - xoff) * nx;

  const int r = p.ridx[0];
  const float rho = p.rho_tab[r], rho_inv = p.rho_tab[R + r];
  const float rho_t = p.rho_tab[2 * R + r], rho_t_inv = p.rho_tab[3 * R + r];
  const float* K = p.Kf + static_cast<size_t>(r) * N * nu * nx;     // (N, nu, nx)
  const float* G = p.Gf + static_cast<size_t>(r) * N * nu * nu;     // (N, nu, nu)
  const size_t lvl = static_cast<size_t>(r) * p.L * N * nx * nx, fl = static_cast<size_t>(r) * N * nx * nx;

  // ---- the lane's split rows and e0 (lane-last: entry (row, i) at
  // (row n + i) B + b) ----
  if (active) {
    for (int idx = t; idx < N * nu; idx += T) {
      vU[idx] = p.vU_in[idx * B + b];
      lamU[idx] = p.lamU_in[idx * B + b];
    }
    for (int idx = t; idx < xrows * nx; idx += T) {
      const ptrdiff_t a = (static_cast<ptrdiff_t>(xoff) * nx + idx) * B + b;
      vX[idx] = p.vX_in[a];
      lamX[idx] = p.lamX_in[a];
    }
    for (int i = t; i < nx; i += T) E0[i] = p.e0[i * B + b];
  }
  __syncthreads();

  // the linear terms, ffs, and the two horizon buffers
  float* LU = W;
  float* FF = LU + N * nu;
  float* BA = FF + N * nu;
  float* BB = BA + N * nx;
  float* US = FF;
  float* XS = BB;

  for (int it = 0; it < p.chunk; ++it) {
    if (active)
      for (int i = t; i < nx; i += T) Y[i] = p.st ? -rho_t * vXN[i] + lamXN[i] : 0.0f;

    // ---- the linear terms lu_k ----
    if (active)
      for (int idx = t; idx < N * nu; idx += T) LU[idx] = -rho * vU[idx] + lamU[idx];
    __syncthreads();
    // ---- b_k = lpre_k - K_k' lu_k, reversed in time ----
    if (active) {
      for (int idx = t; idx < N * nx; idx += T) {
        const int k = idx / nx, i = idx - k * nx;
        const float lp = (p.si && k >= 1)
                             ? -rho * vX[(k - xoff) * nx + i] + lamX[(k - xoff) * nx + i]
                             : 0.0f;
        BA[(N - 1 - k) * nx + i] =
            lp - dot(K + static_cast<size_t>(k) * nu * nx + i, nx, LU + k * nu, nu);
      }
    }
    __syncthreads();
    // ---- backward prefix: g_k at row N-1-k ----
    float* grev = affine_prefix(p.bwdL + lvl, p.bwdF + fl, BA, BB, Y, N, nx, t, T, active);
    float* other = grev == BA ? BB : BA;
    // ---- B' g_{k+1} + lu_k, in place of lu ----
    if (active) {
      for (int idx = t; idx < N * nu; idx += T) {
        const int k = idx / nu, i = idx - k * nu;
        const float* gn = k < N - 1 ? grev + (N - 2 - k) * nx : Y;
        LU[idx] = dot(p.Bm + i, nu, gn, nx) + LU[idx];
      }
    }
    __syncthreads();
    // ---- ffs_k = G_k (B' g_{k+1} + lu_k) ----
    if (active) {
      for (int idx = t; idx < N * nu; idx += T) {
        const int k = idx / nu, i = idx - k * nu;
        FF[idx] = dot(G + (static_cast<size_t>(k) * nu + i) * nu, 1, LU + k * nu, nu);
      }
    }
    __syncthreads();
    // ---- -B ffs_k, then the forward prefix: e_{k+1} at row k ----
    if (active) {
      for (int idx = t; idx < N * nx; idx += T) {
        const int k = idx / nx, i = idx - k * nx;
        other[idx] = -dot(p.Bm + static_cast<size_t>(i) * nu, 1, FF + k * nu, nu);
      }
    }
    __syncthreads();
    XS = affine_prefix(p.fwdL + lvl, p.fwdF + fl, other, grev, E0, N, nx, t, T, active);
    // ---- u_k = -K_k e_k - ffs_k, in place of ffs ----
    if (active) {
      for (int idx = t; idx < N * nu; idx += T) {
        const int k = idx / nu, i = idx - k * nu;
        const float* xk = k == 0 ? E0 : XS + (k - 1) * nx;
        FF[idx] = -dot(K + (static_cast<size_t>(k) * nu + i) * nx, 1, xk, nx) - FF[idx];
      }
    }
    __syncthreads();

    // ---- projections and dual ascent: U, the interior X rows ----
    if (active) {
      for (int idx = t; idx < N * nu; idx += T) {
        const int i = idx % nu;
        const float u = US[idx], lam = lamU[idx];
        const float v = clip(u + rho_inv * lam, p.ulo[i], p.uhi[i]);
        lamU[idx] = lam + rho * (u - v);
        vU[idx] = v;
      }
      if (p.si) {
        for (int idx = t; idx < (N - 1) * nx; idx += T) {  // rows 1..N-1
          const int i = idx % nx;
          const float x = XS[idx], lam = lamX[idx];
          const float v = clip(x + rho_inv * lam, p.xlo[i], p.xhi[i]);
          lamX[idx] = lam + rho * (x - v);
          vX[idx] = v;
        }
      }
    }
    // ---- the terminal row: the ball at rho, or the box at rho_t ----
    const float* XN = XS + (N - 1) * nx;
    if (p.ball) {
      float scale = 1.0f;
      if (active) {  // every thread forms the norm itself, in row order
        const float rad = p.ballr[b];
        const float w0 = XN[0] + rho_inv * lamXN[0];
        double acc = static_cast<double>(w0) * static_cast<double>(w0);
        for (int i = 1; i < nx; ++i) {
          const float w = XN[i] + rho_inv * lamXN[i];
          acc = fma(static_cast<double>(w), static_cast<double>(w), acc);
        }
        const float nrm = sqrtf(static_cast<float>(acc));
        scale = nrm > rad ? rad / nanmax(nrm, 1e-30f) : 1.0f;
      }
      __syncthreads();  // every thread has read the terminal dual
      if (active) {
        for (int i = t; i < nx; i += T) {
          const float w = XN[i] + rho_inv * lamXN[i];
          const float v = w * scale;
          lamXN[i] = lamXN[i] + rho * (XN[i] - v);
          vXN[i] = v;
        }
      }
    } else if (p.st) {
      if (active) {
        for (int i = t; i < nx; i += T) {
          const float lam = lamXN[i];
          const float v = clip(XN[i] + rho_t_inv * lam, p.xNlo[i], p.xNhi[i]);
          lamXN[i] = lam + rho_t * (XN[i] - v);
          vXN[i] = v;
        }
      }
    }
    __syncthreads();
  }

  // ---- the outputs: X, U of the last iteration, the split rows, the
  // mirrors of the rows that are not split, row 0 = e0 ----
  if (!active) return;  // no barrier follows
  for (int idx = t; idx < N * nu; idx += T) {
    p.U[idx * B + b] = US[idx];
    p.vU[idx * B + b] = vU[idx];
    p.lamU[idx * B + b] = lamU[idx];
  }
  for (int idx = t; idx < (N + 1) * nx; idx += T) {
    const int row = idx / nx;
    const float x = row == 0 ? E0[idx] : XS[idx - nx];
    const ptrdiff_t a = idx * B + b;
    p.X[a] = x;
    const bool split = row >= xoff;
    p.vX[a] = split ? vX[idx - xoff * nx] : x;
    p.lamX[a] = split ? lamX[idx - xoff * nx] : 0.0f;
  }
}

// X_0 = e0, X_{k+1} = A X_k + B U_k, one lane a block, a thread a row; e
// double-buffered, u staged, in shared memory.
__global__ void __launch_bounds__(kMaxThreads)
riccati_wide_rollout_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                            const float* __restrict__ e0, const float* __restrict__ U,
                            float* __restrict__ X, int N, int nx, int nu, int B) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  float* e[2] = {sm, sm + nx};
  float* u = sm + 2 * nx;
  for (int i = t; i < nx; i += T) {
    e[0][i] = e0[static_cast<size_t>(i) * B + b];
    X[static_cast<size_t>(i) * B + b] = e[0][i];
  }
  for (int i = t; i < nu; i += T) u[i] = U[static_cast<size_t>(i) * B + b];
  __syncthreads();
  for (int k = 0; k < N; ++k) {
    const float* cur = e[k & 1];
    float* nxt = e[(k + 1) & 1];
    for (int i = t; i < nx; i += T) {
      nxt[i] = dot(A + static_cast<size_t>(i) * nx, 1, cur, nx) +
               dot(Bm + static_cast<size_t>(i) * nu, 1, u, nu);
      X[(static_cast<size_t>(k + 1) * nx + i) * B + b] = nxt[i];
    }
    __syncthreads();
    if (k + 1 < N)
      for (int i = t; i < nu; i += T) u[i] = U[(static_cast<size_t>(k + 1) * nu + i) * B + b];
    __syncthreads();
  }
}

// The certificate's terms of one lane a block: the adjoint recursion g <-
// A' g + dlamX_k with residual B' g + dlamU_k by a thread a row (g and the
// two products in shared memory, two barriers a step), the long sums as
// per-thread fp64 partials combined by thread 0 in thread order.
__global__ void __launch_bounds__(kMaxThreads) riccati_wide_certificate_kernel(
    const float* __restrict__ A, const float* __restrict__ Bm, const float* __restrict__ xlo,
    const float* __restrict__ xhi, const float* __restrict__ xNlo,
    const float* __restrict__ xNhi, const float* __restrict__ ulo,
    const float* __restrict__ uhi, const float* __restrict__ lamX_new,
    const float* __restrict__ lamX_old, const float* __restrict__ lamU_new,
    const float* __restrict__ lamU_old, const float* __restrict__ Xbar,
    const float* __restrict__ ballr, float* __restrict__ out, int N, int nx, int nu, int B,
    int si, int st, int ball) {
  extern __shared__ __align__(16) double smd[];
  const int b = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  double* P = smd;                                  // 4 fp64 partials a thread
  float* F = reinterpret_cast<float*>(P + 4 * T);   // 2 fp32 maxima a thread
  float* g = F + 2 * T;
  float* bgag = g + nx;
  const auto dx = [&](int row, int i) {
    const size_t a = (static_cast<size_t>(row) * nx + i) * B + b;
    return lamX_new[a] - lamX_old[a];
  };
  const auto du = [&](int row, int i) {
    const size_t a = (static_cast<size_t>(row) * nu + i) * B + b;
    return lamU_new[a] - lamU_old[a];
  };

  // the long sums: box supports, <dlamX, Xbar>, max |dlam|
  double s_u = 0.0, s_int = 0.0, s_term = 0.0, xb = 0.0;
  float dn = 0.0f, ortho = 0.0f;
  for (int idx = t; idx < N * nu; idx += T) {
    const int i = idx % nu;
    const float d = du(idx / nu, i);
    dn = nanmax(dn, fabsf(d));
    s_u += static_cast<double>(box_term(d, ulo[i], uhi[i]));
  }
  for (int idx = t; idx < (N + 1) * nx; idx += T) {
    const int row = idx / nx, i = idx - row * nx;
    const float d = dx(row, i);
    dn = nanmax(dn, fabsf(d));
    xb = fma(static_cast<double>(d), static_cast<double>(Xbar[static_cast<size_t>(idx) * B + b]), xb);
    if (si && row >= 1 && row < N) s_int += static_cast<double>(box_term(d, xlo[i], xhi[i]));
    if (row == N && st && !ball) s_term += static_cast<double>(box_term(d, xNlo[i], xNhi[i]));
  }

  // the adjoint recursion from g = dlamX_N
  for (int i = t; i < nx; i += T) g[i] = dx(N, i);
  __syncthreads();
  for (int k = N - 1; k >= 0; --k) {
    for (int rr = t; rr < nu + nx; rr += T)
      bgag[rr] = rr < nu ? dot(Bm + rr, nu, g, nx) : dot(A + (rr - nu), nx, g, nx);
    __syncthreads();
    for (int rr = t; rr < nu + nx; rr += T) {
      if (rr < nu)
        ortho = nanmax(ortho, fabsf(bgag[rr] + du(k, rr)));
      else
        g[rr - nu] = bgag[rr] + dx(k, rr - nu);
    }
    __syncthreads();
  }

  P[t] = s_u, P[T + t] = s_int, P[2 * T + t] = s_term, P[3 * T + t] = xb;
  F[t] = ortho, F[T + t] = dn;
  __syncthreads();
  if (t != 0) return;
  double su = 0.0, sint = 0.0, sterm = 0.0, sxb = 0.0;
  float o = 0.0f, d = 0.0f;
  for (int j = 0; j < T; ++j) {
    su += P[j], sint += P[T + j], sterm += P[2 * T + j], sxb += P[3 * T + j];
    o = nanmax(o, F[j]);
    d = nanmax(d, F[T + j]);
  }
  float s_c = static_cast<float>(su);
  if (si) s_c = s_c + static_cast<float>(sint);
  if (ball) {  // ||dlamX_N||, squares in row order
    const float d0 = dx(N, 0);
    double acc = static_cast<double>(d0) * static_cast<double>(d0);
    for (int i = 1; i < nx; ++i) {
      const float di = dx(N, i);
      acc = fma(static_cast<double>(di), static_cast<double>(di), acc);
    }
    s_c = s_c + ballr[b] * sqrtf(static_cast<float>(acc));
  } else if (st) {
    s_c = s_c + static_cast<float>(sterm);
  }
  out[b] = o;
  out[B + b] = s_c - static_cast<float>(sxb);
  out[2 * static_cast<size_t>(B) + b] = d;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int levels_of(int N) {
  int l = 0;
  for (int s = 1; s < N; s *= 2) ++l;
  return l > 0 ? l : 1;
}

}  // namespace

extern "C" {

// Launch `chunk` (>= 1) iterations on `stream`. All arrays are float32 and
// contiguous on one device: Kf (R, N, nu, nx), Gf (R, N, nu, nu), Bm (nx,
// nu), the doubling levels bwdL, fwdL (R, L, N, nx, nx) and prefix
// products bwdF, fwdF (R, N, nx, nx), the boxes xlo, xhi, xNlo, xNhi (nx) and ulo, uhi
// (nu), rho_tab (4, R); ridx (1) int32 in [0, R); e0 (nx, B), ballr (B);
// vX_in, lamX_in and the outputs X, vX, lamX (N+1, nx, B); vU_in, lamU_in
// and the outputs U, vU, lamU (N, nu, B); scratch, the lanes' scratch in
// device memory (blocks x lanes x lane_floats floats) when smem_bytes is 0.
// The layout comes from the host's plan (ops/riccati_fused.k3w_plan):
// `lanes` lanes a block, `lane_threads` threads each, lane_floats =
// wide_lane_floats(...), and smem_bytes = 4 lanes lane_floats (the scratch
// in shared memory) or 0. Returns the cudaError_t of the launch (0 on
// success).
int riccati_wide_chunk(const float* Kf, const float* Gf,
                       const float* Bm, const float* bwdL, const float* bwdF,
                       const float* fwdL, const float* fwdF, const float* xlo,
                       const float* xhi, const float* xNlo, const float* xNhi,
                       const float* ulo, const float* uhi, const float* rho_tab,
                       const int* ridx, const float* e0, const float* ballr,
                       const float* vX_in, const float* vU_in, const float* lamX_in,
                       const float* lamU_in, float* X, float* U, float* vX, float* vU,
                       float* lamX, float* lamU, float* scratch, int N, int nx, int nu, int B,
                       int R, int L, int chunk, int split_interior, int split_terminal,
                       int terminal_ball, int lanes, int lane_threads,
                       int lane_floats, int smem_bytes, void* stream) {
  if (N <= 0 || nx <= 0 || nu <= 0 || B <= 0 || R <= 0 || chunk <= 0 || lanes <= 0 ||
      lane_threads <= 0 || lanes * lane_threads > kMaxThreads || L != levels_of(N))
    return static_cast<int>(cudaErrorInvalidValue);
  const int xrows = wide_split_x_rows(N, split_interior, split_terminal, terminal_ball);
  const size_t floats = wide_lane_floats(N, nx, nu, xrows);
  // the host's plan and this layout must agree
  if (static_cast<size_t>(lane_floats) != floats) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(smem_bytes);
  if (bytes != 0 && bytes != sizeof(float) * floats * lanes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes == 0 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  WideArgs p;
  p.Kf = Kf, p.Gf = Gf, p.Bm = Bm;
  p.bwdL = bwdL, p.bwdF = bwdF, p.fwdL = fwdL, p.fwdF = fwdF;
  p.xlo = xlo, p.xhi = xhi, p.xNlo = xNlo, p.xNhi = xNhi, p.ulo = ulo, p.uhi = uhi;
  p.rho_tab = rho_tab, p.ridx = ridx, p.e0 = e0, p.ballr = ballr;
  p.vX_in = vX_in, p.vU_in = vU_in, p.lamX_in = lamX_in, p.lamU_in = lamU_in;
  p.X = X, p.U = U, p.vX = vX, p.vU = vU, p.lamX = lamX, p.lamU = lamU, p.scratch = scratch;
  p.N = N, p.nx = nx, p.nu = nu, p.B = B, p.R = R, p.L = L, p.chunk = chunk;
  p.si = split_interior, p.st = split_terminal, p.ball = terminal_ball;
  p.lanes = lanes, p.lane_threads = lane_threads, p.lane_floats = floats;
  p.shared = bytes != 0;
  const cudaError_t err = set_smem(riccati_wide_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + lanes - 1) / lanes;
  riccati_wide_kernel<<<blocks, lanes * lane_threads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// X (N+1, nx, B) from e0 (nx, B) and U (N, nu, B); A (nx, nx), Bm (nx, nu);
// one lane a block of `threads` threads.
int riccati_wide_rollout(const float* A, const float* Bm, const float* e0, const float* U,
                         float* X, int N, int nx, int nu, int B, int threads, void* stream) {
  if (N <= 0 || nx <= 0 || nu <= 0 || B <= 0 || threads <= 0 || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(float) * (2 * static_cast<size_t>(nx) + nu);
  const cudaError_t err = set_smem(riccati_wide_rollout_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  riccati_wide_rollout_kernel<<<B, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      A, Bm, e0, U, X, N, nx, nu, B);
  return static_cast<int>(cudaGetLastError());
}

// out (3, B): max_k |B' g_{k+1} + dlamU_k|, the support value and max |dlam|
// of each lane, from lamX_new/old, Xbar (N+1, nx, B), lamU_new/old (N, nu,
// B), ballr (B) and the boxes as in riccati_wide_chunk; one lane a block of
// `threads` threads.
int riccati_wide_certificate(const float* A, const float* Bm, const float* xlo,
                             const float* xhi, const float* xNlo, const float* xNhi,
                             const float* ulo, const float* uhi, const float* lamX_new,
                             const float* lamX_old, const float* lamU_new,
                             const float* lamU_old, const float* Xbar, const float* ballr,
                             float* out, int N, int nx, int nu, int B, int split_interior,
                             int split_terminal, int terminal_ball, int threads,
                             void* stream) {
  if (N <= 0 || nx <= 0 || nu <= 0 || B <= 0 || threads <= 0 || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(double) * 4 * threads +
                       sizeof(float) * (2 * static_cast<size_t>(threads) + 2 * nx + nu);
  const cudaError_t err = set_smem(riccati_wide_certificate_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  riccati_wide_certificate_kernel<<<B, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      A, Bm, xlo, xhi, xNlo, xNhi, ulo, uhi, lamX_new, lamX_old, lamU_new, lamU_old, Xbar,
      ballr, out, N, nx, nu, B, split_interior, split_terminal, terminal_ball);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
