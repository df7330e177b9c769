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
// riccati_chain_floor measures what the recurrence itself costs: the
// dependent instructions of a sweep step and a rollout step, from registers.
//
// What bounds K3 on this card: neither bytes nor operations. Each iteration
// is a chain of 2N dependent steps per lane (a step is a few products of
// length nx or nu), and a lane's 2N x chunk steps cannot overlap. What a
// step costs is therefore what counts: the latency of every load on it, and
// the instructions one warp must issue for it, of which the fp32 <-> fp64
// conversions are the dearest (a quarter of the fp64 FMA rate). At horizon
// 500 with 4 states and 2 inputs, the chain's own instructions take 2.0 ms
// per 25-iteration chunk from registers (riccati_chain_floor) and the kernel
// 3.7 ms (NVIDIA H100 80GB HBM3, 700.00 W; k3_ab.py).
//
// Design:
// - The lane's rows stay in shared memory for the whole chunk. A block
//   takes `lanes` lanes (one thread each, chosen by the host's plan so that
//   the batch spreads over all SMs), loads their split rows (vU, lamU, and
//   the vX, lamX rows that are split) once, runs all `chunk` iterations in
//   place with ffs in shared memory too, and writes vU, lamU and the split
//   vX, lamX rows once. X, U and the rows that are not split are stored by
//   the last iteration only (no iteration reads them). Layout [row][lane]
//   [dim]: a lane's row is one aligned float2 or float4 where the plant
//   fills its register tier, and a warp's rows tile the banks.
// - One rho's factors, picked by the device-resident grid index, are copied
//   once per block into shared memory and widened to fp64 there (exact), each
//   matrix padded to the register tier (MX, MU) so that a row is a run of
//   aligned double2. A product then converts only its vector. All lanes read
//   the same factor entry: broadcasts.
// - Every product reads whole rows of its matrix: M v row by row, M' v as
//   running sums over the rows of M; each sum keeps the column order.
// - Where that does not fit (the host's k3_plan, ops/riccati_fused.py):
//   fewer lanes; else the fp32 factors as they are, in shared memory or read
//   through L1/L2; and where not even one lane's rows fit, the rows stay in
//   the output arrays in device memory (lane-last, coalesced) and are
//   iterated in place there, with ffs in a global scratch. All are
//   instantiations of one kernel.
// - The kernel has barriers (cooperative staging), so no thread returns
//   early: a partial last block masks its work.
// - Template arguments MX, MU bound nx, nu (register arrays); the C entry
//   picks the smallest of (4, 2), (8, 4), (16, 8), (32, 16) that holds the
//   plant. At (32, 16) a lane's fp64 rows do not fit in registers and spill
//   to local memory (the ptxas report says how much). A
//   plant that fills its tier (the QTP: 4 states, 2 inputs) takes an
//   instantiation with nx and nu fixed, so no sum is predicated and a row
//   moves as one vector; others take the predicated one.
// - One warp's instruction stream is all a lane has, so the loops carry
//   nothing they do not need: running pointers, no per-entry branches, the
//   chain's products before the step's other work, and a forward pass
//   compiled twice, with and without the last iteration's stores of X, U.
// - The certificate stages tiles of horizon rows x lanes (the dual deltas and
//   Xbar) into shared memory with all threads, coalesced; one thread per
//   lane then walks the tile.
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
// This header holds K3's kernel, the products and helpers it shares with the
// rollout and certificate kernels (riccati_admm.cu), and its launcher. It is
// bound to PyTorch by ctypes through the plain C functions of riccati_admm.cu.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <type_traits>

namespace mpc_k3 {

// What the kernels take; the launch arguments of riccati_admm_chunk.
struct ChunkArgs {
  const float *Kf, *Gf, *AmBKf, *A, *Bm, *xlo, *xhi, *xNlo, *xNhi, *ulo, *uhi;
  const float* rho_tab;
  const int* ridx;
  const float *e0, *ballr, *vX_in, *vU_in, *lamX_in, *lamU_in;
  float *X, *U, *vX, *vU, *lamX, *lamU, *ffs;
  int N, nx, nu, B, R, chunk;
  int split_interior, split_terminal, terminal_ball;
  int lanes, fac_shared;
};

// Launch K3 at register tier TIER (0: (4, 2), 1: (8, 4), 2: (16, 8), 3: (32, 16)) on
// ROUTE (0: the lanes' rows and fp64 factors in shared memory; 1: the rows in
// shared memory, fp32 factors in shared or device memory as p.fac_shared
// says; 2: the rows in device memory). Each pair is specialised by
// MPC_K3_TIER_ROUTE in some translation unit; the (16, 8) and (32, 16)
// tiers' routes have one each, so that nvcc builds the long ones side by side.
template <int TIER, int ROUTE>
cudaError_t launch_tier(ChunkArgs p, size_t smem_bytes, cudaStream_t st);
#define MPC_K3_DECLARE(TIER)                                                    \
  template <>                                                                   \
  cudaError_t launch_tier<TIER, 0>(ChunkArgs, size_t, cudaStream_t);            \
  template <>                                                                   \
  cudaError_t launch_tier<TIER, 1>(ChunkArgs, size_t, cudaStream_t);            \
  template <>                                                                   \
  cudaError_t launch_tier<TIER, 2>(ChunkArgs, size_t, cudaStream_t);
MPC_K3_DECLARE(0)
MPC_K3_DECLARE(1)
MPC_K3_DECLARE(2)
MPC_K3_DECLARE(3)
#undef MPC_K3_DECLARE

}  // namespace mpc_k3

namespace {

using mpc_k3::ChunkArgs;

constexpr int kThreads = 128;  // K3 and the certificate: threads per block
constexpr size_t kSmemLimit = 232448;

// jnp.clip / torch.clamp semantics: a NaN passes through
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// max that propagates NaN, as jnp.max and torch.amax do
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// row[j] = p[j], j < W. A padded fp64 row is read whole, as aligned pairs;
// an fp32 row has n entries and is widened here.
template <int W>
__device__ __forceinline__ void load_row(const double* __restrict__ p, int,
                                         double (&row)[W]) {
  static_assert(W % 2 == 0, "padded rows are runs of double2");
#pragma unroll
  for (int j = 0; j < W; j += 2) {
    const double2 v = *reinterpret_cast<const double2*>(p + j);
    row[j] = v.x;
    row[j + 1] = v.y;
  }
}

template <int W>
__device__ __forceinline__ void load_row(const float* __restrict__ p, int n,
                                         double (&row)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) row[j] = j < n ? static_cast<double>(p[j]) : 0.0;
}

template <int W>
__device__ __forceinline__ void widen(const float (&v)[W], double (&out)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) out[j] = static_cast<double>(v[j]);
}

// A product of more than kUnrolledMax entries (the (32, 16) tier's, all but
// G's) walks its outer loop instead of unrolling it: unrolled, K3 at that
// tier is ~10^4 straight-line instructions that ptxas takes minutes to
// allocate, and spills all the same. Each sum keeps its order.
constexpr int kUnrolledMax = 256;

// out[i] = sum_j M[i*ld + j] v[j] for i < a, j < n: exact fp32 products
// summed in fp64 in order j = 0..n-1, rounded once to fp32
template <int MA, int MN, typename T>
__device__ __forceinline__ void mv(const T* __restrict__ M, int ld, int a,
                                   int n, const double (&v)[MN],
                                   float (&out)[MA]) {
#pragma unroll(MA * MN <= kUnrolledMax ? MA : 1)
  for (int i = 0; i < MA; ++i) {
    out[i] = 0.0f;
    if (i < a) {
      double row[MN];
      load_row<MN>(M + i * ld, n, row);
      double acc = row[0] * v[0];
#pragma unroll
      for (int j = 1; j < MN; ++j)
        if (j < n) acc = fma(row[j], v[j], acc);
      out[i] = static_cast<float>(acc);
    }
  }
}

// out[i] = sum_j M[j*ld + i] v[j] for i < a, j < n: the same sums, formed
// side by side over the rows of M
template <int MA, int MN, typename T>
__device__ __forceinline__ void mtv(const T* __restrict__ M, int ld, int a,
                                    int n, const double (&v)[MN],
                                    float (&out)[MA]) {
  double acc[MA];
#pragma unroll
  for (int i = 0; i < MA; ++i) acc[i] = 0.0;
#pragma unroll(MA * MN <= kUnrolledMax ? MN : 1)
  for (int j = 0; j < MN; ++j) {
    if (j < n) {
      double row[MA];
      load_row<MA>(M + j * ld, a, row);
#pragma unroll
      for (int i = 0; i < MA; ++i)
        acc[i] = j == 0 ? row[i] * v[0] : fma(row[i], v[j], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < MA; ++i) out[i] = i < a ? static_cast<float>(acc[i]) : 0.0f;
}

// the support of a box at direction d: +inf rays only where d points
// along them
__device__ __forceinline__ float box_term(float d, float lo, float hi) {
  const float inf = INFINITY;
  const float pos = d > 0.0f ? (isfinite(hi) ? hi * d : inf) : 0.0f;
  const float neg = d < 0.0f ? (isfinite(lo) ? lo * d : inf) : 0.0f;
  return pos + neg;
}

// Move `rows` rows of n entries of the block's lanes that exist between a
// lane-last array in device memory (g, at the block's first lane; entry
// (row, i) of lane l at g[(row*n + i)*B + l]) and the block's copy s, by all
// threads, coalesced on the device side. SH: s is in shared memory, a lane's
// row contiguous ([row][lane][i]); else s is lane-last too. IN: g to s.
template <bool SH, bool IN>
__device__ __forceinline__ void move_rows(float* __restrict__ s, float* __restrict__ g,
                                          int rows, int n, int lanes, int live,
                                          ptrdiff_t B) {
#pragma unroll 4  // several loads in flight
  for (int idx = threadIdx.x; idx < rows * n * lanes; idx += blockDim.x) {
    const int ri = idx / lanes, l = idx - ri * lanes;
    if (l >= live) continue;
    const int row = ri / n, i = ri - row * n;
    float* ps = SH ? s + (static_cast<ptrdiff_t>(row) * lanes + l) * n + i : s + ri * B + l;
    float* pg = g + ri * B + l;
    if (IN)
      *ps = *pg;
    else
      *pg = *ps;
  }
}

// The boxes, the grid entry's constants and the sizes, as the chain reads
// them.
struct Consts {
  const float *xlo, *xhi, *xNlo, *xNhi;
  float rho, rho_inv, rho_t, rho_t_inv;
  int N, nx, nu, chunk;
  bool split_interior, split_terminal, terminal_ball;
};

// v[i] = p[i*es] for i < n (zero past n). VEC: the W entries are adjacent and
// aligned (es = 1, n = W), read as float2 or float4.
template <int W, bool VEC>
__device__ __forceinline__ void get(const float* __restrict__ p, ptrdiff_t es, int n,
                                    float (&v)[W]) {
  if constexpr (VEC && W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else if constexpr (VEC && W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x, v[i + 1] = t.y, v[i + 2] = t.z, v[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = i < n ? p[i * es] : 0.0f;
  }
}

// p[i*es] = v[i] for i < n; VEC as in get
template <int W, bool VEC>
__device__ __forceinline__ void put(float* __restrict__ p, ptrdiff_t es, int n,
                                    const float (&v)[W]) {
  if constexpr (VEC && W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else if constexpr (VEC && W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (i < n) p[i * es] = v[i];
  }
}

// All `chunk` iterations of one lane, in place. The row pointers are the
// lane's own: element (k, i) of vU, lamU, ffs is p[k*nu*ld + i*es], of vX,
// lamX p[(k - xoff)*nx*ld + i*es] (only split rows are touched through
// these); the loops walk them with running pointers. In shared memory
// (SH) a lane's row is contiguous (es = 1, ld = the block's lanes); in the
// lane-last arrays in device memory es = ld = B. Xg, Ug, vXg, lamXg are the
// lane's columns of the lane-last outputs (stride B): the last iteration
// stores X and U there, mirrors X into the rows of vX that are not split and
// zeroes their dual. PAD: the factors are padded to (MX, MU). FULL: the plant
// fills its tier (nx = MX, nu = MU), so no sum is predicated and a shared row
// moves as one vector.
template <int MX, int MU, bool PAD, bool FULL, bool SH, typename T>
__device__ __forceinline__ void lane_chunk(
    const T* __restrict__ fK, const T* __restrict__ fG,
    const T* __restrict__ fAmBK, const T* __restrict__ fA,
    const T* __restrict__ fB, const float* __restrict__ ulo_p,
    const float* __restrict__ uhi_p, const Consts& c, const float (&e0)[MX],
    float rad, float* __restrict__ vU, float* __restrict__ lamU,
    float* __restrict__ ffs, float* __restrict__ vX, float* __restrict__ lamX,
    ptrdiff_t ld, int xoff, float* __restrict__ Xg, float* __restrict__ Ug,
    float* __restrict__ vXg, float* __restrict__ lamXg, ptrdiff_t B) {
  constexpr bool VEC = SH && FULL;
  const int N = c.N, nx = FULL ? MX : c.nx, nu = FULL ? MU : c.nu;
  const float rho = c.rho, rho_inv = c.rho_inv;
  const int ldx = PAD ? MX : nx, ldu = PAD ? MU : nu;  // row lengths
  const int sK = PAD ? MU * MX : nu * nx, sG = PAD ? MU * MU : nu * nu;
  const int sA = PAD ? MX * MX : nx * nx;
  const ptrdiff_t es = SH ? 1 : ld;            // between a row's entries
  const ptrdiff_t sU = nu * ld, sX = nx * ld;  // one row of the lane's arrays
  const ptrdiff_t gU = nu * B, gX = nx * B;    // and of the outputs
  float* const vXN = vX + (N - xoff) * sX;     // the terminal row
  float* const lamXN = lamX + (N - xoff) * sX;
  float ulo[MU], uhi[MU], xlo[MX], xhi[MX];  // the boxes the loops read
#pragma unroll
  for (int i = 0; i < MU; ++i) {
    ulo[i] = i < nu ? ulo_p[i] : 0.0f;
    uhi[i] = i < nu ? uhi_p[i] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < MX; ++i) {
    xlo[i] = (c.split_interior && i < nx) ? c.xlo[i] : 0.0f;
    xhi[i] = (c.split_interior && i < nx) ? c.xhi[i] : 0.0f;
  }
  // lu = -rho vU_k + lamU_k
  const auto linear_u = [&](const float* pvU, const float* plamU, float (&lu)[MU]) {
    float v[MU], lam[MU];
    get<MU, VEC>(pvU, es, nu, v);
    get<MU, VEC>(plamU, es, nu, lam);
#pragma unroll
    for (int i = 0; i < MU; ++i) lu[i] = i < nu ? -rho * v[i] + lam[i] : 0.0f;
  };
  // ffs_k = G_k (B' g + lu)
  const auto feedforward = [&](const T* pG, float* pffs, const double (&gd)[MX],
                               const float (&lu)[MU]) {
    float bg[MU], t[MU], ff[MU];
    double td[MU];
    mtv<MU, MX>(fB, ldu, nu, nx, gd, bg);  // B' g
#pragma unroll
    for (int i = 0; i < MU; ++i) t[i] = bg[i] + lu[i];
    widen(t, td);
    mv<MU, MU>(pG, ldu, nu, nu, td, ff);
    put<MU, VEC>(pffs, es, nu, ff);
  };

  // ---- w-update: backward affine sweep (fills ffs) ----
  const auto sweep = [&]() {
    float g[MX];
#pragma unroll
    for (int i = 0; i < MX; ++i)
      g[i] = (c.split_terminal && i < nx) ? -c.rho_t * vXN[i * es] + lamXN[i * es] : 0.0f;
    {
      const float* pvU = vU + (N - 1) * sU;
      const float* plamU = lamU + (N - 1) * sU;
      float* pffs = ffs + (N - 1) * sU;
      const float* pvX = vX + (N - 1 - xoff) * sX;
      const float* plamX = lamX + (N - 1 - xoff) * sX;
      const T* pG = fG + static_cast<ptrdiff_t>(N - 1) * sG;
      const T* pA = fAmBK + static_cast<ptrdiff_t>(N - 1) * sA;
      const T* pK = fK + static_cast<ptrdiff_t>(N - 1) * sK;
      double gd[MX];
      float lu[MU];
#pragma unroll(MX <= 4 ? 2 : 1)
      for (int k = N - 1; k >= 1; --k) {
        float ag[MX], kl[MX];
        double lud[MU];
        // the chain first (g feeds the next step), then the step's ffs
        widen(g, gd);
        linear_u(pvU, plamU, lu);
        widen(lu, lud);
        mtv<MX, MX>(pA, ldx, nx, nx, gd, ag);
        mtv<MX, MU>(pK, ldx, nx, nu, lud, kl);
#pragma unroll
        for (int i = 0; i < MX; ++i) g[i] = ag[i] - kl[i];
        feedforward(pG, pffs, gd, lu);
        if (c.split_interior) {
          float v[MX], lam[MX];
          get<MX, VEC>(pvX, es, nx, v);
          get<MX, VEC>(plamX, es, nx, lam);
#pragma unroll
          for (int i = 0; i < MX; ++i)
            if (i < nx) g[i] = g[i] + (-rho * v[i] + lam[i]);
        }
        pvU -= sU, plamU -= sU, pffs -= sU, pvX -= sX, plamX -= sX;
        pG -= sG, pA -= sA, pK -= sK;
      }
      widen(g, gd);  // k = 0: nothing reads the g past it
      linear_u(pvU, plamU, lu);
      feedforward(pG, pffs, gd, lu);
    }
  };

  // ---- forward rollout, with each row's projection and dual ascent, then the
  // terminal row; the chunk's last iteration (is_last, a compile-time flag:
  // the others carry none of its stores) also writes X, U and the mirrors ----
  const auto forward = [&](auto is_last) {
    constexpr bool last = decltype(is_last)::value;
    float e[MX];
#pragma unroll
    for (int i = 0; i < MX; ++i) e[i] = e0[i];
    {
      float* pvU = vU;
      float* plamU = lamU;
      const float* pffs = ffs;
      float* pvX = vX + (1 - xoff) * sX;  // row k + 1
      float* plamX = lamX + (1 - xoff) * sX;
      float *pUg = Ug, *pXg = Xg + gX, *pvXg = vXg + gX, *plamXg = lamXg + gX;
      const T* pK = fK;
#pragma unroll(MX <= 4 ? 2 : 1)
      for (int k = 0; k < N; ++k) {
        float ke[MU], ff[MU], u[MU], ae[MX], bu[MX], lam[MU], v[MU];
        double ed[MX], ud[MU];
        widen(e, ed);
        mv<MU, MX>(pK, ldx, nu, nx, ed, ke);
        get<MU, VEC>(pffs, es, nu, ff);
#pragma unroll
        for (int i = 0; i < MU; ++i) u[i] = i < nu ? -ke[i] - ff[i] : 0.0f;
        widen(u, ud);
        mv<MX, MX>(fA, ldx, nx, nx, ed, ae);
        mv<MX, MU>(fB, ldu, nx, nu, ud, bu);
#pragma unroll
        for (int i = 0; i < MX; ++i) e[i] = ae[i] + bu[i];
        get<MU, VEC>(plamU, es, nu, lam);
#pragma unroll
        for (int i = 0; i < MU; ++i) {
          v[i] = clip(u[i] + rho_inv * lam[i], ulo[i], uhi[i]);
          lam[i] = lam[i] + rho * (u[i] - v[i]);
        }
        put<MU, VEC>(plamU, es, nu, lam);
        put<MU, VEC>(pvU, es, nu, v);
        if (c.split_interior) {
          if (k + 1 < N) {  // interior row k+1
            float lx[MX], vx[MX];
            get<MX, VEC>(plamX, es, nx, lx);
#pragma unroll
            for (int i = 0; i < MX; ++i) {
              vx[i] = clip(e[i] + rho_inv * lx[i], xlo[i], xhi[i]);
              lx[i] = lx[i] + rho * (e[i] - vx[i]);
            }
            put<MX, VEC>(plamX, es, nx, lx);
            put<MX, VEC>(pvX, es, nx, vx);
          }
        }
        if (last) {
#pragma unroll
          for (int i = 0; i < MU; ++i)
            if (i < nu) pUg[i * B] = u[i];
#pragma unroll
          for (int i = 0; i < MX; ++i) {
            if (i >= nx) continue;
            pXg[i * B] = e[i];
            if (!c.split_interior && k + 1 < N) {
              pvXg[i * B] = e[i];
              plamXg[i * B] = 0.0f;
            }
          }
        }
        pvU += sU, plamU += sU, pffs += sU, pvX += sX, plamX += sX;
        pUg += gU, pXg += gX, pvXg += gX, plamXg += gX;
        pK += sK;
      }
    }

    // ---- terminal row: the ball at rho, or the box at rho_t ----
    if (c.terminal_ball) {
      float w[MX];
#pragma unroll
      for (int i = 0; i < MX; ++i) w[i] = i < nx ? e[i] + rho_inv * lamXN[i * es] : 0.0f;
      double acc = static_cast<double>(w[0]) * static_cast<double>(w[0]);
#pragma unroll
      for (int i = 1; i < MX; ++i)
        if (i < nx) acc = fma(static_cast<double>(w[i]), static_cast<double>(w[i]), acc);
      const float nrm = sqrtf(static_cast<float>(acc));
      const float scale = nrm > rad ? rad / nanmax(nrm, 1e-30f) : 1.0f;
#pragma unroll
      for (int i = 0; i < MX; ++i) {
        if (i >= nx) continue;
        const float v = w[i] * scale;
        lamXN[i * es] = lamXN[i * es] + rho * (e[i] - v);
        vXN[i * es] = v;
      }
    } else if (c.split_terminal) {
#pragma unroll
      for (int i = 0; i < MX; ++i) {
        if (i >= nx) continue;
        const float lam = lamXN[i * es];
        const float v = clip(e[i] + c.rho_t_inv * lam, c.xNlo[i], c.xNhi[i]);
        lamXN[i * es] = lam + c.rho_t * (e[i] - v);
        vXN[i * es] = v;
      }
    } else if (last) {
#pragma unroll
      for (int i = 0; i < MX; ++i) {
        if (i >= nx) continue;
        vXg[N * gX + i * B] = e[i];
        lamXg[N * gX + i * B] = 0.0f;
      }
    }
  };

  for (int it = 0; it < c.chunk; ++it) {
    sweep();
    if (it + 1 < c.chunk)
      forward(std::false_type{});
    else
      forward(std::true_type{});
  }
  // row 0 is the fixed e_1: X = vX = e0, no dual
#pragma unroll
  for (int i = 0; i < MX; ++i) {
    if (i >= nx) continue;
    Xg[i * B] = e0[i];
    vXg[i * B] = e0[i];
    lamXg[i * B] = 0.0f;
  }
}

// The split rows of X: N when the interior is split, the terminal row alone
// when only it is, none otherwise.
__host__ __device__ inline int split_x_rows(int N, int si, int st, int ball) {
  return si ? N : ((st || ball) ? 1 : 0);
}

// Factor entries in shared memory: padded fp64 (FAC64), or the fp32 stacks
// as they are.
__host__ __device__ inline size_t factor_count(bool fac64, int MX, int MU,
                                               int N, int nx, int nu) {
  const size_t x = fac64 ? MX : nx, u = fac64 ? MU : nu;
  return static_cast<size_t>(N) * (u * x + u * u + x * x) + x * x + x * u;
}

// FAC64: the factors widened in shared memory; else fp32, in shared memory
// (fac_shared) or device memory. ROWS_SHARED: the lanes' rows in shared
// memory; else in the output arrays. FULL: nx = MX and nu = MU.
template <int MX, int MU, bool FAC64, bool ROWS_SHARED, bool FULL>
__global__ void __launch_bounds__(kThreads, 1)
riccati_admm_chunk_kernel(const ChunkArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  using T = typename std::conditional<FAC64, double, float>::type;
  const int N = p.N, nx = FULL ? MX : p.nx, nu = FULL ? MU : p.nu, B = p.B, lanes = p.lanes;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x * lanes;
  const int live = min(lanes, B - b0);  // lanes of this block that exist
  const bool active = tid < live;       // mask the work: barriers below
  const int r = p.ridx[0];
  const int xrows = split_x_rows(N, p.split_interior, p.split_terminal, p.terminal_ball);

  // ---- the factors of grid entry r ----
  const float* gK = p.Kf + static_cast<size_t>(r) * N * nu * nx;
  const float* gG = p.Gf + static_cast<size_t>(r) * N * nu * nu;
  const float* gA = p.AmBKf + static_cast<size_t>(r) * N * nx * nx;
  const int fx = FAC64 ? MX : nx, fu = FAC64 ? MU : nu;
  const size_t nK = static_cast<size_t>(N) * fu * fx, nG = static_cast<size_t>(N) * fu * fu;
  const size_t nAk = static_cast<size_t>(N) * fx * fx;
  const T *fK, *fG, *fAmBK, *fA, *fB;
  size_t used = 0;  // bytes of shared memory taken by the factors
  if (FAC64 || p.fac_shared) {
    T* s = reinterpret_cast<T*>(smem);
    T *sK = s, *sG = sK + nK, *sAk = sG + nG, *sA = sAk + nAk, *sB = sA + fx * fx;
    used = (sizeof(T) * factor_count(FAC64, MX, MU, N, nx, nu) + 15) / 16 * 16;
    // dst (rows x cols, leading dimension ld, padded with zeros) from the
    // fp32 src (a x n), N of them
    const auto fill = [&](T* dst, const float* src, int rows, int cols, int a, int n,
                          size_t count) {
      for (size_t idx = tid; idx < count; idx += nthr) {
        const size_t k = idx / (rows * cols);
        const int rem = static_cast<int>(idx - k * rows * cols);
        const int i = rem / cols, j = rem - i * cols;
        dst[idx] = (i < a && j < n) ? static_cast<T>(src[(k * a + i) * n + j]) : T(0);
      }
    };
    fill(sK, gK, fu, fx, nu, nx, nK);
    fill(sG, gG, fu, fu, nu, nu, nG);
    fill(sAk, gA, fx, fx, nx, nx, nAk);
    fill(sA, p.A, fx, fx, nx, nx, static_cast<size_t>(fx) * fx);
    fill(sB, p.Bm, fx, fu, nx, nu, static_cast<size_t>(fx) * fu);
    fK = sK, fG = sG, fAmBK = sAk, fA = sA, fB = sB;
  } else {
    // FAC64 never gets here
    fK = reinterpret_cast<const T*>(gK), fG = reinterpret_cast<const T*>(gG);
    fAmBK = reinterpret_cast<const T*>(gA), fA = reinterpret_cast<const T*>(p.A);
    fB = reinterpret_cast<const T*>(p.Bm);
  }

  // ---- the lanes' rows: staged into shared memory, or iterated in place in
  // the outputs; either way the split rows come from the inputs ----
  const int nU = N * nu, nXs = xrows * nx;
  const ptrdiff_t x0 = static_cast<ptrdiff_t>(N + 1 - xrows) * nx * B;  // first split row
  const int xoff = N + 1 - xrows;
  float *vU, *lamU, *ffs, *vX, *lamX;
  ptrdiff_t ld;
  if (ROWS_SHARED) {
    float* s = reinterpret_cast<float*>(smem + used);
    vX = s, lamX = vX + static_cast<ptrdiff_t>(nXs) * lanes;
    vU = lamX + static_cast<ptrdiff_t>(nXs) * lanes, lamU = vU + static_cast<ptrdiff_t>(nU) * lanes;
    ffs = lamU + static_cast<ptrdiff_t>(nU) * lanes;
    ld = lanes;
  } else {
    vU = p.vU + b0, lamU = p.lamU + b0, ffs = p.ffs + b0;
    vX = p.vX + x0 + b0, lamX = p.lamX + x0 + b0;
    ld = B;
  }
  move_rows<ROWS_SHARED, true>(vU, const_cast<float*>(p.vU_in) + b0, N, nu, lanes, live, B);
  move_rows<ROWS_SHARED, true>(lamU, const_cast<float*>(p.lamU_in) + b0, N, nu, lanes, live, B);
  move_rows<ROWS_SHARED, true>(vX, const_cast<float*>(p.vX_in) + x0 + b0, xrows, nx, lanes, live, B);
  move_rows<ROWS_SHARED, true>(lamX, const_cast<float*>(p.lamX_in) + x0 + b0, xrows, nx, lanes, live, B);
  __syncthreads();

  if (active) {
    const int b = b0 + tid;
    Consts c;
    c.xlo = p.xlo, c.xhi = p.xhi, c.xNlo = p.xNlo, c.xNhi = p.xNhi;
    c.rho = p.rho_tab[r];
    c.rho_inv = p.rho_tab[p.R + r];
    c.rho_t = p.rho_tab[2 * p.R + r];
    c.rho_t_inv = p.rho_tab[3 * p.R + r];
    c.N = N, c.nx = nx, c.nu = nu, c.chunk = p.chunk;
    c.split_interior = p.split_interior != 0;
    c.split_terminal = p.split_terminal != 0;
    c.terminal_ball = p.terminal_ball != 0;
    float e0[MX];
#pragma unroll
    for (int i = 0; i < MX; ++i) e0[i] = i < nx ? p.e0[static_cast<size_t>(i) * B + b] : 0.0f;
    // the lane's place in a row: its own run of entries in shared memory,
    // its column in a lane-last array
    const int ou = ROWS_SHARED ? tid * nu : tid, ox = ROWS_SHARED ? tid * nx : tid;
    lane_chunk<MX, MU, FAC64, FULL, ROWS_SHARED>(
        fK, fG, fAmBK, fA, fB, p.ulo, p.uhi, c, e0, p.ballr[b], vU + ou, lamU + ou, ffs + ou,
        vX + ox, lamX + ox, ld, xoff, p.X + b, p.U + b, p.vX + b, p.lamX + b,
        static_cast<ptrdiff_t>(B));
  }

  if (ROWS_SHARED) {
    __syncthreads();
    move_rows<true, false>(vU, p.vU + b0, N, nu, lanes, live, B);
    move_rows<true, false>(lamU, p.lamU + b0, N, nu, lanes, live, B);
    move_rows<true, false>(vX, p.vX + x0 + b0, xrows, nx, lanes, live, B);
    move_rows<true, false>(lamX, p.lamX + x0 + b0, xrows, nx, lanes, live, B);
  }
}

template <int MX, int MU, bool FAC64, bool ROWS_SHARED, bool FULL>
cudaError_t launch_chunk(const ChunkArgs& p, size_t smem_bytes, cudaStream_t st) {
  const size_t fac = (FAC64 || p.fac_shared)
                         ? ((FAC64 ? sizeof(double) : sizeof(float)) *
                                factor_count(FAC64, MX, MU, p.N, p.nx, p.nu) + 15) / 16 * 16
                         : 0;
  const int xrows = split_x_rows(p.N, p.split_interior, p.split_terminal, p.terminal_ball);
  const size_t rows =
      ROWS_SHARED ? sizeof(float) * p.lanes *
                        (3 * static_cast<size_t>(p.N) * p.nu + 2 * static_cast<size_t>(xrows) * p.nx)
                  : 0;
  // the host's plan and this layout must agree
  if (fac + rows != smem_bytes || smem_bytes > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = riccati_admm_chunk_kernel<MX, MU, FAC64, ROWS_SHARED, FULL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  const int blocks = (p.B + p.lanes - 1) / p.lanes;
  kernel<<<blocks, kThreads, smem_bytes, st>>>(p);
  return cudaGetLastError();
}

// ROUTE as launch_tier takes it; the plant picks the unpredicated instantiation
template <int MX, int MU, int ROUTE>
cudaError_t launch_route(const ChunkArgs& p, size_t smem_bytes, cudaStream_t st) {
  constexpr bool FAC64 = ROUTE == 0, ROWS_SHARED = ROUTE != 2;
  return (p.nx == MX && p.nu == MU)
             ? launch_chunk<MX, MU, FAC64, ROWS_SHARED, true>(p, smem_bytes, st)
             : launch_chunk<MX, MU, FAC64, ROWS_SHARED, false>(p, smem_bytes, st);
}

}  // namespace

#define MPC_K3_TIER_ROUTE(TIER, MX, MU, ROUTE)                                      \
  template <>                                                                       \
  cudaError_t mpc_k3::launch_tier<TIER, ROUTE>(ChunkArgs p, size_t smem_bytes,      \
                                               cudaStream_t st) {                   \
    return launch_route<MX, MU, ROUTE>(p, smem_bytes, st);                          \
  }
