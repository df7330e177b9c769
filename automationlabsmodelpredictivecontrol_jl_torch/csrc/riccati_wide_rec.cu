// The Riccati drivers' two per-lane recurrences at any width: the warm and
// zero-input rollouts and the infeasibility certificate's terms (the
// drivers' _start and _check in ops/riccati_fused.py; K3's own versions,
// riccati_admm.cu, are register-tiered up to (32, 16)).
//
// riccati_wide_rollout replaces the JAX package's ops/riccati.py
// rollout_warm (:562-570): X_0 = e0, X_{k+1} = A X_k + B U_k.
// riccati_wide_certificate replaces the terms of its infeas_certificate
// (:515-559): along the adjoint g_N = dlamX_N, g_k = A' g_{k+1} + dlamX_k,
// max_k |B' g_{k+1} + dlamU_k|; the box and ball supports of the dual delta
// less <dlamX, Xbar>; max |dlam| (dlam = lam_new - lam_old).
//
// What bounds them on this card: each is a chain of N dependent products
// a lane (N x nx dependent fp64 multiply-adds: the chain floor), beside
// N nx (nx + nu) multiply-adds a lane in all. A horizon step's sums take
// three quarters of its clocks at B = 1 and at the drivers' large batches
// (scripts/wide_rec_phase_probe.py); the dual deltas' global loads and the
// step's barrier take the rest. At 8 lanes an SM the sums run 13-16 fp64
// multiply-adds a clock an SM, whatever the tile, the warps (3-12) or the
// shared-memory bytes a multiply-add (6-12) (PERF.md); the fp32 -> fp64
// widening (15 a clock an SM, scripts/cvt_rate_probe.py) is kept out of
// the loop by the fp64 operators and state.
//
// Design:
// - A block takes `lanes` consecutive lanes (1-32), and every lane-last
//   array is read and written as rows of `lanes` contiguous floats, each
//   entry once. The rollout's U rows, which every row of B u reads, are
//   loaded into registers where the step before their use starts and
//   stored into one of two slots in shared memory where it ends (on this
//   card 4-byte cp.async copies took longer to start than the loads); the
//   certificate's dual deltas and Xbar are read only by the thread that
//   owns their (row, lane), straight into registers before the product that
//   hides their latency.
// - The operators (A' and B' for the rollout, read from the host's A.T and
//   B.T; A and B for the certificate) are staged once per block into
//   shared memory [j][row], widened to fp64 where they fit ("fp64"), else
//   as fp32 ("fp32"), else read where they lie, through L1/L2 ("global"),
//   kBatch loads a thread in flight. A warp's loads of a column j are one
//   16-byte run a row group, broadcast over its lane groups.
// - A thread takes a register tile of RT rows x LT lanes, (2, 2) or, where
//   that leaves a block few threads (at B = 1), (1, 1): each operator entry
//   is widened once for its LT lanes, each lane entry once for its RT rows
//   (the state the chain carries, e and g, is kept in shared memory already
//   widened, by the thread that forms it).
//   Every sum runs in column order j = 0..n-1, as dot64 does; a thread loads
//   a few columns before it multiplies them, so that a shared-memory load's
//   latency overlaps other columns' multiply-adds.
// - Off the chain: the rollout forms B u_{k+1} beside A e_k, one step ahead
//   (kept in shared memory by the thread that uses it), so the chain
//   carries only A e; the certificate forms B' g_{k+1} beside A' g_{k+1}
//   (rows [0, nxp) of its tile space are A', rows [nxp, nxp + nup) B'),
//   and folds each dual delta, where the chain or the residual reads it,
//   into the box supports, <dlamX, Xbar> and max |dlam|. Each lane's
//   partials are reduced across the block by warp shuffles, then over the
//   warps in order; the ball's ||dlamX_N|| sums its squares in row order.
// - One barrier a horizon step. At B = 1 (the runtime's step) a lane's
//   rows are spread over the threads (RT = 1), and the step is its chain.
// - Where a block's lane buffers do not fit shared memory even at one lane,
//   they lie in a device scratch (route "device"; one lane, RT = LT = 1, the
//   operators through L1/L2): any width the drivers take.
// The host's plan (ops/riccati_fused.wide_recurrence_plan) picks the
// lanes, the tile, the threads, the placement and the route;
// rollout_layout / certificate_layout place them, and the entries refuse
// shared-memory bytes that differ.
//
// Precision: fp32 state, each product exact fp32 products summed in fp64
// in column order and rounded once; built with --fmad=false each kernel
// agrees with its plain version bit for bit (riccati.rollout_warm;
// certificate_terms_plain, whose long fp64 sums of row 1 the kernel forms in
// another order before the one rounding).
//
// Bound to PyTorch by ctypes through plain C functions that return
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr size_t kSmemLimit = 232448;
// the most threads of a block (WIDE_REC_MAX_THREADS)
constexpr int kRecMaxThreads = 512;
constexpr int kRecMaxLanes = 32;
// the rollout's slots of U (WIDE_REC_RING): the one a step reads, and the
// one the next step's U goes to where it ends
constexpr int kRing = 2;
// the operator entries a thread loads before it stores them
constexpr int kBatch = 16;
// the staged floats of U a thread holds in registers a step (more go
// through a loop where the step ends)
constexpr int kRollStage = 4;

__host__ __device__ inline size_t a16(size_t n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline int pad_to(int n, int m) { return (n + m - 1) / m * m; }

// jnp.maximum-style max that propagates NaN, as torch.amax does
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

// Where a block's regions lie, in bytes, each 16-byte aligned: the
// operators (fp64 or fp32, [j][row]; none when read through L1/L2), the
// certificate's reduction (a warp's partials of each lane), and the lane
// buffers, in shared memory (route 0) or in the block's part of a device
// scratch (route 1). ops/riccati_fused.wide_rec_bytes mirrors both.
struct RecLayout {
  size_t ops, red, e, u, bu, lane, total;
};

// the bytes of an operator entry by placement (none through L1/L2)
__host__ __device__ inline size_t op_width(int place) {
  return place == 0 ? 8 : place == 1 ? 4 : 0;
}

// The rollout: E (two slots of e_k, [row][lane], fp64), U (kRing slots of
// a step's U, fp32) and BU (B u_{k+1}, [row][lane], fp32).
__host__ __device__ inline RecLayout rollout_layout(int nx, int nu, int lanes, int rt, int place,
                                                    int route) {
  RecLayout d;
  const size_t x = nx, u = nu, l = lanes, xp = pad_to(nx, rt);
  d.ops = a16(op_width(place) * (x + u) * xp);
  d.red = 0;
  d.e = a16(16 * x * l);
  d.u = a16(4 * kRing * u * l);
  d.bu = a16(4 * xp * l);
  d.lane = d.e + d.u + d.bu;
  d.total = d.ops + d.red + d.lane * (route == 0);
  return d;
}

// The certificate: G (two slots of g_k, fp64); the reduction holds 4 fp64
// and 2 fp32 partials a warp and lane.
__host__ __device__ inline RecLayout certificate_layout(int nx, int nu, int lanes, int rt,
                                                        int threads, int place, int route) {
  RecLayout d;
  const size_t x = nx, l = lanes, w = threads / 32;
  const size_t cols = pad_to(nx, rt) + pad_to(nu, rt);
  d.ops = a16(op_width(place) * x * cols);
  d.red = a16(40 * w * l);
  d.e = a16(16 * x * l);
  d.u = 0;
  d.bu = 0;
  d.lane = d.e + d.u + d.bu;
  d.total = d.ops + d.red + d.lane * (route == 0);
  return d;
}

// One operator as a thread reads it: entry (j, c) of rows [j][c] at row
// stride ld. In shared memory (PLACE 0: fp64, 1: fp32) c is the tile
// space's row; through L1/L2 (PLACE 2) the source's own column c - c0,
// clamped to its last one (rows past it are padding, never stored).
struct Op {
  const void* p;
  int ld, c0, cmax;
};

// A thread's walk down the columns j of an operator tile: RT entries of
// row j from column c (in shared memory, PLACE 0: fp64, 1: fp32; through
// L1/L2, PLACE 2, each tile row's source column clamped once), widened.
template <int RT, int PLACE>
struct OpCursor {
  const char* q;
  size_t step;
  int col[PLACE == 2 ? RT : 1];

  __device__ __forceinline__ OpCursor(const Op& m, int c) {
    const size_t w = PLACE == 0 ? 8 : 4;
    step = w * static_cast<size_t>(m.ld);
    q = static_cast<const char*>(m.p) + (PLACE == 2 ? 0 : w * c);
#pragma unroll
    for (int r = 0; r < (PLACE == 2 ? RT : 1); ++r) col[r] = min(c - m.c0 + r, m.cmax);
  }
  __device__ __forceinline__ void next() { q += step; }
  __device__ __forceinline__ void load(double (&w)[RT]) const {
    if constexpr (PLACE == 0) {
      const double* d = reinterpret_cast<const double*>(q);
      if constexpr (RT == 1) {
        w[0] = d[0];
      } else {
#pragma unroll
        for (int r = 0; r < RT; r += 2) {
          const double2 v = *reinterpret_cast<const double2*>(d + r);
          w[r] = v.x, w[r + 1] = v.y;
        }
      }
    } else if constexpr (PLACE == 1) {
      const float* f = reinterpret_cast<const float*>(q);
      if constexpr (RT == 2) {
        const float2 v = *reinterpret_cast<const float2*>(f);
        w[0] = v.x, w[1] = v.y;
      } else {
        w[0] = f[0];
      }
    } else {
      const float* f = reinterpret_cast<const float*>(q);
#pragma unroll
      for (int r = 0; r < RT; ++r) w[r] = __ldg(f + col[r]);
    }
  }
};

// A thread's walk down the rows j of a [row][lane] buffer of `lanes`
// lanes: its LT lanes from l0, widened (fp64, or fp32).
template <int LT, typename TV>
struct LaneCursor {
  const TV* q;
  int lanes;

  __device__ __forceinline__ LaneCursor(const TV* v, int lanes_, int l0)
      : q(v + l0), lanes(lanes_) {}
  __device__ __forceinline__ void next() { q += lanes; }
  __device__ __forceinline__ void load(double (&out)[LT]) const {
    if constexpr (LT == 1) {
      out[0] = q[0];
    } else if constexpr (sizeof(TV) == 8) {
#pragma unroll
      for (int c = 0; c < LT; c += 2) {
        const double2 t = *reinterpret_cast<const double2*>(q + c);
        out[c] = t.x, out[c + 1] = t.y;
      }
    } else {
      const float2 t = *reinterpret_cast<const float2*>(q);
      out[0] = t.x, out[1] = t.y;
    }
  }
};

// One column of a tile's sums, the cursors then moved to the next:
// acc[r][q] = w[r] v[q] at the first column (FIRST, as dot64 starts), a
// multiply-add after it.
template <bool FIRST, int RT, int LT, int PLACE, typename TV>
__device__ __forceinline__ void tile_col(double (&acc)[RT][LT], OpCursor<RT, PLACE>& m,
                                         LaneCursor<LT, TV>& v) {
  double w[RT], x[LT];
  m.load(w);
  v.load(x);
  m.next();
  v.next();
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int q = 0; q < LT; ++q) acc[r][q] = FIRST ? w[r] * x[q] : fma(w[r], x[q], acc[r][q]);
}

// The columns whose loads a thread starts before their multiply-adds: the
// loop's ILP (the chain's multiply-adds wait on nothing but each other).
constexpr int kColsAhead = 4;

// kC columns of a tile's sums after the first: every load first, then the
// multiply-adds column by column.
template <int kC, int RT, int LT, int PLACE, typename TV>
__device__ __forceinline__ void tile_cols(double (&acc)[RT][LT], OpCursor<RT, PLACE>& m,
                                          LaneCursor<LT, TV>& v) {
  double w[kC][RT], x[kC][LT];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    m.load(w[c]);
    v.load(x[c]);
    m.next();
    v.next();
  }
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int q = 0; q < LT; ++q) acc[r][q] = fma(w[c][r], x[c][q], acc[r][q]);
}

// A tile's sums of length n >= 1 (rows from column c, lanes from l0), in
// column order.
template <int RT, int LT, int PLACE, typename TV>
__device__ __forceinline__ void tile_dot(double (&a)[RT][LT], const Op& m, const TV* v, int n,
                                         int lanes, int c, int l0) {
  constexpr int kC = kColsAhead;
  OpCursor<RT, PLACE> mc(m, c);
  LaneCursor<LT, TV> vc(v, lanes, l0);
  tile_col<true>(a, mc, vc);
  int j = 1;
  for (; j + kC <= n; j += kC) tile_cols<kC>(a, mc, vc);
  for (; j < n; ++j) tile_col<false>(a, mc, vc);
}

// Two tiles' sums of lengths n1 >= 1 and n2 (0: the second is not formed),
// their common columns interleaved so that the second fills the first's
// latency; each in column order.
template <int RT, int LT, int PLACE, typename TV1, typename TV2>
__device__ __forceinline__ void tile_dot2(double (&a)[RT][LT], const Op& m1, const TV1* v1,
                                          int n1, double (&b)[RT][LT], const Op& m2,
                                          const TV2* v2, int n2, int lanes, int c, int l0) {
  if (n2 == 0) {
    tile_dot<RT, LT, PLACE>(a, m1, v1, n1, lanes, c, l0);
    return;
  }
  constexpr int kC = kColsAhead / 2;
  OpCursor<RT, PLACE> mc1(m1, c), mc2(m2, c);
  LaneCursor<LT, TV1> vc1(v1, lanes, l0);
  LaneCursor<LT, TV2> vc2(v2, lanes, l0);
  tile_col<true>(a, mc1, vc1);
  tile_col<true>(b, mc2, vc2);
  const int common = min(n1, n2);
  int j = 1;
  for (; j + kC <= common; j += kC) {
    tile_cols<kC>(a, mc1, vc1);
    tile_cols<kC>(b, mc2, vc2);
  }
  for (; j < common; ++j) {
    tile_col<false>(a, mc1, vc1);
    tile_col<false>(b, mc2, vc2);
  }
  constexpr int kC1 = kColsAhead;
  int j1 = common;
  for (; j1 + kC1 <= n1; j1 += kC1) tile_cols<kC1>(a, mc1, vc1);
  for (; j1 < n1; ++j1) tile_col<false>(a, mc1, vc1);
  int j2 = common;
  for (; j2 + kC1 <= n2; j2 += kC1) tile_cols<kC1>(b, mc2, vc2);
  for (; j2 < n2; ++j2) tile_col<false>(b, mc2, vc2);
}

// U's rows [row0, row0 + nu) for the block's lanes ([row][lane], `lanes` =
// 2^lg2 lanes), `total` floats (0: none): a thread's first kRollStage of
// them (e = tid + s T) loaded into registers where a step starts and stored
// into a slot where it ends, so that their latency overlaps the step's
// products; any past kRollStage T loaded and stored at the end. Lanes past
// the batch are zeros.
struct UStage {
  const float* src;
  int total, lg2, B, b0, live, tid, T;
  float v[kRollStage];

  __device__ __forceinline__ float at(int e) const {
    const int l = e & ((1 << lg2) - 1);
    return l < live ? src[static_cast<size_t>(e >> lg2) * B + b0 + l] : 0.0f;
  }
  __device__ __forceinline__ void load() {
#pragma unroll
    for (int s = 0; s < kRollStage; ++s) {
      const int e = tid + s * T;
      v[s] = e < total ? at(e) : 0.0f;
    }
  }
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int s = 0; s < kRollStage; ++s) {
      const int e = tid + s * T;
      if (e < total) dst[e] = v[s];
    }
    for (int e = tid + kRollStage * T; e < total; e += T) dst[e] = at(e);
  }
};

// the operators [j][c] into shared memory (PLACE 0: fp64, 1: fp32), `cols`
// columns a row, zeros where no entry lies: the rollout's A' (rows j < n1)
// then B' (rows past them), each w1 wide; the certificate's A (columns c <
// w1) beside B (columns [c2, c2 + w2)). A thread's kBatch loads are in
// flight at once.
template <int PLACE>
__device__ void stage_ops(void* dst, int rows, int cols, const float* __restrict__ m1, int n1,
                          int w1, const float* __restrict__ m2, int w2, int c2, int split_cols,
                          int tid, int T) {
  const int n = rows * cols;
  for (int e0 = tid; e0 < n; e0 += kBatch * T) {  // kBatch loads in flight a thread
    float v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * T, j = e / cols, c = e - j * cols;
      v[b] = 0.0f;
      if (e >= n) continue;
      if (split_cols) {  // the certificate: [A[j] | B[j]] side by side
        if (c < w1) v[b] = m1[static_cast<size_t>(j) * w1 + c];
        else if (c >= c2 && c - c2 < w2) v[b] = m2[static_cast<size_t>(j) * w2 + c - c2];
      } else if (c < w1) {  // the rollout: A' rows then B' rows
        v[b] = j < n1 ? m1[static_cast<size_t>(j) * w1 + c]
                      : m2[static_cast<size_t>(j - n1) * w1 + c];
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * T;
      if (e >= n) continue;
      if constexpr (PLACE == 0) static_cast<double*>(dst)[e] = static_cast<double>(v[b]);
      else static_cast<float*>(dst)[e] = v[b];
    }
  }
}

struct RollArgs {
  const float *AT, *BT, *e0, *U;
  float *X, *scratch;
  int N, nx, nu, B, lanes;
  RecLayout lay;
};

// X_0 = e0, X_{k+1} = A X_k + B U_k for the block's lanes.
template <int RT, int LT, int PLACE, bool DEV>
__global__ void __launch_bounds__(kRecMaxThreads, 1)
riccati_wide_rollout_kernel(const RollArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, nx = p.nx, nu = p.nu, B = p.B, lanes = p.lanes;
  const int tid = threadIdx.x, T = blockDim.x;
  const int b0 = blockIdx.x * lanes, live = min(lanes, B - b0);
  const int LG = lanes / LT, lg = tid % LG, RG = pad_to(nx, RT) / RT, RGS = T / LG;
  const int l0 = lg * LT, xp = pad_to(nx, RT);
  unsigned char* lane = DEV ? reinterpret_cast<unsigned char*>(p.scratch) +
                                  static_cast<size_t>(blockIdx.x) * p.lay.lane
                            : smem + p.lay.ops;
  double* E = reinterpret_cast<double*>(lane);               // [2][nx][lanes]
  float* Us = reinterpret_cast<float*>(lane + p.lay.e);      // [kRing][nu][lanes]
  float* BU = reinterpret_cast<float*>(lane + p.lay.e + p.lay.u);  // [xp][lanes]
  const size_t es = static_cast<size_t>(nx) * lanes, us = static_cast<size_t>(nu) * lanes;

  Op mA, mB;
  if constexpr (PLACE == 2) {
    mA = Op{p.AT, nx, 0, nx - 1};
    mB = Op{p.BT, nx, 0, nx - 1};
  } else {
    stage_ops<PLACE>(smem, nx + nu, xp, p.AT, nx, nx, p.BT, 0, 0, 0, tid, T);
    const size_t w = PLACE == 0 ? 8 : 4;
    mA = Op{smem, xp, 0, 0};
    mB = Op{smem + w * nx * xp, xp, 0, 0};
  }
  // e0 (row 0 of X), U_0 and U_1
  for (int e = tid; e < nx * lanes; e += T) {
    const int i = e / lanes, l = e - i * lanes;
    const float v = l < live ? p.e0[static_cast<size_t>(i) * B + b0 + l] : 0.0f;
    E[e] = static_cast<double>(v);
    if (l < live) p.X[static_cast<size_t>(i) * B + b0 + l] = v;
  }
  const int lg2 = __ffs(lanes) - 1;
  const auto u_rows = [&](int k) {  // U_k, none past the horizon
    return UStage{p.U + static_cast<size_t>(k) * nu * B, k < N ? nu * lanes : 0, lg2, B, b0,
                  live, tid, T};
  };
  for (int k = 0; k < kRing; ++k) {  // U_0, U_1
    UStage st = u_rows(k);
    st.load();
    st.store(Us + k * us);
  }
  __syncthreads();
  // B u_0, kept by the thread that adds it
  for (int rg = tid / LG; rg < RG; rg += RGS) {
    double b[RT][LT];
    tile_dot<RT, LT, PLACE>(b, mB, Us, nu, lanes, rg * RT, l0);
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int q = 0; q < LT; ++q)
        BU[static_cast<size_t>(rg * RT + r) * lanes + l0 + q] = static_cast<float>(b[r][q]);
  }
  __syncthreads();  // U_0's slot is free

  for (int k = 0; k < N; ++k) {
    const double* cur = E + (k & 1) * es;
    double* nxt = E + ((k + 1) & 1) * es;
    const float* un = Us + ((k + 1) % kRing) * us;  // U_{k+1}
    UStage st = u_rows(k + 2);  // U_{k+2}, a step ahead
    st.load();
    const int n2 = k + 1 < N ? nu : 0;
    for (int rg = tid / LG; rg < RG; rg += RGS) {
      const int c = rg * RT;
      double a[RT][LT], b[RT][LT];
      tile_dot2<RT, LT, PLACE>(a, mA, cur, nx, b, mB, un, n2, lanes, c, l0);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (c + r >= nx) continue;
        float* bu = BU + static_cast<size_t>(c + r) * lanes + l0;
        float* x = p.X + (static_cast<size_t>(k + 1) * nx + c + r) * B + b0 + l0;
#pragma unroll
        for (int q = 0; q < LT; ++q) {
          const float v = static_cast<float>(a[r][q]) + bu[q];
          nxt[static_cast<size_t>(c + r) * lanes + l0 + q] = static_cast<double>(v);
          if (l0 + q < live) x[q] = v;
          if (n2) bu[q] = static_cast<float>(b[r][q]);
        }
      }
    }
    st.store(Us + (k % kRing) * us);  // into U_k's slot
    __syncthreads();
  }
}

struct CertArgs {
  const float *A, *Bm, *xlo, *xhi, *xNlo, *xNhi, *ulo, *uhi;
  const float *lamX_new, *lamX_old, *lamU_new, *lamU_old, *Xbar, *ballr;
  float *out, *scratch;
  int N, nx, nu, B, si, st, ball, lanes;
  RecLayout lay;
};

// The certificate's three terms of the block's lanes.
template <int RT, int LT, int PLACE, bool DEV>
__global__ void __launch_bounds__(kRecMaxThreads, 1)
riccati_wide_certificate_kernel(const CertArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, nx = p.nx, nu = p.nu, B = p.B, lanes = p.lanes;
  const int tid = threadIdx.x, T = blockDim.x;
  const int b0 = blockIdx.x * lanes, live = min(lanes, B - b0);
  const int xp = pad_to(nx, RT), cols = xp + pad_to(nu, RT);
  const int LG = lanes / LT, lg = tid % LG, RG = cols / RT, RGS = T / LG, l0 = lg * LT;
  unsigned char* lane = DEV ? reinterpret_cast<unsigned char*>(p.scratch) +
                                  static_cast<size_t>(blockIdx.x) * p.lay.lane
                            : smem + p.lay.ops + p.lay.red;
  double* G = reinterpret_cast<double*>(lane);  // [2][nx][lanes]
  const size_t gs = static_cast<size_t>(nx) * lanes;

  Op mA, mB;
  if constexpr (PLACE == 2) {
    mA = Op{p.A, nx, 0, nx - 1};
    mB = Op{p.Bm, nu, xp, nu - 1};
  } else {
    stage_ops<PLACE>(smem, nx, cols, p.A, nx, nx, p.Bm, nu, xp, 1, tid, T);
    mA = mB = Op{smem, cols, 0, 0};
  }
  // a thread's partials, a tile lane each
  double s_u[LT], s_int[LT], s_term[LT], xb[LT];
  float ortho[LT], dn[LT];
#pragma unroll
  for (int q = 0; q < LT; ++q) {
    s_u[q] = s_int[q] = s_term[q] = xb[q] = 0.0;
    ortho[q] = dn[q] = 0.0f;
  }
  // the entry of a lane-last array (rows, B) at (row, lane l0 + q), zero
  // past the batch: each read once, by the thread that owns it
  const auto at = [&](const float* a, int row, int q) {
    return l0 + q < live ? a[static_cast<size_t>(row) * B + b0 + l0 + q] : 0.0f;
  };

  // g_N = dlamX_N and row N's terms
  const bool box_n = p.st && !p.ball;
  for (int rg = tid / LG; rg < RG; rg += RGS) {
    const int c = rg * RT;
    if (c >= xp) break;  // the A' rows' tiles come first
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int i = c + r;
      if (i >= nx) continue;
      const int row = N * nx + i;
#pragma unroll
      for (int q = 0; q < LT; ++q) {
        const float d = at(p.lamX_new, row, q) - at(p.lamX_old, row, q);
        G[(N & 1) * gs + static_cast<size_t>(i) * lanes + l0 + q] = static_cast<double>(d);
        dn[q] = nanmax(dn[q], fabsf(d));
        xb[q] = fma(static_cast<double>(d), static_cast<double>(at(p.Xbar, row, q)), xb[q]);
        if (box_n) s_term[q] += static_cast<double>(box_term(d, p.xNlo[i], p.xNhi[i]));
      }
    }
  }
  __syncthreads();
  double sq = 0.0;  // ||dlamX_N||^2 of lane tid, in row order
  if (p.ball && tid < live) {
    const double* g = G + (N & 1) * gs;
    sq = g[tid] * g[tid];
    for (int i = 1; i < nx; ++i) sq = fma(g[static_cast<size_t>(i) * lanes + tid],
                                          g[static_cast<size_t>(i) * lanes + tid], sq);
  }

  for (int k = N - 1; k >= 0; --k) {
    const double* gn = G + ((k + 1) & 1) * gs;  // g_{k+1}
    double* gk = G + (k & 1) * gs;
    for (int rg = tid / LG; rg < RG; rg += RGS) {
      const int c = rg * RT;
      double a[RT][LT];
      if (c < xp) {  // A' g_{k+1} (no g_0 is formed), then dlamX_k
        // the tile's entries of step k, loaded before the product that
        // hides their latency
        float dnew[RT][LT], dold[RT][LT], xbar[RT][LT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < LT; ++q) {
            const int row = k * nx + min(c + r, nx - 1);
            dnew[r][q] = at(p.lamX_new, row, q);
            dold[r][q] = at(p.lamX_old, row, q);
            xbar[r][q] = at(p.Xbar, row, q);
          }
        if (k >= 1) tile_dot<RT, LT, PLACE>(a, mA, gn, nx, lanes, c, l0);
        const bool interior = p.si && k >= 1;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int i = c + r;
          if (i >= nx) continue;
          const float lo = interior ? p.xlo[i] : 0.0f, hi = interior ? p.xhi[i] : 0.0f;
#pragma unroll
          for (int q = 0; q < LT; ++q) {
            const float d = dnew[r][q] - dold[r][q];
            if (k >= 1)
              gk[static_cast<size_t>(i) * lanes + l0 + q] =
                  static_cast<double>(static_cast<float>(a[r][q]) + d);
            dn[q] = nanmax(dn[q], fabsf(d));
            xb[q] = fma(static_cast<double>(d), static_cast<double>(xbar[r][q]), xb[q]);
            if (interior) s_int[q] += static_cast<double>(box_term(d, lo, hi));
          }
        }
      } else {  // B' g_{k+1} + dlamU_k
        float unew[RT][LT], uold[RT][LT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < LT; ++q) {
            const int row = k * nu + min(c + r - xp, nu - 1);
            unew[r][q] = at(p.lamU_new, row, q);
            uold[r][q] = at(p.lamU_old, row, q);
          }
        tile_dot<RT, LT, PLACE>(a, mB, gn, nx, lanes, c, l0);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int i = c + r - xp;
          if (i >= nu) continue;
          const float lo = p.ulo[i], hi = p.uhi[i];
#pragma unroll
          for (int q = 0; q < LT; ++q) {
            const float du = unew[r][q] - uold[r][q];
            ortho[q] = nanmax(ortho[q], fabsf(static_cast<float>(a[r][q]) + du));
            dn[q] = nanmax(dn[q], fabsf(du));
            s_u[q] += static_cast<double>(box_term(du, lo, hi));
          }
        }
      }
    }
    __syncthreads();
  }

  // each lane's partials: over a warp's row groups by shuffles, then over
  // the warps in order
  double* R = reinterpret_cast<double*>(smem + p.lay.ops);  // [warp][4][lanes]
  const int W = T / 32, w = tid / 32;
  float* F = reinterpret_cast<float*>(R + static_cast<size_t>(W) * 4 * lanes);  // [warp][2][lanes]
#pragma unroll
  for (int q = 0; q < LT; ++q) {
    for (int off = 16; off >= LG; off >>= 1) {
      s_u[q] += __shfl_xor_sync(0xffffffffu, s_u[q], off);
      s_int[q] += __shfl_xor_sync(0xffffffffu, s_int[q], off);
      s_term[q] += __shfl_xor_sync(0xffffffffu, s_term[q], off);
      xb[q] += __shfl_xor_sync(0xffffffffu, xb[q], off);
      ortho[q] = nanmax(ortho[q], __shfl_xor_sync(0xffffffffu, ortho[q], off));
      dn[q] = nanmax(dn[q], __shfl_xor_sync(0xffffffffu, dn[q], off));
    }
    if (tid % 32 < LG) {
      const size_t l = l0 + q;
      R[(static_cast<size_t>(w) * 4 + 0) * lanes + l] = s_u[q];
      R[(static_cast<size_t>(w) * 4 + 1) * lanes + l] = s_int[q];
      R[(static_cast<size_t>(w) * 4 + 2) * lanes + l] = s_term[q];
      R[(static_cast<size_t>(w) * 4 + 3) * lanes + l] = xb[q];
      F[(static_cast<size_t>(w) * 2 + 0) * lanes + l] = ortho[q];
      F[(static_cast<size_t>(w) * 2 + 1) * lanes + l] = dn[q];
    }
  }
  __syncthreads();
  if (tid >= live) return;  // no barrier follows
  double su = 0.0, sint = 0.0, sterm = 0.0, sxb = 0.0;
  float o = 0.0f, d = 0.0f;
  for (int v = 0; v < W; ++v) {
    su += R[(static_cast<size_t>(v) * 4 + 0) * lanes + tid];
    sint += R[(static_cast<size_t>(v) * 4 + 1) * lanes + tid];
    sterm += R[(static_cast<size_t>(v) * 4 + 2) * lanes + tid];
    sxb += R[(static_cast<size_t>(v) * 4 + 3) * lanes + tid];
    o = nanmax(o, F[(static_cast<size_t>(v) * 2 + 0) * lanes + tid]);
    d = nanmax(d, F[(static_cast<size_t>(v) * 2 + 1) * lanes + tid]);
  }
  const int b = b0 + tid;
  float s_c = static_cast<float>(su);
  if (p.si) s_c = s_c + static_cast<float>(sint);
  if (p.ball)
    s_c = s_c + p.ballr[b] * sqrtf(static_cast<float>(sq));
  else if (p.st)
    s_c = s_c + static_cast<float>(sterm);
  p.out[b] = o;
  p.out[B + b] = s_c - static_cast<float>(sxb);
  p.out[2 * static_cast<size_t>(B) + b] = d;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The instantiated (RT, LT) tiles (WIDE_REC_TILES): 0 (1, 1), 1 (2, 2);
// -1 otherwise.
int tile_index(int rt, int lt) {
  return rt == 1 && lt == 1 ? 0 : rt == 2 && lt == 2 ? 1 : -1;
}

// The plan's checks shared by both entries: lanes a power of two (1-32),
// a tile that divides them, whole warps up to kRecMaxThreads, a
// placement, and the device route only with one lane, RT = LT = 1 and the
// operators through L1/L2.
bool plan_ok(int lanes, int threads, int rt, int lt, int place, int route) {
  return lanes >= 1 && lanes <= kRecMaxLanes && (lanes & (lanes - 1)) == 0 &&
         tile_index(rt, lt) >= 0 && lanes % lt == 0 && threads >= 32 && threads % 32 == 0 &&
         threads <= kRecMaxThreads && place >= 0 && place <= 2 &&
         (route == 0 || route == 1) &&
         (route == 0 || (lanes == 1 && rt == 1 && lt == 1 && place == 2));
}

#define MPC_REC_PICK(KERNEL, FN)                                                   \
  template <int PLACE>                                                             \
  auto FN##_place(int tile) {                                                      \
    return tile == 0 ? KERNEL<1, 1, PLACE, false> : KERNEL<2, 2, PLACE, false>;    \
  }                                                                                \
  auto FN(int tile, int place, int route) {                                        \
    if (route == 1) return KERNEL<1, 1, 2, true>;                                  \
    return place == 0 ? FN##_place<0>(tile) : place == 1 ? FN##_place<1>(tile)     \
                                                         : FN##_place<2>(tile);    \
  }

MPC_REC_PICK(riccati_wide_rollout_kernel, rollout_kernel_for)
MPC_REC_PICK(riccati_wide_certificate_kernel, certificate_kernel_for)
#undef MPC_REC_PICK

}  // namespace

extern "C" {

// X (N+1, nx, B) from e0 (nx, B) and U (N, nu, B); AT (nx, nx) = A' and BT
// (nu, nx) = B', float32 and contiguous on one device. The layout comes
// from the host's plan (ops/riccati_fused.wide_recurrence_plan): `lanes`
// lanes a block (a power of two, 1-32), `threads` threads (whole warps, at
// most 512), a tile of rows_per_thread x lanes_per_thread ((1, 1) or
// (2, 2)), the operators' placement (0: fp64 in shared
// memory, 1: fp32 there, 2: through L1/L2), the route of the lane buffers
// (0: shared memory; 1: `scratch`, lane_bytes / 4 floats a block, with one
// lane, the (1, 1) tile and placement 2) and smem_bytes =
// rollout_layout(...).total. Returns the cudaError_t of the launch.
int riccati_wide_rollout(const float* AT, const float* BT, const float* e0, const float* U,
                         float* X, float* scratch, int N, int nx, int nu, int B, int lanes,
                         int threads, int rows_per_thread, int lanes_per_thread, int place,
                         int route, int smem_bytes, void* stream) {
  if (N <= 0 || nx <= 0 || nu <= 0 || B <= 0 ||
      !plan_ok(lanes, threads, rows_per_thread, lanes_per_thread, place, route))
    return static_cast<int>(cudaErrorInvalidValue);
  RollArgs p;
  p.AT = AT, p.BT = BT, p.e0 = e0, p.U = U, p.X = X, p.scratch = scratch;
  p.N = N, p.nx = nx, p.nu = nu, p.B = B, p.lanes = lanes;
  p.lay = rollout_layout(nx, nu, lanes, rows_per_thread, place, route);
  // the host's plan and this layout must agree
  if (static_cast<size_t>(smem_bytes) != p.lay.total || (route == 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = rollout_kernel_for(tile_index(rows_per_thread, lanes_per_thread), place, route);
  const cudaError_t err = set_smem(kernel, p.lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + lanes - 1) / lanes;
  kernel<<<blocks, threads, p.lay.total, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// out (3, B): max_k |B' g_{k+1} + dlamU_k|, the support value and max |dlam|
// of each lane, from A (nx, nx), Bm (nx, nu), the boxes xlo, xhi, xNlo,
// xNhi (nx), ulo, uhi (nu), lamX_new/old, Xbar (N+1, nx, B), lamU_new/old
// (N, nu, B) and ballr (B); the layout as riccati_wide_rollout's, with
// smem_bytes = certificate_layout(...).total.
int riccati_wide_certificate(const float* A, const float* Bm, const float* xlo,
                             const float* xhi, const float* xNlo, const float* xNhi,
                             const float* ulo, const float* uhi, const float* lamX_new,
                             const float* lamX_old, const float* lamU_new,
                             const float* lamU_old, const float* Xbar, const float* ballr,
                             float* out, float* scratch, int N, int nx, int nu, int B,
                             int split_interior, int split_terminal, int terminal_ball,
                             int lanes, int threads, int rows_per_thread, int lanes_per_thread,
                             int place, int route, int smem_bytes, void* stream) {
  if (N <= 0 || nx <= 0 || nu <= 0 || B <= 0 ||
      !plan_ok(lanes, threads, rows_per_thread, lanes_per_thread, place, route))
    return static_cast<int>(cudaErrorInvalidValue);
  CertArgs p;
  p.A = A, p.Bm = Bm, p.xlo = xlo, p.xhi = xhi, p.xNlo = xNlo, p.xNhi = xNhi;
  p.ulo = ulo, p.uhi = uhi, p.lamX_new = lamX_new, p.lamX_old = lamX_old;
  p.lamU_new = lamU_new, p.lamU_old = lamU_old, p.Xbar = Xbar, p.ballr = ballr;
  p.out = out, p.scratch = scratch;
  p.N = N, p.nx = nx, p.nu = nu, p.B = B;
  p.si = split_interior, p.st = split_terminal, p.ball = terminal_ball, p.lanes = lanes;
  p.lay = certificate_layout(nx, nu, lanes, rows_per_thread, threads, place, route);
  if (static_cast<size_t>(smem_bytes) != p.lay.total || (route == 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = certificate_kernel_for(tile_index(rows_per_thread, lanes_per_thread), place, route);
  const cudaError_t err = set_smem(kernel, p.lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + lanes - 1) / lanes;
  kernel<<<blocks, threads, p.lay.total, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
