// K1 and K2 on Hopper, the stream route: `chunk` ADMM iterations of a batch
// of condensed QPs whose constraint matrix is diagonal (K1) or mixed,
// A = [diag(d); A2] with a dense tail A2 (K2), at the operator widths the
// shared routes (admm_diag.cu, admm_mixed.cu) do not take.
//
// Replaces the rest of ops/admm_pallas.py::_iterate_kernel_diag (K1) and
// _iterate_kernel_mixed (K2) of the JAX package: the widths their Pallas
// bodies take (admm_pallas.fused_fits: K1 up to n = 528 at tier 1's R = 2,
// 280 at tier 2, 288 at the default config; K2's state box up to n = 275,
// a tail of up to 550 rows) and the shared routes, which hold every rho's
// fp64 K^-1 in one block's shared memory (n <= 52-118) and a tail of at
// most 128 rows, do not. Same math as those two files, per lane and
// iteration (TAIL: K2):
//
//   TAIL: A'y = d.y[:n] + A2' y[n:];  A'(rho.s) split the same way
//   rhs = sigma x - q - A'y + A'(rho.s)        (K1: A' = diag(d))
//   xt  = K_r^-1 rhs;  refine_steps times: xt += K_r^-1 (rhs - K_r xt)
//   st  = [d.xt; A2 xt];  v = alpha st + (1-alpha) s
//   x = alpha xt + (1-alpha) x;  s = clip(v + rho^-1 y, l, u)
//   y += rho (v - s);  ax = alpha st + (1-alpha) ax
//
// One source, one kernel with the compile-time flag TAIL: K1 without a
// dense tail, K2 with one; ops/admm_fused.k1_plan and k2_plan take this
// route only where their shared route has no layout.
//
// How lanes meet their operators: the wrapper orders the lanes by rho index
// on the device (admm_fused.rho_order, no host sync) and each block takes
// up to 64 lanes of one index, reading and writing them through the order,
// so it needs one rho's operators: K^-1, K when refining, and for K2 A2'
// and A2, handed over by the wrapper as 4-byte entries in device memory
// (fp32 at "highest", the bf16 pair (hi, lo) at "bf16x3" and "default";
// admm_fused.kernel_operators(..., narrow=True)), rows padded to a multiple
// of 4. A block widens each entry once into the 8-byte entry its products
// read (admm_common.cuh, Prec) as it copies it into shared memory. Where
// one rho's widened operators fit the block's two panels whole they are
// copied once a chunk (resident: at n = 100 and the default config, K^-1
// and K take 163 KB); elsewhere each product streams its operator through
// the two panels, tile by tile, each tile's columns panel by panel.
//
// Each product is a small GEMM: the rho's operator (rows x columns) times
// the block's lanes' vectors (columns x lanes), register-tiled. The block
// is LG lane-groups by G row-groups; thread (g, t) takes lanes g + c LG
// (c < LT: 4 lanes a thread in blocks of 32 or 64 lanes, 2 in blocks of
// 16, 1 in smaller ones) and rows t + k G of each tile of RT G rows (k <
// RT: the plan's rows a thread, 8 or 4 in K1's blocks of 4 lanes a
// thread, 4 elsewhere; in K2's A2' pass, which sums A'y and A'(rho.s)
// together, tiles of 4 G rows), and holds the sums of those rows and
// lanes. So one 16-byte operator load from shared memory feeds 2 LT
// multiply-adds and one 16-byte vector load 2 RT; the strided rows and
// lanes keep a warp's loads free of bank conflicts. A row's owner is
// thread t = row mod G in
// every product. Every (row, lane) sum runs over its columns in index
// order from zero and is rounded once, as before.
//
// The copies of a streamed panel: each thread loads its share of the next
// panel (at most kStage 16-byte chunks) into registers before the barrier
// that opens the current one, and widens it into the other panel after
// its sums on the current one; one barrier a panel makes both complete.
//
// The lane's state lives in device memory: a block copies its lanes' state
// and inputs (x, s, y, ax, q, l, u) once a chunk from their scattered
// columns into a working copy in a scratch, a region of a column per lane
// for each block, so that a block's columns are neighbours and every
// iteration's reads and writes coalesce, and writes the outputs back once at its end (a thread
// owns the same rows and lanes in every product and update, so it alone
// reads and writes them). When refining, the refinement's rhs and xt in
// fp32 lie in the same scratch, read ahead of the epilogue that needs
// them. The vectors the products read lie in shared memory: the box rows'
// two buffers (rhs or the residual, xt) and K2's tail rows' two (y and
// rho.s), fp64 of L lanes.
//
// What bounds it on this card: the shared-memory loads that feed the fp64
// multiply-adds (a warp's 16-byte load takes 4 clocks of an SM, so 8 rows
// x 4 lanes a thread reach about 42 multiply-adds a clock of the 64 the
// SM has, 4 x 4 about 32: scripts/fp64_rate_probe.py) and, where the
// operators are streamed, the panels' copies from
// L2, 4 bytes an entry, one rho's operators a block of up to 64 lanes and
// iteration; the plan (ops/admm_fused._k12_stream_cost) weighs both. The
// working copy's reads and writes (about 11 floats a row, lane and
// iteration, coalesced) come on top.
//
// Precision, as in K1 and K2: the state is fp32; at "highest" every
// matrix-vector product is accumulated in fp64 from exact fp32 products in
// index order and rounded once; at "bf16x3" and "default" (the template
// parameter MODE, admm_common.cuh) each is that precision's passes over
// the operators' bf16 pairs and the vectors split when written to the
// lane buffers. The plain versions (admm_fused.iterate_chunk_diag_T_plain,
// iterate_chunk_mixed_T_plain) sum in the same order, so the two agree bit
// for bit. Built with --fmad=false so the elementwise updates round like
// PyTorch's.
//
// Shared memory: two panels of `panel` doubles; the box buffers, (n
// rounded up to even) x L doubles each; K2's tail buffers, likewise. Every
// thread reaches every barrier (the loops' bounds are the block's); spare
// blocks (each rho's partial last one leaves some) return before the
// first; lanes past their rho's count run on its last lane's inputs and
// store nothing to the state.
//
// Bound to PyTorch by ctypes through the plain C functions
// admm_diag_stream_chunk (K1) and admm_mixed_stream_chunk (K2), which
// return cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <type_traits>

#include "admm_common.cuh"

namespace {

using mpc_admm::clip;
using mpc_admm::panel_stride;
using mpc_admm::Prec;
using mpc_admm::slot;
using mpc_admm::widen4;

constexpr int kPassRows = 4;      // rows a thread takes in each tile of K2's A2' pass
constexpr int kThreads = 256;     // the most threads a block may have
constexpr int kWideLanes = 32;    // blocks of at least this many lanes: 4 lanes a thread
constexpr int kMidLanes = 16;     // blocks of this many: 2 lanes a thread; fewer, 1
constexpr int kStage = 8;         // 16-byte chunks of a streamed panel a thread stages
constexpr int kMaxWidth = 1024;   // the widest n, and K2's longest tail

__host__ __device__ constexpr int lanes_per_thread(int lanes) {
  return lanes >= kWideLanes ? 4 : lanes >= kMidLanes ? 2 : 1;
}

// whether a thread of K1 (TAIL false) or K2 takes `rows` rows in each tile
// of the products but K2's A2' pass: 4, or 8 in K1's blocks of 4 lanes a
// thread (K2's A2' pass's sums leave no registers for 8)
__host__ __device__ constexpr bool rows_fit(bool tail, int lt, int rows) {
  return rows == kPassRows || (rows == 2 * kPassRows && lt == 4 && !tail);
}

// the products of an iteration: K2's A2' pass (A'y and A'(rho.s) of the
// tail), the first K-solve, the refinement's K product and K-solve, K2's
// A2 xt
enum Kind { kAty, kSolve0, kKprod, kSolve, kAx };

struct Layout {
  int ldn, ldm;           // row strides (entries) in device memory: n and m - n rounded up to 4
  int nslots, tslots;     // lane buffer rows: the box's, the tail's
  int panel;              // doubles of one panel
  int sn, pn;             // row stride (doubles) and columns of a panel of an n-column operator
  int st, pt;             // the same for A2' (m - n columns)
  int resident;           // one rho's operators whole in the panels for the chunk
  int k_at, at_at, a_at;  // resident: where K, A2' and A2 start (K^-1 at 0)
};

// one operator of a product: its rows in device memory (rows x cols at
// stride ld), its panel's row stride and columns, where it sits when
// resident, and the rows of its tiles
struct Geo {
  const float* M;
  int rows, cols, ld, sp, pk, at, h;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <bool TAIL, int MODE, int LT, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
admm_stream_kernel(const float* __restrict__ kinv,  // (R, n, ldn) entries
                   const float* __restrict__ kmat,  // (R, n, ldn)
                   const float* __restrict__ a2t,   // TAIL: (n, ldm)
                   const float* __restrict__ a2,    // TAIL: (m - n, ldn)
                   const float* __restrict__ dvec,
                   const float* __restrict__ rho_vecs,  // (R, m)
                   const float* __restrict__ rho_invs,
                   const float* __restrict__ q, const float* __restrict__ l,
                   const float* __restrict__ u,
                   const int* __restrict__ order,
                   const int* __restrict__ starts,
                   const float* x_in, const float* s_in, const float* y_in,
                   const float* ax_in, float* x_out, float* s_out, float* y_out,
                   float* ax_out, float* scratch, int n, int m, int B, int R, int chunk,
                   int refine_steps, float sigma, float alpha, Layout lay) {
  using P = Prec<MODE>;
  using Entry = typename P::Entry;
  using Acc = typename P::Acc;
  extern __shared__ __align__(16) double smem[];
  const int LG = blockDim.x;  // lane-groups
  const int G = blockDim.y;   // row-groups
  const int L = LT * LG;
  const int g0 = threadIdx.x;
  const int t = threadIdx.y;
  const int tid = t * LG + g0;
  const int nthreads = LG * G;
  const int ms = m - n;

  // the block's lanes: one rho index's (mpc_admm::rho_block); the thread's
  // are g0 + c LG
  const mpc_admm::RhoBlock rb = mpc_admm::rho_block(starts, R, L);
  if (rb.r == R) return;  // a spare block: every thread, before any barrier
  const int r = rb.r;
  int lc[LT];
  bool live[LT];
#pragma unroll
  for (int c = 0; c < LT; ++c) {
    const int off = rb.off + g0 + c * LG;
    live[c] = off < rb.cnt;
    lc[c] = order[rb.seg + (live[c] ? off : rb.cnt - 1)];
  }

  const bool refine = refine_steps > 0;
  double* pan = smem;                        // two panels
  double* vbuf = pan + 2 * lay.panel;        // box rows: two buffers
  double* tbuf = vbuf + 2 * lay.nslots * L;  // K2's tail rows: y, then rho.s
  double* tbuf1 = tbuf + lay.tslots * L;
  // the lanes' working copy in the scratch, a region of L columns per
  // block, row i of lane c at [i * L + c * LG]: x (n rows), s, y, ax (m
  // rows each), q (n), l, u (m), and when refining the refinement's rhs
  // and xt (n); a block's columns are neighbours, so its accesses
  // coalesce, and offsets in the region fit an int whatever the batch
  const int region = (2 * n + 5 * m + (refine ? 2 * n : 0)) * L;
  float* wx = scratch + static_cast<long long>(blockIdx.x) * region + g0;
  float* ws = wx + n * L;
  float* wy = ws + m * L;
  float* wax = wy + m * L;
  float* wq = wax + m * L;
  float* wl = wq + n * L;
  float* wu = wl + m * L;
  float* rhs_f = wu + m * L;
  float* xt_f = rhs_f + n * L;
  const float* rho_r = rho_vecs + r * m;
  const float* rhoi_r = rho_invs + r * m;
  const float* ki_r = kinv + r * n * lay.ldn;
  const float* k_r = kmat + r * n * lay.ldn;
  const float beta = 1.0f - alpha;
  const int ps = 2 * L;   // doubles between a lane's row pairs
  const int cs = 2 * LG;  // doubles between a thread's lanes

  // the working copy of the inputs (a lane past its rho's count copies
  // its stand-in's) and the first product's vectors: K1's rhs, K2's tail
  // of y and rho.s. A thread copies the rows it owns: box row i and tail
  // row j (row n + j) where i, j = t mod G
  auto copy_in = [&](int row, int c) {
    const int g = row * B + lc[c];
    const int o = row * L + c * LG;
    ws[o] = s_in[g];
    wy[o] = y_in[g];
    wax[o] = ax_in[g];
    wl[o] = l[g];
    wu[o] = u[g];
  };
  for (int i = t; i < n; i += G) {
#pragma unroll
    for (int c = 0; c < LT; ++c) {
      copy_in(i, c);
      const int g = i * B + lc[c];
      const int o = i * L + c * LG;
      wx[o] = x_in[g];
      wq[o] = q[g];
      if constexpr (!TAIL) {
        const float d = dvec[i];
        const float rhs = sigma * wx[o] - wq[o] - d * wy[o] + d * (rho_r[i] * ws[o]);
        if (refine) rhs_f[o] = rhs;
        P::store(vbuf + slot(i, L, g0 + c * LG), P::entry(rhs));
      }
    }
  }
  if constexpr (TAIL) {
    for (int j = t; j < ms; j += G) {
#pragma unroll
      for (int c = 0; c < LT; ++c) {
        copy_in(n + j, c);
        const int o = (n + j) * L + c * LG;
        P::store(tbuf + slot(j, L, g0 + c * LG), P::entry(wy[o]));
        P::store(tbuf1 + slot(j, L, g0 + c * LG), P::entry(rho_r[n + j] * ws[o]));
      }
    }
  }

  // the products of an iteration, in order: K2's A2' pass, the first
  // solve, refine_steps times the K product and a solve, K2's A2 xt
  const int phases = 1 + 2 * refine_steps + (TAIL ? 2 : 0);
  const int last_solve = phases - (TAIL ? 2 : 1);
  auto kind_of = [&](int ph) {
    if (TAIL) {
      if (ph == 0) return kAty;
      if (ph == phases - 1) return kAx;
      --ph;
    }
    return ph == 0 ? kSolve0 : (ph & 1) ? kKprod : kSolve;
  };
  // one product's operator and its tiles' rows (kPassRows a thread in K2's
  // A2' pass, ROWS in the others)
  auto geo = [&](Kind kind) {
    if (TAIL && kind == kAty)
      return Geo{a2t, n, ms, lay.ldm, lay.st, lay.pt, lay.at_at, kPassRows * G};
    if (TAIL && kind == kAx) return Geo{a2, ms, n, lay.ldn, lay.sn, lay.pn, lay.a_at, ROWS * G};
    if (kind == kKprod) return Geo{k_r, n, n, lay.ldn, lay.sn, lay.pn, lay.k_at, ROWS * G};
    return Geo{ki_r, n, n, lay.ldn, lay.sn, lay.pn, 0, ROWS * G};
  };

  // a streamed panel's copy: fetch loads the thread's chunks of the panel
  // of phase ph, tile `tile`, columns panel cp into registers (chunk k of
  // the thread is chunk tid + k nthreads of the panel, row by row); put
  // widens them into a panel
  float4 stage[kStage];
  // the fetched panel's rows, chunks a row and stride; the thread's first
  // chunk (row, chunk in the row) and the step to its next
  int st_rows = 0, st_q = 1, st_sp = 0, st_row = 0, st_h = 0, st_drow = 0, st_dh = 0;
  auto fetch = [&](int ph, int tile, int cp) {
    const Geo g = geo(kind_of(ph));
    const int r0 = tile * g.h;
    const int c0 = cp * g.pk;
    st_rows = min(g.h, g.rows - r0);
    st_q = (min(g.pk, g.cols - c0) + 3) >> 2;
    st_sp = g.sp;
    st_row = tid / st_q;
    st_h = tid - st_row * st_q;
    st_drow = nthreads / st_q;
    st_dh = nthreads - st_drow * st_q;
    const float* src = g.M + r0 * g.ld + c0;
    int row = st_row, h = st_h;
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      if (row < st_rows) stage[k] = load4(src + row * g.ld + 4 * h);
      row += st_drow;
      h += st_dh;
      if (h >= st_q) {
        h -= st_q;
        ++row;
      }
    }
  };
  auto put = [&](double* dst) {
    int row = st_row, h = st_h;
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      if (row < st_rows) widen4<MODE>(dst + row * st_sp + 4 * h, stage[k]);
      row += st_drow;
      h += st_dh;
      if (h >= st_q) {
        h -= st_q;
        ++row;
      }
    }
  };
  // a resident operator's copy, once a chunk
  auto copy_whole = [&](double* dst, int sp, const float* src, int ld, int rows, int cols) {
    const int q4 = (cols + 3) >> 2;
#pragma unroll 4
    for (int e = tid; e < rows * q4; e += nthreads) {
      const int row = e / q4;
      const int h = 4 * (e - row * q4);
      widen4<MODE>(dst + row * sp + h, load4(src + row * ld + h));
    }
  };

  if (lay.resident) {
    copy_whole(pan, lay.sn, ki_r, lay.ldn, n, n);
    if (refine) copy_whole(pan + lay.k_at, lay.sn, k_r, lay.ldn, n, n);
    if constexpr (TAIL) {
      copy_whole(pan + lay.at_at, lay.st, a2t, lay.ldm, n, ms);
      copy_whole(pan + lay.a_at, lay.sn, a2, lay.ldn, ms, n);
    }
  } else if (chunk > 0) {
    fetch(0, 0, 0);
    put(pan);
  }

  int buf = 0;  // the panel being read (streamed)
  int cur = 0;  // the box buffer that holds the next solve's input
  for (int it = 0; it < chunk; ++it) {
    for (int ph = 0; ph < phases; ++ph) {
      const Kind kind = kind_of(ph);
      const Geo g = geo(kind);
      const bool solve = kind == kSolve0 || kind == kKprod || kind == kSolve;
      const int H = g.h;
      const int nt = (g.rows + H - 1) / H;
      const int np = lay.resident ? 1 : (g.cols + g.pk - 1) / g.pk;
      // a solve reads one box buffer and writes the other; the A2' pass
      // reads the tail buffers and writes the box buffer the first solve
      // reads; A2 xt reads the last solve's xt and writes the tail buffers
      const double* vin = vbuf + cur * lay.nslots * L + 2 * g0;
      double* vout = kind == kAty ? vbuf + cur * lay.nslots * L
                                  : solve ? vbuf + (cur ^ 1) * lay.nslots * L : tbuf;
      // the product's tiles, RT rows a thread; `two`: K2's A2' pass, A'y
      // and A'(rho.s) in one
      auto tiles = [&](auto rows_tag, auto two_tag) {
        constexpr int RT = decltype(rows_tag)::value;
        constexpr bool two = decltype(two_tag)::value;
        for (int tile = 0; tile < nt; ++tile) {
          const int r0 = tile * H;
          const int nr = min(H, g.rows - r0);
          int roff[RT];  // a padded row reads the tile's last one
#pragma unroll
          for (int k = 0; k < RT; ++k) {
            const int rl = t + k * G;
            roff[k] = (rl < nr ? rl : nr - 1) * g.sp;
          }
          Acc acc[RT][LT], acc2[two ? RT : 1][LT];  // acc2: A'(rho.s)
#pragma unroll
          for (int k = 0; k < RT; ++k) {
#pragma unroll
            for (int c = 0; c < LT; ++c) {
              P::zero(acc[k][c]);
              if constexpr (two) P::zero(acc2[k][c]);
            }
          }
          // the epilogue's fp32 operand from the scratch, read ahead: the
          // refinement's rhs (K product) or first xt (later solves)
          float pre[two ? 1 : RT][LT];
          if constexpr (!two) {
            if (kind == kKprod || kind == kSolve) {
              const float* src = kind == kKprod ? rhs_f : xt_f;
#pragma unroll
              for (int k = 0; k < RT; ++k) {
                const int i = min(r0 + t + k * G, g.rows - 1);
#pragma unroll
                for (int c = 0; c < LT; ++c) pre[k][c] = src[i * L + c * LG];
              }
            }
          }
          for (int cp = 0; cp < np; ++cp) {
            const double* pn;
            bool more = false;
            if (!lay.resident) {
              // the next panel of the schedule, into registers
              int nph = ph, ntile = tile, ncp = cp + 1;
              if (ncp == np) {
                ncp = 0;
                if (++ntile == nt) {
                  ntile = 0;
                  ++nph;
                }
              }
              more = true;
              if (nph == phases) {
                nph = 0;
                more = it + 1 < chunk;
              }
              if (more) fetch(nph, ntile, ncp);
              __syncthreads();  // the panel and the lane buffers it meets are complete
              pn = pan + buf * lay.panel;
            } else {
              if (tile == 0) __syncthreads();  // the phase's input buffers are complete
              pn = pan + g.at + r0 * g.sp;
            }
            const int c0 = cp * g.pk;
            const int c1 = min(g.cols, c0 + g.pk);
            int j = c0;
            if constexpr (two) {
              const double* yb = tbuf + 2 * g0;
              const double* wb = tbuf1 + 2 * g0;
#pragma unroll 2
              for (; j + 1 < c1; j += 2) {
                Entry y0[LT], y1[LT], w0[LT], w1[LT];
#pragma unroll
                for (int c = 0; c < LT; ++c) {
                  P::load2(yb + (j >> 1) * ps + c * cs, y0[c], y1[c]);
                  P::load2(wb + (j >> 1) * ps + c * cs, w0[c], w1[c]);
                }
#pragma unroll
                for (int k = 0; k < RT; ++k) {
                  Entry a0, a1;
                  P::load2(pn + roff[k] + (j - c0), a0, a1);
#pragma unroll
                  for (int c = 0; c < LT; ++c) {
                    P::mac(acc[k][c], a0, y0[c]);
                    P::mac(acc2[k][c], a0, w0[c]);
                    P::mac(acc[k][c], a1, y1[c]);
                    P::mac(acc2[k][c], a1, w1[c]);
                  }
                }
              }
              if (j < c1) {
                Entry yj[LT], wj[LT];
#pragma unroll
                for (int c = 0; c < LT; ++c) {
                  yj[c] = P::load(yb + (j >> 1) * ps + c * cs);
                  wj[c] = P::load(wb + (j >> 1) * ps + c * cs);
                }
#pragma unroll
                for (int k = 0; k < RT; ++k) {
                  const Entry a0 = P::load(pn + roff[k] + (j - c0));
#pragma unroll
                  for (int c = 0; c < LT; ++c) {
                    P::mac(acc[k][c], a0, yj[c]);
                    P::mac(acc2[k][c], a0, wj[c]);
                  }
                }
              }
            } else {
#pragma unroll 2
              for (; j + 1 < c1; j += 2) {
                Entry v0[LT], v1[LT];
#pragma unroll
                for (int c = 0; c < LT; ++c) P::load2(vin + (j >> 1) * ps + c * cs, v0[c], v1[c]);
#pragma unroll
                for (int k = 0; k < RT; ++k) {
                  Entry a0, a1;
                  P::load2(pn + roff[k] + (j - c0), a0, a1);
#pragma unroll
                  for (int c = 0; c < LT; ++c) {
                    P::mac(acc[k][c], a0, v0[c]);
                    P::mac(acc[k][c], a1, v1[c]);
                  }
                }
              }
              if (j < c1) {
                Entry vj[LT];
#pragma unroll
                for (int c = 0; c < LT; ++c) vj[c] = P::load(vin + (j >> 1) * ps + c * cs);
#pragma unroll
                for (int k = 0; k < RT; ++k) {
                  const Entry a0 = P::load(pn + roff[k] + (j - c0));
#pragma unroll
                  for (int c = 0; c < LT; ++c) P::mac(acc[k][c], a0, vj[c]);
                }
              }
            }
            if (!lay.resident) {
              if (more) put(pan + (buf ^ 1) * lay.panel);  // read after the next barrier
              buf ^= 1;
            }
          }

          // the tile's rows: each thread its own, of its own lanes
#pragma unroll
          for (int k = 0; k < RT; ++k) {
            const int i = r0 + t + k * G;
            if (i >= g.rows) continue;
            if constexpr (two) {  // box row i's rhs
              const float d = dvec[i];
              float xs[LT], ss[LT], ys[LT], qs[LT];
#pragma unroll
              for (int c = 0; c < LT; ++c) {
                const int o = i * L + c * LG;
                xs[c] = wx[o];
                ss[c] = ws[o];
                ys[c] = wy[o];
                qs[c] = wq[o];
              }
#pragma unroll
              for (int c = 0; c < LT; ++c) {
                const float aty = d * ys[c] + P::result(acc[k][c]);
                const float w = d * (rho_r[i] * ss[c]) + P::result(acc2[k][c]);
                const float rhs = sigma * xs[c] - qs[c] - aty + w;
                if (refine) rhs_f[i * L + c * LG] = rhs;
                P::store(vout + slot(i, L, g0 + c * LG), P::entry(rhs));
              }
            } else if (TAIL && kind == kAx) {  // tail row i, st = A2 xt
              float s0[LT], y0[LT], a0[LT], lo[LT], hi[LT];
#pragma unroll
              for (int c = 0; c < LT; ++c) {
                const int o = (n + i) * L + c * LG;
                s0[c] = ws[o];
                y0[c] = wy[o];
                a0[c] = wax[o];
                lo[c] = wl[o];
                hi[c] = wu[o];
              }
#pragma unroll
              for (int c = 0; c < LT; ++c) {
                const int o = (n + i) * L + c * LG;
                const float res = P::result(acc[k][c]);
                const float v = alpha * res + beta * s0[c];
                const float s_new = clip(v + rhoi_r[n + i] * y0[c], lo[c], hi[c]);
                const float y_new = y0[c] + rho_r[n + i] * (v - s_new);
                const float ax_new = alpha * res + beta * a0[c];
                ws[o] = s_new;
                wy[o] = y_new;
                wax[o] = ax_new;
                if (it + 1 < chunk) {
                  const int sl = slot(i, L, g0 + c * LG);
                  P::store(tbuf + sl, P::entry(y_new));
                  P::store(tbuf1 + sl, P::entry(rho_r[n + i] * s_new));
                }
              }
            } else if (kind == kKprod) {  // the refinement's residual
#pragma unroll
              for (int c = 0; c < LT; ++c)
                P::store(vout + slot(i, L, g0 + c * LG),
                         P::entry(pre[k][c] - P::result(acc[k][c])));
            } else if (ph != last_solve) {  // a solve's xt, for the refinement
#pragma unroll
              for (int c = 0; c < LT; ++c) {
                const float res = P::result(acc[k][c]);
                const float xt = kind == kSolve0 ? res : pre[k][c] + res;
                xt_f[i * L + c * LG] = xt;
                P::store(vout + slot(i, L, g0 + c * LG), P::entry(xt));
              }
            } else {  // the update of box row i
              const float d = dvec[i];
              const float rho = rho_r[i];
              float x0[LT], s0[LT], y0[LT], a0[LT], qs[LT], lo[LT], hi[LT];
#pragma unroll
              for (int c = 0; c < LT; ++c) {
                const int o = i * L + c * LG;
                x0[c] = wx[o];
                s0[c] = ws[o];
                y0[c] = wy[o];
                a0[c] = wax[o];
                qs[c] = wq[o];
                lo[c] = wl[o];
                hi[c] = wu[o];
              }
#pragma unroll
              for (int c = 0; c < LT; ++c) {
                const int o = i * L + c * LG;
                const float res = P::result(acc[k][c]);
                const float xt = kind == kSolve0 ? res : pre[k][c] + res;
                const float st = d * xt;
                const float v = alpha * st + beta * s0[c];
                const float s_new = clip(v + rhoi_r[i] * y0[c], lo[c], hi[c]);
                const float x_new = alpha * xt + beta * x0[c];
                const float y_new = y0[c] + rho * (v - s_new);
                const float ax_new = alpha * st + beta * a0[c];
                wx[o] = x_new;
                ws[o] = s_new;
                wy[o] = y_new;
                wax[o] = ax_new;
                const int sl = slot(i, L, g0 + c * LG);
                if constexpr (TAIL) {
                  P::store(vout + sl, P::entry(xt));  // for A2 xt
                } else if (it + 1 < chunk) {  // the next iteration's rhs
                  const float rhs = sigma * x_new - qs[c] - d * y_new + d * (rho * s_new);
                  if (refine) rhs_f[o] = rhs;
                  P::store(vout + sl, P::entry(rhs));
                }
              }
            }
          }
        }
      };
      if constexpr (TAIL) {
        if (kind == kAty) {
          tiles(std::integral_constant<int, kPassRows>{}, std::true_type{});
        } else {
          tiles(std::integral_constant<int, ROWS>{}, std::false_type{});
        }
      } else {
        tiles(std::integral_constant<int, ROWS>{}, std::false_type{});
      }
      if (solve) cur ^= 1;
    }
  }

  // the outputs: each live lane's working copy, by the rows' owners
  auto copy_out = [&](int row, int c) {
    const int g = row * B + lc[c];
    const int o = row * L + c * LG;
    s_out[g] = ws[o];
    y_out[g] = wy[o];
    ax_out[g] = wax[o];
  };
  for (int i = t; i < n; i += G) {
#pragma unroll
    for (int c = 0; c < LT; ++c) {
      if (!live[c]) continue;
      copy_out(i, c);
      x_out[i * B + lc[c]] = wx[i * L + c * LG];
    }
  }
  if constexpr (TAIL) {
    for (int j = t; j < ms; j += G) {
#pragma unroll
      for (int c = 0; c < LT; ++c)
        if (live[c]) copy_out(n + j, c);
    }
  }
}

struct Args {
  const float *kinv, *kmat, *a2t, *a2;
  const float *dvec, *rho_vecs, *rho_invs, *q, *l, *u;
  const int *order, *starts;
  const float *x_in, *s_in, *y_in, *ax_in;
  float *x_out, *s_out, *y_out, *ax_out, *scratch;
  int n, m, B, R, chunk, refine_steps;
  float sigma, alpha;
};

template <bool TAIL, int MODE, int LT, int ROWS>
cudaError_t launch(const Args& a, int lanes, int groups, const Layout& lay, size_t smem,
                   cudaStream_t stream) {
  auto kernel = admm_stream_kernel<TAIL, MODE, LT, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + lanes - 1) / lanes + a.R);
  const dim3 block(lanes / LT, groups);
  kernel<<<grid, block, smem, stream>>>(
      a.kinv, a.kmat, a.a2t, a.a2, a.dvec, a.rho_vecs, a.rho_invs, a.q, a.l, a.u,
      a.order, a.starts, a.x_in, a.s_in, a.y_in, a.ax_in, a.x_out, a.s_out, a.y_out,
      a.ax_out, a.scratch, a.n, a.m, a.B, a.R, a.chunk, a.refine_steps, a.sigma, a.alpha,
      lay);
  return cudaGetLastError();
}

// the instantiation of the precision, the lanes a thread and the rows
// (rows_fit holds)
template <bool TAIL, int MODE>
cudaError_t launch_tile(const Args& a, int lanes, int groups, int rows, const Layout& lay,
                        size_t smem, cudaStream_t stream) {
  switch (lanes_per_thread(lanes)) {
    case 4:
      if constexpr (!TAIL) {
        if (rows == 2 * kPassRows)
          return launch<TAIL, MODE, 4, 2 * kPassRows>(a, lanes, groups, lay, smem, stream);
      }
      return launch<TAIL, MODE, 4, kPassRows>(a, lanes, groups, lay, smem, stream);
    case 2:
      return launch<TAIL, MODE, 2, kPassRows>(a, lanes, groups, lay, smem, stream);
  }
  return launch<TAIL, MODE, 1, kPassRows>(a, lanes, groups, lay, smem, stream);
}

// The layout of a launch of `lanes` lanes, `groups` row-groups, `rows` rows
// a thread and panels of `panel` doubles; false if a streamed panel holds
// fewer than 4 columns of a tile. A streamed panel holds at most kStage
// chunks of 4 columns a thread: kStage LG columns of a tile of 4 G rows
// (K2's A2', and the other products at 4 rows a thread), kStage LG / 2 of
// one of 8 G rows, LG = lanes / lanes_per_thread(lanes).
// ops/admm_fused.k12_stream_layout mirrors it.
bool make_layout(int n, int ms, bool refine, int lanes, int groups, int rows, int panel,
                 Layout& lay) {
  const int lt = lanes_per_thread(lanes);
  const int cap = kStage * (lanes / lt) * kPassRows / rows;  // columns of a panel of rows G rows
  const int capt = kStage * (lanes / lt);                     // of kPassRows G rows (A2')
  lay.ldn = (n + 3) & ~3;
  lay.ldm = (ms + 3) & ~3;
  lay.nslots = (n + 1) & ~1;
  lay.tslots = (ms + 1) & ~1;
  lay.panel = panel;
  // whole rows at the least stride whose rows a warp reads without conflicts
  const int fn = panel_stride(lay.ldn + 2, 1, lay.ldn);
  const int ft = ms > 0 ? panel_stride(lay.ldm + 2, 1, lay.ldm) : 0;
  lay.k_at = n * fn;
  lay.at_at = lay.k_at + (refine ? n * fn : 0);
  lay.a_at = lay.at_at + n * ft;
  const long long whole = lay.a_at + static_cast<long long>(ms) * fn;
  lay.resident = whole <= 2LL * panel;
  if (lay.resident) {
    lay.sn = fn;
    lay.pn = lay.ldn;
    lay.st = ft;
    lay.pt = lay.ldm;
    return true;
  }
  lay.sn = panel_stride(panel, rows * groups, lay.ldn < cap ? lay.ldn : cap);
  lay.pn = lay.sn - 2;
  lay.st = ms > 0 ? panel_stride(panel, kPassRows * groups, lay.ldm < capt ? lay.ldm : capt) : 0;
  lay.pt = ms > 0 ? lay.st - 2 : 0;
  return lay.pn >= 4 && (ms == 0 || lay.pt >= 4);
}

// The entry of K1 (TAIL false) or K2: the checks, the layout, its bytes,
// the precision's instantiation.
template <bool TAIL>
int stream_chunk(const Args& a, int mode, int lanes, int groups, int rows, int panel,
                 int smem_bytes, void* stream) {
  const int n = a.n, ms = a.m - a.n;
  if (n <= 0 || n > kMaxWidth || (TAIL ? ms < 1 || ms > kMaxWidth : ms != 0) || a.B <= 0 ||
      a.R <= 0 || a.chunk < 0 || a.refine_steps < 0 ||
      static_cast<long long>(a.m) * a.B > INT_MAX ||
      (lanes != 4 && lanes != 8 && lanes != 16 && lanes != 32 && lanes != 64) ||
      groups <= 0 || lanes / lanes_per_thread(lanes) * groups > kThreads ||
      !rows_fit(TAIL, lanes_per_thread(lanes), rows) || panel <= 0 ||
      panel % 2 != 0 || a.scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout lay;
  if (!make_layout(n, ms, a.refine_steps > 0, lanes, groups, rows, panel, lay))
    return static_cast<int>(cudaErrorInvalidValue);
  // the bytes of the layout (ops/admm_fused.k12_stream_smem_bytes mirrors
  // these two lines, which tests/test_torch_build.py reads)
  const long long stream_doubles = 2LL * panel + 2LL * (lay.nslots + lay.tslots) * lanes;
  const long long stream_need = 8 * stream_doubles;
  if (stream_need != smem_bytes || stream_need > static_cast<long long>(mpc_admm::kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(stream_need);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case mpc_admm::kHighest:
      return static_cast<int>(
          launch_tile<TAIL, mpc_admm::kHighest>(a, lanes, groups, rows, lay, smem, st));
    case mpc_admm::kBf16x3:
      return static_cast<int>(
          launch_tile<TAIL, mpc_admm::kBf16x3>(a, lanes, groups, rows, lay, smem, st));
    case mpc_admm::kDefault:
      return static_cast<int>(
          launch_tile<TAIL, mpc_admm::kDefault>(a, lanes, groups, rows, lay, smem, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// K1 on the stream route: launch `chunk` iterations on `stream` at
// precision `mode` (0 "highest", 1 "bf16x3", 2 "default";
// ops/admm_fused.PRECISIONS). kinv, kmat (R, n, ldn) are K^-1 and K (row i
// holds row i), as 4-byte entries (the fp32 value at "highest", the bf16
// pair (hi, lo) at "bf16x3", (hi, 0) at "default", hi in the low half:
// ops/admm_fused.narrow_entries) with rows padded to ldn = n rounded up to
// a multiple of 4 (kmat unused when refine_steps == 0); the other arrays
// float32 and contiguous on one device: dvec (n), rho_vecs, rho_invs (R,
// n), q, l, u, x_in, s_in, y_in, ax_in and the outputs (n, B); order (B),
// the lanes sorted by rho index (stable), and starts (R + 1), where each
// index's lanes start in that order (admm_fused.rho_order); scratch, (7 n,
// and 2 n more when refining) (ceil(B / lanes) + R) lanes floats of device
// memory (admm_fused.k12_scratch_floats). Takes n <= 1024 and n B < 2^31.
// The layout comes from ops/admm_fused.k1_plan:
// lanes (4, 8, 16, 32 or 64) and groups per block (at most 256 threads of
// 1 lane, of 2 at 16 lanes, of 4 from 32 lanes on), the rows a thread
// takes in each tile (rpt: 4, or 8 at 4 lanes a thread), the doubles of
// one operator panel (panel) and the dynamic shared memory they take,
// which must equal what the kernel's layout needs. Returns the
// cudaError_t of the launch (0 on success).
int admm_diag_stream_chunk(const float* kinv, const float* kmat, const float* dvec,
                           const float* rho_vecs, const float* rho_invs, const float* q,
                           const float* l, const float* u, const int* order, const int* starts,
                           const float* x_in, const float* s_in, const float* y_in,
                           const float* ax_in, float* x_out, float* s_out, float* y_out,
                           float* ax_out, float* scratch, int n, int B, int R, int chunk,
                           int refine_steps, int mode, int lanes, int groups, int rpt,
                           int panel, int smem_bytes, float sigma, float alpha, void* stream) {
  const Args a{kinv, kmat, nullptr, nullptr, dvec, rho_vecs, rho_invs, q, l, u, order, starts,
               x_in, s_in, y_in, ax_in, x_out, s_out, y_out, ax_out, scratch,
               n, n, B, R, chunk, refine_steps, sigma, alpha};
  return stream_chunk<false>(a, mode, lanes, groups, rpt, panel, smem_bytes, stream);
}

// K2 on the stream route: as admm_diag_stream_chunk, with the dense tail
// A2 (m - n, n) as a2t (n, ldm), its transpose with rows padded to ldm =
// m - n rounded up to a multiple of 4, and a2 (m - n, ldn), both as 4-byte
// entries; dvec (n) is the box's diagonal, rho_vecs, rho_invs (R, m), l,
// u, s, y, ax (m, B); scratch (2 n + 5 m, and 2 n more when refining)
// (ceil(B / lanes) + R) lanes floats. Takes n <= 1024, 1 <= m - n <= 1024
// and m B < 2^31; the layout from ops/admm_fused.k2_plan (rpt_n: 4 rows a
// thread).
int admm_mixed_stream_chunk(const float* kinv, const float* kmat, const float* a2t,
                            const float* a2, const float* dvec, const float* rho_vecs,
                            const float* rho_invs, const float* q, const float* l,
                            const float* u, const int* order, const int* starts,
                            const float* x_in, const float* s_in, const float* y_in,
                            const float* ax_in, float* x_out, float* s_out, float* y_out,
                            float* ax_out, float* scratch, int n, int m, int B, int R, int chunk,
                            int refine_steps, int mode, int lanes, int groups, int rpt_n,
                            int panel, int smem_bytes, float sigma, float alpha, void* stream) {
  const Args a{kinv, kmat, a2t, a2, dvec, rho_vecs, rho_invs, q, l, u, order, starts,
               x_in, s_in, y_in, ax_in, x_out, s_out, y_out, ax_out, scratch,
               n, m, B, R, chunk, refine_steps, sigma, alpha};
  return stream_chunk<true>(a, mode, lanes, groups, rpt_n, panel, smem_bytes, stream);
}

}  // extern "C"
