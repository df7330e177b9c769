// K5 and K4 on Hopper, the wide route: `chunk` ADMM iterations of a batch
// of QPs whose scaled constraint matrix A (m, n) is dense (rows not
// box-first), per rho (K5) or lane-packed (K4), at the operator shapes the
// shared and stream routes (admm_perr.cu: n <= 128, m <= 512) do not take.
//
// Replaces the rest of ops/admm_pallas.py::_iterate_kernel_perr (K5) and
// _iterate_kernel (K4) of the JAX package, both driven by _iterate_chunk:
// every dense shape admm_pallas.fused_fits admits (n up to 582 and up to
// 3839 rows at R = 1; the QTP's state box to h154 and its equality
// terminal to h228 at tier 1's grid) past the two older routes. Same math
// as admm_perr.cu, per lane b and iteration, r the lane's rho-grid index:
//
//   rhs = sigma x - q - A'y + sum_i s_i fl(rho_r,i A_i.)
//   xt  = rhs K_r^-1
//   K5: refine_steps times: xt += (rhs - xt K_r) K_r^-1;  st = A xt
//   K4: st = rhs kia_r;  refine_steps times: res = rhs - xt K_r;
//       xt += res K_r^-1;  st += res kia_r
//   x = alpha xt + (1-alpha) x;  v = alpha st + (1-alpha) s
//   s = clip(v + rho^-1 y, l, u);  y += rho (v - s);  ax = alpha st + (1-alpha) ax
//
// One source, one kernel with the compile-time flag PACKED (K4) and the
// precision MODE; ops/admm_fused.k5_plan and k4_plan take this route only
// where neither of the other two has a layout. An iteration is a sequence
// of products, each a small GEMM of one rho's operator (rows x columns)
// and the block's lanes' vectors (columns x lanes):
//
// - the pass: A' and fl(rho_r A)' (n rows, m columns) against y and s,
//   A'y and fl(rho A)'s summed together;
// - the solves: K_r^-1' (K4: W_r = [K_r^-1'; kia_r'], n + m rows, whose
//   last m give the image st), the refinement's K_r' (n rows), and K5's A
//   xt (A, m rows), all over n columns.
//
// How lanes meet their operators: the wrapper orders the lanes by rho index
// on the device (admm_fused.rho_order, no host sync) and each cluster of 1
// or 2 blocks takes up to 64 lanes of one index (mpc_admm::rho_block_at),
// every block of it all the cluster's lanes and its span of each product's
// rows (block k rows [k span, (k + 1) span), span = ceil(rows / cluster)),
// so a block needs its rows of one rho's operators, handed over as 4-byte
// entries in device memory (fp32 at "highest", the bf16 pair (hi, lo) at
// "bf16x3" and "default"; admm_fused.kernel_operators(..., narrow=True)),
// rows padded to a multiple of 4. A block widens each entry once into the 8-byte entry its products
// read (admm_common.cuh, Prec, widen4) as it stages a panel.
//
// Register tiles: the block's 256 threads split, for each product, into
// LG = L / LT lane-groups by G row-groups; thread (g, t) takes lanes g + c
// LG (c < LT) and rows t + k G (k < RT) of each tile of H = RT G rows, and
// holds their sums (the pass: two sums a row and lane). RT x LT is the
// plan's for the pass and for the other products (of kTiles); G is as few
// row-groups as cover the block's span of the product's rows in as few
// tiles as the block's threads allow, so a tile is padded by fewer than RT rows (a
// padded row reads the tile's last one) and threads past G rows idle in
// that product. One 16-byte operator load from shared memory feeds 2 LT
// multiply-adds and one 16-byte vector load 2 RT. Every (row, lane) sum
// runs over its columns in index order from zero and is rounded once.
//
// Panels: a product's tiles go in turn, each tile's columns panel by panel
// (pk columns of the tile's rows; the pass's panel holds A' above fl(rho
// A)' and the panel's columns of y and s for every lane). Its 4-byte
// entries travel through a ring of `depth` slots in shared memory with
// cp.async, depth - 1 panels ahead of the one being read; each thread
// widens the chunks it copied itself into one of two fp64 panels after its
// sums on the other, and one barrier a panel makes both complete. The
// ring restarts each iteration, so that the pass reads y and s after the
// last iteration's update.
//
// The lanes' state lives in device memory: a cluster copies its lanes'
// state and inputs (x, q, s, y, ax, l, u) once a chunk from their scattered
// columns into a working copy in a scratch, a region of L columns for each
// cluster, so that every iteration's reads and writes coalesce, and writes
// the outputs back once at its end. Each product's outputs go to the
// working copy in fp32 (rhs, xt, the refinement's residual, K4's image;
// x, s, y, ax at the update), and the next product's input vector is
// widened from there into one fp64 buffer of n rows and L lanes in shared
// memory, after a barrier of the cluster's blocks (release / acquire; the
// working copy is read from L2, __ldcg, so another block's writes are
// seen). y and s never sit whole in shared memory, so the constraint rows
// do not cap the lanes a block takes; n does (the buffer). A cluster of
// two reads one rho's operators once for twice the lanes of a block, and
// each of its blocks widens half of them.
//
// What bounds it on this card: the fp64 multiply-adds (3 m n + (1 + 2
// refine) n^2 per lane and iteration for K5) fed from shared memory, a
// 16-byte load per 2 RT or 2 LT of them (a warp's load takes 4 clocks of
// its SM: scripts/fp64_rate_probe.py), about half of a step; then each
// panel's copies' issue and widening (0.2 and 0.27 clocks of the SM an
// entry, the steps' phases timed with clock64 on the H100, PERF.md), which
// a cluster's blocks share, the tiles' epilogues (round trips of the state
// to L2), and where the operators stream, the panels' copies from L2, 4
// bytes an entry, one rho's operators a cluster of up to 64 lanes and
// iteration; the plan (ops/admm_fused._wide_cost) weighs them.
//
// Precision, as on the other routes: the state is fp32; at "highest" every
// matrix-vector product is accumulated in fp64 from exact fp32 products in
// index order and rounded once; at "bf16x3" and "default" (the template
// parameter MODE, admm_common.cuh) each is that precision's passes over
// the operators' bf16 pairs and the vectors split when widened. The plain
// versions (admm_fused.iterate_chunk_dense_perr_T_plain,
// iterate_chunk_dense_packed_T_plain) sum in the same order, so the two
// agree bit for bit. Built with --fmad=false so the elementwise updates
// round like PyTorch's.
//
// Every thread reaches every barrier (the loops' bounds are the block's,
// the cluster barriers' the cluster's); spare clusters (each rho's partial
// last one leaves some) return whole before the first; lanes past their
// rho's count run on its last lane's inputs and store nothing to the state.
//
// Bound to PyTorch by ctypes through the plain C functions
// admm_perr_wide_chunk (K5) and admm_packed_wide_chunk (K4), which return
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <type_traits>

#include "admm_common.cuh"

namespace {

using mpc_admm::clip;
using mpc_admm::copy16f;
using mpc_admm::Prec;
using mpc_admm::slot;
using mpc_admm::widen4;

constexpr int kThreads = 256;    // threads a block
constexpr int kMaxN = 1024;      // the widest n
constexpr int kMaxRows = 4096;   // the most constraint rows
constexpr int kMaxDepth = 4;     // the most ring slots
constexpr int kMaxCluster = 2;   // the most blocks a cluster that shares its lanes

// the register tiles (rows, lanes a thread) a product may take, the pass's
// and the others' each of them (ops/admm_fused.WIDE_TILES)
constexpr int kTiles[][2] = {{4, 4}, {2, 4}, {4, 2}, {2, 2}, {4, 1}, {2, 1}};

// the products of an iteration: the pass, the first solve, the
// refinement's K product and solve, K5's A xt
enum Kind { kPass, kSolve0, kKprod, kSolve, kAx };

// one product's operator and tiles: its rows, columns and row stride in
// device memory (4-byte entries), the rows each block of a cluster takes
// (block k rows [k span, (k + 1) span)), the operators and staged vectors a
// panel holds (the pass: 2 and 2), the thread's rows and lanes and log2 of
// the lane-groups, the row-groups, rows of a tile and a block's tiles, a
// panel's columns, its rows' stride (doubles) and the panels of a tile
struct Geo {
  int rows, cols, ld, span, ops, vecs;
  int rt, lt, lgl;
  int G, H, tiles;
  int pk, sp, np;
};

// a launch's layout (make_layout): the lanes a cluster's blocks share and
// their log2, the blocks of a cluster, the ring's slots (each of `panel`
// floats), the doubles of an fp64 panel, the rows of the vector buffer (n rounded
// up to even), n and m rounded up to 4 (the working copy's rows), and the
// products' geometry: the pass, the solves (K^-1' or W), the refinement's
// K', K5's A
struct Layout {
  int lanes, lgl, cluster, depth, panel, nslots, n4, m4;
  Geo g[4];
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the block's rank in its cluster (0 in a launch without clusters)
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// every thread of the cluster's blocks here, their writes to the working
// copy before it visible to the reads after it (which go to L2: __ldcg)
__device__ __forceinline__ void cluster_sync(int cluster) {
  if (cluster == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

template <bool PACKED, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
admm_wide_kernel(const float* __restrict__ kinv,  // (R, n, ldn) K^-1'; PACKED: W (R, n + m, ldn)
                 const float* __restrict__ kmat,  // (R, n, ldn) K'
                 const float* __restrict__ a,     // (m, ldn) A (K5's A xt)
                 const float* __restrict__ at,    // (n, ldm) A'
                 const float* __restrict__ rat,   // (R, n, ldm) fl(rho_r A)'
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
  const int tid = threadIdx.x;
  const int L = lay.lanes;

  // the cluster's lanes: one rho index's (mpc_admm::rho_block_at); every
  // block of a cluster takes them all and its span of each product's rows
  const int C = lay.cluster;
  const int rank = cluster_rank();
  const int group = static_cast<int>(blockIdx.x) / C;
  const mpc_admm::RhoBlock rb = mpc_admm::rho_block_at(starts, R, L, group);
  if (rb.r == R) return;  // a spare cluster: every thread, before any barrier
  const int r = rb.r;
  const int live = rb.cnt - rb.off;  // the block's lanes from `live` on are stand-ins
  auto column = [&](int c) { return order[rb.seg + min(rb.off + c, rb.cnt - 1)]; };

  const bool refine = refine_steps > 0;
  const int wrows = PACKED ? n + m : n;  // rows of the solves' operator
  double* pan = smem;                                   // two fp64 panels
  double* vbuf = pan + 2 * lay.panel;                   // the products' input, n rows
  float* ring = reinterpret_cast<float*>(vbuf + lay.nslots * L);  // depth slots
  // the lanes' working copy in the scratch, a region of L columns per
  // cluster, row i of lane c at [i * L + c]: x, q, rhs, xt (n rows each), s,
  // y, ax, l, u (m rows each), when refining the residual (n) and K4's
  // image (m); every array's rows rounded up to 4
  const int n4 = lay.n4, m4 = lay.m4;
  const int region = (4 * n4 + (refine ? n4 : 0) + 5 * m4 + (PACKED && refine ? m4 : 0)) * L;
  float* wx = scratch + static_cast<long long>(group) * region;
  float* wq = wx + n4 * L;
  float* wr = wq + n4 * L;
  float* wt = wr + n4 * L;
  float* ws = wt + n4 * L;
  float* wy = ws + m4 * L;
  float* wax = wy + m4 * L;
  float* wl = wax + m4 * L;
  float* wu = wl + m4 * L;
  float* wres = wu + m4 * L;
  float* wimg = wres + (refine ? n4 : 0) * L;
  const float* w_r = kinv + static_cast<size_t>(r) * wrows * lay.g[1].ld;
  const float* k_r = kmat + static_cast<size_t>(r) * n * lay.g[2].ld;
  const float* rat_r = rat + static_cast<size_t>(r) * n * lay.g[0].ld;
  const float* rho_r = rho_vecs + static_cast<size_t>(r) * m;
  const float* rhoi_r = rho_invs + static_cast<size_t>(r) * m;
  const float beta = 1.0f - alpha;

  // the working copy of the inputs (a stand-in lane copies its stand-in's),
  // the cluster's blocks in turn
  const int start = rank * kThreads, stride = C * kThreads;
  for (int f = tid + start; f < n * L; f += stride) {
    const int g = (f >> lay.lgl) * B + column(f & (L - 1));
    wx[f] = x_in[g];
    wq[f] = q[g];
  }
  for (int f = tid + start; f < m * L; f += stride) {
    const int g = (f >> lay.lgl) * B + column(f & (L - 1));
    ws[f] = s_in[g];
    wy[f] = y_in[g];
    wax[f] = ax_in[g];
    wl[f] = l[g];
    wu[f] = u[g];
  }
  cluster_sync(C);

  // the products of an iteration, in order: the pass, the first solve,
  // refine_steps times the K product and a solve, K5's A xt
  const int phases = (PACKED ? 2 : 3) + 2 * refine_steps;
  const int last_solve = phases - (PACKED ? 1 : 2);
  auto kind_of = [&](int ph) {
    if (ph == 0) return kPass;
    if (!PACKED && ph == phases - 1) return kAx;
    --ph;
    return ph == 0 ? kSolve0 : (ph & 1) ? kKprod : kSolve;
  };
  auto geo_of = [&](Kind kind) -> Geo {
    return lay.g[kind == kPass ? 0 : kind == kKprod ? 2 : kind == kAx ? 3 : 1];
  };
  auto operator_of = [&](Kind kind) {
    return kind == kPass ? at : kind == kKprod ? k_r : kind == kAx ? a : w_r;
  };
  // the block's rows of a product: [first_row, end_row), in tiles_of tiles
  auto first_row = [&](const Geo& g) { return rank * g.span; };
  auto end_row = [&](const Geo& g) { return min(g.rows, (rank + 1) * g.span); };
  auto tiles_of = [&](const Geo& g) { return (end_row(g) - first_row(g) + g.H - 1) / g.H; };

  // The schedule: a step is one panel (product ph, tile, column panel cp);
  // step k's 4-byte entries go to ring slot k mod depth.
  struct Step {
    int ph, tile, cp;
  };
  auto advance = [&](Step& s) {
    const Geo g = geo_of(kind_of(s.ph));
    if (++s.cp == g.np) {
      s.cp = 0;
      if (++s.tile == tiles_of(g)) {
        s.tile = 0;
        ++s.ph;
      }
    }
  };
  // Start copying step s into ring slot k (an empty group past the
  // iteration's last step): the operator rows of its tile and columns,
  // and for the pass y and s of its columns. A thread copies
  // chunks tid + e 256 of the operator rows (row by row, 4 entries a
  // chunk) and of the vectors, and widens the same ones (widen).
  auto issue = [&](const Step& s, int k) {
    if (s.ph < phases) {
      const Kind kind = kind_of(s.ph);
      const Geo g = geo_of(kind);
      float* dst = ring + k * lay.panel;
      const int r0 = first_row(g) + s.tile * g.H;
      const int nr = min(g.H, end_row(g) - r0);
      const int c0 = s.cp * g.pk;
      const int q4 = (min(g.pk, g.cols - c0) + 3) >> 2;
      const float* M = operator_of(kind) + r0 * g.ld + c0;
      const float* M2 = rat_r + r0 * g.ld + c0;  // the pass's second
      int row = tid / q4, h = tid - row * q4;
      const int drow = kThreads / q4, dh = kThreads - drow * q4;
      for (int e = tid; e < g.ops * nr * q4; e += kThreads) {
        const bool second = row >= nr;
        const int rr = second ? row - nr : row;
        copy16f(dst + ((second ? g.H : 0) + rr) * g.pk + 4 * h,
                (second ? M2 : M) + rr * g.ld + 4 * h);
        row += drow;
        h += dh;
        if (h >= q4) {
          h -= q4;
          ++row;
        }
      }
      if (kind == kPass) {
        float* vd = dst + 2 * g.H * g.pk;
        const int nv = 4 * q4 * L;  // floats of y, then of s
        for (int e = 4 * tid; e < 2 * nv; e += 4 * kThreads)
          copy16f(vd + e, e < nv ? wy + c0 * L + e : ws + c0 * L + (e - nv));
      }
    }
    __pipeline_commit();
  };
  // Widen the chunks this thread copied of step s (ring slot k) into the
  // fp64 panel dp: operator rows at stride sp (the pass's second operator
  // H rows down), then the pass's y and s of pk rows each, L lanes in
  // row pairs (slot).
  auto widen = [&](const Step& s, int k, double* dp) {
    const Kind kind = kind_of(s.ph);
    const Geo g = geo_of(kind);
    const float* raw = ring + k * lay.panel;
    const int r0 = first_row(g) + s.tile * g.H;
    const int nr = min(g.H, end_row(g) - r0);
    const int c0 = s.cp * g.pk;
    const int q4 = (min(g.pk, g.cols - c0) + 3) >> 2;
    int row = tid / q4, h = tid - row * q4;
    const int drow = kThreads / q4, dh = kThreads - drow * q4;
    for (int e = tid; e < g.ops * nr * q4; e += kThreads) {
      const bool second = row >= nr;
      const int rr = second ? row - nr : row;
      widen4<MODE>(dp + ((second ? g.H : 0) + rr) * g.sp + 4 * h,
                   lds4(raw + ((second ? g.H : 0) + rr) * g.pk + 4 * h));
      row += drow;
      h += dh;
      if (h >= q4) {
        h -= q4;
        ++row;
      }
    }
    if (kind == kPass) {
      const float* vr = raw + 2 * g.H * g.pk;
      double* vy = dp + 2 * g.H * g.sp;
      const int nv = 4 * q4 * L;
      for (int e = 4 * tid; e < 2 * nv; e += 4 * kThreads) {
        const float4 v = lds4(vr + e);
        const bool is_s = e >= nv;
        const int f = is_s ? e - nv : e;
        double* d = is_s ? vy + g.pk * L : vy;
        const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          P::store(d + slot((f + i) >> lay.lgl, L, (f + i) & (L - 1)), P::entry(vals[i]));
      }
    }
  };
  auto wait_ring = [&]() {  // every group but the depth - 1 newest complete
    switch (lay.depth) {
      case 2:
        __pipeline_wait_prior(1);
        break;
      case 3:
        __pipeline_wait_prior(2);
        break;
      default:
        __pipeline_wait_prior(3);
        break;
    }
  };
  Step iss{0, 0, 0}, wid{0, 0, 0};  // the next step to copy, the next to widen
  int buf = 0, cslot = 0;           // the fp64 panel and ring slot of the step being read
  auto begin_step = [&]() {  // the step depth ahead, into the slot read last
    issue(iss, cslot);
    if (iss.ph < phases) advance(iss);
  };
  auto end_step = [&]() {  // the next step widened into the other panel
    if (wid.ph < phases) {
      wait_ring();
      widen(wid, cslot + 1 == lay.depth ? 0 : cslot + 1, pan + (buf ^ 1) * lay.panel);
      advance(wid);
    }
    __syncthreads();  // the next panel complete, and every thread done with this one
    buf ^= 1;
    cslot = cslot + 1 == lay.depth ? 0 : cslot + 1;
  };

  // the update of constraint row c of lanes lane[0..LT) from their images
  // st, each lane's operands read before any is written
  auto update = [&](int c, const int* lane, const float* st, auto lanes_tag) {
    constexpr int LT = decltype(lanes_tag)::value;
    const float rho = __ldg(rho_r + c), rhoi = __ldg(rhoi_r + c);
    float s0[LT], y0[LT], a0[LT], lo[LT], hi[LT];
#pragma unroll
    for (int q = 0; q < LT; ++q) {
      const int o = c * L + lane[q];
      s0[q] = __ldcg(ws + o);
      y0[q] = __ldcg(wy + o);
      a0[q] = __ldcg(wax + o);
      lo[q] = __ldcg(wl + o);
      hi[q] = __ldcg(wu + o);
    }
#pragma unroll
    for (int q = 0; q < LT; ++q) {
      const int o = c * L + lane[q];
      const float v = alpha * st[q] + beta * s0[q];
      const float s_new = clip(v + rhoi * y0[q], lo[q], hi[q]);
      const float y_new = y0[q] + rho * (v - s_new);
      const float ax_new = alpha * st[q] + beta * a0[q];
      ws[o] = s_new;
      wy[o] = y_new;
      wax[o] = ax_new;
    }
  };

  // One product's tiles at RT rows x LT lanes a thread; `two`: the pass,
  // A'y and fl(rho A)'s in one.
  auto run = [&](auto rows_tag, auto lanes_tag, auto two_tag, int ph) {
    constexpr int RT = decltype(rows_tag)::value;
    constexpr int LT = decltype(lanes_tag)::value;
    constexpr bool two = decltype(two_tag)::value;
    const Kind kind = kind_of(ph);
    const Geo g = geo_of(kind);
    const int LG = 1 << g.lgl;
    const int g0 = tid & (LG - 1);
    const int t = tid >> g.lgl;
    const bool active = t < g.G;
    const int ps = 2 * L;   // doubles between a lane's row pairs
    const int cs = 2 * LG;  // doubles between a thread's lanes
    const int rows_end = end_row(g);
    const int tiles = tiles_of(g);
    for (int tile = 0; tile < tiles; ++tile) {
      const int r0 = first_row(g) + tile * g.H;
      const int nr = min(g.H, rows_end - r0);
      int roff[RT];  // a padded row reads the tile's last one
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        const int rl = t + k * g.G;
        roff[k] = (rl < nr ? rl : nr - 1) * g.sp;
      }
      Acc acc[RT][LT], acc2[two ? RT : 1][LT];  // acc2: fl(rho A)'s
#pragma unroll
      for (int k = 0; k < RT; ++k) {
#pragma unroll
        for (int c = 0; c < LT; ++c) {
          P::zero(acc[k][c]);
          if constexpr (two) P::zero(acc2[k][c]);
        }
      }
      // the epilogue's fp32 operand from the working copy, read ahead: the
      // refinement's rhs (K product) or the last xt or image (later solves)
      float pre[two ? 1 : RT][LT];
      if constexpr (!two) {
        if (active && (kind == kKprod || kind == kSolve)) {
#pragma unroll
          for (int k = 0; k < RT; ++k) {
            const int i = min(r0 + t + k * g.G, rows_end - 1);
            const float* src =
                kind == kKprod ? wr + i * L : i < n ? wt + i * L : wimg + (i - n) * L;
#pragma unroll
            for (int c = 0; c < LT; ++c) pre[k][c] = __ldcg(src + g0 + c * LG);
          }
        }
      }
      for (int cp = 0; cp < g.np; ++cp) {
        begin_step();
        const double* pn = pan + buf * lay.panel;
        const int w = min(g.pk, g.cols - cp * g.pk);  // the panel's columns
        if (active) {
          int j = 0;
          if constexpr (two) {
            const double* pn2 = pn + g.H * g.sp;
            const double* yb = pn + 2 * g.H * g.sp + 2 * g0;
            const double* sb = yb + g.pk * L;
#pragma unroll 2
            for (; j + 1 < w; j += 2) {
              Entry y0[LT], y1[LT], s0[LT], s1[LT];
#pragma unroll
              for (int c = 0; c < LT; ++c) {
                P::load2(yb + (j >> 1) * ps + c * cs, y0[c], y1[c]);
                P::load2(sb + (j >> 1) * ps + c * cs, s0[c], s1[c]);
              }
#pragma unroll
              for (int k = 0; k < RT; ++k) {
                Entry a0, a1, w0, w1;
                P::load2(pn + roff[k] + j, a0, a1);
                P::load2(pn2 + roff[k] + j, w0, w1);
#pragma unroll
                for (int c = 0; c < LT; ++c) {
                  P::mac(acc[k][c], a0, y0[c]);
                  P::mac(acc2[k][c], w0, s0[c]);
                  P::mac(acc[k][c], a1, y1[c]);
                  P::mac(acc2[k][c], w1, s1[c]);
                }
              }
            }
            if (j < w) {
              Entry yj[LT], sj[LT];
#pragma unroll
              for (int c = 0; c < LT; ++c) {
                yj[c] = P::load(yb + (j >> 1) * ps + c * cs);
                sj[c] = P::load(sb + (j >> 1) * ps + c * cs);
              }
#pragma unroll
              for (int k = 0; k < RT; ++k) {
                const Entry a0 = P::load(pn + roff[k] + j);
                const Entry w0 = P::load(pn2 + roff[k] + j);
#pragma unroll
                for (int c = 0; c < LT; ++c) {
                  P::mac(acc[k][c], a0, yj[c]);
                  P::mac(acc2[k][c], w0, sj[c]);
                }
              }
            }
          } else {
            const double* vin = vbuf + 2 * g0 + cp * g.pk * L;  // the panel's first column pair
#pragma unroll 2
            for (; j + 1 < w; j += 2) {
              Entry v0[LT], v1[LT];
#pragma unroll
              for (int c = 0; c < LT; ++c) P::load2(vin + (j >> 1) * ps + c * cs, v0[c], v1[c]);
#pragma unroll
              for (int k = 0; k < RT; ++k) {
                Entry a0, a1;
                P::load2(pn + roff[k] + j, a0, a1);
#pragma unroll
                for (int c = 0; c < LT; ++c) {
                  P::mac(acc[k][c], a0, v0[c]);
                  P::mac(acc[k][c], a1, v1[c]);
                }
              }
            }
            if (j < w) {
              Entry vj[LT];
#pragma unroll
              for (int c = 0; c < LT; ++c) vj[c] = P::load(vin + (j >> 1) * ps + c * cs);
#pragma unroll
              for (int k = 0; k < RT; ++k) {
                const Entry a0 = P::load(pn + roff[k] + j);
#pragma unroll
                for (int c = 0; c < LT; ++c) P::mac(acc[k][c], a0, vj[c]);
              }
            }
          }
        }
        end_step();
      }
      if (!active) continue;

      // the tile's rows: each thread its own, of its own lanes; a row's
      // operands read before its results are written
      int lane[LT];
#pragma unroll
      for (int c = 0; c < LT; ++c) lane[c] = g0 + c * LG;
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        const int i = r0 + t + k * g.G;
        if (i >= rows_end) continue;
        float res[LT];
#pragma unroll
        for (int c = 0; c < LT; ++c) res[c] = P::result(acc[k][c]);
        if constexpr (two) {  // rhs of variable row i
          float xs[LT], qs[LT];
#pragma unroll
          for (int c = 0; c < LT; ++c) {
            xs[c] = __ldcg(wx + i * L + lane[c]);
            qs[c] = __ldcg(wq + i * L + lane[c]);
          }
#pragma unroll
          for (int c = 0; c < LT; ++c)
            wr[i * L + lane[c]] = sigma * xs[c] - qs[c] - res[c] + P::result(acc2[k][c]);
        } else if (kind == kKprod) {  // the refinement's residual
#pragma unroll
          for (int c = 0; c < LT; ++c) wres[i * L + lane[c]] = pre[k][c] - res[c];
        } else if (!PACKED && kind == kAx) {  // constraint row i, st = A xt
          update(i, lane, res, lanes_tag);
        } else if (PACKED && i >= n) {  // the image of constraint row i - n
          float st[LT];
#pragma unroll
          for (int c = 0; c < LT; ++c) st[c] = kind == kSolve0 ? res[c] : pre[k][c] + res[c];
          if (ph != last_solve) {
#pragma unroll
            for (int c = 0; c < LT; ++c) wimg[(i - n) * L + lane[c]] = st[c];
          } else {
            update(i - n, lane, st, lanes_tag);
          }
        } else {  // xt of variable row i
          float xt[LT];
#pragma unroll
          for (int c = 0; c < LT; ++c) xt[c] = kind == kSolve0 ? res[c] : pre[k][c] + res[c];
          if (ph != last_solve) {
#pragma unroll
            for (int c = 0; c < LT; ++c) wt[i * L + lane[c]] = xt[c];
          } else {
            float xs[LT];
#pragma unroll
            for (int c = 0; c < LT; ++c) xs[c] = __ldcg(wx + i * L + lane[c]);
#pragma unroll
            for (int c = 0; c < LT; ++c) {
              wx[i * L + lane[c]] = alpha * xt[c] + beta * xs[c];
              if constexpr (!PACKED) wt[i * L + lane[c]] = xt[c];  // for A xt
            }
          }
        }
      }
    }
  };

  // the input vector of a product other than the pass, from the working
  // copy into the fp64 buffer
  auto reload = [&](const float* src) {
    cluster_sync(C);  // the last product's outputs written, its reads of the buffer done
    for (int f = tid; f < n * L; f += kThreads)
      P::store(vbuf + slot(f >> lay.lgl, L, f & (L - 1)), P::entry(__ldcg(src + f)));
    __syncthreads();
  };

  for (int it = 0; it < chunk; ++it) {
    // the ring, restarted: steps 0 .. depth - 1 in flight, step 0 widened
    iss = Step{0, 0, 0};
    wid = Step{0, 0, 0};
    for (int k = 0; k < lay.depth; ++k) {
      issue(iss, k);
      if (iss.ph < phases) advance(iss);
    }
    wait_ring();
    widen(wid, 0, pan);
    advance(wid);
    __syncthreads();
    buf = 0;
    cslot = 0;
    for (int ph = 0; ph < phases; ++ph) {
      const Kind kind = kind_of(ph);
      const Geo g = geo_of(kind);
      if (kind != kPass) reload(kind == kSolve0 ? wr : kind == kSolve ? wres : wt);
      const int tile = g.rt * 16 + g.lt;
      using std::integral_constant;
      if (kind == kPass) {
        switch (tile) {
          case 4 * 16 + 4:
            run(integral_constant<int, 4>{}, integral_constant<int, 4>{}, std::true_type{}, ph);
            break;
          case 2 * 16 + 4:
            run(integral_constant<int, 2>{}, integral_constant<int, 4>{}, std::true_type{}, ph);
            break;
          case 4 * 16 + 2:
            run(integral_constant<int, 4>{}, integral_constant<int, 2>{}, std::true_type{}, ph);
            break;
          case 2 * 16 + 2:
            run(integral_constant<int, 2>{}, integral_constant<int, 2>{}, std::true_type{}, ph);
            break;
          case 4 * 16 + 1:
            run(integral_constant<int, 4>{}, integral_constant<int, 1>{}, std::true_type{}, ph);
            break;
          default:
            run(integral_constant<int, 2>{}, integral_constant<int, 1>{}, std::true_type{}, ph);
            break;
        }
      } else {
        switch (tile) {
          case 4 * 16 + 4:
            run(integral_constant<int, 4>{}, integral_constant<int, 4>{}, std::false_type{}, ph);
            break;
          case 2 * 16 + 4:
            run(integral_constant<int, 2>{}, integral_constant<int, 4>{}, std::false_type{}, ph);
            break;
          case 4 * 16 + 2:
            run(integral_constant<int, 4>{}, integral_constant<int, 2>{}, std::false_type{}, ph);
            break;
          case 2 * 16 + 2:
            run(integral_constant<int, 2>{}, integral_constant<int, 2>{}, std::false_type{}, ph);
            break;
          case 4 * 16 + 1:
            run(integral_constant<int, 4>{}, integral_constant<int, 1>{}, std::false_type{}, ph);
            break;
          default:
            run(integral_constant<int, 2>{}, integral_constant<int, 1>{}, std::false_type{}, ph);
            break;
        }
      }
    }
    cluster_sync(C);  // the update written before the next pass copies y and s
  }

  // the outputs: each live lane's working copy, the cluster's blocks in turn
  for (int f = tid + start; f < n * L; f += stride) {
    const int c = f & (L - 1);
    if (c < live) x_out[(f >> lay.lgl) * B + column(c)] = __ldcg(wx + f);
  }
  for (int f = tid + start; f < m * L; f += stride) {
    const int c = f & (L - 1);
    if (c >= live) continue;
    const int g = (f >> lay.lgl) * B + column(c);
    s_out[g] = __ldcg(ws + f);
    y_out[g] = __ldcg(wy + f);
    ax_out[g] = __ldcg(wax + f);
  }
}

struct Args {
  const float *kinv, *kmat, *a, *at, *rat;
  const float *rho_vecs, *rho_invs, *q, *l, *u;
  const int *order, *starts;
  const float *x_in, *s_in, *y_in, *ax_in;
  float *x_out, *s_out, *y_out, *ax_out, *scratch;
  int n, m, B, R, chunk, refine_steps;
  float sigma, alpha;
};

// a grid of clusters of lay.cluster blocks (one a cluster: a plain launch),
// room in it for every rho's partial last cluster
template <bool PACKED, int MODE>
cudaError_t launch(const Args& a, const Layout& lay, size_t smem, cudaStream_t stream) {
  auto kernel = admm_wide_kernel<PACKED, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lay.cluster * ((a.B + lay.lanes - 1) / lay.lanes + a.R));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = lay.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = lay.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a.kinv, a.kmat, a.a, a.at, a.rat, a.rho_vecs,
                           a.rho_invs, a.q, a.l, a.u, a.order, a.starts, a.x_in, a.s_in, a.y_in,
                           a.ax_in, a.x_out, a.s_out, a.y_out, a.ax_out, a.scratch, a.n, a.m,
                           a.B, a.R, a.chunk, a.refine_steps, a.sigma, a.alpha, lay);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <size_t N>
bool has_tile(const int (&tiles)[N][2], int rt, int lt) {
  for (size_t i = 0; i < N; ++i)
    if (tiles[i][0] == rt && tiles[i][1] == lt) return true;
  return false;
}

int log2_of(int v) {
  int k = 0;
  while ((1 << k) < v) ++k;
  return k;
}

// One product's geometry at rt x lt a thread (false where the lanes do
// not split into lt a thread, or a panel holds fewer than 4 columns): each
// block of a cluster takes a span of ceil(rows / cluster) rows, in as few
// tiles as the block's row-groups allow, as few row-groups as cover the
// span in them, and the widest panel of whole 4-entry chunks whose
// fp64 entries (at a row stride odd in 16-byte units) and staged vectors
// fit `panel` doubles (their 4-byte entries then fit a ring slot of `panel`
// floats). ops/admm_fused.wide_geometry mirrors it.
bool make_geo(Geo& g, int rows, int cols, int ops, int vecs, int rt, int lt, int lanes,
              int cluster, int panel) {
  g.rows = rows;
  g.cols = cols;
  g.ld = round4(cols);
  g.span = (rows + cluster - 1) / cluster;
  g.ops = ops;
  g.vecs = vecs;
  g.rt = rt;
  g.lt = lt;
  if (lanes % lt != 0) return false;
  const int lg = lanes / lt;
  g.lgl = log2_of(lg);
  const int most = kThreads / lg;  // row-groups
  g.tiles = (g.span + rt * most - 1) / (rt * most);
  g.G = (g.span + g.tiles * rt - 1) / (g.tiles * rt);
  g.H = rt * g.G;
  const long long by_panel = (static_cast<long long>(panel) - 2LL * ops * g.H) /
                             (static_cast<long long>(ops) * g.H + 1LL * vecs * lanes);
  long long pk = g.ld;
  if (by_panel < pk) pk = by_panel;
  g.pk = static_cast<int>(pk < 0 ? 0 : pk & ~3LL);
  g.sp = g.pk + 2;
  g.np = g.pk > 0 ? (cols + g.pk - 1) / g.pk : 0;
  return g.pk >= 4;
}

// The layout of a launch (false where a product has none).
// ops/admm_fused.wide_layout mirrors it.
bool make_layout(bool packed, int n, int m, bool refine, int lanes, int rt_pass, int lt_pass,
                 int rt, int lt, int depth, int panel, int cluster, Layout& lay) {
  lay.lanes = lanes;
  lay.lgl = log2_of(lanes);
  lay.cluster = cluster;
  lay.depth = depth;
  lay.panel = panel;
  lay.nslots = (n + 1) & ~1;
  lay.n4 = round4(n);
  lay.m4 = round4(m);
  const int wrows = packed ? n + m : n;
  bool ok = make_geo(lay.g[0], n, m, 2, 2, rt_pass, lt_pass, lanes, cluster, panel);
  ok = make_geo(lay.g[1], wrows, n, 1, 0, rt, lt, lanes, cluster, panel) && ok;
  ok = (make_geo(lay.g[2], n, n, 1, 0, rt, lt, lanes, cluster, panel) || !refine) && ok;
  ok = (make_geo(lay.g[3], m, n, 1, 0, rt, lt, lanes, cluster, panel) || packed) && ok;
  return ok;
}

// The entry of K5 (PACKED false) or K4: the checks, the layout, its bytes,
// the precision's instantiation.
template <bool PACKED>
int wide_chunk(const Args& a, int mode, int lanes, int rt_pass, int lt_pass, int rt, int lt,
               int depth, int panel, int cluster, int smem_bytes, void* stream) {
  const int n = a.n, m = a.m;
  if (n <= 0 || n > kMaxN || m <= 0 || m > kMaxRows || a.B <= 0 || a.R <= 0 || a.chunk < 0 ||
      a.refine_steps < 0 || static_cast<long long>(m) * a.B > INT_MAX ||
      static_cast<long long>(n) * a.B > INT_MAX ||
      (lanes != 1 && lanes != 2 && lanes != 4 && lanes != 8 && lanes != 16 && lanes != 32 &&
       lanes != 64) ||
      !has_tile(kTiles, rt_pass, lt_pass) || !has_tile(kTiles, rt, lt) || depth < 2 ||
      depth > kMaxDepth || panel <= 0 || panel % 8 != 0 ||
      cluster < 1 || cluster > kMaxCluster || n < cluster || m < cluster ||
      a.scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout lay;
  if (!make_layout(PACKED, n, m, a.refine_steps > 0, lanes, rt_pass, lt_pass, rt, lt, depth,
                   panel, cluster, lay))
    return static_cast<int>(cudaErrorInvalidValue);
  // the bytes of the layout (ops/admm_fused.wide_smem_bytes mirrors these
  // three lines, which tests/test_torch_build.py reads)
  const long long wide_doubles = 2LL * panel + 1LL * lay.nslots * lanes;
  const long long ring_floats = 1LL * depth * panel;
  const long long wide_need = 8 * wide_doubles + 4 * ring_floats;
  if (wide_need != smem_bytes || wide_need > static_cast<long long>(mpc_admm::kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(wide_need);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case mpc_admm::kHighest:
      return static_cast<int>(launch<PACKED, mpc_admm::kHighest>(a, lay, smem, st));
    case mpc_admm::kBf16x3:
      return static_cast<int>(launch<PACKED, mpc_admm::kBf16x3>(a, lay, smem, st));
    case mpc_admm::kDefault:
      return static_cast<int>(launch<PACKED, mpc_admm::kDefault>(a, lay, smem, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// K5 on the wide route: launch `chunk` iterations on `stream` at precision
// `mode` (0 "highest", 1 "bf16x3", 2 "default"; ops/admm_fused.PRECISIONS).
// kinv, kmat (R, n, ldn) are K^-1 and K transposed (row j holds column j),
// a (m, ldn) is A, at (n, ldm) A' and rat (R, n, ldm) fl(rho_r A)', all as
// 4-byte entries (the fp32 value at "highest", the bf16 pair (hi, lo) at
// "bf16x3", (hi, 0) at "default", hi in the low half:
// ops/admm_fused.narrow_entries) with rows padded to ldn = n and ldm = m
// rounded up to a multiple of 4 (kmat unused when refine_steps == 0); the
// other arrays float32 and contiguous on one device: rho_vecs, rho_invs
// (R, m), q, x_in, x_out (n, B), l, u, s_in, y_in, ax_in and their outputs
// (m, B); order (B), the lanes sorted by rho index (stable), and starts (R
// + 1), where each index's lanes start in that order
// (admm_fused.rho_order); scratch, the working copy's floats
// (admm_fused.wide_scratch_floats). Takes n <= 1024, 1 <= m <= 4096 and m
// B, n B < 2^31. The layout comes from ops/admm_fused.k5_plan: lanes a
// block (1 to 64, a power of 2), the rows and lanes a thread takes in the
// pass (rt_pass, lt_pass) and in the other products (rt, lt), each of
// kTiles, the ring's slots (depth, 2 to 4), the doubles of one fp64 panel
// (panel, a multiple of 8), the blocks of a cluster that share their lanes
// (cluster, 1 or 2, at most n and m) and the dynamic shared memory a block
// takes, which must equal what the kernel's layout needs. Returns the
// cudaError_t of the launch (0 on success).
int admm_perr_wide_chunk(const float* kinv, const float* kmat, const float* a,
                         const float* at, const float* rat, const float* rho_vecs,
                         const float* rho_invs, const float* q, const float* l, const float* u,
                         const int* order, const int* starts, const float* x_in,
                         const float* s_in, const float* y_in, const float* ax_in, float* x_out,
                         float* s_out, float* y_out, float* ax_out, float* scratch, int n, int m,
                         int B, int R, int chunk, int refine_steps, int mode, int lanes,
                         int rt_pass, int lt_pass, int rt, int lt, int depth, int panel,
                         int cluster, int smem_bytes, float sigma, float alpha, void* stream) {
  const Args args{kinv, kmat, a, at, rat, rho_vecs, rho_invs, q, l, u, order, starts,
                  x_in, s_in, y_in, ax_in, x_out, s_out, y_out, ax_out, scratch,
                  n, m, B, R, chunk, refine_steps, sigma, alpha};
  return wide_chunk<false>(args, mode, lanes, rt_pass, lt_pass, rt, lt, depth, panel, cluster,
                           smem_bytes, stream);
}

// K4 on the wide route: as admm_perr_wide_chunk, with w (R, n + m, ldn) in
// place of kinv: rows 0..n-1 of w_r are K_r^-1 transposed, rows
// n..n+m-1 kia_r = K_r^-1 A' transposed (row i holds column i); a is
// unused. The layout from ops/admm_fused.k4_plan.
int admm_packed_wide_chunk(const float* w, const float* kmat, const float* a,
                           const float* at, const float* rat, const float* rho_vecs,
                           const float* rho_invs, const float* q, const float* l, const float* u,
                           const int* order, const int* starts, const float* x_in,
                           const float* s_in, const float* y_in, const float* ax_in,
                           float* x_out, float* s_out, float* y_out, float* ax_out,
                           float* scratch, int n, int m, int B, int R, int chunk,
                           int refine_steps, int mode, int lanes, int rt_pass, int lt_pass,
                           int rt, int lt, int depth, int panel, int cluster, int smem_bytes,
                           float sigma, float alpha, void* stream) {
  const Args args{w, kmat, a, at, rat, rho_vecs, rho_invs, q, l, u, order, starts,
                  x_in, s_in, y_in, ax_in, x_out, s_out, y_out, ax_out, scratch,
                  n, m, B, R, chunk, refine_steps, sigma, alpha};
  return wide_chunk<true>(args, mode, lanes, rt_pass, lt_pass, rt, lt, depth, panel, cluster,
                          smem_bytes, stream);
}

}  // extern "C"
