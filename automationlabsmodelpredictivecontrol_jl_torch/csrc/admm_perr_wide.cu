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
// where neither of the other two has a layout. It is K1's and K2's stream
// route (admm_diag_stream.cu) with no box rows: the same schedule of row
// tiles and panels, every operator's rows being the rows a product
// writes:
//
// - The pass (A'y and sum_i s_i fl(rho_r,i A_i.)): A' (n, m) and
//   fl(rho_r A)' (n, m), both summed over the m constraint rows against y
//   and s; a panel holds a tile's rows of both, one below the other.
// - The solves: K_r^-1' (n rows; K4: W_r = [K_r^-1'; kia_r'], n + m rows,
//   whose last m give the image st), the refinement's K_r' (n rows), and
//   K5's A xt (A, m rows), all summed over n.
//
// How lanes meet their operators: the wrapper orders the lanes by rho index
// on the device (admm_fused.rho_order, no host sync) and each block takes
// lanes of one index (mpc_admm::rho_block), so it needs one rho's
// operators, handed over as the precision's 8-byte entries in device
// memory, rows padded to an even stride (built once per operator and
// precision, admm_fused.kernel_operators). Where they fit the block's two
// panels whole they are copied into shared memory once a chunk; elsewhere
// each product streams its operator through the two panels with cp.async,
// the next panel in flight while the block computes on the current one.
//
// Rows of any count: a product runs over tiles of H = 4 G rows (G the
// block's row-groups), thread (b, t) taking rows t + k G of a tile (k < 4)
// of lane b, and a panel holds H rows (the pass: 2 H) of pk columns; the
// panels go tile by tile, each tile's columns in index order, so every
// output still sums in index order. Row i of every product falls to thread
// t = i mod G (K4's constraint row i to that of W's row n + i), so a
// thread alone reads and writes its rows of the lane state, which lives in
// device memory, the outputs serving as the working copy. Shared memory
// holds only what the products read: the two panels, the n-row buffers of
// rhs (then the refinement residual) and xt, the m-row buffers of y and s,
// and, when refining, rhs and xt (K4: also the image st) in fp32. At m =
// 3839 y and s alone take 61 KB a lane, so a block takes 1, 2, 4, 8, 16 or
// 32 lanes, as few as the vectors need.
//
// What bounds it on this card: each block re-reads its rho's operators
// from L2 every iteration (at (200, 600, 5, 1) 3.5 MB a block and
// iteration), so the panels' copies, more than the fp64 multiply-adds (3 m
// n + (1 + 2 refine) n^2 per lane and iteration for K5) or their
// shared-memory reads, set its time; the plan
// (ops/admm_fused._wide_cost) weighs the copies against the lanes a block
// shares them with. Making it fast is later work.
//
// Precision, as on the other routes: the state is fp32; at "highest" every
// matrix-vector product is accumulated in fp64 from exact fp32 products in
// index order and rounded once; at "bf16x3" and "default" (the template
// parameter MODE, admm_common.cuh) each is that precision's passes over the
// operators' bf16 pairs and the vectors split when written to the lane
// buffers. The plain versions (admm_fused.iterate_chunk_dense_perr_T_plain,
// iterate_chunk_dense_packed_T_plain) sum in the same order, so the two
// agree bit for bit. Built with --fmad=false so the elementwise updates
// round like PyTorch's.
//
// Every thread reaches every barrier (the loops' bounds are the block's);
// spare blocks return before the first; lanes past their rho's count run on
// its last lane's inputs and store nothing.
//
// Bound to PyTorch by ctypes through the plain C functions
// admm_perr_wide_chunk (K5) and admm_packed_wide_chunk (K4), which return
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "admm_common.cuh"

namespace {

using mpc_admm::clip;
using mpc_admm::panel_stride;
using mpc_admm::Prec;
using mpc_admm::slot;

constexpr int kRows = 4;         // rows a thread takes in each tile of a product
constexpr int kThreads = 512;    // the most threads a block may have
constexpr int kMaxN = 1024;      // the widest n
constexpr int kMaxRows = 4096;   // the most constraint rows

// the products of an iteration: the pass, the first solve, the
// refinement's K product and solve, K5's A xt
enum Kind { kPass, kSolve0, kKprod, kSolve, kAx };

struct Layout {
  int ldn, ldm;      // row strides (doubles) in device memory: n and m rounded up to even
  int nslots, mslots;  // lane buffer rows
  int panel;         // doubles of one panel
  int sn, pn;        // row stride and columns of a panel of an n-column operator
  int sm, pm;        // the same for the pass's A' and fl(rho A)' (m columns)
  int resident;      // one rho's operators whole in the panels for the chunk
  int rat_at, w_at, k_at, a_at;  // resident: where fl(rho A)', K^-1' (W), K' and A start (A' at 0)
};

// one operator of a product: its rows in device memory (rows x cols at
// stride ld; the pass's second, fl(rho A)', at M2), its panel's row stride
// and columns, and where it sits when resident
struct Geo {
  const double* M;
  const double* M2;
  int rows, cols, ld, sp, pk, at, at2;
};

template <bool PACKED, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
admm_wide_kernel(const double* __restrict__ kinv,  // (R, n, ldn) K^-1'; PACKED: W (R, n + m, ldn)
                 const double* __restrict__ kmat,  // (R, n, ldn) K'
                 const double* __restrict__ a,     // (m, ldn) A (K5's A xt)
                 const double* __restrict__ at,    // (n, ldm) A'
                 const double* __restrict__ rat,   // (R, n, ldm) fl(rho_r A)'
                 const float* __restrict__ rho_vecs,  // (R, m)
                 const float* __restrict__ rho_invs,
                 const float* __restrict__ q, const float* __restrict__ l,
                 const float* __restrict__ u,
                 const int* __restrict__ order,
                 const int* __restrict__ starts,
                 const float* x_in, const float* s_in, const float* y_in,
                 const float* ax_in, float* x_out, float* s_out, float* y_out,
                 float* ax_out, int n, int m, int B, int R, int chunk,
                 int refine_steps, float sigma, float alpha, Layout lay) {
  using P = Prec<MODE>;
  using Entry = typename P::Entry;
  extern __shared__ __align__(16) double smem[];
  const int L = blockDim.x;
  const int G = blockDim.y;
  const int b = threadIdx.x;
  const int t = threadIdx.y;
  const int tid = t * L + b;
  const int nthreads = L * G;
  const int H = kRows * G;  // rows of a tile

  // the block's lanes: one rho index's (mpc_admm::rho_block)
  const mpc_admm::RhoBlock rb = mpc_admm::rho_block(starts, R, L);
  if (rb.r == R) return;  // a spare block: every thread, before any barrier
  const int r = rb.r;
  const int off = rb.off + b;
  const bool live = off < rb.cnt;
  const int lc = order[rb.seg + (live ? off : rb.cnt - 1)];

  const bool refine = refine_steps > 0;
  const int wrows = PACKED ? n + m : n;  // rows of the solves' operator
  double* pan = smem;                                // two panels
  double* vbuf = pan + 2 * lay.panel;                // n rows: two buffers (rhs or residual, xt)
  double* ybuf = vbuf + 2 * lay.nslots * L;          // m rows: y
  double* sbuf = ybuf + lay.mslots * L;              // m rows: s
  float* rhs_f = reinterpret_cast<float*>(sbuf + lay.mslots * L);  // when refining
  float* xt_f = rhs_f + n * L;
  float* img_f = xt_f + n * L;                       // K4 when refining: the image st
  const double* w_r = kinv + static_cast<size_t>(r) * wrows * lay.ldn;
  const double* k_r = kmat + static_cast<size_t>(r) * n * lay.ldn;
  const double* rat_r = rat + static_cast<size_t>(r) * n * lay.ldm;
  const float* rho_r = rho_vecs + static_cast<size_t>(r) * m;
  const float* rhoi_r = rho_invs + static_cast<size_t>(r) * m;
  // the state: a live lane's in the outputs, its working copy; a lane
  // past its rho's count reads its stand-in's inputs and writes nothing
  const float* xs = live ? x_out : x_in;
  const float* ss = live ? s_out : s_in;
  const float* ys = live ? y_out : y_in;
  const float* axs = live ? ax_out : ax_in;
  const float beta = 1.0f - alpha;
  const int ps = 2 * L;  // doubles between a lane's row pairs

  // the working copy of the state, and y and s for the first pass; a
  // constraint row is the thread's whose row of the product that updates
  // it is (K5: row i of A xt; K4: row n + i of W)
  for (int i = t; i < n; i += G) {
    if (live) x_out[i * B + lc] = x_in[i * B + lc];
  }
  for (int i = PACKED ? ((t - n) % G + G) % G : t; i < m; i += G) {
    const int g = i * B + lc;
    const float s = s_in[g], y = y_in[g];
    if (live) {
      s_out[g] = s;
      y_out[g] = y;
      ax_out[g] = ax_in[g];
    }
    P::store(ybuf + slot(i, L, b), P::entry(y));
    P::store(sbuf + slot(i, L, b), P::entry(s));
  }

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
  auto geo = [&](Kind kind) {
    if (kind == kPass) return Geo{at, rat_r, n, m, lay.ldm, lay.sm, lay.pm, 0, lay.rat_at};
    if (kind == kAx) return Geo{a, nullptr, m, n, lay.ldn, lay.sn, lay.pn, lay.a_at, 0};
    if (kind == kKprod) return Geo{k_r, nullptr, n, n, lay.ldn, lay.sn, lay.pn, lay.k_at, 0};
    return Geo{w_r, nullptr, wrows, n, lay.ldn, lay.sn, lay.pn, lay.w_at, 0};
  };
  // start copying the panel of phase ph, tile `tile`, columns panel cp;
  // the pass's fl(rho A)' rows go below its A' rows
  auto issue = [&](int ph, int tile, int cp, double* dst) {
    const Geo g = geo(kind_of(ph));
    const int r0 = tile * H;
    const int c0 = cp * g.pk;
    const int rows = min(H, g.rows - r0);
    const int cols = min(g.pk, g.cols - c0);
    mpc_admm::copy_rows(dst, g.sp, g.M + r0 * g.ld + c0, g.ld, rows, cols, tid, nthreads);
    if (g.M2 != nullptr)
      mpc_admm::copy_rows(dst + H * g.sp, g.sp, g.M2 + r0 * g.ld + c0, g.ld, rows, cols, tid,
                          nthreads);
  };
  // the update of constraint row i from its image st, in iteration it
  auto update = [&](int i, float st, int it) {
    const int gi = i * B + lc;
    const float s0 = ss[gi], y0 = ys[gi];
    const float v = alpha * st + beta * s0;
    const float s_new = clip(v + rhoi_r[i] * y0, l[gi], u[gi]);
    const float y_new = y0 + rho_r[i] * (v - s_new);
    const float ax_new = alpha * st + beta * axs[gi];
    if (live) {
      s_out[gi] = s_new;
      y_out[gi] = y_new;
      ax_out[gi] = ax_new;
    }
    if (it + 1 < chunk) {
      P::store(ybuf + slot(i, L, b), P::entry(y_new));
      P::store(sbuf + slot(i, L, b), P::entry(s_new));
    }
  };

  if (lay.resident) {  // one rho's operators, once a chunk
    mpc_admm::copy_rows(pan, lay.sm, at, lay.ldm, n, m, tid, nthreads);
    mpc_admm::copy_rows(pan + lay.rat_at, lay.sm, rat_r, lay.ldm, n, m, tid, nthreads);
    mpc_admm::copy_rows(pan + lay.w_at, lay.sn, w_r, lay.ldn, wrows, n, tid, nthreads);
    if (refine) mpc_admm::copy_rows(pan + lay.k_at, lay.sn, k_r, lay.ldn, n, n, tid, nthreads);
    if (!PACKED) mpc_admm::copy_rows(pan + lay.a_at, lay.sn, a, lay.ldn, m, n, tid, nthreads);
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else if (chunk > 0) {
    issue(0, 0, 0, pan);
    __pipeline_commit();
  }

  int buf = 0;  // the panel being read (streamed)
  int cur = 0;  // the n-row buffer that holds the next solve's input
  for (int it = 0; it < chunk; ++it) {
    for (int ph = 0; ph < phases; ++ph) {
      const Kind kind = kind_of(ph);
      const Geo g = geo(kind);
      const bool pass = kind == kPass;
      const bool solve = kind == kSolve0 || kind == kKprod || kind == kSolve;
      const int nt = (g.rows + H - 1) / H;
      const int np = lay.resident ? 1 : (g.cols + g.pk - 1) / g.pk;
      // a solve reads one n-row buffer and writes the other; the pass reads
      // y and s and writes the buffer the first solve reads; A xt reads the
      // last solve's xt and writes y and s
      const double* vin = vbuf + cur * lay.nslots * L + 2 * b;
      double* vout = vbuf + (pass ? cur : cur ^ 1) * lay.nslots * L;
      for (int tile = 0; tile < nt; ++tile) {
        const int r0 = tile * H;
        const int nr = min(H, g.rows - r0);
        int roff[kRows];  // a padded row reads the tile's last one
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int rl = t + k * G;
          roff[k] = (rl < nr ? rl : nr - 1) * g.sp;
        }
        typename P::Acc acc[2 * kRows];  // the second half: the pass's fl(rho A)' s
#pragma unroll
        for (int k = 0; k < 2 * kRows; ++k) P::zero(acc[k]);
        for (int cp = 0; cp < np; ++cp) {
          const double* pn;
          const double* pn2;
          if (!lay.resident) {
            // the next panel of the schedule into the other buffer
            int nph = ph, ntile = tile, ncp = cp + 1;
            if (ncp == np) {
              ncp = 0;
              if (++ntile == nt) {
                ntile = 0;
                ++nph;
              }
            }
            bool more = true;
            if (nph == phases) {
              nph = 0;
              more = it + 1 < chunk;
            }
            if (more) issue(nph, ntile, ncp, pan + (buf ^ 1) * lay.panel);
            __pipeline_commit();
            __pipeline_wait_prior(1);
            __syncthreads();  // the panel and the lane buffers it meets are complete
            pn = pan + buf * lay.panel;
            pn2 = pn + H * g.sp;
          } else {
            if (tile == 0) __syncthreads();  // the phase's input buffers are complete
            pn = pan + g.at + r0 * g.sp;
            pn2 = pan + g.at2 + r0 * g.sp;
          }
          const int c0 = cp * g.pk;
          const int c1 = min(g.cols, c0 + g.pk);
          int j = c0;
          if (pass) {
            const double* y_b = ybuf + 2 * b;
            const double* s_b = sbuf + 2 * b;
#pragma unroll 2
            for (; j + 1 < c1; j += 2) {
              Entry y0, y1, s0, s1;
              P::load2(y_b + (j >> 1) * ps, y0, y1);
              P::load2(s_b + (j >> 1) * ps, s0, s1);
#pragma unroll
              for (int k = 0; k < kRows; ++k) {
                Entry a0, a1, w0, w1;
                P::load2(pn + roff[k] + (j - c0), a0, a1);
                P::load2(pn2 + roff[k] + (j - c0), w0, w1);
                P::mac(acc[k], a0, y0);
                P::mac(acc[kRows + k], w0, s0);
                P::mac(acc[k], a1, y1);
                P::mac(acc[kRows + k], w1, s1);
              }
            }
            if (j < c1) {
              const Entry yj = P::load(y_b + (j >> 1) * ps);
              const Entry sj = P::load(s_b + (j >> 1) * ps);
#pragma unroll
              for (int k = 0; k < kRows; ++k) {
                P::mac(acc[k], P::load(pn + roff[k] + (j - c0)), yj);
                P::mac(acc[kRows + k], P::load(pn2 + roff[k] + (j - c0)), sj);
              }
            }
          } else {
#pragma unroll 2
            for (; j + 1 < c1; j += 2) {
              Entry v0, v1;
              P::load2(vin + (j >> 1) * ps, v0, v1);
#pragma unroll
              for (int k = 0; k < kRows; ++k) {
                Entry a0, a1;
                P::load2(pn + roff[k] + (j - c0), a0, a1);
                P::mac(acc[k], a0, v0);
                P::mac(acc[k], a1, v1);
              }
            }
            if (j < c1) {
              const Entry vj = P::load(vin + (j >> 1) * ps);
#pragma unroll
              for (int k = 0; k < kRows; ++k) P::mac(acc[k], P::load(pn + roff[k] + (j - c0)), vj);
            }
          }
          if (!lay.resident) {
            __syncthreads();  // every thread is done with the panel
            buf ^= 1;
          }
        }

        // the tile's rows: each thread its own, of its own lane
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int i = r0 + t + k * G;
          if (i >= g.rows) continue;
          const float res = P::result(acc[k]);
          if (pass) {  // rhs of variable row i
            const int gi = i * B + lc;
            const float rhs = sigma * xs[gi] - q[gi] - res + P::result(acc[kRows + k]);
            if (refine) rhs_f[i * L + b] = rhs;
            P::store(vout + slot(i, L, b), P::entry(rhs));
          } else if (kind == kKprod) {  // the refinement's residual
            P::store(vout + slot(i, L, b), P::entry(rhs_f[i * L + b] - res));
          } else if (!PACKED && kind == kAx) {  // constraint row i, st = A xt
            update(i, res, it);
          } else if (PACKED && i >= n) {  // the image of constraint row i - n
            const int c = i - n;
            const float st = kind == kSolve0 ? res : img_f[c * L + b] + res;
            if (ph != last_solve)
              img_f[c * L + b] = st;
            else
              update(c, st, it);
          } else {  // xt of variable row i
            const float xt = kind == kSolve0 ? res : xt_f[i * L + b] + res;
            if (ph != last_solve) {
              xt_f[i * L + b] = xt;
              P::store(vout + slot(i, L, b), P::entry(xt));
              continue;
            }
            const int gi = i * B + lc;
            const float x_new = alpha * xt + beta * xs[gi];
            if (live) x_out[gi] = x_new;
            if constexpr (!PACKED) P::store(vout + slot(i, L, b), P::entry(xt));  // for A xt
          }
        }
      }
      if (solve) cur ^= 1;
    }
  }
}

struct Args {
  const double *kinv, *kmat, *a, *at, *rat;
  const float *rho_vecs, *rho_invs, *q, *l, *u;
  const int *order, *starts;
  const float *x_in, *s_in, *y_in, *ax_in;
  float *x_out, *s_out, *y_out, *ax_out;
  int n, m, B, R, chunk, refine_steps;
  float sigma, alpha;
};

template <bool PACKED, int MODE>
cudaError_t launch(const Args& a, int lanes, int groups, const Layout& lay, size_t smem,
                   cudaStream_t stream) {
  auto kernel = admm_wide_kernel<PACKED, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + lanes - 1) / lanes + a.R);
  const dim3 block(lanes, groups);
  kernel<<<grid, block, smem, stream>>>(
      a.kinv, a.kmat, a.a, a.at, a.rat, a.rho_vecs, a.rho_invs, a.q, a.l, a.u, a.order,
      a.starts, a.x_in, a.s_in, a.y_in, a.ax_in, a.x_out, a.s_out, a.y_out, a.ax_out, a.n, a.m,
      a.B, a.R, a.chunk, a.refine_steps, a.sigma, a.alpha, lay);
  return cudaGetLastError();
}

// The layout of a launch of `groups` row-groups and panels of `panel`
// doubles; false if a panel holds fewer than 2 columns of a tile.
// ops/admm_fused.wide_layout mirrors it.
bool make_layout(bool packed, int n, int m, bool refine, int groups, int panel, Layout& lay) {
  const int H = kRows * groups;
  lay.ldn = n + (n & 1);
  lay.ldm = m + (m & 1);
  lay.nslots = (n + 1) & ~1;
  lay.mslots = (m + 1) & ~1;
  lay.panel = panel;
  // whole rows at the least stride whose rows a warp reads without conflicts
  const int fn = panel_stride(lay.ldn + 2, 1, lay.ldn);
  const int fm = panel_stride(lay.ldm + 2, 1, lay.ldm);
  lay.rat_at = n * fm;
  lay.w_at = 2 * n * fm;
  lay.k_at = lay.w_at + (packed ? n + m : n) * fn;
  lay.a_at = lay.k_at + (refine ? n * fn : 0);
  const long long whole = lay.a_at + (packed ? 0LL : static_cast<long long>(m) * fn);
  lay.resident = whole <= 2LL * panel;
  if (lay.resident) {
    lay.sn = fn;
    lay.pn = lay.ldn;
    lay.sm = fm;
    lay.pm = lay.ldm;
    return true;
  }
  lay.sn = panel_stride(panel, H, lay.ldn);
  lay.pn = lay.sn < lay.ldn ? lay.sn : lay.ldn;
  lay.sm = panel_stride(panel, 2 * H, lay.ldm);
  lay.pm = lay.sm < lay.ldm ? lay.sm : lay.ldm;
  return lay.sn > 0 && lay.sm > 0;
}

// The entry of K5 (PACKED false) or K4: the checks, the layout, its bytes,
// the precision's instantiation.
template <bool PACKED>
int wide_chunk(const Args& a, int mode, int lanes, int groups, int panel, int smem_bytes,
               void* stream) {
  const int n = a.n, m = a.m;
  if (n <= 0 || n > kMaxN || m <= 0 || m > kMaxRows || a.B <= 0 || a.R <= 0 || a.chunk < 0 ||
      a.refine_steps < 0 || static_cast<long long>(m) * a.B > INT_MAX ||
      static_cast<long long>(n) * a.B > INT_MAX ||
      (lanes != 1 && lanes != 2 && lanes != 4 && lanes != 8 && lanes != 16 && lanes != 32) ||
      groups <= 0 || lanes * groups > kThreads || panel <= 0 || panel % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout lay;
  if (!make_layout(PACKED, n, m, a.refine_steps > 0, groups, panel, lay))
    return static_cast<int>(cudaErrorInvalidValue);
  // the bytes of the layout (ops/admm_fused.wide_smem_bytes mirrors these
  // four lines, which tests/test_torch_build.py reads)
  const long long wide_doubles = 2LL * panel + 2LL * (lay.nslots + lay.mslots) * lanes;
  const long long refine_floats = a.refine_steps > 0 ? 2LL * n * lanes : 0;
  const long long image_floats = PACKED && a.refine_steps > 0 ? 1LL * m * lanes : 0;
  const long long wide_need = 8 * wide_doubles + 4 * (refine_floats + image_floats);
  if (wide_need != smem_bytes || wide_need > static_cast<long long>(mpc_admm::kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(wide_need);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case mpc_admm::kHighest:
      return static_cast<int>(launch<PACKED, mpc_admm::kHighest>(a, lanes, groups, lay, smem, st));
    case mpc_admm::kBf16x3:
      return static_cast<int>(launch<PACKED, mpc_admm::kBf16x3>(a, lanes, groups, lay, smem, st));
    case mpc_admm::kDefault:
      return static_cast<int>(launch<PACKED, mpc_admm::kDefault>(a, lanes, groups, lay, smem, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// K5 on the wide route: launch `chunk` iterations on `stream` at precision
// `mode` (0 "highest", 1 "bf16x3", 2 "default"; ops/admm_fused.PRECISIONS).
// kinv, kmat (R, n, ldn) are K^-1 and K transposed (row j holds column j),
// a (m, ldn) is A, at (n, ldm) A' and rat (R, n, ldm) fl(rho_r A)', all as
// the precision's 8-byte entries (fp64 at "highest", the fp32 pair (hi,
// lo) at "bf16x3", (hi, 0) at "default": ops/admm_fused.operator_entries)
// with rows padded to ldn = n and ldm = m rounded up to even (kmat unused
// when refine_steps == 0); the other arrays float32 and contiguous on one
// device: rho_vecs, rho_invs (R, m), q, x_in, x_out (n, B), l, u, s_in,
// y_in, ax_in and their outputs (m, B); order (B), the lanes sorted by rho
// index (stable), and starts (R + 1), where each index's lanes start in
// that order (admm_fused.rho_order). Takes n <= 1024, 1 <= m <= 4096 and
// m B, n B < 2^31. The layout comes from ops/admm_fused.k5_plan: lanes (1,
// 2, 4, 8, 16 or 32) and groups per block (at most 512 threads), the
// doubles of one operator panel (panel) and the dynamic shared memory they
// take, which must equal what the kernel's layout needs. Returns the
// cudaError_t of the launch (0 on success).
int admm_perr_wide_chunk(const double* kinv, const double* kmat, const double* a,
                         const double* at, const double* rat, const float* rho_vecs,
                         const float* rho_invs, const float* q, const float* l, const float* u,
                         const int* order, const int* starts, const float* x_in,
                         const float* s_in, const float* y_in, const float* ax_in, float* x_out,
                         float* s_out, float* y_out, float* ax_out, int n, int m, int B, int R,
                         int chunk, int refine_steps, int mode, int lanes, int groups, int panel,
                         int smem_bytes, float sigma, float alpha, void* stream) {
  const Args args{kinv, kmat, a, at, rat, rho_vecs, rho_invs, q, l, u, order, starts,
                  x_in, s_in, y_in, ax_in, x_out, s_out, y_out, ax_out,
                  n, m, B, R, chunk, refine_steps, sigma, alpha};
  return wide_chunk<false>(args, mode, lanes, groups, panel, smem_bytes, stream);
}

// K4 on the wide route: as admm_perr_wide_chunk, with w (R, n + m, ldn) in
// place of kinv: rows 0..n-1 of w_r are K_r^-1 transposed, rows
// n..n+m-1 kia_r = K_r^-1 A' transposed (row i holds column i); a is
// unused. The layout from ops/admm_fused.k4_plan.
int admm_packed_wide_chunk(const double* w, const double* kmat, const double* a,
                           const double* at, const double* rat, const float* rho_vecs,
                           const float* rho_invs, const float* q, const float* l, const float* u,
                           const int* order, const int* starts, const float* x_in,
                           const float* s_in, const float* y_in, const float* ax_in,
                           float* x_out, float* s_out, float* y_out, float* ax_out, int n, int m,
                           int B, int R, int chunk, int refine_steps, int mode, int lanes,
                           int groups, int panel, int smem_bytes, float sigma, float alpha,
                           void* stream) {
  const Args args{w, kmat, a, at, rat, rho_vecs, rho_invs, q, l, u, order, starts,
                  x_in, s_in, y_in, ax_in, x_out, s_out, y_out, ax_out,
                  n, m, B, R, chunk, refine_steps, sigma, alpha};
  return wide_chunk<true>(args, mode, lanes, groups, panel, smem_bytes, stream);
}

}  // extern "C"
