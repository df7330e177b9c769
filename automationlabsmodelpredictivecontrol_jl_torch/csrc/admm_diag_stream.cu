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
// How lanes meet their operators, as K5's stream route (admm_perr.cu): the
// wrapper orders the lanes by rho index on the device (admm_fused.rho_order,
// no host sync) and each block takes lanes of one index only, reading and
// writing them through the order, so it needs one rho's operators: K^-1, K
// when refining, and for K2 A2' and A2, handed over by the wrapper as the
// precision's 8-byte entries in device memory, rows padded to an even
// stride (built once per operator, admm_fused.kernel_operators). Where they
// fit the block's two panels whole they are copied into shared memory once
// a chunk (resident: at n = 100 and the default config, K^-1 and K take
// 160 KB); elsewhere each product streams its operator through the two
// panels with cp.async, the next panel in flight while the block computes
// on the current one.
//
// Rows of any width: a product runs over tiles of H = 4 G rows (G the
// block's row-groups), thread (b, t) taking rows t + k G of a tile (k < 4)
// of lane b, and a panel holds H rows of pk columns; the panels go tile by
// tile, each tile's columns in index order, so every output still sums in
// index order. The lane's state therefore cannot stay in registers: it
// lives in device memory, the outputs serving as the working copy (a
// thread owns rows t, t + G, ... of its lane in every product and update,
// so it alone reads and writes them), and the vectors the products read
// in shared memory: the box rows' two buffers (rhs or the residual, xt),
// K2's tail rows' two (y and rho.s), and, when refining, rhs and xt in
// fp32 beside them.
//
// What bounds it on this card: the shared-memory reads that feed the fp64
// multiply-adds (one operator entry per lane and multiply-add, the lane's
// vector once per 4 rows), and where the operators are streamed, the
// panels' copies from L2, one rho's operators a block and iteration; the
// plan (ops/admm_fused._k12_stream_cost) weighs both. The state's reads
// and writes in device memory (11 floats a row, lane and iteration) come
// on top, coalesced where a block's lanes are neighbours.
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
// rounded up to even) x L doubles each; K2's tail buffers, likewise; when
// refining, rhs and xt, n x L floats each. Every thread reaches every
// barrier (the loops' bounds are the block's); spare blocks (each rho's
// partial last one leaves some) return before the first; lanes past their
// rho's count run on its last lane's inputs and store nothing.
//
// Bound to PyTorch by ctypes through the plain C functions
// admm_diag_stream_chunk (K1) and admm_mixed_stream_chunk (K2), which
// return cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "admm_common.cuh"

namespace {

using mpc_admm::clip;
using mpc_admm::panel_stride;
using mpc_admm::Prec;
using mpc_admm::slot;

constexpr int kRows = 4;          // rows a thread takes in each tile of a product
constexpr int kThreads = 512;     // the most threads a block may have
constexpr int kMaxWidth = 1024;   // the widest n, and K2's longest tail

// the products of an iteration: K2's A2' pass (A'y and A'(rho.s) of the
// tail), the first K-solve, the refinement's K product and K-solve, K2's
// A2 xt
enum Kind { kAty, kSolve0, kKprod, kSolve, kAx };

struct Layout {
  int ldn, ldm;           // row strides (doubles) in device memory: n and m - n rounded up to even
  int nslots, tslots;     // lane buffer rows: the box's, the tail's
  int panel;              // doubles of one panel
  int sn, pn;             // row stride and columns of a panel of an n-column operator (K^-1, K, A2)
  int st, pt;             // the same for A2' (m - n columns)
  int resident;           // one rho's operators whole in the panels for the chunk
  int k_at, at_at, a_at;  // resident: where K, A2' and A2 start (K^-1 at 0)
};

// one operator of a product: its rows in device memory (rows x cols at
// stride ld), its panel's row stride and columns, and where it sits when
// resident
struct Geo {
  const double* M;
  int rows, cols, ld, sp, pk, at;
};

template <bool TAIL, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
admm_stream_kernel(const double* __restrict__ kinv,  // (R, n, ldn) entries
                   const double* __restrict__ kmat,  // (R, n, ldn)
                   const double* __restrict__ a2t,   // TAIL: (n, ldm)
                   const double* __restrict__ a2,    // TAIL: (m - n, ldn)
                   const float* __restrict__ dvec,
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
  const int ms = m - n;

  // the block's lanes: one rho index's (mpc_admm::rho_block)
  const mpc_admm::RhoBlock rb = mpc_admm::rho_block(starts, R, L);
  if (rb.r == R) return;  // a spare block: every thread, before any barrier
  const int r = rb.r, seg = rb.seg, cnt = rb.cnt;
  const int off = rb.off + b;
  const bool live = off < cnt;
  const int lc = order[seg + (live ? off : cnt - 1)];

  const bool refine = refine_steps > 0;
  double* pan = smem;                            // two panels
  double* vbuf = pan + 2 * lay.panel;            // box rows: two buffers
  double* tbuf = vbuf + 2 * lay.nslots * L;      // K2's tail rows: y, then rho.s
  double* tbuf1 = tbuf + lay.tslots * L;
  float* rhs_f = reinterpret_cast<float*>(tbuf + 2 * lay.tslots * L);  // when refining
  float* xt_f = rhs_f + n * L;
  const float* rho_r = rho_vecs + r * m;
  const float* rhoi_r = rho_invs + r * m;
  const double* ki_r = kinv + r * n * lay.ldn;
  const double* k_r = kmat + r * n * lay.ldn;
  // the state: a live lane's in the outputs, its working copy; a lane
  // past its rho's count reads its stand-in's inputs and writes nothing
  const float* xs = live ? x_out : x_in;
  const float* ss = live ? s_out : s_in;
  const float* ys = live ? y_out : y_in;
  const float* axs = live ? ax_out : ax_in;
  const float beta = 1.0f - alpha;
  const int ps = 2 * L;  // doubles between a lane's row pairs

  // the working copy of the state and the first product's vectors: K1's
  // rhs, K2's tail of y and rho.s
  for (int i = t; i < n; i += G) {
    const int g = i * B + lc;
    const float x = x_in[g], s = s_in[g], y = y_in[g];
    if (live) {
      x_out[g] = x;
      s_out[g] = s;
      y_out[g] = y;
      ax_out[g] = ax_in[g];
    }
    if constexpr (!TAIL) {
      const float d = dvec[i];
      const float rhs = sigma * x - q[g] - d * y + d * (rho_r[i] * s);
      if (refine) rhs_f[i * L + b] = rhs;
      P::store(vbuf + slot(i, L, b), P::entry(rhs));
    }
  }
  if constexpr (TAIL) {
    for (int j = t; j < ms; j += G) {
      const int g = (n + j) * B + lc;
      const float s = s_in[g], y = y_in[g];
      if (live) {
        s_out[g] = s;
        y_out[g] = y;
        ax_out[g] = ax_in[g];
      }
      P::store(tbuf + slot(j, L, b), P::entry(y));
      P::store(tbuf1 + slot(j, L, b), P::entry(rho_r[n + j] * s));
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
  auto geo = [&](Kind kind) {
    if (TAIL && kind == kAty) return Geo{a2t, n, ms, lay.ldm, lay.st, lay.pt, lay.at_at};
    if (TAIL && kind == kAx) return Geo{a2, ms, n, lay.ldn, lay.sn, lay.pn, lay.a_at};
    if (kind == kKprod) return Geo{k_r, n, n, lay.ldn, lay.sn, lay.pn, lay.k_at};
    return Geo{ki_r, n, n, lay.ldn, lay.sn, lay.pn, 0};
  };
  // start copying `rows` rows of `cols` columns into shared memory
  auto copy_rows = [&](double* dst, int sp, const double* src, int ld, int rows, int cols) {
    mpc_admm::copy_rows(dst, sp, src, ld, rows, cols, tid, nthreads);
  };
  // start copying the panel of phase ph, tile `tile`, columns panel cp
  auto issue = [&](int ph, int tile, int cp, double* dst) {
    const Geo g = geo(kind_of(ph));
    const int r0 = tile * H;
    const int c0 = cp * g.pk;
    copy_rows(dst, g.sp, g.M + r0 * g.ld + c0, g.ld, min(H, g.rows - r0), min(g.pk, g.cols - c0));
  };

  if (lay.resident) {  // one rho's operators, once a chunk
    copy_rows(pan, lay.sn, ki_r, lay.ldn, n, n);
    if (refine) copy_rows(pan + lay.k_at, lay.sn, k_r, lay.ldn, n, n);
    if constexpr (TAIL) {
      copy_rows(pan + lay.at_at, lay.st, a2t, lay.ldm, n, ms);
      copy_rows(pan + lay.a_at, lay.sn, a2, lay.ldn, ms, n);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else if (chunk > 0) {
    issue(0, 0, 0, pan);
    __pipeline_commit();
  }

  int buf = 0;  // the panel being read (streamed)
  int cur = 0;  // the box buffer that holds the next solve's input
  for (int it = 0; it < chunk; ++it) {
    for (int ph = 0; ph < phases; ++ph) {
      const Kind kind = kind_of(ph);
      const Geo g = geo(kind);
      const bool two = TAIL && kind == kAty;  // A'y and A'(rho.s) in one pass
      const bool solve = kind == kSolve0 || kind == kKprod || kind == kSolve;
      const int nt = (g.rows + H - 1) / H;
      const int np = lay.resident ? 1 : (g.cols + g.pk - 1) / g.pk;
      // a solve reads one box buffer and writes the other; the A2' pass
      // reads the tail buffers and writes the box buffer the first solve
      // reads; A2 xt reads the last solve's xt and writes the tail buffers
      const double* vin = vbuf + cur * lay.nslots * L + 2 * b;
      double* vout = two ? vbuf + cur * lay.nslots * L
                         : solve ? vbuf + (cur ^ 1) * lay.nslots * L : tbuf;
      for (int tile = 0; tile < nt; ++tile) {
        const int r0 = tile * H;
        const int nr = min(H, g.rows - r0);
        int roff[kRows];  // a padded row reads the tile's last one
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int rl = t + k * G;
          roff[k] = (rl < nr ? rl : nr - 1) * g.sp;
        }
        typename P::Acc acc[2 * kRows];  // the second half: A'(rho.s)
#pragma unroll
        for (int k = 0; k < 2 * kRows; ++k) P::zero(acc[k]);
        for (int cp = 0; cp < np; ++cp) {
          const double* pn;
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
          } else {
            if (tile == 0) __syncthreads();  // the phase's input buffers are complete
            pn = pan + g.at + r0 * g.sp;
          }
          const int c0 = cp * g.pk;
          const int c1 = min(g.cols, c0 + g.pk);
          int j = c0;
          if (two) {
            const double* y_b = tbuf + 2 * b;
            const double* w_b = tbuf1 + 2 * b;
#pragma unroll 2
            for (; j + 1 < c1; j += 2) {
              Entry y0, y1, w0, w1;
              P::load2(y_b + (j >> 1) * ps, y0, y1);
              P::load2(w_b + (j >> 1) * ps, w0, w1);
#pragma unroll
              for (int k = 0; k < kRows; ++k) {
                Entry a0, a1;
                P::load2(pn + roff[k] + (j - c0), a0, a1);
                P::mac(acc[k], a0, y0);
                P::mac(acc[kRows + k], a0, w0);
                P::mac(acc[k], a1, y1);
                P::mac(acc[kRows + k], a1, w1);
              }
            }
            if (j < c1) {
              const Entry yj = P::load(y_b + (j >> 1) * ps);
              const Entry wj = P::load(w_b + (j >> 1) * ps);
#pragma unroll
              for (int k = 0; k < kRows; ++k) {
                const Entry a0 = P::load(pn + roff[k] + (j - c0));
                P::mac(acc[k], a0, yj);
                P::mac(acc[kRows + k], a0, wj);
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
          const int sl = slot(i, L, b);
          if (TAIL && kind == kAty) {
            const int gi = i * B + lc;
            const float d = dvec[i];
            const float aty = d * ys[gi] + res;
            const float w = d * (rho_r[i] * ss[gi]) + P::result(acc[kRows + k]);
            const float rhs = sigma * xs[gi] - q[gi] - aty + w;
            if (refine) rhs_f[i * L + b] = rhs;
            P::store(vout + sl, P::entry(rhs));
          } else if (TAIL && kind == kAx) {  // tail row i, st = A2 xt
            const int gi = (n + i) * B + lc;
            const float s0 = ss[gi], y0 = ys[gi];
            const float v = alpha * res + beta * s0;
            const float s_new = clip(v + rhoi_r[n + i] * y0, l[gi], u[gi]);
            const float y_new = y0 + rho_r[n + i] * (v - s_new);
            const float ax_new = alpha * res + beta * axs[gi];
            if (live) {
              s_out[gi] = s_new;
              y_out[gi] = y_new;
              ax_out[gi] = ax_new;
            }
            if (it + 1 < chunk) {
              P::store(tbuf + sl, P::entry(y_new));
              P::store(tbuf1 + sl, P::entry(rho_r[n + i] * s_new));
            }
          } else if (kind == kKprod) {  // the refinement's residual
            P::store(vout + sl, P::entry(rhs_f[i * L + b] - res));
          } else {
            const float xt = kind == kSolve0 ? res : xt_f[i * L + b] + res;
            if (ph != last_solve) {
              xt_f[i * L + b] = xt;
              P::store(vout + sl, P::entry(xt));
              continue;
            }
            // the update of box row i
            const int gi = i * B + lc;
            const float d = dvec[i];
            const float rho = rho_r[i];
            const float st = d * xt;
            const float s0 = ss[gi], y0 = ys[gi];
            const float v = alpha * st + beta * s0;
            const float s_new = clip(v + rhoi_r[i] * y0, l[gi], u[gi]);
            const float x_new = alpha * xt + beta * xs[gi];
            const float y_new = y0 + rho * (v - s_new);
            const float ax_new = alpha * st + beta * axs[gi];
            if (live) {
              x_out[gi] = x_new;
              s_out[gi] = s_new;
              y_out[gi] = y_new;
              ax_out[gi] = ax_new;
            }
            if constexpr (TAIL) {
              P::store(vout + sl, P::entry(xt));  // for A2 xt
            } else if (it + 1 < chunk) {  // the next iteration's rhs
              const float rhs = sigma * x_new - q[gi] - d * y_new + d * (rho * s_new);
              if (refine) rhs_f[i * L + b] = rhs;
              P::store(vout + sl, P::entry(rhs));
            }
          }
        }
      }
      if (solve) cur ^= 1;
    }
  }
}

struct Args {
  const double *kinv, *kmat, *a2t, *a2;
  const float *dvec, *rho_vecs, *rho_invs, *q, *l, *u;
  const int *order, *starts;
  const float *x_in, *s_in, *y_in, *ax_in;
  float *x_out, *s_out, *y_out, *ax_out;
  int n, m, B, R, chunk, refine_steps;
  float sigma, alpha;
};

template <bool TAIL, int MODE>
cudaError_t launch(const Args& a, int lanes, int groups, const Layout& lay, size_t smem,
                   cudaStream_t stream) {
  auto kernel = admm_stream_kernel<TAIL, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + lanes - 1) / lanes + a.R);
  const dim3 block(lanes, groups);
  kernel<<<grid, block, smem, stream>>>(
      a.kinv, a.kmat, a.a2t, a.a2, a.dvec, a.rho_vecs, a.rho_invs, a.q, a.l, a.u,
      a.order, a.starts, a.x_in, a.s_in, a.y_in, a.ax_in, a.x_out, a.s_out, a.y_out,
      a.ax_out, a.n, a.m, a.B, a.R, a.chunk, a.refine_steps, a.sigma, a.alpha, lay);
  return cudaGetLastError();
}

// The layout of a launch of `groups` row-groups and panels of `panel`
// doubles; false if a panel holds fewer than 2 columns of a tile.
// ops/admm_fused.k12_stream_layout mirrors it.
bool make_layout(int n, int ms, bool refine, int groups, int panel, Layout& lay) {
  const int H = kRows * groups;
  lay.ldn = n + (n & 1);
  lay.ldm = ms + (ms & 1);
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
  lay.sn = panel_stride(panel, H, lay.ldn);
  lay.pn = lay.sn < lay.ldn ? lay.sn : lay.ldn;
  lay.st = ms > 0 ? panel_stride(panel, H, lay.ldm) : 0;
  lay.pt = lay.st < lay.ldm ? lay.st : lay.ldm;
  return lay.sn > 0 && (ms == 0 || lay.st > 0);
}

// The entry of K1 (TAIL false) or K2: the checks, the layout, its bytes,
// the precision's instantiation.
template <bool TAIL>
int stream_chunk(const Args& a, int mode, int lanes, int groups, int panel, int smem_bytes,
                 void* stream) {
  const int n = a.n, ms = a.m - a.n;
  if (n <= 0 || n > kMaxWidth || (TAIL ? ms < 1 || ms > kMaxWidth : ms != 0) || a.B <= 0 ||
      a.R <= 0 || a.chunk < 0 || a.refine_steps < 0 ||
      static_cast<long long>(a.m) * a.B > INT_MAX ||
      (lanes != 4 && lanes != 8 && lanes != 16 && lanes != 32) || groups <= 0 ||
      lanes * groups > kThreads || panel <= 0 || panel % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout lay;
  if (!make_layout(n, ms, a.refine_steps > 0, groups, panel, lay))
    return static_cast<int>(cudaErrorInvalidValue);
  // the bytes of the layout (ops/admm_fused.k12_stream_smem_bytes mirrors
  // these two lines, which tests/test_torch_build.py reads)
  const long long stream_doubles = 2LL * panel + 2LL * (lay.nslots + lay.tslots) * lanes;
  const long long stream_need = 8 * stream_doubles + (a.refine_steps > 0 ? 8LL * n * lanes : 0);
  if (stream_need != smem_bytes || stream_need > static_cast<long long>(mpc_admm::kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(stream_need);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case mpc_admm::kHighest:
      return static_cast<int>(launch<TAIL, mpc_admm::kHighest>(a, lanes, groups, lay, smem, st));
    case mpc_admm::kBf16x3:
      return static_cast<int>(launch<TAIL, mpc_admm::kBf16x3>(a, lanes, groups, lay, smem, st));
    case mpc_admm::kDefault:
      return static_cast<int>(launch<TAIL, mpc_admm::kDefault>(a, lanes, groups, lay, smem, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// K1 on the stream route: launch `chunk` iterations on `stream` at
// precision `mode` (0 "highest", 1 "bf16x3", 2 "default";
// ops/admm_fused.PRECISIONS). kinv, kmat (R, n, ldn) are K^-1 and K (row i
// holds row i), as the precision's 8-byte entries (fp64 at "highest", the
// fp32 pair (hi, lo) at "bf16x3", (hi, 0) at "default":
// ops/admm_fused.operator_entries) with rows padded to ldn = n rounded up
// to even (kmat unused when refine_steps == 0); the other arrays float32
// and contiguous on one device: dvec (n), rho_vecs, rho_invs (R, n), q, l,
// u, x_in, s_in, y_in, ax_in and the outputs (n, B); order (B), the lanes
// sorted by rho index (stable), and starts (R + 1), where each index's
// lanes start in that order (admm_fused.rho_order). Takes n <= 1024 and
// n B < 2^31. The layout comes from ops/admm_fused.k1_plan: lanes (4, 8,
// 16 or 32) and groups per block (at most 512 threads), the doubles of one
// operator panel (panel) and the dynamic shared memory they take, which
// must equal what the kernel's layout needs. Returns the cudaError_t of
// the launch (0 on success).
int admm_diag_stream_chunk(const double* kinv, const double* kmat, const float* dvec,
                           const float* rho_vecs, const float* rho_invs, const float* q,
                           const float* l, const float* u, const int* order, const int* starts,
                           const float* x_in, const float* s_in, const float* y_in,
                           const float* ax_in, float* x_out, float* s_out, float* y_out,
                           float* ax_out, int n, int B, int R, int chunk, int refine_steps,
                           int mode, int lanes, int groups, int panel, int smem_bytes,
                           float sigma, float alpha, void* stream) {
  const Args a{kinv, kmat, nullptr, nullptr, dvec, rho_vecs, rho_invs, q, l, u, order, starts,
               x_in, s_in, y_in, ax_in, x_out, s_out, y_out, ax_out,
               n, n, B, R, chunk, refine_steps, sigma, alpha};
  return stream_chunk<false>(a, mode, lanes, groups, panel, smem_bytes, stream);
}

// K2 on the stream route: as admm_diag_stream_chunk, with the dense tail
// A2 (m - n, n) as a2t (n, ldm), its transpose with rows padded to ldm =
// m - n rounded up to even, and a2 (m - n, ldn), both as the precision's
// entries; dvec (n) is the box's diagonal, rho_vecs, rho_invs (R, m), l,
// u, s, y, ax (m, B). Takes n <= 1024, 1 <= m - n <= 1024 and m B < 2^31;
// the layout from ops/admm_fused.k2_plan.
int admm_mixed_stream_chunk(const double* kinv, const double* kmat, const double* a2t,
                            const double* a2, const float* dvec, const float* rho_vecs,
                            const float* rho_invs, const float* q, const float* l,
                            const float* u, const int* order, const int* starts,
                            const float* x_in, const float* s_in, const float* y_in,
                            const float* ax_in, float* x_out, float* s_out, float* y_out,
                            float* ax_out, int n, int m, int B, int R, int chunk,
                            int refine_steps, int mode, int lanes, int groups, int panel,
                            int smem_bytes, float sigma, float alpha, void* stream) {
  const Args a{kinv, kmat, a2t, a2, dvec, rho_vecs, rho_invs, q, l, u, order, starts,
               x_in, s_in, y_in, ax_in, x_out, s_out, y_out, ax_out,
               n, m, B, R, chunk, refine_steps, sigma, alpha};
  return stream_chunk<true>(a, mode, lanes, groups, panel, smem_bytes, stream);
}

}  // extern "C"
