// K3W's doubling form on Hopper: `chunk` Riccati-ADMM iterations of the
// per-lane engine for a plant of any width with the sweeps in doubling
// form. (K3W's sequential form is riccati_wide_seq.cu; the drivers' wide
// rollout and certificate riccati_wide_rec.cu.)
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
// What bounds the doubling form on this card: the fp64 multiply-adds of
// its levels (each reads one nx x nx matrix a horizon step, ~ceil(log2 N) N
// nx^2 a sweep) and the fp32 -> fp64 widening of their operands (16 a clock
// an SM against 64 multiply-adds), in 2 ceil(log2 N) + ~6 dependent phases
// an iteration instead of the sequential form's 2N steps.
//
// Design:
// - A block takes `lanes` lanes of the launch's one rho (1-32), so one
//   read of a level serves them all. Every operator the iteration streams
//   (K, the backward levels and prefix products, G, the forward levels and
//   prefix products, K again) is one contiguous range at rho r, copied in
//   panels of whole horizon steps into a ring of `ring` slots of `panel`
//   floats in shared memory, `ring` - 1 panels ahead of the one the block
//   computes (no level depends on the lanes' state), every thread copying
//   its share by 4-byte cp.async, each step at an odd stride; or, without a
//   ring (ring = 0), read where they lie, through L1/L2. The plan takes the
//   ring-less layout at the QTP's width, (4, 2), a compile-time
//   instantiation whose rows are float4 reads, and wherever one rho's
//   operators of an iteration fit L1: on the card it beat the ring there,
//   of 4-byte copies and of bulk copies (TMA) alike, whose launching stalled
//   a warp ~0.8-2k clocks a panel (scripts/k3w_dbl_phase_probe.py).
// - A thread takes a register tile of 4 rows x LT lanes (LT = 1, 2, 4 or 8,
//   a template parameter) of one horizon step: each operator entry is
//   widened once for its LT lanes, each lane entry once for the 4 rows.
//   The threads of a warp take neighbouring steps.
// - The lanes' horizon buffers (the two levels' double buffer, ff, the
//   terminal linear term, e0) lie [step][row][lane], a step padded so that
//   neighbouring steps start in other banks; a thread's lanes are one or
//   two 16-byte loads. They sit in shared memory (routes 0, 1) or, where a
//   block's do not fit, in a device scratch (route 2). The lanes' state
//   (vU, lamU and the split rows of vX, lamX) sits in shared memory (route
//   0) or in the outputs themselves, lane-last (routes 1, 2). The host's
//   plan (ops/riccati_fused.k3w_plan) picks the lanes, the tile, the
//   threads, the ring and the route; dbl_layout places them, and the entry
//   refuses shared-memory bytes that differ from it.
// - s_k = B' g_{k+1} + lu_k and ffs_k = G_k s_k are one phase where a
//   thread's 4 rows hold all nu rows (s in registers), else two (s in its
//   own buffer). lu_k is formed from vU, lamU where it is used. A tile
//   loads every state row it needs before it stores any (in device memory
//   each load is an L2 round trip), LT lanes at a time; the interior X
//   rows are projected by the u phase's items of their step.
// - Barriers: one a panel (the ring's) and one before each phase without
//   an operator (s, B ffs, the terminal row); no thread returns early;
//   lanes past the batch compute on zeros and are never stored.
//
// Precision: the state is fp32; each product of length nx or nu sums exact
// fp32 products in fp64 in column order and is rounded once to fp32; each
// level's add is fp32, b[k] + dot(...); the elementwise steps are fp32 in
// the plain version's order. Built with --fmad=false, the kernel agrees
// with its plain version bit for bit (ops/riccati_fused.py:
// iterate_chunk_riccati_doubling_plain, whose summation order the kernel
// follows).
//
// Bound to PyTorch by ctypes through plain C functions that return
// cudaGetLastError() after the launch (0 on success).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr size_t kSmemLimit = 232448;
// the doubling form: the most threads of a block (k3w_dbl_max_threads: 256
// where a thread takes 8 lanes, whose tile needs more than 128 registers),
// the rows of a thread's tile, the lanes a block may take
__host__ __device__ constexpr int dbl_max_threads(int lt) { return lt == 8 ? 256 : 512; }
constexpr int kRt = 4;
constexpr int kDblMaxLanes = 32;

__host__ __device__ inline size_t pad4(size_t n) { return (n + 3) / 4 * 4; }

// jnp.clip / torch.clamp semantics: a NaN passes through
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// max that propagates NaN, as torch.amax does
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The split rows of X: N when the interior is split, the terminal row alone
// when only it is, none otherwise.
__host__ __device__ inline int wide_split_x_rows(int N, int si, int st, int ball) {
  return si ? N : ((st || ball) ? 1 : 0);
}

// The stride of one horizon step of a [step][row][lane] buffer: rows x
// lanes floats, padded so that stride / unit is odd (unit = the floats of
// a thread's lane load, at most 4): the threads of a warp, on neighbouring
// steps, then load from distinct banks.
__host__ __device__ inline size_t dbl_stride(size_t rows, size_t lanes, int lt) {
  const size_t unit = lt < 4 ? static_cast<size_t>(lt) : 4;
  const size_t s = rows * lanes;
  return (s / unit) % 2 == 0 ? s + unit : s;
}

// Where each region of a doubling block lies, in floats. The work area
// (from its own base): the two horizon buffers (N steps of stride ks), ff
// and, where nu > kRt, s (N steps of stride ku), the terminal linear term
// and e0 ([row][lane]), the ball's scale (a lane each). Shared memory (from
// its base): the ring, the plant's B, the work area (routes 0, 1) and the
// lanes' state (route 0: vU, lamU, then the split rows of vX, lamX, each
// [row][lane]). ops/riccati_fused.k3w_dbl_floats mirrors it.
struct DblLayout {
  size_t ks, ku, ha, hb, ff, s, y, e0, sc, work;
  size_t ring, plant, wbase, state, total;
};

__host__ __device__ inline DblLayout dbl_layout(int N, int nx, int nu, int xrows, int lanes,
                                                int lt, int ring, int panel, int route) {
  DblLayout d;
  const size_t n = N, x = nx, u = nu, l = lanes;
  d.ks = dbl_stride(x, l, lt);
  d.ku = dbl_stride(u, l, lt);
  size_t o = 0;
  d.ha = o, o += n * d.ks;
  d.hb = o, o += n * d.ks;
  d.ff = o, o += n * d.ku;
  d.s = o, o += nu > kRt ? n * d.ku : 0;
  d.y = o, o += x * l;
  d.e0 = o, o += x * l;
  d.sc = o, o += l;
  d.work = pad4(o);
  o = 0;
  d.ring = o, o += static_cast<size_t>(ring) * panel;
  d.plant = o, o += pad4(x * u);
  d.wbase = o, o += route < 2 ? d.work : 0;
  d.state = o;
  if (route == 0) o += (2 * n * u + 2 * static_cast<size_t>(xrows) * x) * l;
  d.total = o;
  return d;
}

// The kernel's compile-time instantiation of the QTP's width, (nx, nu) =
// (4, 2) (ops/riccati_fused.K3W_DBL_TIER): the loops over a step's rows and
// columns unrolled, and without a ring a step's rows read as float4.
__host__ __device__ inline bool dbl_qtp(int nx, int nu) { return nx == 4 && nu == 2; }

struct WideArgs {
  const float *Kf, *Gf, *Bm, *bwdL, *bwdF, *fwdL, *fwdF;
  const float *xlo, *xhi, *xNlo, *xNhi, *ulo, *uhi, *rho_tab;
  const int* ridx;
  const float *e0, *ballr, *vX_in, *vU_in, *lamX_in, *lamU_in;
  float *X, *U, *vX, *vU, *lamX, *lamU, *scratch;
  int N, nx, nu, B, R, L, chunk, si, st, ball, lanes, ring, panel, route;
  DblLayout lay;
};

// One operator stream of an iteration: step k's matrix of m floats at src +
// k m, for k0 <= k < k0 + n; mp its stride in a ring slot: odd, so that the
// threads of a warp, each on its own step, read distinct banks (m without
// a ring, where the blocks read the stream where it lies).
struct Seg {
  const float* src;
  int m, mp, k0, n;
};

// The iteration's streams in the order the block uses them: K (the sweep's
// K' lu), the lv backward levels, the backward prefix products, G, the lv
// forward levels and prefix products, K (the rollout's K e); lv levels run
// (ceil(log2 N), none at N = 1); at rho r. A ring-less block (ring 0)
// reads a stream where it lies, at stride m.
__device__ __forceinline__ Seg dbl_seg(const WideArgs& p, int st, int lv, int r, int nx,
                                       int nu) {
  const int N = p.N, mm = nx * nx;
  const size_t lvl = static_cast<size_t>(r) * p.L * N * mm, full = static_cast<size_t>(r) * N * mm;
  Seg s;
  s.k0 = 0, s.n = N, s.m = mm;
  if (st == 0 || st == 2 * lv + 4) {
    s.src = p.Kf + static_cast<size_t>(r) * N * nu * nx, s.m = nu * nx;
  } else if (st <= lv) {
    s.k0 = 1 << (st - 1), s.n = N - s.k0;
    s.src = p.bwdL + lvl + static_cast<size_t>(st - 1) * N * mm;
  } else if (st == lv + 1) {
    s.src = p.bwdF + full;
  } else if (st == lv + 2) {
    s.src = p.Gf + static_cast<size_t>(r) * N * nu * nu, s.m = nu * nu;
  } else if (st <= 2 * lv + 2) {
    const int l = st - lv - 3;
    s.k0 = 1 << l, s.n = N - s.k0, s.src = p.fwdL + lvl + static_cast<size_t>(l) * N * mm;
  } else {
    s.src = p.fwdF + full;
  }
  s.mp = p.ring ? s.m | 1 : s.m;
  return s;
}

// Start the copies of panel p (P steps a panel) of stream s into a ring
// slot, each step at stride s.mp: this thread's share, 4 bytes a copy.
__device__ __forceinline__ void dbl_fill(float* dst, const Seg& s, int p, int P, int tid, int T) {
  const int ka = s.k0 + p * P;
  const int total = min(P, s.k0 + s.n - ka) * s.m;
  const float* src = s.src + static_cast<size_t>(ka) * s.m;
  int k = tid / s.m, w = tid - k * s.m;
  const int qT = T / s.m, rT = T - qT * s.m;
  for (int e = tid; e < total; e += T) {
    __pipeline_memcpy_async(dst + k * s.mp + w, src + e, 4);
    k += qT, w += rT;
    if (w >= s.m) w -= s.m, ++k;
  }
}

// LT lanes from p (16-byte aligned where LT >= 4, 8-byte where LT == 2)
template <int LT>
__device__ __forceinline__ void load_lanes(const float* p, float (&v)[LT]) {
  if constexpr (LT == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else if constexpr (LT == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else if constexpr (LT == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x, v[1] = a.y;
  } else {
    v[0] = p[0];
  }
}

template <int LT>
__device__ __forceinline__ void store_lanes(float* p, const float (&v)[LT]) {
  if constexpr (LT == 8) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else if constexpr (LT == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (LT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// acc[r][l] = m[r] v[l] (first) or fma(m[r], v[l], acc[r][l]): one column
// of a tile's products, each entry widened once.
template <int LT>
__device__ __forceinline__ void tile_col(double (&acc)[kRt][LT], const float (&m)[kRt],
                                         const float (&v)[LT], bool first) {
  double vd[LT];
#pragma unroll
  for (int l = 0; l < LT; ++l) vd[l] = static_cast<double>(v[l]);
#pragma unroll
  for (int r = 0; r < kRt; ++r) {
    const double md = static_cast<double>(m[r]);
#pragma unroll
    for (int l = 0; l < LT; ++l) acc[r][l] = first ? md * vd[l] : fma(md, vd[l], acc[r][l]);
  }
}

// acc[r][l] = sum_{j < n} M[ro[r] + j mj] v_j[l] (n >= 1), v_j the LT lanes
// that src(j, v) loads: exact fp32 products summed in fp64 in column order.
template <int LT, typename Src>
__device__ __forceinline__ void tile_dot(double (&acc)[kRt][LT], const float* M,
                                         const int (&ro)[kRt], int mj, int n, Src src) {
  float m[kRt], v[LT];
#pragma unroll
  for (int r = 0; r < kRt; ++r) m[r] = M[ro[r]];
  src(0, v);
  tile_col<LT>(acc, m, v, true);
#pragma unroll 2
  for (int j = 1; j < n; ++j) {
#pragma unroll
    for (int r = 0; r < kRt; ++r) m[r] = M[ro[r] + j * mj];
    src(j, v);
    tile_col<LT>(acc, m, v, false);
  }
}

// The components of a float4
__device__ __forceinline__ void split4(const float4& f, float (&c)[4]) {
  c[0] = f.x, c[1] = f.y, c[2] = f.z, c[3] = f.w;
}

// tile_dot of the 4 rows of a step's 4 x 4 matrix at M (16-byte aligned,
// row-major, mj = 1): the rows read as float4; the sums are tile_dot's.
template <int LT, typename Src>
__device__ __forceinline__ void step4_dot(double (&acc)[kRt][LT], const float* M, Src src) {
  float4 q[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) q[r] = *reinterpret_cast<const float4*>(M + 4 * r);
  float rows[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) split4(q[r], rows[r]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float m[kRt], v[LT];
#pragma unroll
    for (int r = 0; r < kRt; ++r) m[r] = rows[r][j];
    src(j, v);
    tile_col<LT>(acc, m, v, j == 0);
  }
}

// The row offsets of a tile's kRt rows from row i0 (rows past nr repeat
// the last one: computed, never stored), rows mr floats apart.
__device__ __forceinline__ void tile_rows(int (&ro)[kRt], int i0, int nr, int mr) {
#pragma unroll
  for (int r = 0; r < kRt; ++r) ro[r] = min(i0 + r, nr - 1) * mr;
}

// NX, NU: the plant's width at compile time (the QTP's (4, 2)), or 0 (a
// runtime width)
template <int LT, int NX, int NU>
__global__ void __launch_bounds__(dbl_max_threads(LT)) riccati_wide_kernel(const WideArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, T = blockDim.x;
  const int nx = NX ? NX : p.nx, nu = NU ? NU : p.nu;
  const int N = p.N, R = p.R, LB = p.lanes, LG = LB / LT;
  const int b0 = blockIdx.x * LB;
  const int nact = min(LB, p.B - b0);  // the block's lanes in the batch
  const ptrdiff_t B = p.B;
  const int xrows = wide_split_x_rows(N, p.si, p.st, p.ball);
  const int xoff = N + 1 - xrows;  // the first split row
  // a step's rows as float4: the QTP's width, read where the streams lie
  const bool rows4 = NX == 4 && !p.ring;
  const DblLayout& lay = p.lay;
  const size_t ks = lay.ks, ku = lay.ku;

  // the work area: in shared memory, or the block's part of the scratch
  float* work = p.route == 2 ? p.scratch + static_cast<size_t>(blockIdx.x) * lay.work
                             : smem + lay.wbase;
  float* HA = work + lay.ha;
  float* HB = work + lay.hb;
  float* FF = work + lay.ff;
  float* S = work + lay.s;
  float* Y = work + lay.y;    // lin_xN [nx][LB]
  float* E0 = work + lay.e0;  // e0 [nx][LB]
  float* SC = work + lay.sc;  // the ball's scale [LB]
  float* ring = smem + lay.ring;
  float* Bs = smem + lay.plant;  // B (nx, nu)

  const int r = p.ridx[0];
  const float rho = p.rho_tab[r], rho_inv = p.rho_tab[R + r];
  const float rho_t = p.rho_tab[2 * R + r], rho_t_inv = p.rho_tab[3 * R + r];
  int lv = 0;  // the combine levels a sweep runs
  while ((1 << lv) < N) ++lv;
  const int NS = 2 * lv + 5;

  // the lanes' state, entry (row, lane) at base[row ls + lane]: vU, lamU
  // (N nu rows), the split rows of vX, lamX (row k at (k - xoff) nx)
  float *vU, *lamU, *vX = nullptr, *lamX = nullptr;
  ptrdiff_t ls;
  if (p.route == 0) {
    ls = LB;
    vU = smem + lay.state;
    lamU = vU + static_cast<size_t>(N) * nu * LB;
    vX = lamU + static_cast<size_t>(N) * nu * LB;
    lamX = vX + static_cast<size_t>(xrows) * nx * LB;
  } else {  // in place in the outputs
    ls = B;
    vU = p.vU + b0, lamU = p.lamU + b0;
    if (xrows) {
      vX = p.vX + static_cast<ptrdiff_t>(xoff) * nx * B + b0;
      lamX = p.lamX + static_cast<ptrdiff_t>(xoff) * nx * B + b0;
    }
  }
  // the LT lanes from l0 of a row of the state (row stride ls) or of a
  // lane-last output (row stride B): vector accesses where the row stride
  // keeps them aligned and every lane is in the batch; lanes past the batch
  // read zeros and are never stored
  const int unit = LT < 4 ? LT : 4;
  const auto get = [&](const float* s, ptrdiff_t stride, ptrdiff_t row, int l0, float (&v)[LT]) {
    const float* q = s + row * stride + l0;
    if (stride % unit == 0 && l0 + LT <= nact) {
      load_lanes<LT>(q, v);
    } else {
#pragma unroll
      for (int c = 0; c < LT; ++c) v[c] = l0 + c < nact ? q[c] : 0.0f;
    }
  };
  const auto put = [&](float* s, ptrdiff_t stride, ptrdiff_t row, int l0, const float (&v)[LT]) {
    float* q = s + row * stride + l0;
    if (stride % unit == 0 && l0 + LT <= nact) {
      store_lanes<LT>(q, v);
    } else {
#pragma unroll
      for (int c = 0; c < LT; ++c)
        if (l0 + c < nact) q[c] = v[c];
    }
  };
  const auto ld = [&](const float* s, ptrdiff_t row, int l) {
    return l < nact ? s[row * ls + l] : 0.0f;
  };
  const auto put_state = [&](float* s, ptrdiff_t row, int l, float v) {
    if (l < nact) s[row * ls + l] = v;
  };
  const auto in = [&](const float* a, ptrdiff_t row, int l) {
    return l < nact ? a[row * B + b0 + l] : 0.0f;
  };
  // lu_k's row j of the LT lanes from l0: -rho vU + lamU
  const auto lu = [&](int k, int j, int l0, float (&v)[LT]) {
    float a[LT];
    const ptrdiff_t row = static_cast<ptrdiff_t>(k) * nu + j;
    get(vU, ls, row, l0, a);
    get(lamU, ls, row, l0, v);
#pragma unroll
    for (int q = 0; q < LT; ++q) v[q] = -rho * a[q] + v[q];
  };
  // the items of a product over nk steps and nr rows, (step, 4 rows, LT
  // lanes), steps fastest: body(step offset, first row, first lane)
  const auto items = [&](int nk, int nr, auto&& body) {
    const int RG = (nr + kRt - 1) / kRt;
    const int n = nk * RG * LG;
    for (int q = tid; q < n; q += T) {
      const int rest = n == nk ? 0 : q / nk;
      body(q - rest * nk, (rest % RG) * kRt, (rest / RG) * LT);
    }
  };

  // ---- the plant, the lanes' state and inputs (lane-last: entry (row, i)
  // at (row n + i) B + b) ----
  for (int i = tid; i < nx * nu; i += T) Bs[i] = p.Bm[i];
  for (int e = tid; e < N * nu * LB; e += T) {
    const int row = e / LB, l = e - row * LB;
    put_state(vU, row, l, in(p.vU_in, row, l));
    put_state(lamU, row, l, in(p.lamU_in, row, l));
  }
  for (int e = tid; e < xrows * nx * LB; e += T) {
    const int row = e / LB, l = e - row * LB;
    const ptrdiff_t a = static_cast<ptrdiff_t>(xoff) * nx + row;
    put_state(vX, row, l, in(p.vX_in, a, l));
    put_state(lamX, row, l, in(p.lamX_in, a, l));
  }
  for (int e = tid; e < nx * LB; e += T) {
    const int i = e / LB, l = e - i * LB;
    E0[e] = in(p.e0, i, l);
    const ptrdiff_t a = static_cast<ptrdiff_t>(N) * nx + i;
    Y[e] = p.st ? -rho_t * in(p.vX_in, a, l) + in(p.lamX_in, a, l) : 0.0f;
  }

  // the ring: panels are taken from its slots in turn and filled ring - 1
  // panels ahead (fill: the next fill's slot, stream, panel and iteration;
  // nothing past the chunk)
  int take = 0, slot_put = 0, put_st = 0, put_p = 0, put_it = 0;
  const auto seg = [&](int st) { return dbl_seg(p, st, lv, r, nx, nu); };
  const auto fill = [&]() {
    if (!p.ring) return;  // the streams are read where they lie
    if (put_it < p.chunk) {
      const Seg s = seg(put_st);
      const int P = p.panel / s.mp;
      dbl_fill(ring + static_cast<size_t>(slot_put) * p.panel, s, put_p, P, tid, T);
      if (++put_p * P >= s.n) {
        put_p = 0;
        if (++put_st == NS) put_st = 0, ++put_it;
      }
    }
    __pipeline_commit();
    slot_put = slot_put + 1 == p.ring ? 0 : slot_put + 1;
  };
  for (int q = 0; q + 1 < p.ring; ++q) fill();
  // wait for the next panel's copies, make them every thread's, refill the
  // slot the block finished with; the panel's slot
  const auto next = [&]() -> const float* {
    if (!p.ring) {
      __syncthreads();
      return nullptr;
    }
    if (p.ring == 3)
      __pipeline_wait_prior(1);
    else
      __pipeline_wait_prior(0);
    __syncthreads();
    fill();
    const float* slot = ring + static_cast<size_t>(take) * p.panel;
    take = take + 1 == p.ring ? 0 : take + 1;
    return slot;
  };
  // every panel of stream st: body(its first step's matrix, mp, first
  // step, steps, first panel); without a ring, the whole stream where it
  // lies
  const auto panels = [&](int st, auto&& body) {
    const Seg s = seg(st);
    const int P = p.ring ? p.panel / s.mp : s.n;
    for (int q = 0; q * P < s.n; ++q) {
      const int ka = s.k0 + q * P;
      const float* slot = next();
      body(slot ? slot : s.src + static_cast<size_t>(ka) * s.m, s.mp, ka,
           min(P, s.k0 + s.n - ka), q == 0);
    }
  };
  // a product of a step's nx x nx matrix at M (row-major) with nx-vectors
  // of LT lanes, rows from i0
  const auto step_dot = [&](double (&acc)[kRt][LT], const float* M, int i0, auto&& src) {
    if (rows4) {
      step4_dot<LT>(acc, M, src);
    } else {
      int ro[kRt];
      tile_rows(ro, i0, nx, nx);
      tile_dot<LT>(acc, M, ro, 1, nx, src);
    }
  };
  // the combine levels of a sweep on cur (nxt its double buffer), then cur
  // += full y; returns the buffer that holds the result
  const auto prefix = [&](int st0, float* cur, float* nxt, const float* y) {
    for (int l = 0; l < lv; ++l) {
      const int s = 1 << l;
      panels(st0 + l, [&](const float* slot, int mp, int ka, int nk, bool first) {
        if (first) {  // the settled rows k < s
          if (ks % 4 == 0) {
            for (size_t e = 4 * tid; e < static_cast<size_t>(s) * ks; e += 4 * T)
              *reinterpret_cast<float4*>(nxt + e) = *reinterpret_cast<const float4*>(cur + e);
          } else {
            for (size_t e = tid; e < static_cast<size_t>(s) * ks; e += T) nxt[e] = cur[e];
          }
        }
        items(nk, nx, [&](int kq, int i0, int l0) {
          const int k = ka + kq;
          double acc[kRt][LT];
          const float* src = cur + (k - s) * ks + l0;
          step_dot(acc, slot + kq * mp, i0,
                   [&](int j, float (&v)[LT]) { load_lanes<LT>(src + j * LB, v); });
#pragma unroll
          for (int rr = 0; rr < kRt; ++rr) {
            if (i0 + rr >= nx) break;
            const size_t o = k * ks + (i0 + rr) * LB + l0;
            float b[LT];
            load_lanes<LT>(cur + o, b);
#pragma unroll
            for (int q = 0; q < LT; ++q) b[q] = b[q] + static_cast<float>(acc[rr][q]);
            store_lanes<LT>(nxt + o, b);
          }
        });
      });
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    panels(st0 + lv, [&](const float* slot, int mp, int ka, int nk, bool) {
      items(nk, nx, [&](int kq, int i0, int l0) {
        const int k = ka + kq;
        double acc[kRt][LT];
        step_dot(acc, slot + kq * mp, i0,
                 [&](int j, float (&v)[LT]) { load_lanes<LT>(y + j * LB + l0, v); });
#pragma unroll
        for (int rr = 0; rr < kRt; ++rr) {
          if (i0 + rr >= nx) break;
          const size_t o = k * ks + (i0 + rr) * LB + l0;
          float b[LT];
          load_lanes<LT>(cur + o, b);
#pragma unroll
          for (int q = 0; q < LT; ++q) b[q] = b[q] + static_cast<float>(acc[rr][q]);
          store_lanes<LT>(cur + o, b);
        }
      });
    });
    return cur;
  };
  const auto store_rows = [&](float* base, int nr, int i0, int l0, const double (&acc)[kRt][LT],
                              bool negate) {
#pragma unroll
    for (int rr = 0; rr < kRt; ++rr) {
      if (i0 + rr >= nr) break;
      float b[LT];
#pragma unroll
      for (int q = 0; q < LT; ++q)
        b[q] = negate ? -static_cast<float>(acc[rr][q]) : static_cast<float>(acc[rr][q]);
      store_lanes<LT>(base + (i0 + rr) * LB + l0, b);
    }
  };

  float* XS = HA;
  for (int it = 0; it < p.chunk; ++it) {
    const bool last = it == p.chunk - 1;
    // ---- b_k = lpre_k - K_k' lu_k, reversed in time, into HA ----
    panels(0, [&](const float* slot, int mp, int ka, int nk, bool) {
      items(nk, nx, [&](int kq, int i0, int l0) {
        const int k = ka + kq;
        const float* Kk = slot + kq * mp;  // (nu, nx)
        double acc[kRt][LT];
        int ro[kRt];
        tile_rows(ro, i0, nx, 1);
        if (nu <= kRt) {  // every lu row first, then the products
          float u[kRt][LT];
#pragma unroll
          for (int j = 0; j < kRt; ++j)
            if (j < nu) lu(k, j, l0, u[j]);
#pragma unroll
          for (int j = 0; j < kRt; ++j) {
            if (j >= nu) break;
            float m[kRt];
            if (rows4) {  // row j of K_k: K_k[j][i] for the step's 4 rows i
              split4(*reinterpret_cast<const float4*>(Kk + 4 * j), m);
            } else {
#pragma unroll
              for (int rr = 0; rr < kRt; ++rr) m[rr] = Kk[ro[rr] + j * nx];
            }
            tile_col<LT>(acc, m, u[j], j == 0);
          }
        } else {
          tile_dot<LT>(acc, Kk, ro, nx, nu, [&](int j, float (&v)[LT]) { lu(k, j, l0, v); });
        }
        float lp[kRt][LT];  // lpre_k's rows, every load first
#pragma unroll
        for (int rr = 0; rr < kRt; ++rr) {
          if (p.si && k >= 1 && i0 + rr < nx) {
            float a[LT];
            const ptrdiff_t row = static_cast<ptrdiff_t>(k - xoff) * nx + i0 + rr;
            get(vX, ls, row, l0, a);
            get(lamX, ls, row, l0, lp[rr]);
#pragma unroll
            for (int q = 0; q < LT; ++q) lp[rr][q] = -rho * a[q] + lp[rr][q];
          } else {
#pragma unroll
            for (int q = 0; q < LT; ++q) lp[rr][q] = 0.0f;
          }
        }
#pragma unroll
        for (int rr = 0; rr < kRt; ++rr) {
          if (i0 + rr >= nx) break;
#pragma unroll
          for (int q = 0; q < LT; ++q) lp[rr][q] = lp[rr][q] - static_cast<float>(acc[rr][q]);
          store_lanes<LT>(HA + (N - 1 - k) * ks + (i0 + rr) * LB + l0, lp[rr]);
        }
      });
    });
    // ---- the backward prefix: g_k at row N-1-k ----
    float* grev = prefix(1, HA, HB, Y);
    float* other = grev == HA ? HB : HA;
    // ---- s_k = B' g_{k+1} + lu_k; ff_k = G_k s_k ----
    const auto s_rows = [&](int k, int i0, int l0, float (&sv)[kRt][LT]) {
      float u[kRt][LT];  // every lu row first
#pragma unroll
      for (int rr = 0; rr < kRt; ++rr)
        if (i0 + rr < nu) lu(k, i0 + rr, l0, u[rr]);
      const float* gn = k < N - 1 ? grev + (N - 2 - k) * ks + l0 : Y + l0;
      int ro[kRt];
      tile_rows(ro, i0, nu, 1);
      double acc[kRt][LT];
      tile_dot<LT>(acc, Bs, ro, nu, nx,
                   [&](int j, float (&v)[LT]) { load_lanes<LT>(gn + j * LB, v); });
#pragma unroll
      for (int rr = 0; rr < kRt; ++rr) {
        if (i0 + rr >= nu) break;  // rows past nu: never read
#pragma unroll
        for (int q = 0; q < LT; ++q) sv[rr][q] = static_cast<float>(acc[rr][q]) + u[rr][q];
      }
    };
    if (nu <= kRt) {  // s in registers: one phase
      panels(lv + 2, [&](const float* slot, int mp, int ka, int nk, bool) {
        items(nk, nu, [&](int kq, int, int l0) {
          const int k = ka + kq;
          float sv[kRt][LT];
          s_rows(k, 0, l0, sv);
          int ro[kRt];
          tile_rows(ro, 0, nu, nu);
          const float* Gk = slot + kq * mp;
          double acc[kRt][LT];
#pragma unroll
          for (int j = 0; j < kRt; ++j) {
            if (j >= nu) break;
            float m[kRt];
#pragma unroll
            for (int rr = 0; rr < kRt; ++rr) m[rr] = Gk[ro[rr] + j];
            tile_col<LT>(acc, m, sv[j], j == 0);
          }
          store_rows(FF + k * ku, nu, 0, l0, acc, false);
        });
      });
    } else {  // s in its own buffer
      __syncthreads();
      items(N, nu, [&](int k, int i0, int l0) {
        float sv[kRt][LT];
        s_rows(k, i0, l0, sv);
#pragma unroll
        for (int rr = 0; rr < kRt; ++rr)
          if (i0 + rr < nu) store_lanes<LT>(S + k * ku + (i0 + rr) * LB + l0, sv[rr]);
      });
      panels(lv + 2, [&](const float* slot, int mp, int ka, int nk, bool) {
        items(nk, nu, [&](int kq, int i0, int l0) {
          const int k = ka + kq;
          int ro[kRt];
          tile_rows(ro, i0, nu, nu);
          double acc[kRt][LT];
          const float* sk = S + k * ku + l0;
          tile_dot<LT>(acc, slot + kq * mp, ro, 1, nu,
                       [&](int j, float (&v)[LT]) { load_lanes<LT>(sk + j * LB, v); });
          store_rows(FF + k * ku, nu, i0, l0, acc, false);
        });
      });
    }
    // ---- -B ffs_k, then the forward prefix: e_{k+1} at row k ----
    __syncthreads();
    items(N, nx, [&](int k, int i0, int l0) {
      int ro[kRt];
      tile_rows(ro, i0, nx, nu);
      double acc[kRt][LT];
      const float* fk = FF + k * ku + l0;
      tile_dot<LT>(acc, Bs, ro, 1, nu,
                   [&](int j, float (&v)[LT]) { load_lanes<LT>(fk + j * LB, v); });
      store_rows(other + k * ks, nx, i0, l0, acc, true);
    });
    XS = prefix(lv + 3, other, grev, E0);
    // ---- u_k = -K_k e_k - ffs_k and its projection; the interior rows
    // X_k (with the items of the first rows); the ball's scale ----
    panels(2 * lv + 4, [&](const float* slot, int mp, int ka, int nk, bool first) {
      items(nk, nu, [&](int kq, int i0, int l0) {
        const int k = ka + kq;
        const float* xk = (k == 0 ? E0 : XS + (k - 1) * ks) + l0;
        const auto lanes_of = [&](int j, float (&v)[LT]) { load_lanes<LT>(xk + j * LB, v); };
        double acc[kRt][LT];
        int ro[kRt];
        tile_rows(ro, i0, nu, nx);
        tile_dot<LT>(acc, slot + kq * mp, ro, 1, nx, lanes_of);
        float lam[kRt][LT];  // every dual row first
#pragma unroll
        for (int rr = 0; rr < kRt; ++rr)
          if (i0 + rr < nu) get(lamU, ls, static_cast<ptrdiff_t>(k) * nu + i0 + rr, l0, lam[rr]);
#pragma unroll
        for (int rr = 0; rr < kRt; ++rr) {
          const int i = i0 + rr;
          if (i >= nu) break;
          float ff[LT], u[LT], v[LT];
          load_lanes<LT>(FF + k * ku + i * LB + l0, ff);
          const float lo = p.ulo[i], hi = p.uhi[i];
#pragma unroll
          for (int q = 0; q < LT; ++q) {
            u[q] = -static_cast<float>(acc[rr][q]) - ff[q];
            v[q] = clip(u[q] + rho_inv * lam[rr][q], lo, hi);
            lam[rr][q] = lam[rr][q] + rho * (u[q] - v[q]);
          }
          const ptrdiff_t row = static_cast<ptrdiff_t>(k) * nu + i;
          put(lamU, ls, row, l0, lam[rr]);
          put(vU, ls, row, l0, v);
          if (last) put(p.U + b0, B, row, l0, u);
        }
        if (!p.si || k == 0 || i0 != 0) return;
        for (int g = 0; g < nx; g += kRt) {  // X_k's rows, kRt at a time
          float lx[kRt][LT];
#pragma unroll
          for (int rr = 0; rr < kRt; ++rr)
            if (g + rr < nx) get(lamX, ls, static_cast<ptrdiff_t>(k - xoff) * nx + g + rr, l0, lx[rr]);
#pragma unroll
          for (int rr = 0; rr < kRt; ++rr) {
            const int i = g + rr;
            if (i >= nx) break;
            float x[LT], v[LT];
            load_lanes<LT>(XS + (k - 1) * ks + i * LB + l0, x);
            const float lo = p.xlo[i], hi = p.xhi[i];
#pragma unroll
            for (int q = 0; q < LT; ++q) {
              v[q] = clip(x[q] + rho_inv * lx[rr][q], lo, hi);
              lx[rr][q] = lx[rr][q] + rho * (x[q] - v[q]);
            }
            const ptrdiff_t row = static_cast<ptrdiff_t>(k - xoff) * nx + i;
            put(lamX, ls, row, l0, lx[rr]);
            put(vX, ls, row, l0, v);
          }
        }
      });
      if (!first || !p.ball) return;
      const float* XN = XS + (N - 1) * ks;  // each lane's norm, squares in row order
      const ptrdiff_t row0 = static_cast<ptrdiff_t>(N - xoff) * nx;
      for (int l = tid; l < LB; l += T) {
        float w = XN[l] + rho_inv * ld(lamX, row0, l);
        double acc = static_cast<double>(w) * static_cast<double>(w);
        for (int i = 1; i < nx; ++i) {
          w = XN[i * LB + l] + rho_inv * ld(lamX, row0 + i, l);
          acc = fma(static_cast<double>(w), static_cast<double>(w), acc);
        }
        const float nrm = sqrtf(static_cast<float>(acc));
        const float rad = l < nact ? p.ballr[b0 + l] : 0.0f;
        SC[l] = nrm > rad ? rad / nanmax(nrm, 1e-30f) : 1.0f;
      }
    });
    // ---- the terminal row: the ball at rho, or the box at rho_t; the next
    // iteration's lin_xN ----
    if (p.st || p.ball) {
      __syncthreads();
      const float* XN = XS + (N - 1) * ks;
      const ptrdiff_t row0 = static_cast<ptrdiff_t>(N - xoff) * nx;
      for (int e = tid; e < nx * LB; e += T) {
        const int i = e / LB, l = e - i * LB;
        const float x = XN[e], lam = ld(lamX, row0 + i, l);
        float v, lam2;
        if (p.ball) {
          v = (x + rho_inv * lam) * SC[l];
          lam2 = lam + rho * (x - v);
        } else {
          v = clip(x + rho_t_inv * lam, p.xNlo[i], p.xNhi[i]);
          lam2 = lam + rho_t * (x - v);
        }
        put_state(lamX, row0 + i, l, lam2);
        put_state(vX, row0 + i, l, v);
        Y[e] = p.st ? -rho_t * (l < nact ? v : 0.0f) + (l < nact ? lam2 : 0.0f) : 0.0f;
      }
    }
  }

  // ---- the outputs: X (row 0 = e0), the rows of vX, lamX that are not
  // split; the state where it is in shared memory (U was stored by the
  // last iteration) ----
  __syncthreads();
  for (int e = tid; e < (N + 1) * nx * LB; e += T) {
    const int l = e % LB, ri = e / LB, i = ri % nx, row = ri / nx;
    if (l >= nact) continue;
    const float x = row == 0 ? E0[i * LB + l] : XS[(row - 1) * ks + i * LB + l];
    const ptrdiff_t a = static_cast<ptrdiff_t>(ri) * B + b0 + l;
    p.X[a] = x;
    if (row < xoff) {
      p.vX[a] = x, p.lamX[a] = 0.0f;
    } else if (p.route == 0) {
      p.vX[a] = vX[(ri - xoff * nx) * LB + l], p.lamX[a] = lamX[(ri - xoff * nx) * LB + l];
    }
  }
  if (p.route == 0) {
    for (int e = tid; e < N * nu * LB; e += T) {
      const int l = e % LB, row = e / LB;
      if (l >= nact) continue;
      p.vU[row * B + b0 + l] = vU[e];
      p.lamU[row * B + b0 + l] = lamU[e];
    }
  }
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
// and the outputs U, vU, lamU (N, nu, B); scratch, the blocks' work areas
// in device memory (route 2; read on no other). The layout comes from the
// host's plan (ops/riccati_fused.k3w_plan): `lanes` lanes a block (1-32),
// `threads` threads (a multiple of 32, at least the lanes),
// `lanes_per_thread` lanes of a thread's tile (1, 2, 4 or 8, dividing the
// lanes), a ring of `ring` (2 or 3) slots of `panel` floats (a multiple of
// 4 that holds one step of every operator; or no ring, ring = panel = 0:
// the operators read where they lie, through L1/L2), the route (0: the work area
// and the lanes' state in shared memory; 1: the state in the outputs; 2:
// the work area in `scratch` too) and smem_bytes = 4 dbl_layout(...).total.
// Returns the cudaError_t of the launch (0 on success).
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
                       int terminal_ball, int lanes, int threads, int lanes_per_thread,
                       int ring, int panel, int route, int smem_bytes, void* stream) {
  const int lt = lanes_per_thread;
  if (N <= 0 || nx <= 0 || nu <= 0 || B <= 0 || R <= 0 || chunk <= 0 || L != levels_of(N) ||
      lanes <= 0 || lanes > kDblMaxLanes || (lt != 1 && lt != 2 && lt != 4 && lt != 8) ||
      lanes % lt != 0 || threads < 32 || threads % 32 != 0 || threads < lanes ||
      threads > dbl_max_threads(lt) || (ring != 0 && ring != 2 && ring != 3) || panel < 0 ||
      panel % 4 != 0 || route < 0 || route > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  // a slot holds one step of every stream (no slot without a ring); the
  // QTP's float4 reads need 16-byte aligned operators
  const bool qtp = dbl_qtp(nx, nu);
  int big = nx * nx;
  if (nu * nx > big) big = nu * nx;
  if (nu * nu > big) big = nu * nu;
  const auto aligned = [](const float* q) { return (reinterpret_cast<size_t>(q) & 15) == 0; };
  if ((ring ? panel < (big | 1) : panel != 0) ||
      (qtp && !ring && !(aligned(Kf) && aligned(bwdL) && aligned(bwdF) && aligned(fwdL) &&
                         aligned(fwdF))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int xrows = wide_split_x_rows(N, split_interior, split_terminal, terminal_ball);
  const DblLayout lay = dbl_layout(N, nx, nu, xrows, lanes, lt, ring, panel, route);
  // the host's plan and this layout must agree
  if (static_cast<size_t>(smem_bytes) != sizeof(float) * lay.total ||
      (route == 2 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  WideArgs p;
  p.Kf = Kf, p.Gf = Gf, p.Bm = Bm;
  p.bwdL = bwdL, p.bwdF = bwdF, p.fwdL = fwdL, p.fwdF = fwdF;
  p.xlo = xlo, p.xhi = xhi, p.xNlo = xNlo, p.xNhi = xNhi, p.ulo = ulo, p.uhi = uhi;
  p.rho_tab = rho_tab, p.ridx = ridx, p.e0 = e0, p.ballr = ballr;
  p.vX_in = vX_in, p.vU_in = vU_in, p.lamX_in = lamX_in, p.lamU_in = lamU_in;
  p.X = X, p.U = U, p.vX = vX, p.vU = vU, p.lamX = lamX, p.lamU = lamU;
  p.scratch = route == 2 ? scratch : nullptr;
  p.N = N, p.nx = nx, p.nu = nu, p.B = B, p.R = R, p.L = L, p.chunk = chunk;
  p.si = split_interior, p.st = split_terminal, p.ball = terminal_ball;
  p.lanes = lanes, p.ring = ring, p.panel = panel, p.route = route;
  p.lay = lay;
  const size_t bytes = static_cast<size_t>(smem_bytes);
  auto kernel = qtp ? (lt == 8   ? riccati_wide_kernel<8, 4, 2>
                       : lt == 4 ? riccati_wide_kernel<4, 4, 2>
                       : lt == 2 ? riccati_wide_kernel<2, 4, 2>
                                 : riccati_wide_kernel<1, 4, 2>)
                    : (lt == 8   ? riccati_wide_kernel<8, 0, 0>
                       : lt == 4 ? riccati_wide_kernel<4, 0, 0>
                       : lt == 2 ? riccati_wide_kernel<2, 0, 0>
                                 : riccati_wide_kernel<1, 0, 0>);
  const cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + lanes - 1) / lanes;
  kernel<<<blocks, threads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
