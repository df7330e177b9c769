// K3W's sequential form on Hopper: `chunk` Riccati-ADMM iterations of the
// per-lane engine for a plant of any width, the lanes of a block sharing
// each horizon step's factors through a ring in shared memory.
//
// riccati_wide_seq_chunk replaces, for plants K3 (riccati_chunk.cuh) does
// not take and wherever ops/riccati_fused.py routes the sequential chunk to
// it, the JAX package's XLA code in ops/riccati.py: solve_sparse's
// admm_iter (:619-659) with its w-update _lqr_affine_solve (:377-424). Per
// lane and iteration, with rho, 1/rho, rho_t, 1/rho_t of the launch's grid
// index r and the factors K_k, G_k, (A - B K_k) of that rho:
//
//   g = lin_xN; for k = N-1 .. 0: lu_k = -rho vU_k + lamU_k,
//   s_k = B' g + lu_k, g = (A - B K_k)' g - K_k' lu_k [+ lpre_k];
//   then e = e0, for k = 0 .. N-1: ffs_k = G_k s_k, u_k = -K_k e - ffs_k,
//   e = A e + B u_k;
//
// then the projections and dual ascent: vU = clip(U + lamU/rho), lamU +=
// rho (U - vU); the interior X rows likewise (split_interior); the terminal
// row onto the ball (terminal_ball) at rho or its box at rho_t
// (split_terminal); rows not split mirror X and carry no dual; row 0 is e0.
// lin_xN = -rho_t vX_N + lamX_N where the terminal row is split (else 0),
// lpre_k = -rho vX_k + lamX_k where the interior is split and k >= 1. (ffs_k
// = G_k (B' g_{k+1} + lu_k) is formed in the rollout, from s_k, where the
// plain version forms it in the sweep: the same sum.)
//
// What bounds it on this card: the fp64 multiply-adds (2 ops each, 34 TFLOP/s
// on the fp64 units) and their chain: a lane's iteration is 2N dependent
// steps, each a few products of length nx or nu.
//
// Design:
// - A block takes `lanes` lanes (4, 8, 16 or 32) of the launch's one rho,
//   so every lane of the block reads the same K_k, G_k, (A - B K_k). Its
//   threads run over (row, group of 4 lanes): a thread reads each factor
//   entry of its row once, widens it once and keeps 4 fp64 sums, one a
//   lane; the step's vectors (g, lu, e, u, s) sit in shared memory in fp64
//   as [row][lane], so that a thread's 4 lanes are two 16-byte loads, which
//   the threads of a warp share.
// - A ring of `ring` horizon steps in shared memory: step k's K_k and
//   (A - B K_k) for the sweep (k walks down), K_k' and G_k' for the rollout
//   (k walks up), filled by cp.async `ring` - 1 steps ahead of the step the
//   block computes. The plant (B, A', B') stays in shared memory for the
//   chunk. The host stores K_k', G_k', A', B' (ops/riccati_fused.
//   k3w_seq_operands) so that every product's threads read neighbouring
//   words of a row: no bank conflicts.
// - Barriers: one a sweep step (the next g in a second buffer; lu_{k-1}
//   formed beside step k), two a rollout step (K e, G s and A e; then B u);
//   each projection is folded into the rollout step that forms its row.
// - The lanes' horizon state (vU, lamU, s, and the split rows of vX, lamX)
//   sits in shared memory where it fits beside the ring ("shared"), else in
//   the outputs themselves in device memory, lane-last ("device"; s in U's
//   rows until the last iteration writes U); past that the step's vectors
//   go to a scratch in device memory too and the factors are read through
//   L1/L2 ("global"), so every width gets a layout
//   (ops/riccati_fused.k3w_plan). The same code runs on each.
// - No thread returns early; lanes past the batch in a partial last block
//   compute on zeros and are never stored.
//
// Precision: the state is fp32; each product of length nx or nu sums exact
// fp32 products in fp64 in column order and is rounded once to fp32; the
// elementwise steps are fp32 in the plain version's order. Built with
// --fmad=false, the kernel equals iterate_chunk_riccati_plain
// (ops/riccati_fused.py) bit for bit.
//
// Bound to PyTorch by ctypes through a plain C function that returns
// cudaGetLastError() after the launch (0 on success).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr size_t kSmemLimit = 232448;
constexpr int kMaxThreads = 256;
constexpr int kLpt = 4;  // lanes a thread

__host__ __device__ inline size_t pad4(size_t n) { return (n + 3) / 4 * 4; }

// Where each region of a block lies, in floats from its base: the step's
// vectors (fp64 g, lu, e (two buffers each), u, s; fp32 lu (two), A e, e0,
// the ball's scale), the ring, the plant, the lanes' horizon state. Regions
// that the layout keeps elsewhere take no room. ops/riccati_fused.
// k3w_seq_floats mirrors it.
struct SeqLayout {
  size_t g, lud, e, u, s, luf, ae, e0, sc, work;  // work: the vectors' floats
  size_t padk, slot, ring, pb, pat, pbt, state, total;
};

__host__ __device__ inline SeqLayout seq_layout(int N, int nx, int nu, int xrows, int L,
                                                int ring, int plant_shared, int state_shared) {
  SeqLayout s;
  const size_t x = nx, u = nu, l = L;
  size_t o = 0;
  s.g = o, o += 4 * x * l;
  s.lud = o, o += 4 * u * l;
  s.e = o, o += 4 * x * l;
  s.u = o, o += 2 * u * l;
  s.s = o, o += 2 * u * l;
  s.luf = o, o += 2 * u * l;
  s.ae = o, o += x * l;
  s.e0 = o, o += x * l;
  s.sc = o, o += l;
  s.work = o;
  s.padk = pad4(u * x);
  s.slot = s.padk + pad4(x * x > u * u ? x * x : u * u);
  s.ring = o, o += static_cast<size_t>(ring) * s.slot;
  s.pb = o, o += plant_shared ? pad4(x * u) : 0;
  s.pat = o, o += plant_shared ? pad4(x * x) : 0;
  s.pbt = o, o += plant_shared ? pad4(u * x) : 0;
  s.state = o;
  if (state_shared) o += (3 * static_cast<size_t>(N) * u + 2 * static_cast<size_t>(xrows) * x) * l;
  s.total = o;
  return s;
}

__host__ __device__ inline int seq_split_x_rows(int N, int si, int st, int ball) {
  return si ? N : ((st || ball) ? 1 : 0);
}

// jnp.clip / torch.clamp semantics: a NaN passes through
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// max that propagates NaN, as torch.amax does
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// acc[l] = sum_j M[j ld] v[j L + l] for the 4 lanes l at v, j < n (n >= 1):
// exact fp32 products summed in fp64 in order j = 0..n-1. M may lie in
// shared or device memory; v is fp64 in shared (or scratch) memory, 16-byte
// aligned.
__device__ __forceinline__ void dot4(const float* __restrict__ M, int ld, const double* v, int L,
                                     int n, double acc[kLpt]) {
  double m = static_cast<double>(M[0]);
  double2 a = *reinterpret_cast<const double2*>(v);
  double2 b = *reinterpret_cast<const double2*>(v + 2);
  acc[0] = m * a.x, acc[1] = m * a.y, acc[2] = m * b.x, acc[3] = m * b.y;
#pragma unroll 4
  for (int j = 1; j < n; ++j) {
    m = static_cast<double>(M[j * ld]);
    a = *reinterpret_cast<const double2*>(v + j * L);
    b = *reinterpret_cast<const double2*>(v + j * L + 2);
    acc[0] = fma(m, a.x, acc[0]);
    acc[1] = fma(m, a.y, acc[1]);
    acc[2] = fma(m, b.x, acc[2]);
    acc[3] = fma(m, b.y, acc[3]);
  }
}


// The two products of a row at once, a[l] = sum_{j < na} Ma[j lda] va[j L
// + l] and b[l] likewise (na, nb >= 1), each in its own order j = 0..n-1:
// twice the independent sums in flight on the thread's chain.
__device__ __forceinline__ void dot4x2(const float* __restrict__ Ma, int lda, const double* va,
                                       int na, double a[kLpt], const float* __restrict__ Mb,
                                       int ldb, const double* vb, int nb, double b[kLpt],
                                       int L) {
  const int n = na < nb ? na : nb;
  double ma = static_cast<double>(Ma[0]), mb = static_cast<double>(Mb[0]);
  double2 a0 = *reinterpret_cast<const double2*>(va);
  double2 a1 = *reinterpret_cast<const double2*>(va + 2);
  double2 b0 = *reinterpret_cast<const double2*>(vb);
  double2 b1 = *reinterpret_cast<const double2*>(vb + 2);
  a[0] = ma * a0.x, a[1] = ma * a0.y, a[2] = ma * a1.x, a[3] = ma * a1.y;
  b[0] = mb * b0.x, b[1] = mb * b0.y, b[2] = mb * b1.x, b[3] = mb * b1.y;
#pragma unroll 2
  for (int j = 1; j < n; ++j) {
    ma = static_cast<double>(Ma[j * lda]);
    mb = static_cast<double>(Mb[j * ldb]);
    a0 = *reinterpret_cast<const double2*>(va + j * L);
    a1 = *reinterpret_cast<const double2*>(va + j * L + 2);
    b0 = *reinterpret_cast<const double2*>(vb + j * L);
    b1 = *reinterpret_cast<const double2*>(vb + j * L + 2);
    a[0] = fma(ma, a0.x, a[0]), a[1] = fma(ma, a0.y, a[1]);
    a[2] = fma(ma, a1.x, a[2]), a[3] = fma(ma, a1.y, a[3]);
    b[0] = fma(mb, b0.x, b[0]), b[1] = fma(mb, b0.y, b[1]);
    b[2] = fma(mb, b1.x, b[2]), b[3] = fma(mb, b1.y, b[3]);
  }
  for (int j = n > 1 ? n : 1; j < na; ++j) {
    ma = static_cast<double>(Ma[j * lda]);
    a0 = *reinterpret_cast<const double2*>(va + j * L);
    a1 = *reinterpret_cast<const double2*>(va + j * L + 2);
    a[0] = fma(ma, a0.x, a[0]), a[1] = fma(ma, a0.y, a[1]);
    a[2] = fma(ma, a1.x, a[2]), a[3] = fma(ma, a1.y, a[3]);
  }
  for (int j = n > 1 ? n : 1; j < nb; ++j) {
    mb = static_cast<double>(Mb[j * ldb]);
    b0 = *reinterpret_cast<const double2*>(vb + j * L);
    b1 = *reinterpret_cast<const double2*>(vb + j * L + 2);
    b[0] = fma(mb, b0.x, b[0]), b[1] = fma(mb, b0.y, b[1]);
    b[2] = fma(mb, b1.x, b[2]), b[3] = fma(mb, b1.y, b[3]);
  }
}

struct SeqArgs {
  const float *K, *KT, *GT, *AmBK, *Bm, *AT, *BT;
  const float *xlo, *xhi, *xNlo, *xNhi, *ulo, *uhi, *rho_tab;
  const int* ridx;
  const float *e0, *ballr, *vX_in, *vU_in, *lamX_in, *lamU_in;
  float *X, *U, *vX, *vU, *lamX, *lamU, *scratch;
  int N, nx, nu, B, R, chunk, si, st, ball, lanes, ring, plant_shared, state_shared, vec16;
  SeqLayout lay;
};

// Start the copies of an iteration's step cc into a ring slot (each
// iteration takes the sweep's steps N-1 .. 0, cc = 0 .. N-1, then the
// rollout's 0 .. N-1, cc = N .. 2N-1): this thread's share, 16 or 4 bytes
// a copy.
__device__ __forceinline__ void ring_fill(const SeqArgs& p, float* slot, int cc, const float* K,
                                          const float* AmBK, const float* KT, const float* GT,
                                          int tid, int T) {
  const int N = p.N;
  const size_t nx = p.nx, nu = p.nu;
  float* second = slot + p.lay.padk;
  const float *a, *b;
  size_t na, nb;
  if (cc < N) {  // the sweep's step k: K_k, (A - B K_k)
    const size_t k = N - 1 - cc;
    a = K + k * nu * nx, na = nu * nx;
    b = AmBK + k * nx * nx, nb = nx * nx;
  } else {  // the rollout's step k: K_k', G_k'
    const size_t k = cc - N;
    a = KT + k * nx * nu, na = nx * nu;
    b = GT + k * nu * nu, nb = nu * nu;
  }
  if (p.vec16) {
    for (size_t i = 4 * static_cast<size_t>(tid); i < na; i += 4 * static_cast<size_t>(T))
      __pipeline_memcpy_async(slot + i, a + i, 16);
    for (size_t i = 4 * static_cast<size_t>(tid); i < nb; i += 4 * static_cast<size_t>(T))
      __pipeline_memcpy_async(second + i, b + i, 16);
  } else {
    for (size_t i = tid; i < na; i += T) __pipeline_memcpy_async(slot + i, a + i, 4);
    for (size_t i = tid; i < nb; i += T) __pipeline_memcpy_async(second + i, b + i, 4);
  }
}

// FAST: the layout keeps everything in shared memory (route 0, a ring, the
// plant), so every access is a shared-memory one the compiler can see as
// such; the other layouts take the general instantiation.
template <bool FAST>
__global__ void __launch_bounds__(kMaxThreads) riccati_wide_seq_kernel(const SeqArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, nx = p.nx, nu = p.nu, L = p.lanes, LG = L / kLpt, R = p.R;
  const int tid = threadIdx.x, T = blockDim.x;
  const int b0 = blockIdx.x * L;
  const int nact = min(L, p.B - b0);  // the block's lanes in the batch
  const ptrdiff_t B = p.B;
  const int xrows = seq_split_x_rows(N, p.si, p.st, p.ball);
  const int xoff = N + 1 - xrows;  // the first split row
  const SeqLayout& lay = p.lay;
  // L is a power of two that divides T: a thread's lane in the [row][L]
  // loops is fixed, its rows step by T / L
  const int lsh = __ffs(L) - 1, el = tid & (L - 1), ej = tid >> lsh, estep = T >> lsh;

  // the step's vectors: in shared memory, or the block's scratch ("global")
  float* work = (!FAST && p.scratch) ? p.scratch + static_cast<size_t>(blockIdx.x) * lay.work
                                     : smem;
  double* G2 = reinterpret_cast<double*>(work + lay.g);     // g, two buffers [2][nx][L]
  double* LUd = reinterpret_cast<double*>(work + lay.lud);  // lu, two buffers [2][nu][L]
  double* E2 = reinterpret_cast<double*>(work + lay.e);     // e, two buffers [2][nx][L]
  double* Ud = reinterpret_cast<double*>(work + lay.u);     // u_k [nu][L]
  double* Sd = reinterpret_cast<double*>(work + lay.s);     // s_k [nu][L]
  float* LUf = work + lay.luf;                              // lu in fp32 [2][nu][L]
  float* AE = work + lay.ae;                                // A e [nx][L]
  float* E0 = work + lay.e0;                                // e0 [nx][L]
  float* SC = work + lay.sc;                                // the ball's scale [L]
  float* ring = smem + lay.ring;
  const bool plant = FAST || p.plant_shared;
  const float* Bp = plant ? smem + lay.pb : p.Bm;    // B (nx, nu)
  const float* ATp = plant ? smem + lay.pat : p.AT;  // A' (nx, nx)
  const float* BTp = plant ? smem + lay.pbt : p.BT;  // B' (nu, nx)

  const int r = p.ridx[0];
  const float rho = p.rho_tab[r], rho_inv = p.rho_tab[R + r];
  const float rho_t = p.rho_tab[2 * R + r], rho_t_inv = p.rho_tab[3 * R + r];
  const float* K = p.K + static_cast<size_t>(r) * N * nu * nx;        // (N, nu, nx)
  const float* KT = p.KT + static_cast<size_t>(r) * N * nu * nx;      // (N, nx, nu)
  const float* GT = p.GT + static_cast<size_t>(r) * N * nu * nu;      // (N, nu, nu)
  const float* AmBK = p.AmBK + static_cast<size_t>(r) * N * nx * nx;  // (N, nx, nx)

  // the lanes' horizon state, entry (row, lane) at base[row ls + lane]:
  // vU, lamU, s (N nu rows) and the split rows of vX, lamX (row k at
  // (k - xoff) nx)
  float *vU, *lamU, *S, *vX = nullptr, *lamX = nullptr;
  ptrdiff_t ls;
  if (FAST || p.state_shared) {
    ls = L;
    vU = smem + lay.state;
    lamU = vU + static_cast<size_t>(N) * nu * L;
    S = lamU + static_cast<size_t>(N) * nu * L;
    vX = S + static_cast<size_t>(N) * nu * L;
    lamX = vX + static_cast<size_t>(xrows) * nx * L;
  } else {  // in place in the outputs, s in U's rows
    ls = B;
    vU = p.vU + b0, lamU = p.lamU + b0, S = p.U + b0;
    if (xrows) {
      vX = p.vX + static_cast<ptrdiff_t>(xoff) * nx * B + b0;
      lamX = p.lamX + static_cast<ptrdiff_t>(xoff) * nx * B + b0;
    }
  }
  // lanes past the batch read zeros and are never stored
  const auto ld = [&](const float* s, ptrdiff_t row, int l) {
    return l < nact ? s[row * ls + l] : 0.0f;
  };
  const auto st = [&](float* s, ptrdiff_t row, int l, float v) {
    if (l < nact) s[row * ls + l] = v;
  };
  const auto in = [&](const float* a, ptrdiff_t row, int l) {
    return l < nact ? a[row * B + b0 + l] : 0.0f;
  };
  // the product items a thread takes, (row, group of 4 lanes): the sweep's
  // and the rollout's first phase run over nu rows, then nx rows (q <
  // (nu + nx) LG), the rollout's second over nx rows (q < nx LG); a
  // thread's first item of each is decoded once
  const auto item2 = [&](int q) {  // (row, lg); row < nu: the first nu rows
    if (q < nu * LG) return make_int2(q % nu, q / nu);
    const int q2 = q - nu * LG;
    return make_int2(nu + q2 % nx, q2 / nx);
  };
  const int2 first = item2(tid);
  const int rowd1 = tid % nx, lgd1 = tid / nx;
  const float ulo1 = first.x < nu ? p.ulo[first.x] : 0.0f;
  const float uhi1 = first.x < nu ? p.uhi[first.x] : 0.0f;

  // ---- the plant and the lanes' inputs (lane-last: entry (row, i) at
  // (row n + i) B + b) ----
  if (plant) {
    float* sb = smem + lay.pb;
    float* sat = smem + lay.pat;
    float* sbt = smem + lay.pbt;
    for (int i = tid; i < nx * nu; i += T) sb[i] = p.Bm[i], sbt[i] = p.BT[i];
    for (int i = tid; i < nx * nx; i += T) sat[i] = p.AT[i];
  }
  for (int row = ej; row < N * nu; row += estep) {
    st(vU, row, el, in(p.vU_in, row, el));
    st(lamU, row, el, in(p.lamU_in, row, el));
  }
  for (int row = ej; row < xrows * nx; row += estep) {
    st(vX, row, el, in(p.vX_in, static_cast<ptrdiff_t>(xoff) * nx + row, el));
    st(lamX, row, el, in(p.lamX_in, static_cast<ptrdiff_t>(xoff) * nx + row, el));
  }
  for (int i = ej; i < nx; i += estep) E0[i * L + el] = in(p.e0, i, el);
  __syncthreads();

  // the ring: the steps are taken from its slots in turn and filled ring -
  // 1 steps ahead (put: the next fill's slot, step and iteration; nothing
  // past the chunk)
  int take = 0, put = 0, put_cc = 0, put_it = 0;
  const auto fill = [&]() {
    if (put_it < p.chunk) ring_fill(p, ring + put * lay.slot, put_cc, K, AmBK, KT, GT, tid, T);
    __pipeline_commit();
    put = put + 1 == p.ring ? 0 : put + 1;
    if (++put_cc == 2 * N) put_cc = 0, ++put_it;
  };
  for (int q = 0; q + 1 < p.ring; ++q) fill();
  // wait for the next step's copies, make them every thread's, refill the
  // slot the block finished with; the step's slot (nullptr: the factors are
  // read from device memory)
  const auto next = [&]() -> const float* {
    if (p.ring == 3)
      __pipeline_wait_prior(1);
    else if (p.ring == 2)
      __pipeline_wait_prior(0);
    __syncthreads();
    if (!FAST && !p.ring) return nullptr;
    fill();
    const float* slot = ring + take * lay.slot;
    take = take + 1 == p.ring ? 0 : take + 1;
    return slot;
  };

  for (int it = 0; it < p.chunk; ++it) {
    const bool last = it == p.chunk - 1;
    // ---- g = lin_xN; lu_{N-1} ----
    for (int i = ej; i < nx; i += estep) {
      const ptrdiff_t row = static_cast<ptrdiff_t>(N - xoff) * nx + i;
      G2[i * L + el] = p.st ? static_cast<double>(-rho_t * ld(vX, row, el) + ld(lamX, row, el))
                            : 0.0;
    }
    for (int j = ej; j < nu; j += estep) {
      const ptrdiff_t row = static_cast<ptrdiff_t>(N - 1) * nu + j;
      const float lu = -rho * ld(vU, row, el) + ld(lamU, row, el);
      LUf[j * L + el] = lu;
      LUd[j * L + el] = lu;
    }

    // ---- the backward affine sweep: s_k, and the next g ----
    for (int k = N - 1; k >= 0; --k) {
      const float* slot = next();
      const float* Kk = (FAST || slot) ? slot : K + static_cast<size_t>(k) * nu * nx;
      const float* Ak = (FAST || slot) ? slot + lay.padk : AmBK + static_cast<size_t>(k) * nx * nx;
      const int cur = (N - 1 - k) & 1;
      const double* g = G2 + cur * nx * L;
      double* gn = G2 + (cur ^ 1) * nx * L;
      const double* lud = LUd + cur * nu * L;
      const float* luf = LUf + cur * nu * L;
      for (int q = tid; q < (nu + nx) * LG; q += T) {
        const int2 item = q == tid ? first : item2(q);
        const int rr = item.x, lg = item.y;
        double acc[kLpt];
        if (rr < nu) {  // s_k = B' g + lu_k
          dot4(Bp + rr, nu, g + lg * kLpt, L, nx, acc);
          for (int l = 0; l < kLpt; ++l) {
            const int lane = lg * kLpt + l;
            const float s = static_cast<float>(acc[l]) + luf[rr * L + lane];
            st(S, k * nu + rr, lane, s);
            if (k == 0) Sd[rr * L + lane] = s;  // the rollout's first s
          }
        } else {  // g = (A - B K_k)' g - K_k' lu_k [+ lpre_k]
          const int i = rr - nu;
          double kl[kLpt];
          dot4x2(Ak + i, nx, g + lg * kLpt, nx, acc, Kk + i, nx, lud + lg * kLpt, nu, kl, L);
          for (int l = 0; l < kLpt; ++l) {
            const int lane = lg * kLpt + l;
            float gv = static_cast<float>(acc[l]) - static_cast<float>(kl[l]);
            if (p.si && k >= 1) {
              const ptrdiff_t row = static_cast<ptrdiff_t>(k - xoff) * nx + i;
              gv = gv + (-rho * ld(vX, row, lane) + ld(lamX, row, lane));
            }
            gn[i * L + lane] = gv;
          }
        }
      }
      if (k >= 1) {  // lu_{k-1}
        for (int j = ej; j < nu; j += estep) {
          const ptrdiff_t row = static_cast<ptrdiff_t>(k - 1) * nu + j;
          const float lu = -rho * ld(vU, row, el) + ld(lamU, row, el);
          LUf[((cur ^ 1) * nu + j) * L + el] = lu;
          LUd[((cur ^ 1) * nu + j) * L + el] = lu;
        }
      } else {  // the rollout's e_0
        for (int i = ej; i < nx; i += estep) E2[i * L + el] = E0[i * L + el];
      }
    }

    // ---- the forward rollout, each row projected where it is formed ----
    for (int k = 0; k < N; ++k) {
      const float* slot = next();
      const float* KTk = (FAST || slot) ? slot : KT + static_cast<size_t>(k) * nx * nu;
      const float* GTk = (FAST || slot) ? slot + lay.padk : GT + static_cast<size_t>(k) * nu * nu;
      const double* e = E2 + (k & 1) * nx * L;
      double* en = E2 + ((k + 1) & 1) * nx * L;
      for (int q = tid; q < (nu + nx) * LG; q += T) {
        const int2 item = q == tid ? first : item2(q);
        const int rr = item.x, lg = item.y;
        double acc[kLpt];
        if (rr < nu) {  // u_k = -K_k e - ffs_k, ffs_k = G_k s_k; vU, lamU
          double ff[kLpt];
          dot4x2(KTk + rr, nu, e + lg * kLpt, nx, acc, GTk + rr, nu, Sd + lg * kLpt, nu, ff, L);
          const float lo = q == tid ? ulo1 : p.ulo[rr], hi = q == tid ? uhi1 : p.uhi[rr];
          for (int l = 0; l < kLpt; ++l) {
            const int lane = lg * kLpt + l;
            const float u = -static_cast<float>(acc[l]) - static_cast<float>(ff[l]);
            Ud[rr * L + lane] = u;
            const ptrdiff_t row = static_cast<ptrdiff_t>(k) * nu + rr;
            const float lam = ld(lamU, row, lane);
            const float v = clip(u + rho_inv * lam, lo, hi);
            st(lamU, row, lane, lam + rho * (u - v));
            st(vU, row, lane, v);
            if (last && lane < nact) p.U[row * B + b0 + lane] = u;
          }
        } else {  // A e
          const int i = rr - nu;
          dot4(ATp + i, nx, e + lg * kLpt, L, nx, acc);
          for (int l = 0; l < kLpt; ++l) AE[i * L + lg * kLpt + l] = static_cast<float>(acc[l]);
        }
      }
      __syncthreads();
      for (int q = tid; q < nx * LG; q += T) {  // e_{k+1} = A e + B u_k
        const int i = q == tid ? rowd1 : q % nx, lg = q == tid ? lgd1 : q / nx;
        double acc[kLpt];
        dot4(BTp + i, nx, Ud + lg * kLpt, L, nu, acc);
        for (int l = 0; l < kLpt; ++l) {
          const int lane = lg * kLpt + l;
          const float x = AE[i * L + lane] + static_cast<float>(acc[l]);
          en[i * L + lane] = x;
          if (last && lane < nact) {
            const ptrdiff_t a = (static_cast<ptrdiff_t>(k + 1) * nx + i) * B + b0 + lane;
            p.X[a] = x;
            if (k + 1 < xoff) p.vX[a] = x, p.lamX[a] = 0.0f;  // a row not split
          }
        }
      }
      if (k + 1 < N) {  // s_{k+1}
        for (int j = ej; j < nu; j += estep)
          Sd[j * L + el] = ld(S, static_cast<ptrdiff_t>(k + 1) * nu + j, el);
      }
      if (p.si && k >= 1) {  // the interior row X_k
        for (int i = ej; i < nx; i += estep) {
          const ptrdiff_t row = static_cast<ptrdiff_t>(k - xoff) * nx + i;
          const float x = static_cast<float>(e[i * L + el]), lam = ld(lamX, row, el);
          const float v = clip(x + rho_inv * lam, p.xlo[i], p.xhi[i]);
          st(lamX, row, el, lam + rho * (x - v));
          st(vX, row, el, v);
        }
      }
    }

    // ---- the terminal row: the ball at rho, or the box at rho_t ----
    __syncthreads();  // e_N is whole
    const double* eN = E2 + (N & 1) * nx * L;
    const ptrdiff_t row0 = static_cast<ptrdiff_t>(N - xoff) * nx;
    if (p.ball) {
      if (tid < L) {  // each lane's norm, squares in row order
        float w = static_cast<float>(eN[tid]) + rho_inv * ld(lamX, row0, tid);
        double acc = static_cast<double>(w) * static_cast<double>(w);
        for (int i = 1; i < nx; ++i) {
          w = static_cast<float>(eN[i * L + tid]) + rho_inv * ld(lamX, row0 + i, tid);
          acc = fma(static_cast<double>(w), static_cast<double>(w), acc);
        }
        const float nrm = sqrtf(static_cast<float>(acc));
        const float rad = tid < nact ? p.ballr[b0 + tid] : 0.0f;
        SC[tid] = nrm > rad ? rad / nanmax(nrm, 1e-30f) : 1.0f;
      }
      __syncthreads();
      for (int i = ej; i < nx; i += estep) {
        const float x = static_cast<float>(eN[i * L + el]), lam = ld(lamX, row0 + i, el);
        const float v = (x + rho_inv * lam) * SC[el];
        st(lamX, row0 + i, el, lam + rho * (x - v));
        st(vX, row0 + i, el, v);
      }
    } else if (p.st) {
      for (int i = ej; i < nx; i += estep) {
        const float x = static_cast<float>(eN[i * L + el]), lam = ld(lamX, row0 + i, el);
        const float v = clip(x + rho_t_inv * lam, p.xNlo[i], p.xNhi[i]);
        st(lamX, row0 + i, el, lam + rho_t * (x - v));
        st(vX, row0 + i, el, v);
      }
    }
  }

  // ---- the outputs: row 0 = e0; the state where it is in shared memory
  // (X, U and the rows not split were stored by the last iteration) ----
  __syncthreads();
  if (el < nact) {
    for (int i = ej; i < nx; i += estep) {
      const ptrdiff_t a = static_cast<ptrdiff_t>(i) * B + b0 + el;
      p.X[a] = E0[i * L + el], p.vX[a] = E0[i * L + el], p.lamX[a] = 0.0f;
    }
    if (FAST || p.state_shared) {
      for (int row = ej; row < N * nu; row += estep) {
        p.vU[row * B + b0 + el] = vU[row * L + el];
        p.lamU[row * B + b0 + el] = lamU[row * L + el];
      }
      for (int row = ej; row < xrows * nx; row += estep) {
        const ptrdiff_t a = (static_cast<ptrdiff_t>(xoff) * nx + row) * B + b0 + el;
        p.vX[a] = vX[row * L + el];
        p.lamX[a] = lamX[row * L + el];
      }
    }
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

extern "C" {

// Launch `chunk` (>= 1) iterations of K3W's sequential form on `stream`.
// All arrays are float32 and contiguous on one device: K (R, N, nu, nx),
// KT = K' (R, N, nx, nu), GT = G' (R, N, nu, nu), AmBK (R, N, nx, nx), Bm
// (nx, nu), AT = A' (nx, nx), BT = B' (nu, nx), the boxes xlo, xhi, xNlo,
// xNhi (nx) and ulo, uhi (nu), rho_tab (4, R); ridx (1) int32 in [0, R);
// e0 (nx, B), ballr (B); vX_in, lamX_in and the outputs X, vX, lamX (N+1,
// nx, B); vU_in, lamU_in and the outputs U, vU, lamU (N, nu, B); scratch,
// the blocks' step vectors in device memory (route 2; read on no other). The
// layout comes from the host's plan (ops/riccati_fused.k3w_plan): `lanes`
// lanes a block (4, 8, 16 or 32), `threads` threads (a multiple of 32),
// a ring of `ring`
// horizon steps (0, 2 or 3), the plant in shared memory or not, the lanes'
// state in shared memory (route 0), in the outputs (route 1), or that and
// the step's vectors in `scratch` (route 2, no shared memory); smem_bytes
// = 4 seq_layout(...).total (0 on route 2). Returns the cudaError_t of
// the launch (0 on success).
int riccati_wide_seq_chunk(const float* K, const float* KT, const float* GT, const float* AmBK,
                           const float* Bm, const float* AT, const float* BT, const float* xlo,
                           const float* xhi, const float* xNlo, const float* xNhi,
                           const float* ulo, const float* uhi, const float* rho_tab,
                           const int* ridx, const float* e0, const float* ballr,
                           const float* vX_in, const float* vU_in, const float* lamX_in,
                           const float* lamU_in, float* X, float* U, float* vX, float* vU,
                           float* lamX, float* lamU, float* scratch, int N, int nx, int nu, int B,
                           int R, int chunk, int split_interior, int split_terminal,
                           int terminal_ball, int lanes, int threads, int ring, int plant_shared,
                           int route, int smem_bytes, void* stream) {
  if (N <= 0 || nx <= 0 || nu <= 0 || B <= 0 || R <= 0 || chunk <= 0 || lanes < kLpt ||
      lanes > 32 || (lanes & (lanes - 1)) != 0 || threads <= 0 || threads % 32 != 0 ||
      threads > kMaxThreads ||
      (ring != 0 && ring != 2 && ring != 3) || route < 0 || route > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int xrows = seq_split_x_rows(N, split_interior, split_terminal, terminal_ball);
  const SeqLayout lay = seq_layout(N, nx, nu, xrows, lanes, ring, plant_shared, route == 0);
  // the host's plan and this layout must agree
  if (route == 2) {
    if (ring != 0 || plant_shared || smem_bytes != 0 || scratch == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (static_cast<size_t>(smem_bytes) != sizeof(float) * lay.total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SeqArgs p;
  p.K = K, p.KT = KT, p.GT = GT, p.AmBK = AmBK, p.Bm = Bm, p.AT = AT, p.BT = BT;
  p.xlo = xlo, p.xhi = xhi, p.xNlo = xNlo, p.xNhi = xNhi, p.ulo = ulo, p.uhi = uhi;
  p.rho_tab = rho_tab, p.ridx = ridx, p.e0 = e0, p.ballr = ballr;
  p.vX_in = vX_in, p.vU_in = vU_in, p.lamX_in = lamX_in, p.lamU_in = lamU_in;
  p.X = X, p.U = U, p.vX = vX, p.vU = vU, p.lamX = lamX, p.lamU = lamU;
  p.scratch = route == 2 ? scratch : nullptr;
  p.N = N, p.nx = nx, p.nu = nu, p.B = B, p.R = R, p.chunk = chunk;
  p.si = split_interior, p.st = split_terminal, p.ball = terminal_ball;
  p.lanes = lanes, p.ring = ring, p.plant_shared = plant_shared, p.state_shared = route == 0;
  // 16-byte copies where every step's blocks start on 16 bytes
  p.vec16 = ((nu * nx | nx * nx | nu * nu) & 3) == 0 && aligned16(K) && aligned16(KT) &&
            aligned16(GT) && aligned16(AmBK);
  p.lay = lay;
  const size_t bytes = static_cast<size_t>(smem_bytes);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const bool fast = route == 0 && ring != 0 && plant_shared;
  auto kernel = fast ? riccati_wide_seq_kernel<true> : riccati_wide_seq_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + lanes - 1) / lanes;
  kernel<<<blocks, threads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
