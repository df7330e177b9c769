// What K1 (admm_diag.cu), K2 (admm_mixed.cu), K5 and K4 (admm_perr.cu) share:
// the layout of the operators and lane buffers in shared memory, the
// precisions of their products, and the matrix-vector product that reads
// them. Each kernel stages its operators itself: K2's
// loop in the form of K1's ran 2% slower (PERF.md, Findings, K1's
// redesign).
//
// Precisions (AdmmConfig.kernel_precision, the C entries' `mode`; the JAX
// package's admm_pallas._make_dot / _make_opdot), as a template parameter
// MODE of every kernel, so that "highest" compiles apart from the others:
// - kHighest: an entry is the fp64 value of an fp32 operand; each product
//   sums exact fp32 products in fp64 in index order, rounded once.
// - kBf16x3: an entry is the pair (hi, lo) of bf16 values held in fp32,
//   hi = bf16(a), lo = bf16(a - hi), rounded to nearest even; three
//   passes hi.hi, lo.hi and hi.lo (lo.lo left out, as in JAX), each an
//   fp32 sum in index order, combined hh + (lh + hl).
// - kDefault: an entry is (bf16(a), 0); one pass hi.hi, an fp32 sum.
// A bf16 x bf16 product is exact in fp32, so an fp32 fma rounds a pass's
// sum as an add does: ops/admm_fused.dot_bf16, which sums in the same
// order, equals these bit for bit. Every precision's entry takes 8 bytes,
// so the layouts below, the plans and their bytes are the same in each:
// the pair is staged once per launch, and a multiply-add converts nothing.
//
// - Operators: the R rho copies of K^-1 (and of K), rows at a stride ld
//   (row_stride), copies at a stride sk = (n ld) | 2, odd in 16-byte
//   units, so that the same entry of two copies never shares a bank group
//   and lanes at mixed rho indices do not serialize.
// - Lane buffers: L lanes, rows paired, row i of lane b at
//   ((i / 2) L + b) 2 + i % 2 (slot), so that a lane's rows j, j+1 are one
//   16-byte load and the L lanes of a warp read L neighbouring ones.
// ops/admm_fused.row_strides and the plans' shared-memory bytes mirror
// these formulas.
//
// The stream routes (K5 and K4 in admm_perr.cu, K1 and K2 in
// admm_diag_stream.cu) and K5's and K4's wide route (admm_perr_wide.cu)
// stream one rho's operators from device memory through shared panels
// with cp.async: StreamLayout is K5's and K4's stream layout, panel_stride
// the row stride of a panel, copy16 and copy16f one 16-byte copy, copy_rows
// a block's copy of a panel's rows, widen4 the widening of four 4-byte
// entries, rho_block the lanes of one rho index a block takes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace mpc_admm {

constexpr size_t kSmemLimit = 232448;  // dynamic shared memory of a block

// jnp.clip / torch.clamp semantics: a NaN passes through, l = -inf clips
// nothing from below.
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

__device__ __forceinline__ double2 load2(const double* p) {
  return *reinterpret_cast<const double2*>(p);
}

// the double index of row i of lane b in an L-lane buffer of paired rows
__device__ __forceinline__ int slot(int i, int L, int b) {
  return (((i >> 1) * L + b) << 1) | (i & 1);
}

constexpr int kHighest = 0, kBf16x3 = 1, kDefault = 2;

// bf16(v), rounded to nearest even, as fp32 (exactly)
__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Prec<MODE>: an operand's 8-byte entry (entry), its loads and stores at
// an 8-byte slot of the fp64-typed buffers (load, load2: two neighbouring
// slots, one 16-byte load; store), a product's sum (Acc: zero, mac) and
// its fp32 result.
template <int MODE>
struct Prec;

template <>
struct Prec<kHighest> {
  using Entry = double;
  using Acc = double;
  static __device__ __forceinline__ Entry entry(float v) { return v; }
  static __device__ __forceinline__ Entry load(const double* p) { return *p; }
  static __device__ __forceinline__ void load2(const double* p, Entry& e0, Entry& e1) {
    const double2 d = mpc_admm::load2(p);
    e0 = d.x;
    e1 = d.y;
  }
  static __device__ __forceinline__ void store(double* p, Entry e) { *p = e; }
  static __device__ __forceinline__ void zero(Acc& a) { a = 0.0; }
  static __device__ __forceinline__ void mac(Acc& a, Entry m, Entry v) { a = fma(m, v, a); }
  static __device__ __forceinline__ float result(const Acc& a) { return static_cast<float>(a); }
};

// the bf16 precisions' common part: (hi, lo) pairs in fp32
struct PairEntries {
  using Entry = float2;
  static __device__ __forceinline__ Entry load(const double* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void load2(const double* p, Entry& e0, Entry& e1) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    e0 = make_float2(f.x, f.y);
    e1 = make_float2(f.z, f.w);
  }
  static __device__ __forceinline__ void store(double* p, Entry e) {
    *reinterpret_cast<float2*>(p) = e;
  }
};

template <>
struct Prec<kBf16x3> : PairEntries {
  struct Acc {
    float hh, lh, hl;
  };
  static __device__ __forceinline__ Entry entry(float v) {
    const float hi = bf16_rn(v);
    return make_float2(hi, bf16_rn(v - hi));
  }
  static __device__ __forceinline__ void zero(Acc& a) { a.hh = a.lh = a.hl = 0.0f; }
  static __device__ __forceinline__ void mac(Acc& a, Entry m, Entry v) {
    a.hh = fmaf(m.x, v.x, a.hh);
    a.lh = fmaf(m.y, v.x, a.lh);
    a.hl = fmaf(m.x, v.y, a.hl);
  }
  static __device__ __forceinline__ float result(const Acc& a) { return a.hh + (a.lh + a.hl); }
};

template <>
struct Prec<kDefault> : PairEntries {
  using Acc = float;
  static __device__ __forceinline__ Entry entry(float v) { return make_float2(bf16_rn(v), 0.0f); }
  static __device__ __forceinline__ void zero(Acc& a) { a = 0.0f; }
  static __device__ __forceinline__ void mac(Acc& a, Entry m, Entry v) { a = fmaf(m.x, v.x, a); }
  static __device__ __forceinline__ float result(const Acc& a) { return a; }
};

// out[k] = sum_j M[off[k] + j] v[j] over j < len, in index order, at
// precision MODE ("highest": fp64 sums of exact fp32 products, rounded
// once). v is the lane's column of a paired buffer (rows j, j+1 at
// v + (j / 2) * pair_stride); both are read two entries at a time.
template <int MODE, int RPT>
__device__ __forceinline__ void matvec(const double* __restrict__ M,
                                       const double* __restrict__ v,
                                       const int (&off)[RPT], int len,
                                       int pair_stride, float (&out)[RPT]) {
  using P = Prec<MODE>;
  typename P::Acc acc[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) P::zero(acc[k]);
  const int pairs = len >> 1;
#pragma unroll 2
  for (int p = 0; p < pairs; ++p) {
    typename P::Entry v0, v1;
    P::load2(v + p * pair_stride, v0, v1);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      typename P::Entry a0, a1;
      P::load2(M + off[k] + 2 * p, a0, a1);
      P::mac(acc[k], a0, v0);
      P::mac(acc[k], a1, v1);
    }
  }
  if (len & 1) {
    const typename P::Entry vj = P::load(v + pairs * pair_stride);
#pragma unroll
    for (int k = 0; k < RPT; ++k) P::mac(acc[k], P::load(M + off[k] + len - 1), vj);
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) out[k] = P::result(acc[k]);
}

// The row stride (in doubles) of an operator read two entries at a time by
// blocks of `lanes` lanes: even, and such that the 32 / lanes consecutive
// rows a warp reads start in distinct 16-byte bank groups (the stride in
// 16-byte units an odd multiple of lanes / 4).
inline int row_stride(int n, int lanes) {
  int ld = n + (n & 1);
  if (lanes >= 32) return ld;
  const int unit = lanes / 4;
  while ((ld / 2) % unit != 0 || ((ld / 2) / unit) % 2 == 0) ld += 2;
  return ld;
}

// the stride (in doubles) of the rho copies of an (n, n) operator
inline int copy_stride(int n, int ld) { return (n * ld) | 2; }

// K5's and K4's stream layout (admm_perr.cu, stream_chunk)
struct StreamLayout {
  int ldg;             // row stride (doubles) of the operators in device memory
  int nslots, mslots;  // lane buffer rows
  int panel;           // doubles of one panel
  int pc;              // constraint rows a panel of the A'y / A'rho.s pass holds
  int pkn, skn;        // columns a panel of the K-solves holds, its row stride
  int pkm, skm;        // the same for A xt
};

// The row stride (doubles) of a panel of `rows` rows within `panel`
// doubles: even, odd in 16-byte units (so the 32 / L rows a warp reads lie
// in distinct bank groups), at most ldg + 2; 0 if not even 2 columns fit.
// ops/admm_fused._panel_stride mirrors it.
inline int panel_stride(int panel, int rows, int ldg) {
  int s = panel / rows;
  if (s > ldg + 2) s = ldg + 2;
  s &= ~1;
  if ((s / 2) % 2 == 0) s -= 2;
  return s < 2 ? 0 : s;
}

// one 16-byte asynchronous copy from device to shared memory
__device__ __forceinline__ void copy16(double* dst, const double* src) {
  __pipeline_memcpy_async(dst, src, 16);
}

// one 16-byte asynchronous copy of four 4-byte entries
__device__ __forceinline__ void copy16f(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, 16);
}

// four 4-byte operator entries, widened into the 8-byte entries of
// Prec<MODE> at dst (16-byte aligned): the fp32 value as fp64 ("highest"),
// or the bf16 pair (hi in the low half, lo in the high) as fp32 values
// (ops/admm_fused.narrow_entries makes them; the stream routes of
// admm_diag_stream.cu and admm_perr_wide.cu widen them once a block)
template <int MODE>
__device__ __forceinline__ void widen4(double* dst, float4 e) {
  if constexpr (MODE == kHighest) {
    reinterpret_cast<double2*>(dst)[0] = make_double2(e.x, e.y);
    reinterpret_cast<double2*>(dst)[1] = make_double2(e.z, e.w);
  } else {
    const unsigned a = __float_as_uint(e.x), b = __float_as_uint(e.y);
    const unsigned c = __float_as_uint(e.z), d = __float_as_uint(e.w);
    reinterpret_cast<float4*>(dst)[0] =
        make_float4(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u),
                    __uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u));
    reinterpret_cast<float4*>(dst)[1] =
        make_float4(__uint_as_float(c << 16), __uint_as_float(c & 0xffff0000u),
                    __uint_as_float(d << 16), __uint_as_float(d & 0xffff0000u));
  }
}

// The block's lanes on a route whose lanes the wrapper orders by rho index
// (admm_fused.rho_order: starts[r] is where index r's lanes begin): block k
// takes lanes [(k - first) L, + L) of rho r's, in lane order, and the grid
// has room for every rho's partial last block. r == R marks a spare block;
// off is the block's first lane within rho r's, seg where they start and
// cnt how many there are.
struct RhoBlock {
  int r, seg, cnt, off;
};

__device__ __forceinline__ RhoBlock rho_block(const int* __restrict__ starts, int R, int L) {
  RhoBlock rb{R, 0, 0, 0};
  int first = 0;
  for (int rr = 0; rr < R; ++rr) {
    const int seg = starts[rr];
    const int cnt = starts[rr + 1] - seg;
    const int nb = (cnt + L - 1) / L;
    if (static_cast<int>(blockIdx.x) < first + nb) {
      rb = RhoBlock{rr, seg, cnt, (static_cast<int>(blockIdx.x) - first) * L};
      break;
    }
    first += nb;
  }
  return rb;
}

// rho_block for block `index` of a grid of equal groups of blocks (a
// thread-block cluster that shares its lanes: admm_perr_wide.cu)
__device__ __forceinline__ RhoBlock rho_block_at(const int* __restrict__ starts, int R, int L,
                                                 int index) {
  RhoBlock rb{R, 0, 0, 0};
  int first = 0;
  for (int rr = 0; rr < R; ++rr) {
    const int seg = starts[rr];
    const int cnt = starts[rr + 1] - seg;
    const int nb = (cnt + L - 1) / L;
    if (index < first + nb) {
      rb = RhoBlock{rr, seg, cnt, (index - first) * L};
      break;
    }
    first += nb;
  }
  return rb;
}

// Start copying `rows` rows of `cols` columns (an odd width with its pad
// column) from device memory at stride ld into shared memory at stride sp,
// 16 bytes a thread at a time over the block's `nthreads` threads.
__device__ __forceinline__ void copy_rows(double* dst, int sp, const double* src, int ld,
                                          int rows, int cols, int tid, int nthreads) {
  const int per_row = (cols + 1) >> 1;
  for (int c = tid; c < rows * per_row; c += nthreads) {
    const int row = c / per_row;
    const int h = c - row * per_row;
    copy16(dst + row * sp + 2 * h, src + row * ld + 2 * h);
  }
}

}  // namespace mpc_admm
