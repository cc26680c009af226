// The scan kernel `field_scan` and the Horner kernel `fr_horner`: the
// launch chains of K1 behind LimbField's prefix scans, `sum_last`,
// `batch_inv` and the linear division, each run in a few launches.
//
// field_scan replaces the rounds of `_prefix_scan` (kzg_tpu/fields/
// limb.py:337) and `sum_last` (:385), which ran one whole-array K1 launch
// (`_run_elementwise`, kzg_tpu/fields/pallas_field.py:295) a round, with a
// roll and a select beside it: ceil(log2 n) rounds a scan. Here an
// inclusive scan of mul or add along the last axis of (N, rows, n) words,
// forward or reverse, takes one launch when n fits one tile and three when
// it fits 1024 tiles (2^20 elements), whatever the rows. Its pair mode runs
// each row forward and reversed at once, exclusive: `batch_inv`'s prefix
// and suffix products in one pass over the input, no reversed copy.
//
// fr_horner replaces the K1 chain of `_div_by_linear` (kzg_tpu/poly/
// polynomial.py:122-145: three log-depth scans, an inverse and the products
// around them) and, in its remainder-only mode, `_eval_many` (:94-118):
// h_n = carry in, h_j = f_j + x h_{j+1}; q_j = h_{j+1} for j < n - 1 and
// the remainder (carry out) is h_0. The quotient and the remainder are the
// unique canonical residues, so they equal the reference's words; x = 0
// needs no branch (h_j = f_j, the reference's coefficient shift).
//
// Tiles. A block owns a tile of kScanTile consecutive elements of one row
// (blockIdx.x the tile, blockIdx.y the row) and stages it in shared memory
// with coalesced loads: the layout is limb-major, word l of neighbouring
// elements at neighbouring addresses, so a thread that walked its own run
// straight from device memory would read with a stride. Word planes are
// padded by one word every 32 elements: thread t reads element t m + k, and
// the pad spreads a warp's 32 reads over 32 banks. Each thread folds its run
// of kScanRun consecutive elements in registers (field.cuh's CIOS); run
// totals are scanned across the warp by shuffles (N words each) and across
// the block's warps through shared memory. Across tiles a wrapper runs the
// same kernel three ways: a first launch writes each tile's total to a
// scratch tensor, the totals are scanned by the same scheme (one launch
// below 1024 tiles), and a last launch runs every tile from its carry.
// Blocks run in no order, so no block waits on another.
//
// fr_horner runs the same tiles with Horner's rule: thread t owns the run
// [t m, t m + m) of its tile and folds it high to low with carry 0 (its run
// value V_t); a segment of d runs below a higher one takes that one's value
// as its carry, S = S_low + x^(m d) S_high, so a warp scans its run values
// by shuffles with x^m squared at each level. The carry into each warp comes
// down from the warp above through shared memory, and a second warp scan
// with that carry folded into the warp's top run gives every thread its true
// carry; then the thread re-runs its run and writes each h. Across tiles the
// tile values, carry 0 into each, are themselves a polynomial in y = x^T (T
// the tile's length, written by the first launch), so the carries into the
// tiles are a Horner division of the tile values by (Y - y): the same kernel
// again. The carry in sits at position n as one more coefficient.
//
// Bound on the H100: field_scan moves N words in and N out an element (a
// column: out only) and does about 2 operations an element (the fold and
// the carry); fr_horner reads f once and writes q once (N = 8 words each)
// and does 2 products and 2 adds a coefficient a point. At the main path's
// 2^15 - 2^20 elements a launch is ~1-20 us of work: what the design cuts is
// the count of launches and whole-array temporaries, not the arithmetic.
// Every partial result is canonical, so any schedule gives the same words.

#pragma once

#include <cuda_runtime.h>

#include "field.cuh"

namespace kzg {

constexpr int kScanThreads = 256;                       // threads a block
constexpr int kScanRun = 4;                             // elements a thread
constexpr int kScanTile = kScanThreads * kScanRun;      // elements a block
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanOpAdd = 0;  // the op codes of the K1 interface
constexpr int kScanOpMul = 2;
static_assert((kScanRun & (kScanRun - 1)) == 0, "x^m by squarings needs m a power of two");
static_assert((kScanWarps & (kScanWarps - 1)) == 0, "x^T by squarings needs T a power of two");

// shared-memory slot of tile element j: one pad word every 32 elements
__host__ __device__ constexpr int scan_slot(int j) { return j + j / 32; }
constexpr int kScanSlots = scan_slot(kScanTile);  // words a plane

template <class F>
constexpr size_t scan_smem_bytes() {
  return sizeof(uint32_t) * F::N * kScanSlots;  // Fr 33,792 B, Fp 50,688 B
}

template <class F>
__device__ __forceinline__ Fe<F> tile_get(const uint32_t* tile, int j) {
  Fe<F> r;
#pragma unroll
  for (int l = 0; l < F::N; l++) r.w[l] = tile[l * kScanSlots + scan_slot(j)];
  return r;
}

template <class F>
__device__ __forceinline__ void tile_put(uint32_t* tile, int j, const Fe<F>& x) {
#pragma unroll
  for (int l = 0; l < F::N; l++) tile[l * kScanSlots + scan_slot(j)] = x.w[l];
}

template <class F>
__device__ __forceinline__ Fe<F> fe_shfl_up(const Fe<F>& a, int d) {
  Fe<F> r;
#pragma unroll
  for (int l = 0; l < F::N; l++) r.w[l] = __shfl_up_sync(0xffffffffu, a.w[l], d);
  return r;
}

template <class F>
__device__ __forceinline__ Fe<F> fe_shfl_down(const Fe<F>& a, int d) {
  Fe<F> r;
#pragma unroll
  for (int l = 0; l < F::N; l++) r.w[l] = __shfl_down_sync(0xffffffffu, a.w[l], d);
  return r;
}

template <class F, int OP>
__device__ __forceinline__ Fe<F> scan_op(const Fe<F>& a, const Fe<F>& b) {
  return OP == kScanOpMul ? fe_mul<F>(a, b) : fe_add<F>(a, b);
}

template <class F, int OP>
__device__ __forceinline__ Fe<F> scan_identity() {
  return OP == kScanOpMul ? fe_one<F>() : fe_zero<F>();
}

// The flags of a scan (the kernel's `flags` and the C entry's):
constexpr int kScanReverse = 1;    // scan from the last element down
constexpr int kScanPair = 2;       // rows [0, h) forward and [h, 2h) reversed, both of input row
                                   // r mod h, out (2, N, h, n): a prefix and a suffix at once
constexpr int kScanExclusive = 4;  // out[p] folds the elements before p (the identity at p = 0)

// Inclusive (or exclusive) scan of `op` along the last axis. Element
// (row, logical p) is read at in[l ws + r rs + p' es], p' = p (forward) or
// n - 1 - p (reverse), r the input row: es = 1 for an array, es = 0 for a
// column broadcast along n. Modes, by the pointers given:
//   totals != null: write each tile's fold to totals (N, rows, tiles);
//   out != null:    write the scan to out (N, rows, n) (kScanPair:
//                   (2, N, rows / 2, n)), each tile g > 0 starting from
//                   carry[g - 1] (carry (N, rows, tiles): the inclusive
//                   scan of the tile totals) when carry != null.
template <class F, int OP>
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ in, long long ws,
            long long rs, long long es, uint32_t* __restrict__ totals,
            const uint32_t* __restrict__ carry, long long n, int flags) {
  extern __shared__ uint32_t tile[];
  __shared__ uint32_t warp_tot[kScanWarps][F::N];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long g = blockIdx.x, tiles = gridDim.x;
  const long long row = blockIdx.y, rows = gridDim.y;
  const long long base = g * kScanTile;
  // the pair's second half runs its input row reversed
  const long long half = (flags & kScanPair) ? rows / 2 : rows;
  const bool second = row >= half;
  const long long irow = second ? row - half : row;
  const bool reverse = (flags & kScanPair) ? second : (flags & kScanReverse) != 0;
  for (int l = 0; l < F::N; l++) {
    const Fe<F> id = scan_identity<F, OP>();
    for (int j = t; j < kScanTile; j += kScanThreads) {
      const long long p = base + j;
      uint32_t v = id.w[l];
      if (p < n) v = in[l * ws + irow * rs + (reverse ? n - 1 - p : p) * es];
      tile[l * kScanSlots + scan_slot(j)] = v;
    }
  }
  __syncthreads();

  // the thread's run, folded in registers; its local prefixes back in place
  Fe<F> acc = tile_get<F>(tile, t * kScanRun);
#pragma unroll
  for (int k = 1; k < kScanRun; k++) {
    acc = scan_op<F, OP>(acc, tile_get<F>(tile, t * kScanRun + k));
    tile_put<F>(tile, t * kScanRun + k, acc);
  }
  // run totals: inclusive across the warp by shuffles
  Fe<F> s = acc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Fe<F> o = fe_shfl_up<F>(s, d);
    if (lane >= d) s = scan_op<F, OP>(o, s);
  }
  if (lane == 31) {
#pragma unroll
    for (int l = 0; l < F::N; l++) warp_tot[warp][l] = s.w[l];
  }
  __syncthreads();
  // the carry into this thread's warp: the tile's carry, then the warps below
  Fe<F> pre = scan_identity<F, OP>();
  if (carry != nullptr && g > 0) {
#pragma unroll
    for (int l = 0; l < F::N; l++) pre.w[l] = carry[(l * rows + row) * tiles + g - 1];
  }
  for (int w = 0; w < warp; w++) {
    Fe<F> wt;
#pragma unroll
    for (int l = 0; l < F::N; l++) wt.w[l] = warp_tot[w][l];
    pre = scan_op<F, OP>(pre, wt);
  }
  if (totals != nullptr) {
    if (t == kScanThreads - 1) {
      const Fe<F> tot = scan_op<F, OP>(pre, s);
#pragma unroll
      for (int l = 0; l < F::N; l++) totals[(l * rows + row) * tiles + g] = tot.w[l];
    }
    return;
  }
  // the thread's exclusive prefix, applied to its run's local prefixes
  // (exclusive: to the local prefix one below, high to low, e itself at 0)
  const Fe<F> below = fe_shfl_up<F>(s, 1);
  const Fe<F> e = lane == 0 ? pre : scan_op<F, OP>(pre, below);
  if (flags & kScanExclusive) {
#pragma unroll
    for (int k = kScanRun - 1; k > 0; k--)
      tile_put<F>(tile, t * kScanRun + k,
                  scan_op<F, OP>(e, tile_get<F>(tile, t * kScanRun + k - 1)));
    tile_put<F>(tile, t * kScanRun, e);
  } else {
#pragma unroll
    for (int k = 0; k < kScanRun; k++)
      tile_put<F>(tile, t * kScanRun + k,
                  scan_op<F, OP>(e, tile_get<F>(tile, t * kScanRun + k)));
  }
  __syncthreads();
  // out as (halves, N, half, n): one half, (N, rows, n), unless a pair
  uint32_t* const dst = out + (second ? (long long)F::N * half * n : 0) + irow * n;
  for (int l = 0; l < F::N; l++) {
    for (int j = t; j < kScanTile; j += kScanThreads) {
      const long long p = base + j;
      if (p < n)
        dst[l * half * n + (reverse ? n - 1 - p : p)] = tile[l * kScanSlots + scan_slot(j)];
    }
  }
}

// Horner's rule along n for rows = k points, over Fr. Coefficient (row, p)
// is f[l fws + row frs + p] for p < n (frs = 0: one polynomial for every
// point), cin[l k + row] at p = n when cin != null, zero above. Modes:
//   totals != null: write each tile's value with carry 0 into it to totals
//                   (8, k, tiles), and x^kScanTile to xpow (8, k) if given;
//   otherwise:      run each tile g from its carry (tile_carry[g] when
//                   g < tiles - 1, the division of the tile values by
//                   (Y - x^kScanTile); zero for the top tile) and write
//                   h_p to q[p - 1] (q (8, k, n - 1)) for 1 <= p < n and
//                   h_0 to rem (8, k), each if given.
__device__ __forceinline__ Fe<Fr> horner_step(const Fe<Fr>& f, const Fe<Fr>& x,
                                              const Fe<Fr>& c) {
  return fe_add<Fr>(f, fe_mul<Fr>(x, c));
}

// inclusive warp scan from the top lane down: lane t ends with the value of
// runs t .. 31 (carry 0 above run 31); xm = x^kScanRun; returns x^(32 m)
__device__ __forceinline__ Fe<Fr> horner_warp_scan(Fe<Fr>& s, Fe<Fr> xd, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Fe<Fr> o = fe_shfl_down<Fr>(s, d);
    if (lane + d < 32) s = horner_step(s, xd, o);
    xd = fe_sqr<Fr>(xd);
  }
  return xd;
}

__global__ void __launch_bounds__(kScanThreads)
horner_kernel(uint32_t* __restrict__ q, uint32_t* __restrict__ rem,
              uint32_t* __restrict__ totals, uint32_t* __restrict__ xpow,
              const uint32_t* __restrict__ f, long long fws, long long frs,
              const uint32_t* __restrict__ x, const uint32_t* __restrict__ cin,
              const uint32_t* __restrict__ tile_carry, long long n) {
  extern __shared__ uint32_t tile[];
  __shared__ uint32_t warp_val[kScanWarps][Fr::N];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long g = blockIdx.x, tiles = gridDim.x;
  const long long row = blockIdx.y, k = gridDim.y;
  const long long base = g * kScanTile;
  for (int l = 0; l < Fr::N; l++) {
    for (int j = t; j < kScanTile; j += kScanThreads) {
      const long long p = base + j;
      uint32_t v = 0u;
      if (p < n) {
        v = f[l * fws + row * frs + p];
      } else if (p == n && cin != nullptr) {
        v = cin[l * k + row];
      }
      tile[l * kScanSlots + scan_slot(j)] = v;
    }
  }
  Fe<Fr> xv;
#pragma unroll
  for (int l = 0; l < Fr::N; l++) xv.w[l] = x[l * k + row];
  Fe<Fr> xm = xv;
#pragma unroll
  for (int m = 1; m < kScanRun; m <<= 1) xm = fe_sqr<Fr>(xm);
  __syncthreads();

  // the run's value with carry 0, high to low
  const int r0 = t * kScanRun;
  Fe<Fr> v = tile_get<Fr>(tile, r0 + kScanRun - 1);
#pragma unroll
  for (int j = kScanRun - 2; j >= 0; j--) v = horner_step(tile_get<Fr>(tile, r0 + j), xv, v);
  Fe<Fr> s = v;
  const Fe<Fr> x32m = horner_warp_scan(s, xm, lane);
  if (lane == 0) {
#pragma unroll
    for (int l = 0; l < Fr::N; l++) warp_val[warp][l] = s.w[l];
  }
  __syncthreads();
  // the carry into this warp, down from the tile's carry through the warps above
  Fe<Fr> c = fe_zero<Fr>();
  if (totals == nullptr && g < tiles - 1) {
#pragma unroll
    for (int l = 0; l < Fr::N; l++) c.w[l] = tile_carry[(l * k + row) * (tiles - 1) + g];
  }
  for (int w = kScanWarps - 1; w > warp; w--) {
    Fe<Fr> wv;
#pragma unroll
    for (int l = 0; l < Fr::N; l++) wv.w[l] = warp_val[w][l];
    c = horner_step(wv, x32m, c);
  }
  if (totals != nullptr) {
    if (t == 0) {
      const Fe<Fr> tot = horner_step(s, x32m, c);  // warp 0 below the warps above
#pragma unroll
      for (int l = 0; l < Fr::N; l++) totals[(l * k + row) * tiles + g] = tot.w[l];
      if (xpow != nullptr && g == 0) {
        Fe<Fr> xt = x32m;
#pragma unroll
        for (int w = 1; w < kScanWarps; w <<= 1) xt = fe_sqr<Fr>(xt);
#pragma unroll
        for (int l = 0; l < Fr::N; l++) xpow[l * k + row] = xt.w[l];
      }
    }
    return;
  }
  // again with the warp's carry folded into its top run: the true carries
  s = lane == 31 ? horner_step(v, xm, c) : v;
  horner_warp_scan(s, xm, lane);
  const Fe<Fr> above = fe_shfl_down<Fr>(s, 1);
  Fe<Fr> h = lane == 31 ? c : above;
#pragma unroll
  for (int j = kScanRun - 1; j >= 0; j--) {
    h = horner_step(tile_get<Fr>(tile, r0 + j), xv, h);
    tile_put<Fr>(tile, r0 + j, h);
  }
  __syncthreads();
  for (int l = 0; l < Fr::N; l++) {
    for (int j = t; j < kScanTile; j += kScanThreads) {
      const long long p = base + j;
      const uint32_t w = tile[l * kScanSlots + scan_slot(j)];
      if (p >= 1 && p < n && q != nullptr) q[(l * k + row) * (n - 1) + p - 1] = w;
      if (p == 0 && rem != nullptr) rem[l * k + row] = w;
    }
  }
}

}  // namespace kzg
