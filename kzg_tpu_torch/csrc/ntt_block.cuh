// Kernel K5 as a block transform, `ntt_block`: one launch runs whole
// m-point NTTs over Montgomery Fr in shared memory.
//
// Replaces `make_ntt_stage` (kzg_tpu/fields/pallas_field.py:346), the one
// stage (u, v) = (a + b, (a - b) w) that the JAX package's Pease loop and
// four-step passes launch log2 m times a transform, together with what ran
// around those stages as launches of their own: the bit-reversal gather, the
// 1/d scale, the coset multiply and the four-step twiddle multiply
// (kzg_tpu/ntt/domain.py:247-300, 354-430). The function is the NTT, not
// the stage: every decomposition of the DFT gives the same canonical
// Montgomery words, so the outputs equal the reference's.
//
// Data. x is (8, nb, m, bt) int32 words, word-major (word l of element i at
// l * plane + i): nb x bt columns, each an m-point transform along axis 2.
// A column's flat index is q = b * bt + c. The output may have another
// column stride (out_bt): column q's row r lands at
// ((q / out_bt) * m + r) * out_bt + q % out_bt, which folds the four-step
// transpose into the second pass's stores (ntt/domain.py).
//
// One block a tile of `cols` consecutive columns of one m-point transform
// each, m = 2^log_m, cols * m <= 2^kNttTileExp elements:
//   1. load: each thread reads whole elements, its warp 32 neighbouring
//      words of one plane (bt = 1: the tile is one contiguous run; bt > 1:
//      runs of `cols` words a row), optionally multiplies each by the
//      `pre` scale, and stores it into shared memory. Shared memory holds
//      two 16-byte planes, words 0-3 and words 4-7 of each element, so
//      neighbouring threads touch neighbouring 16-byte slots;
//   2. every DIF stage in place, half-size h = m/2 .. 1: butterfly (i, i+h),
//      u = a + b, v = (a - b) w, w = tw[h + (i mod h)] from the
//      stage-concatenated table (tw[h + j] = omega_m^(j m / 2h), m entries,
//      element-major), by `kTw`:
//        kNttTwGlobal: read from device memory through the read-only cache
//          (the butterflies of a warp read neighbouring entries, so the reads
//          coalesce at every stage);
//        kNttTwStage: the whole table staged into shared memory once a block
//          (m entries beside the tile: fits while m + tile <= 7,264 elements);
//        kNttTwHalf: only its last m/2 entries, the sub-domain's half table
//          omega_m^j, staged once a block and read at stride m / 2h;
//      `bench.ntt` times the three (PERF.md), the library's entry runs the
//      one `kNttTw` names;
//   3. store in natural order: row r reads slot bitrev(r) (the permutation
//      stays in shared memory, the device-memory stores stay coalesced),
//      optionally multiplies by the `post` scale, and writes out.
// A scale is a per-element factor: a constant, or base^e from two tables,
// hi[e >> s] * lo[e & (2^s - 1)] (lo[e] alone when hi is null), with
// e = r * bt + c (linear: the coset powers, with 1/d folded into the table)
// or e = r * (c / div) (product: the four-step twiddle W[k2, j1]).
//
// Bound on the H100: the (m/2) log2 m butterfly products, 2 * 8^2 + 8
// 32-bit multiply-adds each, plus one or two a scaled element; the bytes
// are one read and one write of the array a pass. Compute is about 5x the
// bytes at 2^20 (two passes), so the design keeps the array in shared
// memory across all of a pass's stages and spends no launch on a
// permutation or a scale. Blocks run `threads` (<= 1024) threads, 64
// registers each at most. The last stage's twiddle is 1, so its
// butterflies skip the product.
//
// The tile's columns past nb * bt (a ragged last tile) are computed on
// whatever shared memory holds and never stored.

#pragma once

#include <cuda_runtime.h>

#include "field.cuh"

namespace kzg {

constexpr int kNttTileExp = 12;  // elements a tile, log2: 128 KB of shared memory
constexpr int kNttMaxThreads = 1024;  // 64 registers a thread at most
constexpr int kNttScaleNone = 0, kNttScaleConst = 1, kNttScaleLinear = 2,
              kNttScaleProduct = 3;
constexpr int kNttTwGlobal = 0, kNttTwStage = 1, kNttTwHalf = 2;
constexpr int kNttTw = kNttTwGlobal;  // the library's twiddle source (bench.ntt, PERF.md)
constexpr int kNttMaxSmem = 227 * 1024;  // dynamic shared memory a block, at most

struct NttScale {
  const uint32_t* hi;  // (len, 8) element-major, or null
  const uint32_t* lo;  // (len, 8) element-major
  int mode;            // kNttScale*
  int s;               // e -> hi[e >> s] * lo[e & (2^s - 1)]
  long long div;       // product mode: e = r * (c / div)
};

// element i of an element-major (len, 8) table: two 16-byte loads
__device__ __forceinline__ Fe<Fr> ntt_table(const uint32_t* __restrict__ t, long long i) {
  const uint4* p = reinterpret_cast<const uint4*>(t) + 2 * i;
  const uint4 a = __ldg(p), b = __ldg(p + 1);
  return Fe<Fr>{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

// v times the scale's factor at row r, column c (c within the transform)
__device__ __forceinline__ Fe<Fr> ntt_scaled(const Fe<Fr>& v, const NttScale& sc, long long r,
                                             long long c, long long bt) {
  if (sc.mode == kNttScaleNone) return v;
  if (sc.mode == kNttScaleConst) return fe_mul<Fr>(v, ntt_table(sc.lo, 0));
  const long long e = sc.mode == kNttScaleLinear ? r * bt + c : r * (c / sc.div);
  if (sc.hi == nullptr) return fe_mul<Fr>(v, ntt_table(sc.lo, e));
  const Fe<Fr> f = fe_mul<Fr>(ntt_table(sc.hi, e >> sc.s),
                              ntt_table(sc.lo, e & ((1LL << sc.s) - 1)));
  return fe_mul<Fr>(v, f);
}

__device__ __forceinline__ Fe<Fr> ntt_smem_load(const uint4* s, int e, int pos) {
  const uint4 a = s[pos], b = s[e + pos];
  return Fe<Fr>{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void ntt_smem_store(uint4* s, int e, int pos, const Fe<Fr>& v) {
  s[pos] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  s[e + pos] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
}

// the tile's idx-th element in the order of device memory: (column in the
// tile, row); bt == 1 keeps each column's rows together, else a row's
// columns are neighbours
__device__ __forceinline__ void ntt_tile_coord(int idx, int log_m, int log_cols, long long bt,
                                               int& g, int& r) {
  if (bt == 1) {
    g = idx >> log_m;
    r = idx & ((1 << log_m) - 1);
  } else {
    g = idx & ((1 << log_cols) - 1);
    r = idx >> log_cols;
  }
}

// shared-memory slots (16 bytes) of the staged twiddles: m, m / 2 or none
__host__ __device__ constexpr int ntt_tw_slots(int tw_mode, int m) {
  return tw_mode == kNttTwStage ? m : tw_mode == kNttTwHalf ? m / 2 : 0;
}

template <int kTw>
__global__ void __launch_bounds__(kNttMaxThreads)
ntt_block_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ x,
                 const uint32_t* __restrict__ tw, long long ncol, int log_m, long long bt,
                 long long out_bt, int log_cols, NttScale pre, NttScale post) {
  extern __shared__ uint4 ntt_smem[];
  const int m = 1 << log_m;
  const int e = m << log_cols;  // elements in the tile
  const long long plane = ncol << log_m;
  const long long q0 = (long long)blockIdx.x << log_cols;
  uint4* tws = ntt_smem + 2 * e;  // the staged twiddles, two planes of tw_len
  const int tw_len = ntt_tw_slots(kTw, m);
  for (int i = threadIdx.x; i < tw_len; i += blockDim.x)
    ntt_smem_store(tws, tw_len, i, ntt_table(tw, m - tw_len + i));

  for (int idx = threadIdx.x; idx < e; idx += blockDim.x) {
    int g, r;
    ntt_tile_coord(idx, log_m, log_cols, bt, g, r);
    const long long q = q0 + g;
    if (q >= ncol) continue;
    const long long b = q / bt, c = q - b * bt;
    const Fe<Fr> v = fe_load<Fr>(x, plane, (b * m + r) * bt + c);
    ntt_smem_store(ntt_smem, e, g * m + r, ntt_scaled(v, pre, r, c, bt));
  }
  __syncthreads();

  const int half = e >> 1;
  for (int log_h = log_m - 1; log_h >= 0; log_h--) {
    const int h = 1 << log_h;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int g = k >> (log_m - 1);
      const int kk = k & ((m >> 1) - 1);
      const int j = kk & (h - 1);
      const int pa = g * m + ((kk - j) << 1) + j;
      const Fe<Fr> a = ntt_smem_load(ntt_smem, e, pa);
      const Fe<Fr> bb = ntt_smem_load(ntt_smem, e, pa + h);
      // the last stage's is omega^0 = 1: not applied
      const Fe<Fr> w = kTw == kNttTwGlobal ? ntt_table(tw, h + j)
                       : kTw == kNttTwStage ? ntt_smem_load(tws, tw_len, h + j)
                                            : ntt_smem_load(tws, tw_len, j << (log_m - 1 - log_h));
      ntt_smem_store(ntt_smem, e, pa, fe_add<Fr>(a, bb));
      const Fe<Fr> d = fe_sub<Fr>(a, bb);
      ntt_smem_store(ntt_smem, e, pa + h, log_h == 0 ? d : fe_mul<Fr>(d, w));
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < e; idx += blockDim.x) {
    int g, r;
    ntt_tile_coord(idx, log_m, log_cols, out_bt, g, r);
    const long long q = q0 + g;
    if (q >= ncol) continue;
    const long long b = q / out_bt, c = q - b * out_bt;
    const int rev = (int)(__brev((unsigned)r) >> (32 - log_m));
    const Fe<Fr> v = ntt_smem_load(ntt_smem, e, g * m + rev);
    fe_store<Fr>(out, plane, (b * m + r) * out_bt + c, ntt_scaled(v, post, r, c, out_bt));
  }
}

// Checks the arguments and launches ntt_block_kernel<kTw> on `stream`
// (the C entry's arguments: csrc/ntt_kernels.cu); returns the launch's
// status. A block's dynamic shared memory above 48 KB must be allowed for
// each device and each module that holds the kernel (the library, the
// bench's variant build): the attribute is set before every such launch,
// on the current device, which costs no more than the launch itself and
// needs no flag shared between threads, devices or modules.
template <int kTw>
int launch_ntt_block(void* out, const void* x, const void* tw, long long ncol, int log_m,
                     long long bt, long long out_bt, int log_cols, int threads, NttScale pre,
                     NttScale post, void* stream) {
  const auto bad_scale = [](const NttScale& sc) {
    return sc.mode < kNttScaleNone || sc.mode > kNttScaleProduct || (sc.mode && !sc.lo) ||
           sc.div < 1;
  };
  if (ncol <= 0 || log_m < 1 || log_cols < 0 || log_m + log_cols > kNttTileExp || bt < 1 ||
      out_bt < 1 || ncol % bt || ncol % out_bt || threads < 32 || threads > kNttMaxThreads ||
      threads % 32 || bad_scale(pre) || bad_scale(post))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(uint4) * 2 * (((size_t)1 << (log_m + log_cols)) + ntt_tw_slots(kTw, 1 << log_m));
  if (smem > (size_t)kNttMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        ntt_block_kernel<kTw>, cudaFuncAttributeMaxDynamicSharedMemorySize, kNttMaxSmem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const long long blocks = (ncol + (1LL << log_cols) - 1) >> log_cols;
  ntt_block_kernel<kTw><<<(unsigned)blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(x),
      static_cast<const uint32_t*>(tw), ncol, log_m, bt, out_bt, log_cols, pre, post);
  return (int)cudaGetLastError();
}

}  // namespace kzg
