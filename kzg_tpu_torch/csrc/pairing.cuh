// The pairing check in two launches: the optimal ate Miller loop
// (`miller_loop`) and the final exponentiation (`final_exp`) over
// BLS12-381, on the 16-lane engine of K4 and the digit ladder (coop.cuh).
//
// Replaces no Pallas kernel: the reference's `miller_loop_device` is one
// `lax.scan` of tower code (kzg_tpu/pairing/pairing.py:109-160) and its
// final exponentiation one jitted program (:163-170), both K1 chains on
// the TPU. Run as the port's tensor code (pairing/tower.py), one check was
// ~20,700 launches of 12-108 Fp elements each, the device idle 0.90 of the
// time between them.
//
// Bound: the latency of each block's chain of dependent products. A Miller
// step is one Fp inverse, the Fermat chain of 381 dependent 16-lane
// products, plus ~40 more products and the add / sub steps between them
// on its critical path; 68 steps a pair. The final exponentiation is one
// inverse and 380 bits of a joint ladder, each a cyclotomic squaring and
// (where the bit column is not 0) an Fp12 product. The whole check is
// ~170,000 Fp products: not a bound at the card's product rate.
//
// Design: one block a pair (`miller_loop`, 32 warps) or an output
// (`final_exp`, 16 warps; Prog::kWarps, from schedule.MILLER_WARPS and
// FINAL_WARPS). Every value lives in a shared-memory slot of 16 words, one
// word a lane (f, T, P, Q, the subset table, the temporaries). The work is
// programs of Fp operations that kzg_tpu_torch/pairing/schedule.py
// generates (pairing_schedule.cuh) from the formulas of pairing/tower.py:
// stages of chains, half-warp h running chain h of a stage, each product,
// add and sub spread over its 16 lanes (coop.cuh, each half under its own
// mask, so the two halves of a warp run different chains), a block barrier
// between stages. An inverse is a stage of its own: warp 0 runs the Fermat
// chain of `field_pow` (field_kernels.cu), acc * base and base^2 on its two
// halves a step. The control flow
// between programs (the bits of |x|, the lanes of the product, the bit
// columns of the hard exponent) reads only constants and bytes every thread
// reads alike, so every thread takes the same way. Every value is
// canonical in [0, p): the results equal the plain twins
// (pairing.miller_loop_plain, final_exp_plain) word for word.

#pragma once

#include <cuda_runtime.h>

#include "coop.cuh"
#include "pairing_schedule.cuh"

namespace {

using kzg::CoopLane;
using kzg::Fp;

constexpr int kPairWords = 16;  // words of a slot
constexpr unsigned kOpMul = 0u, kOpAdd = 1u, kOpSub = 2u, kOpInv = 3u;

// slot dst = slot src ^ (p - 2) by warp 0 (lane 0-31): LSB first, half 0
// forms acc * base and half 1 base^2 each step; acc and base double-buffered
// in the four slots at Prog::kINV. inv(0) = 0.
template <class Prog>
__device__ __forceinline__ void fermat_inverse(uint32_t* sm, int dst, int src, int lane) {
  const CoopLane<Fp> L(lane, kzg::kCoopPairMask);
  const int half = lane >> 4;
  uint32_t* buf = sm + kPairWords * Prog::kINV;  // [buffer][acc, base][word]
  buf[kPairWords * half + L.j] =
      half ? sm[kPairWords * src + L.j] : (L.j < Fp::N ? Fp::one(L.j) : 0u);
  __syncwarp();
  int cur = 0;
#pragma unroll 1
  for (int s = 0; s < kFermatBits; s++) {
    const uint32_t* acc = buf + 2 * kPairWords * cur;
    const uint32_t* base = acc + kPairWords;
    const uint32_t r = kzg::coop_mul<Fp>(L, half ? base : acc, base);
    const uint32_t e = Fp::mod(s >> 5) - (s < 32 ? 2u : 0u);  // word s / 32 of p - 2
    const bool bit = (e >> (s & 31)) & 1u;
    buf[2 * kPairWords * (cur ^ 1) + kPairWords * half + L.j] = (half || bit) ? r : acc[L.j];
    cur ^= 1;
    __syncwarp();
  }
  if (half == 0) sm[kPairWords * dst + L.j] = buf[2 * kPairWords * cur + L.j];
}

// Program g of Prog on the block's slots; every thread calls it. Half-warp
// h runs chain h of a stage under its own mask: the two halves of a warp
// run different chains, and a sub's correction step branches on its own
// half's borrow.
template <class Prog>
__device__ __forceinline__ void run_program(uint32_t* sm, int g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, hw = threadIdx.x >> 4;
  const CoopLane<Fp> L(lane, kzg::coop_half_mask(lane));
  const int end = Prog::program(g + 1);
#pragma unroll 1
  for (int st = Prog::program(g); st < end; st++) {
    const int c0 = Prog::stage(st), c1 = Prog::stage(st + 1);
    const unsigned long long first = Prog::op(Prog::chain(c0));
    if ((first & 0xffffu) == kOpInv) {
      if (warp == 0)
        fermat_inverse<Prog>(sm, (int)((first >> 16) & 0xffffu), (int)((first >> 32) & 0xffffu),
                             lane);
    } else if (c0 + hw < c1) {
      const int o1 = Prog::chain(c0 + hw + 1);
#pragma unroll 1
      for (int o = Prog::chain(c0 + hw); o < o1; o++) {
        const unsigned long long op = Prog::op(o);
        const uint32_t kind = (uint32_t)op & 0xffffu;
        const uint32_t* a = sm + kPairWords * ((op >> 32) & 0xffffu);
        const uint32_t* b = sm + kPairWords * (op >> 48);
        uint32_t r;
        if (kind == kOpMul) {
          r = kzg::coop_mul<Fp>(L, a, b);
        } else if (kind == kOpAdd) {
          r = kzg::coop_add<Fp>(L, a[L.j], b[L.j]);
        } else {
          r = kzg::coop_sub<Fp>(L, a[L.j], b[L.j]);
        }
        sm[kPairWords * ((op >> 16) & 0xffffu) + L.j] = r;
        __syncwarp(L.mask);  // the half's next operation reads every word
      }
    }
    __syncthreads();
  }
}

// every slot zero, then the constants ((12, kConsts) words) into theirs
template <class Prog>
__device__ __forceinline__ void init_slots(uint32_t* sm, const uint32_t* __restrict__ consts) {
  for (int t = threadIdx.x; t < kPairWords * Prog::kSlots; t += blockDim.x) sm[t] = 0u;
  __syncthreads();
  for (int t = threadIdx.x; t < Fp::N * Prog::kConsts; t += blockDim.x) {
    const int c = t % Prog::kConsts, w = t / Prog::kConsts;
    sm[kPairWords * (Prog::kConst + c) + w] = consts[t];
  }
}

// the 12 slots at dst <- lane i of a (12, 12, n) batch (store: the other way)
template <bool kStore>
__device__ __forceinline__ void move_f12(uint32_t* sm, int dst, uint32_t* g, long long n,
                                         long long i) {
  for (int t = threadIdx.x; t < Fp::N * 12; t += blockDim.x) {
    const int k = t / Fp::N, w = t % Fp::N;  // component, word
    uint32_t* p = g + ((long long)w * 12 + k) * n + i;
    if (kStore) {
      *p = sm[kPairWords * (dst + k) + w];
    } else {
      sm[kPairWords * (dst + k) + w] = *p;
    }
  }
}

// Fp12 one into the 12 slots at dst (slot words above Fp::N stay zero)
__device__ __forceinline__ void set_one(uint32_t* sm, int dst) {
  for (int t = threadIdx.x; t < Fp::N * 12; t += blockDim.x) {
    const int k = t / Fp::N, w = t % Fp::N;
    sm[kPairWords * (dst + k) + w] = k == 0 ? Fp::one(w) : 0u;
  }
}

__device__ __forceinline__ void copy_f12(uint32_t* sm, int dst, int src) {
  for (int t = threadIdx.x; t < kPairWords * 12; t += blockDim.x)
    sm[kPairWords * dst + t] = sm[kPairWords * src + t];
}

// One block a pair: f_{|x|,Q}(P) conjugated, (12, 12, n) words; Fp12 one
// where skip[i] (P or Q infinite) is set.
template <class Prog>
__global__ void __launch_bounds__(32 * Prog::kWarps)
miller_loop_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ xp,
                   const uint32_t* __restrict__ yp, const uint32_t* __restrict__ xq,
                   const uint32_t* __restrict__ yq, const uint8_t* __restrict__ skip,
                   const uint32_t* __restrict__ consts, long long n) {
  __shared__ uint32_t sm[kPairWords * Prog::kSlots];
  const long long i = blockIdx.x;
  if (skip != nullptr && skip[i]) {  // the reference's select: the lane contributes 1
    set_one(sm, Prog::kF);
    __syncthreads();
    move_f12<true>(sm, Prog::kF, out, n, i);
    return;
  }
  init_slots<Prog>(sm, consts);
  for (int t = threadIdx.x; t < 6 * Fp::N; t += blockDim.x) {
    const int k = t / Fp::N, w = t % Fp::N;  // xp, yp, xq.c0, xq.c1, yq.c0, yq.c1
    const uint32_t v = k == 0   ? xp[w * n + i]
                       : k == 1 ? yp[w * n + i]
                       : k < 4  ? xq[(2LL * w + k - 2) * n + i]
                                : yq[(2LL * w + k - 4) * n + i];
    sm[kPairWords * (k == 0 ? Prog::kXP : k == 1 ? Prog::kYP : Prog::kQ + k - 2) + w] = v;
  }
  __syncthreads();
  run_program<Prog>(sm, Prog::kProgInit);
#pragma unroll 1
  for (int b = kMillerLoopBits - 2; b >= 0; b--) {
    run_program<Prog>(sm, Prog::kProgTangent);
    if ((kMillerLoop >> b) & 1ull) run_program<Prog>(sm, Prog::kProgChord);
  }
  run_program<Prog>(sm, Prog::kProgConj);
  move_f12<true>(sm, Prog::kF, out, n, i);
}

// f^((p^12 - 1) / r). product != 0: one block multiplies the lanes of f
// not under skip (Fp12 one if none) and exponentiates the product into out
// column 0; else block i exponentiates lane i into column i. cols: the
// joint ladder's ncols bit columns of the hard exponent's base-p digits,
// MSB first, each a mask of the four Frobenius powers.
template <class Prog>
__global__ void __launch_bounds__(32 * Prog::kWarps)
final_exp_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ f,
                 const uint8_t* __restrict__ skip, const uint8_t* __restrict__ cols, int ncols,
                 const uint32_t* __restrict__ consts, long long n, int product) {
  __shared__ uint32_t sm[kPairWords * Prog::kSlots];
  init_slots<Prog>(sm, consts);
  uint32_t* fg = const_cast<uint32_t*>(f);
  if (product) {
    set_one(sm, Prog::kACC);
    __syncthreads();
    bool first = true;
#pragma unroll 1
    for (long long j = 0; j < n; j++) {
      if (skip != nullptr && skip[j]) continue;
      move_f12<false>(sm, first ? Prog::kACC : Prog::kX, fg, n, j);
      __syncthreads();
      if (!first) run_program<Prog>(sm, Prog::kProgMul);
      first = false;
    }
  } else {
    move_f12<false>(sm, Prog::kACC, fg, n, blockIdx.x);
    __syncthreads();
  }
  run_program<Prog>(sm, Prog::kProgEasy);  // into T[1]
  run_program<Prog>(sm, Prog::kProgTable);
  copy_f12(sm, Prog::kACC, Prog::kT + 12 * (cols[0] - 1));
  __syncthreads();
#pragma unroll 1
  for (int j = 1; j < ncols; j++) {
    const int m = cols[j];
    if (m) {
      copy_f12(sm, Prog::kX, Prog::kT + 12 * (m - 1));
      __syncthreads();
      run_program<Prog>(sm, Prog::kProgCycMul);
    } else {
      run_program<Prog>(sm, Prog::kProgCyc);
    }
  }
  move_f12<true>(sm, Prog::kACC, out, product ? 1 : n, product ? 0 : blockIdx.x);
}

}  // namespace
