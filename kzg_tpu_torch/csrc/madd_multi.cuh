// Kernel K7's narrow mode: the bucket loop's fused step over G1 (Fp) and G2
// (Fp2), two lanes a block, each product over 16 lanes.
//
// Replaces `_PointKernels.madd_multi` (kzg_tpu/curve/pallas_ops.py:275, its
// step loop at :838-859) on the launches too narrow to fill the card: per
// lane, S skip-masked, optionally negated madd-2007-bl steps acc += q[s], in
// order, the accumulator kept on chip across the steps. `cuda_ops` sends a
// launch here while its lanes fit a few waves of this kernel, and to the
// one-thread kernel of point.cuh (the wide mode) above that.
//
// Bound: each lane's chain of S dependent mixed additions. At the bucket
// loop's widths (a few thousand sub-run lanes) the one-thread kernel leaves
// most SMs idle and runs the 11 products of a step one after another, each
// a 144-step serial CIOS, with the step's point read only after the last
// step's madd.
//
// Design: the digit ladder's engine (pair.cuh, horner.cuh, coop.cuh), two
// lanes a block, one a half-warp, the accumulator in the lane's shared
// slots for all S steps. Each step runs the madd program of
// horner_schedule.cuh: each level's products side by side, each product,
// add and sub over 16 lanes, so a step's critical path is
// `critical_products(prog, "madd")` products (5 over Fp, 7 over Fp2), not
// 11 (29). While step s runs, step s + 1's x and y words and both lanes'
// skip and neg bytes are copied into a second set of slots by cp.async
// (committed, and waited at the top of the next step). A step moves its
// point into (X2, Y2), y negated in the slot as 0 - y where neg is set (0
// stays 0), and tests Z in the same pass. The branches keep the twin's
// precedence per lane (CurveOps.madd): skip -> p; p infinite -> (x2, y2,
// 1); P == Q -> dbl(p); P == -Q -> (1, 1, 0). The madd stages run when
// either lane adds; they write only temporaries and (X3, Y3, Z3), which a
// lane takes where its own branch says so; the rare doubling runs on the
// half whose lane needs it. A block whose two lanes both skip a step does
// no product work for it. Every branch is read from bytes and votes that
// every thread sees, so the threads of a block take the same way.
//
// Every value is canonical, so the result equals the plain twin word for
// word, Jacobian coordinates included.

#pragma once

#include "pair.cuh"

namespace {

// 4 bytes from global memory into shared memory, asynchronously; `bytes`
// (1-4) are read, the rest of the word is zero-filled
__device__ __forceinline__ void cp_async4(void* dst, const void* src, uint32_t bytes = 4) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A lane's shared words: the program's slots, then the next step's x and y
// (kComp slots each), then 16 words of padding (pair.cuh).
template <class Prog>
struct MaddMultiSlots {
  static constexpr int kNextX = Prog::kSlots, kNextY = Prog::kSlots + Prog::kComp;
  static constexpr int kWords = lane_words<Prog>(Prog::kSlots + 2 * Prog::kComp);
  static_assert((Prog::kSlots + 2 * Prog::kComp) % 2 == 0, "the halves' slots share banks");
};

// Step s's point of block lanes i0 and i0 + 1 (those below n) -> the next
// slots, and the skip and neg bytes of both lanes -> masks[0..1] (skip) and
// masks[2..3] (neg): the two 32-bit words that hold bytes s n + i0 and
// s n + i0 + 1 of each (S, n) array, read only inside it. Every thread
// commits its copies as one group.
template <class Prog>
__device__ __forceinline__ void fetch_step(uint32_t* smem, uint32_t* masks, const uint32_t* qx,
                                           const uint32_t* qy, const uint8_t* skip,
                                           const uint8_t* neg, int s, int steps, long long n,
                                           long long i0) {
  using Slots = MaddMultiSlots<Prog>;
  constexpr int kE = Prog::kComp * Fp::N;  // words of one affine coordinate
  const long long total = (long long)steps * n, k = (long long)s * n + i0;
  for (int t = threadIdx.x; t < kLadderLanes * 2 * kE; t += blockDim.x) {
    const int h = t & 1, coord = (t >> 1) / kE, r = (t >> 1) % kE;  // r = w kComp + comp
    if (i0 + h >= n) continue;
    const uint32_t* g = (coord ? qy : qx) + (long long)r * total + k + h;
    cp_async4(smem + h * Slots::kWords +
                  kSlotWords * (Slots::kNextX + coord * Prog::kComp + r % Prog::kComp) +
                  r / Prog::kComp,
              g);
  }
  const int t = threadIdx.x - blockDim.x + 4;  // the last four threads: the mask words
  if (t >= 0 && (t < 2 || neg != nullptr)) {
    const long long start = (k & ~3ll) + 4 * (t & 1);
    const long long left = total - start;
    if (left > 0)
      cp_async4(masks + t, (t < 2 ? skip : neg) + start, left < 4 ? (uint32_t)left : 4u);
  }
  cp_async_commit();
}

// Per block lane h with live[h]: the fetched point -> (X2, Y2), y negated
// where neg[h] (p - y, 0 for 0; one thread a component, a 12-word borrow
// chain). Returns bit h set where lane h's Z is non-zero. One barrier.
template <class Prog>
__device__ __forceinline__ unsigned move_step(uint32_t* smem, const bool* live, const bool* neg,
                                              unsigned* votes) {
  using Slots = MaddMultiSlots<Prog>;
  constexpr int kC = Prog::kComp * kSlotWords;
  const int t0 = threadIdx.x;
  if (t0 < kLadderLanes * Prog::kComp && live[t0 / Prog::kComp]) {
    const int h = t0 / Prog::kComp, c = t0 % Prog::kComp;
    uint32_t* s = smem + h * Slots::kWords;
    const uint32_t* y = s + kSlotWords * (Slots::kNextY + c);
    uint32_t* d = s + kSlotWords * (Prog::kY2 + c);
    bool nz = false;
    for (int w = 0; w < Fp::N; w++) nz |= y[w] != 0u;
    if (neg[h] && nz) {
      uint32_t borrow = 0;
      for (int w = 0; w < Fp::N; w++) {
        const uint64_t v = (uint64_t)Fp::mod(w) - y[w] - borrow;
        d[w] = (uint32_t)v;
        borrow = (uint32_t)(v >> 63);
      }
    } else {
      for (int w = 0; w < Fp::N; w++) d[w] = y[w];
    }
  }
  unsigned bits = 0;
  for (int t = t0; t < kLadderLanes * kC; t += blockDim.x) {
    const int h = t / kC, e = t % kC;
    uint32_t* s = smem + h * Slots::kWords;
    if (live[h]) s[kSlotWords * Prog::kX2 + e] = s[kSlotWords * Slots::kNextX + e];
    if (s[kSlotWords * Prog::kZ + e] != 0u) bits |= 1u << h;
  }
  return block_or<Prog>(bits, votes);
}

// per block lane h with take[h]: (X, Y, Z) = (X2, Y2, 1), the sum with an
// infinite accumulator
template <class Prog>
__device__ __forceinline__ void take_points(uint32_t* smem, const bool* take) {
  using Slots = MaddMultiSlots<Prog>;
  constexpr int kC = Prog::kComp * kSlotWords;
  for (int t = threadIdx.x; t < kLadderLanes * 3 * kC; t += blockDim.x) {
    const int h = t / (3 * kC), e = t % (3 * kC);
    if (!take[h]) continue;
    uint32_t* s = smem + h * Slots::kWords;
    const int w = e % kSlotWords;
    s[kSlotWords * Prog::kX + e] = e < 2 * kC ? s[kSlotWords * Prog::kX2 + e]
                                   : (e == 2 * kC + w && w < Fp::N) ? Fp::one(w) : 0u;
  }
  __syncthreads();
}

// acc (12[, 2], n); qx / qy (12[, 2], steps, n), step-major; skip / neg
// (steps, n) bytes, non-zero: keep the lane / add -q = (x, -y), each at a
// 4-byte aligned address (fetch_step copies them a 32-bit word at a time);
// neg may be null (no step negated).
template <class Prog>
__global__ void __launch_bounds__(32 * Prog::kWarps, min_blocks<Prog>())
madd_multi_narrow_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                         uint32_t* __restrict__ oz, const uint32_t* __restrict__ ax,
                         const uint32_t* __restrict__ ay, const uint32_t* __restrict__ az,
                         const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
                         const uint8_t* __restrict__ skip, const uint8_t* __restrict__ neg,
                         int steps, long long n) {
  using Slots = MaddMultiSlots<Prog>;
  constexpr int kWords = Slots::kWords;
  __shared__ __align__(16) uint32_t smem[kLadderLanes * kWords];
  __shared__ uint32_t masks[2][4];  // a step's mask words, double-buffered by step parity
  __shared__ unsigned votes[Prog::kWarps];
  for (int t = threadIdx.x; t < kLadderLanes * kWords; t += blockDim.x) smem[t] = 0u;
  const long long i0 = (long long)blockIdx.x * kLadderLanes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = lane >> 4;  // the block lane this half-warp works on
  uint32_t* sm = smem + half * kWords;
  const CoopLane<Fp> L(lane, kzg::coop_half_mask(lane));
  __syncthreads();
  load_points<Prog>(smem, kWords, Prog::kX, ax, ay, az, n, i0);
  fetch_step<Prog>(smem, masks[0], qx, qy, skip, neg, 0, steps, n, i0);
  for (int s = 0; s < steps; s++) {
    cp_async_wait_all();
    __syncthreads();  // step s's point and masks, and the loaded accumulator, seen by all
    const uint8_t* mb = reinterpret_cast<const uint8_t*>(masks[s & 1]);
    const int b = (int)((((long long)s * n) + i0) & 3);  // byte of lane i0 in the words
    bool live[kLadderLanes], ng[kLadderLanes];
    for (int h = 0; h < kLadderLanes; h++) {
      live[h] = i0 + h < n && mb[b + h] == 0;
      ng[h] = neg != nullptr && mb[8 + b + h] != 0;
    }
    if (!live[0] && !live[1]) {  // the same in every thread: no product work
      if (s + 1 < steps) fetch_step<Prog>(smem, masks[(s + 1) & 1], qx, qy, skip, neg, s + 1,
                                          steps, n, i0);
      continue;
    }
    const unsigned z = move_step<Prog>(smem, live, ng, votes);
    if (s + 1 < steps)  // the next slots are free again: step s + 1 copies in behind this one
      fetch_step<Prog>(smem, masks[(s + 1) & 1], qx, qy, skip, neg, s + 1, steps, n, i0);
    bool madd[kLadderLanes], take[kLadderLanes];
    for (int h = 0; h < kLadderLanes; h++) {
      madd[h] = live[h] && ((z >> h) & 1u);
      take[h] = live[h] && !madd[h];  // infinity + Q = (x2, y2, 1)
    }
    if (take[0] || take[1]) take_points<Prog>(smem, take);
    if (!madd[0] && !madd[1]) continue;
    run_stages<Prog>(sm, L, warp, true, Prog::kAddEnd, Prog::kMaddEnd);
    bool sum[kLadderLanes], same[kLadderLanes], opposite[kLadderLanes];
    const unsigned hr = nonzero_bits<Prog>(smem, kWords, Prog::kH, Prog::kR, votes);
    for (int h = 0; h < kLadderLanes; h++) {
      const bool h0 = !((hr >> (2 * h)) & 1u), r0 = !((hr >> (2 * h + 1)) & 1u);
      sum[h] = madd[h] && !h0;
      same[h] = madd[h] && h0 && r0;
      opposite[h] = madd[h] && h0 && !r0;
    }
    copy_points<Prog>(smem, kWords, sum, Prog::kX, Prog::kX3);
    if (same[0] || same[1])  // P == Q: dbl(P), on the halves whose lane needs it
      run_stages<Prog>(sm, L, warp, same[half], 0, Prog::kDblEnd);
    if (opposite[0] || opposite[1]) set_infinities<Prog>(smem, kWords, opposite);  // P == -Q
  }
  __syncthreads();
  const int src[kLadderLanes] = {Prog::kX, Prog::kX};
  store_points<Prog>(smem, kWords, src, ox, oy, oz, n, i0);
}

template <class Prog>
int launch_madd_multi_narrow(void* ox, void* oy, void* oz, const void* ax, const void* ay,
                             const void* az, const void* qx, const void* qy, const void* skip,
                             const void* neg, int steps, long long n, void* stream) {
  if (n <= 0 || steps <= 0 || (long long)steps * n >= (1ll << 40))
    return (int)cudaErrorInvalidValue;
  madd_multi_narrow_kernel<Prog><<<pair_blocks(n), 32 * Prog::kWarps, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(ax), static_cast<const uint32_t*>(ay),
      static_cast<const uint32_t*>(az), static_cast<const uint32_t*>(qx),
      static_cast<const uint32_t*>(qy), static_cast<const uint8_t*>(skip),
      static_cast<const uint8_t*>(neg), steps, n);
  return (int)cudaGetLastError();
}

}  // namespace
