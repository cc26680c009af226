// Two lanes a block on K4's engine (horner.cuh): the shared-memory layout,
// the votes, the copies and the loaders of the kernels that run one point
// operation a half-warp: the digit ladder (ladder.cuh), K2's narrow mode
// (pointwise.cuh) and K7's narrow mode (madd_multi.cuh).
//
// Block lane h (0 or 1) owns `words` shared words from smem + h * words:
// the program's slots of 16 words (horner_schedule.cuh) and whatever the
// kernel keeps beside them. Warp k runs chains k, k + warps, ... of a
// stage, its lanes 0-15 on block lane 0's slots and lanes 16-31 on block
// lane 1's, each half under its own mask. Coordinates are tested through
// one vote and barrier, so every thread takes the same way.

#pragma once

#include "horner.cuh"

namespace {

constexpr int kLadderLanes = 2;  // lanes a block, one a half-warp

// Shared words between the two lanes' slots: 16 more than `slots` slots,
// so that the halves of a warp, each reading word j (or the broadcast word
// i) of its own lane's operand, hit different banks.
template <class Prog>
__host__ __device__ constexpr int lane_words(int slots = Prog::kSlots) {
  return kSlotWords * slots + 16;
}

// Blocks an SM is asked to hold: 32 registers a thread at most (65,536 on
// an SM) over Fp and Fp2, which ptxas meets with 8 bytes spilled; 40
// registers left 6 Fp2 blocks an SM where 8 fit.
template <class Prog>
__host__ __device__ constexpr int min_blocks() {
  return 65536 / (32 * 32 * Prog::kWarps);
}

// ORs each thread's bits over the block, one barrier. Each warp ORs its
// lanes' bits, its lane 0 leaves them in `votes` (read after the barrier,
// written again only after further barriers), and every thread ORs the
// warps'.
template <class Prog>
__device__ __forceinline__ unsigned block_or(unsigned bits, unsigned* votes) {
  bits = __reduce_or_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) votes[threadIdx.x >> 5] = bits;
  __syncthreads();
  bits = 0;
  for (int k = 0; k < Prog::kWarps; k++) bits |= votes[k];
  return bits;
}

// Bit 2 h + k set where the coordinate at slot_k of block lane h is
// non-zero; one barrier.
template <class Prog>
__device__ __forceinline__ unsigned nonzero_bits(const uint32_t* sm, int words, int slot0,
                                                 int slot1, unsigned* votes) {
  constexpr int kC = Prog::kComp * kSlotWords;
  unsigned bits = 0;
  for (int t = threadIdx.x; t < 2 * kLadderLanes * kC; t += blockDim.x) {
    const int q = t / kC;
    if (sm[(q >> 1) * words + kSlotWords * ((q & 1) ? slot1 : slot0) + t % kC] != 0u)
      bits |= 1u << q;
  }
  return block_or<Prog>(bits, votes);
}

// per block lane h with flags[h] set: the three coordinates at src -> dst
template <class Prog>
__device__ __forceinline__ void copy_points(uint32_t* sm, int words, const bool* flags, int dst,
                                            int src) {
  constexpr int kP = 3 * Prog::kComp * kSlotWords;
  for (int t = threadIdx.x; t < kLadderLanes * kP; t += blockDim.x) {
    uint32_t* s = sm + (t / kP) * words;
    if (flags[t / kP]) s[kSlotWords * dst + t % kP] = s[kSlotWords * src + t % kP];
  }
  __syncthreads();
}

// per block lane h with flags[h] set: the accumulator (X, Y, Z) = (1, 1, 0)
template <class Prog>
__device__ __forceinline__ void set_infinities(uint32_t* sm, int words, const bool* flags) {
  constexpr int kC = Prog::kComp * kSlotWords;
  for (int t = threadIdx.x; t < kLadderLanes * 3 * kC; t += blockDim.x) {
    const int k = t % (3 * kC), w = k % kSlotWords;
    if (flags[t / (3 * kC)])
      sm[(t / (3 * kC)) * words + kSlotWords * Prog::kX + k] =
          (k < 2 * kC && k % kC < kSlotWords && w < Fp::N) ? Fp::one(w) : 0u;
  }
  __syncthreads();
}

// point i0 + h of a (12[, 2], n) batch -> the three coordinates at `slot` of
// block lane h, words N..15 zero; a lane past n loads zeros
template <class Prog>
__device__ __forceinline__ void load_points(uint32_t* sm, int words, int slot,
                                            const uint32_t* x, const uint32_t* y,
                                            const uint32_t* z, long long n, long long i0) {
  constexpr int kC = Prog::kComp * kSlotWords;
  for (int t = threadIdx.x; t < kLadderLanes * 3 * kC; t += blockDim.x) {
    const int h = t / (3 * kC), e = t % (3 * kC);
    const int coord = e / kC, comp = (e % kC) / kSlotWords, w = e % kSlotWords;
    uint32_t v = 0u;
    if (w < Fp::N && i0 + h < n)
      v = (coord == 0 ? x : coord == 1 ? y : z)[(long long)(Prog::kComp * w + comp) * n + i0 + h];
    sm[h * words + kSlotWords * slot + e] = v;
  }
}

// block lane h's three coordinates at slot src[h] (src[h] < 0: infinity,
// (1, 1, 0)) -> point i0 + h of a (12[, 2], n) batch
template <class Prog>
__device__ __forceinline__ void store_points(const uint32_t* sm, int words, const int* src,
                                             uint32_t* x, uint32_t* y, uint32_t* z, long long n,
                                             long long i0) {
  constexpr int kC = Prog::kComp * kSlotWords;
  for (int t = threadIdx.x; t < kLadderLanes * 3 * kC; t += blockDim.x) {
    const int h = t / (3 * kC), e = t % (3 * kC);
    const int coord = e / kC, comp = (e % kC) / kSlotWords, w = e % kSlotWords;
    if (w >= Fp::N || i0 + h >= n) continue;
    const uint32_t v = src[h] >= 0 ? sm[h * words + kSlotWords * src[h] + e]
                       : (coord < 2 && comp == 0) ? Fp::one(w) : 0u;
    (coord == 0 ? x : coord == 1 ? y : z)[(long long)(Prog::kComp * w + comp) * n + i0 + h] = v;
  }
}

inline unsigned pair_blocks(long long n) {
  return (unsigned)((n + kLadderLanes - 1) / kLadderLanes);
}

}  // namespace
