// Kernel K2's narrow mode: pointwise add and dbl over G1 (Fp) and G2 (Fp2),
// two points a block, each product over 16 lanes.
//
// Replaces `_PointKernels.add` / `.dbl` (kzg_tpu/curve/pallas_ops.py:712,
// :707) on the launches that are too narrow to fill the card: the levels of
// the MSM's bucket reductions and combines, the ladder table's adds, the
// batched verify's double-and-add, setup's base chain. `cuda_ops` sends a
// launch here while its points fit a few waves of this kernel, and to the
// one-thread kernels of point.cuh (the wide mode) above that.
//
// Bound: the latency of one point's chain of dependent Fp products. At a
// few thousand points the one-thread kernel leaves most SMs idle and runs
// every product of add-2007-bl one after another (16 over Fp, 43 over Fp2),
// each a 144-step serial CIOS.
//
// Design: the digit ladder's engine (ladder.cuh, horner.cuh), two points a
// block, one a half-warp. Each point's operands and temporaries live in
// shared-memory slots of 16 words (padded by 16 words a point, so the two
// halves of a warp read different banks); the stages of the addition or of
// the doubling from the generated program (horner_schedule.cuh) run each
// level's products side by side, each product, add and sub over 16 lanes
// (coop.cuh): the critical path is 6 products of the addition over Fp, 8
// over Fp2, 3 of the doubling. The addition keeps the twin's precedence
// (CurveOps.add) per point: p infinite -> q; q infinite -> p; H == 0 and
// R == 0 -> dbl(p); H == 0 -> (1, 1, 0). The addition's stages run when
// either point of the block adds; they write only temporaries and (X3, Y3,
// Z3), so a point that passes an operand through keeps it, and the rare
// doubling runs in place on (X, Y, Z) on the half whose point needs it.
// Coordinates are tested through one vote and barrier (nonzero_bits), so
// every thread takes the same way. The doubling runs dbl-2009-l on any
// input, infinity included, as the twin does.
//
// Every value is canonical, so the result equals the plain twin word for
// word, Jacobian coordinates included.

#pragma once

#include "ladder.cuh"

namespace {

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

template <class Prog>
__global__ void __launch_bounds__(32 * Prog::kWarps, min_blocks<Prog>())
pointwise_add_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                     uint32_t* __restrict__ oz, const uint32_t* __restrict__ x1,
                     const uint32_t* __restrict__ y1, const uint32_t* __restrict__ z1,
                     const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
                     const uint32_t* __restrict__ z2, long long n) {
  constexpr int kWords = lane_words<Prog>();
  __shared__ uint32_t smem[kLadderLanes * kWords];
  __shared__ unsigned votes[Prog::kWarps];
  const long long i0 = (long long)blockIdx.x * kLadderLanes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = lane >> 4;  // the block lane this half-warp works on
  uint32_t* sm = smem + half * kWords;
  const CoopLane<Fp> L(lane, kzg::coop_half_mask(lane));
  load_points<Prog>(smem, kWords, Prog::kX, x1, y1, z1, n, i0);
  load_points<Prog>(smem, kWords, Prog::kX2, x2, y2, z2, n, i0);
  __syncthreads();
  const unsigned z = nonzero_bits<Prog>(smem, kWords, Prog::kZ, Prog::kZ2, votes);
  bool adds[kLadderLanes], same[kLadderLanes];
  int src[kLadderLanes];
  for (int h = 0; h < kLadderLanes; h++) {
    const bool p_live = (z >> (2 * h)) & 1u, q_live = (z >> (2 * h + 1)) & 1u;
    adds[h] = p_live && q_live;
    src[h] = !p_live ? Prog::kX2 : !q_live ? Prog::kX : Prog::kX3;
  }
  if (adds[0] || adds[1]) {  // the same in every thread
    run_stages<Prog>(sm, L, warp, true, Prog::kDblEnd, Prog::kAddEnd);
    const unsigned hr = nonzero_bits<Prog>(smem, kWords, Prog::kH, Prog::kR, votes);
    for (int h = 0; h < kLadderLanes; h++) {
      const bool h0 = !((hr >> (2 * h)) & 1u), r0 = !((hr >> (2 * h + 1)) & 1u);
      same[h] = adds[h] && h0 && r0;
      if (adds[h] && h0) src[h] = r0 ? Prog::kX : -1;  // P == Q: dbl(P) in place; P == -Q
    }
    if (same[0] || same[1]) run_stages<Prog>(sm, L, warp, same[half], 0, Prog::kDblEnd);
  }
  store_points<Prog>(smem, kWords, src, ox, oy, oz, n, i0);
}

template <class Prog>
__global__ void __launch_bounds__(32 * Prog::kWarps, min_blocks<Prog>())
pointwise_dbl_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                     uint32_t* __restrict__ oz, const uint32_t* __restrict__ x,
                     const uint32_t* __restrict__ y, const uint32_t* __restrict__ z,
                     long long n) {
  constexpr int kWords = lane_words<Prog>();
  __shared__ uint32_t smem[kLadderLanes * kWords];
  const long long i0 = (long long)blockIdx.x * kLadderLanes;
  const int lane = threadIdx.x & 31;
  const CoopLane<Fp> L(lane, kzg::coop_half_mask(lane));
  load_points<Prog>(smem, kWords, Prog::kX, x, y, z, n, i0);
  __syncthreads();
  run_stages<Prog>(smem + (lane >> 4) * kWords, L, threadIdx.x >> 5, true, 0, Prog::kDblEnd);
  const int src[kLadderLanes] = {Prog::kX, Prog::kX};
  store_points<Prog>(smem, kWords, src, ox, oy, oz, n, i0);
}

inline unsigned pointwise_blocks(long long n) {
  return (unsigned)((n + kLadderLanes - 1) / kLadderLanes);
}

template <class Prog>
int launch_pointwise_add(void* ox, void* oy, void* oz, const void* x1, const void* y1,
                         const void* z1, const void* x2, const void* y2, const void* z2,
                         long long n, void* stream) {
  if (n <= 0 || n >= (1ll << 32)) return (int)cudaErrorInvalidValue;
  pointwise_add_kernel<Prog><<<pointwise_blocks(n), 32 * Prog::kWarps, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(x1), static_cast<const uint32_t*>(y1),
      static_cast<const uint32_t*>(z1), static_cast<const uint32_t*>(x2),
      static_cast<const uint32_t*>(y2), static_cast<const uint32_t*>(z2), n);
  return (int)cudaGetLastError();
}

template <class Prog>
int launch_pointwise_dbl(void* ox, void* oy, void* oz, const void* x, const void* y,
                         const void* z, long long n, void* stream) {
  if (n <= 0 || n >= (1ll << 32)) return (int)cudaErrorInvalidValue;
  pointwise_dbl_kernel<Prog><<<pointwise_blocks(n), 32 * Prog::kWarps, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<const uint32_t*>(z), n);
  return (int)cudaGetLastError();
}

}  // namespace
